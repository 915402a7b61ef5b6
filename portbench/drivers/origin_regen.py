"""A port origin regenerates the metainfo of one seeded blob back to back.

The origin is built by ``assembly.OriginNode`` from the configuration's
YAML, so its ``Generator`` carries the ``IngestPipeline`` that the
assembly attaches from ``ingest:``. Before each regeneration the
``torrentmeta`` sidecar is removed (``CAStore.delete_metadata``), so every
piece is hashed every time. Closed loop, one blob in flight: the window
runs from the first regeneration's start to the end of the one that is
under way when ``--seconds`` have passed, so it holds whole regenerations
and no idle time. The blob is written in set-up and read from the page
cache.
"""

from __future__ import annotations

import hashlib
import time

import numpy as np

from portbench import port, traffic
from portbench.harness import Context, Outcome
from portbench.reference import metainfo as ref


def _plant(hasher, fault: str | None, control: bool) -> None:
    """Break the timed path underneath (a CPU rehearsal's ``--fault``), or
    put the control in its place: the reference's ``hashlib`` over every
    piece but its last 64 bytes (one guarantee of the configuration, that
    each digest covers its whole piece, broken)."""
    real = hasher.hash_pieces
    if control:
        def hash_pieces(data, plen):
            v = memoryview(data)
            return np.frombuffer(b"".join(
                hashlib.sha256(v[o:min(o + plen, len(v)) - 64]).digest()
                for o in range(0, len(v), plen)), dtype=np.uint8).reshape(-1, 32)
    elif fault == "alter_answer":
        def hash_pieces(data, plen):
            out = real(data, plen).copy()
            out[0, 0] ^= 1
            return out
    elif fault == "half_batch":
        def hash_pieces(data, plen):
            out = real(data, plen).copy()
            out[len(out) // 2:] = 0
            return out
    else:
        return
    hasher.hash_pieces = hash_pieces


def run(ctx: Context) -> Outcome:
    cfg, tr, args = ctx.config, ctx.traffic, ctx.args
    if ctx.cpu:
        port.ask_for_cpu()
    from kraken_tpu_torch import Digest
    from kraken_tpu_torch.assembly import OriginNode
    from kraken_tpu_torch.origin.metainfogen import TorrentMetaMetadata

    marks = {"imports": time.monotonic() - ctx.t_start}
    size = cfg["rehearsal"]["blob_bytes"] if ctx.cpu else cfg["blob_bytes"]
    yaml = port.node_yaml(cfg)
    node = OriginNode(
        store_root=str(ctx.workdir / "origin"), hasher=yaml["hasher"],
        hash_workers=int(yaml.get("hash_workers", 1)),
        durability=yaml.get("durability", "rename"), ingest=yaml.get("ingest"),
        fsck=False, retry_db=str(ctx.workdir / "retry.db"),
        dedup=False,  # the dedup pass follows an upload, not a regeneration
    )
    gen, store = node.generator, node.store
    data = traffic.blob(args.seed, tr["blob_key"], size)
    d = Digest.from_bytes(data)
    uid = store.create_upload()
    store.write_upload_chunk(uid, 0, data)
    store.commit_upload(uid, d, verify=False)
    del data
    marks["data"] = time.monotonic() - ctx.t_start
    _plant(gen.hasher, args.fault, args.control)
    if args.fault == "unchanged_state":
        # The step hands back the state it was given: the metainfo as it
        # stood before the sidecar was removed, with no piece hashed.
        first = gen.generate_sync(d)
        gen.generate_sync = lambda _d: first

    def regenerate():
        store.delete_metadata(d, TorrentMetaMetadata)
        return gen.generate_sync(d)

    regenerate()  # warm-up: the library's load and the window's shapes
    marks["warm_regeneration"] = time.monotonic() - ctx.t_start
    trace = None
    if args.trace and not ctx.cpu:  # a CPU run reads no device metric
        from portbench.devtrace import DeviceTrace

        trace = DeviceTrace(ctx.workdir)
        trace.start()
    before = port.counters()
    ctx.window_opens()
    if trace:
        trace.open()
    t0 = time.monotonic()
    regens = []
    while True:
        a = time.monotonic()
        mi = regenerate()
        b = time.monotonic()
        regens.append({"start": a - t0, "end": b - t0, "bytes": mi.length,
                       "got": {"digest": mi.digest.hex, "length": mi.length,
                               "piece_length": mi.piece_length,
                               "piece_hashes": mi.piece_hashes}})
        if b - t0 >= args.seconds:
            break
    if trace:
        trace.close()
    window = port.rise(before, port.counters())
    peak = port.memory_peak_bytes(ctx.cpu)
    summary = trace.summary() if trace else None
    del node, gen, store
    # The reference, once the window has closed and the peak is read.
    want = ref.expected(traffic.blob(args.seed, tr["blob_key"], size), cfg["piece_lengths"])
    wrong = sum(ref.metainfo_wrong(r["got"], want) for r in regens)
    pieces = len(want["piece_hashes"]) // 32
    unhashed = max(0.0, pieces * len(regens) - window["rows_hashed"])
    for r in regens:
        del r["got"]
    obs = {"window_s": regens[-1]["end"], "regens": regens, "counters": {"window": window},
           "trace": summary}
    return Outcome(obs=obs, attempted=len(regens), failed=0,
                   checks={"metainfo_wrong": (wrong, 0), "pieces_not_hashed": (unhashed, 0)},
                   memory_peak_bytes=peak, trace=summary, lines=[{"setup_s_at": marks}])
