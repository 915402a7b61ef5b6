"""The SHA-256 plane's stage timers (``kraken_tpu_torch/utils/trace.py``
``stage``, ``bill``, ``plane``) at their boundaries: a verify flush's
queue, pool, staging, bounds check, submit and readback; the ingest
session's slot and pool waits and its hasher stages; the dispatcher's
re-requests and duplicate payloads. CPU only: the hasher runs the
kernels' plain versions (``device="cpu"``)."""

import asyncio
import hashlib
import json

import numpy as np
import pytest
import torch
from torch._C._profiler import _ExperimentalConfig

import kraken_tpu_torch as kt
from kraken_tpu_torch.core.ingest import IngestConfig, IngestPipeline
from kraken_tpu_torch.core.peer import PeerID
from kraken_tpu_torch.ops.sha256 import TorchPieceHasher
from kraken_tpu_torch.p2p.dispatch import Dispatcher, _Peer
from kraken_tpu_torch.p2p.piecerequest import RequestManager
from kraken_tpu_torch.p2p.storage import BatchedVerifier
from kraken_tpu_torch.p2p.wire import Message
from kraken_tpu_torch.utils import trace
from kraken_tpu_torch.utils.metrics import REGISTRY

STAGES = ("queue", "pool", "slot", "stage", "check", "submit", "readback")


def plane_counts(path: str) -> dict[str, tuple[float, float]]:
    """stage -> (seconds, events) billed to ``path`` so far."""
    s = REGISTRY.counter("hash_plane_seconds_total")
    n = REGISTRY.counter("hash_plane_events_total")
    return {st: (s.value(path=path, stage=st), n.value(path=path, stage=st)) for st in STAGES}


def rise(before: dict, after: dict) -> dict[str, float]:
    """stage -> events billed between two ``plane_counts``."""
    return {st: after[st][1] - before[st][1] for st in STAGES}


def pid(i: int) -> PeerID:
    return PeerID(f"{i:040x}")


def counter(name: str, **labels) -> float:
    return REGISTRY.counter(name).value(**labels)


def pieces_of(n: int) -> list[bytes]:
    """A few hundred bytes each: the plain SHA-256 takes ~0.4 s a 4 KiB row."""
    return [bytes((i * 7 + k) % 256 for k in range(200 + 50 * i)) for i in range(n)]


async def verify_all(v: BatchedVerifier, pieces: list[bytes]) -> list[bool]:
    return await asyncio.gather(*(v.verify(p, hashlib.sha256(p).digest()) for p in pieces))


@pytest.mark.parametrize("profiled", [True, False], ids=["profiler", "no-profiler"])
def test_a_verify_flush_bills_each_stage(tmp_path, monkeypatch, profiled):
    """One flush of three pieces: one event a stage for its one group
    (the submit's launch adds seconds, not an event) and one a piece for
    the queue and the pool. With a profiler recording every thread the
    group's stages are ``kraken.verify.*`` ranges on its timeline (the hash
    runs in an ``asyncio.to_thread`` worker, which a profiler of only the
    calling thread does not see); with none, no range is entered."""
    pieces = pieces_of(3)
    v = BatchedVerifier(TorchPieceHasher(device="cpu"))
    before, verified = plane_counts("verify"), counter("verify_pieces_total")
    if profiled:
        cfg = _ExperimentalConfig(profile_all_threads=True)
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU],
                                    experimental_config=cfg) as prof:
            ok = asyncio.run(verify_all(v, pieces))
        prof.export_chrome_trace(str(tmp_path / "trace.json"))
        events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
        ranges = {e["name"] for e in events
                  if e.get("cat") == "user_annotation" and e["name"].startswith("kraken.")}
        assert ranges == {f"kraken.verify.{s}" for s in ("stage", "check", "submit", "readback")}
    else:
        def refuse(*_a, **_k):
            raise AssertionError("record_function entered with no profiler")

        monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
        ok = asyncio.run(verify_all(v, pieces))
    assert ok == [True, True, True]
    after = plane_counts("verify")
    assert rise(before, after) == {"queue": 3, "pool": 3, "slot": 0, "stage": 1, "check": 1,
                                   "submit": 1, "readback": 1}
    assert counter("verify_pieces_total") - verified == 3
    assert all(after[s][0] > before[s][0] for s in ("queue", "pool", "stage", "submit"))


@pytest.mark.parametrize("in_flight", [1, 2])
def test_an_ingest_session_bills_slots_pool_and_stages(in_flight):
    """A slot wait for every ``begin_window``; a pool wait and the hasher's
    stages for each window submitted with bytes (one uniform group each);
    none for an empty one."""
    blob = bytes(range(256)) * (8 * 1024)  # 2 MiB: two 1 MiB windows
    pipe = IngestPipeline(TorchPieceHasher(device="cpu"),
                          IngestConfig(window_bytes=1 << 20, windows_in_flight=in_flight))
    before = plane_counts("ingest")
    ses = pipe.session(1024)
    off = 0
    for _ in range(3):
        buf = ses.begin_window()
        n = min(len(buf), len(blob) - off)
        buf[:n] = blob[off:off + n]
        off += n
        ses.submit(n)
    got = ses.finish()
    want = [hashlib.sha256(blob[i:i + 1024]).digest() for i in range(0, len(blob), 1024)]
    assert got.tobytes() == b"".join(want)
    assert rise(before, plane_counts("ingest")) == {
        "queue": 0, "pool": 2, "slot": 3, "stage": 2, "check": 0, "submit": 2, "readback": 2}
    assert ses.slot_seconds >= 0 and ses.windows == 3


def test_the_pipelined_generate_opens_its_span(tmp_path):
    """``origin.metainfo.generate`` opens on the pipelined path too, with
    the blob's size, its windows and the session's stage walls; the
    reader's slot wait is its child on a sampled trace."""
    blob = bytes(range(256)) * 8 + b"tail"
    d = kt.Digest.from_bytes(blob)
    store = kt.CAStore(str(tmp_path))
    uid = store.create_upload()
    store.write_upload_chunk(uid, 0, blob)
    store.commit_upload(uid, d)
    pipe = IngestPipeline(TorchPieceHasher(device="cpu"), IngestConfig(window_bytes=1 << 20))
    saved = trace.TRACER.config
    trace.TRACER.apply(trace.TraceConfig(sample_rate=1.0))
    trace.TRACER.recorder.clear()
    try:
        mi = kt.Generator(store, piece_lengths=kt.PieceLengthConfig(((0, 1024),)),
                          pipeline=pipe).generate_sync(d)
        spans = trace.TRACER.recorder.snapshot()
    finally:
        trace.TRACER.apply(saved)
    assert mi.piece_hashes == kt.CPUPieceHasher().hash_pieces(blob, 1024).tobytes()
    gen = [s for s in spans if s["name"] == "origin.metainfo.generate"][-1]
    assert gen["attrs"]["size"] == len(blob) and gen["attrs"]["windows"] == 1
    assert {"slot_s", "read_s", "hash_s"} <= set(gen["attrs"])
    slots = [s for s in spans if s["name"] == "hash_plane.ingest.slot"]
    assert slots and slots[-1]["parent_id"] == gen["span_id"]


def test_re_requests_count_once_by_reason():
    """A hand-timed sequence over three pieces: a rescue duplicate while a
    piece is still unrequested, an endgame duplicate once all are in
    flight, and an expired piece handed out again."""
    rm = RequestManager(timeout_seconds=10.0, pipeline_limit=4)
    c = REGISTRY.counter("p2p_piece_rerequests_total")
    reasons = ("expired", "rescue", "endgame")
    before = {r: c.value(reason=r) for r in reasons}
    missing = [0, 1, 2]
    peer = [pid(i) for i in range(5)]
    assert sorted(rm.select(peer[0], {0, 1}, missing, {}, now=0.0)) == [0, 1]
    assert rm.select(peer[1], {0}, missing, {}, now=1.5) == [0]  # 2 still unrequested
    assert rm.select(peer[2], {2}, missing, {}, now=2.0) == [2]  # a first request
    assert rm.select(peer[3], {1}, missing, {}, now=3.5) == [1]  # all in flight
    assert rm.select(peer[4], {2}, missing, {}, now=20.0) == [2]  # every request expired
    assert {r: c.value(reason=r) - before[r] for r in reasons} == {
        "expired": 1, "rescue": 1, "endgame": 1}


class _Conn:
    """Just enough of a Conn for the dispatcher's payload path."""

    def __init__(self, peer_id: PeerID):
        self.peer_id = peer_id
        self.sent = []

    async def send(self, msg):
        self.sent.append(msg)

    def close(self):
        pass


@pytest.mark.parametrize("when", ["before_verify", "after_verify"])
def test_a_duplicate_payload_counts_when_it_was_dropped(tmp_path, when):
    """A payload for a piece the torrent holds is dropped before verify; a
    second copy verified with the first is dropped after."""
    blob = bytes(range(256)) * 16  # 4 pieces of 1 KiB
    d = kt.Digest.from_bytes(blob)
    origin = kt.CAStore(str(tmp_path / "o"))
    uid = origin.create_upload()
    origin.write_upload_chunk(uid, 0, blob)
    origin.commit_upload(uid, d)
    mi = kt.Generator(origin, hasher=kt.CPUPieceHasher(),
                      piece_lengths=kt.PieceLengthConfig(((0, 1024),))).generate_sync(d)
    v = BatchedVerifier(kt.CPUPieceHasher())
    c = REGISTRY.counter("p2p_piece_duplicates_total")
    before = {w: c.value(when=w) for w in ("before_verify", "after_verify")}
    piece = blob[:1024]

    async def main():
        if when == "before_verify":
            seeder = kt.OriginTorrentArchive(origin, v).create_torrent(mi)
            disp = Dispatcher(seeder)
            conn = _Conn(pid(9))
            peer = _Peer(conn, set(), asyncio.get_running_loop().time())
            disp._peers[conn.peer_id] = peer
            await disp._on_payload(peer, 0, Message.piece_payload(0, piece))
            disp.close()
        else:
            leech = kt.AgentTorrentArchive(kt.CAStore(str(tmp_path / "a")), v).create_torrent(mi)
            done = await asyncio.gather(leech.write_piece(0, piece), leech.write_piece(0, piece))
            assert done == [False, False] and leech.has_piece(0)

    asyncio.run(main())
    want = {"before_verify": 0, "after_verify": 0, when: 1}
    assert {w: c.value(when=w) - before[w] for w in want} == want


def test_stage_seconds_and_events_reach_the_counters_under_a_plane():
    """``plane`` labels what a ``stage`` bills; ``count=False`` adds seconds
    and no event; ``bill`` adds an interval timed elsewhere."""
    before = plane_counts("verify")
    with trace.plane("verify"):
        with trace.stage("stage") as st:
            np.zeros(16).sum()
        with trace.stage("stage", count=False):
            pass
    trace.bill("queue", 0.5, 4, "verify")
    after = plane_counts("verify")
    assert rise(before, after)["stage"] == 1 and rise(before, after)["queue"] == 4
    assert after["stage"][0] - before["stage"][0] >= st.seconds > 0
    assert after["queue"][0] - before["queue"][0] == pytest.approx(0.5)
    assert trace._plane.get() == "other"
