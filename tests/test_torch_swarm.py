"""In-process swarms of the port's schedulers: real TCP conns on loopback,
real piece exchange, an in-memory tracker. The cases of
``tests/test_swarm.py`` against the port, pulls across the two packages
(a port leecher from a ``kraken_tpu`` seeder and the reverse, with the
trace context carried across), one pull verified through the SHA-256
kernel's wrapper (its plain version, on the CPU), the refusal of the
multi-core data plane's knobs, the sampling profiler the dispatcher
reads, and the ``Torrent`` methods the dispatcher and scheduler call,
against ``kraken_tpu``'s."""

import asyncio
import os
import pathlib

import numpy as np
import pytest

import kraken_tpu.core.digest as jax_digest
import kraken_tpu.core.metainfo as jax_metainfo
import kraken_tpu.core.peer as jax_peer
import kraken_tpu.p2p.scheduler as jax_scheduler
import kraken_tpu.p2p.storage as jax_storage
import kraken_tpu.store as jax_store
import kraken_tpu.utils.trace as jax_trace
import kraken_tpu_torch.core.digest as port_digest
import kraken_tpu_torch.core.metainfo as port_metainfo
import kraken_tpu_torch.core.peer as port_peer
import kraken_tpu_torch.p2p.scheduler as port_scheduler
import kraken_tpu_torch.p2p.storage as port_storage
import kraken_tpu_torch.store as port_store
import kraken_tpu_torch.utils.profiler as port_profiler
import kraken_tpu_torch.utils.trace as port_trace
from kraken_tpu_torch import CPUPieceHasher, TorchPieceHasher
from kraken_tpu_torch.ops import sha256_cuda
from kraken_tpu_torch.p2p.networkevent import Producer
from kraken_tpu_torch.p2p.scheduler import SchedulerConfig
from kraken_tpu_torch.store import PieceStatusMetadata
from kraken_tpu_torch.utils.metrics import REGISTRY

NS = "test-ns"
PORT, JAX = "kraken_tpu_torch", "kraken_tpu"


class _Pkg:
    def __init__(self, digest, metainfo, peer, scheduler, storage, store, trace):
        self.digest, self.metainfo, self.peer = digest, metainfo, peer
        self.scheduler, self.storage, self.store, self.trace = scheduler, storage, store, trace


PKGS = {
    PORT: _Pkg(port_digest, port_metainfo, port_peer, port_scheduler, port_storage,
               port_store, port_trace),
    JAX: _Pkg(jax_digest, jax_metainfo, jax_peer, jax_scheduler, jax_storage,
              jax_store, jax_trace),
}


def blob_of(n: int, seed: int) -> bytes:
    return np.random.default_rng(seed).integers(0, 256, n, dtype=np.uint8).tobytes()


def make_metainfo(blob: bytes, piece_length: int = 4096):
    """The port's MetaInfo; ``FakeTracker`` hands each package its own."""
    hashes = CPUPieceHasher().hash_pieces(blob, piece_length)
    return port_metainfo.MetaInfo(
        port_digest.Digest.from_bytes(blob), len(blob), piece_length, hashes.tobytes()
    )


class FakeTracker:
    """In-memory announce + metainfo service shared by every peer of a
    test, whichever package it runs: records are kept as plain values and
    each client builds its own package's ``MetaInfo`` and ``PeerInfo``."""

    def __init__(self, interval: float = 0.2):
        self.metainfos: dict[str, bytes] = {}  # digest hex -> serialized
        self.peers: dict[str, dict[str, dict]] = {}  # info hash -> peer id -> record
        self.interval = interval

    def add(self, mi) -> None:
        self.metainfos[mi.digest.hex] = mi.serialize()

    def client_for(self, ref: dict, pkg: _Pkg):
        tracker = self

        class _Client:
            async def get(self, namespace, d):
                return pkg.metainfo.MetaInfo.deserialize(tracker.metainfos[d.hex])

            async def announce(self, d, h, namespace, complete):
                sched = ref["s"]
                swarm = tracker.peers.setdefault(h.hex, {})
                swarm[sched.peer_id.hex] = {
                    "peer_id": sched.peer_id.hex, "ip": sched.ip, "port": sched.port,
                    "complete": complete,
                }
                others = [
                    pkg.peer.PeerInfo.from_dict(rec)
                    for pid, rec in swarm.items() if pid != sched.peer_id.hex
                ]
                return others, tracker.interval

        return _Client()


def make_peer(tmp_path, name, tracker, seed_blob=None, pkg=PORT, hasher=None,
              digest_hex=None, events=None):
    """A scheduler of package ``pkg`` with its own store. With
    ``seed_blob`` it holds that blob committed (under ``digest_hex``, when
    given: a lying seeder) and seeds origin-style."""
    p = PKGS[pkg]
    store = p.store.CAStore(str(tmp_path / name))
    if pkg == PORT:
        verifier = p.storage.BatchedVerifier(hasher or CPUPieceHasher())
    else:
        verifier = p.storage.BatchedVerifier()
    ref: dict = {}
    if seed_blob is not None:
        d = p.digest.Digest.from_hex(digest_hex) if digest_hex else p.digest.Digest.from_bytes(seed_blob)
        uid = store.create_upload()
        store.write_upload_chunk(uid, 0, seed_blob)
        store.commit_upload(uid, d, verify=digest_hex is None)
        archive = p.storage.OriginTorrentArchive(store, verifier)
    else:
        archive = p.storage.AgentTorrentArchive(store, verifier)
    client = tracker.client_for(ref, p)
    sched = p.scheduler.Scheduler(
        peer_id=p.peer.PeerID(os.urandom(20).hex()),
        ip="127.0.0.1",
        port=0,
        archive=archive,
        metainfo_client=client,
        announce_client=client,
        events=events,
        config=p.scheduler.SchedulerConfig(
            announce_interval_seconds=0.1,
            retry_tick_seconds=0.2,
            dial_timeout_seconds=2.0,
        ),
    )
    ref["s"] = sched
    return sched, store


def mi_for(pkg, mi):
    return PKGS[pkg].metainfo.MetaInfo.deserialize(mi.serialize())


async def start_all(*scheds):
    for s in scheds:
        await s.start()


async def stop_all(*scheds):
    for s in scheds:
        await s.stop()


def test_seeder_to_leecher(tmp_path):
    async def main():
        blob = blob_of(100_000, 1)
        mi = make_metainfo(blob)
        tracker = FakeTracker()
        tracker.add(mi)
        seeder, _ = make_peer(tmp_path, "seeder", tracker, seed_blob=blob)
        leecher, lstore = make_peer(tmp_path, "leecher", tracker)
        await start_all(seeder, leecher)
        try:
            seeder.seed(mi, NS)
            await asyncio.wait_for(leecher.download(NS, mi.digest), 15)
            assert lstore.read_cache_file(mi.digest) == blob
        finally:
            await stop_all(seeder, leecher)

    asyncio.run(main())


def test_multi_leecher_fanout(tmp_path):
    """One seeder, four leechers at once; all converge byte-identically
    (pieces flow leecher to leecher too)."""

    async def main():
        blob = blob_of(300_000, 2)
        mi = make_metainfo(blob, piece_length=8192)
        tracker = FakeTracker()
        tracker.add(mi)
        seeder, _ = make_peer(tmp_path, "seeder", tracker, seed_blob=blob)
        leechers = [make_peer(tmp_path, f"l{i}", tracker) for i in range(4)]
        await start_all(seeder, *(s for s, _ in leechers))
        try:
            seeder.seed(mi, NS)
            await asyncio.wait_for(
                asyncio.gather(*(s.download(NS, mi.digest) for s, _ in leechers)), 30
            )
            for _, st in leechers:
                assert st.read_cache_file(mi.digest) == blob
        finally:
            await stop_all(seeder, *(s for s, _ in leechers))

    asyncio.run(main())


def test_download_coalesces(tmp_path):
    async def main():
        blob = blob_of(50_000, 3)
        mi = make_metainfo(blob)
        tracker = FakeTracker()
        tracker.add(mi)
        seeder, _ = make_peer(tmp_path, "seeder", tracker, seed_blob=blob)
        leecher, lstore = make_peer(tmp_path, "leecher", tracker)
        await start_all(seeder, leecher)
        pieces0 = REGISTRY.counter("verify_pieces_total").value()
        try:
            seeder.seed(mi, NS)
            await asyncio.wait_for(
                asyncio.gather(*(leecher.download(NS, mi.digest) for _ in range(5))), 15
            )
            assert lstore.read_cache_file(mi.digest) == blob
            assert len(leecher._controls) == 1
            # Five calls, one download: each piece verified about once.
            assert REGISTRY.counter("verify_pieces_total").value() - pieces0 < 2 * mi.num_pieces
        finally:
            await stop_all(seeder, leecher)

    asyncio.run(main())


def test_resume_from_partial(tmp_path):
    """A leecher with a persisted partial bitfield fetches only the missing
    pieces and completes."""

    blob = blob_of(64 * 1024, 4)
    mi = make_metainfo(blob, piece_length=4096)
    tracker = FakeTracker()
    tracker.add(mi)
    # Half the pieces on disk and in the sidecar, as a crashed pull leaves.
    lstore = port_store.CAStore(str(tmp_path / "leecher"))
    lstore.allocate_partial_file(mi.digest, mi.length)
    status = PieceStatusMetadata(mi.num_pieces)
    with open(lstore.partial_path(mi.digest), "r+b") as f:
        for i in range(0, mi.num_pieces, 2):
            f.seek(i * mi.piece_length)
            f.write(blob[i * mi.piece_length : (i + 1) * mi.piece_length])
            status.set(i)
    lstore.set_metadata(mi.digest, status)

    async def main():
        seeder, _ = make_peer(tmp_path, "seeder", tracker, seed_blob=blob)
        leecher, lstore = make_peer(tmp_path, "leecher", tracker)
        down0 = REGISTRY.counter("p2p_piece_bytes_down_total").value()
        await start_all(seeder, leecher)
        try:
            seeder.seed(mi, NS)
            await asyncio.wait_for(leecher.download(NS, mi.digest), 15)
            assert lstore.read_cache_file(mi.digest) == blob
            got = REGISTRY.counter("p2p_piece_bytes_down_total").value() - down0
            assert mi.length // 2 <= got < mi.length
        finally:
            await stop_all(seeder, leecher)

    asyncio.run(main())


def test_corrupt_seeder_blacklisted(tmp_path):
    """A peer serving corrupt pieces is dropped and blacklisted; the pull
    completes from an honest seeder."""

    async def main():
        blob = blob_of(60_000, 5)
        mi = make_metainfo(blob, piece_length=4096)
        tracker = FakeTracker()
        tracker.add(mi)
        evil, _ = make_peer(tmp_path, "evil", tracker, seed_blob=blob_of(len(blob), 6),
                            digest_hex=mi.digest.hex)
        honest, _ = make_peer(tmp_path, "honest", tracker, seed_blob=blob)
        leecher, lstore = make_peer(tmp_path, "leecher", tracker)
        await start_all(evil, honest, leecher)
        try:
            evil.seed(mi, NS)
            await asyncio.sleep(0.15)  # let evil announce first
            honest.seed(mi, NS)
            await asyncio.wait_for(leecher.download(NS, mi.digest), 20)
            assert lstore.read_cache_file(mi.digest) == blob
            assert leecher.conn_state.blacklist.blocked(evil.peer_id, mi.info_hash)
        finally:
            await stop_all(evil, honest, leecher)

    asyncio.run(main())


@pytest.mark.parametrize("seeder_pkg,leecher_pkg", [(JAX, PORT), (PORT, JAX)],
                         ids=["jax-seeds-port-pulls", "port-seeds-jax-pulls"])
def test_pull_across_the_packages_carries_the_trace(tmp_path, seeder_pkg, leecher_pkg):
    """One package's leecher pulls from the other's seeder byte for byte.
    Every trace is sampled, so the leecher's piece requests carry its
    traceparent and the seeder's serve spans join the leecher's download
    trace across the two packages' tracers."""

    async def main():
        blob = blob_of(120_000, 7)
        mi = make_metainfo(blob, piece_length=8192)
        tracker = FakeTracker()
        tracker.add(mi)
        seeder, _ = make_peer(tmp_path, "seeder", tracker, seed_blob=blob, pkg=seeder_pkg)
        leecher, lstore = make_peer(tmp_path, "leecher", tracker, pkg=leecher_pkg)
        await start_all(seeder, leecher)
        try:
            seeder.seed(mi_for(seeder_pkg, mi), NS)
            d = PKGS[leecher_pkg].digest.Digest.from_hex(mi.digest.hex)
            await asyncio.wait_for(leecher.download(NS, d), 15)
            assert lstore.read_cache_file(d) == blob
        finally:
            await stop_all(seeder, leecher)

    tracers = [PKGS[p].trace.TRACER for p in (seeder_pkg, leecher_pkg)]
    configs = [t.config for t in tracers]
    for t in tracers:
        t.apply({"sample_rate": 1.0})
        t.recorder.clear()
    try:
        asyncio.run(main())
        served = [s for s in tracers[0].recorder.snapshot() if s["name"] == "p2p.piece.serve"]
        pulls = [s for s in tracers[1].recorder.snapshot() if s["name"] == "p2p.download"]
    finally:
        for t, cfg in zip(tracers, configs):
            t.apply(cfg)
            t.recorder.clear()
    assert len(pulls) == 1 and served
    assert {s["trace_id"] for s in served} == {pulls[0]["trace_id"]}


def test_pull_verified_through_the_kernel_wrapper_on_the_cpu(tmp_path):
    """The port's verifier on the ``cuda`` hasher with ``device="cpu"``:
    every received piece goes through ``sha256_cuda.sha256_ragged``, which
    takes its plain version for a CPU tensor (and counts no launch)."""

    async def main():
        blob = blob_of(16 * 1024, 8)
        mi = make_metainfo(blob, piece_length=1024)
        tracker = FakeTracker()
        tracker.add(mi)
        seeder, _ = make_peer(tmp_path, "seeder", tracker, seed_blob=blob)
        leecher, lstore = make_peer(tmp_path, "leecher", tracker,
                                    hasher=TorchPieceHasher(device="cpu"))
        assert leecher.archive.verifier.hasher.name == "cuda"
        await start_all(seeder, leecher)
        try:
            seeder.seed(mi, NS)
            await asyncio.wait_for(leecher.download(NS, mi.digest), 60)
            assert lstore.read_cache_file(mi.digest) == blob
        finally:
            await stop_all(seeder, leecher)

    rows = REGISTRY.counter("hasher_pieces_total")
    batches = REGISTRY.counter("verify_batches_total")
    before = (rows.value(hasher="cuda"), batches.value(path="cuda"), dict(sha256_cuda.LAUNCHES))
    asyncio.run(main())
    assert rows.value(hasher="cuda") - before[0] >= 16
    assert batches.value(path="cuda") - before[1] >= 1
    assert sha256_cuda.LAUNCHES == before[2]


@pytest.mark.parametrize("knob", ["data_plane_workers", "leech_workers"])
@pytest.mark.parametrize("how", ["init", "from_dict", "reload"])
def test_the_multi_core_data_plane_is_refused(tmp_path, knob, how):
    with pytest.raises(ValueError, match="A7g"):
        if how == "init":
            SchedulerConfig(**{knob: 1})
        elif how == "from_dict":
            SchedulerConfig.from_dict({knob: 2})
        else:
            sched, _ = make_peer(tmp_path, "p", FakeTracker())
            cfg = SchedulerConfig()
            setattr(cfg, knob, 1)
            sched.reload(cfg)
    assert SchedulerConfig().data_plane_workers == SchedulerConfig().leech_workers == 0


def test_the_shipped_scheduler_sections_load_and_workers_stay_refused():
    """The shipped agent files set ``leech_ring_mb: 32`` beside
    ``leech_workers: 0``: the port takes the key, stores it as the
    reference does, and nothing reads it while the workers stay at 0.
    Any worker count above 0 is still refused, naming A7g."""
    import yaml

    from kraken_tpu.configutil import load_config as jax_load_config
    from kraken_tpu.p2p.scheduler import SchedulerConfig as JaxSchedulerConfig

    root = pathlib.Path(__file__).resolve().parent.parent / "config"
    for name in ("agent/base.yaml", "agent/development.yaml",
                 "origin/base.yaml", "origin/development.yaml"):
        doc = jax_load_config(str(root / name))["scheduler"]
        port, ref = SchedulerConfig.from_dict(doc), JaxSchedulerConfig.from_dict(doc)
        for key in doc:
            assert getattr(port, key) == getattr(ref, key), (name, key)
    assert "leech_ring_mb" in yaml.safe_load((root / "agent/base.yaml").read_text())["scheduler"]
    assert SchedulerConfig.from_dict({"leech_ring_mb": 8}).leech_ring_mb == 8
    assert SchedulerConfig().leech_ring_mb == JaxSchedulerConfig().leech_ring_mb == 32
    for knob in ("leech_workers", "data_plane_workers"):
        with pytest.raises(ValueError, match="A7g"):
            SchedulerConfig.from_dict({"leech_ring_mb": 32, knob: 1})


def test_a_pull_reports_its_plane_split_while_the_profiler_runs(tmp_path, monkeypatch):
    """The dispatcher baselines a pull against the running sampler's
    cumulative plane counts; the completed pull's summary carries the
    delta, and the sampler stops when asked.

    Two things are made sure of rather than left to timing. A node
    started in-process by another test of the same worker leaves the
    process-global sampler running, and its samples go into the same
    ``profiler_samples_total``: it is stopped for the test's length.
    And the pull is held open (every send delayed through the
    ``p2p.conn.send.delay`` failpoint) until the sampler has taken a
    sample after the dispatcher's baseline."""
    from kraken_tpu_torch.utils import failpoints

    stray = port_profiler.PROFILER
    stray_was_running = stray.running
    stray.stop()
    prof = port_profiler.SamplingProfiler(port_profiler.ProfilerConfig.from_dict({"hz": 250.0}))
    monkeypatch.setattr(port_profiler, "PROFILER", prof)
    samples = REGISTRY.counter("profiler_samples_total")
    before = samples.value()
    events = Producer("leecher")

    async def main():
        blob = blob_of(100_000, 12)
        mi = make_metainfo(blob)
        tracker = FakeTracker()
        tracker.add(mi)
        seeder, _ = make_peer(tmp_path, "seeder", tracker, seed_blob=blob)
        leecher, lstore = make_peer(tmp_path, "leecher", tracker, events=events)
        await start_all(seeder, leecher)
        try:
            seeder.seed(mi, NS)
            failpoints.FAILPOINTS.arm("p2p.conn.send.delay", "always+delay:20")
            pull = asyncio.ensure_future(leecher.download(NS, mi.digest))
            try:
                async with asyncio.timeout(15):
                    while not leecher._controls:
                        await asyncio.sleep(0.005)
                    (ctl,) = leecher._controls.values()
                    base = sum(ctl.dispatcher._plane0.values())
                    while sum(prof.plane_cumulative().values()) <= base:
                        await asyncio.sleep(0.005)
            finally:
                failpoints.FAILPOINTS.disarm("p2p.conn.send.delay")
            await asyncio.wait_for(pull, 15)
            assert lstore.read_cache_file(mi.digest) == blob
        finally:
            await stop_all(seeder, leecher)

    prof.start()
    assert prof.running
    try:
        asyncio.run(main())
    finally:
        prof.stop()
        if stray_was_running:
            stray.start()
    assert not prof.running
    (summary,) = [e for e in events.events if e["name"] == "torrent_summary"]
    split = summary["plane_split"]
    cum = prof.plane_cumulative()
    assert split and all(0 < n <= cum[plane] for plane, n in split.items())
    assert samples.value() - before == sum(cum.values())
    # Every field of the reference's section is a port key (the nodes
    # read them); a key of neither is still refused.
    assert port_profiler.ProfilerConfig.from_dict({"dump_dir": "/tmp"}).dump_dir == "/tmp"
    with pytest.raises(ValueError, match="unknown profiling config keys"):
        port_profiler.ProfilerConfig.from_dict({"dump_path": "/tmp"})


def test_torrent_surface_matches_the_reference(tmp_path):
    """The ``Torrent`` methods the dispatcher and scheduler call agree with
    ``kraken_tpu``'s on the same pieces, and the bitfield sidecar one
    package flushes is read by the other."""
    blob = blob_of(10 * 1024 + 77, 9)
    mi = make_metainfo(blob, piece_length=1024)

    async def main():
        torrents = {}
        for name, pkg in PKGS.items():
            store = pkg.store.CAStore(str(tmp_path / name))
            verifier = (pkg.storage.BatchedVerifier(CPUPieceHasher()) if name == PORT
                        else pkg.storage.BatchedVerifier())
            t = pkg.storage.AgentTorrentArchive(store, verifier).create_torrent(mi_for(name, mi))
            for i in (0, 3, 4, mi.num_pieces - 1):
                await t.write_piece(i, blob[i * 1024 : (i + 1) * 1024])
            await t.flush_bits()
            assert await t.read_piece_async(3) == blob[3072:4096]
            t.release_fd()  # reopened by the next piece IO
            assert t.read_piece(4) == blob[4096:5120]
            torrents[name] = (t, store)
        (pt, pstore), (jt, jstore) = torrents[PORT], torrents[JAX]
        assert pt.bitfield() == jt.bitfield()
        assert pt.num_pieces_complete() == jt.num_pieces_complete() == 4
        assert pt.info_hash.hex == jt.info_hash.hex
        assert pt.blob_path == pstore.partial_path(pt.digest)
        # Each package reads the sidecar the other flushed.
        d_port = port_digest.Digest.from_hex(mi.digest.hex)
        d_jax = jax_digest.Digest.from_hex(mi.digest.hex)
        theirs = pstore.get_metadata(d_port, PieceStatusMetadata)
        assert bytes(theirs.bits) == jt.bitfield()
        jax_md = jax_store.PieceStatusMetadata
        assert bytes(jstore.get_metadata(d_jax, jax_md).bits) == pt.bitfield()
        for t, _ in torrents.values():
            t.close()

    asyncio.run(main())


def test_spool_backed_torrent_is_promoted(tmp_path):
    """``seed_partial``'s torrent reads the upload spool, and ``promote``
    repoints it at the committed path."""
    blob = blob_of(5000, 10)
    mi = make_metainfo(blob, piece_length=1024)
    store = port_store.CAStore(str(tmp_path / "s"))
    spool = str(tmp_path / "spool")
    with open(spool, "wb") as f:
        f.write(blob)
    t = port_storage.Torrent(store, mi, port_storage.BatchedVerifier(CPUPieceHasher()),
                             complete=True, path=spool)
    assert t.spool_backed and t.blob_path == spool and t.read_piece(4) == blob[4096:]
    t.close()
    uid = store.create_upload()
    store.write_upload_chunk(uid, 0, blob)
    store.commit_upload(uid, mi.digest)
    t = port_storage.Torrent(store, mi, port_storage.BatchedVerifier(CPUPieceHasher()),
                             complete=True, path=spool)
    t.promote(store.cache_path(mi.digest))
    os.unlink(spool)
    assert not t.spool_backed and t.read_piece(0) == blob[:1024]
    assert mi.num_pieces == 5 and t.bitfield() == bytes([0b11111])  # bit i = piece i
    t.close()
