"""The port's multi-core seed-serve plane (``kraken_tpu_torch/p2p/
shardpool.py``): the seven cases of ``tests/test_shardpool.py`` against
the port's schedulers, on the ``cpu`` hasher at a few MiB, every poll
bounded; the control channel's messages packed by ``msgpack_lite`` against
``msgpack``; ``record_data_plane_shard``'s exposition against the
reference's; a ``SlabRing`` written in a forked child and read in the
parent; and pulls through workers across the two packages, both ways.

Every test stops every pool it starts: the ``no_leftovers`` fixture
asserts that no child process outlives a test and that no sampler or SLO
evaluator was left running by it."""

from __future__ import annotations

import asyncio
import multiprocessing
import os
import signal
import time

import msgpack
import numpy as np
import pytest

import kraken_tpu.p2p.connstate as jax_connstate
import kraken_tpu.utils.metrics as jax_metrics
import kraken_tpu.utils.profiler as jax_profiler
import kraken_tpu.utils.slo as jax_slo
import kraken_tpu_torch.utils.metrics as port_metrics
from kraken_tpu_torch import CPUPieceHasher
from kraken_tpu_torch.core.peer import PeerID
from kraken_tpu_torch.p2p.connstate import ConnStateConfig
from kraken_tpu_torch.p2p.scheduler import Scheduler, SchedulerConfig
from kraken_tpu_torch.p2p.wire import Message, MsgType, recv_message, send_message
from kraken_tpu_torch.utils import failpoints, msgpack_lite
from kraken_tpu_torch.utils.bufpool import SlabRing
from kraken_tpu_torch.utils.metrics import REGISTRY
from kraken_tpu_torch.utils.profiler import PROFILER
from kraken_tpu_torch.utils.slo import SLO
from test_torch_swarm import JAX, PKGS, PORT, FakeTracker, make_metainfo

NS = "test-shard"


@pytest.fixture(autouse=True)
def no_leftovers():
    """No test of the plane may leave a worker process, a sampler or an
    SLO evaluator behind (of either package)."""
    running = _threads()
    yield
    deadline = time.monotonic() + 5.0
    while multiprocessing.active_children() and time.monotonic() < deadline:
        time.sleep(0.05)
    assert multiprocessing.active_children() == []
    assert _threads() == running


def _threads() -> tuple:
    """Whether each package's sampler and SLO evaluator thread runs."""
    return (PROFILER.running, SLO.running, jax_profiler.PROFILER.running,
            jax_slo.SLO._thread is not None)


def blob_of(n: int, seed: int) -> bytes:
    return np.random.default_rng(seed).integers(0, 256, n, dtype=np.uint8).tobytes()


def make_sched(root, name, tracker, *, seed_blobs=None, workers=0, leech_workers=0,
               bandwidth=None, churn_idle=4.0, pkg=PORT, hasher=None):
    """A scheduler of package ``pkg`` on its own store, holding
    ``seed_blobs`` committed (origin-style) when given; port peers verify
    on ``hasher``, the ``cpu`` hasher by default."""
    p = PKGS[pkg]
    store = p.store.CAStore(os.path.join(str(root), name))
    ref: dict = {}
    is_origin = seed_blobs is not None
    verifier = (p.storage.BatchedVerifier(hasher or CPUPieceHasher()) if pkg == PORT
                else p.storage.BatchedVerifier())
    if is_origin:
        for blob in seed_blobs:
            store.create_cache_file(p.digest.Digest.from_bytes(blob), iter([blob]))
        archive = p.storage.OriginTorrentArchive(store, verifier)
    else:
        archive = p.storage.AgentTorrentArchive(store, verifier)
    client = tracker.client_for(ref, p)
    conn_state = ConnStateConfig if pkg == PORT else jax_connstate.ConnStateConfig
    sched = p.scheduler.Scheduler(
        peer_id=p.peer.PeerID(os.urandom(20).hex()),
        ip="127.0.0.1",
        port=0,
        archive=archive,
        metainfo_client=client,
        announce_client=client,
        is_origin=is_origin,
        bandwidth=bandwidth,
        config=p.scheduler.SchedulerConfig(
            announce_interval_seconds=0.2,
            retry_tick_seconds=0.2,
            max_announce_rate=2000.0,
            data_plane_workers=workers,
            leech_workers=leech_workers,
            conn_churn_idle_seconds=churn_idle,
            conn_state=conn_state(max_open_conns_per_torrent=64 if is_origin else 10),
        ),
    )
    ref["s"] = sched
    return sched, store


def seeded(tracker, blob: bytes, piece_len: int):
    mi = make_metainfo(blob, piece_len)
    tracker.add(mi)
    return mi


def pkg_mi(mi, pkg):
    """``mi`` as package ``pkg``'s MetaInfo."""
    return PKGS[pkg].metainfo.MetaInfo.deserialize(mi.serialize())


async def _poll(cond, timeout: float = 10.0, msg: str = ""):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return
        await asyncio.sleep(0.05)
    raise AssertionError(f"condition never held: {msg}")


def _shard_counter(name: str, prefix: str = "data_plane_shard", registry=REGISTRY,
                   shards: int = 8) -> float:
    c = registry.counter(name)
    return sum(c.value(shard=f"{prefix}{i}") for i in range(shards))


async def _read(path: str) -> bytes:
    def read() -> bytes:
        with open(path, "rb") as f:
            return f.read()

    return await asyncio.to_thread(read)


# -- the reference's seven cases ----------------------------------------------


def test_worker_shard_serves_bit_identical_pull(tmp_path):
    async def run():
        blob = blob_of(4 << 20, 1)
        tracker = FakeTracker()
        mi = seeded(tracker, blob, 256 << 10)
        origin, _ = make_sched(tmp_path, "origin", tracker, seed_blobs=[blob], workers=2)
        agent, astore = make_sched(tmp_path, "agent", tracker)
        handoffs0 = _shard_counter("data_plane_handoffs_total")
        await origin.start()
        try:
            origin.seed(mi, NS)
            await agent.start()
            try:
                await asyncio.wait_for(agent.download(NS, mi.digest), 60)
            finally:
                await agent.stop()
            assert await _read(astore.cache_path(mi.digest)) == blob
            # The serve really went through a shard, not the main loop.
            assert _shard_counter("data_plane_handoffs_total") > handoffs0
            info = origin._shardpool.worker_info()
            assert len(info) == 2 and all(w["alive"] for w in info)
            pids = [w["pid"] for w in info]
        finally:
            await origin.stop()
        for pid in pids:
            with pytest.raises(ProcessLookupError):
                os.kill(pid, 0)
        assert origin._shardpool is None

    asyncio.run(run())


def test_mid_serve_disconnect_failpoint_recovers(tmp_path):
    """A shard drops the conn mid-serve; the leecher redials (soft
    cool-off, not a ban) and the pull finishes bit-identically."""

    async def run():
        blob = blob_of(2 << 20, 2)
        tracker = FakeTracker()
        mi = seeded(tracker, blob, 128 << 10)
        # Armed BEFORE the origin starts: the forked shard inherits it.
        failpoints.FAILPOINTS.arm("p2p.shard.serve.disconnect", "once")
        origin, _ = make_sched(tmp_path, "origin", tracker, seed_blobs=[blob], workers=1)
        agent, astore = make_sched(tmp_path, "agent", tracker)
        await origin.start()
        try:
            origin.seed(mi, NS)
            await agent.start()
            try:
                await asyncio.wait_for(agent.download(NS, mi.digest), 60)
            finally:
                await agent.stop()
            assert await _read(astore.cache_path(mi.digest)) == blob
        finally:
            await origin.stop()
            failpoints.FAILPOINTS.disarm("p2p.shard.serve.disconnect")

    asyncio.run(run())


def test_eviction_while_serving_requeues_to_healthy_peer(tmp_path):
    """The blob leaves the origin mid-pull: its shard conns close
    gracefully and the leecher finishes from another seeder."""

    async def run():
        from kraken_tpu_torch.utils.bandwidth import BandwidthLimiter

        blob = blob_of(4 << 20, 3)
        tracker = FakeTracker()
        mi = seeded(tracker, blob, 128 << 10)
        origin, _ = make_sched(tmp_path, "origin", tracker, seed_blobs=[blob], workers=1)
        seeder, _ = make_sched(tmp_path, "seeder", tracker)
        # Throttled leecher: the pull outlives the mid-flight eviction.
        leech, lstore = make_sched(tmp_path, "leech", tracker,
                                   bandwidth=BandwidthLimiter(ingress_bps=4 << 20))
        await origin.start()
        try:
            origin.seed(mi, NS)
            await seeder.start()
            await leech.start()
            try:
                await asyncio.wait_for(seeder.download(NS, mi.digest), 60)
                pull = asyncio.create_task(leech.download(NS, mi.digest))
                await _poll(lambda: origin._shardpool.num_conns > 0,
                            msg="no shard conn formed")
                assert origin.unseed(mi.digest), "origin was not seeding?"
                await asyncio.wait_for(pull, 90)
                await _poll(lambda: origin._shardpool.num_conns == 0,
                            msg="shard conns survived eviction")
            finally:
                await leech.stop()
                await seeder.stop()
            assert await _read(lstore.cache_path(mi.digest)) == blob
        finally:
            await origin.stop()

    asyncio.run(run())


async def _raw_handshake(origin: Scheduler, mi, peer_hex: str | None = None):
    """Dial the origin's p2p port as a hand-rolled leecher."""
    reader, writer = await asyncio.open_connection("127.0.0.1", origin.port)
    peer_hex = peer_hex or os.urandom(20).hex()
    bits = bytes((mi.num_pieces + 7) // 8)
    await send_message(writer, Message.handshake(
        peer_hex, mi.info_hash.hex, mi.digest.hex, NS, bits, mi.num_pieces))
    theirs = await asyncio.wait_for(recv_message(reader), 10)
    assert theirs.type == MsgType.HANDSHAKE
    return reader, writer, peer_hex


async def _read_piece_payload(reader, expect_index: int, expect_len: int) -> bytes:
    while True:
        msg = await asyncio.wait_for(recv_message(reader), 15)
        if msg.type == MsgType.PIECE_PAYLOAD:
            assert msg.header["index"] == expect_index
            assert len(msg.payload) == expect_len
            return bytes(msg.payload)


def test_worker_misbehavior_verdict_reaches_parent_blacklist(tmp_path):
    async def run():
        blob = blob_of(512 << 10, 4)
        tracker = FakeTracker()
        mi = seeded(tracker, blob, 128 << 10)
        origin, _ = make_sched(tmp_path, "origin", tracker, seed_blobs=[blob], workers=1)
        await origin.start()
        try:
            origin.seed(mi, NS)
            reader, writer, peer_hex = await _raw_handshake(origin, mi)
            await send_message(writer, Message.piece_request(0))
            assert await _read_piece_payload(reader, 0, 128 << 10) == blob[: 128 << 10]
            await send_message(writer, Message.piece_request(10**6))
            peer = PeerID(peer_hex)
            await _poll(lambda: origin.conn_state.blacklist.blocked(peer, mi.info_hash),
                        msg="worker misbehavior verdict never reached the blacklist")
            writer.close()
        finally:
            await origin.stop()

    asyncio.run(run())


def test_lameduck_drain_lets_worker_conn_finish(tmp_path):
    """A draining node refuses NEW conns but a shard's in-flight conn
    keeps serving, and the drain's quiesce signal counts it until it
    closes."""

    async def run():
        from kraken_tpu_torch.p2p.conn import PeerBusyError, handshake_outbound

        blob = blob_of(512 << 10, 5)
        tracker = FakeTracker()
        mi = seeded(tracker, blob, 128 << 10)
        origin, _ = make_sched(tmp_path, "origin", tracker, seed_blobs=[blob], workers=1,
                               churn_idle=1.0)
        await origin.start()
        try:
            origin.seed(mi, NS)
            reader, writer, _ = await _raw_handshake(origin, mi)
            await send_message(writer, Message.piece_request(0))
            await _read_piece_payload(reader, 0, 128 << 10)
            assert origin.num_active_conns == 1  # counts the shard conn
            origin.enter_lameduck()
            await send_message(writer, Message.piece_request(1))
            data = await _read_piece_payload(reader, 1, 128 << 10)
            assert data == blob[128 << 10: 256 << 10]
            r2, w2 = await asyncio.open_connection("127.0.0.1", origin.port)
            with pytest.raises(PeerBusyError):
                await handshake_outbound(
                    r2, w2, PeerID(os.urandom(20).hex()), mi.info_hash, mi.digest.hex, NS,
                    bytes((mi.num_pieces + 7) // 8), mi.num_pieces, timeout=5.0)
            w2.close()
            writer.close()
            await _poll(lambda: origin.num_active_conns == 0,
                        msg="drain quiesce signal never reached 0")
        finally:
            await origin.stop()

    asyncio.run(run())


def test_reload_resizes_pool_and_crash_respawns(tmp_path):
    async def run():
        tracker = FakeTracker()
        origin, _ = make_sched(tmp_path, "origin", tracker, seed_blobs=[b"x" * 1024], workers=1)
        await origin.start()
        try:
            pool = origin._shardpool
            assert pool.alive_workers == 1

            def cfg(workers: int) -> SchedulerConfig:
                return SchedulerConfig.from_dict({"data_plane_workers": workers})

            origin.reload(cfg(3))
            await _poll(lambda: pool.alive_workers == 3, msg="grow to 3")
            assert REGISTRY.gauge("data_plane_workers").value(component="origin") == 3
            origin.reload(cfg(1))
            await _poll(lambda: pool.alive_workers == 1 and len(pool.worker_info()) == 1,
                        msg="shrink to 1")
            crashes0 = _shard_counter("data_plane_worker_crashes_total")
            pid = pool.worker_info()[0]["pid"]
            os.kill(pid, signal.SIGKILL)
            await _poll(lambda: pool.alive_workers == 1 and pool.worker_info()[0]["pid"] != pid,
                        msg="crashed shard never respawned")
            assert _shard_counter("data_plane_worker_crashes_total") > crashes0
        finally:
            await origin.stop()

    asyncio.run(run())


def test_sentinel_aggregates_workers_and_flags_dead_shard(tmp_path):
    """The resource sentinel folds the workers' fds and RSS into its
    sample, and a dead shard is a breach."""

    async def run():
        from kraken_tpu_torch.utils.resources import ResourceSentinel, ResourcesConfig

        tracker = FakeTracker()
        origin, ostore = make_sched(tmp_path, "origin", tracker, seed_blobs=[b"y" * 2048],
                                    workers=2)
        await origin.start()
        try:
            sentinel = ResourceSentinel("origin-test", ResourcesConfig(interval_seconds=3600.0),
                                        scheduler=origin, store=ostore)
            sample = await sentinel.sample()
            assert sample["workers_expected"] == 2
            assert sample["workers_alive"] == 2
            assert sample["worker_fds"] > 0, "child fds not aggregated"
            assert sample["worker_rss_bytes"] > 0, "child RSS not aggregated"
            assert sample["open_fds"] > sample["worker_fds"]
            assert not sample["breached"]
            sentinel.stop()

            class _DeadShardPool:
                expected_workers = 2

                def worker_info(self):
                    return [{"shard": 0, "pid": os.getpid(), "alive": True},
                            {"shard": 1, "pid": None, "alive": False}]

            class _Sched:
                _shardpool = _DeadShardPool()
                _bufpool = None
                num_active_conns = 0

            breaches = REGISTRY.counter("resource_budget_breaches_total")
            b0 = breaches.value(kind="workers")
            s2 = ResourceSentinel("origin-test-dead", ResourcesConfig(), scheduler=_Sched())
            sample2 = s2._finish_sample({})
            assert "workers" in sample2["breached"]
            assert sample2["workers_alive"] == 1
            assert breaches.value(kind="workers") == b0 + 1
            s2.stop()
        finally:
            await origin.stop()

    asyncio.run(run())


# -- the control channel, the exposition, the ring ----------------------------

CONTROL_MESSAGES = {
    "handoff": {"t": "conn", "cid": 7, "peer": "ab" * 20, "ih": "cd" * 20,
                "name": "ef" * 32, "plen": 4 << 20, "len": (1 << 30) + 12345,
                "np": 257, "path": "/store/cache/ef/ef/efef", "residual": b"\x05\x00\x00",
                "tp": "00-" + "1" * 32 + "-" + "2" * 16 + "-01", "leech": True, "wr": True,
                "have": bytes([0b10110001, 0, 255, 1])},
    "stats": {"t": "stats", "conns": 3, "bytes_up": 1 << 33, "serves": 2048,
              "bytes_down": 0, "pieces": 0, "cpu_s": 12.375, "lameduck": False},
    "verdict_closed": {"t": "closed", "cid": 7, "reason": "misbehavior",
                       "detail": "piece index out of range: 1000000", "mis": True},
    "verdict_write": {"t": "write", "name": "ef" * 32, "slot": 5, "idx": 200},
    "written": {"t": "written", "slot": 5, "ok": True},
    "send": {"t": "send", "cid": 7, "frames": [[int(MsgType.PIECE_REQUEST), {"index": 3}, b""],
                                                [int(MsgType.ANNOUNCE_PIECE), {"index": 9}, b""]]},
    "spans": {"t": "spans", "spans": [{"trace_id": "a" * 32, "span_id": "b" * 16,
                                       "name": "p2p.shard.serve", "duration_s": 0.0125,
                                       "attrs": {"piece": 4, "peer": "ab" * 6},
                                       "node": "origin/shard0"}]},
}


@pytest.mark.parametrize("name", sorted(CONTROL_MESSAGES))
def test_control_messages_pack_as_msgpack_does(name):
    msg = CONTROL_MESSAGES[name]
    packed = msgpack_lite.packb(msg)
    assert packed == msgpack.packb(msg)
    assert msgpack_lite.unpackb(packed) == msgpack.unpackb(packed)


def test_record_data_plane_shard_renders_as_the_references():
    calls = [
        ("data_plane_shard0", dict(conns=2, bytes_delta=4 << 20, serves_delta=1,
                                   cpu_seconds=0.5)),
        ("data_plane_shard1", dict(conns=0, bytes_delta=0, serves_delta=0, cpu_seconds=0.0)),
        ("leech_shard0", dict(conns=1, bytes_delta=0, serves_delta=0, cpu_seconds=1.25,
                              bytes_down_delta=8 << 20, pieces_delta=2)),
        ("data_plane_shard0", dict(conns=1, bytes_delta=12 << 20, serves_delta=3,
                                   cpu_seconds=0.75)),
    ]
    port, ref = port_metrics.Registry(), jax_metrics.Registry()
    for shard, kw in calls:
        port_metrics.record_data_plane_shard(shard, registry=port, **kw)
        jax_metrics.record_data_plane_shard(shard, registry=ref, **kw)
    assert port.render() == ref.render()
    assert "data_plane_worker_pieces_total" in port.render()


def test_a_slab_ring_written_in_a_forked_child_reads_in_the_parent():
    ring = SlabRing(4, 100 << 10)
    assert ring.slot_bytes == 128 << 10
    slot = ring.lease()
    payload = blob_of(100 << 10, 6)

    def child() -> None:
        ring.view(slot, len(payload))[:] = payload
        ring.view(slot, 1)[0] ^= 0x5A

    proc = multiprocessing.get_context("fork").Process(target=child)
    proc.start()
    proc.join(10)
    assert proc.exitcode == 0
    proc.close()
    want = bytes([payload[0] ^ 0x5A]) + payload[1:]
    assert bytes(ring.view(slot, len(payload))) == want
    ring.release(slot)
    assert ring.leased == 0
    with pytest.raises(ValueError):
        ring.view(4, 1)
    ring.close()


# -- across the packages ------------------------------------------------------


@pytest.mark.parametrize("seeder_pkg,leecher_pkg", [(JAX, PORT), (PORT, JAX)])
def test_a_pull_through_workers_across_the_packages(tmp_path, seeder_pkg, leecher_pkg):
    """A seeder of one package serving from a seed-serve worker to a
    leecher of the other pumping through a leech worker: the blob lands
    byte-identical and both planes carried it."""

    async def run():
        blob = blob_of(2 << 20, 7 if seeder_pkg == JAX else 8)
        tracker = FakeTracker()
        mi = seeded(tracker, blob, 128 << 10)
        origin, _ = make_sched(tmp_path, "origin", tracker, seed_blobs=[blob], workers=1,
                               pkg=seeder_pkg)
        agent, astore = make_sched(tmp_path, "agent", tracker, leech_workers=1,
                                   pkg=leecher_pkg)
        regs = {PORT: REGISTRY, JAX: jax_metrics.REGISTRY}
        served0 = _shard_counter("data_plane_worker_bytes_sent_total",
                                 registry=regs[seeder_pkg])
        landed0 = _shard_counter("data_plane_worker_pieces_total", "leech_shard",
                                 registry=regs[leecher_pkg])
        await origin.start()
        try:
            origin.seed(pkg_mi(mi, seeder_pkg), NS)
            await agent.start()
            try:
                d = pkg_mi(mi, leecher_pkg).digest
                await asyncio.wait_for(agent.download(NS, d), 60)
                assert agent._leech_pool.num_conns >= 1
                await _poll(lambda: agent._leech_pool.slot_leases == 0, msg="leases")
                await _poll(lambda: _shard_counter(
                    "data_plane_worker_pieces_total", "leech_shard",
                    registry=regs[leecher_pkg]) - landed0 >= mi.num_pieces,
                    msg="pieces through the leech worker")
                await _poll(lambda: _shard_counter(
                    "data_plane_worker_bytes_sent_total", registry=regs[seeder_pkg])
                    - served0 >= len(blob), msg="bytes through the seed worker")
            finally:
                await agent.stop()
            assert await _read(astore.cache_path(d)) == blob
        finally:
            await origin.stop()

    asyncio.run(run())

