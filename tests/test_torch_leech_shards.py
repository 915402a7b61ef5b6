"""The port's multi-core DOWNLOAD plane (``kraken_tpu_torch/p2p/
shardpool.py`` in leech mode): the five cases of
``tests/test_leech_shards.py`` against the port's schedulers, on the
``cpu`` hasher at a few MiB, every poll bounded; the leech plane's
control messages packed by ``msgpack_lite`` against ``msgpack``; the
profiler's shipping half (``drain_pending``, ``record_foreign``) against
the reference's for the same stacks; a slot's lifetime against a verify
that is cancelled while its thread copies the slot; and one pull through
a leech worker verified by the SHA-256 kernel's wrapper (its plain
version, on the CPU), which reads the shared ring as it would on the card.
"""

from __future__ import annotations

import asyncio
import collections
import os
import signal
import threading

import msgpack
import pytest

import kraken_tpu.utils.profiler as jax_profiler
from kraken_tpu_torch import CPUPieceHasher, TorchPieceHasher
from kraken_tpu_torch.ops import sha256_cuda
from kraken_tpu_torch.p2p.storage import BatchedVerifier
from kraken_tpu_torch.p2p.wire import MsgType
from kraken_tpu_torch.utils import failpoints, msgpack_lite
from kraken_tpu_torch.utils import profiler as port_profiler
from kraken_tpu_torch.utils.bufpool import SlabRing
from kraken_tpu_torch.utils.metrics import REGISTRY
from test_torch_shardpool import (  # noqa: F401 -- no_leftovers is autouse
    NS,
    FakeTracker,
    _poll,
    _read,
    blob_of,
    make_sched,
    no_leftovers,
    seeded,
)


def _leech_counter(name: str, shards: int = 8) -> float:
    c = REGISTRY.counter(name)
    return sum(c.value(shard=f"leech_shard{i}") for i in range(shards))


def _make_swarm(tmp_path, tracker, blob, piece_len, *, origins=1, leech_workers=1):
    mi = seeded(tracker, blob, piece_len)
    seeds = [make_sched(tmp_path, f"origin{i}", tracker, seed_blobs=[blob])[0]
             for i in range(origins)]
    agent, astore = make_sched(tmp_path, "agent", tracker, leech_workers=leech_workers)
    return mi, seeds, agent, astore


async def _assert_leases_drained(pool):
    await _poll(lambda: pool.slot_leases == 0,
                msg=f"{pool.slot_leases} ring slot leases never returned")


# -- the reference's five cases -----------------------------------------------


def test_leech_worker_pull_bit_identical_and_leases_returned(tmp_path):
    async def run():
        blob = blob_of(4 << 20, 11)
        tracker = FakeTracker()
        mi, seeds, agent, astore = _make_swarm(tmp_path, tracker, blob, 256 << 10)
        verify0 = REGISTRY.counter("verify_batches_total").value(path="host")
        pieces0 = _leech_counter("data_plane_worker_pieces_total")
        await seeds[0].start()
        try:
            seeds[0].seed(mi, NS)
            await agent.start()
            try:
                pool = agent._leech_pool
                assert pool is not None and pool.alive_workers == 1
                await asyncio.wait_for(agent.download(NS, mi.digest), 60)
                assert pool.num_conns >= 1, "conn never handed to shard"
                await _assert_leases_drained(pool)
                info = pool.worker_info()
                assert len(info) == 1 and info[0]["alive"]
                pids = [w["pid"] for w in info]
                assert REGISTRY.counter("verify_batches_total").value(path="host") > verify0
                await _poll(lambda: _leech_counter("data_plane_worker_pieces_total")
                            - pieces0 >= mi.num_pieces,
                            msg="pieces not counted through the leech shard")
            finally:
                await agent.stop()
            assert await _read(astore.cache_path(mi.digest)) == blob
            assert agent._leech_pool is None
        finally:
            await seeds[0].stop()
        for pid in pids:
            with pytest.raises(ProcessLookupError):
                os.kill(pid, 0)

    asyncio.run(run())


def test_mid_recv_disconnect_requeues_to_healthy_peer(tmp_path):
    """The worker's recv pump loses the conn mid-piece: the partial slot
    is freed, the request requeues, and the piece lands from a healthy
    peer -- a connectivity blip, not a ban."""

    async def run():
        blob = blob_of(2 << 20, 12)
        tracker = FakeTracker()
        failpoints.FAILPOINTS.arm("p2p.shard.leech.disconnect", "once")
        mi, seeds, agent, astore = _make_swarm(tmp_path, tracker, blob, 128 << 10, origins=2)
        for o in seeds:
            await o.start()
            o.seed(mi, NS)
        try:
            await agent.start()
            try:
                await asyncio.wait_for(agent.download(NS, mi.digest), 60)
                await _assert_leases_drained(agent._leech_pool)
                for o in seeds:
                    entry = agent.conn_state.blacklist._entries.get((o.peer_id, mi.info_hash))
                    assert entry is None or entry[1] == 0, (
                        "mid-recv disconnect hard-banned a healthy peer")
            finally:
                await agent.stop()
            assert await _read(astore.cache_path(mi.digest)) == blob
        finally:
            for o in seeds:
                await o.stop()
            failpoints.FAILPOINTS.disarm("p2p.shard.leech.disconnect")

    asyncio.run(run())


def test_corrupt_piece_in_worker_escalates_parent_blacklist(tmp_path):
    """A piece that lands corrupt in a worker's ring slot fails the
    PARENT's batched verify: hard blacklist of exactly its sender,
    requeue, and the corrupt bytes never reach the blob."""

    async def run():
        blob = blob_of(2 << 20, 13)
        tracker = FakeTracker()
        failpoints.FAILPOINTS.arm("p2p.shard.leech.corrupt", "once")
        mi, seeds, agent, astore = _make_swarm(tmp_path, tracker, blob, 128 << 10, origins=2)
        for o in seeds:
            await o.start()
            o.seed(mi, NS)
        try:
            await agent.start()
            try:
                await asyncio.wait_for(agent.download(NS, mi.digest), 60)
                banned = [o for o in seeds
                          if agent.conn_state.blacklist.blocked(o.peer_id, mi.info_hash)]
                assert len(banned) == 1, f"corrupt verdict banned {len(banned)} peers, want 1"
                await _assert_leases_drained(agent._leech_pool)
            finally:
                await agent.stop()
            assert await _read(astore.cache_path(mi.digest)) == blob
        finally:
            for o in seeds:
                await o.stop()
            failpoints.FAILPOINTS.disarm("p2p.shard.leech.corrupt")

    asyncio.run(run())


def test_leech_worker_sigkill_respawns_and_requeues(tmp_path):
    """SIGKILL the pump: the supervisor respawns the shard, the dead
    worker's conns close as the node's fault (no blacklist), and a second
    pull runs through the respawned worker. No leaked slot or process."""

    async def run():
        tracker = FakeTracker()
        blob1, blob2 = blob_of(1 << 20, 14), blob_of(1 << 20, 15)
        mi1, mi2 = seeded(tracker, blob1, 128 << 10), seeded(tracker, blob2, 128 << 10)
        origin, _ = make_sched(tmp_path, "origin", tracker, seed_blobs=[blob1, blob2])
        agent, astore = make_sched(tmp_path, "agent", tracker, leech_workers=1)
        await origin.start()
        try:
            origin.seed(mi1, NS)
            await agent.start()
            try:
                pool = agent._leech_pool
                crashes0 = _leech_counter("data_plane_worker_crashes_total")
                await asyncio.wait_for(agent.download(NS, mi1.digest), 60)
                assert pool.num_conns >= 1
                pid0 = pool.worker_info()[0]["pid"]
                os.kill(pid0, signal.SIGKILL)
                await _poll(lambda: pool.alive_workers == 1
                            and pool.worker_info()[0]["pid"] != pid0,
                            msg="killed leech shard never respawned")
                assert _leech_counter("data_plane_worker_crashes_total") > crashes0
                assert not agent.conn_state.blacklist.blocked(origin.peer_id, mi1.info_hash), (
                    "worker crash blamed on an innocent peer")
                await _assert_leases_drained(pool)
                origin.seed(mi2, NS)
                handoffs = REGISTRY.counter("data_plane_handoffs_total")
                h0 = handoffs.value(shard="leech_shard0")
                await asyncio.wait_for(agent.download(NS, mi2.digest), 60)
                assert handoffs.value(shard="leech_shard0") > h0, "respawn took no conn"
                await _assert_leases_drained(pool)
            finally:
                await agent.stop()
            assert await _read(astore.cache_path(mi2.digest)) == blob2
        finally:
            await origin.stop()

    asyncio.run(run())


def test_leech_pool_skips_shaped_and_oversize(tmp_path):
    """The handoff's negative gates: an ingress-shaped node and a torrent
    whose pieces are longer than a ring slot stay on the main loop, and
    their pulls still complete there."""

    async def run():
        from kraken_tpu_torch.utils.bandwidth import BandwidthLimiter

        tracker = FakeTracker()
        blob = blob_of(1 << 20, 16)
        mi = seeded(tracker, blob, 128 << 10)
        big = blob_of(6 << 20, 17)
        big_mi = seeded(tracker, big, 8 << 20)  # one 6 MiB piece > a 4 MiB slot
        origin, _ = make_sched(tmp_path, "origin", tracker, seed_blobs=[blob, big])
        shaped, sstore = make_sched(tmp_path, "shaped", tracker, leech_workers=1,
                                    bandwidth=BandwidthLimiter(ingress_bps=1 << 30))
        plain, pstore = make_sched(tmp_path, "plain", tracker, leech_workers=1)
        await origin.start()
        try:
            origin.seed(mi, NS)
            origin.seed(big_mi, NS)
            await shaped.start()
            await plain.start()
            try:
                await asyncio.wait_for(shaped.download(NS, mi.digest), 60)
                assert shaped._leech_pool.num_conns == 0, (
                    "shaped node handed a conn to the leech plane")
                assert plain._leech_pool.slot_bytes == 4 << 20
                await asyncio.wait_for(plain.download(NS, big_mi.digest), 60)
                assert plain._leech_pool.num_conns == 0, (
                    "a piece longer than a slot went to the leech plane")
            finally:
                await shaped.stop()
                await plain.stop()
            assert await _read(sstore.cache_path(mi.digest)) == blob
            assert await _read(pstore.cache_path(big_mi.digest)) == big
        finally:
            await origin.stop()

    asyncio.run(run())


# -- the leech plane's own contracts ------------------------------------------

LEECH_MESSAGES = {
    "piece": {"t": "piece", "cid": 3, "idx": 255, "slot": 7, "ln": 4 << 20},
    "frame": {"t": "frame", "cid": 3, "mt": int(MsgType.BITFIELD), "h": {},
              "p": bytes([255, 255, 3])},
    "drop": {"t": "drop", "slot": 7},
    "written_failed": {"t": "written", "slot": 7, "ok": False},
    "prof": {"t": "prof", "node": "agent/leech0",
             "stacks": [["MainThread;shardpool.py:run;selectors.py:select", 12],
                        ["MainThread;shardpool.py:_do_write;threading.py:wait", 3]],
             "planes": {"idle": 12, "pwrite": 3}},
    "ready": {"t": "ready", "pid": 4_194_303},
}


@pytest.mark.parametrize("name", sorted(LEECH_MESSAGES))
def test_leech_control_messages_pack_as_msgpack_does(name):
    msg = LEECH_MESSAGES[name]
    packed = msgpack_lite.packb(msg)
    assert packed == msgpack.packb(msg)
    assert msgpack_lite.unpackb(packed) == msgpack.unpackb(packed)


STACKS = [(f"MainThread;shardpool.py:run;f{i % 7}.py:g{i}", plane)
          for i, plane in zip(range(40), ["pump", "pwrite", "idle", "other"] * 10)]


@pytest.mark.parametrize("max_stacks", [1, 16, 64])
def test_drain_pending_and_record_foreign_match_the_reference(max_stacks):
    """The same stacks, sampled in a worker of each package, ship home in
    the same batches and fold into the parent's collapse alike."""
    disabled = {"enabled": False}
    port_w = port_profiler.SamplingProfiler(port_profiler.ProfilerConfig.from_dict(disabled))
    jax_w = jax_profiler.SamplingProfiler(jax_profiler.ProfilerConfig.from_dict(disabled))
    port_p = port_profiler.SamplingProfiler(port_profiler.ProfilerConfig.from_dict(disabled))
    jax_p = jax_profiler.SamplingProfiler(jax_profiler.ProfilerConfig.from_dict(disabled))
    for w in (port_w, jax_w):
        w.restart_in_child("agent/leech0")
        assert not w.running and w._in_child
        for n, (stack, plane) in enumerate(STACKS):
            w._pending[stack] += n % 5 + 1
            w._pending_planes[plane] += n % 5 + 1
    batches = {"port": [], "jax": []}
    for key, w in (("port", port_w), ("jax", jax_w)):
        while (batch := w.drain_pending(max_stacks=max_stacks)) is not None:
            batches[key].append(batch)
    assert batches["port"] == batches["jax"] and batches["port"]
    for batch in batches["port"]:
        port_p.record_foreign(batch["node"], batch["stacks"], batch["planes"])
        jax_p.record_foreign(batch["node"], batch["stacks"], batch["planes"])
    assert port_p.folded() == jax_p.folded()
    assert port_p.plane_totals() == jax_p.plane_totals()
    assert port_p.plane_cumulative() == jax_p.plane_cumulative()
    assert port_p.snapshot()["foreign_samples"] == jax_p.snapshot()["foreign_samples"]
    assert port_p.folded(include_foreign=False) == []
    want = collections.Counter()
    for n, (stack, _plane) in enumerate(STACKS):
        want[f"agent/leech0;{stack}"] += n % 5 + 1
    assert dict(port_p.folded()) == dict(want)


def test_a_cancelled_verify_returns_its_slot_only_after_the_copy():
    """A conn torn down while its piece is in a verify batch cancels the
    payload task; the slot's drop (the task's done-callback) must come
    after the verify thread has copied the slot, or the worker could
    reuse the slot under the copy."""
    events: list[str] = []
    copying, finish = threading.Event(), threading.Event()

    class SlowCopy(CPUPieceHasher):
        def hash_batch(self, pieces):
            events.append("copy start")
            copying.set()
            finish.wait(10)
            out = super().hash_batch(pieces)
            events.append("copy end")
            return out

    ring = SlabRing(2, 64 << 10)
    slot = ring.lease()
    view = ring.view(slot, 64 << 10)
    view[:] = blob_of(64 << 10, 18)

    async def run():
        verifier = BatchedVerifier(SlowCopy())
        task = asyncio.create_task(verifier.verify(view, b"\0" * 32))
        task.add_done_callback(lambda _t: events.append("drop"))
        await asyncio.to_thread(copying.wait, 10)
        task.cancel()
        await asyncio.sleep(0.2)
        assert events == ["copy start"], "the slot dropped while the copy ran"
        finish.set()
        with pytest.raises(asyncio.CancelledError):
            await task

    asyncio.run(run())
    assert events == ["copy start", "copy end", "drop"]
    ring.release(slot)
    ring.close()


def test_a_pull_through_a_leech_worker_verifies_on_the_kernels_wrapper(tmp_path):
    """The agent's verify reads the worker's ring through
    ``TorchPieceHasher`` (on the CPU its wrapper runs the plain version;
    on the card it launches the kernel): pieces land byte-identical and
    the wrapper saw every one."""

    async def run():
        blob = blob_of(64 << 10, 19)
        tracker = FakeTracker()
        mi = seeded(tracker, blob, 4 << 10)
        origin, _ = make_sched(tmp_path, "origin", tracker, seed_blobs=[blob], workers=1)
        agent, astore = make_sched(tmp_path, "agent", tracker, leech_workers=1,
                                   hasher=TorchPieceHasher(device="cpu"))
        rows = REGISTRY.counter("hasher_pieces_total")
        rows0 = rows.value(hasher="cuda")
        await origin.start()
        try:
            origin.seed(mi, NS)
            await agent.start()
            try:
                await asyncio.wait_for(agent.download(NS, mi.digest), 120)
                assert agent._leech_pool.num_conns >= 1
                await _assert_leases_drained(agent._leech_pool)
            finally:
                await agent.stop()
            assert await _read(astore.cache_path(mi.digest)) == blob
        finally:
            await origin.stop()
        return rows.value(hasher="cuda") - rows0

    launches = dict(sha256_cuda.LAUNCHES)
    assert asyncio.run(run()) >= 16
    assert sha256_cuda.LAUNCHES == launches  # the CPU route launches nothing


def test_a_dead_workers_slot_verdicts_never_reach_its_respawn():
    """A verify that finishes after its worker died holds a lease on the
    dead worker's ring. Its ``write`` fails (the piece requeues) and its
    ``drop`` goes nowhere: the respawned shard's fresh ring reuses the
    slot numbers, and a verdict meant for the old ring would free or
    pwrite a slot the new worker has leased."""
    from kraken_tpu_torch.p2p.shardpool import ShardPool, _SlotLease

    async def run():
        pool = ShardPool(1, leech=True, ring_slots=2, slot_bytes=64 << 10,
                         component="test-leech")
        pool.start()
        try:
            old = pool._workers[0]
            drop, write = _SlotLease(pool, old, 0, "ab"), _SlotLease(pool, old, 1, "ab")
            pool.slot_leases += 2
            os.kill(old.proc.pid, signal.SIGKILL)
            await _poll(lambda: pool._workers.get(0) not in (None, old)
                        and pool.alive_workers == 1, timeout=15,
                        msg="the shard never respawned")
            sent = []
            send = pool._send
            pool._send = lambda w, msg: sent.append(msg)
            try:
                drop.release()
                with pytest.raises(ConnectionError):
                    await write.remote_write(3)
            finally:
                pool._send = send
            assert sent == [] and pool.slot_leases == 0
        finally:
            await pool.stop()

    asyncio.run(run())
