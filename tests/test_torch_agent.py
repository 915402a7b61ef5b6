"""The port's ``AgentServer`` against the reference's: the same requests to
both, served by their own HTTP stacks (``http_lite`` and ``aiohttp``), give
the same status codes, bodies and drain headers -- a pull on a cache miss,
a hit, a range, stat, delete (unseed), the timeout and failure answers,
``/health``, ``/readiness`` and the 503s while draining. Then a cancelled
pull leaves no verify flush pending, and a real port agent pulls from a
seeder through its HTTP API."""

import asyncio

import aiohttp
import numpy as np
import pytest
from aiohttp import web

import kraken_tpu.agent.server as jax_agent
import kraken_tpu.core.digest as jax_digest
import kraken_tpu.store as jax_store
import kraken_tpu_torch.agent.server as port_agent
import kraken_tpu_torch.core.digest as port_digest
import kraken_tpu_torch.store as port_store
from kraken_tpu_torch import CPUPieceHasher
from kraken_tpu_torch.p2p.storage import BatchedVerifier
from kraken_tpu_torch.utils import http_lite

PKG = {
    "jax": (jax_agent, jax_store, jax_digest),
    "port": (port_agent, port_store, port_digest),
}


def blob_of(n: int, seed: int) -> bytes:
    return np.random.default_rng(seed).integers(0, 256, n, dtype=np.uint8).tobytes()


class FakeScheduler:
    """What AgentServer calls on its scheduler: ``download`` puts the blob
    into the store (or sleeps, or fails), ``unseed`` records."""

    def __init__(self, store, blobs: dict[str, bytes]):
        self.store = store
        self.blobs = blobs
        self.unseeded: list[str] = []
        self.num_active_conns = 0
        self._server = object()

    async def download(self, ns: str, d) -> None:
        data = self.blobs[d.hex]
        if data == b"slow":
            await asyncio.sleep(30)
        if data == b"fail":
            raise RuntimeError("boom")
        self.store.create_cache_file(d, iter([data]))

    def unseed(self, d) -> None:
        self.unseeded.append(d.hex)

    def enter_lameduck(self) -> None:
        self.lameduck = True


async def serve(kind: str, tmp_path, blobs):
    agent_mod, store_mod, _ = PKG[kind]
    store = store_mod.CAStore(str(tmp_path / kind))
    sched = FakeScheduler(store, blobs)
    server = agent_mod.AgentServer(store, sched, download_timeout_seconds=0.3)
    app = server.make_app()
    if kind == "port":
        runner, port = await http_lite.serve(app, "127.0.0.1", 0)
    else:
        runner = web.AppRunner(app, handler_cancellation=True)
        await runner.setup()
        site = web.TCPSite(runner, "127.0.0.1", 0)
        await site.start()
        port = site._server.sockets[0].getsockname()[1]
    return f"http://127.0.0.1:{port}", server, sched, runner.cleanup


def test_the_port_agent_server_answers_as_the_references(tmp_path):
    good, gone = blob_of(70_000, 1), blob_of(5_000, 2)
    hx = {name: port_digest.Digest.from_bytes(b).hex for name, b in
          (("good", good), ("gone", gone), ("slow", b"slow"), ("fail", b"fail"))}
    blobs = {hx["good"]: good, hx["gone"]: gone, hx["slow"]: b"slow", hx["fail"]: b"fail"}

    def script(base):
        b = f"{base}/namespace/library%2Fns/blobs"
        return [
            ("GET", f"{base}/health", {}),
            ("GET", f"{base}/readiness", {}),
            ("GET", f"{b}/{hx['good']}/stat", {}),
            ("GET", f"{b}/{hx['good']}", {}),  # miss -> pull -> serve
            ("GET", f"{b}/sha256:{hx['good']}", {}),  # hit
            ("GET", f"{b}/{hx['good']}", {"Range": "bytes=100-199"}),
            ("GET", f"{b}/{hx['good']}/stat", {}),
            ("GET", f"{b}/not-a-digest", {}),
            ("GET", f"{b}/{hx['slow']}", {}),
            ("GET", f"{b}/{hx['fail']}", {}),
            ("GET", f"{b}/{hx['gone']}", {}),
            ("DELETE", f"{base}/blobs/{hx['gone']}", {}),
            ("GET", f"{b}/{hx['gone']}/stat", {}),
            ("GET", f"{base}/debug/lameduck", {}),
            ("POST", f"{base}/debug/lameduck", {}),
            ("GET", f"{base}/health", {}),
            ("GET", f"{base}/readiness", {}),
            ("GET", f"{b}/{hx['gone']}", {}),  # a miss while draining: 503
            ("GET", f"{b}/{hx['good']}", {}),  # a hit still serves
        ]

    async def run(kind):
        base, server, sched, stop = await serve(kind, tmp_path, blobs)
        out = []
        try:
            async with aiohttp.ClientSession() as s:
                for method, url, headers in script(base):
                    async with s.request(method, url, headers=headers) as r:
                        out.append((method, url[len(base):], r.status,
                                    r.headers.get("Retry-After"), await r.read()))
            return out, sched.unseeded, server.inflight_work, sched.lameduck
        finally:
            await stop()

    async def main():
        return await run("jax"), await run("port")

    (ref, ref_unseeded, ref_inflight, ref_ld), (got, got_unseeded, got_inflight, got_ld) = (
        asyncio.run(main()))
    assert got == ref
    statuses = [r[2] for r in got]
    assert statuses == [200, 200, 404, 200, 200, 206, 200, 400, 504, 500, 200, 204, 404,
                        200, 200, 503, 503, 503, 200]
    assert got[3][4] == good and got[5][4] == good[100:200]
    assert got_unseeded == ref_unseeded == [hx["gone"]]
    assert got_inflight == ref_inflight == 0
    assert got_ld is ref_ld is True  # the drain reached the scheduler


def test_readiness_waits_for_the_scheduler(tmp_path):
    async def main():
        base, _server, sched, stop = await serve("port", tmp_path, {})
        sched._server = None
        try:
            async with aiohttp.ClientSession() as s:
                async with s.get(f"{base}/readiness") as r:
                    return r.status, await r.text()
        finally:
            await stop()

    assert asyncio.run(main()) == (503, "scheduler not started")


def test_a_cancelled_verify_leaves_no_flush_pending():
    """The agent's pull runs under ``asyncio.wait_for``: a pull cut at its
    timeout cancels the verify waiters it had queued. The flush that
    follows drops them and resolves the rest; nothing stays queued."""
    v = BatchedVerifier(hasher=CPUPieceHasher(), max_delay_seconds=0.05)
    pieces = [blob_of(1000, i) for i in range(4)]
    digests = CPUPieceHasher().hash_batch(pieces)

    async def main():
        cut = [asyncio.create_task(v.verify(p, bytes(d))) for p, d in zip(pieces[:2], digests)]
        kept = [asyncio.create_task(v.verify(p, bytes(d))) for p, d in zip(pieces[2:], digests[2:])]
        with pytest.raises(asyncio.TimeoutError):
            await asyncio.wait_for(asyncio.gather(*cut), 0.01)
        ok = await asyncio.gather(*kept)
        await asyncio.sleep(0.1)
        return ok, v._queue, v._inflight, v._flusher.done()

    ok, queue, inflight, flushed = asyncio.run(main())
    assert ok == [True, True] and queue == [] and not inflight and flushed


def test_a_port_agent_pulls_from_a_seeder_through_its_http_api(tmp_path):
    """The real path: ``AgentServer`` over a port ``Scheduler`` whose
    archive verifies with the cpu hasher, a seeder on loopback and an
    in-memory tracker (the swarm tests' harness)."""
    from test_torch_swarm import FakeTracker, make_metainfo, make_peer, start_all, stop_all

    blob = blob_of(200_000, 3)
    mi = make_metainfo(blob)

    async def main():
        tracker = FakeTracker()
        tracker.add(mi)
        seeder, _ = make_peer(tmp_path, "seeder", tracker, seed_blob=blob)
        leecher, store = make_peer(tmp_path, "leecher", tracker)
        await start_all(seeder, leecher)
        seeder.seed(mi, "ns")
        server = port_agent.AgentServer(store, leecher)
        runner, port = await http_lite.serve(server.make_app(), "127.0.0.1", 0)
        try:
            async with aiohttp.ClientSession() as s:
                async with s.get(f"http://127.0.0.1:{port}/namespace/ns/blobs/{mi.digest.hex}") as r:
                    return r.status, await r.read()
        finally:
            await runner.cleanup()
            await stop_all(seeder, leecher)

    status, body = asyncio.run(main())
    assert status == 200 and body == blob
