"""The port's tracker plane (``kraken_tpu_torch.tracker``) across the two
packages both ways: the port's ``TrackerServer`` (served by ``http_lite``)
with the JAX ``TrackerClient`` and ``TrackerFleetClient``, and the JAX
``TrackerServer`` (served by ``aiohttp``) with the port's. The handouts and
the proxied metainfo bytes agree, malformed announces get 400 from both,
lameduck answers 503 with ``Retry-After``, a fleet shards and fails over
the same way and its outage latch engages and clears as in
``tests/test_tracker_fleet.py``. The port's ``RedisPeerStore`` runs
against ``tests/test_parity.py``'s ``FakeRedis``. The cases of
``tests/test_tracker_fleet.py`` that need no other package run on the port
alone (the JAX file runs them on ``kraken_tpu``). Last, a CPU swarm: port
schedulers pull through three port trackers over ``http_lite`` while the
shard owner is stopped mid-pull."""

import asyncio
import json
import os
import ssl
import subprocess
import time
from types import SimpleNamespace

import aiohttp
import numpy as np
import pytest
from aiohttp import web
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st
from test_parity import FakeRedis

import kraken_tpu.core.digest as jax_digest
import kraken_tpu.core.metainfo as jax_metainfo
import kraken_tpu.core.peer as jax_peer
import kraken_tpu.placement.healthcheck as jax_health
import kraken_tpu.tracker.client as jax_client
import kraken_tpu.tracker.peerstore as jax_peerstore
import kraken_tpu.tracker.server as jax_server
import kraken_tpu.utils.httputil as jax_httputil
import kraken_tpu.utils.metrics as jax_metrics
import kraken_tpu_torch.core.digest as port_digest
import kraken_tpu_torch.core.metainfo as port_metainfo
import kraken_tpu_torch.core.peer as port_peer
import kraken_tpu_torch.placement.healthcheck as port_health
import kraken_tpu_torch.tracker.client as port_client
import kraken_tpu_torch.tracker.peerstore as port_peerstore
import kraken_tpu_torch.tracker.server as port_server
import kraken_tpu_torch.utils.httputil as port_httputil
import kraken_tpu_torch.utils.metrics as port_metrics
from kraken_tpu_torch import (
    AgentTorrentArchive, BatchedVerifier, CAStore, CPUPieceHasher, OriginTorrentArchive,
)
from kraken_tpu_torch.p2p.scheduler import Scheduler, SchedulerConfig
from kraken_tpu_torch.placement.hrw import rendezvous_hash
from kraken_tpu_torch.utils import http_lite
from kraken_tpu_torch.utils.bandwidth import BandwidthLimiter

NS = "library/fleet"
PKG = {
    "jax": SimpleNamespace(client=jax_client, server=jax_server, peer=jax_peer,
                           digest=jax_digest, metainfo=jax_metainfo, health=jax_health,
                           peerstore=jax_peerstore, registry=jax_metrics.REGISTRY),
    "port": SimpleNamespace(client=port_client, server=port_server, peer=port_peer,
                            digest=port_digest, metainfo=port_metainfo, health=port_health,
                            peerstore=port_peerstore, registry=port_metrics.REGISTRY),
}
BOTH = pytest.mark.parametrize("pkg", ["jax", "port"])
# (server package, client package)
CROSS = [("port", "jax"), ("jax", "port"), ("port", "port"), ("jax", "jax")]
CROSS_IDS = [f"{s}-server-{c}-client" for s, c in CROSS]


def _pid(k, i: int):
    return k.peer.PeerID(f"{i:040x}")


def _peer_doc(i: int, complete=False, origin=False) -> dict:
    return {"peer_id": f"{i:040x}", "ip": "10.0.0.%d" % (i % 250 + 1), "port": 7000 + i,
            "complete": complete, "origin": origin}


class Tracker:
    """One ``TrackerServer`` of either package on 127.0.0.1."""

    def __init__(self, pkg: str, **kw):
        self.pkg = pkg
        kw.setdefault("announce_interval_seconds", 0.1)
        kw.setdefault("peer_store", PKG[pkg].peerstore.InMemoryPeerStore(ttl_seconds=5.0))
        self.server = PKG[pkg].server.TrackerServer(**kw)
        self.addr = ""
        self._stop = None

    async def start(self, ssl_context=None) -> "Tracker":
        app = self.server.make_app()
        if self.pkg == "port":
            runner, port = await http_lite.serve(app, "127.0.0.1", 0, ssl_context=ssl_context)
        else:
            runner = web.AppRunner(app, handler_cancellation=True)
            await runner.setup()
            site = web.TCPSite(runner, "127.0.0.1", 0, ssl_context=ssl_context)
            await site.start()
            port = site._server.sockets[0].getsockname()[1]
        self.addr = f"127.0.0.1:{port}"
        self._stop = runner.cleanup
        return self

    async def stop(self) -> None:
        if self._stop is not None:
            stop, self._stop = self._stop, None
            await stop()
            await self.server.close()


async def start_fleet(pkg: str, n: int, **kw) -> tuple[list[Tracker], list[str]]:
    trackers = [await Tracker(pkg, **kw).start() for _ in range(n)]
    addrs = [t.addr for t in trackers]
    for t in trackers:
        t.server.set_fleet(addrs, t.addr)
    return trackers, addrs


def fleet_client(pkg: str, addrs, i=1, **kw):
    k = PKG[pkg]
    return k.client.TrackerFleetClient(
        addrs, _pid(k, i), "127.0.0.1", 7000 + i,
        announce_timeout_seconds=kw.pop("announce_timeout_seconds", 3.0), **kw)


class Origin:
    """The tracker's ``origin_cluster``: serves metainfo of one package."""

    def __init__(self, pkg: str, blobs: dict):
        k = PKG[pkg]
        self.pkg = pkg
        self.metainfos = {}
        for blob in blobs.values():
            d = k.digest.Digest.from_bytes(blob)
            hashes = CPUPieceHasher().hash_pieces(blob, 4096).tobytes()
            self.metainfos[d.hex] = k.metainfo.MetaInfo(d, len(blob), 4096, hashes)
        self.calls = 0

    async def get_metainfo(self, namespace, d):
        self.calls += 1
        return self.metainfos[d.hex]


def blob_of(n: int, seed: int) -> bytes:
    return np.random.default_rng(seed).integers(0, 256, n, dtype=np.uint8).tobytes()


# -- the clients' shape ------------------------------------------------------


def test_make_tracker_client_picks_shape():
    pkg = "port"
    k = PKG[pkg]
    single = k.client.make_tracker_client("1.2.3.4:7602", _pid(k, 1), "h", 1)
    assert isinstance(single, k.client.TrackerClient)
    empty = k.client.make_tracker_client("", _pid(k, 1), "h", 1)
    assert isinstance(empty, k.client.TrackerClient) and empty.addr == ""
    fleet = k.client.make_tracker_client("a:1, b:2,,c:3", _pid(k, 1), "h", 1)
    assert isinstance(fleet, k.client.TrackerFleetClient)
    assert fleet.addrs == ["a:1", "b:2", "c:3"]
    assert k.client.parse_tracker_addrs(["x:1", "", "y:2"]) == ["x:1", "y:2"]


def test_both_packages_pick_the_same_owner_and_failover_order():
    rng = np.random.default_rng(21)
    addrs = [f"127.0.0.1:{p}" for p in rng.integers(1024, 65536, 5)]
    clients = {pkg: fleet_client(pkg, addrs) for pkg in PKG}
    for _ in range(100):
        key = rng.bytes(32).hex()
        assert clients["jax"].owner_of(key) == clients["port"].owner_of(key)
        assert ([c.addr for c in clients["jax"].clients_for(key)]
                == [c.addr for c in clients["port"].clients_for(key)])


def test_fleet_set_addrs_reshards_prunes_and_the_port_setter_fans_out():
    pkg = "port"
    client = fleet_client(pkg, ["a:1", "b:2", "c:3"])
    client.health.failed("c:3")
    client.set_addrs(["a:1", "b:2"])
    assert client.addrs == ["a:1", "b:2"]
    assert "c:3" not in client.health.snapshot()["hosts"]
    with pytest.raises(ValueError):
        client.set_addrs([])
    sub = client._client("a:1")
    client.port = 4242
    assert sub.port == 4242 and client._client("b:2").port == 4242


# -- one tracker, across the packages ------------------------------------------


@pytest.mark.parametrize("server,client", CROSS, ids=CROSS_IDS)
def test_handouts_follow_the_announce_sequence(server, client):
    """Six peers announce in turn; each handout holds every earlier
    announcer but itself, complete agents first and origins last."""
    k = PKG[client]
    h = k.metainfo.InfoHash("ab" * 32)
    kinds = [(False, True), (False, False), (True, False), (False, False),
             (True, False), (False, True)]  # (complete, origin)

    async def main():
        t = await Tracker(server).start()
        handouts = []
        try:
            for i, (complete, origin) in enumerate(kinds):
                c = k.client.TrackerClient(t.addr, _pid(k, i), "10.0.0.%d" % (i + 1), 7000 + i,
                                           is_origin=origin)
                try:
                    peers, interval = await c.announce(None, h, NS, complete)
                finally:
                    await c.close()
                assert interval == 0.1
                handouts.append([(p.peer_id.hex, p.complete, p.origin) for p in peers])
        finally:
            await t.stop()
        return handouts

    handouts = asyncio.run(main())
    for i, got in enumerate(handouts):
        assert sorted(x[0] for x in got) == [f"{j:040x}" for j in range(i)]
        tiers = [2 if origin else (0 if complete else 1) for _pid_, complete, origin in got]
        assert tiers == sorted(tiers)
        assert {x[0]: x[1:] for x in got} == {f"{j:040x}": kinds[j] for j in range(i)}


@pytest.mark.parametrize("server,client", CROSS, ids=CROSS_IDS)
def test_proxied_metainfo_bytes_agree_and_are_cached(server, client):
    blob = blob_of(50_000, 3)
    origin = Origin(server, {"b": blob})
    want = Origin("jax", {"b": blob}).metainfos
    k = PKG[client]
    d = k.digest.Digest.from_bytes(blob)

    async def main():
        t = await Tracker(server, origin_cluster=origin).start()
        c = k.client.TrackerClient(t.addr, _pid(k, 1), "127.0.0.1", 7001)
        try:
            got = [await c.get(NS, d) for _ in range(3)]
            with pytest.raises(Exception) as e:
                await c.get(NS, k.digest.Digest.from_bytes(b"missing"))
            return got, e.value
        finally:
            await c.close()
            await t.stop()

    got, missing = asyncio.run(main())
    assert {m.serialize() for m in got} == {want[d.hex].serialize()}
    assert isinstance(got[0], k.metainfo.MetaInfo)
    assert origin.calls == 2  # one for the blob (then cached), one for the miss
    assert missing.status == 404


_JSON = st.recursive(
    st.none() | st.booleans() | st.integers() | st.floats(allow_nan=False) | st.text(max_size=8),
    lambda inner: st.lists(inner, max_size=3) | st.dictionaries(st.text(max_size=8), inner,
                                                                max_size=3),
    max_leaves=6)
_BAD_ANNOUNCE = st.one_of(
    st.binary(max_size=40),
    _JSON.map(json.dumps),
    st.fixed_dictionaries({"info_hash": _JSON.filter(lambda v: not isinstance(v, str)),
                           "peer": st.just(_peer_doc(1))}).map(json.dumps),
    st.fixed_dictionaries({"info_hash": st.text(max_size=8), "peer": _JSON}).map(json.dumps),
    st.fixed_dictionaries({"info_hash": st.text(max_size=8),
                           "peer": st.fixed_dictionaries(
                               {"peer_id": st.text(max_size=12), "ip": _JSON, "port": _JSON})
                           }).map(json.dumps),
)


@settings(max_examples=6, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(bodies=st.lists(_BAD_ANNOUNCE, min_size=12, max_size=12))
def test_malformed_announces_get_400_from_both_servers(bodies):
    async def main():
        servers = [await Tracker(pkg).start() for pkg in ("jax", "port")]
        session = http_lite.ClientSession()
        out = []
        try:
            for body in bodies:
                statuses = []
                for t in servers:
                    async with session.request("POST", f"http://{t.addr}/announce",
                                               data=body) as r:
                        await r.read()
                        statuses.append(r.status)
                out.append(statuses)
        finally:
            await session.close()
            for t in servers:
                await t.stop()
        return out

    for statuses in asyncio.run(main()):
        assert statuses == [400, 400]


@BOTH
def test_lameduck_answers_503_with_retry_after_and_health_flips(pkg):
    async def main():
        t = await Tracker(pkg, origin_cluster=Origin(pkg, {})).start()
        session = http_lite.ClientSession()
        base = f"http://{t.addr}"
        announce = json.dumps({"info_hash": "ab" * 32, "peer": _peer_doc(3)})
        out = {}
        try:
            async with session.request("GET", f"{base}/health") as r:
                out["health_before"] = (r.status, await r.text())
            async with session.request("POST", f"{base}/debug/lameduck") as r:
                out["enter"] = (await r.json())["lameduck"]
            for path, method, data in (("/health", "GET", None),
                                       ("/announce", "POST", announce),
                                       (f"/namespace/ns/blobs/{'cd' * 32}/metainfo", "GET", None)):
                async with session.request(method, base + path, data=data) as r:
                    out[path.split("/")[1]] = (r.status, r.headers.get("Retry-After"),
                                               await r.text())
            async with session.request("GET", f"{base}/debug/lameduck") as r:
                out["state"] = await r.json()
        finally:
            await session.close()
            await t.stop()
        return out

    out = asyncio.run(main())
    drained = (503, "5", "draining (lameduck)")
    assert out == {"health_before": (200, "ok"), "enter": True, "health": drained,
                   "announce": drained, "namespace": drained,
                   "state": {"lameduck": True, "inflight": 0, "active_conns": 0}}


def test_a_cancelled_proxy_read_runs_its_finally_and_the_drain_count_falls_back():
    """A client that hangs up on a metainfo read cancels the handler; its
    ``finally`` takes the read out of the lameduck drain's count."""

    class Blocked:
        async def get_metainfo(self, namespace, d):
            self.started.set()
            await asyncio.sleep(30)

    async def main():
        origin = Blocked()
        origin.started = asyncio.Event()
        t = await Tracker("port", origin_cluster=origin).start()
        try:
            host, port = t.addr.split(":")
            reader, writer = await asyncio.open_connection(host, int(port))
            writer.write(f"GET /namespace/ns/blobs/{'cd' * 32}/metainfo HTTP/1.1\r\n"
                         f"Host: x\r\n\r\n".encode())
            await writer.drain()
            await asyncio.wait_for(origin.started.wait(), 5)
            assert t.server.inflight_work == 1
            writer.close()
            for _ in range(200):
                if t.server.inflight_work == 0:
                    break
                await asyncio.sleep(0.01)
            return t.server.inflight_work
        finally:
            await t.stop()

    assert asyncio.run(main()) == 0


@pytest.mark.parametrize("server,client", CROSS[:3], ids=CROSS_IDS[:3])
def test_announce_over_https_through_the_cluster_ca(server, client, tmp_path):
    """An ``https://`` tracker address and an ``HTTPClient`` given the
    cluster CA (``tests/test_parity.py``'s TLS case, across the packages)."""
    cert, key = tmp_path / "cert.pem", tmp_path / "key.pem"
    subprocess.run(
        ["openssl", "req", "-x509", "-newkey", "rsa:2048", "-nodes", "-keyout", str(key),
         "-out", str(cert), "-days", "1", "-subj", "/CN=127.0.0.1",
         "-addext", "subjectAltName=IP:127.0.0.1"],
        check=True, capture_output=True)
    server_ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    server_ctx.load_cert_chain(str(cert), str(key))
    k = PKG[client]
    httputil = (port_httputil if client == "port" else jax_httputil)

    async def main():
        t = await Tracker(server).start(ssl_context=server_ctx)
        c = k.client.TrackerClient(
            f"https://{t.addr}", _pid(k, 1), "127.0.0.1", 7001,
            http=httputil.HTTPClient(ssl=ssl.create_default_context(cafile=str(cert))))
        plain = k.client.TrackerClient(f"https://{t.addr}", _pid(k, 2), "127.0.0.1", 7002,
                                       http=httputil.HTTPClient(retries=0))
        try:
            got = await c.announce(None, k.metainfo.InfoHash("ab" * 32), NS, False)
            with pytest.raises(Exception) as e:  # no CA: the handshake fails
                await plain.announce(None, k.metainfo.InfoHash("ab" * 32), NS, False)
            return got, e.value
        finally:
            await c.close()
            await plain.close()
            await t.stop()

    (peers, interval), refused = asyncio.run(main())
    assert peers == [] and interval == 0.1
    # Each package's connection error, the certificate error beneath it.
    conn_error = (http_lite.ClientConnectionError if client == "port"
                  else aiohttp.ClientConnectionError)
    assert isinstance(refused, conn_error) and "CERTIFICATE_VERIFY_FAILED" in str(refused)


# -- a fleet --------------------------------------------------------------------


@pytest.mark.parametrize("server,client", CROSS[:3], ids=CROSS_IDS[:3])
def test_fleet_shards_announces_by_info_hash(server, client):
    k = PKG[client]

    async def main():
        trackers, addrs = await start_fleet(server, 3)
        c = fleet_client(client, addrs)
        try:
            hashes = [k.metainfo.InfoHash(f"{i:02x}" + "cd" * 31) for i in range(12)]
            for h in hashes:
                await c.announce(None, h, NS, complete=False)
            for h in hashes:
                owner = rendezvous_hash(h.hex, addrs, k=1)[0]
                for t in trackers:
                    assert bool(t.server.peers._swarms.get(h.hex)) == (t.addr == owner)
        finally:
            await c.close()
            for t in trackers:
                await t.stop()

    asyncio.run(main())


@pytest.mark.parametrize("server,client", CROSS[:3], ids=CROSS_IDS[:3])
def test_fleet_fails_over_when_the_owner_dies(server, client):
    k = PKG[client]

    async def main():
        trackers, addrs = await start_fleet(server, 3)
        h = k.metainfo.InfoHash("ee" * 32)
        owner = rendezvous_hash(h.hex, addrs, k=1)[0]
        c1, c2 = fleet_client(client, addrs, i=1), fleet_client(client, addrs, i=2)
        failovers = k.registry.counter("tracker_fleet_failovers_total")
        before = failovers.value(op="announce")
        victim = next(t for t in trackers if t.addr == owner)
        try:
            await c1.announce(None, h, NS, complete=True)
            await victim.stop()
            _peers, interval = await c2.announce(None, h, NS, complete=False)
            assert interval > 0
            assert failovers.value(op="announce") > before
            await c1.announce(None, h, NS, complete=True)
            peers, _ = await c2.announce(None, h, NS, complete=False)
            assert any(p.peer_id == _pid(k, 1) for p in peers)
            for _ in range(3):
                await c2.announce(None, h, NS, complete=False)
            assert owner in c2.health.snapshot()["hosts"]
            assert owner in k.health.debug_snapshot()[c2.health.name]["hosts"]
        finally:
            await c1.close()
            await c2.close()
            for t in trackers:
                await t.stop()

    asyncio.run(main())


def test_a_non_owner_forwards_and_a_forwarded_announce_is_not_forwarded_again():
    async def main():
        trackers, addrs = await start_fleet("port", 3)
        h = "aa" * 32
        owner = rendezvous_hash(h, addrs, k=1)[0]
        non_owner = next(t for t in trackers if t.addr != owner)
        owner_t = next(t for t in trackers if t.addr == owner)
        session = http_lite.ClientSession()
        try:
            async with session.request("POST", f"http://{non_owner.addr}/announce",
                                       data=json.dumps({"info_hash": h,
                                                        "peer": _peer_doc(7)})) as r:
                assert (await r.json())["interval"] > 0
            for _ in range(100):
                if h in owner_t.server.peers._swarms:
                    break
                await asyncio.sleep(0.02)
            assert f"{7:040x}" in owner_t.server.peers._swarms[h]
            # Marked as forwarded: the third tracker keeps it to itself.
            third = next(t for t in trackers if t not in (owner_t, non_owner))
            forwarded = []
            third.server._maybe_forward = lambda ih, doc: forwarded.append(ih)
            async with session.request("POST", f"http://{third.addr}/announce",
                                       data=json.dumps({"info_hash": h, "peer": _peer_doc(8)}),
                                       headers={"X-Kraken-Forwarded": "1"}) as r:
                assert r.status == 200
            assert forwarded == []
        finally:
            await session.close()
            for t in trackers:
                await t.stop()

    asyncio.run(main())


def test_lameduck_owner_routes_the_fleet_around_it():
    async def main():
        trackers, addrs = await start_fleet("port", 2)
        c = fleet_client("jax", addrs)
        h = jax_metainfo.InfoHash("bb" * 32)
        victim = next(t for t in trackers if t.addr == rendezvous_hash(h.hex, addrs, k=1)[0])
        try:
            await c.announce(None, h, NS, complete=True)
            victim.server.enter_lameduck()
            _peers, interval = await c.announce(None, h, NS, complete=False)
            assert interval > 0
        finally:
            await c.close()
            for t in trackers:
                await t.stop()

    asyncio.run(main())


# -- the outage latch (tests/test_tracker_fleet.py:456-586) -------------------


def _dead_fleet(monkeypatch, pkg, addrs, calls, cooldown=30.0):
    k = PKG[pkg]

    async def dead_announce(self, d, ih, namespace, complete, deadline=None):
        calls.append(self.addr)
        raise ConnectionError("connection refused")

    monkeypatch.setattr(k.client.TrackerClient, "announce", dead_announce)
    return fleet_client(pkg, addrs, health=k.health.PassiveFilter(
        fail_threshold=1, cooldown_seconds=cooldown))


def test_outage_latch_engages_and_fail_fasts(monkeypatch):
    pkg = "port"
    k = PKG[pkg]

    async def main():
        calls = []
        client = _dead_fleet(monkeypatch, pkg, ["a:1", "b:2", "c:3"], calls)
        outages = k.registry.counter("tracker_outages_total")
        before = outages.value()
        h = k.metainfo.InfoHash("ab" * 32)
        try:
            assert client.outage is False
            with pytest.raises(ConnectionError):
                await client.announce(None, h, NS, complete=False)
            assert len(calls) == 3
            with pytest.raises(ConnectionError, match="fleet outage"):
                await client.announce(None, h, NS, complete=False)
            assert len(calls) == 3 and client.outage is True
            assert outages.value() == before + 1
            assert k.registry.gauge("tracker_outage").value() == 1
            for _ in range(10):
                with pytest.raises(ConnectionError, match="fleet outage"):
                    await client.announce(None, h, NS, complete=False)
            assert len(calls) == 3
        finally:
            await client.close()

    asyncio.run(main())


def test_outage_latch_clears_only_on_walk_success(monkeypatch):
    pkg = "port"
    k = PKG[pkg]

    async def main():
        calls, alive = [], {"up": False}

        async def flaky_announce(self, d, ih, namespace, complete, deadline=None):
            calls.append(self.addr)
            if not alive["up"]:
                raise ConnectionError("connection refused")
            return [], 0.5

        monkeypatch.setattr(k.client.TrackerClient, "announce", flaky_announce)
        client = fleet_client(pkg, ["a:1", "b:2"], health=k.health.PassiveFilter(
            fail_threshold=1, cooldown_seconds=0.15))
        seconds = k.registry.counter("tracker_outage_seconds_total")
        s0 = seconds.value()
        h = k.metainfo.InfoHash("cd" * 32)
        try:
            with pytest.raises(ConnectionError):
                await client.announce(None, h, NS, complete=False)
            with pytest.raises(ConnectionError, match="fleet outage"):
                await client.announce(None, h, NS, complete=False)
            assert client.outage is True
            await asyncio.sleep(0.2)
            n = len(calls)
            with pytest.raises(ConnectionError):
                await client.announce(None, h, NS, complete=False)
            assert len(calls) > n and client.outage is True
            alive["up"] = True
            await asyncio.sleep(0.5)
            _peers, interval = await client.announce(None, h, NS, complete=False)
            assert interval == 0.5 and client.outage is False
            assert k.registry.gauge("tracker_outage").value() == 0
            assert seconds.value() - s0 >= 0.3
        finally:
            await client.close()

    asyncio.run(main())


def test_set_addrs_to_all_dead_membership_short_circuits(monkeypatch):
    pkg = "port"
    k = PKG[pkg]

    async def main():
        calls = []
        client = _dead_fleet(monkeypatch, pkg, ["a:1", "b:2"], calls)
        h = k.metainfo.InfoHash("ef" * 32)
        try:
            with pytest.raises(ConnectionError):
                await client.announce(None, h, NS, complete=False)
            with pytest.raises(ConnectionError, match="fleet outage"):
                await client.announce(None, h, NS, complete=False)
            client.set_addrs(["d:4", "e:5"])
            n = len(calls)
            for _ in range(10):
                with pytest.raises(ConnectionError):
                    await client.announce(None, h, NS, complete=False)
            assert len(calls) - n == 2 and client.outage is True
        finally:
            await client.close()

    asyncio.run(main())


def test_blackholed_owner_pays_one_slice_not_the_whole_budget(monkeypatch):
    pkg = "port"
    k = PKG[pkg]
    h = k.metainfo.InfoHash("dd" * 32)

    async def main():
        client = fleet_client(pkg, ["a:1", "b:2", "c:3"], announce_timeout_seconds=1.5)
        owner = client.owner_of(h.hex)

        async def fake_announce(self, d, ih, namespace, complete, deadline=None):
            if self.addr == owner:
                await asyncio.sleep(3600)
            return [], 0.5

        monkeypatch.setattr(k.client.TrackerClient, "announce", fake_announce)
        try:
            t0 = time.monotonic()
            _peers, interval = await client.announce(None, h, NS, False)
            assert interval == 0.5 and time.monotonic() - t0 < 1.2
            assert client.health.snapshot()["hosts"][owner]["consecutive_fails"] >= 1
        finally:
            await client.close()

    asyncio.run(main())


def test_recipe_cache_survives_failover(monkeypatch):
    pkg = "port"
    k = PKG[pkg]
    calls = {"recipe": 0, "similar": 0}

    async def fake_recipe(self, namespace, d, deadline=None):
        calls["recipe"] += 1
        return ("RECIPE", "origin:1")

    async def fake_similar(self, namespace, d, deadline=None):
        calls["similar"] += 1
        return [{"digest": "ab" * 32, "score": 0.9}]

    async def main():
        monkeypatch.setattr(k.client.TrackerClient, "get_recipe", fake_recipe)
        monkeypatch.setattr(k.client.TrackerClient, "similar", fake_similar)
        client = fleet_client(pkg, ["a:1", "b:2", "c:3"], recipe_cache_ttl_seconds=60.0)
        d = k.digest.Digest.from_bytes(b"target")
        try:
            assert await client.get_recipe(NS, d) == ("RECIPE", "origin:1")
            client.set_addrs(["b:2", "c:3"])
            assert await client.get_recipe(NS, d) == ("RECIPE", "origin:1")
            assert len(await client.similar(NS, d)) == 1
            assert len(await client.similar(NS, d)) == 1
            assert calls == {"recipe": 1, "similar": 1}
        finally:
            await client.close()

    asyncio.run(main())


# -- the Redis peer store -------------------------------------------------------


def test_redis_peerstore_against_fake_redis():
    pkg = "port"
    k = PKG[pkg]

    async def main():
        async with FakeRedis() as srv:
            store = k.peerstore.RedisPeerStore(srv.addr, ttl_seconds=1)
            await store.update("hash1", k.peer.PeerInfo.from_dict(_peer_doc(1)))
            await store.update("hash1", k.peer.PeerInfo.from_dict(_peer_doc(2, complete=True)))
            await store.update("hash2", k.peer.PeerInfo.from_dict(_peer_doc(3)))
            got = await store.get_peers("hash1")
            assert {p.port for p in got} == {7001, 7002}
            assert await store.get_peers("nope") == []
            records = {key: dict(h) for key, h in srv.hashes.items()}
            for h in srv.hashes.values():
                for f, v in list(h.items()):
                    doc = json.loads(v)
                    doc["_expiry"] = 0
                    h[f] = json.dumps(doc).encode()
            assert await store.get_peers("hash1") == []
            assert srv.hashes[b"swarm:hash1"] == {}  # reaped
            store._conn.close()  # a dropped conn is one reconnect
            assert len(await store.get_peers("hash2")) == 0
            await store.close()
            return {key: sorted(h) for key, h in records.items()}

    assert asyncio.run(main()) == {
        b"swarm:hash1": [f"{1:040x}".encode(), f"{2:040x}".encode()],
        b"swarm:hash2": [f"{3:040x}".encode()],
    }


def test_redis_records_are_read_across_the_packages():
    async def main():
        async with FakeRedis() as srv:
            a = jax_peerstore.RedisPeerStore(srv.addr, ttl_seconds=30)
            b = port_peerstore.RedisPeerStore(srv.addr, ttl_seconds=30)
            await a.update("h", jax_peer.PeerInfo.from_dict(_peer_doc(1, complete=True)))
            await b.update("h", port_peer.PeerInfo.from_dict(_peer_doc(2, origin=True)))
            got = ([p.to_dict() for p in await a.get_peers("h")],
                   [p.to_dict() for p in await b.get_peers("h")])
            await a.close()
            await b.close()
            return got

    via_jax, via_port = asyncio.run(main())
    key = lambda d: d["peer_id"]  # noqa: E731
    assert sorted(via_jax, key=key) == sorted(via_port, key=key)
    assert len(via_port) == 2


# -- a CPU swarm through three port trackers, the owner stopped mid-pull -------


def test_a_swarm_pulls_through_three_trackers_while_the_shard_owner_dies(tmp_path):
    blob = blob_of(300_000, 9)
    d = port_digest.Digest.from_bytes(blob)
    hashes = CPUPieceHasher().hash_pieces(blob, 8192).tobytes()
    mi = port_metainfo.MetaInfo(d, len(blob), 8192, hashes)
    origin = SimpleNamespace(calls=0)

    async def get_metainfo(namespace, digest):
        origin.calls += 1
        return mi

    origin.get_metainfo = get_metainfo

    async def main():
        trackers, addrs = await start_fleet("port", 3, origin_cluster=origin,
                                            announce_interval_seconds=0.2)
        owner = rendezvous_hash(mi.info_hash.hex, addrs, k=1)[0]
        victim = next(t for t in trackers if t.addr == owner)

        def peer(name, archive_cls, blob_in=None, bandwidth=None):
            store = CAStore(str(tmp_path / name))
            if blob_in is not None:
                uid = store.create_upload()
                store.write_upload_chunk(uid, 0, blob_in)
                store.commit_upload(uid, d)
            pid = port_peer.PeerID(os.urandom(20).hex())
            client = port_client.make_tracker_client(",".join(addrs), pid, "127.0.0.1", 0)
            s = Scheduler(pid, "127.0.0.1", 0,
                          archive_cls(store, BatchedVerifier(CPUPieceHasher())), client, client,
                          config=SchedulerConfig(retry_tick_seconds=0.2), bandwidth=bandwidth)
            return s, client, store

        seeder = peer("seeder", OriginTorrentArchive, blob)
        agents = [peer(f"agent{i}", AgentTorrentArchive,
                       bandwidth=BandwidthLimiter(ingress_bps=150_000)) for i in range(3)]
        peers = [seeder] + agents
        for s, client, _store in peers:
            await s.start()
            client.port = s.port
        done_at_kill = None
        try:
            seeder[0].seed(mi, NS)
            pulls = [asyncio.create_task(s.download(NS, d)) for s, _c, _st in agents]

            def pieces_done():
                return [s._controls[mi.info_hash].torrent.num_pieces_complete()
                        if mi.info_hash in s._controls else 0 for s, _c, _st in agents]

            t0 = time.monotonic()
            while max(pieces_done()) < 1 and time.monotonic() - t0 < 30:
                await asyncio.sleep(0.005)
            done_at_kill = pieces_done()
            await victim.stop()
            await asyncio.wait_for(asyncio.gather(*pulls), 60)
            # The peers go on announcing (as seeders now): the dead owner is
            # named by some agent's breaker, and the survivors take the swarm.
            survivors = [t for t in trackers if t is not victim]
            t0 = time.monotonic()
            while time.monotonic() - t0 < 30:
                snap = port_health.debug_snapshot()
                named = any(owner in snap[c.health.name]["hosts"] for _s, c, _st in agents)
                held = [bool(t.server.peers._swarms) for t in survivors]
                if named and any(held):
                    break
                await asyncio.sleep(0.02)
            return done_at_kill, named, held
        finally:
            for s, client, _store in peers:
                await s.stop()
                await client.close()
            for t in trackers:
                await t.stop()

    done_at_kill, named, survivors_hold_swarms = asyncio.run(main())
    assert 1 <= max(done_at_kill) < mi.num_pieces  # the kill landed mid-pull
    for i in range(3):
        assert CAStore(str(tmp_path / f"agent{i}")).read_cache_file(d) == blob
    assert named
    assert any(survivors_hold_swarms)
    assert origin.calls >= 1
