"""The port's placement plane (``kraken_tpu_torch.placement``) beside
``kraken_tpu.placement``: the cases of ``tests/test_placement.py`` as
parametrised cases over both packages, the breaker cases of
``tests/test_degradation.py`` on the port, then the same inputs through
both -- rendezvous owners, ring locations across a membership change,
breaker and monitor verdicts under one sequence of events on a fake clock,
and the replica walks (serial, hedged, quorum fan-out) on the same fake
clients, with the same result and the same order of attempts."""

import asyncio
import random
import sys
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

import kraken_tpu.core.digest as jax_digest
import kraken_tpu.placement as jax_placement
import kraken_tpu.placement.healthcheck as jax_health
import kraken_tpu.placement.replicawalk as jax_walk
import kraken_tpu.utils.deadline as jax_deadline
import kraken_tpu_torch.core.digest as port_digest
import kraken_tpu_torch.placement as port_placement
import kraken_tpu_torch.placement.healthcheck as port_health
import kraken_tpu_torch.placement.replicawalk as port_walk
import kraken_tpu_torch.utils.deadline as port_deadline

PKG = {
    "jax": SimpleNamespace(p=jax_placement, health=jax_health, walk=jax_walk,
                           digest=jax_digest, deadline=jax_deadline),
    "port": SimpleNamespace(p=port_placement, health=port_health, walk=port_walk,
                            digest=port_digest, deadline=port_deadline),
}
BOTH = pytest.mark.parametrize("pkg", ["jax", "port"])


def digests(k, n):
    return [k.digest.Digest.from_bytes(str(i).encode()) for i in range(n)]


# -- the cases of tests/test_placement.py, over both packages ------------------


@BOTH
def test_hrw_deterministic_and_complete(pkg):
    k = PKG[pkg]
    nodes = [f"h{i}:80" for i in range(10)]
    top = k.p.rendezvous_hash("key", nodes, k=3)
    assert top == k.p.rendezvous_hash("key", nodes, k=3)
    assert len(set(top)) == 3 and all(t in nodes for t in top)


@BOTH
def test_hrw_minimal_disruption(pkg):
    k = PKG[pkg]
    nodes = [f"h{i}:80" for i in range(10)]
    keys = [f"k{i}" for i in range(200)]
    before = {key: k.p.rendezvous_hash(key, nodes, k=1)[0] for key in keys}
    survivors = [n for n in nodes if n != "h3:80"]
    for key in keys:
        if before[key] != "h3:80":
            assert k.p.rendezvous_hash(key, survivors, k=1)[0] == before[key]


@BOTH
def test_hrw_balance(pkg):
    k = PKG[pkg]
    nodes = [f"h{i}:80" for i in range(5)]
    counts = {n: 0 for n in nodes}
    for i in range(2000):
        counts[k.p.rendezvous_hash(f"key{i}", nodes, k=1)[0]] += 1
    for c in counts.values():
        assert 200 < c < 600, counts


@BOTH
def test_ring_locations_replicas(pkg):
    k = PKG[pkg]
    ring = k.p.Ring(k.p.HostList(static=[f"o{i}:80" for i in range(5)]), max_replica=3)
    for d in digests(k, 20):
        locs = ring.locations(d)
        assert len(locs) == 3 and len(set(locs)) == 3


@BOTH
def test_ring_small_cluster(pkg):
    k = PKG[pkg]
    ring = k.p.Ring(k.p.HostList(static=["solo:80"]), max_replica=3)
    assert ring.locations(digests(k, 1)[0]) == ["solo:80"]


@BOTH
def test_ring_membership_change_notifies_and_replaces(pkg):
    k = PKG[pkg]
    members = [f"o{i}:80" for i in range(4)]
    ring = k.p.Ring(k.p.HostList(resolver=lambda: members), max_replica=2)
    events = []
    ring.on_change(events.append)
    before = {d.hex: ring.locations(d) for d in digests(k, 50)}
    assert any("o0:80" in v for v in before.values())
    members = members[1:]
    assert ring.refresh() is True
    assert events and "o0:80" not in events[0]
    for d in digests(k, 50):
        locs = ring.locations(d)
        assert "o0:80" not in locs
        if "o0:80" not in before[d.hex]:
            assert locs == before[d.hex]
    assert ring.refresh() is False


@BOTH
def test_ring_health_filter_integration(pkg):
    k = PKG[pkg]
    pf = k.p.PassiveFilter(fail_threshold=1, cooldown_seconds=1000)
    ring = k.p.Ring(k.p.HostList(static=["a:1", "b:1", "c:1"]), max_replica=2,
                    health_filter=pf.filter)
    assert set(ring.members) == {"a:1", "b:1", "c:1"}
    pf.failed("b:1")
    ring.refresh()
    assert "b:1" not in ring.members
    pf.succeeded("b:1")
    ring.refresh()
    assert "b:1" in ring.members


@BOTH
def test_ring_empty_raises(pkg):
    k = PKG[pkg]
    ring = k.p.Ring(k.p.HostList(resolver=lambda: []), max_replica=1)
    with pytest.raises(RuntimeError):
        ring.locations(digests(k, 1)[0])


@BOTH
def test_passive_filter_threshold_and_cooldown(pkg):
    pf = PKG[pkg].p.PassiveFilter(fail_threshold=2, cooldown_seconds=10)
    assert pf.healthy("h", now=0)
    pf.failed("h", now=0)
    assert pf.healthy("h", now=1)
    pf.failed("h", now=1)
    assert not pf.healthy("h", now=2)
    assert pf.healthy("h", now=12)


@BOTH
def test_passive_filter_never_empties(pkg):
    pf = PKG[pkg].p.PassiveFilter(fail_threshold=1)
    pf.failed("a", now=0)
    pf.failed("b", now=0)
    assert pf.filter(["a", "b"], now=0) == ["a", "b"]


@BOTH
def test_active_monitor_thresholds(pkg):
    health = {"h": True}

    async def probe(host):
        return health[host]

    mon = PKG[pkg].health.ActiveMonitor(probe, pass_threshold=1, fail_threshold=2)

    async def main():
        await mon.check_all(["h"])
        assert mon.healthy("h")
        health["h"] = False
        await mon.check_all(["h"])
        assert mon.healthy("h")
        await mon.check_all(["h"])
        assert not mon.healthy("h")
        health["h"] = True
        await mon.check_all(["h"])
        assert mon.healthy("h")

    asyncio.run(main())


@BOTH
def test_passive_filter_prune_drops_departed_hosts(pkg):
    pf = PKG[pkg].p.PassiveFilter(fail_threshold=1, cooldown_seconds=1000)
    pf.failed("gone:1")
    pf.failed("stays:1")
    assert pf.prune(["stays:1", "new:1"]) == 1
    assert pf.healthy("gone:1") and not pf.healthy("stays:1")
    for i in range(50):
        pf.failed(f"pod-{i}:1")
    pf.prune(["stays:1"])
    assert set(pf._fails) == {"stays:1"}


@BOTH
def test_active_monitor_prune_drops_departed_hosts(pkg):
    async def main():
        health = {"a:1": False, "b:1": True}

        async def probe(h):
            return health.get(h, True)

        mon = PKG[pkg].health.ActiveMonitor(probe, fail_threshold=1)
        await mon.check_all(["a:1", "b:1"])
        assert not mon.healthy("a:1") and mon.healthy("b:1")
        assert mon.prune(["b:1"]) == 1
        assert set(mon._state) == {"b:1"} and mon.healthy("a:1")

    asyncio.run(main())


# -- the breaker cases of tests/test_degradation.py, on the port ---------------


def test_breaker_trips_probes_once_and_reopens_with_backoff():
    pkg = "port"
    pf = PKG[pkg].p.PassiveFilter(fail_threshold=3, cooldown_seconds=10.0)
    for t in (0, 1, 2):
        pf.failed("h", now=t)
    assert not pf.healthy("h", now=3)
    assert pf.healthy("h", now=13)
    assert pf.try_acquire_probe("h", now=13) == "probe"
    assert pf.try_acquire_probe("h", now=13) is False
    pf.failed("h", now=13)
    s = pf._fails["h"]
    assert s.open_until > 13 + 10.0 - 1e-9 and s.backoff_prev >= 10.0
    t2 = 13 + s.backoff_prev + 1
    assert pf.try_acquire_probe("h", now=t2) == "probe"
    pf.failed("h", now=t2)
    t3 = t2 + pf._fails["h"].backoff_prev + 1
    assert pf.try_acquire_probe("h", now=t3) == "probe"
    pf.succeeded("h")
    assert pf.healthy("h", now=t3) and pf.try_acquire_probe("h", now=t3) is True


def test_breaker_half_open_admits_exactly_one_of_many():
    pkg = "port"
    pf = PKG[pkg].p.PassiveFilter(fail_threshold=1, cooldown_seconds=5.0)
    pf.failed("h", now=0)
    admitted = [bool(pf.try_acquire_probe("h", now=6.0)) for _ in range(50)]
    assert sum(admitted) == 1 and admitted[0]
    pf.release_probe("h")
    assert pf.try_acquire_probe("h", now=6.0) == "probe"


def test_brownout_sheds_to_back_of_order_without_opening():
    pkg = "port"
    pf = PKG[pkg].p.PassiveFilter(brownout_threshold_seconds=0.5)
    pf.observe("slow:1", True, seconds=2.0)
    pf.observe("fast:1", True, seconds=0.05)
    assert pf.healthy("slow:1") and pf.browned_out("slow:1")
    assert pf.order(["slow:1", "fast:1"]) == ["fast:1", "slow:1"]
    assert pf.unhealthy_hosts() == {"slow:1"}
    for _ in range(20):
        pf.observe("slow:1", True, seconds=0.05)
    assert pf.order(["slow:1", "fast:1"]) == ["slow:1", "fast:1"]


def test_breaker_order_tiers_open_hosts_last_and_debug_snapshot():
    pkg = "port"
    k = PKG[pkg]
    pf = k.p.PassiveFilter(fail_threshold=1, cooldown_seconds=100.0, name=f"tp-{pkg}")
    pf.failed("dead:1", now=0)
    assert pf.order(["dead:1", "b:1", "a:1"], now=1) == ["b:1", "a:1", "dead:1"]
    pf.failed("bad:1")
    assert k.health.debug_snapshot()[f"tp-{pkg}"]["hosts"]["bad:1"]["state"] == "open"


# -- the same inputs through both packages --------------------------------------


def test_rendezvous_owners_agree_across_packages():
    rng = np.random.default_rng(11)
    for _ in range(50):
        nodes = [f"10.0.{rng.integers(256)}.{rng.integers(256)}:{rng.integers(1, 65536)}"
                 for _ in range(int(rng.integers(1, 9)))]
        key = rng.bytes(32).hex()
        k = int(rng.integers(1, len(nodes) + 1))
        assert (jax_placement.rendezvous_hash(key, nodes, k=k)
                == port_placement.rendezvous_hash(key, nodes, k=k))


def test_ring_locations_agree_across_a_membership_change():
    rng = np.random.default_rng(12)
    members = [f"o{i}:80" for i in range(6)]
    rings = {}
    for name, k in PKG.items():
        rings[name] = k.p.Ring(k.p.HostList(resolver=lambda: members), max_replica=3)
    blobs = [rng.bytes(64) for _ in range(40)]

    def locations():
        return {name: [r.locations(PKG[name].digest.Digest.from_bytes(b)) for b in blobs]
                for name, r in rings.items()}

    first = locations()
    assert first["jax"] == first["port"]
    members = members[2:] + ["o9:80"]
    assert [r.refresh() for r in rings.values()] == [True, True]
    second = locations()
    assert second["jax"] == second["port"] != first["jax"]


# One sequence of breaker events on a fake clock: (call, host, now, seconds).
EVENTS = [
    ("observe_ok", "a:1", 0.0, 0.05), ("failed", "b:1", 0.1, None),
    ("failed", "b:1", 0.2, None), ("failed", "b:1", 0.3, None),
    ("probe", "b:1", 5.0, None), ("probe", "b:1", 40.0, None), ("probe", "b:1", 40.0, None),
    ("failed", "b:1", 40.1, None), ("observe_ok", "c:1", 41.0, 2.5),
    ("failed", "a:1", 41.0, None), ("failed", "a:1", 200.0, None),
    ("probe", "b:1", 500.0, None), ("succeeded", "b:1", 500.1, None),
    ("failed", "c:1", 501.0, None), ("failed", "c:1", 501.5, None),
    ("failed", "c:1", 502.0, None), ("probe", "c:1", 560.0, None),
    ("release", "c:1", 560.1, None), ("probe", "c:1", 560.2, None),
    ("observe_fail", "c:1", 560.3, 0.01),
]


def _breaker_trace(k) -> list:
    random.seed(5)  # the decorrelated jitter draws from ``random``
    pf = k.p.PassiveFilter(fail_threshold=3, cooldown_seconds=30.0,
                           brownout_threshold_seconds=1.0, name="trace")
    hosts = ["a:1", "b:1", "c:1"]
    out = []
    for call, host, now, secs in EVENTS:
        if call == "observe_ok":
            pf.observe(host, True, secs, now=now)
        elif call == "observe_fail":
            pf.observe(host, False, secs, now=now)
        elif call == "failed":
            pf.failed(host, now=now)
        elif call == "succeeded":
            pf.succeeded(host)
        elif call == "probe":
            got = pf.try_acquire_probe(host, now=now)
            out.append(("probe", got if got in (True, False) else str(got)))
        elif call == "release":
            pf.release_probe(host)
        out.append((call, [pf.healthy(h, now) for h in hosts], pf.order(hosts, now),
                    sorted(pf.unhealthy_hosts(now)), pf.filter(hosts, now),
                    pf.snapshot(now)["hosts"]))
    return out


def test_breaker_verdicts_agree_under_one_sequence_of_events():
    jax_trace, port_trace = _breaker_trace(PKG["jax"]), _breaker_trace(PKG["port"])
    assert jax_trace == port_trace
    assert any(step[0] == "probe" and step[1] == "probe" for step in jax_trace)


def test_active_monitor_verdicts_agree():
    rng = np.random.default_rng(13)
    rounds = [{h: bool(rng.random() < 0.6) for h in ("a:1", "b:1", "c:1")} for _ in range(30)]

    def trace(k):
        results = {}

        async def probe(h):
            if h == "c:1" and not results[h]:
                raise ConnectionError("probe refused")  # an error reads as a failure
            return results[h]

        mon = k.health.ActiveMonitor(probe, pass_threshold=2, fail_threshold=3)
        out = []

        async def main():
            for r in rounds:
                results.update(r)
                await mon.check_all(list(r))
                out.append((mon.filter(list(r)), mon.snapshot()["hosts"]))

        asyncio.run(main())
        return out

    assert trace(PKG["jax"]) == trace(PKG["port"])


class FakeReplica:
    """A replica answering after ``delay`` seconds, or failing."""

    def __init__(self, addr: str, delay: float, ok: bool, log: list):
        self.addr, self.delay, self.ok, self.log = addr, delay, ok, log

    async def call(self, deadline):
        self.log.append(("start", self.addr))
        try:
            await asyncio.sleep(self.delay)
        except asyncio.CancelledError:
            self.log.append(("cancelled", self.addr))
            raise
        if not self.ok:
            self.log.append(("failed", self.addr))
            raise ConnectionError(f"{self.addr} refused")
        self.log.append(("ok", self.addr))
        return self.addr


WALKS = {
    # name: [(addr, delay, ok)], hedge_delay
    "serial_first_ok": ([("a", 0.0, True), ("b", 0.0, True)], None),
    "serial_failover": ([("a", 0.0, False), ("b", 0.0, False), ("c", 0.0, True)], None),
    "serial_all_fail": ([("a", 0.0, False), ("b", 0.0, False)], None),
    "hedged_slow_primary": ([("a", 0.4, True), ("b", 0.0, True)], 0.05),
    "hedged_failed_primary": ([("a", 0.0, False), ("b", 0.05, True), ("c", 0.0, True)], 0.2),
    "hedged_all_fail": ([("a", 0.0, False), ("b", 0.0, False)], 0.05),
}


def _walk(k, spec, hedge):
    log: list = []
    reps = [FakeReplica(a, d, ok, log) for a, d, ok in spec]
    health = k.p.PassiveFilter(fail_threshold=1, cooldown_seconds=100.0)

    async def main():
        try:
            out = await k.walk.walk_replicas(
                reps, lambda c, dl: c.call(dl), key="k", health=health, hedge_delay=hedge,
                deadline=k.deadline.Deadline(5.0, component="test"))
        except ConnectionError as e:
            out = ("error", str(e))
        await asyncio.sleep(0.05)
        return out

    out = asyncio.run(main())
    return out, log, sorted(health.unhealthy_hosts())


@pytest.mark.parametrize("walk", sorted(WALKS))
def test_replica_walks_agree_in_result_and_order_of_attempts(walk):
    spec, hedge = WALKS[walk]
    jax_out, port_out = _walk(PKG["jax"], spec, hedge), _walk(PKG["port"], spec, hedge)
    assert jax_out == port_out
    if walk == "hedged_slow_primary":
        assert jax_out[0] == "b" and ("cancelled", "a") in jax_out[1]


QUORUMS = {
    # name: [(addr, delay, ok)], need, hedge_delay
    "all_ok": ([("a", 0.0, True), ("b", 0.02, True), ("c", 0.04, True)], 2, None),
    "one_fails": ([("a", 0.0, False), ("b", 0.02, True), ("c", 0.04, True)], 2, None),
    "reserves_join_on_failure": ([("a", 0.0, False), ("b", 0.02, True), ("c", 0.0, True)],
                                 2, 1.0),
    "unmet": ([("a", 0.0, False), ("b", 0.0, False), ("c", 0.0, True)], 2, None),
}


@pytest.mark.parametrize("case", sorted(QUORUMS))
def test_fan_out_quorum_agrees(case):
    spec, need, hedge = QUORUMS[case]

    def run(k):
        log: list = []
        reps = [FakeReplica(a, d, ok, log) for a, d, ok in spec]

        async def main():
            ok, failed, abandoned = await k.walk.fan_out_quorum(
                reps, lambda c, dl: c.call(dl), need=need, hedge_delay=hedge,
                deadline=k.deadline.Deadline(5.0, component="test"))
            return sorted(ok), sorted(failed), sorted(abandoned)

        return asyncio.run(main()), log

    assert run(PKG["jax"]) == run(PKG["port"])


def test_the_port_breaker_holds_its_verdicts_under_threads():
    """Threads and the loop share one filter: its counts stay whole."""
    pf = port_placement.PassiveFilter(fail_threshold=10 ** 9, cooldown_seconds=10 ** 6)
    n_threads, per = 16, 400
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(i):
            for j in range(per):
                pf.failed("h:1", now=float(j))
                pf.observe(f"t{i}:1", True, 0.001)
                pf.snapshot()

        threads = [threading.Thread(target=work, args=(i,)) for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert pf._fails["h:1"].fails == n_threads * per
    assert len(pf.snapshot()["hosts"]) == n_threads + 1
    start = time.monotonic()
    assert pf.healthy("h:1") and time.monotonic() - start < 1.0
