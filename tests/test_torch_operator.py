"""The port's operator plane (``utils/metrics.py``'s middleware and debug
mux, the SLO evaluator, ``utils/resources.py``'s sentinel,
``utils/canary.py``'s prober, ``/debug/torch-profile``), held against
``kraken_tpu`` on the CPU at small sizes:

- every node's ``stop()`` leaves the process as it found it for what it
  started (a deliberate difference: the reference's nodes leave the SLO
  evaluator and the sampler running);
- the same requests to a reference node's app (``aiohttp``) and a port
  node's app give the same ``/debug/`` index (``torch-profile`` for
  ``jax-profile``), the same ``http_requests_total`` label sets and the
  same keys in ``/debug/slo``, ``/debug/healthcheck``,
  ``/debug/resources`` and ``/debug/failpoints``, with the same answers
  to the arming gate;
- ``/debug/torch-profile``'s 400 / 409 / cancel-while-capturing contract
  on a ``cpu`` node;
- ``canary_blob`` byte for byte, and one canary probe through an
  in-process port herd recorded good as canary traffic;
- both packages' sentinels breaching on the same injected probes, and
  ``drain_on_breach`` entering lameduck.

The in-process nodes run under the port's stall sanitizer
(``utils/sanitize.py``). Reference nodes run with their SLO evaluator and
sampler off, and the reference's process globals are restored after.
"""

import asyncio
import json
import os
import threading
import tracemalloc

import aiohttp
import pytest

import kraken_tpu.assembly as jax_assembly
import kraken_tpu.placement.healthcheck as jax_healthcheck
import kraken_tpu.utils.canary as jax_canary
import kraken_tpu.utils.failpoints as jax_failpoints
import kraken_tpu.utils.metrics as jax_metrics
import kraken_tpu.utils.resources as jax_resources
import kraken_tpu_torch.assembly as port_assembly
import kraken_tpu_torch.placement.healthcheck as port_healthcheck
import kraken_tpu_torch.utils.canary as port_canary
import kraken_tpu_torch.utils.failpoints as port_failpoints
import kraken_tpu_torch.utils.metrics as port_metrics
import kraken_tpu_torch.utils.resources as port_resources
from kraken_tpu_torch.utils.profiler import PROFILER
from kraken_tpu_torch.utils.sanitize import sanitized_run
from kraken_tpu_torch.utils.slo import SLO
from kraken_tpu.utils.slo import SLO as JAX_SLO
from test_torch_profiler import process_globals  # noqa: F401 (a fixture)

PORT, JAX = "port", "jax"
PKG = {
    PORT: (port_assembly, port_metrics, port_failpoints, port_healthcheck, port_resources),
    JAX: (jax_assembly, jax_metrics, jax_failpoints, jax_healthcheck, jax_resources),
}
COMPONENTS = ("tracker", "origin", "agent")
# Reference nodes keep their process-global threads off here: the
# reference's stop() would leave them running in this worker.
QUIET = {"slo": {"enabled": False}, "profiling": {"enabled": False}}
# A loop stall past this fails the test (generous: the suite shares cores).
STALL_SECONDS = 3.0


def run(coro):
    """``asyncio.run`` under the port's stall sanitizer."""
    return sanitized_run(coro, threshold_seconds=STALL_SECONDS)


@pytest.fixture
def jax_globals():
    """The reference's process-global tracer, sampler, SLO manager and
    failpoints as they were (the sampler and the evaluator running or
    not), after a test that starts reference nodes."""
    from kraken_tpu.utils.profiler import PROFILER as JP
    from kraken_tpu.utils.slo import SLO as JS
    from kraken_tpu.utils.trace import TRACER as JT

    saved = (JT.config, JT.node, JT.on_trigger, JP.config, JP.node, JS.config, JS.node,
             JP.running, JS._thread is not None, jax_failpoints.FAILPOINTS.allowed)
    slo_state = (dict(JS._recorders), dict(JS._alerts), JS._last_eval)
    yield
    JS._recorders, JS._alerts, JS._last_eval = slo_state
    JT.apply(saved[0])
    JT.node, JT.on_trigger = saved[1], saved[2]
    JP.config, JP.node = saved[3], saved[4]
    if not saved[7]:
        JP.stop()
    elif not JP.running:
        JP.start()
    JS.config, JS.node = saved[5], saved[6]
    if not saved[8]:
        JS.stop()
    elif JS._thread is None:
        JS.apply(saved[5])
    jax_failpoints.FAILPOINTS.disarm_all()
    jax_failpoints.FAILPOINTS.allowed = saved[9]


@pytest.fixture
def failpoints_gate():
    """Both packages' failpoint registries disarmed and not yet allowed,
    as a node booted without the chaos acknowledgement has them."""
    saved = [fp.FAILPOINTS.allowed for fp in (port_failpoints, jax_failpoints)]
    for fp in (port_failpoints, jax_failpoints):
        fp.FAILPOINTS.disarm_all()
        fp.FAILPOINTS.allowed = False
    yield
    for fp, allowed in zip((port_failpoints, jax_failpoints), saved):
        fp.FAILPOINTS.disarm_all()
        fp.FAILPOINTS.allowed = allowed


def make_node(pkg: str, component: str, tmp_path, **kw):
    asm = PKG[pkg][0]
    if component == "tracker":
        return asm.TrackerNode(**kw)
    if component == "origin":
        return asm.OriginNode(str(tmp_path / f"{pkg}-origin"), hasher="cpu", dedup=False, **kw)
    return asm.AgentNode(str(tmp_path / f"{pkg}-agent"), "", hasher="cpu", **kw)


async def fetch(session, method: str, url: str, **kw) -> tuple[int, bytes]:
    async with session.request(method, url, **kw) as r:
        return r.status, await r.read()


# -- every node stops what it starts ---------------------------------------------

PLANES_ON = {
    "slo": {"eval_interval_seconds": 0.05, "bucket_seconds": 1.0},
    "profiling": {"hz": 20, "loop_lag_interval_seconds": 0.05},
}


@pytest.mark.parametrize("component", COMPONENTS)
def test_a_stopped_node_leaves_the_process_as_it_found_it(tmp_path, monkeypatch, process_globals,
                                                          component):
    """With every operator plane on (the SLO evaluator, the sampler and
    the loop-lag monitor, a sentinel sampling every 50 ms with a budget,
    the canary probing a dead origin), a heap call through the mux (which
    turns tracemalloc on) and a 30 s torch.profiler capture still running
    on the mux, stop() leaves no thread the node started alive, tracemalloc
    off, the SLO evaluator and the sampler stopped, and the profile lock
    free."""
    monkeypatch.setenv("KRAKEN_PROFILE_DIR", str(tmp_path))
    SLO.stop()
    PROFILER.stop()
    assert not tracemalloc.is_tracing()
    kw = dict(PLANES_ON)
    if component != "tracker":
        kw["resources"] = {"interval_seconds": 0.05, "max_open_fds": 1}
    if component == "agent":
        kw["canary"] = {"enabled": True, "origins": "127.0.0.1:1", "interval_seconds": 0.05,
                        "pull_timeout_seconds": 0.5}
    before = set(threading.enumerate())

    async def main():
        node = make_node(PORT, component, tmp_path, **kw)
        await node.start()
        base = f"http://{node.addr}"
        async with aiohttp.ClientSession() as s:
            capture = asyncio.ensure_future(
                fetch(s, "GET", f"{base}/debug/torch-profile?seconds=30"))
            while port_metrics._active_capture is None:
                await asyncio.sleep(0.01)
            # The profiler runs before tracemalloc slows every import.
            assert await asyncio.to_thread(port_metrics._active_capture.started.wait, 60)
            status, _ = await fetch(s, "GET", f"{base}/debug/pprof/heap")
            assert status == 200 and tracemalloc.is_tracing()
            await asyncio.sleep(0.3)
            assert SLO.running and PROFILER.running and node.loop_monitor is not None
            if component != "tracker":
                assert node.sentinel.last_sample is not None
            if component == "agent":
                assert node.canary._seq >= 1
            await node.stop()
            with pytest.raises(aiohttp.ClientError):
                await capture

    run(main())
    started = [t for t in threading.enumerate() if t not in before and t.is_alive()]
    assert started == []
    assert not tracemalloc.is_tracing()
    assert not SLO.running and not PROFILER.running
    assert not port_metrics._profile_lock.locked() and port_metrics._active_capture is None
    assert not [s for s in port_resources.debug_snapshot()["sentinels"].values()
                if s["config"]["interval_seconds"] == 0.05]


# -- the mux against the reference's ----------------------------------------------

_HC = "operator-mux-test"
_ARM = {"action": "arm", "name": "store.scrub.bitflip", "spec": "once"}


def _label_delta(counter, before: dict, component: str) -> set:
    """The label sets of ``counter`` that this test's requests moved."""
    with counter._lock:
        now = dict(counter._values)
    return {k for k, v in now.items()
            if v != before.get(k, 0.0) and dict(k).get("component") == component}


def _keys(doc) -> object:
    """A document's shape: its keys, nested, down to the leaves."""
    if isinstance(doc, dict):
        return {k: _keys(v) for k, v in sorted(doc.items())}
    return type(doc).__name__ if doc is not None else None


async def _drive_mux(pkg: str, component: str, tmp_path, monkeypatch) -> dict:
    _asm, metrics, failpoints, healthcheck, _res = PKG[pkg]
    slo = (SLO if pkg == PORT else JAX_SLO)
    node = make_node(pkg, component, tmp_path, **QUIET)
    hc = healthcheck.PassiveFilter(name=_HC)
    hc.observe("h:1", False)
    await node.start()
    out: dict = {"status": []}
    requests = metrics.REGISTRY.counter("http_requests_total")
    with requests._lock:
        before = dict(requests._values)
    base = f"http://{node.addr}"
    try:
        if getattr(node, "sentinel", None) is not None:
            await node.sentinel.sample()
        slo.evaluate()
        async with aiohttp.ClientSession() as s:
            for path in ("/debug/", "/debug", "/debug/slo", "/debug/healthcheck",
                         "/debug/resources", "/debug/failpoints", "/debug/pprof/looplag",
                         "/debug/trace?view=recent&limit=5", "/debug/trace?limit=x",
                         "/debug/trace?view=nope", "/nowhere", "/health"):
                status, body = await fetch(s, "GET", base + path)
                out["status"].append((path, status))
                if status == 200 and path.startswith("/debug"):
                    out[path] = json.loads(body)
            for name, doc in (("arm-refused", _ARM), ("malformed", {"action": "nope"}),
                              ("disarm", {"action": "disarm_all"})):
                status, body = await fetch(s, "POST", base + "/debug/failpoints", json=doc)
                out["status"].append((name, status))
            monkeypatch.setenv("KRAKEN_FAILPOINTS_ALLOW", "1")
            status, body = await fetch(s, "POST", base + "/debug/failpoints", json=_ARM)
            monkeypatch.delenv("KRAKEN_FAILPOINTS_ALLOW")
            out["status"].append(("arm-allowed", status))
            out["armed"] = json.loads(body)
            status, body = await fetch(s, "GET", base + "/metrics", headers={
                "Accept": "application/openmetrics-text; version=1.0.0"})
            out["openmetrics"] = (status, body.decode().endswith("# EOF\n"),
                                  "# TYPE http_requests counter" in body.decode())
    finally:
        await node.stop()
        failpoints.FAILPOINTS.disarm_all()
    out["requests"] = _label_delta(requests, before, component)
    return out


@pytest.fixture
def fresh_slo(process_globals, jax_globals):
    """Both packages' SLO managers with no recorded events, no alert state
    and no last evaluation for the test; the two fixtures it takes put back
    what was there. Another test in the same worker (the reference's
    cleanup-wiring herd, say) leaves failed announces in one package's
    recorders; an alert firing there gives its ``since_ts`` a float where
    the other package's stays null, and the shapes of ``/debug/slo`` part."""
    for slo in (SLO, JAX_SLO):
        with slo._lock:
            slo._recorders, slo._alerts, slo._last_eval = {}, {}, {}
    yield


@pytest.mark.parametrize("component", COMPONENTS)
def test_the_mux_answers_as_the_references(tmp_path, monkeypatch, fresh_slo, failpoints_gate,
                                           component):
    monkeypatch.delenv("KRAKEN_FAILPOINTS_ALLOW", raising=False)
    got = {pkg: run(_drive_mux(pkg, component, tmp_path, monkeypatch)) for pkg in (JAX, PORT)}
    ref, port = got[JAX], got[PORT]
    assert port["status"] == ref["status"]
    ref_index = {("/debug/torch-profile" if k == "/debug/jax-profile" else k): v
                 for k, v in ref["/debug/"]["surfaces"].items()}
    assert port["/debug/"] == {"component": component, "surfaces": ref_index}
    assert port["/debug"] == port["/debug/"]
    assert "/debug/torch-profile" in port["/debug/"]["surfaces"]
    # The endpoint label is the route template, "unmatched" for a 404.
    assert port["requests"] == ref["requests"]
    endpoints = {dict(k)["endpoint"] for k in port["requests"]}
    assert {"/debug/", "/debug", "/debug/trace", "unmatched"} <= endpoints
    for path in ("/debug/slo", "/debug/failpoints", "/debug/pprof/looplag"):
        assert _keys(port[path]) == _keys(ref[path]), path
    assert _keys(port["/debug/healthcheck"][_HC]) == _keys(ref["/debug/healthcheck"][_HC])
    res_p, res_r = port["/debug/resources"], ref["/debug/resources"]
    assert set(res_p["process"]) == set(res_r["process"])
    assert len(res_p["sentinels"]) == len(res_r["sentinels"]) == (component != "tracker")
    for (kp, sp), (kr, sr) in zip(res_p["sentinels"].items(), res_r["sentinels"].items()):
        assert kp == kr
        assert set(sp) == set(sr) and set(sp["last_sample"]) == set(sr["last_sample"])
    assert ("arm-refused", 403) in port["status"] and ("arm-allowed", 200) in port["status"]
    assert port["armed"] == ref["armed"]
    assert port["openmetrics"] == ref["openmetrics"] == (200, True, True)


# -- /debug/torch-profile ----------------------------------------------------------

def test_torch_profile_refuses_bad_asks_and_one_capture_at_a_time(tmp_path, monkeypatch,
                                                                    process_globals):
    """On a cpu node: a malformed ``seconds`` or a ``dir`` outside the
    capture root answers 400, a second call during a capture 409; the
    capture (CPU activity only, said so) writes a Chrome trace under the
    asked dir. A client that goes away mid-capture ends it: the stop runs
    and only then is the lock free, and the next capture is taken."""
    root = tmp_path / "root"
    root.mkdir()
    monkeypatch.setenv("KRAKEN_PROFILE_DIR", str(root))

    async def main():
        node = make_node(PORT, "tracker", tmp_path, **QUIET)
        await node.start()
        base = f"http://{node.addr}/debug/torch-profile"
        try:
            async with aiohttp.ClientSession() as s:
                assert (await fetch(s, "GET", f"{base}?seconds=x"))[0] == 400
                assert (await fetch(s, "GET", f"{base}?dir={tmp_path}"))[0] == 400
                first = asyncio.ensure_future(
                    fetch(s, "GET", f"{base}?seconds=0.5&dir={root / 'mine'}"))
                while port_metrics._active_capture is None:
                    await asyncio.sleep(0.01)
                status, body = await fetch(s, "GET", f"{base}?seconds=0.1")
                assert (status, body) == (409, b"capture already running")
                status, body = await first
                assert status == 200
                doc = json.loads(body)
                assert doc["device"] == "cpu" and doc["activities"] == ["cpu"]
                assert doc["kernels"] == {} and doc["seconds"] == 0.5
                assert os.path.dirname(doc["trace_file"]) == str(root / "mine")
                traces.append(doc["trace_file"])
                # Disconnect mid-capture: the client times out at 0.3 s of
                # a 60 s capture (seconds is clamped to 60).
                with pytest.raises(asyncio.TimeoutError):
                    await fetch(s, "GET", f"{base}?seconds=600",
                                timeout=aiohttp.ClientTimeout(total=0.3))
                for _ in range(500):
                    if not port_metrics._profile_lock.locked():
                        break
                    await asyncio.sleep(0.02)
                assert not port_metrics._profile_lock.locked()
                status, body = await fetch(s, "GET", f"{base}?seconds=0.1")
                assert status == 200 and json.loads(body)["seconds"] == 0.1
        finally:
            await node.stop()

    traces: list = []
    run(main())
    assert port_metrics._active_capture is None
    with open(traces[0]) as f:
        assert "traceEvents" in json.load(f)


# -- the canary --------------------------------------------------------------------

@pytest.mark.parametrize("node,seq,size,epoch", [
    ("agent-127.0.0.1", 1, 262144, 0), ("a", 7, 1, 1792265799), ("b", 0, 100003, 5)])
def test_canary_blobs_are_the_references_byte_for_byte(node, seq, size, epoch):
    assert (port_canary.canary_blob(node, seq, size, epoch)
            == jax_canary.canary_blob(node, seq, size, epoch))


def test_a_canary_probe_through_a_port_herd_is_recorded_good(tmp_path, process_globals):
    """A port tracker, origin and agent in this process: one probe seeds a
    blob through the origin and pulls it through the swarm; it is recorded
    ok, as canary traffic (``slo_events_total{canary="1"}``), the
    document lands on /debug/slo, and the agent's stop reaps the blob on
    both sides."""
    from kraken_tpu_torch.origin.client import ClusterClient
    from kraken_tpu_torch.placement import HostList, Ring

    events = port_metrics.REGISTRY.counter("slo_events_total")

    async def main():
        tracker = port_assembly.TrackerNode(announce_interval_seconds=0.1, **QUIET)
        await tracker.start()
        origin = port_assembly.OriginNode(str(tmp_path / "o"), tracker_addr=tracker.addr,
                                          hasher="cpu", dedup=False, **QUIET)
        await origin.start()
        cluster = ClusterClient(Ring(HostList(static=[origin.addr]), max_replica=1))
        tracker.server.origin_cluster = cluster
        agent = port_assembly.AgentNode(
            str(tmp_path / "a"), tracker.addr, hasher="cpu", slo={"bucket_seconds": 1.0},
            profiling={"enabled": False},
            canary={"origins": origin.addr, "blob_bytes": 65536, "ttl_seconds": 60.0,
                    "pull_timeout_seconds": 10.0})
        await agent.start()
        try:
            good = events.value(sli="pull", result="good", canary="1")
            doc = await agent.canary.probe()
            assert doc["result"] == "ok", doc
            assert events.value(sli="pull", result="good", canary="1") == good + 1
            assert SLO.canary_status is doc and doc["stages"]["pull_s"] >= 0
            d = port_assembly.Digest.from_hex(doc["digest"])
            assert agent.store.in_cache(d) and origin.store.in_cache(d)
        finally:
            await agent.stop()
            assert not agent.store.in_cache(d) and not origin.store.in_cache(d)
            await origin.stop()
            await cluster.close()
            await tracker.stop()

    run(main())


# -- the sentinel ------------------------------------------------------------------

_BUDGETS = {"max_open_fds": 1, "loop_lag_p99_seconds": 0.01, "max_retry_queue": 3,
            "max_tasks": 100000, "breach_streak": 2, "drain_on_breach": True}


def _sentinel_run(resources) -> tuple[list, list]:
    drains: list = []
    sentinel = resources.ResourceSentinel(
        "agent", _BUDGETS, on_sustained_breach=drains.append,
        loop_lag_probe=lambda: 0.5, retry_probe=lambda: {"replicate": 2, "heal": 2})
    try:
        breached = [sentinel._finish_sample({"stale_spool": 0})["breached"] for _ in range(3)]
        sentinel.apply({**_BUDGETS, "max_retry_queue": 10})
        breached.append(sentinel._finish_sample({})["breached"])
        return breached, drains
    finally:
        sentinel.stop()


def test_the_sentinel_breaches_on_the_same_probes_as_the_references():
    """Both packages' sentinels, fed the same loop-lag and retry-queue
    probes, breach the same budgets sample by sample, call the drain hook
    once when a breach is sustained (latched), and start clean after a
    reload."""
    port, ref = _sentinel_run(port_resources), _sentinel_run(jax_resources)
    assert port == ref
    breached, drains = port
    assert breached[0] == ["fds", "loop_lag", "retry_queue"] and breached[-1] == ["fds", "loop_lag"]
    assert drains == [["fds", "loop_lag", "retry_queue"]]


def test_drain_on_breach_puts_the_node_in_lameduck(tmp_path, process_globals):
    drains = port_metrics.REGISTRY.counter("resource_breach_drains_total")

    async def main():
        node = make_node(PORT, "agent", tmp_path, **QUIET, resources={
            "max_open_fds": 1, "breach_streak": 1, "drain_on_breach": True,
            "interval_seconds": 3600})
        await node.start()
        try:
            before = drains.value(component="agent")
            assert not node.server.lameduck
            assert (await node.sentinel.sample())["breached"] == ["fds"]
            assert node.server.lameduck
            assert drains.value(component="agent") == before + 1
            async with aiohttp.ClientSession() as s:
                assert (await fetch(s, "GET", f"http://{node.addr}/health"))[0] == 503
        finally:
            await node.stop()

    run(main())


def test_metrics_carries_kernel_launches_on_both_formats(monkeypatch):
    """``kernel_launches_total{kernel}`` (the port's own series) is on the
    classic text and on the OpenMetrics answer, whose counter families
    drop the ``_total`` suffix as OpenMetrics requires."""
    from kraken_tpu_torch.ops import sha256_cuda
    from kraken_tpu_torch.utils import http_lite

    monkeypatch.setattr(sha256_cuda, "LAUNCHES", {"sha256_ragged": 7, "sha256_uniform": 2})

    async def main():
        app = port_metrics.instrument_app(http_lite.Application(), "launch-test")
        runner, port = await http_lite.serve(app, "127.0.0.1", 0)
        try:
            async with aiohttp.ClientSession() as s:
                classic = (await fetch(s, "GET", f"http://127.0.0.1:{port}/metrics"))[1]
                om = (await fetch(s, "GET", f"http://127.0.0.1:{port}/metrics", headers={
                    "Accept": "application/openmetrics-text; version=1.0.0"}))[1]
        finally:
            await runner.cleanup()
        return classic.decode(), om.decode()

    classic, om = asyncio.run(main())
    for text in (classic, om):
        assert 'kernel_launches_total{kernel="sha256_ragged"} 7' in text.splitlines()
    assert "# TYPE kernel_launches_total counter" in classic.splitlines()
    assert "# TYPE kernel_launches counter" in om.splitlines()
    assert om.endswith("# EOF\n") and "# TYPE http_requests_total" not in om
