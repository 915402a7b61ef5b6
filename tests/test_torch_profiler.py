"""The port's profiling plane as the nodes start it: the sampler's window
ring and live reload, the loop-lag monitor naming a blocking frame, profile
dumps that the reference's flame loader reads, the trigger captures'
throttle, a node's SIGHUP of its ``profiling:`` section; with
``SLOManager.apply`` and the CLI's YAML ``failpoints:`` under the chaos
acknowledgement."""

import asyncio
import json
import logging
import os
import threading
import time

import pytest

from kraken_tpu_torch.utils.metrics import REGISTRY
from kraken_tpu_torch.utils.profiler import (
    LoopLagMonitor,
    ProfilerConfig,
    SamplingProfiler,
    looplag_snapshot,
)


def _burn_the_cpu(stop: threading.Event) -> None:
    x = 0
    while not stop.is_set():
        x = (x * 31 + 7) % 1_000_003


def _sampled(tmp_path, **kw) -> SamplingProfiler:
    prof = SamplingProfiler(ProfilerConfig(hz=200, dump_dir=str(tmp_path), **kw))
    prof.node = "port-test"
    stop = threading.Event()
    t = threading.Thread(target=_burn_the_cpu, args=(stop,), daemon=True)
    t.start()
    prof.start()
    try:
        time.sleep(0.3)
    finally:
        prof.stop()
        stop.set()
        t.join(1.0)
    return prof


@pytest.fixture
def process_globals():
    """Nodes apply their sections to the process-global tracer, sampler
    and SLO manager, and their muxes can turn on tracemalloc and start a
    torch.profiler capture; give the rest of the session the state it had:
    the configs, the sampler and the SLO evaluator running or not,
    tracemalloc tracing or not, no capture held."""
    import tracemalloc

    from kraken_tpu_torch.utils import metrics
    from kraken_tpu_torch.utils.profiler import HEAP, PROFILER
    from kraken_tpu_torch.utils.slo import SLO
    from kraken_tpu_torch.utils.trace import TRACER

    saved = (TRACER.config, TRACER.node, TRACER.on_trigger, PROFILER.config, PROFILER.node,
             SLO.config, SLO.node, SLO.canary_status)
    slo_state = (dict(SLO._recorders), dict(SLO._alerts), SLO._last_eval)
    sampling, evaluating, tracing = PROFILER.running, SLO.running, tracemalloc.is_tracing()
    yield
    metrics.stop_profile_capture()
    PROFILER.stop()
    TRACER.apply(saved[0])
    TRACER.node, TRACER.on_trigger = saved[1], saved[2]
    PROFILER.config, PROFILER.node = saved[3], saved[4]
    if sampling:
        PROFILER.start()
    SLO.stop()
    SLO.config, SLO.node, SLO.canary_status = saved[5], saved[6], saved[7]
    SLO._recorders, SLO._alerts, SLO._last_eval = slo_state
    if evaluating:
        SLO.apply(saved[5])
    if not tracing:
        HEAP.stop()
        if tracemalloc.is_tracing():
            tracemalloc.stop()


def test_sampler_start_stop_idempotent_and_live_reload():
    prof = SamplingProfiler(ProfilerConfig(hz=50))
    prof.start()
    prof.start()
    thread0 = prof._thread
    prof.apply(ProfilerConfig(hz=100))  # a new rate restarts the thread
    assert prof.running and prof._thread is not thread0
    prof.apply({"enabled": False})
    assert not prof.running
    prof.apply(ProfilerConfig(hz=100))
    assert prof.running
    prof.stop()
    prof.stop()
    assert not prof.running


def test_the_ring_rotates_and_the_cumulative_count_keeps_every_sample():
    prof = SamplingProfiler(ProfilerConfig(hz=200, window_seconds=0.05, keep_windows=2))
    stop = threading.Event()
    t = threading.Thread(target=_burn_the_cpu, args=(stop,), daemon=True)
    t.start()
    prof.start()
    try:
        time.sleep(0.6)
    finally:
        prof.stop()
        stop.set()
        t.join(1.0)
    snap = prof.snapshot()
    assert len(snap["windows"]) <= 2
    assert sum(prof.plane_cumulative().values()) > sum(prof.plane_totals().values())
    assert snap["stacks"] and snap["stacks"][0][1] >= snap["stacks"][-1][1]
    prof.reset()
    assert prof.plane_cumulative() == {} and prof.folded() == []


def _block_the_loop_for(seconds: float) -> None:
    time.sleep(seconds)  # deliberately synchronous: the stall under test


def test_loop_lag_names_the_blocking_frame(caplog):
    cfg = ProfilerConfig(hz=200, loop_lag_interval_seconds=0.05,
                         loop_lag_threshold_seconds=0.2)
    prof = SamplingProfiler(cfg)

    async def run():
        mon = LoopLagMonitor("port-lag-test", cfg, profiler=prof)
        mon.start()
        try:
            await asyncio.sleep(0.2)
            _block_the_loop_for(0.5)
            await asyncio.sleep(0.2)
            return mon, looplag_snapshot()
        finally:
            mon.stop()

    prof.start()
    try:
        with caplog.at_level(logging.WARNING, logger="kraken.profiler"):
            mon, live = asyncio.run(run())
    finally:
        prof.stop()
    snap = mon.snapshot()
    assert snap["stalls"] >= 1 and snap["max_s"] >= 0.3 and mon.p99() >= 0.3
    assert "_block_the_loop_for" in (snap["last_blame"] or "")
    assert any("_block_the_loop_for" in getattr(r, "blame", "") for r in caplog.records)
    assert any(k.startswith("port-lag-test/") for k in live["monitors"])
    assert REGISTRY.counter("loop_lag_stalls_total").value(component="port-lag-test") >= 1
    assert mon not in looplag_snapshot()["monitors"].values()


def test_a_port_dump_is_read_by_the_references_flame_loader(tmp_path):
    from kraken_tpu.utils.profiler import load_profile_dumps

    prof = _sampled(tmp_path)
    path = prof.dump("manual", "cross-package")
    with open(path) as f:
        header = json.loads(f.readline())
        rows = [json.loads(line) for line in f]
    assert header["profile"] == "manual" and header["stacks"] == len(rows) > 0
    assert all(row["node"] == "port-test" for row in rows)
    stacks, planes, errors = load_profile_dumps([path])
    assert errors == []
    assert sum(stacks.values()) == header["samples"] == sum(r["count"] for r in rows)


def test_trigger_captures_are_throttled_per_trigger(tmp_path):
    empty = SamplingProfiler(ProfilerConfig(dump_dir=str(tmp_path / "e")))
    assert empty.trigger_capture("lameduck") is None  # empty ring: nothing written
    prof = _sampled(tmp_path, dump_min_interval_seconds=30.0)
    first = prof.trigger_capture("lameduck", "drain")
    assert first is not None
    assert prof.trigger_capture("lameduck") is None  # throttled
    other = prof.trigger_capture("breaker_trip")
    assert other is not None and other != first
    deadline = time.time() + 5
    while not (os.path.exists(first) and os.path.exists(other)) and time.time() < deadline:
        time.sleep(0.02)
    assert os.path.exists(first) and os.path.exists(other)
    nodir = SamplingProfiler(ProfilerConfig())
    assert nodir.trigger_capture("lameduck") is None  # no dump_dir: no file


def test_a_nodes_sighup_reloads_its_profiling_section(tmp_path, process_globals):
    from kraken_tpu_torch.assembly import AgentNode
    from kraken_tpu_torch.utils.profiler import PROFILER
    from kraken_tpu_torch.utils.trace import TRACER

    async def run():
        agent = AgentNode(str(tmp_path / "a"), "", hasher="cpu", profiling={"hz": 31})
        await agent.start()
        try:
            assert PROFILER.running and PROFILER.config.hz == 31
            assert agent.loop_monitor is not None
            assert TRACER.on_trigger == PROFILER.trigger_capture
            assert agent.profiling_config.dump_dir == os.path.join(agent.store.root, "traces")
            agent.reload({"profiling": {"hz": 59, "loop_lag_threshold_seconds": 0.9}})
            assert PROFILER.config.hz == 59
            assert agent.loop_monitor.config.loop_lag_threshold_seconds == 0.9
            agent.reload({"profiling": {"enabled": False}})
            assert not PROFILER.running and agent.loop_monitor is None
            agent.reload({"profiling": {"hz": 41}})
            assert PROFILER.running and agent.loop_monitor is not None
        finally:
            await agent.stop()

    asyncio.run(run())


def test_slo_apply_keeps_its_windows_unless_their_geometry_changes():
    from kraken_tpu_torch.utils.slo import SLOConfig, SLOManager

    slo = SLOManager()
    slo.record("pull", True)
    slo.apply({"eval_interval_seconds": 1.0})
    assert slo._recorders  # same buckets: the history stays
    slo.apply(SLOConfig.from_dict({"bucket_seconds": 1.0}))
    assert slo._recorders == {}
    slo.apply({"enabled": False})
    slo.record("pull", False)
    assert slo._recorders == {}


def test_yaml_failpoints_arm_under_the_acknowledgement(tmp_path, monkeypatch, process_globals):
    """With ``KRAKEN_FAILPOINTS_ALLOW=1`` a YAML ``failpoints:`` section
    arms the port's registry and the node boots (the refusal without it
    is in test_torch_config.py)."""
    import logging as _logging

    from kraken_tpu_torch import cli
    from kraken_tpu_torch.utils import failpoints

    cfg = tmp_path / "a.yaml"
    cfg.write_text("failpoints:\n  castore.write: once\n")
    seen = {}

    async def boot(node, describe, config_path=None):
        await node.start()
        seen["armed"] = sorted(failpoints.FAILPOINTS.snapshot()["failpoints"])
        await node.stop()

    monkeypatch.setenv("KRAKEN_FAILPOINTS_ALLOW", "1")
    monkeypatch.setattr(cli, "_run_until_signal", boot)
    root = _logging.getLogger()
    handlers, level = list(root.handlers), root.level
    try:
        cli.main(["agent", "--config", str(cfg), "--hasher", "cpu", "--port", "0",
                  "--p2p-port", "0", "--store", str(tmp_path / "s")])
    finally:
        failpoints.FAILPOINTS.disarm_all()
        failpoints.allow(False)
        root.handlers[:] = handlers
        root.setLevel(level)
    assert seen["armed"] == ["castore.write"]
