"""Runs one cell of ``BENCHMARK.json``: the look for a card, the driver, the
readers, the check that nothing of JAX was loaded, and the result line.

A driver's ``run(ctx) -> Outcome`` sets the system up, calls
``ctx.window_opens()`` at its first timed request, drives the window, and
returns what it observed (``Outcome.obs``) with the numbers that decide
``correct`` (``Outcome.checks``: name -> (number, limit); the run is
correct when each number is at most its limit). Every metric, end-to-end
or per layer, is read from ``obs`` by the reader file of its name, except
``setup_s``, which the harness times itself.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib
import importlib.util
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
# Build and kernel caches at fixed paths inside the checkout, so that only
# the first run of a cell in a checkout builds (the port's own kernel
# library builds under ``kraken_tpu_torch/_build``, also inside it).
CACHE_DIR = ROOT / ".portbench_cache"
FORBIDDEN = ("jax", "jaxlib", "flax", "kraken_tpu")
# Faults a CPU rehearsal can plant under the timed path, to show that the
# comparison catches each (portbench/tests/test_portbench_faults.py).
FAULTS = ("alter_answer", "unchanged_state", "half_batch")


def pin_caches() -> None:
    """Point every cache the port's stack may write at the checkout, before
    torch is imported."""
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE_DIR / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE_DIR / "triton")
    os.environ["USE_FLAX"] = "0"


@dataclasses.dataclass
class Outcome:
    obs: dict
    attempted: int
    failed: int
    checks: dict[str, tuple[float, float]]
    memory_peak_bytes: int
    trace: dict | None = None  # busy_s, window_s, breakdown (portbench.devtrace)
    lines: list[dict] = dataclasses.field(default_factory=list)
    # The top-level modules that a helper process reported loading.
    child_modules: list[str] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class Context:
    args: argparse.Namespace
    cell: dict
    config: dict
    traffic: dict
    workdir: Path
    t_start: float
    setup_s: float | None = None

    @property
    def cpu(self) -> bool:
        return self.args.cpu

    def window_opens(self) -> None:
        """The first timed request is due now: set-up ends here."""
        self.setup_s = time.monotonic() - self.t_start


def parse(argv: list[str] | None = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="portbench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--cpu", action="store_true",
                   help="rehearse on the CPU with the kernels' plain versions, at the "
                        "configuration's rehearsal sizes; not a measurement")
    p.add_argument("--control", action="store_true",
                   help="put the cell's control in the program's place (it must come "
                        "out not correct)")
    p.add_argument("--fault", choices=FAULTS,
                   help="plant a fault under the timed path (CPU rehearsal only)")
    args = p.parse_args(argv)
    if args.fault and not args.cpu:
        p.error("--fault is for CPU rehearsals")
    return args


def load_bench() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def plan(bench: dict, workload: str) -> tuple[dict, dict, dict, list, list]:
    """The cell's entry, configuration file, traffic file, end-to-end
    metrics and per-layer metrics."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"portbench: no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    config = json.loads((ROOT / entry["file"]).read_text())
    traffic = json.loads((BENCH_DIR / "traffic" / f"{cell['traffic']}.json").read_text())
    e2e = [m for m in bench["end_to_end"] if workload in m.get("workloads", [workload])]
    for m in bench["per_layer"]:
        if "workloads" not in m:
            raise SystemExit(f"portbench: per-layer metric {m['name']!r} names no workloads")
    per_layer = [m for m in bench["per_layer"] if workload in m["workloads"]]
    return cell, config, traffic, e2e, per_layer


def load_reader(name: str):
    """``metrics/<name>.py``'s ``read``."""
    path = BENCH_DIR / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def smi_power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "not read"


def device_of(chips: int, cpu: bool) -> dict:
    """The card the cell runs on; exits without a result when there is
    none (no CPU fallback: a CPU run must be asked for)."""
    import torch

    if cpu:
        return {"platform": "cpu", "kind": "cpu rehearsal, not a measurement", "count": 0}
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < chips:
        raise SystemExit(f"portbench: the cell needs {chips} CUDA device(s), found {found}; "
                         "no result (pass --cpu for a rehearsal)")
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
            "power_limit": smi_power_limit()}


def forbidden_modules(child_modules: list[str] = ()) -> list[str]:
    """JAX or the JAX package among this process's modules and those a
    helper process reported, compared by the whole top-level name."""
    tops = {m.split(".")[0] for m in list(sys.modules)} | set(child_modules)
    return sorted(tops & set(FORBIDDEN))


def number(v: float) -> float | int:
    return int(v) if float(v).is_integer() and abs(v) < 2**53 else float(v)


def main(t_start: float, argv: list[str] | None = None) -> int:
    args = parse(argv)
    pin_caches()
    bench = load_bench()
    cell, config, traffic, e2e, per_layer = plan(bench, args.workload)
    device = device_of(cell["chips"], args.cpu)
    print(json.dumps({"portbench": "start", "workload": args.workload, "seed": args.seed,
                      "device": device}), file=sys.stderr, flush=True)
    driver = importlib.import_module(f"portbench.drivers.{traffic['driver']}")
    with tempfile.TemporaryDirectory(prefix="portbench-") as work:
        ctx = Context(args, cell, config, traffic, Path(work), t_start)
        out = driver.run(ctx)
    bad = forbidden_modules(out.child_modules)
    if bad:
        print(f"portbench: the run loaded {bad}; no result", file=sys.stderr)
        return 3
    out.obs["setup_s"] = ctx.setup_s
    readers = {"setup_s": lambda obs: obs["setup_s"]}
    metrics = {}
    for m in (per_layer if args.trace else e2e):
        read = readers.get(m["name"]) or load_reader(m["name"])
        v = read(out.obs)
        if v is not None and math.isfinite(v):
            metrics[m["name"]] = {"value": number(v), "unit": m["unit"]}
    device["memory_peak_bytes"] = int(out.memory_peak_bytes)
    result = {"correct": all(v <= lim for v, lim in out.checks.values()) and bool(out.checks),
              "attempted": out.attempted, "failed": out.failed, "metrics": metrics,
              "device": device}
    if args.cpu:
        result["measurement"] = False
    if args.trace and out.trace is not None:
        device["busy_s"] = out.trace["busy_s"]
        device["window_s"] = out.trace["window_s"]
        result["breakdown"] = out.trace["breakdown"]
    result["checks"] = {k: {"value": number(v), "limit": number(lim)}
                        for k, (v, lim) in out.checks.items()}
    for line in out.lines:
        print(json.dumps(line), flush=True)
    for k, (v, lim) in out.checks.items():
        print(f"check {k} {number(v)} limit {number(lim)}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
