"""The device trace of a window: ``torch.profiler`` (CUPTI) around it, and
its reduction to the device's busy time, each device operation's time and
the longest idle gaps, named by what the host was doing.

The profiler starts before the window (its own start-up stays out of it)
and a ``record_function`` range marks the window on the host's timeline;
only device operations inside that range are read.
"""

from __future__ import annotations

import json
from pathlib import Path

WINDOW_MARK = "portbench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")
TOP = 10


class DeviceTrace:
    """``with --trace 1``: start before the window, ``open()`` and
    ``close()`` at its edges (on one thread), ``summary()`` after it."""

    def __init__(self, workdir: Path):
        import torch

        self._torch = torch
        self._path = workdir / "trace.json"
        self._prof = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA])
        self._mark = None

    def start(self) -> None:
        self._prof.start()

    def open(self) -> None:
        self._mark = self._torch.autograd.profiler.record_function(WINDOW_MARK)
        self._mark.__enter__()

    def close(self) -> None:
        self._mark.__exit__(None, None, None)

    def summary(self) -> dict:
        self._torch.cuda.synchronize()
        self._prof.stop()
        self._prof.export_chrome_trace(str(self._path))
        events = json.loads(self._path.read_text())["traceEvents"]
        self._path.unlink()
        return reduce(events)


def merged(intervals) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def reduce(events: list[dict]) -> dict:
    """Chrome-trace events (``ts`` and ``dur`` in microseconds) -> the
    window's ``busy_s``, ``window_s``, seconds by device operation
    (``ops``) and ``breakdown``."""
    marks = [e for e in events if e.get("name") == WINDOW_MARK and e.get("ph") == "X"
             and e.get("cat") == "user_annotation"]
    if not marks:
        raise RuntimeError("device trace: the window's mark is missing")
    w0 = marks[0]["ts"]
    w1 = w0 + marks[0]["dur"]
    device, host = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        a, b = max(e["ts"], w0), min(e["ts"] + e["dur"], w1)
        if b <= a:
            continue
        if e.get("cat") in DEVICE_CATS:
            device.append((a, b, e["name"]))
        elif e.get("cat") in HOST_CATS and e["name"] != WINDOW_MARK:
            host.append((a, b, e["name"]))
    ops: dict[str, float] = {}
    for a, b, name in device:
        ops[name] = ops.get(name, 0.0) + (b - a) / 1e6
    busy = merged((a, b) for a, b, _n in device)
    busy_s = sum(b - a for a, b in busy) / 1e6
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
    gaps.sort(key=lambda g: g[1] - g[0], reverse=True)
    named = []
    for a, b in gaps[:TOP]:
        best, name = 0.0, "no host operation traced"
        for ha, hb, hn in host:
            ov = min(b, hb) - max(a, ha)
            if ov > best:
                best, name = ov, hn
        named.append([name, (b - a) / 1e6])
    top_ops = sorted(ops.items(), key=lambda kv: kv[1], reverse=True)[:TOP]
    return {"busy_s": busy_s, "window_s": (w1 - w0) / 1e6, "ops": ops,
            "breakdown": {"device_ops": [[n, s] for n, s in top_ops], "idle_gaps": named}}


def kernel_seconds(trace: dict | None, kernel: str) -> float:
    """Summed device seconds of the kernels whose name holds ``kernel``."""
    if trace is None:
        return 0.0
    return sum(s for n, s in trace["ops"].items() if kernel in n)
