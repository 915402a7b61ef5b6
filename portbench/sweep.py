"""The knee of an agent cell: the highest rate that the agent sustains,
with the cell's own arrivals. One set-up, then one window a rate in turns,
rising, each image evicted before the next window::

    python3 -m portbench.sweep --workload agent.pull-c2 --seed 7 --seconds 51 \\
        --rates 0.42,0.56,0.7,0.84 --pool 24 --witness 1.0

A rate is sustained when no pull failed and the images in flight do not
grow over the window's second half (a least-squares slope of at most
``GROWTH`` images a second). The sweep stops at the first rate that is not
sustained; ``--witness`` then runs one more window at an overload, to
show how the agent and the helper hold up there. Prints one JSON line a
rate, with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

from portbench import harness
from portbench.drivers.agent_pull import Session, image_spans, in_flight_max
from portbench.readers import pull_latencies, rank, ratio

GROWTH = 0.05


def summarize(w: dict) -> dict:
    s = w["window_s"]
    spans = image_spans(w["pulls"])
    done = sum(1 for _a, b in spans if b <= s)
    ts = np.arange(s / 2, s, 0.25)
    inflight = [sum(1 for a, b in spans if a <= t < b) for t in ts]
    slope = float(np.polyfit(ts, inflight, 1)[0]) if len(ts) > 1 else 0.0
    lat = pull_latencies(w)
    failed = sum(p["status"] != 200 for p in w["pulls"])
    return {"offered_images_per_s": len(spans) / s, "completed_images_per_s": done / s,
            "images_open_at_close": len(spans) - done, "in_flight_slope_per_s": slope,
            "images_in_flight_max": in_flight_max(w["pulls"]),
            "sustained": failed == 0 and slope <= GROWTH,
            "pull_mean_s": float(np.mean(lat)),
            **{f"pull_p{q}_s": rank(lat, q / 100) for q in (50, 80, 90, 100)},
            "dup_bytes_ratio": ratio(w, "settled", "bytes_down", "bytes_needed"),
            "rows_per_launch": ratio(w, "window", "verify_pieces", "launches.sha256_ragged"),
            "failed": failed, "late_max_s": max(w["late"]), "load": w["load"]}


async def sweep(ctx: harness.Context, rates: list[float], witness: float | None, pool: int,
                grace: float) -> None:
    s = Session(ctx, pool, grace, ctx.traffic["warm_images"])

    async def window(rate: float, role: str) -> dict:
        t = time.monotonic()
        w = summarize(await s.window(rate, ctx.args.seconds))
        if role == "sweep":  # the witness is last: what it leaves goes with the agent
            await s.reset()
        print(json.dumps({"sweep": ctx.args.workload, "role": role, "rate": rate, **w,
                          "wall_s": time.monotonic() - t}), flush=True)
        return w

    try:
        await s.setup()
        for rate in sorted(rates):
            if not (await window(rate, "sweep"))["sustained"]:
                break
        if witness is not None:
            await window(witness, "witness")
    finally:
        await s.close()
    print(json.dumps({"sweep": ctx.args.workload, "helper_modules": s.helper_modules,
                      "forbidden": harness.forbidden_modules(s.helper_modules or [])}),
          flush=True)


def main(argv: list[str] | None = None) -> int:
    t_start = time.monotonic()
    p = argparse.ArgumentParser(prog="portbench.sweep")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--rates", required=True, help="images a second, comma-separated")
    p.add_argument("--pool", type=int, required=True)
    p.add_argument("--grace", type=float, default=60.0)
    p.add_argument("--witness", type=float, help="one more window at this rate, last")
    p.add_argument("--cpu", action="store_true")
    a = p.parse_args(argv)
    harness.pin_caches()
    cell, config, traffic, _e2e, _pl = harness.plan(harness.load_bench(), a.workload)
    device = harness.device_of(cell["chips"], a.cpu)
    print(json.dumps({"sweep": a.workload, "device": device}), flush=True)
    args = argparse.Namespace(seed=a.seed, seconds=a.seconds, trace=0, cpu=a.cpu,
                              control=False, fault=None, workload=a.workload)
    with tempfile.TemporaryDirectory(prefix="portbench-sweep-") as work:
        ctx = harness.Context(args, cell, config, traffic, Path(work), t_start)
        asyncio.run(sweep(ctx, [float(r) for r in a.rates.split(",")], a.witness, a.pool,
                          a.grace))
    return 0


if __name__ == "__main__":
    sys.exit(main())
