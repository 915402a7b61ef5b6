"""Arithmetic shared by the metric files (``metrics/<name>.py``). Each
reader returns ``None`` when its run holds nothing to read, and never 0
for a share of a roofline."""

from __future__ import annotations

import math

from portbench import devtrace, roofline


def rank(values: list[float], q: float) -> float:
    """The nearest-rank ``q`` quantile: the value that ``q`` of the
    samples are at or below."""
    s = sorted(values)
    return s[max(0, math.ceil(q * len(s)) - 1)]


def pull_latencies(obs: dict) -> list[float]:
    """Every layer pull due in the window, from its due time to the last
    byte of a 200; one that failed or never ended counts as the longest a
    run can see (the window and the grace after it)."""
    cap = obs["window_s"] + obs["grace_s"]
    return [p["end"] - p["due"] if p["status"] == 200 and p["end"] is not None else cap
            for p in obs["pulls"]]


def pull_quantile(obs: dict, q: float) -> float | None:
    lat = pull_latencies(obs)
    return rank(lat, q) if lat else None


def ratio(obs: dict, span: str, num: str, den: str) -> float | None:
    c = obs["counters"][span]
    return c[num] / c[den] if c[den] else None


def roofline_pct(obs: dict, kernel: str = "sha256_rows_kernel") -> float | None:
    """The least time the window's SHA-256 work could take on the card, over
    the kernel's summed device time in the window's trace."""
    seconds = devtrace.kernel_seconds(obs["trace"], kernel)
    c = obs["counters"]["window"]
    if not seconds or not c["rows_hashed"]:
        return None
    blocks = roofline.blocks_lower(c["bytes_hashed"], c["rows_hashed"])
    return 100.0 * roofline.least_seconds(blocks, c["bytes_hashed"], c["rows_hashed"]) / seconds


def idle_pct(obs: dict) -> float | None:
    t = obs["trace"]
    if t is None or not t["window_s"]:
        return None
    return 100.0 * (t["window_s"] - t["busy_s"]) / t["window_s"]
