"""The one generator of inputs: seeded bytes and arrival times, from the
parameters of a traffic file and a configuration file. The bench and the
reference both take their bytes from here, so both sides see the same.

Arrivals keep the work of a run fixed across seeds: a window of ``S``
seconds at ``rate`` items a second has ``n = round(rate * S)`` arrivals,
whose gaps are the exponential distribution's quantiles at
``(k + 0.5) / n`` (a Poisson process's gaps, stratified) scaled to fill
the window. The traffic file's ``arrivals_key`` shuffles them once into a
fixed sequence, and the seed rotates that sequence: every seed offers the
same items in the same bursts, starting at another point of the cycle.
"""

from __future__ import annotations

import numpy as np

MASK64 = (1 << 64) - 1


def rng(seed: int, *keys: int) -> np.random.Generator:
    return np.random.default_rng([seed & MASK64, *keys])


def blob(seed: int, key: tuple[int, ...], size: int) -> bytes:
    """``size`` seeded bytes, as incompressible as a gzipped layer."""
    return rng(seed, *key).bytes(size)


def arrivals(seed: int, rate: float, seconds: float, key: int) -> list[float]:
    """Due times (seconds from the window's start) of an open loop."""
    n = max(1, round(rate * seconds))
    q = (np.arange(n) + 0.5) / n
    gaps = -np.log1p(-q)
    gaps *= seconds / gaps.sum()
    np.random.default_rng([key, 7]).shuffle(gaps)
    gaps = np.roll(gaps, -int(rng(seed, 7).integers(n)))
    due = np.concatenate(([0.0], np.cumsum(gaps)[:-1]))
    return due.tolist()
