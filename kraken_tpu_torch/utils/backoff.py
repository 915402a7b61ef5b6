"""Exponential backoff with jitter (reference: uber/kraken ``utils/backoff``
-- upstream path, unverified; SURVEY.md SS2.5)."""

from __future__ import annotations

import dataclasses
import random


@dataclasses.dataclass(frozen=True)
class Backoff:
    base_seconds: float = 0.25
    factor: float = 2.0
    max_seconds: float = 30.0
    jitter: float = 0.2  # +/- fraction

    def delay(self, attempt: int) -> float:
        """Delay before retry ``attempt`` (0-based)."""
        d = min(self.max_seconds, self.base_seconds * self.factor**attempt)
        if self.jitter:
            d *= 1 + random.uniform(-self.jitter, self.jitter)
        return max(0.0, d)


@dataclasses.dataclass(frozen=True)
class DecorrelatedJitter:
    """AWS-style decorrelated-jitter backoff: each delay is drawn from
    ``uniform(base, prev * 3)`` (capped), so repeated failures spread a
    fleet's retries instead of synchronizing them the way plain
    exponential-with-ratio-jitter does. Stateless -- the caller carries
    ``prev`` (0 = first failure, which yields exactly ``base`` so the
    initial cooldown stays deterministic for operators and tests)."""

    base_seconds: float = 30.0
    max_seconds: float = 300.0

    def next(self, prev: float, rng: random.Random | None = None) -> float:
        if prev <= 0:
            return min(self.base_seconds, self.max_seconds)
        draw = (rng or random).uniform(self.base_seconds, prev * 3)
        return min(self.max_seconds, max(self.base_seconds, draw))
