"""Token-bucket bandwidth limiting for async IO.

Mirrors uber/kraken ``utils/bandwidth`` (egress/ingress token buckets used
by the conn plane and per-backend caps) -- upstream path, unverified;
SURVEY.md SS2.5. Async-native: ``acquire`` suspends the calling task until
tokens accrue, so a single limiter shapes many concurrent transfers.
"""

from __future__ import annotations

import asyncio
import time


class TokenBucket:
    """Classic token bucket: ``rate`` tokens/sec, burst up to ``capacity``.

    ``rate <= 0`` disables limiting.
    """

    def __init__(self, rate: float, capacity: float | None = None):
        self.rate = rate
        self.capacity = capacity if capacity is not None else max(rate, 1.0)
        self._tokens = self.capacity
        self._last = time.monotonic()
        self._lock = asyncio.Lock()

    def _refill(self) -> None:
        now = time.monotonic()
        self._tokens = min(self.capacity, self._tokens + (now - self._last) * self.rate)
        self._last = now

    async def acquire(self, n: float) -> None:
        """Take ``n`` tokens, waiting as needed. Requests larger than the
        bucket capacity are allowed through in one go once the bucket is
        full (they'd otherwise deadlock)."""
        if self.rate <= 0:
            return
        async with self._lock:
            while True:
                self._refill()
                take = min(n, self.capacity)
                if self._tokens >= take:
                    self._tokens -= n  # may go negative: debt delays next caller
                    return
                await asyncio.sleep((take - self._tokens) / self.rate)

    def try_acquire(self, n: float) -> bool:
        """Non-blocking variant."""
        if self.rate <= 0:
            return True
        self._refill()
        if self._tokens >= n:
            self._tokens -= n
            return True
        return False


class BandwidthLimiter:
    """Paired ingress/egress buckets (bytes/sec), as the conn plane uses."""

    def __init__(self, ingress_bps: float = 0, egress_bps: float = 0, burst: float | None = None):
        self.ingress = TokenBucket(ingress_bps, burst)
        self.egress = TokenBucket(egress_bps, burst)

    async def recv(self, nbytes: int) -> None:
        await self.ingress.acquire(nbytes)

    async def send(self, nbytes: int) -> None:
        await self.egress.acquire(nbytes)
