"""In-flight request coalescing + TTL result cache.

Mirrors uber/kraken ``utils/dedup`` (guards duplicate downloads: N
concurrent requests for one blob become one download) -- upstream path,
unverified; SURVEY.md SS2.5. The thundering-herd guard sits in front of
the scheduler and blobrefresh paths.
"""

from __future__ import annotations

import asyncio
import time
from typing import Awaitable, Callable, Generic, Hashable, TypeVar

T = TypeVar("T")


class RequestCoalescer(Generic[T]):
    """``get(key, fn)``: concurrent callers of the same key share one
    invocation of ``fn``; its result (or exception) fans out to all."""

    def __init__(self):
        self._inflight: dict[Hashable, asyncio.Future] = {}

    async def get(self, key: Hashable, fn: Callable[[], Awaitable[T]]) -> T:
        fut = self._inflight.get(key)
        if fut is None:
            fut = asyncio.get_running_loop().create_future()
            self._inflight[key] = fut
            try:
                result = await fn()
            except BaseException as e:
                self._inflight.pop(key, None)
                if not fut.done():
                    fut.set_exception(e)
                    # Consume so "exception never retrieved" isn't logged if
                    # no one else was waiting.
                    fut.exception()
                raise
            self._inflight.pop(key, None)
            if not fut.done():
                fut.set_result(result)
            return result
        return await asyncio.shield(fut)


class TTLCache(Generic[T]):
    """Tiny TTL cache for interval-style results (e.g. announce lists).

    ``max_entries`` bounds memory for open-ended key spaces (tag names,
    digests): inserting into a full cache evicts the stalest entry.
    """

    def __init__(self, ttl_seconds: float, max_entries: int | None = None):
        self.ttl = ttl_seconds
        self.max_entries = max_entries
        self._entries: dict[Hashable, tuple[float, T]] = {}

    def get(self, key: Hashable) -> T | None:
        hit = self._entries.get(key)
        if hit is None:
            return None
        ts, value = hit
        if time.monotonic() - ts > self.ttl:
            del self._entries[key]
            return None
        return value

    def put(self, key: Hashable, value: T) -> None:
        if (
            self.max_entries is not None
            and key not in self._entries
            and len(self._entries) >= self.max_entries
        ):
            oldest = min(self._entries, key=lambda k: self._entries[k][0])
            del self._entries[oldest]
        self._entries[key] = (time.monotonic(), value)

    def invalidate(self, key: Hashable) -> None:
        self._entries.pop(key, None)
