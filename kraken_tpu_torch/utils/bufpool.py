"""Size-classed buffer pool: the ingest plane's staging windows.

The port's copy of ``kraken_tpu.utils.bufpool`` (``SlabRing``, the
leech-shard slab, waits for that plane). A lease for ``n`` bytes draws a
reused ``bytearray`` from the power-of-two class that fits (floor 4 KiB);
one explicit :meth:`Lease.release` returns it. Retained (free) bytes are
capped by ``budget_bytes``; a release that would exceed the budget drops
the buffer to the allocator, so the pool never holds more than budget +
what is concurrently leased. Gauges ``bufpool_leased`` /
``bufpool_hit_ratio`` / ``bufpool_retained_bytes`` (labelled by pool) say
whether the pool is recycling.

Thread-safe: the ingest plane leases on the caller's thread and releases
on its window workers.
"""

from __future__ import annotations

import threading

MIN_CLASS = 1 << 12  # 4 KiB: below this, pooling costs more than malloc


def _class_for(n: int) -> int:
    size = MIN_CLASS
    while size < n:
        size <<= 1
    return size


class Lease:
    """One leased buffer. ``view`` is a length-``n`` writable memoryview
    over the (possibly larger) class-sized backing ``bytearray``.
    :meth:`release` is idempotent -- racing returns of one buffer must let
    exactly one win (a double return would hand the same bytes to two
    windows)."""

    __slots__ = ("_pool", "_buf", "view", "_lock")

    def __init__(self, pool: "BufferPool", buf: bytearray, n: int):
        self._pool = pool
        self._buf = buf
        self.view = memoryview(buf)[:n]
        self._lock = threading.Lock()

    @property
    def released(self) -> bool:
        return self._buf is None

    def release(self) -> None:
        with self._lock:
            buf, self._buf = self._buf, None
        if buf is None:
            return
        try:
            # Releasing the exporting view makes any use-after-release a
            # loud ValueError instead of a silent read of recycled bytes.
            self.view.release()
        except BufferError:
            # A reader still exports the view: it can't be torn down under
            # it, so DROP the buffer instead of pooling it -- a rare lost
            # buffer beats recycling memory a reader holds.
            self._pool._drop(buf)
            return
        self._pool._give_back(buf)


class BufferPool:
    """Process-lifetime pool; one per ingest pipeline."""

    def __init__(self, budget_bytes: int = 256 << 20, name: str = "wire"):
        self.name = name
        self._budget = budget_bytes
        self._lock = threading.Lock()
        self._free: dict[int, list[bytearray]] = {}
        self._retained = 0
        # Stats (read by tests; rendered as gauges).
        self.leased = 0
        self.hits = 0
        self.misses = 0
        self.allocated = 0  # lifetime buffers created (reuse => stays flat)
        # Gauge refs resolved ONCE, not a registry lookup per lease.
        from kraken_tpu_torch.utils.metrics import REGISTRY

        self._g_leased = REGISTRY.gauge(
            "bufpool_leased", "Wire payload buffers currently leased"
        )
        self._g_hit = REGISTRY.gauge(
            "bufpool_hit_ratio",
            "Fraction of leases served from the free list",
        )
        self._g_retained = REGISTRY.gauge(
            "bufpool_retained_bytes", "Free bytes retained for reuse"
        )

    def set_budget(self, budget_bytes: int) -> None:
        """Live-reload surface. Shrinking takes effect lazily: retained
        buffers above the new budget are dropped as they cycle through
        the next release."""
        with self._lock:
            self._budget = budget_bytes

    @property
    def budget_bytes(self) -> int:
        with self._lock:
            return self._budget

    def lease(self, n: int) -> Lease:
        size = _class_for(n)
        with self._lock:
            free = self._free.get(size)
            if free:
                buf = free.pop()
                self._retained -= size
                self.hits += 1
            else:
                buf = None
                self.misses += 1
            self.leased += 1
        if buf is None:
            buf = bytearray(size)
            with self._lock:
                self.allocated += 1
        self._record()
        return Lease(self, buf, n)

    def _give_back(self, buf: bytearray) -> None:
        size = len(buf)
        with self._lock:
            self.leased -= 1
            if self._retained + size <= self._budget:
                self._free.setdefault(size, []).append(buf)
                self._retained += size
            # else: over budget -- drop to the allocator.
        self._record()

    def _drop(self, buf: bytearray) -> None:
        """Lease ends but the buffer is still exported by a reader: count
        the lease back without pooling the bytes."""
        with self._lock:
            self.leased -= 1
        self._record()

    @property
    def retained_bytes(self) -> int:
        with self._lock:
            return self._retained

    def hit_ratio(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def _record(self) -> None:
        with self._lock:
            leased, retained = self.leased, self._retained
            total = self.hits + self.misses
            ratio = self.hits / total if total else 0.0
        self._g_leased.set(leased, pool=self.name)
        self._g_hit.set(ratio, pool=self.name)
        self._g_retained.set(retained, pool=self.name)
