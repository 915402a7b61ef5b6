"""The ``PieceHasher`` interface -- the seam the GPU plane plugs into.

Both hot loops of the system route through this interface:

- origin-side metainfo generation (``origin/metainfogen``): hash every piece
  of every uploaded blob;
- agent-side piece verification (``p2p/storage``): hash every received piece.

Implementations register by name: ``cpu`` is the hashlib oracle below,
``cuda`` the hand-written SHA-256 kernel (``kraken_tpu_torch.ops.sha256``).
The interface is batch-shaped -- ``hash_pieces`` takes a whole blob window
and returns an ``[N, 32]`` digest matrix -- because the device amortizes a
launch over many pieces.
"""

from __future__ import annotations

import hashlib
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Callable, Dict

import numpy as np

DIGEST_SIZE = 32


class HashPool:
    """Worker threads for the host piece-hash path.

    Piece hashing is embarrassingly parallel and ``hashlib`` releases the
    GIL for large buffers, so N workers hash N pieces concurrently.
    Occupancy and queue-depth gauges publish at every task edge.
    """

    def __init__(self, workers: int, name: str = "cpu"):
        if workers < 1:
            raise ValueError(f"hash pool needs >= 1 worker: {workers}")
        self.workers = workers
        self.name = name
        self._ex = ThreadPoolExecutor(
            workers, thread_name_prefix=f"hashpool-{name}"
        )
        self._lock = threading.Lock()
        self._running = 0
        self._queued = 0
        self._publish()  # gauges visible from construction

    def _publish(self) -> None:
        from kraken_tpu_torch.utils.metrics import record_hash_pool_metrics

        record_hash_pool_metrics(
            self.name, self.workers, self._running, self._queued
        )

    def submit(self, fn: Callable, *args) -> Future:
        with self._lock:
            self._queued += 1
            self._publish()

        def run():
            with self._lock:
                self._queued -= 1
                self._running += 1
                self._publish()
            try:
                return fn(*args)
            finally:
                with self._lock:
                    self._running -= 1
                    self._publish()

        return self._ex.submit(run)

    def run_sharded(self, n: int, worker: Callable[[int, int], None]) -> None:
        """Run ``worker(lo, hi)`` over ``[0, n)`` split into at most
        ``self.workers`` contiguous shards, blocking until all finish."""
        shards = min(self.workers, n)
        bounds = [k * n // shards for k in range(shards + 1)]
        futs = [
            self.submit(worker, bounds[k], bounds[k + 1])
            for k in range(shards)
        ]
        for f in futs:
            f.result()


def record_hash_metrics(
    hasher: str, nbytes: int, pieces: int, seconds: float,
    occupancy: float = 1.0,
) -> None:
    """North-star gauges: per-call GB/s and batch occupancy, plus
    cumulative byte/piece counters, labeled by hasher."""
    from kraken_tpu_torch.utils.metrics import REGISTRY

    REGISTRY.counter(
        "hasher_bytes_total", "Bytes hashed through the piece-hash plane"
    ).inc(nbytes, hasher=hasher)
    REGISTRY.counter(
        "hasher_pieces_total", "Pieces hashed through the piece-hash plane"
    ).inc(pieces, hasher=hasher)
    if seconds > 0:
        REGISTRY.gauge(
            "hasher_last_gbps", "Throughput of the last hash_pieces call"
        ).set(nbytes / seconds / 1e9, hasher=hasher)
    REGISTRY.gauge(
        "hasher_batch_occupancy",
        "Useful rows / dispatched rows in the last hash_pieces call",
    ).set(occupancy, hasher=hasher)


class PieceHasher:
    """Batched SHA-256 over the pieces of a blob.

    Implementations must be safe to share across threads/tasks.
    """

    name = "abstract"
    # Host hash-worker pool, when the implementation has one (the cpu
    # hasher with workers >= 1); None = strictly serial hashing.
    pool: HashPool | None = None

    def hash_pieces(self, data: bytes | memoryview, piece_length: int) -> np.ndarray:
        """Split ``data`` into ``piece_length`` pieces (last may be short)
        and return the SHA-256 of each as a ``[num_pieces, 32] uint8``
        array. A zero-length blob returns ``[0, 32]``."""
        raise NotImplementedError

    def hash_batch(self, pieces: list[bytes | memoryview]) -> np.ndarray:
        """Hash a list of arbitrary-length pieces -> ``[len(pieces), 32]``.

        Used by the agent verify path, where received pieces arrive out of
        order and are batched briefly before verification.
        """
        raise NotImplementedError


class CPUPieceHasher(PieceHasher):
    """Reference implementation on hashlib, and the golden oracle for the
    GPU plane's tests (crypto hashes admit no tolerance).

    ``workers >= 1`` hashes independent pieces through a :class:`HashPool`;
    ``workers <= 0`` is strictly serial. Digests are bit-identical either
    way: sharding only reorders which thread hashes a piece.
    """

    name = "cpu"

    def __init__(self, workers: int = 0):
        self.pool = (
            HashPool(workers, name=f"cpu/{workers}") if workers >= 1 else None
        )

    def hash_pieces(self, data: bytes | memoryview, piece_length: int) -> np.ndarray:
        if piece_length <= 0:
            raise ValueError(f"piece_length must be positive: {piece_length}")
        start = time.perf_counter()
        view = memoryview(data)
        n = (len(view) + piece_length - 1) // piece_length
        out = np.empty((n, DIGEST_SIZE), dtype=np.uint8)

        def run(lo: int, hi: int) -> None:
            digs = [
                hashlib.sha256(
                    view[i * piece_length : (i + 1) * piece_length]
                ).digest()
                for i in range(lo, hi)
            ]
            out[lo:hi] = np.frombuffer(
                b"".join(digs), dtype=np.uint8
            ).reshape(-1, DIGEST_SIZE)

        # Only a pool of >= 2 workers can shard a blocking call; one worker
        # would move the whole pass to another thread and wait.
        if self.pool is None or self.pool.workers < 2 or n <= 1:
            if n:
                run(0, n)
        else:
            self.pool.run_sharded(n, run)
        if n:
            record_hash_metrics(
                self.name, len(view), n, time.perf_counter() - start
            )
        return out

    def hash_batch(self, pieces: list[bytes | memoryview]) -> np.ndarray:
        out = np.empty((len(pieces), DIGEST_SIZE), dtype=np.uint8)

        def run(lo: int, hi: int) -> None:
            digs = [hashlib.sha256(pieces[i]).digest() for i in range(lo, hi)]
            out[lo:hi] = np.frombuffer(
                b"".join(digs), dtype=np.uint8
            ).reshape(-1, DIGEST_SIZE)

        if self.pool is None or self.pool.workers < 2 or len(pieces) <= 1:
            if pieces:
                run(0, len(pieces))
        else:
            self.pool.run_sharded(len(pieces), run)
        return out


_REGISTRY: Dict[str, Callable[[], PieceHasher]] = {}
_INSTANCES: Dict[str, PieceHasher] = {}


def register_hasher(name: str, factory: Callable[[], PieceHasher]) -> None:
    _REGISTRY[name] = factory


def get_hasher(name: str = "cpu", workers: int = 0) -> PieceHasher:
    """Resolve a hasher by registry name (``cpu``, ``cuda``).

    Instances are cached, so the origin and agent of one process share one
    instance. ``workers`` applies only to the cpu hasher: ``workers >= 1``
    returns a pooled instance cached per worker count. The cuda hasher's
    parallelism is the batch axis, not host threads.
    """
    if name == "cpu" and workers >= 1:
        key = f"cpu/{workers}"
        if key not in _INSTANCES:
            _INSTANCES[key] = CPUPieceHasher(workers=workers)
        return _INSTANCES[key]
    if name not in _INSTANCES:
        if name not in _REGISTRY and name == "cuda":
            # Importing the plane registers its hasher; deferred so that
            # pure-host components never pay the torch import.
            import kraken_tpu_torch.ops.sha256  # noqa: F401
        try:
            factory = _REGISTRY[name]
        except KeyError:
            raise KeyError(
                f"unknown hasher {name!r}; registered: {sorted(_REGISTRY)}"
            ) from None
        _INSTANCES[name] = factory()
    return _INSTANCES[name]


register_hasher("cpu", CPUPieceHasher)
