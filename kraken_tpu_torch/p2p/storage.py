"""Torrent storage: piece-addressed views over the CAStore.

**Piece verification on write lives here** -- the agent-side hot loop the
north star routes through ``PieceHasher``: received pieces are verified by
the :class:`BatchedVerifier`, which coalesces concurrent arrivals into one
batched kernel launch. Incomplete torrents persist the same piece bitfield
sidecar as ``kraken_tpu.p2p.storage``, so a download begun by either
package resumes under the other.
"""

from __future__ import annotations

import asyncio
import logging
import os
import threading
import time
from typing import NamedTuple, Optional

from kraken_tpu_torch.core.digest import Digest
from kraken_tpu_torch.core.hasher import PieceHasher, get_hasher
from kraken_tpu_torch.core.metainfo import MetaInfo
from kraken_tpu_torch.store import CAStore, PieceStatusMetadata
from kraken_tpu_torch.utils import trace
from kraken_tpu_torch.utils.metrics import REGISTRY

_log = logging.getLogger("kraken.storage")


class PieceError(Exception):
    pass


# Set by the dispatcher (a payload for a piece already held) and by
# Torrent.write_piece (a copy verified, then found already set).
PIECE_DUPLICATES = REGISTRY.counter(  # kt-lint: disable=metric-catalog  # the port's own counter (ROADMAP §C); docs/OPERATIONS.md is the reference's catalog, which the port does not edit
    "p2p_piece_duplicates_total",
    "Piece payloads dropped as duplicates, by when: before_verify (the "
    "piece was already held) or after_verify (verified, then found set)",
)


class _Queued(NamedTuple):
    """A piece waiting in the verify queue."""

    data: bytes | memoryview
    expected: bytes
    fut: asyncio.Future
    at: float  # time.perf_counter() at enqueue
    span: Optional[trace.Span]  # the caller's span, if its trace is sampled


class BatchedVerifier:
    """Verifies received pieces against their expected digests, batching
    concurrent arrivals into one ``PieceHasher.hash_batch`` dispatch.

    Each ``verify`` parks on a future while a single flusher task drains
    the queue -- one kernel launch per drain instead of one per piece.
    With no ``hasher`` it takes the ``cuda`` hasher, which needs a card.
    The ``verify`` plane bills each piece's wait in the queue (enqueue to
    the flush) and for the pool (the flush to its hash thread's start);
    the hasher bills the flush's own stages.
    """

    def __init__(
        self,
        hasher: PieceHasher | None = None,
        max_batch: int = 1024,
        max_delay_seconds: float = 0.0,
    ):
        # max_delay 0 = one event-loop tick: every arrival scheduled this
        # tick enqueues before the flusher runs, so a burst still batches
        # while a trickle pays no fixed delay per piece.
        self.hasher = hasher or get_hasher("cuda")
        self._max_batch = max_batch
        self._max_delay = max_delay_seconds
        self._queue: list[_Queued] = []
        self._flusher: Optional[asyncio.Task] = None
        self._inflight: set[asyncio.Task] = set()  # strong refs to hash tasks
        # Waiter future -> the hash task whose thread reads its buffer.
        self._reading: dict[asyncio.Future, asyncio.Task] = {}
        # The size histogram says whether arrivals coalesce; the per-path
        # batch counter splits host SHA from device launches.
        self._h_batch_size = REGISTRY.histogram(
            "verify_batch_size",
            "Pieces coalesced into each verify flush",
            buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024),
        )
        self._c_batches = REGISTRY.counter(
            "verify_batches_total",
            "Verify flushes dispatched, by hash path (host|cuda)",
        )
        self._path_label = "host" if self.hasher.name == "cpu" else "cuda"

    async def verify(self, data: bytes | memoryview, expected: bytes) -> bool:
        loop = asyncio.get_running_loop()
        fut: asyncio.Future[bool] = loop.create_future()
        sp = trace.current()
        self._queue.append(_Queued(data, expected, fut, time.perf_counter(),
                                   sp if sp is not None and sp.sampled else None))
        if self._flusher is None or self._flusher.done():
            self._flusher = asyncio.create_task(self._flush_soon())
        if len(self._queue) >= self._max_batch:
            self._flush_now()
        try:
            return await fut
        except asyncio.CancelledError:
            # A cancelled caller frees ``data`` as soon as this returns (a
            # leech worker reuses its ring slot the moment the drop
            # arrives). While a flush's thread is still copying it into
            # staging, return only after that copy.
            reader = self._reading.get(fut)
            if reader is not None and not reader.done():
                await asyncio.wait({reader})
            raise

    async def _flush_soon(self) -> None:
        await asyncio.sleep(self._max_delay)
        self._flush_now()

    def _flush_now(self) -> None:
        batch, self._queue = self._queue, []
        if not batch:
            return
        now = time.perf_counter()
        trace.bill("queue", sum(now - q.at for q in batch), len(batch), "verify")
        for q in batch:
            if q.span is not None:
                trace.record_interval("hash_plane.verify.queue", q.span, q.at)
        REGISTRY.counter(
            "verify_pieces_total", "Pieces through batched verification"
        ).inc(len(batch))
        REGISTRY.gauge(
            "verify_batch_occupancy",
            "Batch fill of the last verify flush (batched / max_batch)",
        ).set(len(batch) / self._max_batch)
        self._h_batch_size.observe(len(batch))
        self._c_batches.inc(1, path=self._path_label)
        # The hash runs off the event loop: a full batch is hundreds of MB
        # and a blocking device round-trip. Each flush resolves only its
        # own batch's futures, so concurrent flushes need no ordering.
        t = asyncio.create_task(self._hash_off_loop(batch, now))
        self._inflight.add(t)
        t.add_done_callback(self._inflight.discard)

    async def _hash_off_loop(self, batch: list[_Queued], flushed: float) -> None:
        # Drop entries whose waiter was cancelled before touching their
        # buffers: the caller may already have released them.
        batch = [q for q in batch if not q.fut.done()]
        if not batch:
            return
        me = asyncio.current_task()
        for q in batch:
            self._reading[q.fut] = me
        try:
            await self._hash_batch(batch, flushed)
        finally:
            for q in batch:
                self._reading.pop(q.fut, None)

    def _hash_in_thread(self, pieces: list, flushed: float | None = None,
                        spans: tuple = ()):
        """The hash thread's body: bill the pieces' wait for it (from the
        flush at ``flushed``) and hash them in the ``verify`` plane."""
        if flushed is not None:
            trace.bill("pool", (time.perf_counter() - flushed) * len(pieces),
                       len(pieces), "verify")
            for sp in spans:
                trace.record_interval("hash_plane.verify.pool", sp, flushed)
        with trace.plane("verify"):
            return self.hasher.hash_batch(pieces)

    async def _hash_batch(self, batch: list[_Queued], flushed: float) -> None:
        try:
            digests = await asyncio.to_thread(
                self._hash_in_thread, [q.data for q in batch], flushed,
                tuple(q.span for q in batch if q.span is not None),
            )
        except Exception:
            # One bad entry must not fail its batch-mates: retry per item,
            # failing only what individually fails.
            for d, expected, fut, *_ in batch:
                if fut.done():
                    continue
                try:
                    got = await asyncio.to_thread(self._hash_in_thread, [d])
                    fut.set_result(bytes(got[0]) == expected)
                except Exception as e:
                    if not fut.done():
                        fut.set_exception(e)
            return
        for (d, expected, fut, *_), got in zip(batch, digests):
            if not fut.done():
                fut.set_result(bytes(got) == expected)


class _FlatIO:
    """Raw-fd IO handle for a flat-file torrent: the pread/pwrite/close
    trio :class:`Torrent` ref-counts."""

    __slots__ = ("_fd",)

    def __init__(self, fd: int):
        self._fd = fd

    def pread(self, n: int, off: int) -> bytes:
        return os.pread(self._fd, n, off)

    def pwrite(self, data, off: int) -> int:
        return os.pwrite(self._fd, data, off)

    def close(self) -> None:
        os.close(self._fd)


class Torrent:
    """Piece-addressed access to one blob in the store.

    Complete torrents (origin seeding) read straight from the committed
    blob. Incomplete torrents own a pre-allocated partial file plus the
    persisted piece bitfield; the final ``write_piece`` completes them.
    """

    BITS_FLUSH_SECONDS = 0.2

    def __init__(
        self,
        store: CAStore,
        metainfo: MetaInfo,
        verifier: BatchedVerifier,
        complete: bool = False,
        path: Optional[str] = None,
    ):
        self.store = store
        self.metainfo = metainfo
        self._verifier = verifier
        # Serve-while-ingest: a complete torrent whose bytes still live at
        # the upload spool ``path``; promote() repoints it at the cache
        # path after the commit's rename (an open fd keeps its inode).
        self.spool_backed = False
        if complete:
            if path is not None:
                self._path = path
                self.spool_backed = True
            else:
                self._path = store.cache_path(metainfo.digest)
            self._status = None  # complete: no bitfield needed
        else:
            # Incomplete data lives at the partial path until the last
            # piece lands; only then is it renamed into the cache, so
            # ``in_cache`` can never observe a half-written blob.
            self._path = store.partial_path(metainfo.digest)
            md = store.get_metadata(metainfo.digest, PieceStatusMetadata)
            self._status = md or PieceStatusMetadata(metainfo.num_pieces)
        # Serializes bitfield updates + completion check.
        self._lock = asyncio.Lock()
        self._full_bits: Optional[bytes] = None  # memoized complete bitfield
        # One long-lived fd with positional IO: piece reads and writes from
        # worker threads need no lock and share no file offset.
        self._fd: Optional[_FlatIO] = None
        self._fd_lock = threading.Lock()
        self._fd_refs = 0  # in-flight pread/pwrite count (teardown gate)
        self._fd_closed = False
        # Bitfield persistence is debounced: pieces mark it dirty and a
        # per-torrent flusher persists it at most every BITS_FLUSH_SECONDS.
        # The persisted bitfield may understate progress, never overstate
        # it (bits are set only after their piece's data write returns).
        self._bits_dirty = False
        self._bits_flusher: Optional[asyncio.Task] = None
        # Cumulative per-piece stage walls for the dispatcher's
        # torrent_summary: how long pieces spent parked on verify and on
        # the data write. Pieces pipeline, so these overlap and sum past
        # the pull's wall: stage costs, not a timeline.
        self.verify_wall = 0.0
        self.write_wall = 0.0

    # -- introspection -----------------------------------------------------

    @property
    def digest(self) -> Digest:
        return self.metainfo.digest

    @property
    def info_hash(self):
        return self.metainfo.info_hash

    @property
    def num_pieces(self) -> int:
        return self.metainfo.num_pieces

    @property
    def blob_path(self) -> str:
        """Filesystem path of the backing file (the committed cache path
        once complete)."""
        return self._path

    def complete(self) -> bool:
        return self._status is None or self._status.complete()

    def has_piece(self, i: int) -> bool:
        return self._status is None or self._status.has(i)

    def missing_pieces(self) -> list[int]:
        return [] if self._status is None else self._status.missing()

    def num_pieces_complete(self) -> int:
        return self.num_pieces if self._status is None else self._status.count()

    def bitfield(self) -> bytes:
        """The piece bitfield a handshake carries (the sidecar's layout)."""
        if self._status is None:
            # Memoized: a seeder sends it on every inbound handshake.
            if self._full_bits is None:
                full = PieceStatusMetadata(self.num_pieces)
                for i in range(self.num_pieces):
                    full.set(i)
                self._full_bits = bytes(full.bits)
            return self._full_bits
        return bytes(self._status.bits)

    # -- pieces ------------------------------------------------------------

    def _open_io(self):
        """The torrent's IO handle: a raw fd on the backing file, or --
        for a COMPLETE blob whose bytes live in the chunk tier -- a
        composed :class:`~kraken_tpu_torch.store.chunkstore.ChunkReader`.
        Both expose ``pread``; only the flat handle can ``pwrite``
        (incomplete torrents always write into a flat ``.part``)."""
        if self._status is None:
            try:
                fd = os.open(self._path, os.O_RDONLY)
            except FileNotFoundError:
                reader = self.store._chunk_reader(self.metainfo.digest)
                if reader is None:
                    raise
                return reader
            return _FlatIO(fd)
        # Incomplete torrents own the file read-write; a complete cached
        # blob is read-only. Completion does not reopen: commit is a
        # rename, so the fd keeps addressing the same inode.
        return _FlatIO(os.open(self._path, os.O_RDWR))

    def _with_fd(self, op):
        """Run ``op(io)`` (a pread/pwrite) with the handle ref-counted.

        close() only marks closed; the last in-flight op (or close() itself
        when none are) actually closes, so a worker thread inside a pwrite
        never sees its fd closed or reused under it."""
        with self._fd_lock:
            if self._fd_closed:
                raise PieceError("torrent closed")
            if self._fd is None:
                self._fd = self._open_io()
            self._fd_refs += 1
            fd = self._fd
        try:
            return op(fd)
        finally:
            with self._fd_lock:
                self._fd_refs -= 1
                if self._fd_closed and self._fd_refs == 0 and self._fd is not None:
                    self._fd.close()
                    self._fd = None

    def release_fd(self) -> None:
        """Drop the cached IO handle if no IO is in flight; the next piece
        IO reopens it. The dispatcher calls this when a torrent's last
        peer leaves, so a node seeding many blobs holds fds only for
        torrents with live conns."""
        with self._fd_lock:
            if self._fd_refs == 0 and self._fd is not None and not self._fd_closed:
                self._fd.close()
                self._fd = None

    def close(self) -> None:
        """Flush any unpersisted bitfield and retire the fd. Only
        incomplete torrents flush (a complete torrent has no sidecar)."""
        if self._bits_flusher is not None:
            self._bits_flusher.cancel()
            self._bits_flusher = None
        if self._status is not None and self._bits_dirty:
            status = self._status
            self._bits_dirty = False

            def _flush() -> None:
                try:
                    self.store.set_metadata(self.metainfo.digest, status)
                except Exception:
                    # Progress-only sidecar: a lost flush re-downloads at
                    # most the unflushed tail on resume.
                    _log.warning(
                        "final bitfield flush failed",
                        extra={"digest": self.metainfo.digest.hex},
                        exc_info=True,
                    )

            try:
                loop = asyncio.get_running_loop()
                loop.run_in_executor(None, _flush)
            except RuntimeError:
                # No loop: flush inline.
                _flush()
        with self._fd_lock:
            self._fd_closed = True
            if self._fd_refs == 0 and self._fd is not None:
                self._fd.close()
                self._fd = None

    def promote(self, path: str) -> None:
        """Repoint a spool-backed torrent at its committed path (the
        commit renamed the spool into the cache, same inode)."""
        with self._fd_lock:
            self._path = path
            self.spool_backed = False

    def read_piece(self, i: int) -> bytes:
        if not self.has_piece(i):
            raise PieceError(f"piece {i} not present")
        off = i * self.metainfo.piece_length
        ln = self.metainfo.piece_length_of(i)
        data = self._with_fd(lambda io_: io_.pread(ln, off))
        if len(data) != ln:
            raise PieceError(f"short read on piece {i}")
        return data

    async def write_piece(
        self,
        i: int,
        data: bytes | memoryview,
        remote_write=None,
    ) -> bool:
        """Verify + persist piece ``i``. Returns True when this write
        completed the torrent. Raises :class:`PieceError` on corrupt data
        (callers blacklist the sender). File IO runs off-loop.

        ``remote_write`` (leech-shard plane): an async callable taking
        the piece index that persists the already-verified bytes in the
        WORKER that received them -- the payload stays in its shared
        slot and never crosses back to this process. It replaces only
        the data write: verify, the duplicate checks, the bit mark and
        the commit stay here, so a set bit still implies bytes on disk.
        A remote write that fails (the worker died) raises, the piece
        stays unmarked, and the dispatcher requeues it."""
        if self._status is None:
            # A second copy of the final piece can arrive after completion:
            # a benign duplicate, never a peer fault.
            PIECE_DUPLICATES.inc(when="before_verify")
            return False
        if len(data) != self.metainfo.piece_length_of(i):
            raise PieceError(
                f"piece {i}: wrong length {len(data)} != "
                f"{self.metainfo.piece_length_of(i)}"
            )
        t0 = time.perf_counter()
        if not await self._verifier.verify(data, self.metainfo.piece_hash(i)):
            raise PieceError(f"piece {i}: digest mismatch")
        self.verify_wall += time.perf_counter() - t0
        if self._status is None or self._status.has(i):
            PIECE_DUPLICATES.inc(when="after_verify")
            return False  # duplicate arrival
        # The data write runs outside the lock: pieces occupy disjoint
        # offsets, so concurrent pwrites never conflict. Completion cannot
        # race this write: piece i's bit is only set below.
        t0 = time.perf_counter()
        if remote_write is not None:
            await remote_write(i)
        else:
            await asyncio.to_thread(self._write_at, i, data)
        self.write_wall += time.perf_counter() - t0
        async with self._lock:
            # Re-check under the lock: a concurrent writer of the same
            # final piece may have completed the torrent meanwhile.
            if self._status is None or self._status.has(i):
                PIECE_DUPLICATES.inc(when="after_verify")
                return False
            self._status.set(i)
            if self._status.complete():
                if self._bits_flusher is not None:
                    self._bits_flusher.cancel()
                    self._bits_flusher = None
                self._bits_dirty = False

                def _commit() -> None:
                    self.store.commit_partial_file(self.metainfo.digest)
                    self.store.delete_metadata(
                        self.metainfo.digest, PieceStatusMetadata
                    )

                await asyncio.to_thread(_commit)
                self._status = None
                self._path = self.store.cache_path(self.metainfo.digest)
                return True
            self._mark_bits_dirty()
            return False

    def _write_at(self, i: int, data: bytes) -> None:
        self._with_fd(
            lambda io_: io_.pwrite(data, i * self.metainfo.piece_length)
        )

    def _mark_bits_dirty(self) -> None:
        self._bits_dirty = True
        if self._bits_flusher is None or self._bits_flusher.done():
            self._bits_flusher = asyncio.create_task(self._flush_bits_later())

    async def _flush_bits_later(self) -> None:
        await asyncio.sleep(self.BITS_FLUSH_SECONDS)
        async with self._lock:
            if self._status is not None and self._bits_dirty:
                await asyncio.to_thread(
                    self.store.set_metadata, self.metainfo.digest, self._status
                )
                self._bits_dirty = False

    async def read_piece_async(self, i: int) -> bytes:
        """Off-loop :meth:`read_piece` for pump-context reads."""
        return await asyncio.to_thread(self.read_piece, i)

    async def flush_bits(self) -> None:
        """Persist the piece bitfield now (off-loop), ahead of the
        debounced flusher."""
        async with self._lock:
            if self._status is not None and self._bits_dirty:
                await asyncio.to_thread(
                    self.store.set_metadata, self.metainfo.digest, self._status
                )
                self._bits_dirty = False


class AgentTorrentArchive:
    """Download-side archive: creates resumable torrents from metainfo.
    With no ``verifier`` it verifies on the card (``BatchedVerifier()``,
    the ``cuda`` hasher)."""

    def __init__(self, store: CAStore, verifier: BatchedVerifier | None = None):
        self.store = store
        self.verifier = verifier or BatchedVerifier()

    def create_torrent(self, metainfo: MetaInfo) -> Torrent:
        d = metainfo.digest
        if self.store.in_cache(d):
            return Torrent(self.store, metainfo, self.verifier, complete=True)
        self.store.allocate_partial_file(d, metainfo.length)
        if self.store.get_metadata(d, PieceStatusMetadata) is None:
            self.store.set_metadata(d, PieceStatusMetadata(metainfo.num_pieces))
        return Torrent(self.store, metainfo, self.verifier, complete=False)


class OriginTorrentArchive:
    """Seed-side archive: torrents over committed CAStore blobs."""

    def __init__(self, store: CAStore, verifier: BatchedVerifier):
        self.store = store
        self.verifier = verifier

    def create_torrent(self, metainfo: MetaInfo) -> Torrent:
        if not self.store.in_cache(metainfo.digest):
            raise KeyError(str(metainfo.digest))
        return Torrent(self.store, metainfo, self.verifier, complete=True)
