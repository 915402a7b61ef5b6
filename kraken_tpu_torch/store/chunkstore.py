"""Content-addressed chunk tier: keep each chunk once, serve blobs as
manifests.

The port's copy of ``kraken_tpu.store.chunkstore``: the same chunk files,
manifests, journal lines and snapshot, so either package reads a tier the
other wrote. It adds one counter of its own, ``chunkstore_seconds_total``
(``add_blob``'s wall and the hashlib checks).

The dedup plane measures 39-78% duplicate bytes across image builds and
the delta plane (p2p/delta.py) already cashes that in on the wire -- but
the CAStore still keeps one whole flat file per blob, so N near-duplicate
builds cost N x disk at rest, and the watermark evictor throws away
exactly the cached bases the DeltaPlanner needs. This module is the
at-rest half: a blob whose chunk recipe is known is stored as a
``ChunkManifestMetadata`` sidecar (store/metadata.py) plus refcounted
chunk files keyed by the SAME ``chunk_fp`` the dedup ledger and
``ChunkRecipe`` use, so a second near-duplicate build stores only its
unique chunks.

Layout (under the owning CAStore's root):

    <root>/chunks/<fp16[:2]>/<fp16>-<size>   chunk files, sharded fanout
    <root>/chunks/refs.snap                  refcount snapshot
    <root>/chunks/refs.log                   fsync'd refcount journal

A chunk's identity is ``(fp, size)`` -- the pair the recipe diff matches
on -- and its file name carries both, so a 64-bit fp collision between
different-sized chunks cannot alias. Every chunk write verifies the
bytes against ``fp`` before the atomic rename; reads therefore trust the
file name exactly as the CAStore trusts a cache path.

Crash contract: refcounts live in memory, journaled append-only with one
fsync per blob-level mutation (add or release), snapshot-compacted when
the log grows. The journal is an optimization, never the truth -- the
manifests are: fsck (store/recovery.py) rebuilds refcounts from the
manifest set and reconciles orphan chunks, so any torn journal state
heals at the next boot.

Deleting a blob decrements refs; zero-ref chunks are REAPED later by a
budgeted GC (:class:`ChunkGC`, the scrub TokenBucket pattern), so a
delete burst never turns into an unlink storm on the serving path.
Corrupt chunks are quarantined -- moved beside the store's corrupt-blob
evidence, never deleted -- and heal by blob re-fetch: the healed blob
re-chunks and rewrites the verified bytes under the same name.

Gated on YAML ``chunkstore.enabled`` (shipped OFF, SIGHUP live-reload;
per-node opt-in, agents first). Knob table and rollout runbook:
docs/OPERATIONS.md "Chunk store".
"""

from __future__ import annotations

import asyncio
import contextlib
import dataclasses
import hashlib
import io
import logging
import os
import threading
import time
from typing import Iterable, Optional

from kraken_tpu_torch.core.metainfo import CHUNK_FP_BYTES
from kraken_tpu_torch.utils.metrics import REGISTRY, FailureMeter

_log = logging.getLogger("kraken.chunkstore")

_SNAP = "refs.snap"
_LOG = "refs.log"
# Compact when the journal carries this many times more entries than
# there are live refs -- bounds replay time without a timer.
_COMPACT_FACTOR = 4
_COMPACT_MIN = 4096


@dataclasses.dataclass
class ChunkStoreConfig:
    """The YAML ``chunkstore:`` section (agent + origin; SIGHUP
    live-reloads). Knob table in docs/OPERATIONS.md "Chunk store"."""

    # Master switch. Shipped OFF: converting blobs to manifests is a
    # rollout decision (agents first, origins after soak -- runbook in
    # OPERATIONS.md), never a config-refresh surprise. Disabling stops
    # NEW conversions only: blobs already stored as manifests stay
    # readable (the tier object remains attached while manifests exist).
    enabled: bool = False
    # Blobs below this stay flat: per-chunk file overhead and manifest
    # bookkeeping cost more than small blobs can dedup.
    min_blob_bytes: int = 1 << 20
    # Budgeted zero-ref reaper (ChunkGC): sleep between passes, and the
    # unlink byte-rate cap (token bucket -- the scrub pattern). 0 bps =
    # unthrottled.
    gc_interval_seconds: float = 300.0
    gc_bytes_per_second: float = 32 * 1024 * 1024

    @classmethod
    def from_dict(cls, doc: dict | None) -> "ChunkStoreConfig":
        doc = dict(doc or {})
        allowed = {f.name for f in dataclasses.fields(cls)}
        unknown = set(doc) - allowed
        if unknown:
            raise ValueError(
                f"unknown chunkstore config keys: {sorted(unknown)}"
            )
        return cls(**doc)


class ChunkCorruptError(Exception):
    """Bytes offered for (or read as) a chunk do not hash to its fp."""


def _fp_of(data) -> int:
    return int.from_bytes(
        hashlib.sha256(data).digest()[:CHUNK_FP_BYTES], "big"
    )


class ChunkStore:
    """Refcounted content-addressed chunk files under one directory.

    Thread-safe: blob-level mutations (add/release) serialize under one
    lock; chunk reads are lock-free (files are immutable once renamed
    into place, exactly the CAS contract of the cache tree above).
    """

    def __init__(
        self,
        root: str,
        config: ChunkStoreConfig | None = None,
        quarantine_dir: str | None = None,
        durability: str = "rename",
    ):
        self.root = root
        self.config = config or ChunkStoreConfig()
        self.durability = durability
        # Corrupt chunks are MOVED here (never deleted), beside the
        # store's corrupt-blob evidence, prefixed so operators and
        # list_quarantined can tell them from 64-hex blob captures.
        self.quarantine_dir = quarantine_dir or os.path.join(
            os.path.dirname(root), "quarantine"
        )
        os.makedirs(self.root, exist_ok=True)
        self._lock = threading.Lock()
        # (fp, size) -> live manifest references. Chunks at 0 keep their
        # file until the GC reaps it; entries leave the dict at reap.
        self._refs: dict[tuple[int, int], int] = {}
        # Chunks whose FILE moved to quarantine (refs stay -- manifests
        # still reference them until their blobs quarantine/heal). Their
        # bytes are excluded from stored accounting: the quarantine walk
        # in CAStore.disk_usage_bytes already counts the moved file, and
        # double-counting would push watermark math over the mark early.
        # A heal's rewrite (add_blob -> _write_chunk) clears the mark.
        self._quarantined: set[tuple[int, int]] = set()
        self._log_entries = 0
        self._logical_bytes = 0  # sum(size * refcount)
        self._load()
        self._g_stored = REGISTRY.gauge(
            "chunkstore_stored_bytes",
            "Bytes of unique chunk files the chunk tier holds (incl. "
            "zero-ref chunks awaiting GC)",
        )
        self._g_logical = REGISTRY.gauge(
            "chunkstore_logical_bytes",
            "Logical bytes of all manifest-backed blobs (sum of chunk "
            "size x refcount)",
        )
        self._g_ratio = REGISTRY.gauge(
            "chunkstore_dedup_ratio",
            "1 - stored/logical over the chunk tier (0 = no dedup win)",
        )
        self._g_chunks = REGISTRY.gauge(
            "chunkstore_chunks",
            "Unique chunks the tier currently tracks (any refcount)",
        )
        self._c_gc = REGISTRY.counter(
            "chunkstore_gc_reaped_bytes_total",
            "Bytes of zero-ref chunk files reaped by the budgeted GC",
        )
        self._c_rebuilds = REGISTRY.counter(
            "chunkstore_ref_rebuilds_total",
            "Refcount rebuilds from manifests that found a mismatch "
            "(fsck; a torn journal healed)",
        )
        self._c_corrupt = REGISTRY.counter(
            "chunkstore_corrupt_chunks_total",
            "Chunk files whose bytes no longer hash to their fp, moved "
            "to quarantine (healed by blob re-fetch, never deleted)",
        )
        # The port's own split of the tier's write and check costs (the
        # reference keeps none): add_blob's wall, and the hashlib fp
        # checks inside it and in verify_chunk.
        self._c_seconds = REGISTRY.counter(
            "chunkstore_seconds_total",
            "Seconds in the chunk tier by stage: add (add_blob's wall) "
            "and check (hashlib fp checks before a rename and in "
            "verify_chunk)",
        )
        self._failures = FailureMeter(
            "chunkstore_failures_total",
            "chunk-tier operations that raised (journal IO, GC unlink)",
            _log,
        )
        self._publish()

    # -- paths --------------------------------------------------------------

    @staticmethod
    def _key_name(fp: int, size: int) -> str:
        return f"{fp:016x}-{size}"

    def chunk_path(self, fp: int, size: int) -> str:
        name = self._key_name(fp, size)
        return os.path.join(self.root, name[:2], name)

    def quarantine_chunk_path(self, fp: int, size: int) -> str:
        return os.path.join(
            self.quarantine_dir, f"chunk-{self._key_name(fp, size)}"
        )

    # -- refcount journal ---------------------------------------------------

    def _load(self) -> None:
        """Replay snapshot + journal. Torn trailing lines (crash mid-
        append) are skipped -- fsck's rebuild-from-manifests is the
        authoritative reconciliation for anything the journal lost."""
        refs: dict[tuple[int, int], int] = {}

        def apply(line: str) -> None:
            parts = line.split()
            if len(parts) < 3:
                return
            op = parts[0]
            try:
                fp, size = int(parts[1], 16), int(parts[2])
                count = int(parts[3]) if op == "=" else 0
            except (ValueError, IndexError):
                return
            key = (fp, size)
            if op == "=":
                if count > 0:
                    refs[key] = count
                else:
                    refs[key] = 0
            elif op == "+":
                refs[key] = refs.get(key, 0) + 1
            elif op == "-":
                n = refs.get(key, 0) - 1
                if n <= 0:
                    refs[key] = 0
                else:
                    refs[key] = n

        for name in (_SNAP, _LOG):
            try:
                with open(os.path.join(self.root, name)) as f:
                    for line in f:
                        if name == _LOG:
                            self._log_entries += 1
                        if line.endswith("\n"):
                            apply(line)
            except FileNotFoundError:
                continue
            except OSError as e:
                self._failures.record(f"journal load {name}", e)
        # GC reaps are not journaled (the refs entry just leaves memory;
        # compaction persists the truth later): a zero-ref entry whose
        # chunk file is already gone was reaped before the crash/restart
        # -- drop it so stored_bytes starts honest.
        for key in [k for k, c in refs.items() if c == 0]:
            if not os.path.exists(self.chunk_path(*key)):
                del refs[key]
        self._refs = refs
        self._logical_bytes = sum(
            size * count for (_fp, size), count in refs.items()
        )

    def _append_journal(self, lines: list[str]) -> None:
        """One append + one fsync per blob-level mutation -- the chunk
        writes themselves already renamed atomically, so this is the
        only durability point a crash can tear (and fsck heals it)."""
        path = os.path.join(self.root, _LOG)
        try:
            fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_APPEND)
            try:
                os.write(fd, ("".join(lines)).encode())
                os.fsync(fd)
            finally:
                os.close(fd)
        except OSError as e:
            # A journal that cannot append must not fail the blob op:
            # the manifests stay authoritative and fsck rebuilds.
            self._failures.record("journal append", e)
            return
        self._log_entries += len(lines)
        if self._log_entries >= max(
            _COMPACT_MIN, _COMPACT_FACTOR * max(len(self._refs), 1)
        ):
            self._compact_locked()

    def _compact_locked(self) -> None:
        """Rewrite the snapshot from the in-memory refs and truncate the
        journal (caller holds the lock). Atomic: tmp + rename, journal
        truncated only after the snapshot landed."""
        snap = os.path.join(self.root, _SNAP)
        tmp = f"{snap}.tmp{os.getpid()}"
        try:
            with open(tmp, "w") as f:
                for (fp, size), count in self._refs.items():
                    f.write(f"= {fp:016x} {size} {count}\n")
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, snap)
            with open(os.path.join(self.root, _LOG), "w") as f:
                f.flush()
                os.fsync(f.fileno())
            self._log_entries = 0
        except OSError as e:
            self._failures.record("journal compact", e)
            with contextlib.suppress(OSError):
                os.unlink(tmp)

    def _publish(self) -> None:
        stored = sum(
            size for (fp, size) in self._refs
            if (fp, size) not in self._quarantined
        )
        self._g_stored.set(stored)
        self._g_logical.set(self._logical_bytes)
        self._g_chunks.set(len(self._refs))
        self._g_ratio.set(
            1.0 - stored / self._logical_bytes if self._logical_bytes else 0.0
        )

    # -- introspection ------------------------------------------------------

    def refcount(self, fp: int, size: int) -> int:
        with self._lock:
            return self._refs.get((fp, size), 0)

    def has_chunk(self, fp: int, size: int) -> bool:
        return os.path.exists(self.chunk_path(fp, size))

    def stored_bytes(self) -> int:
        """Disk the chunk files occupy (tracked, not walked: one entry
        per unique chunk incl. zero-ref awaiting GC; chunks whose file
        moved to quarantine are excluded -- the quarantine walk counts
        them). Journal/snapshot overhead is excluded -- bounded by
        compaction and noise next to the chunks.
        ``CAStore.disk_usage_bytes`` adds this so watermark math sees
        the tier (a tier the evictor can't see can fill the volume
        behind its back -- the quarantine/ lesson of PR 3)."""
        with self._lock:
            return sum(
                size for (fp, size) in self._refs
                if (fp, size) not in self._quarantined
            )

    def logical_bytes(self) -> int:
        with self._lock:
            return self._logical_bytes

    def unique_bytes(self, fps, sizes) -> int:
        """Bytes only THIS manifest holds references to -- what evicting
        the blob would actually free once GC runs. The watermark
        evictor's chunk-aware size: a delta base sharing most chunks
        with live blobs frees almost nothing, so the evictor can afford
        to keep it."""
        with self._lock:
            seen: set[tuple[int, int]] = set()
            total = 0
            for fp, size in zip(fps, sizes):
                key = (int(fp), int(size))
                if key in seen:
                    continue
                seen.add(key)
                if self._refs.get(key, 0) <= 1:
                    total += size
            return total

    def zero_ref_chunks(self) -> list[tuple[int, int]]:
        with self._lock:
            return [k for k, c in self._refs.items() if c == 0]

    def known_chunks(self) -> set[tuple[int, int]]:
        """Every (fp, size) the journal currently tracks, any refcount
        -- fsck's baseline for telling a crash-orphaned chunk file from
        a normal zero-ref chunk awaiting the budgeted GC."""
        with self._lock:
            return set(self._refs)

    # -- blob-level mutations ------------------------------------------------

    def add_blob(self, fps, sizes, read_chunk) -> tuple[int, int]:
        """Admit one manifest's chunks: chunks already stored gain a
        reference; absent ones are written from ``read_chunk(index,
        offset, size) -> bytes`` (verified against their fp BEFORE the
        atomic rename -- a wrong byte can never enter the tier under a
        chunk name). Returns ``(new_bytes, dup_bytes)``. Raises
        :class:`ChunkCorruptError` (after rolling back this call's refs)
        when the provided bytes don't match a fp -- the caller keeps its
        flat file and the tier stays consistent.

        Two phases so a 10 GiB conversion never stalls the store: the
        refcount bump + journal append run under the lock (a ref > 0
        shields every chunk from the GC for the rest of the call); the
        chunk file IO runs OUTSIDE it. Two conversions racing on the
        same missing chunk both write tmp+rename of identical verified
        bytes -- benign."""
        t_add = time.perf_counter()
        check_s = 0.0
        fps = [int(fp) for fp in fps]
        sizes = [int(s) for s in sizes]
        new_bytes = dup_bytes = 0
        lines: list[str] = []
        added: list[tuple[int, int]] = []
        to_write: list[tuple[int, int, int, int]] = []  # (i, off, fp, size)
        off = 0
        with self._lock:
            for i, (fp, size) in enumerate(zip(fps, sizes)):
                key = (fp, size)
                count = self._refs.get(key, 0)
                if count == 0 and not os.path.exists(
                    self.chunk_path(fp, size)
                ):
                    to_write.append((i, off, fp, size))
                    new_bytes += size
                elif count > 0:
                    # Duplicate only when another manifest already
                    # holds it; re-referencing a zero-ref (GC-pending)
                    # chunk revives the stored file.
                    dup_bytes += size
                else:
                    new_bytes += size
                self._refs[key] = count + 1
                self._logical_bytes += size
                added.append(key)
                lines.append(f"+ {fp:016x} {size}\n")
                off += size
            self._append_journal(lines)
            self._publish()
        try:
            for i, c_off, fp, size in to_write:
                data = read_chunk(i, c_off, size)
                t_check = time.perf_counter()
                ok = len(data) == size and _fp_of(data) == fp
                check_s += time.perf_counter() - t_check
                if not ok:
                    raise ChunkCorruptError(
                        f"chunk {fp:016x}-{size}: bytes do not hash to "
                        "the manifest fp"
                    )
                self._write_chunk(fp, size, data)
        except Exception:
            with self._lock:
                undo: list[str] = []
                for key in added:
                    n = self._refs.get(key, 0) - 1
                    self._refs[key] = max(n, 0)
                    self._logical_bytes -= key[1]
                    undo.append(f"- {key[0]:016x} {key[1]}\n")
                # Compensate the journal so a replay lands on the same
                # state (any chunk files already written sit at zero-ref
                # and reap normally).
                self._append_journal(undo)
                self._publish()
            raise
        finally:
            self._c_seconds.inc(check_s, stage="check")
            self._c_seconds.inc(time.perf_counter() - t_add, stage="add")
        return new_bytes, dup_bytes

    def _write_chunk(self, fp: int, size: int, data) -> None:
        dst = self.chunk_path(fp, size)
        os.makedirs(os.path.dirname(dst), exist_ok=True)
        tmp = f"{dst}.tmp{os.getpid()}.{threading.get_ident()}"
        with open(tmp, "wb") as f:
            f.write(data)
            if self.durability == "fsync":
                f.flush()
                os.fsync(f.fileno())
        os.replace(tmp, dst)
        with self._lock:
            # A heal's verified rewrite revives a quarantined chunk:
            # its bytes count as stored again.
            if (fp, size) in self._quarantined:
                self._quarantined.discard((fp, size))
                self._publish()

    def release_blob(self, fps, sizes) -> None:
        """Drop one manifest's references. Zero-ref chunk files stay on
        disk until the budgeted GC reaps them (an eviction burst must
        not become an unlink storm on the serving path)."""
        lines: list[str] = []
        with self._lock:
            for fp, size in zip(fps, sizes):
                key = (int(fp), int(size))
                count = self._refs.get(key)
                if count is None:
                    continue  # fsck will reconcile (torn journal)
                self._refs[key] = max(count - 1, 0)
                self._logical_bytes -= int(size)
                lines.append(f"- {int(fp):016x} {int(size)}\n")
            if self._logical_bytes < 0:
                self._logical_bytes = 0
            if lines:
                self._append_journal(lines)
            self._publish()

    # -- reads --------------------------------------------------------------

    def pread_chunk(self, fp: int, size: int, off: int, n: int) -> bytes:
        fd = os.open(self.chunk_path(fp, size), os.O_RDONLY)
        try:
            return os.pread(fd, n, off)
        finally:
            os.close(fd)

    def verify_chunk(self, fp: int, size: int) -> bool:
        """True iff the stored chunk file hashes back to ``fp``. Missing
        or unreadable (EIO) both read as 'not healthy' -- the scrub/fsck
        contract the blob tier uses."""
        try:
            with open(self.chunk_path(fp, size), "rb") as f:
                data = f.read()
        except OSError:
            return False
        t_check = time.perf_counter()
        ok = len(data) == size and _fp_of(data) == fp
        self._c_seconds.inc(time.perf_counter() - t_check, stage="check")
        return ok

    def quarantine_chunk(self, fp: int, size: int) -> Optional[str]:
        """Move a corrupt chunk file aside -- NEVER deletion: the blob
        heal plane re-fetches the whole blob, re-chunks, and rewrites
        the verified bytes under this same name. Returns the quarantine
        path, or None when the file already raced away."""
        os.makedirs(self.quarantine_dir, exist_ok=True)
        dst = self.quarantine_chunk_path(fp, size)
        try:
            os.replace(self.chunk_path(fp, size), dst)
        except FileNotFoundError:
            return None
        with self._lock:
            self._quarantined.add((fp, size))
            self._publish()
        self._c_corrupt.inc()
        _log.error(
            "corrupt chunk quarantined",
            extra={"chunk": self._key_name(fp, size), "quarantine": dst},
        )
        return dst

    # -- GC + fsck support ---------------------------------------------------

    def gc_reap(self, max_bytes: int | None = None) -> int:
        """Unlink zero-ref chunk files (up to ``max_bytes``; None = all).
        Returns bytes reaped. Sync -- callers budget it (ChunkGC's token
        bucket, or the watermark sweep under disk pressure)."""
        reaped = 0
        for fp, size in self.zero_ref_chunks():
            if max_bytes is not None and reaped + size > max_bytes and reaped:
                break
            reaped += self._reap_locked(fp, size)
        if reaped:
            self._c_gc.inc(reaped)
            with self._lock:
                self._publish()
        return reaped

    def _reap_locked(self, fp: int, size: int) -> int:
        """Refcount re-check AND unlink under ONE lock hold: a
        concurrent add_blob re-referencing a zero-ref chunk (file
        exists, so it does not rewrite) takes the same lock -- the reap
        either runs before it (add_blob then finds the file gone and
        rewrites) or never runs. A check-then-unlink outside the lock
        could delete a chunk a fresh manifest just adopted."""
        with self._lock:
            if self._refs.get((fp, size)) != 0:
                return 0
            try:
                os.unlink(self.chunk_path(fp, size))
            except FileNotFoundError:
                pass
            except OSError as e:
                self._failures.record(f"gc unlink {fp:016x}-{size}", e)
                return 0
            del self._refs[(fp, size)]
            self._quarantined.discard((fp, size))
        return size

    def gc_reap_one(self, fp: int, size: int) -> int:
        """Reap exactly one zero-ref chunk (the ChunkGC's budgeted unit).
        Returns the bytes freed (0 when re-referenced or unlink failed)."""
        n = self._reap_locked(fp, size)
        if n:
            self._c_gc.inc(n)
            with self._lock:
                self._publish()
        return n

    def rebuild_refs(
        self, manifests: Iterable[tuple[Iterable[int], Iterable[int]]]
    ) -> int:
        """Recompute refcounts from the authoritative manifest set (fsck:
        a torn journal, a crash between chunk rename and journal fsync).
        Returns the number of (fp, size) entries whose count changed.
        Chunk files on disk with no manifest reference are kept as
        zero-ref entries -- the GC's job, counted by the caller as
        orphan chunks."""
        truth: dict[tuple[int, int], int] = {}
        logical = 0
        for fps, sizes in manifests:
            for fp, size in zip(fps, sizes):
                key = (int(fp), int(size))
                truth[key] = truth.get(key, 0) + 1
                logical += int(size)
        # Chunk files present on disk but unreferenced: track at 0 so
        # gc_reap sees them.
        for name2 in self._walk_chunk_names():
            key = self._parse_key(name2)
            if key is not None and key not in truth:
                truth[key] = 0
        with self._lock:
            # Presence matters, not just the count: a disk-walk orphan
            # enters truth at 0 while the journal never saw it -- that
            # IS a mismatch (the whole point of the rebuild).
            changed = sum(
                1
                for key in set(truth) | set(self._refs)
                if truth.get(key) != self._refs.get(key)
            )
            if changed:
                self._refs = truth
                self._logical_bytes = logical
                self._compact_locked()
                self._c_rebuilds.inc()
            self._publish()
        return changed

    def _walk_chunk_names(self) -> list[str]:
        out = []
        for dirpath, _dirnames, filenames in os.walk(self.root):
            for name in filenames:
                if name in (_SNAP, _LOG) or ".tmp" in name:
                    continue
                out.append(name)
        return out

    @staticmethod
    def _parse_key(name: str) -> tuple[int, int] | None:
        parts = name.split("-")
        if len(parts) != 2 or len(parts[0]) != 16:
            return None
        try:
            return int(parts[0], 16), int(parts[1])
        except ValueError:
            return None

    def sweep_tmp(self) -> int:
        """Remove torn chunk-write staging files (crash between write
        and rename). fsck-only: runs on a quiescent store."""
        swept = 0
        for dirpath, _dirnames, filenames in os.walk(self.root):
            for name in filenames:
                if ".tmp" in name:
                    with contextlib.suppress(OSError):
                        os.unlink(os.path.join(dirpath, name))
                        swept += 1
        return swept


class ChunkReader:
    """Composed positional reads over one manifest's chunks.

    ``pread(n, off)`` crosses chunk boundaries transparently; per-chunk
    fds open lazily and a small LRU keeps the hot ones (a piece read
    touches a handful of adjacent chunks). Thread-safe for concurrent
    preads -- positional IO shares no file offset, and the fd cache
    mutates under a lock. A missing/quarantined chunk file surfaces as
    ``OSError`` -- callers treat it exactly like a failed flat read
    (at-rest damage: scrub quarantines the blob, heal re-fetches)."""

    _MAX_FDS = 8

    def __init__(self, store: ChunkStore, fps, sizes):
        self._store = store
        self._fps = [int(fp) for fp in fps]
        self._sizes = [int(s) for s in sizes]
        self._offs: list[int] = []
        off = 0
        for s in self._sizes:
            self._offs.append(off)
            off += s
        self.length = off
        self._fds: dict[int, int] = {}  # chunk index -> fd (LRU by insert)
        # fd -> in-flight pread count. Concurrent preads share this
        # reader (Torrent piece serves fan out via asyncio.to_thread):
        # an LRU eviction or close() must NOT close an fd another
        # thread already holds -- fd-number reuse would silently read a
        # different file. Doomed fds (evicted/closed while in use) are
        # closed by their LAST in-flight user.
        self._users: dict[int, int] = {}
        self._doomed: set[int] = set()
        self._lock = threading.Lock()
        self._closed = False

    def _chunk_at(self, off: int) -> int:
        """Index of the chunk containing byte ``off`` (bisect)."""
        lo, hi = 0, len(self._offs) - 1
        while lo < hi:
            mid = (lo + hi + 1) // 2
            if self._offs[mid] <= off:
                lo = mid
            else:
                hi = mid - 1
        return lo

    def _acquire_fd(self, i: int) -> int:
        with self._lock:
            if self._closed:
                raise OSError("chunk reader closed")
            fd = self._fds.pop(i, None)
            if fd is None:
                fd = os.open(
                    self._store.chunk_path(self._fps[i], self._sizes[i]),
                    os.O_RDONLY,
                )
                while len(self._fds) >= self._MAX_FDS:
                    _old_i, old_fd = next(iter(self._fds.items()))
                    del self._fds[_old_i]
                    if self._users.get(old_fd, 0) > 0:
                        self._doomed.add(old_fd)  # last user closes it
                    else:
                        os.close(old_fd)
            self._fds[i] = fd  # re-insert = most recent
            self._users[fd] = self._users.get(fd, 0) + 1
            return fd

    def _release_fd(self, fd: int) -> None:
        with self._lock:
            n = self._users.get(fd, 1) - 1
            if n > 0:
                self._users[fd] = n
                return
            self._users.pop(fd, None)
            if fd in self._doomed:
                self._doomed.discard(fd)
                with contextlib.suppress(OSError):
                    os.close(fd)

    def _pread_chunk(self, i: int, n: int, off: int) -> bytes:
        fd = self._acquire_fd(i)
        try:
            return os.pread(fd, n, off)
        finally:
            self._release_fd(fd)

    def pread(self, n: int, off: int) -> bytes:
        if off >= self.length or n <= 0:
            return b""
        n = min(n, self.length - off)
        parts: list[bytes] = []
        i = self._chunk_at(off)
        remaining = n
        while remaining > 0 and i < len(self._fps):
            c_off = off - self._offs[i]
            take = min(remaining, self._sizes[i] - c_off)
            data = self._pread_chunk(i, take, c_off)
            if len(data) != take:
                raise OSError(
                    f"short chunk read: chunk {i} wanted {take} got "
                    f"{len(data)}"
                )
            parts.append(data)
            off += take
            remaining -= take
            i += 1
        return b"".join(parts)

    def fileno(self) -> int:
        raise io.UnsupportedOperation("chunk-backed blob has no single fd")

    def close(self) -> None:
        with self._lock:
            self._closed = True
            fds, self._fds = list(self._fds.values()), {}
            idle = [fd for fd in fds if self._users.get(fd, 0) == 0]
            self._doomed.update(
                fd for fd in fds if self._users.get(fd, 0) > 0
            )
        for fd in idle:
            with contextlib.suppress(OSError):
                os.close(fd)


class FlatReader:
    """The flat-file twin of :class:`ChunkReader`: one fd, positional
    reads -- so every consumer of ``CAStore.open_cache_reader`` (piece
    serves, delta base copies) runs one code path over both storage
    representations."""

    def __init__(self, fd: int, length: int):
        self._fd = fd
        self.length = length

    def pread(self, n: int, off: int) -> bytes:
        return os.pread(self._fd, n, off)

    def fileno(self) -> int:
        return self._fd

    def close(self) -> None:
        with contextlib.suppress(OSError):
            os.close(self._fd)


class ChunkBackedIO(io.RawIOBase):
    """File-like view over a :class:`ChunkReader` so sequential
    consumers (scrub re-hash, Digest.from_reader, metainfo generation,
    backend writeback streaming) need no chunk awareness."""

    def __init__(self, reader: ChunkReader):
        self._reader = reader
        self._pos = 0

    def readable(self) -> bool:
        return True

    def seekable(self) -> bool:
        return True

    def seek(self, pos: int, whence: int = os.SEEK_SET) -> int:
        if whence == os.SEEK_SET:
            self._pos = pos
        elif whence == os.SEEK_CUR:
            self._pos += pos
        elif whence == os.SEEK_END:
            self._pos = self._reader.length + pos
        else:
            raise ValueError(f"bad whence: {whence}")
        if self._pos < 0:
            raise ValueError("negative seek position")
        return self._pos

    def tell(self) -> int:
        return self._pos

    def readinto(self, b) -> int:
        data = self._reader.pread(len(b), self._pos)
        b[: len(data)] = data
        self._pos += len(data)
        return len(data)

    def close(self) -> None:
        if not self.closed:
            self._reader.close()
        super().close()


class ChunkGC:
    """Budgeted zero-ref reaper: the scrub TokenBucket pattern applied
    to unlinks. Assembly starts one per node with an attached tier;
    watermark pressure bypasses it (store/cleanup.py reaps inline when
    the volume is over the high watermark -- ENOSPC beats politeness)."""

    def __init__(self, store: ChunkStore):
        self.store = store
        self._task: Optional[asyncio.Task] = None
        self._failures = FailureMeter(
            "chunkstore_gc_failures_total",
            "Chunk-GC cycles that raised (retried next interval)",
            _log,
        )

    async def run_cycle(self) -> int:
        from kraken_tpu_torch.utils.bandwidth import TokenBucket

        cfg = self.store.config
        bps = cfg.gc_bytes_per_second
        if bps <= 0:
            return await asyncio.to_thread(self.store.gc_reap)
        bucket = TokenBucket(bps, capacity=max(bps, 64 * 1024 * 1024.0))
        reaped = 0
        for fp, size in self.store.zero_ref_chunks():
            await bucket.acquire(size)
            reaped += await asyncio.to_thread(
                self.store.gc_reap_one, fp, size
            )
        return reaped

    def start(self) -> None:
        self._task = asyncio.create_task(self._loop())

    async def _loop(self) -> None:
        while True:
            await asyncio.sleep(self.store.config.gc_interval_seconds)
            try:
                n = await self.run_cycle()
                if n:
                    _log.info(
                        "chunk gc reaped", extra={"bytes": n,
                                                  "root": self.store.root},
                    )
            except Exception as e:
                self._failures.record("chunk gc cycle", e)

    def stop(self) -> None:
        if self._task:
            self._task.cancel()
