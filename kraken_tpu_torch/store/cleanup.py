"""Background cache eviction: idle-TTL plus disk-utilization watermarks.

The port's copy of ``kraken_tpu.store.cleanup``. Services call
:meth:`CleanupManager.run_once` from a periodic asyncio task; the logic
itself is synchronous and testable without a loop.

Policy, in order:
1. evict blobs idle past ``tti_seconds`` (last access from TTIMetadata,
   falling back to file mtime);
2. if the store still exceeds ``high_watermark_bytes``, evict
   least-recently-accessed blobs until under ``low_watermark_bytes``.
``persist``-marked blobs (pending writeback) are never evicted.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import os
import time

from kraken_tpu_torch.core.digest import Digest
from kraken_tpu_torch.store.castore import CAStore
from kraken_tpu_torch.store.metadata import PersistMetadata, TTIMetadata
from kraken_tpu_torch.utils.metrics import FailureMeter

_log = logging.getLogger("kraken.cleanup")


@dataclasses.dataclass
class CleanupConfig:
    tti_seconds: float = 6 * 3600
    high_watermark_bytes: int = 0  # 0 = no size pressure eviction
    low_watermark_bytes: int = 0
    interval_seconds: float = 300.0
    # Abandoned upload spool files (client started a chunked upload and
    # died before commit; commit/abort remove the file themselves) age
    # out after this long without a write. 0 disables.
    upload_ttl_seconds: float = 6 * 3600


class CleanupManager:
    def __init__(
        self,
        store: CAStore,
        config: CleanupConfig | None = None,
        on_evict=None,
        after_evict=None,
    ):
        self.store = store
        self.config = config or CleanupConfig()
        # Called with the Digest BEFORE deletion (sidecars still readable):
        # e.g. DedupIndex.remove_sync, so eviction doesn't leave ghost
        # entries in the similarity index. Failures don't block eviction.
        self.on_evict = on_evict
        # Called AFTER deletion: e.g. scheduler unseed -- it must run once
        # the bytes are gone, or a concurrent inbound handshake could
        # resurrect the torrent control while the blob still exists.
        self.after_evict = after_evict
        # Access times are recorded in memory on every read (free for the
        # request path) and flushed to TTIMetadata sidecars by the sweep;
        # the sweep always consults the in-memory map too, so a hot blob is
        # never evicted on a stale persisted timestamp. Restart loses at
        # most one sweep interval of recency.
        self._touched: dict[str, float] = {}
        self._flushed: dict[str, float] = {}
        # Evict callbacks (dedup-index removal, scheduler unseed) must not
        # block eviction, but a callback that dies every sweep must show
        # on /metrics rather than rot silently.
        self._evict_failures = FailureMeter(
            "store_cleanup_evict_callback_failures_total",
            "cleanup evict-callback failures (on_evict/after_evict)",
            _log,
        )

    def _evict(self, d: Digest) -> None:
        if self.on_evict is not None:
            try:
                self.on_evict(d)
            except Exception as e:
                self._evict_failures.record(f"on_evict {d.hex[:8]}", e)
        self._touched.pop(d.hex, None)
        self._flushed.pop(d.hex, None)
        self.store.delete_cache_file(d)
        if self.after_evict is not None:
            try:
                self.after_evict(d)
            except Exception as e:
                self._evict_failures.record(f"after_evict {d.hex[:8]}", e)

    def touch(self, d: Digest, now: float | None = None) -> None:
        """Record an access (callers: every blob read path). Memory-only --
        no disk write on the request path; :meth:`run_once` persists."""
        self._touched[d.hex] = time.time() if now is None else now

    def _flush_touches(self) -> None:
        """Persist in-memory access times that moved since the last sweep;
        entries for blobs deleted outside eviction (DELETE endpoint) are
        pruned -- writing their sidecar would orphan a ._md_tti file."""
        for hex_, t in list(self._touched.items()):
            d = Digest.from_hex(hex_)
            if not self.store.in_cache(d):
                self._touched.pop(hex_, None)
                self._flushed.pop(hex_, None)
                continue
            if t > self._flushed.get(hex_, 0.0):
                try:
                    self.store.set_metadata(d, TTIMetadata(t))
                    self._flushed[hex_] = t
                except OSError:
                    pass  # blob raced away; eviction handles the rest

    def _last_access(self, d: Digest) -> float:
        persisted = 0.0
        md = self.store.get_metadata(d, TTIMetadata)
        if md is not None:
            persisted = md.last_access
        else:
            try:
                persisted = os.path.getmtime(self.store.cache_path(d))
            except FileNotFoundError:
                # Chunk-backed blob: no flat data file -- age from the
                # manifest sidecar instead (written at conversion).
                try:
                    persisted = os.path.getmtime(
                        self.store._manifest_path(d)
                    )
                except (OSError, AttributeError):
                    pass
        return max(persisted, self._touched.get(d.hex, 0.0))

    def _evictable(self, d: Digest) -> bool:
        md = self.store.get_metadata(d, PersistMetadata)
        return md is None or not md.persist

    def _sweep_abandoned_uploads(self) -> None:
        """Unlink upload-spool files idle past upload_ttl_seconds.

        A live chunked upload keeps a fresh mtime with every PATCH;
        commit renames the file out and abort unlinks it -- only uploads
        whose client died uncommitted age to the TTL. Without this, the
        origin's ``upload/`` dir grows forever (the proxy's upload
        sessions have their own TTL purge; the origin's spool had none).

        WALL CLOCK ONLY, never ``run_once(now=...)``'s injected clock:
        that parameter exists for simulated TTI sweeps, but spool ages
        come from real filesystem mtimes -- a future-dated simulated now
        would unlink LIVE spool files mid-upload."""
        ttl = self.config.upload_ttl_seconds
        if ttl <= 0:
            return
        try:
            names = os.listdir(self.store.upload_dir)
        except FileNotFoundError:
            return
        now = time.time()
        present = set(names)
        for name in names:
            path = os.path.join(self.store.upload_dir, name)
            suffix = self.store.SESSION_SUFFIX
            if suffix in name:
                # Session journals sweep WITH their spool (below), never
                # alone -- unlinking a live journal would silently strip
                # a resumable upload down to size-based resume. Orphan
                # journals (spool committed/aborted under a crash) and
                # torn ``.tmp`` writes are debris.
                base = name.split(suffix, 1)[0]
                if base not in present or not name.endswith(suffix):
                    with contextlib.suppress(OSError):
                        os.unlink(path)
                continue
            try:
                if now - os.path.getmtime(path) > ttl:
                    os.unlink(path)
                    # The journal pairs with the spool: sweep as a unit.
                    with contextlib.suppress(OSError):
                        os.unlink(path + suffix)
            except OSError:
                # FileNotFoundError: committed/aborted under us -- gone.
                # Anything else (stray subdir, permission artifact): skip
                # THIS entry, never abort the sweep -- an unremovable
                # spool entry must not disable cache eviction forever.
                continue

    def run_once(self, now: float | None = None) -> list[Digest]:
        """One eviction sweep; returns evicted digests."""
        now = time.time() if now is None else now
        cfg = self.config
        self._flush_touches()
        self._sweep_abandoned_uploads()
        evicted: list[Digest] = []

        entries = [
            (d, self._last_access(d))
            for d in self.store.list_cache_digests()
            if self._evictable(d)
        ]

        # 1. idle eviction
        if cfg.tti_seconds > 0:
            for d, last in list(entries):
                if now - last > cfg.tti_seconds:
                    self._evict(d)
                    evicted.append(d)
                    entries.remove((d, last))

        # 2. disk-pressure eviction, LRU order. Chunk-aware sizing:
        # evicting a chunk-backed blob frees only its UNIQUE bytes
        # (shared chunks stay referenced by other manifests), so the
        # watermark math uses evictable_bytes, not the logical size --
        # and a delta base that shares nearly everything buys no
        # headroom, so the evictor naturally keeps it and moves on to
        # blobs whose eviction actually frees disk.
        if cfg.high_watermark_bytes > 0:
            usage = self.store.disk_usage_bytes()
            if usage > cfg.high_watermark_bytes:
                for d, _last in sorted(entries, key=lambda e: e[1]):
                    if usage <= cfg.low_watermark_bytes:
                        break
                    try:
                        size = self.store.evictable_bytes(d)
                    except (KeyError, AttributeError):
                        continue
                    self._evict(d)
                    evicted.append(d)
                    usage -= size
                # Under watermark pressure the freed chunk bytes must
                # become real NOW, not at the next budgeted GC pass --
                # ENOSPC beats politeness (the GC loop stays budgeted
                # for the steady state).
                cs = getattr(self.store, "chunkstore", None)
                if cs is not None:
                    cs.gc_reap()
        return evicted
