"""Background integrity scrubber: re-verify at-rest blobs, quarantine rot.

The port's copy of ``kraken_tpu.store.scrub`` (hashlib digests, as the
reference).

Commit is the only moment the storage plane verifies content against the
CAS invariant; after that, bit-rot or a torn crash-window write silently
poisons every downstream consumer (P2P seeding, ring replication, backend
writeback all stream from disk unchecked). The scrubber closes that gap:
a low-priority async loop re-hashes every cached blob on a configurable
cycle and MOVES mismatches to ``quarantine/`` -- never silent deletion,
so operators can post-mortem the damage (docs/OPERATIONS.md runbook).

Priorities are enforced two ways:

- read IO flows through a ``utils/bandwidth.TokenBucket`` capped at
  ``bytes_per_second``, so a scrub pass never starves the serving path
  of disk bandwidth;
- digest work reuses the node's ``HashPool`` (core/hasher.py,
  ``hash_workers``) when one exists, so scrubbing costs pool occupancy
  -- visible on the pool gauges -- instead of a private thread.

On corruption: quarantine (data + sidecars move together, so the piece
bitfield, torrent meta, and dedup sketch all leave the cache tree with
the bytes), count ``scrub_corruptions_total{source="scrub"}``, and hand
the digest to ``on_corrupt`` -- assembly wires that to dedup-index
removal, scheduler unseed, and the origin heal plane (re-fetch from ring
replicas via the persistedretry task in origin/server.py).

Failpoint ``store.scrub.bitflip``: when armed, the next verified blob
gets one byte flipped ON DISK before hashing -- real at-rest damage, so
the chaos tier proves detect -> quarantine -> heal end-to-end with the
quarantined capture actually holding corrupt bytes.
"""

from __future__ import annotations

import asyncio
import dataclasses
import hashlib
import logging
import os
from typing import Callable, Optional

from kraken_tpu_torch.core.digest import Digest
from kraken_tpu_torch.store.castore import CAStore
from kraken_tpu_torch.store.metadata import NamespaceMetadata
from kraken_tpu_torch.utils import failpoints
from kraken_tpu_torch.utils.bandwidth import TokenBucket
from kraken_tpu_torch.utils.metrics import REGISTRY, FailureMeter

_log = logging.getLogger("kraken.scrub")


@dataclasses.dataclass
class ScrubConfig:
    # Sleep between full-store passes. One pass at bytes_per_second may
    # itself take long on a big store; the interval is the idle gap, not
    # a schedule guarantee.
    interval_seconds: float = 6 * 3600.0
    # Read budget (token bucket). 0 = unthrottled (offline tools only --
    # an unthrottled scrub on a serving node competes with reads).
    bytes_per_second: float = 32 * 1024 * 1024
    chunk_bytes: int = 1 << 20


class Scrubber:
    """Drives verification passes over a CAStore.

    ``hasher`` is the node's PieceHasher (its ``pool`` is reused for
    digest work when present); ``on_corrupt(digest, namespace)`` runs on
    the event loop after a blob was quarantined.
    """

    def __init__(
        self,
        store: CAStore,
        config: ScrubConfig | None = None,
        hasher=None,
        on_corrupt: Callable[[Digest, str], None] | None = None,
    ):
        self.store = store
        self.config = config or ScrubConfig()
        self._pool = getattr(hasher, "pool", None)
        self.on_corrupt = on_corrupt
        # Capacity >= one chunk: acquire(chunk) must be satisfiable
        # without relying on the oversize-request escape hatch.
        self._bucket = TokenBucket(
            self.config.bytes_per_second,
            capacity=max(
                self.config.bytes_per_second, float(self.config.chunk_bytes)
            ),
        )
        self._task: Optional[asyncio.Task] = None
        self._failures = FailureMeter(
            "scrub_cycle_failures_total",
            "Scrub cycles that raised (retried next interval)",
            _log,
        )

    # -- one pass ----------------------------------------------------------

    async def run_cycle(self) -> list[Digest]:
        """Verify every cached blob once; returns the quarantined digests."""
        quarantined: list[Digest] = []
        # Digests with a live journaled upload session are mid-ingest:
        # their tail is still arriving (resume) or their commit is in
        # flight (serve-while-ingest) -- judging them now risks
        # quarantining a blob the very next PATCH completes. The next
        # cycle scrubs them committed.
        live = await asyncio.to_thread(self.store.live_upload_digests)
        for d in await asyncio.to_thread(self.store.list_cache_digests):
            if d.hex in live:
                continue
            try:
                ok = await self._verify(d)
            except (KeyError, FileNotFoundError):
                if not self.store.in_cache(d):
                    continue  # evicted/deleted mid-scrub: nothing to judge
                # Still cached yet unreadable: a chunk-backed blob whose
                # chunk file vanished (quarantined by another blob's
                # scrub, manual damage) -- at-rest loss, same verdict as
                # EIO below.
                _log.warning(
                    "scrub: cached blob unreadable (missing chunk?); "
                    "treating as corrupt",
                    extra={"digest": d.hex}, exc_info=True,
                )
                ok = False
            except OSError:
                # A media-level read failure (EIO on a dying sector) IS
                # at-rest damage -- the scrubber's primary real-world
                # find. Skipping it would leave the blob seeded and
                # indexed while unreadable; quarantine + heal instead.
                _log.warning(
                    "scrub: blob unreadable; treating as corrupt",
                    extra={"digest": d.hex}, exc_info=True,
                )
                ok = False
            if ok:
                continue
            if self.store.is_chunked(d):
                # Chunk-backed blob: pinpoint the damage first. The
                # corrupt chunk file moves to quarantine (NEVER deleted
                # -- evidence), so every other manifest referencing it
                # fails its next read/scrub too and heals the same way;
                # the heal plane's re-fetch re-chunks the verified blob
                # and rewrites the chunk bit-identically.
                await asyncio.to_thread(self._quarantine_corrupt_chunks, d)
            # Read the namespace BEFORE quarantine moves the sidecar --
            # the heal plane re-fetches under it.
            md = await asyncio.to_thread(
                self.store.get_metadata, d, NamespaceMetadata
            )
            ns = md.namespace if md is not None else "default"
            try:
                dst = await asyncio.to_thread(
                    self.store.quarantine_cache_file, d
                )
            except OSError as e:
                # Same dying disk failing the move: keep the cycle going
                # for the remaining blobs, metered + retried next pass.
                self._failures.record(f"quarantine {d.hex[:8]}", e)
                continue
            if dst is None:
                continue  # raced away (evicted) between hash and move
            REGISTRY.counter(
                "scrub_corruptions_total",
                "Blobs that failed at-rest content verification",
            ).inc(source="scrub")
            _log.error(
                "scrub: corrupt blob quarantined",
                extra={
                    "digest": d.hex, "namespace": ns, "quarantine": dst,
                },
            )
            quarantined.append(d)
            if self.on_corrupt is not None:
                try:
                    self.on_corrupt(d, ns)
                except Exception as e:
                    self._failures.record(f"on_corrupt {d.hex[:8]}", e)
        REGISTRY.counter(
            "scrub_cycles_total", "Completed full-store scrub passes"
        ).inc()
        return quarantined

    def _quarantine_corrupt_chunks(self, d: Digest) -> int:
        """Move aside every chunk of ``d`` whose bytes no longer hash to
        its fp (worker thread; the blob-level verify already failed)."""
        md = self.store.manifest(d)
        cs = self.store.chunkstore
        if md is None or cs is None:
            return 0
        moved = 0
        for fp, _off, size in md.chunks():
            if not cs.verify_chunk(fp, size):
                try:
                    if cs.quarantine_chunk(fp, size) is not None:
                        moved += 1
                except OSError as e:
                    self._failures.record(
                        f"chunk quarantine {fp:016x}-{size}", e
                    )
        return moved

    async def _verify(self, d: Digest) -> bool:
        if failpoints.fire("store.scrub.bitflip"):
            await asyncio.to_thread(_flip_bit, self.store.cache_path(d))
        h = hashlib.sha256()
        with self.store.open_cache_file(d) as f:
            while True:
                chunk = await asyncio.to_thread(
                    f.read, self.config.chunk_bytes
                )
                if not chunk:
                    break
                # IO budget BEFORE the digest work: the cap bounds disk
                # read rate, and hashing an already-read chunk is free.
                await self._bucket.acquire(len(chunk))
                if self._pool is not None:
                    await asyncio.wrap_future(self._pool.submit(h.update, chunk))
                else:
                    await asyncio.to_thread(h.update, chunk)
                REGISTRY.counter(
                    "scrub_bytes_total", "Bytes re-read by the scrubber"
                ).inc(len(chunk))
        return h.hexdigest() == d.hex

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        self._task = asyncio.create_task(self._loop())

    async def _loop(self) -> None:
        while True:
            await asyncio.sleep(self.config.interval_seconds)
            try:
                await self.run_cycle()
            except Exception as e:
                self._failures.record("scrub cycle", e)

    def stop(self) -> None:
        if self._task:
            self._task.cancel()


def _flip_bit(path: str) -> None:
    """Chaos helper: flip one bit mid-file ON DISK (store.scrub.bitflip).
    Empty or absent files are left alone -- there is no bit to flip
    (chunk-backed blobs have no flat file; their chaos tier flips a
    chunk file directly, tests/test_chunkstore.py)."""
    if not os.path.exists(path):
        return
    size = os.path.getsize(path)
    if size == 0:
        return
    with open(path, "r+b") as f:
        f.seek(size // 2)
        b = f.read(1)
        f.seek(size // 2)
        f.write(bytes([b[0] ^ 0x01]))
