"""Cross-layer dedup plane: CDC chunks -> fingerprints on the card -> LSH.

The counterpart of ``kraken_tpu/origin/dedup.py`` (BASELINE.json configs
4-5): on every blob that lands in an origin's CAStore, the blob is
content-defined-chunked (:mod:`kraken_tpu_torch.ops.cdc`, the gear kernel
``csrc/gear.cu``), each chunk is fingerprinted through the batched SHA-256
plane (the ``cuda`` hasher's ragged kernel), a MinHash sketch is built
(:mod:`kraken_tpu_torch.ops.minhash`), and the sketch is inserted into an
LSH index so near-duplicate layers are queryable.

Sketches and per-chunk (fingerprint, size) tables persist as metadata
sidecars beside the blob -- the same bytes as the JAX package's, so either
package rebuilds its index from a store the other indexed, without
re-chunking -- and the corpus-level dedup ratio (bytes of chunks already
seen elsewhere / total bytes) is exact across restarts.

Entry points run on the card unless the caller asks for the CPU:
``DedupIndex(store)`` chunks, hashes and sketches on ``cuda``;
``DedupIndex(store, hasher=..., device="cpu")`` runs the plain versions.
"""

from __future__ import annotations

import asyncio
import mmap
import os
import struct
import threading
import time

import numpy as np
import torch

from kraken_tpu_torch.core.digest import Digest
from kraken_tpu_torch.core.hasher import PieceHasher
from kraken_tpu_torch.core.metainfo import ChunkRecipe
from kraken_tpu_torch.ops import resolve_device
from kraken_tpu_torch.ops.cdc import (
    CDCParams, chunk_host, chunk_spans, spans_from_cuts,
)
from kraken_tpu_torch.ops.minhash import (
    CompactLSHIndex,
    LSHIndex,
    MinHasher,
    fingerprints_from_digests,
)
from kraken_tpu_torch.ops.sha256 import TorchPieceHasher
from kraken_tpu_torch.store import CAStore, Metadata, register_metadata
from kraken_tpu_torch.utils.metrics import REGISTRY


class ChunkRouter:
    """Routes a blob's CDC pass to the host C chunker or the gear kernel by
    MEASURED rate, not a guessed threshold.

    Small blobs always chunk on host (a device dispatch's fixed cost
    dwarfs the work). The first blob at/above ``min_device_bytes`` runs a
    one-time calibration: both paths chunk the same leading sample and
    the faster one wins for the rest of the process lifetime. Calibration
    costs one extra pass over <= ``sample_bytes``, once.

    ``device``: ``None`` means the card (raises without CUDA), where the
    router calibrates; on ``"cpu"`` it decides ``host`` without timing,
    as the JAX router does off a TPU. An error of the device path during
    calibration reaches the caller: the router never settles on ``host``
    because the device raised.
    """

    def __init__(
        self,
        params: CDCParams,
        min_device_bytes: int = 8 << 20,
        sample_bytes: int = 8 << 20,
        device: str | torch.device | None = None,
    ):
        self.params = params
        self.device = resolve_device(device, "ChunkRouter")
        self.min_device_bytes = min_device_bytes
        self.sample_bytes = sample_bytes
        self.decision: str | None = None  # "host" | "device" once measured
        self.measured: dict[str, float] = {}  # path -> bytes/s
        self._calibrate_lock = threading.Lock()

    def _host_spans(self, data) -> list[tuple[int, int]]:
        return spans_from_cuts(chunk_host(data, self.params).tolist())

    def _device_spans(self, data) -> list[tuple[int, int]]:
        return chunk_spans(data, self.params, self.device)

    def _calibrate(self, data) -> None:
        if self.device.type != "cuda":
            self.decision = "host"
            return
        sample = np.array(
            memoryview(data)[: self.sample_bytes], copy=True
        )
        # Warm BOTH paths untimed first: the first device call pays the
        # kernel library's build and load, and the first host call pays
        # the cc build check -- timing either cold would lock in the
        # wrong decision for the process lifetime.
        self._host_spans(sample)
        self._device_spans(sample)
        t0 = time.perf_counter()
        self._host_spans(sample)
        host_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        self._device_spans(sample)  # device path (incl. transfer)
        device_s = time.perf_counter() - t0
        self.measured = {
            "host_bps": len(sample) / max(host_s, 1e-9),
            "device_bps": len(sample) / max(device_s, 1e-9),
        }
        self.decision = "device" if device_s < host_s else "host"
        # The stats() mirror of these rates is operator-polled; the gauge
        # is what dashboards see.
        g = REGISTRY.gauge(
            "dedup_chunk_route_bps",
            "Measured CDC chunk rate per path from the one-time "
            "ChunkRouter calibration (bytes/sec; 0 = not calibrated)",
        )
        g.set(self.measured["host_bps"], path="host")
        g.set(self.measured["device_bps"], path="device")

    def calibrate(self, data) -> str:
        """Decide the route on ``data``'s leading sample unless it is
        decided already; returns the decision."""
        if self.decision is None:
            with self._calibrate_lock:
                # Re-check: a concurrent ingest may have calibrated while
                # we waited (two racing calibrations would time contended
                # transfers and could lock in opposite decisions).
                if self.decision is None:
                    self._calibrate(data)
        return self.decision

    def spans(self, data) -> list[tuple[int, int]]:
        if len(data) < self.min_device_bytes:
            return self._host_spans(data)
        if self.calibrate(data) == "device":
            return self._device_spans(data)
        return self._host_spans(data)


class DedupEvictionRace(KeyError):
    """Eviction (or DELETE) raced an in-flight ``add_blob`` between the
    chunk/sketch compute and the index admit. Benign by design -- the
    index must simply not plant a ghost entry for a blob nobody can
    fetch -- and therefore NOT a dedup-plane failure: callers count it
    separately from ``origin_dedup_failures_total``.
    Subclasses KeyError so existing blob-not-found handling (404 on
    ``/similar``) keeps working."""


_MAGIC = 0xC5
# v2: ledger fingerprints widened to 64-bit (first 8 digest bytes). The v1
# 32-bit ledger saw likely birthday collisions past ~2^16 unique chunks,
# silently inflating duplicate_bytes; 32-bit fps remain only inside the
# MinHash sketch, where collision noise is within estimation error.
_VERSION = 2


@register_metadata
class ChunkSketchMetadata(Metadata):
    """Persisted dedup record: MinHash sketch + per-chunk (fp, size) table."""

    name = "chunksketch"

    def __init__(
        self, sketch: np.ndarray, fps: np.ndarray, sizes: np.ndarray
    ):
        self.sketch = np.asarray(sketch, dtype=np.uint32)
        self.fps = np.asarray(fps, dtype=np.uint64)
        self.sizes = np.asarray(sizes, dtype=np.uint32)
        if self.fps.shape != self.sizes.shape:
            raise ValueError("fps/sizes length mismatch")

    def serialize(self) -> bytes:
        head = struct.pack(
            "<BBHI", _MAGIC, _VERSION, self.sketch.size, self.fps.size
        )
        return (
            head
            + self.sketch.tobytes()
            + self.fps.tobytes()
            + self.sizes.tobytes()
        )

    @classmethod
    def deserialize(cls, raw: bytes) -> "ChunkSketchMetadata":
        magic, version, k, n = struct.unpack_from("<BBHI", raw, 0)
        if magic != _MAGIC or version != _VERSION:
            # Old-version sidecars are recomputed, not migrated: v1 stored
            # truncated fingerprints that cannot be widened after the fact.
            raise ValueError("bad chunksketch record")
        off = struct.calcsize("<BBHI")
        sketch = np.frombuffer(raw, dtype=np.uint32, count=k, offset=off)
        off += 4 * k
        fps = np.frombuffer(raw, dtype=np.uint64, count=n, offset=off)
        off += 8 * n
        sizes = np.frombuffer(raw, dtype=np.uint32, count=n, offset=off)
        return cls(sketch.copy(), fps.copy(), sizes.copy())


class DedupIndex:
    """Origin-side near-duplicate service over one CAStore.

    Thread-safe for the blocking entry points (they run in worker threads
    via ``asyncio.to_thread``); the LSH index and chunk ledger mutate under
    one lock. CDC + hashing + sketching (the heavy part) run outside it.
    """

    def __init__(
        self,
        store: CAStore,
        hasher: PieceHasher | None = None,
        params: CDCParams | None = None,
        num_hashes: int = 128,
        num_bands: int = 32,
        max_blobs: int = 200_000,
        index_kind: str = "dict",
        index_budget_bytes: int | None = None,
        low_j_bands: int | None = None,  # None = index default; 0 = off
        device: str | torch.device | None = None,
    ):
        self.device = resolve_device(device, "DedupIndex")
        self.store = store
        self.hasher = hasher or TorchPieceHasher(device=self.device)
        self.params = params or CDCParams()
        self.minhasher = MinHasher(num_hashes=num_hashes, device=self.device)
        # "dict" (LSHIndex) for typical origins; "compact" (array-backed,
        # ~1 KB/blob, optional byte budget) for million-blob corpora --
        # same banding math and query results, parity-tested.
        if index_kind == "compact":
            self._index = CompactLSHIndex(
                self.minhasher, num_bands=num_bands,
                budget_bytes=index_budget_bytes,
                low_j_bands=low_j_bands,
            )
        elif index_kind == "dict":
            self._index = LSHIndex(
                self.minhasher, num_bands=num_bands,
                low_j_bands=low_j_bands,
            )
        else:
            raise ValueError(f"unknown dedup index kind: {index_kind!r}")
        self._router = ChunkRouter(self.params, device=self.device)
        self._lock = threading.Lock()
        # Insertion-ordered (dict keys): beyond max_blobs the OLDEST
        # indexed blob leaves the in-memory index (its sidecar stays on
        # disk, so it re-admits on next touch) -- the ledger and LSH
        # tables are otherwise unbounded at the survey's 1M-chunk-set
        # scale. ~O(1 KB)/blob in-memory => default caps near 200 MB.
        self.max_blobs = max_blobs
        self._indexed: dict[str, None] = {}
        # Chunk ledger: 64-bit fp -> refcount across indexed blobs. Drives
        # the exact corpus dedup accounting (duplicate bytes / total bytes)
        # and supports removal: invariant is
        # duplicate_bytes == total_bytes - sum(size of each unique fp).
        self._seen: dict[int, int] = {}
        self.total_bytes = 0
        self.duplicate_bytes = 0
        # Promoted /dedup/stats counters: the JSON endpoint is
        # poll-only and invisible to the metric-catalog lint; these gauges
        # put the corpus accounting on /metrics proper. Registered (at
        # zero) from construction so a fresh origin's scrape and the
        # catalog lint both see the full set before the first ingest.
        self._g_blobs = REGISTRY.gauge(
            "origin_dedup_indexed_blobs",
            "Blobs currently admitted to the in-memory dedup index",
        )
        self._g_chunks = REGISTRY.gauge(
            "origin_dedup_unique_chunks",
            "Unique chunk fingerprints in the dedup ledger",
        )
        self._g_total = REGISTRY.gauge(
            "origin_dedup_total_bytes",
            "Bytes of chunked content the dedup ledger accounts",
        )
        self._g_dup = REGISTRY.gauge(
            "origin_dedup_duplicate_bytes",
            "Bytes whose chunk fingerprint was already in the ledger",
        )
        self._g_ratio = REGISTRY.gauge(
            "origin_dedup_ratio",
            "duplicate_bytes / total_bytes over the indexed corpus",
        )
        REGISTRY.gauge(
            "dedup_chunk_route_bps",
            "Measured CDC chunk rate per path from the one-time "
            "ChunkRouter calibration (bytes/sec; 0 = not calibrated)",
        )
        self._publish_stats()

    def _publish_stats(self) -> None:
        """Mirror the ledger onto /metrics (callers may hold ``_lock``;
        gauge sets take only their own)."""
        self._g_blobs.set(len(self._indexed))
        self._g_chunks.set(len(self._seen))
        self._g_total.set(self.total_bytes)
        self._g_dup.set(self.duplicate_bytes)
        self._g_ratio.set(
            self.duplicate_bytes / self.total_bytes if self.total_bytes else 0.0
        )

    # -- stats -------------------------------------------------------------

    @property
    def router(self) -> ChunkRouter:
        """The CDC route policy of this index (its decision and rates)."""
        return self._router

    @property
    def dedup_ratio(self) -> float:
        """Fraction of ingested bytes whose chunks were already stored."""
        return self.duplicate_bytes / self.total_bytes if self.total_bytes else 0.0

    def stats(self) -> dict:
        with self._lock:
            return {
                "blobs": len(self._indexed),
                "unique_chunks": len(self._seen),
                "total_bytes": self.total_bytes,
                "duplicate_bytes": self.duplicate_bytes,
                "dedup_ratio": round(self.dedup_ratio, 4),
                "chunk_route": self._router.decision or "host(<min)",
                "chunk_route_measured": {
                    k: round(v) for k, v in self._router.measured.items()
                },
            }

    # -- ingest ------------------------------------------------------------

    def _compute_record(
        self, data: bytes | memoryview
    ) -> ChunkSketchMetadata:
        spans = self._router.spans(data)
        view = memoryview(data)
        chunks = [view[s:e] for s, e in spans]
        digests = self.hasher.hash_batch(chunks)  # batched device dispatch
        # Per-chunk fp table keeps duplicates/order (sizes align 1:1);
        # the sketch uses the deduped 32-bit set.
        fps_all = (
            np.ascontiguousarray(digests[:, :8]).view(">u8").reshape(-1)
            .astype(np.uint64)
        )
        sizes = np.asarray([e - s for s, e in spans], dtype=np.uint32)
        sketch = self.minhasher.sketch(fingerprints_from_digests(digests))
        return ChunkSketchMetadata(sketch, fps_all, sizes)

    def _load_record(self, d: Digest) -> ChunkSketchMetadata | None:
        """Sidecar record for ``d``, or None if absent or old-version."""
        try:
            return self.store.get_metadata(d, ChunkSketchMetadata)
        except ValueError:
            return None

    def add_blob_sync(self, d: Digest) -> ChunkSketchMetadata:
        """Chunk + sketch + index blob ``d`` (idempotent; loads the sidecar
        if one exists). Raises KeyError if the blob is not in cache."""
        with self._lock:
            if d.hex in self._indexed:
                record = self._load_record(d)
                if record is not None:
                    return record
                # Sidecar vanished under us (concurrent DELETE): fall
                # through and recompute -- read_cache_file below raises
                # KeyError if the blob itself is gone too.
        record = self._load_record(d)
        if record is None:
            # mmap, not read(): CDC + chunk hashing walk the blob
            # sequentially, so the heap stays O(chunk) and the pages are
            # reclaimable file cache even for multi-GiB layers.
            with self.store.open_cache_file(d) as f:  # KeyError if absent
                try:
                    fileno = f.fileno()
                except OSError:
                    # Chunk-backed blob (no single fd to mmap): rare --
                    # a chunked blob normally HAS its sketch sidecar
                    # (the recipe that chunked it came from one) -- so
                    # buffering the composed read is acceptable here.
                    record = self._compute_record(f.read())
                    fileno = None
                if fileno is None:
                    pass
                elif os.fstat(fileno).st_size == 0:
                    record = self._compute_record(b"")
                else:
                    # Manual lifecycle, not `with`: a sampling profiler
                    # briefly holds every thread's frame, which can keep a
                    # just-returned frame's locals -- views over this
                    # map included -- alive a beat past the compute.
                    # An eager close() into that window raises
                    # BufferError; tolerating it and dropping the map
                    # instead lets the last view's dealloc unmap it
                    # (the bufpool.Lease.release precedent). The cache
                    # fd closes independently via the `with` above.
                    mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
                    mv = memoryview(mm)
                    try:
                        record = self._compute_record(mv)
                    finally:
                        try:
                            mv.release()
                            mm.close()
                        except BufferError:
                            pass
            if not self.store.in_cache(d):
                # Eviction (or DELETE) raced this add: the open fd/mmap
                # kept the bytes readable past the unlink, but indexing
                # now would plant a ghost entry remove_sync already ran
                # for -- /similar would hand out a blob nobody can fetch
                # -- and the sidecar write would orphan a ._md file
                # beside a deleted blob.
                raise DedupEvictionRace(d.hex)
            self.store.set_metadata(d, record)
        self._admit(d, record)
        self._evict_over_cap(keep=d.hex)
        return record

    def _evict_over_cap(self, keep: str) -> None:
        """Bound the in-memory index: oldest admitted leaves first (its
        sidecar persists; a later touch re-admits it)."""
        while True:
            # Pick the victim under the lock (remove_sync re-acquires it;
            # concurrent _admit/remove otherwise race the dict iteration).
            with self._lock:
                if len(self._indexed) <= self.max_blobs:
                    return
                oldest = next(iter(self._indexed))
            if oldest == keep:
                return
            self.remove_sync(Digest.from_hex(oldest))

    def _admit(self, d: Digest, record: ChunkSketchMetadata) -> None:
        with self._lock:
            if d.hex in self._indexed:
                return
            if not self.store.in_cache(d):
                # Eviction raced this add between the compute and here
                # (on_evict's remove_sync shares this lock, so checking
                # inside it leaves only the remove_sync->delete sliver):
                # indexing would plant a ghost /similar could hand out.
                raise DedupEvictionRace(d.hex)
            self._indexed[d.hex] = None
            self._index.add(d.hex, record.sketch)
            for fp, size in zip(record.fps.tolist(), record.sizes.tolist()):
                self.total_bytes += size
                if fp in self._seen:
                    self._seen[fp] += 1
                    self.duplicate_bytes += size
                else:
                    self._seen[fp] = 1
            self._publish_stats()

    async def add_blob(self, d: Digest) -> None:
        await asyncio.to_thread(self.add_blob_sync, d)

    def remove_sync(self, d: Digest) -> bool:
        """Drop blob ``d`` from the index and the corpus accounting (called
        on DELETE and on cache eviction). The sidecar may already be gone
        (the store deletes metadata with the blob), so the ledger is
        adjusted from the record only when it is still readable."""
        record = self._load_record(d)
        with self._lock:
            if d.hex not in self._indexed:
                return False
            self._indexed.pop(d.hex, None)
            self._index.remove(d.hex)
            if record is None:
                self._publish_stats()
                return True
            for fp, size in zip(record.fps.tolist(), record.sizes.tolist()):
                count = self._seen.get(fp, 0)
                if count == 0:
                    continue
                self.total_bytes -= size
                if count > 1:
                    self._seen[fp] = count - 1
                    self.duplicate_bytes -= size
                else:
                    del self._seen[fp]
            self._publish_stats()
            return True

    async def remove(self, d: Digest) -> bool:
        return await asyncio.to_thread(self.remove_sync, d)

    def load_existing(self) -> int:
        """Index every cached blob that already has a sketch sidecar (origin
        startup); returns the number admitted."""
        n = 0
        for d in self.store.list_cache_digests():
            if n >= self.max_blobs:
                break  # cap applies at startup too; the rest re-admit on touch
            record = self._load_record(d)
            if record is not None:
                self._admit(d, record)
                n += 1
        return n

    def chunk_table(self, d: Digest) -> tuple[list[int], list[int]] | None:
        """The blob's persisted ``(fps, sizes)`` chunk table, or None
        when no sketch sidecar exists -- what the origin's chunk-tier
        conversion feeds ``CAStore.convert_to_chunks`` (one derivation
        shared with the dedup ledger and the delta recipes)."""
        record = self._load_record(d)
        if record is None:
            return None
        return record.fps.tolist(), record.sizes.tolist()

    # -- chunk recipes (delta-transfer plane) -------------------------------

    def recipe_sync(self, d: Digest) -> tuple[ChunkRecipe, bool]:
        """``(recipe, had_sidecar)``: the blob's ordered chunk recipe
        plus whether a persisted sketch sidecar served it (False =
        recomputed through the ChunkRouter -- the recipe endpoint's
        hit-vs-recompute accounting, answered from the SAME single
        sidecar load that builds the recipe). Either way the blob is
        (re-)admitted to the /similar index, exactly as
        ``add_blob_sync`` would. Raises KeyError when the blob is not
        in cache."""
        record = self._load_record(d)
        had_sidecar = record is not None
        if record is None:
            record = self.add_blob_sync(d)
        else:
            self._admit(d, record)  # no-op when already indexed
            self._evict_over_cap(keep=d.hex)
        return (
            ChunkRecipe(d, record.fps.tolist(), record.sizes.tolist()),
            had_sidecar,
        )

    # -- query -------------------------------------------------------------

    def similar(
        self, d: Digest, k: int = 10, min_jaccard: float = 0.05
    ) -> list[dict]:
        """Near-duplicate blobs of ``d`` (must be indexed or have a sidecar):
        [{"digest": hex, "score": estimated-Jaccard}], best first."""
        record = self._load_record(d)
        if record is None:
            raise KeyError(d.hex)
        with self._lock:
            hits = self._index.query(record.sketch, k=k + 1, min_jaccard=min_jaccard)
        return [
            {"digest": key, "score": round(score, 4)}
            for key, score in hits
            if key != d.hex
        ][:k]
