"""Metainfo generation: the origin-side piece-hash hot loop, on the GPU.

Choose the piece length from the blob size, hash every piece through the
batched ``PieceHasher`` (one kernel launch per window of pieces) or the
pipelined ingest plane (``core/ingest.py``), and persist the MetaInfo as a
``torrentmeta`` sidecar of the blob, so restarts never re-hash. The
sidecar bytes are those ``kraken_tpu`` writes.
"""

from __future__ import annotations

import asyncio
import dataclasses
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from kraken_tpu_torch.core.digest import Digest
from kraken_tpu_torch.core.hasher import PieceHasher, get_hasher
from kraken_tpu_torch.core.metainfo import MetaInfo
from kraken_tpu_torch.store import CAStore, Metadata, register_metadata
from kraken_tpu_torch.utils import trace


@register_metadata
class TorrentMetaMetadata(Metadata):
    """The blob's serialized MetaInfo, stored beside it."""

    name = "torrentmeta"

    def __init__(self, metainfo: MetaInfo):
        self.metainfo = metainfo

    def serialize(self) -> bytes:
        return self.metainfo.serialize()

    @classmethod
    def deserialize(cls, raw: bytes) -> "TorrentMetaMetadata":
        return cls(MetaInfo.deserialize(raw))


@dataclasses.dataclass(frozen=True)
class PieceLengthConfig:
    """Blob size -> piece length table (powers of two). Small blobs get
    4 MiB pieces; larger blobs scale up so the piece count stays bounded."""

    # (min blob size, piece length), evaluated top-down; last match wins.
    table: tuple[tuple[int, int], ...] = (
        (0, 4 * 1024 * 1024),
        (2 * 1024**3, 8 * 1024 * 1024),
        (8 * 1024**3, 16 * 1024 * 1024),
    )

    def piece_length(self, blob_size: int) -> int:
        chosen = self.table[0][1]
        for min_size, piece_len in self.table:
            if blob_size >= min_size:
                chosen = piece_len
        return chosen


class Generator:
    """Generates (and caches) MetaInfo for blobs in a CAStore.

    With no ``hasher`` it takes the pipeline's hasher, or else the ``cuda``
    hasher, which needs a card.
    """

    def __init__(
        self,
        store: CAStore,
        hasher: PieceHasher | None = None,
        piece_lengths: PieceLengthConfig | None = None,
        window_bytes: int = 256 * 1024 * 1024,
        pipeline=None,
    ):
        self.store = store
        self.hasher = hasher or (
            pipeline.hasher if pipeline is not None else get_hasher("cuda")
        )
        self.piece_lengths = piece_lengths or PieceLengthConfig()
        # Blobs are hashed through a sliding window of whole pieces, so
        # generation memory is O(window), not O(blob). The window is the
        # hasher's batch: one thread of the kernel per piece in it.
        self.window_bytes = window_bytes
        # core.ingest.IngestPipeline, when the origin runs the pipelined
        # ingest plane: generate streams the blob's windows through it
        # (read overlapping pack/transfer/hash) instead of the serial
        # read-then-hash loop. None = serial path.
        self.pipeline = pipeline

    def get_cached(self, d: Digest) -> MetaInfo | None:
        md = self.store.get_metadata(d, TorrentMetaMetadata)
        return md.metainfo if md else None

    def generate_sync(self, d: Digest) -> MetaInfo:
        """Hash every piece of blob ``d`` (windowed batched dispatches) and
        persist the MetaInfo. Idempotent. Raises KeyError if the blob is
        absent."""
        cached = self.get_cached(d)
        if cached is not None:
            return cached
        size = self.store.cache_size(d)  # KeyError if absent
        piece_length = self.piece_lengths.piece_length(size)
        if self.pipeline is not None:
            hashes = self._generate_pipelined(d, size, piece_length)
            metainfo = MetaInfo(d, size, piece_length, hashes.tobytes())
            self.store.set_metadata(d, TorrentMetaMetadata(metainfo))
            return metainfo
        # Floor the window at a few pieces when a host hash pool exists, so
        # a tiny window cannot serialize the sharded piece pass; the cap of
        # 4 keeps window_bytes the operator's memory bound.
        pool = self.hasher.pool
        min_pieces = min(pool.workers, 4) if pool is not None else 1
        window = max(
            piece_length * min_pieces,
            self.window_bytes // piece_length * piece_length,
        )
        parts = []
        # One-window lookahead: the read of window i+1 runs in a side
        # thread while the hasher chews window i. The span splits the wall
        # into the hasher's calls and the waits for a read.
        hash_s = 0.0
        with trace.span("origin.metainfo.generate", digest=d.hex[:12]) as sp, \
                self.store.open_cache_file(d) as f, ThreadPoolExecutor(1) as ex:
            t0 = time.perf_counter()
            data = f.read(window)
            while True:
                prefetch = ex.submit(f.read, window)
                t1 = time.perf_counter()
                parts.append(self.hasher.hash_pieces(data, piece_length))
                hash_s += time.perf_counter() - t1
                if len(data) < window:
                    break
                data = prefetch.result()
                if not data:
                    break
            if sp is not None:
                wall = time.perf_counter() - t0
                sp.set(size=size, windows=len(parts), hash_s=round(hash_s, 6),
                       read_wait_s=round(wall - hash_s, 6))
        hashes = parts[0] if len(parts) == 1 else np.concatenate(parts)
        metainfo = MetaInfo(d, size, piece_length, hashes.tobytes())
        self.store.set_metadata(d, TorrentMetaMetadata(metainfo))
        return metainfo

    def _generate_pipelined(
        self, d: Digest, size: int, piece_length: int
    ) -> np.ndarray:
        """Stream the blob through the ingest pipeline: ``readinto`` lands
        each window's bytes directly in the staging buffer the hasher
        consumes, and the pipeline overlaps window k+1's read with window
        k's pack/transfer/hash. Digests are bit-identical to the serial
        loop -- same piece boundaries. The span carries the session's
        stage walls and its waits for a window slot."""
        ses = self.pipeline.session(piece_length)
        with trace.span("origin.metainfo.generate", digest=d.hex[:12]) as sp:
            try:
                with self.store.open_cache_file(d) as f:
                    while True:
                        buf = ses.begin_window()
                        n = f.readinto(buf)
                        ses.submit(n or 0)
                        if not n or n < len(buf):
                            break
                hashes = ses.finish()
            except BaseException:
                ses.abort()
                raise
            if sp is not None:
                sp.set(size=size, windows=ses.windows,
                       slot_s=round(ses.slot_seconds, 6),
                       **{f"{k}_s": round(v, 6)
                          for k, v in ses.stage_seconds.items()})
        return hashes

    async def generate(self, d: Digest) -> MetaInfo:
        """Off-loop :meth:`generate_sync` (reads + hashes a whole blob)."""
        return await asyncio.to_thread(self.generate_sync, d)

    def adopt(
        self, d: Digest, size: int, piece_length: int, piece_hashes: bytes
    ) -> MetaInfo:
        """Persist a MetaInfo whose piece hashes the caller computed while
        the bytes streamed in -- the blob is never re-read. The piece length
        must match this generator's config for ``size`` so agents and the
        re-generate path agree bit-for-bit."""
        if piece_length != self.piece_lengths.piece_length(size):
            raise ValueError(
                f"piece_length {piece_length} != configured "
                f"{self.piece_lengths.piece_length(size)} for size {size}"
            )
        metainfo = MetaInfo(d, size, piece_length, piece_hashes)
        self.store.set_metadata(d, TorrentMetaMetadata(metainfo))
        return metainfo
