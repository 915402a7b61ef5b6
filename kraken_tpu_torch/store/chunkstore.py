"""Chunk-tier config: the YAML ``chunkstore:`` section.

The port's part of ``kraken_tpu.store.chunkstore``: only the config and
its ``from_dict``, so the shipped files load. The tier itself (refcounted
chunk files, manifests, the zero-ref reaper) waits for ROADMAP A7f:
``enabled: true`` raises ``ValueError`` naming the key and A7f, at start
and on SIGHUP alike.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class ChunkStoreConfig:
    """The YAML ``chunkstore:`` section, every field of the reference's.
    Shipped OFF."""

    enabled: bool = False
    min_blob_bytes: int = 1 << 20
    gc_interval_seconds: float = 300.0
    gc_bytes_per_second: float = 32 * 1024 * 1024

    def __post_init__(self) -> None:
        if self.enabled:
            raise ValueError(
                "chunkstore.enabled: the chunk tier is not ported yet"
                " (ROADMAP A7f)"
            )

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
