"""Typed per-file metadata persisted beside cache files.

The agent's crash-resume depends on it: a restarted download reads the
piece bitfield and only fetches missing pieces; the origin remembers a
blob's namespace, its eviction pins and its last access. Each type
serializes to bytes and lives at ``<data_path>._md_<name>`` -- the same
file names and bytes as ``kraken_tpu.store.metadata``, so either package
reads the other's sidecars.
"""

from __future__ import annotations

import struct
import time
from typing import Dict, Type

_REGISTRY: Dict[str, Type["Metadata"]] = {}


def register_metadata(cls: Type["Metadata"]) -> Type["Metadata"]:
    """Class decorator: register a metadata type by its ``name``."""
    _REGISTRY[cls.name] = cls
    return cls


def metadata_type(name: str) -> Type["Metadata"]:
    return _REGISTRY[name]


class Metadata:
    """One typed metadata record attached to a stored file."""

    name = "abstract"

    def serialize(self) -> bytes:
        raise NotImplementedError

    @classmethod
    def deserialize(cls, raw: bytes) -> "Metadata":
        raise NotImplementedError


@register_metadata
class PieceStatusMetadata(Metadata):
    """Bitfield of completed pieces for a partially-downloaded blob:
    a 4-byte big-endian piece count, then piece i at bit ``i % 8`` of
    byte ``i // 8``."""

    name = "piece_status"

    def __init__(self, num_pieces: int, bits: bytearray | None = None):
        self.num_pieces = num_pieces
        nbytes = (num_pieces + 7) // 8
        self.bits = bytearray(nbytes) if bits is None else bytearray(bits)
        if len(self.bits) != nbytes:
            raise ValueError(
                f"bitfield length {len(self.bits)} != expected {nbytes}"
            )
        # Stray padding bits in the last byte (corrupt/hand-built sidecar)
        # must not count: complete() would otherwise declare a torrent done
        # with a real piece missing.
        if num_pieces % 8 and self.bits:
            self.bits[-1] &= (1 << (num_pieces % 8)) - 1
        # Cached popcount: complete() runs once per received piece.
        self._count = sum(int(b).bit_count() for b in self.bits)

    def has(self, i: int) -> bool:
        return bool(self.bits[i // 8] >> (i % 8) & 1)

    def set(self, i: int) -> None:
        if not self.has(i):
            self.bits[i // 8] |= 1 << (i % 8)
            self._count += 1

    def complete(self) -> bool:
        return self._count == self.num_pieces

    def count(self) -> int:
        return self._count

    def missing(self) -> list[int]:
        return [i for i in range(self.num_pieces) if not self.has(i)]

    def serialize(self) -> bytes:
        return self.num_pieces.to_bytes(4, "big") + bytes(self.bits)

    @classmethod
    def deserialize(cls, raw: bytes) -> "PieceStatusMetadata":
        n = int.from_bytes(raw[:4], "big")
        return cls(n, bytearray(raw[4:]))


@register_metadata
class ChunkManifestMetadata(Metadata):
    """Chunk-tier manifest: the ordered ``(fp, size)`` table a blob is
    stored as once the content-addressed chunk tier holds its bytes
    (store/chunkstore.py). The presence of THIS sidecar -- with no flat
    data file beside it -- is what marks a blob as chunk-backed:
    ``CAStore.in_cache`` counts it, reads compose through a
    :class:`~kraken_tpu_torch.store.chunkstore.ChunkReader`, and deleting the
    blob releases one reference on every chunk listed here. Same packed
    tables as ``core/metainfo.ChunkRecipe`` (big-endian u64 fps, u32
    sizes; offsets implicit), one derivation shared with the dedup
    ledger, so the manifest IS the recipe minus the JSON envelope."""

    name = "chunk_manifest"

    def __init__(self, fps, sizes):
        self.fps = [int(fp) for fp in fps]
        self.sizes = [int(s) for s in sizes]
        if len(self.fps) != len(self.sizes):
            raise ValueError("fps/sizes length mismatch")
        for s in self.sizes:
            if not 0 < s < 1 << 32:
                raise ValueError(f"chunk size out of range: {s}")
        self.length = sum(self.sizes)

    def chunks(self):
        """Yield ``(fp, offset, size)`` in blob order."""
        off = 0
        for fp, size in zip(self.fps, self.sizes):
            yield fp, off, size
            off += size

    def serialize(self) -> bytes:
        n = len(self.fps)
        return (
            struct.pack("<BI", 1, n)
            + struct.pack(f">{n}Q", *self.fps)
            + struct.pack(f">{n}I", *self.sizes)
        )

    @classmethod
    def deserialize(cls, raw: bytes) -> "ChunkManifestMetadata":
        try:
            version, n = struct.unpack_from("<BI", raw, 0)
            if version != 1:
                raise ValueError(
                    f"unsupported chunk manifest version: {version}"
                )
            off = struct.calcsize("<BI")
            if len(raw) != off + 12 * n:
                raise ValueError("truncated chunk manifest")
            fps = struct.unpack_from(f">{n}Q", raw, off)
            sizes = struct.unpack_from(f">{n}I", raw, off + 8 * n)
        except struct.error as e:
            # An empty/short sidecar (rename-durability power loss) must
            # surface as the SAME ValueError contract every caller
            # guards -- struct.error is not a ValueError subclass.
            raise ValueError(f"malformed chunk manifest: {e}") from e
        return cls(fps, sizes)


@register_metadata
class TTIMetadata(Metadata):
    """Last-access timestamp driving idle (TTI) eviction."""

    name = "tti"

    def __init__(self, last_access: float | None = None):
        self.last_access = time.time() if last_access is None else last_access

    def serialize(self) -> bytes:
        return repr(self.last_access).encode()

    @classmethod
    def deserialize(cls, raw: bytes) -> "TTIMetadata":
        return cls(float(raw.decode()))


@register_metadata
class NamespaceMetadata(Metadata):
    """The namespace a blob was committed under -- needed by the repair
    path, which re-replicates blobs long after the upload request (and its
    namespace) is gone."""

    name = "namespace"

    def __init__(self, namespace: str):
        self.namespace = namespace

    def serialize(self) -> bytes:
        return self.namespace.encode()

    @classmethod
    def deserialize(cls, raw: bytes) -> "NamespaceMetadata":
        return cls(raw.decode())


@register_metadata
class PersistMetadata(Metadata):
    """Marks a cache file as exempt from eviction while any pin reason is
    outstanding (pending writeback, pending replication, ...).

    Multiple subsystems pin independently; a boolean would let one
    subsystem's unpin release another's pin (writeback landing must not
    unpin a blob whose replication is still retrying). Pin bookkeeping is
    not concurrency-safe across threads -- callers run on the event loop.
    """

    name = "persist"

    def __init__(self, persist: bool | set[str] = True):
        if isinstance(persist, bool):
            self.reasons: set[str] = {"writeback"} if persist else set()
        else:
            self.reasons = set(persist)

    @property
    def persist(self) -> bool:
        return bool(self.reasons)

    def serialize(self) -> bytes:
        return ",".join(sorted(self.reasons)).encode()

    @classmethod
    def deserialize(cls, raw: bytes) -> "PersistMetadata":
        text = raw.decode()
        if text == "1":
            # Legacy boolean record: writeback was the only writer of
            # PersistMetadata(True), so map it to the reason writeback
            # releases -- an unreleasable reason would pin forever.
            return cls({"writeback"})
        if text in ("", "0"):
            return cls(False)
        return cls(set(text.split(",")))


def pin(store, d, reason: str) -> None:
    """Add an eviction-exemption reason to a blob."""
    md = store.get_metadata(d, PersistMetadata) or PersistMetadata(set())
    md.reasons.add(reason)
    store.set_metadata(d, md)


def unpin(store, d, reason: str) -> None:
    """Drop one reason; the blob stays pinned while others remain."""
    md = store.get_metadata(d, PersistMetadata)
    if md is None:
        return
    md.reasons.discard(reason)
    store.set_metadata(d, md)
