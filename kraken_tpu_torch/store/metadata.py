"""Typed per-file metadata persisted beside cache files.

The agent's crash-resume depends on it: a restarted download reads the
piece bitfield and only fetches missing pieces; the origin remembers a
blob's namespace, its eviction pins and its last access. Each type
serializes to bytes and lives at ``<data_path>._md_<name>`` -- the same
file names and bytes as ``kraken_tpu.store.metadata``, so either package
reads the other's sidecars. ``ChunkManifestMetadata`` is not ported yet
(ROADMAP A7f).
"""

from __future__ import annotations

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
