"""Torrent metainfo: piece layout + per-piece digests for one blob.

A blob of ``length`` bytes is split into fixed ``piece_length`` pieces (the
final piece may be short). ``MetaInfo`` records the full SHA-256 digest of
every piece plus the blob digest; agents fetch it before downloading and
verify every received piece against it.

Serialization is canonical JSON (sorted keys, hex-encoded hash blob), and
``InfoHash`` is the SHA-256 of the canonical info document. Both are the
same bytes as ``kraken_tpu.core.metainfo`` writes, so a ``torrentmeta``
sidecar written by either package is read by the other and names the same
swarm. ``ChunkRecipe``, a blob's ordered CDC chunk table, serializes to the
same bytes as ``kraken_tpu``'s too.
"""

from __future__ import annotations

import hashlib
import json
import struct
from typing import Iterator, List, Sequence

from kraken_tpu_torch.core.digest import Digest

PIECE_HASH_SIZE = 32  # full SHA-256 per piece
CHUNK_FP_BYTES = 8  # chunk fingerprint = first 8 bytes of its SHA-256


class MetaInfoError(ValueError):
    """Raised on malformed metainfo documents."""


class InfoHash:
    """Deterministic identity of a torrent's info document (hex string)."""

    __slots__ = ("_hex",)

    def __init__(self, hex: str):
        if len(hex) != 64:
            raise MetaInfoError(f"malformed info hash: {hex!r}")
        self._hex = hex

    @classmethod
    def of(cls, info_doc: bytes) -> "InfoHash":
        return cls(hashlib.sha256(info_doc).hexdigest())

    @property
    def hex(self) -> str:
        return self._hex

    def __str__(self) -> str:
        return self._hex

    def __repr__(self) -> str:
        return f"InfoHash({self._hex[:12]}...)"

    def __eq__(self, other: object) -> bool:
        return isinstance(other, InfoHash) and other._hex == self._hex

    def __hash__(self) -> int:
        return hash(self._hex)


class MetaInfo:
    """Piece layout + per-piece SHA-256 digests for one blob."""

    __slots__ = ("_digest", "_length", "_piece_length", "_piece_hashes", "_info_hash")

    def __init__(
        self,
        digest: Digest,
        length: int,
        piece_length: int,
        piece_hashes: bytes,
    ):
        if piece_length <= 0:
            raise MetaInfoError(f"piece_length must be positive: {piece_length}")
        if length < 0:
            raise MetaInfoError(f"length must be non-negative: {length}")
        n = num_pieces(length, piece_length)
        if len(piece_hashes) != n * PIECE_HASH_SIZE:
            raise MetaInfoError(
                f"expected {n} piece hashes ({n * PIECE_HASH_SIZE} bytes), "
                f"got {len(piece_hashes)} bytes"
            )
        self._digest = digest
        self._length = length
        self._piece_length = piece_length
        self._piece_hashes = bytes(piece_hashes)
        self._info_hash = InfoHash.of(self._info_doc())

    # -- identity ----------------------------------------------------------

    @property
    def digest(self) -> Digest:
        return self._digest

    @property
    def name(self) -> str:
        """Blob name == digest hex."""
        return self._digest.hex

    @property
    def info_hash(self) -> InfoHash:
        return self._info_hash

    # -- piece layout ------------------------------------------------------

    @property
    def length(self) -> int:
        return self._length

    @property
    def piece_length(self) -> int:
        return self._piece_length

    @property
    def num_pieces(self) -> int:
        return num_pieces(self._length, self._piece_length)

    def piece_length_of(self, i: int) -> int:
        """Actual byte length of piece ``i`` (the last piece may be short)."""
        self._check_index(i)
        if i == self.num_pieces - 1:
            return self._length - i * self._piece_length
        return self._piece_length

    def piece_hash(self, i: int) -> bytes:
        self._check_index(i)
        return self._piece_hashes[i * PIECE_HASH_SIZE : (i + 1) * PIECE_HASH_SIZE]

    @property
    def piece_hashes(self) -> bytes:
        return self._piece_hashes

    def verify_piece(self, i: int, data: bytes | memoryview) -> bool:
        """Host verification of a single piece (the device path batches)."""
        if len(data) != self.piece_length_of(i):
            return False
        return hashlib.sha256(data).digest() == self.piece_hash(i)

    def _check_index(self, i: int) -> None:
        if not 0 <= i < self.num_pieces:
            raise IndexError(f"piece index {i} out of range [0, {self.num_pieces})")

    # -- serialization -----------------------------------------------------

    def _info_doc(self) -> bytes:
        # Canonical: sorted keys, no whitespace. This document defines the
        # InfoHash; never change field names or encoding without a version
        # bump in serialize().
        return json.dumps(
            {
                "length": self._length,
                "name": self._digest.hex,
                "piece_hashes": self._piece_hashes.hex(),
                "piece_length": self._piece_length,
            },
            sort_keys=True,
            separators=(",", ":"),
        ).encode()

    def serialize(self) -> bytes:
        return json.dumps(
            {
                "version": 1,
                "digest": str(self._digest),
                "info": json.loads(self._info_doc()),
            },
            sort_keys=True,
            separators=(",", ":"),
        ).encode()

    @classmethod
    def deserialize(cls, raw: bytes) -> "MetaInfo":
        try:
            doc = json.loads(raw)
            if not isinstance(doc, dict):
                raise MetaInfoError("metainfo document is not an object")
            if doc.get("version") != 1:
                raise MetaInfoError(f"unsupported metainfo version: {doc.get('version')}")
            info = doc["info"]
            mi = cls(
                digest=Digest.parse(doc["digest"]),
                length=info["length"],
                piece_length=info["piece_length"],
                piece_hashes=bytes.fromhex(info["piece_hashes"]),
            )
            name = info["name"]
        # AttributeError: non-dict/str values where the shape expects one
        # (e.g. an int digest reaching Digest.parse) -- this comes off the
        # wire, so any shape error is one thing: malformed metainfo.
        except (KeyError, TypeError, ValueError, AttributeError) as e:
            if isinstance(e, MetaInfoError):
                raise
            raise MetaInfoError(f"malformed metainfo: {e}") from e
        if name != mi.name:
            raise MetaInfoError("info name does not match digest")
        return mi

    # -- construction helpers ---------------------------------------------

    @classmethod
    def from_piece_hash_list(
        cls,
        digest: Digest,
        length: int,
        piece_length: int,
        hashes: List[bytes],
    ) -> "MetaInfo":
        return cls(digest, length, piece_length, b"".join(hashes))

    def __eq__(self, other: object) -> bool:
        return isinstance(other, MetaInfo) and other.serialize() == self.serialize()

    def __hash__(self) -> int:
        return hash(self._info_hash)

    def __repr__(self) -> str:
        return (
            f"MetaInfo(name={self.name[:12]}..., length={self._length}, "
            f"piece_length={self._piece_length}, pieces={self.num_pieces})"
        )


def num_pieces(length: int, piece_length: int) -> int:
    """Piece count for a blob; a zero-length blob has zero pieces."""
    return (length + piece_length - 1) // piece_length


class ChunkRecipe:
    """Ordered CDC chunk table for one blob: ``(fp, offset, size)`` per
    chunk, where ``fp`` is the first 8 bytes of the chunk's SHA-256 as a
    big-endian uint64 (the dedup plane's ledger fingerprint).

    This is the delta-transfer plane's control document: the origin
    derives it from the persisted ``ChunkSketchMetadata`` sidecar
    (``origin/dedup.py``) and serves it on ``GET .../recipe``; agents
    diff the target's recipe against a locally-held near-duplicate's to
    decide which byte spans can be copied out of the local base instead
    of fetched. Fingerprints are a PLANNING hint only -- every copied
    chunk is re-hashed against its fp and the assembled piece still goes
    through the full piece-hash verify, so a stale or hostile recipe can
    waste effort but never corrupt a blob.

    Offsets are implicit (cumulative sizes): chunks tile ``[0, length)``
    exactly, by construction and checked on deserialize.
    """

    __slots__ = ("_digest", "_length", "_fps", "_sizes")

    def __init__(self, digest: Digest, fps: Sequence[int], sizes: Sequence[int]):
        if len(fps) != len(sizes):
            raise MetaInfoError(
                f"fps/sizes length mismatch: {len(fps)} != {len(sizes)}"
            )
        for s in sizes:
            if not 0 < s < 1 << 32:
                raise MetaInfoError(f"chunk size out of range: {s}")
        for fp in fps:
            if not 0 <= fp < 1 << 64:
                raise MetaInfoError(f"chunk fp out of range: {fp}")
        self._digest = digest
        self._fps = tuple(int(fp) for fp in fps)
        self._sizes = tuple(int(s) for s in sizes)
        self._length = sum(self._sizes)

    @property
    def digest(self) -> Digest:
        return self._digest

    @property
    def length(self) -> int:
        return self._length

    @property
    def num_chunks(self) -> int:
        return len(self._fps)

    @property
    def fps(self) -> tuple:
        """Per-chunk fingerprints in blob order (the chunk tier's
        manifest table shares this derivation)."""
        return self._fps

    @property
    def sizes(self) -> tuple:
        return self._sizes

    def chunks(self) -> Iterator[tuple[int, int, int]]:
        """Yield ``(fp, offset, size)`` in blob order."""
        off = 0
        for fp, size in zip(self._fps, self._sizes):
            yield fp, off, size
            off += size

    def serialize(self) -> bytes:
        n = len(self._fps)
        return json.dumps(
            {
                "version": 1,
                "digest": str(self._digest),
                "length": self._length,
                # Packed tables, hex-encoded (a JSON int array costs ~3x
                # the bytes at 100k+ chunks): big-endian u64 fps, u32 sizes.
                "fps": struct.pack(f">{n}Q", *self._fps).hex(),
                "sizes": struct.pack(f">{n}I", *self._sizes).hex(),
            },
            sort_keys=True,
            separators=(",", ":"),
        ).encode()

    @classmethod
    def deserialize(cls, raw: bytes) -> "ChunkRecipe":
        try:
            doc = json.loads(raw)
            if not isinstance(doc, dict):
                raise MetaInfoError("chunk recipe is not an object")
            if doc.get("version") != 1:
                raise MetaInfoError(
                    f"unsupported chunk recipe version: {doc.get('version')}"
                )
            fps_raw = bytes.fromhex(doc["fps"])
            sizes_raw = bytes.fromhex(doc["sizes"])
            if len(fps_raw) % 8 or len(sizes_raw) % 4:
                raise MetaInfoError("misaligned chunk tables")
            n = len(fps_raw) // 8
            if len(sizes_raw) // 4 != n:
                raise MetaInfoError("fps/sizes table length mismatch")
            recipe = cls(
                Digest.parse(doc["digest"]),
                struct.unpack(f">{n}Q", fps_raw),
                struct.unpack(f">{n}I", sizes_raw),
            )
            if recipe.length != doc["length"]:
                raise MetaInfoError(
                    f"chunk sizes sum to {recipe.length}, document says "
                    f"{doc['length']}"
                )
        except (KeyError, TypeError, ValueError, AttributeError) as e:
            if isinstance(e, MetaInfoError):
                raise
            raise MetaInfoError(f"malformed chunk recipe: {e}") from e
        return recipe

    def __eq__(self, other: object) -> bool:
        return (
            isinstance(other, ChunkRecipe)
            and other._digest == self._digest
            and other._fps == self._fps
            and other._sizes == self._sizes
        )

    def __repr__(self) -> str:
        return (
            f"ChunkRecipe(digest={self._digest.hex[:12]}..., "
            f"length={self._length}, chunks={len(self._fps)})"
        )


def chunk_fp(data: bytes | bytearray | memoryview) -> int:
    """The recipe fingerprint of one chunk's bytes -- the SAME derivation
    the dedup plane persists (first 8 digest bytes, big-endian), in one
    place so the agent-side re-verify and the origin-side table can never
    drift."""
    return int.from_bytes(
        hashlib.sha256(data).digest()[:CHUNK_FP_BYTES], "big"
    )
