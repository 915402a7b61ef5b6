"""Blob identity: SHA-256 digests in ``sha256:<hex>`` form.

Every blob (docker layer, manifest, arbitrary file) in the system is
identified by the SHA-256 of its content. Digest strings follow the Docker
content-addressable format ``sha256:<64 hex chars>``.

The port's own copy of ``kraken_tpu.core.digest``: the same strings, the
same equality, so digests parsed by either package name the same blobs.
"""

from __future__ import annotations

import hashlib
import re
from typing import BinaryIO, Iterator

SHA256 = "sha256"
_HEX_RE = re.compile(r"^[0-9a-f]{64}$")

# Default read size for streaming digest computation.
_STREAM_CHUNK = 4 * 1024 * 1024


class DigestError(ValueError):
    """Raised on malformed digest strings."""


class Digest:
    """An immutable ``sha256:<hex>`` blob identity.

    >>> d = Digest.from_bytes(b"hello")
    >>> d.algo
    'sha256'
    >>> str(d) == "sha256:" + d.hex
    True
    """

    __slots__ = ("_algo", "_hex")

    def __init__(self, algo: str, hex: str):
        if algo != SHA256:
            raise DigestError(f"unsupported digest algorithm: {algo!r}")
        if not _HEX_RE.match(hex):
            raise DigestError(f"malformed sha256 hex: {hex!r}")
        self._algo = algo
        self._hex = hex

    # -- constructors ------------------------------------------------------

    @classmethod
    def parse(cls, s: str) -> "Digest":
        """Parse ``sha256:<hex>``."""
        algo, sep, hx = s.partition(":")
        if not sep:
            raise DigestError(f"digest missing ':' separator: {s!r}")
        return cls(algo, hx)

    @classmethod
    def from_hex(cls, hx: str) -> "Digest":
        return cls(SHA256, hx)

    @classmethod
    def from_str(cls, s: str) -> "Digest":
        """Lenient URL-path form: ``sha256:<hex>`` or bare ``<hex>``."""
        return cls.parse(s) if ":" in s else cls.from_hex(s)

    @classmethod
    def from_bytes(cls, data: bytes | bytearray | memoryview) -> "Digest":
        return cls(SHA256, hashlib.sha256(data).hexdigest())

    @classmethod
    def from_reader(cls, f: BinaryIO) -> "Digest":
        h = hashlib.sha256()
        while True:
            chunk = f.read(_STREAM_CHUNK)
            if not chunk:
                break
            h.update(chunk)
        return cls(SHA256, h.hexdigest())

    # -- accessors ---------------------------------------------------------

    @property
    def algo(self) -> str:
        return self._algo

    @property
    def hex(self) -> str:
        return self._hex

    @property
    def raw(self) -> bytes:
        """The 32 raw digest bytes."""
        return bytes.fromhex(self._hex)

    def short(self, n: int = 12) -> str:
        return self._hex[:n]

    def __str__(self) -> str:
        return f"{self._algo}:{self._hex}"

    def __repr__(self) -> str:
        return f"Digest({str(self)!r})"

    def __eq__(self, other: object) -> bool:
        return (
            isinstance(other, Digest)
            and other._algo == self._algo
            and other._hex == self._hex
        )

    def __hash__(self) -> int:
        return hash((self._algo, self._hex))

    def __lt__(self, other: "Digest") -> bool:
        return self._hex < other._hex


class Digester:
    """Incremental SHA-256 wrapper producing a :class:`Digest`."""

    __slots__ = ("_h",)

    def __init__(self):
        self._h = hashlib.sha256()

    def update(self, data: bytes | bytearray | memoryview) -> None:
        self._h.update(data)

    def digest(self) -> Digest:
        return Digest(SHA256, self._h.hexdigest())

    def tee(self, chunks: Iterator[bytes]) -> Iterator[bytes]:
        """Yield chunks unchanged while hashing them."""
        for c in chunks:
            self._h.update(c)
            yield c
