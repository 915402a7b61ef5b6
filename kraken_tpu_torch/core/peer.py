"""Peer identity and announce records.

Reference: uber/kraken ``core/peer_id.go`` (``PeerID``, ``PeerIDFactory``
with ``addr_hash`` and random variants), ``core/peer_info.go``,
``core/blob_info.go`` -- upstream paths, unverified; see SURVEY.md SS2.1.
"""

from __future__ import annotations

import dataclasses
import hashlib
import re
import secrets

PEER_ID_SIZE = 20  # bytes, rendered as 40 hex chars (BitTorrent-sized)
_PEER_ID_RE = re.compile(r"^[0-9a-f]{40}$")


class PeerIDError(ValueError):
    pass


class PeerID:
    """A 20-byte peer identity, rendered as 40 hex chars."""

    __slots__ = ("_hex",)

    def __init__(self, hex: str):
        if not _PEER_ID_RE.match(hex):
            raise PeerIDError(f"malformed peer id: {hex!r}")
        self._hex = hex

    @property
    def hex(self) -> str:
        return self._hex

    def __str__(self) -> str:
        return self._hex

    def __repr__(self) -> str:
        return f"PeerID({self._hex[:12]}...)"

    def __eq__(self, other: object) -> bool:
        return isinstance(other, PeerID) and other._hex == self._hex

    def __lt__(self, other: "PeerID") -> bool:
        return self._hex < other._hex

    def __hash__(self) -> int:
        return hash(self._hex)


class PeerIDFactory:
    """Builds peer ids.

    Two variants, as in the reference:

    - ``addr_hash``: deterministic from ``ip:port``, so an agent restarted
      on the same address keeps its identity (and its tracker records
      remain valid).
    - ``random``: fresh identity per process.
    """

    ADDR_HASH = "addr_hash"
    RANDOM = "random"

    def __init__(self, variant: str = ADDR_HASH):
        if variant not in (self.ADDR_HASH, self.RANDOM):
            raise PeerIDError(f"unknown peer id factory variant: {variant!r}")
        self._variant = variant

    def create(self, ip: str, port: int) -> PeerID:
        if self._variant == self.ADDR_HASH:
            raw = hashlib.sha256(f"{ip}:{port}".encode()).digest()[:PEER_ID_SIZE]
            return PeerID(raw.hex())
        return PeerID(secrets.token_hex(PEER_ID_SIZE))


@dataclasses.dataclass(frozen=True)
class PeerInfo:
    """One peer's announce record, as stored by the tracker and handed to
    announcers."""

    peer_id: PeerID
    ip: str
    port: int
    origin: bool = False  # dedicated seeder
    complete: bool = False  # has every piece

    @property
    def addr(self) -> str:
        return f"{self.ip}:{self.port}"

    def to_dict(self) -> dict:
        return {
            "peer_id": self.peer_id.hex,
            "ip": self.ip,
            "port": self.port,
            "origin": self.origin,
            "complete": self.complete,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "PeerInfo":
        return cls(
            peer_id=PeerID(d["peer_id"]),
            ip=d["ip"],
            port=int(d["port"]),
            origin=bool(d.get("origin", False)),
            complete=bool(d.get("complete", False)),
        )


@dataclasses.dataclass(frozen=True)
class BlobInfo:
    """Blob size record, served by origins on stat."""

    size: int

    def to_dict(self) -> dict:
        return {"size": self.size}

    @classmethod
    def from_dict(cls, d: dict) -> "BlobInfo":
        return cls(size=int(d["size"]))
