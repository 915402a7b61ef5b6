"""Test fixtures for core types, importable by every other package's tests.

The port's copy of ``kraken_tpu.core.fixtures``: the same seeds give the
same bytes, digests and metainfo.

Reference: uber/kraken ``core/fixtures.go`` (``DigestFixture``,
``MetaInfoFixture``) -- upstream path, unverified; see SURVEY.md SS4.
"""

from __future__ import annotations

import random

from kraken_tpu_torch.core.digest import Digest
from kraken_tpu_torch.core.hasher import CPUPieceHasher
from kraken_tpu_torch.core.metainfo import MetaInfo
from kraken_tpu_torch.core.peer import PeerID, PeerInfo


def blob_fixture(size: int, seed: int | None = None) -> bytes:
    rng = random.Random(seed)
    return rng.randbytes(size)


def digest_fixture(seed: int | None = None) -> Digest:
    return Digest.from_bytes(blob_fixture(64, seed))


def metainfo_fixture(
    blob: bytes, piece_length: int = 4 * 1024
) -> MetaInfo:
    hashes = CPUPieceHasher().hash_pieces(blob, piece_length)
    return MetaInfo(
        digest=Digest.from_bytes(blob),
        length=len(blob),
        piece_length=piece_length,
        piece_hashes=hashes.tobytes(),
    )


def blob_and_metainfo_fixture(
    size: int = 256 * 1024, piece_length: int = 4 * 1024, seed: int | None = None
) -> tuple[bytes, MetaInfo]:
    blob = blob_fixture(size, seed)
    return blob, metainfo_fixture(blob, piece_length)


def peer_id_fixture(seed: int | None = None) -> PeerID:
    rng = random.Random(seed)
    return PeerID(rng.randbytes(20).hex())


def peer_info_fixture(port: int = 0, seed: int | None = None, **kw) -> PeerInfo:
    rng = random.Random(seed)
    return PeerInfo(
        peer_id=peer_id_fixture(seed),
        ip="127.0.0.1",
        port=port or rng.randint(10000, 60000),
        **kw,
    )
