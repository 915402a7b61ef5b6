"""Core vocabulary types shared by every layer."""

from kraken_tpu_torch.core.digest import Digest, Digester, DigestError
from kraken_tpu_torch.core.hasher import CPUPieceHasher, PieceHasher, get_hasher
from kraken_tpu_torch.core.metainfo import InfoHash, MetaInfo, MetaInfoError

__all__ = [
    "Digest",
    "Digester",
    "DigestError",
    "MetaInfo",
    "InfoHash",
    "MetaInfoError",
    "PieceHasher",
    "CPUPieceHasher",
    "get_hasher",
]
