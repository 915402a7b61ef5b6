"""Local storage plane: content-addressable store and typed metadata."""

from kraken_tpu_torch.store.castore import (
    CAStore,
    DigestMismatchError,
    FileExistsInCacheError,
    UploadNotFoundError,
)
from kraken_tpu_torch.store.metadata import (
    ChunkManifestMetadata,
    Metadata,
    PieceStatusMetadata,
    register_metadata,
)

__all__ = [
    "CAStore",
    "ChunkManifestMetadata",
    "DigestMismatchError",
    "FileExistsInCacheError",
    "UploadNotFoundError",
    "Metadata",
    "PieceStatusMetadata",
    "register_metadata",
]
