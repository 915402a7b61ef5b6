"""Local storage plane: content-addressable store and typed metadata."""

from kraken_tpu_torch.store.castore import (
    CAStore,
    DigestMismatchError,
    FileExistsInCacheError,
    UploadNotFoundError,
)
from kraken_tpu_torch.store.metadata import (
    Metadata,
    PieceStatusMetadata,
    register_metadata,
)

__all__ = [
    "CAStore",
    "DigestMismatchError",
    "FileExistsInCacheError",
    "UploadNotFoundError",
    "Metadata",
    "PieceStatusMetadata",
    "register_metadata",
]
