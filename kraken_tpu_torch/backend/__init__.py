"""Pluggable storage backends: the port's copy of ``kraken_tpu.backend``.

A ``Manager`` resolves a namespace (by regex) to a backend client; the
origin writes committed blobs back through it and fills cache misses from
it. The port registers ``file`` and ``testfs``. The reference's other
backends (``http``, ``shadow``, ``s3``, ``gcs``, ``hdfs``,
``registry_blob``, ``registry_tag``) are not ported yet (ROADMAP A7h):
``make_backend`` of one of their names raises ``ValueError`` naming A7h.
"""

from kraken_tpu_torch.backend.base import (
    BackendClient,
    BackendError,
    BlobNotFoundError,
    Manager,
    make_backend,
    register_backend,
)

__all__ = [
    "BackendClient",
    "BackendError",
    "BlobNotFoundError",
    "Manager",
    "make_backend",
    "register_backend",
]

# Import for registration side effects.
import kraken_tpu_torch.backend.filebackend  # noqa: E402,F401
import kraken_tpu_torch.backend.testfs  # noqa: E402,F401
