"""Pluggable storage backends: the port's copy of ``kraken_tpu.backend``.

A ``Manager`` resolves a namespace (by regex) to a backend client; the
origin writes committed blobs back through it and fills cache misses from
it; build-index persists tags through it. The port registers the
reference's names: ``file``, ``testfs``, ``http``, ``shadow``, ``s3``,
``gcs`` (S3's client on GCS's interoperable API), ``hdfs`` (WebHDFS),
``registry_blob`` and ``registry_tag`` (pull-through from an upstream
docker registry).
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
import kraken_tpu_torch.backend.httpbackend  # noqa: E402,F401
import kraken_tpu_torch.backend.testfs  # noqa: E402,F401
import kraken_tpu_torch.backend.shadowbackend  # noqa: E402,F401
import kraken_tpu_torch.backend.s3backend  # noqa: E402,F401  (also: gcs)
import kraken_tpu_torch.backend.hdfsbackend  # noqa: E402,F401
import kraken_tpu_torch.backend.registrybackend  # noqa: E402,F401
