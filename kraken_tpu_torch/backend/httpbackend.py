"""Read-only HTTP(S) backend: GET blobs from an arbitrary URL template.

The port's copy of ``kraken_tpu.backend.httpbackend``.

Mirrors uber/kraken ``lib/backend/httpbackend`` (download-only backend
against plain HTTP endpoints) -- upstream path, unverified; SURVEY.md SS2.3.
"""

from __future__ import annotations

from kraken_tpu_torch.backend.base import (
    BackendClient,
    BackendError,
    BlobInfo,
    BlobNotFoundError,
    register_backend,
)
from kraken_tpu_torch.utils.httputil import HTTPClient, HTTPError


@register_backend("http")
class HTTPBackend(BackendClient):
    """config: ``{"download_url": "http://host/blobs/%s"}`` -- %s <- name."""

    def __init__(self, config: dict):
        self.download_url = config["download_url"]
        self._http = HTTPClient(retries=config.get("retries", 3))

    async def stat(self, namespace: str, name: str) -> BlobInfo:
        data = await self.download(namespace, name)
        return BlobInfo(len(data))

    async def download(self, namespace: str, name: str) -> bytes:
        try:
            return await self._http.get(self.download_url % name)
        except HTTPError as e:
            if e.status == 404:
                raise BlobNotFoundError(name) from None
            raise

    async def upload(self, namespace: str, name: str, data: bytes) -> None:
        raise BackendError("http backend is read-only")

    async def list(self, prefix: str) -> list[str]:
        raise BackendError("http backend does not support list")

    async def close(self) -> None:
        await self._http.close()
