"""Shadow backend: writes to two backends, reads from the primary.

The port's copy of ``kraken_tpu.backend.shadowbackend``.

Mirrors uber/kraken ``lib/backend/shadowbackend`` (migration aid: dual-write
while moving between stores) -- upstream path, unverified; SURVEY.md SS2.3.
"""

from __future__ import annotations

from kraken_tpu_torch.backend.base import (
    BackendClient,
    BlobInfo,
    BlobNotFoundError,
    make_backend,
    register_backend,
)


@register_backend("shadow")
class ShadowBackend(BackendClient):
    """config: ``{"primary": {"backend": ..., "config": ...},
    "shadow": {...}}``."""

    def __init__(self, config: dict):
        p, s = config["primary"], config["shadow"]
        self._primary = make_backend(p["backend"], p.get("config"))
        self._shadow = make_backend(s["backend"], s.get("config"))

    async def stat(self, namespace: str, name: str) -> BlobInfo:
        return await self._primary.stat(namespace, name)

    async def download(self, namespace: str, name: str) -> bytes:
        try:
            return await self._primary.download(namespace, name)
        except BlobNotFoundError:
            return await self._shadow.download(namespace, name)

    async def upload(self, namespace: str, name: str, data: bytes) -> None:
        await self._primary.upload(namespace, name, data)
        await self._shadow.upload(namespace, name, data)

    async def list(self, prefix: str) -> list[str]:
        return await self._primary.list(prefix)

    async def close(self) -> None:
        await self._primary.close()
        await self._shadow.close()
