"""Local-filesystem backend: the simplest durable store (the port's copy
of ``kraken_tpu.backend.filebackend``, the same layout under its root).

No direct reference analog (the reference's closest is testfs); used for
single-host deployments and as the default herd backend when no object
store exists.
"""

from __future__ import annotations

import asyncio
import os
import uuid

from kraken_tpu_torch.backend.base import (
    BackendClient,
    BlobInfo,
    BlobNotFoundError,
    register_backend,
)
from kraken_tpu_torch.backend.namepath import get_pather
from kraken_tpu_torch.utils import failpoints


@register_backend("file")
class FileBackend(BackendClient):
    def __init__(self, config: dict):
        self.root = config["root"]
        self._pather = get_pather(config.get("pather", "identity"))
        os.makedirs(self.root, exist_ok=True)

    def _path(self, name: str) -> str:
        return os.path.join(self.root, self._pather("", name))

    async def stat(self, namespace: str, name: str) -> BlobInfo:
        try:
            return BlobInfo(os.path.getsize(self._path(name)))
        except FileNotFoundError:
            raise BlobNotFoundError(name) from None

    async def download(self, namespace: str, name: str) -> bytes:
        # Failpoint backend.file.download: a flaky durable store --
        # blobrefresh/writeback retry planes must surface and retry it,
        # never translate it into "not found".
        if failpoints.fire("backend.file.download"):
            import errno

            raise OSError(errno.EIO, "failpoint backend.file.download", name)
        def _read() -> bytes:
            with open(self._path(name), "rb") as f:
                return f.read()

        try:
            # Whole-blob disk read off the event loop: backends serve
            # read-through misses mid-pull, and a multi-MB sync read
            # here parks every conn pump in the process.
            return await asyncio.to_thread(_read)
        except FileNotFoundError:
            raise BlobNotFoundError(name) from None

    async def upload(self, namespace: str, name: str, data: bytes) -> None:
        if failpoints.fire("backend.file.upload"):
            import errno

            raise OSError(errno.ENOSPC, "failpoint backend.file.upload", name)
        path = self._path(name)

        def _write() -> None:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            # Unique tmp per call: now that writes run off-loop they can
            # interleave, and two same-name uploads sharing one ".tmp"
            # would race replace() into a spurious FileNotFoundError.
            tmp = f"{path}.tmp.{uuid.uuid4().hex[:8]}"
            try:
                with open(tmp, "wb") as f:
                    f.write(data)
                os.replace(tmp, path)
            except BaseException:
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
                raise

        await asyncio.to_thread(_write)

    async def list(self, prefix: str) -> list[str]:
        out = []
        for dirpath, _dirs, files in os.walk(self.root):
            for fn in files:
                rel = os.path.relpath(os.path.join(dirpath, fn), self.root)
                rel = rel.replace(os.sep, "/")
                if rel.startswith(prefix):
                    out.append(rel)
        return sorted(out)
