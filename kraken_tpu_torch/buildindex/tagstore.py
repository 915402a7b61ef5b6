"""Tag persistence: local disk + async backend writeback.

Mirrors uber/kraken ``build-index/tagstore`` (disk cache, writeback via
persistedretry) -- upstream path, unverified; SURVEY.md SS2.4. A tag is a
``repo:tag`` name mapping to a manifest digest.

The port's copy of ``kraken_tpu.buildindex.tagstore``: one file a tag,
named by the tag quoted with ``safe=""`` and holding the digest's string,
so each package reads the other's tags; writeback through the port's
``backend.Manager`` and ``persistedretry``.
"""

from __future__ import annotations

import asyncio
import os
import urllib.parse
from typing import Optional

from kraken_tpu_torch.backend import BlobNotFoundError, Manager as BackendManager
from kraken_tpu_torch.core.digest import Digest
from kraken_tpu_torch.persistedretry import Manager as RetryManager, Task

WRITEBACK_KIND = "tag_writeback"


class _BackendUnavailable(Exception):
    """Transient backend failure during a read-through (NOT proven-absent).

    get() degrades it to None; get_strict propagates it so the
    immutability check can answer a retryable 503."""


class TagStore:
    def __init__(
        self,
        root: str,
        backends: BackendManager | None = None,
        retry: RetryManager | None = None,
    ):
        self.root = root
        os.makedirs(root, exist_ok=True)
        self.backends = backends
        self.retry = retry
        if retry is not None and backends is not None:
            retry.register(WRITEBACK_KIND, self._execute_writeback)

    def _path(self, tag: str) -> str:
        return os.path.join(self.root, urllib.parse.quote(tag, safe=""))

    # -- local disk --------------------------------------------------------

    def put_local(self, tag: str, d: Digest) -> None:
        path = self._path(tag)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            f.write(str(d))
        os.replace(tmp, path)

    def get_local(self, tag: str) -> Optional[Digest]:
        try:
            with open(self._path(tag)) as f:
                return Digest.parse(f.read().strip())
        except FileNotFoundError:
            return None

    def list_local(self, prefix: str = "") -> list[str]:
        tags = [urllib.parse.unquote(n) for n in os.listdir(self.root)
                if not n.endswith(".tmp")]
        return sorted(t for t in tags if t.startswith(prefix))

    # -- backend-aware ops -------------------------------------------------

    async def put(self, tag: str, d: Digest, namespace: str = "") -> None:
        """Write locally, then queue durable backend writeback."""
        await asyncio.to_thread(self.put_local, tag, d)
        if self.retry is not None and self.backends is not None:
            if self.backends.try_get_client(namespace or tag) is not None:
                self.retry.add(
                    Task(kind=WRITEBACK_KIND, key=tag,
                         payload={"tag": tag, "namespace": namespace or tag})
                )

    async def get(self, tag: str, namespace: str = "") -> Optional[Digest]:
        """Local first; on miss, fall through to the backend and cache.

        A backend OUTAGE degrades to None (reads are best-effort), but a
        corrupt backend payload (Digest.parse) still raises: a tag that
        exists-but-is-broken must surface as a 5xx, not a definitive
        'tag not found'."""
        try:
            return await self.get_strict(tag, namespace)
        except _BackendUnavailable:
            return None

    async def get_strict(self, tag: str, namespace: str = "") -> Optional[Digest]:
        """Like get(), but only a *proven-absent* tag returns None.

        A backend outage raises instead of returning None, so callers that
        need the distinction (the immutable-tags check) don't fail open:
        a build-index on a fresh volume must not accept a re-point just
        because the backend that holds the truth is temporarily down."""
        local = await asyncio.to_thread(self.get_local, tag)
        if local is not None:
            return local
        if self.backends is None:
            return None
        client = self.backends.try_get_client(namespace or tag)
        if client is None:
            return None
        try:
            raw = await client.download(namespace or tag, tag)
        except BlobNotFoundError:
            return None
        except Exception as e:
            raise _BackendUnavailable(str(e)) from e
        d = Digest.parse(raw.decode().strip())
        try:
            await asyncio.to_thread(self.put_local, tag, d)
        except OSError:
            # Cache write is best-effort: a full/read-only volume must
            # not turn a successfully fetched tag into an error.
            pass
        return d

    async def _execute_writeback(self, task: Task) -> None:
        tag = task.payload["tag"]
        ns = task.payload["namespace"]
        d = self.get_local(tag)
        if d is None:
            return
        client = self.backends.get_client(ns)
        await client.upload(ns, tag, str(d).encode())
