"""ImageTransferer: the seam between registry semantics and blob movement.

Mirrors uber/kraken ``lib/dockerregistry/transfer`` (``ReadOnlyTransferer``
for agents: blobs via scheduler.Download, tags via build-index;
``ProxyTransferer`` for the proxy: blobs via origin cluster client, tag
put + replicate) -- upstream path, unverified; SURVEY.md SS2.4.

The port's copy of ``kraken_tpu.dockerregistry.transfer``.
"""

from __future__ import annotations

import asyncio
import contextlib
import os
import tempfile
import uuid as uuidlib
from typing import Optional, Protocol

from kraken_tpu_torch.buildindex.server import TagClient
from kraken_tpu_torch.core.digest import Digest
from kraken_tpu_torch.origin.client import ClusterClient
from kraken_tpu_torch.p2p.scheduler import Scheduler
from kraken_tpu_torch.store import CAStore
from kraken_tpu_torch.utils import httputil
from kraken_tpu_torch.utils.dedup import TTLCache


class ImageTransferer(Protocol):
    # ``download``/``upload`` buffer whole bodies: manifests only (KBs).
    async def download(self, namespace: str, d: Digest) -> bytes: ...
    async def upload(self, namespace: str, d: Digest, data: bytes) -> None: ...
    # Blob movement is file-based so the registry never holds a layer in RAM.
    async def stat(self, namespace: str, d: Digest) -> Optional[int]: ...
    async def download_path(
        self, namespace: str, d: Digest
    ) -> tuple[str, bool]: ...
    async def upload_file(
        self, namespace: str, d: Digest, path: str
    ) -> None: ...
    async def mount(self, source: str, target: str, d: Digest) -> bool: ...
    async def get_tag(self, tag: str) -> Optional[Digest]: ...
    async def put_tag(self, tag: str, d: Digest) -> None: ...
    async def list_repo_tags(self, repo: str) -> list[str]: ...
    async def list_all_tags(self) -> list[str]: ...


class ReadOnlyTransferer:
    """Agent-side: pulls ride the swarm; pushes are rejected."""

    def __init__(
        self, store: CAStore, scheduler: Scheduler, tags: TagClient,
        tag_cache_ttl: float = 0.0,
    ):
        self.store = store
        self.scheduler = scheduler
        self.tags = tags
        # Positive-only tag cache: the node-local dockerd re-resolves the
        # same tag on every pull. Misses are NOT cached -- a tag pushed a
        # moment ago must appear on the next request. Default is OFF
        # (ttl=0): with mutable tags a positive cache serves a re-pointed
        # tag's old digest for up to the TTL. Turn it on (agent YAML
        # tag_cache_ttl) only when the build-index declares immutable_tags.
        self._tag_cache: TTLCache[Digest] | None = (
            TTLCache(tag_cache_ttl, max_entries=4096)
            if tag_cache_ttl > 0 else None
        )

    async def _ensure_local(self, namespace: str, d: Digest) -> None:
        if not self.store.in_cache(d):
            await self.scheduler.download(namespace, d)

    async def download(self, namespace: str, d: Digest) -> bytes:
        await self._ensure_local(namespace, d)
        return await asyncio.to_thread(self.store.read_cache_file, d)

    async def stat(self, namespace: str, d: Digest) -> Optional[int]:
        await self._ensure_local(namespace, d)
        return self.store.cache_size(d)

    async def download_path(
        self, namespace: str, d: Digest
    ) -> tuple[str, bool]:
        """(cache path, is_temp=False): blobs stream straight off the
        CAStore. A CHUNK-backed blob (store/chunkstore.py) has no flat
        path to hand to FileResponse -- export a temp flat copy and
        return it as is_temp=True, which the registry's streaming
        branch serves with Range support and unlinks afterwards."""
        await self._ensure_local(namespace, d)
        path = self.store.cache_path(d)
        if os.path.exists(path):
            return path, False
        fd, tmp = tempfile.mkstemp(prefix="kraken-registry-")
        os.close(fd)
        try:
            await asyncio.to_thread(self.store.export_to_file, d, tmp)
        except Exception:
            with contextlib.suppress(OSError):
                os.unlink(tmp)
            raise
        return tmp, True

    async def upload(self, namespace: str, d: Digest, data: bytes) -> None:
        raise PermissionError("agent registry is read-only; push via the proxy")

    async def upload_file(self, namespace: str, d: Digest, path: str) -> None:
        raise PermissionError("agent registry is read-only; push via the proxy")

    async def mount(self, source: str, target: str, d: Digest) -> bool:
        raise PermissionError("agent registry is read-only; push via the proxy")

    async def get_tag(self, tag: str) -> Optional[Digest]:
        # None means PROVEN absent (build-index said 404). A transient
        # build-index failure propagates so the registry surface can
        # answer a retryable 5xx instead of a definitive MANIFEST_UNKNOWN.
        if self._tag_cache is not None:
            cached = self._tag_cache.get(tag)
            if cached is not None:
                return cached
        try:
            d = await self.tags.get(tag)
        except Exception as e:
            if httputil.is_not_found(e):
                return None
            raise
        if d is not None and self._tag_cache is not None:
            self._tag_cache.put(tag, d)
        return d

    async def put_tag(self, tag: str, d: Digest) -> None:
        raise PermissionError("agent registry is read-only; push via the proxy")

    async def list_repo_tags(self, repo: str) -> list[str]:
        return await self.tags.list_repo(repo)

    async def list_all_tags(self) -> list[str]:
        return await self.tags.list_all()


class ProxyTransferer:
    """Proxy-side: pushes fan blobs to the origin replica set and tags to
    the build-index (with cross-cluster replication)."""

    def __init__(
        self, origins: ClusterClient, tags: TagClient,
        spool_dir: str | None = None,
    ):
        self.origins = origins
        self.tags = tags
        # Pass-through blob reads spool here (deleted after each response).
        self._spool = spool_dir or tempfile.mkdtemp(prefix="kt-proxy-spool-")
        os.makedirs(self._spool, exist_ok=True)

    async def download(self, namespace: str, d: Digest) -> bytes:
        return await self.origins.download(namespace, d)

    async def stat(self, namespace: str, d: Digest) -> Optional[int]:
        info = await self.origins.stat(namespace, d)
        return None if info is None else info.size

    async def download_path(
        self, namespace: str, d: Digest
    ) -> tuple[str, bool]:
        """(spooled temp path, is_temp=True): caller deletes after use."""
        dest = os.path.join(self._spool, f"{d.hex}.{uuidlib.uuid4().hex}")
        await self.origins.download_to_file(namespace, d, dest)
        return dest, True

    async def mount(self, source: str, target: str, d: Digest) -> bool:
        """Cross-repo blob mount: blobs are content-addressed, so the
        origin just adopts the existing bytes into the target namespace
        (durable: namespace sidecar + writeback, with backend read-through
        from the source if the cache evicted them). False = not found
        anywhere; the registry falls back to a normal upload session."""
        return await self.origins.adopt(target, d, source)

    async def upload(self, namespace: str, d: Digest, data: bytes) -> None:
        await self.origins.upload(namespace, d, data)

    async def upload_file(self, namespace: str, d: Digest, path: str) -> None:
        await self.origins.upload_from_file(namespace, d, path)

    async def get_tag(self, tag: str) -> Optional[Digest]:
        # None means PROVEN absent (build-index said 404). A transient
        # build-index failure propagates so the registry surface can
        # answer a retryable 5xx instead of a definitive MANIFEST_UNKNOWN.
        try:
            return await self.tags.get(tag)
        except Exception as e:
            if httputil.is_not_found(e):
                return None
            raise

    async def put_tag(self, tag: str, d: Digest) -> None:
        await self.tags.put(tag, d, replicate=True)

    async def list_repo_tags(self, repo: str) -> list[str]:
        return await self.tags.list_repo(repo)

    async def list_all_tags(self) -> list[str]:
        return await self.tags.list_all()
