"""Backend interface, registry, and the namespace->client manager: the
port's copy of ``kraken_tpu.backend.base``."""

from __future__ import annotations

import asyncio
import os
import re
from typing import Callable, Dict, Optional

from kraken_tpu_torch.utils.bandwidth import TokenBucket


class BackendError(Exception):
    pass


class BlobNotFoundError(BackendError):
    """Named blob absent in the backend."""


class BlobInfo:
    __slots__ = ("size",)

    def __init__(self, size: int):
        self.size = size


class BackendClient:
    """Async client for one remote store.

    Names are backend-relative paths (the pather in
    :mod:`kraken_tpu_torch.backend.namepath` maps digests/tags to them).
    """

    async def stat(self, namespace: str, name: str) -> BlobInfo:
        raise NotImplementedError

    async def download(self, namespace: str, name: str) -> bytes:
        raise NotImplementedError

    async def upload(self, namespace: str, name: str, data: bytes) -> None:
        raise NotImplementedError

    async def upload_file(self, namespace: str, name: str, path: str) -> None:
        """Upload from a local file. Default: buffer + :meth:`upload`
        (correct for all backends; memory-bound for multi-GB blobs).
        Backends with a streaming/multipart story override this -- the
        writeback plane always calls THIS, so overriding is sufficient."""

        def _read() -> bytes:
            with open(path, "rb") as f:
                return f.read()

        data = await asyncio.to_thread(_read)
        await self.upload(namespace, name, data)

    async def download_to_file(
        self, namespace: str, name: str, dest_path: str
    ) -> int:
        """Download into a local file; returns byte count. Default:
        :meth:`download` + write (memory-bound); streaming backends
        override."""
        data = await self.download(namespace, name)

        def _write() -> None:
            with open(dest_path, "wb") as f:
                f.write(data)

        await asyncio.to_thread(_write)
        return len(data)

    async def list(self, prefix: str) -> list[str]:
        raise NotImplementedError

    async def close(self) -> None:
        pass


_REGISTRY: Dict[str, Callable[[dict], BackendClient]] = {}

# The reference's backends that the port has not ported yet (ROADMAP A7h).
UNPORTED_BACKENDS = frozenset({
    "gcs", "hdfs", "http", "registry_blob", "registry_tag", "s3", "shadow",
})


def register_backend(name: str):
    """Decorator: register a backend factory under ``name`` (the YAML
    ``backend:`` key, same plugin pattern as the hasher registry)."""

    def deco(factory: Callable[[dict], BackendClient]):
        _REGISTRY[name] = factory
        return factory

    return deco


def make_backend(name: str, config: dict | None = None) -> BackendClient:
    if name in UNPORTED_BACKENDS and name not in _REGISTRY:
        raise ValueError(
            f"backend {name!r} is not ported yet (ROADMAP A7h); the port "
            f"has: {sorted(_REGISTRY)}"
        )
    try:
        factory = _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown backend {name!r}; registered: {sorted(_REGISTRY)}"
        ) from None
    return factory(config or {})


class _ThrottledClient(BackendClient):
    """Wraps a client with ingress/egress token buckets (bytes/sec)."""

    def __init__(self, inner: BackendClient, ingress_bps: float, egress_bps: float):
        self._inner = inner
        self._ingress = TokenBucket(ingress_bps)
        self._egress = TokenBucket(egress_bps)

    async def stat(self, namespace: str, name: str) -> BlobInfo:
        return await self._inner.stat(namespace, name)

    async def download(self, namespace: str, name: str) -> bytes:
        data = await self._inner.download(namespace, name)
        await self._ingress.acquire(len(data))
        return data

    async def upload(self, namespace: str, name: str, data: bytes) -> None:
        await self._egress.acquire(len(data))
        await self._inner.upload(namespace, name, data)

    async def upload_file(self, namespace: str, name: str, path: str) -> None:
        size = await asyncio.to_thread(os.path.getsize, path)
        await self._egress.acquire(size)
        await self._inner.upload_file(namespace, name, path)

    async def download_to_file(
        self, namespace: str, name: str, dest_path: str
    ) -> int:
        n = await self._inner.download_to_file(namespace, name, dest_path)
        await self._ingress.acquire(n)
        return n

    async def list(self, prefix: str) -> list[str]:
        return await self._inner.list(prefix)

    async def close(self) -> None:
        await self._inner.close()


class Manager:
    """Resolves a namespace to its backend client.

    Config shape (YAML-mirrored):

        backends:
          - namespace: "library/.*"
            backend: testfs
            config: {addr: "localhost:9000"}
            bandwidth: {ingress_bps: 0, egress_bps: 0}

    First matching entry wins, as in the reference.
    """

    def __init__(self, entries: list[dict] | None = None):
        self._entries: list[tuple[re.Pattern, BackendClient]] = []
        for e in entries or []:
            client = make_backend(e["backend"], e.get("config"))
            bw = e.get("bandwidth") or {}
            if bw.get("ingress_bps") or bw.get("egress_bps"):
                client = _ThrottledClient(
                    client, bw.get("ingress_bps", 0), bw.get("egress_bps", 0)
                )
            self.register(e["namespace"], client)

    def register(self, namespace_pattern: str, client: BackendClient) -> None:
        self._entries.append((re.compile(namespace_pattern + r"\Z"), client))

    def get_client(self, namespace: str) -> BackendClient:
        for pattern, client in self._entries:
            if pattern.match(namespace):
                return client
        raise KeyError(f"no backend configured for namespace {namespace!r}")

    def try_get_client(self, namespace: str) -> Optional[BackendClient]:
        try:
            return self.get_client(namespace)
        except KeyError:
            return None

    async def close(self) -> None:
        for _p, c in self._entries:
            await c.close()
