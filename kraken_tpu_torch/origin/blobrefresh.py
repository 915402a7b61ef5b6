"""Blob refresh: fill origin cache misses from the remote backend.

Mirrors uber/kraken ``lib/blobrefresh`` (``Refresher``: on miss, pull
backend -> CAStore, then regenerate metainfo) -- upstream path, unverified;
SURVEY.md SS2.3/SS3.5. Requests coalesce so a miss storm pulls once.
The port's copy of ``kraken_tpu.origin.blobrefresh``: the metainfo of a
pulled blob is made by the origin's generator, on the card for a ``cuda``
hasher.
"""

from __future__ import annotations

import asyncio

from kraken_tpu_torch.backend import BlobNotFoundError, Manager
from kraken_tpu_torch.core.digest import Digest
from kraken_tpu_torch.origin.metainfogen import Generator
from kraken_tpu_torch.store import CAStore
from kraken_tpu_torch.store.castore import DigestMismatchError, FileExistsInCacheError
from kraken_tpu_torch.utils.dedup import RequestCoalescer
from kraken_tpu_torch.utils.metrics import REGISTRY


class Refresher:
    def __init__(
        self,
        store: CAStore,
        backends: Manager,
        generator: Generator,
    ):
        self.store = store
        self.backends = backends
        self.generator = generator
        self._coalescer: RequestCoalescer = RequestCoalescer()

    async def refresh(self, namespace: str, d: Digest) -> None:
        """Ensure blob ``d`` is cached locally (pulling from the backend if
        needed) with metainfo generated. Raises
        :class:`~kraken_tpu_torch.backend.BlobNotFoundError` when the backend
        doesn't have it either."""
        if self.store.in_cache(d):
            await self.generator.generate(d)
            return
        await self._coalescer.get(d.hex, lambda: self._pull(namespace, d))

    async def stat(self, namespace: str, d: Digest):
        """Cheap durable-existence check: backend stat WITHOUT restoring
        the bytes. Raises BlobNotFoundError on a true miss (including "no
        backend for this namespace"); transient backend failures propagate
        so callers can distinguish "not there" from "can't tell"."""
        client = self.backends.try_get_client(namespace)
        if client is None:
            raise BlobNotFoundError(f"no backend for namespace {namespace!r}")
        return await client.stat(namespace, d.hex)

    async def _pull(self, namespace: str, d: Digest) -> None:
        client = self.backends.try_get_client(namespace)
        if client is None:
            raise BlobNotFoundError(f"no backend for namespace {namespace!r}")
        # Logical name only: each backend owns its physical layout
        # (pather) -- see backend/namepath.py. The bytes stream
        # backend -> upload area -> verified atomic commit: a restored
        # multi-GB layer never transits RAM whole.
        uid = self.store.create_upload()
        try:
            await client.download_to_file(
                namespace, d.hex, self.store.upload_path(uid)
            )
            try:
                await asyncio.to_thread(self.store.commit_upload, uid, d)
            except FileExistsInCacheError:
                pass  # a concurrent path restored it; ours was redundant
            except DigestMismatchError as e:
                # The heal plane leans on this read-through as its last
                # resort; a backend serving wrong bytes must be visibly
                # distinct from a backend miss on /metrics.
                REGISTRY.counter(
                    "blob_refresh_pulls_total",
                    "Backend read-through pulls by result",
                ).inc(result="corrupt")
                raise BlobNotFoundError(
                    f"backend returned corrupt blob: {e}"
                ) from None
        except BaseException:
            self.store.abort_upload(uid)
            raise
        REGISTRY.counter(
            "blob_refresh_pulls_total",
            "Backend read-through pulls by result",
        ).inc(result="ok")
        await self.generator.generate(d)
