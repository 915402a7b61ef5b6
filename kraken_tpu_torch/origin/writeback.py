"""Async writeback: committed blobs flow origin -> backend durably.

Mirrors uber/kraken ``lib/persistedretry/writeback`` (a persistedretry task
type uploading committed blobs to the remote backend; the blob is marked
persist-exempt from eviction until it lands) -- upstream path, unverified;
SURVEY.md SS2.3/SS3.2. The port's copy of ``kraken_tpu.origin.writeback``.
"""

from __future__ import annotations

import asyncio
import os

from kraken_tpu_torch.backend import Manager as BackendManager
from kraken_tpu_torch.core.digest import Digest
from kraken_tpu_torch.persistedretry import Manager as RetryManager, Task
from kraken_tpu_torch.store import CAStore
from kraken_tpu_torch.store.metadata import pin, unpin

KIND = "writeback"


class WritebackExecutor:
    """Registers the ``writeback`` task kind on a retry manager."""

    def __init__(
        self,
        store: CAStore,
        backends: BackendManager,
        retry: RetryManager,
    ):
        self.store = store
        self.backends = backends
        self.retry = retry
        retry.register(KIND, self._execute)
        # Earlier builds keyed tasks '{namespace}:{hex}'; rewrite any such
        # persisted rows so the digest-first prefix scan in _execute sees
        # them (a missed row releases the eviction pin too early).
        retry.store.canonicalize_keys(
            KIND, lambda p: f"{p['digest']}:{p['namespace']}"
        )

    def enqueue(self, namespace: str, d: Digest) -> None:
        """Queue a blob for backend upload; pin it against eviction."""
        if self.backends.try_get_client(namespace) is None:
            return  # namespace has no durable backend configured
        pin(self.store, d, KIND)
        # Digest-first key: the unpin logic prefix-scans for other pending
        # writebacks of the same blob (a cross-repo mount enqueues a second
        # namespace's writeback for the same bytes).
        self.retry.add(
            Task(kind=KIND, key=f"{d.hex}:{namespace}",
                 payload={"namespace": namespace, "digest": d.hex})
        )

    async def _execute(self, task: Task) -> None:
        namespace = task.payload["namespace"]
        d = Digest.from_hex(task.payload["digest"])
        client = self.backends.get_client(namespace)
        # File-based: backends stream/multipart it (S3), or buffer via the
        # base-class default; either way writeback never holds a layer in
        # RAM itself. The backend owns pathing. A chunk-backed blob has
        # no flat path to hand over -- materialize a temporary flat copy
        # in the upload spool (the export escape hatch), upload, drop it.
        path = self.store.cache_path(d)
        uploaded = False
        if os.path.exists(path):
            try:
                await client.upload_file(namespace, d.hex, path)
                uploaded = True
            except FileNotFoundError:
                # A chunk-tier conversion unlinked the flat file between
                # the check and the backend's open: fall through to the
                # export path -- the bytes are fully readable.
                pass
        if not uploaded:
            uid = self.store.create_upload()
            tmp = self.store.upload_path(uid)
            try:
                await asyncio.to_thread(self.store.export_to_file, d, tmp)
                await client.upload_file(namespace, d.hex, tmp)
            finally:
                self.store.abort_upload(uid)
        # Landed durably: drop the writeback pin -- but only once no OTHER
        # pending writeback references this blob (the pin is a reason-set,
        # not a counter: the first namespace's writeback landing must not
        # expose the bytes to eviction while a second namespace's -- from
        # a cross-repo mount -- is still queued). The current task counts
        # until the retry manager marks it done, hence <= 1.
        if self.retry.store.count_pending(KIND, f"{d.hex}:") <= 1:
            unpin(self.store, d, KIND)
