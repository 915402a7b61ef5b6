"""Origin blob clients: single-node client + hashring-aware cluster client.

Mirrors uber/kraken ``origin/blobclient`` (``Client``, ``ClusterClient``
resolving ``hashring.Locations(d)`` and retrying across replicas; used by
proxy, tracker, build-index, and other origins) -- upstream path,
unverified; SURVEY.md SS2.4. The port's copy of ``kraken_tpu.origin.client``,
over the port's ``utils/httputil`` (itself on ``utils/http_lite``).
``get_recipe`` and ``similar`` stay because the tracker proxies them; the
port's origin does not serve those routes yet (ROADMAP A7f) and answers
404, as the reference's does with its dedup index off.
"""

from __future__ import annotations

import asyncio
from typing import Callable, Optional

from kraken_tpu_torch.core.digest import Digest
from kraken_tpu_torch.core.metainfo import MetaInfo
from kraken_tpu_torch.core.peer import BlobInfo
from kraken_tpu_torch.placement.hashring import Ring
from kraken_tpu_torch.placement.replicawalk import _RAISE, walk_replicas
from urllib.parse import quote

from kraken_tpu_torch.utils.backoff import DecorrelatedJitter
from kraken_tpu_torch.utils.deadline import Deadline
from kraken_tpu_torch.utils.httputil import HTTPClient, HTTPError, base_url


class BlobClient:
    """HTTP client for one origin."""

    # Bounded resume: enough round-trips to ride out an origin restart
    # (crash -> supervisor respawn -> fsck -> listen) without turning a
    # permanently dead origin into an unbounded retry loop -- the
    # ClusterClient's replica walk is the next line of defense.
    RESUME_ATTEMPTS = 4

    def __init__(
        self, addr: str, http: HTTPClient | None = None, resume: bool = True
    ):
        self.addr = addr
        self._http = http or HTTPClient()
        # Resume-on-failure for chunked uploads: on a transport error,
        # exhausted 5xx, or offset conflict, HEAD the upload URL for the
        # origin's durable offset and re-PATCH only the tail. Off =
        # legacy fail-fast (one shot per replica).
        self.resume = resume
        self._backoff = DecorrelatedJitter(0.2, 5.0)

    def _url(self, path: str) -> str:
        return f"{base_url(self.addr)}{path}"

    async def stat(
        self, namespace: str, d: Digest, local_only: bool = False,
        deadline: Deadline | None = None,
    ) -> Optional[BlobInfo]:
        """``local_only`` asks "do YOU cache the bytes" (repair semantics)
        instead of "does the cluster durably have them"."""
        suffix = "?local=true" if local_only else ""
        try:
            body = await self._http.get(
                self._url(
                    f"/namespace/{quote(namespace, safe='')}/blobs/{d.hex}/stat{suffix}"
                ),
                retry_5xx=False,
                deadline=deadline,
            )
        except HTTPError as e:
            if e.status == 404:
                return None
            raise
        import json

        return BlobInfo.from_dict(json.loads(body))

    async def download(
        self, namespace: str, d: Digest, deadline: Deadline | None = None
    ) -> bytes:
        return await self._http.get(
            self._url(f"/namespace/{quote(namespace, safe='')}/blobs/{d.hex}"),
            deadline=deadline,
        )

    async def download_to_file(
        self, namespace: str, d: Digest, dest_path: str,
        deadline: Deadline | None = None,
    ) -> int:
        """Stream the blob to ``dest_path`` -- O(chunk) memory, any size."""
        return await self._http.get_to_file(
            self._url(f"/namespace/{quote(namespace, safe='')}/blobs/{d.hex}"),
            dest_path,
            deadline=deadline,
        )

    async def get_metainfo(
        self, namespace: str, d: Digest, deadline: Deadline | None = None
    ) -> MetaInfo:
        raw = await self._http.get(
            self._url(f"/namespace/{quote(namespace, safe='')}/blobs/{d.hex}/metainfo"),
            deadline=deadline,
        )
        return MetaInfo.deserialize(raw)

    async def get_recipe(
        self, namespace: str, d: Digest, deadline: Deadline | None = None
    ) -> tuple[bytes, str]:
        """The blob's serialized chunk recipe (delta-transfer plane) plus
        the addr that served it -- the tracker proxy stamps that addr on
        its response so agents know where byte-range fetches can go. 404s
        (delta disabled on the origin, blob gone) raise HTTPError."""
        raw = await self._http.get(
            self._url(
                f"/namespace/{quote(namespace, safe='')}/blobs/{d.hex}/recipe"
            ),
            retry_5xx=False,
            deadline=deadline,
        )
        return raw, self.addr

    async def similar(
        self, namespace: str, d: Digest, k: int = 10,
        deadline: Deadline | None = None,
    ) -> list[dict]:
        """Near-duplicate blobs of ``d`` from the origin's dedup index:
        [{"digest": hex, "score": estimated-Jaccard}], best first."""
        import json

        body = await self._http.get(
            self._url(
                f"/namespace/{quote(namespace, safe='')}/blobs/{d.hex}"
                f"/similar?k={k}"
            ),
            retry_5xx=False,
            deadline=deadline,
        )
        return json.loads(body)["similar"]

    async def adopt(self, namespace: str, d: Digest, source: str,
                    deadline: Deadline | None = None) -> None:
        """Cross-repo mount support: associate an existing blob with
        ``namespace`` (reads through from ``source`` if evicted)."""
        await self._http.post(
            self._url(
                f"/namespace/{quote(namespace, safe='')}/blobs/{d.hex}/adopt"
                f"?source={quote(source, safe='')}"
            ),
            ok_statuses=(201,),
            retry_5xx=False,
            deadline=deadline,
        )

    async def upload(self, namespace: str, d: Digest, data: bytes,
                     chunk_size: int = 16 * 1024 * 1024,
                     deadline: Deadline | None = None) -> None:
        """Chunked upload: start -> PATCH chunks -> commit. With resume
        on, a mid-stream failure re-queries the origin's durable offset
        (HEAD) and re-PATCHes only the tail."""
        import io

        def open_at(offset: int):
            f = io.BytesIO(data)
            f.seek(offset)
            return f

        await self._upload_resumable(
            namespace, d, open_at, chunk_size, deadline
        )

    async def upload_from_file(
        self, namespace: str, d: Digest, path: str,
        chunk_size: int = 16 * 1024 * 1024,
        deadline: Deadline | None = None,
    ) -> None:
        """Chunked upload streamed from a local file -- O(chunk) memory
        (replication and proxy pushes of arbitrarily large blobs)."""

        def open_at(offset: int):
            f = open(path, "rb")
            try:
                f.seek(offset)
            except OSError:
                f.close()
                raise
            return f

        await self._upload_resumable(
            namespace, d, open_at, chunk_size, deadline
        )

    async def upload_from_store(
        self, namespace: str, d: Digest, store,
        chunk_size: int = 16 * 1024 * 1024,
        deadline: Deadline | None = None,
    ) -> None:
        """Chunked upload streamed straight from a CAStore -- works for
        flat AND chunk-backed blobs (``open_cache_file`` composes the
        tier's reads), so replication of a manifest-backed blob never
        needs a flat copy on disk. O(chunk) memory either way."""

        def open_at(offset: int):
            f = store.open_cache_file(d)  # KeyError when absent
            try:
                f.seek(offset)
            except OSError:
                f.close()
                raise
            return f

        await self._upload_resumable(
            namespace, d, open_at, chunk_size, deadline
        )

    async def upload_from_opener(
        self, namespace: str, d: Digest, open_at,
        chunk_size: int = 16 * 1024 * 1024,
        deadline: Deadline | None = None,
    ) -> None:
        """Chunked upload from a caller-supplied ``open_at(offset) ->
        reader`` -- the source must be re-readable at any offset (resume
        rounds reopen). This is the primitive under upload/from_file/
        from_store; callers with source files that MOVE mid-stream (the
        origin's quorum push streams a blob whose spool file the
        concurrent local commit renames into the cache) supply an opener
        that falls back across both locations."""
        await self._upload_resumable(
            namespace, d, open_at, chunk_size, deadline
        )

    # -- resumable upload engine -------------------------------------------

    async def _upload_resumable(
        self, namespace: str, d: Digest, open_at, chunk_size: int,
        deadline: Deadline | None = None,
    ) -> None:
        """Start -> stream -> commit with resume-on-failure.

        ``open_at(offset)`` returns a (sync) reader positioned at
        ``offset`` -- sources must be re-readable, which bytes, files,
        and store blobs all are. Each recovery round HEADs the upload
        URL for the origin's durable offset (the journaled session on a
        restarted origin answers with what actually survived) and
        re-sends from there under decorrelated-jitter backoff. A 404
        from HEAD means the session is gone/unadoptable: ONE fresh
        session restart, then give up (the cluster client's replica
        fan-out is the next recourse)."""
        uid = await self._start_upload(namespace, d)
        attempts = 0
        restarted = False
        prev_sleep = 0.0
        offset = 0
        while True:
            try:
                await self._stream_from(
                    namespace, d, uid, open_at, offset, chunk_size
                )
                await self._commit_resumable(namespace, d, uid, attempts > 0)
                return
            except (HTTPError, OSError, asyncio.TimeoutError) as e:
                if not self.resume:
                    raise
                if isinstance(e, HTTPError) and e.status not in (409,) and \
                        e.status < 500:
                    raise  # 4xx (bad digest, unknown upload): not transient
                attempts += 1
                if attempts > self.RESUME_ATTEMPTS:
                    raise
                if deadline is not None and deadline.expired:
                    raise
                prev_sleep = self._backoff.next(prev_sleep)
                if deadline is not None:
                    prev_sleep = min(prev_sleep, deadline.remaining())
                await asyncio.sleep(prev_sleep)
                try:
                    offset = await self._session_offset(
                        namespace, d, uid, deadline
                    )
                except HTTPError as he:
                    if he.status != 404:
                        continue  # transient HEAD failure: retry round
                    # Session unadoptable or swept: one clean restart.
                    if restarted:
                        raise e
                    restarted = True
                    uid = await self._start_upload(namespace, d)
                    offset = 0
                except (OSError, asyncio.TimeoutError):
                    continue  # origin still down: next backoff round

    async def _stream_from(
        self, namespace: str, d: Digest, uid: str, open_at, offset: int,
        chunk_size: int,
    ) -> None:
        f = await asyncio.to_thread(open_at, offset)
        try:
            while True:
                chunk = await asyncio.to_thread(f.read, chunk_size)
                if not chunk and offset > 0:
                    break
                await self._patch_chunk(namespace, d, uid, offset, chunk)
                offset += len(chunk)
                if not chunk:
                    break  # zero-length blob: one empty PATCH
        finally:
            await asyncio.to_thread(f.close)

    async def _session_offset(
        self, namespace: str, d: Digest, uid: str,
        deadline: Deadline | None = None,
    ) -> int:
        """The origin's durable offset for this upload session
        (X-Upload-Offset from HEAD on the upload URL). Raises HTTPError
        404 when the session is gone or unadoptable."""
        _status, headers, _body = await self._http.request_full(
            "HEAD",
            self._url(
                f"/namespace/{quote(namespace, safe='')}/blobs/{d.hex}"
                f"/uploads/{uid}"
            ),
            retry_5xx=False,
            deadline=deadline,
        )
        try:
            return int(headers.get("X-Upload-Offset", ""))
        except ValueError:
            raise HTTPError("HEAD", self._url("/uploads"), 502)

    async def _commit_resumable(
        self, namespace: str, d: Digest, uid: str, resumed: bool
    ) -> None:
        """Commit, idempotently under resume: when a RESUMED upload's
        commit answers 404 (a previous commit attempt landed but its
        response was lost -- the upload is gone because it succeeded),
        confirm via stat before declaring success."""
        try:
            await self._commit_upload(namespace, d, uid)
        except HTTPError as e:
            if not (resumed and e.status == 404):
                raise
            info = await self.stat(namespace, d, local_only=True)
            if info is None:
                raise

    async def _start_upload(self, namespace: str, d: Digest) -> str:
        body = await self._http.post(
            self._url(f"/namespace/{quote(namespace, safe='')}/blobs/{d.hex}/uploads")
        )
        return body.decode()

    async def _patch_chunk(
        self, namespace: str, d: Digest, uid: str, offset: int, chunk: bytes
    ) -> None:
        await self._http.patch(
            self._url(f"/namespace/{quote(namespace, safe='')}/blobs/{d.hex}/uploads/{uid}"),
            data=chunk,
            headers={"X-Upload-Offset": str(offset)},
        )

    async def _commit_upload(
        self, namespace: str, d: Digest, uid: str
    ) -> None:
        await self._http.put(
            self._url(f"/namespace/{quote(namespace, safe='')}/blobs/{d.hex}/uploads/{uid}/commit"),
            ok_statuses=(200, 201, 204, 409),  # 409 = already cached: success
        )

    async def delete(self, namespace: str, d: Digest) -> None:
        await self._http.delete(self._url(f"/namespace/{quote(namespace, safe='')}/blobs/{d.hex}"))

    async def health(self) -> bool:
        try:
            await self._http.get(self._url("/health"), retry_5xx=False)
            return True
        except Exception:
            return False

    async def close(self) -> None:
        await self._http.close()


class ClusterClient:
    """Routes blob ops to the replica set owning each digest.

    Reads walk replicas in breaker-aware order (placement order with
    browned-out and tripped hosts shed toward the back --
    placement/healthcheck.py) under ONE end-to-end deadline, and
    idempotent reads HEDGE: after ``hedge_delay_seconds`` without a
    first answer a second attempt launches at the next healthy replica,
    first success wins, the loser is cancelled cleanly. Writes go to
    every replica (as the reference's proxy upload does) so any one can
    serve and replicate onward.
    """

    def __init__(
        self,
        ring: Ring,
        client_factory: Callable[[str], BlobClient] | None = None,
        health=None,  # placement.healthcheck.PassiveFilter (optional)
        exclude_addr: str = "",
        hedge_delay_seconds: float | None = None,
        deadline_seconds: float | None = None,
        component: str = "cluster",
    ):
        self.ring = ring
        self._factory = client_factory or BlobClient
        self._clients: dict[str, BlobClient] = {}
        # Every request outcome (with its latency) feeds the breaker;
        # when it is also the ring's health_filter, failing origins leave
        # the ring on the next refresh (SURVEY.md SS5 failure detection).
        self.health = health
        # An origin using a ClusterClient over its OWN ring (the heal
        # plane re-fetching a quarantined blob from replicas) must skip
        # itself: asking yourself for the bytes you just lost is at best
        # a wasted round-trip and at worst a read-through loop.
        self.exclude_addr = exclude_addr
        # None/0 = hedging off (e.g. the write-mostly proxy path keeps
        # the old serial walk). YAML rpc.hedge_delay_seconds.
        self.hedge_delay = hedge_delay_seconds or None
        # Default TOTAL budget applied to any read whose caller brought
        # no deadline of its own; None keeps the legacy unbudgeted walk.
        self.deadline_seconds = deadline_seconds
        self.component = component

    def _client(self, addr: str) -> BlobClient:
        if addr not in self._clients:
            self._clients[addr] = self._factory(addr)
        return self._clients[addr]

    def clients_for(self, d: Digest) -> list[BlobClient]:
        addrs = [
            a for a in self.ring.locations(d) if a != self.exclude_addr
        ]
        if self.health is not None and hasattr(self.health, "order"):
            # Breaker-aware read order: browned-out (slow-but-alive) and
            # tripped hosts shed to the back; placement order otherwise.
            addrs = self.health.order(addrs)
        return [self._client(a) for a in addrs]

    def _report(self, c: BlobClient, ok: bool) -> None:
        if self.health is not None:
            (self.health.succeeded if ok else self.health.failed)(c.addr)

    async def _try_each(
        self, d: Digest, op, *, default=_RAISE,
        deadline: Deadline | None = None, op_name: str = "rpc",
        hedge: bool = False,
    ):
        """Read policy: walk replicas in breaker order under one total
        budget; idempotent ops hedge (placement/replicawalk.py -- the
        walk machinery is shared with the tracker fleet client). First
        success wins; with all replicas failed, raise the last error (or
        return ``default`` if given and no replica errored -- i.e. the
        ring was empty).

        ``op`` is an async callable ``(client, deadline)`` so the budget
        reaches the HTTP layer of every attempt."""
        if deadline is None and self.deadline_seconds:
            deadline = Deadline(self.deadline_seconds, component=self.component)
        return await walk_replicas(
            self.clients_for(d), op,
            key=d.hex[:12], missing_key=str(d),
            health=self.health,
            hedge_delay=self.hedge_delay if hedge else None,
            deadline=deadline, op_name=op_name, default=default,
        )

    async def _fan_out(self, d: Digest, op) -> None:
        """Write policy: send to EVERY replica (as the reference's proxy
        upload does, so any one can serve and replicate onward); success if
        at least one accepted. The replica set is captured once -- a ring
        refresh mid-fan-out must not turn total failure into silence."""
        clients = self.clients_for(d)
        errs = []
        for c in clients:
            try:
                await op(c)
                self._report(c, True)
            except Exception as e:
                self._report(c, False)
                errs.append(e)
        if clients and len(errs) == len(clients):
            raise errs[0]

    async def stat(
        self, namespace: str, d: Digest, deadline: Deadline | None = None
    ) -> Optional[BlobInfo]:
        return await self._try_each(
            d, lambda c, dl: c.stat(namespace, d, deadline=dl),
            default=None, deadline=deadline, op_name="stat", hedge=True,
        )

    async def download(
        self, namespace: str, d: Digest, deadline: Deadline | None = None
    ) -> bytes:
        return await self._try_each(
            d, lambda c, dl: c.download(namespace, d, deadline=dl),
            deadline=deadline, op_name="download", hedge=True,
        )

    async def adopt(self, namespace: str, d: Digest, source: str) -> bool:
        """Cross-repo mount: adopt the blob into ``namespace``. Writes go
        to EVERY replica (like upload -- the namespace sidecar, writeback,
        and replication intents should be as durable as a real push);
        True if at least one replica adopted, False if none could (the
        registry then falls back to a normal upload session)."""
        clients = self.clients_for(d)
        ok = False
        # One budget across the whole adopt sweep: a ring of hung
        # sockets costs the caller one deadline, not N client timeouts.
        deadline = None
        if self.deadline_seconds:
            deadline = Deadline(self.deadline_seconds, component=self.component)
        for c in clients:
            try:
                await c.adopt(namespace, d, source, deadline=deadline)
                self._report(c, True)
                ok = True
            except HTTPError as e:
                # A clean 404 ("I can't find those bytes") is a healthy
                # answer, not a node failure.
                self._report(c, e.status == 404)
            except Exception:
                self._report(c, False)
        return ok

    async def get_metainfo(
        self, namespace: str, d: Digest, deadline: Deadline | None = None
    ) -> MetaInfo:
        return await self._try_each(
            d, lambda c, dl: c.get_metainfo(namespace, d, deadline=dl),
            deadline=deadline, op_name="get_metainfo", hedge=True,
        )

    async def get_recipe(
        self, namespace: str, d: Digest, deadline: Deadline | None = None
    ) -> tuple[bytes, str]:
        """(serialized recipe, serving origin addr) from the replica set
        -- hedged like every idempotent read."""
        return await self._try_each(
            d, lambda c, dl: c.get_recipe(namespace, d, deadline=dl),
            deadline=deadline, op_name="get_recipe", hedge=True,
        )

    async def similar(
        self, namespace: str, d: Digest, k: int = 10,
        deadline: Deadline | None = None,
    ) -> list[dict]:
        return await self._try_each(
            d, lambda c, dl: c.similar(namespace, d, k=k, deadline=dl),
            deadline=deadline, op_name="similar", hedge=True,
        )

    async def download_to_file(
        self, namespace: str, d: Digest, dest_path: str,
        deadline: Deadline | None = None,
    ) -> int:
        # Hedge-safe: get_to_file writes through a per-call temp file,
        # so two racing transfers of one dest never tear each other;
        # the winner's atomic rename publishes, the loser's tmp unlinks.
        return await self._try_each(
            d, lambda c, dl: c.download_to_file(namespace, d, dest_path, deadline=dl),
            deadline=deadline, op_name="download_to_file", hedge=True,
        )

    async def upload(self, namespace: str, d: Digest, data: bytes) -> None:
        await self._fan_out(d, lambda c: c.upload(namespace, d, data))

    async def upload_from_file(
        self, namespace: str, d: Digest, path: str
    ) -> None:
        await self._fan_out(
            d, lambda c: c.upload_from_file(namespace, d, path)
        )

    async def close(self) -> None:
        for c in self._clients.values():
            await c.close()
