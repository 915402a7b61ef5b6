"""Build-index tag server + cross-cluster replication.

Mirrors uber/kraken ``build-index/tagserver`` + ``tagreplication``
(put/get tag -> digest, list repo tags, replicate endpoint; durable
replication tasks resolving a tag's blob dependencies so the remote
cluster pre-fetches them) -- upstream paths, unverified; SURVEY.md SS2.4.

Endpoints:

    PUT  /tags/{tag}/digest/{d}              local put
    PUT  /tags/{tag}/digest/{d}/replicate    put + replicate to remotes
    GET  /tags/{tag}                         -> digest string
    GET  /repositories/{repo}/tags           -> JSON list of tag names
    POST /internal/replicate                 {tag, digest, dependencies}
    GET  /health

The port's copy of ``kraken_tpu.buildindex.server``, served by the port's
own HTTP/1.1 (``utils/http_lite``); its clients are the port's
``utils/httputil``. Either package's ``TagClient`` talks to either
package's ``TagServer``, and a replication task of either reaches the
other.
"""

from __future__ import annotations

import asyncio
import json
import logging
from urllib.parse import quote, unquote

from kraken_tpu_torch.buildindex.tagstore import TagStore
from kraken_tpu_torch.buildindex.tagtype import DependencyResolver
from kraken_tpu_torch.core.digest import Digest, DigestError
from kraken_tpu_torch.persistedretry import Manager as RetryManager, Task
from kraken_tpu_torch.utils import http_lite as web
from kraken_tpu_torch.utils.deadline import Deadline
from kraken_tpu_torch.utils.httputil import HTTPClient, base_url

REPLICATE_KIND = "tag_replicate"


class TagServer:
    def __init__(
        self,
        store: TagStore,
        retry: RetryManager | None = None,
        remotes: list[str] | None = None,  # remote build-index addrs
        resolver: DependencyResolver | None = None,
        origin_cluster=None,  # for pre-fetching replicated dependencies
        immutable: bool = False,
    ):
        self.store = store
        self.retry = retry
        self.remotes = remotes or []
        self.resolver = resolver or DependencyResolver(origin_cluster)
        self.origin_cluster = origin_cluster
        # immutable_tags YAML: a tag, once written, can never point at a
        # DIFFERENT digest (re-putting the same digest stays idempotent --
        # retried pushes must not fail). Conflicts answer 409. This is the
        # guarantee that makes aggressive tag caching sound and prevents
        # a re-tagged name from silently changing what hosts run.
        self.immutable = immutable
        # One lock serializes check+put: without it two concurrent PUTs
        # with different digests could both pass the immutability check
        # in the await gap before either write lands.
        self._put_lock = asyncio.Lock()
        self._http = HTTPClient()
        if retry is not None:
            retry.register(REPLICATE_KIND, self._execute_replication)

    async def _checked_put(self, tag: str, d: Digest) -> None:
        """store.put, guarded by the immutability check when enabled.

        The check reads through to the BACKEND (store.get), not just
        local disk: a build-index rescheduled onto a fresh volume must
        still refuse to re-point a tag that exists durably -- the silent
        re-tag is exactly what the feature prevents."""
        if not self.immutable:
            await self.store.put(tag, d)
            return
        ns = tag.rpartition(":")[0] or tag
        async with self._put_lock:
            # get_strict: a backend outage must NOT look like "tag absent"
            # -- that would fail open and allow the silent re-tag this
            # feature exists to prevent. Answer retryable 503 instead.
            try:
                existing = await self.store.get_strict(tag, ns)
            except Exception as e:
                raise web.HTTPServiceUnavailable(
                    text=f"immutability check unavailable: backend error: {e}"
                )
            if existing is not None and existing != d:
                raise web.HTTPConflict(
                    text=f"tag is immutable: {tag} -> {existing}"
                )
            await self.store.put(tag, d)

    def make_app(self) -> web.Application:
        app = web.Application(client_max_size=1 << 26)
        r = app.router
        r.add_put("/tags/{tag}/digest/{d}/replicate", self._put_and_replicate)
        r.add_put("/tags/{tag}/digest/{d}", self._put)
        r.add_get("/tags/{tag}", self._get)
        r.add_get("/repositories/{repo}/tags", self._list_repo)
        r.add_get("/internal/tags", self._list_all)
        r.add_post("/internal/replicate", self._recv_replication)
        r.add_get("/health", self._health)
        return app

    def _parse(self, req: web.Request) -> tuple[str, Digest]:
        tag = unquote(req.match_info["tag"])
        try:
            return tag, Digest.from_str(req.match_info["d"])
        except DigestError:
            raise web.HTTPBadRequest(text="malformed digest")

    async def _put(self, req: web.Request) -> web.Response:
        tag, d = self._parse(req)
        await self._checked_put(tag, d)
        return web.Response(status=200)

    async def _put_and_replicate(self, req: web.Request) -> web.Response:
        tag, d = self._parse(req)
        await self._checked_put(tag, d)
        if self.retry is not None:
            deps = await self.resolver.resolve(tag.rpartition(":")[0] or tag, tag, d)
            for remote in self.remotes:
                self.retry.add(
                    Task(
                        kind=REPLICATE_KIND,
                        key=f"{remote}:{tag}",
                        payload={
                            "remote": remote,
                            "tag": tag,
                            "digest": d.hex,
                            "dependencies": [x.hex for x in deps],
                        },
                    )
                )
        return web.Response(status=200)

    async def _execute_replication(self, task: Task) -> None:
        remote = task.payload["remote"]
        tag = task.payload["tag"]
        await self._http.post(
            f"{base_url(remote)}/internal/replicate",
            data=json.dumps(
                {
                    "tag": tag,
                    "digest": task.payload["digest"],
                    "dependencies": task.payload["dependencies"],
                }
            ),
        )

    async def _recv_replication(self, req: web.Request) -> web.Response:
        try:
            doc = await req.json()
            tag = doc["tag"]
            d = Digest.from_hex(doc["digest"])
            deps = [Digest.from_hex(x) for x in doc.get("dependencies", [])]
        except (json.JSONDecodeError, KeyError, ValueError) as e:
            raise web.HTTPBadRequest(text=f"malformed replication: {e}")

        # Pre-fetch dependency blobs into this cluster's origins (repair
        # path pulls them from the remote cluster's backend on miss).
        if self.origin_cluster is not None:
            ns = tag.rpartition(":")[0] or tag
            # One budget for the whole preheat sweep: a dead origin
            # cluster must cost this replication handler one deadline,
            # not len(deps) full client timeouts.
            deadline = Deadline(60.0, component="buildindex-preheat")
            for dep in deps:
                try:
                    await self.origin_cluster.stat(ns, dep, deadline=deadline)
                except Exception:
                    # Best-effort preheat: the repair path covers a cold
                    # dep, but a persistently failing cluster should be
                    # visible in the logs, not silent.
                    logging.getLogger("kraken.buildindex").debug(
                        "dependency preheat failed for %s", dep,
                        exc_info=True,
                    )
        # Two clusters minting the same tag differently is a config
        # error; refusing (409) keeps it visible in the source's retry
        # queue instead of letting last-writer-wins corrupt either side.
        await self._checked_put(tag, d)
        return web.Response(status=200)

    async def _get(self, req: web.Request) -> web.Response:
        tag = unquote(req.match_info["tag"])
        ns = tag.rpartition(":")[0] or tag
        d = await self.store.get(tag, ns)
        if d is None:
            raise web.HTTPNotFound(text="tag not found")
        return web.Response(text=str(d))

    async def _list_repo(self, req: web.Request) -> web.Response:
        repo = unquote(req.match_info["repo"])
        tags = await asyncio.to_thread(self.store.list_local, repo + ":")
        names = [t.rpartition(":")[2] for t in tags]
        return web.json_response(names)

    async def _list_all(self, req: web.Request) -> web.Response:
        tags = await asyncio.to_thread(self.store.list_local, "")
        return web.json_response(tags)

    async def _health(self, req: web.Request) -> web.Response:
        return web.Response(text="ok")


class TagClient:
    """Client for the tag server (agents resolve tags; proxy puts them)."""

    def __init__(self, addr: str, http: HTTPClient | None = None):
        self.addr = addr
        self._http = http or HTTPClient()

    async def put(self, tag: str, d: Digest, replicate: bool = False) -> None:
        suffix = "/replicate" if replicate else ""
        await self._http.put(
            f"{base_url(self.addr)}/tags/{quote(tag, safe='')}/digest/{d.hex}{suffix}",
            ok_statuses=(200,),
        )

    async def get(self, tag: str) -> Digest:
        body = await self._http.get(f"{base_url(self.addr)}/tags/{quote(tag, safe='')}")
        return Digest.parse(body.decode())

    async def list_repo(self, repo: str) -> list[str]:
        body = await self._http.get(
            f"{base_url(self.addr)}/repositories/{quote(repo, safe='')}/tags"
        )
        return json.loads(body)

    async def list_all(self) -> list[str]:
        body = await self._http.get(f"{base_url(self.addr)}/internal/tags")
        return json.loads(body)

    async def close(self) -> None:
        await self._http.close()
