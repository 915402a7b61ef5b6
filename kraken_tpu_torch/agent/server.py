"""Agent HTTP API.

Mirrors uber/kraken ``agent/agentserver`` (GET blob triggers the P2P
download and streams the result; delete; health/readiness) -- upstream
path, unverified; SURVEY.md SS2.4/SS3.1.

The port's copy of ``kraken_tpu.agent.server``, served by the port's own
HTTP/1.1 (``AgentServer(...).make_app()`` under ``utils/http_lite.serve``):
the same routes, status codes and bodies.

Endpoints:

    GET    /namespace/{ns}/blobs/{d}     -> downloads via swarm, streams blob
    GET    /namespace/{ns}/blobs/{d}/stat
    DELETE /blobs/{d}
    GET    /health                       -> 503 while draining (lameduck)
    GET    /readiness                    -> 200 once the scheduler listens
    POST   /debug/lameduck               -> enter drain mode (no exit)
"""

from __future__ import annotations

import asyncio
import urllib.parse

from kraken_tpu_torch.utils import http_lite as web

from kraken_tpu_torch.core.digest import Digest, DigestError
from kraken_tpu_torch.p2p.scheduler import Scheduler
from kraken_tpu_torch.store import CAStore
from kraken_tpu_torch.utils.lameduck import LameduckMixin


class AgentServer(LameduckMixin):
    lameduck_component = "agent"

    def __init__(self, store: CAStore, scheduler: Scheduler,
                 download_timeout_seconds: float = 300.0,
                 cleanup=None):  # store.cleanup.CleanupManager (optional)
        self.store = store
        self.scheduler = scheduler
        self.download_timeout = download_timeout_seconds
        self.cleanup = cleanup
        # Lameduck drain (utils/lameduck.py): /health fails (so load
        # balancers and the ring route away), NEW swarm pulls are
        # refused with 503+Retry-After, in-flight ones finish. Entered
        # by SIGTERM (cli) or the debug endpoint; never exited -- drain
        # precedes stop.
        self._inflight_downloads = 0

    def make_app(self) -> web.Application:
        app = web.Application()
        r = app.router
        r.add_get("/namespace/{ns}/blobs/{d}/stat", self._stat)
        r.add_get("/namespace/{ns}/blobs/{d}", self._download)
        r.add_delete("/blobs/{d}", self._delete)
        r.add_get("/health", self._health)
        r.add_get("/readiness", self._readiness)
        self.add_lameduck_routes(r)
        self.bind_app(app)
        return app

    @property
    def inflight_work(self) -> int:
        """Drain quiesce signal: downloads that must be allowed to
        finish, plus in-flight debug scrapes (`kraken-tpu status` must
        never lose a listener mid-read)."""
        return self._inflight_downloads + self.debug_inflight

    def _digest(self, req: web.Request) -> Digest:
        try:
            return Digest.from_str(req.match_info["d"])
        except DigestError:
            raise web.HTTPBadRequest(text="malformed digest")

    async def _download(self, req: web.Request) -> web.StreamResponse:
        ns = urllib.parse.unquote(req.match_info["ns"])
        d = self._digest(req)
        if not self.store.in_cache(d):
            if self.lameduck:
                # A cache MISS needs a fresh swarm pull -- new work a
                # draining node must refuse (cache hits below still
                # serve: they cost one sendfile and finish immediately).
                raise self.drain_unavailable()
            self._inflight_downloads += 1
            # Pull SLI (utils/slo.py): success + latency of the swarm
            # pull behind this endpoint.  User-facing -- the canary
            # prober records its own pulls with the canary flag.
            from kraken_tpu_torch.utils.slo import SLO

            t0 = asyncio.get_running_loop().time()
            try:
                await asyncio.wait_for(
                    self.scheduler.download(ns, d), self.download_timeout
                )
            except asyncio.TimeoutError:
                SLO.record(
                    "pull", False, asyncio.get_running_loop().time() - t0
                )
                raise web.HTTPGatewayTimeout(text="download timed out")
            except Exception as e:
                SLO.record(
                    "pull", False, asyncio.get_running_loop().time() - t0
                )
                raise web.HTTPInternalServerError(text=f"download failed: {e}")
            else:
                SLO.record(
                    "pull", True, asyncio.get_running_loop().time() - t0
                )
            finally:
                self._inflight_downloads -= 1
        if self.cleanup is not None:
            self.cleanup.touch(d)  # feed the eviction clock (throttled)
        # One Range-capable streaming path over BOTH storage
        # representations (store/serve.py): the reader opens the flat
        # fd or the chunk manifest atomically, so the post-pull
        # chunk-tier conversion racing this serve can never 404/500 it.
        from kraken_tpu_torch.store.serve import blob_response

        return await blob_response(req, self.store, d)

    async def _stat(self, req: web.Request) -> web.Response:
        d = self._digest(req)
        try:
            size = self.store.cache_size(d)
        except KeyError:
            raise web.HTTPNotFound(text="blob not found")
        return web.json_response({"size": size})

    async def _delete(self, req: web.Request) -> web.Response:
        d = self._digest(req)
        await asyncio.to_thread(self.store.delete_cache_file, d)
        if self.scheduler is not None:
            # A deleted blob leaves the swarm (post-unlink, so a racing
            # handshake cannot resurrect the control).
            self.scheduler.unseed(d)
        return web.Response(status=204)

    async def _health(self, req: web.Request) -> web.Response:
        if self.lameduck:
            # Failing health IS the drain broadcast: load balancers,
            # monitors, and ring peers route away without being told.
            raise self.drain_unavailable()
        return web.Response(text="ok")

    async def _readiness(self, req: web.Request) -> web.Response:
        if self.lameduck:
            raise self.drain_unavailable()
        if self.scheduler._server is None:
            raise web.HTTPServiceUnavailable(text="scheduler not started")
        return web.Response(text="ready")
