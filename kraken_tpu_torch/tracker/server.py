"""Tracker HTTP API: announce + metainfo proxy.

The port's copy of ``kraken_tpu.tracker.server``, served by the port's own
HTTP/1.1 (``utils/http_lite.serve``) where the reference is served by
aiohttp.

Mirrors uber/kraken ``tracker/trackerserver`` (announce endpoint: peer <->
peer-list exchange with an announce interval; metainfo endpoint proxying
the origin cluster with a TTL cache) -- upstream path, unverified;
SURVEY.md SS2.4/SS3.4.

Endpoints:

    POST /announce                 body: announce record   -> {peers, interval}
    GET  /namespace/{ns}/blobs/{d}/metainfo               -> metainfo doc
    GET  /namespace/{ns}/blobs/{d}/recipe                 -> chunk recipe
                                                             (X-Kraken-Origin:
                                                             serving origin)
    GET  /namespace/{ns}/blobs/{d}/similar                -> near-dup list
    GET  /health
    POST/GET /debug/lameduck

Agents know only the tracker, so the delta-transfer control plane
(recipes + /similar) proxies through it exactly like metainfo; the
``X-Kraken-Origin`` header names the origin that served the recipe so
agents can aim byte-range fetches at a replica that actually holds the
blob.

Fleet mode (round 12, the tracker HA plane): trackers run as a
rendezvous-sharded fleet -- clients (``tracker/client.TrackerFleetClient``)
shard announces by info hash so each tracker owns a stable slice, and
fail over along the ring when a tracker dies. Every tracker SERVES any
swarm unconditionally (a peer handout never errors just because the
shard owner died: the local store answers, and with the in-memory store
the failover swarm re-forms within one announce interval as peers
re-announce). A non-owner additionally FORWARDS accepted announces to
the live shard owner (best-effort, throttled, breaker-gated) so mixed
client views during a membership change never lose a registered peer.
Trackers sharing a Redis store skip forwarding -- the store is the
rendezvous point. Lameduck (``enter_lameduck`` / the debug endpoint /
SIGTERM) flips /health to 503 and refuses new announces so rolling
restarts drain one tracker at a time, exactly like agents and origins.
"""

from __future__ import annotations

import asyncio
import json
import logging
import urllib.parse

from kraken_tpu_torch.utils import http_lite as web

from kraken_tpu_torch.core.digest import Digest, DigestError
from kraken_tpu_torch.core.peer import PeerInfo
from kraken_tpu_torch.placement.healthcheck import PassiveFilter
from kraken_tpu_torch.placement.hrw import rendezvous_hash
from kraken_tpu_torch.tracker.peerhandout import default_priority
from kraken_tpu_torch.tracker.peerstore import InMemoryPeerStore, PeerStore
from kraken_tpu_torch.utils import failpoints
from kraken_tpu_torch.utils.dedup import TTLCache
from kraken_tpu_torch.utils.httputil import HTTPClient, base_url, is_not_found
from kraken_tpu_torch.utils.lameduck import LameduckMixin
from kraken_tpu_torch.utils.metrics import REGISTRY, FailureMeter

_log = logging.getLogger("kraken.tracker")

# Marks an announce the fleet already forwarded once: the owner must
# never re-forward (membership disagreement between trackers would
# otherwise bounce an announce around the fleet forever).
_FORWARDED_HEADER = "X-Kraken-Forwarded"


class TrackerServer(LameduckMixin):
    lameduck_component = "tracker"

    def __init__(
        self,
        peer_store: PeerStore | None = None,
        # Any object with get_metainfo / get_recipe / similar:
        # origin.client.ClusterClient.
        origin_cluster=None,
        announce_interval_seconds: float = 3.0,
        handout_policy=default_priority,
        handout_limit: int = 50,
        metainfo_cache_ttl: float = 60.0,
        fleet_addrs: list[str] | None = None,
        self_addr: str = "",
        shared_store: bool = False,
        forward_timeout_seconds: float = 2.0,
    ):
        self.peers = peer_store or InMemoryPeerStore()
        self.origin_cluster = origin_cluster
        self.interval = announce_interval_seconds
        self.policy = handout_policy
        self.handout_limit = handout_limit
        self._metainfo_cache: TTLCache = TTLCache(metainfo_cache_ttl)
        # Recipes are as immutable as metainfo (CAS: derived from the
        # blob's bytes), so the same TTL cache applies; /similar is NOT
        # cached -- its answer improves as blobs land.
        self._recipe_cache: TTLCache = TTLCache(metainfo_cache_ttl)
        # A handler failure swallowed as a bare 404 made a dying origin
        # cluster indistinguishable from a missing blob; meter + one
        # throttled WARN with request context instead.
        self._handler_errors = FailureMeter(
            "tracker_handler_errors_total",
            "Tracker handler failures previously swallowed as 404s",
            _log,
        )
        # -- fleet state (see module docstring) ---------------------------
        self.fleet_addrs = list(fleet_addrs or [])
        self.self_addr = self_addr
        # Trackers on a shared (Redis) store need no forwarding: every
        # tracker reads the same swarm records.
        self.shared_store = shared_store
        self._forward_http: HTTPClient | None = None
        self._forward_timeout = forward_timeout_seconds
        # The owner's availability, as THIS tracker sees it: forwarding
        # to a dead owner is wasted sockets, so forward failures trip a
        # local breaker and forwarding resumes via its half-open probe.
        self._forward_health = PassiveFilter(name="tracker-fleet-forward")
        # One forward per (info_hash, peer) per announce interval: the
        # owner re-learns a peer at the peer's own announce cadence, not
        # N-trackers times that.
        self._forward_throttle = TTLCache(
            max(announce_interval_seconds, 1.0), max_entries=8192
        )
        self._forward_tasks: set[asyncio.Task] = set()
        self._forwards = REGISTRY.counter(
            "tracker_announce_forwards_total",
            "Announces a non-owner tracker forwarded toward the shard"
            " owner, by outcome",
        )
        # Drain bookkeeping (LameduckMixin): announces/proxy reads that
        # must finish before the drain quiesces.
        self._inflight = 0

    def set_fleet(self, fleet_addrs: list[str], self_addr: str = "") -> None:
        """Swap fleet membership live (SIGHUP): ownership re-shards on
        the next announce; stale forward-breaker verdicts for departed
        trackers are pruned."""
        self.fleet_addrs = list(fleet_addrs)
        if self_addr:
            self.self_addr = self_addr
        self._forward_health.prune(self.fleet_addrs)

    @property
    def inflight_work(self) -> int:
        # debug_inflight: /debug/slo + /debug/ scrapes (`kraken-tpu
        # status`, canary tooling) gate the drain quiesce exactly like
        # the /recipe proxy reads below (the round-12 lesson).
        return self._inflight + self.debug_inflight

    def make_app(self) -> web.Application:
        app = web.Application()
        app.router.add_post("/announce", self._announce)
        app.router.add_get("/namespace/{ns}/blobs/{d}/metainfo", self._metainfo)
        app.router.add_get("/namespace/{ns}/blobs/{d}/recipe", self._recipe)
        app.router.add_get("/namespace/{ns}/blobs/{d}/similar", self._similar)
        app.router.add_get("/health", self._health)
        self.add_lameduck_routes(app.router)
        self.bind_app(app)
        return app

    async def close(self) -> None:
        """Release fleet resources (forward tasks + client) and the peer
        store."""
        for t in list(self._forward_tasks):
            t.cancel()
        if self._forward_tasks:
            await asyncio.gather(*self._forward_tasks, return_exceptions=True)
        if self._forward_http is not None:
            await self._forward_http.close()
            self._forward_http = None
        await self.peers.close()

    async def _announce(self, req: web.Request) -> web.Response:
        if self.lameduck:
            # Draining: the 503 makes fleet clients fail over to the
            # next ring tracker NOW -- the rolling-restart contract.
            raise self.drain_unavailable()
        self._inflight += 1
        try:
            return await self._announce_inner(req)
        finally:
            self._inflight -= 1

    async def _announce_inner(self, req: web.Request) -> web.Response:
        # Failpoint tracker.announce.error: a flapping tracker -- clients
        # must meter the failure (announce_failures_total) and recover on
        # a later interval, not wedge or crash.
        if failpoints.fire("tracker.announce.error"):
            raise web.HTTPServiceUnavailable(
                text="failpoint tracker.announce.error"
            )
        try:
            doc = await req.json()
            info_hash = doc["info_hash"]
            if not isinstance(info_hash, str):
                # Opaque but must be a string: swarm keys are typed
                # (and e.g. a list is unhashable only at store time).
                raise ValueError("info_hash must be a string")
            peer = PeerInfo.from_dict(doc["peer"])
        except (json.JSONDecodeError, KeyError, ValueError,
                TypeError, AttributeError) as e:
            # TypeError/AttributeError: right keys, wrong shapes (a list
            # where an object belongs) -- still a malformed announce, not
            # a server error.
            raise web.HTTPBadRequest(text=f"malformed announce: {e}")
        # Record BEFORE reading: the store calls suspend the handler, so a
        # flash crowd of first announces handled read-first would all
        # snapshot the swarm before any write landed and every one would
        # get an empty handout. Writing first makes concurrent announcers
        # visible to each other; the announcer itself is filtered out of
        # its own handout below (hence the +1 overfetch).
        await self.peers.update(info_hash, peer)
        # Fleet mode: ALWAYS accepted locally (a handout must never
        # error because the shard owner died); additionally forwarded
        # toward a live owner so a membership-change straggler's
        # announce reaches the store most clients read from.
        if not req.headers.get(_FORWARDED_HEADER):
            self._maybe_forward(info_hash, doc)
        candidates = await self.peers.get_peers(
            info_hash, limit=self.handout_limit + 1
        )
        others = [
            p for p in candidates if p.peer_id != peer.peer_id
        ][: self.handout_limit]
        # Failpoint tracker.announce.empty: a 200 with an empty handout
        # (fresh tracker after restart, peer-store flush) -- leechers
        # must simply re-announce rather than treat it as terminal.
        if failpoints.fire("tracker.announce.empty"):
            others = []
        ordered = self.policy(others)
        ordered = self._shed_unhealthy_origins(ordered)
        return web.json_response(
            {
                "peers": [p.to_dict() for p in ordered],
                "interval": self.interval,
            }
        )

    def _shed_unhealthy_origins(
        self, peers: list[PeerInfo]
    ) -> list[PeerInfo]:
        """Breaker-aware handout: origin peers whose HOST the tracker's
        own origin-cluster breaker holds unhealthy (open, half-open, or
        browned out) move to the back of the handout, so leechers dial
        them only when everyone healthier is exhausted. Matching is by
        IP -- the breaker keys http addrs, announces carry p2p addrs --
        and only origin peers are shed: the breaker knows nothing about
        agent hosts."""
        health = getattr(self.origin_cluster, "health", None)
        if health is None or not hasattr(health, "unhealthy_hosts"):
            return peers

        def host_ip(h: str) -> str:
            h = h.split("://", 1)[-1]
            return h.rsplit(":", 1)[0]

        bad_ips = {host_ip(h) for h in health.unhealthy_hosts()}
        if not bad_ips:
            return peers
        return sorted(  # stable: policy order preserved within each half
            peers, key=lambda p: p.origin and p.ip in bad_ips
        )

    # -- fleet forwarding --------------------------------------------------

    def owns(self, info_hash: str) -> bool:
        """Shard ownership by the SAME rendezvous ranking the fleet
        client shards with; a tracker outside (or without) a fleet owns
        everything."""
        if not self.fleet_addrs or not self.self_addr:
            return True
        return rendezvous_hash(
            info_hash, self.fleet_addrs, k=1
        )[0] == self.self_addr

    def _maybe_forward(self, info_hash: str, doc: dict) -> None:
        """Best-effort re-announce toward the shard owner. Fire-and-
        forget: the announcer already has its answer from the local
        store; losing a forward costs one announce interval of owner-
        store freshness, never correctness. Skipped entirely on a shared
        store, when we ARE the owner, when the owner's forward breaker
        is open, or inside the per-peer throttle window."""
        if self.shared_store or not self.fleet_addrs or not self.self_addr:
            return
        owner = rendezvous_hash(info_hash, self.fleet_addrs, k=1)[0]
        if owner == self.self_addr:
            return
        peer_id = str(doc.get("peer", {}).get("peer_id", ""))
        throttle_key = (owner, info_hash, peer_id)
        if self._forward_throttle.get(throttle_key) is not None:
            self._forwards.inc(result="throttled")
            return
        if not self._forward_health.healthy(owner):
            # The owner is down as far as this tracker can tell -- the
            # announcer's own failover already landed the record here.
            self._forwards.inc(result="skipped_unhealthy")
            return
        self._forward_throttle.put(throttle_key, True)
        t = asyncio.create_task(self._forward(owner, doc))
        self._forward_tasks.add(t)
        t.add_done_callback(self._forward_tasks.discard)

    async def _forward(self, owner: str, doc: dict) -> None:
        if self._forward_http is None:
            self._forward_http = HTTPClient(
                timeout_seconds=self._forward_timeout, retries=0
            )
        try:
            await self._forward_http.post(
                f"{base_url(owner)}/announce",
                data=json.dumps(doc),
                headers={_FORWARDED_HEADER: "1"},
            )
        except asyncio.CancelledError:
            raise
        except Exception:
            self._forward_health.failed(owner)
            self._forwards.inc(result="error")
        else:
            self._forward_health.succeeded(owner)
            self._forwards.inc(result="ok")

    # -- metainfo / delta proxies ------------------------------------------

    async def _metainfo(self, req: web.Request) -> web.Response:
        if self.lameduck:
            raise self.drain_unavailable()
        self._inflight += 1
        try:
            return await self._metainfo_inner(req)
        finally:
            self._inflight -= 1

    async def _metainfo_inner(self, req: web.Request) -> web.Response:
        ns, d = self._parse_digest(req)
        cached = self._metainfo_cache.get(d.hex)
        if cached is None:
            if self.origin_cluster is None:
                raise web.HTTPNotFound(text="no origin cluster configured")
            try:
                metainfo = await self.origin_cluster.get_metainfo(ns, d)
            except Exception as e:
                # Still a 404 to the caller (agents retry through their
                # announce loop), but never a SILENT one: an origin
                # cluster that is down looks exactly like a missing blob
                # otherwise. Metered + one throttled WARN with context.
                self._handler_errors.record(
                    f"metainfo fetch {d.hex[:12]} ns={ns} "
                    f"peer={req.remote}", e,
                )
                raise web.HTTPNotFound(text="metainfo unavailable")
            cached = metainfo.serialize()
            self._metainfo_cache.put(d.hex, cached)
        return web.Response(body=cached)

    def _parse_digest(self, req: web.Request) -> tuple[str, Digest]:
        ns = urllib.parse.unquote(req.match_info["ns"])
        try:
            return ns, Digest.from_str(req.match_info["d"])
        except DigestError:
            raise web.HTTPBadRequest(text="malformed digest")

    async def _recipe(self, req: web.Request) -> web.Response:
        """Delta-plane proxy: the blob's chunk recipe from the origin
        cluster, with the serving origin's addr stamped on the response
        (``X-Kraken-Origin``) so agents can aim range fetches at it. A
        clean origin 404 (delta disabled, blob gone) is the expected
        steady state while delta is rolled out -- it is NOT a handler
        error."""
        if self.lameduck:
            raise self.drain_unavailable()
        self._inflight += 1
        try:
            return await self._recipe_inner(req)
        finally:
            self._inflight -= 1

    async def _recipe_inner(self, req: web.Request) -> web.Response:
        ns, d = self._parse_digest(req)
        cached = self._recipe_cache.get(d.hex)
        if cached is None:
            if self.origin_cluster is None:
                raise web.HTTPNotFound(text="no origin cluster configured")
            try:
                raw, addr = await self.origin_cluster.get_recipe(ns, d)
            except Exception as e:
                if not is_not_found(e):
                    self._handler_errors.record(
                        f"recipe fetch {d.hex[:12]} ns={ns} "
                        f"peer={req.remote}", e,
                    )
                raise web.HTTPNotFound(text="recipe unavailable")
            cached = (raw, addr)
            self._recipe_cache.put(d.hex, cached)
        raw, addr = cached
        return web.Response(
            body=raw,
            content_type="application/json",
            headers={"X-Kraken-Origin": addr},
        )

    async def _similar(self, req: web.Request) -> web.Response:
        """Delta-plane proxy: near-duplicate candidates from the origin
        cluster's dedup index (uncached: the answer improves as blobs
        land)."""
        if self.lameduck:
            raise self.drain_unavailable()
        self._inflight += 1
        try:
            return await self._similar_inner(req)
        finally:
            self._inflight -= 1

    async def _similar_inner(self, req: web.Request) -> web.Response:
        ns, d = self._parse_digest(req)
        if self.origin_cluster is None:
            raise web.HTTPNotFound(text="no origin cluster configured")
        try:
            k = int(req.query.get("k", "10"))
        except ValueError:
            raise web.HTTPBadRequest(text="malformed k")
        if k <= 0:
            # Reject here: forwarded, the origin's 400 would both read
            # as 404 to the caller and pollute _handler_errors -- the
            # meter that distinguishes a dying origin cluster from a
            # missing blob.
            raise web.HTTPBadRequest(text="k must be > 0")
        try:
            hits = await self.origin_cluster.similar(ns, d, k=k)
        except Exception as e:
            if not is_not_found(e):
                self._handler_errors.record(
                    f"similar fetch {d.hex[:12]} ns={ns} "
                    f"peer={req.remote}", e,
                )
            raise web.HTTPNotFound(text="similar unavailable")
        return web.json_response({"similar": hits})

    async def _health(self, req: web.Request) -> web.Response:
        if self.lameduck:
            # Rolling restart: the deploy system (and any LB) observes
            # the flip, waits its grace period, then SIGTERMs -- the
            # same contract agents and origins honor.
            raise self.drain_unavailable()
        return web.Response(text="ok")
