"""Agent-side tracker clients: announce + metainfo fetch, single host or
sharded fleet.

The port's copy of ``kraken_tpu.tracker.client``, over the port's own
HTTP/1.1 (``utils/httputil.py`` on ``utils/http_lite.py``).

Mirrors uber/kraken ``tracker/announceclient`` + ``tracker/metainfoclient``
-- upstream paths, unverified; SURVEY.md SS2.4. Both classes implement the
scheduler's ``AnnounceClient`` / ``MetaInfoClient`` protocols.

- :class:`TrackerClient` -- one tracker address (the pre-fleet shape;
  still what tests and single-tracker rigs construct directly).
- :class:`TrackerFleetClient` -- N tracker addresses. Each request
  shards by its swarm key (info hash for announces, blob digest for
  metainfo/recipes) over the SAME rendezvous hashring the origin ring
  uses (placement/hashring.py), so in a healthy fleet every tracker owns
  a stable slice of the announce load. On failure the request fails over
  along the ring through the shared degradation machinery
  (placement/replicawalk.py): per-tracker-host circuit breakers, probe
  admission, deadline-budgeted walks, and hedged metainfo/recipe reads.
  Drop-in for the scheduler -- announce loops, delta planning, and
  origin seed-announces inherit failover untouched.

Every announce runs under an explicit total budget
(``announce_timeout_seconds`` -> utils/deadline.Deadline): before round 8
the announce POST had NO timeout at all, so one hung tracker socket
stalled the scheduler's announce loop forever -- the announce queue kept
popping, but the in-flight task never returned. Exhaustion is counted on
``announce_timeouts_total`` and raises, which the scheduler's announce
loop already meters and backs off (decorrelated jitter, round 12).
"""

from __future__ import annotations

import asyncio
import itertools
import json
import logging
import time

from kraken_tpu_torch.core.digest import Digest
from kraken_tpu_torch.core.metainfo import ChunkRecipe, InfoHash, MetaInfo
from kraken_tpu_torch.core.peer import PeerID, PeerInfo
from urllib.parse import quote

from kraken_tpu_torch.placement.healthcheck import PassiveFilter
from kraken_tpu_torch.placement.hrw import rendezvous_hash
from kraken_tpu_torch.placement.replicawalk import walk_replicas
from kraken_tpu_torch.utils import failpoints, trace
from kraken_tpu_torch.utils.deadline import Deadline, DeadlineExceeded
from kraken_tpu_torch.utils.dedup import TTLCache
from kraken_tpu_torch.utils.httputil import HTTPClient, base_url
from kraken_tpu_torch.utils.metrics import REGISTRY

_log = logging.getLogger("kraken.tracker.client")

# Unique per-instance breaker names: /debug/healthcheck keys its
# snapshot by filter name, and an in-process herd (or a test session)
# holds several fleet clients at once -- a shared name would let one
# client's view shadow another's on the operator surface.
_fleet_seq = itertools.count()


def _count_announce_timeout() -> None:
    REGISTRY.counter(
        "announce_timeouts_total",
        "Tracker announces abandoned at their total time budget",
    ).inc()


class _RecipeCache:
    """Agent-side TTL cache for the delta-plane control reads
    (``get_recipe`` / ``similar``): a tracker failover must never
    re-fetch a recipe the agent just had (recipes are CAS-immutable;
    /similar staleness is bounded by the TTL). Hits and misses count on
    ``tracker_recipe_cache_total{op,result}``. TTL 0 disables."""

    def __init__(self, ttl_seconds: float, max_entries: int = 1024):
        self.ttl = ttl_seconds
        self._cache: TTLCache | None = (
            TTLCache(ttl_seconds, max_entries=max_entries)
            if ttl_seconds > 0 else None
        )
        self._counter = REGISTRY.counter(
            "tracker_recipe_cache_total",
            "Agent-side delta-plane cache outcomes (recipe + /similar"
            " lookups), by op and hit/miss",
        )

    def get(self, op: str, key):
        if self._cache is None:
            return None
        hit = self._cache.get(key)
        self._counter.inc(op=op, result="hit" if hit is not None else "miss")
        return hit

    def put(self, op: str, key, value) -> None:
        if self._cache is not None:
            self._cache.put(key, value)


class TrackerClient:
    """Both announce and metainfo against one tracker address."""

    def __init__(
        self,
        addr: str,
        peer_id: PeerID,
        ip: str,
        port: int,
        is_origin: bool = False,
        http: HTTPClient | None = None,
        announce_timeout_seconds: float = 5.0,
        recipe_cache_ttl_seconds: float = 0.0,
    ):
        self.addr = addr
        self.peer_id = peer_id
        self.ip = ip
        self.port = port
        self.is_origin = is_origin
        self._http = http or HTTPClient()
        # Per-announce TOTAL budget (retries included); the per-attempt
        # timeout becomes min(http timeout, remaining budget). 0 = the
        # legacy unbounded announce (discouraged; kept for tests).
        self.announce_timeout = announce_timeout_seconds
        # Delta-plane read cache (agents pass a TTL; default off so
        # direct/administrative constructions stay uncached).
        self._recipes = _RecipeCache(recipe_cache_ttl_seconds)

    async def announce(
        self, d: Digest, h: InfoHash, namespace: str, complete: bool,
        deadline: Deadline | None = None,
    ) -> tuple[list[PeerInfo], float]:
        me = PeerInfo(
            peer_id=self.peer_id,
            ip=self.ip,
            port=self.port,
            origin=self.is_origin,
            complete=complete,
        )
        # Failpoint tracker.blackout: this tracker is DARK (bad deploy,
        # dead shared backend) -- a typed connectivity failure, exactly
        # what a refused socket raises, so breakers trip and the fleet
        # outage latch engages through the production path.
        if failpoints.fire("tracker.blackout"):
            raise ConnectionError("failpoint tracker.blackout")
        # An externally-supplied deadline (the fleet client's walk
        # budget) is owned by the caller: IT counts the exhaustion, this
        # hop only propagates it.
        own_budget = deadline is None
        if own_budget and self.announce_timeout:
            deadline = Deadline(self.announce_timeout, component="announce")
        try:
            # The announce span is what /debug/trace shows for the hop;
            # the HTTP client span inside injects the traceparent header
            # so the tracker's server span joins the same trace.
            # `d` is optional here (announce by bare info hash): the
            # span must not be the first thing that dereferences it.
            with trace.span(
                "tracker.announce",
                digest=d.hex[:12] if d is not None else "",
                complete=complete,
            ):
                body = await self._http.post(
                    f"{base_url(self.addr)}/announce",
                    data=json.dumps(
                        {"info_hash": h.hex, "peer": me.to_dict()}
                    ),
                    deadline=deadline,
                )
        except DeadlineExceeded:
            if own_budget:
                _count_announce_timeout()
            raise
        doc = json.loads(body)
        return [PeerInfo.from_dict(p) for p in doc["peers"]], float(doc["interval"])

    async def get(
        self, namespace: str, d: Digest, deadline: Deadline | None = None
    ) -> MetaInfo:
        if failpoints.fire("tracker.blackout"):
            raise ConnectionError("failpoint tracker.blackout")
        with trace.span("tracker.get_metainfo", digest=d.hex[:12]):
            raw = await self._http.get(
                f"{base_url(self.addr)}/namespace/"
                f"{quote(namespace, safe='')}/blobs/{d.hex}/metainfo",
                deadline=deadline,
            )
        return MetaInfo.deserialize(raw)

    async def get_recipe(
        self, namespace: str, d: Digest, deadline: Deadline | None = None
    ) -> tuple[ChunkRecipe, str]:
        """The blob's chunk recipe (delta-transfer plane), proxied from
        the origin cluster, plus the serving origin's addr (the
        ``X-Kraken-Origin`` response header; '' when absent) -- where the
        planner aims its byte-range fetches. Raises HTTPError on 404
        (delta disabled or blob unknown): misses are an expected state
        the planner degrades through, so no retries (and no negative
        caching -- the blob may land any moment)."""
        cached = self._recipes.get("recipe", (namespace, d.hex))
        if cached is not None:
            return cached
        with trace.span("tracker.get_recipe", digest=d.hex[:12]):
            _status, headers, body = await self._http.request_full(
                "GET",
                f"{base_url(self.addr)}/namespace/"
                f"{quote(namespace, safe='')}/blobs/{d.hex}/recipe",
                retry_5xx=False,
                deadline=deadline,
            )
        out = ChunkRecipe.deserialize(body), headers.get(
            "X-Kraken-Origin", ""
        )
        self._recipes.put("recipe", (namespace, d.hex), out)
        return out

    async def similar(
        self, namespace: str, d: Digest, deadline: Deadline | None = None
    ) -> list[dict]:
        """Near-duplicate candidates for ``d`` (delta base selection):
        [{"digest": hex, "score": estimated-Jaccard}], best first."""
        cached = self._recipes.get("similar", ("~", namespace, d.hex))
        if cached is not None:
            return cached
        with trace.span("tracker.get_similar", digest=d.hex[:12]):
            raw = await self._http.get(
                f"{base_url(self.addr)}/namespace/"
                f"{quote(namespace, safe='')}/blobs/{d.hex}/similar",
                retry_5xx=False,
                deadline=deadline,
            )
        out = json.loads(raw)["similar"]
        self._recipes.put("similar", ("~", namespace, d.hex), out)
        return out

    async def close(self) -> None:
        await self._http.close()


class TrackerFleetClient:
    """N tracker addrs behind the scheduler's client protocols.

    Sharding: each request ranks the fleet with the same rendezvous hash
    the origin hashring uses (placement/hrw.py), keyed by the swarm's
    info hash (announces) or the blob digest (metainfo/recipe/similar).
    The top-ranked tracker is the shard OWNER; the rest of the ranking
    is the failover order. The per-host breaker
    (placement/healthcheck.PassiveFilter) sheds open/browned-out
    trackers toward the back of that order, so a dead tracker costs its
    shard at most `fail_threshold` slow announces before every client
    routes around it -- and the half-open probe re-admits it after the
    cooldown without a thundering herd.

    Announces walk serially (failover, no hedging: doubling announce
    write load fleet-wide buys nothing). Metainfo/recipe/similar reads
    HEDGE exactly like origin cluster reads: after ``hedge_delay``
    without an answer the next ranked tracker joins the race.

    ``set_addrs`` swaps the fleet live (SIGHUP reload of the tracker
    list): ownership re-shards by rendezvous hashing, so adding or
    removing one tracker moves only ~1/N of the swarms.
    """

    def __init__(
        self,
        addrs: list[str],
        peer_id: PeerID,
        ip: str,
        port: int,
        is_origin: bool = False,
        http: HTTPClient | None = None,
        announce_timeout_seconds: float = 5.0,
        request_deadline_seconds: float = 60.0,
        hedge_delay_seconds: float | None = 0.3,
        recipe_cache_ttl_seconds: float = 0.0,
        health: PassiveFilter | None = None,
    ):
        if not addrs:
            raise ValueError("tracker fleet needs at least one addr")
        self.peer_id = peer_id
        self.ip = ip
        self._port = port
        self.is_origin = is_origin
        self._http = http or HTTPClient()
        self.announce_timeout = announce_timeout_seconds
        self.request_deadline = request_deadline_seconds
        self.hedge_delay = hedge_delay_seconds or None
        self.health = health or PassiveFilter(
            name=f"tracker-fleet-{next(_fleet_seq)}"
        )
        self._addrs: list[str] = []
        # addr -> TrackerClient; sub-clients share ONE HTTPClient (and
        # are never individually closed -- close() closes the session).
        self._clients: dict[str, TrackerClient] = {}
        self._failovers = REGISTRY.counter(
            "tracker_fleet_failovers_total",
            "Requests served by a tracker other than their shard owner",
        )
        # Total-outage latch: every breaker open at once means the whole
        # tracker plane is down, and walking the full failover order at
        # full budget per request is pure queue-building. While latched,
        # walks with no probe-eligible tracker fail fast (no HTTP); the
        # latch clears only on a SUCCESSFUL walk (hysteresis -- one
        # breaker entering half-open is a probe opportunity, not
        # recovery). Registered eagerly so the gauge exists at 0 before
        # the first outage.
        self.outage = False
        self._outage_accrue_t = 0.0
        self._outage_gauge = REGISTRY.gauge(
            "tracker_outage",
            "1 while every tracker in the fleet is breaker-open (total "
            "tracker outage), else 0",
        )
        self._outage_gauge.set(0)
        self._outages_total = REGISTRY.counter(
            "tracker_outages_total",
            "Transitions into total tracker outage (all breakers open)",
        )
        self._outage_seconds = REGISTRY.counter(
            "tracker_outage_seconds_total",
            "Seconds spent with the tracker outage latch engaged",
        )
        self._recipes = _RecipeCache(recipe_cache_ttl_seconds)
        self.set_addrs(addrs)

    # -- membership --------------------------------------------------------

    @property
    def addrs(self) -> list[str]:
        return list(self._addrs)

    @property
    def addr(self) -> str:
        """Single-addr compatibility surface (logs, tests): the fleet's
        membership as one comma-joined string."""
        return ",".join(self._addrs)

    def set_addrs(self, addrs: list[str]) -> None:
        """Swap the fleet membership live (SIGHUP). Dropped trackers
        lose their clients and breaker verdicts (a departed addr's stale
        verdict must not greet a reused address); survivors keep
        theirs."""
        if not addrs:
            raise ValueError("tracker fleet needs at least one addr")
        self._addrs = list(dict.fromkeys(addrs))  # de-dup, keep order
        for gone in set(self._clients) - set(self._addrs):
            del self._clients[gone]
        self.health.prune(self._addrs)

    @property
    def port(self) -> int:
        return self._port

    @port.setter
    def port(self, value: int) -> None:
        # Assembly learns the p2p port only after the scheduler binds;
        # the setter fans it out so every sub-client announces it.
        self._port = value
        for c in self._clients.values():
            c.port = value

    def _client(self, addr: str) -> TrackerClient:
        c = self._clients.get(addr)
        if c is None:
            c = self._clients[addr] = TrackerClient(
                addr, self.peer_id, self.ip, self._port,
                is_origin=self.is_origin, http=self._http,
                # The walk owns the budget; sub-clients never start one.
                announce_timeout_seconds=0.0,
            )
        return c

    def clients_for(self, key_hex: str) -> list[TrackerClient]:
        """The full fleet ranked for ``key_hex``: rendezvous order
        (owner first), breaker-unhealthy trackers shed toward the back."""
        ranked = rendezvous_hash(key_hex, self._addrs, k=len(self._addrs))
        return [self._client(a) for a in self.health.order(ranked)]

    def owner_of(self, key_hex: str) -> str:
        """The shard owner for ``key_hex`` (breaker-blind placement --
        where the request goes when the whole fleet is healthy)."""
        return rendezvous_hash(key_hex, self._addrs, k=1)[0]

    def _outage_check(self) -> None:
        """Walk-entry gate for the total-outage latch.

        ``PassiveFilter.healthy`` is False only for OPEN-AND-COOLING
        breakers -- past the cooldown it reads True again (the half-open
        probe invitation). So "every addr unhealthy" simultaneously
        means "total outage" and "nothing is probe-eligible right now":
        latch and fail fast with a typed error instead of burning the
        full walk budget on sockets we already know are dark. The
        moment any cooldown expires the addr reads healthy, this gate
        passes, and the walk itself becomes the probe. Clearing the
        latch is ``_walk``'s success path, never this gate (hysteresis).
        """
        now = time.monotonic()
        if self.outage:
            self._outage_seconds.inc(max(0.0, now - self._outage_accrue_t))
            self._outage_accrue_t = now
        if not all(not self.health.healthy(a, now) for a in self._addrs):
            return
        if not self.outage:
            self.outage = True
            self._outage_accrue_t = now
            self._outage_gauge.set(1)
            self._outages_total.inc()
            _log.error(
                "tracker fleet outage: all %d trackers breaker-open (%s)",
                len(self._addrs), ",".join(self._addrs),
            )
            from kraken_tpu_torch.utils.trace import TRACER
            TRACER.trigger_dump(
                "tracker_outage",
                f"all {len(self._addrs)} trackers breaker-open",
            )
        raise ConnectionError(
            "tracker fleet outage: all trackers breaker-open"
        )

    async def _walk(self, key_hex: str, op, *, op_name: str,
                    deadline: Deadline, hedge: bool):
        """Shared walk wrapper: counts a failover whenever the serving
        tracker is not the shard owner (the operator's 'how much load is
        off-placement' signal).

        Serial walks additionally slice the budget PER ATTEMPT
        (total / fleet size): a BLACKHOLED tracker (partition, not a
        clean RST) must not eat the whole walk budget on attempt one --
        the slice's TimeoutError IS host evidence (unlike a spent
        walk-wide deadline, which deliberately is not), so the breaker
        counts it, the walk reaches a survivor inside the budget, and
        after ``fail_threshold`` announces the fleet routes around the
        corpse entirely. Hedged walks need no slice: the hedge timer
        already races past a hung primary."""
        self._outage_check()
        owner = self.owner_of(key_hex)
        served: list[str] = []
        per_attempt = (
            deadline.remaining() / len(self._addrs)
            if deadline is not None and not hedge and len(self._addrs) > 1
            else None
        )

        async def op2(c, dl):
            if per_attempt is not None:
                cap = per_attempt
                if dl is not None:
                    cap = min(cap, max(0.001, dl.remaining()))
                out = await asyncio.wait_for(op(c, dl), cap)
            else:
                out = await op(c, dl)
            served.append(c.addr)
            return out

        result = await walk_replicas(
            self.clients_for(key_hex), op2,
            key=key_hex[:12], health=self.health,
            hedge_delay=self.hedge_delay if hedge else None,
            deadline=deadline, op_name=op_name,
        )
        if served and served[0] != owner:
            self._failovers.inc(op=op_name)
        if self.outage:
            # A whole walk succeeded end to end: that is recovery, not a
            # half-open flicker -- unlatch.
            self.outage = False
            self._outage_seconds.inc(
                max(0.0, time.monotonic() - self._outage_accrue_t)
            )
            self._outage_gauge.set(0)
            _log.warning("tracker fleet recovered from total outage")
        return result

    # -- the client protocols ----------------------------------------------

    async def announce(
        self, d: Digest, h: InfoHash, namespace: str, complete: bool
    ) -> tuple[list[PeerInfo], float]:
        deadline = (
            Deadline(self.announce_timeout, component="announce")
            if self.announce_timeout else None
        )
        try:
            return await self._walk(
                h.hex,
                lambda c, dl: c.announce(d, h, namespace, complete,
                                         deadline=dl),
                op_name="announce", deadline=deadline, hedge=False,
            )
        except DeadlineExceeded:
            _count_announce_timeout()
            raise

    async def get(self, namespace: str, d: Digest) -> MetaInfo:
        return await self._walk(
            d.hex,
            lambda c, dl: c.get(namespace, d, deadline=dl),
            op_name="tracker_metainfo",
            deadline=Deadline(self.request_deadline,
                              component="tracker-fleet"),
            hedge=True,
        )

    async def get_recipe(
        self, namespace: str, d: Digest
    ) -> tuple[ChunkRecipe, str]:
        cached = self._recipes.get("recipe", (namespace, d.hex))
        if cached is not None:
            return cached
        out = await self._walk(
            d.hex,
            lambda c, dl: c.get_recipe(namespace, d, deadline=dl),
            op_name="tracker_recipe",
            deadline=Deadline(self.request_deadline,
                              component="tracker-fleet"),
            hedge=True,
        )
        self._recipes.put("recipe", (namespace, d.hex), out)
        return out

    async def similar(self, namespace: str, d: Digest) -> list[dict]:
        cached = self._recipes.get("similar", ("~", namespace, d.hex))
        if cached is not None:
            return cached
        out = await self._walk(
            d.hex,
            lambda c, dl: c.similar(namespace, d, deadline=dl),
            op_name="tracker_similar",
            deadline=Deadline(self.request_deadline,
                              component="tracker-fleet"),
            hedge=True,
        )
        self._recipes.put("similar", ("~", namespace, d.hex), out)
        return out

    async def close(self) -> None:
        await self._http.close()


def parse_tracker_addrs(spec: str | list[str]) -> list[str]:
    """One config shape for 'the tracker(s)': a comma-separated string
    (YAML/flag) or an explicit list. Empty entries drop out."""
    if isinstance(spec, str):
        spec = spec.split(",")
    return [a.strip() for a in spec if a and a.strip()]


def make_tracker_client(
    spec: str | list[str],
    peer_id: PeerID,
    ip: str,
    port: int,
    is_origin: bool = False,
    announce_timeout_seconds: float = 5.0,
    request_deadline_seconds: float = 60.0,
    hedge_delay_seconds: float | None = 0.3,
    recipe_cache_ttl_seconds: float = 0.0,
):
    """Assembly's one constructor for 'the tracker client': a fleet
    client for >= 2 addrs, the plain single-host client otherwise (0 or
    1 addr keeps the pre-fleet behavior bit-for-bit, including the
    legacy empty-addr construction some harnesses rely on)."""
    addrs = parse_tracker_addrs(spec)
    if len(addrs) >= 2:
        return TrackerFleetClient(
            addrs, peer_id, ip, port, is_origin=is_origin,
            announce_timeout_seconds=announce_timeout_seconds,
            request_deadline_seconds=request_deadline_seconds,
            hedge_delay_seconds=hedge_delay_seconds,
            recipe_cache_ttl_seconds=recipe_cache_ttl_seconds,
        )
    single = addrs[0] if addrs else (spec if isinstance(spec, str) else "")
    return TrackerClient(
        single, peer_id, ip, port, is_origin=is_origin,
        announce_timeout_seconds=announce_timeout_seconds,
        recipe_cache_ttl_seconds=recipe_cache_ttl_seconds,
    )
