"""Discrete-event swarm simulator: the REAL policy code at 10k-agent scale.

The port's copy of ``kraken_tpu.p2p.sim``, over the port's own policy
modules: a (seed, config) pair gives the reference's result dict.

The socket harness tops out at one GIL (~100 MB/s aggregate, PERF.md), so
BASELINE row 6's "p99 pull latency @ 10k agents" cannot be measured with
sockets on this rig. This simulator removes the transport, not the logic:
piece selection (:class:`RequestManager`), conn admission + soft blacklist
(:class:`ConnState`), announce pacing (:class:`AnnounceQueue`) and tracker
handout ordering (:func:`default_priority`) are the production objects,
driven by a simulated clock and an in-memory bandwidth/latency model.
Mirrors the reference's simulated-swarm test tier (SURVEY.md SS4 tier 3,
SS6 row 6) -- upstream testing strategy, unverified.

Model (deliberately simple, stated so results are interpretable):

- Each peer has one uplink of ``uplink_bps``; piece serves queue FIFO on
  it (``busy_until``). ``downlink_bps`` > 0 additionally FIFO-queues the
  receive side at the transfer rate min(uplink, downlink) -- the per-host
  bandwidth-cap shape production ships (utils/bandwidth.py YAML knobs).
  0 keeps the round-3 uplink-only model.
- ``blob_pieces`` with several entries simulates an image-shaped pull:
  every agent pulls ALL blobs concurrently (one conn budget per blob, as
  production conns are per-torrent; one shared uplink/downlink pair per
  host), and an agent's pull latency is when its LAST blob completes --
  what ``docker pull`` wall time means.
- Every message hop pays ``latency_s``.
- Conns are bidirectional, with the dispatcher's idle churn: a conn that
  carries nothing useful for ``churn_idle_s`` is dropped from both ends.
  This is LOAD-BEARING at scale, exactly as the dispatcher's docstring
  claims: without it, completed peers' slots stay pinned to other
  completed peers and a flash crowd wedges (observed in this sim before
  churn was modeled -- 10/200 agents completed, the rest starved).
- Agents announce on join and every ``announce_interval_s`` after
  (complete agents too, as real seeders do); the tracker answers with the
  production handout policy. Announce LOAD is reported, the pacing
  driven through one production :class:`AnnounceQueue`.
- ``restart_frac`` > 0 kills that fraction of agents at ``restart_at_s``:
  conns drop from both ends, in-flight requests are lost, up to
  ``restart_lose_pieces`` most-recent pieces per blob are forgotten (the
  debounced-bitfield crash window), and the agent rejoins after
  ``restart_down_s`` via a fresh announce -- the mid-swarm agent-restart
  chaos shape.
- ``n_trackers`` > 1 models the tracker HA plane (round 12): announces
  shard by info hash over the SAME rendezvous ranking production's
  ``TrackerFleetClient`` uses, each peer carries a real production
  :class:`PassiveFilter` breaker over the tracker hosts (driven with
  sim time), and a failed attempt walks to the next ring tracker.
  Each tracker owns an independent in-memory membership store that DIES
  with it (``tracker_kill_at_s``/``tracker_kill`` kill the blob-0
  owners first; ``tracker_restart_after_s`` revives them empty), so the
  sim measures the real re-form dynamics: failover announces rebuild
  the survivor's swarm view within ~one announce interval. Per-announce
  latency (walk cost included) is reported as ``announce_p50_s`` /
  ``announce_p99_s`` -- the number the tier-1 fleet band pins.
  ``tracker_down_mode`` "refuse" charges one latency hop per dead
  attempt (a killed process RSTs instantly); "blackhole" charges the
  full announce budget (a partitioned host).

Determinism: one seeded ``random.Random`` drives every stochastic choice
(handout shuffle + selection tiebreaks route through ``random`` module
state, seeded per run), so a (seed, config) pair replays exactly.
"""

from __future__ import annotations

import dataclasses
import heapq
import random
import statistics
from typing import Callable, Optional

from kraken_tpu_torch.core.metainfo import InfoHash
from kraken_tpu_torch.core.peer import PeerID, PeerInfo
from kraken_tpu_torch.p2p.announcequeue import AnnounceQueue
from kraken_tpu_torch.p2p.connstate import ConnState, ConnStateConfig
from kraken_tpu_torch.p2p.piecerequest import RequestManager
from kraken_tpu_torch.placement.healthcheck import PassiveFilter
from kraken_tpu_torch.placement.hrw import rendezvous_hash
from kraken_tpu_torch.tracker.peerhandout import default_priority


@dataclasses.dataclass
class SimConfig:
    n_agents: int = 1000
    n_origins: int = 1
    num_pieces: int = 64
    piece_bytes: int = 4 << 20
    uplink_bps: float = 1.25e9  # ~10 GbE
    origin_uplink_bps: float = 1.25e9
    downlink_bps: float = 0.0  # 0 = uplink-only model (round-3 shape)
    latency_s: float = 0.001
    announce_interval_s: float = 3.0
    handout_limit: int = 20
    max_conns_per_torrent: int = 10
    pipeline_limit: int = 4
    piece_timeout_s: float = 8.0
    churn_idle_s: float = 4.0  # dispatcher default
    churn_tick_s: float = 1.0
    seed: int = 0
    max_sim_s: float = 600.0
    # Image-shaped pulls: pieces per blob (None = one blob of num_pieces).
    blob_pieces: tuple[int, ...] | None = None
    # Mid-swarm restart chaos (0 = off).
    restart_at_s: float = 0.0
    restart_frac: float = 0.0
    restart_down_s: float = 1.0
    restart_lose_pieces: int = 1
    # Tracker HA fleet (round 12; 1 = the legacy single-tracker model,
    # bit-for-bit -- the 1k regression band depends on that).
    n_trackers: int = 1
    tracker_kill_at_s: float = 0.0
    tracker_kill: int = 0  # blob-0 owners die first (a miss-less kill)
    tracker_restart_after_s: float = 0.0  # 0 = stays dead
    tracker_down_mode: str = "refuse"  # "refuse" | "blackhole"
    tracker_fail_timeout_s: float = 5.0  # blackhole: announce budget
    tracker_breaker_fails: int = 3
    tracker_breaker_cooldown_s: float = 10.0
    # Gossip peer exchange (p2p/pex.py's model; OFF by default so legacy
    # runs replay bit-exact). Every pex_interval_s each peer offers each
    # conn up to pex_max_peers ids from its known-peer book; receivers
    # merge and dial through the SAME blacklist + capacity gates an
    # announce handout does -- so with every tracker dead the swarm
    # keeps discovering peers over the conns it already has.
    pex: bool = False
    pex_interval_s: float = 5.0
    pex_max_peers: int = 16
    # Total-outage drill: kill EVERY tracker at tracker_kill_at_s
    # (overrides tracker_kill's count).
    tracker_kill_all: bool = False

    def blobs(self) -> tuple[int, ...]:
        return self.blob_pieces or (self.num_pieces,)

    @property
    def fleet(self) -> bool:
        return self.n_trackers > 1


class _Peer:
    """Sim-side agent or origin. Policy objects are the production ones.

    Per-torrent state (``has``/``avail``/``conns``/``requests``) is a
    list indexed by blob; the uplink/downlink queues and the ConnState
    (which natively tracks per-torrent AND global budgets, as production
    does) are per-host."""

    __slots__ = (
        "pid", "origin", "join_t", "done_t", "blob_done_t", "has", "avail",
        "conns", "requests", "cs", "bl", "busy_until", "recv_until",
        "uplink_bps", "offline_until", "order", "incarnation",
        "tracker_health", "known",
    )

    def __init__(self, pid: PeerID, cfg: SimConfig, origin: bool, join_t: float):
        blobs = cfg.blobs()
        self.pid = pid
        self.origin = origin
        self.join_t = join_t
        self.done_t: Optional[float] = None
        self.blob_done_t: list[Optional[float]] = [None] * len(blobs)
        self.has: list[set[int]] = [
            set(range(n)) if origin else set() for n in blobs
        ]
        self.avail: list[dict[int, int]] = [{} for _ in blobs]
        self.conns: list[dict[PeerID, float]] = [{} for _ in blobs]
        self.requests = [
            RequestManager(
                pipeline_limit=cfg.pipeline_limit,
                timeout_seconds=cfg.piece_timeout_s,
            )
            for _ in blobs
        ]
        cs_config = ConnStateConfig(
            max_open_conns_per_torrent=cfg.max_conns_per_torrent,
            # Global cap can't bind with one torrent; keep it out of the way.
            max_global_conns=10 ** 9,
        )
        self.cs = ConnState(cs_config)
        # The blacklist lives OUTSIDE self.cs: ConnState.can_dial consults
        # its own blacklist with wall-clock time, which against sim-time
        # expiries would make results depend on host uptime. This
        # standalone production Blacklist is driven with explicit sim
        # `now`; cs.blacklist stays empty so can_dial's internal check is
        # inert.
        from kraken_tpu_torch.p2p.connstate import Blacklist

        self.bl = Blacklist(cs_config)
        self.busy_until = 0.0
        self.recv_until = 0.0
        self.uplink_bps = cfg.origin_uplink_bps if origin else cfg.uplink_bps
        self.offline_until = 0.0  # restart chaos: no serve/dial while down
        self.order: list[list[int]] = [[] for _ in blobs]  # arrival order
        # Fleet mode: the PRODUCTION breaker over tracker hosts, driven
        # with explicit sim `now` everywhere (like the Blacklist above).
        # One shared instance name keeps the per-filter gauge at a
        # single series however many sim peers exist.
        self.tracker_health: PassiveFilter | None = (
            PassiveFilter(
                fail_threshold=cfg.tracker_breaker_fails,
                cooldown_seconds=cfg.tracker_breaker_cooldown_s,
                name="sim-tracker-fleet",
            )
            if cfg.fleet else None
        )
        # PEX mode: the per-torrent known-peer book (p2p/pex.KnownPeers'
        # role) -- tracker handouts, established conns and received
        # gossip all land here; gossip sends and tracker-free redials
        # draw from it. Restart chaos keeps it: that is the peercache.
        self.known: list[set[PeerID]] = [set() for _ in blobs]
        # Bumped on every restart: events scheduled against the OLD
        # process (queued serves, in-flight pieces) must not charge or
        # feed the reborn one.
        self.incarnation = 0

    def offline(self, now: float) -> bool:
        return now < self.offline_until

    def complete(self) -> bool:
        return self.done_t is not None or self.origin

    def blob_complete(self, t: int) -> bool:
        return self.origin or self.blob_done_t[t] is not None


class _SimTracker:
    """One fleet tracker: an up/down flag and an independent in-memory
    membership store (per torrent) that dies with the process."""

    __slots__ = ("name", "up", "members", "member_set")

    def __init__(self, name: str, n_blobs: int):
        self.name = name
        self.up = True
        self.members: list[list[PeerID]] = [[] for _ in range(n_blobs)]
        self.member_set: list[set[PeerID]] = [set() for _ in range(n_blobs)]

    def wipe(self) -> None:
        for t in range(len(self.members)):
            self.members[t].clear()
            self.member_set[t].clear()


class SwarmSim:
    """``n_agents`` leechers x ``blobs()`` torrents, ``n_origins`` seeders."""

    def __init__(self, cfg: SimConfig):
        self.cfg = cfg
        self.blobs = cfg.blobs()
        self.hs = [
            InfoHash(f"{t:02x}" + "ab" * 31) for t in range(len(self.blobs))
        ]
        self.now = 0.0
        self._heap: list[tuple[float, int, Callable[[], None]]] = []
        self._seq = 0
        self.peers: dict[PeerID, _Peer] = {}
        self.announce_q = AnnounceQueue()
        self.announces = 0
        self.transfers = 0
        self.duplicates = 0
        self.busy_rejects = 0
        self.restarts = 0
        self._remaining = cfg.n_agents  # agents with >= 1 incomplete blob
        # Tracker swarm membership per torrent (each pid once, append-only:
        # the sim has no TTL churn). Handouts SAMPLE this, as the
        # production peerstore does; completeness is read from live peer
        # state, a one-interval-fresher view than the tracker's records.
        self._members: list[list[PeerID]] = [[] for _ in self.blobs]
        self._member_set: list[set[PeerID]] = [set() for _ in self.blobs]
        # Fleet mode state (cfg.n_trackers > 1; legacy single-tracker
        # runs never touch any of it, preserving bit-exact replays).
        self.trackers: list[_SimTracker] = [
            _SimTracker(f"tracker{i}", len(self.blobs))
            for i in range(cfg.n_trackers)
        ] if cfg.fleet else []
        self._tracker_by_name = {tr.name: tr for tr in self.trackers}
        self.announce_lat: list[float] = []
        self.announce_failovers = 0  # attempts that walked past a tracker
        self.announce_failures = 0   # walks that exhausted the whole fleet
        self.tracker_kills = 0
        self.pex_messages = 0  # gossip frames sent
        self.pex_dials = 0     # dials sourced from gossip/book, not announces

    # -- event plumbing ----------------------------------------------------

    def _at(self, t: float, fn: Callable[[], None]) -> None:
        self._seq += 1
        heapq.heappush(self._heap, (t, self._seq, fn))

    def run(self) -> dict:
        random.seed(self.cfg.seed)
        cfg = self.cfg
        for i in range(cfg.n_origins):
            pid = PeerID("ff" * 2 + f"{i:036x}")
            self.peers[pid] = _Peer(pid, cfg, origin=True, join_t=0.0)
            for t in range(len(self.blobs)):
                if cfg.fleet:
                    # The origin registers with each swarm's shard OWNER
                    # (where its production seed-announce would land) and
                    # keeps re-announcing via the queue -- that periodic
                    # announce is what re-registers it with the failover
                    # tracker after the owner dies.
                    tr = self._tracker_by_name[self._owner(t)]
                    tr.members[t].append(pid)
                    tr.member_set[t].add(pid)
                    self.announce_q.schedule(
                        (pid, t), cfg.announce_interval_s
                    )
                else:
                    self._members[t].append(pid)
                    self._member_set[t].add(pid)
        for i in range(cfg.n_agents):
            pid = PeerID(f"{i:040x}")
            self.peers[pid] = _Peer(pid, cfg, origin=False, join_t=0.0)
            for t in range(len(self.blobs)):
                self.announce_q.schedule((pid, t), 0.0)
        # One announce pump, as in the production scheduler: drain due
        # announces in batches rather than a timer per peer.
        self._at(0.0, self._announce_pump)
        self._at(cfg.churn_tick_s, self._churn_tick)
        if cfg.restart_frac > 0 and cfg.restart_at_s > 0:
            self._at(cfg.restart_at_s, self._restart_wave)
        if cfg.fleet and cfg.tracker_kill_at_s > 0 and (
            cfg.tracker_kill > 0 or cfg.tracker_kill_all
        ):
            self._at(cfg.tracker_kill_at_s, self._tracker_kill_wave)
        if cfg.pex:
            self._at(cfg.pex_interval_s, self._pex_tick)

        while self._heap and self.now <= cfg.max_sim_s and self._remaining:
            t, _seq, fn = heapq.heappop(self._heap)
            self.now = t
            fn()
        return self._report()

    # -- announce plane ----------------------------------------------------

    def _announce_pump(self) -> None:
        for key in self.announce_q.pop_ready(self.now, limit=10 ** 6):
            pid, t = key
            p = self.peers[pid]
            if p.offline(self.now):
                # Down agents re-announce when they come back.
                self.announce_q.schedule(key, p.offline_until)
                continue
            self._announce(p, t)
        if self._remaining:
            self._at(self.now + 0.05, self._announce_pump)

    def _info(self, pid: PeerID, t: int) -> PeerInfo:
        p = self.peers[pid]
        return PeerInfo(
            pid, "sim", 0, origin=p.origin, complete=p.blob_complete(t)
        )

    def _announce(self, p: _Peer, t: int) -> None:
        if self.cfg.fleet:
            self._announce_fleet(p, t)
            return
        self.announces += 1
        # Tracker side: record membership, sample candidates (as the
        # production peerstore does), order with the production policy.
        if p.pid not in self._member_set[t]:
            self._member_set[t].add(p.pid)
            self._members[t].append(p.pid)
        limit = self.cfg.handout_limit
        k = min(len(self._members[t]), limit + 1)
        candidates = random.sample(self._members[t], k)
        others = [self._info(q, t) for q in candidates if q != p.pid][:limit]
        handout = default_priority(others)
        if self.cfg.pex:
            for info in handout:
                p.known[t].add(info.peer_id)
        self.announce_q.schedule(
            (p.pid, t), self.now + self.cfg.announce_interval_s
        )
        if p.blob_complete(t):
            return  # seeders announce for discoverability, don't dial
        for info in handout:
            self._try_dial(p, info.peer_id, t)

    # -- tracker fleet (round 12) ------------------------------------------

    def _owner(self, t: int) -> str:
        return rendezvous_hash(
            self.hs[t].hex, [tr.name for tr in self.trackers], k=1
        )[0]

    def _announce_fleet(self, p: _Peer, t: int) -> None:
        """One announce through the fleet: rendezvous ranking (owner
        first), production-breaker ordering and probe admission, walk on
        failure -- the TrackerFleetClient policy in sim time. The walk's
        accumulated cost IS the announce latency the band test pins."""
        self.announces += 1
        names = [tr.name for tr in self.trackers]
        ranked = rendezvous_hash(self.hs[t].hex, names, k=len(names))
        health = p.tracker_health
        chosen: _SimTracker | None = None
        delay = 0.0
        for admit in (True, False):
            attempted = False
            for name in health.order(ranked, now=self.now):
                if admit:
                    if not health.try_acquire_probe(name, now=self.now + delay):
                        continue  # open-and-cooling, or probe taken
                attempted = True
                tr = self._tracker_by_name[name]
                if not tr.up:
                    # "refuse": a killed process RSTs instantly -- one
                    # hop to learn. "blackhole": the attempt burns the
                    # announce budget before the walk moves on.
                    delay += (
                        self.cfg.latency_s
                        if self.cfg.tracker_down_mode == "refuse"
                        else self.cfg.tracker_fail_timeout_s
                    )
                    self.announce_failovers += 1
                    health.observe(name, False, now=self.now + delay)
                    continue
                rtt = 2 * self.cfg.latency_s
                delay += rtt
                health.observe(name, True, rtt, now=self.now + delay)
                chosen = tr
                break
            if chosen is not None or attempted:
                break
            # Every tracker was skipped by the probe gate: walk again
            # all-in (serving badly beats serving nothing -- the same
            # degrade the production walk takes).
        self.announce_lat.append(delay)
        self.announce_q.schedule(
            (p.pid, t), self.now + delay + self.cfg.announce_interval_s
        )
        if chosen is None:
            self.announce_failures += 1  # whole fleet down: retry next tick
            return
        self._at(self.now + delay,
                 lambda: self._announce_apply(p, t, chosen))

    def _announce_apply(self, p: _Peer, t: int, tr: _SimTracker) -> None:
        """The announce lands at a live tracker: register membership in
        ITS store (re-forming the swarm there after a failover), sample
        a handout from what IT knows, dial."""
        if not tr.up or p.offline(self.now):
            return  # the tracker (or the announcer) died in flight
        if p.pid not in tr.member_set[t]:
            tr.member_set[t].add(p.pid)
            tr.members[t].append(p.pid)
        limit = self.cfg.handout_limit
        k = min(len(tr.members[t]), limit + 1)
        candidates = random.sample(tr.members[t], k)
        others = [self._info(q, t) for q in candidates if q != p.pid][:limit]
        handout = default_priority(others)
        if self.cfg.pex:
            for info in handout:
                p.known[t].add(info.peer_id)
        if p.blob_complete(t):
            return  # seeders announce for discoverability, don't dial
        for info in handout:
            self._try_dial(p, info.peer_id, t)

    def _tracker_kill_wave(self) -> None:
        """Kill the blob-0 shard owners first (a random victim could
        miss the shard under test entirely), wiping their in-memory
        stores -- exactly what a process death does. Optional revival
        brings them back EMPTY; announces re-form the swarm."""
        names = [tr.name for tr in self.trackers]
        ranked = rendezvous_hash(self.hs[0].hex, names, k=len(names))
        kill = (
            len(ranked) if self.cfg.tracker_kill_all
            else self.cfg.tracker_kill
        )
        for name in ranked[:kill]:
            tr = self._tracker_by_name[name]
            tr.up = False
            tr.wipe()
            self.tracker_kills += 1
            if self.cfg.tracker_restart_after_s > 0:
                self._at(
                    self.now + self.cfg.tracker_restart_after_s,
                    lambda tr=tr: setattr(tr, "up", True),
                )

    # -- conn plane --------------------------------------------------------

    def _try_dial(self, a: _Peer, bid: PeerID, t: int) -> None:
        # Sim-time blacklist check against the peer's standalone
        # Blacklist (see _Peer.bl for why it is not cs.blacklist).
        if a.bl.blocked(bid, self.hs[t], now=self.now):
            return
        if not a.cs.add_pending(bid, self.hs[t]):
            return
        self._at(self.now + self.cfg.latency_s,
                 lambda: self._dial_arrives(a, bid, t))

    def _dial_arrives(self, a: _Peer, bid: PeerID, t: int) -> None:
        b = self.peers[bid]
        if b.offline(self.now) or b.cs.at_capacity(self.hs[t]):
            # Polite busy frame -> soft blacklist, as the production
            # scheduler does on a busy rejection (scheduler.py:412). A
            # down host answers nothing; connection refused takes the
            # same soft-blacklist path in production.
            self.busy_rejects += 1
            self._at(self.now + self.cfg.latency_s, lambda: (
                a.cs.remove_pending(bid, self.hs[t]),
                a.bl.add(bid, self.hs[t], now=self.now, soft=True),
            ))
            return
        b.cs.promote(a.pid, self.hs[t])  # inbound: promote directly
        self._at(self.now + self.cfg.latency_s,
                 lambda: self._established(a, b, t))

    def _established(self, a: _Peer, b: _Peer, t: int) -> None:
        a.cs.promote(b.pid, self.hs[t])
        if self.cfg.pex:
            # A live conn IS peer knowledge ("conn"-sourced book entry).
            a.known[t].add(b.pid)
            b.known[t].add(a.pid)
        for x, y in ((a, b), (b, a)):
            if y.pid not in x.conns[t]:
                x.conns[t][y.pid] = self.now
                for i in y.has[t]:
                    x.avail[t][i] = x.avail[t].get(i, 0) + 1
        self._select(a, b, t)
        self._select(b, a, t)

    def _drop_conn(self, x: _Peer, y: _Peer, t: int) -> None:
        if y.pid not in x.conns[t]:
            return
        for a, b in ((x, y), (y, x)):
            del a.conns[t][b.pid]
            a.cs.remove(b.pid, self.hs[t])
            a.requests[t].clear_peer(b.pid)
            # Clamped decrement: an announce in flight when the conn drops
            # was never counted, so subtracting b's full has-set can
            # transiently undercount by one -- bounded by the latency
            # window, and preferable to per-conn piece snapshots (O(conns
            # x pieces) memory at 10k agents).
            for i in b.has[t]:
                n = a.avail[t].get(i, 0) - 1
                if n > 0:
                    a.avail[t][i] = n
                else:
                    a.avail[t].pop(i, None)

    def _churn_tick(self) -> None:
        cutoff = self.cfg.churn_idle_s
        for p in self.peers.values():
            for t in range(len(self.blobs)):
                for qid, last in list(p.conns[t].items()):
                    if self.now - last > cutoff:
                        self._drop_conn(p, self.peers[qid], t)
        if self._remaining:
            self._at(self.now + self.cfg.churn_tick_s, self._churn_tick)

    # -- gossip peer exchange ----------------------------------------------

    def _pex_tick(self) -> None:
        """One gossip round, modeling p2p/pex.py: every online peer
        offers each conn up to ``pex_max_peers`` ids from its known book
        (live conns included -- production's ``delta_for`` snapshots the
        live book). Gossip is NOT useful traffic (no churn exemption, as
        the dispatcher rules), and every dial -- on receive AND from the
        retry-loop redial below -- goes through the SAME blacklist +
        capacity gates an announce handout does."""
        cfg = self.cfg
        for p in self.peers.values():
            if p.offline(self.now):
                continue
            for t in range(len(self.blobs)):
                pool = p.known[t] | set(p.conns[t])
                pool.discard(p.pid)
                if not pool:
                    continue
                ordered = sorted(pool)
                for qid in list(p.conns[t]):
                    cand = [x for x in ordered if x != qid]
                    if len(cand) > cfg.pex_max_peers:
                        cand = random.sample(cand, cfg.pex_max_peers)
                    if not cand:
                        continue
                    self.pex_messages += 1
                    q = self.peers[qid]
                    self._at(
                        self.now + cfg.latency_s,
                        lambda q=q, t=t, cand=cand:
                            self._pex_receive(q, t, cand),
                    )
                # The scheduler's retry loop over the book: an
                # incomplete agent redials known peers it is not
                # connected to -- this is what un-strands an agent
                # whose every conn churned away while the trackers are
                # dead (its book is the only discovery plane left).
                if not p.origin and not p.blob_complete(t):
                    for pid in ordered:
                        if pid not in p.conns[t]:
                            self.pex_dials += 1
                            self._try_dial(p, pid, t)
        if self._remaining:
            self._at(self.now + cfg.pex_interval_s, self._pex_tick)

    def _pex_receive(self, q: _Peer, t: int, cand: list[PeerID]) -> None:
        if q.offline(self.now):
            return
        for pid in cand:
            if pid != q.pid and pid in self.peers:
                q.known[t].add(pid)
        if q.origin or q.blob_complete(t):
            return
        for pid in cand:
            if pid != q.pid and pid in self.peers and pid not in q.conns[t]:
                self.pex_dials += 1
                self._try_dial(q, pid, t)

    # -- restart chaos -----------------------------------------------------

    def _restart_wave(self) -> None:
        cfg = self.cfg
        agents = [
            p for p in self.peers.values()
            if not p.origin and not p.offline(self.now)
        ]
        victims = random.sample(
            agents, int(len(agents) * cfg.restart_frac)
        )
        for p in victims:
            self.restarts += 1
            was_complete = p.done_t is not None
            p.offline_until = self.now + cfg.restart_down_s
            p.incarnation += 1
            # The reborn process has EMPTY transfer queues: bytes queued
            # toward (or from) the dead one were never delivered and must
            # not phantom-saturate either bucket after rejoin.
            p.recv_until = 0.0
            p.busy_until = 0.0
            for t in range(len(self.blobs)):
                for qid in list(p.conns[t]):
                    self._drop_conn(p, self.peers[qid], t)
                # The debounced-bitfield crash window: the most recent
                # pieces may not have hit the sidecar. (Guarded: a -0
                # slice would mean "lose everything", not "lose none".)
                lost = (
                    p.order[t][-cfg.restart_lose_pieces:]
                    if cfg.restart_lose_pieces > 0 else []
                )
                for i in reversed(lost):
                    if i in p.has[t]:
                        p.has[t].discard(i)
                        p.order[t].remove(i)
                        if p.blob_done_t[t] is not None:
                            p.blob_done_t[t] = None
                # In-flight requests died with the process.
                p.requests[t] = RequestManager(
                    pipeline_limit=cfg.pipeline_limit,
                    timeout_seconds=cfg.piece_timeout_s,
                )
                self.announce_q.schedule((p.pid, t), p.offline_until)
            if was_complete and any(
                p.blob_done_t[t] is None for t in range(len(self.blobs))
            ):
                p.done_t = None
                self._remaining += 1

    # -- piece plane -------------------------------------------------------

    def _select(self, a: _Peer, b: _Peer, t: int) -> None:
        """``a`` asks the production RequestManager what to fetch from
        ``b`` and schedules the transfers."""
        if (
            a.origin or a.blob_done_t[t] is not None
            or b.pid not in a.conns[t] or a.offline(self.now)
        ):
            return
        missing = [i for i in range(self.blobs[t]) if i not in a.has[t]]
        if not missing:
            return
        chosen = a.requests[t].select(
            b.pid, b.has[t], missing, a.avail[t], now=self.now
        )
        for i in chosen:
            self._at(self.now + self.cfg.latency_s,
                     lambda i=i: self._serve(b, a, i, t))

    def _serve(self, b: _Peer, a: _Peer, i: int, t: int) -> None:
        """Request for piece ``i`` arrives at ``b``: FIFO-queue it on b's
        uplink (and a's downlink when caps are modeled)."""
        if i not in b.has[t] or b.offline(self.now) or a.offline(self.now):
            return  # raced ahead of an announce / host down; timeout re-requests
        if a.pid in b.conns[t]:
            b.conns[t][a.pid] = self.now  # a request is useful traffic
        # Sender and receiver each FIFO on their OWN bucket; completion is
        # when both have passed the bytes. Holding the sender's queue for
        # a slow receiver's duration instead (the first model tried)
        # head-of-line-blocks every other download behind one capped
        # receiver -- a wedge real multiplexed TCP does not have (a 10k
        # capped run completed 0 agents in 600 sim-seconds under it).
        up_start = max(self.now, b.busy_until)
        up_done = up_start + self.cfg.piece_bytes / b.uplink_bps
        b.busy_until = up_done
        done = up_done
        if self.cfg.downlink_bps > 0:
            dn_start = max(up_start, a.recv_until)
            dn_done = dn_start + self.cfg.piece_bytes / self.cfg.downlink_bps
            a.recv_until = dn_done
            done = max(done, dn_done)
        inc = a.incarnation
        sinc = b.incarnation
        self._at(done + self.cfg.latency_s,
                 lambda: self._on_piece(a, b, i, t, inc, sinc))

    def _on_piece(
        self, a: _Peer, b: _Peer, i: int, t: int, inc: int, sinc: int
    ) -> None:
        if a.offline(self.now) or inc != a.incarnation:
            return  # arrived at a dead (or since-restarted) process
        if sinc != b.incarnation:
            return  # the SENDER died mid-serve: its socket died with it
        self.transfers += 1
        if b.pid in a.conns[t]:
            a.conns[t][b.pid] = self.now  # payload is useful traffic
        a.requests[t].clear_piece(i, now=self.now)
        if i in a.has[t] or a.blob_done_t[t] is not None:
            self.duplicates += 1
            self._select(a, b, t)  # endgame duplicate: just keep pulling
            return
        a.has[t].add(i)
        a.order[t].append(i)
        # Announce the new piece to every conn (metadata hop).
        for cid in a.conns[t]:
            c = self.peers[cid]
            self._at(self.now + self.cfg.latency_s,
                     lambda a=a, c=c, i=i: self._on_announce_piece(c, a, i, t))
        if len(a.has[t]) == self.blobs[t]:
            a.blob_done_t[t] = self.now
            if all(d is not None for d in a.blob_done_t):
                a.done_t = self.now
                self._remaining -= 1
            return
        self._select(a, b, t)

    def _on_announce_piece(self, c: _Peer, a: _Peer, i: int, t: int) -> None:
        if a.pid not in c.conns[t]:
            return
        c.conns[t][a.pid] = self.now  # progress announce is useful traffic
        c.avail[t][i] = c.avail[t].get(i, 0) + 1
        self._select(c, a, t)

    # -- reporting ---------------------------------------------------------

    def _report(self) -> dict:
        lat = sorted(
            p.done_t - p.join_t
            for p in self.peers.values()
            if not p.origin and p.done_t is not None
        )
        n = len(lat)
        incomplete = self.cfg.n_agents - n
        q = (lambda f: lat[min(n - 1, int(f * n))]) if n else (lambda f: None)
        alat = sorted(self.announce_lat)
        na = len(alat)
        aq = (
            (lambda f: alat[min(na - 1, int(f * na))]) if na
            else (lambda f: None)
        )
        return {
            "agents": self.cfg.n_agents,
            "blobs": len(self.blobs),
            "completed": n,
            "incomplete": incomplete,
            "p50_s": q(0.50),
            "p99_s": q(0.99),
            "max_s": lat[-1] if n else None,
            "mean_s": statistics.fmean(lat) if n else None,
            "sim_end_s": self.now,
            "announces": self.announces,
            "announces_per_s": self.announces / self.now if self.now else 0.0,
            "transfers": self.transfers,
            "duplicate_transfers": self.duplicates,
            "busy_rejects": self.busy_rejects,
            "restarts": self.restarts,
            # Tracker fleet plane (None/0 outside fleet mode: legacy
            # announces are instantaneous in-model).
            "n_trackers": self.cfg.n_trackers,
            "announce_p50_s": aq(0.50),
            "announce_p99_s": aq(0.99),
            "announce_failovers": self.announce_failovers,
            "announce_failures": self.announce_failures,
            "tracker_kills": self.tracker_kills,
            # Gossip plane (0 outside pex mode).
            "pex_messages": self.pex_messages,
            "pex_dials": self.pex_dials,
        }


def run_sim(**overrides) -> dict:
    return SwarmSim(SimConfig(**overrides)).run()
