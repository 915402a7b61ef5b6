"""The torrent scheduler: public ``download()`` + swarm orchestration.

Mirrors uber/kraken ``lib/torrent/scheduler`` (single event loop owning all
torrent state; blocking ``Download(namespace, digest)``; announce ticks;
conn management; seeding-by-existence for origins) -- upstream path,
unverified; SURVEY.md SS2.2/SS3.1. The reference's single-goroutine
invariant maps to the asyncio loop; its event structs map to plain awaits.

Collaborators are injected as small interfaces so in-process swarm tests
(SURVEY.md SS4 tier 3) can fake the tracker:

- ``metainfo_client.get(namespace, digest) -> MetaInfo``
- ``announce_client.announce(digest, info_hash, namespace, complete)
  -> (list[PeerInfo], interval_seconds)``

The port's copy of ``kraken_tpu.p2p.scheduler`` without the multi-core
data plane (the forked seed-serve and leech workers of the reference's
``p2p/shardpool.py``): every conn runs on this loop, and a config that
asks for workers is refused (:func:`refuse_data_plane_workers`). Each
agent's received pieces are verified by its archive's
``BatchedVerifier``, on the card by default.
"""

from __future__ import annotations

import asyncio
import contextlib
import logging
import random
import secrets
from typing import Optional, Protocol

from kraken_tpu_torch.core.digest import Digest
from kraken_tpu_torch.core.metainfo import InfoHash, MetaInfo
from kraken_tpu_torch.core.peer import PeerID, PeerInfo
from kraken_tpu_torch.p2p.conn import (
    Conn,
    ConnClosedError,
    HandshakeResult,
    PeerBusyError,
    handshake_inbound,
    handshake_outbound,
)
from kraken_tpu_torch.p2p.announcequeue import AnnounceQueue
from kraken_tpu_torch.p2p.connstate import ConnState, ConnStateConfig
from kraken_tpu_torch.p2p.dispatch import Dispatcher
from kraken_tpu_torch.p2p.networkevent import NoopProducer, Producer
from kraken_tpu_torch.p2p.pex import (
    MAX_ENTRIES_PER_MESSAGE,
    KnownPeers,
    PeerCache,
    PexConfig,
    PexManager,
)
from kraken_tpu_torch.p2p.piecerequest import RequestManager
from kraken_tpu_torch.p2p.storage import Torrent
from kraken_tpu_torch.p2p.wire import Message, WireError, send_message
from kraken_tpu_torch.utils import failpoints, trace
from kraken_tpu_torch.utils.backoff import DecorrelatedJitter
from kraken_tpu_torch.utils.bandwidth import BandwidthLimiter
from kraken_tpu_torch.utils.bufpool import BufferPool
from kraken_tpu_torch.utils.dedup import RequestCoalescer
from kraken_tpu_torch.utils.metrics import REGISTRY, FailureMeter
from kraken_tpu_torch.utils.slo import CANARY_NAMESPACE, SLO

_log = logging.getLogger("kraken.p2p")

# StreamReader buffer high-water mark for P2P conns. asyncio's 64 KiB
# default pauses the transport ~16x inside one 1 MiB piece frame
# (pause/resume flow-control round-trips cost ~20% pair goodput in the
# reference's pair profile); 4 MiB holds a whole piece.
_WIRE_BUF = 4 << 20

_announce_failures = FailureMeter(
    "announce_failures_total",
    "Tracker announce attempts that raised (retried next interval)",
    _log,
)


class _AtCapacity(Exception):
    """Inbound conn rejected for capacity (accept path sends a busy frame)."""


class MetaInfoClient(Protocol):
    async def get(self, namespace: str, d: Digest) -> MetaInfo: ...


class AnnounceClient(Protocol):
    async def announce(
        self, d: Digest, h: InfoHash, namespace: str, complete: bool
    ) -> tuple[list[PeerInfo], float]: ...


class TorrentArchive(Protocol):
    def create_torrent(self, metainfo: MetaInfo) -> Torrent: ...


def refuse_data_plane_workers(config: "SchedulerConfig") -> None:
    """Raise ``ValueError`` when ``config`` asks for worker processes of
    the multi-core data plane (``data_plane_workers`` or
    ``leech_workers`` above 0), which the port does not have yet (ROADMAP
    A7g): running such a config on the main loop alone would quietly
    serve it single-core."""
    asked = {
        k: getattr(config, k) for k in ("data_plane_workers", "leech_workers")
        if getattr(config, k)
    }
    if asked:
        raise ValueError(
            f"scheduler {asked}: the multi-core data plane (ShardPool) is"
            " not ported yet (ROADMAP A7g); set both to 0"
        )


class SchedulerConfig:
    def __init__(
        self,
        announce_interval_seconds: float = 3.0,
        dial_timeout_seconds: float = 5.0,
        retry_tick_seconds: float = 2.0,
        conn_state: ConnStateConfig | None = None,
        seed_on_complete: bool = True,
        max_announce_rate: float = 100.0,
        announce_tick_seconds: float = 0.2,
        seed_announce_interval_seconds: float | None = None,
        piece_pipeline_limit: int = 16,
        piece_timeout_seconds: float = 8.0,
        conn_churn_idle_seconds: float = 4.0,
        wire_send_batch: int = 16,
        bufpool_budget_mb: int = 256,
        data_plane_workers: int = 0,
        leech_workers: int = 0,
        leech_ring_mb: int = 32,
        max_announce_inflight: int = 32,
    ):
        self.announce_interval = announce_interval_seconds
        self.dial_timeout = dial_timeout_seconds
        self.retry_tick = retry_tick_seconds
        self.conn_state = conn_state or ConnStateConfig()
        self.seed_on_complete = seed_on_complete
        # Announce pacing (announcequeue): the global cap keeps announce
        # load O(rate) however many torrents seed; complete torrents
        # re-announce on the longer seed interval.
        self.max_announce_rate = max_announce_rate
        self.announce_tick = announce_tick_seconds
        # 3x, not more: seeders must re-announce inside the tracker's peer
        # TTL (default 30 s vs 9 s here) or they vanish from handouts.
        self.seed_announce_interval = (
            seed_announce_interval_seconds
            if seed_announce_interval_seconds is not None
            else announce_interval_seconds * 3
        )
        # In-flight piece requests per conn. Measured (bench_swarm, loopback
        # pair): 4 -> 71 MB/s, 16 -> 82, 64 -> 82 -- 16 saturates the
        # request-response turnaround without deep per-peer buffering.
        self.piece_pipeline_limit = piece_pipeline_limit
        self.piece_timeout = piece_timeout_seconds
        self.conn_churn_idle = conn_churn_idle_seconds
        # Wire-plane knobs (docs/OPERATIONS.md "Wire plane"):
        # max frames corked into one vectored send per drain(), and the
        # recv payload pool's retained-byte budget.
        self.wire_send_batch = wire_send_batch
        self.bufpool_budget_mb = bufpool_budget_mb
        # The multi-core data plane (the reference's p2p/shardpool.py:
        # seed-serve and leech worker processes; docs/OPERATIONS.md
        # "Data-plane workers", "Leech shard plane") is not in the port:
        # a config that asks for workers is refused, never quietly run
        # on the main loop alone (refuse_data_plane_workers).
        # leech_ring_mb sizes EACH leech worker's ring; as in the
        # reference, nothing reads it while leech_workers is 0, which is
        # all the port takes.
        self.data_plane_workers = data_plane_workers
        self.leech_workers = leech_workers
        self.leech_ring_mb = leech_ring_mb
        refuse_data_plane_workers(self)
        # PER-AGENT announce concurrency cap. The rate cap bounds how
        # many announces START per second; during a full tracker outage
        # every in-flight announce hangs to its timeout, and without a
        # concurrency bound N failing torrents stack N timed-out walks
        # -- a storm of busywork against dead hosts, re-synchronized at
        # every revival. The per-torrent decorrelated-jitter backoff
        # desyncs the retries; this bounds how many run at once.
        self.max_announce_inflight = max(1, max_announce_inflight)

    @classmethod
    def from_dict(cls, doc: dict) -> "SchedulerConfig":
        """Build from the YAML ``scheduler:`` section; ``conn_state`` is a
        nested dict of ConnStateConfig fields."""
        doc = dict(doc)
        conn = doc.pop("conn_state", None)
        import inspect

        allowed = set(inspect.signature(cls.__init__).parameters) - {
            "self", "conn_state"
        }
        unknown = set(doc) - allowed
        if unknown:
            raise ValueError(f"unknown scheduler config keys: {sorted(unknown)}")
        return cls(
            conn_state=ConnStateConfig.from_dict(conn) if conn else None,
            **doc,
        )


class _TorrentControl:
    def __init__(
        self,
        torrent: Torrent,
        namespace: str,
        dispatcher: Dispatcher,
        known_peers_cap: int = 256,
    ):
        self.torrent = torrent
        self.namespace = namespace
        self.dispatcher = dispatcher
        self.tasks: set[asyncio.Task] = set()
        # Dialable-peer book for the PEX plane (p2p/pex.py): fed by
        # tracker announces, handshakes carrying a listen port, gossip,
        # and the peercache -- what this node gossips onward and what
        # the peercache persists for crash redials.
        self.known_peers = KnownPeers(cap=known_peers_cap)
        # The download's trace context (utils/trace.py): announce and
        # dial tasks are spawned from long-lived pump loops, OUTSIDE the
        # downloader's contextvar scope, so the control carries the
        # parent explicitly for them to join. None for pure seeders.
        self.trace_parent: trace.ParentContext | None = None
        # Decorrelated-jitter carry for FAILED announces (0 = healthy):
        # a dead tracker must not make every torrent's retry land on the
        # same tick fleet-wide (the synchronized-storm shape), and the
        # first retry should come FASTER than a full interval so
        # failover finds peers quickly.
        self.announce_backoff = 0.0

    def spawn(self, coro) -> asyncio.Task:
        """Track a task for cleanup; finished tasks self-prune (a seeding
        control dials on every announce tick -- an append-only list would
        grow forever)."""
        task = asyncio.create_task(coro)
        self.tasks.add(task)
        task.add_done_callback(self.tasks.discard)
        return task

    def cancel_tasks(self) -> None:
        for t in list(self.tasks):
            t.cancel()


class Scheduler:
    """One per process. Owns the listening socket and all torrent state."""

    def __init__(
        self,
        peer_id: PeerID,
        ip: str,
        port: int,
        archive: TorrentArchive,
        metainfo_client: MetaInfoClient,
        announce_client: AnnounceClient,
        config: SchedulerConfig | None = None,
        bandwidth: BandwidthLimiter | None = None,
        events: Producer | None = None,
        is_origin: bool = False,
        metainfo_resolver=None,
        delta=None,  # p2p.delta.DeltaPlanner (agents; optional)
        pex: PexConfig | None = None,
        peercache_path: str | None = None,
    ):
        self.peer_id = peer_id
        self.ip = ip
        self.port = port
        self.archive = archive
        self.metainfo_client = metainfo_client
        self.announce_client = announce_client
        self.config = config or SchedulerConfig()
        self.bandwidth = bandwidth
        self.events = events or NoopProducer()
        self.is_origin = is_origin
        # Origin side: resolve a blob digest hex -> MetaInfo for inbound
        # handshakes on blobs we seed but have no live control for.
        self._metainfo_resolver = metainfo_resolver
        # Delta-transfer plane (p2p/delta.py): when set, downloads run a
        # prefill pass first -- pieces assembled from a local near-
        # duplicate base (plus origin byte-range fetches) land in the
        # piece bitfield before the swarm pull, which then fetches only
        # what delta could not cover. Gated inside the planner on its
        # live-reloadable config; a prefill failure never fails the pull.
        self._delta = delta
        self._convert_tasks: set[asyncio.Task] = set()  # strong refs
        self.conn_state = ConnState(self.config.conn_state)
        # Which Conn instance owns each conn-state active slot: a stale
        # conn's close must never release a slot a newer conn has taken.
        self._conn_owners: dict[tuple[PeerID, InfoHash], Conn] = {}
        self._controls: dict[InfoHash, _TorrentControl] = {}
        # digest -> info hash: unseed must be O(1), not a scan -- a
        # watermark eviction sweep unseeds many blobs back to back.
        self._digest_to_hash: dict[Digest, InfoHash] = {}
        self._coalescer: RequestCoalescer = RequestCoalescer()
        # One payload pool per scheduler, shared by every conn: the piece
        # pipeline bounds concurrent leases, the budget bounds retained
        # free bytes (utils/bufpool.py).
        self._bufpool = BufferPool(
            budget_bytes=self.config.bufpool_budget_mb << 20
        )
        self._server: Optional[asyncio.base_events.Server] = None
        self._announce_queue = AnnounceQueue()
        self._announce_pump_task: Optional[asyncio.Task] = None
        self._announce_tasks: set[asyncio.Task] = set()
        # PEX gossip plane (p2p/pex.py): receive is merged behind the
        # connstate blacklist in _on_pex; the send pump gossips deltas
        # on existing conns. SIGHUP live-reloads via reload_pex().
        self.pex_config = pex or PexConfig()
        self._pex = PexManager(self.pex_config)
        self._pex_task: Optional[asyncio.Task] = None
        # Disk-backed last-known-peers cache: loaded once at start(),
        # merged+flushed periodically, seeding redials (and serving
        # metainfo) across an agent restart during a tracker outage.
        self._peercache: Optional[PeerCache] = (
            PeerCache(
                peercache_path,
                ttl_seconds=self.pex_config.peercache_ttl_seconds,
            )
            if peercache_path and self.pex_config.peercache
            else None
        )
        self._peercache_doc: dict[str, dict] = {}
        self._peercache_task: Optional[asyncio.Task] = None
        # Lameduck drain (docs/OPERATIONS.md "Degradation plane"): stop
        # announcing and refuse NEW conns, but keep serving established
        # ones so in-flight pieces finish. Entered by SIGTERM or
        # POST /debug/lameduck; the tracker's peer TTL then ages this
        # node out of handouts.
        self.lameduck = False
        # Terminal: set by stop(). A download racing stop past its
        # metainfo await must not create a fresh control (whose
        # _retry_loop nothing would ever cancel -- stop already swept
        # self._controls).
        self._stopped = False

    # -- lifecycle ---------------------------------------------------------

    def reload(self, config: SchedulerConfig) -> None:
        """Live config swap (the reference's ReloadableScheduler). Pacing,
        timeouts, and conn limits apply from the next tick or admission
        decision; per-torrent dispatchers keep their pipeline settings
        until their torrent is recreated (new torrents use the new
        values). No torrent state is dropped. A config that asks for the
        multi-core data plane's workers raises ``ValueError`` and is not
        applied."""
        refuse_data_plane_workers(config)
        self.config = config
        self.conn_state.reconfigure(config.conn_state)
        self._bufpool.set_budget(config.bufpool_budget_mb << 20)
        _log.info(
            "scheduler config reloaded",
            extra={
                "wire_send_batch": config.wire_send_batch,
                "bufpool_budget_mb": config.bufpool_budget_mb,
                "max_announce_rate": config.max_announce_rate,
            },
        )

    def reload_pex(self, config: PexConfig) -> None:
        """Live swap of the YAML ``pex:`` section (SIGHUP): cadence,
        budgets, and the enable switches apply from the next tick or
        received frame; dedup state survives (it is correctness, not
        tuning). The peercache path is fixed at construction."""
        self.pex_config = config
        self._pex.reconfigure(config)
        _log.info("pex config reloaded")

    async def start(self) -> None:
        self._server = await asyncio.start_server(
            self._accept, host=self.ip, port=self.port, limit=_WIRE_BUF
        )
        if self.port == 0:
            self.port = self._server.sockets[0].getsockname()[1]
        self._announce_pump_task = asyncio.create_task(self._announce_pump())
        self._pex_task = asyncio.create_task(self._pex_pump())
        if self._peercache is not None:
            # Load off-loop (disk read); tolerant of anything on disk.
            self._peercache_doc = await asyncio.to_thread(
                self._peercache.load
            )
            self._peercache_task = asyncio.create_task(
                self._peercache_flush_loop()
            )

    async def stop(self) -> None:
        self._stopped = True
        if self._announce_pump_task is not None:
            self._announce_pump_task.cancel()
        if self._pex_task is not None:
            self._pex_task.cancel()
        if self._peercache_task is not None:
            self._peercache_task.cancel()
        if self._peercache is not None:
            # Final snapshot while the controls still exist: a planned
            # restart must resume with the freshest peer book, not the
            # last periodic flush's.
            with contextlib.suppress(Exception):
                await self._flush_peercache()
        for t in list(self._announce_tasks):
            t.cancel()
        for t in list(self._convert_tasks):
            # Safe to cut: convert_to_chunks runs inside ONE to_thread
            # hop, so a cancel lands before it starts or after it
            # finished -- never mid-conversion.
            t.cancel()
        for ctl in list(self._controls.values()):
            ctl.cancel_tasks()
            ctl.dispatcher.close()
        self._controls.clear()
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()

    @property
    def addr(self) -> str:
        return f"{self.ip}:{self.port}"

    @property
    def num_active_conns(self) -> int:
        """Live peer conns -- the drain loop's quiesce signal."""
        return len(self._conn_owners)

    def enter_lameduck(self) -> None:
        """Drain mode: seed announces stop (the tracker's peer TTL ages
        this node out of handouts) and new INBOUND conns are refused --
        but in-flight downloads keep announcing and dialing: "let
        in-flight work finish" includes a download that has not found
        its peers yet, and the HTTP layer already refuses NEW download
        requests while draining. Established conns keep serving until
        they complete and churn out; assembly's drain() waits on
        :attr:`num_active_conns`."""
        self.lameduck = True
        _log.info("scheduler entering lameduck drain")

    # -- public API --------------------------------------------------------

    async def download(self, namespace: str, d: Digest) -> None:
        """Download blob ``d`` via the swarm; returns when it is complete
        in local storage. Concurrent calls for one blob coalesce."""
        await self._coalescer.get(d.hex, lambda: self._download(namespace, d))

    async def _download(self, namespace: str, d: Digest) -> None:
        start = asyncio.get_running_loop().time()
        # The pull's root-most p2p span: a child of the HTTP server span
        # when the download came through an agent endpoint, a fresh
        # sampled-or-not root for direct callers. Announce/dial tasks
        # join via ctl.trace_parent (they run outside this context).
        with trace.span(
            "p2p.download", digest=d.hex[:12], namespace=namespace,
        ) as sp:
            plan_t0 = asyncio.get_running_loop().time()
            try:
                metainfo = await self.metainfo_client.get(namespace, d)
            except asyncio.CancelledError:
                raise
            except Exception:
                # Tracker dark (total outage): the peercache may hold
                # this blob's metainfo from a pull that was in flight
                # before a restart -- the ONLY way a fresh boot can
                # rejoin its swarm with every tracker down. No cache
                # record: the original failure stands, typed as-is.
                metainfo = self._peercache_metainfo(d)
                if metainfo is None:
                    raise
                REGISTRY.counter(
                    "pex_peercache_metainfo_hits_total",
                    "Metainfo served from the peercache because every"
                    " tracker fetch failed",
                ).inc()
            if (
                self._delta is not None
                and metainfo.info_hash not in self._controls
            ):
                # Prefill BEFORE the control exists: the control's
                # Torrent (and its dispatcher's done future) must be
                # built from the post-prefill bitfield -- a fully
                # prefilled blob then completes without a single conn.
                try:
                    await self._delta.prefill(metainfo, namespace)
                except Exception:
                    _log.warning(
                        "delta prefill failed; full swarm pull",
                        extra={"digest": d.hex}, exc_info=True,
                    )
            plan_wall = asyncio.get_running_loop().time() - plan_t0
            ctl = self._get_or_create_control(metainfo, namespace)
            # Stage split for the torrent_summary rollup: "plan" is
            # everything before the swarm could move a byte (metainfo
            # fetch + delta prefill).
            ctl.dispatcher.stage_walls["plan"] += plan_wall
            if sp is not None and ctl.trace_parent is None:
                ctl.trace_parent = trace.ParentContext(
                    sp.trace_id, sp.span_id, sp.sampled
                )
            try:
                await asyncio.shield(ctl.dispatcher.done)
            finally:
                # The pull is over (or failed): seed-phase re-announces
                # must not keep joining -- and inflating -- the
                # download's trace for the torrent's whole seeding life;
                # from here they are their own sampled-or-not roots.
                ctl.trace_parent = None
        # Per-torrent lifecycle summary (the reference's torrentlog):
        # one line per completed download with the operative numbers.
        _log.info(
            "torrent complete",
            extra={
                "digest": d.hex,
                "namespace": namespace,
                "bytes": metainfo.length,
                "pieces": metainfo.num_pieces,
                "seconds": round(
                    asyncio.get_running_loop().time() - start, 3
                ),
                "peers": ctl.dispatcher.num_peers,
            },
        )
        # Become discoverable as a seeder immediately (still rate-paced).
        self._announce_queue.schedule(metainfo.info_hash, 0.0)
        if self._delta is not None:
            # Chunk-tier handover (store/chunkstore.py): a completed
            # pull whose recipe the prefill planner fetched converts to
            # manifest + refcounted chunks, so the NEXT near-duplicate
            # build stores only its unique bytes. A BACKGROUND task --
            # conversion re-reads the whole blob, and blocking here
            # would add seconds to every large pull's completion; every
            # serve path picks its representation atomically
            # (store/serve.py, open_cache_reader), so racing readers
            # are safe. Failures never fail the pull: the blob just
            # stays flat.
            t = asyncio.create_task(
                self._chunk_convert(metainfo, namespace)
            )
            self._convert_tasks.add(t)
            t.add_done_callback(self._convert_tasks.discard)
        if not self.config.seed_on_complete:
            # Download-only mode: tear the torrent down instead of
            # lazily seeding it (e.g. bandwidth-constrained edge agents).
            self._remove_control(metainfo.info_hash)

    async def _chunk_convert(self, metainfo: MetaInfo, namespace: str) -> None:
        try:
            await self._delta.chunk_completed(metainfo, namespace)
        except Exception:
            _log.warning(
                "chunk-tier conversion failed; blob stays flat",
                extra={"digest": metainfo.digest.hex}, exc_info=True,
            )

    def _remove_control(self, h: InfoHash) -> None:
        ctl = self._controls.pop(h, None)
        if ctl is None:
            return
        self._digest_to_hash.pop(ctl.torrent.metainfo.digest, None)
        self._announce_queue.remove(h)
        ctl.cancel_tasks()
        ctl.dispatcher.close()
        self.conn_state.clear_torrent(h)
        self.events.emit("remove_torrent", h.hex)

    def seed(self, metainfo: MetaInfo, namespace: str) -> None:
        """Start seeding a complete local blob (origin startup / post-
        download agents keep seeding automatically)."""
        self._get_or_create_control(metainfo, namespace)

    def seed_partial(self, metainfo: MetaInfo, namespace: str, path: str) -> None:
        """Seed a blob whose bytes are all on disk but NOT yet committed
        (serve-while-ingest): the torrent reads straight from the upload
        spool at ``path``. Pulls of a still-ingesting blob start now;
        :meth:`promote_partial` repoints at the cache path post-commit,
        :meth:`unseed` tears down if the commit fails."""
        torrent = Torrent(
            self.archive.store, metainfo, self.archive.verifier,
            complete=True, path=path,
        )
        self._get_or_create_control(metainfo, namespace, torrent=torrent)

    def promote_partial(self, d: Digest, path: str) -> None:
        """Commit landed: repoint blob ``d``'s spool-backed torrent at its
        committed cache path. No-op when no such torrent is live."""
        h = self._digest_to_hash.get(d)
        if h is None:
            return
        ctl = self._controls.get(h)
        if ctl is not None and getattr(ctl.torrent, "spool_backed", False):
            ctl.torrent.promote(path)

    def unseed(self, d: Digest) -> bool:
        """Stop seeding blob ``d`` (DELETE / cache eviction): the torrent
        control, its announces, and its conns go away -- a seeder must not
        keep advertising bytes it can no longer serve. False if no torrent
        for ``d`` is active."""
        h = self._digest_to_hash.get(d)
        if h is None:
            return False
        self._remove_control(h)
        return True

    def stage_walls(self, d: Digest) -> dict | None:
        """The per-pull stage split (plan/dial/piece_wait/verify/
        write walls) of blob ``d``'s live torrent, or None once the
        control is gone.  The canary prober (utils/canary.py) reads it
        right after a probe pull to attribute where a slow canary spent
        its time."""
        h = self._digest_to_hash.get(d)
        if h is None:
            return None
        ctl = self._controls.get(h)
        if ctl is None:
            return None
        return ctl.dispatcher.stage_split()

    # -- torrent control ---------------------------------------------------

    def _get_or_create_control(
        self, metainfo: MetaInfo, namespace: str, torrent=None
    ) -> _TorrentControl:
        h = metainfo.info_hash
        ctl = self._controls.get(h)
        if ctl is not None:
            return ctl
        if self._stopped:
            # stop() already swept the controls; creating one now would
            # leak its retry loop (and re-announce a dead node).
            raise RuntimeError("scheduler is stopped")
        if torrent is None:
            torrent = self.archive.create_torrent(metainfo)
        dispatcher = Dispatcher(
            torrent,
            requests=RequestManager(
                pipeline_limit=self.config.piece_pipeline_limit,
                timeout_seconds=self.config.piece_timeout,
            ),
            on_peer_failure=lambda pid, reason: self._peer_failed(pid, h, reason),
            churn_idle_seconds=self.config.conn_churn_idle,
            events=self.events,
            on_peer_exchange=lambda pid, hdr: self._on_pex(pid, h, hdr),
        )
        ctl = _TorrentControl(
            torrent, namespace, dispatcher,
            known_peers_cap=self.pex_config.max_known_peers,
        )
        self._controls[h] = ctl
        self._digest_to_hash[torrent.metainfo.digest] = h
        # First announce ASAP (downloads need peers now); re-announces are
        # paced by the queue pump under the global rate cap.
        self._announce_queue.schedule(h, 0.0)
        ctl.spawn(self._retry_loop(ctl))
        self._seed_from_peercache(ctl)
        self.events.emit(
            "add_torrent", h.hex, blob=metainfo.name, complete=torrent.complete()
        )
        return ctl

    def _peer_failed(self, peer_id: PeerID, h: InfoHash, reason: str) -> None:
        self.conn_state.blacklist.add(peer_id, h)
        self.conn_state.remove(peer_id, h)
        self.events.emit("blacklist_conn", h.hex, peer=peer_id.hex, reason=reason)

    # -- peer exchange (PEX) -----------------------------------------------

    def _on_pex(self, sender: PeerID, h: InfoHash, header: dict) -> None:
        """One received PEER_EXCHANGE frame (sync, on the recv pump via
        the dispatcher). A ValueError out of ingest -- shape garbage or
        an entry flood -- propagates into the dispatcher's _fail_peer
        ban path, exactly like a bad piece. Accepted peers merge behind
        the SAME gates announces use: _maybe_dial goes through
        conn_state.add_pending, so a blacklisted peer gossiped back in
        stays blacklisted, and the token-bucket dial budget keeps even
        an honest gossip storm from flooding the dial queue."""
        ctl = self._controls.get(h)
        if ctl is None:
            return
        # Failpoint p2p.pex.drop: lossy gossip plane -- discovery must
        # still converge off later ticks / other senders.
        if failpoints.fire("p2p.pex.drop"):
            return
        if not self.pex_config.enabled:
            return
        now = asyncio.get_running_loop().time()
        fresh, drops = self._pex.ingest(h.hex, sender, header, now)
        src = f"gossip:{sender.hex}"
        for pid in drops:
            ctl.known_peers.drop(pid, src)
        for peer in fresh:
            if peer.peer_id == self.peer_id:
                continue
            if not ctl.known_peers.add(peer, src):
                continue  # book full of authoritative entries
            if ctl.torrent.complete():
                continue  # seeders learn addrs but never dial
            if not self._pex.try_dial_budget():
                continue
            self._maybe_dial(ctl, peer)

    async def _pex_pump(self) -> None:
        """ONE task gossips for every conn: each jittered tick computes
        per-conn deltas (what that conn has not heard yet, capped at the
        send budget) and spawns the sends -- never awaiting a send
        inline, so one stuck peer cannot stall the plane's cadence."""
        rng = random.Random()
        while True:
            cfg = self.pex_config  # re-read: reload_pex swaps it live
            interval = max(1.0, cfg.interval_seconds)
            await asyncio.sleep(
                interval * (1.0 + rng.uniform(-cfg.jitter, cfg.jitter))
            )
            if not cfg.send_enabled:
                continue
            self._gossip_tick()

    def _gossip_tick(self) -> None:
        frames = 0
        for key, conn in list(self._conn_owners.items()):
            pid, h = key
            ctl = self._controls.get(h)
            if ctl is None:
                continue
            added, dropped = self._pex.delta_for(
                key, pid, ctl.known_peers.snapshot()
            )
            # Failpoint p2p.pex.flood: a hostile peer ignoring the send
            # budget -- the RECEIVER must ban us (entry-count violation),
            # not balloon its dial queue.
            if failpoints.fire("p2p.pex.flood"):
                added = [
                    {"id": secrets.token_hex(20), "ip": "203.0.113.1",
                     "p": 1 + (i % 65000)}
                    for i in range(MAX_ENTRIES_PER_MESSAGE + 1)
                ]
            if not added and not dropped:
                continue
            frames += 1
            ctl.spawn(self._send_pex(conn, added, dropped))
        if frames:
            with trace.span("p2p.pex.gossip", frames=frames):
                pass

    async def _send_pex(
        self, conn: Conn, added: list[dict], dropped: list[str]
    ) -> None:
        with contextlib.suppress(ConnClosedError):
            await conn.send(Message.peer_exchange(added, dropped))

    # -- peercache (disk-backed last-known peers) --------------------------

    def _peercache_metainfo(self, d: Digest) -> MetaInfo | None:
        """Cached metainfo for blob ``d``, from a pull that was in
        flight when the cache was last flushed. None on any miss or
        decode problem (the cache must never add failure modes)."""
        for rec in self._peercache_doc.values():
            try:
                mi = MetaInfo.deserialize(rec["metainfo"].encode())
            except Exception:
                _log.debug(
                    "peercache record undecodable; skipped", exc_info=True
                )
                continue
            if mi.digest == d:
                return mi
        return None

    def _seed_from_peercache(self, ctl: _TorrentControl) -> None:
        """New incomplete control: seed its dial set with the cached
        last-known peers (TTL-aged at load). Dials ride the normal
        connstate gates; the first successful tracker announce then
        refreshes the book with authoritative records."""
        if ctl.torrent.complete():
            return
        rec = self._peercache_doc.get(ctl.torrent.info_hash.hex)
        if rec is None:
            return
        seeded = 0
        for peer in rec["peers"]:
            if peer.peer_id == self.peer_id:
                continue
            ctl.known_peers.add(peer, "cache")
            self._maybe_dial(ctl, peer)
            seeded += 1
        if seeded:
            REGISTRY.counter(
                "pex_peercache_seeds_total",
                "Dial candidates seeded from the disk peercache at"
                " torrent creation",
            ).inc(seeded)

    async def _peercache_flush_loop(self) -> None:
        while True:
            await asyncio.sleep(self.pex_config.peercache_flush_seconds)
            try:
                await self._flush_peercache()
            except asyncio.CancelledError:
                raise
            except Exception:
                _log.warning("peercache flush failed", exc_info=True)

    async def _flush_peercache(self) -> None:
        """Merge live in-flight torrents over the loaded doc (carried
        records keep their TTL clocks) and persist off-loop. Completed
        pulls drop out -- a restart serves them from the store."""
        if self._peercache is None:
            return
        doc = dict(self._peercache_doc)
        for h, ctl in list(self._controls.items()):
            if ctl.torrent.complete():
                doc.pop(h.hex, None)
                continue
            peers = [
                p for p in ctl.known_peers.snapshot()
                if p.peer_id != self.peer_id
            ]
            if not peers:
                continue
            doc[h.hex] = {
                "namespace": ctl.namespace,
                "metainfo": ctl.torrent.metainfo.serialize().decode(),
                "peers": peers,
            }
        self._peercache_doc = doc
        await asyncio.to_thread(self._peercache.save, doc)

    # -- announce / dial ---------------------------------------------------

    async def _announce_pump(self) -> None:
        """ONE task paces every torrent's announces (announcequeue): each
        tick drains at most rate*tick due torrents, oldest-due first, so
        tracker load is bounded by config however many torrents exist."""
        carry = 0.0  # fractional budget: caps below 1/tick must still hold
        while True:
            cfg = self.config  # re-read: reload() swaps the config live
            carry = min(
                carry + cfg.max_announce_rate * cfg.announce_tick,
                max(1.0, cfg.max_announce_rate),  # burst at most 1 s of budget
            )
            # Satellite cap: never more than max_announce_inflight walks
            # in flight PER AGENT. Healthy trackers finish announces in
            # milliseconds and never feel this; during a full outage it
            # is what keeps N failing torrents from stacking N hung
            # timeout walks (the rate cap only bounds starts).
            room = max(
                0, cfg.max_announce_inflight - len(self._announce_tasks)
            )
            budget = min(int(carry), room)
            carry -= budget
            now = asyncio.get_running_loop().time()
            for h in self._announce_queue.pop_ready(now, budget):
                ctl = self._controls.get(h)
                if ctl is None:
                    continue
                t = asyncio.create_task(self._announce_once(ctl))
                self._announce_tasks.add(t)
                t.add_done_callback(self._announce_tasks.discard)
            await asyncio.sleep(cfg.announce_tick)

    async def _announce_once(self, ctl: _TorrentControl) -> None:
        h = ctl.torrent.info_hash
        complete = ctl.torrent.complete()
        if self.lameduck and complete:
            # Draining seeders go dark (no reschedule: the tracker's
            # peer TTL forgets us); LEECHING announces keep flowing so
            # an in-flight download can still find its peers and finish
            # inside the drain window.
            return
        interval = (
            self.config.seed_announce_interval
            if complete
            else self.config.announce_interval
        )
        announce_t0 = asyncio.get_running_loop().time()
        try:
            # Child of the download's root span (the announce pump task
            # itself carries no context); seeders' re-announces become
            # their own sampled-or-not roots.
            with trace.span(
                "p2p.announce", ctl.trace_parent,
                info_hash=h.hex[:12], complete=complete,
            ):
                peers, interval_r = await self.announce_client.announce(
                    ctl.torrent.digest, h, ctl.namespace, complete
                )
            announce_wall = asyncio.get_running_loop().time() - announce_t0
            ctl.announce_backoff = 0.0  # healthy again: next failure is fresh
            if not complete and interval_r:
                interval = interval_r
            self.events.emit("announce", h.hex, returned=len(peers))
            for peer in peers:
                if peer.peer_id != self.peer_id:
                    # Authoritative handout: feeds the PEX gossip book
                    # (and the peercache snapshot behind it).
                    ctl.known_peers.add(peer, "tracker")
                self._maybe_dial(ctl, peer)
            # Announce SLI (utils/slo.py): client-side latency covers
            # the whole fleet walk -- failovers and breaker shedding
            # included -- which is what an agent actually experiences.
            # Recorded LAST in the try: an emit/dial failure must take
            # the except's bad-record path, never count the same
            # announce as both good and bad.
            SLO.record(
                "announce", True, announce_wall,
                canary=ctl.namespace == CANARY_NAMESPACE,
            )
        except asyncio.CancelledError:
            raise
        except Exception as e:
            SLO.record(
                "announce", False,
                asyncio.get_running_loop().time() - announce_t0,
                canary=ctl.namespace == CANARY_NAMESPACE,
            )
            # Tracker hiccup: retry with per-torrent decorrelated-jitter
            # backoff, capped at the announce interval -- METERED (a
            # dead tracker must be visible on /metrics), and NEVER on a
            # fixed tick (a tracker death otherwise synchronizes every
            # torrent's retry into one storm at its revival).
            _announce_failures.record(f"announce {h.hex[:12]}", e)
            # Backoff-and-probe during a LATCHED fleet outage: with every
            # tracker dark (tracker/client.py outage latch) there is no
            # failover left to find, so retries stretch well past the
            # normal interval -- PEX carries discovery -- and each one
            # that does run doubles as the recovery probe. The latch
            # clears on the first success and cadence snaps back.
            outage = bool(getattr(self.announce_client, "outage", False))
            cap = interval * (8.0 if outage else 1.0)
            jitter = DecorrelatedJitter(
                base_seconds=min(1.0, interval), max_seconds=cap
            )
            ctl.announce_backoff = jitter.next(ctl.announce_backoff)
            interval = ctl.announce_backoff
            REGISTRY.counter(
                "announce_retry_backoffs_total",
                "Failed announces rescheduled with decorrelated-jitter"
                " backoff instead of the fixed interval",
            ).inc()
        if h in self._controls:
            self._announce_queue.schedule(
                h, asyncio.get_running_loop().time() + interval
            )

    def _maybe_dial(self, ctl: _TorrentControl, peer: PeerInfo) -> None:
        # Deliberately NOT lameduck-gated: dials only ever serve an
        # INCOMPLETE torrent (see the complete() check below), i.e. an
        # in-flight download -- exactly the work a drain lets finish.
        # New downloads are refused upstream at the HTTP layer.
        if peer.peer_id == self.peer_id:
            return
        # Complete torrents only serve; they never dial (origins and
        # seeding agents wait for inbound conns).
        if ctl.torrent.complete():
            return
        h = ctl.torrent.info_hash
        if not self.conn_state.add_pending(peer.peer_id, h):
            return
        ctl.spawn(self._dial(ctl, peer))

    async def _dial(self, ctl: _TorrentControl, peer: PeerInfo) -> None:
        # Stage split: "dial" is the connect+handshake wall, successful
        # or not -- a pull that spends its life redialing soft-busy
        # seeders shows it here, not as mystery wall time.
        t0 = asyncio.get_running_loop().time()
        try:
            await self._dial_inner(ctl, peer)
        finally:
            ctl.dispatcher.stage_walls["dial"] += (
                asyncio.get_running_loop().time() - t0
            )

    async def _dial_inner(self, ctl: _TorrentControl, peer: PeerInfo) -> None:
        h = ctl.torrent.info_hash
        # The dial span ADOPTS the conn: _adopt runs inside it, so the
        # conn's pumps (and every io task they spawn) inherit this
        # context -- piece requests/receives nest under the dial, and
        # the outbound handshake carries its traceparent to the remote.
        with trace.span(
            "p2p.dial", ctl.trace_parent,
            peer=f"{peer.ip}:{peer.port}", info_hash=h.hex[:12],
        ) as sp:
            try:
                reader, writer = await asyncio.wait_for(
                    asyncio.open_connection(
                        peer.ip, peer.port, limit=_WIRE_BUF
                    ),
                    self.config.dial_timeout,
                )
                theirs = await handshake_outbound(
                    reader,
                    writer,
                    self.peer_id,
                    h,
                    ctl.torrent.metainfo.name,
                    ctl.namespace,
                    ctl.torrent.bitfield(),
                    ctl.torrent.num_pieces,
                    timeout=self.config.dial_timeout,
                    own_listen_port=self.port,
                )
            except (PeerBusyError, OSError, asyncio.TimeoutError) as e:
                if sp is not None:
                    sp.mark_error(e)
                self.conn_state.remove_pending(peer.peer_id, h)
                # Connectivity failure (refused / at-capacity / timeout),
                # not misbehavior: short soft cool-off so a flash crowd
                # retries the seeder within seconds once churn frees its
                # slots.
                self.conn_state.blacklist.add(peer.peer_id, h, soft=True)
                if not isinstance(e, PeerBusyError):
                    # Dead addr (refused/timeout), not at-capacity: drop
                    # it from the gossip book so we stop advertising --
                    # and persisting -- an address nobody answers at.
                    # The tracker re-adds it if it comes back.
                    ctl.known_peers.discard(peer.peer_id)
                return
            except WireError as e:
                if sp is not None:
                    sp.mark_error(e)
                self.conn_state.remove_pending(peer.peer_id, h)
                # Garbage handshake = misbehavior: exponential backoff.
                self.conn_state.blacklist.add(peer.peer_id, h)
                return
            # The handshaked identity wins over the (possibly stale)
            # announced one: release the announced pending slot before
            # promoting, or a restarted peer with a new id would leak
            # pending slots forever.
            self.conn_state.remove_pending(peer.peer_id, h)
            if not self.conn_state.promote(theirs.peer_id, h):
                writer.close()
                return
            self._adopt(ctl, reader, writer, theirs)

    # -- inbound conns -----------------------------------------------------

    async def _accept(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> None:
        try:
            theirs = await handshake_inbound(
                reader, writer, self.peer_id, self._bitfield_for,
                own_listen_port=self.port,
            )
        except _AtCapacity:
            # Polite rejection: the dialer must learn this is capacity,
            # not misbehavior, so it soft-blacklists and retries soon.
            with contextlib.suppress(Exception):
                await send_message(writer, Message.error("busy"))
            writer.close()
            return
        except (OSError, WireError, KeyError, asyncio.TimeoutError):
            writer.close()
            return
        h = theirs.info_hash
        ctl = self._controls.get(h)
        if ctl is None or not self.conn_state.promote(theirs.peer_id, h):
            writer.close()
            return
        self._adopt(ctl, reader, writer, theirs)

    def _bitfield_for(self, hs: HandshakeResult) -> tuple[bytes, int]:
        """Inbound handshake: find or create local state for the torrent.

        Origins lazily create seeding controls for any stored blob (the
        resolver loads its metainfo); agents only serve torrents they have
        live controls for. Raising KeyError rejects the conn.
        """
        if self.lameduck:
            # Draining: the polite busy frame -- the dialer soft-
            # blacklists (capacity, not misbehavior) and retries another
            # peer, which is exactly what 503+Retry-After means in HTTP.
            raise _AtCapacity(hs.info_hash.hex)
        if self.conn_state.at_capacity(hs.info_hash):
            raise _AtCapacity(hs.info_hash.hex)
        ctl = self._controls.get(hs.info_hash)
        if ctl is None:
            if self._metainfo_resolver is None:
                raise KeyError(hs.info_hash.hex)
            metainfo = self._metainfo_resolver(hs.name, hs.namespace)
            if metainfo is None or metainfo.info_hash != hs.info_hash:
                raise KeyError(hs.info_hash.hex)
            try:
                ctl = self._get_or_create_control(metainfo, hs.namespace)
            except RuntimeError:
                # stop() swept the controls while this handshake was in
                # flight: reject the conn (the KeyError contract above),
                # don't crash the acceptor and strand the peer's socket.
                raise KeyError(hs.info_hash.hex) from None
        return ctl.torrent.bitfield(), ctl.torrent.num_pieces

    def _adopt(
        self,
        ctl: _TorrentControl,
        reader: asyncio.StreamReader,
        writer: asyncio.StreamWriter,
        theirs: HandshakeResult,
    ) -> None:
        h = ctl.torrent.info_hash
        conn = Conn(
            reader, writer, theirs.peer_id, h,
            bandwidth=self.bandwidth,
            pool=self._bufpool,
            send_batch=self.config.wire_send_batch,
            # The handshaken metainfo's piece length bounds every payload
            # this conn may legally carry -- anything longer is rejected
            # before buffering and blacklists the sender.
            max_payload_length=ctl.torrent.metainfo.piece_length,
        )
        conn.start()
        if not ctl.dispatcher.add_conn(conn, theirs.bitfield, theirs.num_pieces):
            # Rejected (duplicate peer / bad bitfield); the dispatcher closed
            # it. promote() only succeeds when no active slot exists, so the
            # slot being released here is this conn's own.
            self.conn_state.remove(theirs.peer_id, h)
            return
        key = (theirs.peer_id, h)
        self._conn_owners[key] = conn
        conn.closed.add_done_callback(lambda _f: self._conn_closed(key, conn))
        if theirs.listen_port:
            # A live handshake is the best peer record there is: the
            # remote told us its LISTEN port (its transport port here may
            # be an ephemeral dial-side port), and the socket names its
            # reachable ip. Feeds the gossip book + peercache.
            peername = writer.get_extra_info("peername")
            if peername:
                ctl.known_peers.add(
                    PeerInfo(
                        theirs.peer_id, peername[0], theirs.listen_port
                    ),
                    "conn",
                )
        self.events.emit("add_active_conn", h.hex, peer=theirs.peer_id.hex)

    def _conn_closed(self, key: tuple[PeerID, InfoHash], conn: Conn) -> None:
        if self._conn_owners.get(key) is conn:
            del self._conn_owners[key]
            self._pex.forget_conn(key)
            self.conn_state.remove(*key)
            self.events.emit(
                "drop_active_conn", key[1].hex, peer=key[0].hex,
                reason=conn.close_reason or "",
                detail=conn.close_detail,
            )

    # -- retry timer -------------------------------------------------------

    async def _retry_loop(self, ctl: _TorrentControl) -> None:
        while True:
            await asyncio.sleep(self.config.retry_tick)
            with contextlib.suppress(Exception):
                await ctl.dispatcher.tick()
