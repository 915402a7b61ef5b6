"""Component assembly: wire stores, schedulers, and HTTP servers into
runnable origin / tracker / agent nodes.

The port's copy of ``kraken_tpu.assembly``'s five nodes (tracker, origin,
agent with its docker-registry endpoint, build-index, proxy): the CLI runs
one node per process; tests run several per process. Config keys follow the component YAML shape
(``config/``). Where the port's nodes differ from the reference's:

- ``hasher`` defaults to ``cuda`` (the reference's default is ``cpu``);
  ``tpu`` and ``tpu-sharded`` raise ``ValueError`` naming the port's
  hashers, ``cpu``, ``cuda`` and ``cuda-sharded`` (every card of the
  host, ``parallel.hashplane``). A card node loads the kernel library at
  start and makes a context on each of its cards, so a card that cannot
  run it fails the boot.
- A card origin (``cuda``, ``cuda-sharded``) gets an ``IngestPipeline`` from its ``ingest:``
  section, and from ``IngestConfig()`` when there is none: its pieces
  are hashed on the card while the upload streams in. The origin's
  ``OriginServer`` reads ``resume`` and ``serve_while_ingest`` from that
  pipeline's config, live.
- The operator's plane runs as in the reference: every app carries the
  per-endpoint middleware and the debug mux (``instrument_app``; a
  ``cuda`` node's ``/debug/torch-profile`` traces the card), the origin
  and the agent their resource sentinel, the agent its canary prober,
  each on and off by SIGHUP. The multi-core data plane's workers
  (``scheduler.data_plane_workers``, ``scheduler.leech_workers``) are
  forked from the node after its CUDA context exists, touch nothing of
  torch, and leave every verify to the node (``p2p/shardpool.py``).
- Every node's ``stop()`` leaves the process as it found it for what the
  node started: the SLO evaluator and the sampler if its own ``apply``
  started them, its loop-lag monitor, sentinel and prober, ``tracemalloc``
  if its mux's ``/debug/pprof/heap`` started it, and a
  ``/debug/torch-profile`` capture still running on its mux. The
  reference's nodes leave the evaluator running and the sampler
  sampling. The tracer, the sampler and the SLO manager stay
  process-global, and while nodes run, the last-started node's sections
  win.
- The build-index and the proxy do no device work, in the reference
  either: they load no kernel library and make no CUDA context. The
  agent's registry endpoint stops before its scheduler, so no pull starts
  on a scheduler that is stopping.
"""

from __future__ import annotations

import asyncio
import dataclasses
import hashlib
import logging
import os
from typing import Optional

from kraken_tpu_torch.agent.server import AgentServer
from kraken_tpu_torch.backend import Manager as BackendManager
from kraken_tpu_torch.core.digest import Digest, DigestError
from kraken_tpu_torch.core.hasher import get_hasher
from kraken_tpu_torch.core.ingest import IngestConfig, IngestPipeline
from kraken_tpu_torch.core.peer import PeerIDFactory
from kraken_tpu_torch.origin.blobrefresh import Refresher
from kraken_tpu_torch.origin.client import ClusterClient
from kraken_tpu_torch.origin.metainfogen import (
    Generator,
    PieceLengthConfig,
    TorrentMetaMetadata,
)
from kraken_tpu_torch.origin.server import OriginServer, QuorumConfig
from kraken_tpu_torch.origin.writeback import WritebackExecutor
from kraken_tpu_torch.p2p.delta import DeltaConfig, DeltaPlanner
from kraken_tpu_torch.p2p.pex import PexConfig
from kraken_tpu_torch.p2p.scheduler import Scheduler, SchedulerConfig
from kraken_tpu_torch.p2p.storage import (
    AgentTorrentArchive,
    BatchedVerifier,
    OriginTorrentArchive,
)
from kraken_tpu_torch.persistedretry import Manager as RetryManager
from kraken_tpu_torch.persistedretry import TaskStore
from kraken_tpu_torch.placement import Ring
from kraken_tpu_torch.placement.healthcheck import ActiveMonitor
from kraken_tpu_torch.store import CAStore
from kraken_tpu_torch.store.chunkstore import ChunkGC, ChunkStore, ChunkStoreConfig
from kraken_tpu_torch.store.cleanup import CleanupConfig, CleanupManager
from kraken_tpu_torch.store.recovery import (
    quarantine_namespace,
    run_fsck,
    write_clean_shutdown,
)
from kraken_tpu_torch.store.scrub import ScrubConfig, Scrubber
from kraken_tpu_torch.tracker.client import (
    TrackerClient,
    make_tracker_client,
    parse_tracker_addrs,
)
from kraken_tpu_torch.tracker.peerstore import InMemoryPeerStore, RedisPeerStore
from kraken_tpu_torch.tracker.server import TrackerServer
from kraken_tpu_torch.utils import failpoints, http_lite
from kraken_tpu_torch.utils.bandwidth import BandwidthLimiter
from kraken_tpu_torch.utils.canary import CanaryConfig, CanaryProber
from kraken_tpu_torch.utils.deadline import RPCConfig
from kraken_tpu_torch.utils.httputil import HTTPClient, base_url
from kraken_tpu_torch.utils.metrics import (
    REGISTRY,
    FailureMeter,
    instrument_app,
    release_app,
)
from kraken_tpu_torch.utils.profiler import PROFILER, LoopLagMonitor, ProfilerConfig
from kraken_tpu_torch.utils.resources import ResourcesConfig, ResourceSentinel
from kraken_tpu_torch.utils.slo import SLO, SLOConfig
from kraken_tpu_torch.utils.trace import TRACER, TraceConfig

_log = logging.getLogger("kraken.assembly")

HASHERS = ("cpu", "cuda", "cuda-sharded")

_ring_refresh_failures = FailureMeter(
    "ring_refresh_failures_total",
    "Origin-ring membership refreshes that raised (retried next interval)",
    _log,
)
_health_probe_failures = FailureMeter(
    "health_probe_failures_total",
    "Health-probe loop iterations that raised (retried next interval)",
    _log,
)


def check_hasher(name: str) -> str:
    """A node's ``hasher:``: one of :data:`HASHERS`, else ``ValueError``."""
    if name in HASHERS:
        return name
    if name in ("tpu", "tpu-sharded"):
        raise ValueError(
            f"hasher {name!r} is the JAX package's: the port's hashers are"
            " 'cpu' (hashlib), 'cuda' (the card) and 'cuda-sharded' (every"
            " card of the host, the counterpart of 'tpu-sharded')"
        )
    raise ValueError(f"unknown hasher {name!r}: the port's hashers are {HASHERS}")


def _load_kernels(hasher) -> None:
    """A card node loads the kernel library and brings up a CUDA context on
    each of its hasher's cards (every device of a ``cuda-sharded`` mesh)
    before it listens: a node that cannot reach a card fails its boot (no
    CPU fallback)."""
    mesh = getattr(hasher, "mesh", None)
    devices = mesh.devices if mesh is not None else (getattr(hasher, "device", None),)
    devices = [d for d in devices if d is not None and d.type == "cuda"]
    if not devices:
        return
    import torch

    from kraken_tpu_torch.ops import cuda_lib

    cuda_lib.load()
    for device in devices:
        torch.zeros(1, device=device)
        torch.cuda.synchronize(device)


async def _cleanup_loop(manager: CleanupManager) -> None:
    """Periodic eviction sweep for a node's CAStore."""
    while True:
        await asyncio.sleep(manager.config.interval_seconds)
        try:
            evicted = await asyncio.to_thread(manager.run_once)
            if evicted:
                _log.info(
                    "evicted blobs",
                    extra={"count": len(evicted),
                           "store": manager.store.root},
                )
        except Exception:
            _log.exception("cleanup sweep failed")


async def _ring_refresh_loop(get_cluster, interval: float) -> None:
    """Periodic membership re-resolve for a node's origin cluster. The
    passive health filter only takes effect when the ring re-resolves, so
    every long-running holder of a ClusterClient needs this loop.
    ``get_cluster`` is a callable: harnesses attach the cluster after
    start."""
    while True:
        await asyncio.sleep(interval)
        cluster = get_cluster()
        try:
            if cluster is not None:
                await cluster.ring.refresh_async()
                # Same tick: drop passive-health verdicts for hosts that
                # left the hostlist.
                health = getattr(cluster, "health", None)
                if health is not None:
                    health.prune(cluster.ring.resolved_hosts)
        except Exception as e:
            _ring_refresh_failures.record("ring refresh", e)


def _reload_tracker_addrs(node, spec) -> None:
    """SIGHUP ``tracker:`` handling shared by agent and origin: a fleet
    client swaps its membership live; a single-host client retargets
    when the new list is still one addr. Growing 1 -> N needs a
    restart -- the client protocol object is chosen at construction."""
    client = node._tracker_client
    if client is None or spec is None:
        return
    addrs = parse_tracker_addrs(spec)
    if not addrs:
        return
    node.tracker_addr = ",".join(addrs)
    if hasattr(client, "set_addrs"):
        client.set_addrs(addrs)
        _log.info("tracker fleet addrs reloaded", extra={"addrs": addrs})
    elif len(addrs) == 1:
        client.addr = addrs[0]
        _log.info("tracker addr reloaded", extra={"addr": addrs[0]})
    else:
        _log.warning(
            "tracker list grew from one addr to %d: the single->fleet"
            " topology change requires a restart", len(addrs),
        )


def _config(cls, doc):
    """Normalize a YAML section (dict) / a config object / None into the
    config class -- every node carries the same knob shapes."""
    if isinstance(doc, cls):
        return doc
    return cls.from_dict(doc)


def _scrub_config(scrub) -> ScrubConfig | None:
    return ScrubConfig(**scrub) if isinstance(scrub, dict) else scrub


def _sync_chunkstore(node) -> None:
    """Attach (or re-configure) a node's chunk tier to match its
    ``chunkstore:`` config -- at construction AND on SIGHUP reload.
    The tier object attaches when the knob is on OR when the tier
    directory already holds state: a node restarted with the knob
    turned off must keep serving its manifest-backed blobs (disabling
    gates NEW conversions only)."""
    store: CAStore = node.store
    cfg: ChunkStoreConfig = node.chunkstore_config
    if store.chunkstore is not None:
        store.chunkstore.config = cfg
        return
    chunks_root = os.path.join(store.root, "chunks")
    if cfg.enabled or os.path.isdir(chunks_root):
        store.attach_chunkstore(ChunkStore(
            chunks_root, cfg,
            quarantine_dir=store.quarantine_dir,
            durability=store.durability,
        ))


def _log_tier_reload(node) -> None:
    """One line for a reload that touched ``delta:`` or ``chunkstore:``,
    so the planes' state after a SIGHUP shows outside the process."""
    _log.info(
        "delta and chunk tier reloaded",
        extra={
            "delta_enabled": node.delta_config.enabled,
            "chunkstore_enabled": node.chunkstore_config.enabled,
            "chunkstore_attached": node.store.chunkstore is not None,
        },
    )


def _sync_chunk_gc(node) -> None:
    """Start the budgeted zero-ref reaper once a tier is attached and a
    loop is running (start() and the live-enable reload path)."""
    if node.store.chunkstore is None or node.chunk_gc is not None:
        return
    try:
        asyncio.get_running_loop()
    except RuntimeError:
        return  # offline reload: the next start() picks it up
    node.chunk_gc = ChunkGC(node.store.chunkstore)
    node.chunk_gc.start()


def _sync_ingest(node) -> None:
    """Attach or retune the pipelined ingest plane from
    ``node.ingest_config``. The first call with a config builds the
    pipeline and threads it through the generator and (if started) the
    blobserver -- so enabling ingest on a running origin is a SIGHUP,
    not a restart. Later calls live-apply knob changes (the origin
    reads ``resume`` and ``serve_while_ingest`` from the pipeline's
    config); disabling requires a restart."""
    if node.ingest_config is None:
        return
    if node.ingest_pipeline is None:
        node.ingest_pipeline = IngestPipeline(
            node.generator.hasher, node.ingest_config
        )
        node.generator.pipeline = node.ingest_pipeline
        if node.server is not None:
            node.server._ingest_pipeline = node.ingest_pipeline
            if node.server._stream_piece_length == 0:
                node.server._stream_piece_length = (
                    node.generator.piece_lengths.piece_length(0)
                )
            node.server._stream_hash_pool = None
    else:
        node.ingest_pipeline.apply(node.ingest_config)


def _apply_slo(node, component: str, cfg: SLOConfig) -> None:
    """Apply a node's ``slo:`` section to the process-global SLO manager
    (one per process, like the TRACER; in-process herds share it and the
    last-started node wins). The evaluator thread follows the enabled
    flag; the node owns it when this call started it, and stops it in
    its own stop()."""
    was_running = SLO.running
    SLO.node = component
    SLO.apply(cfg)
    if not SLO.running:
        node._owns_slo = False
    elif not was_running:
        node._owns_slo = True


def _apply_profiling(node, component: str, cfg: ProfilerConfig,
                     store_root: str = "") -> ProfilerConfig:
    """Apply a node's ``profiling:`` section to the process-global
    sampler (one per process, like the TRACER). An empty ``dump_dir``
    defaults beside the trace dumps under the node's store root;
    store-less nodes (tracker) skip file captures unless a dir is set.
    Also registers the tracer's dump-trigger hook: every flight-recorder
    trigger captures a profile window too. The node owns the sampler
    when this call started it, and stops it in its own stop()."""
    if not cfg.dump_dir and store_root:
        cfg = dataclasses.replace(
            cfg, dump_dir=os.path.join(store_root, "traces")
        )
    was_running = PROFILER.running
    PROFILER.node = component
    PROFILER.apply(cfg)
    TRACER.on_trigger = PROFILER.trigger_capture
    if not PROFILER.running:
        node._owns_sampler = False
    elif not was_running:
        node._owns_sampler = True
    return cfg


async def _release_process_globals(node, *runners) -> None:
    """What a node's stop() owes the process: the SLO evaluator and the
    sampler if the node started them, ``tracemalloc`` if its mux's
    ``/debug/pprof/heap`` started it, and a ``/debug/torch-profile``
    capture still running on its mux (waited for off the loop). The
    reference's nodes leave the first two running; in a CLI process
    nothing tells, in a process that runs one node after another it
    decides what the next one sees."""
    if getattr(node, "_owns_slo", False):
        SLO.stop()
        node._owns_slo = False
    if getattr(node, "_owns_sampler", False):
        PROFILER.stop()
        node._owns_sampler = False
    for runner in runners:
        if runner is not None:
            await asyncio.to_thread(release_app, runner.app)


def _apply_trace(component: str, cfg: TraceConfig,
                 store_root: str = "") -> None:
    """Apply a node's ``trace:`` section to the process-global tracer
    (one per process, like the metric REGISTRY). An empty ``dump_dir``
    defaults under the node's store root."""
    if not cfg.dump_dir and store_root:
        cfg = dataclasses.replace(
            cfg, dump_dir=os.path.join(store_root, "traces")
        )
    TRACER.apply(cfg)
    TRACER.node = component


def _sync_loop_monitor(node, component: str) -> None:
    """Bring a node's LoopLagMonitor in line with its profiling config
    -- at start AND on SIGHUP reload, so enabling profiling live starts
    the heartbeat and disabling stops it (knob changes apply in
    place). Keeps the sentinel's loop_lag probe pointed at the live
    monitor (or None), so the ``loop_lag`` budget follows the toggle
    too."""
    cfg = node.profiling_config
    sentinel = getattr(node, "sentinel", None)
    if cfg.enabled and node.loop_monitor is None:
        try:
            asyncio.get_running_loop()
        except RuntimeError:
            return  # no loop (offline reload): nothing to heartbeat yet
        node.loop_monitor = LoopLagMonitor(component, cfg)
        node.loop_monitor.start()
    elif not cfg.enabled and node.loop_monitor is not None:
        node.loop_monitor.stop()
        node.loop_monitor = None
    elif node.loop_monitor is not None:
        node.loop_monitor.apply(cfg)
    if sentinel is not None:
        sentinel.loop_lag_probe = (
            node.loop_monitor.p99 if node.loop_monitor is not None else None
        )


def _start_sentinel(node, component: str) -> ResourceSentinel:
    """Build, register, and start a node's resource sentinel. The
    sustained-breach hook enters lameduck (idempotent, non-blocking):
    /health flips to 503, the deploy system observes and SIGTERMs for
    the full drain+stop -- the same operator contract as
    POST /debug/lameduck."""

    def shed(kinds: list[str]) -> None:
        REGISTRY.counter(
            "resource_breach_drains_total",
            "Lameduck drains entered by the resource sentinel",
        ).inc(component=component)
        if node.server is not None:
            node.server.enter_lameduck()
        elif node.scheduler is not None:
            node.scheduler.enter_lameduck()

    monitor = getattr(node, "loop_monitor", None)
    sentinel = ResourceSentinel(
        component,
        node.resources_config,
        scheduler=node.scheduler,
        store=node.store,
        upload_ttl_seconds=(
            node.cleanup.config.upload_ttl_seconds
            if node.cleanup is not None else 6 * 3600
        ),
        on_sustained_breach=shed,
        # The loop-lag monitor's recent p99 feeds the `loop_lag` budget:
        # a wedged event loop drains like any other resource breach.
        loop_lag_probe=monitor.p99 if monitor is not None else None,
        # The persistedretry Manager's per-kind pending counts feed the
        # `retry_queue_depth` gauge and the `retry_queue` budget.
        retry_probe=(
            node.retry.queue_depths
            if getattr(node, "retry", None) is not None else None
        ),
    )
    sentinel.start()
    return sentinel


async def _drain_node(server, scheduler, timeout: float,
                      component: str) -> None:
    """Shared lameduck drain: enter drain mode, then wait (up to
    ``timeout``) for in-flight work to finish -- established p2p conns
    completing and churning out, streaming HTTP bodies landing. The
    caller runs the normal stop() afterwards."""
    # A drain is a degradation event (the clean stop() path is not):
    # persist the flight recorder before the conns drain away.
    TRACER.trigger_dump("lameduck", f"{component}: drain entered")
    if server is not None:
        server.enter_lameduck()
    elif scheduler is not None:
        scheduler.enter_lameduck()
    REGISTRY.gauge(
        "lameduck", "1 while this node is draining (SIGTERM/debug entry)"
    ).set(1, component=component)
    loop = asyncio.get_running_loop()
    deadline = loop.time() + timeout
    while loop.time() < deadline:
        conns = scheduler.num_active_conns if scheduler is not None else 0
        inflight = server.inflight_work if server is not None else 0
        if conns == 0 and inflight == 0:
            _log.info("drain quiesced", extra={"component": component})
            return
        await asyncio.sleep(0.05)
    _log.warning(
        "drain timeout: proceeding to hard stop",
        extra={
            "component": component,
            "active_conns": scheduler.num_active_conns if scheduler else 0,
            "inflight": server.inflight_work if server else 0,
        },
    )


def _profile_device(hasher) -> str:
    """Where a node's kernels run: ``cuda`` for a hasher on the card
    (its ``/debug/torch-profile`` traces the card), else ``cpu``."""
    device = getattr(hasher, "device", None)
    return "cuda" if getattr(device, "type", None) == "cuda" else "cpu"


async def _serve(app: http_lite.Application, host: str, port: int,
                 component: str = "", ssl_context=None,
                 profile_device: str = "cpu"):
    # Chaos guard: refuse to bind a listener while failpoints are armed
    # without the explicit acknowledgement (utils/failpoints.py).
    failpoints.FAILPOINTS.assert_safe(component or "node")
    if component:
        # Per-endpoint latency/status metrics, GET /metrics and the debug
        # mux on every component app.
        instrument_app(app, component, profile_device=profile_device)
    return await http_lite.serve(app, host, port, ssl_context=ssl_context)


class TrackerNode:
    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 origin_cluster: ClusterClient | None = None,
                 announce_interval_seconds: float = 3.0,
                 peer_ttl_seconds: float = 30.0,
                 ring_refresh_seconds: float = 5.0,
                 redis_addr: str = "",
                 fleet: str | list[str] | None = None,
                 self_addr: str = "",
                 ssl_context=None,
                 rpc: dict | RPCConfig | None = None,
                 trace: dict | TraceConfig | None = None,
                 profiling: dict | ProfilerConfig | None = None,
                 slo: dict | SLOConfig | None = None):
        self.host = host
        self.port = port
        self.rpc = _config(RPCConfig, rpc)
        # Tracker HA fleet: the full fleet's addrs + this tracker's own
        # addr as it appears there (shard ownership + forwarding).
        self.fleet_addrs = parse_tracker_addrs(fleet or [])
        self.self_addr = self_addr
        # Store-less node: dump_dir stays "" unless the YAML sets one.
        self.trace_config = _config(TraceConfig, trace)
        self.profiling_config = _config(ProfilerConfig, profiling)
        self.slo_config = _config(SLOConfig, slo)
        self.loop_monitor: Optional[LoopLagMonitor] = None
        # Process globals this node started (stopped by its stop()).
        self._owns_slo = self._owns_sampler = False
        peer_store = (
            RedisPeerStore(redis_addr, ttl_seconds=peer_ttl_seconds)
            if redis_addr
            else InMemoryPeerStore(ttl_seconds=peer_ttl_seconds)
        )
        self.server = TrackerServer(
            peer_store=peer_store,
            origin_cluster=origin_cluster,
            announce_interval_seconds=announce_interval_seconds,
            fleet_addrs=self.fleet_addrs,
            self_addr=self.self_addr,
            # Trackers sharing a Redis store already rendezvous there:
            # non-owner forwarding would only duplicate writes.
            shared_store=bool(redis_addr),
        )
        self.ring_refresh = ring_refresh_seconds
        self.ssl_context = ssl_context
        self._runner: Optional[http_lite.AppRunner] = None
        self._refresh_task: Optional[asyncio.Task] = None

    @property
    def addr(self) -> str:
        return f"{self.host}:{self.port}"

    async def start(self) -> None:
        _apply_trace("tracker", self.trace_config)
        self.profiling_config = _apply_profiling(
            self, "tracker", self.profiling_config
        )
        _apply_slo(self, "tracker", self.slo_config)
        _sync_loop_monitor(self, "tracker")
        self._runner, self.port = await _serve(
            self.server.make_app(), self.host, self.port, "tracker",
            ssl_context=self.ssl_context,
        )
        self._refresh_task = asyncio.create_task(_ring_refresh_loop(
            lambda: self.server.origin_cluster, self.ring_refresh
        ))

    def reload(self, cfg: dict) -> None:
        """SIGHUP: apply the ``fleet:``/``self_addr:``, ``trace:``,
        ``profiling:``, ``slo:`` and ``rpc:`` sections live. An EMPTY
        fleet parse is skipped, not applied: the shipped base.yaml
        carries ``fleet: ""``, and a SIGHUP for an unrelated section
        must not dissolve a fleet configured via flags."""
        reload_fleet = parse_tracker_addrs(cfg.get("fleet") or [])
        if reload_fleet:
            self.fleet_addrs = reload_fleet
            if cfg.get("self_addr"):
                self.self_addr = cfg["self_addr"].strip()
            self.server.set_fleet(self.fleet_addrs, self.self_addr)
            _log.info(
                "tracker fleet reloaded",
                extra={"fleet": self.fleet_addrs, "self": self.self_addr},
            )
        if cfg.get("trace") is not None:
            self.trace_config = _config(TraceConfig, cfg["trace"])
            _apply_trace("tracker", self.trace_config)
        if cfg.get("profiling") is not None:
            self.profiling_config = _apply_profiling(
                self, "tracker", _config(ProfilerConfig, cfg["profiling"])
            )
            _sync_loop_monitor(self, "tracker")
        if cfg.get("slo") is not None:
            self.slo_config = _config(SLOConfig, cfg["slo"])
            _apply_slo(self, "tracker", self.slo_config)
        if cfg.get("rpc") is None:
            return
        self.rpc = _config(RPCConfig, cfg["rpc"])
        c = self.server.origin_cluster
        if c is not None:
            c.hedge_delay = self.rpc.hedge_delay_seconds or None
            c.deadline_seconds = self.rpc.request_deadline_seconds
            if c.health is not None and hasattr(c.health, "brownout_threshold"):
                c.health.brownout_threshold = (
                    self.rpc.brownout_threshold_seconds
                )
        _log.info("rpc config reloaded", extra={"node": self.addr})

    async def drain(self, timeout: float | None = None) -> None:
        """Lameduck drain (SIGTERM): /health flips to 503 and new
        announces/proxy reads are refused -- fleet clients fail over to
        the next ring tracker. In-flight handlers finish up to
        ``drain_timeout``; :meth:`stop` follows."""
        await _drain_node(
            self.server, None,
            self.rpc.drain_timeout_seconds if timeout is None else timeout,
            "tracker",
        )

    async def stop(self) -> None:
        # Refusal-before-teardown: no new announce lands while the
        # runner below is mid-teardown.
        self.server.enter_lameduck()
        if self._refresh_task:
            self._refresh_task.cancel()
        if self.loop_monitor:
            self.loop_monitor.stop()
            self.loop_monitor = None
        if self._runner:
            await self._runner.cleanup()
        await self.server.close()
        await _release_process_globals(self, self._runner)


class OriginNode:
    """Origin: CAStore + metainfo-gen on the card + blobserver + P2P
    seeding."""

    def __init__(
        self,
        store_root: str,
        tracker_addr: str = "",
        host: str = "127.0.0.1",
        http_port: int = 0,
        p2p_port: int = 0,
        hasher: str = "cuda",
        hash_workers: int = 1,
        backends: BackendManager | None = None,
        ring: Ring | None = None,
        self_addr: str = "",
        retry_db: str = "",
        piece_lengths: PieceLengthConfig | None = None,
        cleanup: CleanupConfig | None = None,
        dedup: bool = True,
        dedup_index: str = "dict",  # "compact" for million-blob corpora
        dedup_budget_bytes: int | None = None,
        dedup_low_j_bands: int | None = None,  # None = default tier; 0 = off
        hash_window_bytes: int = 256 * 1024 * 1024,
        health_interval_seconds: float = 5.0,
        health_fail_threshold: int = 3,
        scheduler_config_doc: dict | None = None,
        p2p_bandwidth: dict | None = None,
        ssl_context=None,
        durability: str = "rename",
        scrub: dict | ScrubConfig | None = None,
        fsck: bool = True,
        task_timeout_seconds: float = 1800.0,
        rpc: dict | RPCConfig | None = None,
        resources: dict | ResourcesConfig | None = None,
        trace: dict | TraceConfig | None = None,
        delta: dict | DeltaConfig | None = None,
        profiling: dict | ProfilerConfig | None = None,
        chunkstore: dict | ChunkStoreConfig | None = None,
        slo: dict | SLOConfig | None = None,
        ingest: dict | IngestConfig | None = None,
        quorum: dict | QuorumConfig | None = None,
    ):
        from kraken_tpu_torch.origin.dedup import DedupIndex

        self.hasher_name = check_hasher(hasher)
        self.host = host
        self.http_port = http_port
        self.p2p_port = p2p_port
        self.tracker_addr = tracker_addr
        self.store = CAStore(store_root, durability=durability)
        # Content-addressed chunk tier (store/chunkstore.py): keep each
        # chunk once, serve blobs as manifests. YAML `chunkstore:`;
        # shipped OFF; SIGHUP live-reloads (enable = attach + convert
        # from the next dedup pass on). Attached BEFORE fsck so the
        # startup pass covers the tier.
        self.chunkstore_config = _config(ChunkStoreConfig, chunkstore)
        self.chunk_gc: Optional[ChunkGC] = None
        _sync_chunkstore(self)
        # Resource sentinel budgets (YAML `resources:`; live-reloadable).
        self.resources_config = _config(ResourcesConfig, resources)
        # Delta-transfer plane (p2p/delta.py): the origin serves chunk
        # recipes on GET .../recipe when enabled (shipped OFF); SIGHUP
        # live-reloads.
        self.delta_config = _config(DeltaConfig, delta)
        # hash_workers sizes the HOST piece-hash pool (cpu hasher only;
        # the card's parallelism is the batch axis).
        self.hash_workers = hash_workers
        hasher_obj = get_hasher(hasher, workers=hash_workers)
        # Pipelined ingest plane (core/ingest.py): the upload spool ->
        # piece-hash path as an overlapped window stream. A card origin
        # always has one (its pieces are hashed on the card at stream
        # time); a cpu origin has one when its config has `ingest:`.
        if ingest is None and self.hasher_name != "cpu":
            ingest = IngestConfig()
        self.ingest_config = None if ingest is None else _config(IngestConfig, ingest)
        self.ingest_pipeline = (
            IngestPipeline(hasher_obj, self.ingest_config)
            if self.ingest_config is not None
            else None
        )
        self.generator = Generator(
            self.store,
            hasher=hasher_obj,
            piece_lengths=piece_lengths,
            window_bytes=hash_window_bytes,
            pipeline=self.ingest_pipeline,
        )
        self.dedup = (
            DedupIndex(
                self.store, hasher=get_hasher(hasher, workers=hash_workers),
                index_kind=dedup_index,
                index_budget_bytes=dedup_budget_bytes,
                low_j_bands=dedup_low_j_bands,
                # The sketch runs where the hasher does.
                device="cpu" if self.hasher_name == "cpu" else None,
            )
            if dedup else None
        )
        self.backends = backends
        self.refresher = (
            Refresher(self.store, backends, self.generator) if backends else None
        )
        # task_timeout_seconds bounds ONE executor run; a cut task
        # reschedules with backoff. 0 disables.
        self.retry = RetryManager(
            TaskStore(retry_db or f"{store_root}/retry.db"),
            task_timeout_seconds=task_timeout_seconds,
        )
        self.writeback = (
            WritebackExecutor(self.store, backends, self.retry) if backends else None
        )
        self.ring = ring
        self.self_addr = self_addr
        self.cleanup = (
            CleanupManager(
                self.store, cleanup,
                on_evict=self.dedup.remove_sync if self.dedup else None,
                after_evict=self._after_evict,
            )
            if cleanup
            else None
        )
        self.health_interval = health_interval_seconds
        self.health_fail_threshold = health_fail_threshold
        self._scheduler_doc = scheduler_config_doc
        self.p2p_bandwidth = (
            BandwidthLimiter(**p2p_bandwidth) if p2p_bandwidth else None
        )
        self.ssl_context = ssl_context
        # Self-healing storage plane: fsck reconciles the tree before any
        # listener binds; the scrubber re-verifies at-rest bytes on a
        # budgeted cycle and feeds corruption into the heal plane.
        self.fsck_enabled = fsck
        self.scrub_config = _scrub_config(scrub)
        self.rpc = _config(RPCConfig, rpc)
        self.trace_config = _config(TraceConfig, trace)
        self.profiling_config = _config(ProfilerConfig, profiling)
        self.slo_config = _config(SLOConfig, slo)
        self.quorum_config = _config(QuorumConfig, quorum)
        self.loop_monitor: Optional[LoopLagMonitor] = None
        self.sentinel: Optional[ResourceSentinel] = None
        # Process globals this node started (stopped by its stop()).
        self._owns_slo = self._owns_sampler = False
        self.scrubber: Optional[Scrubber] = None
        self.fsck_report = None
        self.monitor: Optional[ActiveMonitor] = None
        self.scheduler: Optional[Scheduler] = None
        self.server: Optional[OriginServer] = None
        self._runner: Optional[http_lite.AppRunner] = None
        self._tracker_client: Optional[TrackerClient] = None
        self._health_http: Optional[HTTPClient] = None
        self._health_task: Optional[asyncio.Task] = None
        self._cleanup_task: Optional[asyncio.Task] = None
        self._reseed_task: Optional[asyncio.Task] = None
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._repair_tasks: set[asyncio.Task] = set()

    @property
    def addr(self) -> str:
        return f"{self.host}:{self.http_port}"

    def _after_evict(self, d: Digest) -> None:
        """Runs in the cleanup sweep's worker thread AFTER the bytes are
        gone: stop seeding (hop to the event loop -- scheduler state is
        loop-owned)."""
        loop, sched = self._loop, self.scheduler
        if loop is not None and sched is not None:
            loop.call_soon_threadsafe(sched.unseed, d)

    def _resolve_metainfo(self, name: str, namespace: str):
        try:
            return self.generator.get_cached(Digest.from_hex(name))
        except DigestError:
            return None

    def _on_scrub_corrupt(self, d: Digest, ns: str) -> None:
        """Scrub-task context (event loop), AFTER the blob moved to
        quarantine: every derived plane drops it, then the heal plane
        restores it."""
        if self.dedup is not None:
            try:
                self.dedup.remove_sync(d)
            except Exception:
                _log.warning(
                    "dedup drop of quarantined blob failed",
                    extra={"digest": d.hex}, exc_info=True,
                )
        if self.scheduler is not None:
            self.scheduler.unseed(d)
        if self.server is not None:
            self.server.enqueue_heal(ns, d)

    async def start(self) -> None:
        self._loop = asyncio.get_running_loop()
        await asyncio.to_thread(_load_kernels, self.generator.hasher)
        _apply_trace("origin", self.trace_config, self.store.root)
        self.profiling_config = _apply_profiling(
            self, "origin", self.profiling_config, self.store.root
        )
        _apply_slo(self, "origin", self.slo_config)
        _sync_loop_monitor(self, "origin")
        # Startup fsck BEFORE any listener binds.
        if self.fsck_enabled:
            self.fsck_report = await asyncio.to_thread(
                run_fsck,
                self.store,
                upload_ttl_seconds=(
                    self.cleanup.config.upload_ttl_seconds
                    if self.cleanup
                    else 6 * 3600
                ),
                expect_namespace=True,
                # Journaled upload sessions are resumable crash state,
                # not debris -- unless resume is configured off.
                resume=(
                    self.ingest_config.resume
                    if self.ingest_config is not None
                    else True
                ),
            )
        # Fixed p2p port -> stable addr_hash identity across restarts;
        # ephemeral port -> random identity.
        factory = PeerIDFactory(
            PeerIDFactory.ADDR_HASH if self.p2p_port else PeerIDFactory.RANDOM
        )
        peer_id = factory.create(self.host, self.p2p_port)
        self._tracker_client = make_tracker_client(
            self.tracker_addr, peer_id, self.host, 0, is_origin=True,
            announce_timeout_seconds=self.rpc.announce_timeout_seconds,
            request_deadline_seconds=self.rpc.request_deadline_seconds,
            hedge_delay_seconds=self.rpc.hedge_delay_seconds,
        )
        self.scheduler = Scheduler(
            peer_id=peer_id,
            ip=self.host,
            port=self.p2p_port,
            archive=OriginTorrentArchive(
                self.store, BatchedVerifier(hasher=self.generator.hasher)
            ),
            metainfo_client=self._tracker_client,
            announce_client=self._tracker_client,
            is_origin=True,
            metainfo_resolver=self._resolve_metainfo,
            config=self.build_scheduler_config(self._scheduler_doc),
            bandwidth=self.p2p_bandwidth,
        )
        await self.scheduler.start()
        self._tracker_client.port = self.scheduler.port
        self.server = OriginServer(
            store=self.store,
            generator=self.generator,
            refresher=self.refresher,
            writeback=self.writeback,
            retry=self.retry,
            ring=self.ring,
            self_addr=self.self_addr,
            scheduler=self.scheduler,
            dedup=self.dedup,
            cleanup=self.cleanup,
            # cpu origins piece-hash with hashlib while the bytes stream
            # in; card origins hash on the card (their pipeline's windows
            # at stream time).
            stream_piece_hash=self.hasher_name == "cpu",
            rpc=self.rpc,
            delta=self.delta_config,
            ingest_pipeline=self.ingest_pipeline,
            quorum=self.quorum_config,
        )
        self._runner, self.http_port = await _serve(
            self.server.make_app(), self.host, self.http_port, "origin",
            ssl_context=self.ssl_context,
            profile_device=_profile_device(self.generator.hasher),
        )
        if not self.self_addr:
            self.self_addr = self.addr
            self.server.self_addr = self.addr
        self.retry.start()
        # Blobs fsck quarantined enter the heal plane now that the retry
        # manager is polling.
        if self.fsck_report is not None:
            for hex_ in self.fsck_report.quarantined:
                self.server.enqueue_heal(
                    quarantine_namespace(self.store, hex_),
                    Digest.from_hex(hex_),
                )
        if self.scrub_config is not None:
            self.scrubber = Scrubber(
                self.store,
                self.scrub_config,
                hasher=self.generator.hasher,
                on_corrupt=self._on_scrub_corrupt,
            )
            self.scrubber.start()
        # Resource sentinel: the in-process fd/RSS/task/orphan auditor;
        # budgets from the YAML `resources:` section, surfaced on
        # /debug/resources and /metrics.
        self.sentinel = _start_sentinel(self, "origin")
        # Chunk-tier GC: budgeted zero-ref chunk reaper (watermark
        # pressure bypasses the budget inside the cleanup sweep).
        _sync_chunk_gc(self)
        # Seed everything already on disk. A blob whose metainfo sidecar
        # was lost gets it regenerated in the background.
        missing: list[Digest] = []
        for d in self.store.list_cache_digests():
            metainfo = self.generator.get_cached(d)
            if metainfo is not None:
                self.scheduler.seed(metainfo, "startup")
            else:
                missing.append(d)
        if missing:
            self._reseed_task = asyncio.create_task(self._reseed(missing))
        if self.dedup is not None:
            await asyncio.to_thread(self.dedup.load_existing)
        if self.cleanup is not None:
            self._cleanup_task = asyncio.create_task(
                _cleanup_loop(self.cleanup)
            )
        # Failure plane: probe ring peers, refresh membership, and
        # repair (re-replicate) on every change.
        if self.ring is not None:
            self._health_http = HTTPClient(timeout_seconds=2.0, retries=0)
            self.monitor = ActiveMonitor(
                probe=self._probe_origin,
                fail_threshold=self.health_fail_threshold,
            )
            if not self.ring.has_health_filter:
                self.ring.set_health_filter(self.monitor.filter)
            self.ring.on_change(self._on_ring_change)
            self._health_task = asyncio.create_task(self._health_loop())

    @staticmethod
    def build_scheduler_config(doc: dict | None) -> SchedulerConfig:
        """The origin's scheduler config: YAML ``scheduler:`` section over
        origin defaults. Origins serve swarms, so the per-torrent conn
        budget is far higher than agents'. One source for boot AND
        reload."""
        doc = dict(doc or {})
        conn = {
            "max_open_conns_per_torrent": 64,
            "max_global_conns": 4000,
            **(doc.pop("conn_state", None) or {}),
        }
        # Origins never download (they ARE the initial seed), so the
        # leech knobs are dropped even if a shared yaml sets them, as in
        # the reference.
        doc.pop("leech_workers", None)
        doc.pop("leech_ring_mb", None)
        return SchedulerConfig.from_dict({**doc, "conn_state": conn})

    def reload(self, cfg: dict) -> None:
        """Apply a re-read config's sections live (SIGHUP). Every section
        is parsed before any is applied, so a config that raises keeps
        the current one whole."""
        sched = (
            self.build_scheduler_config(cfg.get("scheduler"))
            if self.scheduler is not None else None
        )
        parsed = {
            key: _config(cls, cfg[key]) for key, cls in (
                ("rpc", RPCConfig), ("resources", ResourcesConfig),
                ("trace", TraceConfig), ("delta", DeltaConfig),
                ("profiling", ProfilerConfig),
                ("chunkstore", ChunkStoreConfig), ("slo", SLOConfig),
                ("ingest", IngestConfig), ("quorum", QuorumConfig),
            ) if cfg.get(key) is not None
        }
        if sched is not None:
            self.scheduler.reload(sched)
        _reload_tracker_addrs(self, cfg.get("tracker"))
        if "rpc" in parsed:
            self.apply_rpc(parsed["rpc"])
        if "resources" in parsed:
            self.resources_config = parsed["resources"]
            if self.sentinel is not None:
                self.sentinel.apply(self.resources_config)
        if "trace" in parsed:
            self.trace_config = parsed["trace"]
            _apply_trace("origin", self.trace_config, self.store.root)
        if "delta" in parsed:
            # Live enable/disable of the recipe endpoint: rollout step 1
            # (origins first) is a SIGHUP, not a restart.
            self.delta_config = parsed["delta"]
            if self.server is not None:
                self.server.delta_config = self.delta_config
        if "profiling" in parsed:
            self.profiling_config = _apply_profiling(
                self, "origin", parsed["profiling"], self.store.root
            )
            _sync_loop_monitor(self, "origin")
        if "chunkstore" in parsed:
            # Live enable = attach tier + start GC; new blobs convert
            # from the next dedup pass. Live disable stops NEW
            # conversions only -- manifest-backed blobs keep serving.
            self.chunkstore_config = parsed["chunkstore"]
            _sync_chunkstore(self)
            _sync_chunk_gc(self)
        if "delta" in parsed or "chunkstore" in parsed:
            _log_tier_reload(self)
        if "slo" in parsed:
            self.slo_config = parsed["slo"]
            _apply_slo(self, "origin", self.slo_config)
        if "ingest" in parsed:
            # Live knob retune -- and live ENABLE on an origin started
            # without a pipeline. Disabling needs a restart.
            self.ingest_config = parsed["ingest"]
            _sync_ingest(self)
        if "quorum" in parsed:
            # Raising write_quorum gates acks from the NEXT commit.
            self.quorum_config = parsed["quorum"]
            if self.server is not None:
                self.server.quorum = self.quorum_config

    def apply_rpc(self, rpc: RPCConfig) -> None:
        """Swap the degradation knobs live: the announce budget, the
        drain timeout, and the heal cluster's hedge/deadline settings
        all take effect from the next call."""
        self.rpc = rpc
        if self._tracker_client is not None:
            self._tracker_client.announce_timeout = rpc.announce_timeout_seconds
            if hasattr(self._tracker_client, "request_deadline"):
                self._tracker_client.request_deadline = (
                    rpc.request_deadline_seconds
                )
                self._tracker_client.hedge_delay = (
                    rpc.hedge_delay_seconds or None
                )
        if self.server is not None:
            self.server.rpc = rpc
            c = self.server._heal_cluster
            if c is not None:
                c.hedge_delay = rpc.hedge_delay_seconds or None
                c.deadline_seconds = rpc.request_deadline_seconds
        _log.info("rpc config reloaded", extra={"node": self.self_addr})

    async def _reseed(self, missing: list[Digest]) -> None:
        """Regenerate lost metainfo sidecars and seed the blobs (in the
        background after startup; sequential so it never starves the
        serving path of hasher batches). A blob whose bytes no longer
        match its digest is skipped: the swarm must not serve it."""
        for d in missing:
            try:
                if not await asyncio.to_thread(self._blob_matches, d):
                    _log.warning(
                        "reseed skipped: blob content does not match digest",
                        extra={"digest": d.hex},
                    )
                    continue
                if self.cleanup is not None:
                    self.cleanup.touch(d)  # a reseed backlog must not TTI-evict
                metainfo = await self.generator.generate(d)
                if not self.store.in_cache(d):
                    # Evicted mid-hash: drop the orphan sidecar generate()
                    # just rewrote and do not advertise a bodyless torrent.
                    await asyncio.to_thread(
                        self.store.delete_metadata, d, TorrentMetaMetadata
                    )
                    continue
                self.scheduler.seed(metainfo, "startup")
            except Exception:
                _log.warning(
                    "startup reseed failed", extra={"digest": d.hex},
                    exc_info=True,
                )

    def _blob_matches(self, d: Digest) -> bool:
        h = hashlib.sha256()
        with self.store.open_cache_file(d) as f:
            for chunk in iter(lambda: f.read(1 << 20), b""):
                h.update(chunk)
        return h.hexdigest() == d.hex

    async def _probe_origin(self, host: str) -> bool:
        try:
            await self._health_http.get(
                f"{base_url(host)}/health", retry_5xx=False
            )
            return True
        except Exception:
            return False

    async def _health_loop(self) -> None:
        while True:
            await asyncio.sleep(self.health_interval)
            try:
                peers = [
                    h for h in self.ring.resolved_hosts
                    if h != self.self_addr
                ]
                await self.monitor.check_all(peers)
                await self.ring.refresh_async()
                self.monitor.prune(self.ring.resolved_hosts)
            except Exception as e:
                _health_probe_failures.record("health probe sweep", e)

    def _on_ring_change(self, hosts: list[str]) -> None:
        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:
            return  # construction-time refresh: nothing to repair yet
        if self.server is None:
            return

        async def repair_and_log():
            n = await self.server.repair()
            _log.info(
                "ring changed; repair enqueued",
                extra={"node": self.self_addr, "members": hosts, "tasks": n},
            )

        t = loop.create_task(repair_and_log())
        self._repair_tasks.add(t)
        t.add_done_callback(self._repair_tasks.discard)

    async def drain(self, timeout: float | None = None) -> None:
        """Lameduck drain (SIGTERM): stop announcing, fail /health,
        refuse new uploads and p2p conns, and let in-flight pieces and
        upload bodies finish -- up to ``drain_timeout``. :meth:`stop`
        follows."""
        await _drain_node(
            self.server, self.scheduler,
            self.rpc.drain_timeout_seconds if timeout is None else timeout,
            "origin",
        )

    async def stop(self) -> None:
        # Refusal-before-teardown, even on the non-drain path.
        if self.server is not None:
            self.server.enter_lameduck()
        elif self.scheduler is not None:
            self.scheduler.enter_lameduck()
        for t in (self._health_task, self._cleanup_task, self._reseed_task):
            if t:
                t.cancel()
        if self.sentinel:
            self.sentinel.stop()
            self.sentinel = None
        if self.loop_monitor:
            self.loop_monitor.stop()
            self.loop_monitor = None
        if self.scrubber:
            self.scrubber.stop()
        if self.chunk_gc:
            self.chunk_gc.stop()
            self.chunk_gc = None
        for t in list(self._repair_tasks):
            t.cancel()
        self.retry.stop()
        if self.scheduler:
            await self.scheduler.stop()
        if self._runner:
            await self._runner.cleanup()
        if self._tracker_client:
            await self._tracker_client.close()
        if self._health_http:
            await self._health_http.close()
        if self.server:
            await self.server.close_heal_cluster()
        await _release_process_globals(self, self._runner)
        # Reap the cancelled poll task BEFORE releasing the sqlite handle.
        await self.retry.reap()
        self.retry.close()
        # LAST: the clean-shutdown stamp bounds the next boot's fsck
        # crash-window verify to blobs written after this instant.
        await asyncio.to_thread(write_clean_shutdown, self.store)


class BuildIndexNode:
    """Build-index: tag server + durable replication."""

    def __init__(
        self,
        store_root: str,
        host: str = "127.0.0.1",
        port: int = 0,
        backends: BackendManager | None = None,
        remotes: list[str] | None = None,
        origin_cluster: ClusterClient | None = None,
        ssl_context=None,
        immutable_tags: bool = False,
        task_timeout_seconds: float = 1800.0,
    ):
        from kraken_tpu_torch.buildindex.server import TagServer
        from kraken_tpu_torch.buildindex.tagstore import TagStore

        self.host = host
        self.port = port
        self.retry = RetryManager(
            TaskStore(f"{store_root}/retry.db"),
            task_timeout_seconds=task_timeout_seconds,
        )
        self.store = TagStore(
            f"{store_root}/tags", backends=backends, retry=self.retry
        )
        self.server = TagServer(
            self.store,
            retry=self.retry,
            remotes=remotes,
            origin_cluster=origin_cluster,
            immutable=immutable_tags,
        )
        self.ssl_context = ssl_context
        self._runner: Optional[http_lite.AppRunner] = None
        self._refresh_task: Optional[asyncio.Task] = None

    @property
    def addr(self) -> str:
        return f"{self.host}:{self.port}"

    async def start(self) -> None:
        self._runner, self.port = await _serve(
            self.server.make_app(), self.host, self.port, "build-index",
            ssl_context=self.ssl_context,
        )
        self.retry.start()
        self._refresh_task = asyncio.create_task(_ring_refresh_loop(
            lambda: self.server.origin_cluster, 5.0
        ))

    async def stop(self) -> None:
        if self._refresh_task:
            self._refresh_task.cancel()
        self.retry.stop()
        if self._runner:
            await self._runner.cleanup()
        await _release_process_globals(self, self._runner)
        await self.retry.reap()
        self.retry.close()


class ProxyNode:
    """Proxy: the docker-push registry frontend (write mode)."""

    def __init__(
        self,
        origin_cluster: ClusterClient,
        build_index_addr: str,
        host: str = "127.0.0.1",
        port: int = 0,
        ssl_context=None,
        spool_root: str | None = None,
    ):
        from kraken_tpu_torch.buildindex.server import TagClient
        from kraken_tpu_torch.dockerregistry.registry import RegistryServer
        from kraken_tpu_torch.dockerregistry.transfer import ProxyTransferer

        self.host = host
        self.port = port
        self.origin_cluster = origin_cluster
        self._tag_client = TagClient(build_index_addr)
        # A configured spool_root makes upload sessions durable across
        # proxy restarts (a crashed mid-push resumes); without it both
        # spools fall back to fresh temp dirs.
        upload_dir = os.path.join(spool_root, "uploads") if spool_root else None
        pass_dir = os.path.join(spool_root, "passthrough") if spool_root else None
        self.server = RegistryServer(
            ProxyTransferer(origin_cluster, self._tag_client,
                            spool_dir=pass_dir),
            read_only=False,
            upload_dir=upload_dir,
        )
        self.ssl_context = ssl_context
        self._runner: Optional[http_lite.AppRunner] = None
        self._refresh_task: Optional[asyncio.Task] = None

    @property
    def addr(self) -> str:
        return f"{self.host}:{self.port}"

    async def start(self) -> None:
        self._runner, self.port = await _serve(
            self.server.make_app(), self.host, self.port, "proxy",
            ssl_context=self.ssl_context,
        )
        self._refresh_task = asyncio.create_task(_ring_refresh_loop(
            lambda: self.origin_cluster, 5.0
        ))

    async def stop(self) -> None:
        if self._refresh_task:
            self._refresh_task.cancel()
        if self._runner:
            await self._runner.cleanup()
        await self._tag_client.close()
        await _release_process_globals(self, self._runner)


class AgentNode:
    """Agent: download daemon + agentserver (+ the docker-registry read
    endpoint when a build-index address is configured)."""

    def __init__(
        self,
        store_root: str,
        tracker_addr: str,
        host: str = "127.0.0.1",
        http_port: int = 0,
        p2p_port: int = 0,
        registry_port: int = 0,
        build_index_addr: str = "",
        hasher: str = "cuda",
        hash_workers: int = 1,
        cleanup: CleanupConfig | None = None,
        scheduler_config: SchedulerConfig | None = None,
        p2p_bandwidth: dict | None = None,
        ssl_context=None,
        tag_cache_ttl: float = 0.0,
        durability: str = "rename",
        registry_strict_accept: bool = False,
        scrub: dict | ScrubConfig | None = None,
        fsck: bool = True,
        recipe_cache_ttl_seconds: float = 60.0,
        rpc: dict | RPCConfig | None = None,
        resources: dict | ResourcesConfig | None = None,
        trace: dict | TraceConfig | None = None,
        delta: dict | DeltaConfig | None = None,
        profiling: dict | ProfilerConfig | None = None,
        chunkstore: dict | ChunkStoreConfig | None = None,
        slo: dict | SLOConfig | None = None,
        canary: dict | CanaryConfig | None = None,
        ingest: dict | IngestConfig | None = None,
        pex: dict | PexConfig | None = None,
    ):
        self.hasher_name = check_hasher(hasher)
        self.host = host
        self.http_port = http_port
        self.p2p_port = p2p_port
        # Agents run no ingest pipeline; ``ingest:`` here carries the
        # robustness knob only (resume gates whether fsck preserves
        # journaled upload state on the shared store layer).
        self.ingest_config = None if ingest is None else _config(IngestConfig, ingest)
        self.registry_port = registry_port
        # Manifest Accept negotiation: strict mode 406s clients pinned to
        # types the registry does not hold; off by default, as in the
        # reference (old docker clients regress under strict).
        self.registry_strict_accept = registry_strict_accept
        self.build_index_addr = build_index_addr
        # Positive-only tag cache TTL for the registry endpoint (0 = off;
        # sound only with a build-index that declares immutable_tags).
        self.tag_cache_ttl = tag_cache_ttl
        self.tracker_addr = tracker_addr
        self.store = CAStore(store_root, durability=durability)
        # Content-addressed chunk tier (store/chunkstore.py): completed
        # pulls whose recipe the delta planner fetched convert to
        # manifest + refcounted chunks -- agents are the tier's first
        # rollout ring. YAML `chunkstore:`; shipped OFF; SIGHUP
        # live-reloads. Attached before fsck.
        self.chunkstore_config = _config(ChunkStoreConfig, chunkstore)
        self.chunk_gc: Optional[ChunkGC] = None
        _sync_chunkstore(self)
        # Resource sentinel budgets (YAML `resources:`; live-reloadable).
        self.resources_config = _config(ResourcesConfig, resources)
        # Synthetic canary prober (utils/canary.py): a periodic seeded
        # pull through the real stack, so the SLO plane stays fed at
        # zero user traffic. Shipped OFF (needs `canary.origins`);
        # SIGHUP live-reloads.
        self.canary_config = _config(CanaryConfig, canary)
        self.canary: Optional[CanaryProber] = None
        # Delta-transfer plane (p2p/delta.py): on a pull, copy the chunks
        # a locally-held near-duplicate blob already has and fetch only
        # the rest (origin byte ranges + swarm pieces). Shipped OFF;
        # YAML `delta:`; SIGHUP live-reloads (the planner is always
        # constructed so a reload can enable it without a restart).
        self.delta_config = _config(DeltaConfig, delta)
        self.delta: Optional[DeltaPlanner] = None
        # CPU verify: one-tick batching (per-piece hashlib is cheap). Card
        # verify: a 2 ms window so arrivals coalesce into real device
        # batches. hash_workers >= 2 gives the cpu verify a host pool.
        self.verifier = BatchedVerifier(
            hasher=get_hasher(
                hasher, workers=hash_workers if hash_workers >= 2 else 0
            ),
            max_delay_seconds=0.0 if hasher == "cpu" else 0.002,
        )
        self.cleanup = (
            CleanupManager(self.store, cleanup, after_evict=self._after_evict)
            if cleanup
            else None
        )
        self.scheduler_config = scheduler_config
        self.p2p_bandwidth = (
            BandwidthLimiter(**p2p_bandwidth) if p2p_bandwidth else None
        )
        self.ssl_context = ssl_context
        # Agent self-healing: fsck sweeps crash debris; the scrubber
        # quarantines rot and unseeds it (the next read re-pulls).
        self.fsck_enabled = fsck
        self.scrub_config = _scrub_config(scrub)
        self.recipe_cache_ttl = recipe_cache_ttl_seconds
        self.rpc = _config(RPCConfig, rpc)
        self.trace_config = _config(TraceConfig, trace)
        self.profiling_config = _config(ProfilerConfig, profiling)
        self.slo_config = _config(SLOConfig, slo)
        # Gossip peer exchange (p2p/pex.py); the peercache path is fixed
        # at startup.
        self.pex_config = _config(PexConfig, pex)
        self.loop_monitor: Optional[LoopLagMonitor] = None
        self.sentinel: Optional[ResourceSentinel] = None
        # Process globals this node started (stopped by its stop()).
        self._owns_slo = self._owns_sampler = False
        self.scrubber: Optional[Scrubber] = None
        self.fsck_report = None
        self.scheduler: Optional[Scheduler] = None
        self.server: Optional[AgentServer] = None
        self._runner: Optional[http_lite.AppRunner] = None
        self._registry_runner: Optional[http_lite.AppRunner] = None
        self._tracker_client: Optional[TrackerClient] = None
        self._tag_client = None
        self._cleanup_task: Optional[asyncio.Task] = None
        self._loop: Optional[asyncio.AbstractEventLoop] = None

    @property
    def addr(self) -> str:
        return f"{self.host}:{self.http_port}"

    @property
    def registry_addr(self) -> str | None:
        """Where the docker-registry read endpoint is served, or None when
        it is off (no build-index address)."""
        if self._registry_runner is None:
            return None
        return f"{self.host}:{self.registry_port}"

    def _after_evict(self, d: Digest) -> None:
        """Cleanup worker thread, post-delete: an evicted blob leaves the
        swarm."""
        loop, sched = self._loop, self.scheduler
        if loop is not None and sched is not None:
            loop.call_soon_threadsafe(sched.unseed, d)

    def _on_scrub_corrupt(self, d: Digest, ns: str) -> None:
        """Scrub-task context (event loop), blob already quarantined:
        stop advertising it. The next local read is a cache miss and
        re-pulls verified pieces -- the agent's heal path."""
        if self.scheduler is not None:
            self.scheduler.unseed(d)

    async def start(self) -> None:
        self._loop = asyncio.get_running_loop()
        await asyncio.to_thread(_load_kernels, self.verifier.hasher)
        _apply_trace("agent", self.trace_config, self.store.root)
        self.profiling_config = _apply_profiling(
            self, "agent", self.profiling_config, self.store.root
        )
        _apply_slo(self, "agent", self.slo_config)
        _sync_loop_monitor(self, "agent")
        if self.fsck_enabled:
            self.fsck_report = await asyncio.to_thread(
                run_fsck,
                self.store,
                upload_ttl_seconds=(
                    self.cleanup.config.upload_ttl_seconds
                    if self.cleanup
                    else 6 * 3600
                ),
                expect_namespace=False,
                resume=(
                    self.ingest_config.resume
                    if self.ingest_config is not None
                    else True
                ),
            )
        factory = PeerIDFactory(
            PeerIDFactory.ADDR_HASH if self.p2p_port else PeerIDFactory.RANDOM
        )
        peer_id = factory.create(self.host, self.p2p_port)
        self._tracker_client = make_tracker_client(
            self.tracker_addr, peer_id, self.host, 0,
            announce_timeout_seconds=self.rpc.announce_timeout_seconds,
            request_deadline_seconds=self.rpc.request_deadline_seconds,
            hedge_delay_seconds=self.rpc.hedge_delay_seconds,
            recipe_cache_ttl_seconds=self.recipe_cache_ttl,
        )
        archive = AgentTorrentArchive(self.store, self.verifier)
        # Always constructed (cheap: one idle HTTP client); the config's
        # enabled flag gates every prefill, so a SIGHUP can turn delta on
        # without a restart.
        self.delta = DeltaPlanner(
            self.store, archive, self._tracker_client, self.delta_config
        )
        self.scheduler = Scheduler(
            peer_id=peer_id,
            ip=self.host,
            port=self.p2p_port,
            archive=archive,
            metainfo_client=self._tracker_client,
            announce_client=self._tracker_client,
            config=self.scheduler_config,
            bandwidth=self.p2p_bandwidth,
            delta=self.delta,
            pex=self.pex_config,
            peercache_path=os.path.join(self.store.root, "peercache.json"),
        )
        await self.scheduler.start()
        self._tracker_client.port = self.scheduler.port
        self.server = AgentServer(
            self.store, self.scheduler, cleanup=self.cleanup
        )
        self._runner, self.http_port = await _serve(
            self.server.make_app(), self.host, self.http_port, "agent",
            ssl_context=self.ssl_context,
            profile_device=_profile_device(self.verifier.hasher),
        )
        if self.cleanup is not None:
            self._cleanup_task = asyncio.create_task(
                _cleanup_loop(self.cleanup)
            )
        if self.scrub_config is not None:
            self.scrubber = Scrubber(
                self.store,
                self.scrub_config,
                hasher=self.verifier.hasher,
                on_corrupt=self._on_scrub_corrupt,
            )
            self.scrubber.start()
        self.sentinel = _start_sentinel(self, "agent")
        _sync_chunk_gc(self)
        # Canary prober: started always (one sleeping task), probing
        # only while canary.enabled -- so SIGHUP can flip it on live.
        self.canary = CanaryProber(
            self.store, self.scheduler, self.canary_config,
            node=f"agent-{self.host}",
        )
        self.canary.start()
        if self.build_index_addr:
            from kraken_tpu_torch.buildindex.server import TagClient
            from kraken_tpu_torch.dockerregistry.registry import RegistryServer
            from kraken_tpu_torch.dockerregistry.transfer import ReadOnlyTransferer

            self._tag_client = TagClient(self.build_index_addr)
            registry = RegistryServer(
                ReadOnlyTransferer(
                    self.store, self.scheduler, self._tag_client,
                    tag_cache_ttl=self.tag_cache_ttl,
                ),
                read_only=True,
                strict_accept=self.registry_strict_accept,
            )
            self._registry_runner, self.registry_port = await _serve(
                registry.make_app(), self.host, self.registry_port,
                "agent-registry", ssl_context=self.ssl_context,
                profile_device=_profile_device(self.verifier.hasher),
            )

    def reload(self, cfg: dict) -> None:
        """Apply a re-read config's sections live (SIGHUP). Every section
        is parsed before any is applied, so a config that raises keeps
        the current one whole."""
        sched = (
            SchedulerConfig.from_dict(cfg["scheduler"])
            if self.scheduler is not None and cfg.get("scheduler") is not None
            else None
        )
        parsed = {
            key: _config(cls, cfg[key]) for key, cls in (
                ("rpc", RPCConfig), ("resources", ResourcesConfig),
                ("trace", TraceConfig), ("delta", DeltaConfig),
                ("profiling", ProfilerConfig),
                ("chunkstore", ChunkStoreConfig), ("slo", SLOConfig),
                ("ingest", IngestConfig), ("canary", CanaryConfig),
                ("pex", PexConfig),
            ) if cfg.get(key) is not None
        }
        if sched is not None:
            self.scheduler.reload(sched)
        _reload_tracker_addrs(self, cfg.get("tracker"))
        if "rpc" in parsed:
            self.rpc = parsed["rpc"]
            if self._tracker_client is not None:
                self._tracker_client.announce_timeout = (
                    self.rpc.announce_timeout_seconds
                )
                if hasattr(self._tracker_client, "request_deadline"):
                    self._tracker_client.request_deadline = (
                        self.rpc.request_deadline_seconds
                    )
                    self._tracker_client.hedge_delay = (
                        self.rpc.hedge_delay_seconds or None
                    )
            _log.info("rpc config reloaded", extra={"node": self.addr})
        if "resources" in parsed:
            self.resources_config = parsed["resources"]
            if self.sentinel is not None:
                self.sentinel.apply(self.resources_config)
        if "trace" in parsed:
            self.trace_config = parsed["trace"]
            _apply_trace("agent", self.trace_config, self.store.root)
        if "delta" in parsed:
            # Live enable/disable + knob swap: the planner re-reads its
            # config object on every prefill.
            self.delta_config = parsed["delta"]
            if self.delta is not None:
                self.delta.config = self.delta_config
        if "profiling" in parsed:
            self.profiling_config = _apply_profiling(
                self, "agent", parsed["profiling"], self.store.root
            )
            _sync_loop_monitor(self, "agent")
        if "chunkstore" in parsed:
            # Agents-first rollout: SIGHUP-enable attaches the tier and
            # converts from the next completed pull on; disable stops
            # new conversions, manifest-backed blobs keep serving.
            self.chunkstore_config = parsed["chunkstore"]
            _sync_chunkstore(self)
            _sync_chunk_gc(self)
        if "delta" in parsed or "chunkstore" in parsed:
            _log_tier_reload(self)
        if "slo" in parsed:
            self.slo_config = parsed["slo"]
            _apply_slo(self, "agent", self.slo_config)
        if "ingest" in parsed:
            self.ingest_config = parsed["ingest"]
        if "canary" in parsed:
            # Live enable/disable + knob swap: the prober loop re-reads
            # its config object every tick.
            self.canary_config = parsed["canary"]
            if self.canary is not None:
                self.canary.config = self.canary_config
        if "pex" in parsed:
            # Cadence/budgets/TTLs swap live; the peercache path is
            # fixed at startup.
            self.pex_config = parsed["pex"]
            if self.scheduler is not None:
                self.scheduler.reload_pex(self.pex_config)

    async def drain(self, timeout: float | None = None) -> None:
        """Lameduck drain (SIGTERM): stop announcing, fail /health,
        refuse new swarm pulls and p2p conns; in-flight downloads and
        pieces finish up to ``drain_timeout``. :meth:`stop` follows."""
        await _drain_node(
            self.server, self.scheduler,
            self.rpc.drain_timeout_seconds if timeout is None else timeout,
            "agent",
        )

    async def stop(self) -> None:
        # Refusal-before-teardown (see OriginNode.stop).
        if self.server is not None:
            self.server.enter_lameduck()
        elif self.scheduler is not None:
            self.scheduler.enter_lameduck()
        if self._cleanup_task:
            self._cleanup_task.cancel()
        if self.sentinel:
            self.sentinel.stop()
            self.sentinel = None
        if self.loop_monitor:
            self.loop_monitor.stop()
            self.loop_monitor = None
        if self.scrubber:
            self.scrubber.stop()
        if self.chunk_gc:
            self.chunk_gc.stop()
            self.chunk_gc = None
        if self.canary:
            # Before the scheduler stops: the reap sweep unseeds its
            # canary blobs through it.
            await self.canary.stop()
            self.canary = None
        # The registry endpoint before the scheduler: no pull starts on a
        # scheduler that is stopping.
        if self._registry_runner:
            await self._registry_runner.cleanup()
        if self.scheduler:
            await self.scheduler.stop()
        if self._runner:
            await self._runner.cleanup()
        if self._tracker_client:
            await self._tracker_client.close()
        if self._tag_client:
            await self._tag_client.close()
        if self.delta:
            await self.delta.close()
        await _release_process_globals(
            self, self._runner, self._registry_runner
        )
        # LAST: bound the next boot's fsck crash-window verify.
        await asyncio.to_thread(write_clean_shutdown, self.store)
