"""In-process resource sentinel: the fleet-survival auditor.

The port's copy of ``kraken_tpu.utils.resources``. A slow fd leak, an RSS
creep, a task spawned per conn and never reaped, spool files orphaned by a
crashed client, a bufpool lease that stopped coming back: each is
invisible until the process dies, unless the process audits itself. The
sentinel samples, every ``interval_seconds``:

- open fds (``/proc/self/fd``) and RSS (``/proc/self/statm``);
- the asyncio task census, tagged by creation site, with the top-N sites;
- bufpool leased buffers and retained bytes, and active p2p conns;
- store debris (stale upload spools, orphaned sidecars, stale ``.part`` /
  ``.alloc`` staging, tmp-sidecar survivors, quarantine count), counted by
  fsck's rules (``store/recovery.py``) without repairing anything;
- the node's persistedretry queue depth and its loop-lag p99.

Samples publish as ``resource_*`` gauges on ``/metrics`` and as JSON on
``GET /debug/resources`` (:func:`debug_snapshot`), and are checked against
the YAML ``resources:`` budgets (0 = off: the shipped sentinel only
observes; SIGHUP reloads them). A breach counts on
``resource_budget_breaches_total{kind}`` and leaves a flight-recorder
dump; one sustained for ``breach_streak`` samples, with
``drain_on_breach``, enters the lameduck drain once, latched until it
clears.
"""

from __future__ import annotations

import asyncio
import collections
import dataclasses
import logging
import os
import threading
import time
import weakref

_log = logging.getLogger("kraken.resources")

# Every live sentinel, for the /debug/resources mux (same pattern as
# placement/healthcheck's breaker registry). Weak so short-lived
# in-process nodes never accumulate; stop() also deregisters.
_instances: "weakref.WeakSet[ResourceSentinel]" = weakref.WeakSet()
_instances_lock = threading.Lock()


# -- process-wide probes (no sentinel needed) ------------------------------

def open_fd_count() -> int | None:
    """Open fds for THIS process, or None off-Linux. The listdir itself
    briefly holds one fd on the proc directory; subtract it so the
    number means "fds the program holds"."""
    try:
        return len(os.listdir("/proc/self/fd")) - 1
    except OSError:
        return None


_PAGE = 4096
try:
    _PAGE = os.sysconf("SC_PAGE_SIZE")
except (ValueError, OSError, AttributeError):  # pragma: no cover
    pass


def rss_bytes() -> int | None:
    """Resident set size, or None off-Linux."""
    try:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * _PAGE
    except (OSError, IndexError, ValueError):
        return None


def child_fd_count(pid: int) -> int | None:
    """Open fds of a CHILD process (a data-plane worker shard), or None
    when it is gone / off-Linux. With worker processes the self-probes
    above go blind to half the data plane; the sentinel aggregates these
    per-child numbers into the same gauges."""
    try:
        return len(os.listdir(f"/proc/{pid}/fd"))
    except OSError:
        return None


def child_rss_bytes(pid: int) -> int | None:
    """Resident set size of a child process, or None when gone."""
    try:
        with open(f"/proc/{pid}/statm") as f:
            return int(f.read().split()[1]) * _PAGE
    except (OSError, IndexError, ValueError):
        return None


def _task_site(task: "asyncio.Task") -> str:
    """Tag a task by the code object of its coroutine -- the creation
    site an operator can actually grep for."""
    try:
        coro = task.get_coro()
        code = getattr(coro, "cr_code", None) or getattr(coro, "gi_code", None)
        if code is None:
            return repr(coro)[:80]
        # co_qualname is 3.11+; co_name is the portable spelling.
        name = getattr(code, "co_qualname", None) or code.co_name
        return (
            f"{os.path.basename(code.co_filename)}:"
            f"{code.co_firstlineno}:{name}"
        )
    except Exception:  # a task mid-teardown must not break the census
        return "<unknown>"


def task_census(top_n: int = 8) -> tuple[int, dict[str, int]]:
    """(total live tasks, top-N creation sites by count). Callable only
    with a running loop; returns (0, {}) otherwise."""
    try:
        tasks = asyncio.all_tasks()
    except RuntimeError:
        return 0, {}
    counts: collections.Counter[str] = collections.Counter()
    for t in tasks:
        if not t.done():
            counts[_task_site(t)] += 1
    total = sum(counts.values())
    return total, dict(counts.most_common(top_n))


def scan_store_orphans(
    store,
    *,
    upload_ttl_seconds: float = 6 * 3600,
    min_age_seconds: float = 60.0,
) -> dict[str, int]:
    """Count-only debris scan of a CAStore tree (fsck's classification,
    store/recovery.py, without the repairs). Synchronous -- the sentinel
    runs it off-loop.

    ``min_age_seconds`` guards the races a LIVE store has that a
    quiescent fsck does not: a sidecar between ``set_metadata``'s write
    and rename, a blob between commit and its namespace sidecar, a
    just-allocated ``.part``. Nothing younger than it is ever counted.
    A ``.part`` beside its piece-bitfield sidecar is an ACTIVE download
    regardless of age (resumable state, fsck spares it the same way) --
    only a ``.part`` older than the upload TTL counts, mirroring fsck's
    sweep rule, and its sidecar is never counted while the ``.part``
    exists.
    """
    now = time.time()
    counts = {
        "stale_spool": 0,
        "stale_partial": 0,
        "tmp_sidecar": 0,
        "orphan_sidecar": 0,
        "quarantine": 0,
    }

    def age(path: str) -> float | None:
        try:
            return now - os.path.getmtime(path)
        except OSError:
            return None

    try:
        spool_names = os.listdir(store.upload_dir)
    except OSError:
        spool_names = []
    for name in spool_names:
        a = age(os.path.join(store.upload_dir, name))
        if a is not None and upload_ttl_seconds > 0 and a > upload_ttl_seconds:
            counts["stale_spool"] += 1

    for dirpath, _dirnames, filenames in os.walk(store.cache_dir):
        present = set(filenames)
        for name in filenames:
            path = os.path.join(dirpath, name)
            if "._md_" in name:
                tail = name.rsplit("._md_", 1)[1]
                if ".tmp" in tail:
                    a = age(path)
                    if a is not None and a > min_age_seconds:
                        counts["tmp_sidecar"] += 1
                    continue
                base = name.split("._md_", 1)[0]
                # A sidecar beside its data file, beside a live
                # ``.part`` (the piece bitfield crash-resume depends
                # on), or beside a chunk-tier manifest (the blob's
                # bytes live in the chunk tier; the manifest IS its
                # committed presence) is not an orphan.
                from kraken_tpu_torch.store.metadata import ChunkManifestMetadata

                if (
                    base in present
                    or f"{base}.part" in present
                    or f"{base}._md_{ChunkManifestMetadata.name}" in present
                ):
                    continue
                a = age(path)
                if a is not None and a > min_age_seconds:
                    counts["orphan_sidecar"] += 1
            elif name.endswith((".part", ".alloc")):
                a = age(path)
                if (
                    a is not None
                    and upload_ttl_seconds > 0
                    and a > upload_ttl_seconds
                ):
                    counts["stale_partial"] += 1

    counts["quarantine"] = len(store.list_quarantined())
    return counts


# -- config ----------------------------------------------------------------

@dataclasses.dataclass
class ResourcesConfig:
    """The YAML ``resources:`` section. Budgets of 0 are OFF -- the
    sentinel then only observes. ``drain_on_breach`` is the opt-in
    teeth: a budget breached for ``breach_streak`` consecutive samples
    enters lameduck drain (docs/OPERATIONS.md "Resource budgets")."""

    interval_seconds: float = 30.0
    max_open_fds: int = 0
    max_rss_mb: float = 0.0
    max_tasks: int = 0
    max_bufpool_leased: int = 0
    max_conns: int = 0
    max_orphans: int = 0
    # Event-loop responsiveness budget: breach when the loop-lag
    # monitor's recent p99 (utils/profiler.py LoopLagMonitor, fed via
    # the sentinel's ``loop_lag_probe``) exceeds this many seconds.
    # A wedged loop is a resource exhaustion like any other -- the node
    # still answers /health (aiohttp keeps limping) while every piece
    # serve and announce rots in the queue; with ``drain_on_breach``
    # the node sheds itself before the swarm blacklists it.
    loop_lag_p99_seconds: float = 0.0
    # Persistedretry backlog budget: breach when the node's durable task
    # queue (replication + writeback + heal + hint, summed across kinds)
    # exceeds this many pending rows. A wedged executor -- replication
    # pushing into a dead ring, hints piling up behind a partition --
    # grows this without bound while the node otherwise looks healthy;
    # the per-kind ``retry_queue_depth`` gauge names the culprit.
    max_retry_queue: int = 0
    breach_streak: int = 3
    drain_on_breach: bool = False
    top_tasks: int = 8
    # Orphan-scan live-race guard; tests lower it to exercise the scan.
    orphan_min_age_seconds: float = 60.0

    @classmethod
    def from_dict(cls, doc: dict | None) -> "ResourcesConfig":
        doc = dict(doc or {})
        allowed = {f.name for f in dataclasses.fields(cls)}
        unknown = set(doc) - allowed
        if unknown:
            raise ValueError(
                f"unknown resources config keys: {sorted(unknown)}"
            )
        return cls(**doc)


# The breach kinds (the ``kind`` label on
# ``resource_budget_breaches_total``), with their budget field and the
# sample field they gate.
_BUDGETS = (
    ("fds", "max_open_fds", "open_fds"),
    ("rss", "max_rss_mb", "rss_mb"),
    ("tasks", "max_tasks", "tasks"),
    ("bufpool_leased", "max_bufpool_leased", "bufpool_leased"),
    ("conns", "max_conns", "conns"),
    ("orphans", "max_orphans", "orphans_total"),
    ("loop_lag", "loop_lag_p99_seconds", "loop_lag_p99"),
    ("retry_queue", "max_retry_queue", "retry_queue_total"),
)


class ResourceSentinel:
    """One per node (agent/origin). ``scheduler`` and ``store`` are the
    node's own (either may be None -- the process-wide probes still
    run); ``on_sustained_breach(kinds)`` is the drain hook assembly
    wires when ``drain_on_breach`` is set."""

    def __init__(
        self,
        component: str,
        config: ResourcesConfig | dict | None = None,
        *,
        scheduler=None,
        store=None,
        upload_ttl_seconds: float = 6 * 3600,
        on_sustained_breach=None,
        loop_lag_probe=None,
        retry_probe=None,
    ):
        self.component = component
        self.config = (
            config if isinstance(config, ResourcesConfig)
            else ResourcesConfig.from_dict(config)
        )
        self.scheduler = scheduler
        self.store = store
        self.upload_ttl_seconds = upload_ttl_seconds
        self.on_sustained_breach = on_sustained_breach
        # () -> recent loop-lag p99 seconds or None (assembly wires the
        # node's LoopLagMonitor.p99 in); gates the "loop_lag" budget.
        self.loop_lag_probe = loop_lag_probe
        # () -> {kind: pending count} from the node's persistedretry
        # Manager (assembly wires Manager.queue_depths); gates the
        # "retry_queue" budget and feeds the per-kind depth gauge.
        self.retry_probe = retry_probe
        self.last_sample: dict | None = None
        # (monotonic_ts, open_fds, rss_bytes) history -- a leak
        # harness's least-squares input. Bounded: a week at 30 s/sample.
        self.history: collections.deque = collections.deque(maxlen=20160)
        self._streaks: dict[str, int] = {}
        self._breach_latched = False
        self._task: asyncio.Task | None = None
        from kraken_tpu_torch.utils.metrics import REGISTRY

        self._breaches = REGISTRY.counter(
            "resource_budget_breaches_total",
            "Resource-budget breaches observed by the sentinel, by kind",
        )
        self._g_fds = REGISTRY.gauge(
            "resource_open_fds", "Open fds of this process (sentinel sample)"
        )
        self._g_rss = REGISTRY.gauge(
            "resource_rss_bytes", "Resident set size (sentinel sample)"
        )
        self._g_tasks = REGISTRY.gauge(
            "resource_asyncio_tasks", "Live asyncio tasks (sentinel sample)"
        )
        self._g_conns = REGISTRY.gauge(
            "resource_active_conns", "Active p2p conns, per component"
        )
        self._g_orphans = REGISTRY.gauge(
            "resource_orphan_files",
            "Store debris counted by the sentinel, per component and kind",
        )
        self._g_retry = REGISTRY.gauge(
            "retry_queue_depth",
            "Pending persistedretry tasks, per component and task kind",
        )
        with _instances_lock:
            _instances.add(self)

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        self._task = asyncio.create_task(self._loop())

    def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            self._task = None
        with _instances_lock:
            _instances.discard(self)

    def apply(self, config: ResourcesConfig | dict) -> None:
        """Live reload (SIGHUP ``resources:`` section): budgets and the
        period apply from the next sample; breach streaks reset so a
        freshly-raised budget starts clean."""
        self.config = (
            config if isinstance(config, ResourcesConfig)
            else ResourcesConfig.from_dict(config)
        )
        self._streaks.clear()
        self._breach_latched = False
        _log.info(
            "resources config reloaded", extra={"component": self.component}
        )

    async def _loop(self) -> None:
        while True:
            await asyncio.sleep(self.config.interval_seconds)
            try:
                await self.sample()
            except asyncio.CancelledError:
                raise
            except Exception:
                # The auditor must never take the node down.
                _log.warning(
                    "resource sample failed",
                    extra={"component": self.component}, exc_info=True,
                )

    # -- sampling ----------------------------------------------------------

    async def sample(self) -> dict:
        """One full sample: probes + gauges + budget check. The store
        scan walks the tree, so it runs off-loop."""
        orphans: dict[str, int] = {}
        if self.store is not None:
            orphans = await asyncio.to_thread(
                scan_store_orphans,
                self.store,
                upload_ttl_seconds=self.upload_ttl_seconds,
                min_age_seconds=self.config.orphan_min_age_seconds,
            )
        return self._finish_sample(orphans)

    def _finish_sample(self, orphans: dict[str, int]) -> dict:
        fds = open_fd_count()
        rss = rss_bytes()
        tasks, top = task_census(self.config.top_tasks)
        pool = getattr(self.scheduler, "_bufpool", None)
        conns = (
            self.scheduler.num_active_conns
            if self.scheduler is not None else 0
        )
        # Data-plane worker shards (p2p/shardpool.py): a forked child's
        # fds and RSS are invisible to /proc/self -- aggregate them into
        # the same budgets, and reap-check: a shard that died without
        # being asked counts as a BREACH ("workers"), never as silence.
        workers = []
        shardpool = getattr(self.scheduler, "_shardpool", None)
        if shardpool is not None:
            workers = shardpool.worker_info()
        # Leech worker shards are the same supervision story on the
        # download plane: fold them into the identical budgets.
        leechpool = getattr(self.scheduler, "_leech_pool", None)
        if leechpool is not None:
            workers = workers + leechpool.worker_info()
        worker_fds = 0
        worker_rss = 0
        workers_alive = 0
        for winfo in workers:
            if winfo.get("alive"):
                workers_alive += 1
            wfds = child_fd_count(winfo["pid"]) if winfo.get("pid") else None
            wrss = child_rss_bytes(winfo["pid"]) if winfo.get("pid") else None
            winfo["open_fds"] = wfds
            winfo["rss_bytes"] = wrss
            worker_fds += wfds or 0
            worker_rss += wrss or 0
        workers_expected = (
            shardpool.expected_workers if shardpool is not None else 0
        ) + (
            leechpool.expected_workers if leechpool is not None else 0
        )
        if fds is not None:
            fds += worker_fds
        if rss is not None:
            rss += worker_rss
        loop_lag_p99 = None
        if self.loop_lag_probe is not None:
            try:
                loop_lag_p99 = self.loop_lag_probe()
            except Exception:  # the probe must never fail the sample
                loop_lag_p99 = None
        retry_depths: dict[str, int] = {}
        retry_total = None
        if self.retry_probe is not None:
            try:
                retry_depths = dict(self.retry_probe())
                retry_total = sum(retry_depths.values())
            except Exception:  # the probe must never fail the sample
                retry_depths, retry_total = {}, None
        sample = {
            "component": self.component,
            "ts": time.time(),
            "loop_lag_p99": loop_lag_p99,
            "open_fds": fds,
            "rss_bytes": rss,
            "rss_mb": (rss / (1 << 20)) if rss is not None else None,
            "worker_fds": worker_fds,
            "worker_rss_bytes": worker_rss,
            "workers": workers,
            "workers_alive": workers_alive,
            "workers_expected": workers_expected,
            "tasks": tasks,
            "top_task_sites": top,
            "bufpool_leased": pool.leased if pool is not None else 0,
            "bufpool_retained_bytes": (
                pool.retained_bytes if pool is not None else 0
            ),
            "conns": conns,
            "orphans": orphans,
            "orphans_total": sum(orphans.values()),
            "retry_queue": retry_depths,
            "retry_queue_total": retry_total,
        }
        if fds is not None:
            self._g_fds.set(fds)
        if rss is not None:
            self._g_rss.set(rss)
        self._g_tasks.set(tasks)
        self._g_conns.set(conns, component=self.component)
        for kind, n in orphans.items():
            self._g_orphans.set(n, component=self.component, kind=kind)
        for kind, n in retry_depths.items():
            self._g_retry.set(n, component=self.component, kind=kind)
        breached = self._check_budgets(sample)
        sample["breached"] = breached
        self.last_sample = sample
        self.history.append((time.monotonic(), fds, rss))
        return sample

    def _check_budgets(self, sample: dict) -> list[str]:
        cfg = self.config
        breached: list[str] = []
        # Reap-check, no budget knob: a dead worker shard is ALWAYS a
        # breach -- the supervisor respawns it, but the death must count
        # (crash-looping shards show up as a climbing breach counter,
        # not as a mysteriously slow data plane).
        if sample.get("workers_alive", 0) < sample.get("workers_expected", 0):
            breached.append("workers")
            self._streaks["workers"] = self._streaks.get("workers", 0) + 1
            self._breaches.inc(kind="workers")
            _log.warning(
                "resource breach: data-plane worker shard dead",
                extra={
                    "component": self.component,
                    "alive": sample.get("workers_alive"),
                    "expected": sample.get("workers_expected"),
                },
            )
        else:
            self._streaks.pop("workers", None)
        for kind, budget_field, sample_field in _BUDGETS:
            budget = getattr(cfg, budget_field)
            value = sample.get(sample_field)
            if not budget or value is None:
                self._streaks.pop(kind, None)
                continue
            if value > budget:
                breached.append(kind)
                self._streaks[kind] = self._streaks.get(kind, 0) + 1
                self._breaches.inc(kind=kind)
                _log.warning(
                    "resource budget breached",
                    extra={
                        "component": self.component, "kind": kind,
                        "value": value, "budget": budget,
                        "streak": self._streaks[kind],
                    },
                )
            else:
                self._streaks.pop(kind, None)
        if breached:
            # Budget breach = degradation event: leave a flight-recorder
            # postmortem (throttled per trigger kind, never raises).
            from kraken_tpu_torch.utils.trace import TRACER

            TRACER.trigger_dump("resource_breach", ",".join(breached))
        sustained = [
            k for k in breached
            if self._streaks.get(k, 0) >= cfg.breach_streak
        ]
        if sustained and not self._breach_latched:
            # Latched until every sustained breach clears: a node
            # hovering at its budget must drain ONCE, not every sample.
            self._breach_latched = True
            if self.on_sustained_breach is not None and cfg.drain_on_breach:
                _log.warning(
                    "sustained resource breach: entering lameduck drain",
                    extra={"component": self.component, "kinds": sustained},
                )
                try:
                    self.on_sustained_breach(sustained)
                except Exception:
                    _log.exception("sustained-breach hook failed")
        elif not breached:
            self._breach_latched = False
        return breached

    # -- debug surface -----------------------------------------------------

    def snapshot(self) -> dict:
        return {
            "config": dataclasses.asdict(self.config),
            "last_sample": self.last_sample,
            "breach_streaks": dict(self._streaks),
            "breach_latched": self._breach_latched,
        }


def debug_snapshot() -> dict:
    """The ``GET /debug/resources`` document: a live process-wide probe
    (meaningful even on components without a sentinel -- tracker,
    proxy, build-index) plus every registered sentinel's last sample
    and budget state."""
    tasks, top = task_census()
    with _instances_lock:
        insts = list(_instances)
    doc = {
        "process": {
            "open_fds": open_fd_count(),
            "rss_bytes": rss_bytes(),
            "tasks": tasks,
            "top_task_sites": top,
        },
        "sentinels": {},
    }
    for i, inst in enumerate(
        sorted(insts, key=lambda s: s.component)
    ):
        doc["sentinels"][f"{inst.component}/{i}"] = inst.snapshot()
    return doc
