"""Continuous profiling plane: the always-on sampler and the loop-lag
monitor.

The port's part of ``kraken_tpu.utils.profiler``, what the nodes start:

- :class:`SamplingProfiler` -- a background daemon thread walking
  ``sys._current_frames()`` at ``profiling.hz``, folding each thread's
  stack (``thread;root;...;leaf``) and tagging it with a data-plane label
  (pump / verify / pwrite / dispatch / store / pack / ingest / idle /
  other). Samples accumulate in a ring of ``keep_windows`` windows of
  ``window_seconds`` each (:meth:`~SamplingProfiler.folded`,
  :meth:`~SamplingProfiler.plane_totals`,
  :meth:`~SamplingProfiler.snapshot`);
  :meth:`~SamplingProfiler.plane_cumulative` is the monotonic per-plane
  count the dispatcher baselines a pull's plane split against. The
  tracer's dump triggers call :meth:`~SamplingProfiler.trigger_capture`,
  which writes the ring to ``profile-<trigger>-*.jsonl`` beside the trace
  dump, throttled per trigger kind.
- :class:`LoopLagMonitor` -- a heartbeat on the event loop: every tick's
  overshoot lands on ``loop_lag_seconds``; a tick past
  ``loop_lag_threshold_seconds`` counts a stall and names the main
  thread's last sampled stack in a WARN.

- :class:`HeapProfiler` (``HEAP``) -- on-demand tracemalloc snapshot/diff
  with the top-N growth sites, served on ``GET /debug/pprof/heap``.
- :func:`load_profile_dumps` folds any set of profile dumps for the
  ``flame`` subcommand, with every unparseable or truncated file named.

Forked data-plane workers (``p2p/shardpool.py``) call
:meth:`~SamplingProfiler.restart_in_child`, ship their folded-stack
deltas home with :meth:`~SamplingProfiler.drain_pending`, and the parent
adopts them under the worker's node stamp with
:meth:`~SamplingProfiler.record_foreign`, so one collapse covers the
node and its workers.

Overhead discipline: the shipped rate is LOW, and a sample is one
``sys._current_frames()`` walk plus a few dict increments off the event
loop entirely.
"""

from __future__ import annotations

import asyncio
import collections
import dataclasses
import json
import logging
import os
import sys
import threading
import time
import weakref
from typing import Iterable, Optional

_log = logging.getLogger("kraken.profiler")

# Live loop-lag monitors, for looplag_snapshot(). Weak so short-lived
# nodes never accumulate.
_monitors: "weakref.WeakSet[LoopLagMonitor]" = weakref.WeakSet()
_monitors_lock = threading.Lock()

# -- plane classification ---------------------------------------------------

# Data-plane attribution rules, matched leaf-first against each folded
# frame (``file.py:func``): the first hit names the plane -- is the leech
# pump (recv framing) or the verify hash or the pwrite the single-core
# bound? Order matters: storage.py hosts both verify dispatch and the
# pwrite, so the function-qualified rules come before the generic ones.
_PLANE_RULES: tuple[tuple[str, str], ...] = (
    ("storage.py:_write_at", "pwrite"),
    ("storage.py:write_piece", "pwrite"),
    ("castore.py:", "store"),
    ("hasher.py:", "verify"),
    ("sha256", "verify"),
    ("_hashlib", "verify"),
    ("storage.py:_hash_off_loop", "verify"),
    ("storage.py:_hash_in_thread", "verify"),
    ("storage.py:verify", "verify"),
    ("wire.py:", "pump"),
    ("conn.py:", "pump"),
    ("bufpool.py:", "pump"),
    # asyncio's selector transport read callback: the kernel->userspace
    # recv copy + StreamReader feed -- the raw ingress half of the pump.
    ("selector_events.py:_read_ready", "pump"),
    ("dispatch.py:", "dispatch"),
    ("scheduler.py:", "dispatch"),
    # Pipelined ingest plane (core/ingest.py): pack-worker threads show
    # as "pack" (the host relayout feeding the packed kernel -- the
    # function-qualified rule catches both native/__init__.py entries and
    # the C call's Python frame), window workers as "ingest".
    ("__init__.py:pack_tiles", "pack"),
    ("ingest.py:", "ingest"),
)

# A thread parked here is idle, not working: the event loop in its
# selector, a worker thread waiting for a task, the sampler's own wait.
_IDLE_MARKS = (
    "selectors.py:select",
    "threading.py:wait",
    "threading.py:_wait_for_tstate_lock",
    "queue.py:get",
    "socket.py:accept",
    "thread.py:_worker",  # an executor thread parked on its work queue
)


def classify_plane(frames: Iterable[str]) -> str:
    """Plane tag for one folded stack (frames leaf-last). The leaf
    decides idleness; the deepest rule hit decides the plane."""
    frames = list(frames)
    if frames:
        leaf = frames[-1]
        for mark in _IDLE_MARKS:
            if mark in leaf:
                return "idle"
    for frame in reversed(frames):
        for needle, plane in _PLANE_RULES:
            if needle in frame:
                return plane
    return "other"


def fold_stack(frame, max_depth: int = 64) -> list[str]:
    """One thread's live stack as ``file.py:func`` frames, root-first."""
    out: list[str] = []
    depth = max_depth
    while frame is not None and depth > 0:
        code = frame.f_code
        out.append(
            f"{os.path.basename(code.co_filename)}:{code.co_name}"
        )
        frame = frame.f_back
        depth -= 1
    out.reverse()
    return out




def plane_pct_busy(planes: dict) -> dict:
    """Plane sample counts -> percent of BUSY samples (idle excluded)."""
    total = sum(planes.values())
    busy = total - planes.get("idle", 0)
    if not busy:
        return {}
    return {
        k: round(100.0 * v / busy, 1)
        for k, v in sorted(planes.items()) if k != "idle"
    }


# -- config -----------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ProfilerConfig:
    """The YAML ``profiling:`` section (agent + origin + tracker; SIGHUP
    live-reloads), every field of the reference's with its checks."""

    # Master switch: off = no sampler thread, no loop-lag monitor.
    enabled: bool = True
    # Sampling frequency. Shipped LOW: a sample walks every thread.
    hz: float = 29.0
    # One ring window's span and how many the ring keeps: the live
    # surface answers over hz x window x keep seconds of history.
    window_seconds: float = 30.0
    keep_windows: int = 10
    # Frames kept per folded stack (leaf-most win).
    max_stack_depth: int = 24
    # Loop-lag heartbeat period and the stall threshold past which a
    # tick WARNs with the sampler's concurrent main-thread stack.
    loop_lag_interval_seconds: float = 0.25
    loop_lag_threshold_seconds: float = 0.5
    # Top-N offender sites in a heap diff (/debug/pprof/heap).
    heap_top: int = 10
    # Where trigger_capture writes profile JSONLs; "" = the node
    # substitutes <store_root>/traces (beside the trace dumps).
    dump_dir: str = ""
    # Floor between two captures of the SAME trigger kind.
    dump_min_interval_seconds: float = 30.0

    @classmethod
    def from_dict(cls, doc: dict | None) -> "ProfilerConfig":
        doc = dict(doc or {})
        allowed = {f.name for f in dataclasses.fields(cls)}
        unknown = set(doc) - allowed
        if unknown:
            raise ValueError(
                f"unknown profiling config keys: {sorted(unknown)}"
            )
        cfg = cls(**doc)
        if not 0.0 < cfg.hz <= 250.0:
            raise ValueError(
                f"profiling.hz must be in (0, 250], got {cfg.hz}"
            )
        if cfg.window_seconds <= 0 or cfg.keep_windows < 1:
            raise ValueError("profiling window knobs must be positive")
        if cfg.loop_lag_interval_seconds <= 0:
            raise ValueError("profiling.loop_lag_interval_seconds must be > 0")
        return cfg


# -- the sampler ------------------------------------------------------------

class _Window:
    __slots__ = ("start", "counts", "planes", "samples")

    def __init__(self, start: float):
        self.start = start
        self.counts: collections.Counter[str] = collections.Counter()
        self.planes: collections.Counter[str] = collections.Counter()
        self.samples = 0


# Bound on DISTINCT foreign stacks retained per shipping node: a worker
# gone wild must cost flamegraph resolution, not parent RSS.
_FOREIGN_STACKS_MAX = 4096
# Bound on the worker-side not-yet-shipped delta (the stats tick drains
# it every 250 ms, so hitting this means the parent is gone anyway).
_PENDING_STACKS_MAX = 4096


class SamplingProfiler:
    """One per process (like the metric REGISTRY and the TRACER); nodes
    apply their YAML ``profiling:`` section at start and on SIGHUP.
    Forked worker shards call :meth:`restart_in_child` -- the sampler
    thread does not survive a fork, and the child must never touch the
    possibly-mid-operation locks it inherited."""

    def __init__(self, config: ProfilerConfig | None = None):
        self.config = config or ProfilerConfig()
        self.node = ""  # stamped on dumps + shipped samples
        self._lock = threading.Lock()
        self._windows: collections.deque[_Window] = collections.deque()
        # node -> Counter of folded stacks shipped home by worker shards
        # (record_foreign); rendered + dumped beside local samples.
        self._foreign: dict[str, collections.Counter[str]] = {}
        self._foreign_planes: dict[str, collections.Counter[str]] = {}
        # Monotonic per-plane sample counts (local + foreign), NEVER
        # trimmed by window rotation: delta consumers (the per-pull
        # plane_split in dispatch.py) baseline against this -- a
        # baseline against the rotating ring goes negative the moment
        # an old window drops out mid-pull. O(planes) memory.
        self._plane_cum: collections.Counter[str] = collections.Counter()
        # Child-side delta awaiting shipment over the control channel.
        self._pending: collections.Counter[str] = collections.Counter()
        self._pending_planes: collections.Counter[str] = collections.Counter()
        self._ship_mode = False  # True only inside worker shards
        self._in_child = False  # child: never touch the inherited REGISTRY
        self._thread: Optional[threading.Thread] = None
        self._stop_evt = threading.Event()
        # Latest folded stack per thread id -- the loop-lag monitor's
        # blame source ("what was the main thread doing when the tick
        # stalled").
        self._last_stacks: dict[int, str] = {}
        self._main_tid = threading.main_thread().ident
        self._dump_lock = threading.Lock()
        self._last_dump: dict[str, float] = {}
        self._dump_seq = 0
        self._c_samples = None  # lazy: registering at import would force
        # the metric on processes that never profile

    # -- lifecycle ---------------------------------------------------------

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def start(self) -> None:
        if self.running or not self.config.enabled:
            return
        self._stop_evt = threading.Event()
        self._thread = threading.Thread(
            target=self._run, name="kraken-profiler", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        t = self._thread
        if t is None:
            return
        self._stop_evt.set()
        if t is not threading.current_thread():
            t.join(timeout=2.0)
        self._thread = None

    def apply(self, config: ProfilerConfig | dict | None) -> None:
        """Live config swap (SIGHUP): a changed rate restarts the
        sampler thread; disabling stops it; the ring keeps what it
        holds (rotation trims it to the new keep_windows)."""
        if not isinstance(config, ProfilerConfig):
            config = ProfilerConfig.from_dict(config)
        was = (self.config.hz, self.config.enabled)
        self.config = config
        if not config.enabled:
            self.stop()
        elif not self.running or was[0] != config.hz:
            self.stop()
            self.start()

    def restart_in_child(self, node: str) -> None:
        """Forked worker entry: fresh locks (the inherited ones may be
        held by a parent thread that no longer exists here), cleared
        sample state (the parent's ring lives in the parent), shipping
        on, REGISTRY off (workers have no /metrics; the inherited
        metric locks are fork-unsafe), then start if enabled."""
        self._lock = threading.Lock()
        self._dump_lock = threading.Lock()
        self._windows = collections.deque()
        self._foreign = {}
        self._foreign_planes = {}
        self._plane_cum = collections.Counter()
        self._pending = collections.Counter()
        self._pending_planes = collections.Counter()
        self._last_stacks = {}
        self._thread = None  # the parent's thread object is a corpse here
        self._ship_mode = True
        self._in_child = True
        self._c_samples = None
        self.node = node
        self._main_tid = threading.main_thread().ident
        self.start()

    def reset(self) -> None:
        """Drop every sample (local and foreign). Benches use this to
        scope attribution to one measured run."""
        with self._lock:
            self._windows.clear()
            self._foreign.clear()
            self._foreign_planes.clear()
            self._plane_cum.clear()
            self._pending.clear()
            self._pending_planes.clear()

    # -- the sampling thread -----------------------------------------------

    def _run(self) -> None:
        period = 1.0 / self.config.hz
        while not self._stop_evt.wait(period):
            try:
                self._sample_once()
            except Exception:  # the profiler must never take the node down
                _log.warning("profiler sample failed", exc_info=True)
            # Re-read: apply() may have swapped the config under us.
            period = 1.0 / self.config.hz

    def _sample_once(self) -> None:
        now = time.monotonic()
        own = threading.get_ident()
        names = {t.ident: t.name for t in threading.enumerate()}
        frames = sys._current_frames()
        folded: list[tuple[int, str, str]] = []  # (tid, stack, plane)
        # Drop each frame reference the moment it is folded (and the
        # dict before touching the lock): a held frame keeps a
        # just-returned function's locals alive, and code that closes
        # exact-lifetime resources (mmaps, exported memoryviews) right
        # after a hot call would see BufferError for every beat we
        # extend them.
        for tid in list(frames):
            frame = frames.pop(tid)
            if tid == own:
                continue
            parts = fold_stack(frame, self.config.max_stack_depth)
            del frame
            plane = classify_plane(parts)
            name = names.get(tid, f"tid{tid}")
            folded.append((tid, f"{name};" + ";".join(parts), plane))
        del frames
        with self._lock:
            win = self._rotate_locked(now)
            for tid, stack, plane in folded:
                self._last_stacks[tid] = stack
                win.counts[stack] += 1
                win.planes[plane] += 1
                win.samples += 1
                self._plane_cum[plane] += 1
                if self._ship_mode and len(self._pending) < _PENDING_STACKS_MAX:
                    self._pending[stack] += 1
                    self._pending_planes[plane] += 1
        if not self._in_child and folded:
            if self._c_samples is None:
                from kraken_tpu_torch.utils.metrics import REGISTRY

                self._c_samples = REGISTRY.counter(
                    "profiler_samples_total",
                    "Thread-stack samples taken by the sampling profiler",
                )
            self._c_samples.inc(len(folded))

    def _rotate_locked(self, now: float) -> _Window:
        cfg = self.config
        if not self._windows or (
            now - self._windows[-1].start >= cfg.window_seconds
        ):
            self._windows.append(_Window(now))
        while len(self._windows) > cfg.keep_windows:
            self._windows.popleft()
        return self._windows[-1]

    # -- reading -----------------------------------------------------------

    def folded(
        self, include_foreign: bool = True
    ) -> list[tuple[str, int]]:
        """Aggregated (stack, count) over the whole ring, foreign worker
        samples prefixed with their node stamp -- the flamegraph
        collapse, sorted hot-first."""
        agg: collections.Counter[str] = collections.Counter()
        with self._lock:
            for win in self._windows:
                agg.update(win.counts)
            if include_foreign:
                for node, counts in self._foreign.items():
                    for stack, c in counts.items():
                        agg[f"{node};{stack}"] += c
        return agg.most_common()

    def plane_totals(self, include_foreign: bool = True) -> dict[str, int]:
        """Plane counts over the RING (what the live surfaces show).
        Shrinks as windows rotate out -- delta consumers must baseline
        against :meth:`plane_cumulative` instead."""
        agg: collections.Counter[str] = collections.Counter()
        with self._lock:
            for win in self._windows:
                agg.update(win.planes)
            if include_foreign:
                for counts in self._foreign_planes.values():
                    agg.update(counts)
        return dict(agg)

    def plane_cumulative(self) -> dict[str, int]:
        """Monotonic per-plane sample counts since start/reset (local +
        foreign), immune to window rotation -- the correct baseline for
        "what happened between T0 and T1" deltas."""
        with self._lock:
            return dict(self._plane_cum)

    def main_thread_stack(self) -> str | None:
        """The latest sampled main-thread stack -- the loop-lag
        monitor's blame line. None until the sampler has seen it."""
        with self._lock:
            return self._last_stacks.get(self._main_tid)

    def snapshot(self) -> dict:
        """The ``/debug/pprof/profile?format=json`` document."""
        with self._lock:
            windows = [
                {
                    "age_s": round(time.monotonic() - w.start, 1),
                    "samples": w.samples,
                    "planes": dict(w.planes),
                }
                for w in self._windows
            ]
            foreign = {
                node: sum(c.values()) for node, c in self._foreign.items()
            }
        planes = self.plane_totals()
        return {
            "node": self.node,
            "running": self.running,
            "hz": self.config.hz,
            "windows": windows,
            "foreign_samples": foreign,
            "planes": planes,
            "plane_pct_busy": plane_pct_busy(planes),
            "stacks": self.folded()[:200],
        }

    # -- cross-process shipping (worker shards) ----------------------------

    def drain_pending(self, max_stacks: int = 256) -> dict | None:
        """Worker side: pop up to ``max_stacks`` distinct folded stacks
        (+ their plane counts) for one control-channel message. None
        when there is nothing to ship."""
        with self._lock:
            if not self._pending:
                return None
            items = self._pending.most_common(max_stacks)
            for stack, _c in items:
                del self._pending[stack]
            planes = dict(self._pending_planes)
            self._pending_planes.clear()
        return {
            "node": self.node,
            "stacks": [[s, c] for s, c in items],
            "planes": planes,
        }

    def record_foreign(
        self, node: str, stacks: Iterable, planes: dict | None = None
    ) -> None:
        """Parent side: adopt a worker shard's folded-stack delta under
        its node stamp. Bounded per node -- an over-cap stack folds into
        a synthetic ``(truncated)`` bucket so totals stay honest."""
        if not node:
            return
        with self._lock:
            counts = self._foreign.setdefault(node, collections.Counter())
            for entry in stacks:
                try:
                    stack, c = entry[0], int(entry[1])
                except (TypeError, ValueError, IndexError):
                    continue
                if (
                    len(counts) >= _FOREIGN_STACKS_MAX
                    and stack not in counts
                ):
                    stack = "(truncated)"
                counts[stack] += c
            if planes:
                pc = self._foreign_planes.setdefault(
                    node, collections.Counter()
                )
                for plane, c in planes.items():
                    try:
                        pc[str(plane)] += int(c)
                        self._plane_cum[str(plane)] += int(c)
                    except (TypeError, ValueError):
                        continue

    # -- profile dumps (the postmortem artifact) ---------------------------

    def trigger_capture(self, trigger: str, detail: str = "") -> str | None:
        """A degradation plane fired (the tracer's dump triggers call
        this hook): persist the sample ring as a profile JSONL beside
        the trace dump, throttled per trigger kind. Never raises."""
        try:
            cfg = self.config
            if not cfg.dump_dir or not cfg.enabled:
                return None
            now = time.monotonic()
            with self._dump_lock:
                last = self._last_dump.get(trigger, -float("inf"))
                if now - last < cfg.dump_min_interval_seconds:
                    return None
                self._last_dump[trigger] = now
            path = self.dump(trigger, detail)
            if path is None:
                # Nothing written (empty ring): free the throttle slot so
                # the next trigger of this kind retries.
                with self._dump_lock:
                    if self._last_dump.get(trigger) == now:
                        del self._last_dump[trigger]
            return path
        except Exception:
            return None

    def dump(self, trigger: str = "manual", detail: str = "") -> str | None:
        """Write the current collapse (local + foreign) to
        ``<dump_dir>/profile-<trigger>-*.jsonl``; the header's ``stacks``
        count lets a reader detect a truncated file. Returns the path, or
        None (no dir / empty ring). Synchronous off-loop; handed to a
        writer thread on a running loop (the triggers fire
        mid-degradation -- same contract as the trace dumps)."""
        cfg = self.config
        if not cfg.dump_dir:
            return None
        node = self.node
        # Rows carry their OWN node stamp (worker-shipped stacks keep
        # theirs), so the flame loader joins multi-process samples
        # without double-prefixing.
        local: collections.Counter[str] = collections.Counter()
        with self._lock:
            for win in self._windows:
                local.update(win.counts)
            foreign = {
                n: c.most_common() for n, c in self._foreign.items()
            }
        rows: list[tuple[str, str, int]] = [
            (node, s, c) for s, c in local.most_common()
        ]
        for n, counts in foreign.items():
            rows.extend((n, s, c) for s, c in counts)
        if not rows:
            return None
        planes = self.plane_totals()
        with self._dump_lock:
            self._dump_seq += 1
            seq = self._dump_seq
        path = os.path.join(
            cfg.dump_dir,
            f"profile-{trigger}-{int(time.time())}-{os.getpid()}-{seq}.jsonl",
        )
        header = {
            "profile": trigger,
            "detail": detail,
            "node": node,
            "ts": time.time(),
            "hz": cfg.hz,
            "stacks": len(rows),
            "samples": sum(c for _n, _s, c in rows),
            "planes": planes,
        }

        def _write() -> None:
            try:
                os.makedirs(cfg.dump_dir, exist_ok=True)
                tmp = path + ".tmp"
                with open(tmp, "w") as f:
                    f.write(json.dumps(header) + "\n")
                    for row_node, stack, count in rows:
                        f.write(json.dumps(
                            {"stack": stack, "count": count,
                             "node": row_node},
                            separators=(",", ":"),
                        ) + "\n")
                os.replace(tmp, path)
                if not self._in_child:
                    from kraken_tpu_torch.utils.metrics import REGISTRY

                    REGISTRY.counter(
                        "profile_dumps_total",
                        "Profile JSONL postmortems written, by trigger",
                    ).inc(trigger=trigger)
            except Exception:
                # Best-effort postmortem -- but a profile capture that
                # never lands should show up in the logs, not vanish.
                _log.warning("profile dump write failed", exc_info=True)

        try:
            asyncio.get_running_loop()
        except RuntimeError:
            _write()
            if not os.path.exists(path):
                return None
        else:
            threading.Thread(
                target=_write, name=f"profile-dump-{trigger}", daemon=True
            ).start()
        return path


PROFILER = SamplingProfiler()


# -- loop-lag monitor -------------------------------------------------------

_LAG_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5,
)

# Recent-lag ring behind p99(): ~10 min of history at the shipped
# 0.25 s heartbeat.
_LAG_KEEP = 2400


class LoopLagMonitor:
    """One per node event loop. A stalled tick is attributed via the
    sampler's concurrent main-thread stack: the frames a 29 Hz sampler
    caught DURING a >=0.5 s block are, with near certainty, the
    blocking callee."""

    def __init__(
        self,
        component: str = "",
        config: ProfilerConfig | None = None,
        profiler: SamplingProfiler | None = None,
    ):
        self.component = component
        self.config = config or ProfilerConfig()
        self.profiler = profiler if profiler is not None else PROFILER
        self._recent: collections.deque[float] = collections.deque(
            maxlen=_LAG_KEEP
        )
        self._stalls = 0
        self._last_blame: str | None = None
        self._task: Optional[asyncio.Task] = None
        from kraken_tpu_torch.utils.metrics import REGISTRY

        self._hist = REGISTRY.histogram(
            "loop_lag_seconds",
            "Event-loop heartbeat overshoot (scheduling lag) per tick",
            buckets=_LAG_BUCKETS,
        )
        self._c_stalls = REGISTRY.counter(
            "loop_lag_stalls_total",
            "Heartbeat ticks stalled past profiling.loop_lag_threshold"
            "_seconds",
        )
        with _monitors_lock:
            _monitors.add(self)

    def start(self) -> None:
        self._task = asyncio.get_running_loop().create_task(self._loop())

    def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            self._task = None
        with _monitors_lock:
            _monitors.discard(self)

    def apply(self, config: ProfilerConfig) -> None:
        """Live reload: the next tick uses the new period/threshold."""
        self.config = config

    async def _loop(self) -> None:
        loop = asyncio.get_running_loop()
        while True:
            cfg = self.config
            t0 = loop.time()
            await asyncio.sleep(cfg.loop_lag_interval_seconds)
            lag = max(0.0, loop.time() - t0 - cfg.loop_lag_interval_seconds)
            self._recent.append(lag)
            self._hist.observe(lag, component=self.component)
            if (
                cfg.loop_lag_threshold_seconds > 0
                and lag >= cfg.loop_lag_threshold_seconds
            ):
                self._stalls += 1
                self._c_stalls.inc(component=self.component)
                blame = (
                    self.profiler.main_thread_stack()
                    if self.profiler is not None and self.profiler.running
                    else None
                )
                self._last_blame = blame
                _log.warning(
                    "event loop stalled",
                    extra={
                        "component": self.component,
                        "lag_s": round(lag, 3),
                        "threshold_s": cfg.loop_lag_threshold_seconds,
                        "blame": blame or "(sampler off)",
                    },
                )

    # -- reading -----------------------------------------------------------

    def p99(self) -> float | None:
        """p99 of the recent lag ring. None before any tick."""
        if not self._recent:
            return None
        vals = sorted(self._recent)
        return vals[min(len(vals) - 1, int(len(vals) * 0.99))]

    def snapshot(self) -> dict:
        vals = sorted(self._recent)

        def pct(p: float) -> float | None:
            if not vals:
                return None
            return round(vals[min(len(vals) - 1, int(len(vals) * p))], 6)

        return {
            "component": self.component,
            "interval_s": self.config.loop_lag_interval_seconds,
            "threshold_s": self.config.loop_lag_threshold_seconds,
            "ticks": len(vals),
            "p50_s": pct(0.5),
            "p99_s": pct(0.99),
            "max_s": round(vals[-1], 6) if vals else None,
            "stalls": self._stalls,
            "last_blame": self._last_blame,
        }


def looplag_snapshot() -> dict:
    """The ``GET /debug/pprof/looplag`` document: every live monitor's
    percentile view."""
    with _monitors_lock:
        insts = list(_monitors)
    return {
        "monitors": {
            f"{m.component}/{i}": m.snapshot()
            for i, m in enumerate(sorted(insts, key=lambda m: m.component))
        },
    }


# -- heap diffing -----------------------------------------------------------

class HeapProfiler:
    """On-demand tracemalloc snapshot/diff, served on
    ``GET /debug/pprof/heap``: first call starts tracing and baselines;
    later calls report the top-N growth sites since the baseline. Tracing
    costs real memory and CPU, so it runs only while an operator asked for
    it -- ``stop()`` (``?stop=1`` on the endpoint, or the stop of the node
    that served it) turns it back off, if this profiler turned it on."""

    def __init__(self):
        self._baseline = None
        self._started_here = False
        self._lock = threading.Lock()

    @property
    def tracing(self) -> bool:
        import tracemalloc

        return tracemalloc.is_tracing()

    def baseline(self, frames: int = 10) -> dict:
        import gc
        import tracemalloc

        with self._lock:
            if not tracemalloc.is_tracing():
                tracemalloc.start(frames)
                self._started_here = True
            gc.collect()
            self._baseline = tracemalloc.take_snapshot()
        cur, peak = tracemalloc.get_traced_memory()
        return {
            "status": "baseline",
            "traced_current_bytes": cur,
            "traced_peak_bytes": peak,
        }

    def diff(self, top_n: int = 10) -> dict:
        """Top-N python-heap growth sites since the baseline. Baselines
        implicitly on the first call."""
        import gc
        import tracemalloc

        with self._lock:
            if self._baseline is None or not tracemalloc.is_tracing():
                pass  # fall through to baseline below
            else:
                gc.collect()
                snap = tracemalloc.take_snapshot()
                stats = snap.compare_to(self._baseline, "lineno")
                cur, peak = tracemalloc.get_traced_memory()
                return {
                    "status": "diff",
                    "traced_current_bytes": cur,
                    "traced_peak_bytes": peak,
                    "top": [
                        {
                            "site": str(s.traceback),
                            "size_diff_bytes": s.size_diff,
                            "count_diff": s.count_diff,
                            "size_bytes": s.size,
                        }
                        for s in stats[:top_n]
                    ],
                }
        return self.baseline()

    def stop(self) -> dict:
        import tracemalloc

        with self._lock:
            self._baseline = None
            if tracemalloc.is_tracing() and self._started_here:
                tracemalloc.stop()
            self._started_here = False
        return {"status": "stopped"}


HEAP = HeapProfiler()


# -- offline reassembly (the `kraken-tpu flame` subcommand) -----------------

class ProfileDumpError(Exception):
    """A profile dump file failed validation (unparseable line, missing
    header, or fewer stack lines than the header promised -- a
    truncated capture). ``kraken-tpu flame`` exits non-zero on it."""


def load_profile_dumps(
    paths: Iterable[str],
) -> tuple[collections.Counter, collections.Counter, list[str]]:
    """Read one or more profile JSONL dumps (multi-node) into
    (merged ``node;stack`` -> count, plane -> count, errors). Every
    error string names the file and the defect; callers gate CI on the
    list being empty."""
    stacks: collections.Counter[str] = collections.Counter()
    planes: collections.Counter[str] = collections.Counter()
    errors: list[str] = []
    for path in paths:
        try:
            with open(path) as f:
                lines = f.readlines()
        except OSError as e:
            errors.append(f"{path}: unreadable: {e}")
            continue
        expected: int | None = None
        seen = 0
        header_ok = False
        for lineno, line in enumerate(lines, 1):
            line = line.strip()
            if not line:
                continue
            try:
                doc = json.loads(line)
            except ValueError:
                errors.append(f"{path}:{lineno}: unparseable line")
                continue
            if not isinstance(doc, dict):
                errors.append(f"{path}:{lineno}: not an object")
                continue
            if "profile" in doc:
                if expected is not None and seen < expected:
                    errors.append(
                        f"{path}: truncated block: header promised "
                        f"{expected} stacks, found {seen}"
                    )
                expected = doc.get("stacks")
                if not isinstance(expected, int):
                    errors.append(f"{path}:{lineno}: header missing stacks")
                    expected = None
                seen = 0
                header_ok = True
                for plane, c in (doc.get("planes") or {}).items():
                    try:
                        planes[str(plane)] += int(c)
                    except (TypeError, ValueError):
                        errors.append(
                            f"{path}:{lineno}: malformed plane count"
                        )
                continue
            if "stack" in doc:
                seen += 1
                try:
                    count = int(doc.get("count", 1))
                except (TypeError, ValueError):
                    errors.append(f"{path}:{lineno}: malformed count")
                    continue
                node = str(doc.get("node") or "")
                key = f"{node};{doc['stack']}" if node else str(doc["stack"])
                stacks[key] += count
                continue
            errors.append(f"{path}:{lineno}: neither header nor stack")
        if not header_ok:
            errors.append(f"{path}: no profile header")
        elif expected is not None and seen < expected:
            errors.append(
                f"{path}: truncated: header promised {expected} stacks, "
                f"found {seen}"
            )
    return stacks, planes, errors
