"""End-to-end distributed tracing + per-node flight recorder.

The port's copy of ``kraken_tpu.utils.trace`` (the Dapper design of
Sigelman et al., 2010, stdlib only), with the same wire format, so a
download's trace crosses between the two packages' nodes:

- a W3C-``traceparent``-style context (``00-<trace_id>-<span_id>-<flags>``)
  carried in a :mod:`contextvars` variable, so it propagates across
  ``await`` boundaries and into ``asyncio.create_task`` children for
  free; the P2P handshake and piece requests carry it to the remote
  (``p2p/wire.py``), whose serve spans join the dialer's trace;
- head sampling at the ROOT span (``trace.sample_rate``), inherited by
  every child -- plus an always-kept tail: spans that ERROR or run past
  ``slow_threshold_seconds`` are recorded even on unsampled traces, so
  the one bad request is never averaged away;
- a bounded ring of finished spans per process (the flight recorder),
  dumped to JSONL by :meth:`Tracer.trigger_dump`, and
  :meth:`Tracer.record_foreign` for span dicts shipped home by other
  processes.

Offline, :func:`load_dumps`, :func:`assemble_tree`, :func:`critical_path`
and :func:`format_tree` join several nodes' dumps into span trees (the
``trace`` subcommand). At import the module registers
:func:`exemplar_trace_id` as the metric histograms' exemplar provider.

The SHA-256 plane's stage boundaries (:func:`stage`, :func:`bill`,
:class:`plane`) count seconds and intervals by path and stage, enter a
``torch.profiler`` range while one records, and are spans on sampled
traces.

Overhead discipline: the shipped sample rate is LOW, span creation is a
plain object + two clock reads, and the per-piece spans in the data plane
are gated on the trace's sampled flag.
"""

from __future__ import annotations

import asyncio
import contextvars
import dataclasses
import json
import logging
import os
import random
import sys
import threading
import time
from collections import deque
from typing import Iterable, Optional

_log = logging.getLogger("kraken.trace")

_TRACEPARENT_VERSION = "00"

# The contextvar IS the propagation mechanism: asyncio copies the
# context into every task at creation, so a span entered before
# create_task is the parent of everything the task does.
_current: contextvars.ContextVar[Optional["Span"]] = contextvars.ContextVar(
    "kraken_trace_span", default=None
)


def _gen_trace_id() -> str:
    return os.urandom(16).hex()


def _gen_span_id() -> str:
    return os.urandom(8).hex()


class Span:
    """One timed operation. Created via :func:`span` / :meth:`Tracer.
    start_span`; finished exactly once (the context manager does it).

    Always a full object even when unsampled: the error/slow tail keep
    needs the timing and attributes of spans the head sampler skipped.
    """

    __slots__ = (
        "name", "trace_id", "span_id", "parent_id", "sampled",
        "start_ts", "_t0", "duration_s", "attrs", "events", "status",
        "error", "_finished", "_token",
    )

    def __init__(
        self,
        name: str,
        trace_id: str,
        span_id: str,
        parent_id: str = "",
        sampled: bool = False,
        attrs: dict | None = None,
    ):
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.sampled = sampled
        # Wall clock for cross-process joins (monotonic clocks do not
        # align between nodes); duration from the perf counter so a
        # stepped wall clock cannot produce negative spans.
        self.start_ts = time.time()
        self._t0 = time.perf_counter()
        self.duration_s: float = 0.0
        self.attrs = attrs or {}
        self.events: list[dict] = []
        self.status = "ok"
        self.error = ""
        self._finished = False
        self._token: Optional[contextvars.Token] = None

    # -- in-flight mutation ------------------------------------------------

    def set(self, **attrs) -> None:
        self.attrs.update(attrs)

    def event(self, name: str, **fields) -> None:
        self.events.append({"name": name, "ts": time.time(), **fields})

    def mark_error(self, err: BaseException | str) -> None:
        self.status = "error"
        self.error = repr(err) if isinstance(err, BaseException) else err

    # -- wire format -------------------------------------------------------

    @property
    def traceparent(self) -> str:
        flags = "01" if self.sampled else "00"
        return (
            f"{_TRACEPARENT_VERSION}-{self.trace_id}-{self.span_id}-{flags}"
        )

    def to_dict(self) -> dict:
        d = {
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "name": self.name,
            "start_ts": round(self.start_ts, 6),
            "duration_s": round(self.duration_s, 6),
            "status": self.status,
        }
        if self.error:
            d["error"] = self.error
        if self.attrs:
            d["attrs"] = self.attrs
        if self.events:
            d["events"] = self.events
        return d

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (
            f"Span({self.name}, trace={self.trace_id[:8]}, "
            f"span={self.span_id}, sampled={self.sampled})"
        )


@dataclasses.dataclass
class ParentContext:
    """An extracted remote parent (traceparent header / wire field):
    enough to continue the trace without a live Span object."""

    trace_id: str
    span_id: str
    sampled: bool

    @property
    def traceparent(self) -> str:
        return (
            f"{_TRACEPARENT_VERSION}-{self.trace_id}-{self.span_id}-"
            f"{'01' if self.sampled else '00'}"
        )


def parse_traceparent(value: str | None) -> Optional[ParentContext]:
    """``00-<32 hex>-<16 hex>-<2 hex>`` -> ParentContext, or None for
    anything malformed (a bad header from a skewed peer must never fail
    the request it rides on)."""
    if not value or not isinstance(value, str):
        return None
    parts = value.strip().split("-")
    if len(parts) < 4:
        return None
    _ver, trace_id, span_id, flags = parts[0], parts[1], parts[2], parts[3]
    if len(trace_id) != 32 or len(span_id) != 16:
        return None
    try:
        int(trace_id, 16), int(span_id, 16)
        sampled = bool(int(flags, 16) & 1)
    except ValueError:
        return None
    if int(trace_id, 16) == 0:
        return None
    return ParentContext(trace_id, span_id, sampled)


@dataclasses.dataclass(frozen=True)
class TraceConfig:
    """The YAML ``trace:`` section (agent + origin + tracker;
    live-reloads via SIGHUP). Knob table in docs/OPERATIONS.md
    "Tracing"."""

    # Master switch: off means no spans are created at all (the
    # trace-off leg of the overhead bench).
    enabled: bool = True
    # Head-sampling probability for NEW root spans; children inherit
    # the root's decision. Shipped LOW (base.yaml) -- error/slow spans
    # are kept regardless, so 0.01 still leaves postmortem artifacts.
    sample_rate: float = 0.01
    # An unsampled span at or past this duration is recorded anyway
    # (the always-kept slow tail). 0 disables the slow tail.
    slow_threshold_seconds: float = 1.0
    # Flight-recorder ring size (finished spans kept in memory).
    keep_spans: int = 4096
    # Where trigger_dump writes JSONL postmortems; "" = assembly
    # substitutes <store_root>/traces for nodes that own a store
    # (trackers without a configured dir skip file dumps).
    dump_dir: str = ""
    # Floor between two dumps of the SAME trigger kind: a breach storm
    # or a flapping breaker must not write unbounded postmortems.
    dump_min_interval_seconds: float = 30.0

    @classmethod
    def from_dict(cls, doc: dict | None) -> "TraceConfig":
        doc = dict(doc or {})
        allowed = {f.name for f in dataclasses.fields(cls)}
        unknown = set(doc) - allowed
        if unknown:
            raise ValueError(f"unknown trace config keys: {sorted(unknown)}")
        cfg = cls(**doc)
        if not 0.0 <= cfg.sample_rate <= 1.0:
            raise ValueError(
                f"trace.sample_rate must be in [0, 1], got {cfg.sample_rate}"
            )
        return cfg


class FlightRecorder:
    """Bounded ring of finished span dicts + trace-level indices for the
    /debug/trace views. Thread-safe: spans finish on the event loop, on
    worker threads (hash pools), and via the shardpool control channel."""

    def __init__(self, keep: int = 4096):
        self._lock = threading.Lock()
        self._keep = keep
        self._spans: deque[dict] = deque(maxlen=keep)

    def resize(self, keep: int) -> None:
        with self._lock:
            if keep != self._keep:
                self._keep = keep
                self._spans = deque(self._spans, maxlen=keep)

    def record(self, span_dict: dict) -> None:
        with self._lock:
            self._spans.append(span_dict)

    def snapshot(self) -> list[dict]:
        with self._lock:
            return list(self._spans)

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()

    # -- views (GET /debug/trace) -----------------------------------------

    def recent(self, limit: int = 100) -> list[dict]:
        snap = self.snapshot()
        return snap[-limit:][::-1]

    def errored(self, limit: int = 100) -> list[dict]:
        out = [s for s in self.snapshot() if s.get("status") == "error"]
        return out[-limit:][::-1]

    def slowest(self, limit: int = 20) -> list[dict]:
        """The slowest-N TRACES (by their root-most recorded span's
        duration), each returned whole so the reader sees where the
        time went, not just that it went."""
        by_trace = self.traces()
        roots: list[tuple[float, str]] = []
        for tid, spans in by_trace.items():
            dur = max(s.get("duration_s", 0.0) for s in spans)
            roots.append((dur, tid))
        roots.sort(reverse=True)
        out = []
        for dur, tid in roots[:limit]:
            out.append({
                "trace_id": tid,
                "duration_s": dur,
                "spans": sorted(
                    by_trace[tid], key=lambda s: s.get("start_ts", 0.0)
                ),
            })
        return out

    def trace(self, trace_id: str) -> list[dict]:
        return sorted(
            (s for s in self.snapshot() if s.get("trace_id") == trace_id),
            key=lambda s: s.get("start_ts", 0.0),
        )

    def traces(self) -> dict[str, list[dict]]:
        by_trace: dict[str, list[dict]] = {}
        for s in self.snapshot():
            by_trace.setdefault(s.get("trace_id", ""), []).append(s)
        return by_trace


class Tracer:
    """Process-global tracing state: config, recorder, dump throttle.
    One per process (like the metric REGISTRY); nodes apply their YAML
    ``trace:`` section at start and on SIGHUP."""

    def __init__(self, config: TraceConfig | None = None):
        self.config = config or TraceConfig()
        self.recorder = FlightRecorder(self.config.keep_spans)
        self.node = ""  # stamped on every span (assembly sets component)
        # Hook fed every recorded span dict: forked seed-serve workers
        # use it to buffer spans for shipment home over the shardpool
        # control channel (the recorder alone would strand them in the
        # child process). Must never raise into finish().
        self.on_record = None
        # Hook fired on every dump trigger (breaker trip, deadline,
        # resource breach, lameduck), before the dump_dir gate: the
        # nodes register the profiler's stack capture here
        # (SamplingProfiler.trigger_capture). Must never raise.
        self.on_trigger = None
        self._rng = random.Random()
        self._dump_lock = threading.Lock()
        self._last_dump: dict[str, float] = {}
        self._dump_seq = 0

    # -- config ------------------------------------------------------------

    def apply(self, config: TraceConfig | dict | None) -> None:
        """Live config swap (SIGHUP): sampling and thresholds apply to
        the next span; the ring resizes in place without losing what it
        holds."""
        if not isinstance(config, TraceConfig):
            config = TraceConfig.from_dict(config)
        self.config = config
        self.recorder.resize(config.keep_spans)

    # -- span lifecycle ----------------------------------------------------

    def start_span(
        self,
        name: str,
        parent: "Span | ParentContext | None" = None,
        **attrs,
    ) -> Optional[Span]:
        """Open a span. ``parent=None`` means "child of the contextvar's
        current span, else a new root". Returns None when tracing is
        disabled outright -- callers use the :func:`span` context
        manager, which tolerates that."""
        cfg = self.config
        if not cfg.enabled:
            return None
        if parent is None:
            parent = _current.get()
        if parent is not None:
            trace_id = parent.trace_id
            parent_id = parent.span_id
            sampled = parent.sampled
        else:
            trace_id = _gen_trace_id()
            parent_id = ""
            sampled = (
                cfg.sample_rate > 0.0
                and self._rng.random() < cfg.sample_rate
            )
        return Span(
            name, trace_id, _gen_span_id(), parent_id, sampled, attrs or None
        )

    def finish(self, sp: Span) -> None:
        """Close + maybe record. Unsampled spans are kept only as the
        error/slow tail; sampled spans always land in the ring."""
        if sp._finished:
            return
        sp._finished = True
        sp.duration_s = time.perf_counter() - sp._t0
        cfg = self.config
        keep = sp.sampled or sp.status == "error" or (
            cfg.slow_threshold_seconds > 0
            and sp.duration_s >= cfg.slow_threshold_seconds
        )
        if not keep:
            return
        d = sp.to_dict()
        if self.node:
            d["node"] = self.node
        self.recorder.record(d)
        if self.on_record is not None:
            try:
                self.on_record(d)
            except Exception:
                # Best-effort shipping, visibly so: dropped spans that
                # never log are a propagation break nobody can debug.
                _log.debug("on_record span hook failed", exc_info=True)
        from kraken_tpu_torch.utils.metrics import REGISTRY

        REGISTRY.counter(
            "trace_spans_recorded_total",
            "Finished spans kept by the flight recorder",
        ).inc()

    def record_foreign(self, span_dicts: Iterable[dict]) -> None:
        """Adopt finished spans from another process (forked seed-serve
        workers ship theirs over the shardpool control channel) -- they
        already carry their node stamp and sampling verdict."""
        for d in span_dicts:
            if isinstance(d, dict) and d.get("trace_id"):
                self.recorder.record(d)

    # -- dump-to-JSONL (the postmortem artifact) ---------------------------

    def trigger_dump(self, trigger: str, detail: str = "") -> str | None:
        """A degradation plane fired (breaker trip, DeadlineExceeded,
        resource breach, lameduck): persist the flight recorder NOW,
        throttled per trigger kind. Returns the dump path -- written
        synchronously off-loop, handed to a writer thread when called on
        a running event loop -- or None (throttled / no dump dir /
        empty ring / write failed off-loop). Never raises -- an
        observability failure must not compound the degradation it is
        recording."""
        try:
            return self._trigger_dump(trigger, detail)
        except Exception:
            return None

    def _trigger_dump(self, trigger: str, detail: str) -> str | None:
        cfg = self.config
        from kraken_tpu_torch.utils.metrics import REGISTRY

        REGISTRY.counter(
            "trace_dump_triggers_total",
            "Degradation events that asked for a flight-recorder dump",
        ).inc(trigger=trigger)
        hook = self.on_trigger
        if hook is not None:
            try:
                hook(trigger, detail)
            except Exception:
                # Must not mute the dump -- but must not vanish either.
                _log.warning("on_trigger profile hook failed",
                             exc_info=True)
        if not cfg.dump_dir:
            return None
        now = time.monotonic()
        with self._dump_lock:
            last = self._last_dump.get(trigger, -float("inf"))
            if now - last < cfg.dump_min_interval_seconds:
                return None
        # A no-op dump must not consume the throttle slot: stamping
        # before the empty-ring check would mute the next REAL
        # postmortem of this trigger kind for the full interval.
        spans = self.recorder.snapshot()
        if not spans:
            return None
        with self._dump_lock:
            last = self._last_dump.get(trigger, -float("inf"))
            if now - last < cfg.dump_min_interval_seconds:
                return None  # lost the race to a concurrent dumper
            self._last_dump[trigger] = now
            self._dump_seq += 1
            seq = self._dump_seq
        path = os.path.join(
            cfg.dump_dir,
            f"trace-{trigger}-{int(time.time())}-{os.getpid()}-{seq}.jsonl",
        )
        header = {
            "dump": trigger,
            "detail": detail,
            "ts": time.time(),
            "node": self.node,
            "spans": len(spans),
        }

        def _write() -> None:
            try:
                os.makedirs(cfg.dump_dir, exist_ok=True)
                tmp = path + ".tmp"
                with open(tmp, "w") as f:
                    f.write(json.dumps(header) + "\n")
                    for s in spans:
                        f.write(json.dumps(s, separators=(",", ":"),
                                           default=str) + "\n")
                os.replace(tmp, path)
                REGISTRY.counter(
                    "trace_dumps_total",
                    "Flight-recorder JSONL postmortems written, by trigger",
                ).inc(trigger=trigger)
            except Exception:
                # Never compound the degradation event -- but a
                # postmortem that failed to land must be findable.
                _log.warning("trace dump write failed", exc_info=True)

        # The triggers fire ON the event loop (breaker trip, deadline,
        # sentinel) at exactly the moment the node is degrading -- a
        # multi-MB synchronous write there would stall the data plane.
        # Off-loop callers (tests, offline tools) keep the synchronous
        # contract: the file exists when this returns.
        try:
            asyncio.get_running_loop()
        except RuntimeError:
            _write()
            if not os.path.exists(path):
                # Nothing got written: free the throttle slot so the
                # next trigger retries instead of inheriting a 30 s
                # mute for a dump that never happened.
                with self._dump_lock:
                    if self._last_dump.get(trigger) == now:
                        del self._last_dump[trigger]
                return None
        else:
            threading.Thread(
                target=_write, name=f"trace-dump-{trigger}", daemon=True
            ).start()
        return path


TRACER = Tracer()


# -- the ergonomic surface (what call sites use) ----------------------------


class span:
    """``with trace.span("origin.commit", digest=d.hex) as sp:`` --
    usable in sync and async code (contextvars survive awaits). Enters
    the contextvar so children created inside (including via
    ``asyncio.create_task``) join the trace; exceptions mark the span
    error and re-raise."""

    __slots__ = ("_name", "_attrs", "_parent", "_sp")

    def __init__(self, _name: str, _parent=None, **attrs):
        self._name = _name
        self._attrs = attrs
        self._parent = _parent
        self._sp: Optional[Span] = None

    def __enter__(self) -> Optional[Span]:
        sp = TRACER.start_span(self._name, parent=self._parent, **self._attrs)
        self._sp = sp
        if sp is not None:
            sp._token = _current.set(sp)
        return sp

    def __exit__(self, exc_type, exc, tb) -> bool:
        sp = self._sp
        if sp is not None:
            if sp._token is not None:
                _current.reset(sp._token)
                sp._token = None
            if exc is not None:
                # Cancellation is routine control flow here -- losing
                # hedge attempts and teardown cancel spans by design
                # (origin/client.py: "NOT host evidence") -- so it must
                # not ride the always-kept error tail and flood the
                # ring; status still says what happened.
                if isinstance(exc, asyncio.CancelledError):
                    sp.status = "cancelled"
                else:
                    sp.mark_error(exc)
            TRACER.finish(sp)
        return False


def current() -> Optional[Span]:
    return _current.get()


def current_ids() -> tuple[str, str] | None:
    """(trace_id, span_id) of the active span, or None -- the cheap
    probe structlog / networkevent use to stamp their lines."""
    sp = _current.get()
    if sp is None:
        return None
    return sp.trace_id, sp.span_id


def current_traceparent(sampled_only: bool = False) -> str | None:
    """The header/wire value to propagate from here, or None when no
    span is active (or, with ``sampled_only``, when the active trace
    lost the sampling roll -- the wire plane skips per-piece span
    machinery on unsampled traces)."""
    sp = _current.get()
    if sp is None or (sampled_only and not sp.sampled):
        return None
    return sp.traceparent


def exemplar_trace_id() -> str | None:
    """Histogram exemplar hook (utils/metrics.py): the trace to attach
    to this observation -- sampled traces only, so every exemplar on
    /metrics is actually findable in /debug/trace."""
    sp = _current.get()
    if sp is None or not sp.sampled:
        return None
    return sp.trace_id


# -- offline reassembly (the `kraken-tpu trace` subcommand) -----------------


def load_dumps(paths: Iterable[str]) -> dict[str, list[dict]]:
    """Read one or more flight-recorder JSONL dumps (multi-node) into
    trace_id -> [span dicts]. Dump header lines (``{"dump": ...}``) and
    malformed lines are skipped; duplicate span ids (the same dump taken
    twice, or a span present in two nodes' rings) dedupe."""
    by_trace: dict[str, dict[str, dict]] = {}
    for path in paths:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    doc = json.loads(line)
                except ValueError:
                    continue
                if not isinstance(doc, dict) or "trace_id" not in doc:
                    continue
                spans = by_trace.setdefault(doc["trace_id"], {})
                spans.setdefault(doc.get("span_id", ""), doc)
    return {tid: list(spans.values()) for tid, spans in by_trace.items()}


def assemble_tree(spans: list[dict]) -> tuple[list[dict], list[dict]]:
    """(roots, orphans): spans whose parent_id is empty are roots;
    spans naming a parent that is absent from the set are ORPHANS -- a
    propagation break (a hop that dropped the context), which the CLI
    turns into a non-zero exit for CI. Spans unreachable from any root
    (a corrupt/crafted line with a parent cycle, e.g. span_id ==
    parent_id) are orphans too: they must fail CI loudly, not vanish
    from the printed tree."""
    by_id = {s.get("span_id"): s for s in spans}
    children: dict[str, list[dict]] = {}
    roots: list[dict] = []
    orphans: list[dict] = []
    for s in spans:
        pid = s.get("parent_id") or ""
        if not pid:
            roots.append(s)
        elif pid in by_id and pid != s.get("span_id"):
            children.setdefault(pid, []).append(s)
        else:
            orphans.append(s)
    # Parent pointers make cycles unreachable from every root; sweep
    # reachability so cycle members surface as orphans.
    reachable: set[str] = set()
    stack = [s.get("span_id") for s in roots]
    while stack:
        sid = stack.pop()
        if sid in reachable:
            continue
        reachable.add(sid)
        stack.extend(c.get("span_id") for c in children.get(sid, []))
    for pid in list(children):
        if pid not in reachable:
            orphans.extend(children.pop(pid))
    for s in spans:
        s["_children"] = sorted(
            children.get(s.get("span_id"), []),
            key=lambda c: c.get("start_ts", 0.0),
        )
    roots.sort(key=lambda s: s.get("start_ts", 0.0))
    return roots, orphans


def critical_path(root: dict) -> set[str]:
    """Span ids on the critical path: from the root, repeatedly descend
    into the child whose END time is latest -- the chain that actually
    bounded the trace's wall clock."""
    path = set()
    node = root
    while node is not None and node.get("span_id") not in path:
        path.add(node.get("span_id"))
        kids = node.get("_children") or []
        node = max(
            kids,
            key=lambda c: c.get("start_ts", 0.0) + c.get("duration_s", 0.0),
            default=None,
        )
    return path


# Exemplar hookup: histograms attach the active sampled trace id to
# their observations (metrics never imports trace -- this registration
# is the one-way bridge).
from kraken_tpu_torch.utils import metrics as _metrics  # noqa: E402

_metrics.set_exemplar_provider(exemplar_trace_id)


# -- hash-plane stage timers (the SHA-256 plane's own boundaries) -----------

# The plane a stage is billed to: "verify" (BatchedVerifier's flushes),
# "ingest" (the pipelined windows), "other" (any other hasher call). Set
# by the caller, so the PieceHasher interface keeps its signature;
# asyncio.to_thread carries it into the hash thread, a ThreadPoolExecutor
# does not (its task sets it again).
_plane: contextvars.ContextVar[str] = contextvars.ContextVar(
    "kraken_hash_plane", default="other"
)

_STAGE_SECONDS = _metrics.REGISTRY.counter(  # kt-lint: disable=metric-catalog  # the port's own counter (ROADMAP §C); docs/OPERATIONS.md is the reference's catalog, which the port does not edit
    "hash_plane_seconds_total",
    "Seconds in the SHA-256 plane by path (verify|ingest|other) and stage "
    "(queue, pool, slot, stage, check, submit, readback)",
)
_STAGE_EVENTS = _metrics.REGISTRY.counter(  # kt-lint: disable=metric-catalog  # the port's own counter (ROADMAP §C); docs/OPERATIONS.md is the reference's catalog, which the port does not edit
    "hash_plane_events_total",
    "Intervals billed to hash_plane_seconds_total: pieces for queue and "
    "pool, windows for slot, flush groups or windows for the others",
)


class plane:
    """``with trace.plane("verify"):`` -- bill the stages timed inside
    (in this thread and in ``asyncio.to_thread`` children) to ``path``."""

    __slots__ = ("_path", "_token")

    def __init__(self, path: str):
        self._path = path

    def __enter__(self) -> None:
        self._token = _plane.set(self._path)

    def __exit__(self, exc_type, exc, tb) -> bool:
        _plane.reset(self._token)
        return False


def record_interval(name: str, parent: Span, t0: float) -> None:
    """A finished child span of ``parent`` that began at ``t0``
    (``time.perf_counter``) and ends now: an interval whose start was
    read in another context (a piece's wait in the verify queue)."""
    sp = TRACER.start_span(name, parent=parent)
    if sp is not None:
        sp.start_ts -= sp._t0 - t0
        sp._t0 = t0
        TRACER.finish(sp)


def bill(stage_: str, seconds: float, events: int = 1,
         path: str | None = None) -> None:
    """Add an interval its caller timed to the plane's counters."""
    path = path or _plane.get()
    _STAGE_SECONDS.inc(seconds, path=path, stage=stage_)
    _STAGE_EVENTS.inc(events, path=path, stage=stage_)


def _profiler_module():
    """``torch.autograd.profiler`` while a torch profiler records anywhere
    in the process, else None. Reads ``sys.modules``: this module never
    imports torch (forked shard workers import it and must not)."""
    prof = sys.modules.get("torch.autograd.profiler")
    if prof is not None and getattr(prof, "_is_profiler_enabled", False):
        return prof
    return None


class stage:
    """``with trace.stage("submit"):`` -- one leaf boundary of the SHA-256
    plane: two clock reads, billed to ``hash_plane_{seconds,events}_total``
    under the current :class:`plane` (or ``path``). ``count=False`` adds
    the seconds of a boundary's second part without a second event (the
    launch after a bounds check that splits the submit).

    While a torch profiler records, the interval is also a
    ``record_function`` range ``kraken.<path>.<stage>``, a
    ``user_annotation`` on the device trace's clock; with none, nothing
    is entered. On a sampled trace it is also a child span
    ``hash_plane.<path>.<stage>``. ``seconds`` holds the interval after
    the block."""

    __slots__ = ("_stage", "_path", "_count", "_range", "_span", "_t0",
                 "seconds")

    def __init__(self, _stage: str, path: str | None = None,
                 count: bool = True):
        self._stage = _stage
        self._path = path
        self._count = count
        self._range = None
        self._span = None
        self.seconds = 0.0

    def __enter__(self) -> "stage":
        path = self._path = self._path or _plane.get()
        prof = _profiler_module()
        if prof is not None:
            self._range = prof.record_function(f"kraken.{path}.{self._stage}")
            self._range.__enter__()
        cur = _current.get()
        if cur is not None and cur.sampled:
            self._span = span(f"hash_plane.{path}.{self._stage}")
            self._span.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.seconds = time.perf_counter() - self._t0
        bill(self._stage, self.seconds, int(self._count), self._path)
        if self._span is not None:
            self._span.__exit__(exc_type, exc, tb)
        if self._range is not None:
            self._range.__exit__(exc_type, exc, tb)
        return False


def format_tree(root: dict, crit: set[str] | None = None) -> list[str]:
    """Indented span tree with durations; critical-path spans carry a
    ``*`` gutter."""
    crit = crit if crit is not None else critical_path(root)
    t0 = root.get("start_ts", 0.0)
    lines: list[str] = []

    def walk(s: dict, depth: int) -> None:
        mark = "*" if s.get("span_id") in crit else " "
        status = "" if s.get("status") == "ok" else f"  [{s.get('status')}]"
        node = f"  @{s['node']}" if s.get("node") else ""
        offset = (s.get("start_ts", 0.0) - t0) * 1e3
        lines.append(
            f"{mark} {'  ' * depth}{s.get('name', '?')}"
            f"  +{offset:.1f}ms {s.get('duration_s', 0.0) * 1e3:.1f}ms"
            f"{node}{status}"
        )
        for c in s.get("_children") or []:
            walk(c, depth + 1)

    walk(root, 0)
    return lines
