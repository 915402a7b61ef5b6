"""Black-box SLO plane: SLI recorders, multi-window burn-rate alerts.

The port's copy of ``kraken_tpu.utils.slo``, the Google SRE workbook's
answer to "is the fleet meeting its objective right now, and if not, which
plane is burning the budget?":

- **SLI recorders** (:class:`SLIRecorder`) over the planes that matter:
  bucketed sliding windows of good/bad events, one dict update under a
  lock per request;
- **multi-burn-rate evaluation** (:meth:`SLOManager.evaluate`, on a daemon
  thread every ``eval_interval_seconds``): each objective is watched by a
  paged fast pair and a ticketed slow pair of windows; an alert fires when
  both windows of a pair burn past the threshold and clears when the short
  window recovers;
- **surfaces**: ``slo_burn_rate{sli,window}``,
  ``slo_error_budget_remaining{sli}`` and ``slo_alert_firing{sli,severity}``
  on ``/metrics``, and the ``GET /debug/slo`` document
  (:meth:`SLOManager.debug_snapshot`) that the ``status`` subcommand reads;
- a page transitioning to firing calls the flight recorder's
  ``trigger_dump``, which captures a profile window too.

Canary traffic (``utils/canary.py``, :data:`CANARY_NAMESPACE`) records with
``canary=True``: counted into the burn-rate math, kept apart in the counters
so user-facing dashboards can exclude it
(``slo_events_total{sli,result,canary="1"}``).

One manager per process (like the TRACER and the PROFILER); nodes apply
their YAML ``slo:`` section at start and on SIGHUP. A node whose
:meth:`~SLOManager.apply` started the evaluator stops it in its own
``stop()`` (:meth:`SLOManager.stop`).
"""

from __future__ import annotations

import dataclasses
import functools
import logging
import threading
import time

_log = logging.getLogger("kraken.slo")

# The namespace canary traffic pulls under; the scheduler labels
# announce SLIs for it as canary, and operators can TTL-reap or firewall
# it knowing no user blob ever lives there.
CANARY_NAMESPACE = "kraken-canary"


def format_window(seconds: float) -> str:
    """Human window label for the ``window`` gauge label: 300 -> "5m",
    3600 -> "1h", 90 -> "90s".  Stable across evaluator and promgen so
    generated alert rules match what the gauges actually export."""
    seconds = int(seconds)
    if seconds % 3600 == 0:
        return f"{seconds // 3600}h"
    if seconds % 60 == 0:
        return f"{seconds // 60}m"
    return f"{seconds}s"


@dataclasses.dataclass(frozen=True)
class SLOObjective:
    """One service-level objective: a success-ratio target over a
    rolling window, with an optional latency threshold that counts a
    slow success as bad (latency is an SLI, not a separate alert)."""

    target: float = 0.999
    # A SUCCESS slower than this many seconds counts against the
    # budget (0 disables the latency criterion).
    latency_threshold_seconds: float = 0.0

    @property
    def error_budget(self) -> float:
        return 1.0 - self.target


# The SLIs the shipped wiring records.  YAML `objectives:` overrides or
# extends; an objective for an sli nothing records just reads 0 burn.
DEFAULT_OBJECTIVES: dict[str, SLOObjective] = {
    # Swarm pulls through the agent endpoint (+ canary pulls).
    "pull": SLOObjective(target=0.999, latency_threshold_seconds=120.0),
    # Tracker announces, client-side (covers the whole fleet walk).
    "announce": SLOObjective(target=0.999, latency_threshold_seconds=5.0),
    # Origin upload commits (the push path's visible latency).
    "upload": SLOObjective(target=0.999, latency_threshold_seconds=300.0),
    # Self-heal executions: how fast quarantined blobs reconverge.
    "heal": SLOObjective(target=0.99, latency_threshold_seconds=600.0),
    # Ring re-replication tasks: replication lag burning here means the
    # durability story is degrading even though every read still works.
    "replication": SLOObjective(target=0.99, latency_threshold_seconds=600.0),
}


@dataclasses.dataclass(frozen=True)
class BurnWindowPair:
    """One multi-window burn-rate rule: fire when the error budget burns
    faster than ``burn_rate`` over BOTH the short and the long window."""

    severity: str  # "page" | "ticket"
    short_seconds: float
    long_seconds: float
    burn_rate: float

    @classmethod
    def from_dict(cls, severity: str, doc: dict | None,
                  default: "BurnWindowPair") -> "BurnWindowPair":
        if not doc:
            return default
        allowed = {"short_seconds", "long_seconds", "burn_rate"}
        unknown = set(doc) - allowed
        if unknown:
            raise ValueError(
                f"unknown slo {severity} window keys: {sorted(unknown)}"
            )
        pair = cls(severity=severity, **{
            **{f.name: getattr(default, f.name)
               for f in dataclasses.fields(cls) if f.name != "severity"},
            **doc,
        })
        if pair.short_seconds <= 0 or pair.long_seconds < pair.short_seconds:
            raise ValueError(
                f"slo {severity} windows must satisfy"
                f" 0 < short <= long, got {pair}"
            )
        if pair.burn_rate <= 0:
            raise ValueError(f"slo {severity} burn_rate must be > 0")
        return pair


# Google SRE workbook's recommended pairs: page on 14.4x over 5m AND 1h
# (2% of a 30d budget in one hour), ticket on 3x over 30m AND 6h.
DEFAULT_FAST = BurnWindowPair("page", 300.0, 3600.0, 14.4)
DEFAULT_SLOW = BurnWindowPair("ticket", 1800.0, 21600.0, 3.0)


@dataclasses.dataclass(frozen=True)
class SLOConfig:
    """The YAML ``slo:`` section (agent + origin + tracker; SIGHUP
    live-reloads).  Knob table in docs/OPERATIONS.md "SLO & canary"."""

    enabled: bool = True
    # Evaluator cadence: gauges + alert transitions recompute this often.
    eval_interval_seconds: float = 10.0
    # Sliding-window granularity.  Accuracy at the short window's edge
    # is one bucket; memory is longest-window / bucket_seconds rows.
    bucket_seconds: float = 5.0
    # sli -> SLOObjective; YAML maps sli -> {target,
    # latency_threshold_seconds} merged OVER the shipped defaults.
    objectives: tuple = tuple(sorted(DEFAULT_OBJECTIVES.items()))
    fast: BurnWindowPair = DEFAULT_FAST
    slow: BurnWindowPair = DEFAULT_SLOW

    @classmethod
    def from_dict(cls, doc: dict | None) -> "SLOConfig":
        doc = dict(doc or {})
        allowed = {
            "enabled", "eval_interval_seconds", "bucket_seconds",
            "objectives", "fast", "slow",
        }
        unknown = set(doc) - allowed
        if unknown:
            raise ValueError(f"unknown slo config keys: {sorted(unknown)}")
        objectives = dict(DEFAULT_OBJECTIVES)
        for sli, obj in (doc.pop("objectives", None) or {}).items():
            if not isinstance(obj, dict):
                raise ValueError(f"slo objective {sli!r} must be a mapping")
            obj_allowed = {"target", "latency_threshold_seconds"}
            obj_unknown = set(obj) - obj_allowed
            if obj_unknown:
                raise ValueError(
                    f"unknown keys in slo objective {sli!r}:"
                    f" {sorted(obj_unknown)}"
                )
            objectives[sli] = SLOObjective(**obj)
        for sli, obj in objectives.items():
            if not 0.0 < obj.target < 1.0:
                raise ValueError(
                    f"slo objective {sli!r} target must be in (0, 1),"
                    f" got {obj.target}"
                )
        fast = BurnWindowPair.from_dict("page", doc.pop("fast", None),
                                        DEFAULT_FAST)
        slow = BurnWindowPair.from_dict("ticket", doc.pop("slow", None),
                                        DEFAULT_SLOW)
        cfg = cls(objectives=tuple(sorted(objectives.items())),
                  fast=fast, slow=slow, **doc)
        if cfg.eval_interval_seconds <= 0 or cfg.bucket_seconds <= 0:
            raise ValueError(
                "slo eval_interval_seconds and bucket_seconds must be > 0"
            )
        return cfg

    @functools.cached_property
    def objective_map(self) -> dict[str, SLOObjective]:
        # cached_property writes straight into __dict__, which frozen
        # dataclasses still have -- record() sits on the pull/announce
        # hot paths and must not rebuild this dict per event.
        return dict(self.objectives)

    @property
    def horizon_seconds(self) -> float:
        return max(self.fast.long_seconds, self.slow.long_seconds)


class SLIRecorder:
    """Bucketed sliding window of good/bad events for one SLI.

    Buckets are keyed by ``int(now / bucket_seconds)`` and hold
    ``[good, bad, canary_good, canary_bad]``; anything older than the
    horizon is pruned on write.  Thread-safe: events arrive on the
    event loop, on hash-pool threads, and from the canary prober."""

    def __init__(self, bucket_seconds: float, horizon_seconds: float,
                 clock=time.monotonic):
        self.bucket_seconds = bucket_seconds
        self.horizon_seconds = horizon_seconds
        self._clock = clock
        self._lock = threading.Lock()
        self._buckets: dict[int, list[float]] = {}

    def record(self, ok: bool, canary: bool = False) -> None:
        now = self._clock()
        key = int(now / self.bucket_seconds)
        idx = (2 if canary else 0) + (0 if ok else 1)
        with self._lock:
            row = self._buckets.get(key)
            if row is None:
                row = [0.0, 0.0, 0.0, 0.0]
                self._buckets[key] = row
                self._prune(now)
            row[idx] += 1.0

    def _prune(self, now: float) -> None:
        # Called with the lock held, on bucket creation only (amortized).
        floor = int((now - self.horizon_seconds) / self.bucket_seconds) - 1
        for k in [k for k in self._buckets if k < floor]:
            del self._buckets[k]

    def counts(self, window_seconds: float) -> dict[str, float]:
        """Totals over the trailing window, canary INCLUDED in good/bad
        (black-box: a failing canary pull is a failing pull) and ALSO
        broken out so dashboards can subtract it."""
        now = self._clock()
        floor = (now - window_seconds) / self.bucket_seconds
        good = bad = cgood = cbad = 0.0
        with self._lock:
            for k, row in self._buckets.items():
                # A bucket counts when any part of it overlaps the
                # window (one-bucket edge accuracy, documented).
                if k + 1 > floor:
                    good += row[0]
                    bad += row[1]
                    cgood += row[2]
                    cbad += row[3]
        return {
            "good": good + cgood,
            "bad": bad + cbad,
            "canary_good": cgood,
            "canary_bad": cbad,
        }

    def error_rate(self, window_seconds: float) -> float:
        c = self.counts(window_seconds)
        total = c["good"] + c["bad"]
        return (c["bad"] / total) if total else 0.0


class _AlertState:
    """Firing latch for one (sli, severity) pair."""

    __slots__ = ("firing", "since_ts", "fired_count")

    def __init__(self):
        self.firing = False
        self.since_ts = 0.0
        self.fired_count = 0


class SLOManager:
    """Process-global SLO state: config, per-SLI recorders, alert
    latches, the evaluator thread, and the ``/debug/slo`` document.

    The evaluator is a daemon THREAD (like the sampling profiler), not
    an asyncio task: trackers, origins, and agents all share the same
    lifecycle without owning a loop, and a wedged event loop -- exactly
    the failure the SLO plane must still report -- cannot stall it."""

    def __init__(self, config: SLOConfig | None = None):
        self.config = config or SLOConfig()
        self.node = ""  # component stamp (assembly sets it)
        self._lock = threading.Lock()
        self._recorders: dict[str, SLIRecorder] = {}
        self._alerts: dict[tuple[str, str], _AlertState] = {}
        self._thread: threading.Thread | None = None
        self._wake = threading.Event()
        # Monotonic clock, injectable so tests drive deterministic
        # window math without sleeping.
        self._clock = time.monotonic
        # Last full evaluation document (the /debug/slo body's core).
        self._last_eval: dict = {}
        # The canary prober (utils/canary.py) publishes its latest probe
        # document here; /debug/slo embeds it.
        self.canary_status: dict | None = None
        from kraken_tpu_torch.utils.metrics import REGISTRY

        # Cached refs: the evaluator sets these every tick and the
        # recorders count every request -- no registry lookups there.
        self._c_events = REGISTRY.counter(
            "slo_events_total",
            "SLI events recorded, by sli, result, and canary flag",
        )
        self._g_burn = REGISTRY.gauge(
            "slo_burn_rate",
            "Error-budget burn rate per SLI and trailing window"
            " (1.0 = exactly on budget)",
        )
        self._g_budget = REGISTRY.gauge(
            "slo_error_budget_remaining",
            "Fraction of the error budget left over the longest window"
            " (negative = budget exhausted)",
        )
        self._g_firing = REGISTRY.gauge(
            "slo_alert_firing",
            "1 while a burn-rate alert is firing, by sli and severity",
        )
        self._c_fired = REGISTRY.counter(
            "slo_alerts_fired_total",
            "Burn-rate alert firing transitions, by sli and severity",
        )

    # -- recording ---------------------------------------------------------

    def record(self, sli: str, ok: bool, latency_s: float | None = None,
               canary: bool = False) -> None:
        """Record one SLI event.  A success slower than the objective's
        latency threshold counts as BAD -- latency is part of the
        objective, not a separate alert.  Cheap and never raises: this
        sits on request paths."""
        try:
            cfg = self.config
            if not cfg.enabled:
                return
            obj = cfg.objective_map.get(sli)
            if (
                ok and obj is not None and latency_s is not None
                and obj.latency_threshold_seconds > 0
                and latency_s > obj.latency_threshold_seconds
            ):
                ok = False
            self._recorder(sli).record(ok, canary=canary)
            self._c_events.inc(
                sli=sli, result="good" if ok else "bad",
                canary="1" if canary else "0",
            )
        except Exception:  # kt-lint: disable=bare-except  # pragma: no cover - per-request SLI record path: a throw here fails the request it observes, and metering the meter can recurse
            pass

    def _recorder(self, sli: str) -> SLIRecorder:
        with self._lock:
            rec = self._recorders.get(sli)
            if rec is None:
                cfg = self.config
                rec = SLIRecorder(
                    cfg.bucket_seconds, cfg.horizon_seconds,
                    clock=self._clock,
                )
                self._recorders[sli] = rec
            return rec

    # -- config / lifecycle ------------------------------------------------

    def apply(self, config: SLOConfig | dict | None) -> None:
        """Live config swap (start + SIGHUP): objectives and windows
        apply from the next evaluation; the evaluator thread follows
        the enabled flag.  Recorders persist across reloads (history is
        the whole point of a sliding window) unless the bucket geometry
        changed."""
        if not isinstance(config, SLOConfig):
            config = SLOConfig.from_dict(config)
        old = self.config
        self.config = config
        with self._lock:
            if (
                old.bucket_seconds != config.bucket_seconds
                or old.horizon_seconds != config.horizon_seconds
            ):
                self._recorders.clear()
        if config.enabled and self._thread is None:
            self._wake.clear()
            self._thread = threading.Thread(
                target=self._run, name="kraken-slo-eval", daemon=True
            )
            self._thread.start()
        elif not config.enabled and self._thread is not None:
            self.stop()

    @property
    def running(self) -> bool:
        """Whether the evaluator thread runs (the port's: a node records
        whether its ``apply`` started it, to stop it in its own stop)."""
        return self._thread is not None

    def stop(self) -> None:
        t = self._thread
        self._thread = None
        self._wake.set()
        if t is not None and t is not threading.current_thread():
            t.join(timeout=2.0)

    def _run(self) -> None:
        while self._thread is threading.current_thread():
            self._wake.wait(self.config.eval_interval_seconds)
            if self._thread is not threading.current_thread():
                return
            try:
                self.evaluate()
            except Exception:  # pragma: no cover - evaluator must survive
                _log.warning("slo evaluation failed", exc_info=True)

    # -- evaluation --------------------------------------------------------

    def evaluate(self) -> dict:
        """One full evaluation: burn rates per (sli, window), budget
        remaining, alert transitions, gauges.  Called by the thread on
        its cadence and synchronously by tests."""
        cfg = self.config
        doc: dict = {}
        pairs = (cfg.fast, cfg.slow)
        with self._lock:
            recorders = dict(self._recorders)
        for sli, obj in cfg.objective_map.items():
            rec = recorders.get(sli)
            windows: dict[str, dict] = {}
            # Distinct window durations across both pairs (fast/slow
            # may share a duration; one gauge per duration).
            durations = sorted({
                p.short_seconds for p in pairs
            } | {p.long_seconds for p in pairs})
            for w in durations:
                counts = rec.counts(w) if rec is not None else {
                    "good": 0.0, "bad": 0.0,
                    "canary_good": 0.0, "canary_bad": 0.0,
                }
                total = counts["good"] + counts["bad"]
                err = (counts["bad"] / total) if total else 0.0
                burn = err / obj.error_budget
                label = format_window(w)
                windows[label] = {
                    "seconds": w, "error_rate": round(err, 6),
                    "burn_rate": round(burn, 3), **counts,
                }
                self._g_burn.set(burn, sli=sli, window=label)
            longest = format_window(durations[-1])
            budget_remaining = 1.0 - (
                windows[longest]["error_rate"] / obj.error_budget
            )
            self._g_budget.set(budget_remaining, sli=sli)
            alerts = {}
            for pair in pairs:
                alerts[pair.severity] = self._transition(
                    sli, pair,
                    windows[format_window(pair.short_seconds)]["burn_rate"],
                    windows[format_window(pair.long_seconds)]["burn_rate"],
                )
            doc[sli] = {
                "target": obj.target,
                "latency_threshold_seconds": obj.latency_threshold_seconds,
                "error_budget": round(obj.error_budget, 6),
                "budget_remaining": round(budget_remaining, 4),
                "windows": windows,
                "alerts": alerts,
            }
        self._last_eval = {"ts": time.time(), "slis": doc}
        return doc

    def _transition(self, sli: str, pair: BurnWindowPair,
                    short_burn: float, long_burn: float) -> dict:
        # The dict resize must not race firing()'s iteration on the
        # event-loop thread (the evaluator runs on its own thread).
        with self._lock:
            state = self._alerts.setdefault(
                (sli, pair.severity), _AlertState()
            )
        if not state.firing:
            # Fire only on the AND-condition: the long window proves
            # the burn is material, the short window proves it is
            # still happening right now.
            if short_burn > pair.burn_rate and long_burn > pair.burn_rate:
                state.firing = True
                state.since_ts = time.time()
                state.fired_count += 1
                self._c_fired.inc(sli=sli, severity=pair.severity)
                detail = (
                    f"{sli}: {pair.severity} burn {short_burn:.1f}x over"
                    f" {format_window(pair.short_seconds)} and"
                    f" {long_burn:.1f}x over"
                    f" {format_window(pair.long_seconds)}"
                    f" (threshold {pair.burn_rate}x, node {self.node})"
                )
                _log.warning("slo alert firing", extra={
                    "sli": sli, "severity": pair.severity,
                    "short_burn": round(short_burn, 2),
                    "long_burn": round(long_burn, 2),
                })
                if pair.severity == "page":
                    # Every page ships its own postmortem: the flight-
                    # recorder dump, whose trigger hook also
                    # captures a profile window.  Ticket-grade
                    # burns stay quiet -- they have hours of runway.
                    from kraken_tpu_torch.utils.trace import TRACER

                    TRACER.trigger_dump("slo_fast_burn", detail)
        else:
            # Hysteresis: clear on the SHORT window alone.  The long
            # window stays hot for its whole span after a real incident
            # -- clearing on the AND of both would page for hours after
            # recovery; clearing on either-below would flap.
            if short_burn <= pair.burn_rate:
                state.firing = False
                _log.info("slo alert resolved", extra={
                    "sli": sli, "severity": pair.severity,
                })
        self._g_firing.set(
            1.0 if state.firing else 0.0, sli=sli, severity=pair.severity
        )
        return {
            "firing": state.firing,
            "since_ts": round(state.since_ts, 3) if state.firing else None,
            "fired_count": state.fired_count,
            "threshold": pair.burn_rate,
            "short_window": format_window(pair.short_seconds),
            "long_window": format_window(pair.long_seconds),
        }

    # -- debug surface -----------------------------------------------------

    def firing(self) -> list[dict]:
        """Currently-firing alerts, the status tool's gate signal."""
        out = []
        with self._lock:  # the evaluator thread resizes this dict
            alerts = sorted(self._alerts.items())
        for (sli, severity), state in alerts:
            if state.firing:
                out.append({
                    "sli": sli, "severity": severity,
                    "since_ts": round(state.since_ts, 3),
                })
        return out

    def debug_snapshot(self) -> dict:
        """The ``GET /debug/slo`` document."""
        cfg = self.config
        canary = self.canary_status
        if canary is not None:
            # Age computed HERE, on the same host clock that stamped
            # ts: a skewed status-machine clock must not flip a fresh
            # failing verdict to "stale" (or vice versa).
            canary = {
                **canary,
                "age_seconds": round(time.time() - canary.get("ts", 0.0), 3),
            }
        return {
            "node": self.node,
            "enabled": cfg.enabled,
            "eval_interval_seconds": cfg.eval_interval_seconds,
            "windows": {
                "page": {
                    "short": format_window(cfg.fast.short_seconds),
                    "long": format_window(cfg.fast.long_seconds),
                    "burn_rate": cfg.fast.burn_rate,
                },
                "ticket": {
                    "short": format_window(cfg.slow.short_seconds),
                    "long": format_window(cfg.slow.long_seconds),
                    "burn_rate": cfg.slow.burn_rate,
                },
            },
            "firing": self.firing(),
            "last_eval": self._last_eval,
            "canary": canary,
        }


SLO = SLOManager()
