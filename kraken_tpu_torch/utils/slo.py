"""Black-box SLO plane: SLI recorders over sliding windows.

The port's part of ``kraken_tpu.utils.slo``: the objectives, the burn
window pairs and the config (``SLOConfig``), the bucketed good/bad window
of one SLI (``SLIRecorder``) and :meth:`SLOManager.record`, which the
scheduler calls for every announce. Canary traffic
(``CANARY_NAMESPACE``) records with ``canary=True``: counted into the
windows, and kept apart in the counters so dashboards can exclude it
(``slo_events_total{sli,result,canary}``).

:meth:`SLOManager.apply` swaps the config at a node's start and on
SIGHUP. The evaluator (its thread, burn rates, the multi-window alerts,
their gauges and the ``/debug/slo`` document) waits for the debug slice
(ROADMAP A7e), so ``eval_interval_seconds`` and the alert windows load
and wait for it.
"""

from __future__ import annotations

import dataclasses
import functools
import threading
import time

# The namespace canary traffic pulls under; the scheduler labels
# announce SLIs for it as canary, and operators can TTL-reap or firewall
# it knowing no user blob ever lives there.
CANARY_NAMESPACE = "kraken-canary"


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


class SLOManager:
    """Process-global SLO state: config and per-SLI recorders (one per
    process, like the metric REGISTRY and the TRACER)."""

    def __init__(self, config: SLOConfig | None = None):
        self.config = config or SLOConfig()
        self.node = ""  # component stamp (the node sets it)
        self._lock = threading.Lock()
        self._recorders: dict[str, SLIRecorder] = {}
        # Monotonic clock, injectable so tests drive deterministic
        # window math without sleeping.
        self._clock = time.monotonic
        from kraken_tpu_torch.utils.metrics import REGISTRY

        # Cached ref: the recorders count every request.
        self._c_events = REGISTRY.counter(
            "slo_events_total",
            "SLI events recorded, by sli, result, and canary flag",
        )

    def apply(self, config: SLOConfig | dict | None) -> None:
        """Live config swap (start + SIGHUP): objectives apply from the
        next record. Recorders persist across reloads (history is the
        whole point of a sliding window) unless the bucket geometry
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
        except Exception:  # pragma: no cover - a throw here would fail the request it observes
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


SLO = SLOManager()
