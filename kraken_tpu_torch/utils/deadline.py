"""End-to-end RPC deadlines: one budget threaded through every hop.

The port's copy of ``kraken_tpu.utils.deadline``.

The RPC plane's timeouts used to compose multiplicatively: an HTTP
client with 3 retries x a 60 s per-attempt timeout, walked across 3 ring
replicas, is a worst case of ~9 minutes for one read -- and the tracker
announce path had no bound at all. A :class:`Deadline` is the caller's
TOTAL budget, carried down the stack; every hop computes its per-attempt
timeout as ``min(per_attempt_timeout, remaining_budget)`` and every
retry loop stops the moment the budget is spent. Exhaustion is a TYPED
error (:class:`DeadlineExceeded`) counted on
``rpc_deadline_exceeded_total{component}`` -- tail-latency give-ups must
be distinguishable from dependency failures on /metrics.

The overload-plane knobs (:class:`RPCConfig`) live here too: one YAML
``rpc:`` section shape shared by agent, origin, and tracker
(docs/OPERATIONS.md "Degradation plane").
"""

from __future__ import annotations

import dataclasses
import time


class DeadlineExceeded(Exception):
    """The caller's total budget ran out before the operation finished.

    Not a dependency failure: the last underlying error (if any attempt
    ran at all) rides along as ``__cause__`` for the log line."""

    def __init__(self, what: str, component: str = ""):
        self.what = what
        self.component = component
        super().__init__(f"deadline exceeded: {what}")


class Deadline:
    """An absolute budget on the monotonic clock.

    ``Deadline(seconds)`` starts the clock now; pass the instance down
    the call chain so retries and replica walks all draw from ONE pot.
    ``component`` labels the exhaustion metric (who gave up, not who was
    slow).
    """

    __slots__ = ("_at", "component")

    def __init__(self, seconds: float, component: str = "",
                 *, now: float | None = None):
        now = time.monotonic() if now is None else now
        self._at = now + seconds
        self.component = component

    def remaining(self, now: float | None = None) -> float:
        now = time.monotonic() if now is None else now
        return self._at - now

    @property
    def expired(self) -> bool:
        return self.remaining() <= 0.0

    def timeout(self, per_attempt: float | None) -> float:
        """The next attempt's timeout: ``min(per_attempt, remaining)``.
        Never negative -- callers check :attr:`expired` first."""
        rem = max(0.0, self.remaining())
        if per_attempt is None or per_attempt <= 0:
            return rem
        return min(per_attempt, rem)

    def exceeded(self, what: str) -> DeadlineExceeded:
        """Build (and count) the typed exhaustion error. The caller
        raises it -- ``raise deadline.exceeded(...) from last_err`` keeps
        the last attempt's failure in the chain."""
        from kraken_tpu_torch.utils.metrics import REGISTRY
        from kraken_tpu_torch.utils.trace import TRACER

        REGISTRY.counter(
            "rpc_deadline_exceeded_total",
            "RPC give-ups because the caller's total budget ran out",
        ).inc(component=self.component or "unknown")
        # A spent budget is a degradation event: dump the flight
        # recorder (throttled per trigger kind, never raises) so the
        # spans of the slow chain survive as a postmortem artifact.
        TRACER.trigger_dump(
            "deadline_exceeded", f"{self.component or 'unknown'}: {what}"
        )
        return DeadlineExceeded(what, self.component)


@dataclasses.dataclass(frozen=True)
class RPCConfig:
    """The YAML ``rpc:`` section (agent + origin + tracker; live-reloads
    via SIGHUP). Knob table in docs/OPERATIONS.md "Degradation plane"."""

    # Total budget for one tracker announce (retries included): a hung
    # tracker socket costs one missed interval, never a wedged loop.
    announce_timeout_seconds: float = 5.0
    # Default end-to-end budget a ClusterClient applies to a read when
    # the caller brought no deadline of its own.
    request_deadline_seconds: float = 60.0
    # Idempotent reads launch a second attempt at the next healthy
    # replica after this long without a first answer (p95-ish of the
    # healthy latency; 0 disables hedging).
    hedge_delay_seconds: float = 0.3
    # A host whose success-latency EWMA exceeds this sheds to the back
    # of the replica order (brown-out: slow-but-alive; 0 disables).
    brownout_threshold_seconds: float = 1.0
    # SIGTERM / POST /debug/lameduck: how long in-flight pieces and
    # uploads get to finish before the hard stop.
    drain_timeout_seconds: float = 30.0

    @classmethod
    def from_dict(cls, doc: dict | None) -> "RPCConfig":
        doc = dict(doc or {})
        allowed = {f.name for f in dataclasses.fields(cls)}
        unknown = set(doc) - allowed
        if unknown:
            raise ValueError(f"unknown rpc config keys: {sorted(unknown)}")
        return cls(**doc)
