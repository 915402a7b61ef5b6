"""Health-filtered host sets: circuit breakers and active monitors.

The port's copy of ``kraken_tpu.placement.healthcheck``. One addition: a
:class:`PassiveFilter`'s verdicts are read and written under a lock of its
own, so a verdict stays whole when a thread (a verify worker, a snapshot
reader) reaches the filter while the event loop updates it.

Mirrors uber/kraken ``lib/healthcheck`` (``Monitor``: periodic health
endpoint probing with pass/fail thresholds; ``PassiveFilter``:
mark-bad-on-request-error with cooldown) -- upstream path, unverified;
SURVEY.md SS2.3/SS5 -- evolved into a closed/open/half-open circuit
breaker (round 8, the overload & degradation plane):

- **closed**: requests flow; consecutive failures count (a streak older
  than the cooldown decays -- sporadic faults on a low-traffic host must
  not accumulate forever).
- **open**: >= ``fail_threshold`` consecutive failures trip the host out
  of rotation until the cooldown passes. A probe failure re-opens with
  DECORRELATED-JITTER backoff (utils/backoff.DecorrelatedJitter) so a
  flapping host's re-probes across a fleet never synchronize.
- **half-open**: after the cooldown the host admits EXACTLY ONE probe
  request (:meth:`try_acquire_probe`); success closes the breaker,
  failure re-opens it with a longer cooldown. Concurrent callers that
  lose the probe race skip to the next replica instead of piling onto a
  host that just proved unreliable.

Brown-outs (slow-but-ALIVE hosts -- the tail-latency killer a binary
up/down model cannot see) are tracked by a per-host latency EWMA
(:meth:`observe`): a closed host whose EWMA exceeds
``brownout_threshold_seconds`` is not opened (it still works!) but sheds
to the BACK of the replica order (:meth:`order`), where hedged reads
(origin/client.py) only reach it if the fast replicas fail.

Verdicts are visible: gauges ``breaker_state{host}`` (0 closed / 1
half-open / 2 open), ``host_latency_ewma_seconds{host}``, and
``healthcheck_unhealthy_hosts{source}``, plus :func:`debug_snapshot`,
served as ``GET /debug/healthcheck`` on every metrics mux
(``utils/metrics.py``) -- "why is this replica being skipped" must never
require a debugger.

Feeds the hashring: dead origins leave the ring, and their blobs
re-place onto the survivors.
"""

from __future__ import annotations

import asyncio
import itertools
import threading
import time
import weakref
import functools
from typing import Awaitable, Callable, Iterable

from kraken_tpu_torch.utils.backoff import DecorrelatedJitter
from kraken_tpu_torch.utils.metrics import REGISTRY

# Breaker states (also the ``breaker_state{host}`` gauge values).
CLOSED, HALF_OPEN, OPEN = 0, 1, 2
_STATE_NAMES = {CLOSED: "closed", HALF_OPEN: "half_open", OPEN: "open"}

# Every live filter/monitor, for the /debug/healthcheck mux. Weak so the
# short-lived instances tests and ad-hoc clients create never accumulate.
_instances: "weakref.WeakSet" = weakref.WeakSet()
_name_seq = itertools.count()
_instances_lock = threading.Lock()


def debug_snapshot() -> dict:
    """Everything every live health filter knows, keyed by instance name
    (the operator's "why is this replica skipped" surface)."""
    with _instances_lock:
        insts = list(_instances)
    return {inst.name: inst.snapshot() for inst in insts}


def _register(inst) -> None:
    with _instances_lock:
        _instances.add(inst)


def _locked(method):
    """Run a :class:`PassiveFilter` method under the filter's lock."""

    @functools.wraps(method)
    def run(self, *args, **kw):
        with self._lock:
            return method(self, *args, **kw)

    return run


class _ProbeToken(str):
    """The half-open probe token: compares equal to ``"probe"`` (API
    compatibility) but each grant is a DISTINCT object, so a release can
    be matched to ITS grant -- a stale release from a cancelled holder
    must never free a token a later caller has since acquired."""

    __slots__ = ()


class _HostState:
    __slots__ = (
        "state", "fails", "open_until", "backoff_prev", "probe_inflight",
        "ewma", "last_fail",
    )

    def __init__(self):
        self.state = CLOSED
        self.fails = 0
        self.open_until = 0.0
        self.backoff_prev = 0.0  # DecorrelatedJitter carry (0 = untripped)
        self.probe_inflight: _ProbeToken | None = None
        self.ewma = 0.0  # success-latency EWMA, seconds (0 = no sample yet)
        self.last_fail = 0.0


class PassiveFilter:
    """Callers report request outcomes; the breaker decides who gets
    traffic. Backwards-compatible surface (``failed`` / ``succeeded`` /
    ``healthy`` / ``filter`` / ``prune``) plus the breaker/brown-out API
    (``observe`` / ``try_acquire_probe`` / ``order``).

    ``healthy()`` is the MEMBERSHIP view (ring filtering): an open host
    past its cooldown reads healthy again so the ring re-admits it --
    but the first request it then receives is the half-open probe, so
    "un-ban after cooldown" no longer means "full traffic, no
    evidence"."""

    def __init__(
        self,
        fail_threshold: int = 3,
        cooldown_seconds: float = 30.0,
        max_cooldown_seconds: float = 300.0,
        brownout_threshold_seconds: float = 0.0,
        ewma_alpha: float = 0.3,
        name: str = "",
    ):
        self.fail_threshold = fail_threshold
        self.cooldown = cooldown_seconds
        self.brownout_threshold = brownout_threshold_seconds
        self.ewma_alpha = ewma_alpha
        self.name = name or f"passive-{next(_name_seq)}"
        self._lock = threading.RLock()
        self._jitter = DecorrelatedJitter(
            base_seconds=cooldown_seconds,
            max_seconds=max(cooldown_seconds, max_cooldown_seconds),
        )
        # Named `_fails` since the pre-breaker builds: external eyes
        # (tests, debuggers) read its KEYS as "hosts with recorded
        # trouble"; values are full breaker records now.
        self._fails: dict[str, _HostState] = {}
        self._state_gauge = REGISTRY.gauge(
            "breaker_state",
            "Per-host circuit state: 0 closed, 1 half-open, 2 open",
        )
        self._ewma_gauge = REGISTRY.gauge(
            "host_latency_ewma_seconds",
            "Per-host EWMA of successful-request latency",
        )
        self._unhealthy_gauge = REGISTRY.gauge(
            "healthcheck_unhealthy_hosts",
            "Hosts a health filter currently holds out of (or shed to the"
            " back of) rotation, by filter instance",
        )
        _register(self)

    # -- outcome reporting -------------------------------------------------

    @_locked
    def observe(self, host: str, ok: bool, seconds: float | None = None,
                now: float | None = None) -> None:
        """One request outcome with its latency: the single entry point
        request paths should use (``succeeded``/``failed`` remain for
        callers with no latency to report). Only SUCCESS latencies feed
        the brown-out EWMA: a fast connection-refused would drag a truly
        browned-out host's average toward zero, and a timeout-bound
        failure would pin it sky-high long after recovery -- failures
        already speak through the breaker itself."""
        if ok and seconds is not None:
            s = self._get(host)
            s.ewma = (
                seconds if s.ewma == 0.0
                else (1 - self.ewma_alpha) * s.ewma + self.ewma_alpha * seconds
            )
            self._ewma_gauge.set(s.ewma, host=host)
        if ok:
            self.succeeded(host)
        else:
            self.failed(host, now=now)

    @_locked
    def failed(self, host: str, now: float | None = None) -> None:
        now = time.monotonic() if now is None else now
        s = self._get(host)
        if s.state == HALF_OPEN:
            # The probe itself failed: straight back to open, with a
            # longer (decorrelated-jitter) cooldown than last time.
            s.probe_inflight = None
            self._open(s, now, host)
        else:
            if s.fails and now - s.last_fail > self.cooldown:
                s.fails = 0  # stale streak: sporadic faults don't add up
            s.fails += 1
            if s.state == CLOSED and s.fails >= self.fail_threshold:
                self._open(s, now, host)
        s.last_fail = now
        self._publish(host, s)

    @_locked
    def succeeded(self, host: str) -> None:
        s = self._fails.get(host)
        if s is None:
            return
        s.state = CLOSED
        s.fails = 0
        s.probe_inflight = None
        s.backoff_prev = 0.0
        if s.ewma == 0.0:
            # Nothing left worth remembering: drop the record so the map
            # only holds hosts with live trouble or latency history.
            del self._fails[host]
        self._publish(host, s if host in self._fails else None)

    def _open(self, s: _HostState, now: float, host: str = "") -> None:
        s.state = OPEN
        s.backoff_prev = self._jitter.next(s.backoff_prev)
        s.open_until = now + s.backoff_prev
        s.fails = 0
        # A breaker trip is a degradation event: persist the flight
        # recorder NOW (throttled, never raises) -- the spans that led
        # here are the postmortem, and they age out of the ring fast.
        from kraken_tpu_torch.utils.trace import TRACER

        TRACER.trigger_dump(
            "breaker_trip", f"{self.name}: {host or 'unknown host'}"
        )

    # -- admission ---------------------------------------------------------

    @_locked
    def healthy(self, host: str, now: float | None = None) -> bool:
        """Membership view (ring filter): open-and-cooling reads False;
        everything else -- closed, half-open, open past its cooldown --
        reads True (eligible for traffic; request admission is the
        probe gate's job)."""
        now = time.monotonic() if now is None else now
        s = self._fails.get(host)
        if s is None or s.state != OPEN:
            return True
        return now >= s.open_until

    @_locked
    def try_acquire_probe(self, host: str, now: float | None = None):
        """Request admission. Closed hosts always admit (``True``). An
        open host past its cooldown transitions to half-open and admits
        EXACTLY one caller -- that caller gets a truthy probe token
        (``== "probe"``; release via :meth:`release_probe` if the
        request is abandoned); everyone else gets ``False`` and goes
        elsewhere until the probe's outcome reports back."""
        now = time.monotonic() if now is None else now
        s = self._fails.get(host)
        if s is None or s.state == CLOSED:
            return True
        if s.state == OPEN:
            if now < s.open_until:
                return False
            s.state = HALF_OPEN
            s.probe_inflight = _ProbeToken("probe")
            self._publish(host, s)
            return s.probe_inflight
        # HALF_OPEN: one probe at a time.
        if s.probe_inflight is not None:
            return False
        s.probe_inflight = _ProbeToken("probe")
        return s.probe_inflight

    @_locked
    def release_probe(self, host: str, token=None) -> None:
        """A probe holder that never issued its request (cancelled
        hedge, shutdown) must hand the token back or the host starves.
        With ``token`` the release applies only if THAT grant is still
        the live one -- a stale release from a cancelled holder must not
        free a token a later caller has since acquired."""
        s = self._fails.get(host)
        if s is None or s.state != HALF_OPEN:
            return
        if token is None or s.probe_inflight is token:
            s.probe_inflight = None

    @_locked
    def browned_out(self, host: str) -> bool:
        if self.brownout_threshold <= 0:
            return False
        s = self._fails.get(host)
        return s is not None and s.ewma > self.brownout_threshold

    # -- set views ---------------------------------------------------------

    @_locked
    def filter(self, hosts: Iterable[str], now: float | None = None) -> list[str]:
        out = [h for h in hosts if self.healthy(h, now)]
        # All-unhealthy degrades to all-in (serving badly beats serving
        # nothing, as in the reference).
        return out or list(hosts)

    @_locked
    def order(self, hosts: Iterable[str], now: float | None = None) -> list[str]:
        """Replica-walk order for reads: healthy and probe-eligible
        hosts keep their placement order -- the probe must FLOW with
        normal traffic or a recovered host would stay demoted forever,
        and the admission gate already bounds its exposure to exactly
        one request. Browned-out hosts shed to the back of the healthy
        set; hard-open (still cooling) hosts go last but are never
        dropped -- with everyone unhealthy they are still the only place
        the bytes live."""
        now = time.monotonic() if now is None else now

        def tier(h: str) -> int:
            s = self._fails.get(h)
            if s is None:
                return 0
            if s.state == OPEN and now < s.open_until:
                return 2
            return 1 if self.browned_out(h) else 0

        return sorted(hosts, key=tier)  # stable: placement order within tiers

    @_locked
    def unhealthy_hosts(self, now: float | None = None) -> set[str]:
        """Hosts currently out of (or shed to the back of) rotation --
        the set the tracker's peer handout de-prioritizes."""
        now = time.monotonic() if now is None else now
        return {
            h for h, s in self._fails.items()
            if s.state != CLOSED or self.browned_out(h)
        }

    @_locked
    def prune(self, current_hosts: Iterable[str]) -> int:
        """Forget hosts that left the hostlist. Without this the state
        map grows without bound under membership churn (k8s pod cycling
        mints a fresh ip:port per generation) and a departed host's stale
        verdict would apply to a REUSED address the moment it comes back.
        Called from the assembly refresh tick. Returns entries dropped."""
        keep = set(current_hosts)
        stale = [h for h in self._fails if h not in keep]
        for h in stale:
            del self._fails[h]
            self._publish(h, None)
        return len(stale)

    # -- introspection -----------------------------------------------------

    def _get(self, host: str) -> _HostState:
        s = self._fails.get(host)
        if s is None:
            s = self._fails[host] = _HostState()
        return s

    def _publish(self, host: str, s: _HostState | None) -> None:
        self._state_gauge.set(s.state if s is not None else CLOSED, host=host)
        self._unhealthy_gauge.set(len(self.unhealthy_hosts()), source=self.name)

    @_locked
    def snapshot(self, now: float | None = None) -> dict:
        now = time.monotonic() if now is None else now
        return {
            "kind": "breaker",
            "fail_threshold": self.fail_threshold,
            "cooldown_seconds": self.cooldown,
            "brownout_threshold_seconds": self.brownout_threshold,
            "hosts": {
                h: {
                    "state": _STATE_NAMES[s.state],
                    "consecutive_fails": s.fails,
                    "open_for_seconds": round(max(0.0, s.open_until - now), 3),
                    "probe_inflight": s.probe_inflight is not None,
                    "latency_ewma_seconds": round(s.ewma, 4),
                    "browned_out": self.browned_out(h),
                }
                for h, s in sorted(self._fails.items())
            },
        }


class ActiveMonitor:
    """Periodic probe of every host; tracks consecutive pass/fail counts.

    ``probe`` is an async callable (host) -> bool. Drive :meth:`check_all`
    from a service timer task; ``healthy_hosts`` reflects the latest state.
    """

    def __init__(
        self,
        probe: Callable[[str], Awaitable[bool]],
        pass_threshold: int = 1,
        fail_threshold: int = 3,
        name: str = "",
    ):
        self._probe = probe
        self.pass_threshold = pass_threshold
        self.fail_threshold = fail_threshold
        self.name = name or f"active-{next(_name_seq)}"
        # host -> (healthy verdict, consecutive contrary results)
        self._state: dict[str, tuple[bool, int]] = {}
        self._unhealthy_gauge = REGISTRY.gauge(
            "healthcheck_unhealthy_hosts",
            "Hosts a health filter currently holds out of (or shed to the"
            " back of) rotation, by filter instance",
        )
        _register(self)

    async def check_all(self, hosts: Iterable[str]) -> None:
        hosts = list(hosts)

        async def probe(h: str) -> bool:
            try:
                return await self._probe(h)
            except Exception:
                return False

        # Concurrent probes: detection latency is one probe timeout, not
        # cluster_size timeouts (serial probing of a large ring with dead
        # peers would exceed the check interval itself).
        results = await asyncio.gather(*(probe(h) for h in hosts))
        for h, ok in zip(hosts, results):
            healthy, contrary = self._state.get(h, (True, 0))
            if ok == healthy:
                contrary = 0
            else:
                contrary += 1
                threshold = self.pass_threshold if ok else self.fail_threshold
                if contrary >= threshold:
                    healthy, contrary = ok, 0
            self._state[h] = (healthy, contrary)
        self._publish()

    def healthy(self, host: str) -> bool:
        return self._state.get(host, (True, 0))[0]

    def filter(self, hosts: Iterable[str]) -> list[str]:
        out = [h for h in hosts if self.healthy(h)]
        return out or list(hosts)

    def prune(self, current_hosts: Iterable[str]) -> int:
        """Forget verdicts for hosts no longer in the hostlist (same
        unbounded-growth and stale-verdict hazard as
        :meth:`PassiveFilter.prune`; a host re-added later starts fresh
        at the healthy default). Returns entries dropped."""
        keep = set(current_hosts)
        stale = [h for h in self._state if h not in keep]
        for h in stale:
            del self._state[h]
        self._publish()
        return len(stale)

    def _publish(self) -> None:
        self._unhealthy_gauge.set(
            sum(1 for v, _c in self._state.values() if not v),
            source=self.name,
        )

    def snapshot(self, now: float | None = None) -> dict:
        return {
            "kind": "active_monitor",
            "pass_threshold": self.pass_threshold,
            "fail_threshold": self.fail_threshold,
            "hosts": {
                h: {"healthy": v, "consecutive_contrary": c}
                for h, (v, c) in sorted(self._state.items())
            },
        }
