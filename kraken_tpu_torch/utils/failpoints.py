"""Deterministic failpoint plane: named fault-injection sites.

The port's copy of the registry core of ``kraken_tpu.utils.failpoints``.
A failpoint is a NAMED site compiled into the real code path -- e.g.
``origin.ingest.device_fail`` -- that does nothing until armed, and when
armed injects the site's fault (the site defines WHAT fails; the registry
decides WHEN). Process-global registry, triggers with a seeded RNG so
chaos runs replay deterministically, one bool read on the hot path while
disarmed.

Trigger grammar (env var and tests share it)::

    once                fire exactly one time, then exhaust
    always              fire on every evaluation
    every:N             fire on every Nth evaluation (N, 2N, ...)
    prob:P              fire with probability P per evaluation (seeded RNG)

with ``+``-joined modifiers::

    times:N             stop firing after N total fires
    delay:MS            sleep MS milliseconds when firing
    seed:N              RNG seed for prob (default 0: deterministic)

Examples: ``once``, ``prob:0.2+seed:7``, ``every:3+times:2+delay:50``.

Configuration: env ``KRAKEN_FAILPOINTS="name=spec,name=spec"`` (setting
the var is the explicit operator opt-in) or :meth:`FailpointRegistry.arm`.
Every node's debug mux serves the registry on ``GET /debug/failpoints``
and arms or disarms it by ``POST`` (``utils/metrics.py``), arming only
under the same acknowledgement.

Safety: :func:`allow` is the deliberate chaos acknowledgement. Arming does
NOT imply it -- :meth:`FailpointRegistry.assert_safe` refuses when anything
is armed without it.
"""

from __future__ import annotations

import os
import random
import threading
from typing import Optional

# Every ``fire("...")`` site of the port declares its name here. Operator
# surfaces (the KRAKEN_FAILPOINTS env) validate against it, so a typo'd
# chaos run fails loudly instead of injecting nothing and reporting green.
# ``name@suffix`` variants validate by their base name.
KNOWN_FAILPOINTS = frozenset({
    "backend.file.download",
    "backend.file.upload",
    "castore.commit",
    "castore.write",
    "httputil.request.conn_reset",
    "httputil.request.error",
    "httputil.request.slow",
    "httputil.request.truncate_body",
    "ingest.abort",
    "ingest.window.hash",
    "ingest.window.pack",
    "ingest.window.read",
    "ingest.window.transfer",
    "origin.commit.slow",
    "origin.hint.replay.crash",
    "origin.ingest.device_fail",
    "origin.patch.close",
    "origin.patch.write",
    "origin.quorum.replica.partition",
    "origin.recipe.miss",
    "origin.upload.resume",
    "p2p.conn.disconnect",
    "p2p.conn.recv.corrupt",
    "p2p.conn.send.delay",
    "p2p.delta.base.evict",
    "p2p.pex.drop",
    "p2p.pex.flood",
    "p2p.shard.leech.corrupt",
    "p2p.shard.leech.disconnect",
    "p2p.shard.serve.disconnect",
    "rpc.brownout.slow",
    "rpc.hedge.lose",
    "rpc.link.delay",
    "rpc.link.drop",
    "store.fsck.orphan",
    "store.scrub.bitflip",
    "tracker.announce.empty",
    "tracker.announce.error",
    "tracker.blackout",
})


def is_known(name: str) -> bool:
    """Is ``name`` (or its pre-``@`` base) a declared site?"""
    return name.split("@", 1)[0] in KNOWN_FAILPOINTS


def assert_known(names) -> None:
    """Reject undeclared site names from the operator surfaces. Raises
    ValueError naming every typo."""
    unknown = sorted(n for n in names if not is_known(n))
    if unknown:
        raise ValueError(
            f"unknown failpoint name(s) {unknown}: not declared in "
            "KNOWN_FAILPOINTS (kraken_tpu_torch/utils/failpoints.py) -- a "
            "typo here would inject nothing and still report green"
        )


class FailpointError(Exception):
    """Generic injected fault (sites that have no better-typed error)."""


class FailpointConfigError(Exception):
    """Armed failpoints without the explicit chaos acknowledgement."""


class Hit:
    """One firing decision. ``delay_s`` is the armed spec's delay (0.0
    when none); sites may time.sleep it."""

    __slots__ = ("name", "delay_s")

    def __init__(self, name: str, delay_s: float):
        self.name = name
        self.delay_s = delay_s

    def __bool__(self) -> bool:  # `if hit:` reads naturally at sites
        return True


class _Armed:
    """Armed state for one site: parsed spec + seeded RNG + counters."""

    __slots__ = (
        "spec", "mode", "arg", "times", "delay_s", "seed", "rng",
        "hits", "fired", "source",
    )

    def __init__(self, spec: str, source: str = "api"):
        self.spec = spec
        # Where the arming came from: "api" (tests) or the operator
        # surface "env" -- assert_safe validates the latter at boot.
        self.source = source
        self.mode = "always"
        self.arg = 0.0
        self.times = 0  # 0 = unlimited
        self.delay_s = 0.0
        self.seed = 0
        for i, part in enumerate(spec.split("+")):
            part = part.strip()
            key, _, val = part.partition(":")
            try:
                if i == 0:
                    if key == "once":
                        self.mode, self.times = "once", 1
                    elif key == "always":
                        self.mode = "always"
                    elif key == "every":
                        self.mode, self.arg = "every", float(int(val))
                        if self.arg < 1:
                            raise ValueError(part)
                    elif key == "prob":
                        self.mode, self.arg = "prob", float(val)
                        if not 0.0 <= self.arg <= 1.0:
                            raise ValueError(part)
                    else:
                        raise ValueError(part)
                elif key == "times":
                    self.times = int(val)
                elif key == "delay":
                    self.delay_s = float(val) / 1000.0
                elif key == "seed":
                    self.seed = int(val)
                else:
                    raise ValueError(part)
            except (TypeError, ValueError):
                raise ValueError(
                    f"malformed failpoint spec {spec!r} (at {part!r}); "
                    "grammar: once|always|every:N|prob:P"
                    "[+times:N][+delay:MS][+seed:N]"
                ) from None
        # Seeded by default: a chaos run replays bit-for-bit.
        self.rng = random.Random(self.seed)
        self.hits = 0  # evaluations while armed
        self.fired = 0  # actual injections

    def evaluate(self) -> bool:
        self.hits += 1
        if self.times and self.fired >= self.times:
            return False
        if self.mode in ("once", "always"):
            fire = True
        elif self.mode == "every":
            fire = self.hits % int(self.arg) == 0
        else:  # prob
            fire = self.rng.random() < self.arg
        if fire:
            self.fired += 1
        return fire


class FailpointRegistry:
    """Process-global registry. One instance (:data:`FAILPOINTS`) below;
    a fresh instance is only useful for testing the registry itself."""

    def __init__(self):
        self._lock = threading.Lock()
        self._armed: dict[str, _Armed] = {}
        # Fast-path flag read WITHOUT the lock by fire(): a disarmed site
        # pays one attribute read. Python guarantees no torn bool reads.
        self._any = False
        self.allowed = False

    # -- arming ------------------------------------------------------------

    def arm(self, name: str, spec: str = "once", source: str = "api") -> None:
        if not isinstance(name, str) or not name:
            raise ValueError(f"failpoint name must be a non-empty str: {name!r}")
        # The operator surface must use declared names; tests may arm
        # ad-hoc names (registry unit tests, per-host @variants).
        if source == "env":
            assert_known([name])
        armed = _Armed(spec, source=source)  # parse/reject outside the lock
        with self._lock:
            self._armed[name] = armed
            self._any = True

    def disarm(self, name: str) -> bool:
        with self._lock:
            existed = self._armed.pop(name, None) is not None
            self._any = bool(self._armed)
            return existed

    def disarm_all(self) -> None:
        with self._lock:
            self._armed.clear()
            self._any = False

    # -- evaluation (the injection-site API) -------------------------------

    def fire(self, name: str) -> Optional[Hit]:
        """Should site ``name`` inject now? None while disarmed (the
        overwhelming case: one bool read)."""
        if not self._any:
            return None
        with self._lock:
            armed = self._armed.get(name)
            if armed is None or not armed.evaluate():
                return None
            delay_s = armed.delay_s
        # Metrics off-lock: REGISTRY has its own locking.
        from kraken_tpu_torch.utils.metrics import REGISTRY

        REGISTRY.counter(
            "failpoints_fired_total",
            "Fault injections per failpoint site (chaos runs only)",
        ).inc(name=name)
        return Hit(name, delay_s)

    # -- introspection / safety --------------------------------------------

    def snapshot(self) -> dict:
        """Every armed site with its spec and hit/fire counts."""
        with self._lock:
            return {
                "allowed": self.allowed,
                "failpoints": {
                    name: {
                        "spec": a.spec,
                        "hits": a.hits,
                        "fired": a.fired,
                        "exhausted": bool(a.times) and a.fired >= a.times,
                    }
                    for name, a in sorted(self._armed.items())
                },
            }

    def assert_safe(self, component: str = "") -> None:
        """Refuse to serve with armed failpoints absent the explicit chaos
        acknowledgement (:func:`allow`): a leftover arm() from an earlier
        test in the same process fails loudly instead of injecting
        silently."""
        with self._lock:
            if self._armed and not self.allowed:
                names = sorted(self._armed)
                raise FailpointConfigError(
                    f"{component or 'node'}: failpoints armed without the "
                    f"chaos acknowledgement: {names}. Call "
                    "kraken_tpu_torch.utils.failpoints.allow() (tests), set "
                    "KRAKEN_FAILPOINTS, or disarm them."
                )
            unknown = sorted(
                n for n, a in self._armed.items()
                if a.source == "env" and not is_known(n)
            )
            if unknown:
                raise FailpointConfigError(
                    f"{component or 'node'}: failpoints armed from env with "
                    f"undeclared name(s) {unknown} -- not in "
                    "KNOWN_FAILPOINTS (kraken_tpu_torch/utils/failpoints.py)"
                )


FAILPOINTS = FailpointRegistry()


def fire(name: str) -> Optional[Hit]:
    """Module-level evaluation shorthand for injection sites."""
    return FAILPOINTS.fire(name)


def any_armed() -> bool:
    """Is ANYTHING armed? One lock-free bool read, for sites with
    per-evaluation setup cost."""
    return FAILPOINTS._any


def allow(flag: bool = True) -> None:
    """The deliberate chaos acknowledgement (see :meth:`assert_safe`)."""
    FAILPOINTS.allowed = flag


def load_from_env(environ=None) -> int:
    """Arm failpoints from ``KRAKEN_FAILPOINTS`` (``name=spec,...``).
    Setting the variable IS the operator's acknowledgement, so this also
    calls :func:`allow`. Returns the number armed. Raises ValueError on a
    malformed entry OR an undeclared site name."""
    raw = (environ or os.environ).get("KRAKEN_FAILPOINTS", "")
    count = 0
    for entry in raw.split(","):
        entry = entry.strip()
        if not entry:
            continue
        name, sep, spec = entry.partition("=")
        if not sep or not name.strip():
            raise ValueError(f"malformed KRAKEN_FAILPOINTS entry {entry!r}")
        FAILPOINTS.arm(name.strip(), spec.strip() or "once", source="env")
        count += 1
    if count:
        allow()
    return count
