"""Shared lameduck-drain plumbing for component HTTP servers.

The port's copy of ``kraken_tpu.utils.lameduck``, on the port's own
HTTP/1.1 (``utils/http_lite.py``) where the reference is on aiohttp.

One implementation of the drain contract (docs/OPERATIONS.md
"Degradation plane") serves both the agent and the origin: a single
``lameduck`` flag, the idempotent drain entry that also drains the p2p
scheduler, the ``POST/GET /debug/lameduck`` operator endpoints, and the
503+Retry-After refusal every new-work path raises. Drain SEMANTICS --
which requests count as new work, which in-flight counter gates the
quiesce -- stay with each server; only the mechanism lives here, so it
cannot diverge between components.
"""

from __future__ import annotations

import contextlib
import logging

from kraken_tpu_torch.utils import http_lite as web

_log = logging.getLogger("kraken.lameduck")

# Clients seeing a drain 503 should retry elsewhere-or-later; this is
# the hint, not a promise (the pod is likely gone by then).
RETRY_AFTER_SECONDS = "5"

# App key under which a component server registers itself so the shared
# debug handlers (the metrics mux's instrument_app in the reference; the
# port's mux is a later slice) can count their scrapes into the drain
# quiesce via track_debug_scrape().
APP_KEY: web.AppKey = web.AppKey(
    "kraken_lameduck_server", object
)


class LameduckMixin:
    """Mix into a component server that owns a ``scheduler`` attribute
    (p2p Scheduler or None). Hosts override :attr:`inflight_work` with
    their quiesce signal and call :meth:`add_lameduck_routes` from
    ``make_app``."""

    lameduck = False
    lameduck_component = "node"
    # In-flight debug/observability scrapes (/debug/slo, /debug/ index
    # -- the surfaces `kraken-tpu status` and the canary plane read).
    # Hosts ADD this into their :attr:`inflight_work` so a lameduck
    # drain cannot quiesce -- and tear the listener down -- under an
    # in-flight status scrape (the round-12 /recipe proxy lesson,
    # applied to the observability surfaces).
    debug_inflight = 0

    @contextlib.contextmanager
    def track_debug_scrape(self):
        """Wrap a debug-surface handler body: counts into
        :attr:`debug_inflight` for the drain quiesce."""
        self.debug_inflight += 1
        try:
            yield
        finally:
            self.debug_inflight -= 1

    def enter_lameduck(self) -> None:
        """Idempotent drain entry: stop advertising, refuse new work,
        let in-flight work finish (assembly's drain() waits on
        :attr:`inflight_work` + the scheduler's conn count)."""
        if self.lameduck:
            return
        self.lameduck = True
        scheduler = getattr(self, "scheduler", None)
        if scheduler is not None:
            scheduler.enter_lameduck()
        _log.info("%s entering lameduck drain", self.lameduck_component)

    @property
    def inflight_work(self) -> int:
        """Drain quiesce signal: requests that must be allowed to
        finish. Hosts override."""
        return 0

    def drain_unavailable(self) -> web.HTTPServiceUnavailable:
        """The refusal every new-work path (and /health) raises while
        draining."""
        return web.HTTPServiceUnavailable(
            text="draining (lameduck)",
            headers={"Retry-After": RETRY_AFTER_SECONDS},
        )

    def add_lameduck_routes(self, router) -> None:
        router.add_post("/debug/lameduck", self._lameduck)
        router.add_get("/debug/lameduck", self._lameduck_state)

    def bind_app(self, app) -> None:
        """Register this server on its app so the shared debug
        handlers (instrument_app) count scrapes into the drain
        quiesce.  Every component ``make_app`` calls it."""
        app[APP_KEY] = self

    async def _lameduck(self, req: web.Request) -> web.Response:
        """Operator drain entry (runbook: docs/OPERATIONS.md). The node
        keeps running -- the deploy system observes /health flip to 503,
        waits its grace period, then SIGTERMs for the full drain+stop."""
        if not self.lameduck:
            # A drain entry is a degradation event: persist the flight
            # recorder as a postmortem (docs/OPERATIONS.md "Tracing").
            # The clean stop() path also enters lameduck (refusal-
            # before-teardown) but that is a shutdown, not a
            # degradation -- only the operator/SIGTERM entries dump.
            from kraken_tpu_torch.utils.trace import TRACER

            TRACER.trigger_dump(
                "lameduck", f"{self.lameduck_component}: operator entry"
            )
        self.enter_lameduck()
        return web.json_response(self._lameduck_doc())

    async def _lameduck_state(self, req: web.Request) -> web.Response:
        return web.json_response(self._lameduck_doc())

    def _lameduck_doc(self) -> dict:
        scheduler = getattr(self, "scheduler", None)
        return {
            "lameduck": self.lameduck,
            "inflight": self.inflight_work,
            "active_conns": (
                scheduler.num_active_conns if scheduler is not None else 0
            ),
        }
