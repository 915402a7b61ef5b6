"""Breaker-aware replica walks: serial failover + staggered hedged reads.

The port's copy of ``kraken_tpu.placement.replicawalk``.

Extracted from ``origin/client.ClusterClient`` (round 8's overload &
degradation plane) so every multi-replica client shares ONE walk policy:
the origin cluster client and the tracker fleet client
(``tracker/client.TrackerFleetClient``) both route requests through
these functions instead of re-implementing breakers, probe admission,
deadline budgets, and hedging per call site.

The contract, unchanged from the in-class implementation:

- Replicas are walked in the caller's order (placement order with
  browned-out/tripped hosts already shed to the back -- the caller runs
  ``health.order`` before handing the clients over).
- Every attempt is admission-gated (``try_acquire_probe``): a half-open
  host admits exactly one probe; callers that lose the race skip ahead.
  If EVERY replica is skipped by the probe gate, the walk retries
  all-in -- serving badly beats serving nothing.
- Outcomes (with latency) feed the breaker via ``observe``. Two outcomes
  are NOT host evidence: a cancelled attempt (losing hedge, teardown)
  and the caller's own budget running out (DeadlineExceeded).
- With ``hedge_delay`` set and >1 replica, reads race: the next admitted
  replica joins per tick (or immediately on a failure); first success
  wins, losers are cancelled AND reaped.

``clients`` are any objects with an ``.addr`` attribute; ``op`` is an
async callable ``(client, deadline)`` so the budget reaches the HTTP
layer of every attempt.
"""

from __future__ import annotations

import asyncio
import time

from kraken_tpu_torch.utils import failpoints, trace
from kraken_tpu_torch.utils.deadline import Deadline, DeadlineExceeded
from kraken_tpu_torch.utils.metrics import REGISTRY

_RAISE = object()  # sentinel: no default, raise on exhaustion


def _observe(health, addr: str, ok: bool, seconds: float) -> None:
    if health is None:
        return
    if hasattr(health, "observe"):
        health.observe(addr, ok, seconds)
    else:
        (health.succeeded if ok else health.failed)(addr)


def _admit(health, addr: str):
    """Breaker request admission: True (closed), a probe token (this
    call holds a half-open host's single probe grant), or False (skip)."""
    if health is None or not hasattr(health, "try_acquire_probe"):
        return True
    return health.try_acquire_probe(addr)


def _release_probe(health, addr: str, token) -> None:
    """Return an unused probe grant (cancelled attempt). Token-matched:
    a stale release must never free a grant a later caller acquired."""
    if token is not None and health is not None and hasattr(
        health, "release_probe"
    ):
        health.release_probe(addr, token)


async def _attempt(health, c, op, deadline, as_hedge: bool,
                   probe_token=None, op_name: str = "rpc"):
    """One replica attempt: latency-timed, outcome fed to the breaker.
    A cancelled attempt and a spent budget stay silent (see module
    docstring). Each attempt is its own child span (``hedge`` attr marks
    the racers) so a hedged read reads off /debug/trace as the primary
    and the hedge side by side."""
    if as_hedge:
        # Failpoint rpc.hedge.lose: delay the hedge so the primary wins
        # the race -- drives the loser-cancellation chaos path.
        hit = failpoints.fire("rpc.hedge.lose")
        if hit:
            await asyncio.sleep(hit.delay_s)
    with trace.span(f"rpc.{op_name}", addr=c.addr, hedge=as_hedge):
        t0 = time.monotonic()
        try:
            out = await op(c, deadline)
        except asyncio.CancelledError:
            _release_probe(health, c.addr, probe_token)
            raise
        except DeadlineExceeded:
            _release_probe(health, c.addr, probe_token)
            raise
        except Exception:
            _observe(health, c.addr, False, time.monotonic() - t0)
            raise
        _observe(health, c.addr, True, time.monotonic() - t0)
        return out


async def walk_replicas(
    clients, op, *, key: str = "", missing_key: str | None = None,
    health=None, hedge_delay: float | None = None,
    deadline: Deadline | None = None, op_name: str = "rpc",
    default=_RAISE,
):
    """Walk ``clients`` under one budget; first success wins. With all
    replicas failed, raise the last error (or return ``default`` if
    given and no replica errored -- i.e. the set was empty). With
    ``hedge_delay`` set and >1 replica, the walk races instead of
    stepping. ``key`` labels errors; ``missing_key`` (defaults to
    ``key``) is the KeyError payload on an empty outcome."""
    if hedge_delay is not None and len(clients) > 1:
        return await _hedged(
            clients, op, key, missing_key, health, hedge_delay, deadline,
            op_name, default,
        )
    return await _serial(
        clients, op, key, missing_key, health, deadline, op_name, default,
        admit=True,
    )


async def _serial(clients, op, key, missing_key, health, deadline,
                  op_name, default, admit: bool):
    last: Exception | None = None
    attempted = False
    for c in clients:
        if deadline is not None and deadline.expired:
            raise deadline.exceeded(f"{op_name} {key}") from last
        admitted = _admit(health, c.addr) if admit else True
        if not admitted:
            continue  # half-open host: someone else holds the probe
        attempted = True
        try:
            return await _attempt(
                health, c, op, deadline, as_hedge=False,
                probe_token=None if admitted is True else admitted,
                op_name=op_name,
            )
        except DeadlineExceeded:
            raise  # the budget is gone: walking further is theater
        except Exception as e:
            last = e
    if not attempted and admit and clients:
        # Every replica was skipped by the probe gate: serving badly
        # beats serving nothing -- retry the walk without admission.
        return await _serial(
            clients, op, key, missing_key, health, deadline, op_name,
            default, admit=False,
        )
    if last is not None:
        raise last
    if default is not _RAISE:
        return default
    raise KeyError(missing_key if missing_key is not None else key)


async def fan_out_quorum(
    clients, op, *, need: int, deadline: Deadline | None = None,
    health=None, op_name: str = "rpc", hedge_delay: float | None = None,
):
    """Counting write fan-out (the quorum push's shape, distinct from
    :func:`walk_replicas`' first-success-wins): launch ``op`` and
    resolve as soon as ``need`` successes have landed, every attempt
    has finished, or the budget ran out -- whichever comes first. No
    breaker admission gate: a write must try every replica regardless
    (outcomes still feed the breaker via ``_observe``).

    With ``hedge_delay`` unset, every client launches at once. With it
    set, only the first ``need`` clients launch immediately; the rest
    are RESERVES that join when a primary fails (in-flight attempts can
    no longer cover ``need``) or the delay elapses with the quorum
    still open. On the healthy path that means exactly ``need`` ops run
    -- for a byte-moving op like the quorum push, half the work of a
    full fan-out -- while a failed or browned-out primary still gets
    covered well inside the budget.

    Returns ``(ok_addrs, failed, abandoned)``: addrs that confirmed,
    addr -> exception for attempts that errored (a spent per-attempt
    budget lands here as ``DeadlineExceeded``), and addrs whose attempt
    was still in flight when the fan-out resolved (cancelled AND reaped
    -- the caller decides whether a slow replica needs a hint or the
    async replication plane covers it). Reserves never launched because
    the quorum resolved first count as abandoned only on an UNMET
    quorum (they were never reached, the hint plane owns them); on a
    met quorum they are simply not reported."""
    ok: list[str] = []
    failed: dict[str, Exception] = {}
    if need <= 0 or not clients:
        return ok, failed, []
    primaries = list(clients)
    reserves: list = []
    if hedge_delay is not None and len(primaries) > need:
        primaries, reserves = primaries[:need], primaries[need:]
    tasks: dict[asyncio.Task, object] = {}

    def _launch(c) -> None:
        t = asyncio.create_task(
            _attempt(health, c, op, deadline, as_hedge=False,
                     op_name=op_name)
        )
        tasks[t] = c

    for c in primaries:
        _launch(c)
    loop = asyncio.get_running_loop()
    hedge_at = loop.time() + hedge_delay if reserves else None
    try:
        while len(ok) < need and (tasks or reserves):
            if reserves and (
                loop.time() >= hedge_at or len(ok) + len(tasks) < need
            ):
                for c in reserves:
                    _launch(c)
                reserves = []
                hedge_at = None
            timeout = None
            if deadline is not None:
                timeout = deadline.remaining()
                if timeout <= 0:
                    break  # budget spent with pushes still in flight
            if hedge_at is not None:
                tick = max(hedge_at - loop.time(), 0.0)
                timeout = tick if timeout is None else min(timeout, tick)
            done, _pending = await asyncio.wait(
                tasks, timeout=timeout,
                return_when=asyncio.FIRST_COMPLETED,
            )
            if not done:
                if deadline is not None and deadline.remaining() <= 0:
                    break  # deadline tick with nothing finished
                continue  # hedge tick: launch the reserves above
            for t in done:
                c = tasks.pop(t)
                err = t.exception()
                if err is None:
                    ok.append(c.addr)
                else:
                    failed[c.addr] = err
    finally:
        # Quorum met (or budget gone): stragglers are cancelled AND
        # reaped -- a leaked push task would keep streaming bytes for
        # an ack already returned.
        for t in tasks:
            t.cancel()
        if tasks:
            await asyncio.gather(*tasks, return_exceptions=True)
    abandoned = [c.addr for c in tasks.values()]
    if len(ok) < need:
        abandoned.extend(c.addr for c in reserves)
    return ok, failed, abandoned


async def _hedged(clients, op, key, missing_key, health, hedge_delay,
                  deadline, op_name, default):
    """Staggered race: the primary attempt starts now; every
    ``hedge_delay`` without an answer (or immediately on a failure) the
    next admitted replica joins. First success cancels the rest.
    Wall-clock worst case stays bounded by ``deadline``."""
    hedges = REGISTRY.counter(
        "rpc_hedges_total",
        "Hedge attempts launched (idempotent reads, after hedge_delay)",
    )
    wins = REGISTRY.counter(
        "rpc_hedge_wins_total",
        "Hedged reads where the hedge answered before the primary",
    )
    # task -> (client, launched-as-hedge)
    tasks: dict[asyncio.Task, tuple[object, bool]] = {}
    idx = 0
    last: Exception | None = None

    def launch(as_hedge: bool) -> bool:
        nonlocal idx
        while idx < len(clients):
            c = clients[idx]
            idx += 1
            admitted = _admit(health, c.addr)
            if not admitted:
                continue
            token = None if admitted is True else admitted
            t = asyncio.create_task(
                _attempt(health, c, op, deadline, as_hedge,
                         probe_token=token, op_name=op_name)
            )
            if token is not None:
                # A task cancelled before its first step never runs
                # _attempt's own release -- the done-callback covers
                # that gap. Token-matched, so this stale release can
                # never free a grant a later caller acquired.
                t.add_done_callback(
                    lambda t, a=c.addr, tok=token:
                    _release_probe(health, a, tok) if t.cancelled() else None
                )
            tasks[t] = (c, as_hedge)
            if as_hedge:
                hedges.inc(op=op_name)
            return True
        return False

    try:
        launch(False)
        if not tasks:
            # Every replica skipped by the probe gate: degrade to the
            # serial all-in walk.
            return await _serial(
                clients, op, key, missing_key, health, deadline, op_name,
                default, admit=False,
            )
        while True:
            timeout = hedge_delay if idx < len(clients) else None
            if deadline is not None:
                rem = deadline.remaining()
                if rem <= 0:
                    raise deadline.exceeded(f"{op_name} {key}") from last
                timeout = rem if timeout is None else min(timeout, rem)
            done, _pending = await asyncio.wait(
                tasks, timeout=timeout,
                return_when=asyncio.FIRST_COMPLETED,
            )
            if not done:
                # Hedge timer fired (or a deadline tick with nothing
                # finished): bring in the next replica.
                launch(True)
                continue
            for t in done:
                c, was_hedge = tasks.pop(t)
                err = t.exception()
                if err is None:
                    if was_hedge:
                        wins.inc(op=op_name)
                    return t.result()
                if isinstance(err, DeadlineExceeded):
                    raise err
                last = err
            if not tasks and not launch(False):
                break
        if last is not None:
            raise last
        if default is not _RAISE:
            return default
        raise KeyError(missing_key if missing_key is not None else key)
    finally:
        # Losers (and everything on an error path) are cancelled AND
        # reaped: a leaked transfer task would keep pulling bytes --
        # and holding buffers -- for a result nobody wants.
        for t in tasks:
            t.cancel()
        if tasks:
            await asyncio.gather(*tasks, return_exceptions=True)
