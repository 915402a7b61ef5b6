"""Piece selection: pending-request manager with timeouts and policies.

Mirrors uber/kraken ``lib/torrent/scheduler/dispatch/piecerequest``
(pending-request manager with timeout & retry; default and rarest-first
policies) -- upstream path, unverified; SURVEY.md SS2.2.
"""

from __future__ import annotations

import random
import time
from typing import Iterable

from kraken_tpu_torch.core.peer import PeerID


class RequestManager:
    """Tracks which pieces are requested from which peers, with expiry.

    ``policy`` is ``"rarest_first"`` (default, as the reference's
    production policy) or ``"random"``. In endgame (every missing piece
    already requested) duplicate requests are allowed so one slow peer
    can't stall completion.
    """

    def __init__(
        self,
        policy: str = "rarest_first",
        timeout_seconds: float = 8.0,
        pipeline_limit: int = 4,
        endgame_duplication: int = 2,
    ):
        if policy not in ("rarest_first", "random"):
            raise ValueError(f"unknown piece policy: {policy!r}")
        self.policy = policy
        self.timeout = timeout_seconds
        self.pipeline_limit = pipeline_limit
        # Max outstanding requests per piece in endgame. Unbounded
        # duplication collapses large swarms: with P-deep pipelines over C
        # conns and few missing pieces, every piece gets requested from
        # every peer and the swarm's goodput divides by the redundancy
        # (measured: 100-agent flash crowd fell from ~85 to ~19 MB/s).
        self.endgame_duplication = endgame_duplication
        # piece -> {peer -> sent_ts}
        self._requests: dict[int, dict[PeerID, float]] = {}
        # EWMA of request->completion age: drives the ADAPTIVE stale
        # threshold for rescue duplicates. A fixed threshold cannot serve
        # both regimes: too low re-requests everything under load (the
        # duplication collapse above), too high parks stragglers for tens
        # of seconds behind one slow peer.
        self._service_ewma: float | None = None

    # -- bookkeeping -------------------------------------------------------

    def _expire(self, now: float) -> None:
        # Adaptive hard expiry: the configured timeout is a FLOOR. Under
        # load (large swarm, saturated seeder) honest service times exceed
        # any fixed timeout, and expiring in-flight work re-requests it --
        # a feedback loop that collapses goodput.
        cutoff = max(
            self.timeout,
            min(8.0 * (self._service_ewma or 0.0), 10.0 * self.timeout),
        )
        for piece, peers in list(self._requests.items()):
            for peer, ts in list(peers.items()):
                if now - ts > cutoff:
                    del peers[peer]
            if not peers:
                del self._requests[piece]

    def mark_sent(self, piece: int, peer: PeerID, now: float | None = None) -> None:
        now = time.monotonic() if now is None else now
        self._requests.setdefault(piece, {})[peer] = now

    def clear_piece(self, piece: int, now: float | None = None) -> None:
        peers = self._requests.pop(piece, None)
        if peers:
            now = time.monotonic() if now is None else now
            # NEWEST mark: the most recent request (often the rescue that
            # actually delivered) approximates true service time; the
            # oldest would fold abandoned-request ages into the EWMA and
            # ratchet the adaptive thresholds toward worst-case.
            age = now - max(peers.values())
            if age >= 0:
                self._service_ewma = (
                    age
                    if self._service_ewma is None
                    else 0.9 * self._service_ewma + 0.1 * age
                )

    def stale_after(self) -> float:
        """Age past which an in-flight request qualifies for a rescue
        duplicate: several observed service times, clamped into
        [0.25 s, timeout / 2]."""
        base = self._service_ewma if self._service_ewma is not None else 0.25
        return min(max(4.0 * base, 0.25), self.timeout * 0.5)

    def clear_peer(self, peer: PeerID) -> None:
        for piece, peers in list(self._requests.items()):
            peers.pop(peer, None)
            if not peers:
                del self._requests[piece]

    def pending_for(self, peer: PeerID, now: float | None = None) -> list[int]:
        now = time.monotonic() if now is None else now
        self._expire(now)
        return [p for p, peers in self._requests.items() if peer in peers]

    # -- selection ---------------------------------------------------------

    def select(
        self,
        peer: PeerID,
        peer_has: set[int],
        missing: Iterable[int],
        availability: dict[int, int],
        now: float | None = None,
    ) -> list[int]:
        """Pieces to request from ``peer`` now, respecting the pipeline
        limit. ``availability[piece]`` = number of connected peers holding
        it (drives rarest-first)."""
        now = time.monotonic() if now is None else now
        self._expire(now)

        budget = self.pipeline_limit - len(self.pending_for(peer, now))
        if budget <= 0:
            return []

        missing = list(missing)
        fresh = [
            p for p in missing if p in peer_has and p not in self._requests
        ]
        if not fresh:
            # Endgame: everything missing is in flight somewhere. With deep
            # pipelines that is the NORMAL mid-download state, so duplicate
            # only to rescue requests that have gone stale (a slow peer),
            # bounded per piece -- otherwise every piece is fetched from
            # every conn and swarm goodput divides by the redundancy.
            stale_after = self.stale_after()
            fresh = [
                p
                for p in missing
                if p in peer_has
                and peer not in self._requests.get(p, {})
                and len(self._requests.get(p, {})) < self.endgame_duplication
                and now - max(self._requests.get(p, {}).values(), default=0.0)
                > stale_after
            ]
        if self.policy == "rarest_first":
            fresh.sort(key=lambda p: (availability.get(p, 0), random.random()))
        else:
            random.shuffle(fresh)
        chosen = fresh[:budget]
        for p in chosen:
            self.mark_sent(p, peer, now)
        return chosen
