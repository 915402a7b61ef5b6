"""Announce pacing: due-time queue with a global rate cap.

Mirrors uber/kraken ``lib/torrent/scheduler/announcequeue`` (ready/pending
rotation so announce load is O(configured rate), not O(torrents)) --
upstream path, unverified; SURVEY.md SS2.2. Rebuilt as a due-time min-heap
drained by one pump task: a 10k-torrent seeding agent emits at most
``max_rate`` announces/second, oldest-due first (the heap order IS the
ready/pending rotation), instead of one announce task per torrent firing
every interval.

Time-budget contract: every announce this queue's pump fires
runs under the tracker client's total deadline
(``rpc.announce_timeout_seconds`` -> utils/deadline.Deadline), so a hung
tracker socket exhausts ONE budget and re-enters the heap at the next
interval -- the pump itself never blocks on a wedged announce (it spawns
per-announce tasks), and no key can wedge the rotation.

Failure-backoff contract (the tracker HA plane): a FAILED
announce re-enters the heap on a per-torrent decorrelated-jitter delay
capped at the announce interval (scheduler ``_announce_once``), never on
the fixed tick -- so a tracker death does not synchronize every
torrent's retry into one storm, and with a tracker FLEET
(tracker/client.TrackerFleetClient) the jittered retry lands on the
next ring replica within ~one base delay.
"""

from __future__ import annotations

import heapq
from typing import Hashable


class AnnounceQueue:
    """Min-heap of (due, seq, key). Not thread-safe: event-loop only."""

    def __init__(self):
        self._heap: list[tuple[float, int, Hashable]] = []
        self._due: dict[Hashable, float] = {}  # current due time per key
        self._seq = 0

    def schedule(self, key: Hashable, due: float) -> None:
        """(Re-)schedule ``key`` at ``due``; an earlier entry wins (a
        download wanting peers NOW must not wait out a seed interval)."""
        current = self._due.get(key)
        if current is not None and current <= due:
            return
        self._due[key] = due
        self._seq += 1
        heapq.heappush(self._heap, (due, self._seq, key))

    def remove(self, key: Hashable) -> None:
        """Forget ``key`` (stale heap entries are skipped lazily on pop)."""
        self._due.pop(key, None)

    def pop_ready(self, now: float, limit: int) -> list[Hashable]:
        """Up to ``limit`` keys due at ``now``, oldest-due first. Popped
        keys are NOT rescheduled -- the announcer re-schedules after the
        announce returns (with the tracker-provided interval)."""
        out: list[Hashable] = []
        while self._heap and len(out) < limit:
            due, _seq, key = self._heap[0]
            if due > now:
                break
            heapq.heappop(self._heap)
            # Skip stale entries: removed keys, or keys superseded by an
            # earlier re-schedule (the live due time differs).
            if self._due.get(key) != due:
                continue
            del self._due[key]
            out.append(key)
        return out
