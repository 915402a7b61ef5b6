"""Connection bookkeeping: pending/active limits and the peer blacklist.

Mirrors uber/kraken ``lib/torrent/scheduler/connstate`` (global and
per-torrent ``MaxOpenConnectionsPerTorrent`` limits; blacklist with
expiry/backoff quarantining bad peers) -- upstream path, unverified;
SURVEY.md SS2.2/SS5.
"""

from __future__ import annotations

import dataclasses
import time

from kraken_tpu_torch.core.metainfo import InfoHash
from kraken_tpu_torch.core.peer import PeerID
from kraken_tpu_torch.utils.backoff import Backoff


@dataclasses.dataclass
class ConnStateConfig:
    max_open_conns_per_torrent: int = 10
    max_global_conns: int = 1000
    blacklist_expiry_seconds: float = 30.0
    soft_blacklist_seconds: float = 2.0  # connectivity cool-off (no escalation)
    blacklist_backoff: Backoff = dataclasses.field(
        default_factory=lambda: Backoff(
            base_seconds=30.0, factor=2.0, max_seconds=600.0, jitter=0.1
        )
    )

    @classmethod
    def from_dict(cls, doc: dict) -> "ConnStateConfig":
        """YAML shape: the dataclass fields by name (unknown keys
        rejected); ``blacklist_backoff`` may be a nested dict of Backoff
        fields -- coerced here so a bad value fails at config load, not at
        the first blacklist add."""
        doc = dict(doc)
        fields = {f.name for f in dataclasses.fields(cls)}
        unknown = set(doc) - fields
        if unknown:
            raise ValueError(f"unknown conn_state config keys: {sorted(unknown)}")
        backoff = doc.get("blacklist_backoff")
        if isinstance(backoff, dict):
            doc["blacklist_backoff"] = Backoff(**backoff)
        return cls(**doc)


class Blacklist:
    """Peers that misbehaved (bad pieces, handshake errors, conn churn);
    entries expire with exponential backoff on repeat offenses."""

    # Expunge cadence: every N adds, sweep entries long past expiry.
    # Amortized O(1) per add; keeps the map bounded on a long-lived node
    # churning torrents forever (the soak harness's leak audit caught
    # the append-only original -- every soft-blacklisted dial to a busy
    # seeder stayed resident for the process lifetime).
    _EXPUNGE_EVERY = 256
    # Entries linger this many multiples of max backoff past expiry so a
    # repeat offender re-appearing shortly after its ban still escalates
    # instead of starting fresh.
    _EXPUNGE_GRACE_FACTOR = 2.0

    def __init__(self, config: ConnStateConfig):
        self._config = config
        # (peer, info_hash) -> (until_ts, offense_count)
        self._entries: dict[tuple[PeerID, InfoHash], tuple[float, int]] = {}
        self._adds_since_expunge = 0

    def _maybe_expunge(self, now: float) -> None:
        self._adds_since_expunge += 1
        if self._adds_since_expunge < self._EXPUNGE_EVERY:
            return
        self._adds_since_expunge = 0
        grace = (
            self._config.blacklist_backoff.max_seconds
            * self._EXPUNGE_GRACE_FACTOR
        )
        for key, (until, _count) in list(self._entries.items()):
            if now - until > grace:
                del self._entries[key]

    def add(
        self, peer: PeerID, h: InfoHash, now: float | None = None,
        soft: bool = False,
    ) -> None:
        """``soft`` = connectivity failure (dial refused, peer at capacity):
        short fixed cool-off, no offense escalation. A flash crowd that hits
        a full seeder must retry within seconds, not back off for minutes
        like a peer that served corrupt pieces."""
        now = time.monotonic() if now is None else now
        self._maybe_expunge(now)
        _until, count = self._entries.get((peer, h), (0.0, 0))
        if soft:
            delay = self._config.soft_blacklist_seconds
            self._entries[(peer, h)] = (max(_until, now + delay), count)
        else:
            delay = self._config.blacklist_backoff.delay(count)
            self._entries[(peer, h)] = (now + delay, count + 1)

    def blocked(self, peer: PeerID, h: InfoHash, now: float | None = None) -> bool:
        now = time.monotonic() if now is None else now
        entry = self._entries.get((peer, h))
        return entry is not None and now < entry[0]

    def reconfigure(self, config: ConnStateConfig) -> None:
        """Live swap: existing entries keep their expiry; future offenses
        use the new backoff/expiry values."""
        self._config = config


class ConnState:
    """Tracks pending (dialing/handshaking) and active conns per torrent."""

    def __init__(self, config: ConnStateConfig | None = None):
        self.config = config or ConnStateConfig()
        self.blacklist = Blacklist(self.config)
        self._pending: dict[InfoHash, set[PeerID]] = {}
        self._active: dict[InfoHash, set[PeerID]] = {}

    def reconfigure(self, config: ConnStateConfig) -> None:
        """Live limit swap: caps apply to the next admission decision;
        existing conns are not torn down (churn/eviction shrinks toward
        new caps naturally). Blacklist entries keep their current expiry."""
        self.config = config
        self.blacklist.reconfigure(config)

    def _count_global(self) -> int:
        return sum(len(s) for s in self._pending.values()) + sum(
            len(s) for s in self._active.values()
        )

    def active_peers(self, h: InfoHash) -> set[PeerID]:
        return set(self._active.get(h, ()))

    def num_active(self, h: InfoHash) -> int:
        return len(self._active.get(h, ()))

    def can_dial(self, peer: PeerID, h: InfoHash) -> bool:
        if self.blacklist.blocked(peer, h):
            return False
        if peer in self._pending.get(h, ()) or peer in self._active.get(h, ()):
            return False
        per_torrent = len(self._pending.get(h, ())) + len(self._active.get(h, ()))
        if per_torrent >= self.config.max_open_conns_per_torrent:
            return False
        return self._count_global() < self.config.max_global_conns

    def at_capacity(self, h: InfoHash) -> bool:
        """Inbound-side check: no slot for another conn on this torrent
        (the accept path rejects POLITELY with a busy frame so the dialer
        soft-blacklists instead of escalating)."""
        per_torrent = len(self._pending.get(h, ())) + len(self._active.get(h, ()))
        return (
            per_torrent >= self.config.max_open_conns_per_torrent
            or self._count_global() >= self.config.max_global_conns
        )

    def add_pending(self, peer: PeerID, h: InfoHash) -> bool:
        if not self.can_dial(peer, h):
            return False
        self._pending.setdefault(h, set()).add(peer)
        return True

    def promote(self, peer: PeerID, h: InfoHash) -> bool:
        """Pending -> active on handshake success. Incoming conns (never
        pending) promote directly if capacity allows."""
        self._pending.get(h, set()).discard(peer)
        if peer in self._active.get(h, ()):
            return False
        active = self._active.setdefault(h, set())
        per_torrent = len(active) + len(self._pending.get(h, ()))
        if per_torrent >= self.config.max_open_conns_per_torrent:
            return False
        active.add(peer)
        return True

    def remove(self, peer: PeerID, h: InfoHash) -> None:
        self._pending.get(h, set()).discard(peer)
        self._active.get(h, set()).discard(peer)

    def remove_pending(self, peer: PeerID, h: InfoHash) -> None:
        """Release only a dial reservation. Dial-path cleanup must use this,
        not ``remove``: the same peer may have promoted a concurrent inbound
        conn to active, and that slot belongs to the live conn."""
        self._pending.get(h, set()).discard(peer)

    def clear_torrent(self, h: InfoHash) -> None:
        self._pending.pop(h, None)
        self._active.pop(h, None)
        # Blacklist rows deliberately survive the torrent: the same
        # blob re-pulled after eviction has the SAME info_hash, so a
        # corrupt peer's escalating verdict must greet the re-pull, not
        # reset with every eviction cycle. Boundedness comes from the
        # amortized expired-entry expunge above, which keeps escalation
        # memory for the grace window and no longer.
