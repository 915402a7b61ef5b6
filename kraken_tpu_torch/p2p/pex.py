"""Peer-exchange (PEX) gossip plane: discovery that survives tracker loss.

The tracker is the PRIMARY peer-discovery plane; PEX is the fallback
that keeps a fleet alive when every tracker is dark (bad deploy, shared
backend death, partition). Agents piggyback compact per-torrent peer
deltas on the conns they already hold: a ``PEER_EXCHANGE`` frame
(p2p/wire.py) carries ``added`` entries -- peer id, ip, LISTEN port
(handshake ``lp``; an inbound conn's transport port is ephemeral and
useless to a dialer), origin flag -- and ``dropped`` peer ids, at a
jittered interval under a per-conn send budget.

Defense model (a gossiped addr is UNTRUSTED input from a peer):

- The scheduler merges gossip into the dial set through the SAME
  connstate gate announces use -- a banned peer gossiped back in stays
  banned (``Blacklist.blocked`` wins), conn caps still apply.
- A hostile peer cannot addr-flood the dial queue: per-message entry
  caps are protocol violations beyond the hard bound (the dispatcher's
  ban path), and accepted entries still pass a token-bucket dial budget
  (sheds count on ``pex_dials_suppressed_total``).
- A seen-TTL dedup set keeps N peers gossiping the same swarm from
  re-dialing (and re-flooding maps with) the same addrs every tick.
- "dropped" is advisory and PROVENANCE-SCOPED: a sender can only
  retract entries it itself gossiped -- gossip must not evict what the
  tracker or a live handshake taught us.

The disk half: :class:`PeerCache` persists last-known dialable peers
(and each in-flight torrent's metainfo -- agents don't store metainfo
anywhere else) under ``<store>/peercache.json`` with a crash-safe
tmp+rename write, TTL-aged on load, so an agent restarted mid-outage
rejoins its swarms with zero tracker round trips.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time

from kraken_tpu_torch.core.peer import PeerID, PeerIDError, PeerInfo
from kraken_tpu_torch.utils.bandwidth import TokenBucket
from kraken_tpu_torch.utils.metrics import REGISTRY

# Receive-side hard bound on entries in ONE frame. The shipped send
# budget is far below it, so an honest peer can never trip it -- beyond
# it is a protocol violation (addr-flood), fed to the misbehavior ban
# path, same contract as an oversize payload.
MAX_ENTRIES_PER_MESSAGE = 256

_SRC_TRACKER = "tracker"
_SRC_CONN = "conn"
_SRC_CACHE = "cache"


@dataclasses.dataclass
class PexConfig:
    """The YAML ``pex:`` section (agent base.yaml; SIGHUP live-reloads).
    Knob table in docs/OPERATIONS.md "Tracker outage survival"."""

    # Receive + merge gossip into the dial set. Shipped ON: receiving
    # costs one map insert per fresh addr and is what lets a fleet
    # survive total tracker loss without a config push mid-outage.
    enabled: bool = True
    # Emit PEX frames on existing conns. Shipped ON with conservative
    # budgets below -- the send side is what costs bytes.
    send_enabled: bool = True
    # Gossip cadence per conn, +/- jitter fraction (desyncs the fleet;
    # a synchronized gossip tick is a self-inflicted micro-burst).
    interval_seconds: float = 30.0
    jitter: float = 0.25
    # Send budget: at most this many ADDED entries per conn per tick
    # (dropped ids ride free -- they are retractions, not load).
    max_peers_per_message: int = 16
    # Seen-TTL dedup: an addr gossiped for torrent H is not re-ingested
    # for this long (N peers all gossip the same swarm).
    seen_ttl_seconds: float = 120.0
    # Token-bucket budget on gossip-SOURCED dials (per agent): rate per
    # second with a small burst. Tracker-sourced dials are not charged.
    dial_rate: float = 10.0
    dial_burst: float = 20.0
    # Known-peers book cap per torrent (gossip + handshakes; tracker
    # entries always fit -- the tracker handout is already bounded).
    max_known_peers: int = 256
    # Disk-backed last-known-peers cache (<store>/peercache.json).
    peercache: bool = True
    peercache_ttl_seconds: float = 6 * 3600.0
    peercache_flush_seconds: float = 30.0

    @classmethod
    def from_dict(cls, doc: dict | None) -> "PexConfig":
        doc = dict(doc or {})
        allowed = {f.name for f in dataclasses.fields(cls)}
        unknown = set(doc) - allowed
        if unknown:
            raise ValueError(f"unknown pex config keys: {sorted(unknown)}")
        return cls(**doc)


class KnownPeers:
    """Per-torrent book of dialable peers with provenance.

    Provenance guards retraction: a gossip "dropped" from sender S only
    removes entries S itself added -- never tracker/handshake/cache
    knowledge. The book is capped; when full, new GOSSIP entries are
    refused (tracker and handshake entries displace gossip ones) so a
    chatty peer cannot evict authoritative knowledge by filling it.
    """

    __slots__ = ("_peers", "_src", "cap")

    def __init__(self, cap: int = 256):
        self._peers: dict[PeerID, PeerInfo] = {}
        self._src: dict[PeerID, str] = {}
        self.cap = cap

    def __len__(self) -> int:
        return len(self._peers)

    def add(self, peer: PeerInfo, src: str) -> bool:
        pid = peer.peer_id
        if pid in self._peers:
            # Authoritative sources overwrite gossip; gossip refreshes
            # only its own entries (a peer must not "move" another's
            # tracker-recorded addr).
            cur = self._src[pid]
            if cur.startswith("gossip:") or src in (_SRC_TRACKER, _SRC_CONN):
                self._peers[pid] = peer
                self._src[pid] = src
            return True
        if len(self._peers) >= self.cap:
            if src.startswith("gossip:") or src == _SRC_CACHE:
                return False
            evicted = next(
                (p for p, s in self._src.items()
                 if s.startswith("gossip:") or s == _SRC_CACHE),
                None,
            )
            if evicted is None:
                return False
            del self._peers[evicted], self._src[evicted]
        self._peers[pid] = peer
        self._src[pid] = src
        return True

    def drop(self, pid: PeerID, src: str) -> None:
        """Provenance-scoped retraction (gossip ``dropped`` entries)."""
        if self._src.get(pid) == src:
            del self._peers[pid], self._src[pid]

    def discard(self, pid: PeerID) -> None:
        """Unconditional removal (our own dial found the addr dead)."""
        self._peers.pop(pid, None)
        self._src.pop(pid, None)

    def snapshot(self) -> list[PeerInfo]:
        return list(self._peers.values())


def _parse_entry(e) -> PeerInfo:
    """One gossiped ``added`` entry -> PeerInfo. Any shape violation is
    a ValueError: the dispatcher maps it to the peer-error ban path."""
    if not isinstance(e, dict):
        raise ValueError(f"pex entry is not a map: {type(e).__name__}")
    try:
        pid = PeerID(e["id"])
        ip = e["ip"]
        port = e["p"]
    except (KeyError, PeerIDError, TypeError) as exc:
        raise ValueError(f"malformed pex entry: {exc}") from exc
    if not isinstance(ip, str) or not 0 < len(ip) <= 64:
        raise ValueError(f"malformed pex ip: {ip!r}")
    if not isinstance(port, int) or not 0 < port < 65536:
        raise ValueError(f"malformed pex port: {port!r}")
    return PeerInfo(pid, ip, port, origin=bool(e.get("o", False)))


class PexManager:
    """Send budgets, receive validation, and the seen-TTL dedup set.

    One per scheduler. Sync throughout -- every entry point is called
    from recv pumps or the gossip tick on the event loop.
    """

    _EXPUNGE_EVERY = 512  # amortized seen-set sweep (Blacklist's idiom)

    def __init__(self, config: PexConfig | None = None):
        self.config = config or PexConfig()
        # (info_hash hex, peer id hex) -> seen-until monotonic deadline.
        self._seen: dict[tuple[str, str], float] = {}
        self._ops = 0
        self._dial_bucket = TokenBucket(
            self.config.dial_rate, self.config.dial_burst
        )
        # Per-conn sent book: conn key -> {peer id hex} we already
        # gossiped on that conn, for added/dropped delta computation.
        self._sent: dict[object, set[str]] = {}
        # Register the pex_* family eagerly: the metric catalog's
        # runtime half boots an idle-ish pair, and a metric that only
        # exists after the first gossip frame would dodge the lint.
        self._m_sent = REGISTRY.counter(
            "pex_messages_sent_total", "PEER_EXCHANGE frames sent"
        )
        self._m_recv = REGISTRY.counter(
            "pex_messages_received_total", "PEER_EXCHANGE frames received"
        )
        self._m_peers = REGISTRY.counter(
            "pex_peers_received_total",
            "Fresh dialable peers accepted from gossip (post dedup)",
        )
        self._m_suppressed = REGISTRY.counter(
            "pex_dials_suppressed_total",
            "Gossiped peers not dialed (token-bucket budget exhausted)",
        )

    def reconfigure(self, config: PexConfig) -> None:
        """SIGHUP: swap knobs live. The dial bucket is rebuilt (rate
        change); the seen set and sent books survive -- dedup state is
        correctness, not tuning."""
        self.config = config
        self._dial_bucket = TokenBucket(config.dial_rate, config.dial_burst)

    # -- receive path ------------------------------------------------------

    def ingest(
        self, h_hex: str, sender: PeerID, header: dict, now: float
    ) -> tuple[list[PeerInfo], list[PeerID]]:
        """Validate one received PEX header -> (fresh added, dropped).

        Raises ValueError on any protocol violation (shape garbage,
        entry flood) -- the caller's ban path handles it. ``added``
        peers already passed the seen-TTL dedup; the caller still owes
        them the blacklist gate and the dial budget.
        """
        self._m_recv.inc()
        added = header.get("a", [])
        dropped = header.get("d", [])
        if not isinstance(added, list) or not isinstance(dropped, list):
            raise ValueError("malformed pex frame: a/d not lists")
        if len(added) + len(dropped) > MAX_ENTRIES_PER_MESSAGE:
            raise ValueError(
                f"pex flood: {len(added) + len(dropped)} entries"
                f" (cap {MAX_ENTRIES_PER_MESSAGE})"
            )
        fresh: list[PeerInfo] = []
        for e in added:
            peer = _parse_entry(e)
            if self._fresh(h_hex, peer.peer_id.hex, now):
                fresh.append(peer)
        drops: list[PeerID] = []
        for d in dropped:
            if not isinstance(d, str):
                raise ValueError(f"malformed pex drop: {d!r}")
            try:
                drops.append(PeerID(d))
            except PeerIDError as exc:
                raise ValueError(f"malformed pex drop: {exc}") from exc
        if fresh:
            self._m_peers.inc(len(fresh))
        return fresh, drops

    def _fresh(self, h_hex: str, pid_hex: str, now: float) -> bool:
        self._ops += 1
        if self._ops % self._EXPUNGE_EVERY == 0:
            self._seen = {
                k: t for k, t in self._seen.items() if t > now
            }
        key = (h_hex, pid_hex)
        if self._seen.get(key, 0.0) > now:
            return False
        self._seen[key] = now + self.config.seen_ttl_seconds
        return True

    def try_dial_budget(self) -> bool:
        """One gossip-sourced dial admission; sheds are metered."""
        if self._dial_bucket.try_acquire(1.0):
            return True
        self._m_suppressed.inc()
        return False

    # -- send path ---------------------------------------------------------

    def delta_for(
        self, conn_key: object, recipient: PeerID, peers: list[PeerInfo]
    ) -> tuple[list[dict], list[str]]:
        """Compute this conn's next gossip delta against what we already
        sent it, capped at the send budget. ``peers`` is the torrent's
        current dialable book. Returns ([], []) when there is nothing
        new to say (the caller skips the frame entirely)."""
        sent = self._sent.setdefault(conn_key, set())
        current = {
            p.peer_id.hex: p for p in peers if p.peer_id != recipient
        }
        added_ids = [pid for pid in current if pid not in sent]
        added_ids = added_ids[: self.config.max_peers_per_message]
        dropped_ids = [pid for pid in sent if pid not in current]
        added = []
        for pid in added_ids:
            p = current[pid]
            entry = {"id": pid, "ip": p.ip, "p": p.port}
            if p.origin:
                entry["o"] = True
            added.append(entry)
        sent.update(added_ids)
        sent.difference_update(dropped_ids)
        if added:
            self._m_sent.inc()
        return added, dropped_ids

    def forget_conn(self, conn_key: object) -> None:
        self._sent.pop(conn_key, None)


class PeerCache:
    """Crash-safe disk cache of last-known peers + in-flight metainfo.

    All IO is SYNCHRONOUS -- callers hop through ``asyncio.to_thread``
    (the lint's blocking-IO-in-async rule is load-bearing here). The
    write is tmp + fsync + ``os.replace``: a crash mid-write leaves
    either the old file or a torn ``.tmp`` the next load ignores.
    """

    VERSION = 1

    def __init__(self, path: str, ttl_seconds: float = 6 * 3600.0):
        self.path = path
        self.ttl = ttl_seconds
        self._m_writes = REGISTRY.counter(
            "pex_peercache_writes_total",
            "Peercache snapshots persisted (tmp+rename)",
        )

    def load(self, now: float | None = None) -> dict[str, dict]:
        """info_hash hex -> {"namespace", "metainfo" (serialized str),
        "peers" (PeerInfo dict list)}, TTL-aged. Missing file, torn
        tmp debris, garbage JSON, and future versions all load as {} --
        the cache is an optimization, never a boot blocker."""
        now = time.time() if now is None else now
        try:
            with open(self.path, "rb") as f:
                doc = json.loads(f.read())
        except (OSError, ValueError):
            return {}
        if not isinstance(doc, dict) or doc.get("v") != self.VERSION:
            return {}
        torrents = doc.get("torrents")
        if not isinstance(torrents, dict):
            return {}
        out: dict[str, dict] = {}
        for h_hex, rec in torrents.items():
            if not isinstance(rec, dict):
                continue
            try:
                saved_at = float(rec["saved_at"])
                peers = [PeerInfo.from_dict(p) for p in rec["peers"]]
                entry = {
                    "namespace": str(rec["namespace"]),
                    "metainfo": str(rec["metainfo"]),
                    "peers": peers,
                    "saved_at": saved_at,
                }
            except (KeyError, TypeError, ValueError, PeerIDError):
                continue  # one torn record must not void the rest
            if now - saved_at > self.ttl:
                continue
            out[h_hex] = entry
        return out

    def save(
        self, torrents: dict[str, dict], now: float | None = None
    ) -> None:
        """``torrents``: info_hash hex -> {"namespace", "metainfo",
        "peers": [PeerInfo], optional "saved_at"}. Records carrying
        their own ``saved_at`` (merged back from a load) keep it, so a
        flush can carry forward a restarted agent's not-yet-requested
        torrents without resetting their TTL clocks forever. Atomic vs
        crash at every step."""
        now = time.time() if now is None else now
        doc = {
            "v": self.VERSION,
            "torrents": {
                h: {
                    "namespace": rec["namespace"],
                    "metainfo": rec["metainfo"],
                    "saved_at": rec.get("saved_at") or now,
                    "peers": [p.to_dict() for p in rec["peers"]],
                }
                for h, rec in torrents.items()
            },
        }
        tmp = self.path + ".tmp"
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        with open(tmp, "w") as f:
            json.dump(doc, f, separators=(",", ":"))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.path)
        self._m_writes.inc()
