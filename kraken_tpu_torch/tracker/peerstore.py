"""Peer membership per info-hash, with TTL expiry.

The port's copy of ``kraken_tpu.tracker.peerstore``.

Mirrors uber/kraken ``tracker/peerstore`` (Redis SETEX-style TTL records;
dead agents vanish from handouts when their announces stop) -- upstream
path, unverified; SURVEY.md SS2.4/SS5. Two implementations behind one
async interface:

- :class:`InMemoryPeerStore` -- per-process TTL dict (default; tracker
  state dies with the process, TTL re-heals the swarm on restart).
- :class:`RedisPeerStore` -- speaks RESP to a real Redis (or compatible)
  server, stdlib-only, so tracker restarts keep the swarm and multiple
  trackers can share one store. One HASH per swarm (``swarm:<info_hash>``,
  field = peer id, value = peer json with an embedded absolute expiry), so
  reads are O(swarm size), never O(keyspace); the whole key gets EXPIREd
  on every announce so idle swarms vanish from Redis wholesale, and
  per-peer expiry is enforced on read from the embedded timestamp (with
  lazy HDEL of the dead fields).
"""

from __future__ import annotations

import asyncio
import json
import logging
import random
import time
from typing import Optional

from kraken_tpu_torch.core.peer import PeerInfo
from kraken_tpu_torch.utils.metrics import REGISTRY, FailureMeter

_log = logging.getLogger("kraken.tracker.peerstore")


class PeerStore:
    """Interface: record a peer's announce, list live peers."""

    async def update(self, info_hash: str, peer: PeerInfo) -> None:
        raise NotImplementedError

    async def get_peers(self, info_hash: str, limit: int = 50) -> list[PeerInfo]:
        raise NotImplementedError

    async def close(self) -> None:
        pass


class InMemoryPeerStore(PeerStore):
    # Amortized sweep cadence: every N updates, expire-scan EVERY swarm.
    # Per-swarm pruning in get_peers only reaps hashes someone still asks
    # about; a tracker serving many one-shot torrents accumulates dead
    # swarms nobody will ever query again.
    _SWEEP_EVERY = 1024

    def __init__(self, ttl_seconds: float = 30.0):
        self.ttl = ttl_seconds
        # info_hash -> peer_id hex -> (expiry, PeerInfo)
        self._swarms: dict[str, dict[str, tuple[float, PeerInfo]]] = {}
        self._updates = 0

    async def update(
        self, info_hash: str, peer: PeerInfo, now: float | None = None
    ) -> None:
        now = time.monotonic() if now is None else now
        swarm = self._swarms.setdefault(info_hash, {})
        swarm[peer.peer_id.hex] = (now + self.ttl, peer)
        self._updates += 1
        if self._updates % self._SWEEP_EVERY == 0:
            self._sweep(now)

    def _sweep(self, now: float) -> None:
        for h, swarm in list(self._swarms.items()):
            for pid, (expiry, _p) in list(swarm.items()):
                if expiry <= now:
                    del swarm[pid]
            if not swarm:
                del self._swarms[h]

    async def get_peers(
        self, info_hash: str, limit: int = 50, now: float | None = None
    ) -> list[PeerInfo]:
        now = time.monotonic() if now is None else now
        swarm = self._swarms.get(info_hash)
        if not swarm:
            return []
        for pid, (expiry, _p) in list(swarm.items()):
            if expiry <= now:
                del swarm[pid]
        if not swarm:
            # Drop the emptied swarm entry: a tracker serving many
            # one-shot torrents would otherwise grow without bound.
            del self._swarms[info_hash]
            return []
        if len(swarm) <= limit:
            return [p for _e, p in swarm.values()]
        # SAMPLE, don't slice: insertion order hands every announcer the
        # same first-N peers, and in a large swarm those N saturate while
        # everyone else starves (measured: the 10k-agent sim could not
        # complete before this). Random sampling is also the reference
        # peerstore's behavior.
        return [
            swarm[k][1] for k in random.sample(list(swarm), limit)
        ]


class RespError(Exception):
    """Server-side RESP error reply."""


class _RespConn:
    """One RESP connection: encode commands, decode replies."""

    def __init__(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        self.reader = reader
        self.writer = writer

    @staticmethod
    def _encode(args) -> bytes:
        out = [f"*{len(args)}\r\n".encode()]
        for a in args:
            if isinstance(a, int):
                a = str(a)
            if isinstance(a, str):
                a = a.encode()
            out.append(b"$%d\r\n%s\r\n" % (len(a), a))
        return b"".join(out)

    async def command(self, *args: str | bytes | int):
        self.writer.write(self._encode(args))
        await self.writer.drain()
        return await self._read_reply()

    async def pipeline(self, *commands):
        """Send several commands in one write, read all replies -- one RTT
        instead of len(commands). EVERY reply is consumed before a server
        error is raised: bailing on the first -ERR would leave the later
        replies in the stream and desync every subsequent command by one."""
        self.writer.write(b"".join(self._encode(c) for c in commands))
        await self.writer.drain()
        replies = []
        first_err: RespError | None = None
        for _ in commands:
            try:
                replies.append(await self._read_reply())
            except RespError as e:
                if first_err is None:
                    first_err = e
                replies.append(e)
        if first_err is not None:
            raise first_err
        return replies

    async def _read_reply(self):
        line = (await self.reader.readline()).rstrip(b"\r\n")
        if not line:
            raise ConnectionError("redis connection closed")
        kind, rest = line[:1], line[1:]
        if kind == b"+":
            return rest.decode()
        if kind == b"-":
            raise RespError(rest.decode())
        if kind == b":":
            return int(rest)
        if kind == b"$":
            n = int(rest)
            if n == -1:
                return None
            data = await self.reader.readexactly(n + 2)
            return data[:-2]
        if kind == b"*":
            n = int(rest)
            if n == -1:
                return None
            # Same consume-everything rule for nested error elements.
            items = []
            first_err: RespError | None = None
            for _ in range(n):
                try:
                    items.append(await self._read_reply())
                except RespError as e:
                    if first_err is None:
                        first_err = e
            if first_err is not None:
                raise first_err
            return items
        # Unknown type byte = protocol garbage, not a server error reply:
        # the stream position is unknowable (ValueError -> conn invalidated
        # by the caller), unlike a clean "-ERR ..." RespError.
        raise ValueError(f"unparseable RESP reply type {kind!r}")

    def close(self) -> None:
        self.writer.close()


class RedisPeerStore(PeerStore):
    """Swarm records in a Redis-protocol server (one conn, serialized by a
    lock -- announce volume is paced by the announce queue upstream)."""

    def __init__(
        self,
        addr: str,
        ttl_seconds: float = 30.0,
        timeout_seconds: float = 5.0,
    ):
        host, _, port = addr.rpartition(":")
        self.host, self.port = host, int(port)
        self.ttl = max(1, int(ttl_seconds))
        # Per-command deadline: a blackholed Redis must fail announces
        # fast (500s the swarm can retry), not wedge every handler behind
        # the connection lock forever.
        self.timeout = timeout_seconds
        self._conn: Optional[_RespConn] = None
        self._lock = asyncio.Lock()
        # A dropped/desynced store conn is a reconnect, not an outage:
        # visible on /metrics so a flapping Redis is diagnosable before
        # it becomes announce 500s.
        self._reconnects = REGISTRY.counter(
            "redis_peerstore_reconnects_total",
            "Redis peerstore connections invalidated (timeout, EOF,"
            " protocol garbage) and rebuilt on the next attempt",
        )
        self._errors = FailureMeter(
            "redis_peerstore_errors_total",
            "Redis peerstore operations that failed after the reconnect"
            " retry (the announce handler 500s and the swarm retries)",
            _log,
        )

    async def _get_conn(self) -> _RespConn:
        if self._conn is None:
            reader, writer = await asyncio.open_connection(self.host, self.port)
            self._conn = _RespConn(reader, writer)
        return self._conn

    async def _run(self, op):
        """Run ``op(conn)`` with a deadline and a single reconnect retry.
        ANY failed attempt -- including the retry -- invalidates the
        connection: a timed-out command leaves the stream mid-frame, and
        reusing it would desync every later reply by one."""
        async with self._lock:
            for attempt in (0, 1):
                try:
                    conn = await self._get_conn()
                    return await asyncio.wait_for(op(conn), self.timeout)
                except RespError:
                    # A clean server error reply ("-ERR ..."): the stream
                    # is still in sync -- the conn stays; the error is
                    # the caller's to handle.
                    raise
                except (ConnectionError, OSError,
                        asyncio.IncompleteReadError, asyncio.TimeoutError,
                        ValueError) as e:
                    # IncompleteReadError is an EOFError, not a
                    # ConnectionError: the server died mid-reply.
                    # ValueError = unparseable reply bytes (protocol
                    # garbage): the stream position is unknowable, so the
                    # conn must not be reused either.
                    if self._conn is not None:
                        self._conn.close()
                    self._conn = None
                    self._reconnects.inc()
                    if attempt:
                        self._errors.record(
                            f"redis {self.host}:{self.port}", e
                        )
                        raise

    async def _cmd(self, *args):
        return await self._run(lambda conn: conn.command(*args))

    @staticmethod
    def _key(info_hash: str) -> str:
        return f"swarm:{info_hash}"

    async def update(self, info_hash: str, peer: PeerInfo) -> None:
        doc = peer.to_dict()
        # Absolute wall-clock expiry: trackers sharing the store are
        # NTP-synced in any deployment where they share a Redis.
        doc["_expiry"] = time.time() + self.ttl
        key = self._key(info_hash)
        # One pipelined round trip; the commands land in Redis's input
        # buffer together, so there is no window where the HSET executed
        # but the EXPIRE (which keeps the swarm key from outliving its
        # announcers) is lost.
        await self._run(lambda conn: conn.pipeline(
            ("HSET", key, peer.peer_id.hex, json.dumps(doc)),
            ("EXPIRE", key, self.ttl),
        ))

    async def get_peers(self, info_hash: str, limit: int = 50) -> list[PeerInfo]:
        reply = await self._cmd("HGETALL", self._key(info_hash))
        if not reply:
            return []
        now = time.time()
        out: list[PeerInfo] = []
        dead: list[bytes] = []
        for field, value in zip(reply[0::2], reply[1::2]):
            try:
                doc = json.loads(value)
                expiry = float(doc.pop("_expiry", 0))
                if expiry <= now:
                    # Lazy reap, with one full TTL of grace: HDEL is not
                    # atomic with the HGETALL snapshot, so a freshly-expired
                    # field might have been re-HSET by a concurrent
                    # announce -- deleting it would drop a live peer until
                    # its next announce. A field dead for a whole extra TTL
                    # has no concurrent announcer in practice.
                    if expiry <= now - self.ttl:
                        dead.append(field)
                    continue
                out.append(PeerInfo.from_dict(doc))
            except (ValueError, KeyError):
                dead.append(field)
        if dead:
            # Best-effort reap: the read already has its answer -- a
            # store hiccup on this housekeeping HDEL must not turn a
            # successful handout into a 500 (the fields stay dead-but-
            # present and the next read retries the reap).
            try:
                await self._cmd("HDEL", self._key(info_hash), *dead)
            except (RespError, ConnectionError, OSError,
                    asyncio.IncompleteReadError, asyncio.TimeoutError,
                    ValueError) as e:
                self._errors.record(
                    f"lazy HDEL {self.host}:{self.port}", e
                )
        if len(out) <= limit:
            return out
        # SAMPLE, not slice: HGETALL field order is stable per key, so a
        # slice hands every announcer the same N peers -- the large-swarm
        # starvation wedge documented in PERF.md (same fix as the
        # in-memory store above).
        return random.sample(out, limit)

    async def close(self) -> None:
        if self._conn is not None:
            self._conn.close()
            self._conn = None
