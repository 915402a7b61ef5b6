"""Per-torrent dispatcher: drives piece exchange over a set of peer conns.

Mirrors uber/kraken ``lib/torrent/scheduler/dispatch`` (tracks which peer
has which pieces, piece request lifecycle, writes received pieces to
storage, re-announces completed pieces to connected peers, endgame &
failure handling) -- upstream path, unverified; SURVEY.md SS2.2.

One Dispatcher per torrent. Each added conn gets a recv-pump task; all
state mutation happens on the scheduler's event loop (asyncio's
single-thread invariant mirrors the reference's single-goroutine design).
"""

from __future__ import annotations

import asyncio
import contextlib
from typing import Callable, Optional

from kraken_tpu_torch.core.peer import PeerID
from kraken_tpu_torch.p2p.conn import Conn, ConnClosedError
from kraken_tpu_torch.p2p.networkevent import NoopProducer, Producer
from kraken_tpu_torch.p2p.piecerequest import RequestManager
from kraken_tpu_torch.p2p.storage import PieceError, Torrent
from kraken_tpu_torch.p2p.wire import Message, MsgType
from kraken_tpu_torch.utils import trace
from kraken_tpu_torch.utils.metrics import REGISTRY


def _bits_to_set(bits: bytes, num_pieces: int) -> set[int]:
    """Decode a peer bitfield, validating its length (a short bitfield from
    a hostile or version-skewed peer must not crash the adopter)."""
    if len(bits) < (num_pieces + 7) // 8:
        raise PieceError(
            f"bitfield too short: {len(bits)} bytes for {num_pieces} pieces"
        )
    return {i for i in range(num_pieces) if bits[i // 8] >> (i % 8) & 1}


class _Peer:
    __slots__ = (
        "conn", "has", "pump", "complete", "last_useful", "serving",
        "receiving",
    )

    def __init__(self, conn: Conn, has: set[int], now: float):
        self.conn = conn
        self.has = has
        self.pump: Optional[asyncio.Task] = None
        self.complete = False
        # Last time this conn carried anything of value (payload, request,
        # progress announce). Drives churn: a conn slot is a scarce
        # resource and an idle-useless conn on a full seeder wedges flash
        # crowds (everyone else is soft-blacklisted waiting for a slot).
        self.last_useful = now
        self.serving = 0  # concurrent _serve_piece tasks (flood bound)
        self.receiving = 0  # concurrent payload tasks (inbound flood bound)


class Dispatcher:
    """Piece-exchange engine for one torrent.

    ``on_peer_failure(peer_id, reason)`` feeds the scheduler's blacklist;
    ``done`` resolves when the torrent completes (immediately for seeders).
    """

    def __init__(
        self,
        torrent: Torrent,
        requests: RequestManager | None = None,
        on_peer_failure: Callable[[PeerID, str], None] | None = None,
        churn_idle_seconds: float = 4.0,
        events: Producer | None = None,  # swarm tracing
        on_peer_exchange: Callable[[PeerID, dict], None] | None = None,
    ):
        self.torrent = torrent
        self.requests = requests or RequestManager()
        self.churn_idle = churn_idle_seconds
        self.events = events or NoopProducer()
        self._on_peer_failure = on_peer_failure or (lambda p, r: None)
        # PEX sink (scheduler's _on_pex): SYNC -- called from _handle on
        # the recv pump, so it must not await. Raising ValueError on a
        # malformed frame feeds the standard _fail_peer ban path.
        self._on_peer_exchange = on_peer_exchange or (lambda p, h: None)
        self._peers: dict[PeerID, _Peer] = {}
        self._io_tasks: set[asyncio.Task] = set()
        # get_running_loop, not the deprecated get_event_loop: under a
        # non-running loop on 3.12+ the latter raises (and before that
        # could bind the future to a loop the scheduler never runs).
        self.done: asyncio.Future[None] = (
            asyncio.get_running_loop().create_future()
        )
        # Per-torrent lifecycle counters for the completion summary
        # (networkevent torrent_summary -- torrentlog parity): every
        # payload byte in/out, every peer ever adopted, every
        # blacklist-feeding drop.
        self._created = asyncio.get_running_loop().time()
        self._bytes_down = 0
        self._bytes_up = 0
        # Fleet-wide swarm byte counters (cached refs: no registry lookup
        # on the per-piece path). What the delta-transfer plane's "bytes
        # actually moved" accounting reads: swarm ingress here plus the
        # planner's delta_bytes_fetched_total is every fetched byte of a
        # pull. Shard-served egress is counted separately by the worker
        # plane (data_plane_worker_bytes_sent_total).
        self._ctr_down = REGISTRY.counter(
            "p2p_piece_bytes_down_total",
            "Piece payload bytes received over the swarm wire",
        )
        self._ctr_up = REGISTRY.counter(
            "p2p_piece_bytes_up_total",
            "Piece payload bytes served over the swarm wire (main loop)",
        )
        self._peers_seen: set[PeerID] = set()
        self._blacklist_events = 0
        # Per-pull stage-timing split for the torrent_summary rollup:
        # plan (metainfo fetch + delta prefill) and dial (handshake)
        # walls are written in by the scheduler; piece_wait accumulates
        # request->payload gaps here; verify/write walls live on the
        # Torrent (storage.py). Stages overlap under pipelining -- they
        # are cumulative stage costs, not a partition of the wall.
        self.stage_walls: dict[str, float] = {"plan": 0.0, "dial": 0.0}
        self._stage_piece_wait = 0.0
        self._req_ts: dict[int, float] = {}
        # Sampler plane attribution over this torrent's life: the delta
        # of the profiler's CUMULATIVE plane counters between creation
        # and completion rides the summary, so one JSONL line answers
        # "where did THIS pull's CPU go" (utils/profiler.py tags). The
        # cumulative counter, not the ring: the ring rotates windows
        # out, and a baseline against it goes negative on any node up
        # longer than the ring span.
        from kraken_tpu_torch.utils.profiler import PROFILER

        self._plane0 = (
            PROFILER.plane_cumulative() if PROFILER.running else None
        )
        if torrent.complete():
            self.done.set_result(None)

    # -- peer membership ---------------------------------------------------

    @property
    def num_peers(self) -> int:
        return len(self._peers)

    def peers(self) -> list[PeerID]:
        return list(self._peers)

    def add_conn(self, conn: Conn, peer_bitfield: bytes, num_pieces: int) -> bool:
        """Adopt a handshaken conn. Starts its recv pump. Returns False when
        the conn is rejected (duplicate peer or malformed bitfield) -- the
        conn is closed here and the caller must release any conn-state slot
        it reserved for it; a rejected duplicate must never tear down the
        live conn's accounting."""
        if conn.peer_id in self._peers:
            conn.close()
            return False
        try:
            has = _bits_to_set(peer_bitfield, self.torrent.num_pieces)
        except PieceError as e:
            conn.close()
            self._blacklist_events += 1  # the summary counts EVERY ban
            self._on_peer_failure(conn.peer_id, str(e))
            return False
        peer = _Peer(conn, has, asyncio.get_running_loop().time())
        self._peers[conn.peer_id] = peer
        self._peers_seen.add(conn.peer_id)
        if hasattr(conn, "set_payload_handler"):
            # Hot-path: the conn's recv loop hands PIECE_PAYLOAD frames
            # here synchronously, bypassing the recv queue + pump await
            # for the one type that carries the bytes.
            conn.set_payload_handler(
                lambda msg: self._handle_payload_direct(peer, msg)
            )
        peer.pump = asyncio.create_task(self._pump(peer))
        return True

    def _availability(self) -> dict[int, int]:
        avail: dict[int, int] = {}
        for p in self._peers.values():
            for i in p.has:
                avail[i] = avail.get(i, 0) + 1
        return avail

    def _drop_peer(self, peer_id: PeerID, reason: str | None = None) -> None:
        peer = self._peers.pop(peer_id, None)
        if peer is None:
            return
        self.requests.clear_peer(peer_id)
        peer.conn.close()
        if peer.pump is not None:
            peer.pump.cancel()
        if reason:
            self._blacklist_events += 1
            self._on_peer_failure(peer_id, reason)
        if not self._peers:
            # No live conns -> shed the cached fd (reopened on the next
            # conn's first piece IO). Bounds steady-state fd usage on
            # origins seeding many blobs.
            self.torrent.release_fd()

    def close(self) -> None:
        for pid in list(self._peers):
            self._drop_peer(pid)
        for t in list(self._io_tasks):
            t.cancel()
        if not self.done.done():
            self.done.cancel()
        # Releases the torrent's cached fd + flushes its debounced
        # bitfield so crash-resume sees the freshest persisted progress.
        self.torrent.close()

    # -- the pump ----------------------------------------------------------

    async def _pump(self, peer: _Peer) -> None:
        """Recv pump. INVARIANT: never awaits a send -- a pump blocked on a
        full send queue stops draining its recv queue, and under a swarm-
        wide burst those stalls form a cycle (distributed send/recv
        gridlock). All sending happens in _spawn_io tasks."""
        pid = peer.conn.peer_id
        try:
            self._spawn_io(peer, self._request_more(peer))
            while True:
                msg = await peer.conn.recv()
                await self._handle(peer, msg)
        except asyncio.CancelledError:
            raise
        except Exception as e:  # defensive: one peer must not kill the loop
            self._fail_peer(pid, e)

    def _check_index(self, msg: Message) -> int:
        """Piece indices from the wire are untrusted: an out-of-range index
        is a protocol violation (drops + reports the peer), never a storage
        seek."""
        idx = msg.header.get("index")
        if not isinstance(idx, int) or not 0 <= idx < self.torrent.num_pieces:
            raise PieceError(f"piece index out of range: {idx!r}")
        return idx

    def _spawn_io(self, peer: _Peer, coro) -> asyncio.Task:
        """Run a storage-touching handler CONCURRENTLY with the recv pump.

        Serializing verify->write->next-request per piece makes every piece
        pay the full verifier batching delay (a batch of one) and blocks
        payload N+1 behind payload N's disk write; with pipeline_limit
        pieces in flight per conn the concurrency here is what lets the
        batched verifier actually batch. Failures map to the same
        drop-peer handling the pump applies (in a done callback: the task
        must wrap ``coro`` directly, or cancellation before the first step
        leaks a never-awaited coroutine)."""
        t = asyncio.create_task(coro)

        def done(task: asyncio.Task) -> None:
            self._io_tasks.discard(task)
            if task.cancelled():
                return
            exc = task.exception()
            if exc is not None:
                self._fail_peer(peer.conn.peer_id, exc)

        self._io_tasks.add(t)
        t.add_done_callback(done)
        return t

    def _fail_peer(self, pid: PeerID, exc: BaseException) -> None:
        """One exception->drop policy for the pump AND the io tasks."""
        if isinstance(exc, ConnClosedError):
            # A conn that closed itself over misbehavior (oversize
            # payload, protocol garbage flagged by the wire) must reach
            # the blacklist with its recorded reason -- a reasonless drop
            # here would let the offender redial immediately.
            peer = self._peers.get(pid)
            if peer is not None and getattr(peer.conn, "misbehavior", False):
                self._drop_peer(
                    pid,
                    f"conn misbehavior: "
                    f"{getattr(peer.conn, 'close_reason', 'unknown')}",
                )
            else:
                self._drop_peer(pid)
        elif isinstance(exc, PieceError):
            self._drop_peer(pid, f"bad piece: {exc}")
        else:
            self._drop_peer(pid, f"peer error: {exc}")

    _MAX_SERVING_PER_PEER = 32  # concurrent serve tasks; a request flood
    # beyond this is dropped (honest peers pipeline far less) -- without a
    # bound, each pending serve holds a piece-sized buffer and a hostile
    # leecher could drive a seeder to OOM.

    def _admit_serve(self, peer: _Peer, idx: int,
                     tp: str | None = None) -> None:
        """``serving`` must be bumped HERE, synchronously at admission:
        ``conn.recv()`` on already-buffered frames completes without
        yielding to the loop, so a burst of buffered PIECE_REQUESTs would
        otherwise all observe ``serving == 0`` and each spawn a task
        holding a piece-sized buffer -- exactly the flood the bound
        exists to prevent. Decrement in the task's done callback, so
        cancellation-before-first-step can't leak the slot."""
        peer.serving += 1
        t = self._spawn_io(peer, self._serve_piece(peer, idx, tp))

        def release(_task: asyncio.Task) -> None:
            peer.serving -= 1

        t.add_done_callback(release)

    def _handle_payload_direct(self, peer: _Peer, msg: Message) -> None:
        """PIECE_PAYLOAD entry called synchronously from the conn's recv
        loop (the hot-type bypass). MUST NOT await -- it runs inside the
        recv pump. Owns ``msg``'s pooled buffer from here on."""
        if self._peers.get(peer.conn.peer_id) is not peer:
            msg.release()  # raced a drop: nobody else will return it
            return
        peer.last_useful = asyncio.get_running_loop().time()
        self._spawn_payload(peer, msg)

    _MAX_RECEIVING_PER_PEER = 64  # concurrent payload tasks per conn: the
    # inbound mirror of _MAX_SERVING_PER_PEER. Each admitted payload holds
    # a piece-sized pool lease until verify+write complete, and the hot-
    # path bypass never blocks on the recv queue -- so a hostile peer
    # pushing UNSOLICITED payloads faster than the disk drains them would
    # otherwise grow leases without bound (the pool budget caps FREE
    # bytes, not live leases). Honest peers cannot reach this: their
    # in-flight payloads are request-gated at pipeline_limit (16) plus
    # bounded endgame duplicates. Over-cap frames are shed (released,
    # dropped) -- no progress for the flooder, no RSS growth for us.

    def _spawn_payload(self, peer: _Peer, msg: Message) -> None:
        """Spawn the verify->write handler for one payload frame with the
        ONE release point for its pooled buffer: the task done-callback
        fires on completion, failure, AND cancellation-before-first-step,
        so no path (corrupt-piece ban, mid-transfer disconnect, teardown)
        can leak the lease. Admission is accounted SYNCHRONOUSLY (same
        rationale as _admit_serve: buffered frames arrive without
        yielding to the loop)."""
        try:
            idx = self._check_index(msg)
        except PieceError as e:
            msg.release()
            self._fail_peer(peer.conn.peer_id, e)
            return
        if peer.receiving >= self._MAX_RECEIVING_PER_PEER:
            msg.release()
            return
        peer.receiving += 1
        t = self._spawn_io(peer, self._on_payload(peer, idx, msg))

        def release(_task: asyncio.Task) -> None:
            peer.receiving -= 1
            msg.release()

        t.add_done_callback(release)

    async def _serve_piece(self, peer: _Peer, idx: int,
                           tp: str | None = None) -> None:
        # The serve span joins the REQUESTER's trace (the PIECE_REQUEST
        # carried its traceparent only when that trace is sampled), so
        # request -> serve -> payload reads as one tree across nodes.
        parent = trace.parse_traceparent(tp)
        cm = (
            trace.span("p2p.piece.serve", parent, piece=idx,
                       peer=peer.conn.peer_id.hex[:12])
            if parent is not None else contextlib.nullcontext()
        )
        with cm:
            data = await self.torrent.read_piece_async(idx)
            await peer.conn.send(Message.piece_payload(idx, data))
        self._bytes_up += len(data)
        self._ctr_up.inc(len(data))
        # A completed send is progress: an honest-but-slow link keeps
        # earning its churn exemption one delivered piece at a time.
        peer.last_useful = asyncio.get_running_loop().time()

    async def _handle(self, peer: _Peer, msg: Message) -> None:
        if msg.type in (
            MsgType.PIECE_REQUEST, MsgType.PIECE_PAYLOAD,
            MsgType.ANNOUNCE_PIECE, MsgType.COMPLETE,
        ):
            peer.last_useful = asyncio.get_running_loop().time()
        if msg.type == MsgType.PIECE_REQUEST:
            idx = self._check_index(msg)
            if (
                self.torrent.has_piece(idx)
                and peer.serving < self._MAX_SERVING_PER_PEER
            ):
                self._admit_serve(peer, idx, msg.header.get("tp"))
        elif msg.type == MsgType.PIECE_PAYLOAD:
            # Cold path: payloads that queued before the fast-path handler
            # was registered (or in unit tests driving _handle directly).
            self._spawn_payload(peer, msg)
        elif msg.type == MsgType.ANNOUNCE_PIECE:
            peer.has.add(self._check_index(msg))
            self._spawn_io(peer, self._request_more(peer))
        elif msg.type == MsgType.BITFIELD:
            peer.has = _bits_to_set(msg.payload, self.torrent.num_pieces)
            self._spawn_io(peer, self._request_more(peer))
        elif msg.type == MsgType.COMPLETE:
            peer.complete = True
            peer.has = set(range(self.torrent.num_pieces))
            self._spawn_io(peer, self._request_more(peer))
        elif msg.type == MsgType.CANCEL_PIECE:
            pass  # best-effort: payload may already be in flight
        elif msg.type == MsgType.PEER_EXCHANGE:
            # Deliberately NOT refreshing last_useful: gossip must not
            # earn a churn exemption, or an idle peer could keep its conn
            # slot alive forever by chattering addrs.
            self._on_peer_exchange(peer.conn.peer_id, msg.header)
        elif msg.type == MsgType.ERROR:
            raise ConnClosedError(msg.header.get("detail", "peer error"))

    async def _on_payload(self, peer: _Peer, idx: int, msg: Message) -> None:
        data = msg.payload  # bytes or a pooled memoryview -- both flow
        # through verify and os.pwrite untouched; the buffer returns via
        # _spawn_payload's done-callback AFTER the bitfield mark below.
        t_req = self._req_ts.pop(idx, None)
        if t_req is not None:
            self._stage_piece_wait += (
                asyncio.get_running_loop().time() - t_req
            )
        self.events.emit(
            "receive_piece", self.torrent.info_hash.hex,
            peer=peer.conn.peer_id.hex, piece=idx, size=len(data),
        )
        self._bytes_down += len(data)
        self._ctr_down.inc(len(data))
        if self.torrent.has_piece(idx):
            self.requests.clear_piece(idx)
            await self._request_more(peer)
            return
        # Per-piece receive span (verify + pwrite) -- gated on the
        # trace's sampled flag so the data-plane hot path pays nothing
        # on unsampled pulls (the trace-on overhead band pins this).
        cm = (
            trace.span("p2p.piece.receive", piece=idx, size=len(data),
                       peer=peer.conn.peer_id.hex[:12])
            if trace.current_traceparent(sampled_only=True) is not None
            else contextlib.nullcontext()
        )
        with cm:
            completed = await self.torrent.write_piece(idx, data)  # raises PieceError
        self.requests.clear_piece(idx)
        # Fan the new piece out to the swarm.
        for other in list(self._peers.values()):
            if other.conn.peer_id != peer.conn.peer_id:
                try:
                    await other.conn.send(Message.announce_piece(idx))
                except ConnClosedError:
                    pass
        if completed:
            if not self.done.done():
                self.done.set_result(None)
                self.events.emit(
                    "torrent_complete", self.torrent.info_hash.hex,
                    blob=self.torrent.metainfo.digest.hex,
                )
                # The lifecycle rollup, once, at the moment of
                # completion: bytes_up keeps counting afterwards (the
                # peer seeds on), but the download story -- how long,
                # from how many peers, against how much misbehavior --
                # is settled exactly here.
                now = asyncio.get_running_loop().time()
                self.events.emit(
                    "torrent_summary", self.torrent.info_hash.hex,
                    blob=self.torrent.metainfo.digest.hex,
                    pieces=self.torrent.num_pieces,
                    length=self.torrent.metainfo.length,
                    peers=len(self._peers_seen),
                    bytes_down=self._bytes_down,
                    bytes_up=self._bytes_up,
                    duration_s=round(now - self._created, 3),
                    blacklist_events=self._blacklist_events,
                    stages=self._stage_split(),
                    plane_split=self._plane_split(),
                )
            for other in list(self._peers.values()):
                try:
                    await other.conn.send(Message.complete())
                except ConnClosedError:
                    pass
        else:
            await self._request_more(peer)

    def stage_split(self) -> dict:
        """Public read of the per-pull stage walls (the scheduler's
        ``stage_walls`` helper serves it to the canary prober)."""
        return self._stage_split()

    def _stage_split(self) -> dict:
        """The per-pull stage walls (seconds): plan/dial from the
        scheduler, piece-wait from the request->payload gaps here,
        verify/write from the torrent's accumulators."""
        return {
            "plan_s": round(self.stage_walls.get("plan", 0.0), 3),
            "dial_s": round(self.stage_walls.get("dial", 0.0), 3),
            "piece_wait_s": round(self._stage_piece_wait, 3),
            "verify_s": round(getattr(self.torrent, "verify_wall", 0.0), 3),
            "write_s": round(getattr(self.torrent, "write_wall", 0.0), 3),
        }

    def _plane_split(self) -> dict:
        """Sampler plane-tag delta over this torrent's life (sample
        counts per plane; {} when the profiler is off)."""
        if self._plane0 is None:
            return {}
        from kraken_tpu_torch.utils.profiler import PROFILER

        now = PROFILER.plane_cumulative()
        return {
            k: v - self._plane0.get(k, 0)
            for k, v in now.items()
            if v - self._plane0.get(k, 0) > 0
        }

    async def _request_more(self, peer: _Peer) -> None:
        if self.torrent.complete():
            return
        if self._peers.get(peer.conn.peer_id) is not peer:
            # Dropped while this task was queued: selecting now would
            # re-mark requests for a dead peer AFTER clear_peer ran,
            # ghost-blocking those pieces until the hard expiry.
            return
        chosen = self.requests.select(
            peer.conn.peer_id,
            peer.has,
            self.torrent.missing_pieces(),
            self._availability(),
        )
        if not chosen:
            return
        # On a sampled trace each request batch is a span and every
        # PIECE_REQUEST frame carries the traceparent, so the remote's
        # serve spans (dispatcher or shardpool worker) join this trace.
        tp = trace.current_traceparent(sampled_only=True)
        cm = (
            trace.span("p2p.piece.request", pieces=len(chosen),
                       peer=peer.conn.peer_id.hex[:12])
            if tp is not None else contextlib.nullcontext()
        )
        with cm as sp:
            if sp is not None:
                tp = sp.traceparent  # serve spans nest under this batch
            now = asyncio.get_running_loop().time()
            for idx in chosen:
                # First request wins the timestamp: a timeout re-request
                # must not reset the piece's wait clock.
                self._req_ts.setdefault(idx, now)
                self.events.emit(
                    "request_piece", self.torrent.info_hash.hex,
                    peer=peer.conn.peer_id.hex, piece=idx,
                )
                await peer.conn.send(Message.piece_request(idx, tp))

    # -- timers (driven by the scheduler) ----------------------------------

    async def tick(self) -> None:
        """Periodic retry + churn: re-request timed-out pieces, and close
        conns that have carried nothing useful for ``churn_idle`` seconds
        (reference conn churn: frees scarce conn slots -- on a seeder, for
        waiting leechers; on a leecher, for peers that actually have data)."""
        now = asyncio.get_running_loop().time()
        for pid, peer in list(self._peers.items()):
            idle_for = now - peer.last_useful
            if idle_for <= self.churn_idle:
                continue
            # Not idle, just slow: a piece we are mid-sending (serving) or
            # mid-receiving (outstanding request) generates no new inbound
            # messages for its whole transfer time, and dropping the conn
            # then discards live work. But the exemption is BOUNDED: a
            # peer that stops reading its socket (TCP zero window) parks
            # our sends forever with serving > 0, and an unbounded
            # exemption would let it pin a conn slot plus piece buffers
            # indefinitely. Completed serves refresh last_useful, so only
            # a link too slow to deliver one piece per 10 idle periods
            # hits the cap. (The request-pending exemption self-bounds via
            # request expiry, but the cap applies uniformly anyway.)
            active = peer.serving > 0 or bool(self.requests.pending_for(pid, now))
            if active and idle_for <= 10.0 * self.churn_idle:
                continue
            self._drop_peer(pid)  # no blacklist: idle, not misbehaving
        if self.torrent.complete():
            return
        for peer in list(self._peers.values()):
            await self._request_more(peer)
