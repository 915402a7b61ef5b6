"""One peer connection: handshake + framed message pump with bandwidth caps.

Mirrors uber/kraken ``lib/torrent/scheduler/conn`` (handshaker exchanging
peer id / info hash / namespace / bitfield; reader+writer goroutines with
per-conn channels; bandwidth accounting) -- upstream path, unverified;
SURVEY.md SS2.2. Reader/writer goroutines become asyncio tasks; channels
become bounded asyncio queues.

Fast path: ``send``/``recv`` take a non-blocking
``put_nowait``/``get_nowait`` and fall back to the race-against-``closed``
slow path only when the queue would actually block. The send loop drains
every queued frame into ONE corked
:func:`~kraken_tpu_torch.p2p.wire.send_messages` batch (one ``drain()``
per batch -- control frames piggyback on payload batches for free), and
the recv loop hands PIECE_PAYLOAD frames straight to the dispatcher's
``payload_handler`` callback, bypassing the recv queue for the hot type.

The forked leech workers' stand-in conn (``LeechConnProxy``) waits for
the multi-core data plane.
"""

from __future__ import annotations

import asyncio
import dataclasses
from typing import Callable, Optional

from kraken_tpu_torch.core.metainfo import InfoHash
from kraken_tpu_torch.core.peer import PeerID
from kraken_tpu_torch.p2p.wire import (
    MAX_PAYLOAD,
    Message,
    MsgType,
    PayloadOversizeError,
    WireError,
    recv_message,
    send_message,
    send_messages,
)
from kraken_tpu_torch.utils import failpoints, trace
from kraken_tpu_torch.utils.bandwidth import BandwidthLimiter
from kraken_tpu_torch.utils.bufpool import BufferPool

_SEND_QUEUE = 256
_RECV_QUEUE = 256


class ConnClosedError(Exception):
    pass


@dataclasses.dataclass
class HandshakeResult:
    peer_id: PeerID
    info_hash: InfoHash
    name: str  # blob digest hex
    namespace: str
    bitfield: bytes
    num_pieces: int
    # The dialer's traceparent (utils/trace.py), "" when it had no
    # active trace: serve spans on the accept side join this trace, and
    # it travels with the shardpool handoff descriptor.
    traceparent: str = ""
    # The remote's p2p LISTEN port (0 = unknown/older peer). An inbound
    # conn's transport port is ephemeral, so without this the accept side
    # has no dialable addr to gossip for the peer -- PEX carries only
    # peers whose listen port is known.
    listen_port: int = 0


class Conn:
    """A live, handshaken connection. Use :meth:`start` to spin the pumps.

    Outbound messages go through :meth:`send` (bounded queue, backpressure);
    inbound arrive on :meth:`recv` -- except PIECE_PAYLOAD frames, which a
    registered ``payload_handler`` receives synchronously from the recv
    loop. Either side closing or a wire error closes the conn; ``closed``
    future resolves for cleanup hooks, with the terminal cause recorded on
    ``close_reason`` (and counted on ``conn_closed_total{reason}``) so a
    dying conn is never silent.
    """

    def __init__(
        self,
        reader: asyncio.StreamReader,
        writer: asyncio.StreamWriter,
        peer_id: PeerID,
        info_hash: InfoHash,
        bandwidth: BandwidthLimiter | None = None,
        pool: BufferPool | None = None,
        send_batch: int = 16,
        max_payload_length: int = MAX_PAYLOAD,
    ):
        self._reader = reader
        self._writer = writer
        self.peer_id = peer_id
        self.info_hash = info_hash
        self._bw = bandwidth
        self._pool = pool
        self._send_batch = max(1, send_batch)
        # The handshaken torrent's piece length: the tightest honest bound
        # on any PIECE_PAYLOAD this conn may carry. A frame beyond it is
        # rejected BEFORE buffering (a bad peer must not balloon RSS) and
        # marks the conn as misbehaving for the blacklist.
        self._max_payload = max_payload_length
        self._send_q: asyncio.Queue[Optional[Message]] = asyncio.Queue(_SEND_QUEUE)
        self._recv_q: asyncio.Queue[Optional[Message]] = asyncio.Queue(_RECV_QUEUE)
        self._tasks: list[asyncio.Task] = []
        # Created lazily on a RUNNING loop: asyncio.get_event_loop() in
        # __init__ is deprecated and breaks under a non-running loop on
        # 3.12+ (and could bind the future to the wrong loop).
        self._closed_fut: Optional[asyncio.Future] = None
        self.close_reason: Optional[str] = None
        self.close_detail: str = ""
        self.misbehavior = False
        # Dispatcher fast path: sync callable fed PIECE_PAYLOAD messages
        # straight from the recv loop (must not await).
        self.payload_handler: Optional[Callable[[Message], None]] = None
        # piece-traffic counters (network events / metrics)
        self.bytes_sent = 0
        self.bytes_received = 0

    @property
    def closed(self) -> asyncio.Future:
        if self._closed_fut is None:
            self._closed_fut = asyncio.get_running_loop().create_future()
        return self._closed_fut

    def start(self) -> None:
        self.closed  # materialize on the pumps' loop
        self._tasks = [
            asyncio.create_task(self._send_loop()),
            asyncio.create_task(self._recv_loop()),
        ]

    def set_payload_handler(self, handler: Callable[[Message], None]) -> None:
        self.payload_handler = handler

    async def send(self, msg: Message) -> None:
        """Enqueue with backpressure; a conn closing mid-wait unblocks the
        caller with :class:`ConnClosedError` instead of stranding it on a
        full queue. Fast path: when the queue has room, a plain
        ``put_nowait`` -- no futures, no wait set."""
        if self._closed_fut is not None and self._closed_fut.done():
            raise ConnClosedError(str(self.peer_id))
        try:
            self._send_q.put_nowait(msg)
            return
        except asyncio.QueueFull:
            pass
        put = asyncio.ensure_future(self._send_q.put(msg))
        try:
            done, _pending = await asyncio.wait(
                {put, self.closed}, return_when=asyncio.FIRST_COMPLETED
            )
        except asyncio.CancelledError:
            # The CALLER was cancelled mid-wait (teardown, hedge loser):
            # asyncio.wait never cancels its awaitables, so the helper
            # future must be reaped here or it outlives the conn as a
            # forever-pending Queue.put task.
            put.cancel()
            raise
        if put not in done:
            put.cancel()
            raise ConnClosedError(str(self.peer_id))
        await put  # surface put errors, if any

    async def recv(self) -> Message:
        try:
            msg = self._recv_q.get_nowait()
        except asyncio.QueueEmpty:
            if self._closed_fut is not None and self._closed_fut.done():
                raise ConnClosedError(str(self.peer_id))
            get = asyncio.ensure_future(self._recv_q.get())
            try:
                done, _pending = await asyncio.wait(
                    {get, self.closed}, return_when=asyncio.FIRST_COMPLETED
                )
            except asyncio.CancelledError:
                # Caller cancelled mid-wait: reap the helper (see send).
                get.cancel()
                raise
            if get not in done:
                get.cancel()
                raise ConnClosedError(str(self.peer_id))
            msg = await get
        if msg is None:
            raise ConnClosedError(str(self.peer_id))
        return msg

    async def _send_loop(self) -> None:
        reason, detail = "send_loop_exit", ""
        try:
            while True:
                msg = await self._send_q.get()
                stop = msg is None
                batch: list[Message] = [] if stop else [msg]
                # Cork: drain whatever else is already queued (bounded by
                # send_batch) into one vectored write + one drain().
                while not stop and len(batch) < self._send_batch:
                    try:
                        m = self._send_q.get_nowait()
                    except asyncio.QueueEmpty:
                        break
                    if m is None:
                        stop = True
                        break
                    batch.append(m)
                if batch:
                    payload_bytes = sum(
                        len(m.payload) for m in batch
                        if m.type == MsgType.PIECE_PAYLOAD
                    )
                    if self._bw and payload_bytes:
                        await self._bw.send(payload_bytes)
                    # Failpoint p2p.conn.send.delay: stall this batch (a
                    # congested/slow link) -- drives churn-exemption and
                    # adaptive piece-timeout paths. Evaluated once per
                    # frame so every:N / times:N specs keep frame
                    # semantics.
                    for _m in batch:
                        hit = failpoints.fire("p2p.conn.send.delay")
                        if hit:
                            await asyncio.sleep(hit.delay_s)
                    await send_messages(self._writer, batch)
                    self.bytes_sent += sum(len(m.payload) for m in batch)
                if stop:
                    return
        except ConnectionError as e:
            reason, detail = "connection_error", str(e)
        except WireError as e:
            reason, detail = "wire_error", str(e)
        except asyncio.CancelledError:
            reason = "cancelled"
        finally:
            self.close(reason=reason, detail=detail)

    async def _recv_loop(self) -> None:
        reason, detail = "recv_loop_exit", ""
        misbehavior = False
        pending: Optional[Message] = None  # read but not yet handed off
        try:
            while True:
                pending = None
                msg = pending = await recv_message(
                    self._reader, pool=self._pool, max_payload=self._max_payload
                )
                if msg.type == MsgType.PIECE_PAYLOAD:
                    if self._bw:
                        await self._bw.recv(len(msg.payload))
                    self.bytes_received += len(msg.payload)
                    if msg.payload:
                        # Failpoint p2p.conn.recv.corrupt: flip the first
                        # payload byte -- the exact fault a bad NIC/disk on
                        # the remote produces. Verify must catch it, the
                        # dispatcher must ban the peer, the pull must finish
                        # from healthy peers. On the pooled path this
                        # mutates the leased buffer IN PLACE.
                        if failpoints.fire("p2p.conn.recv.corrupt"):
                            pl = msg.payload
                            if isinstance(pl, memoryview):
                                pl[0] ^= 0xFF
                            else:
                                msg.payload = bytes([pl[0] ^ 0xFF]) + pl[1:]
                        # Failpoint p2p.conn.disconnect: drop the conn mid-
                        # transfer, discarding this frame (remote crash /
                        # RST) -- re-announce + re-request must recover.
                        if failpoints.fire("p2p.conn.disconnect"):
                            msg.release()
                            raise ConnectionResetError(
                                "failpoint p2p.conn.disconnect"
                            )
                    if self.payload_handler is not None:
                        # Hot-type bypass: no queue put, no pump wakeup.
                        pending = None  # ownership moves to the handler
                        self.payload_handler(msg)
                        continue
                else:
                    self.bytes_received += len(msg.payload)
                await self._recv_q.put(msg)
                pending = None  # queue drained by close() or a consumer
        except PayloadOversizeError as e:
            reason, detail, misbehavior = "oversize_payload", str(e), True
        except ConnectionError as e:
            reason, detail = "connection_error", str(e)
        except WireError as e:
            reason, detail = "wire_error", str(e)
        except asyncio.CancelledError:
            reason = "cancelled"
        finally:
            # A frame read but never handed off (cancelled mid-put, bw
            # wait, failpoint) must still return its pooled buffer.
            if pending is not None:
                pending.release()
            self.close(reason=reason, detail=detail, misbehavior=misbehavior)

    def close(
        self,
        reason: str = "local_close",
        detail: str = "",
        misbehavior: bool = False,
    ) -> None:
        if misbehavior:
            self.misbehavior = True
        if self.close_reason is not None:
            return  # first close wins; the pumps' finally re-enter here
        self.close_reason = reason
        self.close_detail = detail
        from kraken_tpu_torch.utils.metrics import REGISTRY

        REGISTRY.counter(
            "conn_closed_total", "P2P conns closed, by terminal cause"
        ).inc(reason=reason)
        fut = self._closed_fut
        if fut is None:
            try:
                fut = self.closed
            except RuntimeError:
                fut = None  # no loop ever ran this conn: nothing to wake
        if fut is not None and not fut.done():
            # The resolved future unblocks every send()/recv() waiter (they
            # race against it); no sentinel bookkeeping needed.
            fut.set_result(None)
        self._writer.close()
        for t in self._tasks:
            t.cancel()
        # Messages parked in the recv queue die with the conn: return
        # their pooled buffers (the leak detector counts every lease).
        while True:
            try:
                queued = self._recv_q.get_nowait()
            except asyncio.QueueEmpty:
                break
            if queued is not None:
                queued.release()

    async def wait_closed(self) -> None:
        await asyncio.shield(self.closed)


async def handshake_outbound(
    reader: asyncio.StreamReader,
    writer: asyncio.StreamWriter,
    own_peer_id: PeerID,
    info_hash: InfoHash,
    name: str,
    namespace: str,
    own_bitfield: bytes,
    num_pieces: int,
    timeout: float = 10.0,
    own_listen_port: int = 0,
) -> HandshakeResult:
    """Dial-side handshake: send ours, await theirs. The active trace
    context (the dial span) rides the handshake so the remote's serve
    spans join this download's trace."""
    await send_message(
        writer,
        Message.handshake(
            str(own_peer_id), info_hash.hex, name, namespace, own_bitfield,
            num_pieces, traceparent=trace.current_traceparent() or "",
            listen_port=own_listen_port,
        ),
    )
    return await _read_handshake(reader, timeout)


async def handshake_inbound(
    reader: asyncio.StreamReader,
    writer: asyncio.StreamWriter,
    own_peer_id: PeerID,
    own_bitfield_for: "callable",
    timeout: float = 10.0,
    own_listen_port: int = 0,
) -> HandshakeResult:
    """Accept-side handshake: read theirs first (it names the torrent),
    then reply with our bitfield for that torrent.

    ``own_bitfield_for(handshake) -> (bits, num_pieces)`` lets the
    scheduler look up (or create) local torrent state; raising aborts the
    conn.
    """
    theirs = await _read_handshake(reader, timeout)
    bits, num_pieces = own_bitfield_for(theirs)
    await send_message(
        writer,
        Message.handshake(
            str(own_peer_id), theirs.info_hash.hex, theirs.name,
            theirs.namespace, bits, num_pieces,
            listen_port=own_listen_port,
        ),
    )
    return theirs


class PeerBusyError(WireError):
    """The remote rejected the conn for CAPACITY, not misbehavior: callers
    soft-blacklist (short, non-escalating) instead of the exponential
    backoff a garbage handshake earns."""


async def _read_handshake(reader: asyncio.StreamReader, timeout: float) -> HandshakeResult:
    msg = await asyncio.wait_for(recv_message(reader), timeout)
    if msg.type == MsgType.ERROR and msg.header.get("code") == "busy":
        raise PeerBusyError("peer at connection capacity")
    if msg.type != MsgType.HANDSHAKE:
        raise WireError(f"expected HANDSHAKE, got {msg.type.name}")
    h = msg.header
    try:
        return HandshakeResult(
            peer_id=PeerID(h["peer_id"]),
            info_hash=InfoHash(h["info_hash"]),
            name=h["name"],
            namespace=h["namespace"],
            bitfield=msg.payload,
            num_pieces=h["num_pieces"],
            traceparent=str(h.get("tp", "") or ""),
            listen_port=int(h.get("lp", 0) or 0),
        )
    except (KeyError, ValueError) as e:
        raise WireError(f"malformed handshake: {e}") from e
