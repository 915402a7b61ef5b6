"""The multi-core data plane: forked worker processes for seed serves
and for download pumps.

The port's copy of ``kraken_tpu.p2p.shardpool``. A :class:`ShardPool`
supervisor forks ``data_plane_workers`` seed-serve workers (and, in leech
mode, ``leech_workers`` download workers), each running its own event
loop; the ``scheduler:`` YAML section sizes them, SIGHUP resizes them.

- **Seed plane.** The scheduler's acceptor hands a handshaken inbound
  conn whose torrent is complete to a worker over one ``AF_UNIX`` /
  ``SOCK_SEQPACKET`` socketpair per worker (``socket.send_fds``), with a
  compact descriptor: info hash, piece length, blob path, the bytes its
  ``StreamReader`` already buffered, the dialer's traceparent. The worker
  serves PIECE_REQUESTs from a long-lived blob fd: prefix and header
  under ``TCP_CORK``, the payload by ``os.sendfile`` (page cache to
  socket). An evicted blob closes the conn between frames; the remote
  requeues elsewhere.
- **Leech plane.** A download conn (dialed or accepted while the torrent
  is partial) is handed off the same way and the dispatcher drives a
  :class:`~kraken_tpu_torch.p2p.conn.LeechConnProxy` in its place. The
  worker runs recv and frame parsing and lands each PIECE_PAYLOAD in a
  slot of its :class:`~kraken_tpu_torch.utils.bufpool.SlabRing` (a
  shared mapping made before the fork); only the slot index crosses the
  control channel. The parent verifies the slot's bytes through its
  ``BatchedVerifier`` and answers ``write`` (the worker pwrites, frees
  the slot, acks) or ``drop``; the bit is set only on the ack, so a set
  bit still implies bytes on disk. A corrupt piece never gets a
  ``write`` and its sender reaches the blacklist as on the main loop.
- Control messages are packed by ``utils/msgpack_lite.py``. Workers ship
  per-shard counters (``record_data_plane_shard``), closed and
  misbehavior verdicts, finished spans (``Tracer.record_foreign``) and
  folded-stack deltas (``SamplingProfiler.record_foreign``) home on a
  0.25 s tick. A worker that dies is seen as control-socket EOF: its
  conns close as the node's fault (no blacklist), its pending writes
  fail (the pieces requeue), ``data_plane_worker_crashes_total`` counts
  it, and the shard is respawned.

Where the card makes this plane differ from its CPU reference:

- **The fork beside a CUDA context.** A ``cuda`` node makes its CUDA
  context before READY, and its workers are forked from it (the
  ``fork`` start method, as in the reference: the ring must be inherited
  and ``spawn`` would re-import torch in every worker). After such a
  fork torch marks the child a bad fork, and any ``torch.cuda`` call
  there raises. So the worker half of this module (everything above
  "Parent side") imports nothing of ``torch`` or of
  ``kraken_tpu_torch.ops``, at any depth of its module imports
  (``tests/test_torch_isolation.py`` checks it), and no worker hashes:
  every verify stays in the parent, on the card.
- **A respawn forks while a verify may be inside a CUDA call** on the
  parent's verify thread, which may hold a metrics or tracer lock at
  that instant. The child therefore renews the process-global locks it
  inherited (:func:`_renew_inherited_locks`) before it touches them.
- **The ring is never pinned.** The CUDA driver may keep registered
  pages out of a later fork's child (a respawn); the parent's verify
  copies each slot view into the hasher's own pinned staging.
- **Slot lifetime against the asynchronous verify.** A slot returns to
  its worker only after ``Torrent.write_piece`` returns, and a verify
  whose caller is cancelled returns only after its batch's thread has
  copied the bytes (``BatchedVerifier.verify``), so a worker never
  overwrites a slot the verify thread is still reading. A slot lease
  and a pending write name the worker object that leased them: after a
  respawn, a late ``drop`` or ``write`` for the dead worker's ring never
  reaches the new worker, whose ring reuses the same slot numbers.
"""

from __future__ import annotations

import asyncio
import errno
import logging
import multiprocessing
import os
import signal
import socket
import threading
import time
from typing import Callable, Optional

from kraken_tpu_torch.p2p.wire import MAX_HEADER, MAX_PAYLOAD, Message, MsgType, frame_head
from kraken_tpu_torch.utils import failpoints, msgpack_lite, profiler, trace
from kraken_tpu_torch.utils.bufpool import SlabRing, _class_for as _bufpool_class_for

_log = logging.getLogger("kraken.p2p.shard")

# Worker-side recv chunk and control-message bound. SEQPACKET preserves
# message boundaries; the only large field is the handoff residual (the
# few frames a fast leecher pipelined behind its handshake).
_CTRL_RECV = 1 << 18
_RECV_CHUNK = 1 << 16

# Parent-side identity of a handed-off conn, for slot release + events.
ConnClosedFn = Callable[[dict, str, bool], None]


def _cork(sock: socket.socket, on: bool) -> None:
    """Batch header+payload into MSS-sized segments (Linux TCP_CORK);
    uncorking flushes. Elsewhere fall back to toggling NODELAY, which
    gives the same flush-on-uncork edge without the strict batching."""
    try:
        if hasattr(socket, "TCP_CORK"):
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_CORK, 1 if on else 0)
        else:  # pragma: no cover - non-Linux
            sock.setsockopt(
                socket.IPPROTO_TCP, socket.TCP_NODELAY, 0 if on else 1
            )
    except OSError:
        pass  # best-effort: correctness never depends on corking


class _Misbehavior(Exception):
    """Protocol violation by the remote (oversize payload, garbage
    header, out-of-range index): the conn closes and the verdict flows
    back to the parent's blacklist."""


_HAVE_SENDFILE = hasattr(os, "sendfile")
# errnos meaning "sendfile cannot serve THIS file/socket pair" (exotic
# fs, emulated kernel): fall back to pread+send for the serve, never
# fail the conn over the transport mechanism.
_SENDFILE_UNSUPPORTED = {
    getattr(errno, name, -1)
    for name in ("EINVAL", "ENOSYS", "EOPNOTSUPP", "ENOTSUP", "ESPIPE")
}


# ---------------------------------------------------------------------------
# Worker side (child process)
# ---------------------------------------------------------------------------

class _WorkerTorrent:
    __slots__ = (
        "name", "path", "piece_length", "length", "num_pieces",
        "file", "evicted_evt", "conns", "writable", "have",
    )

    def __init__(self, desc: dict):
        self.name = desc["name"]
        self.path = desc["path"]
        self.piece_length = desc["plen"]
        self.length = desc["len"]
        self.num_pieces = desc["np"]
        self.file = None  # long-lived blob fd, opened on first serve
        self.evicted_evt = asyncio.Event()
        self.conns: set["_WorkerConn"] = set()
        # Leech plane: writable torrents open r+ (the ``.part`` the
        # parent preallocated) so verdict pwrites land here; ``have``
        # mirrors the PARENT's bitfield (seeded from the handoff
        # descriptor, grown by write acks and by the announce/complete
        # frames the parent fans out through us) and gates which
        # PIECE_REQUESTs this worker may answer in-process.
        self.writable = bool(desc.get("wr"))
        self.have: set[int] = set()
        bits = desc.get("have") or b""
        if bits:
            # Same LSB-first convention as dispatch._bits_to_set.
            self.have = {
                i for i in range(self.num_pieces)
                if i // 8 < len(bits) and bits[i // 8] >> (i % 8) & 1
            }

    def piece_length_of(self, i: int) -> int:
        return min(self.piece_length, self.length - i * self.piece_length)

    def open(self):
        if self.file is None:
            # Buffered binary handle: sock_sendfile's native path only
            # uses fileno() (positional os.sendfile -- safe concurrently),
            # as do the leech plane's os.pwrite calls (unbuffered, so the
            # parent's commit fsync sees every byte).
            self.file = open(self.path, "r+b" if self.writable else "rb")
        return self.file

    def close(self) -> None:
        if self.file is not None:
            try:
                self.file.close()
            finally:
                self.file = None


class _WorkerConn:
    __slots__ = (
        "cid", "sock", "torrent", "buf", "task", "peer", "ih", "tp",
        "leech", "wlock",
    )

    def __init__(self, cid: int, sock: socket.socket, torrent: _WorkerTorrent,
                 desc: dict):
        self.cid = cid
        self.sock = sock
        self.torrent = torrent
        self.buf = bytearray(desc.get("residual") or b"")
        self.task: Optional[asyncio.Task] = None
        self.peer = desc["peer"]
        self.ih = desc["ih"]
        # Conn-level trace context from the leecher's handshake (rode
        # the handoff descriptor); per-request PIECE_REQUEST "tp"
        # headers override it for finer nesting.
        self.tp = desc.get("tp") or ""
        # Leech conns interleave TWO writers on one socket: parent-
        # authored control frames (requests, announces) and in-process
        # piece serves. The lock keeps a corked serve atomic.
        self.leech = bool(desc.get("leech"))
        self.wlock = asyncio.Lock()


class _WorkerState:
    """Everything one shard process owns. Runs inside ``asyncio.run``."""

    def __init__(self, ctrl: socket.socket, shard: int, cfg: dict,
                 ring: SlabRing | None = None):
        self.ctrl = ctrl
        self.shard = shard
        # Idle churn mirrors the dispatcher's conn churn: a seed conn
        # that carries nothing for 2x the churn window frees its slot
        # (the remote redials if it still wants bytes).
        self.idle_timeout = max(1.0, 2.0 * float(cfg.get("churn_idle", 4.0)))
        self.torrents: dict[str, _WorkerTorrent] = {}
        self.conns: dict[int, _WorkerConn] = {}
        self.bytes_up = 0
        self.serves = 0
        # Leech plane: the shared slab (created PRE-fork so both sides
        # map the same pages; None on seed-only shards). This side's
        # free list is authoritative -- the parent only reads views.
        self.ring = ring
        self._ring_evt = asyncio.Event()  # a slot freed; leasers recheck
        self.bytes_down = 0
        self.pieces = 0
        self._write_tasks: set[asyncio.Task] = set()
        self.lameduck = False
        self._stop_evt = asyncio.Event()
        self._stats_dirty = True
        # Finished serve spans awaiting shipment to the parent (fed by
        # the tracer's on_record hook; drained with the stats tick).
        # Bounded: a backlogged parent must cost spans, not RSS.
        self._span_buf: list[dict] = []

    # -- control channel ---------------------------------------------------

    def _on_ctrl(self) -> None:
        while True:
            try:
                data, fds, _flags, _addr = socket.recv_fds(
                    self.ctrl, _CTRL_RECV, 4
                )
            except BlockingIOError:
                return
            except OSError:
                data, fds = b"", []
            if not data:
                # Parent closed its end (stop/crash): drain and exit.
                self._stop_evt.set()
                return
            try:
                msg = msgpack_lite.unpackb(data)
                self._handle_ctrl(msg, fds)
            except Exception:
                for fd in fds:
                    os.close(fd)
                _log.exception("shard %d: bad control message", self.shard)

    def _handle_ctrl(self, msg: dict, fds: list[int]) -> None:
        t = msg.get("t")
        if t == "conn":
            if not fds:
                return
            if self._stop_evt.is_set() or self.lameduck:
                # Late handoff into a draining worker (the parent sent
                # the conn before it saw our drain state): refuse by
                # closing -- the remote soft-retries another peer. The
                # closed verdict MUST still flow back, or the parent's
                # conn slot leaks and the drain wait never quiesces.
                for fd in fds:
                    os.close(fd)
                self._send(
                    {"t": "closed", "cid": msg["cid"],
                     "reason": "worker_refused", "detail": "draining",
                     "mis": False}
                )
                return
            sock = socket.socket(fileno=fds[0])
            for fd in fds[1:]:
                os.close(fd)
            sock.setblocking(False)
            try:
                # A whole piece should fit in the send buffer: sendfile
                # then completes in one or two syscalls instead of
                # ping-ponging EAGAIN -> add_writer -> retry per few
                # hundred KB (each round trip is an epoll_ctl pair plus
                # a loop wakeup -- measured 2x serve CPU on small
                # default buffers).
                sock.setsockopt(
                    socket.SOL_SOCKET, socket.SO_SNDBUF,
                    max(4 << 20, msg.get("plen", 0) * 2),
                )
                if msg.get("leech"):
                    # Download pump: the recv window should hold a
                    # couple of pipelined pieces so the remote keeps
                    # streaming while we drain into the ring.
                    sock.setsockopt(
                        socket.SOL_SOCKET, socket.SO_RCVBUF,
                        max(4 << 20, msg.get("plen", 0) * 2),
                    )
            except OSError:
                pass
            torrent = self.torrents.get(msg["name"])
            if torrent is None or torrent.evicted_evt.is_set():
                torrent = _WorkerTorrent(msg)
                self.torrents[msg["name"]] = torrent
            conn = _WorkerConn(msg["cid"], sock, torrent, msg)
            torrent.conns.add(conn)
            self.conns[conn.cid] = conn
            conn.task = asyncio.create_task(self._conn_loop(conn))
            self._stats_dirty = True
        elif t == "evict":
            torrent = self.torrents.get(msg["name"])
            if torrent is not None:
                # Graceful: conn loops observe the event BETWEEN frames,
                # so an in-flight sendfile completes (the unlinked inode
                # stays readable through the open fd), then the conn
                # closes and the remote requeues elsewhere.
                torrent.evicted_evt.set()
                if not torrent.conns:
                    torrent.close()
                    self.torrents.pop(msg["name"], None)
        elif t == "lameduck":
            self.lameduck = True
        elif t == "stop":
            self._stop_evt.set()
        elif t == "cfg":
            self.idle_timeout = max(
                1.0, 2.0 * float(msg.get("churn_idle", 4.0))
            )
        elif t == "send":
            # Parent-authored outbound frames for one leech conn
            # (requests, announce fanout, PEX). Announce/complete also
            # grow the torrent's have-set, so in-process serves track
            # pieces the parent landed through OTHER conns.
            conn = self.conns.get(msg.get("cid"))
            if conn is not None:
                task = asyncio.create_task(
                    self._send_frames(conn, msg.get("frames") or [])
                )
                self._write_tasks.add(task)
                task.add_done_callback(self._write_tasks.discard)
        elif t == "write":
            # Verify verdict: good digest. pwrite from the slot, free
            # it, ack -- the parent marks the bitfield only on our ack.
            task = asyncio.create_task(self._do_write(msg))
            self._write_tasks.add(task)
            task.add_done_callback(self._write_tasks.discard)
        elif t == "drop":
            # Slot abandoned parent-side (corrupt piece, duplicate,
            # conn torn down mid-verify): free without touching disk.
            self._free_slot(msg.get("slot"))
        elif t == "close":
            # Parent-initiated close (proxy.close echoed down). The
            # conn loop's finally still sends the closed verdict; the
            # proxy is already closed, so it no-ops on arrival.
            conn = self.conns.get(msg.get("cid"))
            if conn is not None and conn.task is not None:
                conn.task.cancel()

    # -- leech plane (slot recv + verdict writes + parent frames) ----------

    def _free_slot(self, slot) -> None:
        if self.ring is None or not isinstance(slot, int):
            return
        self.ring.release(slot)
        self._ring_evt.set()  # wake any pump parked on a full ring

    async def _lease_slot(self) -> int:
        """Claim a ring slot, waiting while the ring is full. The wait IS
        the backpressure: the pump stops reading, the kernel stops
        acking, TCP throttles the remote -- no bytes are dropped."""
        while True:
            slot = self.ring.lease()
            if slot is not None:
                return slot
            self._ring_evt.clear()
            await self._ring_evt.wait()

    async def _recv_into_slot(self, conn: _WorkerConn, slot: int,
                              n: int) -> None:
        """Land ``n`` payload bytes directly in the slot: residual bytes
        already buffered first, then ``sock_recv_into`` the rest -- the
        payload is written exactly once, by the kernel."""
        view = self.ring.view(slot, n)
        got = 0
        if conn.buf:
            take = min(len(conn.buf), n)
            view[:take] = conn.buf[:take]
            del conn.buf[:take]
            got = take
        loop = asyncio.get_running_loop()
        while got < n:
            r = await loop.sock_recv_into(conn.sock, view[got:])
            if not r:
                raise ConnectionResetError("remote closed mid-piece")
            got += r

    async def _send_frames(self, conn: _WorkerConn, frames: list) -> None:
        """Write parent-authored frames to the conn's socket (wire.py
        layout via the shared ``frame_head``)."""
        out = bytearray()
        for mt, header, payload in frames:
            header = header or {}
            payload = payload or b""
            if mt == int(MsgType.ANNOUNCE_PIECE):
                idx = header.get("index")
                if isinstance(idx, int):
                    conn.torrent.have.add(idx)
            elif mt == int(MsgType.COMPLETE):
                conn.torrent.have.update(range(conn.torrent.num_pieces))
            packed = msgpack_lite.packb(header)
            out += frame_head(mt, packed, len(payload))
            out += payload
        if not out:
            return
        loop = asyncio.get_running_loop()
        try:
            async with conn.wlock:
                await loop.sock_sendall(conn.sock, bytes(out))
        except (ConnectionError, OSError):
            pass  # the conn loop's recv observes the death and reports it

    async def _do_write(self, msg: dict) -> None:
        slot, idx, name = msg.get("slot"), msg.get("idx"), msg.get("name")
        ok = False
        try:
            t = self.torrents.get(name)
            if t is None or not t.writable or not isinstance(idx, int):
                raise OSError(f"no writable torrent for {name!r}")
            ln = t.piece_length_of(idx)
            view = self.ring.view(slot, ln)
            f = t.open()
            # Off-loop: a disk stall must not freeze this shard's pumps.
            # os.pwrite on the raw fd bypasses the handle's buffering,
            # so the parent's commit path sees the bytes immediately.
            await asyncio.to_thread(
                os.pwrite, f.fileno(), view, idx * t.piece_length
            )
            t.have.add(idx)
            ok = True
        except Exception as e:
            _log.warning(
                "leech shard write failed",
                extra={"shard": self.shard, "piece": idx, "err": str(e)},
            )
        finally:
            # Free BEFORE acking: the bytes are on disk (or abandoned),
            # either way the slot's job is done.
            self._free_slot(slot)
            self._send({"t": "written", "slot": slot, "ok": ok})

    # -- frame plumbing ----------------------------------------------------

    async def _readexactly(self, conn: _WorkerConn, n: int) -> bytes:
        loop = asyncio.get_running_loop()
        while len(conn.buf) < n:
            chunk = await loop.sock_recv(conn.sock, _RECV_CHUNK)
            if not chunk:
                raise ConnectionResetError("remote closed")
            conn.buf += chunk
        out = bytes(conn.buf[:n])
        del conn.buf[:n]
        return out

    # Control-frame payloads worth forwarding to the parent whole (a
    # mid-stream BITFIELD's bits ride the payload): anything larger is
    # drained and dropped like the seed path.
    _FWD_PAYLOAD_MAX = 1 << 16

    async def _read_frame(
        self, conn: _WorkerConn
    ) -> tuple[int, dict, Optional[int], int, bytes]:
        """One wire frame (p2p/wire.py layout) as ``(mtype, header,
        slot, payload_len, payload)``.

        Seed conns: payload bytes are always unsolicited -- drained and
        dropped to keep framing (``slot=None, payload=b""``). Leech
        conns: a PIECE_PAYLOAD lands in a leased ring slot (``slot``
        set, the caller notifies the parent), small control payloads are
        captured for forwarding, and oversize or malformed input is
        misbehavior either way."""
        prefix = await self._readexactly(conn, 9)
        mtype = prefix[0]
        header_len = int.from_bytes(prefix[1:5], "big")
        payload_len = int.from_bytes(prefix[5:9], "big")
        if header_len > MAX_HEADER or payload_len > MAX_PAYLOAD:
            raise _Misbehavior(
                f"oversized frame: header={header_len} payload={payload_len}"
            )
        if payload_len > max(conn.torrent.piece_length, 1 << 20):
            raise _Misbehavior(f"oversize payload: {payload_len}")
        raw_header = await self._readexactly(conn, header_len) if header_len else b""
        try:
            header = msgpack_lite.unpackb(raw_header) if header_len else {}
            if not isinstance(header, dict):
                raise ValueError("header not a map")
        except Exception as e:
            raise _Misbehavior(f"malformed header: {e}") from e
        if (
            conn.leech
            and self.ring is not None
            and payload_len
            and mtype == int(MsgType.PIECE_PAYLOAD)
        ):
            t = conn.torrent
            idx = header.get("index")
            if not isinstance(idx, int) or not 0 <= idx < t.num_pieces:
                raise _Misbehavior(f"piece index out of range: {idx!r}")
            if payload_len != t.piece_length_of(idx):
                raise _Misbehavior(
                    f"piece {idx}: wrong length {payload_len}"
                )
            slot = await self._lease_slot()
            try:
                await self._recv_into_slot(conn, slot, payload_len)
                # Failpoint p2p.shard.leech.corrupt: flip the first
                # payload byte IN the shared slot -- parent verify must
                # catch it, the ban must cross the fork boundary, the
                # pull must finish from healthy peers.
                if failpoints.fire("p2p.shard.leech.corrupt"):
                    self.ring.view(slot, 1)[0] ^= 0xFF
                # Failpoint p2p.shard.leech.disconnect: the remote dies
                # mid-transfer in a WORKER pump -- the piece requeues to
                # a healthy peer and the slot must come back.
                if failpoints.fire("p2p.shard.leech.disconnect"):
                    raise ConnectionResetError(
                        "failpoint p2p.shard.leech.disconnect"
                    )
            except BaseException:
                self._free_slot(slot)
                raise
            return mtype, header, slot, payload_len, b""
        if (
            conn.leech
            and payload_len
            and payload_len <= self._FWD_PAYLOAD_MAX
            and mtype != int(MsgType.PIECE_PAYLOAD)
        ):
            payload = await self._readexactly(conn, payload_len)
            return mtype, header, None, payload_len, payload
        # Drain-and-drop any payload: a seeder never asked for one.
        remaining = payload_len
        while remaining:
            got = await self._readexactly(conn, min(remaining, _RECV_CHUNK))
            remaining -= len(got)
        return mtype, header, None, payload_len, b""

    async def _wait_writable(self, sock: socket.socket) -> None:
        loop = asyncio.get_running_loop()
        fut = loop.create_future()
        fd = sock.fileno()

        def ready() -> None:
            loop.remove_writer(fd)
            if not fut.done():
                fut.set_result(None)

        loop.add_writer(fd, ready)
        try:
            await fut
        except asyncio.CancelledError:
            loop.remove_writer(fd)
            raise

    async def _sendfile(self, conn: _WorkerConn, f, offset: int,
                        count: int) -> None:
        """Nonblocking ``os.sendfile`` with an inline fast path: after
        the previous piece drains, the (piece-sized, see SO_SNDBUF at
        adoption) send buffer almost always has room, so the common
        case is ONE syscall and zero event-loop round trips --
        ``loop.sock_sendfile``'s per-chunk add_writer/remove_writer
        dance measured at 2x the serve CPU on this path."""
        loop = asyncio.get_running_loop()
        fd = conn.sock.fileno()
        sent = 0
        while sent < count:
            try:
                n = os.sendfile(fd, f.fileno(), offset + sent, count - sent)
            except BlockingIOError:
                await self._wait_writable(conn.sock)
                continue
            if n == 0:
                raise ConnectionResetError("sendfile: remote closed")
            sent += n
            if sent < count:
                # Partial: buffer full mid-piece; wait before retrying
                # rather than spinning EAGAIN.
                await self._wait_writable(conn.sock)
        await asyncio.sleep(0)  # serve fairness between conns of a shard

    async def _serve_piece(self, conn: _WorkerConn, idx: int,
                           tp: str = "") -> None:
        """The hot path: prefix+header corked, payload via sendfile from
        the long-lived blob fd -- piece bytes never enter this process's
        userspace (page cache -> socket in the kernel).

        ``tp`` is the requester's traceparent (frame-level, falling back
        to the handshake's): present only on SAMPLED traces, in which
        case the serve gets a span that ships home to the parent's
        flight recorder -- the cross-process half of "one trace per
        pull"."""
        parent = trace.parse_traceparent(tp or conn.tp)
        if parent is not None and parent.sampled:
            with trace.span(
                "p2p.shard.serve", parent, piece=idx,
                peer=conn.peer[:12],
            ):
                await self._serve_piece_inner(conn, idx)
        else:
            await self._serve_piece_inner(conn, idx)

    async def _serve_piece_inner(self, conn: _WorkerConn, idx: int) -> None:
        hit = failpoints.fire("p2p.shard.serve.disconnect")
        if hit:
            if hit.delay_s:
                await asyncio.sleep(hit.delay_s)
            raise ConnectionResetError("failpoint p2p.shard.serve.disconnect")
        t = conn.torrent
        ln = t.piece_length_of(idx)
        head = frame_head(
            int(MsgType.PIECE_PAYLOAD), msgpack_lite.packb({"index": idx}), ln
        )
        loop = asyncio.get_running_loop()
        f = t.open()  # FileNotFoundError here = evicted under us
        # wlock: on leech conns a parent-authored frame batch must not
        # interleave with the corked head+sendfile (seed conns never
        # contend -- the conn loop is the only writer).
        async with conn.wlock:
            _cork(conn.sock, True)
            try:
                await loop.sock_sendall(conn.sock, head)
                if _HAVE_SENDFILE:
                    try:
                        await self._sendfile(
                            conn, f, idx * t.piece_length, ln
                        )
                    except OSError as e:
                        if e.errno not in _SENDFILE_UNSUPPORTED:
                            raise
                        # Kernel/fs without sendfile for this pair: the
                        # pread fallback is correct, one userspace copy.
                        await self._serve_pread(conn, f, idx, ln)
                else:  # pragma: no cover - non-Linux
                    await self._serve_pread(conn, f, idx, ln)
            finally:
                _cork(conn.sock, False)
        self.bytes_up += ln
        self.serves += 1
        self._stats_dirty = True

    async def _serve_pread(self, conn: _WorkerConn, f, idx: int,
                           ln: int) -> None:
        loop = asyncio.get_running_loop()
        data = os.pread(f.fileno(), ln, idx * conn.torrent.piece_length)
        if len(data) != ln:
            raise OSError(f"short read on piece {idx}")
        await loop.sock_sendall(conn.sock, data)

    # Frame types a leech conn forwards to the parent's dispatcher (the
    # bookkeeping half: availability updates and peer gossip).
    _FORWARD_TYPES = frozenset(
        int(m) for m in (
            MsgType.ANNOUNCE_PIECE, MsgType.BITFIELD,
            MsgType.COMPLETE, MsgType.PEER_EXCHANGE,
        )
    )

    async def _handle_frame(self, conn: _WorkerConn, mtype: int,
                            header: dict, payload: bytes = b"") -> None:
        if mtype == MsgType.PIECE_REQUEST:
            idx = header.get("index")
            t = conn.torrent
            if not isinstance(idx, int) or not 0 <= idx < t.num_pieces:
                raise _Misbehavior(f"piece index out of range: {idx!r}")
            if conn.leech and idx not in t.have:
                # Same as the main-loop dispatcher: a request for a
                # piece we don't (yet) have is silently dropped -- the
                # remote re-requests after our next announce.
                return
            await self._serve_piece(conn, idx, str(header.get("tp") or ""))
        elif conn.leech and mtype in self._FORWARD_TYPES:
            # Dispatcher bookkeeping (peer availability, PEX gossip)
            # lives in the parent: ship the frame home. Payloads here
            # are small (bitfield bits) and size-capped at read time.
            self._send({
                "t": "frame", "cid": conn.cid, "mt": mtype, "h": header,
                **({"p": payload} if payload else {}),
            })
        elif mtype == MsgType.ERROR:
            raise ConnectionResetError(header.get("detail", "peer error"))
        # Remaining chatter (CANCEL_PIECE; ANNOUNCE/COMPLETE on a seed
        # conn; PIECE_PAYLOAD already drained): nothing to act on.

    async def _conn_loop(self, conn: _WorkerConn) -> None:
        reason, detail, mis = "remote_closed", "", False
        t = conn.torrent
        evict_wait = asyncio.ensure_future(t.evicted_evt.wait())
        stop_wait = asyncio.ensure_future(self._stop_evt.wait())
        recv: Optional[asyncio.Future] = None
        try:
            while True:
                if t.evicted_evt.is_set():
                    reason = "evicted"
                    break
                if self._stop_evt.is_set():
                    reason = "drain_stop"
                    break
                recv = asyncio.ensure_future(self._read_frame(conn))
                done, _pending = await asyncio.wait(
                    {recv, evict_wait, stop_wait},
                    timeout=self.idle_timeout,
                    return_when=asyncio.FIRST_COMPLETED,
                )
                if recv not in done:
                    recv.cancel()
                    recv = None
                    if evict_wait in done:
                        reason = "evicted"
                    elif stop_wait in done:
                        reason = "drain_stop"
                    else:
                        reason = "idle_conn"
                    break
                mtype, header, slot, ln, payload = recv.result()
                recv = None
                if slot is not None:
                    # A complete piece landed in the shared ring: hand
                    # the parent its slot index for verify. Ownership
                    # transfers -- the slot comes back as a write
                    # verdict or a drop.
                    self.bytes_down += ln
                    self.pieces += 1
                    self._stats_dirty = True
                    delivered = self._send({
                        "t": "piece", "cid": conn.cid,
                        "idx": header.get("index"), "slot": slot, "ln": ln,
                    })
                    if not delivered:
                        # Parent backlogged/gone: the piece is lost (the
                        # request times out and requeues) but the slot
                        # MUST come back or the ring bleeds dry.
                        self._free_slot(slot)
                    continue
                # In-flight serves run INLINE here: eviction and drain
                # take effect between frames, never mid-sendfile.
                await self._handle_frame(conn, mtype, header, payload)
        except (ConnectionError, OSError, asyncio.IncompleteReadError) as e:
            reason, detail = "connection_error", str(e)
        except _Misbehavior as e:
            reason, detail, mis = "misbehavior", str(e), True
        except asyncio.CancelledError:
            reason = "cancelled"
        except Exception as e:  # a bad conn must not kill the shard
            reason, detail = "serve_error", str(e)
        finally:
            if recv is not None:
                recv.cancel()
            evict_wait.cancel()
            stop_wait.cancel()
            try:
                conn.sock.close()
            except OSError:
                pass
            self.conns.pop(conn.cid, None)
            t.conns.discard(conn)
            if not t.conns:
                # Shed the blob fd with the last conn (release_fd parity:
                # a long-lived shard must not hold fds for idle torrents).
                t.close()
                # Identity-guarded: an evicted torrent may have been
                # replaced in the registry by a fresh handoff after a
                # re-pull; popping by name alone would evict the NEW
                # object's registration and orphan its conns from any
                # later evict fan-out.
                if (
                    t.evicted_evt.is_set()
                    and self.torrents.get(t.name) is t
                ):
                    self.torrents.pop(t.name, None)
            self._send(
                {"t": "closed", "cid": conn.cid, "reason": reason,
                 "detail": detail, "mis": mis}
            )
            self._stats_dirty = True

    # -- stats + lifecycle -------------------------------------------------

    def _send(self, msg: dict) -> bool:
        try:
            self.ctrl.send(msgpack_lite.packb(msg))
            return True
        except (BlockingIOError, OSError):
            return False  # parent backlogged or gone; mostly best-effort

    def _send_stats(self) -> None:
        times = os.times()
        self._send({
            "t": "stats",
            "conns": len(self.conns),
            "bytes_up": self.bytes_up,
            "serves": self.serves,
            "bytes_down": self.bytes_down,
            "pieces": self.pieces,
            "cpu_s": times.user + times.system,
            "lameduck": self.lameduck,
        })
        self._stats_dirty = False
        self._ship_spans()
        self._ship_profile()

    _SPAN_BUF_MAX = 2048  # drop-oldest bound on the shipping buffer
    _SPAN_BATCH = 64  # spans per SEQPACKET message (size-bounded frames)

    def _on_span(self, d: dict) -> None:
        self._span_buf.append(d)
        if len(self._span_buf) > self._SPAN_BUF_MAX:
            del self._span_buf[: -self._SPAN_BUF_MAX]

    def _ship_spans(self) -> None:
        """Drain finished serve spans home; the parent adopts them into
        its flight recorder (record_foreign) so /debug/trace and the
        dump triggers see worker serves like any main-loop span."""
        while self._span_buf:
            batch = self._span_buf[: self._SPAN_BATCH]
            del self._span_buf[: self._SPAN_BATCH]
            self._send({"t": "spans", "spans": batch})

    def _ship_profile(self) -> None:
        """Drain this shard's folded-stack delta home (utils/profiler.py
        restarted its sampler post-fork): the parent adopts it under our
        node stamp so /debug/pprof/profile -- and a `kraken-tpu flame`
        collapse -- covers the whole node, shards included. Batched at
        the span-shipping size: one SEQPACKET datagram of hundreds of
        deep stacks would exceed the control socket's send buffer (and
        the parent's recv bound), losing the already-drained samples."""
        while True:
            batch = profiler.PROFILER.drain_pending(
                max_stacks=self._SPAN_BATCH
            )
            if batch is None:
                return
            self._send({"t": "prof", **batch})

    async def run(self) -> None:
        loop = asyncio.get_running_loop()
        self.ctrl.setblocking(False)
        loop.add_reader(self.ctrl.fileno(), self._on_ctrl)
        # This fork inherited the parent's tracer wholesale: keep the
        # (pre-fork) config, but drop the parent's recorded spans --
        # they already live in the parent's ring -- stamp the shard on
        # the node id, and buffer this process's spans for shipment.
        trace.TRACER.recorder.clear()
        stamp = (
            f"leech{self.shard}" if self.ring is not None
            else f"shard{self.shard}"
        )
        trace.TRACER.node = (
            f"{trace.TRACER.node}/{stamp}" if trace.TRACER.node else stamp
        )
        trace.TRACER.on_record = self._on_span
        # Same story for the sampling profiler: the fork inherited its
        # config but killed its thread (and may have inherited mid-held
        # locks) -- restart clean with the shard's node stamp and ship
        # mode on, so this process's stacks ride the stats tick home.
        profiler.PROFILER.restart_in_child(trace.TRACER.node)
        self._send({"t": "ready", "pid": os.getpid()})
        try:
            while not self._stop_evt.is_set():
                try:
                    await asyncio.wait_for(self._stop_evt.wait(), 0.25)
                except asyncio.TimeoutError:
                    pass
                if self._stats_dirty or self.conns:
                    self._send_stats()
        finally:
            # Graceful drain: conn loops observed _stop_evt and are
            # finishing their in-flight serve; give them a beat, then cut.
            tasks = [c.task for c in list(self.conns.values()) if c.task]
            if tasks:
                await asyncio.wait(tasks, timeout=1.0)
            for c in list(self.conns.values()):
                if c.task:
                    c.task.cancel()
            if tasks:
                await asyncio.gather(*tasks, return_exceptions=True)
            # Verdict pwrites still in flight finish before the fds
            # close: the parent is awaiting their written acks.
            if self._write_tasks:
                await asyncio.gather(
                    *list(self._write_tasks), return_exceptions=True
                )
            for t in list(self.torrents.values()):
                t.close()
            self._send_stats()
            loop.remove_reader(self.ctrl.fileno())
            try:
                self.ctrl.close()
            except OSError:
                pass


def _renew_inherited_locks() -> None:
    """Give this forked worker fresh process-global locks. The fork
    copied only the forking thread; a lock another parent thread held at
    that instant (a verify thread inside ``hash_batch`` bumping a
    counter, a span landing in the flight recorder) stays held forever
    in the copy. Nothing else runs in the child yet, so the swap races
    nothing."""
    from kraken_tpu_torch.utils.metrics import REGISTRY

    REGISTRY._lock = threading.Lock()
    for metric in list(REGISTRY._metrics.values()):
        metric._lock = threading.Lock()
    trace.TRACER.recorder._lock = threading.Lock()
    trace.TRACER._dump_lock = threading.Lock()
    failpoints.FAILPOINTS._lock = threading.Lock()


def _worker_main(ctrl: socket.socket, parent_fd: int, shard: int,
                 cfg: dict, ring: SlabRing | None = None) -> None:
    """Child-process entry (fork start method). Renews the inherited
    locks and resets inherited signal plumbing -- the parent's asyncio
    handlers reference a loop this process must never touch -- then runs
    the shard's own loop. Nothing here reaches torch: a child forked
    from a process with a live CUDA context may not call into it."""
    _renew_inherited_locks()
    try:
        # Name the process ``kt-shard<n>`` / ``kt-leech<n>``, so that ps,
        # top and scripts can tell a node's workers apart.
        with open("/proc/self/comm", "w") as f:
            f.write(f"kt-{'leech' if ring is not None else 'shard'}{shard}")
    except OSError:
        pass
    try:
        signal.set_wakeup_fd(-1)
    except (ValueError, OSError):  # pragma: no cover
        pass
    signal.signal(signal.SIGTERM, signal.SIG_DFL)
    signal.signal(signal.SIGINT, signal.SIG_IGN)  # parent ^C handles us
    try:
        signal.signal(signal.SIGHUP, signal.SIG_IGN)
    except (OSError, ValueError):  # pragma: no cover
        pass
    if parent_fd >= 0:
        # The fork duplicated the PARENT's end of the socketpair into
        # this process; holding it open would mask parent-death EOF.
        try:
            os.close(parent_fd)
        except OSError:
            pass
    try:
        asyncio.run(_WorkerState(ctrl, shard, cfg, ring).run())
    except KeyboardInterrupt:  # pragma: no cover
        pass


# ---------------------------------------------------------------------------
# Parent side (supervisor)
# ---------------------------------------------------------------------------

def _note_exit(w: "_Worker", expected: bool) -> None:
    """A worker that was asked to exit (stop, resize) must exit 0 after
    its drain; anything else is logged, for the operator and for scripts
    that gate on a clean shutdown."""
    code = w.proc.exitcode
    if expected and code != 0:
        _log.warning(
            "data-plane shard exited non-zero",
            extra={"shard": w.label, "pid": w.proc.pid, "exitcode": code},
        )


class _Worker:
    __slots__ = (
        "shard", "proc", "sock", "conns", "retiring",
        "last_bytes", "last_serves", "last_down", "last_pieces",
        "cpu_s", "prefix", "ring", "pending_writes",
    )

    def __init__(self, shard: int, proc, sock: socket.socket,
                 prefix: str = "data_plane_shard",
                 ring: SlabRing | None = None):
        self.shard = shard
        self.proc = proc
        self.sock = sock
        self.conns = 0  # parent-side estimate (handoffs - closes)
        self.retiring = False
        self.last_bytes = 0
        self.last_serves = 0
        self.last_down = 0
        self.last_pieces = 0
        self.cpu_s = 0.0
        self.prefix = prefix
        # Leech shards only: the shared slab this worker's pumps fill.
        # A respawn gets a FRESH ring; the old mapping lives exactly as
        # long as in-flight parent-side views into it.
        self.ring = ring
        # slot -> future resolved by this worker's written ack. Per
        # worker OBJECT: a respawn reuses the shard number and the slot
        # numbers, never these futures.
        self.pending_writes: dict[int, asyncio.Future] = {}

    @property
    def label(self) -> str:
        return f"{self.prefix}{self.shard}"


class _SlotLease:
    """Parent-side lease on one shared-ring slot, attached to the
    PIECE_PAYLOAD :class:`~kraken_tpu_torch.p2p.wire.Message` a leech worker
    announced. Mirrors the bufpool Lease contract the dispatcher already
    trusts: ``release()`` is idempotent and is THE single return point
    (the dispatcher's payload-task done-callback always calls it) --
    here it ships a ``drop`` so the worker frees the slot untouched.

    ``remote_write`` is the leech plane's replacement for the parent's
    pwrite (``Torrent.write_piece(..., remote_write=...)``): it consumes
    the lease, sends the good-digest ``write`` verdict, and resolves on
    the worker's ``written`` ack -- after which the slot is already free
    worker-side, so the later ``release()`` no-ops.

    The lease names the worker OBJECT whose ring holds the slot: once that
    worker is gone, neither verdict may reach the shard's respawn, whose
    fresh ring reuses the slot numbers."""

    __slots__ = ("_pool", "_worker", "_slot", "_name", "_consumed")

    def __init__(self, pool: "ShardPool", worker: _Worker, slot: int, name: str):
        self._pool = pool
        self._worker = worker
        self._slot = slot
        self._name = name
        self._consumed = False

    @property
    def released(self) -> bool:
        return self._consumed

    def release(self) -> None:
        if self._consumed:
            return
        self._consumed = True
        self._pool._drop_slot(self._worker, self._slot)

    async def remote_write(self, idx: int) -> None:
        if self._consumed:
            raise ConnectionError("slot lease already released")
        self._consumed = True
        await self._pool._remote_write(self._worker, self._slot, self._name, idx)


class ShardPool:
    """Supervisor for the seed-serve worker processes. One per scheduler;
    all methods run on the scheduler's event loop."""

    def __init__(
        self,
        size: int,
        *,
        churn_idle_seconds: float = 4.0,
        on_conn_closed: ConnClosedFn | None = None,
        component: str = "p2p",
        leech: bool = False,
        ring_slots: int = 32,
        slot_bytes: int = 1 << 20,
    ):
        self._target = max(0, size)
        self.churn_idle = churn_idle_seconds
        self._on_conn_closed = on_conn_closed or (lambda desc, r, m: None)
        self.component = component
        # Leech mode: workers run download pumps, each with a pre-fork
        # shared SlabRing of ``ring_slots`` x ``slot_bytes``-class slots.
        self.leech = leech
        self._ring_slots = max(1, ring_slots)
        # Normalize to the SlabRing's power-of-two slot class so the
        # scheduler's piece-length gate compares against the size the
        # ring actually allocates.
        self._slot_bytes = _bufpool_class_for(max(1, slot_bytes))
        self._prefix = "leech_shard" if leech else "data_plane_shard"
        # cid -> LeechConnProxy for handed-off download conns; their
        # closed verdicts route to the proxy (the dispatcher owns the
        # bookkeeping), NOT the seed plane's on_conn_closed callback.
        self._proxies: dict[int, object] = {}
        # Parent-side mirror of outstanding slot leases (leak audit).
        self.slot_leases = 0
        self._workers: dict[int, _Worker] = {}
        self._conns: dict[int, tuple[_Worker, dict]] = {}  # cid -> (worker, desc)
        self._next_cid = 0
        self._stopping = False
        self.lameduck = False
        self._reap_tasks: set[asyncio.Task] = set()
        from kraken_tpu_torch.utils.metrics import REGISTRY

        self._c_handoffs = REGISTRY.counter(
            "data_plane_handoffs_total",
            "Seed conns handed to worker shards, by shard",
        )
        self._c_fallbacks = REGISTRY.counter(
            "data_plane_handoff_fallbacks_total",
            "Seed conns kept on the main loop (no shard could take them)",
        )
        self._c_crashes = REGISTRY.counter(
            "data_plane_worker_crashes_total",
            "Worker shards that exited without being asked to",
        )
        self._g_workers = REGISTRY.gauge(
            "data_plane_workers", "Configured seed-serve worker processes"
        )
        self._g_alive = REGISTRY.gauge(
            "data_plane_workers_alive", "Live seed-serve worker processes"
        )

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        for shard in range(self._target):
            self._spawn(shard)
        self._g_workers.set(self._target, component=self.component)

    def _spawn(self, shard: int) -> None:
        parent_sock, child_sock = socket.socketpair(
            socket.AF_UNIX, socket.SOCK_SEQPACKET
        )
        # The ring MUST exist before the fork: both processes inherit
        # the same anonymous MAP_SHARED pages. A respawned shard gets a
        # fresh ring (the dead worker's free-list state is gone with
        # it); old in-flight views pin the old mapping until they die.
        ring = (
            SlabRing(self._ring_slots, self._slot_bytes)
            if self.leech else None
        )
        ctx = multiprocessing.get_context("fork")
        proc = ctx.Process(
            target=_worker_main,
            args=(
                child_sock, parent_sock.fileno(), shard,
                {"churn_idle": self.churn_idle}, ring,
            ),
            daemon=True,  # backstop: never outlive the node process
            name=f"kraken-{'leech' if self.leech else 'data-plane'}-shard{shard}",
        )
        proc.start()
        child_sock.close()
        parent_sock.setblocking(False)
        w = _Worker(shard, proc, parent_sock, prefix=self._prefix, ring=ring)
        self._workers[shard] = w
        asyncio.get_running_loop().add_reader(
            parent_sock.fileno(), self._on_worker_msg, shard
        )
        self._g_alive.set(self.alive_workers, component=self.component)
        _log.info(
            "data-plane shard spawned",
            extra={"shard": shard, "pid": proc.pid},
        )

    def resize(self, size: int) -> None:
        """SIGHUP live resize: grow spawns fresh shards; shrink retires
        the highest shards -- they finish in-flight serves, close their
        conns, and exit; their slots release through the normal closed
        verdicts."""
        size = max(0, size)
        self._target = size
        self._g_workers.set(size, component=self.component)
        live = sorted(
            s for s, w in self._workers.items() if not w.retiring
        )
        for shard in range(size):
            if shard not in self._workers:
                self._spawn(shard)
        for shard in live:
            if shard >= size:
                w = self._workers[shard]
                w.retiring = True
                self._send(w, {"t": "stop"})

    def enter_lameduck(self) -> None:
        self.lameduck = True
        for w in self._workers.values():
            self._send(w, {"t": "lameduck"})

    def evict(self, name_hex: str) -> None:
        """A blob left the store (eviction, quarantine, unseed): every
        shard drops its fd and closes that torrent's conns gracefully."""
        for w in self._workers.values():
            self._send(w, {"t": "evict", "name": name_hex})

    def reconfigure(self, churn_idle_seconds: float) -> None:
        self.churn_idle = churn_idle_seconds
        for w in self._workers.values():
            self._send(w, {"t": "cfg", "churn_idle": churn_idle_seconds})

    async def stop(self) -> None:
        """Graceful teardown: ask every worker to drain, join with a
        bound, hard-kill stragglers, release any conn slots still
        attributed to shards. Reaps every child -- zero orphans is the
        soak harness's audit line."""
        self._stopping = True
        workers = list(self._workers.values())
        self._workers.clear()
        loop = asyncio.get_running_loop()
        for w in workers:
            try:
                loop.remove_reader(w.sock.fileno())
            except (OSError, ValueError):
                pass
            self._send(w, {"t": "stop"})

        def _join_all() -> None:
            deadline = time.monotonic() + 3.0
            for w in workers:
                w.proc.join(max(0.1, deadline - time.monotonic()))
            for w in workers:
                if w.proc.is_alive():
                    w.proc.terminate()
                    w.proc.join(1.0)
                if w.proc.is_alive():  # pragma: no cover - last resort
                    w.proc.kill()
                    w.proc.join(1.0)

        await asyncio.to_thread(_join_all)
        for w in workers:
            _note_exit(w, expected=True)
            try:
                w.sock.close()
            except OSError:
                pass
            try:
                w.proc.close()  # releases the mp sentinel fd
            except (OSError, ValueError):  # pragma: no cover
                pass  # close() raises ValueError while still alive
        for cid, (_w, desc) in list(self._conns.items()):
            self._conns.pop(cid, None)
            proxy = self._proxies.pop(cid, None)
            if proxy is not None:
                proxy.on_remote_closed("pool_stop", False)
            else:
                self._safe_conn_closed(desc, "pool_stop", False)
        for w in workers:
            self._fail_writes(w, "pool stopped mid-write")
            if w.ring is not None:
                w.ring.close()
        self._g_alive.set(0, component=self.component)
        for t in list(self._reap_tasks):
            t.cancel()
        if self._reap_tasks:
            await asyncio.gather(*self._reap_tasks, return_exceptions=True)

    # -- handoff -----------------------------------------------------------

    @property
    def can_accept(self) -> bool:
        return (
            not self._stopping
            and not self.lameduck
            and any(not w.retiring for w in self._workers.values())
        )

    @property
    def num_conns(self) -> int:
        """Live handed-off conns -- counted into the scheduler's drain
        quiesce signal."""
        return len(self._conns)

    @property
    def slot_bytes(self) -> int:
        """Ring slot class in bytes (power of two). A leech handoff is
        only legal when the torrent's piece length fits one slot."""
        return self._slot_bytes

    def try_handoff(self, fd: int, desc: dict, proxy=None) -> bool:
        """Ship a handshaken conn (by fd) to the least-loaded shard.
        False = no shard could take it right now (all retiring, control
        channel backlogged); the caller keeps the conn on the main loop.

        ``proxy`` (leech mode): the :class:`LeechConnProxy` the
        dispatcher will drive. On success it is bound to the worker --
        its outbound frames and close flow through :meth:`send_frames` /
        :meth:`close_remote`, and the worker's verdicts route back to
        it."""
        if not self.can_accept:
            self._c_fallbacks.inc()
            return False
        cid = self._next_cid
        self._next_cid += 1
        payload = msgpack_lite.packb({"t": "conn", "cid": cid, **desc})
        candidates = sorted(
            (w for w in self._workers.values() if not w.retiring),
            key=lambda w: w.conns,
        )
        for w in candidates:
            try:
                socket.send_fds(w.sock, [payload], [fd])
            except (BlockingIOError, OSError):
                continue
            w.conns += 1
            self._conns[cid] = (w, desc)
            if proxy is not None:
                proxy._shard_cid = cid
                self._proxies[cid] = proxy
            self._c_handoffs.inc(shard=w.label)
            return True
        self._c_fallbacks.inc()
        return False

    # -- leech proxy plumbing ----------------------------------------------

    def _live(self, w: _Worker) -> bool:
        """Is ``w`` still its shard's worker (not dead, not respawned)?"""
        return self._workers.get(w.shard) is w

    def send_frames(self, proxy, frames: list) -> None:
        """Outbound frames for a handed-off leech conn (injected into
        the proxy as its ``send_frames``). Best-effort, like every
        control-channel send: a lost frame behaves like a lossy peer
        (requests re-issue on piece timeout)."""
        cid = getattr(proxy, "_shard_cid", None)
        entry = self._conns.get(cid) if cid is not None else None
        if entry is not None and self._live(entry[0]):
            self._send(entry[0], {"t": "send", "cid": cid, "frames": frames})

    def close_remote(self, proxy, reason: str, mis: bool) -> None:
        """Parent-initiated close of a handed-off leech conn."""
        cid = getattr(proxy, "_shard_cid", None)
        entry = self._conns.get(cid) if cid is not None else None
        if entry is not None and self._live(entry[0]):
            self._send(entry[0], {"t": "close", "cid": cid})

    def _drop_slot(self, w: _Worker, slot: int) -> None:
        """A slot lease released unconsumed (corrupt piece, duplicate,
        teardown): tell the worker to free it without writing."""
        self.slot_leases = max(0, self.slot_leases - 1)
        if self._live(w):
            self._send(w, {"t": "drop", "slot": slot})
        # Worker gone: its ring (and authoritative free list) died with
        # it -- nothing to free.

    async def _remote_write(self, w: _Worker, slot: int, name: str,
                            idx: int) -> None:
        """Good-digest verdict: have the worker pwrite the slot, await
        its written ack. Raising (worker death, write error, timeout)
        leaves the piece unmarked -- the dispatcher requeues it."""
        self.slot_leases = max(0, self.slot_leases - 1)
        if not self._live(w) or not w.proc.is_alive():
            raise ConnectionError("leech worker exited before write")
        fut = asyncio.get_running_loop().create_future()
        w.pending_writes[slot] = fut
        self._send(w, {"t": "write", "name": name, "slot": slot, "idx": idx})
        try:
            # Generous bound: a wedged worker must not strand the
            # dispatcher's payload task forever (its conn would never
            # churn -- receiving>0 exempts it).
            await asyncio.wait_for(fut, 30.0)
        except asyncio.TimeoutError:
            raise ConnectionError(
                f"leech shard {w.shard}: written ack timed out (piece {idx})"
            ) from None
        finally:
            if w.pending_writes.get(slot) is fut:
                del w.pending_writes[slot]

    @staticmethod
    def _fail_writes(w: _Worker, why: str) -> None:
        """In-flight verdict writes of ``w`` can never be acked now: fail
        them so write_piece raises, the piece stays unmarked, and it
        requeues."""
        for slot, fut in list(w.pending_writes.items()):
            del w.pending_writes[slot]
            if not fut.done():
                fut.set_exception(ConnectionError(why))

    # -- worker messages ---------------------------------------------------

    def _send(self, w: _Worker, msg: dict) -> None:
        try:
            w.sock.send(msgpack_lite.packb(msg))
        except (BlockingIOError, OSError):
            pass  # worker gone or backlogged; EOF handling catches death

    def _on_worker_msg(self, shard: int) -> None:
        w = self._workers.get(shard)
        if w is None:
            return
        while True:
            try:
                data = w.sock.recv(_CTRL_RECV)
            except BlockingIOError:
                return
            except OSError:
                data = b""
            if not data:
                self._worker_gone(shard)
                return
            try:
                self._handle_worker_msg(w, msgpack_lite.unpackb(data))
            except Exception:
                _log.exception("bad message from shard %d", shard)

    def _handle_worker_msg(self, w: _Worker, msg: dict) -> None:
        t = msg.get("t")
        if t == "stats":
            from kraken_tpu_torch.utils.metrics import record_data_plane_shard

            w.cpu_s = float(msg.get("cpu_s", 0.0))
            record_data_plane_shard(
                w.label,
                conns=msg.get("conns", 0),
                bytes_delta=max(0, msg.get("bytes_up", 0) - w.last_bytes),
                serves_delta=max(0, msg.get("serves", 0) - w.last_serves),
                cpu_seconds=w.cpu_s,
                bytes_down_delta=max(
                    0, msg.get("bytes_down", 0) - w.last_down
                ),
                pieces_delta=max(0, msg.get("pieces", 0) - w.last_pieces),
            )
            w.last_bytes = msg.get("bytes_up", w.last_bytes)
            w.last_serves = msg.get("serves", w.last_serves)
            w.last_down = msg.get("bytes_down", w.last_down)
            w.last_pieces = msg.get("pieces", w.last_pieces)
        elif t == "closed":
            cid = msg.get("cid")
            entry = self._conns.pop(cid, None)
            w.conns = max(0, w.conns - 1)
            proxy = self._proxies.pop(cid, None)
            if proxy is not None:
                # Dispatcher-owned conn: the verdict flows through the
                # proxy (misbehavior intact -> blacklist escalation);
                # connstate/event cleanup rides its closed callback.
                proxy.on_remote_closed(
                    msg.get("reason", ""), bool(msg.get("mis"))
                )
            elif entry is not None:
                _owner, desc = entry
                self._safe_conn_closed(
                    desc, msg.get("reason", ""), bool(msg.get("mis"))
                )
        elif t == "piece":
            self._on_piece(w, msg)
        elif t == "written":
            fut = w.pending_writes.get(msg.get("slot"))
            if fut is not None and not fut.done():
                if msg.get("ok"):
                    fut.set_result(None)
                else:
                    fut.set_exception(
                        OSError(f"leech shard {w.shard}: pwrite failed")
                    )
        elif t == "frame":
            proxy = self._proxies.get(msg.get("cid"))
            if proxy is not None:
                proxy.on_frame(
                    msg.get("mt"), msg.get("h") or {}, msg.get("p") or b""
                )
        elif t == "spans":
            # Worker serve spans come home: adopt them so the parent's
            # /debug/trace and flight-recorder dumps hold the WHOLE
            # data plane, forked halves included.
            trace.TRACER.record_foreign(msg.get("spans") or [])
        elif t == "prof":
            # Folded-stack deltas from the shard's own sampler: one
            # /debug/pprof/profile (and one flame collapse) covers the
            # main loop AND the forked serve plane.
            profiler.PROFILER.record_foreign(
                str(msg.get("node") or w.label),
                msg.get("stacks") or [],
                msg.get("planes") or {},
            )
        elif t == "ready":
            pass

    def _on_piece(self, w: _Worker, msg: dict) -> None:
        """A leech worker landed a complete piece in its ring: build the
        zero-copy Message (payload = a view of the shared mapping, lease
        = the slot) and deliver it to the owning proxy exactly like the
        recv loop's payload-handler bypass."""
        cid, slot, ln = msg.get("cid"), msg.get("slot"), msg.get("ln", 0)
        idx = msg.get("idx")
        entry = self._conns.get(cid)
        proxy = self._proxies.get(cid)
        if w.ring is None or not isinstance(slot, int):
            return
        lease = _SlotLease(
            self, w, slot,
            entry[1].get("name", "") if entry else "",
        )
        self.slot_leases += 1
        if proxy is None or not isinstance(idx, int):
            lease.release()  # conn already gone: free the slot
            return
        m = Message(
            MsgType.PIECE_PAYLOAD, {"index": idx},
            w.ring.view(slot, ln), lease=lease,
        )
        try:
            proxy.deliver_payload(m)
        except Exception:
            m.release()
            _log.exception("leech payload delivery failed")

    def _safe_conn_closed(self, desc: dict, reason: str, mis: bool) -> None:
        try:
            self._on_conn_closed(desc, reason, mis)
        except Exception:
            _log.exception("shard conn-closed callback failed")

    def _worker_gone(self, shard: int) -> None:
        w = self._workers.pop(shard, None)
        if w is None:
            return
        loop = asyncio.get_running_loop()
        try:
            loop.remove_reader(w.sock.fileno())
        except (OSError, ValueError):
            pass
        try:
            w.sock.close()
        except OSError:
            pass
        # Every conn this shard held is gone with it: release the slots
        # so the remotes can redial (onto another shard or the main loop).
        for cid, (owner, desc) in list(self._conns.items()):
            if owner is w:
                self._conns.pop(cid, None)
                proxy = self._proxies.pop(cid, None)
                if proxy is not None:
                    # No blacklist: worker death is OUR fault, not the
                    # peer's -- the dispatcher drops + requeues.
                    proxy.on_remote_closed("worker_exit", False)
                else:
                    self._safe_conn_closed(desc, "worker_exit", False)
        self._fail_writes(w, "leech worker exited mid-write")
        if w.ring is not None:
            # Best-effort unmap; in-flight views keep the pages alive
            # until verify finishes with them. The respawn maps fresh.
            w.ring.close()
        expected = w.retiring or self._stopping
        if not expected:
            self._c_crashes.inc(shard=w.label)
            _log.warning(
                "data-plane shard died unexpectedly; respawning",
                extra={"shard": shard, "pid": w.proc.pid},
            )

        t = asyncio.create_task(self._reap(w, shard, expected))
        self._reap_tasks.add(t)
        t.add_done_callback(self._reap_tasks.discard)
        self._g_alive.set(self.alive_workers, component=self.component)

    async def _reap(self, w: _Worker, shard: int, expected: bool) -> None:
        def _join() -> None:
            w.proc.join(2.0)
            if w.proc.is_alive():  # pragma: no cover
                w.proc.terminate()
                w.proc.join(1.0)

        await asyncio.to_thread(_join)
        _note_exit(w, expected)
        try:
            w.proc.close()
        except (OSError, ValueError):  # pragma: no cover
            pass  # close() raises ValueError while still alive
        # Respawn on crash, but ALSO when a retiring shard exits while
        # the target has grown back over it (shrink-then-grow race: the
        # grow saw the old shard still in the table and spawned nothing,
        # so this exit is the only chance to restore the pool size).
        if (
            not self._stopping
            and shard < self._target
            and shard not in self._workers
        ):
            self._spawn(shard)

    # -- introspection (sentinel / tests) ----------------------------------

    @property
    def alive_workers(self) -> int:
        return sum(1 for w in self._workers.values() if w.proc.is_alive())

    @property
    def expected_workers(self) -> int:
        return self._target

    def worker_info(self) -> list[dict]:
        """Per-shard pid/liveness/conn snapshot for the resource sentinel
        (child fd+RSS aggregation, crash reap-check) and /debug surfaces."""
        return [
            {
                "shard": w.shard,
                "pid": w.proc.pid,
                "alive": w.proc.is_alive(),
                "retiring": w.retiring,
                "conns": w.conns,
                "cpu_s": w.cpu_s,
            }
            for w in sorted(self._workers.values(), key=lambda w: w.shard)
        ]
