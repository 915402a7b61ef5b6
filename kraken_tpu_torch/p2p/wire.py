"""P2P wire protocol: length-prefixed frames, msgpack headers, raw payloads.

Message set mirrored from uber/kraken ``proto/p2p/p2p.proto`` (BITFIELD,
PIECE_REQUEST, PIECE_PAYLOAD, ANNOUNCE_PIECE, CANCEL_PIECE, COMPLETE,
ERROR; piece bytes framed after the message) -- upstream path, unverified;
SURVEY.md SS2.2. Framing is hand-rolled rather than protobuf: a fixed
9-byte prefix + msgpack header keeps zero codegen and lets the payload ride
as one contiguous slice (no protobuf copy of 4 MiB pieces). The headers go
through the port's own codec (:mod:`kraken_tpu_torch.utils.msgpack_lite`),
whose bytes equal the ``msgpack`` package's, so the frames equal
``kraken_tpu.p2p.wire``'s byte for byte.

Frame layout (all ints big-endian):

    u8  type | u32 header_len | u32 payload_len | header | payload

Handshake exchange happens first on every conn, as HANDSHAKE frames.

Zero-copy recv: with a :class:`~kraken_tpu_torch.utils.bufpool.
BufferPool`, PIECE_PAYLOAD bytes are read straight into a leased,
recycled buffer -- no per-piece payload allocation and no
``raw[header_len:]`` slice copy -- and ``Message.payload`` is a writable
``memoryview`` that flows through verify and ``os.pwrite`` untouched.
The lease rides on ``Message.lease``; whoever consumes the payload calls
:meth:`Message.release` exactly once (idempotent) after the last read.

Corked vectored send: :func:`send_messages` writes a whole batch of
frames with ONE ``drain()`` -- control frames coalesce into a single
``writelines`` buffer, payloads are appended without an extra copy --
so the send loop pays the event-loop future machinery per batch, not
per frame.
"""

from __future__ import annotations

import asyncio
import enum
from typing import Any, Iterable, Optional

from kraken_tpu_torch.utils import msgpack_lite
from kraken_tpu_torch.utils.bufpool import BufferPool, Lease

MAX_HEADER = 1 << 20
MAX_PAYLOAD = 1 << 26  # 64 MiB -- piece length upper bound

# Control frames below this ride in the coalesced writelines buffer (one
# small concat beats N transport appends); payloads at or above it are
# handed to the transport as-is, avoiding a batch-sized join copy.
_COALESCE_CUTOFF = 16 << 10


class MsgType(enum.IntEnum):
    HANDSHAKE = 0
    BITFIELD = 1
    PIECE_REQUEST = 2
    PIECE_PAYLOAD = 3
    ANNOUNCE_PIECE = 4
    CANCEL_PIECE = 5
    COMPLETE = 6
    ERROR = 7
    PEER_EXCHANGE = 8


class WireError(Exception):
    pass


class PayloadOversizeError(WireError):
    """A PIECE_PAYLOAD frame longer than the handshaken torrent's piece
    length (or the absolute MAX_PAYLOAD cap). Raised BEFORE the payload
    is buffered, so a hostile peer cannot balloon RSS; the conn plane
    treats it as misbehavior (escalating blacklist), not connectivity."""


class Message:
    """One protocol frame: typed header dict + optional raw payload.

    ``payload`` is ``bytes`` for control frames and (on the pooled recv
    path) a ``memoryview`` into a leased buffer for PIECE_PAYLOAD;
    ``release()`` returns that buffer to its pool and is a no-op for
    unpooled messages, so consumers call it unconditionally."""

    __slots__ = ("type", "header", "payload", "lease")

    def __init__(
        self,
        type: MsgType,
        header: dict | None = None,
        payload: bytes | memoryview = b"",
        lease: Optional[Lease] = None,
    ):
        self.type = type
        self.header = header or {}
        self.payload = payload
        self.lease = lease

    def release(self) -> None:
        lease, self.lease = self.lease, None
        if lease is not None:
            # The view dies with the lease; drop our reference first so a
            # late reader gets b"" length math, not a released-view error.
            self.payload = b""
            lease.release()

    def __repr__(self) -> str:
        return f"Message({self.type.name}, {self.header}, payload={len(self.payload)}B)"

    # -- constructors for each message of the set --------------------------

    @classmethod
    def handshake(
        cls, peer_id: str, info_hash: str, name: str, namespace: str,
        bitfield: bytes, num_pieces: int, traceparent: str = "",
        listen_port: int = 0,
    ) -> "Message":
        """``name`` is the blob digest hex -- carried alongside the info
        hash so the accepting side can load its stored metainfo directly
        (no reverse info-hash index needed). ``traceparent`` (dial side
        only) lets the accepting node's serve spans join the dialer's
        trace (utils/trace.py); absent for peers without an active
        trace. ``listen_port`` is this side's p2p LISTEN port (an inbound
        conn's transport port is ephemeral) -- it gives the remote a
        dialable addr to gossip over PEX; 0 omits the key (older peers
        tolerate its absence the same way)."""
        header = {
            "peer_id": peer_id,
            "info_hash": info_hash,
            "name": name,
            "namespace": namespace,
            "num_pieces": num_pieces,
        }
        if traceparent:
            header["tp"] = traceparent
        if listen_port:
            header["lp"] = listen_port
        return cls(MsgType.HANDSHAKE, header, payload=bitfield)

    @classmethod
    def bitfield(cls, bits: bytes, num_pieces: int) -> "Message":
        return cls(MsgType.BITFIELD, {"num_pieces": num_pieces}, payload=bits)

    @classmethod
    def piece_request(cls, index: int, traceparent: str | None = None) -> "Message":
        """``traceparent`` joins the request to the leecher's SAMPLED
        trace, so the remote's serve span (dispatcher or shardpool
        worker) lands in the same tree; omitted on unsampled traces --
        the serve side then creates no span at all."""
        header: dict = {"index": index}
        if traceparent:
            header["tp"] = traceparent
        return cls(MsgType.PIECE_REQUEST, header)

    @classmethod
    def piece_payload(cls, index: int, data: bytes) -> "Message":
        return cls(MsgType.PIECE_PAYLOAD, {"index": index}, payload=data)

    @classmethod
    def announce_piece(cls, index: int) -> "Message":
        return cls(MsgType.ANNOUNCE_PIECE, {"index": index})

    @classmethod
    def cancel_piece(cls, index: int) -> "Message":
        return cls(MsgType.CANCEL_PIECE, {"index": index})

    @classmethod
    def complete(cls) -> "Message":
        return cls(MsgType.COMPLETE)

    @classmethod
    def error(cls, code: str, detail: str = "") -> "Message":
        return cls(MsgType.ERROR, {"code": code, "detail": detail})

    @classmethod
    def peer_exchange(cls, added: list[dict], dropped: list[str]) -> "Message":
        """Gossip frame (PEX): compact per-torrent peer deltas riding an
        existing conn. ``added`` entries are dicts with short keys --
        ``id`` (peer id hex), ``ip``, ``p`` (listen port), ``o`` (origin
        flag, omitted when false) -- ``dropped`` is peer id hexes the
        sender no longer has conns to. The torrent is implied by the conn
        the frame rides on (conns are per-info-hash)."""
        return cls(MsgType.PEER_EXCHANGE, {"a": added, "d": dropped})


def frame_head(mtype: int, header: bytes, payload_len: int) -> bytes:
    """The 9-byte prefix + packed header of one frame -- the single
    definition of the wire layout. Shared by the stream send path here
    and the shardpool workers' raw-socket paths (seed serves and the
    leech plane's parent-authored control frames), so the framing can
    never skew between the main loop and the forked halves."""
    return (
        bytes([mtype])
        + len(header).to_bytes(4, "big")
        + payload_len.to_bytes(4, "big")
        + header
    )


def frame_bytes(mtype: int, header: dict, payload: bytes = b"") -> bytes:
    """One fully-encoded frame from its parts (control frames only --
    payload rides inline, so callers keep it small)."""
    packed = msgpack_lite.packb(header)
    return frame_head(mtype, packed, len(payload)) + payload


def _head(msg: Message, header: bytes) -> bytes:
    return frame_head(msg.type, header, len(msg.payload))


async def send_messages(
    writer: asyncio.StreamWriter, msgs: Iterable[Message]
) -> None:
    """Write every frame in ``msgs`` and drain ONCE.

    Small frames (prefix+header, control payloads) collect into one
    ``writelines`` call -- a single transport append for the whole run of
    control traffic riding a payload batch. Piece payloads are written
    as-is: the transport buffers the existing bytes/memoryview, so the
    batch costs zero payload copies on this side of the socket.
    """
    small: list[bytes] = []
    for msg in msgs:
        header = msgpack_lite.packb(msg.header)
        small.append(_head(msg, header))
        payload = msg.payload
        if payload:
            if len(payload) < _COALESCE_CUTOFF:
                small.append(bytes(payload))
            else:
                if small:
                    writer.writelines(small)
                    small = []
                writer.write(payload)
    if small:
        writer.writelines(small)
    await writer.drain()


async def send_message(writer: asyncio.StreamWriter, msg: Message) -> None:
    await send_messages(writer, (msg,))


async def _readinto_exactly(
    reader: asyncio.StreamReader, view: memoryview
) -> None:
    """``readexactly`` into a caller-owned buffer.

    asyncio's StreamReader has no public readinto, and ``readexactly``
    materializes a fresh payload-sized ``bytes`` per call -- the exact
    per-piece allocation the bufpool exists to remove. This drains the
    reader's internal buffer straight into ``view`` using the same
    private fields ``readexactly`` itself uses (``_buffer``, ``_eof``,
    ``_wait_for_data``, ``_maybe_resume_transport`` -- stable across
    CPython 3.8-3.12); if an exotic reader lacks them we fall back to
    readexactly + copy (correct, one transient allocation).
    """
    n = len(view)
    if not (
        hasattr(reader, "_buffer")
        and hasattr(reader, "_eof")
        and hasattr(reader, "_wait_for_data")
        and hasattr(reader, "_maybe_resume_transport")
    ):  # pragma: no cover - non-CPython readers
        view[:] = await reader.readexactly(n)
        return
    pos = 0
    while pos < n:
        exc = reader.exception()
        if exc is not None:
            raise exc
        if reader._buffer:
            take = min(len(reader._buffer), n - pos)
            with memoryview(reader._buffer) as mv:
                view[pos : pos + take] = mv[:take]
            del reader._buffer[:take]
            reader._maybe_resume_transport()
            pos += take
        elif reader._eof:
            raise asyncio.IncompleteReadError(bytes(view[:pos]), n)
        else:
            await reader._wait_for_data("_readinto_exactly")


async def recv_message(
    reader: asyncio.StreamReader,
    pool: Optional[BufferPool] = None,
    max_payload: int = MAX_PAYLOAD,
) -> Message:
    """Read one frame. With ``pool``, PIECE_PAYLOAD bytes land in a
    leased buffer (``Message.payload`` is a memoryview, ``Message.lease``
    owns the return); without, behavior matches the classic bytes path.

    ``max_payload`` tightens the PIECE_PAYLOAD bound to the handshaken
    torrent's piece length; violations raise :class:`PayloadOversizeError`
    BEFORE any payload byte is buffered.
    """
    try:
        prefix = await reader.readexactly(9)
    except asyncio.IncompleteReadError as e:
        raise WireError("connection closed") from e
    mtype = prefix[0]
    header_len = int.from_bytes(prefix[1:5], "big")
    payload_len = int.from_bytes(prefix[5:9], "big")
    try:
        t = MsgType(mtype)
    except ValueError:
        raise WireError(f"unknown message type {mtype}") from None
    if t == MsgType.PIECE_PAYLOAD and payload_len > min(max_payload, MAX_PAYLOAD):
        raise PayloadOversizeError(
            f"piece payload {payload_len} exceeds limit "
            f"{min(max_payload, MAX_PAYLOAD)}"
        )
    if header_len > MAX_HEADER or payload_len > MAX_PAYLOAD:
        raise WireError(f"oversized frame: header={header_len} payload={payload_len}")
    try:
        raw_header = await reader.readexactly(header_len) if header_len else b""
    except asyncio.IncompleteReadError as e:
        raise WireError("connection closed mid-frame") from e
    try:
        header: Any = msgpack_lite.unpackb(raw_header) if header_len else {}
    except Exception as e:
        # The codec raises ValueError (truncation, trailing bytes, bad
        # UTF-8, non-str keys, ext types) and UnicodeDecodeError, a
        # ValueError; to the conn plane each is one thing: a malformed
        # frame from a bad peer.
        raise WireError(f"malformed header: {e}") from e
    if not isinstance(header, dict):
        raise WireError("malformed header")
    lease: Optional[Lease] = None
    if payload_len == 0:
        payload: bytes | memoryview = b""
    elif pool is not None and t == MsgType.PIECE_PAYLOAD:
        lease = pool.lease(payload_len)
        try:
            await _readinto_exactly(reader, lease.view)
        except asyncio.IncompleteReadError as e:
            lease.release()
            raise WireError("connection closed mid-frame") from e
        except BaseException:
            lease.release()
            raise
        payload = lease.view
    else:
        try:
            payload = await reader.readexactly(payload_len)
        except asyncio.IncompleteReadError as e:
            raise WireError("connection closed mid-frame") from e
    return Message(t, header, payload, lease=lease)
