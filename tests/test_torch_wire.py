"""The port's P2P wire and its building blocks, held against
``kraken_tpu``: every message type frames byte for byte as the JAX wire
does and each package reads the other's frames; the oversize, truncation
and fuzz cases of the JAX wire tests run against the port; the
connstate, piecerequest, backoff and bandwidth unit cases run against
the port; and the request policies pick the same pieces in both
packages."""

import asyncio
import os
import random
import types

import msgpack
import numpy as np
import pytest

import kraken_tpu.core.metainfo as jax_metainfo
import kraken_tpu.core.peer as jax_peer
import kraken_tpu.p2p.connstate as jax_connstate
import kraken_tpu.p2p.piecerequest as jax_piecerequest
import kraken_tpu.p2p.wire as jax_wire
import kraken_tpu.utils.backoff as jax_backoff
import kraken_tpu.utils.bandwidth as jax_bandwidth
import kraken_tpu.utils.bufpool as jax_bufpool
import kraken_tpu_torch.core.metainfo as port_metainfo
import kraken_tpu_torch.core.peer as port_peer
import kraken_tpu_torch.p2p.connstate as port_connstate
import kraken_tpu_torch.p2p.piecerequest as port_piecerequest
import kraken_tpu_torch.p2p.wire as port_wire
import kraken_tpu_torch.utils.backoff as port_backoff
import kraken_tpu_torch.utils.bandwidth as port_bandwidth
import kraken_tpu_torch.utils.bufpool as port_bufpool
from kraken_tpu_torch.p2p.wire import (
    Message,
    MsgType,
    PayloadOversizeError,
    WireError,
    recv_message,
    send_message,
)
from kraken_tpu_torch.utils.bufpool import BufferPool

PACKAGES = {
    "kraken_tpu": types.SimpleNamespace(
        wire=jax_wire, peer=jax_peer, metainfo=jax_metainfo, connstate=jax_connstate,
        piecerequest=jax_piecerequest, backoff=jax_backoff, bandwidth=jax_bandwidth,
        bufpool=jax_bufpool,
    ),
    "kraken_tpu_torch": types.SimpleNamespace(
        wire=port_wire, peer=port_peer, metainfo=port_metainfo, connstate=port_connstate,
        piecerequest=port_piecerequest, backoff=port_backoff, bandwidth=port_bandwidth,
        bufpool=port_bufpool,
    ),
}


# The unit cases run on the port, with the values the reference's own
# cases (tests/test_p2p_units.py) expect; PACKAGES serves the cases that
# compare the two packages.
port = PACKAGES["kraken_tpu_torch"]


class Sink:
    """StreamWriter-shaped byte sink for offline framing."""

    def __init__(self):
        self.buf = bytearray()

    def write(self, b):
        self.buf += b

    def writelines(self, bufs):
        for b in bufs:
            self.buf += b

    async def drain(self):
        pass


async def frame_bytes(*msgs, wire=port_wire) -> bytes:
    sink = Sink()
    await wire.send_messages(sink, msgs)
    return bytes(sink.buf)


async def feed(raw: bytes, pool=None, max_payload=None, wire=port_wire):
    reader = asyncio.StreamReader()
    reader.feed_data(raw)
    reader.feed_eof()
    return await wire.recv_message(
        reader, pool=pool,
        max_payload=wire.MAX_PAYLOAD if max_payload is None else max_payload,
    )


# -- frames, byte for byte ---------------------------------------------------

TP = "00-" + "0123456789abcdef" * 2 + "-" + "fedcba9876543210" + "-01"
_rng = np.random.default_rng(5)
CONSTRUCTORS = {
    MsgType.HANDSHAKE: [
        ("handshake", ("ab" * 20, "cd" * 32, "ef" * 32, "ns", b"\xff\x01", 10), {}),
        ("handshake", ("ab" * 20, "cd" * 32, "ef" * 32, "ns/é", b"", 70_000),
         {"traceparent": TP, "listen_port": 7611}),
    ],
    MsgType.BITFIELD: [("bitfield", (b"\x0f", 4), {}), ("bitfield", (bytes(300), 2400), {})],
    MsgType.PIECE_REQUEST: [("piece_request", (7,), {}), ("piece_request", (1 << 20, TP), {})],
    MsgType.PIECE_PAYLOAD: [
        ("piece_payload", (0, b""), {}),
        ("piece_payload", (65536, _rng.integers(0, 256, 100_000, dtype=np.uint8).tobytes()), {}),
    ],
    MsgType.ANNOUNCE_PIECE: [("announce_piece", (127,), {}), ("announce_piece", (128,), {})],
    MsgType.CANCEL_PIECE: [("cancel_piece", (3,), {}), ("cancel_piece", (70_000,), {})],
    MsgType.COMPLETE: [("complete", (), {})],
    MsgType.ERROR: [("error", ("busy",), {}), ("error", ("bad", "try later " * 20), {})],
    MsgType.PEER_EXCHANGE: [
        ("peer_exchange", ([{"id": "ab" * 20, "ip": "10.0.0.1", "p": 7611, "o": 1}],
                           ["cd" * 20]), {}),
        ("peer_exchange", ([{"id": f"{i:040x}", "ip": "203.0.113.1", "p": i + 1}
                            for i in range(40)], []), {}),
    ],
}


def test_every_message_type_has_cases():
    assert set(CONSTRUCTORS) == set(MsgType) == {
        jax_wire.MsgType(t.value) for t in MsgType
    }
    assert [t.name for t in MsgType] == [t.name for t in jax_wire.MsgType]


@pytest.mark.parametrize("mtype", list(MsgType), ids=lambda t: t.name)
def test_frames_equal_the_jax_wire_and_cross_read(mtype):
    async def main():
        for ctor, args, kw in CONSTRUCTORS[mtype]:
            port_msg = getattr(port_wire.Message, ctor)(*args, **kw)
            jax_msg = getattr(jax_wire.Message, ctor)(*args, **kw)
            assert int(port_msg.type) == int(jax_msg.type) == mtype.value
            ours = await frame_bytes(port_msg, wire=port_wire)
            theirs = await frame_bytes(jax_msg, wire=jax_wire)
            assert ours == theirs
            assert ours[9:9 + int.from_bytes(ours[1:5], "big")] == msgpack.packb(jax_msg.header)
            # Each package reads the other's frame.
            for reader_wire, raw, sent in ((port_wire, theirs, jax_msg),
                                           (jax_wire, ours, port_msg)):
                got = await feed(raw, wire=reader_wire)
                assert int(got.type) == mtype.value
                assert got.header == sent.header
                assert bytes(got.payload) == bytes(sent.payload)

    asyncio.run(main())


def test_pooled_recv_reads_jax_payloads_into_a_lease():
    async def main():
        pool = BufferPool()
        payload = os.urandom(5000)
        raw = await frame_bytes(jax_wire.Message.piece_payload(3, payload), wire=jax_wire)
        got = await feed(raw, pool=pool)
        assert isinstance(got.payload, memoryview) and bytes(got.payload) == payload
        assert pool.leased == 1
        got.release()
        got.release()  # idempotent
        assert pool.leased == 0

    asyncio.run(main())


def test_send_messages_corks_a_batch_like_the_jax_wire():
    async def main():
        msgs = [
            ("piece_payload", (i, os.urandom(n))) for i, n in enumerate((0, 1, 16 << 10, 20_000))
        ] + [("announce_piece", (9,)), ("complete", ())]
        ours = await frame_bytes(*(getattr(Message, c)(*a) for c, a in msgs))
        theirs = await frame_bytes(*(getattr(jax_wire.Message, c)(*a) for c, a in msgs),
                                   wire=jax_wire)
        assert ours == theirs
        reader = asyncio.StreamReader()
        reader.feed_data(ours)
        reader.feed_eof()
        for c, a in msgs:
            got = await recv_message(reader)
            assert got.header == getattr(Message, c)(*a).header

    asyncio.run(main())


def test_wire_roundtrip_over_loopback_and_unknown_type():
    async def main():
        got = []

        async def handler(reader, writer):
            try:
                while True:
                    got.append(await recv_message(reader))
            except WireError:
                writer.close()

        server = await asyncio.start_server(handler, "127.0.0.1", 0)
        port = server.sockets[0].getsockname()[1]
        _reader, writer = await asyncio.open_connection("127.0.0.1", port)
        msgs = [getattr(Message, c)(*a, **k) for cases in CONSTRUCTORS.values()
                for c, a, k in cases]
        for m in msgs:
            await send_message(writer, m)
        writer.write(bytes([99]) + bytes(8))  # unknown type ends the stream
        await writer.drain()
        await asyncio.sleep(0.2)
        writer.close()
        server.close()
        await server.wait_closed()
        assert [m.type for m in got] == [m.type for m in msgs]
        for sent, recv in zip(msgs, got):
            assert recv.header == sent.header and recv.payload == sent.payload

    asyncio.run(main())


# -- oversize and truncation (the JAX wire-plane cases, against the port) ----


def test_max_header_exact_and_off_by_one(monkeypatch):
    monkeypatch.setattr(port_wire, "MAX_HEADER", 256)

    def frame_with_header_len(target: int) -> bytes:
        pad = target - len(msgpack.packb({"p": ""}))
        while len(msgpack.packb({"p": "x" * pad})) > target:
            pad -= 1
        header = msgpack.packb({"p": "x" * pad})
        assert len(header) == target
        return (
            bytes([MsgType.PIECE_REQUEST]) + len(header).to_bytes(4, "big")
            + (0).to_bytes(4, "big") + header
        )

    async def main():
        got = await feed(frame_with_header_len(256))
        assert got.type == MsgType.PIECE_REQUEST
        with pytest.raises(WireError):
            await feed(frame_with_header_len(257))

    asyncio.run(main())


def test_max_payload_exact_and_off_by_one(monkeypatch):
    monkeypatch.setattr(port_wire, "MAX_PAYLOAD", 1 << 16)

    async def main():
        got = await feed(await frame_bytes(Message.piece_payload(0, b"x" * (1 << 16))))
        assert len(got.payload) == 1 << 16
        over = await frame_bytes(Message.piece_payload(0, b"x" * ((1 << 16) + 1)))
        with pytest.raises(PayloadOversizeError):
            await feed(over)
        raw = bytes([MsgType.BITFIELD]) + (0).to_bytes(4, "big") + ((1 << 16) + 1).to_bytes(4, "big")
        with pytest.raises(WireError):
            await feed(raw)

    asyncio.run(main())


def test_truncation_at_every_boundary():
    async def main():
        raw = await frame_bytes(Message.piece_payload(3, os.urandom(100)))
        header_len = int.from_bytes(raw[1:5], "big")
        cuts = list(range(1, 9))
        cuts += [9 + header_len // 2, 9 + header_len]
        cuts += [9 + header_len + 1, len(raw) - 1]
        pool = BufferPool()
        for cut in cuts:
            with pytest.raises(WireError):
                await feed(raw[:cut], pool=pool)
            assert pool.leased == 0, f"lease leaked at cut {cut}"

    asyncio.run(main())


def test_payload_oversize_rejected_before_buffering():
    async def main():
        pool = BufferPool()
        header = msgpack.packb({"index": 0})
        raw = (
            bytes([MsgType.PIECE_PAYLOAD]) + len(header).to_bytes(4, "big")
            + (1 << 20).to_bytes(4, "big") + header
        )
        reader = asyncio.StreamReader()
        reader.feed_data(raw)  # no EOF: a read past the prefix would hang
        with pytest.raises(PayloadOversizeError):
            await asyncio.wait_for(recv_message(reader, pool=pool, max_payload=64 << 10), 2.0)
        assert pool.leased == 0 and pool.hits + pool.misses == 0

    asyncio.run(main())


@pytest.mark.parametrize("header", [
    b"\x92\x01",  # truncated
    b"\x80\x01",  # trailing bytes
    b"\x81\xa2\xff\xfe\x01",  # bad UTF-8
    b"\x81\x01\x02",  # a non-str key
    b"\xd4\x01\x02",  # an ext type
    b"\x91\x01",  # not a map
    b"\xc1",  # reserved
])
def test_every_decode_error_becomes_wire_error(header):
    raw = bytes([MsgType.PIECE_REQUEST]) + len(header).to_bytes(4, "big") + bytes(4) + header
    with pytest.raises(WireError):
        asyncio.run(feed(raw))


def test_wire_fuzz_corrupt_frames_raise_wireerror():
    """Arbitrary bytes on the wire surface as WireError, never as codec
    or struct internals."""
    rng = np.random.default_rng(11)

    async def main():
        for n in (0, 1, 8, 9, 64, 4096):
            for _ in range(50):
                try:
                    await feed(rng.integers(0, 256, size=n, dtype=np.uint8).tobytes())
                except WireError:
                    pass
        for msg in (
            Message.handshake("ab" * 20, "cd" * 32, "ef" * 32, "ns", b"\x01", 8),
            Message.piece_payload(3, b"x" * 100),
            Message.error("busy", "full"),
            Message.peer_exchange([{"id": "ab" * 20, "ip": "10.0.0.1", "p": 1}], []),
        ):
            raw = await frame_bytes(msg)
            assert isinstance(await feed(raw), Message)
            for _ in range(200):
                b = bytearray(raw)
                b[int(rng.integers(0, len(b)))] ^= int(rng.integers(1, 256))
                try:
                    await feed(bytes(b))
                except WireError:
                    pass

    asyncio.run(main())


# -- connstate, piecerequest, backoff, bandwidth: the port ------------------


def pid(pkg, i: int):
    return pkg.peer.PeerID((bytes([i]) * 20).hex())


def ih(pkg, i: int):
    return pkg.metainfo.InfoHash((bytes([i]) * 32).hex())


def test_connstate_per_torrent_limit():
    cs = port.connstate.ConnState(port.connstate.ConnStateConfig(max_open_conns_per_torrent=2))
    h = ih(port, 1)
    assert cs.add_pending(pid(port, 1), h)
    assert cs.add_pending(pid(port, 2), h)
    assert not cs.add_pending(pid(port, 3), h)
    assert cs.promote(pid(port, 1), h)
    cs.remove(pid(port, 2), h)
    assert cs.add_pending(pid(port, 3), h)


def test_connstate_no_duplicate_dials():
    cs = port.connstate.ConnState()
    h = ih(port, 1)
    assert cs.add_pending(pid(port, 1), h)
    assert not cs.add_pending(pid(port, 1), h)
    cs.promote(pid(port, 1), h)
    assert not cs.add_pending(pid(port, 1), h)


def test_connstate_global_limit():
    cs = port.connstate.ConnState(
        port.connstate.ConnStateConfig(max_global_conns=2, max_open_conns_per_torrent=5))
    assert cs.add_pending(pid(port, 1), ih(port, 1))
    assert cs.add_pending(pid(port, 2), ih(port, 2))
    assert not cs.add_pending(pid(port, 3), ih(port, 3))


def test_blacklist_backoff_expiry():
    cfg = port.connstate.ConnStateConfig()
    cfg.blacklist_backoff = port.backoff.Backoff(base_seconds=10, factor=2, max_seconds=100, jitter=0)
    cs = port.connstate.ConnState(cfg)
    h = ih(port, 1)
    cs.blacklist.add(pid(port, 1), h, now=0.0)
    assert cs.blacklist.blocked(pid(port, 1), h, now=5.0)
    assert not cs.blacklist.blocked(pid(port, 1), h, now=11.0)
    cs.blacklist.add(pid(port, 1), h, now=11.0)  # repeat offense: 20 s
    assert cs.blacklist.blocked(pid(port, 1), h, now=25.0)
    assert not cs.blacklist.blocked(pid(port, 1), h, now=32.0)
    assert cs.can_dial(pid(port, 2), h)


def test_blacklist_bounded_under_torrent_churn():
    cfg = port.connstate.ConnStateConfig()
    cfg.blacklist_backoff = port.backoff.Backoff(base_seconds=1, factor=2, max_seconds=10, jitter=0)
    cs = port.connstate.ConnState(cfg)
    bl = cs.blacklist

    def ihx(i):
        return port.metainfo.InfoHash(f"{i:064x}")

    for i in range(2000):
        bl.add(pid(port, i % 50), ihx(i), now=float(i) * 0.001)
    assert len(bl._entries) == 2000
    for i in range(bl._EXPUNGE_EVERY + 1):
        bl.add(pid(port, i % 50), ihx(10_000 + i), now=10_000.0)
    assert len(bl._entries) <= 2 * bl._EXPUNGE_EVERY
    h, h2 = ihx(12345), ihx(12346)
    bl.add(pid(port, 1), h, now=10_000.0)
    bl.add(pid(port, 1), h2, now=10_000.0)
    cs.clear_torrent(h)
    assert bl.blocked(pid(port, 1), h, now=10_000.5)
    assert bl.blocked(pid(port, 1), h2, now=10_000.5)
    bl2 = port.connstate.ConnState(cfg).blacklist
    bl2.add(pid(port, 1), ih(port, 1), now=0.0)
    for i in range(bl2._EXPUNGE_EVERY + 1):
        bl2.add(pid(port, 2), ih(port, 2), now=5.0)
    assert (pid(port, 1), ih(port, 1)) in bl2._entries
    bl2.add(pid(port, 1), ih(port, 1), now=5.0)
    assert bl2._entries[(pid(port, 1), ih(port, 1))][1] == 2


def test_request_manager_pipeline_and_dedup():
    rm = port.piecerequest.RequestManager(policy="rarest_first", pipeline_limit=2)
    missing = [0, 1, 2, 3]
    avail = {0: 3, 1: 1, 2: 2, 3: 1}
    got = rm.select(pid(port, 1), {0, 1, 2, 3}, missing, avail, now=0.0)
    assert set(got) == {1, 3}
    assert rm.select(pid(port, 1), {0, 1, 2, 3}, missing, avail, now=0.0) == []
    assert set(rm.select(pid(port, 2), {0, 1, 2, 3}, missing, avail, now=0.0)) == {0, 2}


def test_request_manager_timeout_requeues():
    rm = port.piecerequest.RequestManager(pipeline_limit=4, timeout_seconds=5)
    rm.select(pid(port, 1), {0}, [0], {}, now=0.0)
    assert rm.select(pid(port, 2), {0}, [0], {}, now=1.0) == []
    assert rm.select(pid(port, 2), {0}, [0], {}, now=2.0) == [0]
    assert rm.select(pid(port, 1), {0}, [0], {}, now=20.0) == [0]


def test_request_manager_adaptive_hard_expiry_under_storm():
    rm = port.piecerequest.RequestManager(pipeline_limit=4, timeout_seconds=2.0)
    for i in range(20):
        rm.mark_sent(i, pid(port, 1), now=float(i))
        rm.clear_piece(i, now=float(i) + 10.0)
    rm.mark_sent(100, pid(port, 2), now=100.0)
    assert rm.pending_for(pid(port, 2), now=104.0) == [100]
    assert rm.pending_for(pid(port, 2), now=119.5) == [100]
    assert rm.pending_for(pid(port, 2), now=121.0) == []
    assert rm.select(pid(port, 3), {100}, [100], {}, now=121.0) == [100]


def test_request_manager_endgame_duplicates():
    rm = port.piecerequest.RequestManager(pipeline_limit=4)
    assert sorted(rm.select(pid(port, 1), {0, 1}, [0, 1], {}, now=0.0)) == [0, 1]
    assert rm.select(pid(port, 2), {0, 1}, [0, 1], {}, now=0.0) == []
    got = rm.select(pid(port, 2), {0, 1}, [0, 1], {}, now=3.0)
    assert set(got) <= {0, 1} and got
    assert rm.select(pid(port, 3), {0, 1}, [0, 1], {}, now=3.5) == []
    rm.clear_piece(0)
    assert 0 in rm.select(pid(port, 3), {0}, [0], {}, now=3.5)


@pytest.mark.parametrize("policy", ["rarest_first", "random"])
def test_request_policies_agree_across_packages(policy):
    """The same seeded selection sequence gives the same picks."""
    picks = []
    for pkg in PACKAGES.values():
        random.seed(7)
        rm = pkg.piecerequest.RequestManager(policy=policy, pipeline_limit=3)
        rng = np.random.default_rng(3)
        seq = []
        for step in range(30):
            have = {int(i) for i in rng.integers(0, 40, 25)}
            avail = {i: int(rng.integers(1, 9)) for i in range(40)}
            got = rm.select(pid(pkg, step % 4), have, list(range(40)), avail, now=float(step))
            seq.append(got)
            for i in got[:1]:
                rm.clear_piece(i, now=float(step) + 0.5)
        picks.append(seq)
    assert picks[0] == picks[1]
    assert sum(map(len, picks[0])) > 30


@pytest.mark.parametrize("attempt", range(6))
def test_backoff_delays(attempt):
    b = port.backoff.Backoff(base_seconds=0.5, factor=3, max_seconds=20, jitter=0)
    assert b.delay(attempt) == min(20, 0.5 * 3 ** attempt)
    j = port.backoff.Backoff(base_seconds=1, factor=2, max_seconds=8, jitter=0.5)
    assert 0 <= j.delay(attempt) <= min(8, 2 ** attempt) * 1.5


def test_decorrelated_jitter_bounds():
    jit = port.backoff.DecorrelatedJitter(base_seconds=0.5, max_seconds=4.0)
    prev = 0.0
    for _ in range(200):
        prev = jit.next(prev)
        assert 0.5 <= prev <= 4.0


def test_token_bucket_try_acquire():
    tb = port.bandwidth.TokenBucket(rate=1000, capacity=100)
    assert tb.try_acquire(100)
    assert not tb.try_acquire(50)


def test_bandwidth_limiter_shapes_transfers():
    async def main():
        lim = port.bandwidth.BandwidthLimiter(ingress_bps=400_000, egress_bps=0, burst=10_000)
        loop = asyncio.get_running_loop()
        t0 = loop.time()
        for _ in range(5):
            await lim.recv(10_000)
        await lim.send(10**9)  # unlimited egress never waits
        return loop.time() - t0

    # 50 kB at 400 kB/s after a 10 kB burst: >= ~0.1 s.
    assert asyncio.run(main()) >= 0.08
