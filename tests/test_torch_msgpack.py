"""The port's MessagePack codec (``kraken_tpu_torch.utils.msgpack_lite``)
held byte for byte against the ``msgpack`` package: hypothesis-generated
headers of every type the wire sends, every width boundary, every header
the JAX wire's ``Message`` constructors build, and the inputs that must
raise."""

import math
import struct

import msgpack
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from kraken_tpu.p2p.wire import Message
from kraken_tpu_torch.utils.msgpack_lite import packb, unpackb


def same(obj):
    """packb == msgpack.packb, and both decoders agree on those bytes."""
    want = msgpack.packb(obj)
    assert packb(obj) == want
    got = unpackb(want)
    assert got == msgpack.unpackb(want)
    return got


# The widths where msgpack switches form: each boundary and its neighbours.
INT_EDGES = sorted({
    v + d
    for v in (0, 0x7F, 0xFF, 0xFFFF, 0xFFFFFFFF, 0xFFFFFFFFFFFFFFFF,
              -32, -0x80, -0x8000, -0x80000000, -0x8000000000000000)
    for d in (-1, 0, 1)
    if -0x8000000000000000 <= v + d <= 0xFFFFFFFFFFFFFFFF
})
LEN_EDGES = (0, 1, 15, 16, 31, 32, 255, 256, 65535, 65536)


@pytest.mark.parametrize("n", INT_EDGES)
def test_ints_take_the_smallest_form_at_every_width_boundary(n):
    assert same(n) == n


@pytest.mark.parametrize("n", LEN_EDGES)
@pytest.mark.parametrize("kind", ["str", "bin", "array", "map"])
def test_lengths_take_the_smallest_form_at_every_boundary(kind, n):
    obj = {
        "str": lambda: "é" * (n // 2) + "x" * (n % 2),  # n UTF-8 bytes
        "bin": lambda: bytes(range(256)) * (n // 256) + bytes(n % 256),
        "array": lambda: list(range(n)),
        "map": lambda: {f"k{i}": i for i in range(n)},
    }[kind]()
    assert same(obj) == obj


@pytest.mark.parametrize("obj", [
    None, True, False, 0.0, -0.0, 1.5, -2.25e300, math.inf, -math.inf,
    (1, (2, 3)), [True, 1, False, 0], {"a": None, b"b": [1.0]},
    bytearray(b"\x00\xff"), memoryview(b"view"),
])
def test_scalars_tuples_and_buffers(obj):
    same(obj)


def test_bool_is_packed_before_int():
    assert packb(True) == b"\xc3" and packb(False) == b"\xc2"
    assert packb([True, 1]) == msgpack.packb([True, 1]) == b"\x92\xc3\x01"
    assert unpackb(b"\xc3") is True


def test_nan_and_float32():
    assert packb(math.nan) == msgpack.packb(math.nan)
    raw = b"\xca" + struct.pack(">f", 1.5)
    assert unpackb(raw) == msgpack.unpackb(raw) == 1.5


def test_nesting_limits_match():
    def nest(d):
        v = 1
        for _ in range(d):
            v = [v]
        return v

    assert packb(nest(511)) == msgpack.packb(nest(511))
    for codec in (packb, msgpack.packb):
        with pytest.raises(ValueError):
            codec(nest(512))
    assert unpackb(b"\x91" * 1024 + b"\x01") == msgpack.unpackb(b"\x91" * 1024 + b"\x01")
    for codec in (unpackb, msgpack.unpackb):
        with pytest.raises(ValueError):
            codec(b"\x91" * 1025 + b"\x01")


scalars = (
    st.none() | st.booleans()
    | st.integers(-(1 << 63), (1 << 64) - 1)
    | st.floats(allow_nan=False)
    | st.text(max_size=300) | st.binary(max_size=300)
)
headers = st.recursive(
    scalars,
    lambda inner: st.lists(inner, max_size=20)
    | st.dictionaries(st.text(max_size=40) | st.binary(max_size=8), inner, max_size=20),
    max_leaves=60,
)


@settings(max_examples=400, deadline=None)
@given(headers)
def test_hypothesis_headers_match_msgpack(obj):
    same(obj)


@settings(max_examples=200, deadline=None)
@given(st.dictionaries(st.text(max_size=12), scalars, max_size=40))
def test_hypothesis_flat_maps_match_msgpack(obj):
    same(obj)


def _constructor_headers():
    tp = "00-" + "ab" * 16 + "-" + "cd" * 8 + "-01"
    msgs = [
        Message.handshake("ab" * 20, "cd" * 32, "ef" * 32, "ns", b"\x01", 8),
        Message.handshake("ab" * 20, "cd" * 32, "ef" * 32, "ns/x", b"", 70_000,
                          traceparent=tp, listen_port=65535),
        Message.bitfield(b"\x0f", 4),
        Message.piece_request(0),
        Message.piece_request(1 << 20, tp),
        Message.piece_payload(255, b"x"),
        Message.announce_piece(65536),
        Message.cancel_piece(127),
        Message.complete(),
        Message.error("busy", "try later"),
        Message.error("bad", "é" * 40),
        Message.peer_exchange(
            [{"id": "ab" * 20, "ip": "10.0.0.1", "p": 7611, "o": 1},
             {"id": "cd" * 20, "ip": "::1", "p": 1}], ["ef" * 20]),
        Message.peer_exchange([{"id": f"{i:040x}", "ip": "203.0.113.1", "p": i + 1}
                               for i in range(300)], []),
    ]
    return [(f"{m.type.name}-{i}", m.header) for i, m in enumerate(msgs)]


@pytest.mark.parametrize("name,header", _constructor_headers())
def test_every_wire_header_of_the_jax_constructors(name, header):
    assert same(header) == header


@pytest.mark.parametrize("raw", [
    b"",  # empty
    b"\x92\x01",  # array missing an item
    b"\xa3ab",  # str cut short
    b"\xcd\x01",  # uint16 cut short
    b"\xc5\x01\x00x",  # bin16 cut short
    b"\x81\xa1a",  # map missing its value
    b"\xdd\xff\xff\xff\xff\x01",  # array32 claiming 4 Gi items
])
def test_truncated_input_raises(raw):
    for codec in (unpackb, msgpack.unpackb):
        with pytest.raises(ValueError):
            codec(raw)


@pytest.mark.parametrize("raw", [b"\x01\x02", b"\x80\xc0", b"\xa1a\x00"])
def test_trailing_bytes_raise(raw):
    for codec in (unpackb, msgpack.unpackb):
        with pytest.raises(ValueError):
            codec(raw)


@pytest.mark.parametrize("raw", [b"\xa2\xff\xfe", b"\xd9\x01\x80", b"\x81\xa1\xc3\x01"])
def test_bad_utf8_raises(raw):
    for codec in (unpackb, msgpack.unpackb):
        with pytest.raises(UnicodeDecodeError):
            codec(raw)


@pytest.mark.parametrize("raw", [
    b"\x81\x01\x02", b"\x81\xc0\x02", b"\x81\xc3\x02", b"\x81\xcb" + struct.pack(">d", 1.0) + b"\x02",
    b"\x81\x90\x02", b"\x81\x80\x02",
])
def test_non_str_map_keys_raise(raw):
    for codec in (unpackb, msgpack.unpackb):
        with pytest.raises(ValueError):
            codec(raw)


@pytest.mark.parametrize("raw", [
    b"\xd4\x01\x02",  # fixext 1
    b"\xd6\xff\x00\x00\x00\x01",  # timestamp 32
    b"\xc7\x00\x05",  # ext 8, empty
    b"\x91\xd5\x02ab",  # fixext 2 inside an array
])
def test_ext_types_raise_where_msgpack_returns_them(raw):
    """The one deliberate difference: the wire sends no ext type."""
    msgpack.unpackb(raw)  # the package decodes them
    with pytest.raises(ValueError, match="ext type"):
        unpackb(raw)


def test_reserved_byte_raises():
    for codec in (unpackb, msgpack.unpackb):
        with pytest.raises(ValueError):
            codec(b"\xc1")


@pytest.mark.parametrize("obj", [1 << 64, -(1 << 63) - 1, [1 << 70]])
def test_ints_beyond_64_bits_raise(obj):
    for codec in (packb, msgpack.packb):
        with pytest.raises(OverflowError):
            codec(obj)


def test_unsupported_types_raise_type_error():
    for codec in (packb, msgpack.packb):
        with pytest.raises(TypeError):
            codec(object())
        with pytest.raises(TypeError):
            codec({1, 2})
