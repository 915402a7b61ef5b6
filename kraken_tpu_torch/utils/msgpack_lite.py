"""The subset of MessagePack the P2P wire speaks, in the standard library.

``kraken_tpu.p2p.wire`` packs its frame headers with the ``msgpack``
package. The port does not depend on it, so it carries this codec for the
types a header holds: nil, bool, int (up to 64 bits, signed and unsigned),
float, str, bin, array and map.

- :func:`packb` gives the bytes of ``msgpack.packb(obj)`` with its
  defaults: ``use_bin_type=True`` (``bytes`` as bin, ``str`` as str8/16/32),
  floats as float64, every length and integer in its smallest form, lists
  and tuples as arrays, at most 511 nested containers.
- :func:`unpackb` gives what ``msgpack.unpackb(data)`` gives with its
  defaults: str decoded as strict UTF-8, arrays as lists, map keys only
  str or bytes (``strict_map_key``), float32 and float64 read, at most
  1024 nested containers. Truncated input, trailing bytes, the reserved
  byte ``0xc1`` and bad UTF-8 raise ``ValueError``.

One difference is deliberate: an ext type (timestamps included) raises
``ValueError`` on decode, where ``msgpack`` returns an ``ExtType``. No
frame of the wire carries one.
"""

from __future__ import annotations

import struct

_PACK_NEST_LIMIT = 511  # msgpack's default recursion limit on pack
_UNPACK_NEST_LIMIT = 1024  # msgpack's unpacker stack

_B = struct.Struct(">B").pack
_BB = struct.Struct(">BB").pack
_BH = struct.Struct(">BH").pack
_BI = struct.Struct(">BI").pack
_BQ = struct.Struct(">BQ").pack
_Bb = struct.Struct(">Bb").pack
_Bh = struct.Struct(">Bh").pack
_Bi = struct.Struct(">Bi").pack
_Bq = struct.Struct(">Bq").pack
_Bd = struct.Struct(">Bd").pack


def _pack_int(n: int, out: list) -> None:
    if n >= 0:
        if n < 0x80:
            out.append(_B(n))
        elif n <= 0xFF:
            out.append(_BB(0xCC, n))
        elif n <= 0xFFFF:
            out.append(_BH(0xCD, n))
        elif n <= 0xFFFFFFFF:
            out.append(_BI(0xCE, n))
        elif n <= 0xFFFFFFFFFFFFFFFF:
            out.append(_BQ(0xCF, n))
        else:
            raise OverflowError("Integer value out of range")
    elif n >= -32:
        out.append(_B(n & 0xFF))
    elif n >= -0x80:
        out.append(_Bb(0xD0, n))
    elif n >= -0x8000:
        out.append(_Bh(0xD1, n))
    elif n >= -0x80000000:
        out.append(_Bi(0xD2, n))
    elif n >= -0x8000000000000000:
        out.append(_Bq(0xD3, n))
    else:
        raise OverflowError("Integer value out of range")


def _pack_len(n: int, fix: int | None, fix_max: int, codes: tuple, out: list) -> None:
    """A length header: fix form below ``fix_max`` (when the type has one),
    else the 8/16/32-bit code of ``codes`` (``None`` where absent)."""
    if fix is not None and n < fix_max:
        out.append(_B(fix | n))
    elif codes[0] is not None and n <= 0xFF:
        out.append(_BB(codes[0], n))
    elif n <= 0xFFFF:
        out.append(_BH(codes[1], n))
    elif n <= 0xFFFFFFFF:
        out.append(_BI(codes[2], n))
    else:
        raise ValueError(f"object too large to pack: {n}")


def _pack(obj, out: list, limit: int) -> None:
    if limit < 0:
        raise ValueError("recursion limit exceeded.")
    if obj is None:
        out.append(b"\xc0")
    elif obj is True:
        out.append(b"\xc3")
    elif obj is False:
        out.append(b"\xc2")
    elif isinstance(obj, int):  # after the bools: bool is an int
        _pack_int(obj, out)
    elif isinstance(obj, float):
        out.append(_Bd(0xCB, obj))
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        _pack_len(len(raw), 0xA0, 32, (0xD9, 0xDA, 0xDB), out)
        out.append(raw)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        raw = bytes(obj)
        _pack_len(len(raw), None, 0, (0xC4, 0xC5, 0xC6), out)
        out.append(raw)
    elif isinstance(obj, (list, tuple)):
        _pack_len(len(obj), 0x90, 16, (None, 0xDC, 0xDD), out)
        for item in obj:
            _pack(item, out, limit - 1)
    elif isinstance(obj, dict):
        _pack_len(len(obj), 0x80, 16, (None, 0xDE, 0xDF), out)
        for k, v in obj.items():
            _pack(k, out, limit - 1)
            _pack(v, out, limit - 1)
    else:
        raise TypeError(f"can not serialize {type(obj).__name__!r} object")


def packb(obj) -> bytes:
    """``obj`` as MessagePack bytes, equal to ``msgpack.packb(obj)``."""
    out: list[bytes] = []
    _pack(obj, out, _PACK_NEST_LIMIT)
    return b"".join(out)


# Fixed-width scalars: first byte -> (struct, size).
_SCALARS = {
    0xCA: struct.Struct(">f"), 0xCB: struct.Struct(">d"),
    0xCC: struct.Struct(">B"), 0xCD: struct.Struct(">H"),
    0xCE: struct.Struct(">I"), 0xCF: struct.Struct(">Q"),
    0xD0: struct.Struct(">b"), 0xD1: struct.Struct(">h"),
    0xD2: struct.Struct(">i"), 0xD3: struct.Struct(">q"),
}
# Length-prefixed: first byte -> (kind, struct of the length).
_SIZED = {
    0xC4: ("bin", struct.Struct(">B")), 0xC5: ("bin", struct.Struct(">H")),
    0xC6: ("bin", struct.Struct(">I")),
    0xD9: ("str", struct.Struct(">B")), 0xDA: ("str", struct.Struct(">H")),
    0xDB: ("str", struct.Struct(">I")),
    0xDC: ("array", struct.Struct(">H")), 0xDD: ("array", struct.Struct(">I")),
    0xDE: ("map", struct.Struct(">H")), 0xDF: ("map", struct.Struct(">I")),
}
_EXT = frozenset((0xC7, 0xC8, 0xC9, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8))
_INCOMPLETE = "Unpack failed: incomplete input"


class _Container:
    __slots__ = ("value", "left", "key", "is_map")

    def __init__(self, n: int, is_map: bool):
        self.value = {} if is_map else []
        self.left = n * 2 if is_map else n
        self.key = None
        self.is_map = is_map


def unpackb(data) -> object:
    """Decode one MessagePack object that fills ``data`` exactly, as
    ``msgpack.unpackb(data)`` does (ext types excepted: they raise)."""
    buf = memoryview(data).cast("B") if not isinstance(data, bytes) else data
    end = len(buf)
    pos = 0
    stack: list[_Container] = []

    def take(n: int) -> bytes:
        nonlocal pos
        if end - pos < n:
            raise ValueError(_INCOMPLETE)
        chunk = bytes(buf[pos : pos + n])
        pos += n
        return chunk

    while True:
        if pos >= end:
            raise ValueError(_INCOMPLETE)
        b = buf[pos]
        pos += 1
        opened = None
        if b < 0x80:
            value = b
        elif b >= 0xE0:
            value = b - 0x100
        elif b < 0x90:
            opened = _Container(b & 0x0F, True)
        elif b < 0xA0:
            opened = _Container(b & 0x0F, False)
        elif b < 0xC0:
            value = take(b & 0x1F).decode("utf-8")
        elif b == 0xC0:
            value = None
        elif b == 0xC2:
            value = False
        elif b == 0xC3:
            value = True
        elif b in _SCALARS:
            st = _SCALARS[b]
            value = st.unpack(take(st.size))[0]
        elif b in _SIZED:
            kind, st = _SIZED[b]
            n = st.unpack(take(st.size))[0]
            if kind == "bin":
                value = take(n)
            elif kind == "str":
                value = take(n).decode("utf-8")
            else:
                opened = _Container(n, kind == "map")
        elif b in _EXT:
            raise ValueError(f"ext type 0x{b:02x} is not supported")
        else:  # 0xc1, never used
            raise ValueError(f"reserved byte 0x{b:02x}")

        if opened is not None:
            if len(stack) >= _UNPACK_NEST_LIMIT:
                raise ValueError("nesting too deep")
            if opened.left:
                stack.append(opened)
                continue
            value = opened.value
        # Hand the finished value to its container, closing every
        # container it fills.
        while True:
            if not stack:
                if pos != end:
                    raise ValueError("unpack(b) received extra data.")
                return value
            top = stack[-1]
            top.left -= 1
            if not top.is_map:
                top.value.append(value)
            elif top.left % 2:  # a key: its value comes next
                if not isinstance(value, (str, bytes)):
                    raise ValueError(
                        f"{type(value).__name__} is not allowed for map key"
                        " when strict_map_key=True"
                    )
                top.key = value
            else:
                top.value[top.key] = value
            if top.left:
                break
            stack.pop()
            value = top.value
