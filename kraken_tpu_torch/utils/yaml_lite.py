"""A YAML reader for the subset the shipped configs use, stdlib only.

The port's stand-in for ``yaml.safe_load`` (PyYAML), as ``msgpack_lite``
and ``http_lite`` stand in for theirs. It reads what ``config/`` holds:

- block mappings, and block sequences (of mappings, ``- namespace: ".*"``,
  or of scalars), a sequence indented under its key or level with it;
- flow mappings and flow sequences on one line (``{root: /var/cache}``,
  ``backends: []``);
- full-line and trailing ``#`` comments;
- plain, single-quoted and double-quoted scalars;
- YAML 1.1's implicit types as ``safe_load`` resolves them: null, bool
  (``yes``/``on``/``true`` and their opposites), int (decimal, octal,
  hex, binary, base 60, ``_`` separators) and float (``1.5``, ``.inf``,
  ``.nan``, base 60).

Anything outside the subset raises ``ValueError`` and never comes back as
a wrong value: anchors, aliases, tags, block scalars, directives and
document markers, complex and merge keys, plain scalars that span lines,
multi-line flow collections, tabs in indentation, and scalars that
``safe_load`` would turn into dates.
"""

from __future__ import annotations

import math
import re
from typing import Any

# PyYAML's implicit resolvers (yaml/resolver.py), in its order.
_BOOL = re.compile(
    r"yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE"
    r"|on|On|ON|off|Off|OFF"
)
_FLOAT = re.compile(
    r"[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?"
    r"|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*"
    r"|[-+]?\.(?:inf|Inf|INF)"
    r"|\.(?:nan|NaN|NAN)"
)
_INT = re.compile(
    r"[-+]?0b[0-1_]+"
    r"|[-+]?0[0-7_]+"
    r"|[-+]?(?:0|[1-9][0-9_]*)"
    r"|[-+]?0x[0-9a-fA-F_]+"
    r"|[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+"
)
_NULL = re.compile(r"~|null|Null|NULL|")
_TIMESTAMP = re.compile(
    r"[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]"
    r"|[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?"
    r"(?:[Tt]|[ \t]+)[0-9][0-9]?"
    r":[0-9][0-9]:[0-9][0-9](?:\.[0-9]*)?"
    r"(?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?"
)

# What YAML 1.1's reader refuses anywhere in a stream (PyYAML's
# Reader.NON_PRINTABLE).
_NON_PRINTABLE = re.compile(
    "[^\x09\x0A\x0D\x20-\x7E\x85\xA0-\uD7FF\uE000-\uFFFD"
    "\U00010000-\U0010ffff]"
)

# Characters that may not start a plain scalar in the subset: each
# starts a YAML construct this reader does not take.
_REFUSED_STARTS = {
    "&": "anchors", "*": "aliases", "!": "tags", "|": "block scalars",
    ">": "block scalars", "%": "directives", "@": "reserved indicators",
    "`": "reserved indicators",
}

_ESCAPES = {
    "0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t", "n": "\n",
    "v": "\v", "f": "\f", "r": "\r", "e": "\x1b", " ": " ", '"': '"',
    "/": "/", "\\": "\\", "N": "\x85", "_": "\xa0", "L": "\u2028",
    "P": "\u2029",
}
_HEX_ESCAPES = {"x": 2, "u": 4, "U": 8}


class _Line:
    __slots__ = ("indent", "text", "lineno")

    def __init__(self, indent: int, text: str, lineno: int):
        self.indent = indent
        self.text = text
        self.lineno = lineno


def _fail(lineno: int, msg: str) -> ValueError:
    return ValueError(f"yaml_lite: line {lineno}: {msg}")


def _quote_opens(text: str, i: int) -> bool:
    """Does the quote at ``text[i]`` start a quoted scalar (and not sit
    inside a plain one, as in ``it's``)?"""
    j = i - 1
    while j >= 0 and text[j] == " ":
        j -= 1
    if j < 0:
        return True
    if text[j] in "[{,":
        return True
    return text[j] in ":-" and j < i - 1


def _strip_comment(text: str, lineno: int) -> str:
    """``text`` without its trailing comment; quotes are respected."""
    quote = ""
    i = 0
    while i < len(text):
        ch = text[i]
        if quote == '"':
            if ch == "\\":
                i += 2
                continue
            if ch == '"':
                quote = ""
        elif quote == "'":
            if ch == "'":
                if i + 1 < len(text) and text[i + 1] == "'":
                    i += 2
                    continue
                quote = ""
        elif ch in "\"'" and _quote_opens(text, i):
            quote = ch
        elif ch == "#" and (i == 0 or text[i - 1] in " \t"):
            return text[:i].rstrip()
        i += 1
    if quote:
        raise _fail(lineno, "a quoted scalar must close on its line")
    return text.rstrip()


def _lines(source: str) -> list[_Line]:
    bad = _NON_PRINTABLE.search(source)
    if bad is not None:
        raise ValueError(
            f"yaml_lite: non-printable character {bad.group()!r} at offset"
            f" {bad.start()}"
        )
    out = []
    for lineno, raw in enumerate(source.splitlines(), 1):
        body = raw.lstrip(" ")
        if not body or body.startswith("#"):
            continue
        if body[0] == "\t":
            raise _fail(lineno, "tabs are not taken in indentation")
        if raw.startswith(("---", "...")) and raw[3:4] in ("", " ", "\t"):
            raise _fail(lineno, "document markers (multi-document streams)"
                                " are not taken")
        if raw.startswith("%"):
            raise _fail(lineno, "directives are not taken")
        text = _strip_comment(body, lineno)
        if text:
            out.append(_Line(len(raw) - len(body), text, lineno))
    return out


# -- scalars ---------------------------------------------------------------

def _resolve_plain(text: str, lineno: int) -> Any:
    """A plain scalar's value, as PyYAML's SafeLoader resolves it."""
    if _BOOL.fullmatch(text):
        return text.lower() in ("yes", "true", "on")
    if _FLOAT.fullmatch(text):
        v = text.replace("_", "").lower()
        sign = -1.0 if v[0] == "-" else 1.0
        if v[0] in "+-":
            v = v[1:]
        if v == ".inf":
            return sign * math.inf
        if v == ".nan":
            return math.nan
        if ":" in v:
            total, base = 0.0, 1
            for part in reversed(v.split(":")):
                total += float(part) * base
                base *= 60
            return sign * total
        return sign * float(v)
    if _INT.fullmatch(text):
        v = text.replace("_", "")
        sign = -1 if v[0] == "-" else 1
        if v[0] in "+-":
            v = v[1:]
        if v == "0":
            return 0
        if v.startswith("0b"):
            return sign * int(v[2:], 2)
        if v.startswith("0x"):
            return sign * int(v[2:], 16)
        if v[0] == "0":
            return sign * int(v, 8)
        if ":" in v:
            total, base = 0, 1
            for part in reversed(v.split(":")):
                total += int(part) * base
                base *= 60
            return sign * total
        return sign * int(v)
    if text == "<<":
        raise _fail(lineno, "merge keys are not taken")
    if _NULL.fullmatch(text):
        return None
    if _TIMESTAMP.fullmatch(text):
        raise _fail(lineno, f"{text!r} would load as a date; quote it")
    if text == "=":
        raise _fail(lineno, "the value key '=' is not taken")
    return text


def _double_quoted(text: str, i: int, lineno: int) -> tuple[str, int]:
    """The double-quoted scalar opening at ``text[i]``: (value, index
    past its closing quote)."""
    out = []
    j = i + 1
    while j < len(text):
        ch = text[j]
        if ch == '"':
            return "".join(out), j + 1
        if ch == "\\":
            esc = text[j + 1:j + 2]
            if esc in _ESCAPES:
                out.append(_ESCAPES[esc])
                j += 2
                continue
            if esc in _HEX_ESCAPES:
                n = _HEX_ESCAPES[esc]
                digits = text[j + 2:j + 2 + n]
                if len(digits) != n or not all(
                    c in "0123456789abcdefABCDEF" for c in digits
                ):
                    raise _fail(lineno, f"bad escape \\{esc}{digits}")
                out.append(chr(int(digits, 16)))
                j += 2 + n
                continue
            raise _fail(lineno, f"unknown escape \\{esc}")
        out.append(ch)
        j += 1
    raise _fail(lineno, "unclosed double-quoted scalar")


def _single_quoted(text: str, i: int, lineno: int) -> tuple[str, int]:
    out = []
    j = i + 1
    while j < len(text):
        ch = text[j]
        if ch == "'":
            if text[j + 1:j + 2] == "'":
                out.append("'")
                j += 2
                continue
            return "".join(out), j + 1
        out.append(ch)
        j += 1
    raise _fail(lineno, "unclosed single-quoted scalar")


def _quoted(text: str, i: int, lineno: int) -> tuple[str, int]:
    if text[i] == '"':
        return _double_quoted(text, i, lineno)
    return _single_quoted(text, i, lineno)


def _check_plain_start(text: str, lineno: int) -> None:
    what = _REFUSED_STARTS.get(text[:1])
    if what is not None:
        raise _fail(lineno, f"{what} are not taken ({text!r})")
    if text[:1] in "?-" and text[1:2] in ("", " "):
        raise _fail(lineno, f"{text!r} is not a scalar of the subset")


def _scalar_or_flow(text: str, lineno: int) -> Any:
    """The value of a whole node written on one line: a flow collection,
    a quoted scalar or a plain one."""
    if not text:
        return None
    if text[0] in "[{":
        value, j = _flow(text, 0, lineno)
        if text[j:].strip():
            raise _fail(lineno, f"text after a flow collection: {text[j:]!r}")
        return value
    if text[0] in "\"'":
        value, j = _quoted(text, 0, lineno)
        if text[j:].strip():
            raise _fail(lineno, f"text after a quoted scalar: {text[j:]!r}")
        return value
    _check_plain_start(text, lineno)
    if ": " in text or text.endswith(":"):
        raise _fail(lineno, f"a mapping is not allowed here: {text!r}")
    if " #" in text:
        raise _fail(lineno, f"unexpected comment in {text!r}")
    return _resolve_plain(text, lineno)


# -- flow collections (one line) -------------------------------------------

def _skip(text: str, j: int) -> int:
    while j < len(text) and text[j] == " ":
        j += 1
    return j


def _flow_plain(text: str, j: int, lineno: int, key: bool) -> tuple[Any, int]:
    start = j
    while j < len(text):
        ch = text[j]
        if ch in ",[]{}":
            break
        if ch == ":" and (j + 1 == len(text) or text[j + 1] in " ,[]{}"):
            if key:
                break
            raise _fail(lineno, "a mapping is not allowed here")
        if ch == "#" and text[j - 1] == " ":
            raise _fail(lineno, "comments inside a flow collection")
        j += 1
    raw = text[start:j].rstrip()
    if not raw:
        raise _fail(lineno, "empty entry in a flow collection")
    _check_plain_start(raw, lineno)
    return _resolve_plain(raw, lineno), j


def _flow_node(text: str, j: int, lineno: int, key: bool = False) -> tuple[Any, int]:
    j = _skip(text, j)
    if j >= len(text):
        raise _fail(lineno, "flow collections must close on their line")
    ch = text[j]
    if ch in "[{":
        if key:
            raise _fail(lineno, "complex keys are not taken")
        return _flow(text, j, lineno)
    if ch in "\"'":
        return _quoted(text, j, lineno)
    return _flow_plain(text, j, lineno, key)


def _flow(text: str, i: int, lineno: int) -> tuple[Any, int]:
    """The flow collection opening at ``text[i]``: (value, index past
    its close)."""
    close = "]" if text[i] == "[" else "}"
    is_map = close == "}"
    out: Any = {} if is_map else []
    j = _skip(text, i + 1)
    if j < len(text) and text[j] == close:
        return out, j + 1
    while True:
        if is_map:
            k, j = _flow_node(text, j, lineno, key=True)
            _check_hashable(k, lineno)
            j = _skip(text, j)
            if j < len(text) and text[j] == ":":
                v, j = _flow_node(text, j + 1, lineno)
            else:
                v = None
            out[k] = v
        else:
            v, j = _flow_node(text, j, lineno)
            j = _skip(text, j)
            if j < len(text) and text[j] == ":":
                raise _fail(lineno, "pairs in a flow sequence are not taken")
            out.append(v)
        j = _skip(text, j)
        if j >= len(text):
            raise _fail(lineno, "flow collections must close on their line")
        if text[j] == close:
            return out, j + 1
        if text[j] != ",":
            raise _fail(lineno, f"expected ',' or {close!r} in {text!r}")
        j = _skip(text, j + 1)
        if j < len(text) and text[j] == close:
            return out, j + 1  # a trailing comma, as YAML allows


def _check_hashable(key: Any, lineno: int) -> None:
    if isinstance(key, (list, dict)):
        raise _fail(lineno, "complex keys are not taken")


# -- block structure -------------------------------------------------------

def _split_key(line: _Line) -> tuple[Any, str] | None:
    """(key, value text) when ``line`` is a ``key: value`` entry."""
    text = line.text
    if text[0] in "\"'":
        key, j = _quoted(text, 0, line.lineno)
        j = _skip(text, j)
        if text[j:j + 1] != ":" or text[j + 1:j + 2] not in ("", " "):
            return None
        return key, text[j + 1:].strip()
    if text[0] in "[{":
        if _flow_closes_then_colon(text):
            raise _fail(line.lineno, "complex keys are not taken")
        return None
    if text[:2] == "? " or text == "?":
        raise _fail(line.lineno, "complex keys are not taken")
    j = 0
    while True:
        j = text.find(":", j)
        if j < 0:
            return None
        if j + 1 == len(text) or text[j + 1] == " ":
            break
        j += 1
    raw = text[:j].rstrip()
    if not raw:
        raise _fail(line.lineno, "empty keys are not taken")
    _check_plain_start(raw, line.lineno)
    if " #" in raw:
        raise _fail(line.lineno, f"unexpected comment in key {raw!r}")
    return _resolve_plain(raw, line.lineno), text[j + 1:].strip()


def _flow_closes_then_colon(text: str) -> bool:
    depth = 0
    for j, ch in enumerate(text):
        if ch in "[{":
            depth += 1
        elif ch in "]}":
            depth -= 1
            if depth == 0:
                return text[j + 1:].lstrip().startswith(":")
    return False


def _is_seq_item(text: str) -> bool:
    return text == "-" or text.startswith("- ")


class _Parser:
    def __init__(self, lines: list[_Line]):
        self.lines = lines
        self.i = 0

    def peek(self) -> _Line | None:
        return self.lines[self.i] if self.i < len(self.lines) else None

    def block(self, indent: int) -> Any:
        line = self.peek()
        if _is_seq_item(line.text):
            return self.sequence(line.indent)
        if _split_key(line) is not None:
            return self.mapping(line.indent)
        self.i += 1
        nxt = self.peek()
        if nxt is not None and nxt.indent > indent:
            raise _fail(nxt.lineno, "plain scalars that span lines are not taken")
        return _scalar_or_flow(line.text, line.lineno)

    def nested(self, parent_indent: int, allow_level_seq: bool) -> Any:
        """The block value of a key or item whose text was empty: a more
        indented block, a sequence level with its key, or null."""
        nxt = self.peek()
        if nxt is None:
            return None
        if nxt.indent > parent_indent:
            return self.block(nxt.indent)
        if allow_level_seq and nxt.indent == parent_indent and _is_seq_item(nxt.text):
            return self.sequence(parent_indent)
        return None

    def mapping(self, indent: int) -> dict:
        out: dict = {}
        while True:
            line = self.peek()
            if line is None or line.indent < indent:
                return out
            if line.indent > indent:
                raise _fail(line.lineno, "unexpected indentation")
            if _is_seq_item(line.text):
                return out  # a level sequence ends this mapping
            entry = _split_key(line)
            if entry is None:
                raise _fail(line.lineno, f"expected 'key: value', got {line.text!r}")
            key, rest = entry
            _check_hashable(key, line.lineno)
            self.i += 1
            if rest:
                if _is_seq_item(rest):
                    raise _fail(line.lineno, "a sequence may not start on its key's line")
                if _split_key(_Line(0, rest, line.lineno)) is not None and rest[0] not in "[{\"'":
                    raise _fail(line.lineno, f"a mapping is not allowed here: {rest!r}")
                value = _scalar_or_flow(rest, line.lineno)
                nxt = self.peek()
                if nxt is not None and nxt.indent > indent:
                    raise _fail(nxt.lineno, "plain scalars that span lines are not taken")
            else:
                value = self.nested(indent, allow_level_seq=True)
            out[key] = value

    def sequence(self, indent: int) -> list:
        out: list = []
        while True:
            line = self.peek()
            if line is None or line.indent < indent:
                return out
            if line.indent > indent:
                raise _fail(line.lineno, "unexpected indentation")
            if not _is_seq_item(line.text):
                return out
            rest = line.text[1:].lstrip(" ")
            if not rest:
                self.i += 1
                out.append(self.nested(indent, allow_level_seq=False))
                continue
            # The item's node starts on the dash's line: reparse that
            # line as the node's first line, at the column it starts.
            col = indent + len(line.text) - len(rest)
            self.lines[self.i] = _Line(col, rest, line.lineno)
            out.append(self.block(col))


def loads(source: str) -> Any:
    """Parse one YAML document of the subset (``safe_load``'s value; an
    empty document is ``None``)."""
    lines = _lines(source)
    if not lines:
        return None
    p = _Parser(lines)
    value = p.block(lines[0].indent)
    rest = p.peek()
    if rest is not None:
        raise _fail(rest.lineno, f"unexpected text {rest.text!r}")
    return value


def safe_load(stream) -> Any:
    """``yaml.safe_load``'s signature: a string or a file object."""
    if hasattr(stream, "read"):
        stream = stream.read()
    if isinstance(stream, bytes):
        stream = stream.decode("utf-8")
    return loads(stream)
