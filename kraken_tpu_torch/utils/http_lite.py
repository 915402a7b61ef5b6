"""A small HTTP/1.1 server and client on asyncio: the port's stand-in for
``aiohttp``, as ``msgpack_lite`` stands in for ``msgpack``.

It offers the surface of ``aiohttp`` that ``kraken_tpu`` uses (``web.`` and
``aiohttp.`` across that package), under the same names where a name
exists, so a ported module reads as its reference does:

Server (``aiohttp.web``):

- :class:`Application` with ``router.add_route/get/post/put/patch/delete/head``
  (``add_get`` also answers HEAD, ``add_route("*", ...)`` any method), route
  templates of ``{name}`` (``[^{}/]+``) and ``{name:regex}`` parts anywhere in
  the path (a regex may span ``/``), resolved as ``aiohttp`` resolves them
  (below), ``middlewares=[...]`` (each ``async def m(request, handler)``,
  the first outermost; :func:`middleware` marks one), app keys
  (:class:`AppKey`, ``app[key] = value``), ``client_max_size`` and
  ``cleanup_ctx`` (async generators run up to their ``yield`` by
  :func:`serve` and finished, last first, by ``AppRunner.cleanup()``);
- :class:`Request`: ``method``, ``path``, ``raw_path``, ``match_info``,
  ``query``, ``headers`` (``getall`` gives a repeated header's values),
  ``remote``, ``transport``, ``app``, ``read()``, ``text()``,
  ``json()``, ``http_range`` (``aiohttp``'s single-range parser: a ``slice``,
  ``ValueError`` for a malformed or multi-range header) and the streaming
  ``content`` (``read``, ``readany``, ``iter_chunked``);
- :class:`Response`, :class:`StreamResponse` (``prepare``, ``write``,
  ``write_eof``, ``content_length``, ``content_type``), :class:`FileResponse`
  (200 or 206 for one byte range, 416 with ``bytes */size``, HEAD; the body
  sent by ``loop.sendfile``, or 1 MiB ``pread`` calls on a thread where the
  transport cannot) and :func:`json_response`, with the content types
  ``aiohttp`` sends;
- :class:`HTTPException` and its subclasses, each taking ``text=`` and
  ``headers=``; raising one from a handler answers with it;
- :func:`serve` (``AppRunner`` + ``TCPSite`` with
  ``handler_cancellation=True``), whose runner's ``cleanup()`` closes the
  listener and every open connection, then raises what a ``cleanup_ctx``
  raised (more than one error as :class:`CleanupError`).

Client (``aiohttp.ClientSession``): a pooled keep-alive
:class:`ClientSession` whose ``request(method, url, data=, headers=,
timeout=, allow_redirects=)`` is awaited or entered (``async with``) and
gives a :class:`ClientResponse` (``status``, ``headers``, ``read()``,
``text()``, ``json()``, ``content.iter_chunked(n)``); ``headers`` may be a
list of pairs, each sent as a header line of its own; https through the
standard library's :mod:`ssl`; :class:`ClientTimeout`;
:class:`ClientConnectionError`, :class:`ClientPayloadError` and
``asyncio.TimeoutError``. A pooled connection that the server closed is
retried once on a fresh one for the idempotent methods, as ``aiohttp``
does; a refused or reset connection raises at once.

Matching, as ``aiohttp`` matches: a template compiles to one pattern
(``{name}`` as ``[^{}/]+``, ``{name:regex}`` as the regex, the literal parts
escaped), held whole against the request path with its escapes decoded but
for ``%2F`` and ``%25`` (yarl's ``path_safe``); each captured value then has
those two decoded, so ``%2F`` inside a ``{name}`` part reaches the handler
as ``/`` and does not split the route, and a decoded ``{`` or ``}`` matches
no ``{name}``. Routes are tried in ``aiohttp``'s order: by the request
path's prefixes, longest first, against each route's literal prefix, and
in registration order within one prefix. A path no route matches raises
``HTTPNotFound``, one whose routes take other methods
``HTTPMethodNotAllowed`` with their ``Allow``; both are raised inside the
middleware chain, so a middleware can rewrite them.

Left out, with what stands in their place (ROADMAP §C):

- ``ClientConnectionError`` subclasses the builtin ``ConnectionError``
  (``aiohttp``'s does not);
- no websockets, cookies, multipart, compression, proxies or ``Expect:
  100-continue``; ``FileResponse`` takes no conditional request
  (``If-Match``, ``If-None-Match``, ``If-Modified-Since``,
  ``If-Unmodified-Since``, ``If-Range``) and serves no precompressed
  sibling;
- ``Request.query`` is a plain ``dict`` of each name's first value (no
  ``getall``), and ``headers[name]`` joins a repeated header's values with
  ``", "`` (``aiohttp`` gives the first; ``getall`` gives each).
"""

from __future__ import annotations

import asyncio
import codecs
import email.utils
import functools
import http
import json as _json
import logging
import math
import mimetypes
import os
import re
import ssl as _ssl
import stat as _stat
import time
from collections.abc import MutableMapping
from dataclasses import dataclass
from typing import Any, AsyncIterator, Awaitable, Callable, Iterator
from urllib.parse import parse_qsl, unquote, urljoin, urlsplit

_log = logging.getLogger("kraken.http_lite")

MAX_LINE = 8190  # request, status and header lines (aiohttp's limit)
STREAM_LIMIT = 1 << 16  # a connection's read buffer before it pauses the socket
MAX_HEADERS = 128
READ_CHUNK = 1 << 16
IDEMPOTENT_METHODS = frozenset({"GET", "HEAD", "OPTIONS", "TRACE", "PUT", "DELETE"})
REDIRECTS = frozenset({301, 302, 303, 307, 308})
MAX_REDIRECTS = 10


def _reason(status: int) -> str:
    try:
        return http.HTTPStatus(status).phrase
    except ValueError:
        return ""


def _check_header(name: str, value: str) -> None:
    if any(c in name for c in "\r\n:") or any(c in value for c in "\r\n"):
        raise ValueError(f"newline or carriage return in header {name!r}")


class Headers(MutableMapping):
    """Case-insensitive headers that keep each name as it was first set
    (``dict(headers)`` gives the names as sent). ``add`` keeps a repeated
    header's values apart: ``getall`` gives them in order, ``headers[name]``
    joins them with ``", "``. Built from a list of pairs, each pair is
    added."""

    def __init__(self, items=None):
        self._d: dict[str, tuple[str, list[str]]] = {}
        if isinstance(items, Headers):
            items = items.pairs()
        elif items and hasattr(items, "items"):
            for k, v in items.items():
                self[k] = v
            return
        for k, v in items or ():
            self.add(k, v)

    def __getitem__(self, name: str) -> str:
        return ", ".join(self._d[name.lower()][1])

    def __setitem__(self, name: str, value) -> None:
        value = str(value)
        _check_header(name, value)
        old = self._d.get(name.lower())
        self._d[name.lower()] = (old[0] if old else name, [value])

    def __delitem__(self, name: str) -> None:
        del self._d[name.lower()]

    def __iter__(self) -> Iterator[str]:
        return (k for k, _v in self._d.values())

    def __len__(self) -> int:
        return len(self._d)

    def __contains__(self, name) -> bool:
        return isinstance(name, str) and name.lower() in self._d

    def add(self, name: str, value) -> None:
        value = str(value)
        _check_header(name, value)
        old = self._d.get(name.lower())
        if old is None:
            self._d[name.lower()] = (name, [value])
        else:
            old[1].append(value)

    def getall(self, name: str, *default) -> list[str]:
        """Every value of ``name``, in the order received; ``default`` (or
        ``KeyError``) when there is none, as ``aiohttp``'s ``getall``."""
        got = self._d.get(name.lower())
        if got is not None:
            return list(got[1])
        if default:
            return default[0]
        raise KeyError(name)

    def pairs(self) -> list[tuple[str, str]]:
        """(name, value) for each value: one header line each."""
        return [(k, v) for k, vs in self._d.values() for v in vs]

    def __repr__(self) -> str:
        return f"Headers({dict(self.items())!r})"


# -- reading a message -------------------------------------------------------


class _HeadError(Exception):
    """A request or response head that does not parse."""


async def _readline(reader: asyncio.StreamReader) -> bytes:
    try:
        line = await reader.readuntil(b"\n")
    except asyncio.LimitOverrunError as e:
        raise _HeadError("line too long") from e
    if len(line) > MAX_LINE + 2:
        raise _HeadError("line too long")
    return line


async def _read_head(reader: asyncio.StreamReader) -> tuple[str, Headers] | None:
    """The start line and the headers; ``None`` on EOF before any byte."""
    try:
        line = await _readline(reader)
    except asyncio.IncompleteReadError as e:
        if not e.partial:
            return None
        raise _HeadError("message head cut short") from e
    start = line.rstrip(b"\r\n").decode("latin-1")
    headers = Headers()
    for _ in range(MAX_HEADERS + 1):
        try:
            raw = await _readline(reader)
        except asyncio.IncompleteReadError as e:
            raise _HeadError("message head cut short") from e
        raw = raw.rstrip(b"\r\n")
        if not raw:
            return start, headers
        name, sep, value = raw.decode("latin-1").partition(":")
        if not sep or not name or name != name.strip() or name[0] in " \t":
            raise _HeadError(f"malformed header line {raw[:64]!r}")
        headers.add(name, value.strip(" \t"))
    raise _HeadError("too many headers")


class BodyReader:
    """A message body read as it arrives: by ``Content-Length``, by chunks
    (``Transfer-Encoding: chunked``), or to the end of the connection."""

    def __init__(self, reader: asyncio.StreamReader | None, length: int | None,
                 chunked: bool, error: type[Exception], deadline: float | None = None):
        self._reader = reader
        self._remaining = length  # None: to EOF, or chunked
        self._chunked = chunked
        self._chunk_left = 0
        self._eof = reader is None or (length == 0 and not chunked)
        self._error = error
        self.deadline = deadline  # loop time the reads must finish by

    @property
    def at_eof(self) -> bool:
        return self._eof

    async def _timed(self, aw):
        if self.deadline is None:
            return await aw
        async with asyncio.timeout_at(self.deadline):
            return await aw

    async def read(self, n: int = -1) -> bytes:
        """Up to ``n`` bytes (at least one unless the body has ended); all
        of what is left with ``n < 0``."""
        if n < 0:
            parts = []
            while chunk := await self.readany():
                parts.append(chunk)
            return b"".join(parts)
        return await self._timed(self._read(n))

    async def readany(self) -> bytes:
        return await self.read(READ_CHUNK)

    async def iter_chunked(self, n: int) -> AsyncIterator[bytes]:
        while chunk := await self.read(n):
            yield chunk

    async def _read(self, n: int) -> bytes:
        if self._eof or n == 0:
            return b""
        try:
            if self._chunked:
                return await self._read_chunked(n)
            if self._remaining is None:
                data = await self._reader.read(n)
                self._eof = not data
                return data
            data = await self._reader.read(min(n, self._remaining))
            if not data:
                raise self._error(
                    f"connection closed with {self._remaining} body bytes unread")
            self._remaining -= len(data)
            self._eof = self._remaining == 0
            return data
        except (asyncio.IncompleteReadError, asyncio.LimitOverrunError, ValueError) as e:
            raise self._error(f"malformed or cut body: {e!r}") from e

    async def _read_chunked(self, n: int) -> bytes:
        r = self._reader
        if self._chunk_left == 0:
            size_line = (await r.readuntil(b"\n")).split(b";", 1)[0].strip()
            size = int(size_line, 16)
            if size < 0:
                raise ValueError("negative chunk size")
            if size == 0:
                while (await r.readuntil(b"\n")).strip():  # trailers
                    pass
                self._eof = True
                return b""
            self._chunk_left = size
        data = await r.read(min(n, self._chunk_left))
        if not data:
            raise asyncio.IncompleteReadError(b"", self._chunk_left)
        self._chunk_left -= len(data)
        if self._chunk_left == 0 and await r.readexactly(2) != b"\r\n":
            raise ValueError("chunk not followed by CRLF")
        return data


def _body_reader(reader, headers: Headers, error, *, default_eof: bool,
                 deadline: float | None = None) -> BodyReader:
    te = headers.get("Transfer-Encoding", "").lower()
    if te:
        if te != "chunked":
            raise _HeadError(f"unsupported Transfer-Encoding {te!r}")
        return BodyReader(reader, None, True, error, deadline)
    cl = headers.get("Content-Length")
    if cl is not None:
        if not cl.isdigit():
            raise _HeadError(f"malformed Content-Length {cl!r}")
        return BodyReader(reader, int(cl), False, error, deadline)
    if default_eof:
        return BodyReader(reader, None, False, error, deadline)
    return BodyReader(None, 0, False, error, deadline)


def _wants_close(version: str, headers: Headers) -> bool:
    conn = headers.get("Connection", "").lower()
    if version == "HTTP/1.0":
        return "keep-alive" not in conn
    return "close" in conn


# -- server ------------------------------------------------------------------


class AppKey:
    """A typed application key (``app[key] = value``); keys compare by
    identity."""

    def __init__(self, name: str, t: type = object):
        self.name = name
        self.type = t

    def __repr__(self) -> str:
        return f"<AppKey({self.name!r})>"


Handler = Callable[["Request"], Awaitable["StreamResponse"]]


_HEX = frozenset("0123456789abcdefABCDEF")
# A template's {name} and {name:regex} parts (aiohttp's ROUTE_RE, DYN and
# DYN_WITH_RE).
_ROUTE_PART = re.compile(r"(\{[_a-zA-Z][^{}]*(?:\{[^{}]*\}[^{}]*)*\})")
_DYN = re.compile(r"\{(?P<var>[_a-zA-Z][_a-zA-Z0-9]*)\}")
_DYN_WITH_RE = re.compile(r"\{(?P<var>[_a-zA-Z][_a-zA-Z0-9]*):(?P<re>.+)\}")
_GOOD = r"[^{}/]+"
METH_ANY = "*"


def _path_safe(raw: str) -> str:
    """The raw request path as ``aiohttp`` matches routes against it
    (yarl's ``URL.path_safe``): each run of escapes decoded as UTF-8, an
    escape that is not UTF-8 kept as sent, a decoded ``/`` or ``%`` kept
    escaped as ``%2F`` or ``%25``."""
    if "%" not in raw:
        return raw
    decoder = codecs.getincrementaldecoder("utf-8")()
    out: list[str] = []
    i, n = 0, len(raw)
    while i < n:
        ch = raw[i]
        i += 1
        if ch == "%" and i <= n - 2 and raw[i] in _HEX and raw[i + 1] in _HEX:
            b = bytes([int(raw[i:i + 2], 16)])
            i += 2
            try:
                got = decoder.decode(b)
            except UnicodeDecodeError:
                out.append(raw[i - 3 - len(decoder.buffer) * 3:i - 3])
                decoder.reset()
                try:
                    got = decoder.decode(b)
                except UnicodeDecodeError:
                    out.append(raw[i - 3:i])
                    continue
            if got == "/":
                out.append("%2F")
            elif got == "%":
                out.append("%25")
            else:
                out.append(got)
            continue
        if decoder.buffer:
            out.append(raw[i - 1 - len(decoder.buffer) * 3:i - 1])
            decoder.reset()
        out.append(ch)
    if decoder.buffer:
        out.append(raw[-len(decoder.buffer) * 3:])
    return "".join(out)


def _unquote_safe(value: str) -> str:
    return value.replace("%2F", "/").replace("%25", "%") if "%" in value else value


class _Resource:
    """One path template and the handlers of its methods (``aiohttp``'s
    ``PlainResource`` and ``DynamicResource``)."""

    def __init__(self, template: str):
        if not template.startswith("/"):
            raise ValueError(f"route {template!r} must start with /")
        self.template = template
        self.routes: dict[str, Handler] = {}
        pattern, canonical, dynamic = "", "", False
        for part in _ROUTE_PART.split(template):
            m = _DYN.fullmatch(part)
            if m:
                pattern += f"(?P<{m['var']}>{_GOOD})"
                canonical += "{" + m["var"] + "}"
                dynamic = True
                continue
            m = _DYN_WITH_RE.fullmatch(part)
            if m:
                pattern += f"(?P<{m['var']}>{m['re']})"
                canonical += "{" + m["var"] + "}"
                dynamic = True
                continue
            if "{" in part or "}" in part:
                raise ValueError(f"invalid route {template!r} at {part!r}")
            pattern += re.escape(part)
            canonical += part
        try:
            self._pattern = re.compile(pattern) if dynamic else None
        except re.error as e:
            raise ValueError(f"route {template!r}: bad pattern {pattern!r}: {e}") from None
        # aiohttp's index key: the literal prefix up to the last / before
        # the first variable.
        key = canonical.partition("{")[0].rpartition("/")[0] if dynamic else canonical
        self.key = key.rstrip("/") or "/"

    def add(self, method: str, handler: Handler) -> None:
        if method in self.routes or METH_ANY in self.routes:
            raise RuntimeError(f"route {method} {self.template} will never be executed: "
                               "its method is already registered")
        self.routes[method] = handler

    def match(self, path: str) -> dict[str, str] | None:
        if self._pattern is None:
            return {} if path == self.template else None
        m = self._pattern.fullmatch(path)
        if m is None:
            return None
        return {k: _unquote_safe(v) for k, v in m.groupdict().items()}


class Router:
    def __init__(self):
        self._resources: list[_Resource] = []
        self._index: dict[str, list[_Resource]] = {}

    def add_route(self, method: str, path: str, handler: Handler) -> None:
        """``method`` ``"*"`` takes any method. Consecutive routes of one
        template share a resource, as in ``aiohttp``."""
        if self._resources and self._resources[-1].template == path:
            resource = self._resources[-1]
        else:
            resource = _Resource(path)
            self._resources.append(resource)
            self._index.setdefault(resource.key, []).append(resource)
        resource.add(method.upper(), handler)

    def add_get(self, path: str, handler: Handler, *, allow_head: bool = True) -> None:
        self.add_route("GET", path, handler)
        if allow_head:
            self.add_route("HEAD", path, handler)

    def add_head(self, path: str, handler: Handler) -> None:
        self.add_route("HEAD", path, handler)

    def add_post(self, path: str, handler: Handler) -> None:
        self.add_route("POST", path, handler)

    def add_put(self, path: str, handler: Handler) -> None:
        self.add_route("PUT", path, handler)

    def add_patch(self, path: str, handler: Handler) -> None:
        self.add_route("PATCH", path, handler)

    def add_delete(self, path: str, handler: Handler) -> None:
        self.add_route("DELETE", path, handler)

    def resolve(self, method: str, raw_path: str) -> tuple[Handler, dict[str, str]]:
        """The handler and ``match_info`` for a request, tried in
        ``aiohttp``'s order; ``HTTPMethodNotAllowed`` (with ``Allow``) or
        ``HTTPNotFound`` when none takes it."""
        path = _path_safe(raw_path)
        allowed: set[str] = set()
        part = path
        while part:
            for resource in self._index.get(part, ()):
                info = resource.match(path)
                if info is None:
                    continue
                handler = resource.routes.get(method, resource.routes.get(METH_ANY))
                if handler is not None:
                    return handler, info
                allowed |= set(resource.routes)
            if part == "/":
                break
            part = part.rpartition("/")[0] or "/"
        if allowed:
            raise HTTPMethodNotAllowed(method, allowed)
        raise HTTPNotFound()


Middleware = Callable[["Request", Handler], Awaitable["StreamResponse"]]


def middleware(f: Middleware) -> Middleware:
    """Marks ``async def f(request, handler)`` as a middleware, as
    ``aiohttp.web.middleware`` does; it changes nothing else."""
    f.__middleware_version__ = 1
    return f


class Application(MutableMapping):
    """Routes and app-wide state. ``client_max_size`` caps what
    :meth:`Request.read` takes (413 at or above it), as in ``aiohttp``.
    ``middlewares`` wrap every request's handler, the first outermost, the
    router's own errors included. ``cleanup_ctx`` holds ``async def
    ctx(app)`` generators that yield once: :func:`serve` runs each to its
    ``yield`` before it listens, and ``AppRunner.cleanup()`` finishes
    them, last first."""

    def __init__(self, *, client_max_size: int = 1024 ** 2,
                 middlewares: list[Middleware] | tuple = ()):
        self.router = Router()
        self.client_max_size = client_max_size
        self.middlewares: list[Middleware] = list(middlewares)
        self.cleanup_ctx: list[Callable[["Application"], AsyncIterator[None]]] = []
        self._state: dict = {}

    def _handler(self, request: "Request") -> Handler:
        """The request's handler wrapped in the middlewares; a router
        error becomes a handler that raises it, so the chain sees it."""
        try:
            handler, request.match_info = self.router.resolve(request.method,
                                                              request.raw_path)
        except HTTPException as e:
            error = e

            async def handler(_request):
                raise error
        for m in reversed(self.middlewares):
            handler = functools.partial(m, handler=handler)
        return handler

    def __getitem__(self, key):
        return self._state[key]

    def __setitem__(self, key, value) -> None:
        self._state[key] = value

    def __delitem__(self, key) -> None:
        del self._state[key]

    def __iter__(self):
        return iter(self._state)

    def __len__(self) -> int:
        return len(self._state)


class Request:
    def __init__(self, app: Application, method: str, target: str, version: str,
                 headers: Headers, content: BodyReader, remote: str | None, conn):
        self.app = app
        self.method = method
        self.version = version
        self.headers = headers
        self.content = content
        self.remote = remote
        self._conn = conn
        raw, _, qs = target.partition("?")
        self.raw_path = raw
        self.path = unquote(raw)
        self.query: dict[str, str] = {}
        for k, v in parse_qsl(qs, keep_blank_values=True):
            self.query.setdefault(k, v)
        self.match_info: dict[str, str] = {}
        self._body: bytes | None = None

    @property
    def transport(self) -> asyncio.Transport | None:
        return self._conn.transport

    @property
    def http_range(self) -> slice:
        """The ``Range`` header as ``aiohttp`` reads it: ``slice(None, None,
        1)`` with no header, ``bytes=a-b`` as ``slice(a, b + 1, 1)``,
        ``bytes=a-`` as ``slice(a, None, 1)``, ``bytes=-n`` as ``slice(-n,
        None, 1)``; ``ValueError`` for any other form (multi-range,
        malformed, an end before its start)."""
        rng = self.headers.get("Range")
        start = end = None
        if rng is not None:
            found = re.findall(r"^bytes=(\d*)-(\d*)$", rng, re.ASCII)
            if not found:
                raise ValueError("range not in acceptable format")
            start_s, end_s = found[0]
            end = int(end_s) if end_s else None
            start = int(start_s) if start_s else None
            if start is None and end is not None:
                start, end = -end, None
            if start is not None and end is not None:
                end += 1
                if start >= end:
                    raise ValueError("start cannot be after end")
            if start is None and end is None:
                raise ValueError("No start or end of range specified")
        return slice(start, end, 1)

    async def read(self) -> bytes:
        if self._body is None:
            body = bytearray()
            limit = self.app.client_max_size
            while chunk := await self.content.readany():
                body += chunk
                if limit and len(body) >= limit:
                    raise HTTPRequestEntityTooLarge(max_size=limit, actual_size=len(body))
            self._body = bytes(body)
        return self._body

    async def text(self) -> str:
        return (await self.read()).decode("utf-8")

    async def json(self, *, loads=_json.loads) -> Any:
        return loads(await self.text())


class StreamResponse:
    """A response whose body the handler writes: ``await prepare(req)``,
    ``await write(data)``, ``await write_eof()``. With ``content_length``
    unset the body goes chunked."""

    def __init__(self, *, status: int = 200, reason: str | None = None,
                 headers=None):
        self.status = status
        self.reason = reason or _reason(status)
        self.headers = Headers(headers)
        self._conn = None
        self._chunked = False
        self._eof = False

    @property
    def content_length(self) -> int | None:
        cl = self.headers.get("Content-Length")
        return int(cl) if cl is not None else None

    @content_length.setter
    def content_length(self, n: int | None) -> None:
        if n is None:
            self.headers.pop("Content-Length", None)
        else:
            self.headers["Content-Length"] = str(int(n))

    @property
    def content_type(self) -> str:
        """The media type of ``Content-Type`` (``application/octet-stream``
        without one), lower case, parameters dropped, as ``aiohttp``."""
        raw = self.headers.get("Content-Type")
        if raw is None:
            return "application/octet-stream"
        return raw.split(";", 1)[0].strip().lower()

    @content_type.setter
    def content_type(self, value: str) -> None:
        self.headers["Content-Type"] = value

    def set_status(self, status: int, reason: str | None = None) -> None:
        self.status = status
        self.reason = reason or _reason(status)

    @property
    def prepared(self) -> bool:
        return self._conn is not None

    async def prepare(self, request: Request) -> None:
        if self._conn is not None:
            return
        self._conn = request._conn
        self._head_only = request.method == "HEAD"
        if self.content_length is None and not self._no_body():
            self.headers["Transfer-Encoding"] = "chunked"
            self._chunked = True
        await self._conn.send_head(self, request)

    def _no_body(self) -> bool:
        return self.status in (204, 304) or 100 <= self.status < 200

    async def write(self, data: bytes) -> None:
        if self._conn is None:
            raise RuntimeError("write() before prepare()")
        if not data or self._head_only or self._no_body():
            return
        if self._chunked:
            data = b"%x\r\n%s\r\n" % (len(data), bytes(data))
        await self._conn.write(data)

    async def write_eof(self, data: bytes = b"") -> None:
        if self._eof:
            return
        if data:
            await self.write(data)
        self._eof = True
        if self._chunked and not self._head_only:
            await self._conn.write(b"0\r\n\r\n")


class Response(StreamResponse):
    """A response whose whole body is known: ``body`` (bytes), or ``text``
    (``text/plain; charset=utf-8`` unless ``content_type`` says else)."""

    def __init__(self, *, body: bytes | bytearray | memoryview | None = None,
                 status: int = 200, reason: str | None = None, text: str | None = None,
                 headers=None, content_type: str | None = None, charset: str | None = None):
        super().__init__(status=status, reason=reason, headers=headers)
        if body is not None and text is not None:
            raise ValueError("body and text are not allowed together")
        self._ctype = content_type
        self._charset = charset
        self.body = None
        if text is not None:
            self.text = text
        elif body is not None:
            self.body = bytes(body)
            if "Content-Type" not in self.headers:
                ct = content_type or "application/octet-stream"
                self.headers["Content-Type"] = f"{ct}; charset={charset}" if charset else ct
        elif content_type is not None and "Content-Type" not in self.headers:
            self.headers["Content-Type"] = content_type

    @property
    def text(self) -> str | None:
        return None if self.body is None else self.body.decode(self._charset or "utf-8")

    @text.setter
    def text(self, text: str) -> None:
        self._charset = self._charset or "utf-8"
        self.body = text.encode(self._charset)
        ct = self._ctype or "text/plain"
        self.headers["Content-Type"] = f"{ct}; charset={self._charset}"


def json_response(data: Any = None, *, text: str | None = None, body: bytes | None = None,
                  status: int = 200, reason: str | None = None, headers=None,
                  content_type: str = "application/json", dumps=_json.dumps) -> Response:
    if data is not None and (text is not None or body is not None):
        raise ValueError("only one of data, text or body")
    if body is None and text is None:
        text = dumps(data)
    return Response(text=text, body=body, status=status, reason=reason, headers=headers,
                    content_type=content_type)


SENDFILE = True  # False: every FileResponse body goes by pread on a thread
FILE_CHUNK = 1 << 20


class FileResponse(StreamResponse):
    """A file's bytes, as ``aiohttp.web.FileResponse`` answers: 200, or 206
    with ``Content-Range`` for one byte range (a suffix, an end past the
    last byte clamped to it), 416 with ``Content-Range: bytes */size`` for
    a range that starts past the end or does not parse; ``Content-Length``,
    ``Accept-Ranges``, ``ETag`` and ``Last-Modified``; ``Content-Type``
    guessed from the name unless given; 404 for a missing file, 403 for one
    that is not regular. The body goes by ``loop.sendfile``, or 1 MiB
    ``pread`` calls on a thread where the transport cannot (TLS), never
    read on the loop."""

    def __init__(self, path, status: int = 200, reason: str | None = None, headers=None):
        super().__init__(status=status, reason=reason, headers=headers)
        self._path = os.fspath(path)

    def _open(self):
        st = os.stat(self._path)
        if not _stat.S_ISREG(st.st_mode):
            return None, st
        f = open(self._path, "rb")
        try:
            return f, os.fstat(f.fileno())
        except OSError:
            return f, st

    async def prepare(self, request: Request) -> None:
        if self.prepared:
            return
        try:
            f, st = await asyncio.to_thread(self._open)
        except PermissionError:
            return await self._answer(request, 403)
        except OSError:
            return await self._answer(request, 404)
        if f is None:
            return await self._answer(request, 403)
        try:
            await self._prepare_open(request, f, st)
        finally:
            await asyncio.to_thread(f.close)

    async def _answer(self, request: Request, status: int, size: int | None = None) -> None:
        """An answer with no body; ``size`` for a 416's ``Content-Range``."""
        if size is not None:
            self.headers["Content-Range"] = f"bytes */{size}"
        self.set_status(status)
        if request.method != "HEAD":
            self.headers.setdefault("Content-Type", "application/octet-stream")
        await super().prepare(request)

    async def _prepare_open(self, request: Request, f, st: os.stat_result) -> None:
        size, start, count = st.st_size, 0, st.st_size
        try:
            rng = request.http_range
        except ValueError:
            return await self._answer(request, 416, size)
        if rng.start is not None:
            start, end = rng.start, rng.stop
            if start < 0 and end is None:  # the last -start bytes
                start = max(0, start + size)
                count = size - start
            else:
                count = min(end if end is not None else size, size) - start
            if start >= size:
                return await self._answer(request, 416, size)
            self.set_status(206)
        if "Content-Type" not in self.headers:
            self.content_type = (mimetypes.guess_type(self._path)[0]
                                 or "application/octet-stream")
        self.headers["ETag"] = f'"{st.st_mtime_ns:x}-{st.st_size:x}"'
        # aiohttp rounds the time up to the whole second.
        self.headers["Last-Modified"] = email.utils.formatdate(math.ceil(st.st_mtime),
                                                               usegmt=True)
        self.content_length = count
        self.headers["Accept-Ranges"] = "bytes"
        if self.status == 206:
            self.headers["Content-Range"] = f"bytes {start}-{start + count - 1}/{size}"
        await super().prepare(request)
        if count == 0 or self._head_only or self._no_body():
            return
        await self._send_body(f, start, count)

    async def _send_body(self, f, offset: int, count: int) -> None:
        transport = self._conn.transport
        # asyncio's native sendfile takes a plain socket transport; its
        # fallback for the others (TLS) reads 16 KiB at a time.
        mode = getattr(transport, "_sendfile_compatible", None)
        if SENDFILE and getattr(mode, "name", "") == "TRY_NATIVE":
            if self._conn._lost or transport.is_closing():
                raise ConnectionResetError("connection lost")
            await asyncio.get_running_loop().sendfile(transport, f, offset, count)
            return
        fd, end = f.fileno(), offset + count
        while offset < end:
            chunk = await asyncio.to_thread(os.pread, fd, min(FILE_CHUNK, end - offset), offset)
            if not chunk:
                raise ConnectionResetError(f"{self._path} shrank under its response")
            offset += len(chunk)
            await self.write(chunk)


class HTTPException(Response, Exception):
    """A response raised from a handler: the connection answers with it.
    With no ``text`` the body is ``"<status>: <reason>"``."""

    status_code = -1

    def __init__(self, *, headers=None, reason: str | None = None, text: str | None = None,
                 content_type: str | None = None):
        Response.__init__(self, status=self.status_code, headers=headers, reason=reason,
                          text=text, content_type=content_type)
        Exception.__init__(self, self.reason)
        if self.body is None:
            self.text = f"{self.status}: {self.reason}"

    def __bool__(self) -> bool:
        return True


class HTTPError(HTTPException):
    """The 4xx and 5xx responses."""


class HTTPBadRequest(HTTPError):
    status_code = 400


class HTTPUnauthorized(HTTPError):
    status_code = 401


class HTTPForbidden(HTTPError):
    status_code = 403


class HTTPNotFound(HTTPError):
    status_code = 404


class HTTPNotAcceptable(HTTPError):
    status_code = 406


class HTTPConflict(HTTPError):
    status_code = 409


class HTTPRequestRangeNotSatisfiable(HTTPError):
    status_code = 416


class HTTPTooManyRequests(HTTPError):
    status_code = 429


class HTTPInternalServerError(HTTPError):
    status_code = 500


class HTTPBadGateway(HTTPError):
    status_code = 502


class HTTPServiceUnavailable(HTTPError):
    status_code = 503


class HTTPGatewayTimeout(HTTPError):
    status_code = 504


class HTTPMethodNotAllowed(HTTPError):
    status_code = 405

    def __init__(self, method: str, allowed_methods, **kw):
        allowed = sorted(allowed_methods)
        headers = Headers(kw.pop("headers", None))
        headers["Allow"] = ",".join(allowed)
        super().__init__(headers=headers, **kw)
        self.method = method.upper()
        self.allowed_methods = set(allowed)


class HTTPRequestEntityTooLarge(HTTPError):
    status_code = 413

    def __init__(self, max_size: int, actual_size: int, **kw):
        kw.setdefault("text", f"Maximum request body size {max_size} exceeded, "
                              f"actual body size {actual_size}")
        super().__init__(**kw)


class _ServerConn(asyncio.Protocol):
    """One accepted connection: requests in turn, keep-alive, each handler
    run in the connection's task, which a lost connection cancels
    (``handler_cancellation``)."""

    def __init__(self, runner: "AppRunner"):
        self._runner = runner
        self._app = runner.app
        self.transport: asyncio.Transport | None = None
        self._reader = asyncio.StreamReader(limit=STREAM_LIMIT)
        self._task: asyncio.Task | None = None
        self._paused = False
        self._drain: asyncio.Future | None = None
        self._lost = False
        self._close_after = False

    # -- asyncio.Protocol
    def connection_made(self, transport) -> None:
        self.transport = transport
        self._reader.set_transport(transport)
        self._runner._conns.add(self)
        self._task = asyncio.get_running_loop().create_task(self._serve())

    def data_received(self, data: bytes) -> None:
        self._reader.feed_data(data)

    def eof_received(self) -> None:
        # As aiohttp: the client's EOF ends the connection, and so cancels
        # a handler still running for it.
        self._reader.feed_eof()

    def connection_lost(self, exc) -> None:
        self._lost = True
        self._reader.feed_eof()
        self._runner._conns.discard(self)
        self._wake_drain(ConnectionResetError("connection lost"))
        if self._task is not None and not self._task.done():
            self._task.cancel()

    def pause_writing(self) -> None:
        self._paused = True

    def resume_writing(self) -> None:
        self._paused = False
        self._wake_drain(None)

    def _wake_drain(self, exc) -> None:
        w, self._drain = self._drain, None
        if w is not None and not w.done():
            if exc is None:
                w.set_result(None)
            else:
                w.set_exception(exc)

    async def write(self, data: bytes) -> None:
        if self._lost or self.transport.is_closing():
            raise ConnectionResetError("connection lost")
        self.transport.write(data)
        if self._paused:
            self._drain = asyncio.get_running_loop().create_future()
            await self._drain

    async def send_head(self, resp: StreamResponse, request: Request | None) -> None:
        if self._close_after:
            resp.headers["Connection"] = "close"
        elif request is not None and request.version == "HTTP/1.0":
            resp.headers["Connection"] = "keep-alive"
        lines = [f"HTTP/1.1 {resp.status} {resp.reason}"]
        lines += [f"{k}: {v}" for k, v in resp.headers.pairs()]
        await self.write(("\r\n".join(lines) + "\r\n\r\n").encode("latin-1"))

    async def _send(self, resp: StreamResponse, request: Request | None) -> None:
        if not resp.prepared and not isinstance(resp, Response) and request is not None:
            await resp.prepare(request)  # a FileResponse, or a handler's unprepared stream
        if resp.prepared:
            await resp.write_eof()
            return
        body = resp.body or b""
        if resp._no_body():
            body = b""
            resp.headers.pop("Content-Length", None)
        elif not (body == b"" and request is not None and request.method == "HEAD"
                  and "Content-Length" in resp.headers):
            # A HEAD answer keeps the length its handler stated, as aiohttp.
            resp.content_length = len(body)
        await self.send_head(resp, request)
        if body and (request is None or request.method != "HEAD"):
            await self.write(body)

    # -- the request loop
    async def _serve(self) -> None:
        try:
            first = True
            while not self._close_after:
                wait = None if first else self._runner.keepalive_timeout
                first = False
                try:
                    async with asyncio.timeout(wait):
                        head = await _read_head(self._reader)
                except TimeoutError:
                    return
                except _HeadError as e:
                    self._close_after = True
                    await self._send(HTTPBadRequest(text=str(e)), None)
                    return
                if head is None:
                    return
                request = self._request(*head)
                if request is None:
                    await self._send(HTTPBadRequest(text="malformed request"), None)
                    return
                resp = await self._dispatch(request)
                await self._send(resp, request)
                if not self._close_after:
                    # The next request starts after this one's body.
                    try:
                        async with asyncio.timeout(self._runner.keepalive_timeout):
                            while await request.content.readany():
                                pass
                    except (TimeoutError, ConnectionError):
                        return
        except ConnectionError:
            return
        finally:
            if self.transport is not None:
                self.transport.close()

    def _request(self, start: str, headers: Headers) -> Request | None:
        parts = start.split(" ")
        if len(parts) != 3 or not parts[2].startswith("HTTP/1.") or not parts[1]:
            self._close_after = True
            return None
        method, target, version = parts
        self._close_after = _wants_close(version, headers)
        try:
            content = _body_reader(self._reader, headers, ConnectionResetError,
                                   default_eof=False)
        except _HeadError:
            self._close_after = True
            return None
        peer = self.transport.get_extra_info("peername")
        return Request(self._app, method.upper(), target, version, headers, content,
                       peer[0] if peer else None, self)

    async def _dispatch(self, request: Request) -> StreamResponse:
        try:
            if not request.raw_path.startswith("/"):
                raise HTTPBadRequest(text="request target must be a path")
            resp = await self._app._handler(request)(request)
            if not isinstance(resp, StreamResponse):
                raise RuntimeError(f"handler returned {type(resp).__name__}, not a response")
            return resp
        except HTTPException as e:
            return e
        except ConnectionError:
            raise
        except Exception:
            _log.exception("http handler failed: %s %s", request.method, request.path)
            return HTTPInternalServerError(
                text="500 Internal Server Error\n\nServer got itself in trouble")


class AppRunner:
    """The listener and its connections; :meth:`cleanup` finishes the
    app's ``cleanup_ctx`` and closes both. A second ``cleanup()`` does
    nothing."""

    def __init__(self, app: Application, keepalive_timeout: float = 75.0):
        self.app = app
        self.keepalive_timeout = keepalive_timeout
        self._server: asyncio.Server | None = None
        self._conns: set[_ServerConn] = set()
        self._contexts: list[AsyncIterator[None]] = []  # started cleanup_ctx

    async def start(self, host: str, port: int, ssl_context=None) -> int:
        loop = asyncio.get_running_loop()
        try:
            for ctx in self.app.cleanup_ctx:
                gen = ctx(self.app)
                await gen.__anext__()
                self._contexts.append(gen)
            self._server = await loop.create_server(lambda: _ServerConn(self), host,
                                                    port, ssl=ssl_context)
        except BaseException:
            await self._finish_contexts()  # what they raise yields to this
            raise
        return self._server.sockets[0].getsockname()[1]

    async def _finish_contexts(self) -> list[Exception]:
        """Finish every started context, last first; returns what they
        raised, as ``aiohttp`` collects it."""
        errors: list[Exception] = []
        while self._contexts:
            gen = self._contexts.pop()
            try:
                await gen.__anext__()
            except StopAsyncIteration:
                continue
            except Exception as e:
                errors.append(e)
            else:
                errors.append(RuntimeError(f"cleanup_ctx {gen!r} yielded more than once"))
        return errors

    async def cleanup(self) -> None:
        """Finish the contexts, then close the listener and connections;
        only then raise what the contexts raised: one error as itself,
        more as a :class:`CleanupError`."""
        errors = await self._finish_contexts()
        if self._server is not None:
            self._server.close()
        tasks = []
        for conn in list(self._conns):
            if conn._task is not None:
                conn._task.cancel()
                tasks.append(conn._task)
            if conn.transport is not None:
                conn.transport.abort()
        if tasks:
            await asyncio.gather(*tasks, return_exceptions=True)
        if self._server is not None:
            await self._server.wait_closed()
            self._server = None
        if len(errors) == 1:
            raise errors[0]
        if errors:
            raise CleanupError("Multiple errors on cleanup stage", errors)


class CleanupError(RuntimeError):
    """More than one ``cleanup_ctx`` failed to finish."""

    @property
    def exceptions(self) -> list[Exception]:
        return self.args[1]


async def serve(app: Application, host: str, port: int,
                ssl_context: _ssl.SSLContext | None = None) -> tuple[AppRunner, int]:
    """Listen on ``host:port`` (0: any free port); returns the runner and
    the bound port."""
    runner = AppRunner(app)
    bound = await runner.start(host, port, ssl_context)
    return runner, bound


# -- client ------------------------------------------------------------------


class ClientError(Exception):
    """Every error the client raises, but timeouts."""


class ClientConnectionError(ClientError, ConnectionError):
    """The connection failed: refused, reset or closed by the server."""


class ClientConnectorError(ClientConnectionError):
    """The connection could not be opened."""


class ServerDisconnectedError(ClientConnectionError):
    """The server closed the connection before its answer."""


class ClientPayloadError(ClientError):
    """A response body cut short or malformed."""


class ClientResponseError(ClientError):
    """A response head that does not parse, or too many redirects."""


class TooManyRedirects(ClientResponseError):
    pass


@dataclass(frozen=True)
class ClientTimeout:
    total: float | None = None  # seconds for a request, its body read included


class _ClientConn:
    def __init__(self, key, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        self.key = key
        self.reader = reader
        self.writer = writer
        self.idle_since = 0.0

    def usable(self, keepalive: float) -> bool:
        return (not self.writer.transport.is_closing() and not self.reader.at_eof()
                and time.monotonic() - self.idle_since < keepalive)

    def close(self) -> None:
        self.writer.transport.abort()


class ClientResponse:
    def __init__(self, method: str, url: str, status: int, reason: str, version: str,
                 headers: Headers, content: BodyReader, conn: _ClientConn,
                 session: "ClientSession"):
        self.method = method
        self.url = url
        self.status = status
        self.reason = reason
        self.version = version
        self.headers = headers
        self.content = content
        self._conn: _ClientConn | None = conn
        self._session = session
        self._keep = not _wants_close(version, headers) and not (
            content._remaining is None and not content._chunked and not content.at_eof)
        self._body: bytes | None = None
        if content.at_eof:
            self.release()

    async def read(self) -> bytes:
        if self._body is None:
            try:
                self._body = await self.content.read()
            except BaseException:
                self.close()
                raise
            self.release()
        return self._body

    async def text(self, encoding: str = "utf-8") -> str:
        return (await self.read()).decode(encoding)

    async def json(self, *, loads=_json.loads) -> Any:
        return loads(await self.text())

    def release(self) -> None:
        """Hand the connection back to the pool when its body was read
        whole and the server keeps it alive; close it otherwise."""
        conn, self._conn = self._conn, None
        if conn is None:
            return
        if self.content.at_eof and self._keep:
            self._session._put(conn)
        else:
            self._session._discard(conn)

    def close(self) -> None:
        conn, self._conn = self._conn, None
        if conn is not None:
            self._session._discard(conn)

    async def __aenter__(self) -> "ClientResponse":
        return self

    async def __aexit__(self, *exc) -> None:
        self.release()


class _RequestContext:
    """``await session.request(...)`` or ``async with session.request(...)
    as resp``."""

    def __init__(self, coro):
        self._coro = coro
        self._resp: ClientResponse | None = None

    def __await__(self):
        return self._coro.__await__()

    async def __aenter__(self) -> ClientResponse:
        self._resp = await self._coro
        return self._resp

    async def __aexit__(self, *exc) -> None:
        self._resp.release()


class ClientSession:
    """Pooled keep-alive HTTP/1.1 connections per (scheme, host, port)."""

    def __init__(self, *, timeout: ClientTimeout | None = None,
                 ssl: _ssl.SSLContext | None = None, keepalive_timeout: float = 15.0):
        self.timeout = timeout or ClientTimeout(total=300.0)
        self._ssl = ssl
        self.keepalive_timeout = keepalive_timeout
        self._idle: dict[tuple, list[_ClientConn]] = {}
        self._busy: set[_ClientConn] = set()
        self.closed = False

    def request(self, method: str, url: str, *, data: Any = None, headers=None,
                timeout: ClientTimeout | float | None = None,
                allow_redirects: bool = True) -> _RequestContext:
        return _RequestContext(self._request(method, url, data, headers, timeout,
                                             allow_redirects))

    def get(self, url: str, **kw) -> _RequestContext:
        return self.request("GET", url, **kw)

    async def close(self) -> None:
        self.closed = True
        for conns in self._idle.values():
            for c in conns:
                c.close()
        self._idle.clear()
        for c in list(self._busy):
            c.close()
        self._busy.clear()

    async def __aenter__(self) -> "ClientSession":
        return self

    async def __aexit__(self, *exc) -> None:
        await self.close()

    # -- the pool
    def _put(self, conn: _ClientConn) -> None:
        self._busy.discard(conn)
        if self.closed:
            conn.close()
            return
        conn.idle_since = time.monotonic()
        self._idle.setdefault(conn.key, []).append(conn)

    def _discard(self, conn: _ClientConn) -> None:
        self._busy.discard(conn)
        conn.close()

    def _pooled(self, key) -> _ClientConn | None:
        conns = self._idle.get(key, [])
        while conns:
            conn = conns.pop()
            if conn.usable(self.keepalive_timeout):
                return conn
            conn.close()
        return None

    async def _connect(self, key) -> _ClientConn:
        scheme, host, port = key
        ctx = None
        if scheme == "https":
            ctx = self._ssl if self._ssl is not None else _ssl.create_default_context()
        try:
            reader, writer = await asyncio.open_connection(
                host, port, ssl=ctx, server_hostname=host if ctx else None,
                limit=STREAM_LIMIT)
        except OSError as e:
            raise ClientConnectorError(f"cannot connect to {host}:{port}: {e}") from e
        return _ClientConn(key, reader, writer)

    # -- one request
    async def _request(self, method, url, data, headers, timeout, allow_redirects):
        if self.closed:
            raise RuntimeError("session is closed")
        method = method.upper()
        if isinstance(timeout, ClientTimeout):
            total = timeout.total
        elif timeout is not None:
            total = float(timeout)
        else:
            total = self.timeout.total
        loop = asyncio.get_running_loop()
        deadline = None if total is None else loop.time() + total
        async with asyncio.timeout_at(deadline):
            for _ in range(MAX_REDIRECTS + 1):
                resp = await self._once(method, url, data, headers, deadline)
                location = resp.headers.get("Location")
                if not (allow_redirects and resp.status in REDIRECTS and location):
                    return resp
                await resp.read()
                url = urljoin(url, location)
                if resp.status == 303 and method != "HEAD" or (
                        resp.status in (301, 302) and method == "POST"):
                    method, data = "GET", None
            raise TooManyRedirects(f"more than {MAX_REDIRECTS} redirects: {url}")

    async def _once(self, method, url, data, headers, deadline) -> ClientResponse:
        parts = urlsplit(url)
        if parts.scheme not in ("http", "https") or not parts.hostname:
            raise ValueError(f"not an http(s) URL: {url!r}")
        port = parts.port or (443 if parts.scheme == "https" else 80)
        key = (parts.scheme, parts.hostname, port)
        target = (parts.path or "/") + (f"?{parts.query}" if parts.query else "")
        hdrs = Headers(headers)
        host = parts.hostname if port in (80, 443) else f"{parts.hostname}:{port}"
        hdrs.setdefault("Host", host)
        hdrs.setdefault("Accept", "*/*")
        body, chunks = self._body(data, hdrs, method)
        retry = method in IDEMPOTENT_METHODS and chunks is None
        while True:
            conn = self._pooled(key)
            reused = conn is not None
            if conn is None:
                conn = await self._connect(key)
            self._busy.add(conn)
            try:
                status_head = await self._exchange(conn, method, target, hdrs, body, chunks)
            except TimeoutError:
                self._discard(conn)
                raise
            except (OSError, asyncio.IncompleteReadError) as e:
                self._discard(conn)
                if reused and retry:
                    retry = False
                    continue
                if isinstance(e, ClientConnectionError):
                    raise
                raise ServerDisconnectedError(f"{method} {url}: {e!r}") from e
            except BaseException:
                self._discard(conn)
                raise
            break
        start, rhdrs = status_head
        version, _, rest = start.partition(" ")
        code, _, reason = rest.partition(" ")
        try:
            no_body = method == "HEAD" or code in ("204", "304")
            content = (BodyReader(None, 0, False, ClientPayloadError, deadline) if no_body
                       else _body_reader(conn.reader, rhdrs, ClientPayloadError,
                                         default_eof=True, deadline=deadline))
        except _HeadError as e:
            self._discard(conn)
            raise ClientResponseError(f"{method} {url}: {e}") from e
        return ClientResponse(method, url, int(code), reason, version, rhdrs, content,
                              conn, self)

    @staticmethod
    def _body(data, hdrs: Headers, method: str):
        """(bytes, None) for a known body, (None, async iterable) for a
        chunked one."""
        if data is None:
            if method in ("POST", "PUT", "PATCH"):
                hdrs.setdefault("Content-Length", "0")
            return b"", None
        if isinstance(data, str):
            hdrs.setdefault("Content-Type", "text/plain; charset=utf-8")
            data = data.encode("utf-8")
        if isinstance(data, (bytes, bytearray, memoryview)):
            hdrs.setdefault("Content-Type", "application/octet-stream")
            hdrs["Content-Length"] = str(len(data))
            return bytes(data), None
        if hasattr(data, "__aiter__"):
            hdrs.setdefault("Content-Type", "application/octet-stream")
            hdrs["Transfer-Encoding"] = "chunked"
            return b"", data
        raise TypeError(f"unsupported request body {type(data).__name__}")

    async def _exchange(self, conn: _ClientConn, method, target, hdrs, body, chunks):
        head = [f"{method} {target} HTTP/1.1"] + [f"{k}: {v}" for k, v in hdrs.pairs()]
        w = conn.writer
        w.write(("\r\n".join(head) + "\r\n\r\n").encode("latin-1") + body)
        await w.drain()
        if chunks is not None:
            async for chunk in chunks:
                if chunk:
                    w.write(b"%x\r\n%s\r\n" % (len(chunk), bytes(chunk)))
                    await w.drain()
            w.write(b"0\r\n\r\n")
            await w.drain()
        while True:
            try:
                got = await _read_head(conn.reader)
            except _HeadError as e:
                raise ClientResponseError(f"{method} {target}: {e}") from e
            if got is None:
                raise ServerDisconnectedError("server closed the connection")
            start, rhdrs = got
            if not start.startswith("HTTP/1.") or len(start.split(" ", 2)) < 2:
                raise ClientResponseError(f"malformed status line {start[:64]!r}")
            code = start.split(" ", 2)[1]
            if not (code.isdigit() and len(code) == 3):
                raise ClientResponseError(f"malformed status line {start[:64]!r}")
            if code.startswith("1"):
                continue  # an interim answer (100 Continue)
            return start, rhdrs
