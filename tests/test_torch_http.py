"""The port's HTTP/1.1 (``kraken_tpu_torch.utils.http_lite``) against
``aiohttp`` both ways -- the port's client against an ``aiohttp`` server and
an ``aiohttp`` client against the port's server (and the port against
itself) -- on one app written once against the shared names; then the
retrying client (``utils/httputil.py``), the JAX ``HTTPClient`` and the
port's on one ``aiohttp`` server, with their exceptions compared through a
stated mapping."""

import asyncio
import hashlib
import json
import os
import socket
import time
from urllib.parse import quote

import aiohttp
import multidict
import numpy as np
import pytest
from aiohttp import web
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

import kraken_tpu.utils.deadline as jax_deadline
import kraken_tpu.utils.failpoints as jax_failpoints
import kraken_tpu.utils.httputil as jax_httputil
import kraken_tpu_torch.utils.deadline as port_deadline
import kraken_tpu_torch.utils.failpoints as port_failpoints
import kraken_tpu_torch.utils.httputil as port_httputil
from kraken_tpu.utils.backoff import Backoff as JaxBackoff
from kraken_tpu_torch.utils import http_lite
from kraken_tpu_torch.utils.backoff import Backoff as PortBackoff

MiB = 1 << 20
WEB = {"port": http_lite, "aiohttp": web}
CLIENT = {"port": http_lite, "aiohttp": aiohttp}
# (server, client)
PAIRS = [("port", "aiohttp"), ("aiohttp", "port"), ("port", "port")]
PAIR_IDS = [f"{s}-server-{c}-client" for s, c in PAIRS]
STATUSES = (200, 201, 204, 400, 404, 409, 503)
VERBS = ("GET", "POST", "PUT", "PATCH", "DELETE", "HEAD")


def blob_of(n: int, seed: int) -> bytes:
    return np.random.default_rng(seed).integers(0, 256, n, dtype=np.uint8).tobytes()


def build_app(w, state: dict):
    """One app on either server: ``w`` is ``aiohttp.web`` or ``http_lite``."""
    app = w.Application(client_max_size=4 * MiB)
    errors = {400: w.HTTPBadRequest, 404: w.HTTPNotFound, 409: w.HTTPConflict,
              503: w.HTTPServiceUnavailable}

    async def status(req):
        code = int(req.match_info["code"])
        body = await req.read()
        state.setdefault("hits", []).append((req.method, code))
        if code in errors:
            raise errors[code](text=f"no {code}",
                               headers={"Retry-After": "7"} if code == 503 else None)
        if code == 204:
            return w.Response(status=204)
        return w.json_response({"method": req.method, "len": len(body)}, status=code,
                               headers={"X-Seen": req.headers.get("X-Test", "")})

    async def echo(req):
        h, n = hashlib.sha256(), 0
        if req.query.get("stream"):
            async for chunk in req.content.iter_chunked(65536):
                h.update(chunk)
                n += len(chunk)
        else:
            body = await req.read()
            h.update(body)
            n = len(body)
        return w.json_response({"len": n, "sha": h.hexdigest(),
                                "chunked": "chunked" in req.headers.get("Transfer-Encoding", "")})

    async def blob(req):
        data = blob_of(int(req.match_info["n"]), 7)
        if not req.query.get("chunked"):
            return w.Response(body=data)
        resp = w.StreamResponse()
        await resp.prepare(req)
        for off in range(0, len(data), 50_000):
            await resp.write(data[off:off + 50_000])
        await resp.write_eof()
        return resp

    async def seg(req):
        return w.json_response({"seg": req.match_info["seg"],
                                "echo": req.headers.get("X-Echo")})

    async def peer(req):
        return w.json_response({"port": req.transport.get_extra_info("peername")[1]})

    async def slow(req):
        state["started"].set()
        try:
            await asyncio.sleep(30)
        finally:
            state["cancelled"] = True
        return w.Response(text="late")

    for add in (app.router.add_get, app.router.add_post, app.router.add_put,
                app.router.add_patch, app.router.add_delete):
        add("/status/{code}", status)
    app.router.add_post("/echo", echo)
    app.router.add_get("/blob/{n}", blob)
    app.router.add_get("/seg/{seg}/tail", seg)
    app.router.add_get("/peer", peer)
    app.router.add_get("/slow", slow)
    return app


async def start(kind: str, app) -> tuple:
    """Serve ``app`` on a free port; returns (port, stop)."""
    if kind == "port":
        runner, port = await http_lite.serve(app, "127.0.0.1", 0)
        return port, runner.cleanup
    runner = web.AppRunner(app, handler_cancellation=True)
    await runner.setup()
    site = web.TCPSite(runner, "127.0.0.1", 0)
    await site.start()
    return site._server.sockets[0].getsockname()[1], runner.cleanup


def run_pair(server: str, client: str, body, **state):
    """``body(session, base_url, state)`` against a fresh server."""
    state = {"started": None, **state}

    async def main():
        state["started"] = asyncio.Event()
        port, stop = await start(server, build_app(WEB[server], state))
        session = CLIENT[client].ClientSession()
        try:
            return await body(session, f"http://127.0.0.1:{port}", state)
        finally:
            await session.close()
            await stop()

    return asyncio.run(main())


# -- http_lite against aiohttp, both ways --------------------------------------


@pytest.mark.parametrize("code", STATUSES)
@pytest.mark.parametrize("server,client", PAIRS, ids=PAIR_IDS)
def test_each_verb_and_status_with_their_bodies_and_headers(server, client, code):
    async def body(session, base, state):
        for verb in VERBS:
            data = None if verb in ("GET", "HEAD") else b"xyz"
            async with session.request(verb, f"{base}/status/{code}", data=data,
                                       headers={"X-Test": verb.lower()}) as r:
                got = await r.read()
                assert r.status == code, verb
                if verb == "HEAD" or code == 204:
                    assert got == b""
                elif code >= 400:
                    assert got == f"no {code}".encode()
                    assert r.headers["Content-Type"] == "text/plain; charset=utf-8"
                    assert r.headers.get("Retry-After") == ("7" if code == 503 else None)
                else:
                    assert r.headers["Content-Type"] == "application/json; charset=utf-8"
                    assert await r.json() == {"method": verb, "len": 0 if data is None else 3}
                    assert r.headers["X-Seen"] == verb.lower()
                if verb == "HEAD" and code in (200, 201):
                    assert int(r.headers["Content-Length"]) > 0
        return state["hits"]

    hits = run_pair(server, client, body)
    assert hits == [(v, code) for v in VERBS]


@pytest.mark.parametrize("stream", [False, True], ids=["read", "content-stream"])
@pytest.mark.parametrize("chunked", [False, True], ids=["content-length", "chunked"])
@pytest.mark.parametrize("server,client", PAIRS, ids=PAIR_IDS)
def test_request_bodies_up_to_one_mib(server, client, chunked, stream):
    sizes = (0, 1, 70_001, MiB)

    async def body(session, base, state):
        out = []
        for n in sizes:
            data = blob_of(n, n)

            async def pieces(data=data):
                for off in range(0, len(data), 100_000):
                    yield data[off:off + 100_000]

            url = f"{base}/echo" + ("?stream=1" if stream else "")
            async with session.request("POST", url, data=pieces() if chunked else data) as r:
                assert r.status == 200
                out.append((await r.json(), hashlib.sha256(data).hexdigest()))
        return out

    for (got, want), n in zip(run_pair(server, client, body), sizes):
        assert got == {"len": n, "sha": want, "chunked": chunked}


@pytest.mark.parametrize("chunked", [False, True], ids=["content-length", "chunked"])
@pytest.mark.parametrize("server,client", PAIRS, ids=PAIR_IDS)
def test_response_bodies_whole_and_by_iter_chunked(server, client, chunked):
    async def body(session, base, state):
        out = []
        for n in (0, 1, 123_457, MiB):
            q = "?chunked=1" if chunked else ""
            async with session.request("GET", f"{base}/blob/{n}{q}") as r:
                whole = await r.read()
                assert ("chunked" in r.headers.get("Transfer-Encoding", "")) == chunked
            async with session.request("GET", f"{base}/blob/{n}{q}") as r:
                parts = [c async for c in r.content.iter_chunked(4096)]
                assert all(0 < len(c) <= 4096 for c in parts)
            out.append((n, whole, b"".join(parts)))
        return out

    for n, whole, parts in run_pair(server, client, body):
        assert whole == parts == blob_of(n, 7)


@pytest.mark.parametrize("server,client", PAIRS, ids=PAIR_IDS)
def test_keep_alive_reuses_one_socket_and_connection_close_does_not(server, client):
    async def body(session, base, state):
        kept = []
        for _ in range(6):
            async with session.request("GET", f"{base}/peer") as r:
                kept.append((await r.json())["port"])
        closed = []
        for _ in range(3):
            async with session.request("GET", f"{base}/peer",
                                       headers={"Connection": "close"}) as r:
                closed.append((await r.json())["port"])
                assert r.headers.get("Connection", "").lower() == "close"
        return kept, closed

    kept, closed = run_pair(server, client, body)
    assert len(set(kept)) == 1
    # The first close rides the pooled socket; each one after needs its own.
    assert closed[0] == kept[0] and len(set(closed)) == 3


@pytest.mark.parametrize("server,client", PAIRS, ids=PAIR_IDS)
def test_percent_2f_stays_inside_its_segment(server, client):
    segs = {"library%2Ffleet": "library/fleet", "a%252Fb": "a%2Fb",
            "caf%C3%A9": "café", "plain": "plain"}

    async def body(session, base, state):
        out = {}
        for raw in segs:
            async with session.request("GET", f"{base}/seg/{raw}/tail") as r:
                assert r.status == 200, raw
                out[raw] = (await r.json())["seg"]
            async with session.request("GET", f"{base}/seg/a/b/tail") as r:
                assert r.status == 404  # a bare / splits the route
            async with session.request("GET", f"{base}/seg/a%7Bb/tail") as r:
                assert r.status == 404  # aiohttp's [^{}/]+ over the decoded value
        return out

    assert run_pair(server, client, body) == segs


@pytest.mark.parametrize("server", ["port", "aiohttp"])
def test_a_client_that_disconnects_mid_request_cancels_the_handler(server):
    state = {"cancelled": False}

    async def main():
        state["started"] = asyncio.Event()
        port, stop = await start(server, build_app(WEB[server], state))
        try:
            reader, writer = await asyncio.open_connection("127.0.0.1", port)
            writer.write(b"GET /slow HTTP/1.1\r\nHost: x\r\n\r\n")
            await writer.drain()
            await asyncio.wait_for(state["started"].wait(), 5)
            writer.close()
            for _ in range(200):
                if state["cancelled"]:
                    break
                await asyncio.sleep(0.01)
        finally:
            await stop()

    asyncio.run(main())
    assert state["cancelled"]


@pytest.mark.parametrize("server", ["port", "aiohttp"])
def test_malformed_requests_oversize_bodies_and_http_1_0(server):
    """A head that does not parse is a 400; a body at ``client_max_size``
    a 413; an HTTP/1.0 request without keep-alive closes its connection."""

    async def raw(port, data: bytes) -> bytes:
        reader, writer = await asyncio.open_connection("127.0.0.1", port)
        writer.write(data)
        await writer.drain()
        got = await asyncio.wait_for(reader.read(), 5)  # until the server closes
        writer.close()
        return got

    async def main():
        port, stop = await start(server, build_app(WEB[server], {"started": None}))
        try:
            bad = await raw(port, b"NOT A REQUEST\r\n\r\n")
            big = 4 * MiB
            async with CLIENT["port"].ClientSession() as session:
                async with session.request("POST", f"http://127.0.0.1:{port}/echo",
                                           data=b"x" * big) as r:
                    too_big = (r.status, await r.text())
            old = await raw(port, b"GET /seg/x/tail HTTP/1.0\r\nHost: x\r\n\r\n")
        finally:
            await stop()
        return bad, too_big, old

    bad, too_big, old = asyncio.run(main())
    assert bad.split(b" ", 2)[1] == b"400"  # aiohttp answers as HTTP/1.0 here
    assert too_big == (413, f"Maximum request body size {4 * MiB} exceeded, "
                            f"actual body size {4 * MiB}")
    assert old.split(b" ", 2)[1] == b"200" and old.endswith(b'{"seg": "x", "echo": null}')


@pytest.mark.parametrize("server,client", PAIRS, ids=PAIR_IDS)
def test_a_request_past_its_timeout_raises_asyncio_timeout_error(server, client):
    async def body(session, base, state):
        t0 = time.monotonic()
        with pytest.raises(asyncio.TimeoutError):
            async with session.request("GET", f"{base}/slow",
                                       timeout=CLIENT[client].ClientTimeout(total=0.2)) as r:
                await r.read()
        return time.monotonic() - t0

    assert run_pair(server, client, body) < 2.0


_SEG = st.text(st.characters(codec="utf-8", exclude_characters="/{}"), min_size=1, max_size=24)
_VALUE = st.text(st.characters(min_codepoint=0x21, max_codepoint=0x7E), min_size=1,
                 max_size=40).map(str.strip).filter(bool)


@pytest.mark.parametrize("server,client", PAIRS, ids=PAIR_IDS)
@settings(max_examples=25, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(seg=_SEG, value=_VALUE)
def test_path_segments_and_header_values_round_trip(server, client, seg, value):
    async def body(session, base, state):
        async with session.request("GET", f"{base}/seg/{quote(seg, safe='')}/tail",
                                   headers={"X-Echo": value}) as r:
            assert r.status == 200
            return await r.json()

    assert run_pair(server, client, body) == {"seg": seg, "echo": value}


@pytest.mark.parametrize("client", ["port", "aiohttp"])
def test_a_refused_connection_raises_at_once(client):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]  # closed again: nothing listens there

    async def main():
        session = CLIENT[client].ClientSession()
        t0 = time.monotonic()
        try:
            with pytest.raises(CLIENT[client].ClientConnectionError):
                await session.request("GET", f"http://127.0.0.1:{port}/x")
        finally:
            await session.close()
        return time.monotonic() - t0

    assert asyncio.run(main()) < 1.0


async def _dropping_server():
    """Answers a connection's first request keep-alive, then reads the
    second and closes without an answer (a keep-alive race)."""
    conns = []

    async def handle(reader, writer):
        conns.append(writer)
        n = 0
        try:
            while True:
                head = await reader.readuntil(b"\r\n\r\n")
                if b"Content-Length: " in head:
                    size = int(head.split(b"Content-Length: ")[1].split(b"\r\n")[0])
                    await reader.readexactly(size)
                n += 1
                if n == 2:
                    return
                writer.write(b"HTTP/1.1 200 OK\r\nContent-Length: 2\r\n\r\nok")
                await writer.drain()
        except (asyncio.IncompleteReadError, ConnectionError):
            return
        finally:
            writer.close()

    server = await asyncio.start_server(handle, "127.0.0.1", 0)
    return server, conns


@pytest.mark.parametrize("client", ["port", "aiohttp"])
def test_a_pooled_connection_the_server_dropped_is_retried_once_if_idempotent(client):
    async def main():
        server, conns = await _dropping_server()
        url = f"http://127.0.0.1:{server.sockets[0].getsockname()[1]}/"
        session = CLIENT[client].ClientSession()
        try:
            async with session.request("GET", url) as r:
                assert await r.read() == b"ok"
            async with session.request("GET", url) as r:  # retried on a new socket
                assert await r.read() == b"ok"
            assert len(conns) == 2
            with pytest.raises(CLIENT[client].ServerDisconnectedError):
                await session.request("POST", url, data=b"x")  # not idempotent
            assert len(conns) == 2
        finally:
            await session.close()
            server.close()
            await server.wait_closed()

    asyncio.run(main())


# -- deliberate differences from aiohttp (ROADMAP §C) ---------------------------


def test_deliberate_differences_from_aiohttp():
    # The connection error is a builtin ConnectionError; aiohttp's is not.
    assert issubclass(http_lite.ClientConnectionError, ConnectionError)
    assert not issubclass(aiohttp.ClientConnectionError, ConnectionError)
    # Lifted: middlewares, and {name:regex} parts anywhere in a template,
    # are taken as aiohttp takes them (their answers: the tests below).
    async def handler(req):
        return web.Response()

    for w in (http_lite, web):
        app = w.Application(middlewares=[])
        assert list(app.middlewares) == []
        app.router.add_get(r"/x/{n:\d+}", handler)
        app.router.add_get("/x/{n:.*}/y", handler)
        with pytest.raises(ValueError):
            w.Application().router.add_get("/x/{n:(}", handler)
    # Lifted: match_info carries its route, whose resource's canonical
    # template is aiohttp's (None for the router's 404 and 405), and the
    # router lists its resources and their methods as aiohttp's does.
    assert asyncio.run(_match_infos(http_lite)) == asyncio.run(_match_infos(web))
    # A repeated header's values join under [name]; getall gives each, as
    # aiohttp's getall does. The query keeps each name's first value.
    h = http_lite.Headers()
    h.add("X-A", "1")
    h.add("x-a", "2")
    assert dict(h) == {"X-A": "1, 2"}
    ref = multidict.CIMultiDict([("X-A", "1"), ("x-a", "2")])
    assert h.getall("x-a") == ref.getall("x-a") == ["1", "2"]
    assert h.getall("nope", []) == ref.getall("nope", []) == []

    async def query(req):
        return http_lite.json_response(req.query)

    app = http_lite.Application()
    app.router.add_get("/q", query)

    async def main():
        runner, port = await http_lite.serve(app, "127.0.0.1", 0)
        async with http_lite.ClientSession() as s:
            async with s.request("GET", f"http://127.0.0.1:{port}/q?a=1&a=2&b=") as r:
                got = await r.json()
        await runner.cleanup()
        return got

    assert asyncio.run(main()) == {"a": "1", "b": ""}
    with pytest.raises(ValueError):
        http_lite.Headers({"X-Bad": "a\r\nInjected: 1"})


async def _match_infos(w) -> dict:
    """What each kind of request's match_info names, and the router's
    resources with their methods, on one server of ``w``."""
    seen = {}

    @w.middleware
    async def record(req, handler):
        resource = req.match_info.route.resource
        seen[f"{req.method} {req.path}"] = (
            dict(req.match_info), None if resource is None else resource.canonical)
        return await handler(req)

    async def ok(req):
        return w.Response(text="ok")

    app = w.Application(middlewares=[record])
    app.router.add_get(r"/blobs/{d:[0-9a-f]+}", ok)
    app.router.add_get("/ns/{ns}/blobs/{d}", ok)
    app.router.add_put("/ns/{ns}/blobs/{d}", ok)
    app.router.add_post("/debug/x", ok)
    app.router.add_get("/debug", ok)
    resources = [(r.canonical, sorted(route.method for route in r))
                 for r in app.router.resources()]
    port, stop = await start("port" if w is http_lite else "aiohttp", app)
    try:
        async with aiohttp.ClientSession() as s:
            for method, path in (("GET", "/blobs/0af"), ("GET", "/ns/a%2Fb/blobs/ff"),
                                 ("PUT", "/ns/x/blobs/ee"), ("GET", "/debug"),
                                 ("GET", "/nowhere"), ("DELETE", "/debug/x")):
                async with s.request(method, f"http://127.0.0.1:{port}{path}") as r:
                    await r.read()
    finally:
        await stop()
    return {"seen": seen, "resources": resources}


def test_file_response_takes_no_conditional_request(tmp_path):
    """A deliberate difference: the port's ``FileResponse`` ignores
    ``If-None-Match`` (aiohttp answers 304 to its own ETag). Its
    ``match_info`` is a ``dict`` with the route's canonical template, as
    aiohttp's is."""
    (tmp_path / "f").write_bytes(b"abc")

    async def main():
        out = {}
        for kind in ("port", "aiohttp"):
            w = WEB[kind]

            async def serve_file(req):
                out.setdefault("info", {})[kind] = (
                    isinstance(req.match_info, dict), req.match_info.route.resource.canonical)
                return w.FileResponse(tmp_path / req.match_info["name"])

            app = w.Application()
            app.router.add_get("/{name}", serve_file)
            port, stop = await start(kind, app)
            try:
                async with aiohttp.ClientSession() as s:
                    async with s.get(f"http://127.0.0.1:{port}/f") as r:
                        etag = r.headers["ETag"]
                    async with s.get(f"http://127.0.0.1:{port}/f",
                                     headers={"If-None-Match": etag}) as r:
                        out[kind] = (r.status, await r.read())
            finally:
                await stop()
        return out

    out = asyncio.run(main())
    assert out["port"] == (200, b"abc") and out["aiohttp"] == (304, b"")
    assert out["info"] == {"port": (True, "/{name}"), "aiohttp": (True, "/{name}")}


def test_cleanup_closes_the_listener_and_every_open_connection():
    async def main():
        app = build_app(http_lite, {"started": asyncio.Event()})
        runner, port = await http_lite.serve(app, "127.0.0.1", 0)
        session = http_lite.ClientSession()
        async with session.request("GET", f"http://127.0.0.1:{port}/peer") as r:
            await r.read()
        (pooled,) = next(iter(session._idle.values()))
        await runner.cleanup()
        await asyncio.sleep(0.05)
        assert pooled.writer.transport.is_closing() or pooled.reader.at_eof()
        with pytest.raises(http_lite.ClientConnectionError):
            await session.request("GET", f"http://127.0.0.1:{port}/peer")
        await session.close()

    asyncio.run(main())


# -- Range, cleanup_ctx and the rest-of-path segment ---------------------------

RANGES = [None, "bytes=0-0", "bytes=5-9", "bytes=5-", "bytes=-3", "bytes=0-", "bytes=-0",
          "bytes=9-5", "bytes=5-5", "bytes=1-2,4-5", "bytes=-", "bytes=a-b", "items=0-1",
          "bytes= 1-2", "bytes=1-2 ", "", "bytes=01-002", "bytes=\u0663-\u0664"]


def _aiohttp_range(header):
    from aiohttp.test_utils import make_mocked_request

    return make_mocked_request("GET", "/", headers={} if header is None else
                               {"Range": header}).http_range


def _port_range(header):
    headers = http_lite.Headers({} if header is None else {"Range": header})
    body = http_lite.BodyReader(None, 0, False, ValueError)
    return http_lite.Request(http_lite.Application(), "GET", "/", "HTTP/1.1", headers, body,
                             None, None).http_range


@pytest.mark.parametrize("header", RANGES)
def test_http_range_is_aiohttps_parser(header):
    def outcome(parse):
        try:
            return parse(header)
        except ValueError:
            return ValueError

    assert outcome(_port_range) == outcome(_aiohttp_range)


def test_cleanup_ctx_runs_at_serve_and_finishes_last_first_before_the_listener_closes():
    events = []

    async def main():
        app = http_lite.Application()
        port = {}

        async def hello(req):
            return http_lite.Response(text="hi")

        def ctx(name):
            async def gen(a):
                assert a is app
                events.append(f"start {name}")
                yield
                # The listener still answers while a context finishes.
                async with http_lite.ClientSession() as s:
                    async with s.get(f"http://127.0.0.1:{port['n']}/") as r:
                        events.append(f"stop {name} {r.status}")
            return gen

        app.router.add_get("/", hello)
        app.cleanup_ctx.extend([ctx("a"), ctx("b")])
        runner, port["n"] = await http_lite.serve(app, "127.0.0.1", 0)
        assert events == ["start a", "start b"]
        await runner.cleanup()
        await runner.cleanup()  # a second cleanup does nothing
        with pytest.raises(http_lite.ClientConnectionError):
            async with http_lite.ClientSession() as s:
                await s.get(f"http://127.0.0.1:{port['n']}/")

    asyncio.run(main())
    assert events == ["start a", "start b", "stop b 200", "stop a 200"]


@pytest.mark.parametrize("failing,raised", [
    ({"b": "raise"}, ["ValueError b"]),
    ({"c": "again"}, ["RuntimeError"]),
    ({"a": "raise", "c": "again"}, ["RuntimeError", "ValueError a"]),
], ids=["one-raises", "one-yields-again", "two-fail"])
@pytest.mark.parametrize("kind", ["port", "aiohttp"])
def test_cleanup_finishes_every_context_and_closes_before_it_raises(kind, failing, raised):
    """A context that raises (or yields again) as it finishes stops no other:
    every context finishes, last first, the listener closes, and then one
    error is raised as itself, more as a ``CleanupError`` holding them."""
    w = WEB[kind]
    finished = []

    def ctx(name):
        async def gen(a):
            yield
            finished.append(name)
            if failing.get(name) == "raise":
                raise ValueError(name)
            if failing.get(name) == "again":
                yield
        return gen

    async def main():
        app = w.Application()
        app.cleanup_ctx.extend([ctx("a"), ctx("b"), ctx("c")])
        port, stop = await start(kind, app)
        with pytest.raises(Exception) as ei:
            await stop()
        with pytest.raises(ConnectionError):
            await asyncio.open_connection("127.0.0.1", port)
        return ei.value

    err = asyncio.run(main())
    assert finished == ["c", "b", "a"]
    errors = err.exceptions if len(raised) > 1 else [err]
    if len(raised) > 1:
        assert type(err).__name__ == "CleanupError" and isinstance(err, RuntimeError)
    assert [" ".join([type(e).__name__, *(str(e),) * isinstance(e, ValueError)])
            for e in errors] == raised


@pytest.mark.parametrize("kind", ["port", "aiohttp"])
def test_a_last_dot_star_segment_takes_the_rest_of_the_path(kind):
    w = WEB[kind]

    async def name(req):
        return w.json_response({"name": req.match_info["name"]})

    async def main():
        app = w.Application()
        app.router.add_get("/files/{name:.*}", name)
        port, stop = await start(kind, app)
        out = {}
        try:
            async with aiohttp.ClientSession() as s:
                for path in ("/files/a/b/c", "/files/", "/files/x%2Fy", "/files", "/other/a"):
                    async with s.get(f"http://127.0.0.1:{port}{path}") as r:
                        out[path] = (await r.json())["name"] if r.status == 200 else r.status
        finally:
            await stop()
        return out

    assert asyncio.run(main()) == {"/files/a/b/c": "a/b/c", "/files/": "", "/files/x%2Fy": "x/y",
                                   "/files": 404, "/other/a": 404}


# -- getall, regex routes, middlewares and FileResponse (the front door) -------


@pytest.mark.parametrize("server,client", PAIRS, ids=PAIR_IDS)
def test_getall_gives_each_value_of_a_repeated_header(server, client):
    """Docker sends its Accept types as separate header lines; each
    client sends a list of pairs as such, and each server's ``getall``
    gives every value in order."""
    w = WEB[server]

    async def accept(req):
        return w.json_response({"all": req.headers.getall("Accept", []),
                                "none": req.headers.getall("X-None", [])})

    async def main():
        app = w.Application()
        app.router.add_get("/accept", accept)
        port, stop = await start(server, app)
        session = CLIENT[client].ClientSession()
        try:
            hdrs = [("Accept", "application/a"), ("Accept", "application/b;q=0.9"),
                    ("Accept", "*/*")]
            async with session.request("GET", f"http://127.0.0.1:{port}/accept",
                                       headers=hdrs) as r:
                return await r.json()
        finally:
            await session.close()
            await stop()

    assert asyncio.run(main()) == {
        "all": ["application/a", "application/b;q=0.9", "*/*"], "none": []}


# The front door's route tables, registered alike on both servers; each
# handler answers its route's name and match_info.
ROUTE_TABLE = [
    ("GET", "/v2/"), ("GET", "/v2/_catalog"),
    ("*", "/v2/{repo:.+}/manifests/{ref}"),
    ("POST", "/v2/{repo:.+}/blobs/uploads/"),
    ("GET", "/v2/{repo:.+}/blobs/uploads/{uid}"),
    ("PATCH", "/v2/{repo:.+}/blobs/uploads/{uid}"),
    ("PUT", "/v2/{repo:.+}/blobs/uploads/{uid}"),
    ("*", "/v2/{repo:.+}/blobs/{digest}"),
    ("GET", "/v2/{repo:.+}/tags/list"),
    ("PUT", "/tags/{tag}/digest/{d}/replicate"), ("PUT", "/tags/{tag}/digest/{d}"),
    ("GET", "/tags/{tag}"), ("GET", "/repositories/{repo}/tags"),
    ("GET", "/files/{name:.*}"), ("DELETE", r"/n/{a:\d+}/{b}"),
]


def _route_app(w):
    app = w.Application()
    for i, (method, template) in enumerate(ROUTE_TABLE):
        async def handler(req, i=i):
            return w.json_response({"route": i, "info": dict(req.match_info)})

        if method == "GET":
            app.router.add_get(template, handler)
        else:
            app.router.add_route(method, template, handler)
    return app


@pytest.fixture(scope="module")
def route_servers():
    """Both servers with ``ROUTE_TABLE``, on a loop of their own in a
    thread, so hypothesis can send them each example."""
    import threading

    loop = asyncio.new_event_loop()
    ports, stops = {}, []
    ready = threading.Event()

    async def up():
        for kind in ("port", "aiohttp"):
            port, stop = await start(kind, _route_app(WEB[kind]))
            ports[kind] = port
            stops.append(stop)
        ready.set()

    thread = threading.Thread(target=lambda: (loop.run_until_complete(up()),
                                              loop.run_forever()), daemon=True)
    thread.start()
    assert ready.wait(30)
    yield ports
    for stop in stops:
        asyncio.run_coroutine_threadsafe(stop(), loop).result(30)
    loop.call_soon_threadsafe(loop.stop)
    thread.join(30)


def raw_request(port: int, method: str, target: str, headers: str = "") -> tuple:
    """One request with the target sent exactly as given: (status, headers
    lowercased, body)."""
    with socket.create_connection(("127.0.0.1", port), timeout=10) as sock:
        sock.sendall(f"{method} {target} HTTP/1.1\r\nHost: x\r\n{headers}"
                     "Connection: close\r\nContent-Length: 0\r\n\r\n".encode("latin-1"))
        data = b""
        while chunk := sock.recv(65536):
            data += chunk
    head, _, body = data.partition(b"\r\n\r\n")
    lines = head.decode("latin-1").split("\r\n")
    hdrs = {}
    for line in lines[1:]:
        k, _, v = line.partition(":")
        hdrs[k.strip().lower()] = v.strip()
    if hdrs.get("transfer-encoding") == "chunked":
        out = b""
        while body:
            size, _, rest = body.partition(b"\r\n")
            n = int(size, 16)
            if n == 0:
                break
            out, body = out + rest[:n], rest[n + 2:]
        body = out
    return int(lines[0].split(" ")[1]), hdrs, body


def _routed(port: int, method: str, target: str):
    status, hdrs, body = raw_request(port, method, target)
    if status == 200 and method != "HEAD":
        return status, json.loads(body)
    return status, hdrs.get("allow"), hdrs.get("content-length")


ROUTE_TARGETS = [
    "/v2/", "/v2", "/v2/_catalog", "/v2/library/app/manifests/v1",
    "/v2/library/app/blobs/uploads/", "/v2/library/app/blobs/uploads/abc",
    "/v2/a/b/c/blobs/sha256:00", "/v2/library/app/tags/list", "/v2/x%2Fy/blobs/z",
    "/v2/library%2Fapp/manifests/v1%3Ax", "/tags/library%2Fapp%3Av1",
    "/tags/library%2Fapp%3Av1/digest/abc", "/tags/a%252Fb/digest/abc/replicate",
    "/tags/a/b", "/tags/%7Bx%7D", "/repositories/library%2Fapp/tags", "/files/a/b%2Fc/",
    "/files", "/n/12/x", "/n/1x/x", "/v2/%e2%82%ac/blobs/%ff", "/v2/a+b/manifests/%2B",
    "/v2/a/blobs/uploads", "/v2//manifests/x", "/nope",
]


@pytest.mark.parametrize("method", ["GET", "HEAD", "PUT", "POST", "PATCH", "DELETE"])
def test_routes_resolve_as_aiohttps_router_on_the_front_doors_tables(route_servers, method):
    """The same raw targets on both servers: the same route, the same
    decoded ``match_info``, or the same 404 / 405 and ``Allow``."""
    for target in ROUTE_TARGETS:
        got = {k: _routed(p, method, target) for k, p in route_servers.items()}
        assert got["port"] == got["aiohttp"], (method, target, got)


_SEGMENT = st.lists(st.sampled_from(list("abAB09._-:+~@!$&'()*,;=") + [
    "%2F", "%2f", "%25", "%3A", "%2B", "%20", "%7B", "%7D", "%e2%82%ac", "%ff", "%C3", "/"]),
    min_size=0, max_size=6).map("".join)


@settings(max_examples=200, deadline=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(prefix=st.sampled_from(["/v2/", "/tags/", "/repositories/", "/files/", "/n/", "/"]),
       parts=st.lists(_SEGMENT, min_size=0, max_size=4),
       tail=st.sampled_from(["", "/manifests/v1", "/blobs/uploads/", "/blobs/uploads/u",
                             "/blobs/sha256:ab", "/tags/list", "/digest/d", "/digest/d/replicate",
                             "/tags", "/"]),
       method=st.sampled_from(["GET", "PUT", "POST", "DELETE"]))
def test_hypothesis_raw_targets_resolve_as_aiohttps_router(route_servers, prefix, parts, tail,
                                                          method):
    target = prefix + "/".join(parts) + tail
    got = {k: _routed(p, method, target) for k, p in route_servers.items()}
    assert got["port"] == got["aiohttp"], (method, target, got)


@pytest.mark.parametrize("kind", ["port", "aiohttp"])
def test_middlewares_run_in_order_and_see_the_routers_errors(kind):
    """Two middlewares, the first outermost; a handler's answer, its
    raised error, and the router's own 404 and 405 (with ``Allow``) all
    pass through the chain, which rewrites them -- as in aiohttp."""
    w = WEB[kind]
    trace = []

    def make(name):
        @w.middleware
        async def mw(req, handler):
            trace.append(f"{name}>")
            try:
                resp = await handler(req)
            except w.HTTPException as e:
                trace.append(f"<{name}:{e.status}")
                return w.json_response({"caught": e.status, "allow": e.headers.get("Allow"),
                                        "ctype": e.content_type, "by": name}, status=e.status)
            trace.append(f"<{name}")
            resp.headers[f"X-{name}"] = "1"
            return resp
        return mw

    async def ok(req):
        trace.append("handler")
        return w.Response(text="ok")

    async def teapot(req):
        raise w.HTTPConflict(text="no", content_type="application/json")

    async def main():
        app = w.Application(middlewares=[make("a"), make("b")])
        app.router.add_get("/ok", ok)
        app.router.add_post("/conflict", teapot)
        port, stop = await start(kind, app)
        out = []
        try:
            async with aiohttp.ClientSession() as s:
                for method, path in (("GET", "/ok"), ("POST", "/conflict"), ("GET", "/none"),
                                     ("PUT", "/ok")):
                    async with s.request(method, f"http://127.0.0.1:{port}{path}") as r:
                        body = await r.read()
                        out.append((r.status, body if r.status == 200 else json.loads(body),
                                    r.headers.get("X-a"), r.headers.get("X-b")))
        finally:
            await stop()
        return out

    out = asyncio.run(main())
    assert out == [
        (200, b"ok", "1", "1"),
        (409, {"caught": 409, "allow": None, "ctype": "application/json", "by": "b"}, "1", None),
        (404, {"caught": 404, "allow": None, "ctype": "text/plain", "by": "b"}, "1", None),
        (405, {"caught": 405, "allow": "GET,HEAD", "ctype": "text/plain", "by": "b"}, "1", None),
    ]
    assert trace == ["a>", "b>", "handler", "<b", "<a", "a>", "b>", "<b:409", "<a",
                     "a>", "b>", "<b:404", "<a", "a>", "b>", "<b:405", "<a"]


FILE_RANGES = [None, "bytes=0-0", "bytes=5-9", "bytes=5-", "bytes=-3", "bytes=-0",
               "bytes=100-99999999", "bytes=-99999999", f"bytes={300_000 - 1}-",
               f"bytes={300_000}-", "bytes=400000-400001", "bytes=9-5", "bytes=a-b",
               "bytes=1-2,4-5", "items=0-1", ""]


@pytest.mark.parametrize("sendfile", [True, False], ids=["sendfile", "pread"])
@pytest.mark.parametrize("method", ["GET", "HEAD"])
def test_file_response_answers_as_aiohttps(tmp_path, monkeypatch, method, sendfile):
    """The same file and Range headers through both servers'
    ``FileResponse``: status, body, and the length, range, type, tag and
    date headers; a missing file and an empty one too."""
    monkeypatch.setattr(http_lite, "SENDFILE", sendfile)
    data = blob_of(300_000, 11)
    (tmp_path / "blob.bin").write_bytes(data)
    (tmp_path / "empty").write_bytes(b"")
    (tmp_path / "page.json").write_bytes(b"{}")
    keys = ("content-length", "content-range", "accept-ranges", "content-type", "etag",
            "last-modified", "x-extra")

    async def main():
        out = {}
        for kind in ("port", "aiohttp"):
            w = WEB[kind]

            async def serve_file(req):
                name = req.match_info["name"]
                extra = {"X-Extra": "1"} if name == "blob.bin" else None
                return w.FileResponse(tmp_path / name, headers=extra)

            app = w.Application()
            app.router.add_get("/f/{name}", serve_file)
            port, stop = await start(kind, app)
            try:
                async with aiohttp.ClientSession(auto_decompress=False) as s:
                    for name in ("blob.bin", "empty", "page.json", "missing"):
                        for rng in FILE_RANGES:
                            hdrs = {} if rng is None else {"Range": rng}
                            async with s.request(method, f"http://127.0.0.1:{port}/f/{name}",
                                                 headers=hdrs) as r:
                                body = await r.read()
                                out.setdefault(kind, []).append(
                                    (name, rng, r.status, hashlib.sha256(body).hexdigest(),
                                     {k: r.headers.get(k) for k in keys
                                      if not (r.status >= 400 and k == "content-length")}))
            finally:
                await stop()
        return out

    out = asyncio.run(main())
    assert out["port"] == out["aiohttp"]
    by = {(n, r): (st_, h) for n, r, st_, _b, h in out["port"]}
    assert by[("blob.bin", "bytes=5-")][0] == 206
    assert by[("blob.bin", "bytes=5-")][1]["content-range"] == "bytes 5-299999/300000"
    assert by[("blob.bin", f"bytes={300_000}-")][0] == 416
    assert by[("blob.bin", "bytes=a-b")][1]["content-range"] == "bytes */300000"
    assert by[("missing", None)][0] == 404


def test_file_response_streams_a_large_file_off_the_loop(tmp_path):
    """32 MiB through ``FileResponse`` on the port's server while the loop
    keeps ticking: the body is never read on the loop."""
    data = blob_of(32 * MiB, 12)
    (tmp_path / "big").write_bytes(data)

    async def main():
        app = http_lite.Application()

        async def big(req):
            return http_lite.FileResponse(tmp_path / "big")

        app.router.add_get("/big", big)
        port, stop = await start("port", app)
        ticks = 0
        done = asyncio.Event()

        async def ticker():
            nonlocal ticks
            while not done.is_set():
                ticks += 1
                await asyncio.sleep(0.001)

        t = asyncio.create_task(ticker())
        try:
            async with aiohttp.ClientSession() as s:
                async with s.get(f"http://127.0.0.1:{port}/big",
                                 headers={"Range": f"bytes={MiB}-"}) as r:
                    got = await r.read()
                    status = r.status
        finally:
            done.set()
            await t
            await stop()
        return status, got, ticks

    status, got, ticks = asyncio.run(main())
    assert status == 206 and got == data[MiB:] and ticks > 1


# -- httputil: the JAX HTTPClient and the port's on one aiohttp server ----------

PKG = {
    "jax": (jax_httputil, jax_failpoints, jax_deadline, JaxBackoff),
    "port": (port_httputil, port_failpoints, port_deadline, PortBackoff),
}
# The exception each package raises for one event, by name in each.
ERROR_MAP = {
    "status": (jax_httputil.HTTPError, port_httputil.HTTPError),
    "deadline": (jax_deadline.DeadlineExceeded, port_deadline.DeadlineExceeded),
    "payload": (aiohttp.ClientPayloadError, http_lite.ClientPayloadError),
    "connection": (aiohttp.ClientConnectionError, http_lite.ClientConnectionError),
}


def _error(pkg: str, kind: str):
    return ERROR_MAP[kind][0 if pkg == "jax" else 1]


def _status_app(state: dict):
    app = web.Application()

    async def status(req):
        state["hits"] = state.get("hits", 0) + 1
        code = int(req.match_info["code"])
        if code >= 400:
            return web.Response(status=code, text=f"no {code}")
        return web.Response(body=blob_of(200_000, 3), status=code)

    app.router.add_get("/status/{code}", status)
    return app


def run_httputil(pkg: str, body, arm: dict | None = None, **client_kw):
    httputil, failpoints, deadline, backoff = PKG[pkg]
    state: dict = {}

    async def main():
        port, stop = await start("aiohttp", _status_app(state))
        client = httputil.HTTPClient(backoff=backoff(base_seconds=0.01, jitter=0),
                                     **client_kw)
        for name, spec in (arm or {}).items():
            failpoints.FAILPOINTS.arm(name, spec)
        try:
            return await body(client, f"http://127.0.0.1:{port}", deadline)
        finally:
            failpoints.FAILPOINTS.disarm_all()
            await client.close()
            await stop()

    out = asyncio.run(main())
    return out, state.get("hits", 0)


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_httputil_retries_5xx_and_not_4xx(pkg):
    async def body(client, base, _dl):
        errs = []
        for code in (503, 404):
            with pytest.raises(_error(pkg, "status")) as e:
                await client.get(f"{base}/status/{code}")
            errs.append((e.value.status, e.value.body))
        return errs

    errs, hits = run_httputil(pkg, body, retries=3)
    assert errs == [(503, b"no 503"), (404, b"no 404")]
    assert hits == 4 + 1  # 503: the first try and 3 retries; 404: once


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_httputil_deadline_caps_the_retries(pkg):
    httputil, _fp, deadline, backoff = PKG[pkg]
    state: dict = {}

    async def main():
        port, stop = await start("aiohttp", _status_app(state))
        client = httputil.HTTPClient(retries=50, backoff=backoff(base_seconds=0.1, jitter=0))
        t0 = time.monotonic()
        try:
            with pytest.raises(_error(pkg, "deadline")):
                await client.get(f"http://127.0.0.1:{port}/status/503",
                                 deadline=deadline.Deadline(0.25, component="test"))
            return time.monotonic() - t0
        finally:
            await client.close()
            await stop()

    assert asyncio.run(main()) < 1.0
    # 0.1 s, then 0.2 s apart: the budget holds 2 tries, never 50.
    assert state["hits"] == 2


@pytest.mark.parametrize("pkg", ["jax", "port"])
@pytest.mark.parametrize("failpoint,spec", [
    ("httputil.request.slow", "always+delay:80"),
    ("httputil.request.conn_reset", "once"),
    ("httputil.request.error", "once"),
    ("httputil.request.truncate_body", "once"),
])
def test_httputil_failpoints(pkg, failpoint, spec):
    async def body(client, base, _dl):
        t0 = time.monotonic()
        got = await client.get(f"{base}/status/200")
        return len(got), time.monotonic() - t0

    (n, wall), hits = run_httputil(pkg, body, arm={failpoint: spec}, retries=2)
    want = {
        "httputil.request.slow": (200_000, 1),  # delayed, then served
        "httputil.request.conn_reset": (200_000, 1),  # an injected RST, retried
        "httputil.request.error": (200_000, 1),  # an injected 503, retried
        "httputil.request.truncate_body": (100_000, 1),  # the torn half
    }[failpoint]
    assert (n, hits) == want
    if failpoint == "httputil.request.slow":
        assert wall >= 0.08


@pytest.mark.parametrize("pkg", ["jax", "port"])
@pytest.mark.parametrize("spec", ["once", "always"])
def test_httputil_get_to_file_on_a_torn_body(pkg, spec, tmp_path):
    dest = tmp_path / "blob"

    async def body(client, base, _dl):
        if spec == "once":
            return await client.get_to_file(f"{base}/status/200", str(dest), chunk_size=65536)
        with pytest.raises(_error(pkg, "payload")):
            await client.get_to_file(f"{base}/status/200", str(dest), chunk_size=65536)
        return None

    n, hits = run_httputil(pkg, body, arm={"httputil.request.truncate_body": spec}, retries=2)
    if spec == "once":  # the whole transfer is retried, and lands whole
        assert n == 200_000 and dest.read_bytes() == blob_of(200_000, 3) and hits == 2
    else:
        assert not dest.exists() and hits == 3
    assert not [p for p in os.listdir(tmp_path) if p.endswith(".tmp")]


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_httputil_connection_errors_are_retried_then_raised(pkg):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    httputil, _fp, _dl, backoff = PKG[pkg]

    async def main():
        client = httputil.HTTPClient(retries=2, backoff=backoff(base_seconds=0.01, jitter=0))
        try:
            with pytest.raises(_error(pkg, "connection")):
                await client.get(f"http://127.0.0.1:{port}/x")
        finally:
            await client.close()

    asyncio.run(main())
    assert httputil.base_url("h:1") == "http://h:1"
    assert httputil.base_url("https://h:1") == "https://h:1"


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_httputil_request_full_and_head_ok(pkg):
    async def body(client, base, _dl):
        status, headers, got = await client.request_full("GET", f"{base}/status/201")
        with pytest.raises(_error(pkg, "status")) as e:
            await client.request_full("GET", f"{base}/status/409")
        return (status, headers["Content-Length"], len(got), e.value.status,
                await client.head_ok(f"{base}/status/200"),
                await client.head_ok(f"{base}/status/404"))

    out, _hits = run_httputil(pkg, body, retries=0)
    assert out == (201, "200000", 200_000, 409, True, False)
