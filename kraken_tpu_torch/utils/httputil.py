"""Retrying async HTTP client helpers -- the control-plane RPC substrate.

The port's copy of ``kraken_tpu.utils.httputil`` (retrying requests with
status-typed errors; every inter-component HTTP call goes through it),
built on the port's own HTTP/1.1 (``utils/http_lite.py``) where the
reference is built on aiohttp. Where the reference catches an aiohttp
error, this module catches the ``http_lite`` error of the same meaning:
``ClientConnectionError``, ``ClientPayloadError`` and
``asyncio.TimeoutError``.
"""

from __future__ import annotations

import asyncio
import contextlib
import itertools
import logging
import os
from typing import Any

from urllib.parse import urlsplit

# get_to_file temp-name disambiguator (hedged reads: two concurrent
# transfers of one dest path in one process must not share a tmp file).
_tmp_seq = itertools.count()

from kraken_tpu_torch.utils import failpoints, http_lite, trace
from kraken_tpu_torch.utils.backoff import Backoff
from kraken_tpu_torch.utils.deadline import Deadline, DeadlineExceeded  # noqa: F401 (re-exported)
from kraken_tpu_torch.utils.metrics import REGISTRY

_log = logging.getLogger("kraken.httputil")


def _count_retry(method: str) -> None:
    """Retries were invisible: a flapping dependency that every call
    papers over with 3 retries looks healthy until the 4th failure.
    Metered per method so read and write planes stay distinguishable."""
    REGISTRY.counter(
        "http_client_retries_total",
        "Outbound HTTP attempts retried (connection error / 5xx)",
    ).inc(method=method)


def _give_up(method: str, url: str, attempts: int, err: Exception) -> None:
    """Final give-up: count it and log ONE structured line (the retries
    themselves stay quiet -- the counter carries their volume)."""
    REGISTRY.counter(
        "http_client_giveups_total",
        "Outbound HTTP requests that exhausted every retry",
    ).inc(method=method)
    _log.warning(
        "http request gave up after %d attempts: %s %s: %r",
        attempts, method, url, err,
        extra={"method": method, "url": url, "attempts": attempts},
    )


async def _failpoint_gate(method: str, url: str) -> "HTTPError | None":
    """Failure-injection sites shared by every outbound request path:

    - ``httputil.request.slow``: sleep the armed delay, then proceed;
    - ``httputil.request.conn_reset``: raise a connection error (caught
      by the caller's retry loop exactly like a real RST);
    - ``httputil.request.error``: RETURN an injected 503 ``HTTPError``
      (returned, not raised: the caller feeds it through its own
      retry-vs-raise policy exactly like a real 5xx).
    """
    hit = failpoints.fire("httputil.request.slow")
    if hit:
        await asyncio.sleep(hit.delay_s)
    if failpoints.fire("httputil.request.conn_reset"):
        raise http_lite.ClientConnectionError(
            f"failpoint httputil.request.conn_reset: {method} {url}"
        )
    if failpoints.fire("httputil.request.error"):
        return HTTPError(method, url, 503, b"failpoint httputil.request.error")
    # Link-fault matrix (the partition chaos tier): per-DESTINATION drop
    # and delay. ``rpc.link.drop`` kills every link; the per-host variant
    # ``rpc.link.drop@host:port`` kills only the links INTO that host --
    # in a single-process herd each node is a distinct destination, so
    # arming some directions and not others builds asymmetric / one-way
    # partitions out of destination-keyed variants alone. The urlsplit
    # is gated on any_armed(): zero parsing on the disarmed hot path.
    if failpoints.any_armed():
        dst = urlsplit(url).netloc
        hit = failpoints.fire("rpc.link.drop") or failpoints.fire(
            f"rpc.link.drop@{dst}"
        )
        if hit:
            if hit.delay_s:
                await asyncio.sleep(hit.delay_s)  # black-hole, then RST
            raise http_lite.ClientConnectionError(
                f"failpoint rpc.link.drop: {method} {url}"
            )
        hit = failpoints.fire("rpc.link.delay") or failpoints.fire(
            f"rpc.link.delay@{dst}"
        )
        if hit:
            await asyncio.sleep(hit.delay_s)
    return None


def _inject_traceparent(headers: dict | None) -> dict | None:
    """Propagate the ACTIVE span's context on every outbound request
    (W3C ``traceparent``), so the server side joins the caller's trace.
    Called inside the client span, which is what the remote becomes a
    child of. The caller's dict is never mutated."""
    tp = trace.current_traceparent()
    if tp is None:
        return headers
    h = dict(headers or {})
    h.setdefault("traceparent", tp)
    return h


def _maybe_truncate(body: bytes) -> bytes:
    """``httputil.request.truncate_body``: a torn response (LB died
    mid-body) -- callers must fail digest checks / length checks, never
    accept the prefix silently."""
    if body and failpoints.fire("httputil.request.truncate_body"):
        return body[: len(body) // 2]
    return body


class HTTPError(Exception):
    """Non-2xx response."""

    def __init__(self, method: str, url: str, status: int, body: bytes = b""):
        self.method = method
        self.url = url
        self.status = status
        self.body = body
        super().__init__(f"{method} {url} -> {status}: {body[:200]!r}")


class StatusError(HTTPError):
    pass


def base_url(addr: str) -> str:
    """Cluster addresses are ``host:port`` by default; an explicit
    ``http://`` / ``https://`` prefix selects the scheme, so TLS-fronted
    components are reachable by listing them as ``https://host:port``."""
    if addr.startswith(("http://", "https://")):
        return addr
    return f"http://{addr}"


def is_status(err: Exception, status: int) -> bool:
    return isinstance(err, HTTPError) and err.status == status


def is_not_found(err: Exception) -> bool:
    return is_status(err, 404)


def is_conflict(err: Exception) -> bool:
    return is_status(err, 409)


def is_accepted(err: Exception) -> bool:
    return is_status(err, 202)


# Process-wide outbound TLS identity. A component is one process, so
# "this process's client cert + cluster CA" is a process property, not a
# per-call-site one: setting it here at boot (cli.py `tls_client:` YAML)
# gives every internal client -- tracker, origin cluster, build-index,
# writeback -- the same identity without threading an ssl arg through
# every constructor. Explicit ``HTTPClient(ssl=...)`` still overrides.
_default_client_ssl = None


def set_default_client_ssl(ctx) -> None:
    global _default_client_ssl
    _default_client_ssl = ctx


class HTTPClient:
    """Thin ``http_lite`` wrapper: retries on connection errors / 5xx, raises
    :class:`HTTPError` on non-2xx. One instance per component process."""

    def __init__(
        self,
        timeout_seconds: float = 60.0,
        retries: int = 3,
        backoff: Backoff | None = None,
        ssl=None,
    ):
        self._timeout_seconds = timeout_seconds
        self._timeout = http_lite.ClientTimeout(total=timeout_seconds)
        self._retries = retries
        self._backoff = backoff or Backoff()
        # ssl.SSLContext for https:// peers signed by a private CA; None
        # falls back to the process default (set_default_client_ssl) and
        # then to the standard library's verification against the system
        # store.
        self._ssl = ssl
        self._session: http_lite.ClientSession | None = None

    async def _get_session(self) -> http_lite.ClientSession:
        if self._session is None or self._session.closed:
            use_ssl = (
                self._ssl if self._ssl is not None else _default_client_ssl
            )
            self._session = http_lite.ClientSession(
                timeout=self._timeout, ssl=use_ssl
            )
        return self._session

    async def close(self) -> None:
        if self._session and not self._session.closed:
            await self._session.close()

    def _attempt_timeout(
        self, deadline: Deadline | None
    ) -> http_lite.ClientTimeout | None:
        """The next attempt's total timeout: ``min(per_attempt,
        remaining_budget)`` when a deadline rides along, else the
        session default. None = use the session's configured timeout."""
        if deadline is None:
            return None
        return http_lite.ClientTimeout(
            total=deadline.timeout(self._timeout_seconds)
        )

    async def _retry_pause(
        self, method: str, url: str, attempt: int,
        deadline: Deadline | None, last_err: Exception | None,
    ) -> None:
        """Backoff between attempts, capped by the remaining budget.
        Raises the typed exhaustion error instead of sleeping past the
        caller's deadline -- retries must never multiply the budget."""
        delay = self._backoff.delay(attempt)
        if deadline is not None:
            rem = deadline.remaining()
            if rem <= delay:
                _give_up(method, url, attempt + 1, last_err)
                raise deadline.exceeded(f"{method} {url}") from last_err
            delay = min(delay, rem)
        _count_retry(method)
        await asyncio.sleep(delay)

    async def request(
        self,
        method: str,
        url: str,
        *,
        data: Any = None,
        headers: dict | None = None,
        ok_statuses: tuple[int, ...] = (200, 201, 204),
        abort_statuses: tuple[int, ...] = (),
        retry_5xx: bool = True,
        deadline: Deadline | None = None,
    ) -> bytes:
        with trace.span(f"http.client {method}", url=url):
            headers = _inject_traceparent(headers)
            last_err: Exception | None = None
            for attempt in range(self._retries + 1):
                if deadline is not None and deadline.expired:
                    _give_up(method, url, attempt, last_err)
                    raise deadline.exceeded(f"{method} {url}") from last_err
                try:
                    injected = await _failpoint_gate(method, url)
                    if injected is not None:
                        if not retry_5xx:
                            raise injected
                        last_err = injected
                    else:
                        session = await self._get_session()
                        kw = {}
                        t = self._attempt_timeout(deadline)
                        if t is not None:
                            kw["timeout"] = t
                        async with session.request(
                            method, url, data=data, headers=headers, **kw
                        ) as resp:
                            if resp.status in abort_statuses:
                                # Statuses the caller only needs to SEE,
                                # never read: raise before resp.read()
                                # buffers the body (e.g. a 200 -- whole
                                # blob -- answering a delta Range GET).
                                raise HTTPError(
                                    method, url, resp.status, b""
                                )
                            body = await resp.read()
                            if resp.status in ok_statuses:
                                return _maybe_truncate(body)
                            err = HTTPError(method, url, resp.status, body)
                            # 4xx are semantic: no point retrying.
                            if resp.status < 500 or not retry_5xx:
                                raise err
                            last_err = err
                except (http_lite.ClientConnectionError,
                        asyncio.TimeoutError) as e:
                    last_err = e
                if attempt < self._retries:
                    await self._retry_pause(
                        method, url, attempt, deadline, last_err
                    )
            assert last_err is not None
            _give_up(method, url, self._retries + 1, last_err)
            raise last_err

    async def request_full(
        self,
        method: str,
        url: str,
        *,
        data: Any = None,
        headers: dict | None = None,
        ok_statuses: tuple[int, ...] = (200, 201, 204),
        retry_5xx: bool = True,
        allow_redirects: bool = True,
        deadline: Deadline | None = None,
    ) -> tuple[int, dict, bytes]:
        """Like :meth:`request` but returns (status, headers, body) --
        needed by backends that read response headers (Content-Length,
        Docker-Content-Digest, redirect Location)."""
        with trace.span(f"http.client {method}", url=url):
            headers = _inject_traceparent(headers)
            last_err: Exception | None = None
            for attempt in range(self._retries + 1):
                if deadline is not None and deadline.expired:
                    _give_up(method, url, attempt, last_err)
                    raise deadline.exceeded(f"{method} {url}") from last_err
                try:
                    injected = await _failpoint_gate(method, url)
                    if injected is not None:
                        if not retry_5xx:
                            raise injected
                        last_err = injected
                    else:
                        session = await self._get_session()
                        kw = {}
                        t = self._attempt_timeout(deadline)
                        if t is not None:
                            kw["timeout"] = t
                        async with session.request(
                            method, url, data=data, headers=headers,
                            allow_redirects=allow_redirects, **kw
                        ) as resp:
                            body = await resp.read()
                            if resp.status in ok_statuses:
                                return (
                                    resp.status, dict(resp.headers),
                                    _maybe_truncate(body),
                                )
                            err = HTTPError(method, url, resp.status, body)
                            if resp.status < 500 or not retry_5xx:
                                raise err
                            last_err = err
                except (http_lite.ClientConnectionError,
                        asyncio.TimeoutError) as e:
                    last_err = e
                if attempt < self._retries:
                    await self._retry_pause(
                        method, url, attempt, deadline, last_err
                    )
            assert last_err is not None
            _give_up(method, url, self._retries + 1, last_err)
            raise last_err

    async def get_to_file(
        self,
        url: str,
        dest_path: str,
        *,
        headers: dict | None = None,
        chunk_size: int = 1 << 20,
        retry_5xx: bool = True,
        deadline: Deadline | None = None,
    ) -> int:
        """Stream a GET body to ``dest_path`` (written via a temp file,
        atomically renamed) without buffering it in RAM; returns the byte
        count. Whole-transfer retries, same policy as :meth:`request`."""
        with trace.span("http.client GET(file)", url=url):
            headers = _inject_traceparent(headers)
            last_err: Exception | None = None
            # Unique per call, not just per process: hedged reads run two
            # transfers of the SAME dest concurrently in one process, and
            # a shared tmp name would let the loser tear the winner's
            # bytes.
            tmp = f"{dest_path}.http{os.getpid()}.{next(_tmp_seq)}.tmp"
            for attempt in range(self._retries + 1):
                if deadline is not None and deadline.expired:
                    _give_up("GET", url, attempt, last_err)
                    raise deadline.exceeded(f"GET {url}") from last_err
                try:
                    injected = await _failpoint_gate("GET", url)
                    if injected is not None:
                        if not retry_5xx:
                            raise injected
                        last_err = injected
                    else:
                        session = await self._get_session()
                        kw = {}
                        t = self._attempt_timeout(deadline)
                        if t is not None:
                            kw["timeout"] = t
                        async with session.get(
                            url, headers=headers, **kw
                        ) as resp:
                            if resp.status != 200:
                                body = await resp.read()
                                err = HTTPError("GET", url, resp.status, body)
                                if resp.status < 500 or not retry_5xx:
                                    raise err
                                last_err = err
                            else:
                                size = 0
                                with await asyncio.to_thread(
                                    open, tmp, "wb"
                                ) as f:
                                    async for chunk in (
                                        resp.content.iter_chunked(chunk_size)
                                    ):
                                        if failpoints.fire(
                                            "httputil.request.truncate_body"
                                        ):
                                            # Torn streaming body: surface
                                            # as the payload error a
                                            # dropped LB produces (whole-
                                            # transfer retry).
                                            raise http_lite.ClientPayloadError(
                                                "failpoint truncate_body"
                                            )
                                        await asyncio.to_thread(f.write, chunk)
                                        size += len(chunk)
                                os.replace(tmp, dest_path)
                                return size
                except (http_lite.ClientConnectionError, asyncio.TimeoutError,
                        http_lite.ClientPayloadError) as e:
                    last_err = e
                finally:
                    with contextlib.suppress(OSError):
                        os.unlink(tmp)
                if attempt < self._retries:
                    await self._retry_pause(
                        "GET", url, attempt, deadline, last_err
                    )
            assert last_err is not None
            _give_up("GET", url, self._retries + 1, last_err)
            raise last_err

    async def get(self, url: str, **kw) -> bytes:
        return await self.request("GET", url, **kw)

    async def post(self, url: str, **kw) -> bytes:
        return await self.request("POST", url, **kw)

    async def put(self, url: str, **kw) -> bytes:
        return await self.request("PUT", url, **kw)

    async def patch(self, url: str, **kw) -> bytes:
        return await self.request("PATCH", url, **kw)

    async def delete(self, url: str, **kw) -> bytes:
        return await self.request("DELETE", url, **kw)

    async def head_ok(self, url: str) -> bool:
        try:
            await self.request("HEAD", url, ok_statuses=(200,), retry_5xx=False)
            return True
        except HTTPError as e:
            if e.status == 404:
                return False
            raise
