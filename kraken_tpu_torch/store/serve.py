"""HTTP blob serving over both storage representations: the port's copy of
``kraken_tpu.store.serve``, over the port's own HTTP/1.1 (``utils/http_lite``).

One code path for flat AND chunk-backed blobs: ``open_cache_reader``
picks the representation atomically (a flat open pins the fd -- the
chunk-tier conversion unlinking the path mid-request is harmless; a
miss falls to the manifest), and a Range-capable ``StreamResponse``
streams 1 MiB positional reads off-loop -- O(slice) memory for any blob
size.
"""

from __future__ import annotations

import asyncio

from kraken_tpu_torch.utils import http_lite as web

_SLICE = 1 << 20


def _parse_range(req: web.Request, length: int) -> tuple[int, int] | None | str:
    """``(start, end_inclusive)``, None for "serve the whole blob", or
    ``"unsatisfiable"``. Delegates to ``req.http_range`` (``http_lite``'s
    copy of aiohttp's parser, held against it by the tests); malformed or
    multi-range headers raise ValueError there and fall back to a full
    200 (permitted by RFC 9110)."""
    try:
        rng = req.http_range
    except ValueError:
        return None
    start, stop = rng.start, rng.stop
    if start is None and stop is None:
        return None
    if start is None:
        start = 0
    if start < 0:  # suffix range: bytes=-N
        start = max(length + start, 0)
        end = length - 1
    else:
        # Clamp an end past EOF to the last byte (RFC 9110: a
        # too-large last-byte-pos is satisfiable).
        end = min(stop - 1 if stop is not None else length - 1, length - 1)
    if start >= length or start > end:
        return "unsatisfiable"
    return start, end


async def blob_response(
    req: web.Request, store, d
) -> web.StreamResponse:
    """Serve blob ``d`` from ``store``, flat or chunk-backed. Raises
    ``web.HTTPNotFound`` when the blob is in neither representation
    (callers already ensured presence; this covers eviction races)."""
    try:
        reader = store.open_cache_reader(d)
    except KeyError:
        raise web.HTTPNotFound(text="blob not found")
    try:
        length = reader.length
        rng = _parse_range(req, length)
        if rng == "unsatisfiable":
            raise web.HTTPRequestRangeNotSatisfiable(
                headers={"Content-Range": f"bytes */{length}"}
            )
        if rng is None:
            start, end, status = 0, length - 1, 200
        else:
            start, end = rng
            status = 206
        resp = web.StreamResponse(status=status)
        resp.headers["Content-Type"] = "application/octet-stream"
        resp.headers["Accept-Ranges"] = "bytes"
        n = end - start + 1 if length else 0
        resp.content_length = n
        if status == 206:
            resp.headers["Content-Range"] = f"bytes {start}-{end}/{length}"
        await resp.prepare(req)
        off = start
        remaining = n
        while remaining > 0:
            take = min(_SLICE, remaining)
            data = await asyncio.to_thread(reader.pread, take, off)
            if len(data) != take:
                # A chunk vanished mid-stream (quarantined under us):
                # the transfer is already partially written -- abort the
                # conn so the client sees a hard failure, never a short
                # body that parses as truncated-but-complete.
                raise ConnectionResetError("blob read truncated mid-serve")
            await resp.write(data)
            off += take
            remaining -= take
        await resp.write_eof()
        return resp
    finally:
        reader.close()
