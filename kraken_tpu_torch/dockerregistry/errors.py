"""Docker/OCI distribution-spec error envelope.

Real docker/containerd clients BRANCH on these codes -- mount fallback on
``BLOB_UNKNOWN``, upload-session restart on ``BLOB_UPLOAD_UNKNOWN``,
retry-vs-fail on ``BLOB_UPLOAD_INVALID`` -- so the envelope is part of the
compatibility contract, not cosmetics: every error must be
``{"errors": [{"code", "message", "detail"}]}`` with a code from the
spec's table. Mirrors docker/distribution ``registry/api/errcode`` +
``registry/api/v2/errors.go`` and the OCI distribution-spec error code
table -- upstream paths, unverified; SURVEY.md SS2.4, SS7 hard part #5.

The port's copy of ``kraken_tpu.dockerregistry.errors``, on ``http_lite``:
the same codes, statuses, envelopes and headers. The middleware sees the
router's own 404 and 405 inside the chain, as under ``aiohttp``.
"""

from __future__ import annotations

import json
import logging
import re

from kraken_tpu_torch.utils import http_lite as web

API_VERSION_HEADER = "Docker-Distribution-API-Version"
API_VERSION = "registry/2.0"

# The spec's code table: code -> (default HTTP status, spec message).
CODES: dict[str, tuple[int, str]] = {
    "BLOB_UNKNOWN": (404, "blob unknown to registry"),
    "BLOB_UPLOAD_INVALID": (400, "blob upload invalid"),
    "BLOB_UPLOAD_UNKNOWN": (404, "blob upload unknown to registry"),
    "DIGEST_INVALID": (400, "provided digest did not match uploaded content"),
    "MANIFEST_BLOB_UNKNOWN": (
        404, "manifest references a manifest or blob unknown to registry"),
    "MANIFEST_INVALID": (400, "manifest invalid"),
    "MANIFEST_UNKNOWN": (404, "manifest unknown to registry"),
    "NAME_INVALID": (400, "invalid repository name"),
    "NAME_UNKNOWN": (404, "repository name not known to registry"),
    "SIZE_INVALID": (400, "provided length did not match content length"),
    "TAG_INVALID": (400, "manifest tag did not match URI"),
    "UNAUTHORIZED": (401, "authentication required"),
    "DENIED": (403, "requested access to the resource is denied"),
    "UNSUPPORTED": (405, "the operation is unsupported"),
    # Extension: the distribution spec's error table has no 406 code (the
    # reference implementation answers content-negotiation misses with a
    # bare 404), but a typed 406 tells a schema-pinned client exactly why
    # the stored manifest cannot be served to it (API.md).
    "MANIFEST_NOT_ACCEPTABLE": (
        406, "stored manifest media type not covered by Accept"),
    "TOOMANYREQUESTS": (429, "too many requests"),
    "PAGINATION_NUMBER_INVALID": (400, "invalid number of results requested"),
    # Spec catch-all for server-side faults: clients retry 5xx but treat
    # 404s as definitive, so a transient dependency failure must never be
    # reported as *_UNKNOWN-not-found.
    "UNKNOWN": (500, "unknown error"),
}

_STATUS_EXC: dict[int, type[web.HTTPException]] = {
    400: web.HTTPBadRequest,
    401: web.HTTPUnauthorized,
    403: web.HTTPForbidden,
    404: web.HTTPNotFound,
    406: web.HTTPNotAcceptable,
    416: web.HTTPRequestRangeNotSatisfiable,
    429: web.HTTPTooManyRequests,
    500: web.HTTPInternalServerError,
    502: web.HTTPBadGateway,
}

# The spec's repository-name grammar (path components joined by "/").
# fullmatch, not match-with-$: "$" permits one trailing newline, which a
# URL-encoded %0A would smuggle into Location headers.
_REPO_COMPONENT = r"[a-z0-9]+(?:(?:\.|_|__|-+)[a-z0-9]+)*"
_REPO_RE = re.compile(rf"{_REPO_COMPONENT}(?:/{_REPO_COMPONENT})*")


def error_body(code: str, message: str | None = None, detail=None) -> str:
    status, spec_message = CODES[code]
    err: dict = {"code": code, "message": message or spec_message}
    if detail is not None:
        err["detail"] = detail
    return json.dumps({"errors": [err]})


def v2_error(
    code: str,
    message: str | None = None,
    *,
    detail=None,
    status: int | None = None,
    headers: dict | None = None,
    allowed: tuple[str, ...] = ("GET", "HEAD"),
) -> web.HTTPException:
    """Build (to ``raise``) the spec error for ``code``.

    ``status`` overrides the code's default (e.g. BLOB_UPLOAD_INVALID
    rides a 416 on out-of-order chunks). 405s need ``allowed`` for the
    Allow header.
    """
    status = status or CODES[code][0]
    body = error_body(code, message, detail)
    if status == 405:
        return web.HTTPMethodNotAllowed(
            "", allowed, headers=headers, text=body,
            content_type="application/json",
        )
    return _STATUS_EXC[status](
        headers=headers, text=body, content_type="application/json"
    )


def is_definitive_not_found(e: BaseException) -> bool:
    """True iff a dependency failure proves the resource does not exist.

    Only a replica's explicit 404 (or a local lookup miss) qualifies; a
    connection error, timeout, or 5xx is a fault of the dependency, not a
    statement about the blob. Docker clients treat 404 codes as FINAL
    (mount probes fall back to full re-upload, pulls abort), so guessing
    not-found on a transient failure breaks them in ways a retryable 5xx
    does not.
    """
    from kraken_tpu_torch.utils import httputil

    if isinstance(e, (KeyError, LookupError, FileNotFoundError)):
        return True
    return isinstance(e, httputil.HTTPError) and e.status == 404


def map_dependency_error(
    e: BaseException, code: str, *, detail=None
) -> web.HTTPException:
    """Map a dependency failure to either the definitive ``code`` (404
    family) or a retryable 502 UNKNOWN envelope. Callers ``raise`` the
    result."""
    if is_definitive_not_found(e):
        return v2_error(code, detail=detail)
    return v2_error(
        "UNKNOWN", "upstream dependency unavailable",
        status=502, detail=detail,
    )


def check_repo_name(repo: str) -> str:
    """NAME_INVALID for names outside the spec grammar (a client that sent
    one is confused; letting it through would mint un-pullable tags)."""
    if not _REPO_RE.fullmatch(repo) or len(repo) > 255:
        raise v2_error("NAME_INVALID", detail={"name": repo})
    return repo


@web.middleware
async def api_version_middleware(req: web.Request, handler):
    """Stamp ``Docker-Distribution-API-Version: registry/2.0`` on every
    response, errors included -- clients use it to confirm they are
    talking to a v2 registry before trusting any other header. Anything
    that escapes a handler un-enveloped (a bug, or a dependency error a
    handler failed to map) is converted to the spec's UNKNOWN 500 here:
    aiohttp's bare text/plain 500 carries no code for a client to branch
    on and would violate the envelope contract this module declares."""
    try:
        resp = await handler(req)
    except web.HTTPException as e:
        if e.status >= 400 and not (e.content_type or "").startswith(
            "application/json"
        ):
            # Router-level errors (no route matched -> aiohttp's plain
            # "404: Not Found", bad method -> bare 405) never went
            # through v2_error; envelope them here. An unknown/unrouted
            # v2 operation is the spec's UNSUPPORTED.
            code = "UNSUPPORTED" if e.status in (404, 405) else "UNKNOWN"
            headers = {API_VERSION_HEADER: API_VERSION}
            if "Allow" in e.headers:
                headers["Allow"] = e.headers["Allow"]
            return web.Response(
                status=e.status,
                text=error_body(code),
                content_type="application/json",
                headers=headers,
            )
        e.headers[API_VERSION_HEADER] = API_VERSION
        raise
    except Exception:
        logging.getLogger("kraken_tpu_torch.registry").exception(
            "unhandled error on %s %s", req.method, req.path
        )
        return web.Response(
            status=500,
            text=error_body("UNKNOWN"),
            content_type="application/json",
            headers={API_VERSION_HEADER: API_VERSION},
        )
    resp.headers[API_VERSION_HEADER] = API_VERSION
    return resp
