"""Pull-through backend against an upstream Docker registry.

The port's copy of ``kraken_tpu.backend.registrybackend``
(``registry_blob`` and ``registry_tag``).

Mirrors uber/kraken ``lib/backend/registrybackend`` (blobs + tags clients
speaking the Registry v2 API to an existing registry, plus the
``security`` token-auth flow; how real clusters bootstrap content they
didn't push) -- upstream path, unverified; SURVEY.md SS2.3.

Two registrations:

- ``registry_blob``: name = blob digest (hex or ``sha256:<hex>``);
  download GETs ``/v2/{namespace}/blobs/sha256:<hex>``. Read-only.
- ``registry_tag``: name = ``repo:tag``; download resolves the manifest
  and returns the manifest DIGEST string (the tag value the build-index
  stores), taken from ``Docker-Content-Digest`` or hashed from the body.

Auth: real registries (Docker Hub, GHCR, Quay) answer anonymous requests
with ``401`` + ``WWW-Authenticate: Bearer realm=...,service=...`` and
expect the docker token flow: GET the realm (with basic credentials if
the account is private) for a short-lived JWT, then retry with
``Authorization: Bearer``. :class:`_AuthSession` implements that flow
with a per-scope token cache; plain ``Basic`` challenges are answered
directly. Configure ``username``/``password`` for private upstreams;
public pulls work anonymously (the token endpoint still issues a token).
"""

from __future__ import annotations

import base64
import hashlib
import json
import re
import time
from urllib.parse import urlencode, urljoin

from kraken_tpu_torch.backend.base import (
    BackendClient,
    BackendError,
    BlobInfo,
    BlobNotFoundError,
    register_backend,
)
from kraken_tpu_torch.utils.httputil import HTTPClient, HTTPError

_MANIFEST_ACCEPT = ", ".join(
    (
        "application/vnd.docker.distribution.manifest.v2+json",
        "application/vnd.docker.distribution.manifest.list.v2+json",
        "application/vnd.oci.image.manifest.v1+json",
        "application/vnd.oci.image.index.v1+json",
    )
)

_CHALLENGE_PARAM = re.compile(r'(\w+)="([^"]*)"')


def _realm_safe_for_credentials(realm: str) -> bool:
    """https always; plain http only to loopback (dev/test rigs)."""
    from urllib.parse import urlsplit

    try:
        parts = urlsplit(realm)
    except ValueError:  # e.g. unbalanced IPv6 bracket -- treat as unsafe
        return False
    if parts.scheme == "https":
        return True
    if parts.scheme != "http":
        return False
    return parts.hostname in ("127.0.0.1", "localhost", "::1")


def _full_digest(name: str) -> str:
    return name if name.startswith("sha256:") else f"sha256:{name}"


class _AuthSession:
    """Docker registry token auth with a per-scope cache.

    One instance per backend client. Tokens are cached until shortly
    before their advertised expiry (a 10 s guard band keeps a token from
    dying between the cache check and the upstream's clock).
    """

    def __init__(self, http: HTTPClient, username: str = "", password: str = ""):
        self._http = http
        self._username = username
        self._password = password
        self._tokens: dict[str, tuple[str, float]] = {}  # scope -> (tok, exp)

    async def request(
        self,
        method: str,
        url: str,
        *,
        scope: str,
        headers: dict | None = None,
        ok: tuple[int, ...] = (200,),
        retry_5xx: bool = True,
    ) -> tuple[int, dict, bytes]:
        hdrs = dict(headers or {})
        cached = self._cached(scope)
        if cached:
            hdrs["Authorization"] = cached
        status, h, b = await self._one_hop(
            method, url, hdrs, ok=tuple(ok) + (401,), retry_5xx=retry_5xx
        )
        if status != 401:
            return status, h, b
        hdrs["Authorization"] = await self._answer(
            h.get("WWW-Authenticate", ""), scope
        )
        return await self._one_hop(
            method, url, hdrs, ok=tuple(ok), retry_5xx=retry_5xx
        )

    async def _one_hop(
        self, method: str, url: str, hdrs: dict, *, ok, retry_5xx
    ) -> tuple[int, dict, bytes]:
        """One request, following redirects MANUALLY so the registry
        Authorization header is dropped on the redirected hop: real
        upstreams answer authorized blob GETs with 307 to a presigned
        S3/CDN URL, and S3 rejects requests carrying BOTH presigned
        query auth and an Authorization header."""
        redirects = (301, 302, 303, 307, 308)
        status, h, b = await self._http.request_full(
            method, url, headers=hdrs, ok_statuses=tuple(ok) + redirects,
            retry_5xx=retry_5xx, allow_redirects=False,
        )
        for _hop in range(5):  # kt-lint: disable=retry-without-deadline  # bounded 5-hop redirect follow, not a retry sweep; each hop is one HTTPClient request with its own timeout+retry budget
            if status not in redirects:
                return status, h, b
            location = h.get("Location", "")
            if not location:
                raise HTTPError(method, url, status, b"redirect without Location")
            url = urljoin(url, location)
            clean = {k: v for k, v in hdrs.items() if k != "Authorization"}
            status, h, b = await self._http.request_full(
                method, url, headers=clean,
                ok_statuses=tuple(ok) + redirects,
                retry_5xx=retry_5xx, allow_redirects=False,
            )
        raise HTTPError(method, url, status, b"too many redirects")

    def _cached(self, scope: str) -> str | None:
        tok = self._tokens.get(scope)
        if tok and tok[1] > time.monotonic():
            return tok[0]
        return None

    def _basic(self) -> str:
        creds = f"{self._username}:{self._password}".encode()
        return "Basic " + base64.b64encode(creds).decode()

    async def _answer(self, challenge: str, scope: str) -> str:
        scheme, _, rest = challenge.partition(" ")
        scheme = scheme.lower()
        if scheme == "basic":
            if not self._username:
                raise BackendError(
                    "upstream registry requires basic auth; configure "
                    "username/password on the backend"
                )
            value = self._basic()
            # Cache under the CALLER's scope (the lookup key) so every
            # subsequent request attaches it proactively instead of
            # eating a guaranteed 401 + retry round-trip.
            self._tokens[scope] = (value, float("inf"))
            return value
        if scheme != "bearer":
            raise BackendError(
                f"unsupported upstream auth challenge: {challenge!r}"
            )
        params = dict(_CHALLENGE_PARAM.findall(rest))
        realm = params.get("realm")
        if not realm:
            raise BackendError(f"bearer challenge without realm: {challenge!r}")
        if self._username and not _realm_safe_for_credentials(realm):
            # The 401 challenge names the token realm; a spoofed or
            # misconfigured plain-http realm would receive our Basic
            # credentials in cleartext. Never send secrets over the
            # network unencrypted (loopback realms are fine: dev rigs).
            raise BackendError(
                f"refusing to send credentials to non-https token realm "
                f"{realm!r} (upstream challenge may be spoofed)"
            )
        # The challenge's own scope wins (the upstream knows what it wants
        # granted); the caller's is the fallback for terse challenges.
        use_scope = params.get("scope") or scope
        query = {
            k: v
            for k, v in (
                ("service", params.get("service", "")),
                ("scope", use_scope),
            )
            if v
        }
        token_url = realm + (f"?{urlencode(query)}" if query else "")
        token_headers = (
            {"Authorization": self._basic()} if self._username else None
        )
        try:
            body = await self._http.get(token_url, headers=token_headers)
        except HTTPError as e:
            raise BackendError(
                f"token endpoint refused ({e.status}): check credentials"
            ) from e
        try:
            payload = json.loads(body)
        except ValueError:
            raise BackendError("token endpoint returned non-JSON") from None
        tok = payload.get("token") or payload.get("access_token")
        if not isinstance(tok, str) or not tok:
            raise BackendError("token endpoint returned no token")
        ttl = float(payload.get("expires_in") or 60.0)
        value = f"Bearer {tok}"
        entry = (value, time.monotonic() + max(ttl - 10.0, 10.0))
        # Store under the CALLER's scope too: lookups key on it, and an
        # upstream whose challenge carries a broader/re-normalized scope
        # string would otherwise never hit the cache (three round-trips
        # per request, hammering a rate-limited token endpoint).
        self._tokens[use_scope] = entry
        self._tokens[scope] = entry
        return value


class _RegistryBase(BackendClient):
    def __init__(self, config: dict):
        addr = config["address"]
        scheme = "https" if config.get("tls", False) else "http"
        self.base = f"{scheme}://{addr}/v2"
        self._http = HTTPClient(retries=config.get("retries", 3))
        self._auth = _AuthSession(
            self._http,
            username=config.get("username", ""),
            password=config.get("password", ""),
        )

    async def upload(self, namespace: str, name: str, data: bytes) -> None:
        raise BackendError("registry backend is read-only (pull-through)")

    async def list(self, prefix: str) -> list[str]:
        raise BackendError("registry backend does not support list")

    async def close(self) -> None:
        await self._http.close()


@register_backend("registry_blob")
class RegistryBlobBackend(_RegistryBase):
    """config: address ("host:port"), tls (false), retries, username,
    password (empty = anonymous token flow)."""

    def _url(self, namespace: str, name: str) -> str:
        return f"{self.base}/{namespace}/blobs/{_full_digest(name)}"

    @staticmethod
    def _scope(namespace: str) -> str:
        return f"repository:{namespace}:pull"

    async def stat(self, namespace: str, name: str) -> BlobInfo:
        try:
            _s, headers, _b = await self._auth.request(
                "HEAD", self._url(namespace, name),
                scope=self._scope(namespace), retry_5xx=False,
            )
        except HTTPError as e:
            if e.status == 404:
                raise BlobNotFoundError(name) from None
            raise
        return BlobInfo(int(headers.get("Content-Length", 0)))

    async def download(self, namespace: str, name: str) -> bytes:
        try:
            _s, _h, body = await self._auth.request(
                "GET", self._url(namespace, name),
                scope=self._scope(namespace),
            )
            return body
        except HTTPError as e:
            if e.status == 404:
                raise BlobNotFoundError(name) from None
            raise


@register_backend("registry_tag")
class RegistryTagBackend(_RegistryBase):
    """Resolves ``repo:tag`` names to manifest digests via the upstream."""

    def _split(self, name: str) -> tuple[str, str]:
        repo, sep, tag = name.rpartition(":")
        if not sep:
            raise BackendError(f"tag name must be repo:tag, got {name!r}")
        return repo, tag

    async def stat(self, namespace: str, name: str) -> BlobInfo:
        digest = await self.download(namespace, name)
        return BlobInfo(len(digest))

    async def download(self, namespace: str, name: str) -> bytes:
        repo, tag = self._split(name)
        try:
            _s, headers, body = await self._auth.request(
                "GET", f"{self.base}/{repo}/manifests/{tag}",
                scope=f"repository:{repo}:pull",
                headers={"Accept": _MANIFEST_ACCEPT},
            )
        except HTTPError as e:
            if e.status == 404:
                raise BlobNotFoundError(name) from None
            raise
        digest = headers.get("Docker-Content-Digest")
        if not digest:
            digest = "sha256:" + hashlib.sha256(body).hexdigest()
        return digest.encode()
