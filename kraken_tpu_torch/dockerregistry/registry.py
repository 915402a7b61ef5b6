"""Docker Registry HTTP API v2 over an ImageTransferer.

Mirrors uber/kraken ``lib/dockerregistry`` (docker/distribution
StorageDriver over kraken) -- upstream path, unverified; SURVEY.md SS2.4 --
rebuilt as a direct, thin v2 API implementation rather than a storage
driver under someone else's registry process (no docker/distribution
dependency exists here; the API surface is the compatibility contract).

Implemented (the surface ``docker pull``/``push`` exercises):

    GET  /v2/                                      api version check
    GET|HEAD /v2/{repo}/manifests/{ref}            ref = tag or digest
    PUT  /v2/{repo}/manifests/{ref}                push manifest + tag
    GET|HEAD /v2/{repo}/blobs/{digest}
    POST /v2/{repo}/blobs/uploads/                 -> 202 + Location
    PATCH /v2/{repo}/blobs/uploads/{uid}           chunk append
    PUT  /v2/{repo}/blobs/uploads/{uid}?digest=    finalize
    GET  /v2/{repo}/tags/list
    GET  /v2/_catalog                              (via build-index)

The namespace for blob storage is the repo name, as in the reference.

Errors follow the docker/OCI distribution spec: every failure carries the
``{"errors": [{"code", ...}]}`` envelope (see ``errors.py``) and every
response the ``Docker-Distribution-API-Version`` header -- clients branch
on the codes, so this is part of the compatibility contract
(``tests/test_registry_conformance.py`` asserts exact codes per flow).

The port's copy of ``kraken_tpu.dockerregistry.registry``, served by the
port's own HTTP/1.1 (``utils/http_lite``): the same routes, codes, headers
and bodies (``tests/test_torch_registry.py`` holds each conformance case
against the reference's). The finalize's whole-blob digest stays hashlib:
v2's ``PUT ?digest=`` names the blob's SHA-256, not a piece hash.
"""

from __future__ import annotations

import asyncio
import contextlib
import json
import os
import tempfile
import time
import uuid as uuidlib

from kraken_tpu_torch.core.digest import Digest, DigestError
from kraken_tpu_torch.dockerregistry.errors import (
    api_version_middleware,
    check_repo_name,
    map_dependency_error,
    v2_error,
)
from kraken_tpu_torch.dockerregistry.transfer import ImageTransferer
from kraken_tpu_torch.utils import http_lite as web

_MANIFEST_TYPES = (
    "application/vnd.docker.distribution.manifest.v2+json",
    "application/vnd.docker.distribution.manifest.list.v2+json",
    "application/vnd.oci.image.manifest.v1+json",
    "application/vnd.oci.image.index.v1+json",
)


def _create_empty(path: str) -> None:
    """Truncate-create an upload spool file (runs via to_thread: even a
    bare open can stall the loop on a slow/remote spool volume)."""
    open(path, "wb").close()


def _accepts(req: web.Request, media: str) -> bool:
    """RFC 7231-shaped Accept check, scoped to what registries need: no
    header and wildcards (``*/*``, ``application/*``) accept anything;
    otherwise the stored type must appear among the listed types
    (parameters like ``q=`` stripped, case-insensitive)."""
    values = req.headers.getall("Accept", [])
    if not values:
        return True
    for header in values:
        for part in header.split(","):
            t = part.split(";", 1)[0].strip().lower()
            if t in ("*/*", "application/*") or t == media.lower():
                return True
    return False


class RegistryServer:
    """v2 API; ``read_only`` distinguishes agent (pull) from proxy (push)."""

    def __init__(
        self,
        transferer: ImageTransferer,
        read_only: bool = True,
        upload_dir: str | None = None,
        upload_ttl_seconds: float = 3600.0,
        strict_accept: bool = False,
    ):
        self.transferer = transferer
        self.read_only = read_only
        # Strict Accept negotiation on manifest GET/HEAD: a client
        # pinned to types we don't hold gets a typed 406. DEFAULT OFF
        # (serve the stored bytes like the reference): older docker /
        # containerd clients send narrow Accept headers yet parse the
        # docker-schema2 bytes fine, and a 406 fails pulls that used to
        # work (ADVICE r5). YAML `registry_strict_accept: true`.
        self.strict_accept = strict_accept
        # Push uploads spill to disk (an interrupted ``docker push`` must
        # not pin blob-sized buffers in RAM for the process lifetime).
        # With a configured ``upload_dir`` the sessions are DURABLE: a
        # proxy that crashes mid-push recovers them at startup (below)
        # and the client resumes against the same Location. Sessions idle
        # past the TTL are purged by the app's timer (make_app) and
        # lazily on the next POST.
        self._upload_dir = upload_dir or tempfile.mkdtemp(
            prefix="kt-registry-upload-"
        )
        os.makedirs(self._upload_dir, exist_ok=True)
        self._upload_ttl = upload_ttl_seconds
        self._uploads: dict[str, float] = {}  # uid -> last-touched
        # Recover sessions persisted by a previous process; last-touched
        # resumes from the spool's mtime, so an abandoned session still
        # ages out on schedule rather than restarting its TTL.
        for name in os.listdir(self._upload_dir):
            path = os.path.join(self._upload_dir, name)
            if os.path.isfile(path):
                with contextlib.suppress(OSError):
                    self._uploads[name] = os.path.getmtime(path)

    def _upload_path(self, uid: str) -> str:
        return os.path.join(self._upload_dir, uid)

    def _purge_stale_uploads(self, now: float | None = None) -> int:
        now = time.time() if now is None else now
        stale = [
            uid
            for uid, touched in self._uploads.items()
            if now - touched > self._upload_ttl
        ]
        for uid in stale:
            del self._uploads[uid]
            with contextlib.suppress(OSError):
                os.unlink(self._upload_path(uid))
        return len(stale)

    async def _purge_ctx(self, app: web.Application):
        """Timer-driven TTL purge: an idle proxy must reclaim abandoned
        spools too, not only on the next POST (a crashed `docker push`
        against a quiet registry would otherwise pin disk until the next
        push arrives)."""

        async def loop() -> None:
            while True:
                await asyncio.sleep(max(1.0, self._upload_ttl / 4))
                self._purge_stale_uploads()

        task = asyncio.create_task(loop())
        yield
        task.cancel()
        with contextlib.suppress(asyncio.CancelledError):
            await task

    def make_app(self) -> web.Application:
        app = web.Application(
            client_max_size=1 << 30, middlewares=[api_version_middleware]
        )
        if not self.read_only:
            app.cleanup_ctx.append(self._purge_ctx)
        r = app.router
        r.add_get("/v2/", self._api_check)
        r.add_get("/v2/_catalog", self._catalog)
        r.add_route("*", "/v2/{repo:.+}/manifests/{ref}", self._manifests)
        r.add_post("/v2/{repo:.+}/blobs/uploads/", self._start_upload)
        r.add_get("/v2/{repo:.+}/blobs/uploads/{uid}", self._upload_status)
        r.add_patch("/v2/{repo:.+}/blobs/uploads/{uid}", self._patch_upload)
        r.add_put("/v2/{repo:.+}/blobs/uploads/{uid}", self._finish_upload)
        r.add_route("*", "/v2/{repo:.+}/blobs/{digest}", self._blobs)
        r.add_get("/v2/{repo:.+}/tags/list", self._tags_list)
        return app

    async def _api_check(self, req: web.Request) -> web.Response:
        return web.json_response({})

    # -- manifests ---------------------------------------------------------

    async def _manifests(self, req: web.Request) -> web.Response:
        repo = check_repo_name(req.match_info["repo"])
        ref = req.match_info["ref"]
        if req.method in ("GET", "HEAD"):
            return await self._get_manifest(req, repo, ref)
        if req.method == "PUT":
            return await self._put_manifest(req, repo, ref)
        raise v2_error("UNSUPPORTED", allowed=("GET", "HEAD", "PUT"))

    async def _get_manifest(self, req, repo: str, ref: str) -> web.Response:
        if ref.startswith("sha256:"):
            try:
                d = Digest.parse(ref)
            except DigestError:
                raise v2_error("DIGEST_INVALID", detail={"reference": ref})
        else:
            try:
                d = await self.transferer.get_tag(f"{repo}:{ref}")
            except Exception as e:
                raise map_dependency_error(
                    e, "MANIFEST_UNKNOWN", detail={"name": repo, "tag": ref}
                )
            if d is None:
                raise v2_error(
                    "MANIFEST_UNKNOWN", detail={"name": repo, "tag": ref}
                )
        try:
            data = await self.transferer.download(repo, d)
        except Exception as e:
            raise map_dependency_error(
                e, "MANIFEST_UNKNOWN",
                detail={"name": repo, "reference": str(d)},
            )
        # The stored bytes are only digest-checked, never schema-checked
        # (a blob can be fetched through the manifest route), so nothing
        # here may trust their shape.
        try:
            parsed = json.loads(data)
            media = parsed.get("mediaType") if isinstance(parsed, dict) else None
        except ValueError:
            media = None
        guessed = not isinstance(media, str)
        if guessed:
            media = "application/vnd.docker.distribution.manifest.v2+json"
        # Content negotiation (VERDICT r4 #7): serve the stored type when
        # the client lists it (or sends no Accept / a wildcard); with
        # ``strict_accept`` a client pinned to types we don't have gets a
        # typed 406 instead of bytes it would reject with a confusing
        # schema error. No conversion is attempted -- converting between
        # schema versions changes the digest, which breaks by-digest
        # pulls. A GUESSED type never 406s: OCI 1.0 manifests may legally
        # omit mediaType, and refusing an OCI-pinned client over our
        # docker-typed guess would fail a pull the client could parse
        # fine. Default (strict off) serves the bytes regardless, as the
        # reference does -- old docker/containerd clients with narrow
        # Accept headers parse them fine (ADVICE r5).
        if self.strict_accept and not guessed and not _accepts(req, media):
            raise v2_error(
                "MANIFEST_NOT_ACCEPTABLE",
                detail={
                    "name": repo,
                    "reference": ref,
                    "stored": media,
                    "accept": ",".join(req.headers.getall("Accept", [])),
                },
            )
        headers = {
            "Docker-Content-Digest": str(d),
            "Content-Type": media,
            "Content-Length": str(len(data)),
        }
        if req.method == "HEAD":
            return web.Response(headers=headers)
        return web.Response(body=data, headers=headers)

    async def _put_manifest(self, req, repo: str, ref: str) -> web.Response:
        if self.read_only:
            raise v2_error(
                "UNSUPPORTED", "registry is read-only; push via the proxy"
            )
        data = await req.read()
        try:
            manifest = json.loads(data)
            if not isinstance(manifest, dict):
                raise ValueError("manifest is not a JSON object")
        except ValueError as e:
            raise v2_error("MANIFEST_INVALID", detail={"reason": str(e)})
        d = Digest.from_bytes(data)
        if ref.startswith("sha256:"):
            # Push-by-digest: the URI reference must match the payload.
            try:
                want = Digest.parse(ref)
            except DigestError:
                raise v2_error("DIGEST_INVALID", detail={"reference": ref})
            if want != d:
                raise v2_error(
                    "DIGEST_INVALID",
                    detail={"reference": ref, "computed": str(d)},
                )
        await self.transferer.upload(repo, d, data)
        if not ref.startswith("sha256:"):
            try:
                await self.transferer.put_tag(f"{repo}:{ref}", d)
            except Exception as e:
                from kraken_tpu_torch.utils import httputil

                if httputil.is_conflict(e):
                    # Immutable-tag cluster (build-index 409): refusing a
                    # re-point is DENIED -- the client's credentials are
                    # fine, the operation itself is forbidden. 404-family
                    # codes would mislead push retry logic.
                    raise v2_error(
                        "DENIED", "tag is immutable and already exists",
                        detail={"name": repo, "tag": ref},
                    )
                raise
        return web.Response(
            status=201, headers={"Docker-Content-Digest": str(d)}
        )

    # -- blobs -------------------------------------------------------------

    async def _blobs(self, req: web.Request) -> web.Response:
        repo = check_repo_name(req.match_info["repo"])
        try:
            d = Digest.parse(req.match_info["digest"])
        except DigestError:
            raise v2_error(
                "DIGEST_INVALID", detail={"digest": req.match_info["digest"]}
            )
        if req.method not in ("GET", "HEAD"):
            raise v2_error("UNSUPPORTED", allowed=("GET", "HEAD"))
        blob_detail = {"name": repo, "digest": str(d)}
        if req.method == "HEAD":
            try:
                size = await self.transferer.stat(repo, d)
            except Exception as e:
                raise map_dependency_error(e, "BLOB_UNKNOWN", detail=blob_detail)
            if size is None:
                raise v2_error("BLOB_UNKNOWN", detail=blob_detail)
            return web.Response(headers={
                "Docker-Content-Digest": str(d),
                "Content-Length": str(size),
                "Content-Type": "application/octet-stream",
            })
        # GET streams from a local file (agent: the CAStore cache; proxy: a
        # spooled temp) -- O(chunk) request memory for any layer size.
        try:
            path, is_temp = await self.transferer.download_path(repo, d)
        except Exception as e:
            raise map_dependency_error(e, "BLOB_UNKNOWN", detail=blob_detail)
        headers = {
            "Docker-Content-Digest": str(d),
            "Content-Type": "application/octet-stream",
        }
        if not is_temp:
            # FileResponse handles Range natively (docker resumes
            # interrupted layer pulls with byte ranges).
            return web.FileResponse(path, headers=headers)
        try:
            size = os.path.getsize(path)
            start, end = 0, size - 1
            status = 200
            # http_lite's copy of aiohttp's Range parser -- the same one
            # FileResponse (the agent-flavor path) uses, so both registry
            # flavors agree on lenient/strict cases. Malformed ranges fall
            # back to a full 200 body (permitted by RFC 9110).
            try:
                rng = req.http_range
            except ValueError:
                rng = slice(None, None)
            if rng.start is not None or rng.stop is not None:
                start = rng.start if rng.start is not None else 0
                if start < 0:  # suffix range: bytes=-N
                    start = max(0, size + start)
                # Clamp an end past EOF to the last byte (RFC 9110: a
                # too-large last-byte-pos is satisfiable).
                end = min(rng.stop - 1 if rng.stop is not None else end,
                          size - 1)
                if start >= size or start > end:
                    raise web.HTTPRequestRangeNotSatisfiable(
                        headers={"Content-Range": f"bytes */{size}"}
                    )
                status = 206
                headers["Content-Range"] = f"bytes {start}-{end}/{size}"
            resp = web.StreamResponse(status=status, headers={
                **headers, "Content-Length": str(end - start + 1),
            })
            await resp.prepare(req)
            # open/seek off-loop: a cold page-cache seek on a busy disk
            # stalls every other streaming response on this loop.
            with await asyncio.to_thread(open, path, "rb") as f:
                await asyncio.to_thread(f.seek, start)
                remaining = end - start + 1
                while remaining:
                    chunk = await asyncio.to_thread(
                        f.read, min(1 << 20, remaining)
                    )
                    if not chunk:
                        break
                    remaining -= len(chunk)
                    await resp.write(chunk)
            await resp.write_eof()
            return resp
        finally:
            with contextlib.suppress(OSError):
                os.unlink(path)

    # -- push upload flow --------------------------------------------------

    def _check_writable(self) -> None:
        if self.read_only:
            # Upload-session URLs route no other methods, so Allow is
            # honestly empty.
            raise v2_error(
                "UNSUPPORTED", "registry is read-only; push via the proxy",
                allowed=(),
            )

    async def _start_upload(self, req: web.Request) -> web.Response:
        self._check_writable()
        self._purge_stale_uploads()
        repo = check_repo_name(req.match_info["repo"])
        # Cross-repo mount (?mount=<digest>&from=<repo>): blobs are
        # content-addressed, so if the cluster has (or can restore) the
        # bytes, the origin ADOPTS them into the target namespace --
        # namespace sidecar + writeback, as durable as a real upload --
        # and the mount answers 201 with no upload session. Any miss or
        # parse failure falls through to the normal 202 flow, which is
        # the spec's mandated fallback.
        mount = req.query.get("mount")
        if mount:
            source = req.query.get("from", repo)
            try:
                d = Digest.parse(mount)
                mounted = await self.transferer.mount(source, repo, d)
            except Exception:
                mounted = False
            if mounted:
                return web.Response(
                    status=201,
                    headers={
                        "Location": f"/v2/{repo}/blobs/{d}",
                        "Docker-Content-Digest": str(d),
                    },
                )
        uid = uuidlib.uuid4().hex
        await asyncio.to_thread(_create_empty, self._upload_path(uid))
        self._uploads[uid] = time.time()
        return web.Response(
            status=202,
            headers={
                "Location": f"/v2/{repo}/blobs/uploads/{uid}",
                "Docker-Upload-UUID": uid,
                "Range": "0-0",
            },
        )

    async def _append_body(self, req: web.Request, uid: str) -> int:
        """Stream the request body onto the upload's spool file; returns
        the resulting total size. Touches the session as the stream
        progresses (a multi-hour PATCH must not look idle), and refuses to
        resurrect a session the TTL purge removed mid-stream."""
        path = self._upload_path(uid)
        self._uploads[uid] = time.time()
        with await asyncio.to_thread(open, path, "ab") as f:
            i = 0
            async for chunk in req.content.iter_chunked(1 << 20):
                await asyncio.to_thread(f.write, chunk)
                i += 1
                if i % 64 == 0 and uid in self._uploads:
                    self._uploads[uid] = time.time()
        if uid not in self._uploads:
            # Purged concurrently: the spool file was unlinked under us.
            raise v2_error(
                "BLOB_UPLOAD_UNKNOWN", "upload session expired",
                detail={"uuid": uid},
            )
        self._uploads[uid] = time.time()
        return os.path.getsize(path)

    async def _upload_status(self, req: web.Request) -> web.Response:
        """Spec upload-status probe: docker GETs the upload URL to learn
        the committed offset before resuming an interrupted push."""
        self._check_writable()
        check_repo_name(req.match_info["repo"])
        uid = req.match_info["uid"]
        if uid not in self._uploads:
            raise v2_error("BLOB_UPLOAD_UNKNOWN", detail={"uuid": uid})
        try:
            size = os.path.getsize(self._upload_path(uid))
        except OSError:
            raise v2_error("BLOB_UPLOAD_UNKNOWN", detail={"uuid": uid})
        return web.Response(status=204, headers={
            "Docker-Upload-UUID": uid,
            "Range": f"0-{max(size - 1, 0)}",
        })

    async def _patch_upload(self, req: web.Request) -> web.Response:
        self._check_writable()
        repo = check_repo_name(req.match_info["repo"])  # before any spooling
        uid = req.match_info["uid"]
        if uid not in self._uploads:
            raise v2_error("BLOB_UPLOAD_UNKNOWN", detail={"uuid": uid})
        size = await self._append_body(req, uid)
        return web.Response(
            status=202,
            headers={
                "Location": f"/v2/{repo}/blobs/uploads/{uid}",
                "Docker-Upload-UUID": uid,
                "Range": f"0-{max(size - 1, 0)}",
            },
        )

    async def _finish_upload(self, req: web.Request) -> web.Response:
        self._check_writable()
        uid = req.match_info["uid"]
        repo = check_repo_name(req.match_info["repo"])
        if uid not in self._uploads:
            raise v2_error("BLOB_UPLOAD_UNKNOWN", detail={"uuid": uid})
        path = self._upload_path(uid)
        try:
            await self._append_body(req, uid)  # final chunk may ride the PUT
            try:
                d = Digest.parse(req.query["digest"])
            except (KeyError, DigestError):
                raise v2_error(
                    "DIGEST_INVALID", "missing or malformed digest parameter",
                    detail={"digest": req.query.get("digest", "")},
                )

            def _file_digest() -> Digest:
                with open(path, "rb") as f:
                    return Digest.from_reader(f)

            got = await asyncio.to_thread(_file_digest)
            if got != d:
                raise v2_error(
                    "DIGEST_INVALID",
                    detail={"expected": str(d), "computed": str(got)},
                )
            await self.transferer.upload_file(repo, d, path)
        finally:
            self._uploads.pop(uid, None)
            with contextlib.suppress(OSError):
                os.unlink(path)
        return web.Response(
            status=201, headers={"Docker-Content-Digest": str(d)}
        )

    # -- listings ----------------------------------------------------------

    @staticmethod
    def _paginate(req: web.Request, items: list[str]):
        """Registry v2 pagination: ?n=<max>&last=<exclusive start>. Adds
        the RFC5988 Link header when a further page exists (docker clients
        follow it for large repos). ``n`` must be positive -- n=0 would
        return an empty page with no Link, which paging clients read as
        "listing complete"."""
        last = req.query.get("last", "")
        if last:
            items = [t for t in items if t > last]
        n = req.query.get("n")
        headers = {}
        if n is not None:
            try:
                n = int(n)
                if n <= 0:
                    raise ValueError
            except ValueError:
                raise v2_error(
                    "PAGINATION_NUMBER_INVALID", detail={"n": req.query["n"]}
                )
            if len(items) > n:
                items = items[:n]
                headers["Link"] = (
                    f'<{req.path}?n={n}&last={items[-1]}>; rel="next"'
                )
        return items, headers

    async def _tags_list(self, req: web.Request) -> web.Response:
        repo = check_repo_name(req.match_info["repo"])
        try:
            tags = await self.transferer.list_repo_tags(repo)
        except Exception:
            # Transient dependency failure must stay a retryable 5xx: a
            # 404 here would tell docker a live repository doesn't exist.
            raise v2_error("UNKNOWN", "failed to list tags")
        if not tags:
            # A repository exists iff it has tags (tags are the only
            # repo-scoped state here); the spec's answer for an unknown
            # repo is NAME_UNKNOWN, which docker surfaces as
            # "repository not found" rather than an empty listing.
            raise v2_error("NAME_UNKNOWN", detail={"name": repo})
        tags, headers = self._paginate(req, sorted(tags))
        return web.json_response({"name": repo, "tags": tags}, headers=headers)

    async def _catalog(self, req: web.Request) -> web.Response:
        # Backed by build-index listings (proxy/registryoverride in the
        # reference); agents typically have this disabled.
        try:
            tags = await self.transferer.list_all_tags()
        except Exception:
            raise v2_error("UNKNOWN", "failed to list repositories")
        repos = sorted({t.rpartition(":")[0] for t in tags if ":" in t})
        repos, headers = self._paginate(req, repos)
        return web.json_response({"repositories": repos}, headers=headers)
