"""testfs: a trivial HTTP file server + client -- the universal fake backend.

Mirrors uber/kraken ``lib/backend/testfs`` (HTTP file server standing in
for S3/GCS/... in every integration test) -- upstream path, unverified;
SURVEY.md SS2.3/SS4. The server half runs in the herd; the client half
registers as backend ``testfs``. The port's copy of
``kraken_tpu.backend.testfs``: the server runs on the port's own HTTP/1.1
(``utils/http_lite``) and speaks the same routes, so either package's
client talks to either package's server.
"""

from __future__ import annotations

from kraken_tpu_torch.utils import http_lite as web

from kraken_tpu_torch.backend.base import (
    BackendClient,
    BlobInfo,
    BlobNotFoundError,
    register_backend,
)
from kraken_tpu_torch.utils.httputil import HTTPClient, HTTPError, base_url


@register_backend("testfs")
class TestFSClient(BackendClient):
    def __init__(self, config: dict):
        self.addr = config["addr"]  # host:port
        self._http = HTTPClient(retries=config.get("retries", 3))

    def _url(self, name: str) -> str:
        return f"{base_url(self.addr)}/files/{name}"

    async def stat(self, namespace: str, name: str) -> BlobInfo:
        try:
            body = await self._http.get(self._url(name) + "?stat=1")
        except HTTPError as e:
            if e.status == 404:
                raise BlobNotFoundError(name) from None
            raise
        return BlobInfo(int(body))

    async def download(self, namespace: str, name: str) -> bytes:
        try:
            return await self._http.get(self._url(name))
        except HTTPError as e:
            if e.status == 404:
                raise BlobNotFoundError(name) from None
            raise

    async def upload(self, namespace: str, name: str, data: bytes) -> None:
        await self._http.put(self._url(name), data=data)

    async def list(self, prefix: str) -> list[str]:
        body = await self._http.get(f"{base_url(self.addr)}/list/{prefix}")
        return [l for l in body.decode().splitlines() if l]

    async def close(self) -> None:
        await self._http.close()


class TestFSServer:
    """In-memory HTTP file server. ``async with TestFSServer(port) as s:``"""

    __test__ = False  # not a pytest class despite the name

    def __init__(self, port: int = 0, host: str = "127.0.0.1"):
        self.host = host
        self.port = port
        self._files: dict[str, bytes] = {}
        self._runner: web.AppRunner | None = None

    @property
    def addr(self) -> str:
        return f"{self.host}:{self.port}"

    def make_app(self) -> web.Application:
        app = web.Application(client_max_size=1 << 30)
        app.router.add_get("/files/{name:.*}", self._get)
        app.router.add_put("/files/{name:.*}", self._put)
        app.router.add_get("/list/{prefix:.*}", self._list)
        return app

    async def _get(self, req: web.Request) -> web.Response:
        name = req.match_info["name"]
        data = self._files.get(name)
        if data is None:
            return web.Response(status=404)
        if req.query.get("stat"):
            return web.Response(text=str(len(data)))
        return web.Response(body=data)

    async def _put(self, req: web.Request) -> web.Response:
        self._files[req.match_info["name"]] = await req.read()
        return web.Response(status=201)

    async def _list(self, req: web.Request) -> web.Response:
        prefix = req.match_info["prefix"]
        names = sorted(n for n in self._files if n.startswith(prefix))
        return web.Response(text="\n".join(names))

    async def __aenter__(self) -> "TestFSServer":
        self._runner, self.port = await web.serve(self.make_app(), self.host, self.port)
        return self

    async def __aexit__(self, *exc) -> None:
        if self._runner:
            await self._runner.cleanup()
