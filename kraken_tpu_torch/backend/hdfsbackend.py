"""HDFS backend over the WebHDFS REST API.

The port's copy of ``kraken_tpu.backend.hdfsbackend``.

Mirrors uber/kraken ``lib/backend/hdfsbackend`` (Stat/Download/Upload/List
against HDFS via webhdfs) -- upstream path, unverified; SURVEY.md SS2.3.
The two-step CREATE/OPEN redirect dance (namenode 307 -> datanode) is
followed manually so the data body is only sent to the datanode, exactly
as the protocol specifies.
"""

from __future__ import annotations

import json
import urllib.parse

from kraken_tpu_torch.backend.base import (
    BackendClient,
    BlobInfo,
    BlobNotFoundError,
    register_backend,
)
from kraken_tpu_torch.backend.namepath import get_pather
from kraken_tpu_torch.utils.httputil import HTTPClient, HTTPError


@register_backend("hdfs")
class HDFSBackend(BackendClient):
    """config: namenode ("http://host:9870"), root, user ("kraken"),
    pather ("sharded_docker_blob")."""

    def __init__(self, config: dict):
        self.namenode = config["namenode"].rstrip("/")
        self.user = config.get("user", "kraken")
        self.root = config.get("root", "")
        self._pather = get_pather(config.get("pather", "sharded_docker_blob"))
        self._http = HTTPClient(retries=config.get("retries", 3))

    def _url(self, path: str, op: str, **params) -> str:
        q = {"op": op, "user.name": self.user, **params}
        return (
            f"{self.namenode}/webhdfs/v1/"
            + urllib.parse.quote(path)
            + "?"
            + urllib.parse.urlencode(q)
        )

    def _path(self, name: str) -> str:
        return self._pather(self.root, name)

    async def stat(self, namespace: str, name: str) -> BlobInfo:
        try:
            body = await self._http.get(
                self._url(self._path(name), "GETFILESTATUS")
            )
        except HTTPError as e:
            if e.status == 404:
                raise BlobNotFoundError(name) from None
            raise
        return BlobInfo(json.loads(body)["FileStatus"]["length"])

    async def download(self, namespace: str, name: str) -> bytes:
        try:
            return await self._http.get(self._url(self._path(name), "OPEN"))
        except HTTPError as e:
            if e.status == 404:
                raise BlobNotFoundError(name) from None
            raise

    async def upload(self, namespace: str, name: str, data: bytes) -> None:
        # Step 1: namenode returns 307 with the datanode Location.
        status, headers, _ = await self._http.request_full(
            "PUT",
            self._url(self._path(name), "CREATE", overwrite="true"),
            ok_statuses=(307,),
            allow_redirects=False,
        )
        # Step 2: send the bytes to the datanode.
        await self._http.request_full(
            "PUT", headers["Location"], data=data, ok_statuses=(200, 201)
        )

    async def list(self, prefix: str) -> list[str]:
        path = f"{self.root}/{prefix}" if self.root else prefix
        try:
            body = await self._http.get(self._url(path, "LISTSTATUS"))
        except HTTPError as e:
            if e.status == 404:
                return []
            raise
        statuses = json.loads(body)["FileStatuses"]["FileStatus"]
        return [s["pathSuffix"] for s in statuses]

    async def close(self) -> None:
        await self._http.close()
