"""S3-compatible object-store backend (AWS Signature V4, pure stdlib).

The port's copy of ``kraken_tpu.backend.s3backend`` (``s3`` and ``gcs``):
the same SigV4 headers byte for byte, the same request sequence.

Mirrors uber/kraken ``lib/backend/s3backend`` (Stat/Download/Upload/List
against S3) -- upstream path, unverified; SURVEY.md SS2.3 -- rebuilt over
the S3 REST API directly (no SDK in the image): SigV4 request signing with
hmac/hashlib, ListObjectsV2 XML via xml.etree. Works against AWS, MinIO,
and the in-repo fake (tests/test_cloud_backends.py).

The ``gcs`` registration reuses this client against Google Cloud
Storage's S3-interoperable XML API (HMAC keys;
https://storage.googleapis.com) -- a deliberate divergence from upstream's
native-SDK gcsbackend, chosen because the interop surface keeps one signed
client for both clouds.
"""

from __future__ import annotations

import asyncio
import datetime
import hashlib
import hmac
import logging
import os
import urllib.parse
import xml.etree.ElementTree as ET

from kraken_tpu_torch.backend.base import (
    BackendClient,
    BlobInfo,
    BlobNotFoundError,
    register_backend,
)
from kraken_tpu_torch.backend.namepath import get_pather
from kraken_tpu_torch.utils.httputil import HTTPClient, HTTPError

_log = logging.getLogger("kraken.backend.s3")

_EMPTY_SHA = hashlib.sha256(b"").hexdigest()


def _hmac(key: bytes, msg: str) -> bytes:
    return hmac.new(key, msg.encode(), hashlib.sha256).digest()


def sigv4_headers(
    method: str,
    url: str,
    *,
    access_key: str,
    secret_key: str,
    region: str,
    service: str = "s3",
    payload_sha256: str = _EMPTY_SHA,
    now: datetime.datetime | None = None,
) -> dict:
    """AWS Signature V4 headers for one request (host-style or path-style).

    Returns {"Authorization", "x-amz-date", "x-amz-content-sha256"}.
    """
    parts = urllib.parse.urlsplit(url)
    now = now or datetime.datetime.now(datetime.timezone.utc)
    amz_date = now.strftime("%Y%m%dT%H%M%SZ")
    datestamp = now.strftime("%Y%m%d")

    # The request path is already single-percent-encoded by the caller
    # (``_url`` quotes the key); S3 canonicalizes the path exactly as sent,
    # so re-quoting here would double-encode ('%' -> '%25') and produce
    # SignatureDoesNotMatch for any key containing ':', '+', space, etc.
    canonical_uri = parts.path or "/"
    # Query keys/values must be sorted and URI-encoded.
    q = urllib.parse.parse_qsl(parts.query, keep_blank_values=True)
    canonical_query = "&".join(
        f"{urllib.parse.quote(k, safe='')}={urllib.parse.quote(v, safe='')}"
        for k, v in sorted(q)
    )
    host = parts.netloc
    canonical_headers = (
        f"host:{host}\nx-amz-content-sha256:{payload_sha256}\n"
        f"x-amz-date:{amz_date}\n"
    )
    signed = "host;x-amz-content-sha256;x-amz-date"
    creq = "\n".join(
        (method, canonical_uri, canonical_query, canonical_headers, signed,
         payload_sha256)
    )
    scope = f"{datestamp}/{region}/{service}/aws4_request"
    sts = "\n".join(
        ("AWS4-HMAC-SHA256", amz_date, scope,
         hashlib.sha256(creq.encode()).hexdigest())
    )
    k = _hmac(b"AWS4" + secret_key.encode(), datestamp)
    k = _hmac(k, region)
    k = _hmac(k, service)
    k = _hmac(k, "aws4_request")
    signature = hmac.new(k, sts.encode(), hashlib.sha256).hexdigest()
    return {
        "Authorization": (
            f"AWS4-HMAC-SHA256 Credential={access_key}/{scope}, "
            f"SignedHeaders={signed}, Signature={signature}"
        ),
        "x-amz-date": amz_date,
        "x-amz-content-sha256": payload_sha256,
    }


@register_backend("s3")
class S3Backend(BackendClient):
    """config: endpoint, bucket, access_key, secret_key, region ("us-east-1"),
    pather ("sharded_docker_blob"), root ("")."""

    service = "s3"

    def __init__(self, config: dict):
        self.endpoint = config["endpoint"].rstrip("/")
        self.bucket = config["bucket"]
        self.access_key = config.get("access_key", "")
        self.secret_key = config.get("secret_key", "")
        self.region = config.get("region", "us-east-1")
        self.root = config.get("root", "")
        self._pather = get_pather(config.get("pather", "sharded_docker_blob"))
        self._http = HTTPClient(retries=config.get("retries", 3))
        # Multipart knobs: S3's floor is 5 MiB/part; 64 MiB parts keep a
        # 5 GiB layer at ~80 requests while bounding memory to one part.
        self.multipart_threshold = int(
            config.get("multipart_threshold", 64 * 1024 * 1024)
        )
        self.multipart_part_size = max(
            int(config.get("multipart_part_size", 64 * 1024 * 1024)),
            5 * 1024 * 1024,
        )

    def _url(self, key: str) -> str:
        return f"{self.endpoint}/{self.bucket}/" + urllib.parse.quote(key)

    def _key(self, name: str) -> str:
        return self._pather(self.root, name)

    async def _signed(
        self, method: str, url: str, data: bytes | None = None,
        ok=(200, 201, 204),
    ):
        payload_sha = hashlib.sha256(data or b"").hexdigest()
        headers = sigv4_headers(
            method, url,
            access_key=self.access_key, secret_key=self.secret_key,
            region=self.region, service=self.service,
            payload_sha256=payload_sha,
        )
        return await self._http.request_full(
            method, url, data=data, headers=headers, ok_statuses=ok,
            retry_5xx=True,
        )

    async def stat(self, namespace: str, name: str) -> BlobInfo:
        url = self._url(self._key(name))
        try:
            _s, headers, _b = await self._signed("HEAD", url, ok=(200,))
        except HTTPError as e:
            if e.status == 404:
                raise BlobNotFoundError(name) from None
            raise
        return BlobInfo(int(headers.get("Content-Length", 0)))

    async def download(self, namespace: str, name: str) -> bytes:
        url = self._url(self._key(name))
        try:
            _s, _h, body = await self._signed("GET", url, ok=(200,))
        except HTTPError as e:
            if e.status == 404:
                raise BlobNotFoundError(name) from None
            raise
        return body

    async def upload(self, namespace: str, name: str, data: bytes) -> None:
        url = self._url(self._key(name))
        await self._signed("PUT", url, data=data, ok=(200, 201, 204))

    async def upload_file(self, namespace: str, name: str, path: str) -> None:
        """Multipart upload for large blobs (S3 caps a single PUT at
        5 GiB, and buffering a multi-GB docker layer for one PUT is a
        memory cliff); small files take the single-PUT fast path. Part
        reads stream off disk one part at a time -- peak memory is one
        part, not the blob."""
        size = await asyncio.to_thread(os.path.getsize, path)
        if size <= self.multipart_threshold:
            def _read() -> bytes:
                with open(path, "rb") as f:
                    return f.read()

            await self.upload(namespace, name, await asyncio.to_thread(_read))
            return

        url = self._url(self._key(name))
        _s, _h, body = await self._signed(
            "POST", f"{url}?uploads", ok=(200,)
        )
        upload_id = next(
            (e.text for e in ET.fromstring(body).iter()
             if e.tag.endswith("UploadId")),
            None,
        )
        if not upload_id:
            raise HTTPError("POST", f"{url}?uploads", 500, b"no UploadId")
        try:
            etags: list[str] = []
            part_num = 0
            # open() off-loop too: on a cold NFS/network mount the open
            # alone can stall the loop for the full mount timeout.
            with await asyncio.to_thread(open, path, "rb") as f:
                while True:
                    chunk = await asyncio.to_thread(
                        f.read, self.multipart_part_size
                    )
                    if not chunk:
                        break
                    part_num += 1
                    part_url = (
                        f"{url}?partNumber={part_num}&uploadId="
                        f"{urllib.parse.quote(upload_id, safe='')}"
                    )
                    _ps, ph, _pb = await self._signed(
                        "PUT", part_url, data=chunk, ok=(200,)
                    )
                    # Case-insensitive: the HTTP client hands back a plain
                    # dict and servers spell it ETag/Etag/etag. The old
                    # exact-key lookup silently embedded <ETag></ETag> --
                    # real S3 rejects that at complete-time, far from here.
                    etag = next(
                        (v for k, v in ph.items() if k.lower() == "etag"),
                        "",
                    ).strip('"')
                    if not etag:
                        # Fail HERE, not at complete-time: an empty <ETag>
                        # in CompleteMultipartUpload produces a confusing
                        # S3 error far from the part that caused it.
                        raise HTTPError(
                            "PUT", part_url, 500,
                            f"part {part_num}: no ETag in response".encode(),
                        )
                    etags.append(etag)
            complete = "<CompleteMultipartUpload>" + "".join(
                f"<Part><PartNumber>{i + 1}</PartNumber>"
                f"<ETag>{etag}</ETag></Part>"
                for i, etag in enumerate(etags)
            ) + "</CompleteMultipartUpload>"
            done_url = (
                f"{url}?uploadId={urllib.parse.quote(upload_id, safe='')}"
            )
            _s, _h, body = await self._signed(
                "POST", done_url, data=complete.encode(), ok=(200,)
            )
            # S3 reports complete-time failures inside a 200 body.
            if b"<Error>" in body:
                raise HTTPError("POST", done_url, 500, body)
        except BaseException:
            # Abort so the bucket doesn't accrete billed orphan parts; the
            # original failure is what the caller needs to see.
            try:
                await self._signed(
                    "DELETE",
                    f"{url}?uploadId="
                    f"{urllib.parse.quote(upload_id, safe='')}",
                    ok=(200, 204),
                )
            except Exception:
                _log.warning(
                    "multipart abort failed; billed orphan parts may"
                    " remain in the bucket", exc_info=True,
                )
            raise

    async def download_to_file(
        self, namespace: str, name: str, dest_path: str
    ) -> int:
        """Streamed GET straight to disk (O(chunk) memory for any blob)."""
        url = self._url(self._key(name))
        headers = sigv4_headers(
            "GET", url,
            access_key=self.access_key, secret_key=self.secret_key,
            region=self.region, service=self.service,
        )
        try:
            return await self._http.get_to_file(url, dest_path, headers=headers)
        except HTTPError as e:
            if e.status == 404:
                raise BlobNotFoundError(name) from None
            raise

    async def list(self, prefix: str) -> list[str]:
        """ListObjectsV2 with continuation; returns full keys under
        ``root``-joined prefix."""
        out: list[str] = []
        token: str | None = None
        key_prefix = f"{self.root}/{prefix}" if self.root else prefix
        while True:
            query = {"list-type": "2", "prefix": key_prefix}
            if token:
                query["continuation-token"] = token
            url = (
                f"{self.endpoint}/{self.bucket}?"
                + urllib.parse.urlencode(sorted(query.items()))
            )
            _s, _h, body = await self._signed("GET", url, ok=(200,))
            ns = {"s3": "http://s3.amazonaws.com/doc/2006-03-01/"}
            root = ET.fromstring(body)
            # Tolerate both namespaced (AWS) and bare (fakes) XML.
            keys = [e.text for e in root.iter() if e.tag.endswith("Key")]
            out.extend(k for k in keys if k)
            truncated = next(
                (e.text for e in root.iter() if e.tag.endswith("IsTruncated")),
                "false",
            )
            token = next(
                (e.text for e in root.iter()
                 if e.tag.endswith("NextContinuationToken")),
                None,
            )
            if truncated != "true" or not token:
                return out

    async def close(self) -> None:
        await self._http.close()


@register_backend("gcs")
def _gcs_factory(config: dict) -> S3Backend:
    """GCS via the S3-interoperable XML API (HMAC keys)."""
    config = dict(config)
    config.setdefault("endpoint", "https://storage.googleapis.com")
    config.setdefault("region", "auto")
    return S3Backend(config)
