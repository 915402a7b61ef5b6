"""The port's remote backends (``s3``, ``gcs``, ``hdfs``, ``http``,
``shadow``, ``registry_blob``, ``registry_tag``) held against
``kraken_tpu.backend`` on the CPU.

Each backend of each package runs against a fresh copy of the reference's
own fakes (``tests/test_cloud_backends.py``: ``FakeS3`` re-derives every
SigV4 signature with the reference's ``sigv4_headers``, ``FakeWebHDFS``
answers CREATE with the namenode's 307, ``FakeUpstreamRegistry`` speaks the
docker token flow and 307s blob GETs to a presigned store URL that refuses
an ``Authorization`` header). The fakes log every request's (method, path,
query); both packages must send the same sequence and leave the same keys
and bodies. ``http`` and ``shadow`` run against each package's ``testfs``.

The cold refresh and the pull-through of the card smoke's ``backends``
phase run here on both packages' origins: the blob exists only in S3 (or
only upstream), a GET on the origin fills the miss, and the port's origin,
hashing through ``TorchPieceHasher(device="cpu")`` (the kernels' plain
versions), must hold the reference origin's metainfo for the same blob.
"""

import asyncio
import datetime
import hashlib
import json

import numpy as np
import pytest
from aiohttp import ClientSession, web
from hypothesis import HealthCheck, given, settings, strategies as st

import kraken_tpu.backend as jax_backend
import kraken_tpu.backend.registrybackend as jax_registry
import kraken_tpu.backend.s3backend as jax_s3
import kraken_tpu.backend.testfs as jax_testfs
import kraken_tpu.core.hasher as jax_hasher
import kraken_tpu.origin.blobrefresh as jax_refresh
import kraken_tpu.origin.metainfogen as jax_gen
import kraken_tpu.origin.server as jax_server
import kraken_tpu.store as jax_store
import kraken_tpu.utils.httputil as jax_httputil
import kraken_tpu_torch as kt
import kraken_tpu_torch.backend as port_backend
import kraken_tpu_torch.backend.registrybackend as port_registry
import kraken_tpu_torch.backend.s3backend as port_s3
import kraken_tpu_torch.backend.testfs as port_testfs
import kraken_tpu_torch.origin.blobrefresh as port_refresh
import kraken_tpu_torch.origin.server as port_server
import kraken_tpu_torch.utils.httputil as port_httputil
from kraken_tpu_torch.backend.namepath import get_pather
from kraken_tpu_torch.utils import http_lite
from test_cloud_backends import FakeS3, FakeUpstreamRegistry, FakeWebHDFS

PORT, JAX = "port", "jax"
PKG = {
    PORT: (port_backend, port_httputil, port_testfs),
    JAX: (jax_backend, jax_httputil, jax_testfs),
}
NOW = datetime.datetime(2024, 5, 17, 12, 34, 56, tzinfo=datetime.timezone.utc)
PIECE = 2048


def run(coro):
    return asyncio.run(coro)


def _seen(log: list, req: web.Request) -> None:
    log.append((req.method, req.path, tuple(sorted(req.query.items()))))


class LoggedS3(FakeS3):
    __test__ = False

    def __init__(self, **kw):
        super().__init__(**kw)
        self.log: list = []

    async def _handle(self, req):
        _seen(self.log, req)
        return await super()._handle(req)


class LoggedHDFS(FakeWebHDFS):
    __test__ = False

    def __init__(self):
        super().__init__()
        self.log: list = []

    async def _handle(self, req):
        _seen(self.log, req)
        return await super()._handle(req)


class LoggedRegistry(FakeUpstreamRegistry):
    """The reference's upstream, logging each request and each
    ``Authorization`` header that reached the presigned store URL."""

    __test__ = False

    def __init__(self, **kw):
        super().__init__(**kw)
        self.log: list = []
        self.cdn_auth: list = []

    async def _token_endpoint(self, req):
        _seen(self.log, req)
        return await super()._token_endpoint(req)

    async def _blob(self, req):
        _seen(self.log, req)
        return await super()._blob(req)

    async def _manifest(self, req):
        _seen(self.log, req)
        return await super()._manifest(req)

    async def _cdn(self, req):
        _seen(self.log, req)
        self.cdn_auth.append(req.headers.get("Authorization"))
        return await super()._cdn(req)


def blob_of(seed: int, size: int) -> bytes:
    return np.random.default_rng(seed).bytes(size)


def digest_of(data: bytes) -> str:
    return "sha256:" + hashlib.sha256(data).hexdigest()


def s3_config(s3: FakeS3, **kw) -> dict:
    return {"endpoint": f"http://{s3.addr}", "bucket": "bkt", "access_key": s3.access_key,
            "secret_key": s3.secret_key, "region": s3.region, **kw}


# -- SigV4 ----------------------------------------------------------------------

_KEY_CHARS = st.characters(min_codepoint=32, max_codepoint=0x2FF, blacklist_characters="\x7f")


@settings(max_examples=200, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(
    method=st.sampled_from(["GET", "PUT", "HEAD", "POST", "DELETE"]),
    key=st.text(_KEY_CHARS, min_size=1, max_size=40),
    query=st.lists(st.tuples(st.text(_KEY_CHARS, min_size=1, max_size=12),
                             st.text(_KEY_CHARS, max_size=12)), max_size=4),
    access=st.text("ABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789", min_size=1, max_size=20),
    secret=st.text(_KEY_CHARS, min_size=1, max_size=40),
    region=st.sampled_from(["us-east-1", "eu-west-3", "auto"]),
    service=st.sampled_from(["s3", "storage"]),
    payload=st.binary(max_size=64),
)
def test_sigv4_headers_are_byte_equal(method, key, query, access, secret, region, service,
                                      payload):
    """The same request at a fixed time signs to the same three headers:
    any key (quoted once, as ``_url`` quotes it), any query, any keys."""
    from urllib.parse import quote, urlencode

    url = f"http://127.0.0.1:9000/bkt/{quote(key)}"
    if query:
        url += "?" + urlencode(query)
    kw = dict(access_key=access, secret_key=secret, region=region, service=service,
              payload_sha256=hashlib.sha256(payload).hexdigest(), now=NOW)
    got = port_s3.sigv4_headers(method, url, **kw)
    assert got == jax_s3.sigv4_headers(method, url, **kw)
    assert list(got) == ["Authorization", "x-amz-date", "x-amz-content-sha256"]


def test_sigv4_defaults_match():
    url = "http://h:1/b/k%3Aey?uploads"
    assert (port_s3.sigv4_headers("POST", url, access_key="a", secret_key="s", region="r",
                                  now=NOW)
            == jax_s3.sigv4_headers("POST", url, access_key="a", secret_key="s", region="r",
                                    now=NOW))
    assert port_s3._EMPTY_SHA == jax_s3._EMPTY_SHA == hashlib.sha256(b"").hexdigest()


# -- S3 and GCS -------------------------------------------------------------------


async def _s3_roundtrip(pkg: str, tmp_path) -> tuple:
    backend, httputil, _ = PKG[pkg]
    async with LoggedS3() as s3:
        client = backend.base.make_backend("s3", s3_config(s3, root="pre"))
        d = digest_of(b"x")[7:]
        try:
            body = blob_of(1, 3000)
            await client.upload("ns", d, body)
            await client.upload("ns", "second-name", b"odd")
            size = (await client.stat("ns", d)).size
            got = await client.download("ns", d)
            n = await client.download_to_file("ns", d, str(tmp_path / f"{pkg}.bin"))
            listed = await client.list("")
            with pytest.raises(backend.BlobNotFoundError):
                await client.download("ns", "0" * 64)
            with pytest.raises(backend.BlobNotFoundError):
                await client.stat("ns", "0" * 64)
            with pytest.raises(backend.BlobNotFoundError):
                await client.download_to_file("ns", "0" * 64, str(tmp_path / "nope"))
        finally:
            await client.close()
        assert got == body and size == n == len(body)
        assert (tmp_path / f"{pkg}.bin").read_bytes() == body
        return dict(s3.objects), sorted(listed), s3.log


def test_s3_roundtrip_sends_the_references_requests(tmp_path):
    ref = run(_s3_roundtrip(JAX, tmp_path))
    port = run(_s3_roundtrip(PORT, tmp_path))
    assert port == ref
    objects, listed, log = port
    d = digest_of(b"x")[7:]
    assert get_pather("sharded_docker_blob")("pre", d) in objects
    assert listed == sorted(objects)
    assert ("GET", "/bkt", (("list-type", "2"), ("prefix", "pre/"))) in log


async def _s3_multipart(pkg: str, tmp_path) -> tuple:
    backend, httputil, _ = PKG[pkg]
    async with LoggedS3() as s3:
        client = backend.base.make_backend(
            "s3", s3_config(s3, pather="identity", multipart_threshold=1024))
        client.multipart_part_size = 700
        try:
            big = tmp_path / f"{pkg}-big.bin"
            payload = blob_of(2, 2560)  # four parts: 700, 700, 700, 460
            big.write_bytes(payload)
            await client.upload_file("ns", "bigkey", str(big))
            initiated = s3.multipart_initiated
            small = tmp_path / f"{pkg}-small.bin"
            small.write_bytes(b"tiny")
            await client.upload_file("ns", "smallkey", str(small))
            # A part that fails aborts the upload: the fake forgets every
            # session after the initiate.
            real = s3.multipart

            class Vanishing(dict):
                def get(self, k, default=None):
                    return None

            s3.multipart = Vanishing()
            with pytest.raises(httputil.HTTPError):
                await client.upload_file("ns", "failkey", str(big))
            s3.multipart = real
        finally:
            await client.close()
        assert s3.objects["bigkey"] == payload and s3.objects["smallkey"] == b"tiny"
        return (initiated, s3.multipart_initiated, s3.multipart_aborted,
                sorted(s3.objects), s3.log)


def test_s3_multipart_parts_and_the_abort_on_a_failed_part(tmp_path):
    ref = run(_s3_multipart(JAX, tmp_path))
    port = run(_s3_multipart(PORT, tmp_path))
    assert port == ref
    initiated, total, aborted, keys, log = port
    assert (initiated, total, aborted) == (1, 2, 1) and "failkey" not in keys
    parts = [q for m, p, q in log if m == "PUT" and dict(q).get("partNumber")]
    assert [dict(q)["partNumber"] for q in parts[:4]] == ["1", "2", "3", "4"]
    assert [m for m, p, q in log][-2:] == ["PUT", "DELETE"]


def test_gcs_is_the_s3_client_on_gcs_defaults():
    cfg = {"bucket": "b", "access_key": "a", "secret_key": "s"}
    port = port_backend.base.make_backend("gcs", cfg)
    ref = jax_backend.base.make_backend("gcs", cfg)
    assert isinstance(port, port_s3.S3Backend)
    for c in (port, ref):
        assert (c.endpoint, c.region) == ("https://storage.googleapis.com", "auto")
    assert (port.multipart_threshold, port.multipart_part_size) == (
        ref.multipart_threshold, ref.multipart_part_size) == (64 << 20, 64 << 20)
    assert port_backend.base.make_backend(
        "gcs", {**cfg, "endpoint": "http://h:1/", "region": "x"}).endpoint == "http://h:1"


# -- HDFS -------------------------------------------------------------------------------


async def _hdfs(pkg: str) -> tuple:
    backend, _, _ = PKG[pkg]
    async with LoggedHDFS() as hdfs:
        client = backend.base.make_backend("hdfs", {"namenode": f"http://{hdfs.addr}",
                                                    "root": "/kraken", "pather": "identity"})
        try:
            await client.upload("ns", "a/one", b"first")
            await client.upload("ns", "a/two", blob_of(3, 5000))
            size = (await client.stat("ns", "a/two")).size
            got = await client.download("ns", "a/one")
            listed = await client.list("a")
            empty = await client.list("nothing")
            with pytest.raises(backend.BlobNotFoundError):
                await client.download("ns", "a/three")
            with pytest.raises(backend.BlobNotFoundError):
                await client.stat("ns", "a/three")
        finally:
            await client.close()
        return size, got, listed, empty, dict(hdfs.files), hdfs.log


def test_hdfs_follows_the_namenodes_307_as_the_reference():
    ref = run(_hdfs(JAX))
    port = run(_hdfs(PORT))
    assert port == ref
    size, got, listed, empty, files, log = port
    assert (size, got, listed, empty) == (5000, b"first", ["one", "two"], [])
    creates = [(p, dict(q)) for m, p, q in log if m == "PUT"]
    # Two hops a file: the namenode's CREATE (no body), then the datanode's.
    assert [q.get("step") for p, q in creates] == [None, "2", None, "2"]
    assert all(q["op"] == "CREATE" and q["user.name"] == "kraken" for p, q in creates)


# -- the upstream registry ----------------------------------------------------------


REGISTRY_FLOWS = {
    "open": {},
    "anonymous": {"token_auth": True},
    "basic": {"token_auth": True, "username": "puller", "password": "hunter2"},
    "presigned": {"token_auth": True, "redirect_blobs": True},
}


async def _registry(pkg: str, flow: str) -> dict:
    backend, _, _ = PKG[pkg]
    fake = REGISTRY_FLOWS[flow]
    async with LoggedRegistry(**fake) as up:
        layer = blob_of(4, 4000)
        d = digest_of(layer)
        up.blobs[f"library/ubuntu/{d}"] = layer
        manifest = json.dumps({"schemaVersion": 2, "layers": [{"digest": d}]}).encode()
        up.manifests["library/ubuntu:22.04"] = manifest
        creds = {k: fake[k] for k in ("username", "password") if k in fake}
        blobs = backend.base.make_backend("registry_blob", {"address": up.addr, **creds})
        tags = backend.base.make_backend("registry_tag", {"address": up.addr, **creds})
        out = {}
        try:
            out["blob"] = await blobs.download("library/ubuntu", d)
            out["bare_hex"] = await blobs.download("library/ubuntu", d[7:])
            out["size"] = (await blobs.stat("library/ubuntu", d)).size
            out["tag"] = await tags.download("library/ubuntu", "library/ubuntu:22.04")
            out["tag_size"] = (await tags.stat("library/ubuntu", "library/ubuntu:22.04")).size
            with pytest.raises(backend.BlobNotFoundError):
                await blobs.download("library/ubuntu", "0" * 64)
            with pytest.raises(backend.BlobNotFoundError):
                await tags.download("library/ubuntu", "library/ubuntu:nope")
            with pytest.raises(backend.BackendError, match="repo:tag"):
                await tags.download("library/ubuntu", "untagged")
            for c in (blobs, tags):
                with pytest.raises(backend.BackendError, match="read-only"):
                    await c.upload("library/ubuntu", d, b"x")
                with pytest.raises(backend.BackendError, match="list"):
                    await c.list("")
        finally:
            await blobs.close()
            await tags.close()
        assert out["blob"] == out["bare_hex"] == layer and out["size"] == len(layer)
        assert out["tag"] == digest_of(manifest).encode()
        out.update(log=up.log, token_fetches=up.token_fetches, cdn_auth=up.cdn_auth)
        return out


@pytest.mark.parametrize("flow", sorted(REGISTRY_FLOWS))
def test_registry_flows_send_the_references_requests(flow):
    ref = run(_registry(JAX, flow))
    port = run(_registry(PORT, flow))
    assert port == ref
    # One token a client and scope: the blob client's and the tag client's.
    assert port["token_fetches"] == (2 if flow != "open" else 0)
    if flow == "presigned":
        assert port["cdn_auth"] and port["cdn_auth"] == [None] * len(port["cdn_auth"])
    else:
        assert port["cdn_auth"] == []


async def _bad_credentials(pkg: str) -> str:
    backend, _, _ = PKG[pkg]
    async with LoggedRegistry(token_auth=True, username="puller", password="hunter2") as up:
        up.blobs["acme/app/sha256:" + "1" * 64] = b"x"
        bad = backend.base.make_backend("registry_blob", {
            "address": up.addr, "username": "puller", "password": "wrong"})
        nocreds = backend.base.make_backend("registry_blob", {"address": up.addr})
        try:
            with pytest.raises(backend.BackendError, match="credentials") as e:
                await bad.download("acme/app", "1" * 64)
            with pytest.raises(backend.BackendError, match="credentials"):
                await nocreds.download("acme/app", "1" * 64)
        finally:
            await bad.close()
            await nocreds.close()
        return str(e.value)


def test_registry_bad_credentials_surface_as_backend_errors():
    assert run(_bad_credentials(PORT)) == run(_bad_credentials(JAX))


async def _challenges(pkg: str) -> list:
    """Basic challenges, an unknown scheme and a realm-less bearer,
    answered by each package's auth session against a scripted server."""
    from urllib.parse import quote

    backend, httputil, _ = PKG[pkg]
    registry = port_registry if pkg == PORT else jax_registry
    answers = []

    async def v2(req):
        answers.append(req.headers.get("Authorization"))
        auth = req.headers.get("Authorization", "")
        if auth.startswith("Basic "):
            return web.Response(body=b"ok")
        return web.Response(status=401, headers={"WWW-Authenticate": req.query["c"]})

    app = web.Application()
    app.router.add_get("/v2/x", v2)
    runner = web.AppRunner(app)
    await runner.setup()
    site = web.TCPSite(runner, "127.0.0.1", 0)
    await site.start()
    addr = f"127.0.0.1:{site._server.sockets[0].getsockname()[1]}"
    http = httputil.HTTPClient(retries=0)
    out = []
    try:
        for creds, challenge in ((("u", "p"), 'Basic realm="r"'), (("", ""), 'Basic realm="r"'),
                                 (("u", "p"), "Digest x"), (("u", "p"), "Bearer service=s"),
                                 (("u", "p"), 'Bearer realm="http://10.0.0.1/t"')):
            session = registry._AuthSession(http, *creds)
            try:
                s, _h, b = await session.request("GET", f"http://{addr}/v2/x?c={quote(challenge)}",
                                                 scope="repository:x:pull")
                out.append((s, b, session._cached("repository:x:pull")))
            except backend.BackendError as e:
                out.append(str(e))
    finally:
        await http.close()
        await runner.cleanup()
    return out + answers


def test_registry_auth_answers_each_challenge_as_the_reference():
    port = run(_challenges(PORT))
    assert port == run(_challenges(JAX))
    assert port[0] == (200, b"ok", "Basic dTpw")
    assert "basic auth" in port[1] and "unsupported" in port[2]
    assert "without realm" in port[3] and "non-https" in port[4]


@pytest.mark.parametrize("realm", [
    "https://auth.docker.io/token", "http://127.0.0.1:5000/token", "http://localhost/t",
    "http://[::1]:80/t", "http://10.0.0.1/token", "ftp://127.0.0.1/t", "http://[::1/t", "",
    "HTTPS://Upper.example/t", "http://localhost.evil.com/t",
])
def test_realm_safe_for_credentials(realm):
    assert (port_registry._realm_safe_for_credentials(realm)
            == jax_registry._realm_safe_for_credentials(realm))


# -- http and shadow against testfs --------------------------------------------------


async def _http_and_shadow(pkg: str, server_pkg: str) -> tuple:
    backend, httputil, _ = PKG[pkg]
    testfs = PKG[server_pkg][2]
    async with testfs.TestFSServer() as primary, testfs.TestFSServer() as shadow:
        sh = backend.base.make_backend("shadow", {
            "primary": {"backend": "testfs", "config": {"addr": primary.addr}},
            "shadow": {"backend": "testfs", "config": {"addr": shadow.addr}}})
        http = backend.base.make_backend(
            "http", {"download_url": f"http://{primary.addr}/files/%s"})
        try:
            await sh.upload("ns", "both", b"written twice")
            shadow._files["only-shadow"] = b"from the shadow"
            got = (await sh.download("ns", "both"), await sh.download("ns", "only-shadow"),
                   (await sh.stat("ns", "both")).size, await sh.list(""))
            with pytest.raises(backend.BlobNotFoundError):
                await sh.download("ns", "neither")
            with pytest.raises(backend.BlobNotFoundError):
                await sh.stat("ns", "only-shadow")  # stat reads the primary alone
            got += (await http.download("ns", "both"), (await http.stat("ns", "both")).size)
            with pytest.raises(backend.BlobNotFoundError):
                await http.download("ns", "only-shadow")
            with pytest.raises(backend.BackendError, match="read-only"):
                await http.upload("ns", "x", b"x")
            with pytest.raises(backend.BackendError, match="list"):
                await http.list("")
        finally:
            await sh.close()
            await http.close()
        return got + (dict(primary._files), dict(shadow._files))


@pytest.mark.parametrize("server_pkg", [PORT, JAX])
def test_http_and_shadow_against_testfs(server_pkg):
    port = run(_http_and_shadow(PORT, server_pkg))
    assert port == run(_http_and_shadow(JAX, server_pkg))
    assert port[:4] == (b"written twice", b"from the shadow", 13, ["both"])
    assert port[-2]["both"] == port[-1]["both"] == b"written twice"


def test_the_manager_resolves_remote_backends_by_namespace():
    entries = [
        {"namespace": "s3/.*", "backend": "s3",
         "config": {"endpoint": "http://h:1", "bucket": "b"}},
        {"namespace": "library/.*", "backend": "registry_blob",
         "config": {"address": "h:2"}, "bandwidth": {"ingress_bps": 10}},
        {"namespace": "tags/.*", "backend": "registry_tag", "config": {"address": "h:2"}},
        {"namespace": "h/.*", "backend": "hdfs", "config": {"namenode": "http://h:3"}},
    ]

    async def kinds(backend):
        m = backend.Manager(entries)
        try:
            return [type(m.get_client(ns)).__name__ for ns in
                    ("s3/x", "library/ubuntu", "tags/a", "h/b")]
        finally:
            await m.close()

    got = run(kinds(port_backend))
    assert got == run(kinds(jax_backend))
    assert got == ["S3Backend", "_ThrottledClient", "RegistryTagBackend", "HDFSBackend"]


# -- the cold refresh and the pull-through, origin by origin -------------------------


async def _serve_origin(pkg: str, root: str, entries: list, hasher):
    """An origin of one package over a backend manager, hashing pieces of
    PIECE bytes with ``hasher``; returns (addr, generator, closer)."""
    if pkg == PORT:
        store = kt.CAStore(root)
        backends = port_backend.Manager(entries)
        gen = kt.Generator(store, hasher=hasher, piece_lengths=kt.PieceLengthConfig(((0, PIECE),)))
        server = port_server.OriginServer(store, gen, port_refresh.Refresher(store, backends, gen))
        runner, port = await http_lite.serve(server.make_app(), "127.0.0.1", 0)
    else:
        store = jax_store.CAStore(root)
        backends = jax_backend.Manager(entries)
        gen = jax_gen.Generator(store, hasher=hasher,
                                piece_lengths=jax_gen.PieceLengthConfig(((0, PIECE),)))
        server = jax_server.OriginServer(store, gen, jax_refresh.Refresher(store, backends, gen))
        runner = web.AppRunner(server.make_app())
        await runner.setup()
        site = web.TCPSite(runner, "127.0.0.1", 0)
        await site.start()
        port = site._server.sockets[0].getsockname()[1]

    async def close():
        await runner.cleanup()
        await backends.close()

    return f"127.0.0.1:{port}", gen, close


def _hasher(pkg: str):
    return kt.TorchPieceHasher(device="cpu") if pkg == PORT else jax_hasher.CPUPieceHasher()


async def _cold_refresh(pkg: str, tmp_path) -> tuple:
    blob = blob_of(5, 5 * PIECE + 321)
    d = kt.Digest.from_bytes(blob)
    async with LoggedS3() as s3:
        s3.objects[get_pather("sharded_docker_blob")("", d.hex)] = blob
        entries = [{"namespace": "s3/.*", "backend": "s3", "config": s3_config(s3)}]
        addr, gen, close = await _serve_origin(pkg, str(tmp_path / pkg), entries, _hasher(pkg))
        try:
            async with ClientSession() as http:
                async with http.get(f"http://{addr}/namespace/s3%2Fcold/blobs/{d.hex}/metainfo") as r:
                    assert r.status == 200, await r.text()
                    doc = await r.read()
                async with http.get(f"http://{addr}/namespace/s3%2Fcold/blobs/{d}") as r:
                    got = await r.read()
                async with http.get(f"http://{addr}/namespace/s3%2Fcold/blobs/{'0' * 64}") as r:
                    missing = r.status
        finally:
            await close()
        assert got == blob
        return gen.get_cached(d).serialize(), doc, missing, s3.log


def test_a_cold_refresh_from_s3_makes_the_references_metainfo(tmp_path):
    """Phase 19 (b) at a small size: the blob is only in S3, under the
    pather's key; one GET of the metainfo refreshes it (one GET of the
    object), and the port's metainfo, made through the kernels' plain
    versions, equals the reference's over hashlib."""
    port = run(_cold_refresh(PORT, tmp_path))
    ref = run(_cold_refresh(JAX, tmp_path))
    assert port == ref
    mi, doc, missing, log = port
    assert missing == 404
    key = "/bkt/" + get_pather("sharded_docker_blob")("", kt.MetaInfo.deserialize(mi).digest.hex)
    assert [(m, p) for m, p, q in log if p == key] == [("GET", key)]
    assert kt.MetaInfo.deserialize(mi).piece_hashes == kt.CPUPieceHasher().hash_pieces(
        blob_of(5, 5 * PIECE + 321), PIECE).tobytes()


async def _pull_through(pkg: str, tmp_path) -> tuple:
    config = blob_of(6, 700)
    layer = blob_of(7, 6 * PIECE + 5)
    async with LoggedRegistry(token_auth=True, redirect_blobs=True) as up:
        manifest = json.dumps({"schemaVersion": 2, "config": {"digest": digest_of(config)},
                               "layers": [{"digest": digest_of(layer)}]}).encode()
        for b in (config, layer, manifest):
            up.blobs[f"library/ubuntu/{digest_of(b)}"] = b
        up.manifests["library/ubuntu:22.04"] = manifest
        entries = [{"namespace": "library/.*", "backend": "registry_blob",
                    "config": {"address": up.addr}}]
        addr, gen, close = await _serve_origin(pkg, str(tmp_path / pkg), entries, _hasher(pkg))
        tags = PKG[pkg][0].base.make_backend("registry_tag", {"address": up.addr})
        got, metainfos = [], []
        try:
            tag = await tags.download("library/ubuntu", "library/ubuntu:22.04")
            async with ClientSession() as http:
                for b in (manifest, config, layer):
                    url = f"http://{addr}/namespace/library%2Fubuntu/blobs/{digest_of(b)}"
                    async with http.get(url) as r:
                        assert r.status == 200, await r.text()
                        got.append(await r.read())
                    metainfos.append(gen.get_cached(kt.Digest.from_bytes(b)).serialize())
        finally:
            await tags.close()
            await close()
        assert got == [manifest, config, layer] and tag == digest_of(manifest).encode()
        return metainfos, up.log, up.token_fetches, up.cdn_auth


def test_a_pull_through_makes_the_references_metainfo(tmp_path):
    """Phase 19 (c) at a small size: the tag resolves through
    ``registry_tag``, each blob of the image is fetched through
    ``registry_blob`` (a 401, one token, a 307 to the presigned URL with no
    Authorization on it), and the port's metainfo of each equals the
    reference's."""
    port = run(_pull_through(PORT, tmp_path))
    ref = run(_pull_through(JAX, tmp_path))
    assert port == ref
    metainfos, log, token_fetches, cdn_auth = port
    assert token_fetches == 2  # the tag client's, the origin's blob client's
    assert len(cdn_auth) == 3 and set(cdn_auth) == {None}
