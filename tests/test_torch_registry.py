"""The port's docker-v2 front door against the reference's.

- The 14 cases of ``tests/test_registry_conformance.py``, each run on both
  packages' ``RegistryServer`` over the same ``FakeTransferer`` (the
  reference's on ``aiohttp``, the port's on ``http_lite``): every request's
  status, v2 error code, ``Allow`` and ``Docker-Distribution-API-Version``
  must agree, beside the reference test's own assertions.
- ``tests/test_registry.py``'s nine flows on an in-process port cluster
  (tracker, origin, build-index, proxy, agent on the ``cpu`` hasher), with
  a client on the port's own ``http_lite``.
- Crossings: the reference test's client flows against a port proxy over a
  port origin; a port agent's registry resolving tags through a JAX
  build-index, and a JAX agent's through a port build-index.
- The agent transferer's export branch, for a store without the flat file.
"""

import asyncio
import json
import os
import pathlib
import random
import tempfile

import aiohttp
import numpy as np
import pytest
from aiohttp import web

import kraken_tpu.dockerregistry.errors as jax_errors
import kraken_tpu.dockerregistry.registry as jax_registry
import kraken_tpu.dockerregistry.transfer as jax_transfer
import kraken_tpu.utils.dedup as jax_dedup
import kraken_tpu.utils.httputil as jax_httputil
import kraken_tpu_torch.dockerregistry.errors as port_errors
import kraken_tpu_torch.dockerregistry.registry as port_registry
import kraken_tpu_torch.dockerregistry.transfer as port_transfer
import kraken_tpu_torch.utils.dedup as port_dedup
import kraken_tpu_torch.utils.httputil as port_httputil
from kraken_tpu.core.digest import Digest
from kraken_tpu_torch.core.digest import Digest as PortDigest
from kraken_tpu_torch.utils import http_lite
from test_registry_conformance import GOOD, FakeTransferer

PKG = {
    "jax": {"registry": jax_registry, "errors": jax_errors, "transfer": jax_transfer,
            "dedup": jax_dedup, "httputil": jax_httputil, "web": web},
    "port": {"registry": port_registry, "errors": port_errors, "transfer": port_transfer,
             "dedup": port_dedup, "httputil": port_httputil, "web": http_lite},
}
VERSION = "Docker-Distribution-API-Version"


class Rig:
    """One package's ``RegistryServer`` on its own HTTP stack, an aiohttp
    client, and the transcript of every answer: (method, path, status,
    v2 code, Allow, version header)."""

    def __init__(self, pkg: str, read_only=False, strict_accept=False):
        self.pkg = pkg
        self.transferer = FakeTransferer()
        self.server = PKG[pkg]["registry"].RegistryServer(
            self.transferer, read_only=read_only, strict_accept=strict_accept)
        self.transcript: list[tuple] = []

    async def __aenter__(self):
        app = self.server.make_app()
        if self.pkg == "port":
            self.runner, port = await http_lite.serve(app, "127.0.0.1", 0)
        else:
            self.runner = web.AppRunner(app)
            await self.runner.setup()
            site = web.TCPSite(self.runner, "127.0.0.1", 0)
            await site.start()
            port = self.runner.addresses[0][1]
        self.base = f"http://127.0.0.1:{port}"
        self.http = aiohttp.ClientSession()
        return self

    async def __aexit__(self, *exc):
        await self.http.close()
        await self.runner.cleanup()

    async def req(self, method, path, **kw) -> tuple[int, dict, bytes]:
        async with self.http.request(method, self.base + path, **kw) as r:
            body = await r.read()
            code = None
            if r.status >= 400 and method != "HEAD":
                code = json.loads(body)["errors"][0]["code"]
            self.transcript.append((method, path, r.status, code, r.headers.get("Allow"),
                                    r.headers.get(VERSION)))
            return r.status, dict(r.headers), body

    async def expect(self, method, path, code, status, **kw):
        got, headers, body = await self.req(method, path, **kw)
        assert got == status, (path, got, body)
        assert headers[VERSION] == "registry/2.0"
        doc = json.loads(body)
        assert list(doc) == ["errors"] and len(doc["errors"]) == 1
        err = doc["errors"][0]
        assert err["code"] == code, (path, err)
        assert err["message"]
        return err


# -- the 14 conformance cases, each written once against a Rig ---------------


async def case_api_version_check(pkg):
    async with Rig(pkg) as rig:
        status, headers, body = await rig.req("GET", "/v2/")
        assert status == 200 and headers[VERSION] == "registry/2.0"
        assert json.loads(body) == {}
        return rig.transcript


async def case_pull_flow_error_codes(pkg):
    async with Rig(pkg) as rig:
        e = await rig.expect("GET", "/v2/repo/manifests/nosuchtag", "MANIFEST_UNKNOWN", 404)
        assert e["detail"]["tag"] == "nosuchtag"
        await rig.expect("GET", f"/v2/repo/manifests/{GOOD}", "MANIFEST_UNKNOWN", 404)
        await rig.expect("GET", "/v2/repo/manifests/sha256:xyz", "DIGEST_INVALID", 400)
        await rig.expect("GET", f"/v2/repo/blobs/{GOOD}", "BLOB_UNKNOWN", 404)
        await rig.expect("GET", "/v2/repo/blobs/sha256:nothex", "DIGEST_INVALID", 400)
        data = b"[1, 2]"
        d = Digest.from_bytes(data)
        rig.transferer.blobs[str(d)] = data
        status, headers, _ = await rig.req("GET", f"/v2/repo/manifests/{d}")
        assert status == 200 and headers["Content-Type"].endswith("json")
        status, headers, _ = await rig.req("HEAD", f"/v2/repo/blobs/{GOOD}")
        assert status == 404 and headers[VERSION] == "registry/2.0"
        return rig.transcript


async def case_push_flow_error_codes(pkg):
    async with Rig(pkg) as rig:
        await rig.expect("PATCH", "/v2/repo/blobs/uploads/deadbeef", "BLOB_UPLOAD_UNKNOWN",
                         404, data=b"x")
        await rig.expect("PUT", f"/v2/repo/blobs/uploads/deadbeef?digest={GOOD}",
                         "BLOB_UPLOAD_UNKNOWN", 404)
        await rig.expect("GET", "/v2/repo/blobs/uploads/deadbeef", "BLOB_UPLOAD_UNKNOWN", 404)

        async def start_upload():
            status, headers, _ = await rig.req("POST", "/v2/repo/blobs/uploads/")
            assert status == 202 and headers["Docker-Upload-UUID"]
            return headers["Location"]

        loc = await start_upload()
        status, _, _ = await rig.req("PATCH", loc, data=b"12345")
        assert status == 202
        status, headers, _ = await rig.req("GET", loc)
        assert status == 204 and headers["Range"] == "0-4"
        loc = await start_upload()
        await rig.expect("PUT", loc, "DIGEST_INVALID", 400, data=b"data")
        loc = await start_upload()
        e = await rig.expect("PUT", f"{loc}?digest={GOOD}", "DIGEST_INVALID", 400, data=b"data")
        assert e["detail"]["computed"] == str(Digest.from_bytes(b"data"))
        await rig.expect("PUT", "/v2/repo/manifests/tag", "MANIFEST_INVALID", 400,
                         data=b"\x00not json")
        await rig.expect("PUT", f"/v2/repo/manifests/{GOOD}", "DIGEST_INVALID", 400, data=b"{}")
        # Upload ids are random: keep them out of the transcript.
        return [t if "/uploads/" not in t[1] or "deadbeef" in t[1] else t[:1] + t[2:]
                for t in rig.transcript]


async def case_mount_flow_falls_back_to_upload_session(pkg):
    async with Rig(pkg) as rig:
        status, headers, _ = await rig.req(
            "POST", f"/v2/repo/blobs/uploads/?mount={GOOD}&from=other")
        assert status == 202 and headers["Docker-Upload-UUID"]
        assert "/blobs/uploads/" in headers["Location"]
        data = np.random.default_rng(3).bytes(64)
        d = Digest.from_bytes(data)
        rig.transferer.blobs[str(d)] = data
        status, headers, _ = await rig.req("POST", f"/v2/repo/blobs/uploads/?mount={d}&from=other")
        assert status == 201 and headers["Docker-Content-Digest"] == str(d)
        return rig.transcript


async def case_resume_flow_expired_session(pkg):
    async with Rig(pkg) as rig:
        _, headers, _ = await rig.req("POST", "/v2/repo/blobs/uploads/")
        uid = headers["Docker-Upload-UUID"]
        rig.server._uploads[uid] -= 10_000
        rig.server._purge_stale_uploads()
        await rig.expect("PATCH", f"/v2/repo/blobs/uploads/{uid}", "BLOB_UPLOAD_UNKNOWN", 404,
                         data=b"more")
        return [t[:1] + t[2:] for t in rig.transcript]


async def case_read_only_and_unsupported_methods(pkg):
    out = []
    async with Rig(pkg, read_only=True) as rig:
        await rig.expect("POST", "/v2/repo/blobs/uploads/", "UNSUPPORTED", 405)
        await rig.expect("PUT", "/v2/repo/manifests/tag", "UNSUPPORTED", 405, data=b"{}")
        # The router's own errors, enveloped by the middleware.
        await rig.expect("DELETE", "/v2/repo/blobs/uploads/", "UNSUPPORTED", 405)
        await rig.expect("GET", "/v2/repo/nothing", "UNSUPPORTED", 404)
        out += rig.transcript
    async with Rig(pkg) as rig:
        await rig.expect("DELETE", "/v2/repo/manifests/tag", "UNSUPPORTED", 405)
        await rig.expect("DELETE", f"/v2/repo/blobs/{GOOD}", "UNSUPPORTED", 405)
        out += rig.transcript
    return out


async def case_name_and_pagination_codes(pkg):
    async with Rig(pkg) as rig:
        await rig.expect("GET", f"/v2/UPPER/blobs/{GOOD}", "NAME_INVALID", 400)
        await rig.expect("GET", "/v2/bad..name/manifests/tag", "NAME_INVALID", 400)
        await rig.expect("GET", f"/v2/repo%20x/blobs/{GOOD}", "NAME_INVALID", 400)
        with pytest.raises(PKG[pkg]["web"].HTTPBadRequest):
            PKG[pkg]["errors"].check_repo_name("repo\n")
        await rig.expect("GET", "/v2/norepo/tags/list", "NAME_UNKNOWN", 404)

        async def boom(repo):
            raise RuntimeError("backend down")

        rig.transferer.list_repo_tags = boom
        await rig.expect("GET", "/v2/repo/tags/list", "UNKNOWN", 500)
        del rig.transferer.list_repo_tags
        rig.transferer.tags["repo:v1"] = Digest.from_bytes(b"m")
        await rig.expect("GET", "/v2/repo/tags/list?n=0", "PAGINATION_NUMBER_INVALID", 400)
        await rig.expect("GET", "/v2/repo/tags/list?n=x", "PAGINATION_NUMBER_INVALID", 400)
        status, _, body = await rig.req("GET", "/v2/repo/tags/list")
        assert status == 200 and json.loads(body) == {"name": "repo", "tags": ["v1"]}
        return rig.transcript


async def case_transient_dependency_failures_are_retryable_5xx(pkg):
    HTTPError = PKG[pkg]["httputil"].HTTPError
    async with Rig(pkg) as rig:
        async def down(*a, **kw):
            raise HTTPError("GET", "http://origin/blob", 503)

        rig.transferer.stat = down
        rig.transferer.download_path = down
        status, headers, _ = await rig.req("HEAD", f"/v2/repo/blobs/{GOOD}")
        assert status == 502 and headers[VERSION] == "registry/2.0"
        await rig.expect("GET", f"/v2/repo/blobs/{GOOD}", "UNKNOWN", 502)
        rig.transferer.get_tag = down
        await rig.expect("GET", "/v2/repo/manifests/v1", "UNKNOWN", 502)
        del rig.transferer.get_tag
        rig.transferer.tags["repo:v1"] = Digest.from_bytes(b"m")
        rig.transferer.download = down
        await rig.expect("GET", "/v2/repo/manifests/v1", "UNKNOWN", 502)

        async def gone(*a, **kw):
            raise HTTPError("GET", "http://origin/blob", 404)

        rig.transferer.download_path = gone
        await rig.expect("GET", f"/v2/repo/blobs/{GOOD}", "BLOB_UNKNOWN", 404)
        return rig.transcript


async def case_unhandled_exception_still_enveloped(pkg):
    async with Rig(pkg) as rig:
        async def boom(*a, **kw):
            raise RuntimeError("wire tripped")

        rig.transferer.upload = boom
        await rig.expect("PUT", "/v2/repo/manifests/v1", "UNKNOWN", 500,
                         data=json.dumps({"mediaType": "x"}).encode())
        return rig.transcript


async def case_transferer_get_tag_classifies_dependency_errors(pkg):
    mods = PKG[pkg]
    HTTPError = mods["httputil"].HTTPError

    class Tags:
        def __init__(self, exc):
            self.exc = exc

        async def get(self, tag):
            raise self.exc

    out = []
    for cls in (mods["transfer"].ReadOnlyTransferer, mods["transfer"].ProxyTransferer):
        t = cls.__new__(cls)  # seam test: only the tag path is touched
        t._tag_cache = mods["dedup"].TTLCache(0)
        t.tags = Tags(HTTPError("GET", "http://bi/tags/x", 404))
        out.append(await t.get_tag("repo:v1"))
        t.tags = Tags(HTTPError("GET", "http://bi/tags/x", 503))
        with pytest.raises(HTTPError):
            await t.get_tag("repo:v1")
    assert out == [None, None]
    return out


async def case_error_envelope_on_randomized_garbage(pkg):
    rng = random.Random(7)
    verbs = ["GET", "PUT", "POST", "PATCH", "DELETE", "HEAD"]
    segments = ["repo", "UPPER", "re..po", "%2e%2e", "sha256:zz", GOOD, "v1", "deadbeef", "",
                "a" * 300]
    templates = ["/v2/{0}/manifests/{1}", "/v2/{0}/blobs/{1}", "/v2/{0}/blobs/uploads/",
                 "/v2/{0}/blobs/uploads/{1}", "/v2/{0}/tags/list?n={1}", "/v2/_catalog?last={0}"]
    async with Rig(pkg) as rig:
        for _ in range(80):
            path = rng.choice(templates).format(rng.choice(segments), rng.choice(segments))
            method = rng.choice(verbs)
            body = rng.choice([b"", b"x", b"{}", b"\xff" * 64])
            status, headers, _ = await rig.req(method, path, data=body)
            if status >= 400:
                assert headers.get(VERSION) == "registry/2.0", (method, path, status)
        # An upload session's Location names a random id: keep the codes.
        return [t[:1] + t[2:] if t[0] == "POST" else t for t in rig.transcript]


DOCKER2 = "application/vnd.docker.distribution.manifest.v2+json"
OCI = "application/vnd.oci.image.manifest.v1+json"
LIST = "application/vnd.docker.distribution.manifest.list.v2+json"
OCI_INDEX = "application/vnd.oci.image.index.v1+json"


async def case_manifest_accept_negotiation(pkg):
    async with Rig(pkg, strict_accept=True) as rig:
        stored = {}
        for tag, media in (("docker2", DOCKER2), ("oci", OCI), ("list", LIST)):
            body = json.dumps({"mediaType": media, "t": tag}).encode()
            d = Digest.from_bytes(body)
            rig.transferer.blobs[str(d)] = body
            rig.transferer.tags[f"repo:{tag}"] = d
            stored[tag] = media

        async def get(tag, accept, expect_status):
            headers = {"Accept": accept} if accept is not None else {}
            status, got, body = await rig.req("GET", f"/v2/repo/manifests/{tag}",
                                              headers=headers)
            assert status == expect_status, (tag, accept, status, body)
            return got

        for tag, media in stored.items():
            assert (await get(tag, media, 200))["Content-Type"] == media
            await get(tag, "*/*", 200)
            await get(tag, "application/*", 200)
            await get(tag, None, 200)
            await get(tag, f"{OCI_INDEX}, {media};q=0.9", 200)
        err = await rig.expect("GET", "/v2/repo/manifests/docker2", "MANIFEST_NOT_ACCEPTABLE",
                               406, headers={"Accept": OCI})
        assert err["detail"]["stored"] == DOCKER2
        await rig.expect("GET", "/v2/repo/manifests/oci", "MANIFEST_NOT_ACCEPTABLE", 406,
                         headers={"Accept": f"{DOCKER2}, {LIST}"})
        await rig.expect("GET", "/v2/repo/manifests/list", "MANIFEST_NOT_ACCEPTABLE", 406,
                         headers={"Accept": OCI})
        # Docker's types as separate header lines: each one is read.
        status, _, _ = await rig.req("GET", "/v2/repo/manifests/list",
                                     headers=[("Accept", OCI), ("Accept", LIST)])
        assert status == 200
        status, _, _ = await rig.req("HEAD", "/v2/repo/manifests/docker2",
                                     headers={"Accept": OCI})
        assert status == 406
        return rig.transcript


async def case_manifest_accept_lenient_by_default(pkg):
    async with Rig(pkg) as rig:
        body = json.dumps({"mediaType": DOCKER2, "t": "x"}).encode()
        d = Digest.from_bytes(body)
        rig.transferer.blobs[str(d)] = body
        rig.transferer.tags["repo:docker2"] = d
        status, headers, got = await rig.req("GET", "/v2/repo/manifests/docker2",
                                             headers={"Accept": OCI})
        assert status == 200 and headers["Content-Type"] == DOCKER2 and got == body
        return rig.transcript


async def case_manifest_without_media_type_never_406s(pkg):
    async with Rig(pkg) as rig:
        body = json.dumps({"schemaVersion": 2, "config": {}}).encode()
        d = Digest.from_bytes(body)
        rig.transferer.blobs[str(d)] = body
        rig.transferer.tags["repo:untyped"] = d
        status, _, _ = await rig.req("GET", "/v2/repo/manifests/untyped", headers={"Accept": OCI})
        assert status == 200
        return rig.transcript


CASES = [case_api_version_check, case_pull_flow_error_codes, case_push_flow_error_codes,
         case_mount_flow_falls_back_to_upload_session, case_resume_flow_expired_session,
         case_read_only_and_unsupported_methods, case_name_and_pagination_codes,
         case_transient_dependency_failures_are_retryable_5xx,
         case_unhandled_exception_still_enveloped,
         case_transferer_get_tag_classifies_dependency_errors,
         case_error_envelope_on_randomized_garbage, case_manifest_accept_negotiation,
         case_manifest_accept_lenient_by_default, case_manifest_without_media_type_never_406s]


def test_the_cases_are_the_conformance_files():
    import test_registry_conformance as conformance

    names = sorted(n[len("test_"):] for n in dir(conformance) if n.startswith("test_"))
    assert sorted(c.__name__[len("case_"):] for c in CASES) == names


@pytest.mark.parametrize("pkg", ["jax", "port"])
@pytest.mark.parametrize("case", CASES, ids=[c.__name__[len("case_"):] for c in CASES])
def test_conformance_case_on_both_packages(case, pkg):
    """The case's assertions hold on ``pkg``; on the port, every answer
    also equals the reference's: status, v2 code, Allow, version."""
    got = asyncio.run(case(pkg))
    if pkg == "port":
        assert got == asyncio.run(case("jax"))


# -- the nine flows on an in-process port cluster ------------------------------


def make_image(nlayers=2, layer_size=50_000, seed=0):
    """A synthetic docker image: config blob + layers + schema2 manifest."""
    rng = np.random.default_rng(seed)
    layers = [rng.bytes(layer_size) for _ in range(nlayers)]
    config = json.dumps({"architecture": "amd64", "os": "linux", "seed": seed}).encode()
    manifest = json.dumps({
        "schemaVersion": 2, "mediaType": DOCKER2,
        "config": {"mediaType": "application/vnd.docker.container.image.v1+json",
                   "size": len(config), "digest": str(Digest.from_bytes(config))},
        "layers": [{"mediaType": "application/vnd.docker.image.rootfs.diff.tar.gzip",
                    "size": len(b), "digest": str(Digest.from_bytes(b))} for b in layers],
    }).encode()
    return config, layers, manifest


async def push_image(session, registry, repo, tag, config, layers, manifest,
                     chunk=1 << 16):
    """``docker push`` on ``http_lite``: per blob POST, PATCH bodies, PUT
    ``?digest=``; then the manifest by tag."""
    base = f"http://{registry}"
    for blob in [config, *layers]:
        d = Digest.from_bytes(blob)
        async with session.request("POST", f"{base}/v2/{repo}/blobs/uploads/") as r:
            assert r.status == 202, await r.text()
            loc = r.headers["Location"]
        for off in range(0, len(blob), chunk):
            async with session.request("PATCH", base + loc, data=blob[off:off + chunk]) as r:
                assert r.status == 202, await r.text()
                assert r.headers["Range"] == f"0-{min(off + chunk, len(blob)) - 1}"
        async with session.request("PUT", f"{base}{loc}?digest={d}") as r:
            assert r.status == 201, await r.text()
    async with session.request("PUT", f"{base}/v2/{repo}/manifests/{tag}", data=manifest,
                               headers={"Content-Type": DOCKER2}) as r:
        assert r.status == 201, await r.text()
        return r.headers["Docker-Content-Digest"]


async def pull_image(session, registry, repo, tag):
    """``docker pull`` on ``http_lite``: the manifest by tag with docker's
    Accept lines, then every blob, each checked against its digest."""
    base = f"http://{registry}"
    accept = [("Accept", DOCKER2), ("Accept", LIST), ("Accept", OCI)]
    async with session.request("GET", f"{base}/v2/{repo}/manifests/{tag}", headers=accept) as r:
        assert r.status == 200, await r.text()
        manifest = await r.read()
    doc = json.loads(manifest)
    blobs = {}
    for ref in [doc["config"], *doc["layers"]]:
        async with session.request("GET", f"{base}/v2/{repo}/blobs/{ref['digest']}") as r:
            assert r.status == 200, await r.text()
            data = await r.read()
        assert str(Digest.from_bytes(data)) == ref["digest"]
        blobs[ref["digest"]] = data
    return manifest, blobs


async def build_cluster(tmp_path, name, remotes=None, bindex_pkg="port", agent_pkg="port"):
    """Port tracker + origin + proxy, and a build-index and an agent of
    either package, fully wired."""
    from kraken_tpu_torch import assembly as port_asm
    from kraken_tpu_torch.origin.client import ClusterClient
    from kraken_tpu_torch.placement import HostList, Ring

    tracker = port_asm.TrackerNode(announce_interval_seconds=0.1)
    await tracker.start()
    origin = port_asm.OriginNode(store_root=str(tmp_path / name / "origin"),
                                 tracker_addr=tracker.addr, hasher="cpu")
    await origin.start()
    cluster = ClusterClient(Ring(HostList(static=[origin.addr]), max_replica=1))
    tracker.server.origin_cluster = cluster
    c = {"tracker": tracker, "origin": origin, "cluster": cluster, "closers": []}
    if bindex_pkg == "port":
        bindex = port_asm.BuildIndexNode(store_root=str(tmp_path / name / "bindex"),
                                         remotes=remotes, origin_cluster=cluster)
    else:
        from kraken_tpu.assembly import BuildIndexNode
        from kraken_tpu.origin.client import ClusterClient as JaxClusterClient
        from kraken_tpu.placement import HostList as JaxHostList, Ring as JaxRing

        jax_cluster = JaxClusterClient(JaxRing(JaxHostList(static=[origin.addr]), max_replica=1))
        c["closers"].append(jax_cluster.close)
        bindex = BuildIndexNode(store_root=str(tmp_path / name / "bindex"), remotes=remotes,
                                origin_cluster=jax_cluster)
    await bindex.start()
    proxy = port_asm.ProxyNode(origin_cluster=cluster, build_index_addr=bindex.addr)
    await proxy.start()
    if agent_pkg == "port":
        agent = port_asm.AgentNode(store_root=str(tmp_path / name / "agent"),
                                   tracker_addr=tracker.addr, build_index_addr=bindex.addr,
                                   hasher="cpu")
    else:
        from kraken_tpu.assembly import AgentNode

        agent = AgentNode(store_root=str(tmp_path / name / "agent"), tracker_addr=tracker.addr,
                          build_index_addr=bindex.addr)
    await agent.start()
    c.update(bindex=bindex, proxy=proxy, agent=agent)
    return c


async def stop_cluster(c):
    for key in ("agent", "proxy", "bindex", "origin", "tracker"):
        await c[key].stop()
    await c["cluster"].close()
    for close in c["closers"]:
        await close()


def run_cluster(tmp_path, body, **kw):
    async def main():
        c = await build_cluster(tmp_path, "c1", **kw)
        session = http_lite.ClientSession()
        try:
            return await body(c, session)
        finally:
            await session.close()
            await stop_cluster(c)

    return asyncio.run(main())


def test_docker_push_pull_roundtrip(tmp_path):
    config, layers, manifest = make_image()

    async def body(c, s):
        await push_image(s, c["proxy"].addr, "library/app", "v1", config, layers, manifest)
        got_manifest, got_blobs = await pull_image(s, c["agent"].registry_addr,
                                                   "library/app", "v1")
        async with s.request("GET", f"http://{c['proxy'].addr}/v2/library/app/tags/list") as r:
            tags = await r.json()
        async with s.request("GET", f"http://{c['proxy'].addr}/v2/_catalog") as r:
            catalog = await r.json()
        return got_manifest, got_blobs, tags, catalog

    got_manifest, got_blobs, tags, catalog = run_cluster(tmp_path, body)
    assert got_manifest == manifest
    assert got_blobs[str(Digest.from_bytes(config))] == config
    for layer in layers:
        assert got_blobs[str(Digest.from_bytes(layer))] == layer
    assert tags == {"name": "library/app", "tags": ["v1"]}
    assert catalog == {"repositories": ["library/app"]}


def test_agent_registry_is_read_only(tmp_path):
    async def body(c, s):
        url = f"http://{c['agent'].registry_addr}"
        out = []
        for method, path, data in (("POST", "/v2/x/blobs/uploads/", None),
                                   ("PUT", "/v2/x/manifests/latest", b"{}")):
            async with s.request(method, url + path, data=data) as r:
                out.append((r.status, (await r.json())["errors"][0]["code"]))
        return out

    assert run_cluster(tmp_path, body) == [(405, "UNSUPPORTED"), (405, "UNSUPPORTED")]


def test_cross_cluster_tag_replication(tmp_path):
    config, layers, manifest = make_image(nlayers=1)

    async def main():
        c2 = await build_cluster(tmp_path, "c2")
        c1 = await build_cluster(tmp_path, "c1", remotes=[c2["bindex"].addr])
        s = http_lite.ClientSession()
        try:
            await push_image(s, c1["proxy"].addr, "library/app", "v1", config, layers, manifest)
            for _ in range(100):
                await c1["bindex"].retry.run_once()
                async with s.request(
                        "GET", f"http://{c2['bindex'].addr}/tags/library%2Fapp%3Av1") as r:
                    if r.status == 200:
                        return await r.text()
                await asyncio.sleep(0.05)
            return None
        finally:
            await s.close()
            await stop_cluster(c1)
            await stop_cluster(c2)

    assert asyncio.run(main()) == str(Digest.from_bytes(manifest))


def test_tags_list_pagination(tmp_path):
    config, layers, manifest = make_image(nlayers=1)

    async def body(c, s):
        for tag in ["v1", "v2", "v3", "v4", "v5"]:
            await push_image(s, c["proxy"].addr, "library/app", tag, config, layers, manifest)
        url = f"http://{c['proxy'].addr}/v2/library/app/tags/list"
        out = []
        for q in ("?n=2", "?n=2&last=v2", "?n=2&last=v4", "?n=bogus", "?n=0"):
            async with s.request("GET", url + q) as r:
                doc = await r.json()
                out.append((r.status, doc.get("tags"), r.headers.get("Link")))
        return out

    out = run_cluster(tmp_path, body)
    assert out[0][:2] == (200, ["v1", "v2"]) and "last=v2" in out[0][2]
    assert out[1][:2] == (200, ["v3", "v4"])
    assert out[2] == (200, ["v5"], None)
    assert out[3][0] == 400 and out[4][0] == 400


def test_blob_get_range_resume(tmp_path):
    """Both registry flavors: the agent's ``FileResponse`` and the proxy's
    spooled-temp streaming branch."""
    config, layers, manifest = make_image(nlayers=1, layer_size=300_000)
    layer = layers[0]
    d = str(Digest.from_bytes(layer))

    async def body(c, s):
        await push_image(s, c["proxy"].addr, "library/app", "v1", config, layers, manifest)
        out = {}
        for name, registry in (("proxy", c["proxy"].addr), ("agent", c["agent"].registry_addr)):
            url = f"http://{registry}/v2/library/app/blobs/{d}"
            for rng in (None, "bytes=100000-", "bytes=1000-1999", "bytes=100000-999999999",
                        f"bytes={len(layer)}-"):
                headers = {"Range": rng} if rng else None
                async with s.request("GET", url, headers=headers) as r:
                    out[name, rng] = (r.status, await r.read(), r.headers.get("Content-Range"))
            async with s.request("HEAD", url) as r:
                out[name, "HEAD"] = (r.status, r.headers["Content-Length"])
        return out

    out = run_cluster(tmp_path, body)
    for name in ("proxy", "agent"):
        assert out[name, None][:2] == (200, layer)
        assert out[name, "bytes=100000-"] == (206, layer[100000:],
                                              f"bytes 100000-{len(layer) - 1}/{len(layer)}")
        assert out[name, "bytes=1000-1999"][:2] == (206, layer[1000:2000])
        assert out[name, "bytes=100000-999999999"][:2] == (206, layer[100000:])
        assert out[name, f"bytes={len(layer)}-"][0] == 416
        assert out[name, "HEAD"] == (200, str(len(layer)))


def test_cross_repo_blob_mount(tmp_path):
    from kraken_tpu_torch.store.metadata import NamespaceMetadata

    config, layers, manifest = make_image(nlayers=1)
    d = str(Digest.from_bytes(layers[0]))
    missing = "sha256:" + "0" * 64

    async def body(c, s):
        await push_image(s, c["proxy"].addr, "library/app", "v1", config, layers, manifest)
        base = f"http://{c['proxy'].addr}/v2/library/other"
        async with s.request("POST", f"{base}/blobs/uploads/?mount={d}&from=library/app") as r:
            mounted = (r.status, r.headers["Docker-Content-Digest"], r.headers["Location"])
        async with s.request("GET", f"{base}/blobs/{d}") as r:
            got = await r.read()
        md = c["origin"].store.get_metadata(PortDigest.parse(d), NamespaceMetadata)
        async with s.request("POST",
                             f"{base}/blobs/uploads/?mount={missing}&from=library/app") as r:
            fallback = (r.status, "Docker-Upload-UUID" in r.headers)
        return mounted, got, md, fallback

    mounted, got, md, fallback = run_cluster(tmp_path, body)
    assert mounted[:2] == (201, d) and mounted[2].endswith(f"/blobs/{d}")
    assert got == layers[0]
    assert md is not None and md.namespace == "library/other"
    assert fallback == (202, True)


def test_mount_second_writeback_keeps_pin_until_both_land(tmp_path):
    from kraken_tpu_torch.assembly import OriginNode, TrackerNode
    from kraken_tpu_torch.backend import Manager as BackendManager
    from kraken_tpu_torch.backend.base import make_backend
    from kraken_tpu_torch.origin.client import ClusterClient
    from kraken_tpu_torch.origin.writeback import KIND
    from kraken_tpu_torch.placement import HostList, Ring
    from kraken_tpu_torch.store.metadata import PersistMetadata

    async def main():
        backends = BackendManager([{"namespace": ".*", "backend": "file",
                                    "config": {"root": str(tmp_path / "remote")}}])
        tracker = TrackerNode(announce_interval_seconds=0.1)
        await tracker.start()
        origin = OriginNode(store_root=str(tmp_path / "origin"), tracker_addr=tracker.addr,
                            backends=backends, hasher="cpu")
        await origin.start()
        cluster = ClusterClient(Ring(HostList(static=[origin.addr]), max_replica=1))
        try:
            blob = np.random.default_rng(5).bytes(100_000)
            d = PortDigest.from_bytes(blob)
            await cluster.upload("ns-a", d, blob)
            assert await cluster.adopt("ns-b", d, "ns-a")
            assert origin.retry.store.count_pending(KIND, f"{d.hex}:") == 2
            await origin.retry.run_once()
            md = origin.store.get_metadata(d, PersistMetadata)
            if origin.retry.store.count_pending(KIND, f"{d.hex}:"):
                assert md is not None and KIND in md.reasons
                await origin.retry.run_once()
            md = origin.store.get_metadata(d, PersistMetadata)
            assert md is None or KIND not in md.reasons
            be = make_backend("file", {"root": str(tmp_path / "remote")})
            return [await be.download(ns, d.hex) for ns in ("ns-a", "ns-b")], blob
        finally:
            await cluster.close()
            await origin.stop()
            await tracker.stop()

    got, blob = asyncio.run(main())
    assert got == [blob, blob]


def test_immutable_tags(tmp_path):
    from kraken_tpu_torch.assembly import BuildIndexNode, OriginNode, ProxyNode
    from kraken_tpu_torch.buildindex.server import TagClient
    from kraken_tpu_torch.origin.client import ClusterClient
    from kraken_tpu_torch.placement import HostList, Ring

    async def main():
        origin = OriginNode(store_root=str(tmp_path / "o"), dedup=False, hasher="cpu")
        await origin.start()
        cluster = ClusterClient(Ring(HostList(static=[origin.addr]), max_replica=1))
        bindex = BuildIndexNode(store_root=str(tmp_path / "bi"), origin_cluster=cluster,
                                immutable_tags=True)
        await bindex.start()
        proxy = ProxyNode(origin_cluster=cluster, build_index_addr=bindex.addr)
        await proxy.start()
        http = port_httputil.HTTPClient()
        tags = TagClient(bindex.addr)
        try:
            d1 = PortDigest.from_bytes(b"manifest-one")
            d2 = PortDigest.from_bytes(b"manifest-two")
            await tags.put("repo:v1", d1)
            await tags.put("repo:v1", d1)
            with pytest.raises(port_httputil.HTTPError) as e:
                await tags.put("repo:v1", d2)
            assert e.value.status == 409
            assert await tags.get("repo:v1") == d1
            m1 = json.dumps({"mediaType": "x", "n": 1}).encode()
            m2 = json.dumps({"mediaType": "x", "n": 2}).encode()
            url = f"http://{proxy.addr}/v2/repo/manifests/v2"
            first, _h, _b = await http.request_full("PUT", url, data=m1, ok_statuses=(201,))
            denied, _h, body = await http.request_full("PUT", url, data=m2, ok_statuses=(403,),
                                                       retry_5xx=False)
            again, _h, _b = await http.request_full("PUT", url, data=m1, ok_statuses=(201,))
            return first, denied, json.loads(body)["errors"][0]["code"], again
        finally:
            await tags.close()
            await http.close()
            await proxy.stop()
            await bindex.stop()
            await origin.stop()
            await cluster.close()

    assert asyncio.run(main()) == (201, 403, "DENIED", 201)


def test_immutable_tags_fail_closed_on_backend_outage(tmp_path):
    from kraken_tpu_torch.backend import BackendError, BlobNotFoundError
    from kraken_tpu_torch.buildindex.server import TagServer
    from kraken_tpu_torch.buildindex.tagstore import TagStore

    class FakeClient:
        mode = "outage"

        async def download(self, ns, name):
            if self.mode == "outage":
                raise BackendError("backend down")
            raise BlobNotFoundError(name)

    class FakeBackends:
        client = FakeClient()

        def try_get_client(self, ns):
            return self.client

    async def main():
        backends = FakeBackends()
        store = TagStore(str(tmp_path / "tags"), backends=backends)
        srv = TagServer(store, immutable=True)
        d = PortDigest.from_bytes(b"m1")
        with pytest.raises(http_lite.HTTPServiceUnavailable):
            await srv._checked_put("repo:v1", d)
        assert store.get_local("repo:v1") is None
        backends.client.mode = "absent"
        await srv._checked_put("repo:v1", d)
        assert store.get_local("repo:v1") == d

    asyncio.run(main())


# -- crossings -----------------------------------------------------------------


def test_the_references_client_flows_against_a_port_proxy_and_agent(tmp_path):
    """``tests/test_registry.py``'s own push and pull helpers (the JAX
    ``HTTPClient`` on ``aiohttp``) against a port proxy over a port origin,
    and a port agent's registry."""
    import test_registry

    config, layers, manifest = test_registry.make_image(nlayers=2)

    async def main():
        c = await build_cluster(tmp_path, "x")
        http = jax_httputil.HTTPClient()
        try:
            await test_registry.push_image(http, c["proxy"].addr, "library/app", "v1",
                                           config, layers, manifest)
            return await test_registry.pull_image(http, c["agent"].registry_addr,
                                                  "library/app", "v1")
        finally:
            await http.close()
            await stop_cluster(c)

    got_manifest, got_blobs = asyncio.run(main())
    assert got_manifest == manifest
    assert set(got_blobs.values()) == {config, *layers}


@pytest.mark.parametrize("bindex_pkg,agent_pkg", [("jax", "port"), ("port", "jax")],
                         ids=["port-agent-jax-build-index", "jax-agent-port-build-index"])
def test_an_agent_resolves_tags_through_the_other_packages_build_index(tmp_path, bindex_pkg,
                                                                       agent_pkg):
    config, layers, manifest = make_image(nlayers=2, seed=9)

    async def body(c, s):
        digest = await push_image(s, c["proxy"].addr, "library/app", "v1", config, layers,
                                  manifest)
        got = await pull_image(s, c["agent"].registry_addr, "library/app", "v1")
        async with s.request("GET", f"http://{c['bindex'].addr}/tags/library%2Fapp%3Av1") as r:
            tag = await r.text()
        return digest, got, tag

    digest, (got_manifest, got_blobs), tag = run_cluster(tmp_path, body, bindex_pkg=bindex_pkg,
                                                         agent_pkg=agent_pkg)
    assert got_manifest == manifest and tag == digest == str(Digest.from_bytes(manifest))
    assert set(got_blobs.values()) == {config, *layers}


# -- the agent's export branch -------------------------------------------------


def test_the_agents_download_path_exports_a_blob_without_its_flat_file(tmp_path):
    """``ReadOnlyTransferer.download_path`` hands out the cache file; for a
    store whose blob has no flat file (the chunk tier, ROADMAP A7f) it
    exports a temp copy, which the registry serves by range and unlinks."""
    from kraken_tpu_torch.store import CAStore

    blob = np.random.default_rng(8).bytes(200_000)
    d = PortDigest.from_bytes(blob)

    class Store(CAStore):
        flat = True

        def cache_path(self, dd):
            path = super().cache_path(dd)
            return path if self.flat else path + ".not-flat"

        def in_cache(self, dd):
            return os.path.exists(CAStore.cache_path(self, dd))

        def export_to_file(self, dd, dst):
            self.flat = True
            try:
                super().export_to_file(dd, dst)
            finally:
                self.flat = False

    store = Store(str(tmp_path / "s"))
    uid = store.create_upload()
    store.write_upload_chunk(uid, 0, blob)
    store.commit_upload(uid, d)

    class NoPulls:
        async def download(self, namespace, dd):
            raise AssertionError("the blob is in the store")

    t = port_transfer.ReadOnlyTransferer(store, NoPulls(), tags=None)

    async def main():
        assert await t.download_path("ns", d) == (store.cache_path(d), False)
        store.flat = False
        path, is_temp = await t.download_path("ns", d)
        exported = await asyncio.to_thread(pathlib.Path(path).read_bytes)
        os.unlink(path)
        server = port_registry.RegistryServer(t, read_only=True)
        runner, port = await http_lite.serve(server.make_app(), "127.0.0.1", 0)
        try:
            async with aiohttp.ClientSession() as s:
                async with s.get(f"http://127.0.0.1:{port}/v2/ns/blobs/{d}",
                                 headers={"Range": "bytes=1000-"}) as r:
                    ranged = (r.status, await r.read())
        finally:
            await runner.cleanup()
        return is_temp, exported, ranged

    before = set(os.listdir(tempfile.gettempdir()))
    is_temp, exported, ranged = asyncio.run(main())
    assert is_temp and exported == blob
    assert ranged == (206, blob[1000:])
    leftover = {n for n in set(os.listdir(tempfile.gettempdir())) - before
                if n.startswith("kraken-registry-")}
    assert leftover == set()
