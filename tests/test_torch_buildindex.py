"""The port's build-index against the reference's: each package's
``TagStore`` reads the other's tags on disk and through a ``file``
backend; each ``TagClient`` talks to each ``TagServer``; a tag replicates
from either package's build-index to the other's through
``persistedretry``; ``DependencyResolver`` gives the same dependencies on
the same manifests."""

import asyncio
import json

import numpy as np
import pytest
from aiohttp import web

import kraken_tpu.backend as jax_backend
import kraken_tpu.buildindex.server as jax_server
import kraken_tpu.buildindex.tagstore as jax_tagstore
import kraken_tpu.buildindex.tagtype as jax_tagtype
import kraken_tpu.core.digest as jax_digest
import kraken_tpu.persistedretry as jax_retry
import kraken_tpu.utils.httputil as jax_httputil
import kraken_tpu_torch.backend as port_backend
import kraken_tpu_torch.buildindex.server as port_server
import kraken_tpu_torch.buildindex.tagstore as port_tagstore
import kraken_tpu_torch.buildindex.tagtype as port_tagtype
import kraken_tpu_torch.core.digest as port_digest
import kraken_tpu_torch.persistedretry as port_retry
import kraken_tpu_torch.utils.httputil as port_httputil
from kraken_tpu_torch.utils import http_lite

PKG = {
    "jax": {"backend": jax_backend, "server": jax_server, "tagstore": jax_tagstore,
            "tagtype": jax_tagtype, "digest": jax_digest, "retry": jax_retry,
            "httputil": jax_httputil},
    "port": {"backend": port_backend, "server": port_server, "tagstore": port_tagstore,
             "tagtype": port_tagtype, "digest": port_digest, "retry": port_retry,
             "httputil": port_httputil},
}
PAIRS = [("jax", "port"), ("port", "jax")]
TAGS = ["library/app:v1", "library/app:v2", "repo:latest", "a/b/c:1.0-rc+x", "x:y%z"]


def digest_of(pkg: str, i: int):
    return PKG[pkg]["digest"].Digest.from_bytes(f"manifest-{i}".encode())


@pytest.mark.parametrize("writer,reader", PAIRS)
def test_each_tagstore_reads_the_others_tags_on_disk(tmp_path, writer, reader):
    w = PKG[writer]["tagstore"].TagStore(str(tmp_path / "tags"))
    for i, tag in enumerate(TAGS):
        w.put_local(tag, digest_of(writer, i))
    r = PKG[reader]["tagstore"].TagStore(str(tmp_path / "tags"))
    assert [str(r.get_local(tag)) for tag in TAGS] == [str(digest_of(writer, i))
                                                        for i in range(len(TAGS))]
    assert r.list_local() == w.list_local() == sorted(TAGS)
    assert r.list_local("library/app:") == ["library/app:v1", "library/app:v2"]
    assert r.get_local("nope:v1") is None


@pytest.mark.parametrize("writer,reader", PAIRS)
def test_a_tag_written_back_by_one_package_is_read_through_by_the_other(tmp_path, writer,
                                                                        reader):
    """``put`` queues a writeback (``persistedretry``); it lands in a
    ``file`` backend, and the other package's store on a fresh volume
    reads the tag through from there."""
    backend_cfg = [{"namespace": ".*", "backend": "file",
                    "config": {"root": str(tmp_path / "remote")}}]

    async def main():
        mods = PKG[writer]
        retry = mods["retry"].Manager(mods["retry"].TaskStore(str(tmp_path / "w-retry.db")))
        w = mods["tagstore"].TagStore(str(tmp_path / "w"),
                                      backends=mods["backend"].Manager(backend_cfg), retry=retry)
        await w.put("library/app:v1", digest_of(writer, 1), namespace="library/app")
        assert await retry.run_once() == 1
        retry.close()
        r = PKG[reader]["tagstore"].TagStore(
            str(tmp_path / "r"), backends=PKG[reader]["backend"].Manager(backend_cfg))
        got = await r.get("library/app:v1", "library/app")
        missing = await r.get("library/app:v9", "library/app")
        return str(got), missing, r.get_local("library/app:v1")

    got, missing, cached = asyncio.run(main())
    assert got == str(digest_of(writer, 1)) and missing is None
    assert str(cached) == got  # read-through fills the local cache


async def _serve_tags(pkg: str, root, **kw):
    mods = PKG[pkg]
    server = mods["server"].TagServer(mods["tagstore"].TagStore(str(root)), **kw)
    app = server.make_app()
    if pkg == "port":
        runner, port = await http_lite.serve(app, "127.0.0.1", 0)
    else:
        runner = web.AppRunner(app)
        await runner.setup()
        site = web.TCPSite(runner, "127.0.0.1", 0)
        await site.start()
        port = runner.addresses[0][1]
    return server, runner, f"127.0.0.1:{port}"


@pytest.mark.parametrize("immutable", [False, True], ids=["mutable", "immutable"])
@pytest.mark.parametrize("server_pkg,client_pkg",
                         [("jax", "port"), ("port", "jax"), ("port", "port")])
def test_tag_server_and_client_across_packages(tmp_path, server_pkg, client_pkg, immutable):
    mods = PKG[client_pkg]

    async def main():
        _server, runner, addr = await _serve_tags(server_pkg, tmp_path / "bi", immutable=immutable)
        client = mods["server"].TagClient(addr)
        try:
            for i, tag in enumerate(TAGS):
                await client.put(tag, digest_of(client_pkg, i))
            got = [str(await client.get(tag)) for tag in TAGS]
            repo = await client.list_repo("library/app")
            everything = await client.list_all()
            with pytest.raises(mods["httputil"].HTTPError) as missing:
                await client.get("library/app:nope")
            await client.put("repo:latest", digest_of(client_pkg, 2))  # same digest again
            try:
                await client.put("repo:latest", digest_of(client_pkg, 7))
                repoint = 200
            except mods["httputil"].HTTPError as e:
                repoint = e.status
            return got, repo, everything, missing.value.status, repoint, \
                str(await client.get("repo:latest"))
        finally:
            await client.close()
            await runner.cleanup()

    got, repo, everything, missing, repoint, latest = asyncio.run(main())
    assert got == [str(digest_of(client_pkg, i)) for i in range(len(TAGS))]
    assert repo == ["v1", "v2"] and everything == sorted(TAGS)
    assert missing == 404
    assert (repoint, latest) == ((409, str(digest_of(client_pkg, 2))) if immutable
                                 else (200, str(digest_of(client_pkg, 7))))


@pytest.mark.parametrize("source,target", PAIRS)
def test_a_tag_replicates_between_the_packages_build_indexes(tmp_path, source, target):
    """``PUT .../replicate`` on ``source`` queues a ``tag_replicate`` task
    per remote; its run posts ``/internal/replicate`` to ``target``."""
    mods = PKG[source]

    async def main():
        _t_server, t_runner, t_addr = await _serve_tags(target, tmp_path / "target")
        retry = mods["retry"].Manager(mods["retry"].TaskStore(str(tmp_path / "retry.db")))
        _s_server, s_runner, s_addr = await _serve_tags(source, tmp_path / "source", retry=retry,
                                                        remotes=[t_addr])
        client = mods["server"].TagClient(s_addr)
        target_client = PKG[target]["server"].TagClient(t_addr)
        try:
            d = digest_of(source, 3)
            await client.put("library/app:v1", d, replicate=True)
            pending = retry.store.count_pending(mods["server"].REPLICATE_KIND)
            ran = await retry.run_once()
            return str(d), pending, ran, str(await target_client.get("library/app:v1"))
        finally:
            await client.close()
            await target_client.close()
            await s_runner.cleanup()
            await t_runner.cleanup()
            retry.close()

    d, pending, ran, replicated = asyncio.run(main())
    assert (pending, ran, replicated) == (1, 1, d)


def _manifests():
    def dg(i):
        return "sha256:" + f"{i:02x}" * 32

    schema2 = {"schemaVersion": 2, "config": {"digest": dg(1)},
               "layers": [{"digest": dg(2)}, {"digest": dg(3)}]}
    no_config = {"schemaVersion": 2, "layers": [{"digest": dg(4)}]}
    index = {"schemaVersion": 2, "manifests": [{"digest": dg(5)}, {"digest": dg(6)}]}
    return {"schema2": json.dumps(schema2).encode(), "no_config": json.dumps(no_config).encode(),
            "index": json.dumps(index).encode(), "other": b'{"schemaVersion": 1}',
            "garbage": b"\x00not json", "bad_digest": b'{"layers": [{"digest": "md5:x"}]}'}


@pytest.mark.parametrize("kind", ["docker", "default"])
@pytest.mark.parametrize("name", sorted(_manifests()))
def test_dependency_resolver_gives_the_references_dependencies(name, kind):
    manifest = _manifests()[name]

    class Origins:
        async def download(self, namespace, d):
            return manifest

    def resolve(pkg):
        mods = PKG[pkg]
        d = mods["digest"].Digest.from_bytes(manifest)
        resolver = mods["tagtype"].DependencyResolver(Origins(), kind=kind)
        return [str(x) for x in asyncio.run(resolver.resolve("library/app", "library/app:v1", d))]

    assert resolve("port") == resolve("jax")
    if kind == "docker" and name == "schema2":
        assert len(resolve("port")) == 4
    for pkg in PKG:
        with pytest.raises(ValueError):
            PKG[pkg]["tagtype"].DependencyResolver(kind="nope")


@pytest.mark.parametrize("name", sorted(_manifests()))
def test_docker_manifest_dependencies_parse_alike(name):
    manifest = _manifests()[name]

    def parse(pkg):
        try:
            return [str(d) for d in PKG[pkg]["tagtype"].docker_manifest_dependencies(manifest)]
        except Exception as e:  # the same exception type in both
            return type(e).__name__

    assert parse("port") == parse("jax")


def test_the_tag_files_are_named_and_written_as_the_references(tmp_path):
    rng = np.random.default_rng(4)
    tag = "library/app:v" + str(int(rng.integers(0, 1000)))
    port_tagstore.TagStore(str(tmp_path / "p")).put_local(tag, digest_of("port", 1))
    jax_tagstore.TagStore(str(tmp_path / "j")).put_local(tag, digest_of("jax", 1))
    (p,) = (tmp_path / "p").iterdir()
    (j,) = (tmp_path / "j").iterdir()
    assert p.name == j.name and p.read_bytes() == j.read_bytes()
