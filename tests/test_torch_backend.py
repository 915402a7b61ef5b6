"""The port's ``backend/`` held against ``kraken_tpu.backend``: the
reference's own cases for ``file``, ``testfs``, ``Manager`` and throttling
run on the port, each package reads the other's ``file`` layout, and each
package's ``testfs`` client talks to the other's server. Blobs come from
``numpy.random.default_rng(seed)``; everything compared is bytes, exactly."""

import asyncio
import time

import numpy as np
import pytest

import kraken_tpu.backend as jax_backend
import kraken_tpu.backend.namepath as jax_namepath
import kraken_tpu.backend.testfs as jax_testfs
import kraken_tpu_torch.backend as port_backend
import kraken_tpu_torch.backend.namepath as port_namepath
import kraken_tpu_torch.backend.testfs as port_testfs
from kraken_tpu_torch.backend import BlobNotFoundError, Manager, make_backend
from kraken_tpu_torch.backend.testfs import TestFSServer

PKG = {"jax": jax_backend, "port": port_backend}
TESTFS = {"jax": jax_testfs, "port": port_testfs}
PAIRS = [("port", "jax"), ("jax", "port")]


def blob_of(n: int, seed: int) -> bytes:
    return np.random.default_rng(seed).integers(0, 256, n, dtype=np.uint8).tobytes()


def run(coro):
    return asyncio.run(coro)


@pytest.mark.parametrize("pather,name", [
    ("identity", "x/y"), ("identity", "x"), ("sharded_docker_blob", "ab" * 32),
    ("docker_tag", "library/nginx:latest"),
])
@pytest.mark.parametrize("root", ["", "blobs"])
def test_pathers_are_the_references(pather, name, root):
    assert (port_namepath.get_pather(pather)(root, name)
            == jax_namepath.get_pather(pather)(root, name))


def test_pathers():
    get_pather = port_namepath.get_pather
    hex64 = "ab" * 32
    assert get_pather("identity")("", "x/y") == "x/y"
    assert get_pather("identity")("root", "x") == "root/x"
    assert get_pather("sharded_docker_blob")("blobs", hex64) == f"blobs/ab/ab/{hex64}"
    assert (get_pather("docker_tag")("tags", "library/nginx:latest")
            == "tags/library/nginx/_manifests/tags/latest/current/link")
    with pytest.raises(ValueError):
        get_pather("docker_tag")("", "notag")


def test_file_backend_roundtrip(tmp_path):
    async def main():
        c = make_backend("file", {"root": str(tmp_path / "be")})
        await c.upload("ns", "a/b/blob1", b"data1")
        await c.upload("ns", "a/blob2", b"data2")
        assert await c.download("ns", "a/b/blob1") == b"data1"
        assert (await c.stat("ns", "a/blob2")).size == 5
        assert await c.list("a/") == ["a/b/blob1", "a/blob2"]
        with pytest.raises(BlobNotFoundError):
            await c.download("ns", "missing")
        with pytest.raises(BlobNotFoundError):
            await c.stat("ns", "missing")

    run(main())


@pytest.mark.parametrize("writer,reader", PAIRS)
@pytest.mark.parametrize("pather", ["identity", "sharded_docker_blob"])
def test_each_package_reads_the_others_file_backend(tmp_path, writer, reader, pather):
    cfg = {"root": str(tmp_path / "be"), "pather": pather}
    blobs = {f"{i:02x}" * 32: blob_of(1000 + 37 * i, i) for i in range(3)}

    w_path = tmp_path / "w"
    w_path.write_bytes(blob_of(5000, 9))

    async def main():
        w = PKG[writer].base.make_backend("file", cfg)
        for name, data in blobs.items():
            await w.upload("ns", name, data)
        await w.upload_file("ns", "ff" * 32, str(w_path))
        r = PKG[reader].base.make_backend("file", cfg)
        out = {name: await r.download("ns", name) for name in blobs}
        sizes = {name: (await r.stat("ns", name)).size for name in blobs}
        dest = str(tmp_path / "dest")
        n = await r.download_to_file("ns", "ff" * 32, dest)
        return out, sizes, n, await r.list(""), await w.list("")

    out, sizes, n, r_list, w_list = run(main())
    assert out == blobs
    assert sizes == {k: len(v) for k, v in blobs.items()}
    assert n == 5000 and (tmp_path / "dest").read_bytes() == blob_of(5000, 9)
    assert r_list == w_list and len(r_list) == 4


def test_testfs_roundtrip():
    async def main():
        async with TestFSServer() as srv:
            c = make_backend("testfs", {"addr": srv.addr})
            await c.upload("ns", "dir/blob", b"hello world")
            assert await c.download("ns", "dir/blob") == b"hello world"
            assert (await c.stat("ns", "dir/blob")).size == 11
            await c.upload("ns", "dir/other", b"x")
            assert await c.list("dir/") == ["dir/blob", "dir/other"]
            with pytest.raises(BlobNotFoundError):
                await c.download("ns", "nope")
            await c.close()

    run(main())


@pytest.mark.parametrize("server,client", PAIRS, ids=[f"{s}-server-{c}-client" for s, c in PAIRS])
def test_testfs_server_serves_the_other_packages_client(server, client):
    data = blob_of(300_000, 4)

    async def main():
        async with TESTFS[server].TestFSServer() as srv:
            c = PKG[client].base.make_backend("testfs", {"addr": srv.addr})
            try:
                await c.upload("ns", "d/blob", data)
                await c.upload("ns", "d/small", b"x")
                got = await c.download("ns", "d/blob")
                size = (await c.stat("ns", "d/blob")).size
                names = await c.list("d/")
                with pytest.raises(PKG[client].BlobNotFoundError):
                    await c.stat("ns", "nope")
            finally:
                await c.close()
        return got, size, names

    got, size, names = run(main())
    assert got == data and size == len(data) and names == ["d/blob", "d/small"]


def test_manager_namespace_resolution(tmp_path):
    async def main():
        m = Manager([
            {"namespace": r"library/.*", "backend": "file",
             "config": {"root": str(tmp_path / "lib")}},
            {"namespace": r".*", "backend": "file",
             "config": {"root": str(tmp_path / "default")}},
        ])
        lib = m.get_client("library/nginx")
        default = m.get_client("other/repo")
        assert lib is not default
        assert m.get_client("library/x") is lib  # first match wins
        assert m.try_get_client("anything") is default
        await m.close()

    run(main())


def test_manager_no_match():
    m = Manager([])
    with pytest.raises(KeyError):
        m.get_client("ns")
    assert m.try_get_client("ns") is None


def test_unknown_backend():
    with pytest.raises(KeyError):
        make_backend("s4")


def test_the_port_registers_file_and_testfs():
    """And every other backend of the reference: the two registries hold
    the same nine names."""
    assert set(port_backend.base._REGISTRY) == set(jax_backend.base._REGISTRY) == {
        "file", "testfs", "http", "shadow", "s3", "gcs", "hdfs", "registry_blob",
        "registry_tag"}


def test_throttled_backend(tmp_path):
    async def main():
        m = Manager([{
            "namespace": ".*", "backend": "file",
            "config": {"root": str(tmp_path / "bw")},
            "bandwidth": {"ingress_bps": 50_000, "egress_bps": 0},
        }])
        c = m.get_client("ns")
        await c.upload("ns", "blob", bytes(30_000))
        t0 = time.monotonic()
        await c.download("ns", "blob")  # within burst capacity
        await c.download("ns", "blob")  # exceeds burst -> throttled ~0.2s
        return time.monotonic() - t0

    assert run(main()) > 0.1


@pytest.mark.parametrize("name", ["backend.file.download", "backend.file.upload"])
def test_file_backend_failpoints_raise_oserror_never_not_found(tmp_path, name):
    from kraken_tpu_torch.utils import failpoints

    async def main():
        c = make_backend("file", {"root": str(tmp_path / "be")})
        await c.upload("ns", "blob", b"abc")
        failpoints.FAILPOINTS.arm(name, "once")
        try:
            with pytest.raises(OSError) as ei:
                if name.endswith("download"):
                    await c.download("ns", "blob")
                else:
                    await c.upload("ns", "blob2", b"x")
            assert not isinstance(ei.value, BlobNotFoundError)
            assert await c.download("ns", "blob") == b"abc"  # once: healed
        finally:
            failpoints.FAILPOINTS.disarm_all()

    run(main())
