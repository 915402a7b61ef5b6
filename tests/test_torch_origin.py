"""The port's origin over its own HTTP/1.1 (``origin/server.py``,
``origin/client.py``, ``blobrefresh``, ``writeback``, ``store/serve.py``)
held against ``kraken_tpu.origin``, byte for byte:

- the port origin serves the JAX ``BlobClient``/``ClusterClient`` and the
  JAX origin serves the port's (upload, resume, stat, metainfo bytes, range
  downloads, delete, 404s);
- the reference's PATCH-failure tests (``tests/test_ingest.py``,
  ``tests/test_chaos.py``) run on the port;
- a three-origin quorum with the partition failpoint (the ack, the hints,
  the replay, read-repair), heal from a ring replica, refresh from a
  backend and writeback to it, the tracker proxying metainfo through the
  port ``ClusterClient``, and the slice's deliberate differences.

Every origin here hashes on the CPU: hashlib (``CPUPieceHasher``), or the
plain versions of the card kernels (``TorchPieceHasher(device="cpu")``)
where a test stands in for a card origin. Blobs are a few KiB to 300 KB
from ``numpy.random.default_rng(seed)``, pieces 4-64 KiB.
"""

import asyncio
import hashlib
import io
import os
import socket

import aiohttp
import numpy as np
import pytest
from aiohttp import web

import kraken_tpu.core.hasher as jax_hasher
import kraken_tpu.core.metainfo as jax_metainfo
import kraken_tpu.origin.client as jax_client
import kraken_tpu.origin.metainfogen as jax_gen
import kraken_tpu.origin.server as jax_server
import kraken_tpu.placement as jax_placement
import kraken_tpu.store as jax_store
import kraken_tpu.utils.failpoints as jax_failpoints
import kraken_tpu.utils.httputil as jax_httputil
import kraken_tpu_torch.origin.client as port_client
import kraken_tpu_torch.placement as port_placement
import kraken_tpu_torch.utils.failpoints as port_failpoints
import kraken_tpu_torch.utils.httputil as port_httputil
from kraken_tpu.core.digest import Digest as JaxDigest
from kraken_tpu_torch.backend import Manager as BackendManager
from kraken_tpu_torch.core.digest import Digest
from kraken_tpu_torch.core.hasher import CPUPieceHasher, HashPool
from kraken_tpu_torch.core.ingest import IngestConfig, IngestPipeline
from kraken_tpu_torch.core.peer import PeerID
from kraken_tpu_torch.ops.sha256 import TorchPieceHasher
from kraken_tpu_torch.origin.blobrefresh import Refresher
from kraken_tpu_torch.origin.client import BlobClient, ClusterClient
from kraken_tpu_torch.origin.dedup import DedupIndex
from kraken_tpu_torch.origin.metainfogen import Generator, PieceLengthConfig, TorrentMetaMetadata
from kraken_tpu_torch.origin.server import HINT_KIND, OriginServer, QuorumConfig, _UploadDigest
from kraken_tpu_torch.origin.writeback import WritebackExecutor
from kraken_tpu_torch.ops.cdc import CDCParams
from kraken_tpu_torch.persistedretry import Manager as RetryManager, TaskStore
from kraken_tpu_torch.placement import HostList, Ring
from kraken_tpu_torch.store import CAStore
from kraken_tpu_torch.store.metadata import PersistMetadata
from kraken_tpu_torch.tracker.client import make_tracker_client
from kraken_tpu_torch.tracker.server import TrackerServer
from kraken_tpu_torch.utils import failpoints, http_lite, trace
from kraken_tpu_torch.utils.httputil import HTTPClient, HTTPError
from kraken_tpu_torch.utils.metrics import REGISTRY

PIECE = 64 * 1024
NS = "ns/a"
PAIRS = [("port", "jax"), ("jax", "port"), ("port", "port")]
PAIR_IDS = [f"{s}-origin-{c}-clients" for s, c in PAIRS]
CLIENT = {"jax": (jax_client, jax_httputil, JaxDigest, jax_placement),
          "port": (port_client, port_httputil, Digest, port_placement)}
FAILPOINTS = {"jax": jax_failpoints, "port": port_failpoints}


def blob_of(n: int, seed: int) -> bytes:
    return np.random.default_rng(seed).integers(0, 256, n, dtype=np.uint8).tobytes()


def hashlib_pieces(blob: bytes, piece: int) -> bytes:
    return b"".join(hashlib.sha256(blob[i:i + piece]).digest()
                    for i in range(0, len(blob), piece))


def reference_metainfo(blob: bytes, piece: int = PIECE) -> bytes:
    """The JAX package's MetaInfo bytes over hashlib's piece hashes."""
    d = JaxDigest.from_bytes(blob)
    return jax_metainfo.MetaInfo(d, len(blob), piece, hashlib_pieces(blob, piece)).serialize()


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def counter(name: str, **labels) -> float:
    return REGISTRY.counter(name).value(**labels)


@pytest.fixture(autouse=True)
def chaos():
    for fp in FAILPOINTS.values():
        fp.FAILPOINTS.disarm_all()
    yield
    for fp in FAILPOINTS.values():
        fp.FAILPOINTS.disarm_all()


def port_origin(root, hasher=None, piece=PIECE, pipeline=None, **kw) -> OriginServer:
    store = CAStore(str(root))
    gen = Generator(store, hasher=hasher if hasher is not None else CPUPieceHasher(),
                    piece_lengths=PieceLengthConfig(((0, piece),)), pipeline=pipeline)
    return OriginServer(store, gen, ingest_pipeline=pipeline, **kw)


async def serve(kind: str, server, port: int = 0):
    """Serve an origin of either package; returns (addr, stop)."""
    if kind == "port":
        runner, port = await http_lite.serve(server.make_app(), "127.0.0.1", port)
    else:
        runner = web.AppRunner(server.make_app(), handler_cancellation=True)
        await runner.setup()
        site = web.TCPSite(runner, "127.0.0.1", port)
        await site.start()
        port = site._server.sockets[0].getsockname()[1]
    return f"127.0.0.1:{port}", runner.cleanup


def make_origin(kind: str, root, **kw):
    if kind == "port":
        return port_origin(root, **kw)
    store = jax_store.CAStore(str(root))
    gen = jax_gen.Generator(store, hasher=jax_hasher.get_hasher("cpu"),
                            piece_lengths=jax_gen.PieceLengthConfig(((0, PIECE),)))
    return jax_server.OriginServer(store, gen, **kw)


async def raw(method: str, url: str, **kw):
    async with aiohttp.ClientSession() as s:
        async with s.request(method, url, **kw) as r:
            return r.status, dict(r.headers), await r.read()


# -- both packages' origins and clients, both ways ------------------------------


@pytest.mark.parametrize("server,client", PAIRS, ids=PAIR_IDS)
def test_origin_serves_the_other_packages_clients(tmp_path, server, client):
    mod, httputil, digest_cls, placement = CLIENT[client]
    blob = blob_of(300_000, 1)
    d = digest_cls.from_bytes(blob)
    want_mi = reference_metainfo(blob)

    async def main():
        origin = make_origin(server, tmp_path / "o")
        addr, stop = await serve(server, origin)
        c = mod.BlobClient(addr, httputil.HTTPClient(retries=0))
        cluster = mod.ClusterClient(placement.Ring(placement.HostList(static=[addr]),
                                                   max_replica=1))
        try:
            assert await c.stat(NS, d) is None
            with pytest.raises(httputil.HTTPError) as ei:
                await c.get_metainfo(NS, d)
            assert ei.value.status == 404
            # A PATCH fails mid-stream on the origin (its own failpoint
            # plane): the client HEADs the durable offset and resumes.
            FAILPOINTS[server].FAILPOINTS.arm("origin.patch.write", "every:3+times:1")
            await c.upload(NS, d, blob, chunk_size=40_000)
            assert FAILPOINTS[server].FAILPOINTS.snapshot()["failpoints"][
                "origin.patch.write"]["fired"] == 1
            out = {
                "stat": (await c.stat(NS, d)).size,
                "local": (await c.stat(NS, d, local_only=True)).size,
                "metainfo": (await c.get_metainfo(NS, d)).serialize(),
                "cluster_metainfo": (await cluster.get_metainfo(NS, d)).serialize(),
                "download": await c.download(NS, d),
                "cluster_download": await cluster.download(NS, d),
                "health": await c.health(),
            }
            out["to_file"] = await c.download_to_file(NS, d, str(tmp_path / "dest"))
            base = f"http://{addr}/namespace/{NS.replace('/', '%2F')}/blobs/{d.hex}"
            out["range"] = await raw("GET", base, headers={"Range": "bytes=1000-1999"})
            out["suffix"] = await raw("GET", base, headers={"Range": "bytes=-10"})
            out["multi"] = await raw("GET", base, headers={"Range": "bytes=0-1,5-6"})
            out["past_eof"] = await raw("GET", base, headers={"Range": f"bytes={len(blob)}-"})
            out["head"] = await raw("HEAD", base)
            await c.delete(NS, d)
            out["after_delete"] = await c.stat(NS, d)
            with pytest.raises(httputil.HTTPError) as ei:
                await c.download(NS, d)
            out["download_404"] = ei.value.status
            out["bad_digest"] = (await raw("GET", f"http://{addr}/namespace/ns/blobs/zz/stat"))[0]
        finally:
            await c.close()
            await cluster.close()
            await stop()
        return out

    out = asyncio.run(main())
    assert out["stat"] == out["local"] == out["to_file"] == len(blob)
    assert out["metainfo"] == out["cluster_metainfo"] == want_mi
    assert out["download"] == out["cluster_download"] == (tmp_path / "dest").read_bytes() == blob
    assert out["health"] is True
    status, headers, body = out["range"]
    assert (status, body) == (206, blob[1000:2000])
    assert headers["Content-Range"] == f"bytes 1000-1999/{len(blob)}"
    assert out["suffix"][0] == 206 and out["suffix"][2] == blob[-10:]
    assert out["multi"][0] == 200 and out["multi"][2] == blob
    assert out["past_eof"][0] == 416
    assert out["past_eof"][1]["Content-Range"] == f"bytes */{len(blob)}"
    assert out["head"][0] == 200 and out["head"][1]["Content-Length"] == str(len(blob))
    assert out["after_delete"] is None and out["download_404"] == 404
    assert out["bad_digest"] == 400


@pytest.mark.parametrize("server", ["port", "jax"])
def test_range_answers_are_the_same_on_both_origins(tmp_path, server):
    """Each origin's answer to the same Range headers, held against the
    slice of the blob Python takes: the two servers agree case by case."""
    blob = blob_of(5000, 2)
    d = Digest.from_bytes(blob)
    ranges = ["bytes=0-0", "bytes=10-", "bytes=-1", "bytes=4990-9999", "bytes=-9999",
              "bytes=7-3", "bytes=abc", "bytes=5000-5000"]

    async def main():
        origin = make_origin(server, tmp_path / "o")
        addr, stop = await serve(server, origin)
        try:
            c = BlobClient(addr)
            await c.upload(NS, d, blob)
            await c.close()
            base = f"http://{addr}/namespace/ns/blobs/{d.hex}"
            return [await raw("GET", base, headers={"Range": h}) for h in ranges]
        finally:
            await stop()

    got = [(s, h.get("Content-Range"), b if s != 416 else None)
           for s, h, b in asyncio.run(main())]
    n = len(blob)
    assert got == [
        (206, f"bytes 0-0/{n}", blob[:1]),
        (206, f"bytes 10-{n - 1}/{n}", blob[10:]),
        (206, f"bytes {n - 1}-{n - 1}/{n}", blob[-1:]),
        (206, f"bytes 4990-{n - 1}/{n}", blob[4990:]),
        (206, f"bytes 0-{n - 1}/{n}", blob),
        (200, None, blob),
        (200, None, blob),
        (416, f"bytes */{n}", None),
    ]


# -- the reference's PATCH-failure tests on the port -----------------------------


async def _upload(addr, d, chunks, offsets=None):
    """Drive the chunked-upload API; offsets override the sequential
    default to simulate out-of-order clients."""
    base = f"http://{addr}/namespace/ns/blobs/{d}"
    async with aiohttp.ClientSession() as http:
        async with http.post(f"{base}/uploads") as r:
            assert r.status == 200
            uid = await r.text()
        pos = 0
        for i, chunk in enumerate(chunks):
            off = pos if offsets is None else offsets[i]
            async with http.patch(f"{base}/uploads/{uid}", data=chunk,
                                  headers={"X-Upload-Offset": str(off)}) as r:
                assert r.status == 204
            pos += len(chunk)
        async with http.put(f"{base}/uploads/{uid}/commit") as r:
            return r.status, await r.text()


def test_stream_metainfo_matches_generate(tmp_path):
    """Piece-misaligned PATCHes to a pooled hashlib origin: the stream-time
    MetaInfo is the reference's bytes."""
    blob = blob_of(9 * PIECE + 1234, 3)
    d = Digest.from_bytes(blob)

    async def main():
        origin = port_origin(tmp_path / "o", hasher=CPUPieceHasher(workers=2))
        assert origin._stream_hash_pool is not None
        addr, stop = await serve("port", origin)
        try:
            cuts = [0, PIECE // 3, 4 * PIECE + 17, 7 * PIECE - 1, len(blob)]
            status, _ = await _upload(addr, d, [blob[a:b] for a, b in zip(cuts, cuts[1:])])
            assert status == 201
            return origin.store.get_metadata(d, TorrentMetaMetadata).metainfo.serialize()
        finally:
            await stop()

    assert asyncio.run(main()) == reference_metainfo(blob)


def test_patch_failure_invalidates_tracker(tmp_path, monkeypatch):
    """An exception escaping the spool-file close must invalidate the
    upload digest tracker: the commit then takes the verifying re-read,
    never the fast path over a possible hole (ADVICE.md, medium)."""
    blob = blob_of(2 * PIECE, 4)
    d = Digest.from_bytes(blob)
    reads = {"n": 0}
    orig_reader = Digest.from_reader.__func__

    def counting_reader(cls, f):
        reads["n"] += 1
        return orig_reader(cls, f)

    monkeypatch.setattr(Digest, "from_reader", classmethod(counting_reader))

    class FailingClose:
        def __init__(self, f):
            self._f = f

        def __getattr__(self, a):
            return getattr(self._f, a)

        def close(self):
            self._f.close()
            raise OSError("deferred write error at close")

    async def main():
        origin = port_origin(tmp_path / "o")
        orig_open = origin.store.open_upload_file
        patches = {"n": 0}

        def open_patched(uid):
            patches["n"] += 1
            f = orig_open(uid)
            return FailingClose(f) if patches["n"] == 1 else f

        origin.store.open_upload_file = open_patched
        addr, stop = await serve("port", origin)
        base = f"http://{addr}/namespace/ns/blobs/{d}"
        try:
            async with aiohttp.ClientSession() as http:
                async with http.post(f"{base}/uploads") as r:
                    uid = await r.text()
                async with http.patch(f"{base}/uploads/{uid}", data=blob[:PIECE],
                                      headers={"X-Upload-Offset": "0"}) as r:
                    assert r.status == 500
                async with http.patch(f"{base}/uploads/{uid}", data=blob[PIECE:],
                                      headers={"X-Upload-Offset": str(PIECE)}) as r:
                    assert r.status == 204
                async with http.put(f"{base}/uploads/{uid}/commit") as r:
                    assert r.status == 201, await r.text()
            return origin.store.read_cache_file(d)
        finally:
            await stop()

    assert asyncio.run(main()) == blob
    assert reads["n"] >= 1


def test_invalidated_pooled_tracker_drops_chunk_pins():
    pool = HashPool(1, name="cpu/test-pins")
    t = _UploadDigest(piece_length=4096, pool=pool)
    t.begin_patch(0)
    t.write_and_update(io.BytesIO(), b"x" * 1000)
    assert t._parts
    t.end_patch()
    t.invalidate()
    assert not t._parts and not t._futs
    t2 = _UploadDigest(piece_length=4096, pool=pool)
    t2.begin_patch(0)
    t2.write_and_update(io.BytesIO(), b"y" * 1000)
    t2.end_patch()
    assert not t2.begin_patch(999)  # wrong offset -> invalidate
    assert not t2._parts


def test_out_of_order_patches_fall_back_and_verify(tmp_path):
    blob = blob_of(3 * PIECE, 5)
    d = Digest.from_bytes(blob)
    other = blob_of(PIECE, 6)
    wrong_d = Digest.from_bytes(b"not the blob")

    async def main():
        origin = port_origin(tmp_path / "o")
        addr, stop = await serve("port", origin)
        try:
            status, _ = await _upload(addr, d, [blob[2 * PIECE:], blob[:2 * PIECE]],
                                      offsets=[2 * PIECE, 0])
            assert status == 201
            assert origin.store.read_cache_file(d) == blob
            status, body = await _upload(addr, wrong_d, [other[PIECE // 2:], other[:PIECE // 2]],
                                         offsets=[PIECE // 2, 0])
            assert status == 400, body
        finally:
            await stop()

    asyncio.run(main())


def test_resume_patch_past_durable_size_409s(tmp_path):
    blob = blob_of(4 * PIECE, 7)
    d = Digest.from_bytes(blob)

    async def main():
        origin = port_origin(tmp_path / "o")
        addr, stop = await serve("port", origin)
        try:
            base = f"http://{addr}/namespace/ns/blobs/{d}"
            async with aiohttp.ClientSession() as http:
                async with http.post(f"{base}/uploads") as r:
                    uid = await r.text()
                async with http.patch(f"{base}/uploads/{uid}", data=blob[:PIECE],
                                      headers={"X-Upload-Offset": "0"}) as r:
                    assert r.status == 204
                async with http.patch(f"{base}/uploads/{uid}", data=blob[2 * PIECE:],
                                      headers={"X-Upload-Offset": str(2 * PIECE)}) as r:
                    assert r.status == 409
                async with http.request("HEAD", f"{base}/uploads/{uid}") as r:
                    off = int(r.headers["X-Upload-Offset"])
                assert off == PIECE
                async with http.patch(f"{base}/uploads/{uid}", data=blob[off:],
                                      headers={"X-Upload-Offset": str(off)}) as r:
                    assert r.status == 204
                async with http.put(f"{base}/uploads/{uid}/commit") as r:
                    assert r.status == 201
            assert origin.store.read_cache_file(d) == blob
            assert origin.store.read_upload_session(uid) is None
        finally:
            await stop()

    asyncio.run(main())


def test_enospc_mid_patch_clean_error_spool_left_retry_succeeds(tmp_path):
    """resume=False pins the fail-fast contract: a mid-stream ENOSPC is a
    clean 500, never a hang or a corrupt blob; the retry lands. (The
    reference also sweeps the spool with ``store/cleanup.py``, ROADMAP A7e.)"""

    async def main():
        origin = port_origin(tmp_path / "o", piece=4096)
        addr, stop = await serve("port", origin)
        oc = BlobClient(addr, HTTPClient(retries=0), resume=False)
        try:
            blob = blob_of(3 * 4096 + 500, 8)
            d = Digest.from_bytes(blob)
            failpoints.FAILPOINTS.arm("origin.patch.write", "once")
            with pytest.raises(HTTPError) as ei:
                await oc.upload(NS, d, blob)
            assert ei.value.status == 500
            assert not origin.store.in_cache(d)
            assert os.listdir(origin.store.upload_dir)  # the spool is left
            await oc.upload(NS, d, blob)
            assert await oc.download(NS, d) == blob
            blob2 = blob_of(2 * 4096, 9)
            d2 = Digest.from_bytes(blob2)
            failpoints.FAILPOINTS.arm("origin.patch.close", "once")
            with pytest.raises(HTTPError) as ei2:
                await oc.upload(NS, d2, blob2)
            assert ei2.value.status == 500
            await oc.upload(NS, d2, blob2)
            assert await oc.download(NS, d2) == blob2
        finally:
            await oc.close()
            await stop()

    asyncio.run(main())


def test_enospc_mid_patch_resume_heals_transparently(tmp_path):
    async def main():
        origin = port_origin(tmp_path / "o", piece=4096)
        addr, stop = await serve("port", origin)
        oc = BlobClient(addr, HTTPClient(retries=0))
        try:
            blob = blob_of(3 * 4096 + 500, 10)
            d = Digest.from_bytes(blob)
            failpoints.FAILPOINTS.arm("origin.patch.write", "once")
            await oc.upload(NS, d, blob)  # no raise: it heals
            assert failpoints.FAILPOINTS.snapshot()["failpoints"]["origin.patch.write"]["fired"] == 1
            assert await oc.download(NS, d) == blob
        finally:
            await oc.close()
            await stop()

    asyncio.run(main())


def test_unadoptable_session_404s_and_the_client_restarts(tmp_path):
    blob = blob_of(3 * 4096, 11)
    d = Digest.from_bytes(blob)

    async def main():
        origin = port_origin(tmp_path / "o", piece=4096)
        addr, stop = await serve("port", origin)
        oc = BlobClient(addr, HTTPClient(retries=0))
        try:
            before = counter("upload_sessions_unadoptable_total")
            failpoints.FAILPOINTS.arm("origin.patch.write", "every:2+times:1")
            failpoints.FAILPOINTS.arm("origin.upload.resume", "once")
            await oc.upload(NS, d, blob, chunk_size=4096)
            assert counter("upload_sessions_unadoptable_total") == before + 1
            assert await oc.download(NS, d) == blob
            assert origin.store.list_upload_sessions() == []
        finally:
            await oc.close()
            await stop()

    asyncio.run(main())


# -- the card's stream-time path, with the plain versions of its kernels ------------


def test_pipeline_trackers_hash_at_stream_time_and_abort_when_invalidated(tmp_path):
    """A ``cuda`` origin with an ingest pipeline hashes pieces through the
    pipeline's windows while the body streams in (here the plain versions
    of the kernels, on the CPU). A PATCH that fails invalidates the
    tracker, whose session aborts on a scrap thread; the resumed upload
    re-adopts and commits the exact blob and metainfo."""
    piece = 1024
    blob = blob_of(3 * (1 << 20) + 3000, 12)
    d = Digest.from_bytes(blob)
    pipe = IngestPipeline(TorchPieceHasher(device="cpu"), IngestConfig(window_bytes=1 << 20))

    async def main():
        origin = port_origin(tmp_path / "o", hasher=pipe.hasher, piece=piece, pipeline=pipe)
        assert origin._stream_piece_length == piece and origin._stream_hash_pool is None
        addr, stop = await serve("port", origin)
        oc = BlobClient(addr, HTTPClient(retries=0))
        aborted = []
        orig_invalidate = _UploadDigest.invalidate

        def spy(self):
            aborted.append(self._ses is not None)
            orig_invalidate(self)

        _UploadDigest.invalidate = spy
        try:
            failpoints.FAILPOINTS.arm("origin.patch.write", "every:3+times:1")
            await oc.upload(NS, d, blob, chunk_size=1 << 20)
        finally:
            _UploadDigest.invalidate = orig_invalidate
            await oc.close()
            await stop()
        return origin, aborted

    origin, aborted = asyncio.run(main())
    assert True in aborted  # a live session was aborted by the invalidation
    assert origin.store.read_cache_file(d) == blob
    stored = origin.store.get_metadata(d, TorrentMetaMetadata).metainfo
    assert stored.serialize() == reference_metainfo(blob, piece)


def test_stream_piece_hash_follows_the_generators_hasher(tmp_path):
    gpu = TorchPieceHasher(device="cpu")  # the ``cuda`` hasher's plain versions
    assert port_origin(tmp_path / "a")._stream_piece_length == PIECE
    assert port_origin(tmp_path / "b", hasher=gpu)._stream_piece_length == 0
    assert port_origin(tmp_path / "c", hasher=gpu,
                       stream_piece_hash=True)._stream_piece_length == PIECE
    assert port_origin(tmp_path / "d", stream_piece_hash=False)._stream_piece_length == 0
    pipe = IngestPipeline(gpu, IngestConfig(window_bytes=1 << 20))
    assert port_origin(tmp_path / "e", hasher=gpu, pipeline=pipe)._stream_piece_length == PIECE
    # The reference hashes with hashlib at stream time unless told not to.
    store = jax_store.CAStore(str(tmp_path / "j"))
    gen = jax_gen.Generator(store, hasher=jax_hasher.get_hasher("cpu"),
                            piece_lengths=jax_gen.PieceLengthConfig(((0, PIECE),)))
    assert jax_server.OriginServer(store, gen)._stream_piece_length == PIECE


@pytest.mark.parametrize("kw,item", [({"delta": object()}, "A7f"), ({"cleanup": object()}, "A7e")])
def test_unported_wiring_is_refused_by_name(tmp_path, kw, item):
    """Wiring that waited for a later item is taken once the item lands.
    ``delta=`` (A7f) is the origin's ``DeltaConfig``, which gates the
    ``/recipe`` route, and defaults to the shipped (off) config as the
    reference's does. ``cleanup=``, which A7e's first part brought
    (``store/cleanup.py``), is taken, and the origin touches the
    eviction clock on every read as the reference's ``_touch`` does."""
    if item == "A7f":
        from kraken_tpu_torch.p2p.delta import DeltaConfig

        assert port_origin(tmp_path / "o", **kw).delta_config is kw["delta"]
        assert port_origin(tmp_path / "d").delta_config == DeltaConfig()
        assert jax_server.OriginServer(
            jax_store.CAStore(str(tmp_path / "j")), None
        ).delta_config.enabled is False
        return
    from kraken_tpu_torch.store.cleanup import CleanupManager

    blob = blob_of(50_000, 14)
    d = Digest.from_bytes(blob)

    async def main():
        origin = port_origin(tmp_path / "o")
        origin.cleanup = CleanupManager(origin.store)
        addr, stop = await serve("port", origin)
        try:
            c = BlobClient(addr)
            await c.upload(NS, d, blob)
            assert d.hex not in origin.cleanup._touched
            assert await c.download(NS, d) == blob
            first = origin.cleanup._touched[d.hex]
            await c.get_metainfo(NS, d)
            await c.close()
            return first, origin.cleanup._touched[d.hex]
        finally:
            await stop()

    first, second = asyncio.run(main())
    assert 0 < first <= second


def test_dedup_runs_after_commit_and_its_routes_are_absent(tmp_path):
    """The post-commit dedup task indexes the blob (on the CPU here); the
    ``/similar`` and ``/dedup/stats`` routes (A7f) answer from the index,
    and ``/recipe`` is absent (404) while ``delta.enabled`` is off, as the
    reference's; with no dedup index all three answer 404."""
    blob = blob_of(200_000, 13)
    d = Digest.from_bytes(blob)

    async def main():
        store_root = tmp_path / "o"
        origin = port_origin(store_root)
        origin.dedup = DedupIndex(origin.store, hasher=CPUPieceHasher(),
                                  params=CDCParams(64, 256, 1024), device="cpu")
        addr, stop = await serve("port", origin)
        try:
            c = BlobClient(addr)
            await c.upload(NS, d, blob)
            await asyncio.gather(*origin._dedup_tasks)
            stats = origin.dedup.stats()
            base = f"http://{addr}/namespace/ns/blobs/{d.hex}"
            urls = (f"{base}/similar", f"{base}/recipe", f"http://{addr}/dedup/stats")
            codes = [(await raw("GET", u))[0] for u in urls]
            similar = await c.similar(NS, d)
            await c.delete(NS, d)
            dedup, origin.dedup = origin.dedup, None
            off = [(await raw("GET", u))[0] for u in urls]
            origin.dedup = dedup
            await c.close()
            return stats, codes, similar, off, origin.dedup.stats()
        finally:
            await stop()

    stats, codes, similar, off, after = asyncio.run(main())
    assert stats["blobs"] == 1 and after["blobs"] == 0
    assert codes == [200, 404, 200] and similar == []
    assert off == [404, 404, 404]


def test_serve_while_ingest_publishes_from_the_spool_before_the_rename(tmp_path):
    blob = blob_of(5 * PIECE + 99, 14)
    d = Digest.from_bytes(blob)
    calls = []

    class Scheduler:
        def seed_partial(self, metainfo, ns, path):
            calls.append(("seed_partial", ns, os.path.dirname(path) == origin.store.upload_dir,
                          metainfo.serialize()))

        def promote_partial(self, digest, path):
            calls.append(("promote", digest == d, path == origin.store.cache_path(d)))

        def seed(self, metainfo, ns):
            calls.append(("seed", ns, metainfo.serialize()))

    origin = port_origin(tmp_path / "o", scheduler=Scheduler(), serve_while_ingest=True)

    async def main():
        addr, stop = await serve("port", origin)
        try:
            c = BlobClient(addr)
            await c.upload(NS, d, blob)
            await c.close()
        finally:
            await stop()

    asyncio.run(main())
    mi = reference_metainfo(blob)
    assert calls == [("seed_partial", NS, True, mi), ("promote", True, True), ("seed", NS, mi)]


@pytest.fixture
def traced():
    """Every span kept, in an empty flight recorder; returns a finder of
    the last recorded span of a name."""
    saved = trace.TRACER.config
    trace.TRACER.apply(trace.TraceConfig(sample_rate=1.0))
    trace.TRACER.recorder.clear()

    def last(name: str) -> dict:
        return [s for s in trace.TRACER.recorder.snapshot() if s["name"] == name][-1]

    yield last
    trace.TRACER.apply(saved)


@pytest.mark.parametrize("resume", [True, False], ids=["resume", "no-resume"])
def test_the_pipelines_ingest_config_sets_resume_and_serve_while_ingest(tmp_path, traced,
                                                                       resume):
    """``IngestConfig.resume`` and ``.serve_while_ingest`` reach the origin
    whose pipeline holds them, live through ``apply``, unless the caller
    pins them. After a failed PATCH a resuming origin re-adopts the journaled
    session by re-reading its spool, and the commit takes that digest; one
    with ``resume=False`` journals nothing and the commit re-reads the blob."""
    piece = 1024
    blob = blob_of(3 * (1 << 20) + 3000, 15)
    d = Digest.from_bytes(blob)
    cfg = IngestConfig(window_bytes=1 << 20, resume=resume)
    pipe = IngestPipeline(TorchPieceHasher(device="cpu"), cfg)
    origin = port_origin(tmp_path / "o", hasher=pipe.hasher, piece=piece, pipeline=pipe)
    assert (origin.resume_enabled, origin.serve_while_ingest) == (resume, False)
    journaled = []
    write_session = origin.store.write_upload_session
    origin.store.write_upload_session = lambda uid, doc: (
        journaled.append(doc["offset"]), write_session(uid, doc))

    async def main():
        addr, stop = await serve("port", origin)
        oc = BlobClient(addr, HTTPClient(retries=0))
        try:
            failpoints.FAILPOINTS.arm("origin.patch.write", "every:3+times:1")
            await oc.upload(NS, d, blob, chunk_size=1 << 20)
        finally:
            await oc.close()
            await stop()

    adopted0 = counter("upload_sessions_adopted_total")
    asyncio.run(main())
    assert origin.store.read_cache_file(d) == blob
    assert origin.generator.get_cached(d).serialize() == reference_metainfo(blob, piece)
    span = traced("origin.ingest.commit")
    if resume:
        assert journaled and counter("upload_sessions_adopted_total") == adopted0 + 1
        assert span["attrs"]["digest_from"] == "stream"
        assert span["attrs"]["replayed_bytes"] in journaled
        assert 0 < span["attrs"]["replayed_bytes"] < len(blob)
    else:
        assert not journaled and counter("upload_sessions_adopted_total") == adopted0
        assert (span["attrs"]["digest_from"], span["attrs"]["replayed_bytes"]) == ("reread", 0)
    pipe.apply(IngestConfig(window_bytes=1 << 20, resume=not resume, serve_while_ingest=True))
    assert (origin.resume_enabled, origin.serve_while_ingest) == (not resume, True)
    pinned = port_origin(tmp_path / "p", hasher=pipe.hasher, piece=piece, pipeline=pipe,
                         ingest_resume=resume, serve_while_ingest=False)
    assert (pinned.resume_enabled, pinned.serve_while_ingest) == (resume, False)
    assert (port_origin(tmp_path / "q").resume_enabled,
            port_origin(tmp_path / "q").serve_while_ingest) == (True, False)


def test_a_commit_with_tracing_off_answers_201(tmp_path):
    """With tracing off the commit's span is None; the commit still lands."""
    blob = blob_of(2 * PIECE + 5, 16)
    d = Digest.from_bytes(blob)
    saved = trace.TRACER.config
    trace.TRACER.apply(trace.TraceConfig(enabled=False))

    async def main():
        origin = port_origin(tmp_path / "o")
        addr, stop = await serve("port", origin)
        try:
            return await _upload(addr, d, [blob]), origin
        finally:
            await stop()

    try:
        (status, _), origin = asyncio.run(main())
    finally:
        trace.TRACER.apply(saved)
    assert status == 201 and origin.store.read_cache_file(d) == blob


def test_lameduck_refuses_new_uploads_and_fails_health(tmp_path):
    async def main():
        origin = port_origin(tmp_path / "o")
        addr, stop = await serve("port", origin)
        try:
            assert (await raw("GET", f"http://{addr}/health"))[0] == 200
            assert (await raw("POST", f"http://{addr}/debug/lameduck"))[0] == 200
            up = await raw("POST", f"http://{addr}/namespace/ns/blobs/{'ab' * 32}/uploads")
            return up, (await raw("GET", f"http://{addr}/health"))[0]
        finally:
            await stop()

    (status, headers, _), health = asyncio.run(main())
    assert status == 503 and headers["Retry-After"] == "5" and health == 503


def test_the_purge_loop_lives_in_cleanup_ctx(tmp_path):
    async def main():
        origin = port_origin(tmp_path / "o")
        addr, stop = await serve("port", origin)
        task = origin._purge_task
        assert task is not None and not task.done()
        c = BlobClient(addr)
        await c._start_upload(NS, Digest.from_bytes(b"x"))
        await c.close()
        assert len(origin._upload_digests) == 1
        origin.UPLOAD_DIGEST_TTL_SECONDS = 0.0
        before = counter("upload_digests_evicted_total", reason="ttl")
        origin.purge_upload_digests()
        assert origin._upload_digests == {}
        assert counter("upload_digests_evicted_total", reason="ttl") == before + 1
        await stop()
        await stop()
        return task

    task = asyncio.run(main())
    assert task.cancelled()


# -- the quorum plane, heal, refresh and writeback -------------------------------


async def _ring(tmp_path, n, quorum=None):
    """n port origins on one static full ring (every origin owns every
    digest), each with a retry manager whose poll the test drives."""
    ports = [free_port() for _ in range(n)]
    addrs = [f"127.0.0.1:{p}" for p in ports]
    nodes, stops = [], []
    for i in range(n):
        retry = RetryManager(TaskStore(str(tmp_path / f"retry{i}.db")))
        origin = port_origin(tmp_path / f"o{i}", retry=retry,
                             ring=Ring(HostList(static=addrs), max_replica=n),
                             self_addr=addrs[i], quorum=quorum if i == 0 else None)
        _addr, stop = await serve("port", origin, ports[i])
        nodes.append(origin)
        stops.append(stop)
    return nodes, addrs, stops


async def _stop(nodes, stops):
    for origin, stop in zip(nodes, stops):
        await stop()
        await origin.close_heal_cluster()
        origin.retry.close()


def test_quorum_acks_after_a_replica_holds_the_blob_then_hints_and_replays(tmp_path):
    q = QuorumConfig(write_quorum=2, push_timeout_seconds=10.0)
    a, b = blob_of(300_000, 15), blob_of(200_000, 16)
    da, db = Digest.from_bytes(a), Digest.from_bytes(b)

    async def main():
        nodes, addrs, stops = await _ring(tmp_path, 3, q)
        try:
            # Replica 2 partitioned at the push: replica 1 is the quorum copy.
            failpoints.FAILPOINTS.arm(f"origin.quorum.replica.partition@{addrs[2]}", "always")
            before_q = counter("origin_quorum_writes_total", outcome="quorum")
            c = BlobClient(addrs[0])
            await c.upload(NS, da, a)
            assert nodes[1].store.in_cache(da) and not nodes[2].store.in_cache(da)
            assert counter("origin_quorum_writes_total", outcome="quorum") == before_q + 1
            assert (nodes[1].generator.get_cached(da).serialize()
                    == nodes[0].generator.get_cached(da).serialize())
            # Replica 2 is hinted only if the walk reached it before the
            # quorum was met (the ring's order of the two replicas).
            hinted_a = nodes[0].retry.store.count_pending(HINT_KIND, f"{da.hex}:")
            assert hinted_a in (0, 1)
            # Read-repair: replica 2 misses, restores from a sibling, serves.
            failpoints.FAILPOINTS.disarm_all()
            before_rr = counter("origin_read_repairs_total")
            c2 = BlobClient(addrs[2])
            assert await c2.download(NS, da) == a
            assert counter("origin_read_repairs_total") == before_rr + 1
            # Every replica partitioned: the commit still acks, via hints.
            failpoints.FAILPOINTS.arm("origin.quorum.replica.partition", "always")
            before_h = counter("origin_quorum_writes_total", outcome="hinted")
            before_j = counter("origin_hints_total", state="journaled")
            before_r = counter("origin_hints_total", state="replayed")
            await c.upload(NS, db, b)
            assert counter("origin_quorum_writes_total", outcome="hinted") == before_h + 1
            assert counter("origin_hints_total", state="journaled") == before_j + 2
            assert nodes[0].retry.store.count_pending(HINT_KIND, f"{db.hex}:") == 2
            assert not nodes[1].store.in_cache(db) and not nodes[2].store.in_cache(db)
            failpoints.FAILPOINTS.disarm_all()
            await nodes[0].retry.run_once()
            assert counter("origin_hints_total", state="replayed") == before_r + 2 + hinted_a
            assert nodes[0].retry.store.count_pending(HINT_KIND, f"{db.hex}:") == 0
            out = [await BlobClient(x).download(NS, db) for x in addrs[1:]]
            await c.close()
            await c2.close()
            return out
        finally:
            await _stop(nodes, stops)

    assert asyncio.run(main()) == [b, b]


def test_heal_restores_a_quarantined_blob_from_a_ring_replica(tmp_path):
    blob = blob_of(100_000, 17)
    d = Digest.from_bytes(blob)

    def rot(path):
        with open(path, "r+b") as f:
            f.write(b"\xff\xfe")  # rot at rest

    async def main():
        nodes, addrs, stops = await _ring(tmp_path, 2)
        try:
            c = BlobClient(addrs[0])
            await c.upload(NS, d, blob)
            await c.close()
            await nodes[0].retry.run_once()  # async replication to node 1
            assert nodes[1].store.read_cache_file(d) == blob
            await asyncio.to_thread(rot, nodes[0].store.cache_path(d))
            assert nodes[0].store.quarantine_cache_file(d) is not None
            assert nodes[0].enqueue_heal(NS, d)
            before = counter("blob_heals_total", source="ring")
            await nodes[0].retry.run_once()
            assert counter("blob_heals_total", source="ring") == before + 1
            return nodes[0].store.read_cache_file(d), nodes[0].store.list_quarantined()
        finally:
            await _stop(nodes, stops)

    healed, quarantined = asyncio.run(main())
    assert healed == blob and quarantined == [d.hex]


def test_refresh_pulls_a_backend_only_blob_and_writeback_lands_in_the_jax_layout(tmp_path):
    """A blob that exists only in a ``file`` backend (written by the JAX
    backend) is pulled on a GET miss, its metainfo made, and served; an
    uploaded blob is written back to the backend, where the JAX backend
    reads it."""
    import kraken_tpu.backend.base as jax_backend

    root = str(tmp_path / "backend")
    cfg = {"root": root, "pather": "sharded_docker_blob"}
    cold = blob_of(150_000, 18)
    warm = blob_of(120_000, 19)
    dc, dw = Digest.from_bytes(cold), Digest.from_bytes(warm)

    async def main():
        jb = jax_backend.make_backend("file", cfg)
        await jb.upload(NS, dc.hex, cold)
        backends = BackendManager([{"namespace": "ns/.*", "backend": "file", "config": cfg}])
        retry = RetryManager(TaskStore(":memory:"))
        origin = port_origin(tmp_path / "o", retry=retry)
        origin.refresher = Refresher(origin.store, backends, origin.generator)
        origin.writeback = WritebackExecutor(origin.store, backends, retry)
        addr, stop = await serve("port", origin)
        try:
            c = BlobClient(addr)
            assert (await c.stat(NS, dc)).size == len(cold)  # backend stat, no pull
            assert await c.stat(NS, dc, local_only=True) is None
            got = await c.download(NS, dc)
            mi = (await c.get_metainfo(NS, dc)).serialize()
            await c.upload(NS, dw, warm)
            assert origin.store.get_metadata(dw, PersistMetadata).reasons == {"writeback"}
            assert await retry.run_once() == 1
            back = await jb.download(NS, dw.hex)
            pins = origin.store.get_metadata(dw, PersistMetadata).reasons
            await c.close()
            return got, mi, back, pins
        finally:
            await stop()
            retry.close()

    got, mi, back, pins = asyncio.run(main())
    assert got == cold and mi == reference_metainfo(cold)
    assert back == warm and pins == set()


def test_the_tracker_proxies_metainfo_from_a_port_origin(tmp_path):
    blob = blob_of(200_000, 20)
    d = Digest.from_bytes(blob)

    async def main():
        origin = port_origin(tmp_path / "o")
        addr, stop = await serve("port", origin)
        cluster = ClusterClient(Ring(HostList(static=[addr]), max_replica=1))
        tracker = TrackerServer(origin_cluster=cluster, announce_interval_seconds=0.1)
        runner, tport = await http_lite.serve(tracker.make_app(), "127.0.0.1", 0)
        client = make_tracker_client(f"127.0.0.1:{tport}", PeerID("a" * 40), "127.0.0.1", 7000)
        try:
            c = BlobClient(addr)
            await c.upload(NS, d, blob)
            await c.close()
            got = (await client.get(NS, d)).serialize()
            missing = await raw("GET", f"http://127.0.0.1:{tport}/namespace/ns/blobs/"
                                        f"{'cd' * 32}/metainfo")
        finally:
            await client.close()
            await runner.cleanup()
            await tracker.close()
            await cluster.close()
            await stop()
        return got, missing[0]

    got, missing = asyncio.run(main())
    assert got == reference_metainfo(blob) and missing == 404
