"""The port stands alone: ``kraken_tpu_torch`` (and ``chip_smoke.py``)
import nothing of JAX or ``kraken_tpu``, nor ``msgpack``, ``yaml`` or
``aiohttp``, which the card machine lacks, and its entry points go to the
card unless the caller asks for the CPU."""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import kraken_tpu_torch as kt
import kraken_tpu_torch.core.hasher as hasher_mod
from kraken_tpu_torch.bench.transpose import decompose
from kraken_tpu_torch.origin.dedup import ChunkRouter

REPO = Path(__file__).resolve().parent.parent


FORBIDDEN = ("jax", "jaxlib", "kraken_tpu", "msgpack", "yaml", "aiohttp")


def _is_forbidden(module: str) -> bool:
    return module.split(".")[0] in FORBIDDEN


def _imports(path: Path) -> list[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    found = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            found += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            found.append(node.module)
    return found


def test_no_module_of_the_port_imports_jax_or_kraken_tpu():
    files = sorted((REPO / "kraken_tpu_torch").rglob("*.py")) + [
        REPO / "chip_smoke.py", REPO / "chip_sha256_sweep.py", REPO / "chip_transpose_sweep.py",
    ]
    assert len(files) > 10
    scanned = {str(f.relative_to(REPO)) for f in files}
    for module in ("utils/http_lite.py", "utils/httputil.py", "utils/deadline.py",
                   "utils/lameduck.py", "placement/hrw.py", "placement/hostlist.py",
                   "placement/hashring.py", "placement/healthcheck.py",
                   "placement/replicawalk.py", "tracker/peerhandout.py",
                   "tracker/peerstore.py", "tracker/server.py", "tracker/client.py",
                   "backend/__init__.py", "backend/base.py", "backend/namepath.py",
                   "backend/filebackend.py", "backend/testfs.py",
                   "persistedretry/__init__.py", "persistedretry/manager.py",
                   "store/castore.py", "store/metadata.py", "store/serve.py",
                   "origin/client.py", "origin/blobrefresh.py", "origin/writeback.py",
                   "origin/server.py", "core/ingest.py", "utils/yaml_lite.py",
                   "configutil.py", "utils/structlog.py", "store/cleanup.py",
                   "store/recovery.py", "store/scrub.py", "utils/profiler.py",
                   "utils/resources.py", "utils/canary.py", "p2p/delta.py",
                   "store/chunkstore.py", "agent/server.py", "utils/metrics.py",
                   "assembly.py", "cli.py", "dockerregistry/__init__.py",
                   "dockerregistry/errors.py", "dockerregistry/transfer.py",
                   "dockerregistry/registry.py", "buildindex/__init__.py",
                   "buildindex/tagtype.py", "buildindex/tagstore.py",
                   "buildindex/server.py", "utils/sanitize.py", "utils/promgen.py",
                   "p2p/shardpool.py", "core/fixtures.py", "backend/httpbackend.py",
                   "backend/shadowbackend.py", "backend/s3backend.py",
                   "backend/hdfsbackend.py", "backend/registrybackend.py",
                   "lint/__init__.py", "lint/findings.py", "lint/pragmas.py",
                   "lint/rules.py", "lint/project.py", "lint/engine.py", "p2p/sim.py",
                   "parallel/__init__.py", "parallel/mesh.py", "parallel/hashplane.py",
                   "parallel/dryrun.py", "parallel/multihost.py"):
        assert f"kraken_tpu_torch/{module}" in scanned, module
    bad = {
        str(f.relative_to(REPO)): m
        for f in files for m in _imports(f) if _is_forbidden(m)
    }
    assert bad == {}


def _module_file(name: str) -> Path | None:
    """The port's source file of module ``name`` (a package's
    ``__init__.py``), or None outside the port."""
    if name.split(".")[0] != "kraken_tpu_torch":
        return None
    base = REPO.joinpath(*name.split("."))
    for path in (base.with_suffix(".py"), base / "__init__.py"):
        if path.is_file():
            return path
    return None


def _named_imports(nodes) -> list[str]:
    """Modules the import statements among ``nodes`` name, at any depth
    of those nodes; ``from pkg import x`` names ``pkg.x`` when it is a
    module of the port."""
    found = []
    for top in nodes:
        for node in ast.walk(top):
            if isinstance(node, ast.Import):
                found += [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
                found.append(node.module)
                found += [f"{node.module}.{a.name}" for a in node.names
                          if _module_file(f"{node.module}.{a.name}") is not None]
    return found


def _load_time_imports(path: Path) -> list[str]:
    """What importing ``path`` imports: its statements outside any def
    (a function's own imports run only when it is called)."""
    tree = ast.parse(path.read_text(), filename=str(path))
    out, stack = [], list(tree.body)
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            out += _named_imports([node])
        else:
            stack.extend(ast.iter_child_nodes(node))
    return out


def _import_closure(roots: list[str]) -> set[str]:
    """Every module reached from ``roots`` through the port's modules'
    load-time imports, with the parent packages of each port module. The
    top package's ``__init__`` is not followed: it re-exports the hasher
    (and so imports torch), and a forked worker inherits it already
    imported from its node, so nothing in it runs in the worker."""
    seen: set[str] = set()
    todo = list(roots)
    while todo:
        name = todo.pop()
        if name in seen:
            continue
        seen.add(name)
        path = _module_file(name)
        if path is None or name == "kraken_tpu_torch":
            continue
        parts = name.split(".")
        todo += [".".join(parts[:i]) for i in range(2, len(parts))]
        todo += _load_time_imports(path)
    return seen


def _worker_half_imports() -> list[str]:
    """The imports of ``p2p/shardpool.py``'s worker half: its load-time
    imports and every import inside a def or class above the "Parent
    side" marker."""
    path = REPO / "kraken_tpu_torch/p2p/shardpool.py"
    src = path.read_text()
    marker = src[: src.index("# Parent side")].count("\n") + 1
    tree = ast.parse(src, filename=str(path))
    worker = [n for n in tree.body if n.lineno < marker
              and isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef))]
    return _load_time_imports(path) + _named_imports(worker)


def test_the_shardpool_worker_half_reaches_neither_torch_nor_the_kernels():
    """A worker is forked from a node whose CUDA context is live; torch
    marks such a child a bad fork and any ``torch.cuda`` call there
    raises. So nothing the worker half imports, at any depth of the
    port's module imports, is ``torch`` or ``kraken_tpu_torch.ops``."""
    reached = _import_closure(_worker_half_imports())
    for module in ("kraken_tpu_torch.p2p.wire", "kraken_tpu_torch.utils.msgpack_lite",
                   "kraken_tpu_torch.utils.bufpool", "kraken_tpu_torch.utils.failpoints",
                   "kraken_tpu_torch.utils.trace", "kraken_tpu_torch.utils.profiler",
                   "kraken_tpu_torch.utils.metrics"):
        assert module in reached, module
    bad = sorted(m for m in reached if m.split(".")[0] == "torch"
                 or m == "kraken_tpu_torch.ops" or m.startswith("kraken_tpu_torch.ops."))
    assert bad == []
    # The walk sees torch where it is: the hasher's module imports it.
    assert "torch" in _import_closure(["kraken_tpu_torch.ops.sha256"])


_SLICE = r"""
import asyncio, json, sys, tempfile
import kraken_tpu_torch as kt
import kraken_tpu_torch.core.hasher as hasher_mod
import kraken_tpu_torch.core.ingest
import kraken_tpu_torch.native
import kraken_tpu_torch.utils.failpoints
import kraken_tpu_torch.core.peer
import kraken_tpu_torch.p2p.announcequeue
import kraken_tpu_torch.p2p.conn
import kraken_tpu_torch.p2p.connstate
import kraken_tpu_torch.p2p.dispatch
import kraken_tpu_torch.p2p.networkevent
import kraken_tpu_torch.p2p.pex
import kraken_tpu_torch.p2p.piecerequest
import kraken_tpu_torch.p2p.scheduler
import kraken_tpu_torch.p2p.wire
import kraken_tpu_torch.utils.backoff
import kraken_tpu_torch.utils.bandwidth
import kraken_tpu_torch.utils.dedup
import kraken_tpu_torch.utils.msgpack_lite
import kraken_tpu_torch.utils.profiler
import kraken_tpu_torch.utils.slo
import kraken_tpu_torch.utils.trace
import kraken_tpu_torch.placement
import kraken_tpu_torch.placement.replicawalk
from kraken_tpu_torch.core.peer import PeerID, PeerInfo
from kraken_tpu_torch.tracker.client import make_tracker_client
from kraken_tpu_torch.tracker.server import TrackerServer
from kraken_tpu_torch.utils import http_lite
from kraken_tpu_torch.p2p.scheduler import Scheduler, SchedulerConfig

blob = bytes(range(256)) * 41
d = kt.Digest.from_bytes(blob)
h = kt.TorchPieceHasher(device="cpu")
with tempfile.TemporaryDirectory() as root:
    o = kt.CAStore(root + "/o")
    uid = o.create_upload()
    o.write_upload_chunk(uid, 0, blob)
    o.commit_upload(uid, d)
    mi = kt.Generator(o, hasher=h, piece_lengths=kt.PieceLengthConfig(((0, 2048),))).generate_sync(d)
    mi = kt.MetaInfo.deserialize(mi.serialize())
    v = kt.BatchedVerifier(h)
    seed = kt.OriginTorrentArchive(o, v).create_torrent(mi)
    a = kt.CAStore(root + "/a")
    leech = kt.AgentTorrentArchive(a, v).create_torrent(mi)

    async def pull():
        await asyncio.gather(*(leech.write_piece(i, seed.read_piece(i)) for i in range(mi.num_pieces)))

    asyncio.run(pull())
    assert a.read_cache_file(d) == blob
    # The pipelined ingest plane: one packed window (a 1024-piece tile),
    # host-packed, then a ragged tail.
    blob2 = bytes(range(256)) * (4 * 1024) + b"tail"
    d2 = kt.Digest.from_bytes(blob2)
    uid = o.create_upload()
    o.write_upload_chunk(uid, 0, blob2)
    o.commit_upload(uid, d2)
    pipe = kt.IngestPipeline(h, kt.IngestConfig(window_bytes=1 << 20, pack_mode="native"))
    mi2 = kt.Generator(o, piece_lengths=kt.PieceLengthConfig(((0, 1024),)), pipeline=pipe).generate_sync(d2)
    assert mi2.piece_hashes == kt.CPUPieceHasher().hash_pieces(blob2, 1024).tobytes()
    # The dedup plane: chunk, fingerprint, sketch, index.
    index = kt.DedupIndex(o, hasher=kt.CPUPieceHasher(), params=kt.CDCParams(64, 256, 1024), device="cpu")
    record = index.add_blob_sync(d2)
    assert index.similar(d2) == [] and index.stats()["blobs"] == 1
    # The chunk tier: the indexed blob converted to manifest and chunks,
    # read back through the composed reader.
    import kraken_tpu_torch.p2p.delta
    from kraken_tpu_torch.store.chunkstore import ChunkStore, ChunkStoreConfig
    o.attach_chunkstore(ChunkStore(root + "/o/chunks", ChunkStoreConfig(enabled=True),
                                   quarantine_dir=o.quarantine_dir))
    assert o.convert_to_chunks(d2, *index.chunk_table(d2)) is not None
    assert o.is_chunked(d2) and o.read_cache_file(d2) == blob2
    # The swarm: a port seeder and leecher over loopback, frames through
    # the port's own msgpack codec.
    peers = {}

    class Tracker:
        async def get(self, namespace, digest):
            return mi

        async def announce(self, digest, h, namespace, complete):
            return [p for p in peers.values() if p.port], 0.1

    def peer(name, archive):
        s = Scheduler(PeerID(name * 40), "127.0.0.1", 0, archive, Tracker(), Tracker(),
                      config=SchedulerConfig(announce_interval_seconds=0.1))
        return s

    async def swarm():
        a2 = kt.CAStore(root + "/a2")
        seeder = peer("1", kt.OriginTorrentArchive(o, v))
        leecher = peer("2", kt.AgentTorrentArchive(a2, v))
        await seeder.start()
        await leecher.start()
        peers["s"] = PeerInfo(seeder.peer_id, "127.0.0.1", seeder.port)
        try:
            seeder.seed(mi, "ns")
            await asyncio.wait_for(leecher.download("ns", d), 30)
        finally:
            await seeder.stop()
            await leecher.stop()
        return a2.read_cache_file(d)

    assert asyncio.run(swarm()) == blob

    # The tracker fleet over the port's HTTP/1.1: two trackers, one fleet
    # client announcing and fetching metainfo through the proxy.
    class Origin:
        async def get_metainfo(self, namespace, digest):
            return mi

    async def fleet():
        servers, runners, addrs = [], [], []
        for _ in range(2):
            server = TrackerServer(origin_cluster=Origin(), announce_interval_seconds=0.1)
            runner, port = await http_lite.serve(server.make_app(), "127.0.0.1", 0)
            servers.append(server)
            runners.append(runner)
            addrs.append(f"127.0.0.1:{port}")
        clients = [make_tracker_client(",".join(addrs), PeerID(c * 40), "127.0.0.1", 7000 + i)
                   for i, c in enumerate("ab")]
        try:
            for c in clients:
                peers, _ = await c.announce(d, mi.info_hash, "ns", False)
            got = await clients[0].get("ns", d)
        finally:
            for c in clients:
                await c.close()
            for runner, server in zip(runners, servers):
                await runner.cleanup()
                await server.close()
        return len(peers), got.serialize() == mi.serialize()

    handout, same_metainfo = asyncio.run(fleet())
    assert same_metainfo

    # The origin over the port's HTTP/1.1: an upload through the port's
    # BlobClient, its metainfo read back through the ClusterClient.
    from kraken_tpu_torch.origin.client import BlobClient, ClusterClient
    from kraken_tpu_torch.origin.server import OriginServer
    from kraken_tpu_torch.placement import HostList, Ring

    async def origin():
        server = OriginServer(o, kt.Generator(o, hasher=kt.CPUPieceHasher(),
                                              piece_lengths=kt.PieceLengthConfig(((0, 2048),))))
        runner, port = await http_lite.serve(server.make_app(), "127.0.0.1", 0)
        addr = f"127.0.0.1:{port}"
        blob3 = blob + b"origin"
        d3 = kt.Digest.from_bytes(blob3)
        client, cluster = BlobClient(addr), ClusterClient(Ring(HostList(static=[addr])))
        try:
            await client.upload("ns", d3, blob3, chunk_size=4096)
            got = await cluster.get_metainfo("ns", d3)
            back = await client.download("ns", d3)
        finally:
            await client.close()
            await cluster.close()
            await runner.cleanup()
        return got.num_pieces, back == blob3

    origin_pieces, origin_ok = asyncio.run(origin())
    assert origin_ok
mods = [m for m in sys.modules
        if m.split(".")[0] in ("jax", "jaxlib", "kraken_tpu", "msgpack", "yaml", "aiohttp")]
print(json.dumps({"pieces": mi.num_pieces, "ingest_pieces": mi2.num_pieces,
                  "chunks": int(record.fps.size), "handout": handout,
                  "origin_pieces": origin_pieces, "forbidden": mods}))
"""


def test_slice_runs_without_jax_or_kraken_tpu_loaded():
    # A fresh interpreter: this test process has jax loaded by conftest.
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    r = subprocess.run(
        [sys.executable, "-c", _SLICE], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert r.returncode == 0, r.stderr
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["chunks"] > 1000
    assert out == {"pieces": 6, "ingest_pieces": 1025, "chunks": out["chunks"], "handout": 1,
                   "origin_pieces": 6, "forbidden": []}


_CLI_CHILD = r"""
import asyncio, json, sys
import kraken_tpu_torch.cli as cli

async def boot(node, describe, config_path=None):
    await node.start()
    await node.stop()

cli._run_until_signal = boot
cli.main(sys.argv[1:])
bad = sorted(m for m in sys.modules if m.split(".")[0] in
             ("jax", "jaxlib", "kraken_tpu", "msgpack", "yaml", "aiohttp"))
from kraken_tpu_torch.ops import cuda_lib
import torch
print(json.dumps({"forbidden": bad, "port": "kraken_tpu_torch.assembly" in sys.modules,
                  "card": cuda_lib._lib is not None or torch.cuda.is_initialized()}))
"""

# The build-index and the proxy ship only a base file; their peers come
# from flags, as the reference's herd gives them.
CLI_ARGS = {
    "build-index": ["--config", str(REPO / "config/build-index/base.yaml"),
                    "--origins", "127.0.0.1:1"],
    "proxy": ["--config", str(REPO / "config/proxy/base.yaml"), "--origins", "127.0.0.1:1",
              "--build-index", "127.0.0.1:1"],
}


@pytest.mark.parametrize("component", ["tracker", "origin", "agent", "build-index", "proxy"])
def test_a_cli_node_loads_none_of_the_forbidden_packages(tmp_path, component):
    """What ``python -m kraken_tpu_torch.cli <component>`` runs -- the
    config read, the node built from the shipped development file (the
    base file for the build-index and the proxy), started and stopped --
    in a fresh interpreter, then its ``sys.modules``; no node here loads
    the kernel library or makes a CUDA context (the build-index and the
    proxy never do)."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    args = CLI_ARGS.get(component, [
        "--config", str(REPO / "config" / component / "development.yaml")]) + ["--port", "0"]
    if component in ("origin", "agent"):
        args += ["--p2p-port", "0", "--tracker", "127.0.0.1:1"]
    if component != "tracker" and component != "proxy":
        args += ["--store", str(tmp_path / "s")]
    r = subprocess.run(
        [sys.executable, "-c", _CLI_CHILD, component, *args], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert r.returncode == 0, r.stderr[-3000:]
    assert json.loads(r.stdout.strip().splitlines()[-1]) == {"forbidden": [], "port": True,
                                                             "card": False}


def test_entry_points_need_the_card_unless_asked_for_the_cpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        kt.TorchPieceHasher()
    with pytest.raises(RuntimeError, match="CUDA"):
        kt.get_hasher("cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        kt.Generator(kt.CAStore(str(tmp_path)))
    with pytest.raises(RuntimeError, match="CUDA"):
        kt.BatchedVerifier()
    with pytest.raises(RuntimeError, match="CUDA"):
        kt.AgentTorrentArchive(kt.CAStore(str(tmp_path)))
    store = kt.CAStore(str(tmp_path))
    params = kt.CDCParams(64, 256, 1024)
    for entry in (
        lambda: kt.chunk(b"x" * 300, params),
        lambda: kt.chunk_spans(b"", params),
        lambda: ChunkRouter(params),
        lambda: kt.MinHasher(),
        lambda: kt.DedupIndex(store),
        lambda: kt.DedupIndex(store, hasher=kt.CPUPieceHasher()),
        lambda: decompose(1, 512),
    ):
        with pytest.raises(RuntimeError, match="CUDA"):
            entry()
    assert kt.TorchPieceHasher(device="cpu").device == torch.device("cpu")
    assert kt.chunk(b"x" * 300, params, device="cpu") == [300]
    assert ChunkRouter(params, device="cpu").device == torch.device("cpu")
    assert kt.MinHasher(device="cpu").device == torch.device("cpu")
    index = kt.DedupIndex(store, device="cpu")
    assert index.hasher.name == "cuda" and index.hasher.device == torch.device("cpu")


def test_the_parallel_plane_needs_the_card_unless_asked_for_the_cpu(monkeypatch):
    from kraken_tpu_torch.parallel import ShardedPieceHasher, piece_mesh
    from kraken_tpu_torch.parallel.multihost import multihost_hash_pieces

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(hasher_mod, "_INSTANCES", {})
    for entry in (
        piece_mesh,
        ShardedPieceHasher,
        lambda: kt.get_hasher("cuda-sharded"),
        lambda: multihost_hash_pieces(np.zeros((2, 64), dtype=np.uint8), 64),
    ):
        with pytest.raises(RuntimeError, match="CUDA.*platform='cpu'"):
            entry()
    hasher = ShardedPieceHasher(piece_mesh(2, platform="cpu"))
    assert hasher.device == torch.device("cpu") and hasher.mesh.size == 2


def test_the_agent_archive_verifies_on_the_card_by_default(monkeypatch, tmp_path):
    """With no verifier, ``AgentTorrentArchive`` builds ``BatchedVerifier()``,
    whose hasher is the ``cuda`` one."""
    made = []

    class Probe(kt.TorchPieceHasher):
        def __init__(self):
            super().__init__(device="cpu")
            made.append(self)

    monkeypatch.setattr(hasher_mod, "_INSTANCES", {})
    monkeypatch.setitem(hasher_mod._REGISTRY, "cuda", Probe)
    archive = kt.AgentTorrentArchive(kt.CAStore(str(tmp_path)))
    assert made and archive.verifier.hasher is made[0]
    assert archive.verifier.hasher.name == "cuda"
    assert archive.verifier._path_label == "cuda"


def test_a_card_origin_does_not_piece_hash_with_hashlib_unless_asked(monkeypatch, tmp_path):
    """``OriginServer`` on a ``cuda`` generator (the kernels' plain versions
    here) hashes no piece with hashlib at stream time: its metainfo comes
    from one batched pass of the ``cuda`` hasher at commit. Asked for
    (``stream_piece_hash=True``), it does hash with hashlib."""
    import asyncio

    from kraken_tpu_torch.origin.client import BlobClient
    from kraken_tpu_torch.origin.server import OriginServer
    from kraken_tpu_torch.utils import http_lite

    blob = bytes(range(256)) * 40 + b"tail"
    d = kt.Digest.from_bytes(blob)
    card_calls = []
    hashlib_pieces = []
    hasher = kt.TorchPieceHasher(device="cpu")
    orig_hash_pieces = hasher.hash_pieces
    monkeypatch.setattr(hasher, "hash_pieces",
                        lambda data, plen: card_calls.append(len(data)) or orig_hash_pieces(data, plen))
    import kraken_tpu_torch.origin.server as server_mod

    real = server_mod.record_hash_metrics
    monkeypatch.setattr(server_mod, "record_hash_metrics",
                        lambda name, *a: hashlib_pieces.append(name) or real(name, *a))

    def upload(root, **kw):
        store = kt.CAStore(str(tmp_path / root))
        gen = kt.Generator(store, hasher=hasher, piece_lengths=kt.PieceLengthConfig(((0, 2048),)))
        server = OriginServer(store, gen, **kw)

        async def main():
            runner, port = await http_lite.serve(server.make_app(), "127.0.0.1", 0)
            client = BlobClient(f"127.0.0.1:{port}")
            try:
                await client.upload("ns", d, blob, chunk_size=3000)
            finally:
                await client.close()
                await runner.cleanup()

        asyncio.run(main())
        return server, gen.get_cached(d)

    server, mi = upload("card")
    assert server._stream_piece_length == 0
    assert card_calls == [len(blob)] and hashlib_pieces == []
    assert mi.piece_hashes == kt.CPUPieceHasher().hash_pieces(blob, 2048).tobytes()
    card_calls.clear()
    server, mi2 = upload("asked", stream_piece_hash=True)
    assert server._stream_piece_length == 2048
    assert card_calls == [] and hashlib_pieces == ["cpu"]
    assert mi2.serialize() == mi.serialize()


def test_a_card_origins_dedup_and_chunk_conversion_hash_no_piece_with_hashlib(monkeypatch, tmp_path):
    """A ``cuda`` origin (the kernels' plain versions here) with the chunk
    tier on: the upload's pieces and the dedup pass's chunk fingerprints
    go through the ``cuda`` hasher, and the only chunk-level hashlib is
    the reference's own -- ``ChunkStore``'s check of each new chunk before
    its rename (``_fp_of``), once a chunk. No piece hash runs through
    hashlib (``CPUPieceHasher``, the ingest reroute, the stream-time piece
    hash, ``verify_piece``)."""
    import asyncio
    import hashlib

    from kraken_tpu_torch.ops.cdc import CDCParams
    from kraken_tpu_torch.origin.client import BlobClient
    from kraken_tpu_torch.origin.dedup import DedupIndex
    from kraken_tpu_torch.origin.server import OriginServer
    from kraken_tpu_torch.store.chunkstore import ChunkStore, ChunkStoreConfig
    from kraken_tpu_torch.utils import http_lite

    calls = []
    real = hashlib.sha256

    def counted(*a, **kw):
        f = sys._getframe(1)
        calls.append((f.f_globals.get("__name__"), f.f_code.co_name))
        return real(*a, **kw)

    rows = []
    hasher = kt.TorchPieceHasher(device="cpu")
    orig_batch = hasher.hash_batch
    monkeypatch.setattr(hasher, "hash_batch", lambda items: rows.append(len(items)) or orig_batch(items))
    piece_calls = []
    orig_pieces = hasher.hash_pieces
    monkeypatch.setattr(hasher, "hash_pieces",
                        lambda data, plen: piece_calls.append(len(data)) or orig_pieces(data, plen))
    store = kt.CAStore(str(tmp_path / "o"))
    store.attach_chunkstore(ChunkStore(str(tmp_path / "o" / "chunks"),
                                       ChunkStoreConfig(enabled=True, min_blob_bytes=1),
                                       quarantine_dir=store.quarantine_dir))
    dedup = DedupIndex(store, hasher=hasher, params=CDCParams(256, 1024, 4096), device="cpu")
    gen = kt.Generator(store, hasher=hasher, piece_lengths=kt.PieceLengthConfig(((0, 4096),)))
    server = OriginServer(store, gen, dedup=dedup)
    blob = bytes(np.random.default_rng(5).integers(0, 256, 24_000, dtype=np.uint8))
    d = kt.Digest.from_bytes(blob)

    async def main():
        runner, port = await http_lite.serve(server.make_app(), "127.0.0.1", 0)
        client = BlobClient(f"127.0.0.1:{port}")
        try:
            monkeypatch.setattr(hashlib, "sha256", counted)
            await client.upload("ns", d, blob, chunk_size=5000)
            await asyncio.gather(*server._dedup_tasks)
        finally:
            monkeypatch.setattr(hashlib, "sha256", real)
            await client.close()
            await runner.cleanup()

    asyncio.run(main())
    assert store.is_chunked(d) and store.read_cache_file(d) == blob
    md = store.manifest(d)
    assert piece_calls == [len(blob)]  # the pieces, in one batched pass at commit
    assert rows == [len(md.fps)]  # the chunk fingerprints, in one batch
    piece_sites = {"kraken_tpu_torch.core.hasher", "kraken_tpu_torch.core.ingest"}
    assert not [c for c in calls if c[0] in piece_sites or c[1] == "verify_piece"], calls
    chunk_calls = [c for c in calls if c[1] in ("_fp_of", "chunk_fp")]
    assert chunk_calls == [("kraken_tpu_torch.store.chunkstore", "_fp_of")] * len(set(md.fps))


def test_a_card_origins_refresh_hashes_no_piece_with_hashlib(monkeypatch, tmp_path):
    """A ``cuda`` origin (the kernels' plain versions here) that fills a
    miss from its backend (``blobrefresh.Refresher``: the download, the
    commit's whole-blob digest, then ``Generator.generate``) hashes every
    piece in one batched pass of the ``cuda`` hasher, and none with
    hashlib: the commit's digest check is the only SHA-256 on the host."""
    import asyncio
    import hashlib

    from kraken_tpu_torch.backend import Manager
    from kraken_tpu_torch.origin.blobrefresh import Refresher
    from kraken_tpu_torch.origin.server import OriginServer
    from kraken_tpu_torch.utils import http_lite

    blob = bytes(np.random.default_rng(9).integers(0, 256, 9_000, dtype=np.uint8))
    d = kt.Digest.from_bytes(blob)
    backend_root = tmp_path / "backend"
    backends = Manager([{"namespace": ".*", "backend": "file",
                         "config": {"root": str(backend_root)}}])
    asyncio.run(backends.get_client("ns").upload("ns", d.hex, blob))
    hasher = kt.TorchPieceHasher(device="cpu")
    card_calls = []
    orig = hasher.hash_pieces
    monkeypatch.setattr(hasher, "hash_pieces",
                        lambda data, plen: card_calls.append(len(data)) or orig(data, plen))
    calls = []
    real = hashlib.sha256

    def counted(*a, **kw):
        f = sys._getframe(1)
        calls.append((f.f_globals.get("__name__"), f.f_code.co_name))
        return real(*a, **kw)

    store = kt.CAStore(str(tmp_path / "o"))
    gen = kt.Generator(store, hasher=hasher, piece_lengths=kt.PieceLengthConfig(((0, 2048),)))
    server = OriginServer(store, gen, Refresher(store, backends, gen))

    async def main():
        runner, port = await http_lite.serve(server.make_app(), "127.0.0.1", 0)
        try:
            async with http_lite.ClientSession() as s:
                monkeypatch.setattr(hashlib, "sha256", counted)
                async with s.get(f"http://127.0.0.1:{port}/namespace/ns/blobs/{d.hex}/metainfo") as r:
                    body = await r.read()
                    assert r.status == 200, body
        finally:
            monkeypatch.setattr(hashlib, "sha256", real)
            await runner.cleanup()
            await backends.close()

    asyncio.run(main())
    assert store.read_cache_file(d) == blob
    assert card_calls == [len(blob)]
    assert gen.get_cached(d).piece_hashes == kt.CPUPieceHasher().hash_pieces(blob, 2048).tobytes()
    piece_sites = {"kraken_tpu_torch.core.hasher", "kraken_tpu_torch.core.ingest"}
    assert not [c for c in calls if c[0] in piece_sites or c[1] == "verify_piece"], calls
