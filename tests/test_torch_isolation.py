"""The port stands alone: ``kraken_tpu_torch`` (and ``chip_smoke.py``)
import nothing of JAX or ``kraken_tpu``, and its entry points go to the
card unless the caller asks for the CPU."""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import kraken_tpu_torch as kt
from kraken_tpu_torch.bench.transpose import decompose
from kraken_tpu_torch.origin.dedup import ChunkRouter

REPO = Path(__file__).resolve().parent.parent


def _is_forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "kraken_tpu")


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
        REPO / "chip_smoke.py", REPO / "chip_sha256_sweep.py",
    ]
    assert len(files) > 10
    bad = {
        str(f.relative_to(REPO)): m
        for f in files for m in _imports(f) if _is_forbidden(m)
    }
    assert bad == {}


_SLICE = r"""
import asyncio, json, sys, tempfile
import kraken_tpu_torch as kt
import kraken_tpu_torch.core.ingest
import kraken_tpu_torch.native
import kraken_tpu_torch.utils.failpoints

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
mods = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "kraken_tpu")]
print(json.dumps({"pieces": mi.num_pieces, "ingest_pieces": mi2.num_pieces,
                  "chunks": int(record.fps.size), "forbidden": mods}))
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
    assert out == {"pieces": 6, "ingest_pieces": 1025, "chunks": out["chunks"], "forbidden": []}


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
