"""The port's sharded hash plane (``kraken_tpu_torch.parallel``) on the CPU,
held against ``kraken_tpu.parallel`` and hashlib bit for bit (SHA-256
admits no tolerance).

The reference runs on conftest's 8 virtual CPU devices; the port on a mesh
of 8 CPU shards (``piece_mesh(8, platform="cpu")``), where each shard runs
the SHA-256 kernel's plain version. Pieces are 256 B (4 blocks) outside
the ingest cases, so the plain version's chains stay short.
"""

import hashlib
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import kraken_tpu.parallel as jax_parallel
from kraken_tpu.core.ingest import IngestConfig as JaxIngestConfig
from kraken_tpu.core.ingest import IngestPipeline as JaxIngestPipeline
from kraken_tpu.ops.sha256 import _digest_bytes as jax_digest_bytes
from kraken_tpu_torch import CPUPieceHasher
from kraken_tpu_torch.core import hasher as hasher_mod
from kraken_tpu_torch.core.ingest import IngestConfig, IngestPipeline
from kraken_tpu_torch.ops import sha256_cuda
from kraken_tpu_torch.ops.sha256 import TorchPieceHasher, _digest_bytes
from kraken_tpu_torch.parallel import (
    PieceMesh,
    ShardedPieceHasher,
    piece_mesh,
    sharded_hash_pieces,
)
from kraken_tpu_torch.parallel import hashplane
from kraken_tpu_torch.utils import failpoints
from kraken_tpu_torch.utils.metrics import REGISTRY

REPO = Path(__file__).resolve().parent.parent
N_DEV = 8
PLEN = 256
PLEN_INGEST = 1024
WINDOW = 1 << 20  # one 1024-piece tile of 1024-byte pieces


def _rows(n: int, plen: int = PLEN, seed: int = 7) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, size=(n, plen), dtype=np.uint8)


def _hashlib(data) -> bytes:
    return b"".join(hashlib.sha256(bytes(row)).digest() for row in data)


@pytest.fixture(scope="module")
def mesh():
    return piece_mesh(N_DEV, platform="cpu")


@pytest.fixture(scope="module")
def jax_hasher():
    return jax_parallel.ShardedPieceHasher(jax_parallel.piece_mesh(N_DEV))


@pytest.fixture
def calls(monkeypatch):
    """Counts the calls of the staged protocol and of the packed path's
    wrappers (on the CPU they run the plain versions: no launch counts)."""
    seen = {"stage_window": 0, "pack_tiles_device": 0, "sha256_packed_tiles": 0}

    def spy(owner, name):
        real = getattr(owner, name)

        def run(*args, **kw):
            seen[name] += 1
            return real(*args, **kw)

        monkeypatch.setattr(owner, name, run)

    spy(ShardedPieceHasher, "stage_window")
    spy(sha256_cuda, "pack_tiles_device")
    spy(sha256_cuda, "sha256_packed_tiles")
    return seen


def test_a_cpu_mesh_stands_in_for_the_references_virtual_devices(mesh):
    ref = jax_parallel.piece_mesh(N_DEV)
    assert isinstance(mesh, PieceMesh)
    assert mesh.size == ref.devices.size == N_DEV
    assert mesh.axis_names == ref.axis_names == ("pieces",)
    assert mesh.devices == (torch.device("cpu"),) * N_DEV
    assert piece_mesh(platform="cpu").size == 1
    with pytest.raises(ValueError, match="at least one"):
        piece_mesh(0, platform="cpu")
    with pytest.raises(ValueError, match="platform"):
        piece_mesh(2, platform="tpu")


def test_the_mesh_never_falls_back_to_cpu_shards(monkeypatch):
    """A deliberate difference: the reference gives virtual CPU devices
    when the accelerator has too few (``mesh.py:30-35``); the port
    raises, so a missing card never hides behind the CPU."""
    ref = jax_parallel.piece_mesh(N_DEV, platform=None)
    assert ref.devices.flat[0].platform == "cpu"  # the reference's fallback
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for n in (None, 1, N_DEV):
        with pytest.raises(RuntimeError, match="platform='cpu'"):
            piece_mesh(n)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="need 8 devices, have 1"):
        piece_mesh(N_DEV)
    assert piece_mesh().devices == (torch.device("cuda", 0),)


@pytest.mark.parametrize("replicate", [True, False])
def test_sharded_digests_equal_the_references(mesh, replicate):
    """29 rows, ragged against the 8-shard quantum: the padding rows are
    sliced off. Replicated, every shard of the mesh holds its own full
    copy, as every device holds the reference's replicated array."""
    data = _rows(29)
    want = _hashlib(data)
    ref = jax_parallel.sharded_hash_pieces(
        jax_parallel.piece_mesh(N_DEV), data, PLEN, use_pallas=False, replicate=replicate
    )
    if replicate:
        assert ref.sharding.is_fully_replicated
    assert jax_digest_bytes(ref).tobytes() == want
    got = sharded_hash_pieces(mesh, data, PLEN, replicate=replicate)
    if replicate:
        assert isinstance(got, tuple) and len(got) == N_DEV
        assert len({w.data_ptr() for w in got}) == N_DEV
        for words, device in zip(got, mesh.devices):
            assert words.shape == (29, 8) and words.device == device
            assert _digest_bytes(words).tobytes() == want
    else:
        assert isinstance(got, torch.Tensor) and got.shape == (29, 8)
        assert np.array_equal(got.numpy().view(np.uint32), np.asarray(ref))


def test_shards_are_equal_and_the_padding_is_zero(mesh):
    staged, m = hashplane.stage_sharded_pieces(mesh, _rows(29), PLEN)
    assert m == 29 and len(staged) == N_DEV
    assert {tuple(s.shape) for s in staged} == {(4, PLEN)}
    assert torch.equal(torch.cat(staged)[:29], torch.from_numpy(_rows(29)))
    assert not torch.cat(staged)[29:].any()
    with pytest.raises(ValueError, match="% 64"):
        hashplane.stage_sharded_pieces(mesh, _rows(3, 100), 100)
    words = sharded_hash_pieces(mesh, _rows(0), PLEN, replicate=False)
    assert words.shape == (0, 8)


def test_staged_windows_equal_hash_pieces_and_the_references_protocol(mesh, jax_hasher):
    data = _rows(21)
    want = _hashlib(data)
    h = ShardedPieceHasher(mesh)
    got = h.hash_staged_window(h.stage_window(data, PLEN))
    ref = jax_hasher.hash_staged_window(jax_hasher.stage_window(data, PLEN))
    assert got.tobytes() == ref.tobytes() == want
    assert h.hash_pieces(data.tobytes(), PLEN).tobytes() == want


@pytest.mark.parametrize("total, plen", [(10 * PLEN + 100, PLEN), (10 * PLEN + 100, 100)])
def test_the_sharded_hasher_takes_tails_and_odd_pieces_on_one_device(
    mesh, jax_hasher, monkeypatch, total, plen
):
    """A ragged tail goes through the single-device ragged path and a
    ``piece_length % 64`` through the single-device hasher, as in the
    reference; the blob's bytes are counted once."""
    blob = np.random.default_rng(total + plen).bytes(total)
    want = CPUPieceHasher().hash_pieces(blob, plen)
    h = ShardedPieceHasher(mesh)
    assert h.device == torch.device("cpu") and h.name == "cuda-sharded"
    raw = []
    real_raw = TorchPieceHasher._hash_batch_raw

    def spy(self, pieces):
        raw.append([len(memoryview(p)) for p in pieces])
        return real_raw(self, pieces)

    monkeypatch.setattr(TorchPieceHasher, "_hash_batch_raw", spy)
    counter = REGISTRY.counter("hasher_bytes_total")
    before = {k: counter.value(hasher=k) for k in ("cuda-sharded", "cuda")}
    got = h.hash_pieces(blob, plen)
    assert np.array_equal(got, want)
    assert np.array_equal(jax_hasher.hash_pieces(blob, plen), want)
    moved = {k: counter.value(hasher=k) - before[k] for k in before}
    assert raw == [[total % plen]]
    if plen % 64:
        assert moved == {"cuda-sharded": 0, "cuda": total}
    else:
        assert moved == {"cuda-sharded": total, "cuda": 0}


def test_hash_batch_goes_through_the_single_device_hasher(mesh, jax_hasher):
    pieces = [b"", b"a" * 63, bytes(range(256)) * 3, b"z" * 1000]
    want = CPUPieceHasher().hash_batch(pieces)
    assert np.array_equal(ShardedPieceHasher(mesh).hash_batch(pieces), want)
    assert np.array_equal(jax_hasher.hash_batch(pieces), want)


def test_the_registry_name_resolves_to_the_sharded_hasher(monkeypatch, mesh):
    monkeypatch.setattr(hasher_mod, "_INSTANCES", {})
    monkeypatch.setitem(hasher_mod._REGISTRY, "cuda-sharded", lambda: ShardedPieceHasher(mesh))
    h = hasher_mod.get_hasher("cuda-sharded")
    assert isinstance(h, ShardedPieceHasher) and h is hasher_mod.get_hasher("cuda-sharded")
    assert h.mesh is mesh


def _stream(pipe, blob: bytes, plen: int):
    ses = pipe.session(plen)
    off = 0
    while off < len(blob):
        buf = ses.begin_window()
        n = min(len(buf), len(blob) - off)
        buf[:n] = blob[off : off + n]
        off += n
        ses.submit(n)
    return ses, ses.finish()


def test_a_sharded_ingest_bills_transfer_and_hash_apart(mesh, jax_hasher, calls):
    """Full windows take the staged protocol, the ragged last one
    ``hash_pieces``; the digests equal the reference's ``tpu-sharded``
    pipeline's and hashlib's."""
    cfg = dict(window_bytes=WINDOW, windows_in_flight=2)
    blob = np.random.default_rng(5).bytes(2 * WINDOW + 3 * PLEN_INGEST + 99)
    want = CPUPieceHasher().hash_pieces(blob, PLEN_INGEST)
    ses, got = _stream(IngestPipeline(ShardedPieceHasher(mesh), IngestConfig(**cfg)),
                       blob, PLEN_INGEST)
    jses, ref = _stream(JaxIngestPipeline(jax_hasher, JaxIngestConfig(**cfg)), blob,
                        PLEN_INGEST)
    assert np.array_equal(got, want) and np.array_equal(ref, want)
    assert calls["stage_window"] == 2
    assert ses.stage_seconds["transfer"] > 0 and ses.stage_seconds["hash"] > 0
    assert jses.stage_seconds["transfer"] > 0
    assert not ses._fell_back


@pytest.mark.parametrize("site", ["ingest.window.transfer", "ingest.window.hash"])
def test_a_staged_window_failpoint_reroutes_to_the_host_pass(mesh, calls, site):
    pipe = IngestPipeline(ShardedPieceHasher(mesh),
                          IngestConfig(window_bytes=WINDOW, windows_in_flight=1))
    blob = np.random.default_rng(9).bytes(2 * WINDOW + 7)
    counter = REGISTRY.counter("ingest_fallbacks_total")
    before = counter.value(reason="failpoint")
    failpoints.FAILPOINTS.arm(site, "once")
    try:
        ses, got = _stream(pipe, blob, PLEN_INGEST)
    finally:
        failpoints.FAILPOINTS.disarm_all()
    assert np.array_equal(got, CPUPieceHasher().hash_pieces(blob, PLEN_INGEST))
    assert ses._fell_back and counter.value(reason="failpoint") == before + 1
    assert calls["stage_window"] == (0 if site == "ingest.window.transfer" else 1)
    assert pipe._bufpool.leased == 0


def test_a_window_of_odd_pieces_is_not_staged(mesh, calls):
    """A uniform window whose pieces are not a multiple of 64 B goes
    through ``hash_pieces`` (the single-device hasher), never the staged
    protocol, whose staging refuses it; nothing falls back to hashlib."""
    pipe = IngestPipeline(ShardedPieceHasher(mesh), IngestConfig(window_bytes=WINDOW))
    blob = np.random.default_rng(17).bytes(30 * 100)
    ses, got = _stream(pipe, blob, 100)
    assert np.array_equal(got, CPUPieceHasher().hash_pieces(blob, 100))
    assert calls["stage_window"] == 0 and not ses._fell_back
    assert ses.stage_seconds["transfer"] == 0 and ses.stage_seconds["hash"] > 0


def test_a_sharded_ingest_in_device_mode_takes_the_packed_path(mesh, calls):
    """``pack_mode: device`` with a window of one whole tile (1024 x 64 B)
    runs the packed kernels on the hasher's device, not the staged
    protocol; the gate is ``name.startswith("cuda")``."""
    pipe = IngestPipeline(ShardedPieceHasher(mesh), IngestConfig(pack_mode="device"))
    blob = np.random.default_rng(13).bytes(1024 * 64)
    ses, got = _stream(pipe, blob, 64)
    assert np.array_equal(got, CPUPieceHasher().hash_pieces(blob, 64))
    assert calls == {"stage_window": 0, "pack_tiles_device": 1, "sha256_packed_tiles": 1}
    assert ses.stage_seconds["pack"] > 0


def test_the_dryrun_is_hermetic_in_a_hostile_environment():
    """Bogus ``JAX_PLATFORMS`` and ``CUDA_VISIBLE_DEVICES``, no
    ``XLA_FLAGS``: the dry run still runs on its CPU shards and never
    initialises CUDA (it checks that itself before ``dryrun ok``)."""
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(JAX_PLATFORMS="bogus", CUDA_VISIBLE_DEVICES="bogus", PYTHONPATH=str(REPO))
    r = subprocess.run(
        [sys.executable, "-m", "kraken_tpu_torch.parallel.dryrun", "8"],
        capture_output=True, text=True, cwd=REPO, env=env, timeout=120,
    )
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.strip().splitlines()[-1] == "dryrun ok"
