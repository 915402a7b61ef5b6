"""The port's SHA-256 plane (``kraken_tpu_torch.ops``) against hashlib and
against ``kraken_tpu``'s JAX hasher, on the CPU: the wrappers run the plain
PyTorch version of the CUDA kernel for CPU tensors. Exact equality -- crypto
hashes admit no tolerance.

Case for case a port of tests/test_sha256.py. Message and piece lengths are
cut so that no block chain is much longer than ~130 blocks: the plain
version runs one eager op per step of the chain (~2,000 per 64-byte block).
"""

import hashlib
import os

import numpy as np
import pytest
import torch

from kraken_tpu.ops import sha256 as jax_sha256
from kraken_tpu_torch.core.hasher import CPUPieceHasher, get_hasher
from kraken_tpu_torch.ops import sha256_cuda, sha256_ref
from kraken_tpu_torch.ops.sha256 import TorchPieceHasher
from kraken_tpu_torch.utils.metrics import REGISTRY


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    # The plain version's ops are small; one intra-op thread keeps this
    # module from competing for every core with the timing-band tests
    # that run beside it under pytest-xdist.
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bytes(rng, n: int) -> bytes:
    return rng.integers(0, 256, size=n, dtype=np.uint8).tobytes()


@pytest.fixture(scope="module")
def hasher():
    return TorchPieceHasher(device="cpu")


def ref_pieces(data: bytes, piece_length: int) -> np.ndarray:
    return CPUPieceHasher().hash_pieces(data, piece_length)


# -- hash_batch: single messages of every tricky length ---------------------

@pytest.mark.parametrize(
    "length",
    [0, 1, 3, 55, 56, 57, 63, 64, 65, 119, 120, 127, 128, 1000, 4096, 8193],
)
def test_single_message_lengths(hasher, length):
    data = _bytes(np.random.default_rng(length), length)
    got = hasher.hash_batch([data])
    assert got.shape == (1, 32)
    assert bytes(got[0]) == hashlib.sha256(data).digest()


def test_every_length_0_to_257_in_one_batch(hasher):
    rng = np.random.default_rng(7)
    pieces = [_bytes(rng, n) for n in range(258)]
    got = hasher.hash_batch(pieces)
    for row, p in zip(got, pieces):
        assert bytes(row) == hashlib.sha256(p).digest()


def test_known_vectors(hasher):
    # FIPS 180-2 test vectors.
    cases = {
        b"abc": "ba7816bf8f01cfea414140de5dae2223b00361a396177a9cb410ff61f20015ad",
        b"": "e3b0c44298fc1c149afbf4c8996fb92427ae41e4649b934ca495991b7852b855",
        b"abcdbcdecdefdefgefghfghighijhijkijkljklmklmnlmnomnopnopq":
            "248d6a61d20638b8e5c026930c3e6039a33ce45964ff2167f6ecedd419db06c1",
    }
    got = hasher.hash_batch(list(cases))
    for row, expect in zip(got, cases.values()):
        assert bytes(row).hex() == expect


def test_ragged_batch(hasher):
    rng = np.random.default_rng(0)
    pieces = [_bytes(rng, int(n)) for n in rng.integers(0, 3000, size=40)]
    got = hasher.hash_batch(pieces)
    for row, p in zip(got, pieces):
        assert bytes(row) == hashlib.sha256(p).digest()


def test_empty_batch(hasher):
    assert hasher.hash_batch([]).shape == (0, 32)


# -- hash_pieces: blob splitting, uniform launch, ragged tail ---------------

@pytest.mark.parametrize(
    "blob_len,piece_len",
    [
        (0, 64),             # empty blob -> zero pieces
        (64, 64),            # exactly one piece
        (640, 64),           # uniform, multiple of 64
        (650, 64),           # uniform + short tail
        (1 << 16, 1 << 12),  # 64 KiB blob, 4 KiB pieces
        ((1 << 16) + 12345, 1 << 12),
        (1000, 100),         # piece length not a multiple of 64
        (37, 100),           # single short piece
    ],
)
def test_hash_pieces_matches_cpu(hasher, blob_len, piece_len):
    data = _bytes(np.random.default_rng(blob_len), blob_len)
    got = hasher.hash_pieces(data, piece_len)
    want = ref_pieces(data, piece_len)
    assert got.shape == want.shape
    assert np.array_equal(got, want)


def test_hash_pieces_streams_sub_batches():
    # Force many launches with a tiny sub-batch budget.
    h = TorchPieceHasher(sub_batch_bytes=256, device="cpu")
    data = _bytes(np.random.default_rng(1), 64 * 40 + 17)
    got = h.hash_pieces(data, 64)
    assert np.array_equal(got, ref_pieces(data, 64))
    got2 = h.hash_batch([data[i * 100 : (i + 1) * 100] for i in range(20)])
    for row, i in zip(got2, range(20)):
        assert bytes(row) == hashlib.sha256(data[i * 100 : (i + 1) * 100]).digest()


def test_matches_cpu_hasher_interface():
    cpu = get_hasher("cpu")
    data = _bytes(np.random.default_rng(2), 30000)
    assert np.array_equal(
        cpu.hash_pieces(data, 1 << 12),
        TorchPieceHasher(device="cpu").hash_pieces(data, 1 << 12),
    )


def test_hash_batch_mixed_sizes_bounded_memory(monkeypatch):
    """One large piece among many tiny ones: every staging buffer stays
    within sub_batch_bytes, except a single piece larger than the budget,
    which goes alone."""
    import kraken_tpu_torch.ops.sha256 as port

    budget = 8192
    sizes = []
    real = port.sha256_ragged

    def spy(flat, offsets, lengths):
        sizes.append((flat.numel(), lengths.numel()))
        return real(flat, offsets, lengths)

    monkeypatch.setattr(port, "sha256_ragged", spy)
    rng = np.random.default_rng(3)
    pieces = [_bytes(rng, 40) for _ in range(300)] + [_bytes(rng, 20000)]
    got = TorchPieceHasher(sub_batch_bytes=budget, device="cpu").hash_batch(pieces)
    for row, p in zip(got, pieces):
        assert bytes(row) == hashlib.sha256(p).digest()
    assert sum(n for _, n in sizes) == len(pieces)
    assert all(nbytes <= budget or n == 1 for nbytes, n in sizes)
    assert (20000 + 15) // 16 * 16 in [nbytes for nbytes, _ in sizes]


# -- three ways: port == kraken_tpu's JAX hasher == hashlib -----------------

@pytest.mark.parametrize("piece_len", [4096, 4000, 100])
def test_port_jax_hashlib_agree(piece_len):
    rng = np.random.default_rng(piece_len)
    blob = _bytes(rng, 5 * 4096 + 777)
    pieces = [_bytes(rng, int(n)) for n in rng.integers(0, 5000, size=12)]
    port = TorchPieceHasher(device="cpu")
    jaxh = jax_sha256.JaxPieceHasher(use_pallas=False)
    cpu = CPUPieceHasher()
    want = cpu.hash_pieces(blob, piece_len)
    assert np.array_equal(port.hash_pieces(blob, piece_len), want)
    assert np.array_equal(jaxh.hash_pieces(blob, piece_len), want)
    want_b = cpu.hash_batch(pieces)
    assert np.array_equal(port.hash_batch(pieces), want_b)
    assert np.array_equal(jaxh.hash_batch(pieces), want_b)


def test_round_constants_match_kraken_tpu():
    assert np.array_equal(sha256_ref._K, jax_sha256._K)
    assert np.array_equal(sha256_ref._H0, jax_sha256._H0)
    assert sha256_ref._K.dtype == jax_sha256._K.dtype == np.uint32


def test_compress_matches_jax_compress():
    """One compression of random states and blocks, word for word."""
    rng = np.random.default_rng(4)
    state = rng.integers(0, 1 << 32, size=(5, 8), dtype=np.uint64).astype(np.uint32)
    block = rng.integers(0, 1 << 32, size=(5, 16), dtype=np.uint64).astype(np.uint32)
    want = np.asarray(jax_sha256._compress(state, block))
    words = torch.from_numpy(block.astype(np.int64))[:, None, :]
    kw = sha256_ref._schedule(words)[0]
    st = list(torch.from_numpy(state.astype(np.int64)).unbind(1))
    got = torch.stack(sha256_ref.compress(st, kw), 1).numpy().astype(np.uint32)
    assert np.array_equal(got, want)


# -- the wrappers -----------------------------------------------------------

def test_wrappers_check_their_inputs():
    flat = torch.zeros(64, dtype=torch.uint8)
    off = torch.zeros(1, dtype=torch.int64)
    with pytest.raises(ValueError):
        sha256_cuda.sha256_ragged(flat, off, torch.tensor([65]))  # past the end
    with pytest.raises(ValueError):
        sha256_cuda.sha256_ragged(flat, off.int(), torch.tensor([1]))
    with pytest.raises(ValueError):
        sha256_cuda.sha256_ragged(flat.view(8, 8), off, torch.tensor([1]))
    with pytest.raises(ValueError):
        sha256_cuda.sha256_uniform(flat)
    with pytest.raises(ValueError):  # neither cpu nor cuda: no silent path
        sha256_cuda.sha256_uniform(torch.zeros((2, 64), dtype=torch.uint8, device="meta"))


def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    sha256_cuda.reset_launches()
    rows = torch.from_numpy(np.frombuffer(_bytes(np.random.default_rng(5), 3 * 192), np.uint8).copy())
    words = sha256_cuda.sha256_uniform(rows.view(3, 192))
    assert words.dtype == torch.int32 and words.shape == (3, 8)
    got = words.numpy().view(np.uint32).astype(">u4").view(np.uint8).reshape(3, 32)
    for i in range(3):
        assert bytes(got[i]) == hashlib.sha256(rows[i * 192 : (i + 1) * 192].numpy().tobytes()).digest()
    assert sha256_cuda.LAUNCHES == {
        "sha256_uniform": 0, "sha256_ragged": 0,
        "pack_tiles_device": 0, "sha256_packed_tiles": 0,
    }


def test_metrics_record_split():
    """hash_batch records its pieces; hash_pieces records the blob once,
    its ragged tail included (the raw path records nothing)."""
    c_bytes = REGISTRY.counter("hasher_bytes_total")
    c_pieces = REGISTRY.counter("hasher_pieces_total")
    h = TorchPieceHasher(device="cpu")
    b0, p0 = c_bytes.value(hasher="cuda"), c_pieces.value(hasher="cuda")
    h.hash_pieces(b"x" * 650, 64)
    assert c_bytes.value(hasher="cuda") - b0 == 650
    assert c_pieces.value(hasher="cuda") - p0 == 11
    h.hash_batch([b"a" * 10, b"b" * 20])
    assert c_bytes.value(hasher="cuda") - b0 == 680
    assert c_pieces.value(hasher="cuda") - p0 == 13


@pytest.mark.skipif(
    not os.environ.get("RUN_PALLAS_INTERPRET"),
    reason="interpret-mode kernel execution takes minutes and tens of GB of "
    "RAM on CPU (set RUN_PALLAS_INTERPRET=1)",
)
def test_matches_pallas_kernel_interpret_mode():
    """The port's uniform wrapper agrees with the Pallas kernel it replaces
    (interpret mode on CPU), including chains not a multiple of _KB."""
    import jax.numpy as jnp

    from kraken_tpu.ops.sha256_pallas import hash_pieces_device

    rng = np.random.default_rng(6)
    for pl_len, n in ((64, 3), (576, 5), (1024, 2)):
        data = rng.integers(0, 256, size=(n, pl_len), dtype=np.uint8)
        want = jax_sha256._digest_bytes(hash_pieces_device(jnp.asarray(data), pl_len))
        words = sha256_cuda.sha256_uniform(torch.from_numpy(data))
        got = words.numpy().view(np.uint32).astype(">u4").view(np.uint8).reshape(n, 32)
        assert np.array_equal(got, want)
