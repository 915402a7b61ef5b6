"""The port's packed path on the CPU: the relayout into the packed
word-major layout and the hash of packed words (the plain versions of
``csrc/sha256_packed.cu``), and the port's host packer
(``kraken_tpu_torch.native``), held against ``kraken_tpu``'s packers, its
Pallas pack kernel in interpret mode, its JAX hasher and hashlib.

The packed layout is state the two packages share: a window packed by
either package's packer hashes the same in both. Every comparison is
bit-exact -- SHA-256 admits no tolerance.
"""

import hashlib
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kraken_tpu import native as jax_native
from kraken_tpu.core.hasher import HashPool as JaxHashPool
from kraken_tpu.ops import sha256 as jax_sha256
from kraken_tpu_torch import native
from kraken_tpu_torch.core.hasher import CPUPieceHasher, HashPool
from kraken_tpu_torch.ops import sha256_cuda
from kraken_tpu_torch.ops.sha256_ref import packed_nb


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    # One intra-op thread keeps this module from competing for every core
    # with the timing-band tests that run beside it under pytest-xdist.
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pieces(m: int, p: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, (m, p), dtype=np.uint8)


def _words(t: torch.Tensor) -> np.ndarray:
    """An int32 tensor of packed words as the host packers' uint32 array."""
    return t.numpy().view(np.uint32)


def _digests(words: torch.Tensor) -> np.ndarray:
    return words.numpy().view(np.uint32).astype(">u4").view(np.uint8).reshape(-1, 32)


def _hashlib(rows: np.ndarray) -> np.ndarray:
    return CPUPieceHasher().hash_batch([r.tobytes() for r in rows])


@pytest.fixture
def c_or_numpy(request):
    """Run the port's host packer on its C path or its NumPy path."""
    if request.param == "c":
        assert native.have_native_packer()  # cc is part of this image
        yield
        return
    lib, native._LIB = native._load(), None
    try:
        yield
    finally:
        native._LIB = lib


# -- the relayout ---------------------------------------------------------------

@pytest.mark.parametrize("m,p", [(1024, 576), (2048, 64)])
def test_pack_agrees_four_ways(m, p):
    """The port's plain pack == the port's host packer ==
    kraken_tpu.native.pack_tiles == the Pallas pack kernel (interpret
    mode), byte for byte, trailing zero blocks included (576 B: nb 9,
    NB 16)."""
    from kraken_tpu.ops.sha256_pallas import pack_tiles_device as pallas_pack

    data = _pieces(m, p, p)
    nb = p // 64
    plain = sha256_cuda.pack_tiles_device(torch.from_numpy(data), nb)
    assert plain.shape == (m // 1024, packed_nb(nb), 16, 8, 128)
    assert plain.dtype == torch.int32
    got = _words(plain).reshape(m // 1024, packed_nb(nb), 16, 1024)
    assert np.array_equal(got, jax_native.pack_tiles(data, packed_nb(nb)))
    assert np.array_equal(got, native.pack_tiles(data, packed_nb(nb)))
    pallas = np.asarray(pallas_pack(jnp.asarray(data), nb, interpret=True))
    assert np.array_equal(_words(plain), pallas)


@pytest.mark.parametrize("c_or_numpy", ["c", "numpy"], indirect=True)
@pytest.mark.parametrize("workers", [1, 3])
def test_host_packer_matches_kraken_tpu(c_or_numpy, workers):
    data = _pieces(2048, 576, workers)
    want = jax_native.pack_tiles(data, 16)
    pool = HashPool(workers, name=f"test-pack-{workers}")
    assert np.array_equal(native.pack_tiles_pooled(data, 16, pool), want)
    assert np.array_equal(native.pack_tiles(data, 16, threads=workers), want)
    assert native.packer() == ("c" if native._LIB is not None else "numpy")


def test_pack_tiles_range_stripes_reassemble():
    """Disjoint group stripes packed by separate calls reassemble to the
    single-call layout, an overshooting upper bound clamped."""
    data = _pieces(2048, 576, 11)
    out = np.zeros((2, 16, 16, 1024), dtype=np.uint32)
    n_groups = 2048 // 16
    native.pack_tiles_range(data, 16, out, 0, 17)
    native.pack_tiles_range(data, 16, out, 17, 100)
    native.pack_tiles_range(data, 16, out, 100, n_groups + 50)
    assert np.array_equal(out, jax_native.pack_tiles(data, 16))
    # Beside kraken_tpu's pooled pack, through its own HashPool.
    assert np.array_equal(
        out, jax_native.pack_tiles_pooled(data, 16, JaxHashPool(2, name="t"))
    )


def test_pack_args_are_checked():
    """Shapes, and a caller's ``out`` (a staging lease in production), are
    validated before any raw pointer reaches the C packer; the wrapper of
    the pack kernel checks its input the same way."""
    with pytest.raises(ValueError):
        native.pack_tiles(np.zeros((100, 64), dtype=np.uint8), 1)
    with pytest.raises(ValueError):
        native.pack_tiles(np.zeros((1024, 63), dtype=np.uint8), 1)
    data = np.zeros((1024, 64), dtype=np.uint8)
    with pytest.raises(ValueError):  # nb_out below the piece's blocks
        native.pack_tiles(np.zeros((1024, 128), dtype=np.uint8), 1)
    with pytest.raises(ValueError):  # wrong dtype
        native.pack_tiles(data, 8, out=np.zeros((1, 8, 16, 1024), np.uint64))
    with pytest.raises(ValueError):  # wrong shape
        native.pack_tiles(data, 8, out=np.zeros((1, 8, 16, 512), np.uint32))
    big = np.zeros((1, 8, 16, 2048), dtype=np.uint32)
    with pytest.raises(ValueError):  # non-contiguous view
        native.pack_tiles(data, 8, out=big[:, :, :, ::2])
    ro = np.zeros((1, 8, 16, 1024), dtype=np.uint32)
    ro.setflags(write=False)
    with pytest.raises(ValueError):  # read-only
        native.pack_tiles(data, 8, out=ro)
    rows = torch.zeros((1024, 128), dtype=torch.uint8)
    with pytest.raises(ValueError):  # P != 64 * unpadded_blocks
        sha256_cuda.pack_tiles_device(rows, 1)
    with pytest.raises(ValueError):  # not a whole tile
        sha256_cuda.pack_tiles_device(rows[:1000], 2)
    with pytest.raises(ValueError):
        sha256_cuda.pack_tiles_device(rows.view(-1), 2)


def test_packed_layout_is_pinned():
    """The first words of a fixed 1024 x 64 B input, written out: a change
    to either packer, or to the plain pack, fails here loudly."""
    data = (np.arange(1024 * 64) % 251).astype(np.uint8).reshape(1024, 64)
    for words in (
        _words(sha256_cuda.pack_tiles_device(torch.from_numpy(data), 1)).reshape(1, 8, 16, 1024),
        native.pack_tiles(data, 8),
        jax_native.pack_tiles(data, 8),
    ):
        assert words.shape == (1, 8, 16, 1024)
        assert [int(v) for v in words[0, 0, 0, :4]] == [
            0x00010203, 0x40414243, 0x80818283, 0xC0C1C2C3,
        ]
        assert int(words[0, 0, 1, 0]) == 0x04050607
        assert int(words[0, 0, 15, 1023]) == 0x15161718
        assert not words[0, 1:].any()  # blocks past the piece's one: zero


# -- the hash of packed words ---------------------------------------------------

@pytest.mark.parametrize("p", [64, 576, 1024])
def test_plain_packed_hash_matches_hashlib_and_jax(p):
    data = _pieces(1024, p, p + 1)
    packed = sha256_cuda.pack_tiles_device(torch.from_numpy(data), p // 64)
    got = _digests(sha256_cuda.sha256_packed_tiles(packed, p // 64))
    want = _hashlib(data)
    assert np.array_equal(got, want)
    jaxh = jax_sha256.JaxPieceHasher(use_pallas=False)
    assert np.array_equal(jaxh.hash_pieces(data.tobytes(), p), want)


def test_packed_hash_of_a_kraken_tpu_pack():
    """A window packed by kraken_tpu's host packer hashes unchanged in the
    port (the layout is the shared state)."""
    data = _pieces(1024, 320, 5)  # nb 5, NB 8
    packed = jax_native.pack_tiles(data, packed_nb(5))
    x = torch.from_numpy(packed.view(np.int32)).view(1, 8, 16, 8, 128)
    got = _digests(sha256_cuda.sha256_packed_tiles(x, 5))
    assert np.array_equal(got, _hashlib(data))


def test_hash_pieces_device_packed_pads_and_trims():
    data = _pieces(5, 128, 3)
    got = _digests(sha256_cuda.hash_pieces_device_packed(torch.from_numpy(data), 128))
    assert got.shape == (5, 32)
    assert np.array_equal(got, _hashlib(data))
    with pytest.raises(ValueError):
        sha256_cuda.hash_pieces_device_packed(torch.from_numpy(data), 100)


def test_packed_wrappers_check_inputs_and_cpu_launches_nothing():
    sha256_cuda.reset_launches()
    packed = torch.zeros((1, 8, 16, 8, 128), dtype=torch.int32)
    with pytest.raises(ValueError):  # more blocks than the layout holds
        sha256_cuda.sha256_packed_tiles(packed, 9)
    with pytest.raises(ValueError):
        sha256_cuda.sha256_packed_tiles(packed.view(1, 8, 16, 1024), 1)
    with pytest.raises(ValueError):
        sha256_cuda.sha256_packed_tiles(packed.long(), 1)
    with pytest.raises(ValueError):  # neither cpu nor cuda: no silent path
        sha256_cuda.sha256_packed_tiles(packed.to("meta"), 1)
    words = sha256_cuda.sha256_packed_tiles(packed, 1)
    assert bytes(_digests(words)[0]) == hashlib.sha256(bytes(64)).digest()
    assert sha256_cuda.LAUNCHES["sha256_packed_tiles"] == 0
    assert sha256_cuda.LAUNCHES["pack_tiles_device"] == 0


def test_cdc_chunker_matches_kraken_tpu():
    """The port's copy of the C chunker cuts where kraken_tpu's does."""
    from kraken_tpu.ops.cdc import CDCParams, chunk_reference

    p = CDCParams(min_size=64, avg_size=256, max_size=1024)
    rng = np.random.default_rng(3)
    for n in (1, 63, 65, 4096, 20000):
        data = rng.integers(0, 256, size=n, dtype=np.uint8)
        args = (p.min_size, p.avg_size, p.max_size, p.mask_strict, p.mask_loose)
        got = native.cdc_chunk_native(data, *args)
        assert got.tolist() == jax_native.cdc_chunk_native(data, *args).tolist()
        assert got.tolist() == chunk_reference(data.tobytes(), p)


@pytest.mark.skipif(
    not os.environ.get("RUN_PALLAS_INTERPRET"),
    reason="interpret-mode kernel execution takes minutes and tens of GB of "
    "RAM on CPU (set RUN_PALLAS_INTERPRET=1)",
)
def test_matches_pallas_packed_kernel_interpret_mode():
    """The plain packed hash agrees with the Pallas kernel it replaces."""
    from kraken_tpu.ops.sha256_pallas import sha256_packed_tiles as pallas_hash

    for p in (64, 576):
        data = _pieces(1024, p, p + 2)
        packed = sha256_cuda.pack_tiles_device(torch.from_numpy(data), p // 64)
        want = jax_sha256._digest_bytes(
            pallas_hash(jnp.asarray(_words(packed)), p // 64, interpret=True)
        )
        got = _digests(sha256_cuda.sha256_packed_tiles(packed, p // 64))
        assert np.array_equal(got, want)
