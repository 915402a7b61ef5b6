"""The port's MinHash and LSH on the CPU, held exactly against
``kraken_tpu.ops.minhash``: the seeded hash parameters, sketches (the
unsigned min over fingerprints at or above 0x80000000, the empty set, sets
the JAX package pads to powers of two), and the query results of both LSH
indexes through removal, compaction and budget eviction. Sketches persist
in dedup sidecars, so they must be bit-identical."""

import numpy as np
import pytest
import torch

from kraken_tpu.ops import minhash as jax_mh
from kraken_tpu_torch.ops import minhash as mh


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_set(rng, size):
    return np.unique(rng.integers(0, 1 << 32, size=size, dtype=np.uint64).astype(np.uint32))


def hashers(num_hashes=128, seed=0):
    return (
        mh.MinHasher(num_hashes=num_hashes, seed=seed, device="cpu"),
        jax_mh.MinHasher(num_hashes=num_hashes, seed=seed),
    )


@pytest.mark.parametrize("seed", [0, 1, 7, 12345])
@pytest.mark.parametrize("num_hashes", [16, 128])
def test_hash_parameters_equal(seed, num_hashes):
    ours, theirs = hashers(num_hashes, seed)
    assert ours._a.dtype == np.uint32 and ours._b.dtype == np.uint32
    assert np.array_equal(ours._a, theirs._a)
    assert np.array_equal(ours._b, theirs._b)


@pytest.mark.parametrize("step", [None, 1000])
def test_sketch_batch_bit_identical(step, monkeypatch):
    if step is not None:  # several steps over M, a running min across them
        monkeypatch.setattr(mh, "_SKETCH_ELEMENTS", step)
    rng = np.random.default_rng(3)
    high = np.array([0x80000000, 0xFFFFFFFF, 0xFFFFFFFE, 0x80000001], dtype=np.uint32)
    sets = [
        make_set(rng, 100),
        np.empty(0, dtype=np.uint32),  # the empty set: all 0xFFFFFFFF
        high,  # only hashes of fingerprints >= 2^31
        np.union1d(make_set(rng, 17), high),
        make_set(rng, 3),
        np.array([0], dtype=np.uint32),
    ]
    ours, theirs = hashers()
    got = ours.sketch_batch(sets)  # 6 sets, not padded to 8
    want = theirs.sketch_batch(sets)
    assert got.dtype == np.uint32 and got.shape == (6, 128)
    assert np.array_equal(got, want)
    assert (got[1] == 0xFFFFFFFF).all()
    assert (got >= 0x80000000).any()  # the unsigned min kept the high half
    for s, row in zip(sets, got):
        assert np.array_equal(ours.sketch(s), row)
    assert ours.sketch_batch([]).shape == (0, 128)


def test_sketch_is_the_unsigned_min():
    """Each coordinate is min over x of (a*x + b) mod 2^32, as unsigned."""
    ours, _ = hashers(num_hashes=8, seed=5)
    s = make_set(np.random.default_rng(8), 40)
    a, b = ours._a.astype(object), ours._b.astype(object)
    want = [min((int(ak) * int(x) + int(bk)) % (1 << 32) for x in s) for ak, bk in zip(a, b)]
    assert ours.sketch(s).tolist() == want


def test_fingerprints_and_estimator():
    digests = np.random.default_rng(4).integers(0, 256, (50, 32), dtype=np.uint8)
    digests[7] = digests[3]  # a repeated chunk: deduped
    got = mh.fingerprints_from_digests(digests)
    assert got.dtype == np.uint32 and got.size == 49
    assert np.array_equal(got, jax_mh.fingerprints_from_digests(digests))
    assert mh.fingerprints_from_digests(np.empty((0, 32), np.uint8)).size == 0
    x, y = got[:10], np.concatenate([got[:5], got[20:25]])
    assert mh.estimate_jaccard(x, y) == jax_mh.estimate_jaccard(x, y)


def _corpus(rng, n=300):
    """A few hundred sets: near-duplicate families around shared bases,
    plus unrelated sets."""
    bases = [make_set(rng, 200) for _ in range(6)]
    sets = []
    for i in range(n):
        if i % 3 == 2:
            sets.append(make_set(rng, 200))
        else:
            base = bases[i % len(bases)]
            keep = int(200 * rng.uniform(0.3, 0.95))
            sets.append(np.union1d(base[:keep], make_set(rng, 200 - keep)))
    return bases, sets


def _build(kind, hasher, keys, sketches):
    if kind == "dict":
        idx = (mh.LSHIndex if isinstance(hasher, mh.MinHasher) else jax_mh.LSHIndex)(
            hasher, num_bands=32
        )
    else:
        idx = (
            mh.CompactLSHIndex if isinstance(hasher, mh.MinHasher) else jax_mh.CompactLSHIndex
        )(hasher, num_bands=32)
    for k, s in zip(keys, sketches):
        idx.add(k, s)
    return idx


@pytest.mark.parametrize("device_min", [None, 64])
@pytest.mark.parametrize("kind", ["dict", "compact"])
def test_queries_equal_the_jax_indexes(kind, device_min, monkeypatch):
    """query and query_brute return the same keys and scores, in the same
    order, through removal and re-add; with a small ``_SCORE_DEVICE_MIN``
    the brute scan and scoring take the device route (top-k ties keep the
    lower row first in both)."""
    if device_min is not None:
        monkeypatch.setattr(mh, "_SCORE_DEVICE_MIN", device_min)
        monkeypatch.setattr(jax_mh, "_SCORE_DEVICE_MIN", device_min)
    rng = np.random.default_rng(11)
    bases, sets = _corpus(rng)
    ours_h, theirs_h = hashers()
    sk = ours_h.sketch_batch(sets)
    assert np.array_equal(sk, theirs_h.sketch_batch(sets))
    keys = [f"s{i}" for i in range(len(sets))]
    ours, theirs = _build(kind, ours_h, keys, sk), _build(kind, theirs_h, keys, sk)
    queries = ours_h.sketch_batch(bases)

    def same():
        assert len(ours) == len(theirs)
        for q in queries:
            assert ours.query(q, k=10) == theirs.query(q, k=10)
            assert ours.query(q, k=10, min_jaccard=0.5) == theirs.query(q, k=10, min_jaccard=0.5)
            assert ours.query_brute(q, k=10) == theirs.query_brute(q, k=10)

    same()
    for i in range(0, 300, 2):  # past the 64-tombstone compaction threshold
        assert ours.remove(keys[i]) == theirs.remove(keys[i])
    assert ours.remove("absent") == theirs.remove("absent") is False
    same()
    for i in range(0, 40, 2):  # re-add: latest wins
        ours.add(keys[i], sk[i])
        theirs.add(keys[i], sk[i])
    assert (keys[0] in ours) == (keys[0] in theirs) is True
    same()


def test_compact_budget_eviction_equal():
    rng = np.random.default_rng(13)
    ours_h, theirs_h = hashers(num_hashes=64)
    sk = ours_h.sketch_batch([make_set(rng, 64) for _ in range(2000)])
    budget = 3_000_000
    ours = mh.CompactLSHIndex(ours_h, num_bands=16, budget_bytes=budget)
    theirs = jax_mh.CompactLSHIndex(theirs_h, num_bands=16, budget_bytes=budget)
    for s in range(0, 4000, 500):
        keys = list(range(s, s + 500))
        ours.add_batch(keys, sk[s % 2000 : s % 2000 + 500])
        theirs.add_batch(keys, sk[s % 2000 : s % 2000 + 500])
        assert ours.footprint_bytes() == theirs.footprint_bytes() <= budget
    assert ours.evictions == theirs.evictions > 0
    assert len(ours) == len(theirs)
    for q in sk[::200]:
        assert ours.query(q, k=5) == theirs.query(q, k=5)
        assert ours.query_brute(q, k=5) == theirs.query_brute(q, k=5)
    with pytest.raises(mh.BudgetExceeded):
        ours.set_budget(1)
    with pytest.raises(jax_mh.BudgetExceeded):
        theirs.set_budget(1)


def test_index_arguments_checked_as_in_jax():
    ours_h, _ = hashers(num_hashes=100)
    for cls in (mh.LSHIndex, mh.CompactLSHIndex):
        with pytest.raises(ValueError, match="divide"):
            cls(ours_h, num_bands=32)
        with pytest.raises(ValueError, match="low_j_bands"):
            cls(ours_h, num_bands=10, low_j_bands=-1)
    with pytest.raises(ValueError):
        mh.MinHasher(num_hashes=0, device="cpu")
