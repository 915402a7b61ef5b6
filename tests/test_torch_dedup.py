"""The port's dedup plane on the CPU, held exactly against
``kraken_tpu.origin.dedup``: the same near-duplicate blobs indexed by both
packages give the same sidecar bytes, stats, ``similar`` results and chunk
recipes; sidecars written by either package load into the other; removal
restores the accounting; the eviction race raises; the router decides
``host`` off the card without timing. The port runs with ``device="cpu"``
and the hashlib hasher, except one tiny blob through the plain SHA-256."""

import hashlib

import numpy as np
import pytest
import torch

from kraken_tpu.core.digest import Digest as JaxDigest
from kraken_tpu.core.metainfo import ChunkRecipe as JaxChunkRecipe
from kraken_tpu.core.metainfo import chunk_fp as jax_chunk_fp
from kraken_tpu.ops.cdc import CDCParams as JaxCDCParams
from kraken_tpu.origin import dedup as jax_dedup
from kraken_tpu.store import CAStore as JaxCAStore
from kraken_tpu_torch import TorchPieceHasher
from kraken_tpu_torch.core.digest import Digest
from kraken_tpu_torch.core.hasher import CPUPieceHasher
from kraken_tpu_torch.core.metainfo import ChunkRecipe, MetaInfoError, chunk_fp
from kraken_tpu_torch.ops.cdc import CDCParams, chunk_spans
from kraken_tpu_torch.origin import dedup
from kraken_tpu_torch.store import CAStore

PARAMS = CDCParams(min_size=256, avg_size=1024, max_size=4096)
JAX_PARAMS = JaxCDCParams(min_size=256, avg_size=1024, max_size=4096)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _near_dup_blobs(rng) -> tuple[bytes, bytes, bytes]:
    """Two blobs sharing most content at SHIFTED offsets + one unrelated
    (the blobs of tests/test_dedup.py)."""
    shared = rng.integers(0, 256, size=48 * 1024, dtype=np.uint8).tobytes()
    a = rng.integers(0, 256, size=512, dtype=np.uint8).tobytes() + shared
    b = rng.integers(0, 256, size=2048, dtype=np.uint8).tobytes() + shared
    c = rng.integers(0, 256, size=50 * 1024, dtype=np.uint8).tobytes()
    return a, b, c


def _put(store, data: bytes):
    d = (Digest if isinstance(store, CAStore) else JaxDigest).from_bytes(data)
    uid = store.create_upload()
    store.write_upload_chunk(uid, 0, data)
    store.commit_upload(uid, d)
    return d


def _ours(store, **kw):
    return dedup.DedupIndex(
        store, hasher=CPUPieceHasher(), params=PARAMS, device="cpu", **kw
    )


def _theirs(store, **kw):
    return jax_dedup.DedupIndex(store, params=JAX_PARAMS, **kw)


def _sidecar(store, d) -> bytes:
    with open(store.cache_path(d) + "._md_chunksketch", "rb") as f:
        return f.read()


@pytest.fixture
def both(tmp_path):
    """The three blobs, stored and indexed by each package in its own store."""
    blobs = _near_dup_blobs(np.random.default_rng(0))
    ours_store = CAStore(str(tmp_path / "ours"))
    theirs_store = JaxCAStore(str(tmp_path / "theirs"))
    ours_d = [_put(ours_store, x) for x in blobs]
    theirs_d = [_put(theirs_store, x) for x in blobs]
    assert [d.hex for d in ours_d] == [d.hex for d in theirs_d]
    return blobs, (ours_store, ours_d), (theirs_store, theirs_d)


@pytest.mark.parametrize("index_kind", ["dict", "compact"])
def test_index_matches_the_jax_package(both, index_kind):
    blobs, (os_, od), (ts, td) = both
    ours, theirs = _ours(os_, index_kind=index_kind), _theirs(ts, index_kind=index_kind)
    for a, b, blob in zip(od, td, blobs):
        ra, rb = ours.add_blob_sync(a), theirs.add_blob_sync(b)
        assert ra.serialize() == rb.serialize()
        assert _sidecar(os_, a) == _sidecar(ts, b)
        want = [e - s for s, e in chunk_spans(blob, PARAMS, device="cpu")]
        assert ra.sizes.tolist() == want
    assert ours.stats() == theirs.stats()
    assert ours.stats()["chunk_route"] == "host(<min)"
    assert ours.dedup_ratio == theirs.dedup_ratio > 0
    for a, b in zip(od, td):
        assert ours.similar(a, k=5) == theirs.similar(b, k=5)
        assert ours.chunk_table(a) == theirs.chunk_table(b)
        (r_ours, hit_ours), (r_theirs, hit_theirs) = ours.recipe_sync(a), theirs.recipe_sync(b)
        assert r_ours.serialize() == r_theirs.serialize()
        assert hit_ours is hit_theirs is True
    hits = ours.similar(od[0], k=5)
    assert hits and hits[0]["digest"] == od[1].hex and hits[0]["score"] > 0.5


def test_sidecars_cross_load_both_ways(both):
    _blobs, (os_, od), (ts, td) = both
    ours, theirs = _ours(os_), _theirs(ts)
    for d in od[:2]:
        ours.add_blob_sync(d)
    for d in td[:2]:
        theirs.add_blob_sync(d)
    # The port reads the JAX package's store and the JAX package the port's.
    ours_on_theirs = _ours(CAStore(ts.root))
    theirs_on_ours = _theirs(JaxCAStore(os_.root))
    assert ours_on_theirs.load_existing() == theirs_on_ours.load_existing() == 2
    assert ours_on_theirs.stats() == theirs.stats() == theirs_on_ours.stats() == ours.stats()
    da = Digest.from_hex(od[0].hex)
    assert ours_on_theirs.similar(da) == theirs.similar(td[0])
    assert theirs_on_ours.similar(td[0]) == ours.similar(od[0])
    recipe, had = ours_on_theirs.recipe_sync(da)
    assert had and recipe.serialize() == theirs.recipe_sync(td[0])[0].serialize()


def test_remove_restores_accounting(both):
    _blobs, (os_, od), _ = both
    index = _ours(os_)
    index.add_blob_sync(od[0])
    alone = index.stats()
    index.add_blob_sync(od[1])
    assert index.duplicate_bytes > 0
    assert index.remove_sync(od[1])
    assert index.stats() == alone
    assert all(h["digest"] != od[1].hex for h in index.similar(od[0], k=5))
    assert not index.remove_sync(od[1])
    index.add_blob_sync(od[1])  # re-admitted from its sidecar
    assert index.stats()["blobs"] == 2 and index.duplicate_bytes > 0
    # The blob's deletion takes its sidecar along; removal still unindexes.
    os_.delete_cache_file(od[1])
    assert not os_.in_cache(od[1]) and index._load_record(od[1]) is None
    assert index.remove_sync(od[1])
    assert index.stats()["blobs"] == 1
    assert [d.hex for d in os_.list_cache_digests()] == sorted(d.hex for d in (od[0], od[2]))


def test_add_is_idempotent_and_capped(both):
    _blobs, (os_, od), _ = both
    index = _ours(os_, max_blobs=2)
    index.add_blob_sync(od[0])
    total = index.total_bytes
    index.add_blob_sync(od[0])
    assert index.total_bytes == total
    index.add_blob_sync(od[1])
    index.add_blob_sync(od[2])  # evicts the oldest from memory, not disk
    assert index.stats()["blobs"] == 2
    assert _ours(os_).load_existing() == 3


def test_eviction_race_raises(both):
    _blobs, (os_, od), _ = both
    index = _ours(os_)
    os_.in_cache = lambda _d: False
    with pytest.raises(dedup.DedupEvictionRace):
        index.add_blob_sync(od[0])
    assert isinstance(dedup.DedupEvictionRace(od[0].hex), KeyError)
    assert index.stats()["blobs"] == 0
    with pytest.raises(KeyError):
        index.similar(od[0])


def test_router_off_the_card_decides_host_without_timing():
    rng = np.random.default_rng(5)
    data = rng.integers(0, 256, 64 * 1024, np.uint8).tobytes()
    router = dedup.ChunkRouter(PARAMS, min_device_bytes=16 * 1024, device="cpu")
    small = data[: 8 * 1024]
    assert router.spans(small) == chunk_spans(small, PARAMS, device="cpu")
    assert router.decision is None  # small blobs never calibrate
    spans = router.spans(data)
    assert router.decision == "host" and router.measured == {}
    assert spans == chunk_spans(data, PARAMS, device="cpu")
    assert spans == jax_dedup.ChunkRouter(JAX_PARAMS, min_device_bytes=16 * 1024).spans(data)


def test_plain_sha256_hasher_gives_the_same_record(tmp_path):
    """A tiny blob through the ``cuda`` hasher's plain CPU route (a few
    short chunks: the plain SHA-256 is ~2,000 eager ops a block)."""
    blob = np.random.default_rng(6).integers(0, 256, 1500, np.uint8).tobytes()
    small = CDCParams(min_size=64, avg_size=256, max_size=512)
    store = CAStore(str(tmp_path))
    d = _put(store, blob)
    index = dedup.DedupIndex(
        store, hasher=TorchPieceHasher(device="cpu"), params=small, device="cpu"
    )
    assert index.hasher.name == "cuda"
    got = index.add_blob_sync(d)
    want = dedup.DedupIndex(
        CAStore(str(tmp_path / "h")), hasher=CPUPieceHasher(), params=small,
        device="cpu",
    )._compute_record(blob)
    assert got.serialize() == want.serialize()
    assert got.fps.size >= 2


def test_sketch_metadata_and_recipe_bytes():
    md = dedup.ChunkSketchMetadata(
        sketch=np.arange(128, dtype=np.uint32),
        fps=np.array([1, 2, 1 << 40, (1 << 64) - 1], dtype=np.uint64),
        sizes=np.array([10, 20, 30, 40], dtype=np.uint32),
    )
    raw = md.serialize()
    theirs = jax_dedup.ChunkSketchMetadata(md.sketch, md.fps, md.sizes)
    assert raw == theirs.serialize()
    back = dedup.ChunkSketchMetadata.deserialize(theirs.serialize())
    assert back.fps.dtype == np.uint64 and np.array_equal(back.fps, md.fps)
    with pytest.raises(ValueError, match="bad chunksketch"):
        dedup.ChunkSketchMetadata.deserialize(raw[:1] + b"\x01" + raw[2:])
    with pytest.raises(ValueError, match="mismatch"):
        dedup.ChunkSketchMetadata(md.sketch, md.fps, md.sizes[:2])

    d = Digest.from_bytes(b"blob")
    fps, sizes = [3, 1 << 63, 0], [100, 1, (1 << 32) - 1]
    recipe = ChunkRecipe(d, fps, sizes)
    theirs_r = JaxChunkRecipe(JaxDigest.from_bytes(b"blob"), fps, sizes)
    assert recipe.serialize() == theirs_r.serialize()
    back = ChunkRecipe.deserialize(theirs_r.serialize())
    assert back == recipe and back.length == sum(sizes)
    assert list(back.chunks()) == list(theirs_r.chunks())
    with pytest.raises(MetaInfoError, match="mismatch"):
        ChunkRecipe(d, [1], [1, 2])
    with pytest.raises(MetaInfoError, match="out of range"):
        ChunkRecipe(d, [1], [0])
    chunk = b"some chunk bytes"
    assert chunk_fp(chunk) == jax_chunk_fp(chunk) == int.from_bytes(
        hashlib.sha256(chunk).digest()[:8], "big"
    )
