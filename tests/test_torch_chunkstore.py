"""The chunk tier in the port (``kraken_tpu_torch.store.chunkstore`` and
the castore's chunk half), held against ``kraken_tpu``: the cases of
``tests/test_chunkstore.py`` as cross-package cases on numpy-seeded bytes,
at the reference's small ``CDCParams(256, 1024, 4096)`` and 16 KiB pieces.

- each package reads a store the other chunked: manifests, chunk file
  names and bytes, the journal, and the refcounts after replay; the same
  operations give the same tree byte for byte;
- multi-base planning: both packages pick the same cover bases
  (hypothesis);
- eviction frees unique bytes, fsck rebuilds and reaps, scrub
  quarantines a flipped shared chunk and a recommit heals it;
- herds in one process: a chunk-backed origin serves pieces and ranges
  bit-identically, and the storage band holds with the tier on the agent;
- a live reload attaches the tier.

There is no tolerance: every comparison is byte for byte.
"""

import asyncio
import os
import shutil
from pathlib import Path

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import kraken_tpu.core.digest as jax_digest
import kraken_tpu.p2p.delta as jax_delta
import kraken_tpu.store as jax_store
import kraken_tpu.store.chunkstore as jax_chunkstore
import kraken_tpu.store.recovery as jax_recovery
import kraken_tpu_torch.core.digest as port_digest
import kraken_tpu_torch.p2p.delta as port_delta
import kraken_tpu_torch.store as port_store
import kraken_tpu_torch.store.chunkstore as port_chunkstore
import kraken_tpu_torch.store.recovery as port_recovery
from kraken_tpu_torch.core.metainfo import ChunkRecipe, chunk_fp
from test_torch_delta import (  # noqa: F401 (chaos_plane is an autouse fixture)
    DELTA_ON,
    JAX,
    PORT,
    TIER_ON,
    Herd,
    chaos_plane,
    make_build_pair,
    wait_chunked,
)
from test_torch_profiler import process_globals  # noqa: F401 (a fixture)

PKG = {
    PORT: (port_store, port_chunkstore, port_recovery, port_digest, port_delta),
    JAX: (jax_store, jax_chunkstore, jax_recovery, jax_digest, jax_delta),
}
PAIRS = [(JAX, PORT), (PORT, JAX), (PORT, PORT)]
STORED_BAND_MAX = 0.7  # the reference's storage band (tests/test_chunkstore.py)
MOVED_BAND_MAX = 0.6


def mk_store(pkg, root, enabled=True):
    store_mod, cs_mod = PKG[pkg][0], PKG[pkg][1]
    store = store_mod.CAStore(str(root))
    store.attach_chunkstore(cs_mod.ChunkStore(
        os.path.join(store.root, "chunks"),
        cs_mod.ChunkStoreConfig(enabled=enabled, min_blob_bytes=1),
        quarantine_dir=store.quarantine_dir,
    ))
    return store


def table(blob: bytes, n_chunks: int) -> tuple[list[int], list[int]]:
    """The reference's fixed tiling table (the tier trusts any table
    whose chunks tile and hash)."""
    size = max(len(blob) // n_chunks, 1)
    sizes, fps, off = [], [], 0
    while off < len(blob):
        s = min(size, len(blob) - off)
        if len(blob) - (off + s) < size // 2:
            s = len(blob) - off
        sizes.append(s)
        fps.append(chunk_fp(blob[off:off + s]))
        off += s
    return fps, sizes


def add(pkg, store, blob: bytes, n_chunks=8, tab=None):
    d = PKG[pkg][3].Digest.from_bytes(blob)
    store.create_cache_file(d, iter([blob]))
    fps, sizes = tab or table(blob, n_chunks)
    assert store.convert_to_chunks(d, fps, sizes) is not None and store.is_chunked(d)
    return d


def tree(root) -> dict[str, bytes]:
    """Every file under a store root but the upload spool, by its path."""
    out = {}
    for dirpath, _dirs, files in os.walk(root):
        for name in files:
            path = os.path.join(dirpath, name)
            rel = os.path.relpath(path, root)
            if not rel.startswith("upload"):
                with open(path, "rb") as f:
                    out[rel] = f.read()
    return out


def blob_of(rng, n) -> bytes:
    return rng.integers(0, 256, size=n, dtype=np.uint8).tobytes()


# -- refcounts, journal and the tree, across the packages -----------------------


def _ops(seed=21):
    """The reference's randomized add/delete sequence over a shared pool:
    ("add", blob, fps, sizes) and ("delete", index of an add)."""
    rng = np.random.default_rng(seed)
    pool = [blob_of(rng, int(rng.integers(512, 4096))) for _ in range(12)]
    ops, live = [], []
    for step in range(40):
        if live and rng.random() < 0.4:
            ops.append(("delete", live.pop(int(rng.integers(0, len(live))))))
            continue
        idx = rng.integers(0, len(pool), size=int(rng.integers(2, 6)))
        blob = b"".join(pool[i] for i in idx) + bytes([step])
        if any(op[0] == "add" and op[1] == blob for op in ops):
            continue
        fps = [chunk_fp(pool[i]) for i in idx] + [chunk_fp(bytes([step]))]
        ops.append(("add", blob, fps, [len(pool[i]) for i in idx] + [1]))
        live.append(len(ops) - 1)
    return ops


def _run(pkg, root, ops):
    store = mk_store(pkg, root)
    model: dict[tuple[int, int], int] = {}
    digests = {}
    for i, op in enumerate(ops):
        if op[0] == "add":
            _, blob, fps, sizes = op
            digests[i] = add(pkg, store, blob, tab=(fps, sizes))
            for k in zip(fps, sizes):
                model[k] = model.get(k, 0) + 1
        else:
            _, j = op
            store.delete_cache_file(digests.pop(j))
            for k in zip(ops[j][2], ops[j][3]):
                model[k] -= 1
        assert {k: c for k, c in store.chunkstore._refs.items() if c > 0} == \
            {k: c for k, c in model.items() if c > 0}
        assert store.chunkstore.logical_bytes() == sum(s * c for (_f, s), c in model.items())
    return store, digests, {k: c for k, c in model.items() if c > 0}


@pytest.mark.parametrize("writer,reader", PAIRS, ids=[f"{w}-wrote-{r}-reads" for w, r in PAIRS])
def test_refcount_invariants_under_add_delete_and_replay(tmp_path, writer, reader):
    """The reference's randomized add/delete: after every step the
    writer's refcounts match a model; the reader package replays the
    writer's journal to the same refcounts, rebuilds the same from the
    manifests, and reads every blob bit-identically. Both packages, fed
    the same operations, leave the same tree byte for byte."""
    ops = _ops()
    store, digests, model = _run(writer, tmp_path / "w", ops)
    other = tmp_path / "other"
    _run(JAX if writer == PORT else PORT, other, ops)
    assert tree(store.root) == tree(other)
    cs_mod, store_mod = PKG[reader][1], PKG[reader][0]
    cs2 = cs_mod.ChunkStore(store.chunkstore.root, quarantine_dir=store.quarantine_dir)
    assert {k: c for k, c in cs2._refs.items() if c > 0} == model
    read = store_mod.CAStore(store.root)
    read.attach_chunkstore(cs2)
    dig = PKG[reader][3].Digest
    assert [d.hex for d in read.list_cache_digests()] == sorted(d.hex for d in digests.values())
    manifests = [(m.fps, m.sizes) for m in map(read.manifest, read.list_cache_digests())]
    cs2.rebuild_refs(manifests)
    assert {k: c for k, c in cs2._refs.items() if c > 0} == model
    for i, d in digests.items():
        assert read.read_cache_file(dig.from_hex(d.hex)) == ops[i][1]
        assert read.verify_cache_file(dig.from_hex(d.hex))


def test_writeback_unpins_flat_and_chunked(tmp_path):
    """The port's writeback lands a flat blob and a chunk-backed one (its
    export path) and drops the eviction pin of both."""
    from kraken_tpu_torch.origin.writeback import KIND, WritebackExecutor
    from kraken_tpu_torch.persistedretry import Task
    from kraken_tpu_torch.store.metadata import PersistMetadata, pin

    store = mk_store(PORT, tmp_path / "s")
    uploaded = {}

    class Client:
        async def upload_file(self, ns, hex_, path):
            uploaded[hex_] = await asyncio.to_thread(Path(path).read_bytes)

    class Backends:
        def get_client(self, ns):
            return Client()

        try_get_client = get_client

    class RetryStore:
        def count_pending(self, kind, prefix):
            return 1

        def canonicalize_keys(self, kind, fn):
            pass

    class Retry:
        store = RetryStore()

        def register(self, kind, fn):
            pass

        def add(self, task):
            return True

    wb = WritebackExecutor(store, Backends(), Retry())
    rng = np.random.default_rng(4)
    flat = blob_of(rng, 9_000)
    d_flat = port_digest.Digest.from_bytes(flat)
    store.create_cache_file(d_flat, iter([flat]))
    chunked = blob_of(rng, 30_000)
    d_chunked = add(PORT, store, chunked, n_chunks=3)
    for d in (d_flat, d_chunked):
        pin(store, d, KIND)
        asyncio.run(wb._execute(Task(kind=KIND, key=f"{d.hex}:ns",
                                     payload={"namespace": "ns", "digest": d.hex})))
        md = store.get_metadata(d, PersistMetadata)
        assert md is None or not md.persist
    assert uploaded == {d_flat.hex: flat, d_chunked.hex: chunked}


@pytest.mark.parametrize("pkg", [PORT, JAX])
def test_empty_manifest_sidecar_reads_as_unhealthy_not_crash(tmp_path, pkg):
    """An empty manifest sidecar (a torn rename): with no flat file the
    blob is quarantined; beside a flat file only the sidecar goes. Each
    package's fsck on a tree the other wrote gives the same report."""
    writer = JAX if pkg == PORT else PORT
    rng = np.random.default_rng(5)
    with pytest.raises(ValueError):
        PKG[pkg][0].ChunkManifestMetadata.deserialize(b"")
    store = mk_store(writer, tmp_path / "s")
    blob, blob2 = blob_of(rng, 20_000), blob_of(rng, 20_000)
    d = add(writer, store, blob, n_chunks=2)
    d2 = add(writer, store, blob2, n_chunks=2)
    store.export_to_file(d2, store.cache_path(d2))
    for x in (d, d2):
        open(store._manifest_path(x), "wb").close()
    read = mk_store(pkg, store.root)
    dig = PKG[pkg][3].Digest
    assert read.manifest(dig.from_hex(d.hex)) is None
    rep = PKG[pkg][2].run_fsck(read, verify="none")
    assert rep.quarantined == [d.hex] and not read.in_cache(dig.from_hex(d.hex))
    assert rep.repairs.get("chunk_dual_state") == 1
    assert read.read_cache_file(dig.from_hex(d2.hex)) == blob2
    assert not os.path.exists(store._manifest_path(d2))


def test_the_tier_times_its_writes_and_checks(tmp_path):
    """The port's own ``chunkstore_seconds_total``: ``add`` is each
    ``add_blob``'s wall and ``check`` the hashlib fp checks inside it
    and in ``verify_chunk``; the reference keeps neither."""
    seconds = port_chunkstore.REGISTRY.counter("chunkstore_seconds_total")
    add0, check0 = seconds.value(stage="add"), seconds.value(stage="check")
    store = mk_store(PORT, tmp_path / "s")
    d = add(PORT, store, blob_of(np.random.default_rng(12), 40_000), n_chunks=4)
    add1, check1 = seconds.value(stage="add"), seconds.value(stage="check")
    assert add1 - add0 >= check1 - check0 > 0
    md = store.manifest(d)
    assert store.chunkstore.verify_chunk(md.fps[0], md.sizes[0])
    assert seconds.value(stage="check") > check1 and seconds.value(stage="add") == add1


@pytest.mark.parametrize("writer,reader", PAIRS, ids=[f"{w}-wrote-{r}-reads" for w, r in PAIRS])
def test_journal_torn_tail_and_compaction(tmp_path, writer, reader):
    """A torn journal tail is skipped on replay, and a compaction by one
    package replays to the same refcounts in the other."""
    store = mk_store(writer, tmp_path / "s")
    blob = blob_of(np.random.default_rng(6), 20_000)
    d = add(writer, store, blob, n_chunks=4)
    cs = store.chunkstore
    with open(os.path.join(cs.root, "refs.log"), "a") as f:
        f.write("+ deadbeef")
    cs_mod = PKG[reader][1]
    assert cs_mod.ChunkStore(cs.root, quarantine_dir=store.quarantine_dir)._refs == cs._refs
    with cs._lock:
        cs._compact_locked()
    cs3 = cs_mod.ChunkStore(cs.root, quarantine_dir=store.quarantine_dir)
    assert cs3._refs == cs._refs
    read = PKG[reader][0].CAStore(store.root)
    read.attach_chunkstore(cs3)
    assert read.read_cache_file(PKG[reader][3].Digest.from_hex(d.hex)) == blob


# -- multi-base planning --------------------------------------------------------


def _recipe(pkg, digest_hex, parts):
    mi = __import__(f"{'kraken_tpu_torch' if pkg == PORT else 'kraken_tpu'}.core.metainfo",
                    fromlist=["ChunkRecipe"])
    dig = PKG[pkg][3].Digest
    return mi.ChunkRecipe(dig.from_hex(digest_hex), [chunk_fp(p) for p in parts],
                          [len(p) for p in parts])


def test_pick_cover_bases_union_beats_best_single():
    """Two bases holding different halves of the target are both picked
    before the dominated one, by both packages, and their union covers
    the target."""
    rng = np.random.default_rng(3)
    chunks = [blob_of(rng, 1024) for _ in range(8)]
    hexes = [port_digest.Digest.from_bytes(x).hex for x in (b"t", b"a", b"b", b"c")]
    for pkg in (PORT, JAX):
        delta = PKG[pkg][4]
        target = _recipe(pkg, hexes[0], chunks)
        a, b, c = (_recipe(pkg, hexes[1], chunks[:5]), _recipe(pkg, hexes[2], chunks[4:]),
                   _recipe(pkg, hexes[3], chunks[:2]))
        picked = delta.pick_cover_bases(target, [(c.digest, c), (a.digest, a), (b.digest, b)], 2)
        assert [d.hex for d, _ in picked] == [hexes[1], hexes[2]]
        haves, needs = delta.diff_recipes_multi(target, [r for _d, r in picked])
        assert needs == [] and sum(h.size for h in haves) == target.length
        assert len(delta.pick_cover_bases(target, [(c.digest, c)], 3)) == 1


@settings(max_examples=60, deadline=None)
@given(pool=st.lists(st.tuples(st.integers(0, (1 << 63) - 1), st.integers(1, 8191)),
                     min_size=1, max_size=30),
       data=st.data())
def test_pick_cover_bases_and_the_multi_diff_agree_across_the_packages(pool, data):
    """The greedy cover and the multi-base diff give the same picks and
    spans in both packages on any recipes drawn from a shared pool, and
    the spans tile the target."""
    pick = st.lists(st.integers(0, len(pool) - 1), max_size=20)
    t_idx = data.draw(pick.filter(bool))
    c_idxs = data.draw(st.lists(pick, max_size=5))
    max_bases = data.draw(st.integers(1, 4))
    out = {}
    for pkg in (PORT, JAX):
        mi = __import__(f"{'kraken_tpu_torch' if pkg == PORT else 'kraken_tpu'}.core.metainfo",
                        fromlist=["ChunkRecipe"])
        dig = PKG[pkg][3].Digest

        def rec(i, idx):
            return mi.ChunkRecipe(dig.from_bytes(bytes([i])), [pool[k][0] for k in idx],
                                  [pool[k][1] for k in idx])

        target = rec(255, t_idx)
        cands = [(r.digest, r) for r in (rec(i, idx) for i, idx in enumerate(c_idxs))]
        picked = PKG[pkg][4].pick_cover_bases(target, cands, max_bases)
        haves, needs = PKG[pkg][4].diff_recipes_multi(target, [r for _d, r in picked])
        spans = sorted([(h.target_off, h.size) for h in haves] + list(needs))
        pos = 0
        for off, size in spans:
            assert off == pos
            pos += size
        assert pos == target.length
        out[pkg] = ([d.hex for d, _ in picked], [tuple(h) for h in haves], needs)
    assert out[PORT] == out[JAX]


# -- eviction, fsck, scrub ------------------------------------------------------


def test_watermark_eviction_frees_unique_bytes_and_reaps(tmp_path):
    """Evicting a chunk-backed blob frees only its unique bytes, and the
    sweep's reap makes them real at once; the same tree in the reference
    gives the same numbers."""
    from kraken_tpu.store.cleanup import CleanupConfig as JaxCleanupConfig
    from kraken_tpu.store.cleanup import CleanupManager as JaxCleanupManager
    from kraken_tpu_torch.store.cleanup import CleanupConfig, CleanupManager

    rng = np.random.default_rng(8)
    shared = blob_of(rng, 40_000)
    blobs = [shared + blob_of(rng, 20_000) for _ in range(2)]
    out = {}
    for pkg, cfg_cls, mgr_cls in ((PORT, CleanupConfig, CleanupManager),
                                  (JAX, JaxCleanupConfig, JaxCleanupManager)):
        store = mk_store(pkg, tmp_path / pkg)
        ds = [add(pkg, store, b, tab=([chunk_fp(b[i * 10_000:(i + 1) * 10_000])
                                       for i in range(6)], [10_000] * 6)) for b in blobs]
        before = (store.chunkstore.stored_bytes(), store.evictable_bytes(ds[0]))
        mgr = mgr_cls(store, cfg_cls(tti_seconds=0, high_watermark_bytes=75_000,
                                     low_watermark_bytes=70_000))
        mgr.touch(ds[0], now=100.0)
        mgr.touch(ds[1], now=200.0)
        evicted = mgr.run_once(now=300.0)
        assert [d.hex for d in evicted] == [ds[0].hex]
        assert store.read_cache_file(ds[1]) == blobs[1]
        out[pkg] = (before, store.chunkstore.stored_bytes())
    assert out[PORT] == out[JAX] == ((80_000, 20_000), 60_000)


def test_fsck_chunk_tier_orphans_rebuild_and_quarantine(tmp_path):
    """The chunk tier's fsck pass: a clean store (with a deleted, not yet
    reaped blob) repairs nothing; a planted orphan chunk is reaped; a
    corrupt chunk is quarantined with its blob. Each step's report equals
    the reference's on a copy of the same tree."""
    rng = np.random.default_rng(9)
    store = mk_store(PORT, tmp_path / "s")
    d = add(PORT, store, blob_of(rng, 60_000), n_chunks=6)
    store.delete_cache_file(add(PORT, store, blob_of(rng, 30_000), n_chunks=3))

    def both(verify):
        shutil.copytree(store.root, tmp_path / "j", dirs_exist_ok=False)
        jrep = jax_recovery.run_fsck(mk_store(JAX, tmp_path / "j"), verify=verify)
        shutil.rmtree(tmp_path / "j")
        prep = port_recovery.run_fsck(mk_store(PORT, store.root), verify=verify)
        assert (prep.repairs, prep.quarantined) == (jrep.repairs, jrep.quarantined)
        return prep

    rep = both("all")
    assert rep.total_repairs == 0 and not rep.quarantined
    orphan = os.path.join(store.chunkstore.root, "ab", "ab" * 8 + "-99")
    os.makedirs(os.path.dirname(orphan), exist_ok=True)
    with open(orphan, "wb") as f:
        f.write(b"x" * 99)
    rep = both("none")
    assert rep.repairs.get("orphan_chunk") == 1 and not os.path.exists(orphan)
    md = store.manifest(d)
    path = store.chunkstore.chunk_path(md.fps[2], md.sizes[2])
    with open(path, "r+b") as f:
        f.seek(10)
        f.write(b"\xde\xad")
    rep = both("all")
    assert rep.quarantined == [d.hex]
    assert os.path.exists(store.chunkstore.quarantine_chunk_path(md.fps[2], md.sizes[2]))
    assert not os.path.exists(path) and not mk_store(PORT, store.root).in_cache(d)


def test_scrub_bitflip_in_shared_chunk_quarantines_and_heals(tmp_path):
    """A bit flipped in a chunk two manifests share: the port's scrubber
    quarantines the chunk (kept, never deleted) and both blobs; a
    recommit and reconversion (the heal plane's storage half) rewrites
    the verified chunk under the same name, and both packages read both
    blobs bit-identically again."""
    from kraken_tpu_torch.store.scrub import Scrubber

    rng = np.random.default_rng(10)
    store = mk_store(PORT, tmp_path / "s")
    cs = store.chunkstore
    shared = blob_of(rng, 30_000)
    blobs = [shared + blob_of(rng, 10_000) for _ in range(2)]
    tabs = [([chunk_fp(b[i * 10_000:(i + 1) * 10_000]) for i in range(4)], [10_000] * 4)
            for b in blobs]
    ds = [add(PORT, store, b, tab=t) for b, t in zip(blobs, tabs)]
    shared_fp = chunk_fp(shared[:10_000])
    assert cs.refcount(shared_fp, 10_000) == 2
    with open(cs.chunk_path(shared_fp, 10_000), "r+b") as f:
        f.seek(5000)
        b0 = f.read(1)
        f.seek(5000)
        f.write(bytes([b0[0] ^ 1]))
    corrupted = []
    quarantined = asyncio.run(
        Scrubber(store, on_corrupt=lambda d, ns: corrupted.append(d.hex)).run_cycle())
    assert {d.hex for d in quarantined} == set(corrupted) == {d.hex for d in ds}
    q = cs.quarantine_chunk_path(shared_fp, 10_000)
    with open(q, "rb") as f:
        assert chunk_fp(f.read()) != shared_fp
    assert not any(store.in_cache(d) for d in ds)
    for b, d, t in zip(blobs, ds, tabs):
        uid = store.create_upload()
        store.write_upload_chunk(uid, 0, b)
        store.commit_upload(uid, d)
        assert store.convert_to_chunks(d, *t) is not None
    assert cs.verify_chunk(shared_fp, 10_000)
    jread = mk_store(JAX, store.root)
    for b, d in zip(blobs, ds):
        assert store.read_cache_file(d) == b and store.verify_cache_file(d)
        assert jread.read_cache_file(jax_digest.Digest.from_hex(d.hex)) == b


# -- herds: serve paths and the storage band ------------------------------------


def test_chunked_origin_serves_pieces_and_ranges_bit_identical(tmp_path):
    """A port origin with the tier on converts the blob after its dedup
    pass (recipe from the CDC pass on the CPU), and every read answers
    bit-identically: a full GET, the range forms the delta planner sends,
    416 past the end, and a swarm pull from the chunk-backed seeder. The
    reference's origin, given the same blob, writes the same chunk tree."""
    from kraken_tpu_torch.utils.httputil import HTTPError

    v1, _ = make_build_pair(np.random.default_rng(31), n_files=8)

    async def main(pkg):
        async with Herd(tmp_path / pkg, origin_pkg=pkg, agent_pkg=pkg,
                        origin_chunkstore=TIER_ON) as herd:
            d = await herd.upload(v1)
            await wait_chunked(herd.origin.store, d)
            assert herd.origin.store.chunkstore.logical_bytes() == len(v1)
            chunks = tree(herd.origin.store.chunkstore.root)
            if pkg == JAX:
                return chunks
            url = herd.url(d)
            assert await herd.http.get(url, retry_5xx=False) == v1
            for hdr, want in [(f"bytes=5000-{len(v1) - 4000}", v1[5000:len(v1) - 3999]),
                              ("bytes=0-0", v1[:1]), (f"bytes={len(v1) - 7000}-", v1[-7000:]),
                              ("bytes=-9000", v1[-9000:])]:
                status, headers, body = await herd.http.request_full(
                    "GET", url, headers={"Range": hdr}, retry_5xx=False, ok_statuses=(206,))
                assert status == 206 and body == want, hdr
                assert headers["Content-Range"].endswith(f"/{len(v1)}")
            with pytest.raises(HTTPError) as ei:
                await herd.http.get(url, headers={"Range": f"bytes={len(v1)}-"},
                                    retry_5xx=False)
            assert ei.value.status == 416
            got, moved = await herd.pull(d)
            assert got == v1 and moved >= len(v1)
            return chunks

    assert asyncio.run(main(PORT)) == asyncio.run(main(JAX))


def test_storage_band_build_over_build(tmp_path):
    """With the tier on the port agent, the build-over-build corpus
    stores <= 0.7x the flat control's bytes, the second build's delta copy
    reads from the chunk-backed first build, a pull from the tier is a
    cache hit, and the moved band (<= 0.6x of the control) still holds."""

    async def main():
        v1, v2 = make_build_pair(np.random.default_rng(7))
        async with Herd(tmp_path / "on", agent_delta=DELTA_ON, origin_delta={"enabled": True},
                        agent_chunkstore=TIER_ON) as herd:
            copied = herd.registry.counter("delta_bytes_copied_local_total")
            converts = herd.registry.counter("chunkstore_converts_total")
            d1 = await herd.upload(v1)
            k0 = converts.value(outcome="converted")
            assert (await herd.pull(d1))[0] == v1
            await wait_chunked(herd.agent.store, d1)
            assert converts.value(outcome="converted") == k0 + 1
            assert herd.agent.store.read_cache_file(d1) == v1
            d2 = await herd.upload(v2)
            c0 = copied.value()
            got2, moved2 = await herd.pull(d2)
            assert got2 == v2 and copied.value() > c0
            await wait_chunked(herd.agent.store, d2)
            stored_on = herd.agent.store.disk_usage_bytes()
            got2b, moved2b = await herd.pull(d2)
            assert got2b == v2 and moved2b == 0
        async with Herd(tmp_path / "off") as herd:
            await herd.pull(await herd.upload(v1))
            got2, moved_off = await herd.pull(await herd.upload(v2))
            assert got2 == v2
            stored_off = herd.agent.store.disk_usage_bytes()
        return moved2 / len(v2), moved_off / len(v2), stored_on / stored_off

    on, off, stored = asyncio.run(main())
    assert stored <= STORED_BAND_MAX, stored
    assert on <= MOVED_BAND_MAX * off, (on, off)


def test_live_reload_attaches_tier_and_default_off(tmp_path):
    """A shipped-off port agent attaches the tier by reload (the SIGHUP
    path); restarted with the knob off over the same store it still
    attaches (the tier holds state) with conversions off, and serves the
    chunk-backed blob; the reference's agent reads that store alike."""
    from kraken_tpu.assembly import AgentNode as JaxAgentNode
    from kraken_tpu_torch.assembly import AgentNode

    agent = AgentNode(store_root=str(tmp_path / "a"), tracker_addr="127.0.0.1:1", hasher="cpu")
    assert agent.store.chunkstore is None
    agent.reload({"chunkstore": {"enabled": True, "min_blob_bytes": 1}})
    assert agent.store.chunkstore is not None and agent.store.chunkstore.config.enabled
    blob = blob_of(np.random.default_rng(11), 50_000)
    d = add(PORT, agent.store, blob, n_chunks=5)
    for again in (AgentNode(store_root=str(tmp_path / "a"), tracker_addr="127.0.0.1:1",
                            hasher="cpu"),
                  JaxAgentNode(store_root=str(tmp_path / "a"), tracker_addr="127.0.0.1:1")):
        assert again.store.chunkstore is not None
        assert not again.store.chunkstore.config.enabled
        dig = type(d) if isinstance(again, AgentNode) else jax_digest.Digest
        assert again.store.read_cache_file(dig.from_hex(d.hex)) == blob
