"""The port's store plane against the reference's, across the two packages'
stores: ``TTIMetadata`` bytes, ``CleanupManager`` (TTI, watermarks, the
upload-spool TTL), ``run_fsck`` on a store the other package wrote with the
same torn files planted, and the ``Scrubber`` with its ``store.scrub.bitflip``
failpoint. Blobs are seeded with numpy."""

import asyncio
import os
import time

import numpy as np
import pytest

import kraken_tpu.core.digest as jax_digest
import kraken_tpu.store as jax_store
import kraken_tpu.store.cleanup as jax_cleanup
import kraken_tpu.store.metadata as jax_metadata
import kraken_tpu.store.recovery as jax_recovery
import kraken_tpu.store.scrub as jax_scrub
import kraken_tpu.utils.failpoints as jax_failpoints
import kraken_tpu_torch.core.digest as port_digest
import kraken_tpu_torch.store as port_store
import kraken_tpu_torch.store.cleanup as port_cleanup
import kraken_tpu_torch.store.metadata as port_metadata
import kraken_tpu_torch.store.recovery as port_recovery
import kraken_tpu_torch.store.scrub as port_scrub
import kraken_tpu_torch.utils.failpoints as port_failpoints

STALE = 8 * 3600

PKG = {
    "jax": (jax_store, jax_digest, jax_metadata, jax_cleanup, jax_recovery, jax_scrub,
            jax_failpoints),
    "port": (port_store, port_digest, port_metadata, port_cleanup, port_recovery,
             port_scrub, port_failpoints),
}
PAIRS = [("jax", "port"), ("port", "jax"), ("port", "port")]


def blobs(n: int, size: int, seed: int) -> list[bytes]:
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, size + i, dtype=np.uint8).tobytes() for i in range(n)]


def put(kind: str, store, data: bytes, ns: str | None = "testns"):
    store_mod, digest_mod, md = PKG[kind][0], PKG[kind][1], PKG[kind][2]
    d = digest_mod.Digest.from_bytes(data)
    store.create_cache_file(d, iter([data]))
    if ns is not None:
        store.set_metadata(d, md.NamespaceMetadata(ns))
    return d


def backdate(path: str, seconds: float = STALE) -> None:
    t = time.time() - seconds
    os.utime(path, (t, t))


@pytest.mark.parametrize("t", [0.0, 1.0, 1234567890.123456, 1792239379.4105833])
def test_tti_metadata_bytes_equal_the_references(t):
    raw = port_metadata.TTIMetadata(t).serialize()
    assert raw == jax_metadata.TTIMetadata(t).serialize()
    assert port_metadata.TTIMetadata.deserialize(raw).last_access == t
    assert jax_metadata.TTIMetadata.deserialize(raw).last_access == t


# -- cleanup -----------------------------------------------------------------------


def _cleanup_store(kind: str, root):
    """Four blobs: a (touched now), b (last access 2 days ago), c (1 h
    ago), d (2 days ago, pinned); an abandoned spool and a live one."""
    store = PKG[kind][0].CAStore(str(root))
    md = PKG[kind][2]
    now = time.time()
    ds = [put(kind, store, b) for b in blobs(4, 20_000, 5)]
    for d, age in zip(ds, (0, 2 * 86400, 3600, 2 * 86400)):
        store.set_metadata(d, md.TTIMetadata(now - age))
    md.pin(store, ds[3], "writeback")
    old = store.create_upload()
    store.write_upload_chunk(old, 0, b"abandoned")
    backdate(store.upload_path(old))
    live = store.create_upload()
    store.write_upload_chunk(live, 0, b"live")
    return store, ds, old, live


@pytest.mark.parametrize("writer,sweeper", PAIRS)
def test_cleanup_evicts_what_the_reference_evicts(tmp_path, writer, sweeper):
    """TTI eviction, the upload-spool TTL and the persist pin, on a store
    the other package wrote; the watermark pass then evicts least
    recently used first down to the low mark."""
    store, ds, old, live = _cleanup_store(writer, tmp_path / "s")
    ref_store, ref_ds, _o, _l = _cleanup_store("jax", tmp_path / "r")
    mod = PKG[sweeper][3]
    sweeper_store = PKG[sweeper][0].CAStore(store.root)
    mgr = mod.CleanupManager(sweeper_store, mod.CleanupConfig(tti_seconds=86400))
    ref = jax_cleanup.CleanupManager(ref_store, jax_cleanup.CleanupConfig(tti_seconds=86400))
    mgr.touch(PKG[sweeper][1].Digest.from_hex(ds[0].hex))
    got = [d.hex for d in mgr.run_once()]
    want = [d.hex for d in ref.run_once()]
    assert got == [ds[1].hex] and want == [ref_ds[1].hex]
    assert not os.path.exists(store.upload_path(old))
    assert os.path.exists(store.upload_path(live))
    # Watermarks: high below the usage, low below what the pinned blob
    # alone holds -- every evictable blob goes, least recently used
    # first, the pinned blob never.
    size = len(store.read_cache_file(ds[0]))
    mgr.config = mod.CleanupConfig(tti_seconds=0, high_watermark_bytes=1,
                                   low_watermark_bytes=size + 200)
    ref.config = jax_cleanup.CleanupConfig(tti_seconds=0, high_watermark_bytes=1,
                                           low_watermark_bytes=size + 200)
    got = [d.hex for d in mgr.run_once()]
    want = [d.hex for d in ref.run_once()]
    assert got == [ds[2].hex, ds[0].hex] and want == [ref_ds[2].hex, ref_ds[0].hex]
    assert sweeper_store.in_cache(sweeper_store_digest(sweeper, ds[3]))
    assert sweeper_store.disk_usage_bytes() == jax_store.CAStore(store.root).disk_usage_bytes()


def sweeper_store_digest(kind, d):
    return PKG[kind][1].Digest.from_hex(d.hex)


def test_touches_flush_to_the_sidecar_the_reference_reads(tmp_path):
    store = port_store.CAStore(str(tmp_path / "s"))
    (d,) = [put("port", store, b) for b in blobs(1, 1000, 6)]
    mgr = port_cleanup.CleanupManager(store)
    mgr.touch(d, now=1234.5)
    assert mgr.run_once(now=1235.0) == []
    ref = jax_store.CAStore(store.root)
    got = ref.get_metadata(jax_digest.Digest.from_hex(d.hex), jax_metadata.TTIMetadata)
    assert got.last_access == 1234.5


def test_evict_callbacks_run_around_the_delete(tmp_path):
    store = port_store.CAStore(str(tmp_path / "s"))
    (d,) = [put("port", store, b) for b in blobs(1, 1000, 7)]
    store.set_metadata(d, port_metadata.TTIMetadata(1.0))
    seen = []
    mgr = port_cleanup.CleanupManager(
        store, port_cleanup.CleanupConfig(tti_seconds=10),
        on_evict=lambda x: seen.append(("before", store.in_cache(x))),
        after_evict=lambda x: seen.append(("after", store.in_cache(x))),
    )
    assert mgr.run_once() == [d]
    assert seen == [("before", True), ("after", False)]


# -- fsck ----------------------------------------------------------------------------


def _plant(kind: str, root):
    """A store with every class of crash debris the flat-store fsck
    repairs, written by ``kind``'s package."""
    store_mod, digest_mod, md = PKG[kind][0], PKG[kind][1], PKG[kind][2]
    s = store_mod.CAStore(str(root))
    good, torn, bare = blobs(3, 8_000, 8)
    d_good = put(kind, s, good)
    jax_recovery.write_clean_shutdown(jax_store.CAStore(s.root), now=time.time() - 60)
    d_torn = put(kind, s, torn, ns="crashns")
    with open(s.cache_path(d_torn), "r+b") as f:
        f.seek(100)
        f.write(b"\x00" * 16)
    d_bare = put(kind, s, bare, ns=None)  # data with no namespace sidecar
    # An orphan sidecar (its data never existed).
    orphan = digest_mod.Digest.from_hex("ab" * 32)
    os.makedirs(os.path.dirname(s.cache_path(orphan)), exist_ok=True)
    s.set_metadata(orphan, md.TTIMetadata(1.0))
    # A torn metadata write and a stale partial download.
    tmp_md = s.cache_path(d_good) + "._md_tti.tmp123.456"
    with open(tmp_md, "wb") as f:
        f.write(b"1.0")
    part = s.cache_path(digest_mod.Digest.from_hex("cd" * 32)) + ".part"
    os.makedirs(os.path.dirname(part), exist_ok=True)
    with open(part, "wb") as f:
        f.write(b"x")
    backdate(part)
    # A stale spool, a live spool with its journal, an orphan journal.
    stale = s.create_upload()
    s.write_upload_chunk(stale, 0, b"stale")
    backdate(s.upload_path(stale))
    live = s.create_upload()
    s.write_upload_chunk(live, 0, b"live")
    s.write_upload_session(live, {"version": 1, "digest": "e" * 64, "namespace": "n",
                                  "offset": 4, "piece_length": 65536, "piece_hashes": ""})
    with open(os.path.join(s.upload_dir, "gone" + s.SESSION_SUFFIX), "w") as f:
        f.write("{}")
    return s, d_good, d_torn, d_bare, live


@pytest.mark.parametrize("writer,checker", PAIRS)
def test_fsck_repairs_a_store_the_other_package_wrote_as_the_reference_does(
        tmp_path, writer, checker):
    s, d_good, d_torn, d_bare, live = _plant(writer, tmp_path / "s")
    _r, *_ = _plant(writer, tmp_path / "r")
    rec, store_mod = PKG[checker][4], PKG[checker][0]
    report = rec.run_fsck(store_mod.CAStore(s.root), expect_namespace=True)
    ref = jax_recovery.run_fsck(jax_store.CAStore(_r.root), expect_namespace=True)
    assert report.repairs == ref.repairs and report.repairs
    assert report.quarantined == [d_torn.hex] and ref.quarantined == [
        jax_digest.Digest.from_bytes(blobs(3, 8_000, 8)[1]).hex]
    assert report.exit_code == ref.exit_code == 2
    check = store_mod.CAStore(s.root)
    assert check.in_cache(sweeper_store_digest(checker, d_good))
    assert os.path.exists(check.upload_path(live))
    assert rec.quarantine_namespace(check, d_torn.hex) == "crashns"
    assert jax_recovery.read_clean_shutdown(jax_store.CAStore(s.root)) is not None


def test_fsck_leaves_the_references_chunk_manifests_alone(tmp_path, caplog):
    """A store with the reference's ``chunks/`` directory gets the tier
    attached (as a node does at start, ``assembly._sync_chunkstore``), and
    fsck runs the chunk tier's pass over it as the reference's does: the
    manifest sidecar counts as the blob's data and stays, the refcounts
    are rebuilt from it, and nothing is logged as skipped."""
    from kraken_tpu_torch.store.chunkstore import ChunkStore, ChunkStoreConfig

    s = port_store.CAStore(str(tmp_path / "s"))
    os.makedirs(os.path.join(s.root, "chunks"))
    s.attach_chunkstore(ChunkStore(os.path.join(s.root, "chunks"), ChunkStoreConfig(),
                                   quarantine_dir=s.quarantine_dir))
    d = port_digest.Digest.from_hex("12" * 32)
    os.makedirs(os.path.dirname(s.cache_path(d)), exist_ok=True)
    manifest = s.cache_path(d) + "._md_chunk_manifest"
    with open(manifest, "wb") as f:
        f.write(jax_metadata.ChunkManifestMetadata([], []).serialize())
    with caplog.at_level("WARNING", logger="kraken.recovery"):
        report = port_recovery.run_fsck(s)
    assert os.path.exists(manifest) and "orphan_sidecar" not in report.repairs
    assert s.is_chunked(d) and s.list_cache_digests() == [d]
    assert "A7f" not in caplog.text and "skipped" not in caplog.text


def test_fsck_orphan_failpoint_plants_and_repairs(tmp_path):
    s = port_store.CAStore(str(tmp_path / "s"))
    port_failpoints.FAILPOINTS.arm("store.fsck.orphan", "once")
    try:
        report = port_recovery.run_fsck(s)
    finally:
        port_failpoints.FAILPOINTS.disarm_all()
    assert report.repairs == {"orphan_sidecar": 1}


def test_clean_shutdown_stamps_read_across_packages(tmp_path):
    s = port_store.CAStore(str(tmp_path / "s"))
    port_recovery.write_clean_shutdown(s, now=123.25)
    assert jax_recovery.read_clean_shutdown(jax_store.CAStore(s.root)) == 123.25
    jax_recovery.write_clean_shutdown(jax_store.CAStore(s.root), now=456.5)
    assert port_recovery.read_clean_shutdown(s) == 456.5


# -- scrub ---------------------------------------------------------------------------


@pytest.mark.parametrize("writer,scrubber", PAIRS)
def test_scrub_quarantines_the_flipped_blob_on_a_store_the_other_wrote(
        tmp_path, writer, scrubber):
    store_mod = PKG[writer][0]
    s = store_mod.CAStore(str(tmp_path / "s"))
    ds = [put(writer, s, b, ns=f"ns{i}") for i, b in enumerate(blobs(3, 30_000, 9))]
    scrub_mod, fp = PKG[scrubber][5], PKG[scrubber][6]
    check = PKG[scrubber][0].CAStore(s.root)
    seen = []
    sc = scrub_mod.Scrubber(check, scrub_mod.ScrubConfig(bytes_per_second=0),
                            on_corrupt=lambda d, ns: seen.append((d.hex, ns)))

    async def main():
        assert await sc.run_cycle() == []
        fp.FAILPOINTS.arm("store.scrub.bitflip", "once")
        try:
            return await sc.run_cycle()
        finally:
            fp.FAILPOINTS.disarm_all()

    bad = asyncio.run(main())
    assert len(bad) == 1 and seen == [(bad[0].hex, f"ns{[d.hex for d in ds].index(bad[0].hex)}")]
    assert not check.in_cache(bad[0]) and os.path.exists(check.quarantine_path(bad[0]))
    with open(check.quarantine_path(bad[0]), "rb") as f:
        assert port_digest.Digest.from_bytes(f.read()).hex != bad[0].hex


def test_scrub_config_fields_match_the_references():
    import dataclasses

    assert [(f.name, f.default) for f in dataclasses.fields(port_scrub.ScrubConfig)] == [
        (f.name, f.default) for f in dataclasses.fields(jax_scrub.ScrubConfig)]
