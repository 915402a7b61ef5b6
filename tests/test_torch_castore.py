"""The port's ``store/`` (the castore's upload half, its session journals,
the reads the origin's server makes, quarantine, durability modes, and the
origin's metadata sidecars) held against ``kraken_tpu.store``: a store root
written by one package is read by the other, and every sidecar's bytes are
the reference's. Blobs come from ``numpy.random.default_rng(seed)``."""

import errno
import os

import numpy as np
import pytest

import kraken_tpu.store as jax_store
import kraken_tpu.store.metadata as jax_md
import kraken_tpu_torch.store as port_store
import kraken_tpu_torch.store.metadata as port_md
from kraken_tpu.core.digest import Digest as JaxDigest
from kraken_tpu_torch.core.digest import Digest
from kraken_tpu_torch.store import CAStore, FileExistsInCacheError
from kraken_tpu_torch.store.castore import DigestMismatchError, UploadNotFoundError
from kraken_tpu_torch.store.metadata import NamespaceMetadata, PersistMetadata, pin, unpin
from kraken_tpu_torch.utils import failpoints

PKG = {"jax": (jax_store, jax_md, JaxDigest), "port": (port_store, port_md, Digest)}
PAIRS = [("jax", "port"), ("port", "jax")]


def blob_of(n: int, seed: int) -> bytes:
    return np.random.default_rng(seed).integers(0, 256, n, dtype=np.uint8).tobytes()


@pytest.fixture
def store(tmp_path):
    return CAStore(str(tmp_path / "store"))


@pytest.fixture
def chaos():
    failpoints.FAILPOINTS.disarm_all()
    yield failpoints.FAILPOINTS
    failpoints.FAILPOINTS.disarm_all()


def put(store, data: bytes) -> Digest:
    d = Digest.from_bytes(data)
    uid = store.create_upload()
    store.write_upload_chunk(uid, 0, data)
    store.commit_upload(uid, d)
    return d


def test_upload_half_streams_sizes_truncates_and_aborts(store):
    data = blob_of(10_000, 1)
    d = Digest.from_bytes(data)
    uid = store.create_upload()
    assert store.upload_exists(uid) and store.upload_path(uid).startswith(store.upload_dir)
    with store.open_upload_file(uid) as f:
        f.write(data[:6000])
        f.seek(6000)
        f.write(data[6000:])
    assert store.upload_size(uid) == len(data)
    store.truncate_upload(uid, 4000)
    assert store.upload_size(uid) == 4000
    with store.open_upload_file(uid) as f:
        f.seek(4000)
        f.write(data[4000:])
    store.commit_upload(uid, d)
    assert not store.upload_exists(uid)
    assert store.read_cache_file(d) == data
    assert b"".join(store.stream_cache_file(d)) == data
    uid2 = store.create_upload()
    store.abort_upload(uid2)
    store.abort_upload(uid2)  # idempotent
    assert not store.upload_exists(uid2)
    for call in (lambda: store.open_upload_file("nope"), lambda: store.upload_size("nope"),
                 lambda: store.truncate_upload("nope", 0),
                 lambda: store.write_upload_chunk("nope", 0, b"x"),
                 lambda: store.commit_upload("nope", d)):
        with pytest.raises(UploadNotFoundError):
            call()


def test_commit_verifies_and_cas_refuses_a_second_copy(store):
    uid = store.create_upload()
    store.write_upload_chunk(uid, 0, b"hello")
    store.write_upload_session(uid, {"digest": "x"})
    with pytest.raises(DigestMismatchError):
        store.commit_upload(uid, Digest.from_bytes(b"other"))
    assert not store.upload_exists(uid) and store.read_upload_session(uid) is None
    d = put(store, b"same")
    uid = store.create_upload()
    store.write_upload_chunk(uid, 0, b"same")
    with pytest.raises(FileExistsInCacheError):
        store.commit_upload(uid, d)
    # A precomputed digest substitutes for the re-read.
    uid = store.create_upload()
    store.write_upload_chunk(uid, 0, b"not what the digest says")
    fake = Digest.from_bytes(b"claimed")
    store.commit_upload(uid, fake, precomputed=fake)
    assert store.read_cache_file(fake) == b"not what the digest says"


def test_session_journal_lists_live_digests_and_tolerates_torn_docs(store):
    uids = [store.create_upload() for _ in range(3)]
    store.write_upload_session(uids[0], {"digest": "aa" * 32, "offset": 5})
    store.write_upload_session(uids[1], {"digest": "bb" * 32, "offset": 0})
    with open(store.upload_session_path(uids[2]), "wb") as f:
        f.write(b"{torn")
    assert store.read_upload_session(uids[0]) == {"digest": "aa" * 32, "offset": 5}
    assert store.read_upload_session(uids[2]) is None
    assert store.list_upload_sessions() == sorted(uids)
    assert store.live_upload_digests() == {"aa" * 32, "bb" * 32}
    store.abort_upload(uids[1])
    assert store.live_upload_digests() == {"aa" * 32}
    store.delete_upload_session(uids[0])
    store.delete_upload_session(uids[0])
    assert store.list_upload_sessions() == [uids[2]]


def test_readers_partials_and_fds(store):
    data = blob_of(50_000, 2)
    d = put(store, data)
    r = store.open_cache_reader(d)
    try:
        assert r.length == len(data)
        assert r.pread(100, 49_950) == data[49_950:]
        assert os.pread(r.fileno(), 10, 5) == data[5:15]
    finally:
        r.close()
        r.close()
    fd = store.open_cache_fd(d)
    try:
        assert os.pread(fd, 7, 3) == data[3:10]
    finally:
        os.close(fd)
    missing = Digest.from_bytes(b"missing")
    for call in (lambda: store.open_cache_reader(missing), lambda: store.open_cache_fd(missing),
                 lambda: list(store.stream_cache_file(missing))):
        with pytest.raises(KeyError):
            call()
    d2 = Digest.from_bytes(b"partial")
    store.allocate_partial_file(d2, 1 << 12)
    assert store.has_partial(d2) and not store.in_cache(d2)
    store.delete_partial_file(d2)
    store.delete_partial_file(d2)
    assert not store.has_partial(d2)
    store.create_cache_file(d2, iter([b"par", b"tial"]))
    store.create_cache_file(d2, iter([b"ignored: cached"]))
    assert store.read_cache_file(d2) == b"partial"


def test_quarantine_moves_the_blob_and_its_sidecars(store):
    data = blob_of(3000, 3)
    d = put(store, data)
    pin(store, d, "replicate")
    store.set_metadata(d, NamespaceMetadata("ns"))
    assert store.verify_cache_file(d)
    with open(store.cache_path(d), "r+b") as f:
        f.write(b"\x00")  # rot
    assert not store.verify_cache_file(d)
    q = store.quarantine_cache_file(d)
    assert q == store.quarantine_path(d) and open(q, "rb").read()[1:] == data[1:]
    assert not store.in_cache(d) and store.get_metadata(d, NamespaceMetadata) is None
    assert sorted(os.listdir(store.quarantine_dir)) == sorted(
        [d.hex, f"{d.hex}._md_namespace", f"{d.hex}._md_persist"])
    assert store.list_quarantined() == [d.hex]
    assert store.quarantine_cache_file(d) is None  # raced away: nothing to move
    assert not store.verify_cache_file(d)


@pytest.mark.parametrize("durability", ["rename", "fsync"])
def test_durability_modes_commit_the_same_tree(tmp_path, durability):
    s = CAStore(str(tmp_path / durability), durability=durability)
    d = put(s, b"durable")
    uid = s.create_upload()
    s.write_upload_session(uid, {"digest": d.hex})
    pin(s, d, "writeback")
    assert s.read_cache_file(d) == b"durable"
    assert s.read_upload_session(uid) == {"digest": d.hex}
    assert s.get_metadata(d, PersistMetadata).reasons == {"writeback"}
    with pytest.raises(ValueError):
        CAStore(str(tmp_path / "x"), durability="sometimes")


@pytest.mark.parametrize("name", ["castore.write", "castore.commit"])
def test_castore_failpoints_surface_enospc(store, chaos, name):
    uid = store.create_upload()
    store.write_upload_chunk(uid, 0, b"bytes")
    chaos.arm(name, "once")
    with pytest.raises(OSError) as ei:
        if name == "castore.write":
            store.write_upload_chunk(uid, 0, b"bytes")
        else:
            store.commit_upload(uid, Digest.from_bytes(b"bytes"))
    assert ei.value.errno == errno.ENOSPC
    # Nothing half-committed: a retry lands.
    store.commit_upload(uid, Digest.from_bytes(b"bytes"))
    assert store.read_cache_file(Digest.from_bytes(b"bytes")) == b"bytes"


def test_persist_pins_are_independent(store):
    d = put(store, b"pinned blob")
    pin(store, d, "writeback")
    pin(store, d, "replicate")
    assert store.get_metadata(d, PersistMetadata).persist
    unpin(store, d, "writeback")
    assert store.get_metadata(d, PersistMetadata).persist
    unpin(store, d, "replicate")
    assert not store.get_metadata(d, PersistMetadata).persist
    assert PersistMetadata.deserialize(b"1").reasons == {"writeback"}
    assert not PersistMetadata.deserialize(b"0").persist
    assert PersistMetadata.deserialize(PersistMetadata({"a", "b"}).serialize()).reasons == {"a", "b"}


@pytest.mark.parametrize("make", [
    lambda md: md.NamespaceMetadata("library/nginx"),
    lambda md: md.NamespaceMetadata(""),
    lambda md: md.PersistMetadata({"writeback", "replicate", "hint"}),
    lambda md: md.PersistMetadata(True),
    lambda md: md.PersistMetadata(False),
    lambda md: md.PieceStatusMetadata(11, bytearray([0xFF, 0x05])),
], ids=["namespace", "namespace-empty", "persist", "persist-true", "persist-false", "piece-status"])
def test_sidecar_bytes_are_the_references(make):
    port, jax = make(port_md), make(jax_md)
    assert port.name == jax.name
    assert port.serialize() == jax.serialize()
    assert type(port).deserialize(jax.serialize()).serialize() == jax.serialize()


@pytest.mark.parametrize("writer,reader", PAIRS)
def test_a_store_root_written_by_one_package_is_read_by_the_other(tmp_path, writer, reader):
    """Uploads in flight, their session journals, committed blobs, their
    namespace and persist sidecars, pins and quarantine: the state one
    package leaves on disk is the state the other picks up."""
    wstore, wmd, wdigest = PKG[writer]
    rstore, rmd, rdigest = PKG[reader]
    root = str(tmp_path / "store")
    w = wstore.CAStore(root)
    blobs = [blob_of(4096 + 100 * i, 10 + i) for i in range(3)]
    digests = []
    for data in blobs:
        d = wdigest.from_bytes(data)
        uid = w.create_upload()
        w.write_upload_chunk(uid, 0, data)
        w.commit_upload(uid, d)
        w.set_metadata(d, wmd.NamespaceMetadata("ns/a"))
        wmd.pin(w, d, "writeback")
        digests.append(d)
    wmd.pin(w, digests[0], "replicate")
    live = w.create_upload()
    w.write_upload_chunk(live, 0, blobs[0][:1000])
    doc = {"version": 1, "digest": digests[0].hex, "namespace": "ns/a", "offset": 1000,
           "piece_length": 1024, "piece_hashes": ""}
    w.write_upload_session(live, doc)
    w.quarantine_cache_file(digests[2])

    r = rstore.CAStore(root)
    rd = [rdigest.from_hex(d.hex) for d in digests]
    assert [d.hex for d in r.list_cache_digests()] == sorted(d.hex for d in digests[:2])
    for d, data in zip(rd[:2], blobs):
        assert r.read_cache_file(d) == data and r.verify_cache_file(d)
        assert r.get_metadata(d, rmd.NamespaceMetadata).namespace == "ns/a"
    assert r.get_metadata(rd[0], rmd.PersistMetadata).reasons == {"writeback", "replicate"}
    assert r.list_upload_sessions() == [live]
    assert r.read_upload_session(live) == doc
    assert r.live_upload_digests() == {digests[0].hex}
    assert r.upload_size(live) == 1000
    assert r.list_quarantined() == [digests[2].hex]
    # The reader carries the upload on and commits it where the writer sees it.
    with r.open_upload_file(live) as f:
        f.seek(1000)
        f.write(blobs[0][1000:])
    rmd.unpin(r, rd[0], "replicate")
    rd_new = rdigest.from_bytes(blobs[0] + b"!")
    uid = r.create_upload()
    r.write_upload_chunk(uid, 0, blobs[0] + b"!")
    r.commit_upload(uid, rd_new)
    r.abort_upload(live)
    back = wstore.CAStore(root)
    assert back.read_cache_file(wdigest.from_hex(rd_new.hex)) == blobs[0] + b"!"
    assert back.get_metadata(digests[0], wmd.PersistMetadata).reasons == {"writeback"}
    assert back.list_upload_sessions() == []
