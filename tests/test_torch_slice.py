"""The ported slice end to end on the CPU -- origin metainfo generation, then
agent piece verify -- with ``kraken_tpu_torch`` on one side and
``kraken_tpu`` on the other, plus the store format both packages share.

The port runs its CUDA kernel's plain PyTorch version here (CPU tensors);
``kraken_tpu`` runs its portable XLA path (``use_pallas=False``). Every
comparison is bit-exact.
"""

import asyncio
import hashlib
import os

import numpy as np
import pytest
import torch

import kraken_tpu_torch as kt
from kraken_tpu.core.digest import Digest as JaxDigest
from kraken_tpu.ops.sha256 import JaxPieceHasher
from kraken_tpu.origin import metainfogen as jax_mig
from kraken_tpu.p2p import storage as jax_storage
from kraken_tpu.store import CAStore as JaxCAStore
from kraken_tpu.store import PieceStatusMetadata as JaxPieceStatus
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


PIECE = 64 * 1024
BLOB_LEN = 4 * PIECE + 45_000  # ~300 KiB: four full pieces + a ragged tail


def _blob(n: int, seed: int) -> bytes:
    return np.random.default_rng(seed).integers(0, 256, n, dtype=np.uint8).tobytes()


def _upload(store, blob: bytes, digest) -> None:
    uid = store.create_upload()
    store.write_upload_chunk(uid, 0, blob)
    store.commit_upload(uid, digest)


def test_slice_origin_to_agent(tmp_path):
    blob = _blob(BLOB_LEN, 0)
    d = kt.Digest.from_bytes(blob)
    port_hasher = kt.TorchPieceHasher(device="cpu")

    # 1-2. origin: upload, commit, generate -- the same MetaInfo as kraken_tpu
    ostore = kt.CAStore(str(tmp_path / "origin"))
    _upload(ostore, blob, d)
    mi = kt.Generator(
        ostore, hasher=port_hasher,
        piece_lengths=kt.PieceLengthConfig(((0, PIECE),)),
    ).generate_sync(d)
    jstore = JaxCAStore(str(tmp_path / "jax-origin"))
    _upload(jstore, blob, JaxDigest.from_bytes(blob))
    jmi = jax_mig.Generator(
        jstore, hasher=JaxPieceHasher(use_pallas=False),
        piece_lengths=jax_mig.PieceLengthConfig(((0, PIECE),)),
    ).generate_sync(JaxDigest.from_bytes(blob))
    assert mi.num_pieces == 5
    assert mi.serialize() == jmi.serialize()
    assert mi.info_hash.hex == jmi.info_hash.hex
    assert ostore.get_metadata(d, kt.TorrentMetaMetadata).metainfo == mi

    # 3. the wire: serialize -> deserialize
    mi2 = kt.MetaInfo.deserialize(mi.serialize())
    assert mi2 == mi and mi2.info_hash == mi.info_hash

    # 4-6. agent: every piece through Torrent.write_piece + BatchedVerifier
    verifier = kt.BatchedVerifier(port_hasher)
    seed = kt.OriginTorrentArchive(ostore, verifier).create_torrent(mi)
    astore = kt.CAStore(str(tmp_path / "agent"))
    leech = kt.AgentTorrentArchive(astore, verifier).create_torrent(mi2)
    batches = REGISTRY.counter("verify_batches_total")
    before = batches.value(path="cuda")
    bad = bytearray(seed.read_piece(2))
    bad[100] ^= 0xFF

    async def pull():
        good = [i for i in range(mi.num_pieces) if i != 2]
        results = await asyncio.gather(
            *(leech.write_piece(i, seed.read_piece(i)) for i in good),
            leech.write_piece(2, bytes(bad)),
            return_exceptions=True,
        )
        assert results[:-1] == [False] * len(good)
        assert isinstance(results[-1], kt.PieceError)  # corrupt: rejected
        assert not leech.complete() and leech.missing_pieces() == [2]
        return await leech.write_piece(2, seed.read_piece(2))  # rewritten

    assert asyncio.run(pull()) is True
    # One flush for the concurrent burst, one for the rewrite: the burst
    # coalesced, and the port labels its batches "cuda".
    assert batches.value(path="cuda") - before == 2
    assert leech.complete() and astore.in_cache(d)
    assert astore.read_cache_file(d) == blob
    assert not os.path.exists(astore.partial_path(d))
    leech.close()
    seed.close()


def test_port_reads_a_store_kraken_tpu_wrote(tmp_path):
    """kraken_tpu writes: a committed blob with its torrentmeta sidecar, and
    a half-finished download with its piece bitfield. The port reads both
    and finishes the download."""
    blob = _blob(5 * 4096 + 300, 1)
    jd = JaxDigest.from_bytes(blob)
    jstore = JaxCAStore(str(tmp_path / "o"))
    _upload(jstore, blob, jd)
    jgen = jax_mig.Generator(
        jstore, hasher=JaxPieceHasher(use_pallas=False),
        piece_lengths=jax_mig.PieceLengthConfig(((0, 4096),)),
    )
    jmi = jgen.generate_sync(jd)
    jagent = JaxCAStore(str(tmp_path / "a"))
    jver = jax_storage.BatchedVerifier(JaxPieceHasher(use_pallas=False))
    jt = jax_storage.AgentTorrentArchive(jagent, jver).create_torrent(jmi)

    async def half():
        for i in (0, 3):
            await jt.write_piece(i, blob[i * 4096 : (i + 1) * 4096])
        jt.close()

    asyncio.run(half())

    d = kt.Digest.from_str(jd.hex)
    ostore = kt.CAStore(str(tmp_path / "o"))
    assert ostore.in_cache(d) and ostore.read_cache_file(d) == blob
    mi = ostore.get_metadata(d, kt.TorrentMetaMetadata).metainfo
    assert mi.serialize() == jmi.serialize()
    assert mi.info_hash.hex == jmi.info_hash.hex
    # The generator finds the sidecar and does not re-hash.
    assert kt.Generator(ostore, hasher=kt.CPUPieceHasher()).generate_sync(d) == mi

    astore = kt.CAStore(str(tmp_path / "a"))
    status = astore.get_metadata(d, kt.PieceStatusMetadata)
    assert status.missing() == [1, 2, 4, 5]
    hasher = kt.TorchPieceHasher(device="cpu")
    t = kt.AgentTorrentArchive(astore, kt.BatchedVerifier(hasher)).create_torrent(mi)
    assert t.missing_pieces() == [1, 2, 4, 5]

    async def rest():
        done = await asyncio.gather(
            *(t.write_piece(i, blob[i * 4096 : (i + 1) * 4096]) for i in (1, 2, 4, 5))
        )
        assert sum(done) == 1

    asyncio.run(rest())
    assert astore.read_cache_file(d) == blob


def test_kraken_tpu_reads_a_store_the_port_wrote(tmp_path):
    blob = _blob(6 * 4096 + 1, 2)
    d = kt.Digest.from_bytes(blob)
    ostore = kt.CAStore(str(tmp_path / "o"))
    _upload(ostore, blob, d)
    hasher = kt.TorchPieceHasher(device="cpu")
    mi = kt.Generator(
        ostore, hasher=hasher, piece_lengths=kt.PieceLengthConfig(((0, 4096),))
    ).generate_sync(d)
    astore = kt.CAStore(str(tmp_path / "a"))
    t = kt.AgentTorrentArchive(astore, kt.BatchedVerifier(hasher)).create_torrent(mi)

    async def half():
        for i in (1, 6):
            await t.write_piece(i, blob[i * 4096 : (i + 1) * 4096])
        t.close()

    asyncio.run(half())

    jd = JaxDigest.from_str(d.hex)
    jstore = JaxCAStore(str(tmp_path / "o"))
    assert jstore.read_cache_file(jd) == blob
    jmi = jstore.get_metadata(jd, jax_mig.TorrentMetaMetadata).metainfo
    assert jmi.serialize() == mi.serialize()
    assert jmi.info_hash.hex == mi.info_hash.hex
    assert np.array_equal(
        np.frombuffer(jmi.piece_hashes, np.uint8).reshape(-1, 32),
        JaxPieceHasher(use_pallas=False).hash_pieces(blob, 4096),
    )
    jagent = JaxCAStore(str(tmp_path / "a"))
    assert jagent.get_metadata(jd, JaxPieceStatus).missing() == [0, 2, 3, 4, 5]
    jt = jax_storage.AgentTorrentArchive(
        jagent, jax_storage.BatchedVerifier(JaxPieceHasher(use_pallas=False))
    ).create_torrent(jmi)

    async def rest():
        for i in jt.missing_pieces():
            await jt.write_piece(i, blob[i * 4096 : (i + 1) * 4096])

    asyncio.run(rest())
    assert jagent.read_cache_file(jd) == blob


@pytest.mark.parametrize("package", ["kraken_tpu_torch", "kraken_tpu"])
def test_store_layout_is_pinned(tmp_path, package):
    """The on-disk format both packages share, spelled out byte for byte:
    the cache path, the torrentmeta sidecar (canonical JSON) and the piece
    bitfield sidecar. A change to either package's format fails here."""
    blob = bytes(range(256)) * 20  # 5120 bytes: five 1 KiB pieces
    hx = hashlib.sha256(blob).hexdigest()
    hashes = "".join(
        hashlib.sha256(blob[i : i + 1024]).hexdigest() for i in range(0, 5120, 1024)
    )
    info = (
        '{"length":5120,"name":"%s","piece_hashes":"%s","piece_length":1024}'
        % (hx, hashes)
    )
    want_meta = ('{"digest":"sha256:%s","info":%s,"version":1}' % (hx, info)).encode()
    want_status = b"\x00\x00\x00\x05" + bytes([0b00000101])  # pieces 0 and 2

    if package == "kraken_tpu_torch":
        store = kt.CAStore(str(tmp_path / "s"))
        d = kt.Digest.from_hex(hx)
        gen = kt.Generator(
            store, hasher=kt.TorchPieceHasher(device="cpu"),
            piece_lengths=kt.PieceLengthConfig(((0, 1024),)),
        )
        status = kt.PieceStatusMetadata(5)
    else:
        store = JaxCAStore(str(tmp_path / "s"))
        d = JaxDigest.from_hex(hx)
        gen = jax_mig.Generator(
            store, hasher=JaxPieceHasher(use_pallas=False),
            piece_lengths=jax_mig.PieceLengthConfig(((0, 1024),)),
        )
        status = JaxPieceStatus(5)
    _upload(store, blob, d)
    mi = gen.generate_sync(d)
    status.set(0)
    status.set(2)
    store.set_metadata(d, status)

    base = tmp_path / "s" / "cache" / hx[:2] / hx[2:4] / hx
    assert base.read_bytes() == blob
    assert (tmp_path / "s" / "cache" / hx[:2] / hx[2:4] / f"{hx}._md_torrentmeta").read_bytes() == want_meta
    assert (tmp_path / "s" / "cache" / hx[:2] / hx[2:4] / f"{hx}._md_piece_status").read_bytes() == want_status
    assert mi.info_hash.hex == hashlib.sha256(info.encode()).hexdigest()
    assert sorted(os.listdir(base.parent)) == [
        hx, f"{hx}._md_piece_status", f"{hx}._md_torrentmeta",
    ]
