"""The port's core fixtures (``kraken_tpu_torch.core.fixtures``) held
against ``kraken_tpu.core.fixtures``: the same seeds give the same bytes,
digests, metainfo and peers."""

import pytest

from kraken_tpu.core import fixtures as jax_fixtures
from kraken_tpu_torch.core import fixtures as port_fixtures


@pytest.mark.parametrize("seed", [0, 1, 7, 2024])
@pytest.mark.parametrize("size", [0, 1, 4096, 10_000])
def test_blobs_and_digests_equal(seed, size):
    assert port_fixtures.blob_fixture(size, seed) == jax_fixtures.blob_fixture(size, seed)
    assert str(port_fixtures.digest_fixture(seed)) == str(jax_fixtures.digest_fixture(seed))


@pytest.mark.parametrize("size,piece_length,seed", [
    (256 * 1024, 4 * 1024, 3), (10_000, 1024, 5), (1, 4096, 9), (8192, 8192, 11),
])
def test_metainfo_equal(size, piece_length, seed):
    pb, pm = port_fixtures.blob_and_metainfo_fixture(size, piece_length, seed)
    jb, jm = jax_fixtures.blob_and_metainfo_fixture(size, piece_length, seed)
    assert pb == jb
    assert pm.serialize() == jm.serialize()
    assert port_fixtures.metainfo_fixture(pb, piece_length).serialize() == pm.serialize()


def test_the_defaults_are_the_references():
    pb, pm = port_fixtures.blob_and_metainfo_fixture(seed=4)
    jb, jm = jax_fixtures.blob_and_metainfo_fixture(seed=4)
    assert (len(pb), pm.piece_length) == (256 * 1024, 4 * 1024)
    assert pm.serialize() == jm.serialize()


@pytest.mark.parametrize("seed", [0, 3, 99])
def test_peers_equal(seed):
    assert str(port_fixtures.peer_id_fixture(seed)) == str(jax_fixtures.peer_id_fixture(seed))
    for port in (0, 7001):
        p = port_fixtures.peer_info_fixture(port, seed, complete=True)
        j = jax_fixtures.peer_info_fixture(port, seed, complete=True)
        assert (str(p.peer_id), p.ip, p.port, p.complete) == (
            str(j.peer_id), j.ip, j.port, j.complete)
