"""Delta pulls in the port (``kraken_tpu_torch.p2p.delta``), held against
``kraken_tpu``: the cases of ``tests/test_delta.py`` as cross-package
cases on numpy-seeded bytes at the reference's small
``CDCParams(256, 1024, 4096)`` and 16 KiB pieces.

- recipes and the diff: both packages serialize, refuse and diff the same
  recipes to the same bytes and spans (hypothesis for the tiling);
- herds in one process (tracker, origin, agent; the ``cpu`` hasher): the
  delta pull band (<= 0.6x of the delta-off control) on a port herd; a
  port agent delta-pulling from a reference origin and tracker, and the
  reverse; each package's ``/recipe``, ``/similar`` and ``/dedup/stats``
  answering alike on the same blobs; a live reload that turns delta on;
- the fallbacks: a corrupt base, a recipe miss, a base evicted mid-plan
  and a chunk rejected by fingerprint each end bit-identical.

There is no tolerance: every comparison is byte for byte.
"""

import asyncio
import json
import os
from urllib.parse import quote

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import kraken_tpu.core.metainfo as jax_metainfo
import kraken_tpu.p2p.delta as jax_delta
import kraken_tpu.utils.failpoints as jax_failpoints
import kraken_tpu.utils.metrics as jax_metrics
import kraken_tpu_torch.core.metainfo as port_metainfo
import kraken_tpu_torch.p2p.delta as port_delta
import kraken_tpu_torch.utils.failpoints as port_failpoints
import kraken_tpu_torch.utils.metrics as port_metrics
from kraken_tpu.core.digest import Digest as JaxDigest
from kraken_tpu_torch.core.digest import Digest
from test_torch_profiler import process_globals  # noqa: F401 (a fixture)

PORT, JAX = "port", "jax"
PKG = {
    PORT: (port_metainfo, port_delta, port_failpoints, port_metrics.REGISTRY, Digest),
    JAX: (jax_metainfo, jax_delta, jax_failpoints, jax_metrics.REGISTRY, JaxDigest),
}
PIECE = 16384
NS = "library/delta"
BAND_MAX = 0.6  # the reference's acceptance bar (tests/test_delta.py)
DELTA_ON = {"enabled": True, "min_blob_bytes": 1}
TIER_ON = {"enabled": True, "min_blob_bytes": 1}
_D = Digest.from_bytes(b"recipe-test")


@pytest.fixture(autouse=True)
def chaos_plane(process_globals):  # noqa: F811
    for fp in (port_failpoints, jax_failpoints):
        fp.FAILPOINTS.disarm_all()
        fp.allow()
    yield
    for fp in (port_failpoints, jax_failpoints):
        fp.FAILPOINTS.disarm_all()
        fp.allow(False)


def params(pkg):
    if pkg == PORT:
        from kraken_tpu_torch.ops.cdc import CDCParams
    else:
        from kraken_tpu.ops.cdc import CDCParams
    return CDCParams(min_size=256, avg_size=1024, max_size=4096)


# -- recipes and the diff, across the packages ---------------------------------


def recipe(pkg, digest_hex, fps, sizes):
    mi, _delta, _fp, _reg, dig = PKG[pkg]
    return mi.ChunkRecipe(dig.from_hex(digest_hex), fps, sizes)


def _random_table(rng, n):
    return (rng.integers(0, 1 << 63, size=n, dtype=np.uint64).tolist(),
            rng.integers(1, 1 << 20, size=n, dtype=np.uint32).tolist())


def test_chunk_recipe_roundtrip_property():
    rng = np.random.default_rng(11)
    for _ in range(50):
        fps, sizes = _random_table(rng, int(rng.integers(0, 64)))
        p, j = recipe(PORT, _D.hex, fps, sizes), recipe(JAX, _D.hex, fps, sizes)
        assert p.serialize() == j.serialize()
        assert jax_metainfo.ChunkRecipe.deserialize(p.serialize()) == j
        back = port_metainfo.ChunkRecipe.deserialize(j.serialize())
        assert back == p and back.length == j.length
        assert list(back.chunks()) == list(j.chunks())


def test_chunk_recipe_malformed():
    fps, sizes = _random_table(np.random.default_rng(1), 3)
    good = json.loads(recipe(PORT, _D.hex, fps, sizes).serialize())
    longer = dict(good, length=good["length"] + 1)
    short = dict(good, fps=good["fps"][:-2])
    bad = [b"not json", b'{"version":2}', b"[1,2,3]",
           json.dumps(longer).encode(), json.dumps(short).encode()]
    for pkg in (PORT, JAX):
        mi = PKG[pkg][0]
        for raw in bad:
            with pytest.raises(mi.MetaInfoError):
                mi.ChunkRecipe.deserialize(raw)
        with pytest.raises(mi.MetaInfoError):
            recipe(pkg, _D.hex, [1, 2], [10])
        with pytest.raises(mi.MetaInfoError):
            recipe(pkg, _D.hex, [1], [0])


POOL = st.lists(st.tuples(st.integers(0, (1 << 63) - 1), st.integers(1, 8191)),
                min_size=1, max_size=40)


@settings(max_examples=60, deadline=None)
@given(pool=POOL, data=st.data())
def test_diff_recipes_tiling_property(pool, data):
    """Both packages diff the same recipes into the same have and need
    spans, and the spans tile the target exactly (single and multi
    base)."""
    pick = st.lists(st.integers(0, len(pool) - 1), max_size=30)
    t_idx = data.draw(pick.filter(bool))
    b_idxs = data.draw(st.lists(pick, max_size=3))

    def build(pkg, idx):
        return recipe(pkg, _D.hex, [pool[i][0] for i in idx], [pool[i][1] for i in idx])

    out = {}
    for pkg in (PORT, JAX):
        d = PKG[pkg][1]
        target, bases = build(pkg, t_idx), [build(pkg, b) for b in b_idxs]
        single = d.diff_recipes(target, bases[0] if bases else build(pkg, []))
        multi = d.diff_recipes_multi(target, bases)
        out[pkg] = [([tuple(h) for h in haves], needs) for haves, needs in (single, multi)]
        for haves, needs in (single, multi):
            spans = sorted([(h.target_off, h.size) for h in haves] + list(needs))
            pos = 0
            for off, size in spans:
                assert off == pos
                pos += size
            assert pos == target.length
    assert out[PORT] == out[JAX]


def test_diff_recipes_merges_adjacent_needs():
    for pkg in (PORT, JAX):
        target = recipe(pkg, _D.hex, [1, 2, 3, 4], [10, 20, 30, 40])
        base = recipe(pkg, _D.hex, [1, 4], [10, 40])
        haves, needs = PKG[pkg][1].diff_recipes(target, base)
        assert [(h.target_off, h.size, h.base_off) for h in haves] == [(0, 10, 0), (60, 40, 10)]
        assert needs == [(10, 50)]


def test_delta_config_from_dict():
    for doc in ({"enabled": True, "max_bases": 5}, None, {"min_piece_cover": 0.5}):
        p = port_delta.DeltaConfig.from_dict(doc)
        j = jax_delta.DeltaConfig.from_dict(doc)
        assert vars(p) == vars(j)
    assert port_delta.DeltaConfig.from_dict(None).enabled is False
    with pytest.raises(ValueError):
        port_delta.DeltaConfig.from_dict({"enabld": True})


# -- in-process herds -----------------------------------------------------------


def make_build_pair(rng, n_files=24, file_kb=16, reuse=0.8):
    """The reference's ``_make_build_pair`` (``tests/test_delta.py``): two
    consecutive builds of (64 B unique header + file body), build 2
    reusing ``reuse`` of build 1's files in shuffled order."""
    files = [rng.integers(0, 256, size=file_kb * 1024, dtype=np.uint8).tobytes()
             for _ in range(2 * n_files)]

    def layer(members):
        parts = []
        for fi in members:
            parts.append(rng.integers(0, 256, size=64, dtype=np.uint8).tobytes())
            parts.append(files[fi])
        return b"".join(parts)

    m1 = list(range(n_files))
    n_keep = int(n_files * reuse)
    m2 = m1[:n_keep] + list(range(n_files, 2 * n_files - n_keep))
    rng.shuffle(m2)
    return layer(m1), layer(m2)


class Herd:
    """A tracker and an origin of ``origin_pkg`` and an agent of
    ``agent_pkg`` in this process, delta- and chunk-tier-capable, all on
    the ``cpu`` hasher. The tracker proxies recipes from the origin."""

    def __init__(self, tmp_path, origin_pkg=PORT, agent_pkg=PORT, agent_delta=None,
                 origin_delta=None, agent_chunkstore=None, origin_chunkstore=None):
        self.tmp, self.origin_pkg, self.agent_pkg = tmp_path, origin_pkg, agent_pkg
        self.kw = {"agent": {"delta": agent_delta, "chunkstore": agent_chunkstore},
                   "origin": {"delta": origin_delta, "chunkstore": origin_chunkstore}}

    async def __aenter__(self):
        if self.origin_pkg == PORT:
            from kraken_tpu_torch import assembly as oasm
            from kraken_tpu_torch.core.hasher import CPUPieceHasher
            from kraken_tpu_torch.origin.client import BlobClient, ClusterClient
            from kraken_tpu_torch.origin.dedup import DedupIndex
            from kraken_tpu_torch.origin.metainfogen import PieceLengthConfig
            from kraken_tpu_torch.placement import HostList, Ring

            extra = {"hasher": "cpu"}
            dedup = lambda store: DedupIndex(store, hasher=CPUPieceHasher(),  # noqa: E731
                                             params=params(PORT), device="cpu")
        else:
            from kraken_tpu import assembly as oasm
            from kraken_tpu.origin.client import BlobClient, ClusterClient
            from kraken_tpu.origin.dedup import DedupIndex
            from kraken_tpu.origin.metainfogen import PieceLengthConfig
            from kraken_tpu.placement import HostList, Ring

            extra = {}
            dedup = lambda store: DedupIndex(store, params=params(JAX))  # noqa: E731
        self.tracker = oasm.TrackerNode(announce_interval_seconds=0.1)
        await self.tracker.start()
        self.origin = oasm.OriginNode(
            store_root=str(self.tmp / "origin"), tracker_addr=self.tracker.addr,
            piece_lengths=PieceLengthConfig(table=((0, PIECE),)), **self.kw["origin"], **extra)
        self.origin.dedup = dedup(self.origin.store)
        await self.origin.start()
        self.cluster = ClusterClient(Ring(HostList(static=[self.origin.addr]), max_replica=2))
        self.tracker.server.origin_cluster = self.cluster
        if self.agent_pkg == PORT:
            from kraken_tpu_torch.assembly import AgentNode

            extra = {"hasher": "cpu"}
        else:
            from kraken_tpu.assembly import AgentNode

            extra = {}
        self.agent = AgentNode(store_root=str(self.tmp / "agent"),
                               tracker_addr=self.tracker.addr, **self.kw["agent"], **extra)
        await self.agent.start()
        from kraken_tpu_torch.utils.httputil import HTTPClient

        self.http = HTTPClient()
        self.oc = BlobClient(self.origin.addr)
        return self

    async def __aexit__(self, *exc):
        await self.http.close()
        await self.oc.close()
        await self.agent.stop()
        await self.origin.stop()
        await self.cluster.close()
        await self.tracker.stop()

    @property
    def registry(self):
        return PKG[self.agent_pkg][3]

    async def upload(self, blob: bytes):
        d = PKG[self.origin_pkg][4].from_bytes(blob)
        await self.oc.upload(NS, d, blob)
        return d

    async def pull(self, d) -> tuple[bytes, int]:
        """Pull through the agent's API: (bytes, bytes moved), moved = the
        swarm's piece bytes plus the delta plane's range fetches."""
        down = self.registry.counter("p2p_piece_bytes_down_total")
        fetched = self.registry.counter("delta_bytes_fetched_total")
        d0, f0 = down.value(), fetched.value()
        body = await self.http.get(
            f"http://{self.agent.addr}/namespace/{quote(NS, safe='')}/blobs/{d.hex}")
        return body, int((down.value() - d0) + (fetched.value() - f0))

    def url(self, d, tail="", who="origin") -> str:
        addr = (self.origin if who == "origin" else self.tracker).addr
        return f"http://{addr}/namespace/{quote(NS, safe='')}/blobs/{d.hex}{tail}"


async def wait_chunked(store, d, timeout: float = 15.0) -> None:
    loop = asyncio.get_running_loop()
    deadline = loop.time() + timeout
    while loop.time() < deadline:
        if store.is_chunked(d):
            return
        await asyncio.sleep(0.05)
    raise AssertionError(f"store never chunked {d.hex[:12]}")


async def band(tmp_path, origin_pkg, agent_pkg, rng_seed=7):
    """Build 1 then build 2 through a delta-on agent, then through a
    delta-off control; returns the two moved ratios and copied bytes."""
    v1, v2 = make_build_pair(np.random.default_rng(rng_seed))
    async with Herd(tmp_path / "on", origin_pkg, agent_pkg, agent_delta=DELTA_ON,
                    origin_delta={"enabled": True}) as herd:
        copied = herd.registry.counter("delta_bytes_copied_local_total")
        d1 = await herd.upload(v1)
        got1, moved1 = await herd.pull(d1)
        assert got1 == v1 and moved1 >= len(v1)
        d2 = await herd.upload(v2)
        c0 = copied.value()
        got2, moved2 = await herd.pull(d2)
        assert got2 == v2, "delta-assembled blob must be bit-identical"
        copied_bytes = copied.value() - c0
    async with Herd(tmp_path / "off", origin_pkg, agent_pkg) as herd:
        d1 = await herd.upload(v1)
        await herd.pull(d1)
        d2 = await herd.upload(v2)
        got2, moved_off = await herd.pull(d2)
        assert got2 == v2
    return moved2 / len(v2), moved_off / len(v2), copied_bytes


def test_delta_pull_band(tmp_path):
    """The band on a port herd: delta on moves <= 0.6x the bytes of the
    delta-off control, bit-identical, with local copies made. The port's
    own ``delta_stage_seconds_total`` splits the prefill's wall."""
    seconds = port_metrics.REGISTRY.counter("delta_stage_seconds_total")
    stages = ("prefill", "plan", "copy", "recheck", "fetch", "write")
    before = {k: seconds.value(stage=k) for k in stages}
    on, off, copied = asyncio.run(band(tmp_path, PORT, PORT))
    spent = {k: seconds.value(stage=k) - before[k] for k in stages}
    assert all(v > 0 for v in spent.values()), spent
    assert spent["prefill"] >= spent["plan"] + spent["copy"] + spent["write"]
    assert spent["copy"] >= spent["recheck"]
    assert copied > 0, "no local copies happened"
    assert off >= 0.95, f"control pull should move ~all bytes: {off}"
    assert on <= BAND_MAX * off, f"delta-on {on:.3f}x vs control {off:.3f}x"


@pytest.mark.parametrize("origin_pkg,agent_pkg", [(JAX, PORT), (PORT, JAX)],
                         ids=["port-agent-from-jax-origin", "jax-agent-from-port-origin"])
def test_delta_pulls_across_the_packages(tmp_path, origin_pkg, agent_pkg):
    """A port agent delta-pulls from a reference origin and tracker, and a
    reference agent from the port's: the recipe, ``/similar`` and the
    range fetches cross the packages, and the band holds."""
    on, off, copied = asyncio.run(band(tmp_path, origin_pkg, agent_pkg, rng_seed=17))
    assert copied > 0 and off >= 0.95
    assert on <= BAND_MAX * off, f"delta-on {on:.3f}x vs control {off:.3f}x"


def test_delta_live_reload_enables(tmp_path):
    """Shipped-off port nodes turn delta on by reload (the SIGHUP path):
    the origin's ``/recipe`` goes 404 -> 200, then the agent's planner."""
    from kraken_tpu_torch.utils.httputil import HTTPError

    async def main():
        v1, v2 = make_build_pair(np.random.default_rng(8))
        async with Herd(tmp_path) as herd:
            d1 = await herd.upload(v1)
            with pytest.raises(HTTPError) as ei:
                await herd.http.get(herd.url(d1, "/recipe"), retry_5xx=False)
            assert ei.value.status == 404
            herd.origin.reload({"delta": {"enabled": True}})
            got = port_metainfo.ChunkRecipe.deserialize(
                await herd.http.get(herd.url(d1, "/recipe"), retry_5xx=False))
            assert got.length == len(v1) and got.digest.hex == d1.hex
            herd.agent.reload({"delta": DELTA_ON})
            assert herd.agent.delta.config.enabled
            await herd.pull(d1)
            d2 = await herd.upload(v2)
            got2, moved2 = await herd.pull(d2)
            assert got2 == v2
            assert moved2 < len(v2), "the pull after the reload should have delta'd"

    asyncio.run(main())


def test_origin_recipe_similar_and_stats_answer_alike(tmp_path):
    """Each package's origin, given the same two builds, answers
    ``/recipe``, ``/similar`` and ``/dedup/stats`` with the same bytes;
    a second ``/recipe`` is a sidecar hit; the tracker's proxy stamps the
    serving origin and carries the same recipe."""

    async def answers(pkg):
        v1, v2 = make_build_pair(np.random.default_rng(9), n_files=6)
        reg = PKG[pkg][3]
        served = reg.counter("origin_recipe_requests_total")
        async with Herd(tmp_path / pkg, origin_pkg=pkg, agent_pkg=pkg,
                        origin_delta={"enabled": True}) as herd:
            d1, d2 = await herd.upload(v1), await herd.upload(v2)
            h0 = served.value(result="hit") + served.value(result="recompute")
            raw = await herd.http.get(herd.url(d1, "/recipe"), retry_5xx=False)
            assert await herd.http.get(herd.url(d1, "/recipe"), retry_5xx=False) == raw
            assert served.value(result="hit") + served.value(result="recompute") == h0 + 2
            for fp, off, size in port_metainfo.ChunkRecipe.deserialize(raw).chunks():
                assert port_metainfo.chunk_fp(v1[off:off + size]) == fp
            sim = await herd.http.get(herd.url(d2, "/similar"), retry_5xx=False)
            await asyncio.gather(*herd.origin.server._dedup_tasks)
            stats = await herd.http.get(f"http://{herd.origin.addr}/dedup/stats",
                                        retry_5xx=False)
            _status, headers, body = await herd.http.request_full(
                "GET", herd.url(d1, "/recipe", who="tracker"), retry_5xx=False)
            assert body == raw and headers.get("X-Kraken-Origin") == herd.origin.addr
            tsim = json.loads(await herd.http.get(herd.url(d1, "/similar", who="tracker"),
                                                  retry_5xx=False))
            assert "similar" in tsim
            return raw, json.loads(sim), json.loads(stats)

    port, jax = asyncio.run(answers(PORT)), asyncio.run(answers(JAX))
    assert port[0] == jax[0]
    assert port[1] == jax[1] and port[1]["similar"], port[1]
    for stats in (port[2], jax[2]):
        del stats["chunk_route_measured"]  # the router's timed rates, never equal
    assert port[2] == jax[2] and port[2]["blobs"] == 2 and port[2]["duplicate_bytes"] > 0


# -- the fallbacks --------------------------------------------------------------


def flip_every_24k(path: str, length: int) -> None:
    """At-rest corruption the recipe knows nothing about, every 24 KiB so
    that shared chunks are hit and not only the unique headers."""
    with open(path, "r+b") as f:
        for off in range(8192, length, 24576):
            f.seek(off)
            f.write(b"\xde\xad\xbe\xef")


def test_delta_corrupt_base_falls_back_bit_identical(tmp_path):
    """Bytes flipped in the agent's cached base: the fingerprint re-check
    rejects the damaged chunks, those pieces ride the swarm, and the pull
    is still bit-identical."""

    async def main():
        v1, v2 = make_build_pair(np.random.default_rng(10))
        async with Herd(tmp_path, agent_delta=DELTA_ON, origin_delta={"enabled": True}) as herd:
            rejects = herd.registry.counter("delta_chunk_verify_failures_total")
            d1 = await herd.upload(v1)
            assert (await herd.pull(d1))[0] == v1
            await asyncio.to_thread(flip_every_24k, herd.agent.store.cache_path(d1), len(v1))
            r0 = rejects.value()
            d2 = await herd.upload(v2)
            got2, _moved = await herd.pull(d2)
            assert got2 == v2, "a corrupt base must never reach the blob"
            assert rejects.value() > r0, "the fingerprint re-check never fired"

    asyncio.run(main())


def test_delta_recipe_miss_full_pull(tmp_path):
    """``origin.recipe.miss`` armed on the origin: the pull degrades to a
    full fetch, counted as a target recipe miss, bit-identical."""

    async def main():
        v1, v2 = make_build_pair(np.random.default_rng(12), n_files=8)
        async with Herd(tmp_path, agent_delta=DELTA_ON, origin_delta={"enabled": True}) as herd:
            misses = herd.registry.counter("delta_recipe_misses_total")
            pulls = herd.registry.counter("delta_pulls_total")
            await herd.pull(await herd.upload(v1))
            port_failpoints.FAILPOINTS.arm("origin.recipe.miss", "always")
            m0, p0 = misses.value(side="target"), pulls.value(outcome="recipe_miss")
            got2, moved2 = await herd.pull(await herd.upload(v2))
            assert got2 == v2 and moved2 >= len(v2)
            assert misses.value(side="target") == m0 + 1
            assert pulls.value(outcome="recipe_miss") == p0 + 1

    asyncio.run(main())


def test_delta_base_evicted_mid_plan_falls_back(tmp_path):
    """``p2p.delta.base.evict`` armed on the agent: the base is evicted
    between the plan and the copy, and the planner falls back to the full
    swarm pull, copying nothing, bit-identical."""

    async def main():
        v1, v2 = make_build_pair(np.random.default_rng(13), n_files=8)
        async with Herd(tmp_path, agent_delta=DELTA_ON, origin_delta={"enabled": True}) as herd:
            pulls = herd.registry.counter("delta_pulls_total")
            copied = herd.registry.counter("delta_bytes_copied_local_total")
            d1 = await herd.upload(v1)
            await herd.pull(d1)
            port_failpoints.FAILPOINTS.arm("p2p.delta.base.evict", "once")
            n0, c0 = pulls.value(outcome="no_cover"), copied.value()
            got2, moved2 = await herd.pull(await herd.upload(v2))
            assert got2 == v2 and moved2 >= len(v2)
            assert copied.value() == c0, "copied from an evicted base"
            assert pulls.value(outcome="no_cover") == n0 + 1
            assert not herd.agent.store.in_cache(d1)

    asyncio.run(main())


def test_copy_piece_holes_and_fp_reject(tmp_path):
    """``DeltaPlanner._copy_piece`` of both packages on the same base and
    spans: the same buffers, holes and copied counts; a chunk that
    straddles a piece is checked whole once; a wrong fingerprint rejects,
    counted once across the pieces it covers."""
    from kraken_tpu.store.chunkstore import FlatReader as JaxFlatReader
    from kraken_tpu_torch.store.chunkstore import FlatReader

    base = bytes(np.random.default_rng(3).integers(0, 256, 8192, np.uint8))
    path = tmp_path / "base"
    path.write_bytes(base)
    fp = port_metainfo.chunk_fp
    out = {}
    for pkg, reader_cls in ((PORT, FlatReader), (JAX, JaxFlatReader)):
        delta, reg = PKG[pkg][1], PKG[pkg][3]
        raw_fd = os.open(str(path), os.O_RDONLY)
        readers = [reader_cls(raw_fd, len(base))]
        try:
            planner = delta.DeltaPlanner.__new__(delta.DeltaPlanner)
            planner._chunk_rejects = reg.counter("delta_chunk_verify_failures_total")
            spans = [delta.HaveSpan(100, 1000, 0, fp(base[0:1000])),
                     delta.HaveSpan(2000, 500, 4000, fp(base[4000:4500]))]
            results = [planner._copy_piece(readers, 0, 4096, spans, {})]
            straddle = delta.HaveSpan(3900, 1000, 500, fp(base[500:1500]))
            verified = {}
            results.append(planner._copy_piece(readers, 0, 4096, [straddle], verified))
            results.append(planner._copy_piece(readers, 4096, 4096, [straddle], verified))
            assert list(verified.values()) == [True]
            bad = delta.HaveSpan(3900, 1000, 0, 12345)
            verified = {}
            r0 = planner._chunk_rejects.value()
            assert planner._copy_piece(readers, 0, 4096, [bad], verified) is None
            assert planner._copy_piece(readers, 4096, 4096, [bad], verified) is None
            assert list(verified.values()) == [False]
            assert planner._chunk_rejects.value() == r0 + 1
            out[pkg] = [(bytes(b), h, n) for b, h, n in results]
        finally:
            os.close(raw_fd)
    assert out[PORT] == out[JAX]
    (buf, holes, n), (b2, _h2, n2), (b3, _h3, n3) = out[PORT]
    assert n == 1500 and holes == [(0, 100), (1100, 900), (2500, 1596)]
    assert buf[100:1100] == base[0:1000] and buf[2000:2500] == base[4000:4500]
    assert n2 == 196 and b2[3900:4096] == base[500:696]
    assert n3 == 1000 - 196 and b3[:n3] == base[696:1500]


def test_the_card_phases_corpus_is_the_references_build_pair():
    """``chip_smoke.py`` phase 16 and these tests make their builds by the
    reference's ``_make_build_pair`` (``tests/test_delta.py``): the same
    seed gives the same bytes."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import chip_smoke
    from test_delta import _make_build_pair

    want = _make_build_pair(np.random.default_rng(7))
    assert make_build_pair(np.random.default_rng(7)) == want
    assert chip_smoke.make_build_pair(np.random.default_rng(7), 24, 16 * 1024, 0.8) == want
