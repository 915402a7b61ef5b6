"""The port reads the shipped config tree as it stands: ``utils/yaml_lite``
against ``yaml.safe_load`` (the nine files under ``config/`` and
hypothesis-generated documents of the subset), ``configutil.load_config``
against the reference's, every shipped section through the port's config
class against the reference's class, every top-level key read by the port's
CLI, every value that turns on an operator plane taken at start and by
SIGHUP, and the planes still waiting refused by name."""

import dataclasses
import json
import math
import os
from pathlib import Path

import pytest
import yaml
from hypothesis import given, settings
from hypothesis import strategies as st

import kraken_tpu.configutil as jax_configutil
from kraken_tpu_torch import assembly, cli, configutil
from kraken_tpu_torch.utils import yaml_lite
from test_torch_profiler import process_globals  # noqa: F401 (a fixture)

REPO = Path(__file__).resolve().parent.parent
CONFIG = REPO / "config"
ALL_FILES = sorted(str(p.relative_to(CONFIG)) for p in CONFIG.rglob("*.yaml"))
COMPONENT_FILES = [f for f in ALL_FILES if f.split("/")[0] in (
    "agent", "origin", "tracker", "build-index", "proxy")]


@pytest.fixture(autouse=True)
def _keep_logging():
    """``cli.main`` routes the root logger to JSON on stderr; give the
    rest of the session its handlers back."""
    import logging

    root = logging.getLogger()
    handlers, level = list(root.handlers), root.level
    yield
    root.handlers[:] = handlers
    root.setLevel(level)


def test_the_tree_has_nine_files_six_of_them_the_ported_components():
    # Since the front door was ported, all eight component files are: the
    # ninth is the shared base.
    assert len(ALL_FILES) == 9 and len(COMPONENT_FILES) == 8
    assert sorted(set(ALL_FILES) - set(COMPONENT_FILES)) == ["base.yaml"]


def same(a, b) -> bool:
    """Equality with NaN equal to itself, and types compared (``1`` and
    ``1.0``, ``True`` and ``1`` are not the same value here)."""
    if type(a) is not type(b):
        return False
    if isinstance(a, float) and math.isnan(a):
        return math.isnan(b)
    if isinstance(a, dict):
        return list(a) == list(b) and all(same(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
    return a == b


# -- yaml_lite ----------------------------------------------------------------


@pytest.mark.parametrize("name", ALL_FILES)
def test_yaml_lite_reads_each_shipped_file_as_safe_load_does(name):
    text = (CONFIG / name).read_text()
    assert same(yaml_lite.loads(text), yaml.safe_load(text))


_PLAIN = st.sampled_from([
    "yes", "No", "ON", "off", "True", "false", "y", "n", "~", "null", "Null",
    "0", "-0", "+12", "017", "0o17", "0x1F", "0b101", "1_000", "1:30", "-1:30",
    "190:20:30.15", "1.5", "-1.5e+3", "1e5", "1.0e5", "3.", ".5", ".inf",
    "-.Inf", ".NaN", "abc", "/var/cache/kraken", "http://h:1/x", "a-b_c",
    "it's", "x,y", "127.0.0.1:7602", "0.01", "1073741824", "--x", "-x",
])
_TEXT = st.text(
    st.characters(blacklist_categories=("Cs",), blacklist_characters="\r\x85\u2028\u2029\ufeff"),
    max_size=12,
)
_KEY = st.from_regex(r"[a-z][a-z0-9_]{0,8}", fullmatch=True)


def _scalar(draw) -> str:
    kind = draw(st.sampled_from(["plain", "double", "single", "int", "float"]))
    if kind == "plain":
        return draw(_PLAIN)
    if kind == "double":
        return json.dumps(draw(_TEXT))
    if kind == "single":
        return "'" + draw(_TEXT.filter(lambda s: "\n" not in s)).replace("'", "''") + "'"
    if kind == "int":
        return str(draw(st.integers(-10**12, 10**12)))
    return repr(draw(st.floats(allow_nan=False, allow_infinity=False, width=64)))


def _flow(draw, depth: int) -> str:
    if depth > 1 or draw(st.booleans()):
        return _scalar(draw)
    if draw(st.booleans()):
        items = draw(st.lists(st.builds(lambda: None), max_size=3))
        return "[" + ", ".join(_flow(draw, depth + 1) for _ in items) + "]"
    keys = draw(st.lists(_KEY, max_size=3, unique=True))
    return "{" + ", ".join(f"{k}: {_flow(draw, depth + 1)}" for k in keys) + "}"


def _comment(draw) -> str:
    return draw(st.sampled_from(["", "", "  # a comment", " # x: y 'q'"]))


def _mapping(draw, indent: int, depth: int) -> list[str]:
    lines = []
    for key in draw(st.lists(_KEY, min_size=1, max_size=4, unique=True)):
        pad = " " * indent
        if draw(st.booleans()):
            lines.append("#" + draw(_TEXT.filter(lambda s: "\n" not in s)))
        kind = draw(st.sampled_from(["scalar", "flow", "map", "seq"] if depth < 2 else ["scalar", "flow"]))
        if kind == "scalar":
            lines.append(f"{pad}{key}: {_scalar(draw)}{_comment(draw)}")
        elif kind == "flow":
            lines.append(f"{pad}{key}: {_flow(draw, 0)}{_comment(draw)}")
        elif kind == "map":
            lines.append(f"{pad}{key}:{_comment(draw)}")
            lines += _mapping(draw, indent + draw(st.sampled_from([2, 4])), depth + 1)
        else:
            lines.append(f"{pad}{key}:")
            seq_indent = indent + draw(st.sampled_from([0, 2]))
            for _ in range(draw(st.integers(1, 3))):
                if draw(st.booleans()):
                    lines.append(f"{' ' * seq_indent}- {_scalar(draw)}")
                else:
                    body = _mapping(draw, seq_indent + 2, depth + 1)
                    first = body.index(next(b for b in body if not b.startswith("#")))
                    body[first] = f"{' ' * seq_indent}- " + body[first].lstrip(" ")
                    lines += body
    return lines


@st.composite
def documents(draw) -> str:
    return "\n".join(_mapping(draw, 0, 0)) + "\n"


@settings(max_examples=300, deadline=None)
@given(documents())
def test_hypothesis_documents_of_the_subset_load_as_safe_load_does(text):
    try:
        want = yaml.safe_load(text)
    except yaml.YAMLError:
        with pytest.raises(ValueError):
            yaml_lite.loads(text)
        return
    assert same(yaml_lite.loads(text), want), text


@pytest.mark.parametrize("text,what", [
    ("a: &x 1\nb: *x\n", "anchors"),
    ("b: *x\n", "aliases"),
    ("a: !!str 1\n", "tags"),
    ("a: |\n  text\n", "block scalars"),
    ("a: >\n  text\n", "block scalars"),
    ("a: 1\n---\nb: 2\n", "document markers"),
    ("%YAML 1.1\n---\na: 1\n", "directives"),
    ("when: 2001-12-14\n", "date"),
    ("<<: {a: 1}\n", "merge keys"),
    ("? a\n: 1\n", "complex keys"),
    ("a: one\n  two\n", "span lines"),
    ("a: [1,\n  2]\n", "close on"),
    ("a: b: c\n", "mapping is not allowed"),
    ("a:\n\t- 1\n", "tabs"),
])
def test_constructs_outside_the_subset_raise_and_never_load_a_wrong_value(text, what):
    with pytest.raises(ValueError, match=what):
        yaml_lite.loads(text)


# -- configutil ----------------------------------------------------------------


@pytest.mark.parametrize("name", ALL_FILES)
def test_load_config_matches_the_references_on_every_file(name):
    path = str(CONFIG / name)
    assert same(configutil.load_config(path), jax_configutil.load_config(path))


def test_extends_merges_deep_and_the_overlay_wins(tmp_path):
    (tmp_path / "base.yaml").write_text("a: {x: 1, y: 2}\nb: 1\n")
    (tmp_path / "sub").mkdir()
    (tmp_path / "sub" / "c.yaml").write_text("extends: ../base.yaml\na: {y: 3}\nc: [1]\n")
    path = str(tmp_path / "sub" / "c.yaml")
    assert configutil.load_config(path) == jax_configutil.load_config(path) == {
        "a": {"x": 1, "y": 3}, "b": 1, "c": [1]}


# -- every shipped section through the port's config class ---------------------

SECTION_CLASSES = {
    "scheduler": ("kraken_tpu_torch.p2p.scheduler", "kraken_tpu.p2p.scheduler", "SchedulerConfig"),
    "rpc": ("kraken_tpu_torch.utils.deadline", "kraken_tpu.utils.deadline", "RPCConfig"),
    "resources": ("kraken_tpu_torch.utils.resources", "kraken_tpu.utils.resources", "ResourcesConfig"),
    "trace": ("kraken_tpu_torch.utils.trace", "kraken_tpu.utils.trace", "TraceConfig"),
    "profiling": ("kraken_tpu_torch.utils.profiler", "kraken_tpu.utils.profiler", "ProfilerConfig"),
    "slo": ("kraken_tpu_torch.utils.slo", "kraken_tpu.utils.slo", "SLOConfig"),
    "delta": ("kraken_tpu_torch.p2p.delta", "kraken_tpu.p2p.delta", "DeltaConfig"),
    "chunkstore": ("kraken_tpu_torch.store.chunkstore", "kraken_tpu.store.chunkstore", "ChunkStoreConfig"),
    "canary": ("kraken_tpu_torch.utils.canary", "kraken_tpu.utils.canary", "CanaryConfig"),
    "pex": ("kraken_tpu_torch.p2p.pex", "kraken_tpu.p2p.pex", "PexConfig"),
    "ingest": ("kraken_tpu_torch.core.ingest", "kraken_tpu.core.ingest", "IngestConfig"),
    "quorum": ("kraken_tpu_torch.origin.server", "kraken_tpu.origin.server", "QuorumConfig"),
    "scrub": ("kraken_tpu_torch.store.scrub", "kraken_tpu.store.scrub", "ScrubConfig"),
    "cleanup": ("kraken_tpu_torch.store.cleanup", "kraken_tpu.store.cleanup", "CleanupConfig"),
}


def _cls(module: str, name: str):
    import importlib

    return getattr(importlib.import_module(module), name)


def _build(cls, doc):
    if hasattr(cls, "from_dict"):
        return cls.from_dict(doc)
    return cls(**doc)


def _fields(obj):
    if dataclasses.is_dataclass(obj):
        return {f.name: _fields(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    if isinstance(obj, (list, tuple)):
        return [_fields(x) for x in obj]
    if hasattr(obj, "__dict__") and not isinstance(obj, type):
        return {k: _fields(v) for k, v in vars(obj).items() if not k.startswith("_")}
    return obj


SECTIONS = [
    (f, s) for f in COMPONENT_FILES
    for s in sorted(jax_configutil.load_config(str(CONFIG / f)))
    if s in SECTION_CLASSES
]


@pytest.mark.parametrize("name,section", SECTIONS, ids=[f"{f}:{s}" for f, s in SECTIONS])
def test_every_shipped_section_builds_the_ports_class_as_the_reference_builds_its(name, section):
    doc = configutil.load_config(str(CONFIG / name))[section]
    port_mod, ref_mod, cls_name = SECTION_CLASSES[section]
    port = _build(_cls(port_mod, cls_name), doc)
    ref = _build(_cls(ref_mod, cls_name), doc)
    assert _fields(port) == _fields(ref)


def test_the_port_config_classes_take_every_field_of_the_references():
    """``ProfilerConfig`` (and each class ported for the planes that
    wait) has every field of the reference's, with the same defaults."""
    for port_mod, ref_mod, name in SECTION_CLASSES.values():
        port, ref = _cls(port_mod, name), _cls(ref_mod, name)
        if dataclasses.is_dataclass(ref):
            assert _fields(port()) == _fields(ref()), name
    from kraken_tpu.utils.profiler import ProfilerConfig as Ref
    from kraken_tpu_torch.utils.profiler import ProfilerConfig as Port

    for bad in ({"hz": 0}, {"window_seconds": 0}, {"keep_windows": 0},
                {"loop_lag_interval_seconds": 0}, {"no_such_key": 1}):
        with pytest.raises(ValueError):
            Ref.from_dict(bad)
        with pytest.raises(ValueError):
            Port.from_dict(bad)


@pytest.mark.parametrize("name", COMPONENT_FILES)
def test_every_top_level_key_is_read_by_the_ports_cli(name):
    component = name.split("/")[0]
    cfg = configutil.load_config(str(CONFIG / name))
    unread = set(cfg) - cli.READS[component] - cli.IGNORED[component]
    assert unread == set()
    # The tracker, the build-index and the proxy hold no CAStore; the
    # shared base's cleanup: is their only key no node reads, as in the
    # reference.
    assert cli.IGNORED == {"tracker": {"cleanup"}, "origin": set(), "agent": set(),
                           "build-index": {"cleanup"}, "proxy": {"cleanup"}}


def test_an_unread_key_is_logged_never_dropped_silently(caplog):
    with caplog.at_level("WARNING", logger="kraken.cli"):
        cli._warn_unread("agent", {"host": "h", "registry_port_typo": 1})
    assert "registry_port_typo" in caplog.text


# -- values that turn on an operator plane --------------------------------------

PLANE_VALUES = [
    ("resources", {"max_rss_mb": 512}),
    ("resources", {"max_open_fds": 1024}),
    ("resources", {"drain_on_breach": True}),
    ("canary", {"enabled": True, "origins": "o:1"}),
]


def _agent(tmp_path, **kw):
    kw.setdefault("hasher", "cpu")
    return assembly.AgentNode(str(tmp_path / "a"), "", **kw)


def _origin(tmp_path, **kw):
    kw.setdefault("hasher", "cpu")
    return assembly.OriginNode(str(tmp_path / "o"), dedup=False, **kw)


# Origins have no canary section, in the reference either.
NODE_PLANES = [(n, *v) for n in ("agent", "origin") for v in PLANE_VALUES
               if not (n == "origin" and v[0] == "canary")]


def _plane_state(n, section: str, doc: dict):
    """What the node's running plane holds of ``doc``'s key: the sentinel's
    budget or the prober's flag."""
    key = next(iter(doc))
    plane = n.sentinel if section == "resources" else n.canary
    return getattr(plane.config, key)


@pytest.mark.parametrize("node,section,doc", NODE_PLANES,
                         ids=[f"{n}-{s}-{next(iter(d))}" for n, s, d in NODE_PLANES])
def test_a_value_that_turns_on_an_operator_plane_is_taken_at_start_and_by_sighup(
        tmp_path, process_globals, node, section, doc):
    """A resources: budget, drain_on_breach and canary.enabled turn their
    plane on at start, and a SIGHUP turns it off and on again, as in the
    reference. A started sentinel's sample breaches a budget exactly when
    its value exceeds it. A reload that raises keeps the whole config."""
    import asyncio

    make = _agent if node == "agent" else _origin
    key = next(iter(doc))

    async def main():
        n = make(tmp_path, **{section: doc})
        await n.start()
        try:
            assert _plane_state(n, section, doc) == doc[key]
            if section == "resources" and key != "drain_on_breach":
                sample = await n.sentinel.sample()
                kind = {"max_rss_mb": ("rss", "rss_mb"),
                        "max_open_fds": ("fds", "open_fds")}[key]
                assert (kind[0] in sample["breached"]) == (sample[kind[1]] > doc[key])
            n.reload({section: {}})
            assert not _plane_state(n, section, doc)
            before = getattr(n, f"{section}_config")
            with pytest.raises(ValueError, match="unknown"):
                n.reload({section: doc, "rpc": {"no_such_knob": 1}})
            assert getattr(n, f"{section}_config") is before
            assert not _plane_state(n, section, doc)
            n.reload({section: doc, "trace": {"sample_rate": 0.5}})
            assert _plane_state(n, section, doc) == doc[key]
            assert n.trace_config.sample_rate == 0.5
        finally:
            await n.stop()

    asyncio.run(main())


TIER_NODES = [(n, s) for n in ("agent", "origin") for s in ("delta", "chunkstore")]


@pytest.mark.parametrize("node,section", TIER_NODES,
                         ids=[f"{n}-{s}" for n, s in TIER_NODES])
def test_delta_and_the_chunk_tier_turn_on_at_start_and_on_and_off_by_sighup(
        tmp_path, node, section, caplog):
    """``delta.enabled`` and ``chunkstore.enabled`` load and run on both
    nodes (ROADMAP A7f), and a reload flips them live, as the
    reference's does. Turning the tier on attaches it to the store; off
    keeps it attached (its manifests stay readable) with conversions
    stopped. A reload that raises still keeps the whole config."""
    make = _agent if node == "agent" else _origin
    on = make(tmp_path / "on", **{section: {"enabled": True}})
    assert getattr(on, f"{section}_config").enabled
    if section == "chunkstore":
        assert on.store.chunkstore is not None
        assert on.store.chunkstore.config.enabled
    n = make(tmp_path / "live")
    assert not getattr(n, f"{section}_config").enabled
    assert n.store.chunkstore is None
    with caplog.at_level("INFO", logger="kraken.assembly"):
        n.reload({section: {"enabled": True}})
    assert getattr(n, f"{section}_config").enabled
    (rec,) = [r for r in caplog.records if r.getMessage() == "delta and chunk tier reloaded"]
    assert getattr(rec, f"{section}_enabled") is True
    if section == "chunkstore":
        tier = n.store.chunkstore
        assert tier is not None and tier.config.enabled
    before = getattr(n, f"{section}_config")
    with pytest.raises(ValueError, match="unknown"):
        n.reload({section: {"enabled": False}, "rpc": {"no_such_knob": 1}})
    assert getattr(n, f"{section}_config") is before
    n.reload({section: {"enabled": False}})
    assert not getattr(n, f"{section}_config").enabled
    if section == "chunkstore":
        assert n.store.chunkstore is tier and not tier.config.enabled


@pytest.mark.parametrize("name", ["tpu", "tpu-sharded", "gpu"])
def test_the_jax_hashers_are_refused_naming_the_ports(tmp_path, name):
    with pytest.raises(ValueError, match="'cpu'.*'cuda'" if name != "gpu" else "cpu"):
        _agent(tmp_path, hasher=name)
    with pytest.raises(ValueError, match="cuda-sharded" if name != "gpu" else "hasher"):
        _origin(tmp_path, hasher=name)


def test_the_nodes_default_to_the_card(monkeypatch, tmp_path):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from kraken_tpu_torch.core import hasher as hasher_mod

    monkeypatch.setattr(hasher_mod, "_INSTANCES", {})
    for make in (lambda: assembly.AgentNode(str(tmp_path / "a"), ""),
                 lambda: assembly.OriginNode(str(tmp_path / "o"))):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()


def test_a_cuda_sharded_node_takes_every_card_of_its_mesh(monkeypatch, tmp_path):
    """``cuda-sharded`` is a node hasher: without a card the nodes raise
    naming the CPU mesh; an origin on it gets IngestConfig()'s pipeline,
    as a cuda origin does; and the boot makes a context on every device of
    the mesh."""
    import torch

    from kraken_tpu_torch.core import hasher as hasher_mod
    from kraken_tpu_torch.core.ingest import IngestConfig
    from kraken_tpu_torch.ops import cuda_lib
    from kraken_tpu_torch.parallel import PieceMesh, ShardedPieceHasher, piece_mesh

    assert assembly.check_hasher("cuda-sharded") == "cuda-sharded"
    monkeypatch.setattr(hasher_mod, "_INSTANCES", {})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: _agent(tmp_path, hasher="cuda-sharded"),
                 lambda: _origin(tmp_path, hasher="cuda-sharded")):
        with pytest.raises(RuntimeError, match="platform='cpu'"):
            make()
    mesh = piece_mesh(2, platform="cpu")
    monkeypatch.setitem(hasher_mod._REGISTRY, "cuda-sharded", lambda: ShardedPieceHasher(mesh))
    node = _origin(tmp_path, hasher="cuda-sharded")
    assert node.ingest_config == IngestConfig()
    assert node.ingest_pipeline.hasher is node.generator.hasher
    assert node.generator.hasher.name == "cuda-sharded"

    touched = []
    monkeypatch.setattr(cuda_lib, "load", lambda: touched.append("load"))
    monkeypatch.setattr(torch, "zeros", lambda *a, device: touched.append(device))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device: None)
    cards = PieceMesh((torch.device("cuda", 0), torch.device("cuda", 1)))
    assembly._load_kernels(type("Sharded", (), {"mesh": cards, "device": cards.devices[0]})())
    assert touched == ["load", *cards.devices]
    touched.clear()
    assembly._load_kernels(node.generator.hasher)  # CPU shards: nothing to bring up
    assert touched == []


def test_the_observe_only_sentinel_and_the_prober_are_not_started(tmp_path, process_globals):
    """The shipped resources: section starts the observe-only sentinel
    (every budget 0: it samples and never breaches), and the node's stop()
    stops it and takes it off /debug/resources. The shipped canary:
    section builds the prober, which idles while enabled is false. The
    shipped delta: and chunkstore: sections (off) give the agent its
    planner, idle, and no chunk tier or reaper, as in the reference."""
    import asyncio

    from kraken_tpu_torch.utils import resources

    cfg = configutil.load_config(str(CONFIG / "agent/development.yaml"))

    async def main():
        n = assembly.AgentNode(
            str(tmp_path / "a"), "", hasher="cpu", resources=cfg["resources"],
            canary=cfg["canary"], delta=cfg["delta"], chunkstore=cfg["chunkstore"],
        )
        await n.start()
        try:
            assert not n.delta.config.enabled and n.chunk_gc is None
            assert n.store.chunkstore is None
            sentinel, canary = n.sentinel, n.canary
            assert sentinel._task is not None and not sentinel._task.done()
            assert (await sentinel.sample())["breached"] == []
            mine = [k for k, v in resources.debug_snapshot()["sentinels"].items()
                    if v["last_sample"] is sentinel.last_sample]
            assert len(mine) == 1
            assert not canary.config.enabled and canary._task is not None
            await asyncio.sleep(0)
            assert canary._seq == 0
            task = sentinel._task
        finally:
            await n.stop()
        await asyncio.sleep(0)
        assert task.done() and sentinel._task is None and n.sentinel is None
        assert n.canary is None and canary._task is None
        assert sentinel not in list(resources._instances)

    asyncio.run(main())


def test_an_origin_on_the_card_gets_an_ingest_pipeline_by_default(monkeypatch, tmp_path):
    """ROADMAP §C's decision: a cuda origin with no ingest: section
    hashes through IngestConfig()'s pipeline; a cpu origin has one only
    when its config asks."""
    from kraken_tpu_torch import CPUPieceHasher
    from kraken_tpu_torch.core.ingest import IngestConfig

    class CardHasher(CPUPieceHasher):
        name = "cuda"

    monkeypatch.setattr(assembly, "get_hasher", lambda name, workers=0: CardHasher())
    card = assembly.OriginNode(str(tmp_path / "c"), dedup=False)
    assert card.ingest_pipeline is not None and card.ingest_config == IngestConfig()
    assert card.generator.pipeline is card.ingest_pipeline
    cpu = assembly.OriginNode(str(tmp_path / "h"), hasher="cpu", dedup=False)
    assert cpu.ingest_pipeline is None


def test_the_data_plane_workers_flags_reach_the_scheduler_config(tmp_path, monkeypatch):
    """``--data-plane-workers`` and ``--leech-workers`` override the
    scheduler section of the agent; the origin takes the first and, as in
    the reference, drops the leech knobs."""
    built = {}

    async def capture(node, describe, config_path=None):
        built[describe["component"]] = node

    monkeypatch.setattr(cli, "_run_until_signal", capture)
    cli.main(["agent", "--hasher", "cpu", "--store", str(tmp_path / "a"),
              "--leech-workers", "2", "--data-plane-workers", "3"])
    cli.main(["origin", "--hasher", "cpu", "--store", str(tmp_path / "o"),
              "--data-plane-workers", "1"])
    agent = built["agent"].scheduler_config
    assert (agent.leech_workers, agent.data_plane_workers) == (2, 3)
    origin = assembly.OriginNode.build_scheduler_config(built["origin"]._scheduler_doc)
    assert origin.data_plane_workers == 1
    shared = assembly.OriginNode.build_scheduler_config(
        {"data_plane_workers": 1, "leech_workers": 4, "leech_ring_mb": 8})
    assert (shared.data_plane_workers, shared.leech_workers, shared.leech_ring_mb) == (1, 0, 32)


def test_a_registry_port_needs_a_build_index(capsys, tmp_path):
    """The reference's rule: the agent's registry endpoint resolves tags
    through a build-index, so a registry port without one exits 2."""
    with pytest.raises(SystemExit) as ei:
        cli.main(["agent", "--hasher", "cpu", "--store", str(tmp_path / "a"),
                  "--registry-port", "0"])
    assert ei.value.code == 2 and "--build-index" in capsys.readouterr().err


@pytest.mark.parametrize("args,needs", [
    (["proxy", "--build-index", "b:1"], "--origins"),
    (["proxy", "--origins", "o:1"], "--build-index"),
])
def test_the_proxy_needs_its_origins_and_build_index(capsys, args, needs):
    with pytest.raises(SystemExit) as ei:
        cli.main([*args, "--config", str(CONFIG / "proxy/base.yaml")])
    assert ei.value.code == 2 and needs in capsys.readouterr().err


def test_the_agent_stores_the_registry_settings(tmp_path):
    n = _agent(tmp_path, registry_port=0, build_index_addr="b:1", tag_cache_ttl=30.0,
               registry_strict_accept=True)
    assert (n.registry_port, n.build_index_addr, n.tag_cache_ttl,
            n.registry_strict_accept, n.registry_addr) == (0, "b:1", 30.0, True, None)


def test_failpoints_in_yaml_need_the_acknowledgement(capsys, monkeypatch, tmp_path):
    path = tmp_path / "a.yaml"
    path.write_text(f"extends: {CONFIG}/agent/development.yaml\nfailpoints:\n  castore.write: once\n")
    monkeypatch.delenv("KRAKEN_FAILPOINTS_ALLOW", raising=False)
    with pytest.raises(SystemExit) as ei:
        cli.main(["agent", "--config", str(path), "--store", str(tmp_path / "a")])
    assert ei.value.code == 2 and "KRAKEN_FAILPOINTS_ALLOW" in capsys.readouterr().err
    assert os.path.isabs(str(path))
