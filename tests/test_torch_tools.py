"""The port's operator tools held against ``kraken_tpu``'s on the CPU: the
SLO evaluator's burn rates and alert transitions, the ``trace``, ``flame``
and ``status`` subcommands (stdout and exit code on the same inputs) and
``promgen``'s files, byte for byte."""

import asyncio
import json
import os
import random
import socket
from pathlib import Path

import pytest

import kraken_tpu.cli as jax_cli
import kraken_tpu.utils.promgen as jax_promgen
import kraken_tpu.utils.slo as jax_slo
import kraken_tpu_torch.cli as port_cli
import kraken_tpu_torch.utils.promgen as port_promgen
import kraken_tpu_torch.utils.slo as port_slo
from kraken_tpu_torch.utils import http_lite
from test_torch_operator import jax_globals  # noqa: F401 (a fixture)
from test_torch_profiler import process_globals  # noqa: F401 (a fixture)

REPO = Path(__file__).resolve().parent.parent
CLI = {"port": port_cli, "jax": jax_cli}


def both(capsys, tool: str, *args, **kw) -> dict:
    """Each package's ``tool`` on the same arguments: (exit code, stdout)."""
    out = {}
    for pkg, cli in CLI.items():
        rc = getattr(cli, tool)(*args, **kw)
        out[pkg] = (rc, capsys.readouterr().out)
    return out


# -- the SLO evaluator ---------------------------------------------------------------

_SLO_CFG = {
    "bucket_seconds": 1.0,
    "eval_interval_seconds": 1.0,
    "objectives": {"pull": {"target": 0.9, "latency_threshold_seconds": 2.0},
                   "announce": {"target": 0.99}},
    "fast": {"short_seconds": 10, "long_seconds": 60, "burn_rate": 6.0},
    "slow": {"short_seconds": 30, "long_seconds": 120, "burn_rate": 2.0},
}


def _evaluations(slo_mod, steps) -> list:
    """A fresh manager of ``slo_mod`` on an injected clock, fed ``steps``
    (advance, [(sli, ok, latency, canary)...]) and evaluated after each:
    the documents without the wall-clock stamps, ``firing()`` and the
    burn gauges."""
    m = slo_mod.SLOManager()
    t = [1000.0]
    m._clock = lambda: t[0]
    m.config = slo_mod.SLOConfig.from_dict(_SLO_CFG)  # no evaluator thread
    out = []
    for advance, events in steps:
        t[0] += advance
        for sli, ok, latency, canary in events:
            m.record(sli, ok, latency, canary=canary)
        doc = m.evaluate()
        for sli_doc in doc.values():
            for alert in sli_doc["alerts"].values():
                alert["since_ts"] = alert["since_ts"] is not None
        out.append((doc, [{k: v for k, v in f.items() if k != "since_ts"} for f in m.firing()],
                    {w: m._g_burn.value(sli="pull", window=w) for w in ("10s", "30s", "1m", "2m")}))
    return out


def _slo_steps(seed: int) -> list:
    rng = random.Random(seed)
    steps = []
    for i in range(24):
        hot = 8 <= i < 14
        events = [("pull", rng.random() > (0.7 if hot else 0.02), rng.choice([0.1, 0.5, 3.0]),
                   rng.random() < 0.2) for _ in range(rng.randint(0, 12))]
        events += [("announce", rng.random() > 0.005, None, False) for _ in range(5)]
        steps.append((rng.choice([1.0, 2.5, 5.0]), events))
    return steps


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_the_evaluator_burns_and_alerts_as_the_references(process_globals, jax_globals, seed):
    steps = _slo_steps(seed)
    port, ref = _evaluations(port_slo, steps), _evaluations(jax_slo, steps)
    assert port == ref
    fired = [f for _doc, firing, _g in port for f in firing]
    if seed == 0:
        assert fired, "the hot stretch must page"


@pytest.mark.parametrize("seconds,label", [(300, "5m"), (3600, "1h"), (90, "90s"), (7200, "2h")])
def test_window_labels_are_the_references(seconds, label):
    assert port_slo.format_window(seconds) == jax_slo.format_window(seconds) == label


# -- trace ---------------------------------------------------------------------------

def _span(tid, sid, parent, name, node, start, dur, status="ok"):
    return {"trace_id": tid, "span_id": sid, "parent_id": parent, "name": name, "node": node,
            "start_ts": start, "duration_s": dur, "status": status, "attrs": {}}


def _trace_dumps(tmp_path) -> dict:
    """One canary probe's trace across agent, tracker and origin, and a
    second, faster trace on the agent alone."""
    a, b = "a" * 32, "b" * 32
    nodes = {
        "agent": [_span(a, "1" * 16, "", "canary.probe", "agent", 10.0, 0.9),
                  _span(a, "2" * 16, "1" * 16, "http.client GET", "agent", 10.1, 0.4),
                  _span(b, "7" * 16, "", "p2p.download", "agent", 20.0, 0.1, "error")],
        "tracker": [_span(a, "3" * 16, "2" * 16, "http.server GET /announce", "tracker",
                          10.15, 0.3)],
        "origin": [_span(a, "4" * 16, "3" * 16, "http.server GET /namespace/{ns}/blobs/{d}",
                         "origin", 10.2, 0.2)],
    }
    paths = {}
    for node, spans in nodes.items():
        p = tmp_path / f"{node}.jsonl"
        p.write_text("\n".join([json.dumps({"dump": "lameduck", "node": node})]
                               + [json.dumps(s) for s in spans]) + "\n")
        paths[node] = str(p)
    bad = tmp_path / "garbage.jsonl"
    bad.write_text("not json\n[1, 2]\n" + json.dumps(nodes["agent"][2]) + "\n{\n")
    paths["garbage"] = str(bad)
    return paths


TRACE_CASES = {
    "joined": (("agent", "tracker", "origin"), {}, 0),
    "one-trace": (("agent", "tracker", "origin"), {"trace_id": "a" * 32}, 0),
    "slowest": (("agent", "tracker", "origin"), {"slowest": 1}, 0),
    "propagation-break": (("agent", "origin"), {}, 1),
    "absent-trace": (("agent",), {"trace_id": "c" * 32}, 1),
    "unparseable-lines": (("garbage",), {}, 0),
}


@pytest.mark.parametrize("case", sorted(TRACE_CASES))
def test_trace_joins_dumps_as_the_references(tmp_path, capsys, case):
    names, kw, code = TRACE_CASES[case]
    paths = _trace_dumps(tmp_path)
    got = both(capsys, "run_trace_tool", [paths[n] for n in names], **kw)
    assert got["port"] == got["jax"]
    assert got["port"][0] == code


def test_trace_of_a_missing_file_is_a_usage_error(tmp_path, capsys):
    got = both(capsys, "run_trace_tool", [str(tmp_path / "nope.jsonl")])
    assert got["port"] == got["jax"] and got["port"][0] == 3


# -- flame ---------------------------------------------------------------------------

def _profile(path: Path, node: str, stacks: list, promised: int | None = None,
             extra: str = "") -> str:
    header = {"profile": "slo_fast_burn", "node": node, "ts": 1.0,
              "stacks": len(stacks) if promised is None else promised,
              "planes": {"verify": 3, "pump": 2, "idle": 5}}
    lines = [json.dumps(header)] + [json.dumps({"node": node, "stack": s, "count": c})
                                    for s, c in stacks]
    path.write_text("\n".join(lines) + "\n" + extra)
    return str(path)


FLAME_STACKS = [("MainThread;loop.py:run;storage.py:verify", 3),
                ("MainThread;loop.py:run;conn.py:pump", 2)]


def _flame_files(tmp_path) -> dict:
    return {
        "agent": _profile(tmp_path / "a.jsonl", "agent", FLAME_STACKS),
        "origin": _profile(tmp_path / "o.jsonl", "origin", FLAME_STACKS[:1]),
        "truncated": _profile(tmp_path / "t.jsonl", "agent", FLAME_STACKS, promised=5),
        "unparseable": _profile(tmp_path / "u.jsonl", "agent", FLAME_STACKS, extra="{oops\n"),
        "headless": str(tmp_path / "h.jsonl"),
        "missing": str(tmp_path / "missing.jsonl"),
    }


FLAME_CASES = {
    "two-nodes": (("agent", "origin"), {}, 0),
    "top": (("agent", "origin"), {"top": 1}, 0),
    "truncated": (("agent", "truncated"), {}, 1),
    "unparseable": (("unparseable",), {}, 1),
    "nothing-usable": (("headless", "missing"), {}, 3),
}


@pytest.mark.parametrize("case", sorted(FLAME_CASES))
def test_flame_folds_dumps_as_the_references(tmp_path, capsys, case):
    names, kw, code = FLAME_CASES[case]
    files = _flame_files(tmp_path)
    Path(files["headless"]).write_text(json.dumps({"hello": 1}) + "\n")
    got = both(capsys, "run_flame_tool", [files[n] for n in names], **kw)
    assert got["port"] == got["jax"]
    assert got["port"][0] == code


# -- status --------------------------------------------------------------------------

_INDEX = {"/health": ["GET"], "/debug/slo": ["GET"], "/debug/resources": ["GET"],
          "/debug/healthcheck": ["GET"], "/metrics": ["GET"]}


def _node_docs(**over) -> dict:
    docs = {
        "/debug/": {"component": "agent", "surfaces": dict(_INDEX)},
        "/health": "ok",
        "/debug/slo": {"firing": [], "last_eval": {"slis": {"pull": {"budget_remaining": 0.5}}},
                       "canary": {"result": "ok", "seq": 3, "age_seconds": 2.0,
                                  "interval_seconds": 60.0}},
        "/debug/resources": {"sentinels": {"agent/0": {"breach_latched": False}}},
        "/debug/healthcheck": {"origin-breaker": {"hosts": {"10.0.0.9:7610": {"state": "open"}}}},
    }
    docs.update(over)
    return docs


STATUS_CASES = {
    "healthy": ([_node_docs()], False, 0),
    "firing": ([_node_docs(**{"/debug/slo": {"firing": [{"sli": "pull", "severity": "page"}]}})],
               False, 1),
    "budget-spent": ([_node_docs(**{"/debug/slo": {
        "firing": [], "last_eval": {"slis": {"upload": {"budget_remaining": -0.2}}}}})], False, 1),
    "canary-failing": ([_node_docs(**{"/debug/slo": {"firing": [], "canary": {
        "result": "pull_fail", "seq": 9, "age_seconds": 1.0, "interval_seconds": 2.0}}})],
        False, 1),
    "canary-stale": ([_node_docs(**{"/debug/slo": {"firing": [], "canary": {
        "result": "pull_fail", "seq": 9, "age_seconds": 900.0, "interval_seconds": 2.0}}})],
        False, 0),
    "resources-latched": ([_node_docs(**{"/debug/resources": {
        "sentinels": {"agent/0": {"breach_latched": True}}}})], False, 1),
    "unhealthy": ([_node_docs(**{"/health": None})], False, 1),
    "no-health-route": ([_node_docs(**{"/debug/": {"component": "proxy",
                                                    "surfaces": {"/metrics": ["GET"]}}})],
                        False, 0),
    "unreadable-slo": ([_node_docs(**{"/debug/slo": None})], False, 1),
    "one-unreachable": ([_node_docs(), _node_docs()], True, 2),
}


def _fake_node(docs: dict) -> http_lite.Application:
    """A node's mux as the status tool reads it: each path's document, a
    ``None`` answering 503."""

    def answer(path):
        async def handler(request):
            doc = docs.get(path)
            if doc is None:
                return http_lite.Response(status=503, text="draining")
            if isinstance(doc, str):
                return http_lite.Response(text=doc)
            return http_lite.json_response(doc)
        return handler

    app = http_lite.Application()
    for path in docs:
        app.router.add_get(path, answer(path))
    return app


def _dead_addr() -> str:
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()
    return f"127.0.0.1:{port}"


def _status_table(out: str) -> str:
    """The tool's stdout with an unreachable row's error text cut: each
    package's HTTP client words a refused connection its own way."""
    return "\n".join(line.split("UNREACHABLE")[0] + "UNREACHABLE" if "UNREACHABLE" in line
                     else line for line in out.splitlines())


@pytest.mark.parametrize("case", sorted(STATUS_CASES))
def test_status_reads_fake_nodes_as_the_references(capsys, case):
    nodes, dead, code = STATUS_CASES[case]

    async def main():
        runners, addrs = [], []
        for docs in nodes:
            runner, port = await http_lite.serve(_fake_node(docs), "127.0.0.1", 0)
            runners.append(runner)
            addrs.append(f"127.0.0.1:{port}")
        if dead:
            addrs.append(_dead_addr())
        try:
            out = {}
            for pkg, cli in CLI.items():
                rc = await asyncio.to_thread(cli.run_status_tool, addrs, 2.0)
                out[pkg] = (rc, _status_table(capsys.readouterr().out))
            return out
        finally:
            for runner in runners:
                await runner.cleanup()

    got = asyncio.run(main())
    assert got["port"] == got["jax"]
    assert got["port"][0] == code


def test_status_without_nodes_is_a_usage_error(capsys):
    got = both(capsys, "run_status_tool", [])
    assert got["port"] == got["jax"] and got["port"][0] == 3


# -- the subcommands -----------------------------------------------------------------

def test_the_trace_subcommand_exits_with_the_tools_code(tmp_path, capsys):
    paths = _trace_dumps(tmp_path)
    with pytest.raises(SystemExit) as ei:
        port_cli.main(["trace", paths["agent"], paths["origin"]])
    assert ei.value.code == 1 and "ORPHAN" in capsys.readouterr().out


def test_the_flame_subcommand_exits_with_the_tools_code(tmp_path, capsys):
    files = _flame_files(tmp_path)
    with pytest.raises(SystemExit) as ei:
        port_cli.main(["flame", "--top", "1", files["agent"]])
    out = capsys.readouterr().out
    assert ei.value.code == 0 and out.splitlines()[0] == f"agent;{FLAME_STACKS[0][0]} 3"


def test_the_status_subcommand_needs_its_nodes(capsys):
    with pytest.raises(SystemExit) as ei:
        port_cli.main(["status"])
    assert ei.value.code == 3


def test_the_promgen_subcommand_writes_the_committed_files(tmp_path, capsys):
    port_cli.main(["promgen", "--out", str(tmp_path)])
    written = [json.loads(line)["path"] for line in capsys.readouterr().out.splitlines()]
    assert sorted(os.path.basename(p) for p in written) == sorted(PROMGEN_FILES)
    for name in PROMGEN_FILES:
        assert (tmp_path / name).read_bytes() == (REPO / "deploy/prometheus" / name).read_bytes()


# -- promgen -------------------------------------------------------------------------

PROMGEN_FILES = {"prometheus.yml": "generate_prometheus_config",
                 "kraken-alerts.yml": "generate_alert_rules"}


@pytest.mark.parametrize("name", sorted(PROMGEN_FILES))
def test_promgen_writes_the_references_files_byte_for_byte(tmp_path, name):
    fn = PROMGEN_FILES[name]
    port, ref = getattr(port_promgen, fn)(), getattr(jax_promgen, fn)()
    assert port == ref
    assert port.encode() == (REPO / "deploy/prometheus" / name).read_bytes()
    port_promgen.write_files(str(tmp_path / "port"))
    jax_promgen.write_files(str(tmp_path / "jax"))
    assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()


def test_promgen_names_only_metrics_the_port_registers():
    """Every metric the alert rules read is one the port's nodes export
    under the same name (a rule over a missing series never fires), the
    worker-shard crash counter of the multi-core data plane included."""
    names = port_promgen.referenced_metric_names(port_promgen.generate_alert_rules())
    assert names == jax_promgen.referenced_metric_names(jax_promgen.generate_alert_rules())
    sources = "\n".join(p.read_text() for p in (REPO / "kraken_tpu_torch").rglob("*.py"))
    missing = sorted(n for n in names if f'"{n}"' not in sources
                     and f'"{n.removesuffix("_bucket")}"' not in sources)
    assert missing == []
