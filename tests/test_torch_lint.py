"""The port's linter (``kraken_tpu_torch.lint``) held against
``kraken_tpu.lint`` on the same sources.

Every test of ``tests/test_lint.py`` that lints a tree (each rule's bad and
good fixtures, the two project rules, the pragma cases, the usage errors,
the reference's tree gate) runs again here with its ``lint_paths`` wrapped:
each call lints the same paths with both packages and holds the port's
findings to the reference's -- the same (rule, path, line, col), the same
message but for the registry's package path, the same counts -- before the
reference test's own assertions read the result. Then the port's CLI's exit
codes and JSON, and the port's own tree gate: ``lint_paths(
["kraken_tpu_torch"])`` is clean with either linter.
"""

import json
import os
import subprocess
import sys

import pytest

import kraken_tpu.lint as jax_lint
import kraken_tpu_torch.lint as port_lint
import test_lint
from kraken_tpu_torch.lint import engine as port_engine

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The reference's tests that lint a tree in process (the two CLI tests run
# ``python -m kraken_tpu.cli``; the port's CLI has its own test below).
LINTING_TESTS = sorted(
    name for name in dir(test_lint)
    if name.startswith("test_") and name != "test_cli_exit_codes_and_json_shape")


def _shape(findings) -> list:
    return [(f.rule, f.path, f.line, f.col,
             f.message.replace("kraken_tpu_torch/", "kraken_tpu/")) for f in findings]


def both_linters(calls: list):
    """A ``lint_paths`` that runs the port's linter and the reference's on
    the same paths and asserts that they agree."""

    def lint_paths(paths, root=None):
        try:
            port = port_lint.lint_paths(paths, root)
        except port_lint.LintUsageError as e:
            port = ("usage", str(e))
        try:
            ref = jax_lint.lint_paths(paths, root)
        except jax_lint.LintUsageError as e:
            assert port == ("usage", str(e))
            calls.append("usage")
            raise
        assert port != "usage" and _shape(port[0]) == _shape(ref[0]), (port, ref)
        assert port[1] == ref[1]
        calls.append(ref)
        return ref

    return lint_paths


@pytest.mark.parametrize("name", LINTING_TESTS)
def test_the_references_lint_tests_through_both_linters(name, tmp_path, monkeypatch):
    calls: list = []
    monkeypatch.setattr(test_lint, "lint_paths", both_linters(calls))
    fn = getattr(test_lint, name)
    fn(tmp_path) if fn.__code__.co_argcount else fn()
    assert calls, f"{name} linted nothing"


def test_the_rule_set_is_the_references():
    assert port_lint.RULE_IDS == jax_lint.RULE_IDS
    assert port_engine._UNSUPPRESSIBLE == {"pragma", "parse-error"}


def _cli(pkg: str, args, cwd=REPO):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "-m", f"{pkg}.cli", "lint", *args],
                          capture_output=True, text=True, timeout=300, cwd=cwd, env=env)


def test_the_cli_answers_as_the_references(tmp_path):
    """Exit 0 clean, 1 with findings (a line each, then the summary), the
    ``--json`` document, 3 for a missing path or none: the same codes and
    the same output as ``python -m kraken_tpu.cli lint``."""
    clean = tmp_path / "clean"
    clean.mkdir()
    (clean / "ok.py").write_text("x = 1\n")
    dirty = tmp_path / "dirty"
    dirty.mkdir()
    (dirty / "bad.py").write_text(
        "def f(x):\n    try:\n        return x()\n"
        "    except:\n        pass\n"
    )
    cases = ([str(clean)], [str(dirty)], [str(dirty), "--json"], [str(tmp_path / "nope")], [])
    for args in cases:
        port, ref = _cli("kraken_tpu_torch", args), _cli("kraken_tpu", args)
        assert (port.returncode, port.stdout) == (ref.returncode, ref.stdout), args
    assert [_cli("kraken_tpu_torch", a).returncode for a in cases] == [0, 1, 1, 3, 3]
    doc = json.loads(_cli("kraken_tpu_torch", [str(dirty), "--json"]).stdout)
    assert doc["findings"] == 1 and doc["results"][0]["rule"] == "bare-except"
    assert doc["results"][0]["line"] == 4


def test_run_lint_tool_in_process(tmp_path, capsys):
    assert port_lint.run_lint_tool([]) == 3
    notpy = tmp_path / "config.yaml"
    notpy.write_text("a: 1\n")
    assert port_lint.run_lint_tool([str(notpy)]) == 3
    (tmp_path / "m.py").write_text("import asyncio\n\nasync def f():\n    asyncio.create_task(g())\n")
    assert port_lint.run_lint_tool([str(tmp_path / "m.py")]) == 1
    out = capsys.readouterr().out.strip().splitlines()
    assert "fire-and-forget-task" in out[-2]
    assert json.loads(out[-1]) == {"event": "lint_done", "files": 1, "findings": 1,
                                   "suppressed": 0}


@pytest.mark.parametrize("linter", [port_lint, jax_lint], ids=["port", "jax"])
def test_the_ports_tree_gate_zero_findings(linter):
    """``lint kraken_tpu_torch/`` is clean under either linter: the port's
    pragmas carry their reasons, its failpoint registry
    (``utils/failpoints.py``) matches its fire sites, and every metric it
    registers is in the project's catalog or carries a reasoned pragma."""
    findings, stats = linter.lint_paths([os.path.join(REPO, "kraken_tpu_torch")], root=REPO)
    assert findings == [], "\n".join(f.render() for f in findings)
    assert stats["files"] > 90
    assert stats["suppressed"] >= 6


def test_the_ports_registry_is_the_one_the_port_reads(tmp_path):
    """A scan of the port reads the port's ``KNOWN_FAILPOINTS`` (found by
    its suffix): beside a copy of the port's registry, a fire site of an
    undeclared name is a finding whose message names the port's registry,
    and a declared one is not."""
    import shutil

    utils = tmp_path / "kraken_tpu_torch" / "utils"
    utils.mkdir(parents=True)
    shutil.copy(os.path.join(REPO, "kraken_tpu_torch", "utils", "failpoints.py"), utils)
    (tmp_path / "kraken_tpu_torch" / "mod.py").write_text(
        "from kraken_tpu_torch.utils import failpoints\n\n"
        "def f():\n"
        "    return failpoints.fire('store.scrub.bitflip') or failpoints.fire('no.such.point')\n")
    findings, _ = port_lint.lint_paths([str(tmp_path / "kraken_tpu_torch")], root=str(tmp_path))
    undeclared = [f for f in findings if f.path == "kraken_tpu_torch/mod.py"]
    assert [(f.rule, f.line) for f in undeclared] == [("failpoint-registry", 4)]
    assert "no.such.point" in undeclared[0].message
    assert "(kraken_tpu_torch/utils/failpoints.py)" in undeclared[0].message
