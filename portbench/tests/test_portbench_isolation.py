"""Nothing the benchmark runs loads JAX or the JAX package, compared by the
whole top-level name (``kraken_tpu_torch`` begins with ``kraken_tpu``), and
the reference takes nothing of the port."""

import ast
import json
import subprocess
import sys

import pytest

from conftest import ROOT, SEED, run_cell

BENCH = ROOT / "portbench"
FORBIDDEN = {"jax", "jaxlib", "flax", "kraken_tpu"}
DRIVER_CELLS = ["origin.regen-1g", "agent.pull-c2"]

PROBE = """
import json, sys
from portbench.harness import main
import time
rc = main(time.monotonic(), sys.argv[1:])
print(json.dumps({"rc": rc, "top": sorted({m.split('.')[0] for m in sys.modules})}))
"""


def imports_of(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


@pytest.mark.parametrize("workload", DRIVER_CELLS)
def test_after_a_rehearsal_of_each_driver_no_jax_module_is_loaded(workload):
    p = subprocess.run([sys.executable, "-c", PROBE, "--workload", workload, "--seed", str(SEED),
                        "--seconds", "2", "--cpu"], cwd=ROOT, capture_output=True, text=True,
                       timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    got = json.loads(p.stdout.strip().splitlines()[-1])
    assert got["rc"] == 0
    assert "kraken_tpu_torch" in got["top"]
    assert not FORBIDDEN & set(got["top"])


def test_a_helper_process_that_loads_a_jax_module_refuses_the_result(tmp_path):
    """The agent cell's helper (a spawned process) reports the modules it
    loaded; a forbidden one there refuses the run, though the process that
    prints the result never loaded it."""
    (tmp_path / "jax").mkdir()
    (tmp_path / "jax" / "__init__.py").write_text("")
    (tmp_path / "sitecustomize.py").write_text(
        "import sys\n"
        "if '--multiprocessing-fork' in sys.argv:\n"
        "    import jax\n")
    rc, res, err = run_cell("agent.pull-c2", "--cpu", pythonpath=str(tmp_path))
    assert rc != 0
    assert res is None
    assert "['jax']" in err


def test_no_file_of_the_benchmark_imports_jax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        tops = {m.split(".")[0] for m in imports_of(path)}
        assert not FORBIDDEN & tops, path


def test_the_reference_imports_nothing_of_the_port():
    for path in (BENCH / "reference").rglob("*.py"):
        tops = {m.split(".")[0] for m in imports_of(path)}
        assert tops <= {"__future__", "hashlib", "os", "concurrent", "numpy"}, (path, tops)
