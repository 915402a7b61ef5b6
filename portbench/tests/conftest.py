"""The benchmark's own CPU tests: ``python -m pytest portbench/tests``
from the root of the repository. They run cells as a measurement would, as
subprocesses, at the configurations' rehearsal sizes."""

import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

# Seeds past 32 signed bits, which a measurement may be given.
SEED = 2**31 + 12345


def run_cell(workload: str, *extra: str, cwd: Path = ROOT, seconds: float = 2,
             timeout: float = 300, pythonpath: str = "") -> tuple[int, dict | None, str]:
    """One run of ``portbench.run``: its exit code, the JSON object on its
    last line of standard output (None when there is none) and its
    standard error."""
    p = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", workload, "--seed", str(SEED),
         "--seconds", str(seconds), *extra],
        cwd=cwd, capture_output=True, text=True, timeout=timeout,
        env={**os.environ, "PYTHONPATH": pythonpath})
    lines = p.stdout.strip().splitlines()
    try:
        last = json.loads(lines[-1]) if lines else None
    except json.JSONDecodeError:
        last = None
    if last is not None and "correct" not in last:
        last = None
    return p.returncode, last, p.stderr
