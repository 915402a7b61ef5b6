"""Each cell's harness rehearsed on the CPU, and the runs that must give no
result."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from conftest import ROOT, SEED, run_cell

CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("trace", ["0", "1"])
def test_a_cpu_rehearsal_of_each_cell_is_correct_and_no_measurement(workload, trace):
    rc, res, err = run_cell(workload, "--cpu", "--trace", trace)
    assert rc == 0, err[-3000:]
    assert res["correct"] is True, res
    assert res["measurement"] is False
    assert res["device"]["platform"] == "cpu"
    # A CPU run names no device metric: busy time, idle share, roofline.
    assert "busy_s" not in res["device"]
    assert not [m for m in res["metrics"] if "roofline" in m or "idle" in m]
    if trace == "0":
        assert "setup_s" in res["metrics"]
    assert list(res)[-1] == "checks"
    assert all(c["value"] <= c["limit"] for c in res["checks"].values())


def test_a_run_without_a_card_and_without_the_cpu_request_gives_no_result():
    rc, res, err = run_cell("origin.regen-1g")
    assert rc != 0
    assert res is None
    assert "CUDA device" in err


def test_a_directory_with_only_the_benchmark_gives_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    rc, res, _err = run_cell("origin.regen-1g", "--cpu", cwd=tmp_path)
    assert rc != 0
    assert res is None


def test_a_per_layer_metric_without_its_workloads_is_refused():
    from portbench import harness

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    del bench["per_layer"][0]["workloads"]
    with pytest.raises(SystemExit, match="names no workloads"):
        harness.plan(bench, "origin.regen-1g")


def test_the_sweep_rehearses_on_the_cpu_and_stops_at_the_first_rate_not_sustained():
    p = subprocess.run(
        [sys.executable, "-m", "portbench.sweep", "--workload", "agent.pull-c2", "--seed",
         str(SEED), "--seconds", "2", "--rates", "1.0,0.5", "--pool", "4", "--grace", "10",
         "--witness", "1.5", "--cpu"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": ""})
    assert p.returncode == 0, p.stderr[-3000:]
    lines = [json.loads(l) for l in p.stdout.strip().splitlines()]
    windows = [l for l in lines if "rate" in l]
    sweep = [w["rate"] for w in windows if w["role"] == "sweep"]
    # Rising rates, stopping after the first that is not sustained.
    assert sweep == [0.5, 1.0] or (sweep == [0.5] and not windows[0]["sustained"])
    assert windows[-1]["role"] == "witness" and windows[-1]["rate"] == 1.5
    for w in windows:
        assert w["load"]["helper"]["cpu_s"] > 0 and w["load"]["agent"]["wall_s"] > 0
    assert lines[-1]["forbidden"] == [] and "kraken_tpu_torch" in lines[-1]["helper_modules"]


def test_a_traffic_file_and_entries_make_a_new_cell(tmp_path):
    """A later PR adds a cell with files and BENCHMARK.json entries only."""
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for name in ("kraken_tpu_torch", "config"):
        (tmp_path / name).symlink_to(ROOT / name)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "origin.regen-new", "config": "origin-c1",
                               "traffic": "regen-new", "chips": 1, "why": "a new mix"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "origin.regen-1g" in m.get("workloads", []):
            m["workloads"].append("origin.regen-new")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    (tmp_path / "portbench" / "traffic" / "regen-new.json").write_text(
        json.dumps({"driver": "origin_regen", "blob_key": [9]}))
    rc, res, err = run_cell("origin.regen-new", "--cpu", cwd=tmp_path)
    assert rc == 0, err[-3000:]
    assert res["correct"] is True
    assert "metainfo_gbps" in res["metrics"]
