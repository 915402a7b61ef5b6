"""The comparison that decides ``correct`` fails each fault a cell can have,
and its control, on the CPU with the timed path broken underneath."""

import pytest

from conftest import run_cell

FAULTS = ("alter_answer", "unchanged_state", "half_batch")


@pytest.mark.parametrize("workload", ["origin.regen-1g", "agent.pull-c2"])
@pytest.mark.parametrize("fault", FAULTS)
def test_each_planted_fault_comes_out_not_correct(workload, fault):
    rc, res, err = run_cell(workload, "--cpu", "--fault", fault)
    assert rc == 0, err[-3000:]
    assert res["correct"] is False, res["checks"]


@pytest.mark.parametrize("workload", ["origin.regen-1g", "agent.pull-c2"])
def test_the_control_comes_out_not_correct(workload):
    rc, res, err = run_cell(workload, "--cpu", "--control")
    assert rc == 0, err[-3000:]
    assert res["correct"] is False, res["checks"]


def test_a_fault_is_refused_outside_a_cpu_rehearsal():
    rc, res, err = run_cell("origin.regen-1g", "--fault", "alter_answer")
    assert rc != 0 and res is None
    assert "--fault is for CPU rehearsals" in err
