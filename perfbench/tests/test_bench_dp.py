"""The controls of the data-parallel training cells: a run with a fault
planted in its ranks (``dp_faults.py``) comes out not ``correct``, for each
fault that only the ranks' collectives can make. The runs skip the look for
the cards (the cells cut to 32 envs a rank, gloo ranks on the CPU); the
limits are the cells' own."""

import time

import pytest

from perfbench import harness
from perfbench.tests import dp_faults
from perfbench.tests.small import small_cell

CELLS = [c["name"] for c in harness.load_json(f"{harness.ROOT}/BENCHMARK.json")["workloads"]
         if harness.resolve(harness.load_json(f"{harness.ROOT}/BENCHMARK.json"), c["name"])
         .traffic["driver"] == "train_dp"]


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", dp_faults.FAULTS)
def test_fault_in_the_ranks_fails_the_check(monkeypatch, cell, fault):
    small = small_cell(cell)
    dp_faults.planted(small, fault, monkeypatch.setattr)
    result = harness.run_cell(small, 2**31 + 13, 0.2, False, "cpu", time.perf_counter())
    failed = {k for k, c in result["checks"].items() if not c["value"] <= c["limit"]}
    print(fault, {k: c["value"] for k, c in result["checks"].items()})
    assert not result["correct"] and failed, result["checks"]
    if fault == "allreduce_left_out":
        assert "rank_learner_mismatch" in failed
    else:
        assert result["checks"]["rank_learner_mismatch"]["value"] == 0
