"""On the card: the control (the plain reference's update computed in float32
with TF32 on, put in the program's place) fails each cell's limits where the
port passes them, at a size a test run holds (the cells' widths; 1024 envs,
8 steps an epoch, 43-step episodes, so that the window's first epoch holds
the time-outs). Run with
``python -m pytest -m cuda perfbench/tests/test_bench_cuda.py``."""

import time

import pytest

from perfbench import harness, readings
from perfbench.tests.small import small_cell

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the control computes in TF32 on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return "cuda:0"


def _cut(name: str) -> harness.Cell:
    cell = small_cell(name)
    full = harness.resolve(harness.load_json(f"{harness.ROOT}/BENCHMARK.json"), name)
    cell.config = full.config
    cell.config["rlg_params"]["config"]["steps_num"] = 8
    cell.config["gym"]["episode_length"] = 43
    cell.traffic = dict(cell.traffic, num_envs=1024, rollout_check_rows=32)
    return cell


@pytest.mark.parametrize("name", ["d1_asymm_8192", "d4_dr_8192"])
def test_control_fails_where_the_port_passes(card, name, tmp_path):
    cell = _cut(name)
    ctx = harness.Context(root=harness.ROOT, cell=cell.spec, config=cell.config,
                          traffic=cell.traffic, seed=2**31 + 21, seconds=0.0, trace=False,
                          device=card, tmpdir=str(tmp_path), t_start=time.perf_counter())
    run = readings.train_readings(ctx, cell.driver, control=True)
    limits = cell.limits["numbers"]
    assert all(v <= limits[k] for k, v in run["sound"].items()), run["sound"]
    assert any(v > limits[k] for k, v in run["control"].items()), run["control"]
