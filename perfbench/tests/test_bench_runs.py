"""Every cell runs through its driver at 32 envs on the CPU and yields every
key; the per-layer readers read what a traced run gives them; the plain
reference agrees with the port, and a bfloat16 port fails it."""

import pytest

from perfbench import harness, trace
from perfbench.tests.small import run_small, small_cell

CELLS = [c["name"] for c in harness.load_json(f"{harness.ROOT}/BENCHMARK.json")["workloads"]]


@pytest.fixture(scope="module")
def runs():
    return {}


def _run(runs, name):
    if name not in runs:
        runs[name] = run_small(name, seed=2**31 + 11)
    return runs[name]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_and_yields_every_key(runs, cell):
    result = _run(runs, cell)
    spec = small_cell(cell)
    assert set(result["e2e"]) == {m["name"] for m in spec.end_to_end}
    assert all(v > 0 for v in result["e2e"].values())
    assert set(result["checks"]) == set(spec.limits["numbers"])
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0


@pytest.mark.parametrize("cell", CELLS)
def test_readers_read_a_traced_stretch(runs, cell):
    """Off the card the profiler sees no device: each reader gets a stretch
    as a traced run on the card would give it, and reads a number."""
    result = dict(_run(runs, cell))
    result["trace"] = trace.TraceSummary(
        window_s=1.0, busy_s=0.8, kernels=3200,
        kernel_s={"physics_step_kernel(LgConsts, ...)": 0.02, "gemm": 0.5},
        kernel_n={"physics_step_kernel(LgConsts, ...)": 64, "gemm": 100},
        device_ops=[("gemm", 0.5)], idle_gaps=[("cudaGraphLaunch", 0.01)])
    result["counters"] = dict(result["counters"], profiled_env_steps=2)
    result["spans"] = {k: v * 50 for k, v in result["spans"].items()}  # a window's worth
    ctx = result["ctx"]
    for entry, reader in small_cell(cell).per_layer:
        value = reader.read(result, ctx)
        assert value is not None and value > 0, entry["name"]
        if entry["unit"] == "%":
            assert value < 100.0, entry["name"]


@pytest.mark.parametrize("cell", CELLS)
def test_bfloat16_port_fails_the_reference(monkeypatch, cell):
    """The port with its bfloat16 towers, the precision under float32, is
    not correct by the cell's limits (the reference keeps the
    configuration's float32)."""
    import dataclasses

    from leibnizgym_tpu_torch.learning import ppo

    from_params = ppo.PPOConfig.from_rlg_params.__func__

    def bfloat16(cls, params, num_actors):
        return dataclasses.replace(from_params(cls, params, num_actors), network_dtype="bfloat16")

    monkeypatch.setattr(ppo.PPOConfig, "from_rlg_params", classmethod(bfloat16))
    result = run_small(cell, seed=2**31 + 12)
    assert ppo.PPOConfig.from_rlg_params({"config": {}}, 8).network_dtype == "bfloat16"
    assert not result["correct"], result["checks"]
