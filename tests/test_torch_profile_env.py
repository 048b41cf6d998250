"""The port's profiler (``leibnizgym_tpu_torch/scripts/profile_env.py``) on
the CPU: each workload at 8 envs in a window of one env step (the plain
physics step is ~80,000 operator calls) writes a Chrome trace and prints
its busy / idle and launch lines and its ten longest idle gaps, each with
the program span open at its end (the training epoch's ``epoch.*`` spans are
ranges of its trace). The reference's ``scripts/profile_env.py``
writes a JAX trace and prints no figures, so there is nothing to compare
numbers with; the trace holds the window's operator calls.
"""

import json
import os

import pytest
import torch

from leibnizgym_tpu_torch.scripts import profile_env

torch.set_num_threads(1)


@pytest.mark.parametrize("what, window", [
    ("env", ["--steps", "1"]),
    ("physics", ["--steps", "1"]),
    ("train", ["--epochs", "1", "--horizon", "1"]),
])
def test_profile_writes_a_trace_and_prints_its_figures(what, window, tmp_path, capsys):
    assert profile_env.main(["--what", what, "--num-envs", "8", "--device", "cpu",
                             "--trace-dir", str(tmp_path), *window]) == 0
    out = capsys.readouterr().out
    path = tmp_path / f"{what}_cpu_8.json"
    assert f"trace written to {path}" in out
    with open(path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "aten::mul" in names
    if what == "train":  # the epoch function's spans, as ranges of the trace
        assert {"epoch.launch.rollout", "epoch.launch.gae", "epoch.launch.update",
                "epoch.metrics"} <= names
    lines = [line for line in out.splitlines() if f"profile what={what}" in line]
    assert any("busy_ms=" in line and "idle_share=" in line and "wall_ms_unprofiled=" in line
               for line in lines)
    launch = next(line for line in lines if "launches_per_env_step=" in line)
    fields = dict(kv.split("=") for kv in launch.split() if "=" in kv)
    assert float(fields["launches_per_env_step"]) == 0.0  # no kernels on the CPU
    assert float(fields["ops_per_env_step"]) > 1000
    assert sum(" top ms=" in line for line in lines) == 10
    gaps = [line.split("span=")[1] for line in lines if " idle_gap ms=" in line]
    assert len(gaps) == 10
    if what == "train":  # every gap between operator calls ends inside an epoch span
        assert all(span.startswith("epoch.") for span in gaps), gaps


def test_profile_without_a_card_is_an_error(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        profile_env.main(["--what", "env", "--num-envs", "8"])
