"""``tools/learning_runs.py``, the D1 learning-run driver, on the CPU: its
parse of the runner's per-epoch lines, and one tiny run through the port's
CLI (2 epochs of 8 envs) summarised in ``summary.json``. The reference has
no such tool; its learning numbers come from RESULTS.md."""

import json
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
import learning_runs  # noqa: E402

LINES = """\
[INFO] [22:34:26] [runner] epoch 1/300 frames 262144 fps 12 ep_rew 0.0 kl 0.0654 lr 5.93e-05
[INFO] [22:34:27] [runner] epoch 2/300 frames 524288 fps 131,072 ep_rew 476.5 kl 0.0065 lr 2.00e-04
"""


def test_parse_log_reads_the_runner_lines():
    rows = learning_runs.parse_log(LINES, horizon=32, num_envs=8192)
    assert sorted(rows) == [1, 2]
    assert rows[2] == {"ep_rew": 476.5, "kl": 0.0065, "lr": 2.0e-4, "epoch_s": 2.0}
    assert rows[1]["epoch_s"] == pytest.approx(32 * 8192 / 12)


def test_one_tiny_run_on_the_cpu(tmp_path):
    out = tmp_path / "out"
    rc = learning_runs.main(["--num-envs", "8", "--epochs", "2", "--device", "cpu",
                             "--out", str(out), "--logdir-root", str(tmp_path / "logs"),
                             "--runs", "bf16_s42", "--threads", "1",
                             "--extra", "gym.sim.substeps=1", "rlg.params.config.steps_num=2"])
    assert rc == 0
    with open(out / "summary.json") as f:
        summary = json.load(f)
    run = summary["runs"]["bf16_s42"]
    assert run["rc"] == 0 and run["final_ep_rew"] is not None
    assert summary["concurrent_runs"] == 1 and summary["f32_median_final"] is None
    with open(out / "bf16_s42.log") as f:
        assert "mixed_precision: true" in f.read().lower()
