"""``tools/learning_runs.py``, the learning-run tool, on the CPU: its
parse of the runner's per-epoch lines, one tiny run through the port's CLI
(2 epochs of 8 envs) summarised in ``summary.json``, and one such run per
recipe (``asymm``, ``vanilla``, ``position``, ``d4_dr``) that finds every
summary key; for ``d4_dr`` also the supervisor, the stop once the level has
held at 1.0, and the eval of ``best_curriculum``. The reference has no such
tool; its learning numbers come from RESULTS.md."""

import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
import learning_runs  # noqa: E402

LINES = """\
[INFO] [22:34:26] [runner] epoch 1/300 frames 262144 fps 12 ep_rew 0.0 kl 0.0654 lr 5.93e-05
[INFO] [22:34:27] [runner] epoch 2/300 frames 524288 fps 131,072 ep_rew 476.5 kl 0.0065 lr 2.00e-04
"""
LEVEL_LINES = """\
[INFO] [10:00:00] [runner] epoch 7/7630 frames 1835008 fps 1 ep_rew 1.0 kl 0.01 lr 1e-4 level 0.995
[INFO] [10:00:01] [runner] epoch 8/7630 frames 2097152 fps 1 ep_rew 1.0 kl 0.01 lr 1e-4 level 1.000
[INFO] [10:00:02] [runner] epoch 9/7630 frames 2359296 fps 1 ep_rew 1.0 kl 0.01 lr 1e-4 level 0.980
[INFO] [10:00:03] [runner] epoch 10/7630 frames 2621440 fps 1 ep_rew 1.0 kl 0.01 lr 1e-4 level 1.000
[INFO] [10:00:04] [runner] epoch 11/7630 frames 2883584 fps 1 ep_rew 1.0 kl 0.01 lr 1e-4 level 1.000
"""
SUMMARY_KEYS = {"card", "recipe", "num_envs", "epochs", "concurrent_runs", "runs",
                "f32_median_final"}
RUN_KEYS = {"rc", "wall_s", "epochs_run", "final_ep_rew", "median_epoch_s", "ep_rew_every_10",
            "lr_every_10", "kl_every_10"}
CURRICULUM_KEYS = {"ended", "first_frame_at_level_1", "epochs_held_at_level_1",
                   "level_every_10", "best_curriculum", "eval"}
EVAL_KEYS = {"goals_attempted", "goals_solved", "goal_solve_rate", "successes_per_episode",
             "solve_time_steps", "censored_goal_age_median"}
TINY = ["--num-envs", "8", "--epochs", "2", "--device", "cpu", "--threads", "1",
        "--extra", "gym.sim.substeps=1", "rlg.params.config.steps_num=2"]


def test_parse_log_reads_the_runner_lines():
    rows = learning_runs.parse_log(LINES, horizon=32, num_envs=8192)
    assert sorted(rows) == [1, 2]
    assert rows[2] == {"ep_rew": 476.5, "kl": 0.0065, "lr": 2.0e-4, "epoch_s": 2.0,
                       "frames": 524288}
    assert rows[1]["epoch_s"] == pytest.approx(32 * 8192 / 12)


def test_level_one_reads_the_curriculum_lines():
    """The first frame at level 1.0 stays the first even after a retreat;
    the hold counts the epochs since the level last arrived there."""
    rows = learning_runs.parse_log(LEVEL_LINES, horizon=32, num_envs=8192)
    assert rows[7]["level"] == 0.995 and "level" not in learning_runs.parse_log(
        LINES, 32, 8192)[1]
    assert learning_runs.level_one(rows) == (2097152, 2)
    assert learning_runs.level_one({}) == (None, 0)


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


@pytest.mark.parametrize("argv", [
    ["--recipe", "asymm", "--runs", "vanilla_s42"],
    ["--recipe", "vanilla", "--runs", "vanilla_s42", "f32_s42"],
    ["--recipe", "d4_dr", "--runs"],
], ids=["other_recipe", "one_of_another", "none"])
def test_runs_outside_the_recipe_are_refused(tmp_path, capsys, argv):
    """A ``--runs`` selection must name runs of the chosen recipe, and at
    least one: otherwise nothing would run and the tool would report
    success."""
    with pytest.raises(SystemExit) as exc:
        learning_runs.main([*argv, "--out", str(tmp_path / "out")])
    assert exc.value.code == 2
    assert f"--runs must name runs of --recipe {argv[1]}" in capsys.readouterr().err
    assert not (tmp_path / "out").exists()


@pytest.mark.parametrize("recipe, runs", [
    ("asymm", ["f32_s42"]),
    ("vanilla", ["vanilla_s42"]),
    ("position", ["position_s7"]),
    ("d4_dr", ["d4dr_s42"]),
])
def test_each_recipe_finds_every_summary_key(tmp_path, recipe, runs):
    """8 envs x 2 epochs of each recipe; the D4 + DR run with 4-step
    episodes, so that its curriculum takes a sample and saves
    ``best_curriculum``, which is then evaluated."""
    out = tmp_path / "out"
    curriculum = ["--eval-envs", "8", "--eval-steps", "10", *TINY, "gym.episode_length=4"]
    rc = learning_runs.main(["--recipe", recipe, "--out", str(out), "--logdir-root",
                             str(tmp_path / "logs"), "--runs", *runs,
                             *(curriculum if recipe == "d4_dr" else TINY)])
    assert rc == 0
    with open(out / "summary.json") as f:
        summary = json.load(f)
    assert set(summary) == SUMMARY_KEYS and summary["recipe"] == recipe
    run = summary["runs"][runs[0]]
    assert run["rc"] == 0 and run["epochs_run"] == 2
    assert summary["f32_median_final"] == run["final_ep_rew"]
    if recipe == "d4_dr":
        assert set(run) == RUN_KEYS | CURRICULUM_KEYS and run["ended"] == "exit 0"
        assert run["first_frame_at_level_1"] is None and run["epochs_held_at_level_1"] == 0
        assert run["eval"]["rc"] == 0 and EVAL_KEYS <= set(run["eval"]["stats"])
        return
    assert set(run) == RUN_KEYS
    with open(out / f"{runs[0]}.log") as f:
        log = f.read()
    if recipe == "vanilla":
        assert "central_value_config" not in log and "asymmetric_obs: false" in log.lower()
    if recipe == "position":
        assert "command_mode: position" in log


def test_d4_dr_recipe_stops_at_level_one_and_evaluates(tmp_path):
    """The flagship recipe under the supervisor, its curriculum made to reach
    level 1.0 at the first sample (4-step episodes, a zero threshold): the
    tool stops it once the level has held, evaluates ``best_curriculum``
    and reports the first frame at level 1.0."""
    out = tmp_path / "out"
    argv = ["--recipe", "d4_dr", "--out", str(out), "--logdir-root", str(tmp_path / "logs"),
            "--hold-epochs", "2", "--eval-envs", "8", "--eval-steps", "10", *TINY,
            "gym.episode_length=4", "gym.goal_curriculum.up_step=1.0",
            "gym.goal_curriculum.up_threshold=-1", "gym.goal_curriculum.window_samples=1"]
    argv[argv.index("--epochs") + 1] = "100"
    assert learning_runs.main(argv) == 0
    with open(out / "summary.json") as f:
        summary = json.load(f)
    assert set(summary) == SUMMARY_KEYS and summary["recipe"] == "d4_dr"
    run = summary["runs"]["d4dr_s42"]
    assert set(run) == RUN_KEYS | CURRICULUM_KEYS
    assert run["ended"].startswith("level 1.0 held") and run["epochs_held_at_level_1"] >= 2
    assert run["epochs_run"] < 100 and run["first_frame_at_level_1"] is not None
    assert os.path.exists(run["best_curriculum"])
    assert run["eval"]["rc"] == 0 and EVAL_KEYS <= set(run["eval"]["stats"])
    assert run["eval"]["stats"]["checkpoint"] == run["best_curriculum"]
    assert run["eval"]["stats"]["level"] == 1.0
    with open(out / "d4dr_s42.log") as f:
        assert "[supervisor] resuming" not in f.read()


def test_d4_dr_supervisor_that_exits_nonzero_fails_the_run(tmp_path, monkeypatch):
    """A supervisor that ends on its own with a nonzero code (it gave up
    before level 1.0 held) fails the run, even with a ``best_curriculum``
    written and evaluated."""
    popen = subprocess.Popen

    def failing_supervisor(cmd, *args, **kwargs):
        if cmd[0] == "bash":  # the supervisor: its run, then exit 3
            cmd = ["bash", "-c", '"$@"; exit 3', "supervisor", *cmd]
        return popen(cmd, *args, **kwargs)

    monkeypatch.setattr(subprocess, "Popen", failing_supervisor)
    out = tmp_path / "out"
    argv = ["--recipe", "d4_dr", "--out", str(out), "--logdir-root", str(tmp_path / "logs"),
            "--eval-envs", "8", "--eval-steps", "10", *TINY, "gym.episode_length=4"]
    assert learning_runs.main(argv) == 1
    with open(out / "summary.json") as f:
        run = json.load(f)["runs"]["d4dr_s42"]
    assert run["ended"] == "exit 3" and run["rc"] == 3 and run["epochs_run"] == 2
    assert run["best_curriculum"] is not None and run["eval"]["rc"] == 0
