"""The port's policy evaluation (``leibnizgym_tpu_torch/scripts/eval_policy.py``).

``goal_solve_stats`` and ``window_solve_rate`` on hand-built step records
whose raw and censoring-corrected rates are worked out below; the CLI on
the CPU at a tiny size writes the JSON keys of ``scripts/eval_policy.py``.
"""

import json
import os

import numpy as np
import pytest
import torch

from leibnizgym_tpu_torch.scripts import eval_policy

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the keys scripts/eval_policy.py writes (its ``out`` dict)
TOP_KEYS = {
    "checkpoint", "level", "num_envs", "num_steps", "goals_attempted", "goals_solved",
    "goal_solve_rate", "successes_per_episode", "solve_time_steps",
    "censored_goal_age_median", "unsolved_pos_dist_median_m", "unsolved_ori_dist_median_rad",
}
CORRECTED_KEYS = {"p90_solve_time_steps", "censored_goals", "censored_with_fair_chance",
                  "corrected_solve_rate", "failure_modes"}
FAILURE_KEYS = {"pos_tolerance_m", "ori_tolerance_rad", "ori_only", "pos_only", "both",
                "neither_at_cutoff", "fair_unsolved_pos_err_median_m",
                "fair_unsolved_ori_err_median_rad"}


def _record(steps=10, n=2):
    z = np.zeros((steps, n))
    return z > 0, z > 0, z.copy(), z.copy()


def test_goal_solve_stats_hand_built():
    """Env 0 solves at steps 3 and 7 (ages 4, 4), then its episode ends at
    step 9 with a goal 2 steps old: censored, no fair chance. Env 1 solves at
    step 0 (age 1); its next goal is 9 steps old at the episode end: censored
    with a fair chance (p90 of [1, 4, 4] is 4), 1 cm off (inside 2 cm) and
    0.5 rad off (outside 0.25 rad). Raw 3 / 5, corrected 3 / (3 + 1)."""
    succ, ep_reset, pos, ori = _record()
    succ[3, 0] = succ[7, 0] = succ[0, 1] = True
    ep_reset[9, :] = True
    pos[9] = [0.05, 0.01]
    ori[9] = [0.1, 0.5]
    out = eval_policy.goal_solve_stats(succ, ep_reset, pos, ori, 10, 0.02, 0.25)
    assert out["goals_solved"] == 3 and out["goals_attempted"] == 5
    assert out["goal_solve_rate"] == 0.6
    assert out["successes_per_episode"] == 1.5  # 3 over 20 env-steps / 10
    assert out["solve_time_steps"] == {"mean": 3.0, "median": 4.0, "p90": 4.0, "max": 4}
    assert out["censored_goal_age_median"] == 5.5
    assert out["unsolved_pos_dist_median_m"] == 0.03
    assert out["unsolved_ori_dist_median_rad"] == 0.3
    cc = out["censoring_corrected"]
    assert set(cc) == CORRECTED_KEYS and set(cc["failure_modes"]) == FAILURE_KEYS
    assert (cc["censored_goals"], cc["censored_with_fair_chance"]) == (2, 1)
    assert cc["corrected_solve_rate"] == 0.75
    fm = cc["failure_modes"]
    assert (fm["ori_only"], fm["pos_only"], fm["both"], fm["neither_at_cutoff"]) == (1, 0, 0, 0)
    assert fm["fair_unsolved_pos_err_median_m"] == 0.01


def test_goal_solve_stats_success_on_the_last_step_is_not_censored():
    succ, ep_reset, pos, ori = _record(steps=4, n=1)
    succ[3, 0] = ep_reset[3, 0] = True
    out = eval_policy.goal_solve_stats(succ, ep_reset, pos, ori, 4, 0.02, 0.25)
    assert (out["goals_solved"], out["goals_attempted"], out["goal_solve_rate"]) == (1, 1, 1.0)
    assert out["censored_goal_age_median"] is None and "censoring_corrected" not in out


def test_goal_solve_stats_nothing_solved():
    succ, ep_reset, pos, ori = _record()
    ep_reset[9, :] = True
    out = eval_policy.goal_solve_stats(succ, ep_reset, pos, ori, 10, 0.02, 0.25)
    assert out["goal_solve_rate"] == 0.0 and out["goals_attempted"] == 2
    assert out["solve_time_steps"]["median"] is None and "censoring_corrected" not in out


def test_window_solve_rate():
    """Over 70 steps: env 0 solves twice and holds a 4-step-old goal; env 1
    solves once, then holds a goal for 60 steps, and env 2 never solves:
    goals older than 50 steps, two failed attempts. Over the first 40 steps
    no open goal is older than 50: no failed attempt."""
    succ = np.zeros((70, 3), bool)
    succ[[20, 65], 0] = True
    succ[9, 1] = True
    solved, attempts, rate = eval_policy.window_solve_rate(succ, fair_age=50)
    assert (solved, attempts, rate) == (3, 5, 0.6)
    solved, attempts, rate = eval_policy.window_solve_rate(succ[:40], fair_age=50)
    assert (solved, attempts, rate) == (2, 2, 1.0)


def test_cli_writes_the_reference_keys(tmp_path, capsys):
    out_path = tmp_path / "eval.json"
    rc = eval_policy.main([
        "--checkpoint", os.path.join(ROOT, "leibnizgym_tpu_torch", "resources", "policies",
                                     "d4_dr_cone_best_curriculum.npz"),
        "--gym", "trifinger_difficulty_4_curriculum_dr", "--num_envs", "4",
        "--num_steps", "6", "--json_out", str(out_path),
        "--set", "args.device=cpu", "--set", "gym.episode_length=3",
        "--set", "gym.sim.substeps=1", "--set", "gym.sim.physx.num_position_iterations=2",
    ])
    assert rc == 0
    out = json.loads(out_path.read_text())
    assert TOP_KEYS <= set(out) <= TOP_KEYS | {"censoring_corrected"}
    assert (out["num_envs"], out["num_steps"], out["level"]) == (4, 6, 1.0)
    # two episode ends in 6 steps: every goal is solved or censored
    assert out["goals_attempted"] >= 8
    printed = capsys.readouterr().out  # the runner's log lines, then the JSON
    assert json.loads(printed[printed.index("{\n"):]) == out


@pytest.mark.parametrize("stochastic", [False, True])
def test_record_goals_shapes(tmp_path, stochastic):
    from leibnizgym_tpu_torch.config.presets import parse_cli, update_cfg
    from leibnizgym_tpu_torch.learning.runner import Runner

    cfg = update_cfg(parse_cli(["gym=trifinger_difficulty_4_curriculum", "args.num_envs=4",
                                "args.play=True"]))
    cfg["gym"]["sim"].update(substeps=1)
    r = Runner(cfg["gym"], cfg["rlg"]["params"], logdir=str(tmp_path), seed=0, device="cpu")
    r.reset()
    succ, ep_reset, pos, ori = eval_policy.record_goals(r, 5, level=0.5,
                                                        deterministic=not stochastic)
    assert succ.shape == ep_reset.shape == pos.shape == ori.shape == (5, 4)
    assert succ.dtype == bool and np.isfinite(pos).all() and (ori >= 0).all()
    assert float(r.env.params.curriculum_level) == 0.5
