"""Per-goal evaluation of a trained policy (counterpart of
``scripts/eval_policy.py``, with the same options and JSON keys).

    python -m leibnizgym_tpu_torch.scripts.eval_policy \\
        --checkpoint leibnizgym_tpu_torch/resources/policies/d4_dr_cone_best_curriculum.npz \\
        --gym trifinger_difficulty_4_curriculum_dr --num_envs 1024 --num_steps 750
    python -m leibnizgym_tpu_torch.scripts.eval_policy --checkpoint logs/<stamp>/nn/best_curriculum \\
        --gym trifinger_difficulty_4_curriculum --set args.device=cpu --num_envs 32

A success resamples the goal at once, so the instantaneous training scalars
show only a few percent of envs inside tolerance even for a policy that
solves nearly every goal. This measures what the D4 capability claim is
about: per-goal time to success, the share of goals solved, and the
residual errors of the goals left unsolved when an episode ended, with the
censoring-corrected solve rate. ``--set args.device=cpu`` runs on the CPU;
the default device is ``cuda:0``.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile

import numpy as np
import torch

from leibnizgym_tpu_torch.config.presets import parse_cli, update_cfg
from leibnizgym_tpu_torch.learning.runner import Runner
from leibnizgym_tpu_torch.utils.math import quat_diff_rad


def record_goals(runner: Runner, num_steps: int, level: float = 1.0,
                 deterministic: bool = True, seed: int = 0):
    """Run the runner's policy for ``num_steps`` from a reset, at curriculum
    ``level``. Returns (T, N) numpy arrays of the steps: success fired,
    episode ends after the step, and the object's position (m) and
    orientation (rad) errors to its goal. The arrays stay on the device
    until the run ends."""
    env = runner.wrap_env()  # FrameStack when trained with frames > 1
    policy = runner.make_policy(deterministic=deterministic, curriculum_level=level)
    generator = torch.Generator(device=runner.device).manual_seed(seed)
    obs = env.reset()
    rows = []
    for _ in range(num_steps):
        obs, _, _, _ = env.step(policy(obs, generator))
        st = runner.env.state
        goal = st.goal_pose_cm.T
        pos_err = torch.linalg.vector_norm(st.physics.cube_pos - goal[:, 0:3], dim=-1)
        ori_err = quat_diff_rad(st.physics.cube_quat, goal[:, 3:7])
        rows.append(torch.stack([st.goal_reset_buf.to(pos_err.dtype),
                                 st.reset_buf.to(pos_err.dtype), pos_err, ori_err]))
    rec = torch.stack(rows).cpu().numpy()
    return rec[:, 0] > 0.5, rec[:, 1] > 0.5, rec[:, 2], rec[:, 3]


def goal_solve_stats(succ, ep_reset, pos_err, ori_err, episode_length: int,
                     pos_tol: float, ori_tol: float) -> dict:
    """Per-goal statistics of a run from its (T, N) step record
    (``record_goals``' output): a goal's age counts the steps since it was
    issued; a success ends it as solved; an episode end scraps it as
    censored, with its residual errors. The raw solve rate counts censored
    goals as failures; the censoring-corrected rate counts only those that
    had at least the 90th-percentile solve time before the cutoff.
    ``pos_tol`` / ``ori_tol`` are the strict final tolerances the failure
    modes are judged against."""
    succ, ep_reset = np.asarray(succ, bool), np.asarray(ep_reset, bool)
    num_steps, n = succ.shape
    goal_age = np.zeros(n, dtype=np.int64)
    solve_times, censored, pos_unsolved, ori_unsolved = [], [], [], []
    for t in range(num_steps):
        goal_age += 1
        s = succ[t]
        solve_times.extend(goal_age[s].tolist())
        goal_age[s] = 0
        cens = ep_reset[t] & ~s
        censored.extend(goal_age[cens].tolist())
        pos_unsolved.extend(np.asarray(pos_err[t])[cens].tolist())
        ori_unsolved.extend(np.asarray(ori_err[t])[cens].tolist())
        goal_age[cens] = 0

    st = np.asarray(solve_times)
    solved = len(solve_times)
    ep_len = episode_length or num_steps
    out = {
        "goals_attempted": int(solved + len(censored)),
        "goals_solved": int(solved),
        "goal_solve_rate": round(solved / max(1, solved + len(censored)), 4),
        "successes_per_episode": round(solved / (num_steps * n / ep_len), 2),
        "solve_time_steps": {
            "mean": round(float(st.mean()), 1) if len(st) else None,
            "median": float(np.median(st)) if len(st) else None,
            "p90": float(np.percentile(st, 90)) if len(st) else None,
            "max": int(st.max()) if len(st) else None,
        },
        "censored_goal_age_median": float(np.median(censored)) if censored else None,
        "unsolved_pos_dist_median_m": (
            round(float(np.median(pos_unsolved)), 4) if pos_unsolved else None),
        "unsolved_ori_dist_median_rad": (
            round(float(np.median(ori_unsolved)), 4) if ori_unsolved else None),
    }
    if len(st) and censored:
        p90 = float(np.percentile(st, 90))
        ages = np.asarray(censored, dtype=float)
        pos_e, ori_e = np.asarray(pos_unsolved), np.asarray(ori_unsolved)
        fair = ages >= p90
        pf, of = pos_e[fair] > pos_tol, ori_e[fair] > ori_tol
        out["censoring_corrected"] = {
            "p90_solve_time_steps": p90,
            "censored_goals": int(len(ages)),
            "censored_with_fair_chance": int(fair.sum()),
            "corrected_solve_rate": round(solved / (solved + int(fair.sum())), 4),
            "failure_modes": {
                "pos_tolerance_m": pos_tol,
                "ori_tolerance_rad": ori_tol,
                "ori_only": int((~pf & of).sum()),
                "pos_only": int((pf & ~of).sum()),
                "both": int((pf & of).sum()),
                "neither_at_cutoff": int((~pf & ~of).sum()),
                "fair_unsolved_pos_err_median_m": (
                    round(float(np.median(pos_e[fair])), 4) if fair.any() else None),
                "fair_unsolved_ori_err_median_rad": (
                    round(float(np.median(ori_e[fair])), 4) if fair.any() else None),
            },
        }
    return out


def window_solve_rate(succ, fair_age: int = 50):
    """(solved, attempts, rate) of a window with no episode end inside it,
    the shipped-policy gate: attempts are the solved goals plus the goals
    still open at the window's end that were older than ``fair_age`` steps."""
    succ = np.asarray(succ, bool)
    goal_age = np.zeros(succ.shape[1], dtype=np.int64)
    solved = 0
    for s in succ:
        goal_age += 1
        solved += int(s.sum())
        goal_age[s] = 0
    attempts = solved + int((goal_age > fair_age).sum())
    return solved, attempts, solved / max(attempts, 1)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--gym", default="trifinger_difficulty_4_curriculum")
    p.add_argument("--num_envs", type=int, default=256)
    p.add_argument("--num_steps", type=int, default=1500)
    p.add_argument("--level", type=float, default=1.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--stochastic", action="store_true")
    p.add_argument("--json_out", default=None)
    p.add_argument("--set", dest="overrides", action="append", default=[],
                   help="extra key=value config overrides (the training CLI's surface); "
                        "must match how the checkpoint was trained, e.g. "
                        "--set gym.arena.profile=cylinder; --set args.device=cpu")
    args = p.parse_args(argv)

    cfg = update_cfg(parse_cli([
        f"gym={args.gym}", f"args.num_envs={args.num_envs}", "args.play=True",
        *args.overrides,
    ]))
    with tempfile.TemporaryDirectory() as logdir:
        runner = Runner(cfg["gym"], cfg["rlg"]["params"], logdir=logdir, seed=args.seed,
                        verbose=False, device=cfg["args"]["device"])
        runner.reset()
        runner.restore(args.checkpoint)
        record = record_goals(runner, args.num_steps, args.level,
                              deterministic=not args.stochastic, seed=args.seed)
        if runner.writer is not None:
            runner.writer.close()
    static = runner.static
    out = {
        "checkpoint": args.checkpoint,
        "level": args.level,
        "num_envs": static.num_envs,
        "num_steps": args.num_steps,
        **goal_solve_stats(*record, static.episode_length, static.position_tolerance,
                           static.orientation_tolerance),
    }
    print(json.dumps(out, indent=2))
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(out, f, indent=2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
