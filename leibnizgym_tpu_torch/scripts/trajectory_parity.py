"""Fixed-seed trajectory dump & comparison harness (counterpart of the repo's
``scripts/trajectory_parity.py``; same flags, npz keys and meta).

    python -m leibnizgym_tpu_torch.scripts.trajectory_parity dump --engine pallas \
        --out /tmp/traj_a.npz
    python -m leibnizgym_tpu_torch.scripts.trajectory_parity dump --device cpu \\
        --num-envs 8 --steps 10 --out /tmp/traj_cpu.npz
    python -m leibnizgym_tpu_torch.scripts.trajectory_parity compare /tmp/traj_a.npz /tmp/traj_b.npz

``dump`` runs a D1 torque rollout with uniform random actions in [-1, 1] on
the device (``cuda:0`` unless ``--device cpu``; on the card under
``--engine pallas`` the reset and every step launch the physics kernel
once, and on the card under any engine the fingertip kernel once) and writes per-step arrays of
shape (T, N, ...): q (T,N,9), qd (T,N,9), cube_pos (T,N,3), cube_quat
(T,N,4), cube_linvel (T,N,3), cube_angvel (T,N,3), obs (T,N,obs), reward
(T,N), action (T,N,A), and ``meta`` (a JSON string: the rollout's settings,
the resolved arena profile, ``framework`` = ``leibnizgym_tpu_torch`` and
``device``, the card's name or ``cpu``). ``--engine`` is the env's
``engine`` key, as the reference passes it: ``pallas`` is the kernel on the
card (its plain version on the CPU), ``soa`` (the default) the plain version
on any device, ``reference`` the batch-first reference engine
(``ops/engine.py``); on the card ``soa`` and ``reference`` take seconds per
step at the default 64 envs x 100 steps. The port draws its reset randoms and actions
from ``torch.Generator``s seeded with ``--seed`` and ``--action-seed``, so
its stream differs from the JAX package's; ``dump(args, actions, draws)``
takes given actions and env draws instead (how a test replays a JAX dump's
rollout in the port).

``compare`` prints each field's max and mean difference and the first step
beyond ``--tol``, and returns 0 (PARITY), 1 (DIVERGED) or 2 (INCOMPARABLE,
the shapes differ) as the reference's does. A torch dump and a JAX dump of
the same rollout compare directly.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from leibnizgym_tpu_torch.envs.trifinger.env import ENGINES, TrifingerEnv
from leibnizgym_tpu_torch.utils.helpers import device_name, resolve_device
from leibnizgym_tpu_torch.utils.message import print_info

FIELDS = ("q", "qd", "cube_pos", "cube_quat", "cube_linvel", "cube_angvel", "obs",
          "reward", "action")


def make_env(args) -> TrifingerEnv:
    config = {
        "num_instances": args.num_envs,
        "task_difficulty": args.difficulty,
        "command_mode": "torque",
        "seed": args.seed,
        "engine": args.engine,
        "sim": {"substeps": args.substeps,
                "physx": {"num_position_iterations": args.iterations,
                          "tpu_solver": args.solver}},
    }
    if args.arena:
        config["arena"] = {"profile": args.arena}
    env = TrifingerEnv(config=config, device=resolve_device(args.device, "--device cpu"),
                       verbose=False)
    env.seed(args.seed)
    return env


def _to(x, device):
    """Tensors of a nested tuple of draws on ``device``."""
    if torch.is_tensor(x):
        return x.to(device)
    if isinstance(x, (tuple, list)):
        return type(x)(_to(v, device) for v in x)
    return x


def record(env: TrifingerEnv, actions, draws=None) -> dict:
    """Reset, then one step per action; (T, N, ...) numpy arrays of FIELDS.
    ``draws`` = (reset draws, [step draws, ...]) in ``draw_init_randoms`` /
    ``draw_step_randoms``' layouts, or None to draw from the env's generator."""
    reset_draws, step_draws = draws if draws is not None else (None, None)
    env.reset(_to(reset_draws, env.device))
    rec = {k: [] for k in FIELDS}
    for t, action in enumerate(actions):
        action = action.to(env.device)
        obs, reward, _, _ = env.step(action, None if step_draws is None
                                     else _to(step_draws[t], env.device))
        st = env.state.physics
        for k in FIELDS[:6]:
            rec[k].append(getattr(st, k).cpu().numpy())
        rec["obs"].append(obs.cpu().numpy())
        rec["reward"].append(reward.cpu().numpy())
        rec["action"].append(action.cpu().numpy())
    return {k: np.stack(v) for k, v in rec.items()}


def dump(args, actions=None, draws=None) -> dict:
    """Write the dump of ``args``; returns its meta. ``actions`` (a sequence of
    (N, A) tensors) and ``draws`` (see ``record``) replace the seeded ones."""
    env = make_env(args)
    if actions is None:
        gen = torch.Generator(device=env.device).manual_seed(args.action_seed)
        shape = (args.num_envs, env.get_action_dim())
        actions = (torch.rand(shape, generator=gen, device=env.device) * 2.0 - 1.0
                   for _ in range(args.steps))
    arrays = record(env, actions, draws)
    # the resolved wall profile, so dumps are self-describing
    arena_profile = ("cone" if float(env.params.scene_base.wall_slope) != 0.0
                     else "cylinder")
    meta = dict(
        num_envs=args.num_envs, steps=args.steps, seed=args.seed,
        action_seed=args.action_seed, difficulty=args.difficulty,
        engine=args.engine, substeps=args.substeps, iterations=args.iterations,
        solver=args.solver, arena=arena_profile, framework="leibnizgym_tpu_torch",
        device=device_name(env.device),
    )
    np.savez_compressed(args.out, meta=json.dumps(meta), **arrays)
    print_info(f"wrote {args.out}: "
               + ", ".join(f"{k}{v.shape}" for k, v in arrays.items()))
    return meta


def compare(args) -> int:
    a = np.load(args.file_a, allow_pickle=True)
    b = np.load(args.file_b, allow_pickle=True)
    meta_a, meta_b = json.loads(str(a["meta"])), json.loads(str(b["meta"]))
    print(f"A: {meta_a}\nB: {meta_b}")
    fields = [k for k in a.files if k != "meta" and k in b.files]
    worst = 0.0
    divergence_step = None
    incomparable = False
    for k in fields:
        xa, xb = a[k], b[k]
        if xa.shape != xb.shape:
            print(f"{k}: SHAPE MISMATCH {xa.shape} vs {xb.shape}")
            incomparable = True
            continue
        err = np.abs(xa - xb)
        per_step = err.reshape(err.shape[0], -1).max(axis=1)
        first_div = int(np.argmax(per_step > args.tol)) if (per_step > args.tol).any() else None
        print(f"{k}: max {err.max():.3e}  mean {err.mean():.3e}"
              + (f"  first>tol at step {first_div}" if first_div is not None else ""))
        worst = max(worst, float(err.max()))
        if first_div is not None:
            divergence_step = (first_div if divergence_step is None
                               else min(divergence_step, first_div))
    if incomparable:
        print("verdict: INCOMPARABLE (shape mismatch — different rollout configs)")
        return 2
    verdict = "PARITY" if worst <= args.tol else f"DIVERGED (step {divergence_step})"
    print(f"verdict: {verdict} (tol {args.tol}, worst {worst:.3e})")
    return 0 if worst <= args.tol else 1


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    d = sub.add_parser("dump")
    d.add_argument("--num-envs", type=int, default=64)
    d.add_argument("--steps", type=int, default=100)
    d.add_argument("--seed", type=int, default=0)
    d.add_argument("--action-seed", type=int, default=1)
    d.add_argument("--difficulty", type=int, default=1)
    d.add_argument("--engine", type=str, default="soa", choices=ENGINES,
                   help="the env's engine: pallas (the kernel), soa (its plain version) "
                        "or reference (ops/engine.py)")
    d.add_argument("--solver", type=str, default="tgs",
                   help="tpu_solver mode recorded in the dump (tgs|pgs)")
    d.add_argument("--substeps", type=int, default=2)
    d.add_argument("--iterations", type=int, default=4)
    d.add_argument("--arena", type=str, default=None,
                   choices=("cylinder", "cone"),
                   help="wall profile (default: the build default; the "
                        "RESOLVED profile is recorded in the dump meta)")
    d.add_argument("--device", default="cuda:0")
    d.add_argument("--out", type=str, required=True)
    c = sub.add_parser("compare")
    c.add_argument("file_a")
    c.add_argument("file_b")
    c.add_argument("--tol", type=float, default=1e-4)
    return ap


def main(argv=None) -> int:
    ap = parser()
    args = ap.parse_args(argv)
    if args.cmd == "compare":
        return compare(args)
    dump(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
