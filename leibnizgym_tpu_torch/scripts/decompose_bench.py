"""Decompose the env-step cost on the card: physics per engine against the
whole env step, and the PPO epoch (counterpart of the repo's
``scripts/decompose_bench.py``; the same choices and keys).

    python -m leibnizgym_tpu_torch.scripts.decompose_bench --what physics_pallas
    python -m leibnizgym_tpu_torch.scripts.decompose_bench --what env
    python -m leibnizgym_tpu_torch.scripts.decompose_bench --what ppo
    python -m leibnizgym_tpu_torch.scripts.decompose_bench --device cpu --num-envs 8 \\
        --what physics --rounds 1 --length 2

The env (D1, torque, asymmetric states, ``--substeps``) is built first and
its ``static.solver`` reused, so every physics time is under the env's own
SolverConfig, gates included. Each time is ``--rounds`` (10) windows of
``--length`` (100) steps after one untimed window, host clock closed by
``torch.cuda.synchronize()``, per step:

- ``physics_pallas_*``: the CUDA kernel (``cuda_engine.physics_step_cuda``;
  its plain version on the CPU);
- ``physics_soa_*``: the plain version (``physics_step_plain``);
- ``physics_reference_*``: the batch-first reference engine
  (``ops/engine.py``). The reference script has no such pair (its
  reference engine is the XLA one it times under ``env``);
- ``env_*``: the whole env step at zero action, reset draws from a seeded
  generator; ``mdp_layer_ms`` = ``env_ms`` minus the physics time of the
  env's default engine (``env_default_engine``: ``pallas`` on the card).

``physics`` runs the soa and reference pairs, ``physics_pallas`` the
kernel's, ``all`` every pair and ``env``. On the card the plain engines take
seconds per step at 8192 envs: ``physics`` and ``all`` run for tens of
minutes there. ``ppo`` decomposes the epoch at ``--num-envs`` envs, each
time over ``--rounds`` calls after one: the rollout alone (``ppo.rollout``
of ``--horizon`` steps from one carry: the policy, central value and env
step), the whole epoch
(``ppo.train_iteration``, which runs ``ppo.update``) at minibatch N, 4N and
8N with its sequential minibatch steps, and the update path (epoch minus
rollout). Prints one JSON line, with ``device`` (the ``nvidia-smi`` name and
power limit, ``cpu`` on the CPU) and ``kernel_launches``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from leibnizgym_tpu_torch.envs.trifinger.env import (
    TrifingerEnv,
    draw_init_randoms,
    draw_step_randoms,
    env_reset,
    env_step,
)
from leibnizgym_tpu_torch.learning import ppo
from leibnizgym_tpu_torch.ops import cuda_engine
from leibnizgym_tpu_torch.ops import engine as reference_engine
from leibnizgym_tpu_torch.ops.types import PhysicsState, SceneParams
from leibnizgym_tpu_torch.utils.helpers import resolve_device, smi, synchronize


# the reference's keys of --what all (env and physics) and --what ppo; this
# script adds the physics_reference_* pair, "device" and "kernel_launches"
ENV_KEYS = ("num_envs", "substeps", "solver_type", "iterations", "env_default_engine",
            "physics_soa_ms", "physics_soa_steps_per_s", "physics_pallas_ms",
            "physics_pallas_steps_per_s", "env_ms", "env_steps_per_s", "mdp_layer_ms")
PPO_KEYS = ("num_envs", "ppo_rollout_ms", "ppo_epoch_ms", "ppo_epoch_updates",
            "ppo_epoch_mb4_ms", "ppo_epoch_mb4_updates", "ppo_epoch_mb8_ms",
            "ppo_epoch_mb8_updates", "ppo_update_path_ms")


def _time_loop(fn, carry, args, device) -> float:
    """Seconds per step of ``fn`` over ``args.rounds`` windows of
    ``args.length`` steps, after one untimed window."""
    for _ in range(args.length):
        carry = fn(carry)
    synchronize(device)
    t0 = time.perf_counter()
    for _ in range(args.rounds * args.length):
        carry = fn(carry)
    synchronize(device)
    return (time.perf_counter() - t0) / (args.rounds * args.length)


def _time_calls(fn, device, reps: int) -> float:
    """Milliseconds per call of ``fn`` over ``reps`` calls after one."""
    fn()
    synchronize(device)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    synchronize(device)
    return (time.perf_counter() - t0) / reps * 1e3


def ppo_decomposition(args, out: dict) -> dict:
    """The PPO epoch's critical path: the rollout alone, the whole epoch at
    minibatch N, 4N and 8N, and the update path (epoch - rollout)."""
    n = args.num_envs
    env = TrifingerEnv(config={"num_instances": n, "command_mode": "torque",
                               "asymmetric_obs": True, "sim": {"substeps": 4}},
                       device=args.device, verbose=False)
    static, params = env.static, env.params
    cfg = ppo.PPOConfig(minibatch_size=n, cv_minibatch_size=n, horizon=args.horizon)
    ts = ppo.init_train_state(cfg, static, params, 0)
    h = cfg.horizon
    out["ppo_rollout_ms"] = round(_time_calls(lambda: ppo.rollout(
        cfg, static, params, ts.carry, ts.actor_critic, ts.central_value,
        generator=ts.generator), env.device, args.rounds), 2)
    for mb_mult, tag in ((1, "ppo_epoch_ms"), (4, "ppo_epoch_mb4_ms"), (8, "ppo_epoch_mb8_ms")):
        c = ppo.PPOConfig(minibatch_size=n * mb_mult, cv_minibatch_size=n * mb_mult,
                          horizon=args.horizon)
        t = ppo.init_train_state(c, static, params, 0)
        out[tag] = round(_time_calls(lambda: ppo.train_iteration(c, static, params, t),  # noqa: B023
                                     env.device, args.rounds), 2)
        out[tag.replace("_ms", "_updates")] = c.mini_epochs * max(h * n // c.minibatch_size, 1)
    out["ppo_update_path_ms"] = round(out["ppo_epoch_ms"] - out["ppo_rollout_ms"], 2)
    return out


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--num-envs", type=int, default=8192)
    ap.add_argument("--substeps", type=int, default=4)
    ap.add_argument("--what", default="all",
                    choices=["all", "physics", "physics_pallas", "env", "ppo"])
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--rounds", type=int, default=10,
                    help="timed windows (timed calls under --what ppo)")
    ap.add_argument("--length", type=int, default=100, help="steps per window")
    ap.add_argument("--horizon", type=int, default=ppo.PPOConfig.horizon,
                    help="PPO rollout steps per epoch (--what ppo)")
    return ap


def decompose_env(args, device) -> dict:
    n = args.num_envs
    env = TrifingerEnv(config={"num_instances": n, "command_mode": "torque",
                               "asymmetric_obs": True, "sim": {"substeps": args.substeps}},
                       device=device, verbose=False)
    static, params = env.static, env.params
    cfg = static.solver  # the env's exact solver config, gates included
    out = {"num_envs": n, "substeps": args.substeps, "solver_type": cfg.solver_type,
           "iterations": cfg.solver_iterations, "env_default_engine": static.engine}

    if args.what != "env":
        scene = SceneParams.default(device=device).broadcast(n)
        tau = torch.zeros((n, 9), device=device)
        state0 = PhysicsState.default(n, device=device)
        steps = {"pallas": cuda_engine.physics_step_cuda,
                 "soa": cuda_engine.physics_step_plain,
                 "reference": reference_engine.physics_step}
        names = {"all": ("soa", "pallas", "reference"), "physics": ("soa", "reference"),
                 "physics_pallas": ("pallas",)}[args.what]
        for name in names:
            step = steps[name]
            dt = _time_loop(lambda s: step(s, tau, scene, cfg, 0.02)[0], state0, args,  # noqa: B023
                            device)
            out[f"physics_{name}_ms"] = round(dt * 1e3, 4)
            out[f"physics_{name}_steps_per_s"] = round(n / dt)

    if args.what in ("all", "env"):
        gen = torch.Generator(device=device).manual_seed(0)
        state, _ = env_reset(static, params, *draw_init_randoms(static, gen, n, device))
        action = torch.zeros((n, static.action_dim), device=device)
        dt = _time_loop(lambda s: env_step(static, params, s, action,
                                           draw_step_randoms(static, gen, n, device))[0],
                        state, args, device)
        out["env_ms"] = round(dt * 1e3, 4)
        out["env_steps_per_s"] = round(n / dt)
        phys_key = f"physics_{static.engine}_ms"
        if phys_key in out:
            out["mdp_layer_ms"] = round(out["env_ms"] - out[phys_key], 4)
    return out


def main(argv=None) -> dict:
    args = parser().parse_args(argv)
    args.device = device = resolve_device(args.device, "--device cpu")
    n = args.num_envs
    launches0 = cuda_engine.launch_count
    if args.what == "ppo":
        out = ppo_decomposition(args, {"num_envs": n})
    else:
        out = decompose_env(args, device)
    out["device"] = smi() if device.type == "cuda" else str(device)
    out["kernel_launches"] = cuda_engine.launch_count - launches0
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
