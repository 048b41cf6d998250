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
- ``env_*``: the whole env step at zero action through
  ``TrifingerEnv.step`` (on the card the captured step, as the reference
  times its jitted one), reset draws from the env's seeded generator;
  ``env_eager_*`` the same step through the eager ``env_step``, in turn
  with it; ``mdp_layer_ms`` (``mdp_layer_eager_ms``) = ``env_ms``
  (``env_eager_ms``) minus the physics time of the env's default engine
  (``env_default_engine``: ``pallas`` on the card).

``physics`` runs the soa and reference pairs, ``physics_pallas`` the
kernel's, ``all`` every pair and ``env``. On the card the plain engines take
seconds per step at 8192 envs: ``physics`` and ``all`` run for tens of
minutes there. ``ppo`` decomposes the epoch at ``--num-envs`` envs, each
time over ``--rounds`` calls after one (after two for a captured epoch: its
first call captures it), graphed and eager side by side, in turns: the
whole epoch at minibatch N, 4N and 8N with its sequential minibatch steps
(``ppo_epoch*_ms``: the captured epoch of ``learning/graphs.py`` on the
card; ``ppo_epoch*_eager_ms``: ``ppo.train_iteration``), the rollout
(``ppo_rollout_ms``: the graphed epoch's rollout phase at minibatch N;
``ppo_rollout_eager_ms``: ``ppo.rollout`` of ``--horizon`` steps from one
carry, the policy, central value and env step) and the update path (epoch
minus rollout). Prints one JSON line, with ``device`` (the ``nvidia-smi``
name and power limit, ``cpu`` on the CPU) and ``kernel_launches`` (the
hand-written kernels' launches: the physics kernel's, and on the card the
fingertip and tail kernels' once each per env reset and step).
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
from leibnizgym_tpu_torch.learning.graphs import GraphedEpoch
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
# the eager figures beside the compiled ones (this script's, not the reference's)
EAGER_ENV_KEYS = ("env_eager_ms", "env_eager_steps_per_s", "mdp_layer_eager_ms")
EAGER_PPO_KEYS = ("ppo_rollout_eager_ms", "ppo_epoch_eager_ms", "ppo_epoch_mb4_eager_ms",
                  "ppo_epoch_mb8_eager_ms", "ppo_update_path_eager_ms")


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


class _Marks:
    """Phase marks of an epoch (its ``on_phase`` hook): CUDA events on the
    card, the host clock on the CPU; ``rollout_ms`` is the median time from
    each epoch's start to its "rollout" mark."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"
        self.marks = []

    def __call__(self, name: str):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append((name, ev))
        else:
            self.marks.append((name, time.perf_counter()))

    def rollout_ms(self) -> float:
        pairs = [(a[1], b[1]) for a, b in zip(self.marks, self.marks[1:])
                 if a[0] == "start" and b[0] == "rollout"]
        ms = [a.elapsed_time(b) if self.cuda else (b - a) * 1e3 for a, b in pairs]
        return sorted(ms)[len(ms) // 2]


def ppo_decomposition(args, out: dict) -> dict:
    """The PPO epoch's critical path, graphed and eager in turns: the whole
    epoch at minibatch N, 4N and 8N, the rollout, and the update path
    (epoch - rollout)."""
    n = args.num_envs
    env = TrifingerEnv(config={"num_instances": n, "command_mode": "torque",
                               "asymmetric_obs": True, "sim": {"substeps": 4}},
                       device=args.device, verbose=False)
    static, params, device = env.static, env.params, env.device
    h = args.horizon
    marks = _Marks(device)
    for mb_mult, tag in ((1, "ppo_epoch_ms"), (4, "ppo_epoch_mb4_ms"), (8, "ppo_epoch_mb8_ms")):
        c = ppo.PPOConfig(minibatch_size=n * mb_mult, cv_minibatch_size=n * mb_mult, horizon=h)
        eager = ppo.init_train_state(c, static, params, 0)
        graphed = ppo.init_train_state(c, static, params, 0)
        epoch = GraphedEpoch()
        epoch(c, static, params, graphed)  # captures on the card

        def graphed_epoch(c=c, graphed=graphed, epoch=epoch, marked=mb_mult == 1):
            if marked:
                marks("start")
            epoch(c, static, params, graphed, on_phase=marks if marked else None)

        out[tag.replace("_ms", "_eager_ms")] = round(_time_calls(
            lambda c=c, eager=eager: ppo.train_iteration(c, static, params, eager), device,
            args.rounds), 2)
        out[tag] = round(_time_calls(graphed_epoch, device, args.rounds), 2)
        out[tag.replace("_ms", "_updates")] = c.mini_epochs * max(h * n // c.minibatch_size, 1)
        if mb_mult == 1:
            synchronize(device)
            out["ppo_rollout_ms"] = round(marks.rollout_ms(), 2)
            out["ppo_rollout_eager_ms"] = round(_time_calls(lambda: ppo.rollout(
                c, static, params, eager.carry, eager.actor_critic, eager.central_value,
                generator=eager.generator), device, args.rounds), 2)
    out["ppo_update_path_ms"] = round(out["ppo_epoch_ms"] - out["ppo_rollout_ms"], 2)
    out["ppo_update_path_eager_ms"] = round(out["ppo_epoch_eager_ms"]
                                            - out["ppo_rollout_eager_ms"], 2)
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
        env.seed(0)
        env.reset()
        dt = _time_loop(lambda _: env.step(action), None, args, device)
        dt_eager = _time_loop(lambda s: env_step(static, params, s, action,
                                                 draw_step_randoms(static, gen, n, device))[0],
                              state, args, device)
        for tag, t in (("env", dt), ("env_eager", dt_eager)):
            out[f"{tag}_ms"] = round(t * 1e3, 4)
            out[f"{tag}_steps_per_s"] = round(n / t)
        phys_key = f"physics_{static.engine}_ms"
        if phys_key in out:
            out["mdp_layer_ms"] = round(out["env_ms"] - out[phys_key], 4)
            out["mdp_layer_eager_ms"] = round(out["env_eager_ms"] - out[phys_key], 4)
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
