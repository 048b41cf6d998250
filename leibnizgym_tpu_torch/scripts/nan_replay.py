"""Replay a NaN-halt dump step by step (counterpart of ``scripts/nan_replay.py``).

    python -m leibnizgym_tpu_torch.scripts.nan_replay <run_logdir> [--steps 64]
    python -m leibnizgym_tpu_torch.scripts.nan_replay <run_logdir> --device cpu

``run_logdir`` is the timestamped directory of a run trained with
``nan_telemetry``: the runner's NaN halt wrote ``nan_prev_ts.pt`` there (the
whole train state before the first bad epoch), beside ``env_config.yaml``
and ``agent_config.yaml``. This rebuilds the env, the networks and the
``PPOConfig`` on the device (``cuda:0`` unless ``--device cpu``; a dump is
replayed on the kind of device that wrote it, since its generator state is
that device's), restores the dumped state and replays the fatal epoch's
rollout one step at a time through ``ppo.rollout``, so the action noise and
the env draws come from the dumped generator in the order the epoch drew
them. Steps past the horizon go on with the pre-epoch policy.

After each step a per-env mask marks non-finite values in any floating
field of the env state or in the reward. At the first step that marks one,
the first bad env's slice is written to the microscope ``.npz`` (``--out``)
for ``nan_microscope``:

- ``pre_<name>`` / ``post_<name>``: every tensor of the env state before
  and after the step under its ``env.env_state_tensors`` name
  (``physics_q``, ``physics_cube_linvel``, ``scene_cube_mass``, ...,
  ``goal_pose_cm``, ``applied_torque``, ``reset_buf``, ``steps_count``),
  the env's row of an (N, ...) field or its column of a component-major
  ``*_cm`` (k, N) field; ``pre_frames`` / ``post_frames``;
- ``draw_<name>``: the env's row of the step's env draws
  (``draw_step_randoms``' blocks: ``u_reset``, ``norm_reset``, ``u_goal``,
  ``norm_goal``, ``dr_scene``, ``dr_pd``, ``obs_noise``, those the config
  draws);
- ``action`` (clipped, as the env got it), ``reward`` (raw), ``step``,
  ``env_index``, ``curriculum_level``.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
from typing import Optional

import numpy as np
import torch
import yaml

from leibnizgym_tpu_torch.envs.trifinger.env import (
    TrifingerEnv,
    draw_step_randoms,
    env_state_from_tensors,
    env_state_tensors,
)
from leibnizgym_tpu_torch.learning import ppo
from leibnizgym_tpu_torch.utils.helpers import resolve_device

DUMP = "nan_prev_ts.pt"


def load_run(logdir: str, device):
    """(env, PPOConfig, train state) from a run's logdir and its NaN dump."""
    with open(os.path.join(logdir, "env_config.yaml")) as f:
        task_cfg = yaml.safe_load(f)
    with open(os.path.join(logdir, "agent_config.yaml")) as f:
        agent_params = yaml.safe_load(f)
    dump = torch.load(os.path.join(logdir, DUMP), map_location="cpu", weights_only=True)
    if torch.device(dump["generator_device"]).type != device.type:
        raise ValueError(f"the dump's generator is a {dump['generator_device']} generator; "
                         f"replay it with --device {dump['generator_device']}")
    env = TrifingerEnv(config=task_cfg, device=device, verbose=False)
    static = env.static
    cfg = ppo.PPOConfig.from_rlg_params(agent_params, static.num_envs)
    if "curriculum_level" in dump:
        env.params = env.params.with_curriculum_level(float(dump["curriculum_level"]))
    actor_critic, central_value = ppo.make_networks(cfg, static, device)
    actor_critic.load_state_dict(dump["ac_state_dict"])
    if central_value is not None:
        central_value.load_state_dict(dump["cv_state_dict"])
    c = dump["carry"]
    carry = ppo.RolloutCarry(
        # a dump written while frames was a host int holds it beside the tensors
        env_state=env_state_from_tensors({k: v.to(device) for k, v in c["env_state"].items()},
                                         c.get("frames")),
        obs=c["obs"].to(device), states=c["states"].to(device),
        ep_return=c["ep_return"].to(device), ep_len=c["ep_len"].to(device))
    generator = torch.Generator(device=device)
    generator.set_state(dump["generator_state"])
    ts = ppo.TrainState.create(cfg, actor_critic, central_value, carry, generator)
    ts.epoch, ts.frame = int(dump["epoch"]), int(dump["frame"])
    return env, cfg, ts


def bad_env_mask(state, reward: torch.Tensor) -> torch.Tensor:
    """(N,) bool: a non-finite value in a floating field of the env state
    (env axis first, or last for the component-major ``*_cm`` fields) or in
    the reward."""
    n = reward.shape[0]
    mask = ~torch.isfinite(reward)
    for name, x in env_state_tensors(state).items():
        if x.is_floating_point():
            rows = x if not name.endswith("_cm") else x.T
            mask |= ~torch.isfinite(rows.reshape(n, -1)).all(1)
    return mask


def env_slice(state, e: int) -> dict:
    """Env ``e``'s part of every tensor of the env state, as numpy."""
    out = {k: (x[:, e] if k.endswith("_cm") else x[e]).cpu().numpy()
           for k, x in env_state_tensors(state).items() if k != "frames"}
    out["frames"] = state.frames.cpu().numpy()
    return out


DRAW_NAMES = ("u_reset", "norm_reset", "u_goal", "norm_goal", "dr", "obs_noise")


def step_draws(static, generator_state, n: int, action_shape, device, dtype, e: int) -> dict:
    """Env ``e``'s row of the env draws of the step that started with the
    generator in ``generator_state`` (the action noise is drawn first)."""
    g = torch.Generator(device=device)
    g.set_state(generator_state)
    torch.randn(action_shape, generator=g, device=device)
    out = {}
    for name, d in zip(DRAW_NAMES, draw_step_randoms(static, g, n, device, dtype)):
        if name == "dr" and d is not None:
            out.update({f"dr_{k}": v[e].cpu().numpy() for k, v in zip(("scene", "pd"), d)})
        elif d is not None:
            out[name] = d[e].cpu().numpy()
    return out


def replay(logdir: str, steps: int = 64, out: str = "nan_microscope.npz",
           device="cuda:0") -> Optional[dict]:
    """Replay the dump; returns {"step", "env_index", "bad_envs", "out"} at
    the first non-finite step (after writing ``out``), else None."""
    device = resolve_device(device, cpu_hint="--device cpu")
    env, cfg, ts = load_run(logdir, device)
    static = env.static
    n = static.num_envs
    print(f"replaying from epoch {ts.epoch} frame {ts.frame} ({n} envs) on {device}", flush=True)
    # one step per call; raw rewards
    one = dataclasses.replace(cfg, horizon=1, reward_shaper_scale=1.0)
    carry = ts.carry
    for i in range(steps):
        gen_state = ts.generator.get_state()
        new, traj = ppo.rollout(one, static, env.params, carry, ts.actor_critic,
                                ts.central_value, generator=ts.generator)
        reward = traj.reward[0]
        mask = bad_env_mask(new.env_state, reward)
        if bool(mask.any()):
            e = int(torch.argmax(mask.to(torch.int8)))
            rew_bad = int((~torch.isfinite(reward)).sum())
            print(f"step {i}: {int(mask.sum())} envs non-finite (+{rew_bad} bad rewards); "
                  f"first bad env = {e}", flush=True)
            action = torch.clamp(traj.action[0, e], -cfg.clip_actions, cfg.clip_actions)
            draws = step_draws(static, gen_state, n, traj.action.shape[1:], device,
                               traj.obs.dtype, e)
            pre = env_slice(carry.env_state, e)
            np.savez(out, action=action.cpu().numpy(), reward=float(reward[e]), step=i,
                     env_index=e, curriculum_level=float(env.params.curriculum_level),
                     **{f"pre_{k}": v for k, v in pre.items()},
                     **{f"post_{k}": v for k, v in env_slice(new.env_state, e).items()},
                     **{f"draw_{k}": v for k, v in draws.items()})
            print(f"microscope dump -> {out}", flush=True)
            for name in sorted(pre):
                if pre[name].size <= 16:
                    print(f"  pre.{name} = {pre[name]}", flush=True)
            return {"step": i, "env_index": e, "bad_envs": int(mask.sum()), "out": out}
        carry = new
    print(f"no non-finite state in {steps} replay steps (the device's numerics may differ "
          f"from the failing run's)", flush=True)
    return None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        epilog="A dump replays only on the kind of device that wrote it: the dumped "
               "generator state is that device's (a CUDA generator's state cannot seed "
               "a CPU one), so a dump written on the card replays on a card, and one "
               "written on the CPU with --device cpu.")
    ap.add_argument("logdir")
    ap.add_argument("--steps", type=int, default=64,
                    help="max rollout steps to replay (an epoch is 32; more catches "
                         "a NaN that needs the next epoch)")
    ap.add_argument("--out", default="nan_microscope.npz")
    ap.add_argument("--device", default="cuda:0",
                    help="cuda:0 (default) or cpu; must be the kind of device that "
                         "wrote the dump")
    args = ap.parse_args(argv)
    found = replay(args.logdir, args.steps, args.out, args.device)
    return 0 if found is not None else 1


if __name__ == "__main__":
    sys.exit(main())
