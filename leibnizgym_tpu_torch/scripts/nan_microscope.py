"""One env, one step of a ``nan_replay`` microscope dump, then the physics
substep by substep (counterpart of ``scripts/nan_microscope.py``).

    python -m leibnizgym_tpu_torch.scripts.nan_microscope <dump.npz> <run_logdir>
    python -m leibnizgym_tpu_torch.scripts.nan_microscope <dump.npz> <run_logdir> --device cpu

Rebuilds the bad env's state before the step from the ``pre_*`` fields of
the dump (``nan_replay``'s docstring lists them) as a one-env state, and
reruns ``env_step`` on the device (``cuda:0`` unless ``--device cpu``) with
the dumped action and env draws. It prints the reward and the non-finite
fields. If the blow-up reproduces, it walks ``substeps x control_decimation``
physics substeps from the state that entered the physics (the dumped one,
after the step's reset of this env if it had one) under the step's applied
torque (post-PD, from the dump), one substep per call of the plain engine
(``engine_v2.step_packed`` with ``substeps=1`` and ``dt = h``), printing the
finiteness of ``q``, ``qd``, ``cube_pos``, ``cube_quat``, ``cube_linvel`` and
``cube_angvel`` after each, and the values before and after the first bad
substep. On a CUDA device the kernel (``cuda_engine.step_packed_cuda``, one
env, one substep per launch) walks beside it and its flags print next to
the plain version's, so a blow-up of the kernel alone, or one in other
fields, shows as such.
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

from leibnizgym_tpu_torch.envs.trifinger import env as tenv
from leibnizgym_tpu_torch.ops import cuda_engine
from leibnizgym_tpu_torch.ops.engine_v2 import pack_params, pack_state, step_packed
from leibnizgym_tpu_torch.utils.helpers import resolve_device

FIELDS = ("q", "qd", "cube_pos", "cube_quat", "cube_linvel", "cube_angvel")
ROWS = {"q": (0, 9), "qd": (9, 18), "cube_pos": (18, 21), "cube_quat": (21, 25),
        "cube_linvel": (25, 28), "cube_angvel": (28, 31)}


def build_state(d, device, prefix: str = "pre_") -> tenv.EnvState:
    """The one-env EnvState of the dump's ``prefix`` fields."""
    tensors = {}
    for key in d.files:
        if key.startswith(prefix) and key != prefix + "frames":
            name = key[len(prefix):]
            x = torch.as_tensor(d[key], device=device)
            tensors[name] = x[..., None] if name.endswith("_cm") else x[None]
    return tenv.env_state_from_tensors(tensors, int(d[prefix + "frames"]))


def dumped_draws(d, device):
    """The step's env draws of the one env, ``draw_step_randoms``' layout."""
    def get(name):
        key = "draw_" + name
        return torch.as_tensor(d[key], device=device)[None] if key in d.files else None

    dr = (get("dr_scene"), get("dr_pd")) if "draw_dr_scene" in d.files else None
    return (get("u_reset"), get("norm_reset"), get("u_goal"), get("norm_goal"), dr,
            get("obs_noise"))


def _flags(x31: torch.Tensor) -> dict:
    return {f: bool(torch.isfinite(x31[a:b]).all()) for f, (a, b) in ROWS.items()}


def _fmt(flags: dict) -> str:
    return "  ".join(f"{k}={'ok' if v else 'NAN'}" for k, v in flags.items())


def walk_substeps(physics, scene, torque, cfg, h: float, count: int,
                  kernel: bool) -> tuple:
    """``count`` substeps of the plain engine (and of the kernel when
    ``kernel``), one per call; returns the first non-finite substep of each
    (None where none) and the fields non-finite there (each a dict keyed
    ``plain`` / ``kernel``)."""
    one = dataclasses.replace(cfg, substeps=1)
    p40, t9 = pack_params(scene, 1), torque.T.contiguous()
    state = {"plain": pack_state(physics)}
    if kernel:
        state["kernel"] = state["plain"].clone()
    first = dict.fromkeys(state)
    fields = dict.fromkeys(state)
    for i in range(count):
        line, went_bad = [], []
        for who in [w for w in state if first[w] is None]:
            if who == "plain":
                new, _ = step_packed(state[who], p40, t9, one, h)
            else:
                new, _ = cuda_engine.step_packed_cuda(state[who], p40, t9, one, h)
            flags = _flags(new)
            line.append((f"{who} " if kernel else "") + _fmt(flags))
            if not all(flags.values()):
                first[who] = i
                fields[who] = [f for f, ok in flags.items() if not ok]
                went_bad.append((who, state[who], new))
            state[who] = new
        print(f"substep {i}: " + "  |  ".join(line), flush=True)
        for who, pre, post in went_bad:
            for f in FIELDS:
                a, b = ROWS[f]
                print(f"  {who} pre  {f} = {pre[a:b, 0].cpu().numpy()}")
                print(f"  {who} post {f} = {post[a:b, 0].cpu().numpy()}")
        if all(v is not None for v in first.values()):
            break
    return first, fields


def microscope(dump: str, logdir: str, device="cuda:0") -> Optional[dict]:
    """Rerun the dumped step and walk its substeps; returns {"nonfinite":
    fields, "first_bad_substep": {"plain": i, "kernel": i},
    "nonfinite_at_first_bad": {"plain": [field, ...], "kernel": [...]}}
    when the step reproduces the blow-up, else None."""
    device = resolve_device(device, cpu_hint="--device cpu")
    d = np.load(dump)
    with open(os.path.join(logdir, "env_config.yaml")) as f:
        task_cfg = yaml.safe_load(f)
    task_cfg["num_instances"] = 1
    env = tenv.TrifingerEnv(config=task_cfg, device=device, verbose=False)
    static = env.static
    params = env.params.with_curriculum_level(float(d["curriculum_level"]))
    state = build_state(d, device)
    draws = dumped_draws(d, device)
    action = torch.as_tensor(d["action"], device=device)[None]
    print(f"device={device} env_index={int(d['env_index'])} step={int(d['step'])}", flush=True)
    new_state, _, _, reward, _, _ = tenv.env_step(static, params, state, action, draws)
    bad = [k for k, x in tenv.env_state_tensors(new_state).items()
           if x.is_floating_point() and not bool(torch.isfinite(x).all())]
    print(f"reward: {float(reward[0])}  nonfinite fields: {bad or 'none'}", flush=True)
    if not bad:
        print("did NOT reproduce on this device", flush=True)
        return None

    cfg = static.solver
    print(f"solver config: {cfg}", flush=True)
    # the physics entered the step after this env's reset, if it had one
    u_reset, norm_reset, _, _, dr_blocks, _ = draws
    entered = tenv._masked_full_reset(static, params, state, state.reset_buf, u_reset,
                                      norm_reset, dr_blocks)
    torque = new_state.applied_torque  # post-PD
    print(f"applied torque: {torque[0].cpu().numpy()}", flush=True)
    first, fields = walk_substeps(entered.physics, entered.scene, torque, cfg,
                                  static.dt / cfg.substeps,
                                  cfg.substeps * static.control_decimation,
                                  kernel=device.type == "cuda")
    print("first non-finite substep: " + "  ".join(f"{k}={v}" for k, v in first.items()),
          flush=True)
    return {"nonfinite": bad, "first_bad_substep": first, "nonfinite_at_first_bad": fields}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("dump")
    ap.add_argument("logdir")
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args(argv)
    return 0 if microscope(args.dump, args.logdir, args.device) is not None else 1


if __name__ == "__main__":
    sys.exit(main())
