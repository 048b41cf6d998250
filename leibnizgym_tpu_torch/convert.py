"""Carry weights and state from the JAX package to the port.

Inputs are plain numpy (``jax.device_get`` / ``np.asarray`` of the JAX
pytrees), so this module imports no JAX:

- flax ``ActorCritic`` / ``CentralValue`` params, nested dicts of arrays,
  become state dicts of ``models.networks``: a Dense kernel (in, out)
  becomes ``Linear.weight`` (out, in); names ``actor_i``, ``critic_i``,
  ``mu``, ``value``, ``log_std`` and ``dense_i`` are kept;
- a JAX ``EnvState`` (any object with the same field names, numpy leaves)
  becomes the port's ``EnvState``;
- an optax ``ScaleByAdamState`` (``count``, and ``mu`` / ``nu`` trees shaped
  like the params) becomes a ``learning.ppo.ClippedAdam`` state dict, with
  the same kernel -> weight transpose;
- a JAX ``PPOTrainState`` becomes the port's ``TrainState``;
- a weights-only ``.npz`` policy (``np.savez`` of a JAX checkpoint's leaves
  under their ``/``-joined tree paths: ``ac_params/...``, ``cv_params/...``,
  ``curriculum_level``, ``epoch``, ``frame``) becomes a checkpoint payload
  that ``learning.runner.Runner.restore`` loads into its ``TrainState``.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from leibnizgym_tpu_torch.envs.trifinger.env import EnvState, frames_tensor
from leibnizgym_tpu_torch.learning import ppo
from leibnizgym_tpu_torch.ops.types import PhysicsState, SceneParams


def _tensor(x, device) -> torch.Tensor:
    return torch.as_tensor(np.array(x), device=device)


def flax_params_to_state_dict(params: Mapping[str, Any], device="cpu") -> dict:
    """Flax ``{"params": {...}}`` (or its inner dict) -> torch state dict."""
    tree = params.get("params", params)
    out = {}
    for name, leaf in tree.items():
        if isinstance(leaf, Mapping):
            out[f"{name}.weight"] = _tensor(np.asarray(leaf["kernel"]).T, device)
            out[f"{name}.bias"] = _tensor(leaf["bias"], device)
        else:
            out[name] = _tensor(leaf, device)
    return out


def checkpoint_from_npz(path: str, device="cpu") -> dict:
    """A weights-only ``.npz`` policy -> the runner's checkpoint payload
    (state dicts, ``epoch``, ``frame``, ``curriculum_level`` when present;
    no optimizer states and no ``lr``)."""
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}

    def tree(prefix: str) -> dict:
        out: dict = {}
        for key, value in flat.items():
            if key.startswith(prefix + "/"):
                *parents, leaf = key[len(prefix) + 1:].split("/")
                node = out
                for p in parents:
                    node = node.setdefault(p, {})
                node[leaf] = value
        return out

    cv = tree("cv_params")
    payload = {
        "ac_state_dict": flax_params_to_state_dict(tree("ac_params"), device),
        "cv_state_dict": flax_params_to_state_dict(cv, device) if cv else None,
        "epoch": int(flat["epoch"]),
        "frame": int(flat["frame"]),
    }
    if "curriculum_level" in flat:
        payload["curriculum_level"] = float(flat["curriculum_level"])
    return payload


def _fields(obj) -> dict:
    if isinstance(obj, Mapping):
        return dict(obj)
    return {k: getattr(obj, k) for k in obj.__dataclass_fields__}


def env_state_from_jax(state, device="cpu") -> EnvState:
    """A JAX ``EnvState`` with numpy leaves -> the port's ``EnvState`` (the
    PRNG key is dropped: the port takes its draws explicitly)."""
    f = _fields(state)
    physics = PhysicsState(**{k: _tensor(v, device) for k, v in _fields(f["physics"]).items()})
    scene = SceneParams(**{k: _tensor(v, device) for k, v in _fields(f["scene"]).items()})
    return EnvState(
        physics=physics,
        scene=scene,
        pd_scale=_tensor(f["pd_scale"], device),
        goal_pose_cm=_tensor(f["goal_pose_cm"], device),
        goal_angvel_cm=_tensor(f["goal_angvel_cm"], device),
        action_buf=_tensor(f["action_buf"], device),
        applied_torque=_tensor(f["applied_torque"], device),
        tip_wrench=_tensor(f["tip_wrench"], device),
        reset_buf=_tensor(f["reset_buf"], device).to(torch.bool),
        goal_reset_buf=_tensor(f["goal_reset_buf"], device).to(torch.bool),
        steps_count=_tensor(f["steps_count"], device).to(torch.int32),
        successes=_tensor(f["successes"], device).to(torch.int32),
        tip_pos_prev_cm=_tensor(f["tip_pos_prev_cm"], device),
        obj_posquat_prev_cm=_tensor(f["obj_posquat_prev_cm"], device),
        frames=frames_tensor(np.asarray(f["frames"]), device),
    )


def adam_state_from_jax(opt_state, device="cpu") -> dict:
    """The ``ScaleByAdamState`` inside an optax chain state (a tuple whose
    other entries, such as the clip's empty state, hold nothing) -> a
    ``ClippedAdam.state_dict()``."""
    states = opt_state if isinstance(opt_state, (tuple, list)) else (opt_state,)
    adam = next(s for s in states if hasattr(s, "mu") and hasattr(s, "nu"))
    return {"count": int(np.asarray(adam.count)),
            "mu": flax_params_to_state_dict(adam.mu, device),
            "nu": flax_params_to_state_dict(adam.nu, device)}


def train_state_from_jax(ts, cfg: "ppo.PPOConfig", static, device="cpu",
                         env_state=None) -> "ppo.TrainState":
    """A JAX ``PPOTrainState`` with numpy leaves -> the port's ``TrainState``:
    both networks, both optimizer states, ``lr``, ``epoch``, ``frame`` and
    the rollout carry. ``env_state`` replaces the conversion of
    ``ts.env_state`` when given. The JAX key does not carry over: the
    state's generator is seeded with 0."""
    actor_critic, central_value = ppo.make_networks(cfg, static, device)
    actor_critic.load_state_dict(flax_params_to_state_dict(ts.ac_params, device))
    if central_value is not None:
        central_value.load_state_dict(flax_params_to_state_dict(ts.cv_params, device))
    carry = ppo.RolloutCarry(
        env_state=env_state if env_state is not None else env_state_from_jax(ts.env_state, device),
        obs=_tensor(ts.obs, device),
        states=_tensor(ts.states, device),
        ep_return=_tensor(ts.ep_return, device),
        ep_len=_tensor(ts.ep_len, device).to(torch.int32),
    )
    out = ppo.TrainState.create(cfg, actor_critic, central_value, carry,
                                torch.Generator(device=device).manual_seed(0))
    out.ac_opt.load_state_dict(adam_state_from_jax(ts.ac_opt_state, device))
    if central_value is not None:
        out.cv_opt.load_state_dict(adam_state_from_jax(ts.cv_opt_state, device))
    out.lr = _tensor(ts.lr, device).to(torch.float32)
    out.epoch = int(np.asarray(ts.epoch))
    out.frame = int(np.asarray(ts.frame))
    return out
