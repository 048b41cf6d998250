"""Vectorized-task wrapper: obs / action clipping and gym-style spaces
(counterpart of ``leibnizgym_tpu/wrappers/vec_task.py``).

The env's tensors already live on its device, so ``rl_device`` moves
nothing: it is kept and reported, as the reference keeps it. ``None`` means
the env's device; a device other than the env's is an error, never a
quiet copy.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

try:
    from gymnasium import spaces
except ImportError:  # pragma: no cover
    spaces = None

from leibnizgym_tpu_torch.envs.trifinger.env import TrifingerEnv
from leibnizgym_tpu_torch.utils.helpers import resolve_device


class VecTask:
    """Wraps an env with clipping bounds and gym spaces."""

    def __init__(self, task: TrifingerEnv, rl_device=None, clip_obs: float = 5.0,
                 clip_actions: float = 1.0):
        assert isinstance(task, TrifingerEnv)
        self._task = task
        self._clip_obs = float(clip_obs)
        self._clip_actions = float(clip_actions)
        self._rl_device = _check_rl_device(rl_device, task.device)
        if spaces is not None:
            def box(n, bound):
                return spaces.Box(np.full(n, -bound, np.float32),
                                  np.full(n, bound, np.float32))

            self._obs_space = box(self.num_obs, self._clip_obs)
            self._state_space = box(self.num_states, self._clip_obs)
            self._act_space = box(self.num_actions, self._clip_actions)
        else:
            self._obs_space = self._state_space = self._act_space = None

    def __str__(self) -> str:
        return (
            f"Vectorized Environment around task: {type(self._task).__name__} \n"
            f"\t Number of instances   : {self.num_envs} \n"
            f"\t Number of observations: {self.num_obs} \n"
            f"\t Number of states      : {self.num_states} \n"
            f"\t Number of actions     : {self.num_actions} \n"
            f"\t Observation clipping  : {self._clip_obs} \n"
            f"\t Actions clipping      : {self._clip_actions} \n"
        )

    def get_number_of_agents(self) -> int:
        return 1

    @property
    def num_envs(self) -> int:
        return self._task.get_num_instances()

    @property
    def num_states(self) -> int:
        return self._task.get_state_dim()

    @property
    def num_obs(self) -> int:
        return self._task.get_obs_dim()

    @property
    def num_actions(self) -> int:
        return self._task.get_action_dim()

    @property
    def observation_space(self):
        return self._obs_space

    @property
    def state_space(self):
        return self._state_space

    @property
    def action_space(self):
        return self._act_space

    def dump_config(self, filename: str):
        self._task.dump_config(filename)

    def reset(self):
        raise NotImplementedError

    def step(self, actions):
        raise NotImplementedError


class VecTaskPython(VecTask):
    """Observations clipped to ``clip_obs``, actions to ``clip_actions``."""

    def get_state(self):
        states = self._task.get_state()
        if states is None:
            return None
        return torch.clamp(states, -self._clip_obs, self._clip_obs)

    def reset(self):
        return torch.clamp(self._task.reset(), -self._clip_obs, self._clip_obs)

    def step(self, actions) -> Tuple:
        if not torch.is_tensor(actions):
            # an array, as jnp.asarray takes it: in the env's dtype (JAX
            # without x64 makes a float64 array float32)
            actions = torch.as_tensor(actions, device=self._task.device, dtype=self._task.dtype)
        actions = torch.clamp(actions, -self._clip_actions, self._clip_actions)
        obs, rew, is_done, info = self._task.step(actions)
        return torch.clamp(obs, -self._clip_obs, self._clip_obs), rew, is_done, info


def _check_rl_device(rl_device, task_device: torch.device) -> torch.device:
    """The wrapper's device: the env's, which ``rl_device`` (None, a device
    string, ``"TPU"`` meaning ``cuda:0`` as everywhere in the port, or a
    ``torch.device``) may name but not change."""
    if rl_device is None:
        return task_device

    def indexed(d: torch.device) -> torch.device:
        return torch.device("cuda", torch.cuda.current_device()) if (
            d.type == "cuda" and d.index is None) else d

    if indexed(resolve_device(rl_device)) != indexed(task_device):
        raise ValueError(f"VecTask: rl_device {str(rl_device)!r} is not the env's device "
                         f"{task_device}; the wrapper moves no tensors, so build the env "
                         f"on {str(rl_device)!r} instead")
    return task_device
