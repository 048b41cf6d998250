"""Vectorized-task wrapper: obs / action clipping and gym-style spaces
(counterpart of ``leibnizgym_tpu/wrappers/vec_task.py``)."""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

try:
    from gymnasium import spaces
except ImportError:  # pragma: no cover
    spaces = None

from leibnizgym_tpu_torch.envs.trifinger.env import TrifingerEnv


class VecTask:
    """Wraps an env with clipping bounds and gym spaces."""

    def __init__(self, task: TrifingerEnv, clip_obs: float = 5.0,
                 clip_actions: float = 1.0):
        assert isinstance(task, TrifingerEnv)
        self._task = task
        self._clip_obs = float(clip_obs)
        self._clip_actions = float(clip_actions)
        if spaces is not None:
            def box(n, bound):
                return spaces.Box(np.full(n, -bound, np.float32),
                                  np.full(n, bound, np.float32))

            self._obs_space = box(self.num_obs, self._clip_obs)
            self._state_space = box(self.num_states, self._clip_obs)
            self._act_space = box(self.num_actions, self._clip_actions)
        else:
            self._obs_space = self._state_space = self._act_space = None

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
        actions = torch.clamp(actions, -self._clip_actions, self._clip_actions)
        obs, rew, is_done, info = self._task.step(actions)
        return torch.clamp(obs, -self._clip_obs, self._clip_obs), rew, is_done, info
