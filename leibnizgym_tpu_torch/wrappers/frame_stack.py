"""Frame-stacking wrapper (counterpart of
``leibnizgym_tpu/wrappers/frame_stack.py``, rl_games wrappers.FrameStack
parity): a rolling (frames, N, obs_dim) buffer on the env's device."""

from __future__ import annotations

import torch


class FrameStack:
    """Stacks the last ``num_frames`` observations along the feature axis,
    oldest first; ``reset`` fills the stack with the reset observation."""

    def __init__(self, env, num_frames: int, flatten: bool = True):
        self.env = env
        self.num_frames = int(num_frames)
        self.flatten = flatten
        self._buf = None

    @property
    def num_envs(self):
        return self.env.num_envs

    @property
    def num_obs(self):
        return self.env.num_obs * self.num_frames

    @property
    def num_states(self):
        return self.env.num_states

    @property
    def num_actions(self):
        return self.env.num_actions

    def _stacked(self):
        if self.flatten:
            return self._buf.transpose(0, 1).reshape(self._buf.shape[1], -1)
        return self._buf

    def reset(self):
        obs = self.env.reset()
        self._buf = torch.stack([obs] * self.num_frames)
        return self._stacked()

    def step(self, actions):
        obs, rew, done, info = self.env.step(actions)
        self._buf = torch.cat([self._buf[1:], obs[None]])
        return self._stacked(), rew, done, info

    def get_state(self):
        return self.env.get_state()

    def __getattr__(self, name):
        return getattr(self.env, name)


def stack_if_frames(env, frames: int):
    """FrameStack when a policy was trained with ``frames > 1``: the
    inference-side counterpart of the stack ``learning/ppo.py``'s rollout
    rolls."""
    return FrameStack(env, frames, flatten=True) if frames > 1 else env
