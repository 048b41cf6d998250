"""Environments."""

from leibnizgym_tpu_torch.envs.trifinger.env import TrifingerEnv

__all__ = ["TrifingerEnv"]
