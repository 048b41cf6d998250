"""TriFinger task environment."""

from leibnizgym_tpu_torch.envs.trifinger.config import TRIFINGER_DEFAULT_CONFIG_DICT
from leibnizgym_tpu_torch.envs.trifinger.dims import (
    ARENA_RADIUS,
    CuboidalObject,
    TrifingerDimensions,
)
from leibnizgym_tpu_torch.envs.trifinger.env import (
    EnvParams,
    EnvState,
    EnvStatic,
    TrifingerEnv,
    env_reset,
    env_step,
)

__all__ = [
    "TRIFINGER_DEFAULT_CONFIG_DICT",
    "ARENA_RADIUS",
    "CuboidalObject",
    "TrifingerDimensions",
    "EnvParams",
    "EnvState",
    "EnvStatic",
    "TrifingerEnv",
    "env_reset",
    "env_step",
]
