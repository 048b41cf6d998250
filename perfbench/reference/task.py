"""Static description and params of a TriFinger task config, built as the
program's ``TrifingerEnv.__init__`` builds them, for ``num_envs`` rows of a
run of ``num_envs_global`` envs (a sample of rows: every env steps alone,
and the reward schedules count the whole run's env-steps)."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from perfbench.reference import trifinger as tf_model
from perfbench.reference.dims import CuboidalObject, SphereObject
from perfbench.reference.env import EnvParams, EnvStatic, build_params, build_static
from perfbench.reference.env_config import SIM_DEFAULT_CONFIG_DICT, TRIFINGER_DEFAULT_CONFIG_DICT


def _merged(base: dict, new: dict) -> dict:
    out = dict(base)
    for k, v in new.items():
        out[k] = _merged(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


def make_task(gym_cfg: dict, device, dtype=torch.float32, num_envs=None,
              num_envs_global=None) -> tuple[EnvStatic, EnvParams]:
    """(static, params) of ``gym_cfg`` on ``device`` in ``dtype``; the plain
    physics step (``engine`` "soa") whatever the config names."""
    merged = _merged(_merged(SIM_DEFAULT_CONFIG_DICT, TRIFINGER_DEFAULT_CONFIG_DICT), gym_cfg)
    if merged["asymmetric_obs"]:
        merged["enable_ft_sensors"] = True
    merged["engine"] = "soa"
    object_type = str(merged.get("object_type", "cube"))
    size = merged.get("object_size", 2 * tf_model.BALL_RADIUS if object_type == "sphere" else 0.065)
    dims_cls = SphereObject if object_type == "sphere" else CuboidalObject
    dims = dims_cls(float(size) if np.isscalar(size) else tuple(float(s) for s in size))
    static = build_static(merged, device)
    if num_envs is not None:
        static = dataclasses.replace(static, num_envs=int(num_envs),
                                     num_envs_global=int(num_envs_global or static.num_envs))
    density = merged.get("object_density")
    params = build_params(static, dims, arena=merged.get("arena"),
                          object_density=None if density is None else float(density),
                          device=device, dtype=dtype)
    return static, params
