"""Shared inputs and conversions for the PyTorch port's parity tests.

No tests here: the test_torch_* modules import it. Inputs are made with
numpy from a seed and handed to both the JAX package and the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from leibnizgym_tpu.models import trifinger as tf_model
from leibnizgym_tpu.ops import types as jtypes
from leibnizgym_tpu_torch.ops import types as ttypes

STATE_FIELDS = ("q", "qd", "cube_pos", "cube_quat", "cube_linvel", "cube_angvel")


def random_physics(n: int, seed: int) -> dict:
    """Seeded states near contact: fingers around the default pose, the cube
    on or just above the floor, anywhere in the arena; plus torques."""
    rng = np.random.default_rng(seed)
    quat = rng.normal(size=(n, 4))
    quat /= np.linalg.norm(quat, axis=1, keepdims=True)
    d = {
        "q": np.tile(tf_model.JOINT_POS_DEFAULT, 3) + rng.uniform(-0.4, 0.4, (n, 9)),
        "qd": rng.uniform(-2.0, 2.0, (n, 9)),
        "cube_pos": np.stack([rng.uniform(-0.12, 0.12, n), rng.uniform(-0.12, 0.12, n),
                              rng.uniform(0.02, 0.08, n)], -1),
        "cube_quat": quat,
        "cube_linvel": rng.uniform(-0.5, 0.5, (n, 3)),
        "cube_angvel": rng.uniform(-3.0, 3.0, (n, 3)),
        "tau": rng.uniform(-0.36, 0.36, (n, 9)),
    }
    return {k: v.astype(np.float32) for k, v in d.items()}


def scene_arrays(n: int, seed: int, shape: str = "box", per_env: bool = False) -> dict:
    """Per-env SceneParams arrays (numpy float32) of the port's defaults. With
    ``per_env``, DR-like scales and the cone arena on even envs."""
    base = ttypes.SceneParams.default(object_shape=shape).broadcast(n)
    d = {k: v.numpy().copy() for k, v in base.fields().items()}
    if per_env:
        rng = np.random.default_rng(seed)
        d["wall_radius"][::2] = tf_model.WALL_CONE_BASE_RADIUS
        d["wall_slope"][::2] = tf_model.WALL_CONE_SLOPE
        d["wall_knee_z"][::2] = tf_model.WALL_CONE_KNEE_Z
        scale = rng.uniform(0.8, 1.2, n).astype(np.float32)
        d["cube_mass"] *= scale
        d["cube_inertia"] *= scale[:, None]
        d["link_masses"] *= rng.uniform(0.9, 1.1, (n, 3)).astype(np.float32)
        d["mu_tip_cube"] *= rng.uniform(0.7, 1.3, n).astype(np.float32)
        d["restitution_tip_cube"] = rng.uniform(0.0, 0.8, n).astype(np.float32)
    return d


def jax_inputs(phys: dict, scene: dict, dtype):
    state = jtypes.PhysicsState(**{k: jnp.asarray(phys[k], dtype) for k in STATE_FIELDS})
    params = jtypes.SceneParams(**{k: jnp.asarray(v, dtype) for k, v in scene.items()})
    return state, jnp.asarray(phys["tau"], dtype), params


def torch_inputs(phys: dict, scene: dict, dtype):
    state = ttypes.PhysicsState(
        **{k: torch.as_tensor(phys[k]).to(dtype) for k in STATE_FIELDS})
    params = ttypes.SceneParams(**{k: torch.as_tensor(v).to(dtype) for k, v in scene.items()})
    return state, torch.as_tensor(phys["tau"]).to(dtype), params


def jax_physics_step(cfg, dt=0.02):
    """JAX reference: jit(vmap(physics_step_v2)) for one static config."""
    from leibnizgym_tpu.ops.engine_v2 import physics_step_v2

    step = jax.vmap(physics_step_v2, in_axes=(0, 0, 0, None, None))
    return jax.jit(lambda s, t, p: step(s, t, p, cfg, dt))


def max_diff(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = b.detach().cpu().numpy().astype(np.float64) if torch.is_tensor(b) else np.asarray(b)
    return float(np.abs(a - b).max()) if a.size else 0.0
