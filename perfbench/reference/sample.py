"""Pose and goal samplers (counterpart of
``leibnizgym_tpu/envs/trifinger/sample.py``).

The ``*_from_uniform`` / ``*_from_normal`` samplers are pure functions of
the uniform or normal columns they are given, so a test can feed the
reference's draws and compare exactly; the env draws those columns from its
``torch.Generator``. The samplers that take a generator (the reference's
take a key) draw their columns from it, then call those.
"""

from __future__ import annotations

import math

import torch

from perfbench.reference.rmath import quaternion_from_euler_xyz


def default_orientation(num: int, device=None, dtype=torch.float32) -> torch.Tensor:
    """Identity quaternions, shape (num, 4), (x, y, z, w)."""
    quat = torch.zeros((num, 4), device=device, dtype=dtype)
    quat[:, 3].fill_(1.0)
    return quat


def random_xy_from_uniform(u2: torch.Tensor, max_com_distance_to_center):
    """u2: (num, 2) uniforms -> uniform positions in the disc."""
    radius = torch.sqrt(u2[:, 0]) * max_com_distance_to_center
    theta = 2.0 * math.pi * u2[:, 1]
    return radius * torch.cos(theta), radius * torch.sin(theta)


def random_z_from_uniform(u1: torch.Tensor, min_height, max_height) -> torch.Tensor:
    return (max_height - min_height) * u1 + min_height


def random_yaw_orientation_from_uniform(u1: torch.Tensor) -> torch.Tensor:
    zeros = torch.zeros_like(u1)
    return quaternion_from_euler_xyz(zeros, zeros, 2.0 * math.pi * u1)


def random_orientation_from_normal(n4: torch.Tensor) -> torch.Tensor:
    norm = torch.linalg.vector_norm(n4, dim=-1, keepdim=True)
    return n4 / torch.clamp_min(norm, 1e-12)


def scale_orientation_swing(quat: torch.Tensor, frac) -> torch.Tensor:
    """Orientation-difficulty curriculum: scale the out-of-plane (swing)
    rotation of ``quat`` by ``frac`` in [0, 1] and keep its twist about z.

    Swing-twist decomposition q = q_swing * q_twist with q_twist =
    normalize([0, 0, q.z, q.w]); the swing angle is multiplied by ``frac``
    (frac 0: yaw-only goals; frac 1: ``quat`` unchanged). A degenerate twist
    (a half turn about an axis in the xy-plane) falls back to the identity."""
    x, y, z, w = quat[..., 0], quat[..., 1], quat[..., 2], quat[..., 3]
    tw_norm = torch.sqrt(z * z + w * w)
    safe = tw_norm > 1e-6
    tz = torch.where(safe, z / torch.clamp_min(tw_norm, 1e-6), 0.0)
    tw = torch.where(safe, w / torch.clamp_min(tw_norm, 1e-6), 1.0)
    # q_swing = q * conj(q_twist), conj(q_twist) = (0, 0, -tz, tw)
    sx = x * tw - y * tz
    sy = y * tw + x * tz
    sz = z * tw - w * tz
    sw = w * tw + z * tz
    s_vec_norm = torch.sqrt(sx * sx + sy * sy + sz * sz)
    new_half = frac * torch.atan2(s_vec_norm, sw)
    scale = torch.where(s_vec_norm > 1e-6,
                        torch.sin(new_half) / torch.clamp_min(s_vec_norm, 1e-6), 0.0)
    nsx, nsy, nsz, nsw = sx * scale, sy * scale, sz * scale, torch.cos(new_half)
    # q' = q_swing' * q_twist
    out = torch.stack([nsx * tw + nsy * tz, nsy * tw - nsx * tz,
                       nsz * tw + nsw * tz, nsw * tw - nsz * tz], dim=-1)
    return out / torch.linalg.vector_norm(out, dim=-1, keepdim=True)

