"""Pose and goal samplers driven by pre-drawn random numbers (counterpart of
the ``*_from_uniform`` / ``*_from_normal`` samplers of
``leibnizgym_tpu/envs/trifinger/sample.py``).

Every sampler is a pure function of the uniform or normal columns it is
given, so a test can feed the reference's draws and compare exactly; the env
draws those columns from its ``torch.Generator``.
"""

from __future__ import annotations

import math

import torch

from leibnizgym_tpu_torch.utils.math import quaternion_from_euler_xyz


def default_orientation(num: int, device=None, dtype=torch.float32) -> torch.Tensor:
    """Identity quaternions, shape (num, 4), (x, y, z, w)."""
    quat = torch.zeros((num, 4), device=device, dtype=dtype)
    quat[:, 3] = 1.0
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


def random_angular_vel_from_normal(n4: torch.Tensor, magnitude_stdev) -> torch.Tensor:
    axis = n4[:, 0:3]
    axis = axis / torch.linalg.vector_norm(axis, dim=-1, keepdim=True)
    return axis * (n4[:, 3:4] * magnitude_stdev)
