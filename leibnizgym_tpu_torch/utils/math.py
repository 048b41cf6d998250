"""Normalization transforms and quaternion algebra on tensors (counterpart
of ``leibnizgym_tpu/utils/math.py``). Quaternions are (x, y, z, w), real part
last; every function broadcasts over leading batch dims."""

from __future__ import annotations

import torch


def scale_transform(x: torch.Tensor, lower: torch.Tensor, upper: torch.Tensor) -> torch.Tensor:
    """Normalize ``x`` from ``[lower, upper]`` to ``[-1, 1]``."""
    offset = (lower + upper) * 0.5
    return 2.0 * (x - offset) / (upper - lower)


def unscale_transform(x: torch.Tensor, lower: torch.Tensor, upper: torch.Tensor) -> torch.Tensor:
    """Denormalize ``x`` from ``[-1, 1]`` to ``[lower, upper]``."""
    offset = (lower + upper) * 0.5
    return x * (upper - lower) * 0.5 + offset


def saturate(x: torch.Tensor, lower: torch.Tensor, upper: torch.Tensor) -> torch.Tensor:
    """Clamp ``x`` to ``[lower, upper]``."""
    return torch.maximum(torch.minimum(x, upper), lower)


def quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product of two (..., 4) quaternions."""
    x1, y1, z1, w1 = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    x2, y2, z2, w2 = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    x = w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2
    y = w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2
    z = w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2
    w = w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2
    return torch.stack([x, y, z, w], dim=-1)


def quat_conjugate(a: torch.Tensor) -> torch.Tensor:
    return torch.cat([-a[..., :3], a[..., 3:4]], dim=-1)


def quat_diff_rad(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Angle between two (..., 4) quaternions: 2 asin(min(|vec(a conj(b))|, 1))."""
    mul = quat_mul(a, quat_conjugate(b))
    vec_norm = torch.linalg.vector_norm(mul[..., 0:3], dim=-1)
    return 2.0 * torch.asin(torch.clamp(vec_norm, max=1.0))


def quaternion_from_euler_xyz(roll: torch.Tensor, pitch: torch.Tensor,
                              yaw: torch.Tensor) -> torch.Tensor:
    """Euler XYZ (radians) to quaternion (x, y, z, w)."""
    cy = torch.cos(yaw * 0.5)
    sy = torch.sin(yaw * 0.5)
    cr = torch.cos(roll * 0.5)
    sr = torch.sin(roll * 0.5)
    cp = torch.cos(pitch * 0.5)
    sp = torch.sin(pitch * 0.5)
    qw = cy * cr * cp + sy * sr * sp
    qx = cy * sr * cp - sy * cr * sp
    qy = cy * cr * sp + sy * sr * cp
    qz = sy * cr * cp - cy * sr * sp
    return torch.stack([qx, qy, qz, qw], dim=-1)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate (..., 3) vectors ``v`` by (..., 4) quaternions ``q``."""
    qvec = q[..., 0:3]
    qw = q[..., 3:4]
    t = 2.0 * torch.linalg.cross(qvec, v, dim=-1)
    return v + qw * t + torch.linalg.cross(qvec, t, dim=-1)


def quat_normalize(q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    norm = torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    return q / torch.clamp_min(norm, eps)
