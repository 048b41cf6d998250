"""Normalization transforms, quaternion algebra and the 3x3 helpers of the
robot dynamics on tensors (counterpart of ``leibnizgym_tpu/utils/math.py``). Quaternions are (x, y, z, w), real part
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


def skew(v: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric cross-product matrix of (..., 3) -> (..., 3, 3)."""
    zeros = torch.zeros_like(v[..., 0])
    return torch.stack(
        [
            torch.stack([zeros, -v[..., 2], v[..., 1]], dim=-1),
            torch.stack([v[..., 2], zeros, -v[..., 0]], dim=-1),
            torch.stack([-v[..., 1], v[..., 0], zeros], dim=-1),
        ],
        dim=-2,
    )


def solve_pd_3x3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve ``a @ x = b`` for symmetric positive-definite 3x3 ``a`` by a
    closed-form Cholesky factor, batched over leading dims."""
    a00 = a[..., 0, 0]
    a10 = a[..., 1, 0]
    a11 = a[..., 1, 1]
    a20 = a[..., 2, 0]
    a21 = a[..., 2, 1]
    a22 = a[..., 2, 2]
    l00 = torch.sqrt(torch.clamp_min(a00, 1e-12))
    l10 = a10 / l00
    l20 = a20 / l00
    l11 = torch.sqrt(torch.clamp_min(a11 - l10 * l10, 1e-12))
    l21 = (a21 - l20 * l10) / l11
    l22 = torch.sqrt(torch.clamp_min(a22 - l20 * l20 - l21 * l21, 1e-12))
    # forward substitution L y = b
    y0 = b[..., 0] / l00
    y1 = (b[..., 1] - l10 * y0) / l11
    y2 = (b[..., 2] - l20 * y0 - l21 * y1) / l22
    # back substitution L^T x = y
    x2 = y2 / l22
    x1 = (y1 - l21 * x2) / l11
    x0 = (y0 - l10 * x1 - l20 * x2) / l00
    return torch.stack([x0, x1, x2], dim=-1)
