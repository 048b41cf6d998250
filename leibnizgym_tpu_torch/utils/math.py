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


def quat_rotate_inverse(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate (..., 3) vectors ``v`` by the inverse of (..., 4) quaternions ``q``."""
    return quat_rotate(quat_conjugate(q), v)


def quat_normalize(q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    norm = torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    return q / torch.clamp_min(norm, eps)


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) quaternions (x, y, z, w) to (..., 3, 3) rotation matrices."""
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack(
        [
            1.0 - 2.0 * (yy + zz), 2.0 * (xy - wz), 2.0 * (xz + wy),
            2.0 * (xy + wz), 1.0 - 2.0 * (xx + zz), 2.0 * (yz - wx),
            2.0 * (xz - wy), 2.0 * (yz + wx), 1.0 - 2.0 * (xx + yy),
        ],
        dim=-1,
    )
    return m.reshape(q.shape[:-1] + (3, 3))


def quat_integrate(q: torch.Tensor, omega: torch.Tensor, dt) -> torch.Tensor:
    """First-order update of (..., 4) quaternions by world-frame angular
    velocities (..., 3) over ``dt``: normalize(q + dt * 0.5 * [omega, 0] q)."""
    omega_quat = torch.cat([omega, torch.zeros_like(omega[..., :1])], dim=-1)
    dq = 0.5 * quat_mul(omega_quat, q)
    return quat_normalize(q + dt * dq)


def matrix_to_quat(m: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) rotation matrices to (..., 4) quaternions (x, y, z, w), by
    a branch-free Shepperd selection (``torch.where`` over the four
    candidates)."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    trace = m00 + m11 + m22

    def safe_sqrt(x):
        return torch.sqrt(torch.clamp_min(x, 1e-12))

    qw0 = safe_sqrt(1.0 + trace) * 0.5
    s0 = 0.25 / qw0
    c0 = torch.stack([(m21 - m12) * s0, (m02 - m20) * s0, (m10 - m01) * s0, qw0], -1)

    qx1 = safe_sqrt(1.0 + m00 - m11 - m22) * 0.5
    s1 = 0.25 / qx1
    c1 = torch.stack([qx1, (m01 + m10) * s1, (m02 + m20) * s1, (m21 - m12) * s1], -1)

    qy2 = safe_sqrt(1.0 - m00 + m11 - m22) * 0.5
    s2 = 0.25 / qy2
    c2 = torch.stack([(m01 + m10) * s2, qy2, (m12 + m21) * s2, (m02 - m20) * s2], -1)

    qz3 = safe_sqrt(1.0 - m00 - m11 + m22) * 0.5
    s3 = 0.25 / qz3
    c3 = torch.stack([(m02 + m20) * s3, (m12 + m21) * s3, qz3, (m10 - m01) * s3], -1)

    cond0 = (trace > 0.0)[..., None]
    cond1 = ((m00 > m11) & (m00 > m22))[..., None]
    cond2 = (m11 > m22)[..., None]
    q = torch.where(cond0, c0, torch.where(cond1, c1, torch.where(cond2, c2, c3)))
    return quat_normalize(q)


def quat_from_axis_angle(axis: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """Quaternions from unit axes (..., 3) and angles (...,)."""
    half = angle * 0.5
    s = torch.sin(half)[..., None]
    w = torch.cos(half)[..., None]
    return torch.cat([axis * s, w], dim=-1)


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
