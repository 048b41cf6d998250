"""Scalar-component (structure-of-arrays) math helpers.

Counterpart of ``leibnizgym_tpu/ops/soa.py``: a vec3 is a 3-tuple and a mat3
a 3x3 nested tuple of same-shape tensors (or Python floats). With (N,)
columns every helper is batched over envs without a vmap, which is how the
plain engine runs. The same formulas, in the same order, are in the CUDA
kernel (``csrc/physics_step.cu``).
"""

from __future__ import annotations

import torch


def v3_add(a, b):
    return (a[0] + b[0], a[1] + b[1], a[2] + b[2])


def v3_sub(a, b):
    return (a[0] - b[0], a[1] - b[1], a[2] - b[2])


def v3_scale(a, s):
    return (a[0] * s, a[1] * s, a[2] * s)


def v3_dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def v3_cross(a, b):
    return (
        a[1] * b[2] - a[2] * b[1],
        a[2] * b[0] - a[0] * b[2],
        a[0] * b[1] - a[1] * b[0],
    )


def m3_matvec(m, v):
    return (
        m[0][0] * v[0] + m[0][1] * v[1] + m[0][2] * v[2],
        m[1][0] * v[0] + m[1][1] * v[1] + m[1][2] * v[2],
        m[2][0] * v[0] + m[2][1] * v[1] + m[2][2] * v[2],
    )


def m3_mul(a, b):
    return tuple(
        tuple(
            a[i][0] * b[0][j] + a[i][1] * b[1][j] + a[i][2] * b[2][j]
            for j in range(3)
        )
        for i in range(3)
    )


def m3_T(m):
    return tuple(tuple(m[j][i] for j in range(3)) for i in range(3))


def m3_rot_x(c, s):
    z = torch.zeros_like(c)
    o = torch.ones_like(c)
    return ((o, z, z), (z, c, -s), (z, s, c))


def m3_rot_y(c, s):
    z = torch.zeros_like(c)
    o = torch.ones_like(c)
    return ((c, z, s), (z, o, z), (-s, z, c))


def quat_to_m3(q):
    """Quaternion (x, y, z, w) 4-tuple -> mat3."""
    x, y, z, w = q
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    return (
        (1.0 - 2.0 * (yy + zz), 2.0 * (xy - wz), 2.0 * (xz + wy)),
        (2.0 * (xy + wz), 1.0 - 2.0 * (xx + zz), 2.0 * (yz - wx)),
        (2.0 * (xz - wy), 2.0 * (yz + wx), 1.0 - 2.0 * (xx + yy)),
    )


def quat_mul4(a, b):
    """Hamilton product on (x, y, z, w) 4-tuples."""
    x1, y1, z1, w1 = a
    x2, y2, z2, w2 = b
    return (
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
    )


def quat_normalize4(q, eps=1e-12):
    n = torch.sqrt(torch.clamp_min(
        q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3], eps))
    inv = 1.0 / n
    return (q[0] * inv, q[1] * inv, q[2] * inv, q[3] * inv)


def quat_integrate4(q, omega, dt):
    """q' = normalize(q + 0.5*dt * (omega_quat * q)); omega is a vec3."""
    ow = (omega[0], omega[1], omega[2], torch.zeros_like(omega[0]))
    dq = quat_mul4(ow, q)
    return quat_normalize4(
        (q[0] + 0.5 * dt * dq[0], q[1] + 0.5 * dt * dq[1],
         q[2] + 0.5 * dt * dq[2], q[3] + 0.5 * dt * dq[3])
    )


def chol3_factor(m):
    """Return the 6 Cholesky entries (l00, l10, l11, l20, l21, l22)."""
    a00, a10, a11, a20, a21, a22 = (
        m[0][0], m[1][0], m[1][1], m[2][0], m[2][1], m[2][2]
    )
    l00 = torch.sqrt(torch.clamp_min(a00, 1e-12))
    l10 = a10 / l00
    l20 = a20 / l00
    l11 = torch.sqrt(torch.clamp_min(a11 - l10 * l10, 1e-12))
    l21 = (a21 - l20 * l10) / l11
    l22 = torch.sqrt(torch.clamp_min(a22 - l20 * l20 - l21 * l21, 1e-12))
    return (l00, l10, l11, l20, l21, l22)


def chol3_solve_factored(f, b):
    l00, l10, l11, l20, l21, l22 = f
    y0 = b[0] / l00
    y1 = (b[1] - l10 * y0) / l11
    y2 = (b[2] - l20 * y0 - l21 * y1) / l22
    x2 = y2 / l22
    x1 = (y1 - l21 * x2) / l11
    x0 = (y0 - l10 * x1 - l20 * x2) / l00
    return (x0, x1, x2)

