"""Batched forward kinematics of one TriFinger finger chain (counterpart of
the part of ``leibnizgym_tpu/ops/kinematics.py`` that ``ops/dynamics.py``
and ``ops/generic_chain.py`` use: ``FingerFK``, ``rot_x``, ``rot_y`` and
``finger_fk``).

The three fingers are kinematically independent and identical up to a mount
yaw, so kinematics and dynamics are computed in the finger-local frame (the
mount frame before the yaw). Every function broadcasts over leading batch
dims; constants follow ``q``'s device and dtype.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from leibnizgym_tpu_torch.models import trifinger as tf_model

# the chain constants as the JAX package rounds them (float32)
_O2 = np.asarray(tf_model.JOINT_OFFSETS[1], dtype=np.float32)
_O3 = np.asarray(tf_model.JOINT_OFFSETS[2], dtype=np.float32)
_TIP = np.asarray(tf_model.TIP_OFFSET, dtype=np.float32)


def const(x, like: torch.Tensor) -> torch.Tensor:
    """``x`` (numpy, tensor or nested floats) as a tensor on ``like``'s device
    and in its dtype."""
    return torch.as_tensor(x, device=like.device, dtype=like.dtype)


def _rot(theta: torch.Tensor, rows) -> torch.Tensor:
    c, s = torch.cos(theta), torch.sin(theta)
    z = torch.zeros_like(c)
    o = torch.ones_like(c)
    pick = {"c": c, "s": s, "-s": -s, "z": z, "o": o}
    return torch.stack([pick[k] for k in rows], dim=-1).reshape(theta.shape + (3, 3))


def rot_x(theta: torch.Tensor) -> torch.Tensor:
    """Rotation matrix about x, shape (..., 3, 3)."""
    return _rot(theta, ("o", "z", "z", "z", "c", "-s", "z", "s", "c"))


def rot_y(theta: torch.Tensor) -> torch.Tensor:
    """Rotation matrix about y, shape (..., 3, 3)."""
    return _rot(theta, ("c", "z", "s", "z", "o", "z", "-s", "z", "c"))


class FingerFK(NamedTuple):
    """Forward-kinematics products for one finger, finger-local frame.

    Shapes given for a (...,) batch of q triplets.
    """

    # link frame rotations (also the joint frames): upper, middle, lower
    link_rot: torch.Tensor  # (..., 3, 3, 3)
    # joint positions
    joint_pos: torch.Tensor  # (..., 3, 3)
    # joint axes in finger frame
    joint_axis: torch.Tensor  # (..., 3, 3)
    # tip frame position
    tip_pos: torch.Tensor  # (..., 3)
    # per-link COM positions
    link_com: torch.Tensor  # (..., 3, 3)


def matvec(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) @ (..., 3) -> (..., 3)."""
    return (m * v[..., None, :]).sum(-1)


def finger_fk(q: torch.Tensor, link_coms=None) -> FingerFK:
    """FK of one 3-DoF trifingerpro finger; ``q`` shape (..., 3).

    ``link_coms`` optionally overrides the per-link COM table (3, 3).
    """
    link_coms = const(tf_model.LINK_COMS if link_coms is None else link_coms, q)
    r1 = rot_y(q[..., 0])
    p1 = torch.zeros(q.shape[:-1] + (3,), device=q.device, dtype=q.dtype)
    p2 = matvec(r1, const(_O2, q))
    r2 = r1 @ rot_x(q[..., 1])
    p3 = p2 + matvec(r2, const(_O3, q))
    r3 = r2 @ rot_x(q[..., 2])
    tip = p3 + matvec(r3, const(_TIP, q))

    ey = const([0.0, 1.0, 0.0], q)
    ex = const([1.0, 0.0, 0.0], q)
    a1 = ey.expand(p1.shape)
    a2 = matvec(r1, ex)
    a3 = matvec(r2, ex)

    com1 = matvec(r1, link_coms[0])
    com2 = p2 + matvec(r2, link_coms[1])
    com3 = p3 + matvec(r3, link_coms[2])

    return FingerFK(
        link_rot=torch.stack([r1, r2, r3], dim=-3),
        joint_pos=torch.stack([p1, p2, p3], dim=-2),
        joint_axis=torch.stack([a1, a2, a3], dim=-2),
        tip_pos=tip,
        link_com=torch.stack([com1, com2, com3], dim=-2),
    )
