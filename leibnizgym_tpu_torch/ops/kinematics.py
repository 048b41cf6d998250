"""Batched forward kinematics of one TriFinger finger chain (counterpart of
``leibnizgym_tpu/ops/kinematics.py``).

The three fingers are kinematically independent and identical up to a mount
yaw, so kinematics and dynamics are computed in the finger-local frame (the
mount frame before the yaw); ``MOUNT_ROTS`` / ``MOUNT_POS`` and the world
helpers below apply the mount transform. Every function broadcasts over
leading batch dims; constants follow ``q``'s device and dtype.
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
_MOUNT_Z = tf_model.MOUNT_HEIGHT


_CONSTS: dict = {}


def const(x, like: torch.Tensor) -> torch.Tensor:
    """``x`` (numpy, tensor or nested floats) as a tensor on ``like``'s device
    and in its dtype. Host values are copied to the device once per value,
    device and dtype, and the copy is shared: a CUDA graph captured after the
    first call reads it and makes no host copy. Callers do not write into
    it."""
    if torch.is_tensor(x):
        return x.to(device=like.device, dtype=like.dtype)
    a = np.asarray(x)
    key = (a.dtype.str, a.shape, a.tobytes(), like.device, like.dtype)
    t = _CONSTS.get(key)
    if t is None:
        t = _CONSTS[key] = torch.as_tensor(a, device=like.device, dtype=like.dtype)
    return t


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


def rot_z(theta: torch.Tensor) -> torch.Tensor:
    """Rotation matrix about z, shape (..., 3, 3)."""
    return _rot(theta, ("c", "-s", "z", "s", "c", "z", "z", "z", "o"))


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


def tip_jacobian(fk: FingerFK) -> torch.Tensor:
    """Linear Jacobian of the tip w.r.t. the 3 joint angles, (..., 3, 3);
    column i is ``axis_i x (tip - joint_i)``."""
    rel = fk.tip_pos[..., None, :] - fk.joint_pos  # (..., 3 joints, 3)
    cols = torch.linalg.cross(fk.joint_axis, rel, dim=-1)
    return cols.transpose(-1, -2)  # columns = joints


def tip_velocity(fk: FingerFK, qd: torch.Tensor) -> torch.Tensor:
    """Linear velocity of the tip; ``qd`` shape (..., 3)."""
    return matvec(tip_jacobian(fk), qd)


def tip_angular_velocity(fk: FingerFK, qd: torch.Tensor) -> torch.Tensor:
    """Angular velocity of the tip link: the sum over joints of axis_j * qd_j."""
    return (fk.joint_axis * qd[..., :, None]).sum(-2)


# ---------------------------------------------------------------------------
# World-frame helpers (the mount transform)
# ---------------------------------------------------------------------------

# (3, 3, 3) per-finger world rotation: trig in float64, then rounded to
# float32 as the reference does
MOUNT_ROTS = np.stack(
    [
        np.array([[np.cos(y), -np.sin(y), 0.0], [np.sin(y), np.cos(y), 0.0],
                  [0.0, 0.0, 1.0]])
        for y in np.asarray(tf_model.FINGER_MOUNT_YAWS, dtype=np.float64)
    ]
).astype(np.float32)
MOUNT_POS = np.array([0.0, 0.0, _MOUNT_Z], dtype=np.float32)


def finger_to_world(x_local: torch.Tensor, finger_rot: torch.Tensor) -> torch.Tensor:
    """Finger-local points (..., 3) to world, given the mount rotation."""
    return const(MOUNT_POS, x_local) + matvec(finger_rot, x_local)


def all_tips_world(q9: torch.Tensor):
    """World tip positions (..., 3, 3) and rotations (..., 3, 3, 3) of the
    three fingers from (..., 9) joint positions (finger-major), and the
    per-finger FK (finger axis before each field's own dims)."""
    q_f = q9.reshape(q9.shape[:-1] + (3, 3))  # (..., finger, joint)
    fk = finger_fk(q_f)
    rots = const(MOUNT_ROTS, q9)
    tip_w = const(MOUNT_POS, q9) + matvec(rots, fk.tip_pos)
    tip_rot_w = rots @ fk.link_rot[..., 2, :, :]
    return tip_w, tip_rot_w, fk
