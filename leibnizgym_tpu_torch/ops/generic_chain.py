"""Generic-chain finger kinematics/dynamics for robot URDF variants
(counterpart of ``leibnizgym_tpu/ops/generic_chain.py``).

The env's physics kernel bakes trifingerpro's chain (axes y/x/x, a shared
mount height). This module is the variant path: FK and robot-only physics
for ANY :class:`~leibnizgym_tpu_torch.models.chain.ChainModel`
(trifingeredu, trifinger, single-finger edu/pro, ... — every robot URDF
under ``resources/assets/robots/``), with arbitrary per-joint origin
rotations, rotation axes and per-finger mount transforms.

The dynamics reuse :mod:`leibnizgym_tpu_torch.ops.dynamics` (Jacobians, RNEA
bias and mass matrix are chain-agnostic given a FingerFK); only the FK is
generalized here (Rodrigues rotation about the URDF axis). Contacts are out
of scope, as in the JAX package: gravity, torque saturation, velocity and
joint limits. Plain PyTorch: the JAX package has no Pallas kernel here.
Every function takes leading batch dims; the chain's numpy tables become
tensors on the state's device and in its dtype.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from leibnizgym_tpu_torch.models.chain import ChainModel
from leibnizgym_tpu_torch.ops import dynamics
from leibnizgym_tpu_torch.ops.kinematics import FingerFK, const, matvec
from leibnizgym_tpu_torch.utils.math import skew


def _rodrigues(axis: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """Rotation matrix about a fixed unit ``axis`` (3,) by angle (...,)."""
    k = skew(axis)
    c = torch.cos(theta)[..., None, None]
    s = torch.sin(theta)[..., None, None]
    eye = torch.eye(3, device=theta.device, dtype=theta.dtype)
    return eye + s * k + (1.0 - c) * (k @ k)


def finger_fk_chain(q: torch.Tensor, chain: ChainModel) -> FingerFK:
    """FK of one generic 3-DoF finger in the finger (mount) frame.

    ``q`` shape (..., 3). Returns the FingerFK structure of
    :func:`ops.kinematics.finger_fk`, so the dynamics work unchanged.
    """
    batch = q.shape[:-1]
    r = torch.eye(3, device=q.device, dtype=q.dtype).expand(batch + (3, 3))
    p = torch.zeros(batch + (3,), device=q.device, dtype=q.dtype)
    joint_pos, joint_axis, link_rot, link_com = [], [], [], []
    for i in range(3):
        axis = const(chain.joint_axis[i], q)
        p = p + matvec(r, const(chain.joint_xyz[i], q))
        r = r @ const(chain.joint_rot[i], q)
        joint_pos.append(p)
        joint_axis.append(matvec(r, axis))
        r = r @ _rodrigues(axis, q[..., i])
        link_rot.append(r)
        link_com.append(p + matvec(r, const(chain.link_coms[i], q)))
    tip = p + matvec(r, const(chain.tip_xyz, q))
    return FingerFK(
        link_rot=torch.stack(link_rot, dim=-3),
        joint_pos=torch.stack(joint_pos, dim=-2),
        joint_axis=torch.stack(joint_axis, dim=-2),
        tip_pos=tip,
        link_com=torch.stack(link_com, dim=-2),
    )


def tips_world_chain(q: torch.Tensor, chain: ChainModel) -> torch.Tensor:
    """World tip positions for all fingers; ``q`` (..., 3F) -> (..., F, 3)."""
    f = chain.num_fingers
    q_f = q.reshape(q.shape[:-1] + (f, 3))
    tips = []
    for i in range(f):
        fk = finger_fk_chain(q_f[..., i, :], chain)
        tips.append(const(chain.mount_pos[i], q) + matvec(const(chain.mount_rot[i], q),
                                                          fk.tip_pos))
    return torch.stack(tips, dim=-2)


class ChainState(NamedTuple):
    """Robot-only physics state for a generic chain; env-batched."""

    q: torch.Tensor  # (N, 3F)
    qd: torch.Tensor  # (N, 3F)


def chain_default_state(chain: ChainModel, n: int, q0: Optional[torch.Tensor] = None,
                        device="cuda:0", dtype=torch.float32) -> ChainState:
    """N envs at ``q0`` (default: mid-range of every joint) at rest, on
    ``device`` (``cuda:0`` unless the caller passes another)."""
    f = chain.num_fingers
    like = torch.empty(0, device=device, dtype=dtype)
    if q0 is None:
        q0 = const(0.5 * (chain.joint_lower + chain.joint_upper), like).repeat(f)
    q0 = const(q0, like)
    return ChainState(q=q0.expand(n, 3 * f).clone(),
                      qd=torch.zeros((n, 3 * f), device=like.device, dtype=dtype))


def chain_physics_step(state: ChainState, tau: torch.Tensor, chain: ChainModel,
                       dt: float = 0.02, substeps: int = 4, joint_damping: float = 0.0,
                       armature: float = 0.0) -> ChainState:
    """Robot-only semi-implicit step: forward dynamics + torque saturation +
    joint limits (hard clamp with velocity zeroing, PhysX-style).

    Gravity is rotated into each finger's mount frame, so non-yaw mounts are
    handled exactly. ``tau`` (N, 3F) is clamped to the URDF effort limit.
    """
    f = chain.num_fingers
    h = dt / substeps
    like = state.q
    g_world = const([0.0, 0.0, -9.81], like)
    damping = torch.full((3,), joint_damping, device=like.device, dtype=like.dtype)
    arma = torch.full((3,), armature, device=like.device, dtype=like.dtype)
    effort = const(chain.effort_limit, like)
    vel_lim = const(chain.velocity_limit, like).repeat(f)
    lo, hi = const(chain.joint_lower, like).repeat(f), const(chain.joint_upper, like).repeat(f)
    masses, inertias = const(chain.link_masses, like), const(chain.link_inertias, like)
    g_local = [const(chain.mount_rot[i], like).T @ g_world for i in range(f)]

    q, qd = state.q, state.qd
    tau_f = torch.clamp(tau.reshape(-1, f, 3), -effort, effort)
    for _ in range(substeps):
        q_f = q.reshape(-1, f, 3)
        qd_f = qd.reshape(-1, f, 3)
        qdd = torch.stack([
            dynamics.forward_dynamics(
                q_f[:, i], qd_f[:, i], tau_f[:, i], g_local[i], link_masses=masses,
                joint_damping=damping, armature=arma, fk=finger_fk_chain(q_f[:, i], chain),
                base_masses=masses, base_inertias=inertias)
            for i in range(f)], dim=1).reshape(q.shape)
        qd = torch.clamp(qd + h * qdd, -vel_lim, vel_lim)
        q_new = q + h * qd
        # hard joint limits: clamp position, zero outward velocity
        hit_lo, hit_hi = q_new < lo, q_new > hi
        q = torch.clamp(q_new, lo, hi)
        qd = torch.where(hit_lo, torch.clamp_min(qd, 0.0), qd)
        qd = torch.where(hit_hi, torch.clamp_max(qd, 0.0), qd)
    return ChainState(q=q, qd=qd)
