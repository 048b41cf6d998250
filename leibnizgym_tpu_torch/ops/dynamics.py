"""Generalized-coordinate dynamics of one 3-DoF finger chain (counterpart of
``leibnizgym_tpu/ops/dynamics.py``).

The mass matrix is assembled from link Jacobians, the Coriolis + gravity
bias by recursive Newton-Euler, and the 3x3 system is solved by a
closed-form Cholesky (``utils.math.solve_pd_3x3``). The Euler-Lagrange
bias ``bias_forces_lagrangian`` (``torch.func`` autodiff of the mass matrix
and the potential) is the oracle the tests hold ``bias_forces`` to. The JAX functions are
written for one finger and vmapped; these take leading batch dims on every
argument that carries a batch (``q``, ``qd``, ``tau``, ``fk``) and
broadcast the rest (gravity, masses, inertias, damping, armature).
"""

from __future__ import annotations

import torch

from leibnizgym_tpu_torch.models import trifinger as tf_model
from leibnizgym_tpu_torch.ops.kinematics import FingerFK, const, finger_fk, matvec
from leibnizgym_tpu_torch.utils.math import solve_pd_3x3

# mask[l, i] = joint i moves link l
_LOWER_MASK = ((1.0, 0.0, 0.0), (1.0, 1.0, 0.0), (1.0, 1.0, 1.0))


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def link_jacobians(fk: FingerFK) -> tuple:
    """Linear & angular Jacobians of each link COM w.r.t. the 3 joints.

    Returns (jv, jw) of shape (..., 3 links, 3, 3 joints): column i of link l
    is the velocity of COM l per unit qd_i (zero for i > l).
    """
    mask = const(_LOWER_MASK, fk.link_com)[..., None]
    # rel[l, i] = com_l - p_i
    rel = fk.link_com[..., :, None, :] - fk.joint_pos[..., None, :, :]
    jv_cols = _cross(fk.joint_axis[..., None, :, :], rel) * mask  # (l, i, 3)
    jw_cols = fk.joint_axis[..., None, :, :].expand(jv_cols.shape) * mask
    # -> (l, 3, i): columns indexed by joint
    return jv_cols.transpose(-1, -2), jw_cols.transpose(-1, -2)


def _inertial(fk: FingerFK, link_masses, base_masses, base_inertias):
    """(masses (..., 3), world-frame link inertias R I R^T (..., 3, 3, 3)).
    ``link_masses`` scales masses and inertias proportionally."""
    like = fk.link_com
    base_masses = const(tf_model.LINK_MASSES if base_masses is None else base_masses, like)
    base_inertias = const(tf_model.LINK_INERTIAS if base_inertias is None else base_inertias,
                          like)
    masses = base_masses if link_masses is None else const(link_masses, like)
    inertias = base_inertias * (masses / base_masses)[..., None, None]
    r = fk.link_rot
    return masses, r @ inertias @ r.transpose(-1, -2)


def mass_matrix(q: torch.Tensor, link_masses=None, armature=None, fk: FingerFK = None,
                base_masses=None, base_inertias=None) -> torch.Tensor:
    """(..., 3, 3) joint-space mass matrix; ``q`` shape (..., 3).

    ``fk`` / ``base_masses`` / ``base_inertias`` override the default
    trifingerpro chain (robot variants, ``ops/generic_chain.py``).
    """
    if fk is None:
        fk = finger_fk(q)
    jv, jw = link_jacobians(fk)
    masses, i_w = _inertial(fk, link_masses, base_masses, base_inertias)
    m = torch.einsum("...l,...lki,...lkj->...ij", masses.expand(jv.shape[:-2]), jv, jv)
    m = m + torch.einsum("...lki,...lkm,...lmj->...ij", jw, i_w, jw)
    if armature is not None:
        m = m + torch.diag_embed(const(armature, m).expand(m.shape[:-1]))
    return m


def potential_energy(q: torch.Tensor, gravity, link_masses=None) -> torch.Tensor:
    """(...,) gravitational potential of one finger (finger-local frame;
    gravity is yaw-invariant, so this holds for every finger)."""
    fk = finger_fk(q)
    masses = const(tf_model.LINK_MASSES if link_masses is None else link_masses, q)
    return -(masses[..., :, None] * fk.link_com * const(gravity, q)[..., None, :]).sum((-2, -1))


def bias_forces_lagrangian(q: torch.Tensor, qd: torch.Tensor, gravity, link_masses=None,
                           armature=None) -> torch.Tensor:
    """(..., 3) Euler-Lagrange bias by autodiff, the oracle of ``bias_forces``:
    b = (dM/dq . qd) qd - 1/2 d(qd^T M qd)/dq + dV/dq, through
    ``torch.func.jacfwd`` / ``torch.func.grad`` of ``mass_matrix`` and
    ``potential_energy``. Leading batch dims of ``q`` / ``qd`` (and of the
    optional per-env ``gravity``, ``link_masses``, ``armature``) are mapped
    with ``torch.func.vmap``."""
    if q.dim() > 1:
        lead = q.shape[:-1]
        args = [None if x is None else const(x, q).expand(lead + const(x, q).shape[-1:])
                .reshape(-1, 3) for x in (gravity, link_masses, armature)]
        dims = [None if x is None else 0 for x in args]
        out = torch.func.vmap(bias_forces_lagrangian, in_dims=(0, 0, *dims))(
            q.reshape(-1, 3), qd.reshape(-1, 3), *args)
        return out.reshape(lead + (3,))

    def mq(qq):
        return matvec(mass_matrix(qq, link_masses, armature), qd)

    dmqd = torch.func.jacfwd(mq)(q)  # (3, 3): d(M qd)_i / dq_j

    def kinetic(qq):
        return 0.5 * (qd * matvec(mass_matrix(qq, link_masses, armature), qd)).sum()

    return (matvec(dmqd, qd) - torch.func.grad(kinetic)(q)
            + torch.func.grad(lambda qq: potential_energy(qq, gravity, link_masses))(q))


def bias_forces(q: torch.Tensor, qd: torch.Tensor, gravity, link_masses=None, armature=None,
                fk: FingerFK = None, base_masses=None, base_inertias=None) -> torch.Tensor:
    """(..., 3) Coriolis/centrifugal + gravity bias by recursive Newton-Euler
    (qdd = 0, base acceleration = -gravity). ``armature`` only adds to the
    mass matrix and is accepted for signature parity."""
    del armature
    if fk is None:
        fk = finger_fk(q)
    masses, i_w = _inertial(fk, link_masses, base_masses, base_inertias)
    gravity = const(gravity, qd)
    axes, joints, coms = fk.joint_axis, fk.joint_pos, fk.link_com  # (..., 3, 3)

    # forward pass: angular velocity/acceleration and linear acceleration of
    # each joint origin, then of each COM (all in the finger-local frame)
    zero = torch.zeros_like(joints[..., 0, :])
    omega_prev, alpha_prev, a_joint_prev, p_prev = zero, zero, -gravity, zero
    omega, alpha, a_com = [], [], []
    for i in range(3):
        d = joints[..., i, :] - p_prev
        a_joint = (a_joint_prev + _cross(alpha_prev, d)
                   + _cross(omega_prev, _cross(omega_prev, d)))
        w_axis = axes[..., i, :] * qd[..., i, None]
        w = omega_prev + w_axis
        al = alpha_prev + _cross(omega_prev, w_axis)  # qdd = 0
        rc = coms[..., i, :] - joints[..., i, :]
        ac = a_joint + _cross(al, rc) + _cross(w, _cross(w, rc))
        omega.append(w)
        alpha.append(al)
        a_com.append(ac)
        omega_prev, alpha_prev, a_joint_prev, p_prev = w, al, a_joint, joints[..., i, :]

    # backward pass: net link loads -> joint torques
    f_child = n_child = zero
    tau = [None, None, None]
    for i in reversed(range(3)):
        f_net = masses[..., i, None] * a_com[i]
        n_net = matvec(i_w[..., i, :, :], alpha[i]) + _cross(
            omega[i], matvec(i_w[..., i, :, :], omega[i]))
        n_i = n_net + n_child + _cross(coms[..., i, :] - joints[..., i, :], f_net)
        if i < 2:  # arm to the child joint
            n_i = n_i + _cross(joints[..., i + 1, :] - joints[..., i, :], f_child)
        tau[i] = (axes[..., i, :] * n_i).sum(-1)
        f_child, n_child = f_net + f_child, n_i
    return torch.stack(tau, dim=-1)


def forward_dynamics(q: torch.Tensor, qd: torch.Tensor, tau: torch.Tensor, gravity,
                     link_masses=None, joint_damping=None, armature=None,
                     fk: FingerFK = None, base_masses=None,
                     base_inertias=None) -> torch.Tensor:
    """(..., 3) joint accelerations qdd under applied torque ``tau``."""
    m = mass_matrix(q, link_masses, armature, fk, base_masses, base_inertias)
    b = bias_forces(q, qd, gravity, link_masses, armature, fk, base_masses, base_inertias)
    total = tau - b
    if joint_damping is not None:
        total = total - const(joint_damping, qd) * qd
    return solve_pd_3x3(m, total)
