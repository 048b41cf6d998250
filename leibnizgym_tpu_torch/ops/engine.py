"""The batch-first reference physics engine (counterpart of
``leibnizgym_tpu/ops/engine.py``, the JAX package's readable oracle).

A second formulation of the step that ``ops/engine_v2.py`` and the CUDA
kernel compute: vectors and 3x3 matrices as tensors, contact groups as
slot axes, rather than scalar components. The reference writes it for one
env and vmaps it; here every tensor carries the env axis first, so one
function serves N = 1 and N = 8192. The order of operations is the
reference's: free velocities, per-substep finger and object quantities,
the contact slots of groups A (object vs ground), B (object vs wall), C
(tips vs object), D (tips vs ground), E (tips vs wall) and F (lower-link
samples vs object), pre-solve targets and effective masses, then
``solver_iterations`` Gauss-Seidel sweeps (PGS targets, or TGS mini-steps
that integrate depths and poses each iteration), tip impulses, position
integration and limits. The Gauss-Seidel accumulators are Python lists of
one tensor per slot, replaced, never written in place.

Plain PyTorch on any device. The env runs it under ``engine: "reference"``;
``chip_smoke.py`` holds the kernel to it on the card.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from leibnizgym_tpu_torch.models import trifinger as tf_model
from leibnizgym_tpu_torch.ops import dynamics
from leibnizgym_tpu_torch.ops.contact import (
    _CORNER_SIGNS,
    _tangent_basis,
    closest_point_on_box,
    contact_target,
    cube_body,
    restitution_target,
    solve_contact_friction,
    solve_contact_normal,
)
from leibnizgym_tpu_torch.ops.kinematics import (
    MOUNT_POS,
    MOUNT_ROTS,
    const,
    finger_fk,
    matvec,
    tip_jacobian,
)
from leibnizgym_tpu_torch.ops.dynamics import _cross
from leibnizgym_tpu_torch.ops.types import PhysicsState, SceneParams, SolverConfig
from leibnizgym_tpu_torch.utils.math import quat_integrate, saturate, solve_pd_3x3

_TIP_LOCAL_OFFSET = np.asarray(tf_model.TIP_SPHERE_OFFSET, dtype=np.float32)
_MAX_CUBE_ANGVEL = 64.0  # PhysX AssetOptions default max_angular_velocity


def _dot(a, b):
    return (a * b).sum(-1)


def _vm(v, m):
    """v @ m for (..., 3) and (..., 3, 3)."""
    return (v[..., :, None] * m).sum(-2)


def _quad(v, m):
    """v @ m @ v."""
    return _dot(_vm(v, m), v)


class _FingerPre(NamedTuple):
    """Per-finger quantities computed once per substep; N envs, 3 fingers,
    S lower-link samples."""

    tip_pos_w: torch.Tensor  # (N, 3, 3)
    jac_w: torch.Tensor  # (N, 3, 3, 3) world-frame linear tip Jacobian
    minv_jt: torch.Tensor  # (N, 3, 3, 3) M^-1 J_w^T (impulse -> delta qd)
    a_tip: torch.Tensor  # (N, 3, 3, 3) J M^-1 J^T (tip-point inverse mass)
    samp_pos_w: torch.Tensor  # (N, 3, S, 3)
    samp_jac_w: torch.Tensor  # (N, 3, S, 3, 3)
    samp_minv_jt: torch.Tensor  # (N, 3, S, 3, 3)
    samp_a: torch.Tensor  # (N, 3, S, 3, 3)


def _minv_jt(m, jac):
    """M^-1 J^T: solve M x = row_i(J) for each world axis i, then transpose
    (impulse index last)."""
    return solve_pd_3x3(m[..., None, :, :], jac).transpose(-1, -2)


def _finger_precompute(q_f: torch.Tensor, params: SceneParams,
                       with_samples: bool = True) -> _FingerPre:
    """``q_f`` (N, 3 fingers, 3 joints). ``with_samples=False`` (the
    link-object group gated off) skips the lower-link samples and returns
    zero-length sample axes."""
    mount_rot = const(MOUNT_ROTS, q_f)  # (3, 3, 3), one per finger
    fk = finger_fk(q_f)
    m = dynamics.mass_matrix(q_f, params.link_masses[:, None], params.armature[:, None])
    jac_w = mount_rot @ tip_jacobian(fk)
    minv_jt = _minv_jt(m, jac_w)
    a_tip = jac_w @ minv_jt
    tip_w = const(MOUNT_POS, q_f) + matvec(mount_rot, fk.tip_pos)

    n = q_f.shape[0]
    if not with_samples:
        def empty(*tail):
            return q_f.new_zeros((n, 3, 0) + tail)

        return _FingerPre(tip_w, jac_w, minv_jt, a_tip, empty(3), empty(3, 3),
                          empty(3, 3), empty(3, 3))

    # lower-link shaft sample points: sphere centers along the knee -> tip
    # segment (the reference's forearm collision meshes)
    knee = fk.joint_pos[..., 2, :]
    sp_w, sj_w, sm, sa = [], [], [], []
    for frac, _radius in tf_model.LOWER_LINK_SAMPLES:
        p_local = knee + frac * (fk.tip_pos - knee)
        rel = p_local[..., None, :] - fk.joint_pos  # (N, 3, 3 joints, 3)
        cols = _cross(fk.joint_axis, rel)  # rows = joints
        j_w = mount_rot @ cols.transpose(-1, -2)  # point Jacobian, columns = joints
        m_jt = _minv_jt(m, j_w)
        sp_w.append(const(MOUNT_POS, q_f) + matvec(mount_rot, p_local))
        sj_w.append(j_w)
        sm.append(m_jt)
        sa.append(j_w @ m_jt)
    return _FingerPre(tip_w, jac_w, minv_jt, a_tip, torch.stack(sp_w, 2),
                      torch.stack(sj_w, 2), torch.stack(sm, 2), torch.stack(sa, 2))


def _free_velocities(state: PhysicsState, tau: torch.Tensor, params: SceneParams, h: float):
    """External and actuation forces over one substep, no contacts."""
    n = tau.shape[0]
    q_f = state.q.reshape(n, 3, 3)
    qd_f = state.qd.reshape(n, 3, 3)
    tau_f = tau.reshape(n, 3, 3)
    qdd_f = dynamics.forward_dynamics(
        q_f, qd_f, tau_f, params.gravity[:, None], params.link_masses[:, None],
        params.joint_damping[:, None], params.armature[:, None],
    )
    qd_f = qd_f + h * qdd_f
    # object: PhysX-style damping, then gravity
    v = state.cube_linvel * torch.clamp_min(
        1.0 - params.cube_linear_damping * h, 0.0)[:, None]
    w = state.cube_angvel * torch.clamp_min(
        1.0 - params.cube_angular_damping * h, 0.0)[:, None]
    v = v + h * params.gravity
    return qd_f, v, w


def _substep(state: PhysicsState, tau: torch.Tensor, params: SceneParams,
             cfg: SolverConfig, h: float):
    """One substep of N envs; returns (state, tip impulse (N, 3, 3), tip
    torque impulse (N, 3, 3))."""
    n = tau.shape[0]
    # ---- unconstrained velocity update -----------------------------------
    qd_f, v, w = _free_velocities(state, tau, params, h)
    q_f = state.q.reshape(n, 3, 3)

    # ---- per-substep precomputation --------------------------------------
    pre = _finger_precompute(q_f, params, with_samples=cfg.enable_link_cube)
    body = cube_body(state.cube_pos, state.cube_quat, params.cube_mass, params.cube_inertia)
    inv_m, inv_i = body.inv_mass, body.inv_inertia_w  # (N,), (N, 3, 3)
    pos = state.cube_pos
    half = params.cube_half_extents
    # the tip-sphere center offset, applied in the world frame (the tip
    # stays near-vertical in the workspace)
    tip_centers = pre.tip_pos_w + const(_TIP_LOCAL_OFFSET, pos)
    tip_radius = params.tip_radius[:, None]

    sphere_obj = cfg.object_shape == 1
    radius_o = half[:, 0]  # sphere radius (half extents are (r, r, r))
    ground_n = const([0.0, 0.0, 1.0], pos)

    def wall_gap(pts):
        """Perpendicular gap (N, k) from points (N, k, 3) to the arena wall
        (positive inside) and inward normals (N, k, 3); the piecewise
        cylinder + cone profile (slope 0: the plain cylinder)."""
        slope = params.wall_slope[:, None]
        rho = torch.clamp_min(torch.linalg.vector_norm(pts[..., 0:2], dim=-1), 1e-9)
        z_over = torch.clamp_min(pts[..., 2] - params.wall_knee_z[:, None], 0.0)
        s = torch.where(z_over > 0.0, slope, 0.0)
        inv_len = 1.0 / torch.sqrt(1.0 + s * s)
        r_eff = params.wall_radius[:, None] + slope * z_over
        gap = (r_eff - rho) * inv_len
        nrm = torch.cat([-pts[..., 0:2] / rho[..., None] * inv_len[..., None],
                         (s * inv_len)[..., None]], dim=-1)
        return gap, nrm

    if sphere_obj:
        a_pts = (pos - ground_n * radius_o[:, None])[:, None]  # (N, 1, 3)
        if cfg.enable_cube_wall:
            # the contact point along the normal (center - n * radius), so the
            # normal impulse passes through the center on the cone too
            gap_c, b_n = wall_gap(pos[:, None])
            b_pts = (pos - b_n[:, 0] * radius_o[:, None])[:, None]
            b_depth = radius_o[:, None] - gap_c
    else:
        signs = const(_CORNER_SIGNS, pos)
        corners_w = pos[:, None] + torch.einsum("nij,ncj->nci", body.rot,
                                                signs * half[:, None])  # (N, 8, 3)
        a_pts = corners_w
        if cfg.enable_cube_wall:
            b_pts = corners_w
            gap_b, b_n = wall_gap(corners_w)
            b_depth = -gap_b
    n_a = a_pts.shape[1]  # object contact points per group
    if not cfg.enable_cube_wall:
        b_pts = pos.new_zeros((n, 0, 3))
        b_depth = pos.new_zeros((n, 0))
        b_n = pos.new_zeros((n, 0, 3))
    n_b = b_pts.shape[1]  # wall contact points (0 when gated off)

    # ---- contact slot construction ---------------------------------------
    # group A: object points vs ground
    a_depth = -a_pts[..., 2]
    a_r = a_pts - pos[:, None]
    # group B: object points vs arena wall; inward normal
    b_r = b_pts - pos[:, None]

    def obj_surface(center):
        """(n_w, sdist, point) of probe centers (N, k, 3): the signed
        distance to the object surface; +n pushes the object away from the
        probe."""
        if sphere_obj:
            delta = center - pos[:, None]
            d2 = _dot(delta, delta)
            dist = torch.sqrt(torch.clamp_min(d2, 1e-18))
            # degenerate probe at the center: a fixed +z direction
            dir_out = torch.where((d2 > 1e-16)[..., None], delta / dist[..., None], ground_n)
            sdist = dist - radius_o[:, None]
            point = pos[:, None] + radius_o[:, None, None] * dir_out
            return -dir_out, sdist, point
        rot = body.rot[:, None]
        local = matvec(rot.transpose(-1, -2), center - pos[:, None])
        n_local, sdist, surf_local = closest_point_on_box(local, half[:, None])
        n_w = -matvec(rot, n_local)
        point = pos[:, None] + matvec(rot, surf_local)
        return n_w, sdist, point

    # group C: tip spheres vs object (3)
    c_n, c_sdist, c_point = obj_surface(tip_centers)
    c_depth = tip_radius - c_sdist
    c_r = c_point - pos[:, None]

    # gated finger-side group counts (0 = group not built)
    n_d = 3 if cfg.enable_tip_ground else 0
    n_e = 3 if cfg.enable_tip_wall else 0

    # group D: tip spheres vs ground (3)
    d_depth = (tip_radius - tip_centers[..., 2])[:, :n_d]
    # group E: tip spheres vs arena wall (3); acts on the finger only
    e_gap, e_n = wall_gap(tip_centers[:, :n_e])
    e_depth = tip_radius - e_gap

    # group F: lower-link shaft samples vs object, slot f * S + s
    n_s = len(tf_model.LOWER_LINK_SAMPLES) if cfg.enable_link_cube else 0
    n_f = 3 * n_s
    samp_radii = const([r for _, r in tf_model.LOWER_LINK_SAMPLES][:n_s], pos)
    f_n, f_sdist, f_point = obj_surface(pre.samp_pos_w.reshape(n, n_f, 3))
    f_depth = samp_radii.repeat(3) - f_sdist
    f_jac = pre.samp_jac_w.reshape(n, n_f, 3, 3)
    f_minv_jt = pre.samp_minv_jt.reshape(n, n_f, 3, 3)
    f_a = pre.samp_a.reshape(n, n_f, 3, 3)

    # ---- effective masses, tangents, restitution targets -----------------
    def k_cube_dir(r, d):
        """Object inverse mass along d at arms r, (N, k, 3) each."""
        rxd = _cross(r, d)
        return inv_m[:, None] + _quad(rxd, inv_i[:, None])

    def cube_point_vel(r):
        return v[:, None] + _cross(w[:, None], r)

    qd_rep = qd_f.repeat_interleave(n_s, dim=1)  # the finger of each F slot
    tip_v = matvec(pre.jac_w, qd_f)  # (N, 3, 3)

    a_t1, a_t2 = _tangent_basis(ground_n)
    b_t = _tangent_basis(b_n)
    c_t = _tangent_basis(c_n)
    e_t = _tangent_basis(e_n)
    f_t = _tangent_basis(f_n)
    f_r = f_point - pos[:, None]

    # pre-solve normal velocities (restitution)
    a_vn0 = _dot(cube_point_vel(a_r), ground_n)
    b_vn0 = _dot(cube_point_vel(b_r), b_n)
    c_vn0 = _dot(cube_point_vel(c_r) - tip_v, c_n)
    d_vn0 = tip_v[:, :n_d, 2]
    e_vn0 = _dot(tip_v[:, :n_e], e_n)
    f_vn0 = _dot(cube_point_vel(f_r) - matvec(f_jac, qd_rep), f_n)

    bounce = params.bounce_threshold[:, None]

    def target(depth, vn0, restitution, bias_cap=None):
        return contact_target(depth, vn0, restitution, bounce, h, cfg, bias_cap=bias_cap)

    a_target = target(a_depth, a_vn0, params.restitution_cube_ground[:, None])
    b_target = target(b_depth, b_vn0, 0.0)
    c_target = target(c_depth, c_vn0, params.restitution_tip_cube[:, None])
    d_target = target(d_depth, d_vn0, params.restitution_tip_ground[:, None],
                      cfg.finger_bias_cap)
    e_target = target(e_depth, e_vn0, params.restitution_tip_wall[:, None],
                      cfg.finger_bias_cap)
    f_target = target(f_depth, f_vn0, params.restitution_link_cube[:, None])

    a_wn = k_cube_dir(a_r, ground_n)
    a_wt1 = k_cube_dir(a_r, a_t1)
    a_wt2 = k_cube_dir(a_r, a_t2)
    b_wn = k_cube_dir(b_r, b_n)
    b_wt1 = k_cube_dir(b_r, b_t[0])
    b_wt2 = k_cube_dir(b_r, b_t[1])
    c_wn = k_cube_dir(c_r, c_n) + _quad(c_n, pre.a_tip)
    c_wt1 = k_cube_dir(c_r, c_t[0]) + _quad(c_t[0], pre.a_tip)
    c_wt2 = k_cube_dir(c_r, c_t[1]) + _quad(c_t[1], pre.a_tip)
    # groups D and E act on the finger alone: their effective inverse mass
    # J M^-1 J^T can reach the kinematic singularity (a fully extended finger
    # at the wall) and is floored at cfg.w_min
    a_tip_d, a_tip_e = pre.a_tip[:, :n_d], pre.a_tip[:, :n_e]
    d_wn = torch.clamp_min(a_tip_d[..., 2, 2], cfg.w_min)
    d_wt1 = torch.clamp_min(a_tip_d[..., 0, 0], cfg.w_min)
    d_wt2 = torch.clamp_min(a_tip_d[..., 1, 1], cfg.w_min)
    e_wn = torch.clamp_min(_quad(e_n, a_tip_e), cfg.w_min)
    e_wt1 = torch.clamp_min(_quad(e_t[0], a_tip_e), cfg.w_min)
    e_wt2 = torch.clamp_min(_quad(e_t[1], a_tip_e), cfg.w_min)
    f_wn = k_cube_dir(f_r, f_n) + _quad(f_n, f_a)
    f_wt1 = k_cube_dir(f_r, f_t[0]) + _quad(f_t[0], f_a)
    f_wt2 = k_cube_dir(f_r, f_t[1]) + _quad(f_t[1], f_a)

    # torsional friction about the normal at object contacts (object side
    # only; torque bound mu_torsion * patch_radius * lambda_n); floored so a
    # degenerate zero normal gives a zero impulse, never 0/0
    def k_spin(nrm):
        return torch.clamp_min(_quad(nrm, inv_i.reshape((n,) + (1,) * (nrm.dim() - 2)
                                                       + (3, 3))), 1e-6)

    torsion = cfg.enable_torsion
    a_ws = k_spin(ground_n.expand(n, 3)) if torsion else None
    b_ws = k_spin(b_n) if torsion else None
    c_ws = k_spin(c_n) if torsion else None
    mu_tor_r = params.mu_torsion * params.torsion_patch_radius

    # ---- TGS mode (solver_type 1): per-iteration mini-steps ---------------
    # each iteration integrates the contact depths with the live normal
    # velocities and recomputes the positional bias from them; the
    # restitution part stays at the substep-start impact velocity
    tgs = cfg.solver_type == 1
    h_it = h / cfg.solver_iterations
    if tgs:
        def rest_of(depth, vn0, e):
            return restitution_target(depth, vn0, e, bounce, h)

        a_rest = rest_of(a_depth, a_vn0, params.restitution_cube_ground[:, None])
        b_rest = rest_of(b_depth, b_vn0, 0.0)
        c_rest = rest_of(c_depth, c_vn0, params.restitution_tip_cube[:, None])
        d_rest = rest_of(d_depth, d_vn0, params.restitution_tip_ground[:, None])
        e_rest = rest_of(e_depth, e_vn0, params.restitution_tip_wall[:, None])
        f_rest = rest_of(f_depth, f_vn0, params.restitution_link_cube[:, None])

    def tgs_target(d, rest, it, bias_cap=None):
        pen = cfg.tgs_bias / h_it * torch.clamp_min(d - cfg.contact_slop, 0.0)
        if bias_cap is not None:
            pen = torch.clamp_max(pen, bias_cap)
        h_rem = h - it * h_it  # speculative approach budget = remaining time
        bias = torch.where(d > 0.0, pen, d / h_rem)
        return torch.maximum(bias, rest)

    mu_cg, mu_cw = params.mu_cube_ground, params.mu_cube_wall
    mu_tc, mu_lc = params.mu_tip_cube, params.mu_link_cube
    mu_tg, mu_tw = params.mu_tip_ground, params.mu_tip_wall
    ex, ey, ez = (const(e, pos) for e in ([1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]))

    def cols(x, k):
        return [x[:, i] for i in range(k)]

    # Gauss-Seidel accumulators and TGS depths: one (N,) tensor per slot
    zero = pos.new_zeros(n)

    def slots(k, count):
        return [[zero] * k for _ in range(count)]

    a_ln, a_l1, a_l2, a_lt = slots(n_a, 4)
    b_ln, b_l1, b_l2, b_lt = slots(n_b, 4)
    c_ln, c_l1, c_l2, c_lt = slots(3, 4)
    d_ln, d_l1, d_l2 = slots(n_d, 3)
    e_ln, e_l1, e_l2 = slots(n_e, 3)
    f_ln, f_l1, f_l2 = slots(n_f, 3)
    if tgs:
        a_d, b_d, c_d = cols(a_depth, n_a), cols(b_depth, n_b), cols(c_depth, 3)
        d_d, e_d, f_d = cols(d_depth, n_d), cols(e_depth, n_e), cols(f_depth, n_f)
        p_pos, p_quat, p_q = pos, state.cube_quat, q_f
    qd = [qd_f[:, f] for f in range(3)]

    def apply_cube(p, r):
        """The object's velocity change from impulse p at arm r."""
        return v + inv_m[:, None] * p, w + matvec(inv_i, _cross(r, p))

    # ---- projected Gauss-Seidel sweeps -----------------------------------
    for it in range(cfg.solver_iterations):
        # -- A: object points vs ground
        for i in range(n_a):
            r = a_r[:, i]
            u = v + _cross(w, r)
            tgt = tgs_target(a_d[i], a_rest[:, i], it) if tgs else a_target[:, i]
            d_lam, nl = solve_contact_normal(_dot(u, ground_n), tgt, a_wn[:, i], a_ln[i])
            a_ln[i] = nl
            v, w = apply_cube(d_lam[:, None] * ground_n, r)
            mu_l = mu_cg * nl
            u = v + _cross(w, r)
            if tgs:
                a_d[i] = a_d[i] + (-_dot(u, ground_n) * h_it)
            d_lam, a_l1[i] = solve_contact_friction(_dot(u, a_t1), a_wt1[:, i], a_l1[i], mu_l)
            v, w = apply_cube(d_lam[:, None] * a_t1, r)
            u = v + _cross(w, r)
            d_lam, a_l2[i] = solve_contact_friction(_dot(u, a_t2), a_wt2[:, i], a_l2[i], mu_l)
            v, w = apply_cube(d_lam[:, None] * a_t2, r)
            if torsion:
                d_lam, a_lt[i] = solve_contact_friction(_dot(w, ground_n), a_ws, a_lt[i],
                                                        mu_tor_r * nl)
                w = w + matvec(inv_i, d_lam[:, None] * ground_n)

        # -- B: object points vs wall
        for i in range(n_b):
            r, nrm = b_r[:, i], b_n[:, i]
            u = v + _cross(w, r)
            tgt = tgs_target(b_d[i], b_rest[:, i], it) if tgs else b_target[:, i]
            d_lam, nl = solve_contact_normal(_dot(u, nrm), tgt, b_wn[:, i], b_ln[i])
            b_ln[i] = nl
            v, w = apply_cube(d_lam[:, None] * nrm, r)
            if tgs:
                u = v + _cross(w, r)
                b_d[i] = b_d[i] + (-_dot(u, nrm) * h_it)
            mu_l = mu_cw * nl
            for t_vec, w_t, lam_t in ((b_t[0][:, i], b_wt1[:, i], b_l1),
                                      (b_t[1][:, i], b_wt2[:, i], b_l2)):
                u = v + _cross(w, r)
                d_lam, lam_t[i] = solve_contact_friction(_dot(u, t_vec), w_t, lam_t[i], mu_l)
                v, w = apply_cube(d_lam[:, None] * t_vec, r)
            if torsion:
                d_lam, b_lt[i] = solve_contact_friction(_dot(w, nrm), b_ws[:, i], b_lt[i],
                                                        mu_tor_r * nl)
                w = w + matvec(inv_i, d_lam[:, None] * nrm)

        # -- C: tips vs object (impulse +P on the object, -P on finger f)
        for f in range(3):
            r, nrm, jac, minv = c_r[:, f], c_n[:, f], pre.jac_w[:, f], pre.minv_jt[:, f]
            u = (v + _cross(w, r)) - matvec(jac, qd[f])
            tgt = tgs_target(c_d[f], c_rest[:, f], it) if tgs else c_target[:, f]
            d_lam, nl = solve_contact_normal(_dot(u, nrm), tgt, c_wn[:, f], c_ln[f])
            c_ln[f] = nl
            p = d_lam[:, None] * nrm
            v, w = apply_cube(p, r)
            qd[f] = qd[f] + (-matvec(minv, p))
            if tgs:
                u = (v + _cross(w, r)) - matvec(jac, qd[f])
                c_d[f] = c_d[f] + (-_dot(u, nrm) * h_it)
            mu_l = mu_tc * nl
            for t_vec, w_t, lam_t in ((c_t[0][:, f], c_wt1[:, f], c_l1),
                                      (c_t[1][:, f], c_wt2[:, f], c_l2)):
                u = (v + _cross(w, r)) - matvec(jac, qd[f])
                d_lam, lam_t[f] = solve_contact_friction(_dot(u, t_vec), w_t, lam_t[f], mu_l)
                p = d_lam[:, None] * t_vec
                v, w = apply_cube(p, r)
                qd[f] = qd[f] + (-matvec(minv, p))
            # object-side spin resistance (the tip does not spin about n)
            if torsion:
                d_lam, c_lt[f] = solve_contact_friction(_dot(w, nrm), c_ws[:, f], c_lt[f],
                                                        mu_tor_r * nl)
                w = w + matvec(inv_i, d_lam[:, None] * nrm)

        # -- F: lower-link samples vs object (impulse +P object, -P finger)
        for j in range(n_f):
            f = j // n_s
            r, nrm, jac, minv = f_r[:, j], f_n[:, j], f_jac[:, j], f_minv_jt[:, j]
            u = (v + _cross(w, r)) - matvec(jac, qd[f])
            tgt = tgs_target(f_d[j], f_rest[:, j], it) if tgs else f_target[:, j]
            d_lam, nl = solve_contact_normal(_dot(u, nrm), tgt, f_wn[:, j], f_ln[j])
            f_ln[j] = nl
            p = d_lam[:, None] * nrm
            v, w = apply_cube(p, r)
            qd[f] = qd[f] + (-matvec(minv, p))
            if tgs:
                u = (v + _cross(w, r)) - matvec(jac, qd[f])
                f_d[j] = f_d[j] + (-_dot(u, nrm) * h_it)
            mu_l = mu_lc * nl
            for t_vec, w_t, lam_t in ((f_t[0][:, j], f_wt1[:, j], f_l1),
                                      (f_t[1][:, j], f_wt2[:, j], f_l2)):
                u = (v + _cross(w, r)) - matvec(jac, qd[f])
                d_lam, lam_t[j] = solve_contact_friction(_dot(u, t_vec), w_t, lam_t[j], mu_l)
                p = d_lam[:, None] * t_vec
                v, w = apply_cube(p, r)
                qd[f] = qd[f] + (-matvec(minv, p))

        # -- D: tips vs ground (impulse +P on the finger)
        for f in range(n_d):
            jac, minv = pre.jac_w[:, f], pre.minv_jt[:, f]
            u = matvec(jac, qd[f])
            tgt = (tgs_target(d_d[f], d_rest[:, f], it, bias_cap=cfg.finger_bias_cap)
                   if tgs else d_target[:, f])
            d_lam, nl = solve_contact_normal(u[:, 2], tgt, d_wn[:, f], d_ln[f])
            d_ln[f] = nl
            qd[f] = qd[f] + matvec(minv, d_lam[:, None] * ez)
            mu_l = mu_tg * nl
            u = matvec(jac, qd[f])
            if tgs:
                d_d[f] = d_d[f] + (-u[:, 2] * h_it)
            d_lam, d_l1[f] = solve_contact_friction(u[:, 0], d_wt1[:, f], d_l1[f], mu_l)
            qd[f] = qd[f] + matvec(minv, d_lam[:, None] * ex)
            u = matvec(jac, qd[f])
            d_lam, d_l2[f] = solve_contact_friction(u[:, 1], d_wt2[:, f], d_l2[f], mu_l)
            qd[f] = qd[f] + matvec(minv, d_lam[:, None] * ey)

        # -- E: tips vs arena wall (impulse +P on the finger, wall static)
        for f in range(n_e):
            nrm, jac, minv = e_n[:, f], pre.jac_w[:, f], pre.minv_jt[:, f]
            u = matvec(jac, qd[f])
            tgt = (tgs_target(e_d[f], e_rest[:, f], it, bias_cap=cfg.finger_bias_cap)
                   if tgs else e_target[:, f])
            d_lam, nl = solve_contact_normal(_dot(u, nrm), tgt, e_wn[:, f], e_ln[f])
            e_ln[f] = nl
            qd[f] = qd[f] + matvec(minv, d_lam[:, None] * nrm)
            if tgs:
                u = matvec(jac, qd[f])
                e_d[f] = e_d[f] + (-_dot(u, nrm) * h_it)
            mu_l = mu_tw * nl
            for t_vec, w_t, lam_t in ((e_t[0][:, f], e_wt1[:, f], e_l1),
                                      (e_t[1][:, f], e_wt2[:, f], e_l2)):
                u = matvec(jac, qd[f])
                d_lam, lam_t[f] = solve_contact_friction(_dot(u, t_vec), w_t, lam_t[f], mu_l)
                qd[f] = qd[f] + matvec(minv, d_lam[:, None] * t_vec)

        if tgs:
            # mini-step pose integration: the poses move each iteration while
            # contact frames and Jacobians stay at the substep start
            p_pos = p_pos + h_it * v
            p_quat = quat_integrate(p_quat, w, h_it)
            p_q = p_q + h_it * torch.stack(qd, 1)

    qd_f = torch.stack(qd, 1)

    # ---- fingertip contact impulses (force/torque sensing) ----------------
    # impulse ON each tip: the reaction of the object contact (-P) plus the
    # ground and wall contacts (+P); lower-link contacts act above the sensor
    def stack(xs, k):
        return torch.stack(xs, 1)[..., None] if k else None

    imp_c = -(stack(c_ln, 3) * c_n + stack(c_l1, 3) * c_t[0] + stack(c_l2, 3) * c_t[1])
    zeros33 = pos.new_zeros((n, 3, 3))
    imp_d = (stack(d_ln, n_d) * ez + stack(d_l1, n_d) * ex + stack(d_l2, n_d) * ey
             if n_d else zeros33)
    imp_e = (stack(e_ln, n_e) * e_n + stack(e_l1, n_e) * e_t[0] + stack(e_l2, n_e) * e_t[1]
             if n_e else zeros33)
    tip_impulse = imp_c + imp_d + imp_e  # (N, 3 fingers, 3)
    # torque impulse about the tip frame origin
    arm_c = c_point - pre.tip_pos_w
    arm_d = (tip_centers - tip_radius[..., None] * ez) - pre.tip_pos_w
    arm_e = ((tip_centers - tip_radius[..., None] * e_n) - pre.tip_pos_w
             if n_e else zeros33)
    tip_torque_impulse = _cross(arm_c, imp_c) + _cross(arm_d, imp_d) + _cross(arm_e, imp_e)

    # ---- position integration + limits -----------------------------------
    # (TGS integrated the poses in its mini-steps)
    q_new = (p_q if tgs else q_f + h * qd_f).reshape(n, 9)
    lower = const(cfg.joint_limit_lower, pos)
    upper = const(cfg.joint_limit_upper, pos)
    q_clamped = saturate(q_new, lower, upper)
    qd9 = qd_f.reshape(n, 9)
    # kill outward velocity at the limits
    at_lower = (q_new <= lower) & (qd9 < 0.0)
    at_upper = (q_new >= upper) & (qd9 > 0.0)
    qd9 = torch.where(at_lower | at_upper, 0.0, qd9)
    vlim = params.velocity_limit[:, None]
    qd9 = saturate(qd9, -vlim, vlim)

    w_norm = torch.linalg.vector_norm(w, dim=-1, keepdim=True)
    w = torch.where(w_norm > _MAX_CUBE_ANGVEL, w * (_MAX_CUBE_ANGVEL / w_norm), w)

    new_state = PhysicsState(
        q=q_clamped,
        qd=qd9,
        cube_pos=p_pos if tgs else pos + h * v,
        cube_quat=p_quat if tgs else quat_integrate(state.cube_quat, w, h),
        cube_linvel=v,
        cube_angvel=w,
    )
    return new_state, tip_impulse, tip_torque_impulse


def _batched_params(params: SceneParams, n: int) -> SceneParams:
    """Per-env params: unbatched (default-shaped) fields get the env axis."""
    if params.gravity.dim() == 2:
        return params
    return params.map(lambda x: x.expand((n,) + tuple(x.shape)))


def physics_step(state: PhysicsState, tau: torch.Tensor, params: SceneParams,
                 cfg: SolverConfig, dt: float = 0.02):
    """Advance N envs by one control step of ``dt`` seconds.

    ``state`` fields (N, ...), ``tau`` (N, 9) the saturated joint torque
    (held over the substeps), ``params`` per env (N, ...) or unbatched.
    Returns (new_state, tip_wrench (N, 3, 6)): each fingertip's contact
    force and torque averaged over the step (impulse / dt)."""
    n = tau.shape[0]
    params = _batched_params(params, n)
    h = dt / cfg.substeps
    acc_f = acc_t = tau.new_zeros((n, 3, 3))
    for _ in range(cfg.substeps):
        state, imp_f, imp_t = _substep(state, tau, params, cfg, h)
        acc_f, acc_t = acc_f + imp_f, acc_t + imp_t
    tip_wrench = torch.cat([acc_f / dt, acc_t / dt], dim=-1)
    return state, tip_wrench
