"""Plain PyTorch SoA physics engine (counterpart of ``ops/engine_v2.py``).

This is the CUDA kernel's plain version and its oracle. Every intermediate
is a scalar component; with (N,) rows as components the whole substep is
batched over envs as written, so no vmap is needed. The formulas and their
order follow the reference line by line (both solvers, both object shapes,
every ``enable_*`` gate); ``csrc/physics_step.cu`` computes the same step
from solver rows built once per substep, and ``ops/cuda_engine.step_flops``
counts this file's operations as the kernel's bound.

Everything static (chain offsets, mount yaws, link inertias, joint limits)
is a Python float, read from the port's ``models/trifinger.py``.
"""

from __future__ import annotations

import math
from types import SimpleNamespace
from typing import NamedTuple

import torch

from perfbench.reference import trifinger as tf_model
from perfbench.reference.soa import (
    chol3_factor,
    chol3_solve_factored,
    m3_T,
    m3_matvec,
    m3_mul,
    m3_rot_x,
    m3_rot_y,
    quat_integrate4,
    quat_normalize4,
    quat_to_m3,
    v3_add,
    v3_cross,
    v3_dot,
    v3_scale,
    v3_sub,
)
from perfbench.reference.types import PhysicsState, SceneParams, SolverConfig

# ---------------------------------------------------------------------------
# Constants (Python floats)
# ---------------------------------------------------------------------------

_O2 = tuple(float(x) for x in tf_model.JOINT_OFFSETS[1])
_O3 = tuple(float(x) for x in tf_model.JOINT_OFFSETS[2])
_TIP = tuple(float(x) for x in tf_model.TIP_OFFSET)
_MOUNT_Z = float(tf_model.MOUNT_HEIGHT)
_TIP_OFF_Z = float(tf_model.TIP_SPHERE_OFFSET[2])
_BASE_MASSES = tuple(float(m) for m in tf_model.LINK_MASSES)
_COMS = tuple(tuple(float(x) for x in c) for c in tf_model.LINK_COMS)
_INERTIAS = tuple(
    tuple(tuple(float(x) for x in row) for row in i) for i in tf_model.LINK_INERTIAS
)
_MOUNT_CS = tuple(
    (math.cos(float(y)), math.sin(float(y))) for y in tf_model.FINGER_MOUNT_YAWS
)
_CORNER_SIGNS = tuple(
    (float(sx), float(sy), float(sz))
    for sx in (-1.0, 1.0)
    for sy in (-1.0, 1.0)
    for sz in (-1.0, 1.0)
)
_MAX_CUBE_ANGVEL = 64.0

STATE_ROWS = 31
WRENCH_ROWS = 18

# (field name, length) in packing order; every entry is per-env batched
PARAM_FIELDS = (
    ("gravity", 3),
    ("link_masses", 3),
    ("joint_damping", 3),
    ("armature", 3),
    ("velocity_limit", 1),
    ("cube_mass", 1),
    ("cube_half_extents", 3),
    ("cube_inertia", 3),
    ("cube_linear_damping", 1),
    ("cube_angular_damping", 1),
    ("mu_tip_cube", 1),
    ("mu_cube_ground", 1),
    ("mu_cube_wall", 1),
    ("mu_tip_ground", 1),
    ("restitution_tip_cube", 1),
    ("restitution_cube_ground", 1),
    ("restitution_tip_ground", 1),
    ("tip_radius", 1),
    ("bounce_threshold", 1),
    ("wall_radius", 1),
    ("wall_slope", 1),
    ("wall_knee_z", 1),
    ("mu_tip_wall", 1),
    ("restitution_tip_wall", 1),
    ("mu_link_cube", 1),
    ("restitution_link_cube", 1),
    ("mu_torsion", 1),
    ("torsion_patch_radius", 1),
)
PARAM_ROWS = sum(k for _, k in PARAM_FIELDS)


# ---------------------------------------------------------------------------
# Elementwise helpers taking tensors or Python floats (jnp semantics)
# ---------------------------------------------------------------------------


def _maximum(a, b):
    if not torch.is_tensor(a):
        return torch.clamp_min(b, a)
    if not torch.is_tensor(b):
        return torch.clamp_min(a, b)
    return torch.maximum(a, b)


def _minimum(a, b):
    if not torch.is_tensor(a):
        return torch.clamp_max(b, a)
    if not torch.is_tensor(b):
        return torch.clamp_max(a, b)
    return torch.minimum(a, b)


def _clip(x, lo, hi):
    """jnp.clip: minimum(maximum(x, lo), hi)."""
    return _minimum(_maximum(x, lo), hi)


def _mount_rotate(f: int, v):
    """Apply the constant mount yaw rotation of finger f to a vec3."""
    c, s = _MOUNT_CS[f]
    return (c * v[0] - s * v[1], s * v[0] + c * v[1], v[2])


class _FingerData(NamedTuple):
    qd: tuple
    tip_w: tuple
    jw_cols: tuple
    minv_jt_cols: tuple
    a_tip: tuple
    samples: tuple


def _finger_dynamics(f: int, q9, qd9, tau9, gravity, link_mass_scale,
                     joint_damping, armature, h, with_samples: bool = True):
    """FK + mass matrix + RNEA bias + free-velocity update for finger f.

    Returns (qd_new (3-tuple), _FingerData with contact-solve quantities)."""
    q = (q9[3 * f], q9[3 * f + 1], q9[3 * f + 2])
    qd = (qd9[3 * f], qd9[3 * f + 1], qd9[3 * f + 2])
    tau = (tau9[3 * f], tau9[3 * f + 1], tau9[3 * f + 2])

    # ---- FK (finger-local frame) -----------------------------------------
    c1, s1 = torch.cos(q[0]), torch.sin(q[0])
    c2, s2 = torch.cos(q[1]), torch.sin(q[1])
    c3, s3 = torch.cos(q[2]), torch.sin(q[2])
    r1 = m3_rot_y(c1, s1)
    r2 = m3_mul(r1, m3_rot_x(c2, s2))
    r3 = m3_mul(r2, m3_rot_x(c3, s3))
    zero = torch.zeros_like(c1)
    p1 = (zero,) * 3
    p2 = m3_matvec(r1, _O2)
    p3 = v3_add(p2, m3_matvec(r2, _O3))
    tip = v3_add(p3, m3_matvec(r3, _TIP))
    joints = (p1, p2, p3)
    rots = (r1, r2, r3)
    a1 = (zero, torch.ones_like(c1), zero)
    a2 = (r1[0][0], r1[1][0], r1[2][0])
    a3 = (r2[0][0], r2[1][0], r2[2][0])
    axes = (a1, a2, a3)
    coms = tuple(
        v3_add(joints[l], m3_matvec(rots[l], _COMS[l])) for l in range(3)
    )

    masses = tuple(_BASE_MASSES[l] * link_mass_scale[l] for l in range(3))
    i_w = []
    for l in range(3):
        scaled = tuple(
            tuple(_INERTIAS[l][i][j] * link_mass_scale[l] for j in range(3))
            for i in range(3)
        )
        i_w.append(m3_mul(m3_mul(rots[l], scaled), m3_T(rots[l])))

    # ---- mass matrix (link-Jacobian assembly) ----------------------------
    jv = [[None] * 3 for _ in range(3)]
    for l in range(3):
        for i in range(l + 1):
            jv[l][i] = v3_cross(axes[i], v3_sub(coms[l], joints[i]))
    m_e = [[zero for _ in range(3)] for _ in range(3)]
    for i in range(3):
        for j in range(i, 3):
            acc = zero
            for l in range(max(i, j), 3):
                acc = acc + masses[l] * v3_dot(jv[l][i], jv[l][j])
                acc = acc + v3_dot(axes[i], m3_matvec(i_w[l], axes[j]))
            m_e[i][j] = acc
            m_e[j][i] = acc
    for i in range(3):
        m_e[i][i] = m_e[i][i] + armature[i]
    m_mat = tuple(tuple(row) for row in m_e)

    # ---- RNEA bias (qdd = 0, base acc = -g) ------------------------------
    omega_prev = (zero,) * 3
    alpha_prev = (zero,) * 3
    a_joint_prev = (-gravity[0], -gravity[1], -gravity[2])
    p_prev = p1
    omega, alpha, a_com = [], [], []
    for i in range(3):
        d = v3_sub(joints[i], p_prev)
        a_joint = v3_add(
            a_joint_prev,
            v3_add(
                v3_cross(alpha_prev, d),
                v3_cross(omega_prev, v3_cross(omega_prev, d)),
            ),
        )
        w = v3_add(omega_prev, v3_scale(axes[i], qd[i]))
        al = v3_add(alpha_prev, v3_cross(omega_prev, v3_scale(axes[i], qd[i])))
        rc = v3_sub(coms[i], joints[i])
        ac = v3_add(
            a_joint, v3_add(v3_cross(al, rc), v3_cross(w, v3_cross(w, rc)))
        )
        omega.append(w)
        alpha.append(al)
        a_com.append(ac)
        omega_prev, alpha_prev, a_joint_prev, p_prev = w, al, a_joint, joints[i]

    f_child = (zero,) * 3
    n_child = (zero,) * 3
    bias = [None, None, None]
    for i in reversed(range(3)):
        f_net = v3_scale(a_com[i], masses[i])
        n_net = v3_add(
            m3_matvec(i_w[i], alpha[i]),
            v3_cross(omega[i], m3_matvec(i_w[i], omega[i])),
        )
        f_i = v3_add(f_net, f_child)
        n_i = v3_add(
            v3_add(n_net, n_child),
            v3_cross(v3_sub(coms[i], joints[i]), f_net),
        )
        if i < 2:
            n_i = v3_add(n_i, v3_cross(v3_sub(joints[i + 1], joints[i]), f_child))
        bias[i] = v3_dot(axes[i], n_i)
        f_child, n_child = f_i, n_i

    # ---- free-velocity update --------------------------------------------
    chol = chol3_factor(m_mat)
    rhs = tuple(tau[i] - bias[i] - joint_damping[i] * qd[i] for i in range(3))
    qdd = chol3_solve_factored(chol, rhs)
    qd_new = tuple(qd[i] + h * qdd[i] for i in range(3))

    # ---- world-frame contact quantities ----------------------------------
    def point_contact_data(p_local):
        pos_w = v3_add((0.0, 0.0, _MOUNT_Z), _mount_rotate(f, p_local))
        cols = []
        for i in range(3):
            col_local = v3_cross(axes[i], v3_sub(p_local, joints[i]))
            cols.append(_mount_rotate(f, col_local))
        minv_cols = []
        for k in range(3):
            row_k = (cols[0][k], cols[1][k], cols[2][k])
            minv_cols.append(chol3_solve_factored(chol, row_k))
        a = tuple(
            tuple(
                cols[0][k] * minv_cols[mm][0]
                + cols[1][k] * minv_cols[mm][1]
                + cols[2][k] * minv_cols[mm][2]
                for mm in range(3)
            )
            for k in range(3)
        )
        return pos_w, tuple(cols), tuple(minv_cols), a

    tip_w, jw_cols, minv_jt_cols, a_tip = point_contact_data(tip)

    samples = []
    if with_samples:
        for frac, _radius in tf_model.LOWER_LINK_SAMPLES:
            p_s = v3_add(joints[2], v3_scale(v3_sub(tip, joints[2]), frac))
            samples.append(point_contact_data(p_s))

    return qd_new, _FingerData(
        qd_new, tip_w, jw_cols, minv_jt_cols, a_tip, tuple(samples)
    )


def _point_vel_cols(jw_cols, qd):
    """World velocity of an attached point = J_w qd (jacobian given by cols)."""
    return (
        jw_cols[0][0] * qd[0] + jw_cols[1][0] * qd[1] + jw_cols[2][0] * qd[2],
        jw_cols[0][1] * qd[0] + jw_cols[1][1] * qd[1] + jw_cols[2][1] * qd[2],
        jw_cols[0][2] * qd[0] + jw_cols[1][2] * qd[1] + jw_cols[2][2] * qd[2],
    )


def _apply_impulse_cols(minv_cols, qd, p, sign):
    """qd += sign * M^-1 J_w^T p for the jacobian whose M^-1 J^T cols are given."""
    return tuple(
        qd[i]
        + sign
        * (
            minv_cols[0][i] * p[0]
            + minv_cols[1][i] * p[1]
            + minv_cols[2][i] * p[2]
        )
        for i in range(3)
    )


def _tip_point_vel(fd: _FingerData, qd):
    return _point_vel_cols(fd.jw_cols, qd)


def _apply_tip_impulse(fd: _FingerData, qd, p, sign):
    return _apply_impulse_cols(fd.minv_jt_cols, qd, p, sign)


def _tangent_basis_s(n):
    """Two orthonormal tangents for unit normal n (scalar version)."""
    use_x = torch.abs(n[0]) < 0.9
    ax = torch.where(use_x, 1.0, 0.0)
    ay = torch.where(use_x, 0.0, 1.0)
    a = (ax, ay, torch.zeros_like(ax))
    t1 = v3_cross(n, a)
    inv = 1.0 / torch.sqrt(torch.clamp_min(v3_dot(t1, t1), 1e-18))
    t1 = v3_scale(t1, inv)
    t2 = v3_cross(n, t1)
    return t1, t2


def _wall_gap_s(px, py, pz, params):
    """Perpendicular gap from a point to the arena wall (positive inside) and
    the inward surface normal, for the cylinder+cone profile."""
    rho = torch.sqrt(torch.clamp_min(px * px + py * py, 1e-18))
    inv_rho = 1.0 / rho
    z_over = torch.clamp_min(pz - params.wall_knee_z, 0.0)
    s = torch.where(z_over > 0.0, params.wall_slope, 0.0)
    inv_len = 1.0 / torch.sqrt(1.0 + s * s)
    r_eff = params.wall_radius + params.wall_slope * z_over
    gap = (r_eff - rho) * inv_len
    n = (-px * inv_rho * inv_len, -py * inv_rho * inv_len, s * inv_len)
    return gap, n


def _restitution_target_s(depth, v_n0, restitution, bounce_threshold, h):
    """Restitution part of the target, gated on predicted touch within the
    substep; -inf when inactive."""
    touching = depth - v_n0 * h > 0.0
    return torch.where(
        (v_n0 < -bounce_threshold) & touching, -restitution * v_n0, -math.inf
    )


def _contact_target_s(depth, v_n0, restitution, bounce_threshold, h, cfg,
                      bias_cap=None):
    pen_bias = cfg.baumgarte / h * torch.clamp_min(depth - cfg.contact_slop, 0.0)
    if bias_cap is not None:
        pen_bias = torch.clamp_max(pen_bias, bias_cap)
    bias = torch.where(depth > 0.0, pen_bias, depth / h)
    return torch.maximum(
        bias, _restitution_target_s(depth, v_n0, restitution, bounce_threshold, h)
    )


def _substep_fields(state, tau, params, cfg: SolverConfig, h: float):
    """One substep on scalar components. ``state``/``params`` are namespaces
    of component rows (see ``rows_namespace``). Returns raw component tuples:
    (q(9), qd(9), pos(3), quat(4), v(3), w(3), tip_imp[3 of vec3],
    tip_timp[3 of vec3])."""
    g = (params.gravity[0], params.gravity[1], params.gravity[2])
    lms = tuple(params.link_masses[i] / _BASE_MASSES[i] for i in range(3))
    jd = (params.joint_damping[0], params.joint_damping[1], params.joint_damping[2])
    arm = (params.armature[0], params.armature[1], params.armature[2])

    # ---- fingers ----------------------------------------------------------
    fingers = []
    qd_f = []
    for f in range(3):
        qd_new, fd = _finger_dynamics(
            f, state.q, state.qd, tau, g, lms, jd, arm, h,
            with_samples=cfg.enable_link_cube,
        )
        fingers.append(fd)
        qd_f.append(qd_new)

    # ---- cube free velocities --------------------------------------------
    lin_damp = torch.clamp_min(1.0 - params.cube_linear_damping * h, 0.0)
    ang_damp = torch.clamp_min(1.0 - params.cube_angular_damping * h, 0.0)
    v = tuple(state.cube_linvel[i] * lin_damp for i in range(3))
    v = (v[0] + h * g[0], v[1] + h * g[1], v[2] + h * g[2])
    w = tuple(state.cube_angvel[i] * ang_damp for i in range(3))

    # ---- cube body quantities --------------------------------------------
    quat = (state.cube_quat[0], state.cube_quat[1], state.cube_quat[2],
            state.cube_quat[3])
    rot = quat_to_m3(quat)
    pos = (state.cube_pos[0], state.cube_pos[1], state.cube_pos[2])
    inv_mass = 1.0 / params.cube_mass
    inv_i = tuple(1.0 / params.cube_inertia[i] for i in range(3))
    inv_i_w = tuple(
        tuple(
            rot[i][0] * inv_i[0] * rot[j][0]
            + rot[i][1] * inv_i[1] * rot[j][1]
            + rot[i][2] * inv_i[2] * rot[j][2]
            for j in range(3)
        )
        for i in range(3)
    )
    half = (
        params.cube_half_extents[0],
        params.cube_half_extents[1],
        params.cube_half_extents[2],
    )

    def k_cube_dir(r, d):
        rxd = v3_cross(r, d)
        return inv_mass + v3_dot(rxd, m3_matvec(inv_i_w, rxd))

    def cube_point_vel(v_, w_, r):
        return v3_add(v_, v3_cross(w_, r))

    sphere_obj = cfg.object_shape == 1
    radius_o = half[0]
    if sphere_obj:
        a_points = [(pos[0], pos[1], pos[2] - radius_o)]
        b_points, b_geoms = [], []
        if cfg.enable_cube_wall:
            gap_c, n_c = _wall_gap_s(pos[0], pos[1], pos[2], params)
            b_points = [
                (
                    pos[0] - n_c[0] * radius_o,
                    pos[1] - n_c[1] * radius_o,
                    pos[2] - n_c[2] * radius_o,
                )
            ]
            b_geoms = [(radius_o - gap_c, n_c)]
    else:
        corners = []
        for sx, sy, sz in _CORNER_SIGNS:
            local = (sx * half[0], sy * half[1], sz * half[2])
            corners.append(v3_add(pos, m3_matvec(rot, local)))
        a_points = corners
        b_points, b_geoms = [], []
        if cfg.enable_cube_wall:
            b_points = corners
            for ci in range(8):
                gap, n = _wall_gap_s(
                    corners[ci][0], corners[ci][1], corners[ci][2], params
                )
                b_geoms.append((-gap, n))

    ez = (0.0, 0.0, 1.0)

    # ---- contact group A: object points vs ground -------------------------
    a_contacts = []
    a_t1 = (0.0, 1.0, 0.0)
    a_t2 = (-1.0, 0.0, 0.0)
    for pt in a_points:
        r = v3_sub(pt, pos)
        depth = -pt[2]
        vn0 = cube_point_vel(v, w, r)[2]
        target = _contact_target_s(
            depth, vn0, params.restitution_cube_ground, params.bounce_threshold, h, cfg
        )
        a_contacts.append(
            dict(r=r, target=target, depth=depth,
                 rest=_restitution_target_s(
                     depth, vn0, params.restitution_cube_ground,
                     params.bounce_threshold, h),
                 wn=k_cube_dir(r, ez), wt1=k_cube_dir(r, a_t1), wt2=k_cube_dir(r, a_t2))
        )

    # ---- group B: object points vs arena wall -----------------------------
    b_contacts = []
    for pt, (depth, n) in zip(b_points, b_geoms):
        r = v3_sub(pt, pos)
        t1, t2 = _tangent_basis_s(n)
        u = cube_point_vel(v, w, r)
        target = _contact_target_s(
            depth, v3_dot(u, n), 0.0, params.bounce_threshold, h, cfg
        )
        b_contacts.append(
            dict(r=r, n=n, t1=t1, t2=t2, target=target, depth=depth,
                 rest=_restitution_target_s(
                     depth, v3_dot(u, n), 0.0, params.bounce_threshold, h),
                 wn=k_cube_dir(r, n), wt1=k_cube_dir(r, t1), wt2=k_cube_dir(r, t2))
        )

    # ---- probe-vs-object closest-point helper (groups C and F) ------------
    def sphere_vs_cube(center):
        """(r, n_w, t1, t2, point, sdist) of the object point closest to
        ``center``; +n pushes the object away from the probe sphere."""
        if sphere_obj:
            delta = v3_sub(center, pos)
            d2 = v3_dot(delta, delta)
            dist = torch.sqrt(torch.clamp_min(d2, 1e-18))
            inv_dist = 1.0 / dist
            deg = d2 > 1e-16
            dir_out = (
                torch.where(deg, delta[0] * inv_dist, 0.0),
                torch.where(deg, delta[1] * inv_dist, 0.0),
                torch.where(deg, delta[2] * inv_dist, 1.0),
            )
            sdist = dist - radius_o
            point = v3_add(pos, v3_scale(dir_out, radius_o))
            n_w = v3_scale(dir_out, -1.0)
            r = v3_sub(point, pos)
            t1, t2 = _tangent_basis_s(n_w)
            return r, n_w, t1, t2, point, sdist
        local = m3_matvec(m3_T(rot), v3_sub(center, pos))
        clamped = tuple(_clip(local[i], -half[i], half[i]) for i in range(3))
        delta = v3_sub(local, clamped)
        # the outside test compares the squared distance (never through sqrt)
        dist_sq = v3_dot(delta, delta)
        outside = dist_sq > 1e-16
        dist = torch.sqrt(torch.clamp_min(dist_sq, 1e-18))
        inv_dist = 1.0 / dist
        n_out = v3_scale(delta, inv_dist)
        # inside: push out through nearest face
        gaps = tuple(half[i] - torch.abs(local[i]) for i in range(3))
        min01 = torch.minimum(gaps[0], gaps[1])
        axis0 = gaps[0] <= gaps[1]
        axis_is_2 = gaps[2] < min01
        sgn = tuple(torch.sign(local[i] + 1e-12) for i in range(3))
        n_in = (
            torch.where(axis_is_2, 0.0, torch.where(axis0, sgn[0], 0.0)),
            torch.where(axis_is_2, 0.0, torch.where(axis0, 0.0, sgn[1])),
            torch.where(axis_is_2, sgn[2], 0.0),
        )
        inside_dist = -torch.where(axis_is_2, gaps[2], torch.minimum(gaps[0], gaps[1]))
        n_local = tuple(torch.where(outside, n_out[i], n_in[i]) for i in range(3))
        sdist = torch.where(outside, dist, inside_dist)
        gap_sel = torch.where(axis_is_2, gaps[2], min01)
        surf_local = tuple(
            torch.where(outside, clamped[i], local[i] + n_in[i] * gap_sel)
            for i in range(3)
        )
        n_w = v3_scale(m3_matvec(rot, n_local), -1.0)
        point = v3_add(pos, m3_matvec(rot, surf_local))
        r = v3_sub(point, pos)
        t1, t2 = _tangent_basis_s(n_w)
        return r, n_w, t1, t2, point, sdist

    # ---- group C: tip spheres vs cube -------------------------------------
    c_contacts = []
    for f in range(3):
        center = v3_add(fingers[f].tip_w, (0.0, 0.0, _TIP_OFF_Z))
        r, n_w, t1, t2, point, sdist = sphere_vs_cube(center)
        depth = params.tip_radius - sdist
        u = v3_sub(cube_point_vel(v, w, r), _tip_point_vel(fingers[f], qd_f[f]))
        target = _contact_target_s(
            depth, v3_dot(u, n_w), params.restitution_tip_cube,
            params.bounce_threshold, h, cfg,
        )

        def w_pair(d, r=r, f=f):
            at = fingers[f].a_tip
            return k_cube_dir(r, d) + v3_dot(d, m3_matvec(at, d))

        c_contacts.append(
            dict(r=r, n=n_w, t1=t1, t2=t2, target=target, point=point,
                 depth=depth,
                 rest=_restitution_target_s(
                     depth, v3_dot(u, n_w), params.restitution_tip_cube,
                     params.bounce_threshold, h),
                 wn=w_pair(n_w), wt1=w_pair(t1), wt2=w_pair(t2))
        )

    # ---- group F: lower-link shaft samples vs cube ------------------------
    f_contacts = []  # flat list, index f * S + s
    _S = len(tf_model.LOWER_LINK_SAMPLES)
    for f in range(3 if cfg.enable_link_cube else 0):
        for s_idx, (_frac, radius) in enumerate(tf_model.LOWER_LINK_SAMPLES):
            pos_w, cols, minv_cols, a_pt = fingers[f].samples[s_idx]
            r, n_w, t1, t2, point, sdist = sphere_vs_cube(pos_w)
            depth = radius - sdist
            u = v3_sub(cube_point_vel(v, w, r), _point_vel_cols(cols, qd_f[f]))
            target = _contact_target_s(
                depth, v3_dot(u, n_w), params.restitution_link_cube,
                params.bounce_threshold, h, cfg,
            )

            def w_pair_s(d, r=r, a_pt=a_pt):
                return k_cube_dir(r, d) + v3_dot(d, m3_matvec(a_pt, d))

            f_contacts.append(
                dict(r=r, n=n_w, t1=t1, t2=t2, target=target, depth=depth,
                     rest=_restitution_target_s(
                         depth, v3_dot(u, n_w), params.restitution_link_cube,
                         params.bounce_threshold, h),
                     cols=cols, minv_cols=minv_cols,
                     wn=w_pair_s(n_w), wt1=w_pair_s(t1), wt2=w_pair_s(t2))
            )

    # ---- group D: tip spheres vs ground -----------------------------------
    d_contacts = []
    for f in range(3 if cfg.enable_tip_ground else 0):
        center = v3_add(fingers[f].tip_w, (0.0, 0.0, _TIP_OFF_Z))
        depth = params.tip_radius - center[2]
        u = _tip_point_vel(fingers[f], qd_f[f])
        target = _contact_target_s(
            depth, u[2], params.restitution_tip_ground, params.bounce_threshold,
            h, cfg, bias_cap=cfg.finger_bias_cap,
        )
        at = fingers[f].a_tip
        # finger-only contact: J M^-1 J^T can be singular (see cfg.w_min)
        d_contacts.append(
            dict(target=target, depth=depth,
                 rest=_restitution_target_s(
                     depth, u[2], params.restitution_tip_ground,
                     params.bounce_threshold, h),
                 wn=torch.clamp_min(at[2][2], cfg.w_min),
                 wt1=torch.clamp_min(at[0][0], cfg.w_min),
                 wt2=torch.clamp_min(at[1][1], cfg.w_min))
        )

    # ---- group E: tip spheres vs arena wall -------------------------------
    e_contacts = []
    for f in range(3 if cfg.enable_tip_wall else 0):
        center = v3_add(fingers[f].tip_w, (0.0, 0.0, _TIP_OFF_Z))
        gap, n = _wall_gap_s(center[0], center[1], center[2], params)
        depth = params.tip_radius - gap
        t1, t2 = _tangent_basis_s(n)
        u = _tip_point_vel(fingers[f], qd_f[f])
        target = _contact_target_s(
            depth, v3_dot(u, n), params.restitution_tip_wall,
            params.bounce_threshold, h, cfg, bias_cap=cfg.finger_bias_cap,
        )
        at = fingers[f].a_tip

        def w_dir(d, at=at):
            return torch.clamp_min(v3_dot(d, m3_matvec(at, d)), cfg.w_min)

        e_contacts.append(
            dict(n=n, t1=t1, t2=t2, target=target, center=center, depth=depth,
                 rest=_restitution_target_s(
                     depth, v3_dot(u, n), params.restitution_tip_wall,
                     params.bounce_threshold, h),
                 wn=w_dir(n), wt1=w_dir(t1), wt2=w_dir(t2))
        )

    # ---- torsional friction spin masses at cube contacts ------------------
    def k_spin(n):
        return torch.clamp_min(v3_dot(n, m3_matvec(inv_i_w, n)), 1e-6)

    torsion = cfg.enable_torsion
    a_ws = inv_i_w[2][2]
    b_ws = [k_spin(ct["n"]) for ct in b_contacts] if torsion else []
    c_ws = [k_spin(ct["n"]) for ct in c_contacts] if torsion else []
    mu_tor_r = params.mu_torsion * params.torsion_patch_radius

    # ---- PGS sweeps --------------------------------------------------------
    def normal_step(u_n, target, w_n, lam):
        new_lam = torch.clamp_min(lam + (target - u_n) / w_n, 0.0)
        return new_lam - lam, new_lam

    def friction_step(u_t, w_t, lam_t, mu_lam):
        new_lam = _clip(lam_t - u_t / w_t, -mu_lam, mu_lam)
        return new_lam - lam_t, new_lam

    def cube_apply(v, w, r, p):
        v = (v[0] + inv_mass * p[0], v[1] + inv_mass * p[1], v[2] + inv_mass * p[2])
        rxp = v3_cross(r, p)
        w = v3_add(w, m3_matvec(inv_i_w, rxp))
        return v, w

    z = torch.zeros_like(pos[0])

    def spin_apply(w, n, d_lam):
        return v3_add(w, m3_matvec(inv_i_w, v3_scale(n, d_lam)))

    # ---- TGS mode (solver_type 1) ------------------------------------------
    tgs = cfg.solver_type == 1
    h_it = h / cfg.solver_iterations

    def tgs_target(d, rest, it, bias_cap=None):
        pen = cfg.tgs_bias / h_it * torch.clamp_min(d - cfg.contact_slop, 0.0)
        if bias_cap is not None:
            pen = torch.clamp_max(pen, bias_cap)
        # speculative approach budget = remaining time; computed in the
        # working dtype, as the reference's traced loop index does
        it_t = torch.full((), float(it), dtype=d.dtype, device=d.device)
        h_rem = h - it_t * h_it
        bias = torch.where(d > 0.0, pen, d / h_rem)
        return torch.maximum(bias, rest)

    def sweep(it, carry):
        if tgs:
            v, w, qd0, qd1, qd2, lam, dep, poses = carry
            (a_d, b_d, c_d, d_d, e_d, f_d) = [list(x) for x in dep]
        else:
            v, w, qd0, qd1, qd2, lam = carry
        qds = [qd0, qd1, qd2]
        (a_ln, a_l1, a_l2, a_lt, b_ln, b_l1, b_l2, b_lt,
         c_ln, c_l1, c_l2, c_lt, d_ln, d_l1, d_l2,
         e_ln, e_l1, e_l2, f_ln, f_l1, f_l2) = [list(x) for x in lam]

        for i, ct in enumerate(a_contacts):
            r = ct["r"]
            u = cube_point_vel(v, w, r)
            tgt = tgs_target(a_d[i], ct["rest"], it) if tgs else ct["target"]
            d_lam, a_ln[i] = normal_step(u[2], tgt, ct["wn"], a_ln[i])
            v, w = cube_apply(v, w, r, (z, z, d_lam))
            mu_l = params.mu_cube_ground * a_ln[i]
            u = cube_point_vel(v, w, r)
            if tgs:
                a_d[i] = a_d[i] - u[2] * h_it
            d_lam, a_l1[i] = friction_step(u[1], ct["wt1"], a_l1[i], mu_l)
            v, w = cube_apply(v, w, r, (z, d_lam, z))
            u = cube_point_vel(v, w, r)
            d_lam, a_l2[i] = friction_step(-u[0], ct["wt2"], a_l2[i], mu_l)
            v, w = cube_apply(v, w, r, (-d_lam, z, z))
            if torsion:
                d_lam, a_lt[i] = friction_step(
                    w[2], a_ws, a_lt[i], mu_tor_r * a_ln[i]
                )
                w = spin_apply(w, (z + 0.0, z + 0.0, z + 1.0), d_lam)

        for i, ct in enumerate(b_contacts):
            r, n = ct["r"], ct["n"]
            u = cube_point_vel(v, w, r)
            tgt = tgs_target(b_d[i], ct["rest"], it) if tgs else ct["target"]
            d_lam, b_ln[i] = normal_step(v3_dot(u, n), tgt, ct["wn"], b_ln[i])
            v, w = cube_apply(v, w, r, v3_scale(n, d_lam))
            mu_l = params.mu_cube_wall * b_ln[i]
            u = cube_point_vel(v, w, r)
            if tgs:
                b_d[i] = b_d[i] - v3_dot(u, n) * h_it
            d_lam, b_l1[i] = friction_step(v3_dot(u, ct["t1"]), ct["wt1"], b_l1[i], mu_l)
            v, w = cube_apply(v, w, r, v3_scale(ct["t1"], d_lam))
            u = cube_point_vel(v, w, r)
            d_lam, b_l2[i] = friction_step(v3_dot(u, ct["t2"]), ct["wt2"], b_l2[i], mu_l)
            v, w = cube_apply(v, w, r, v3_scale(ct["t2"], d_lam))
            if torsion:
                d_lam, b_lt[i] = friction_step(
                    v3_dot(w, n), b_ws[i], b_lt[i], mu_tor_r * b_ln[i]
                )
                w = spin_apply(w, n, d_lam)

        for f, ct in enumerate(c_contacts):
            r, n = ct["r"], ct["n"]
            u = v3_sub(cube_point_vel(v, w, r), _tip_point_vel(fingers[f], qds[f]))
            tgt = tgs_target(c_d[f], ct["rest"], it) if tgs else ct["target"]
            d_lam, c_ln[f] = normal_step(v3_dot(u, n), tgt, ct["wn"], c_ln[f])
            p = v3_scale(n, d_lam)
            v, w = cube_apply(v, w, r, p)
            qds[f] = _apply_tip_impulse(fingers[f], qds[f], p, -1.0)
            if tgs:
                u = v3_sub(
                    cube_point_vel(v, w, r), _tip_point_vel(fingers[f], qds[f])
                )
                c_d[f] = c_d[f] - v3_dot(u, n) * h_it
            mu_l = params.mu_tip_cube * c_ln[f]
            for which in (0, 1):
                t_vec = ct["t1"] if which == 0 else ct["t2"]
                w_t = ct["wt1"] if which == 0 else ct["wt2"]
                lam_prev = c_l1[f] if which == 0 else c_l2[f]
                u = v3_sub(cube_point_vel(v, w, r), _tip_point_vel(fingers[f], qds[f]))
                d_lam, new_lam = friction_step(v3_dot(u, t_vec), w_t, lam_prev, mu_l)
                if which == 0:
                    c_l1[f] = new_lam
                else:
                    c_l2[f] = new_lam
                p = v3_scale(t_vec, d_lam)
                v, w = cube_apply(v, w, r, p)
                qds[f] = _apply_tip_impulse(fingers[f], qds[f], p, -1.0)
            if torsion:
                d_lam, c_lt[f] = friction_step(
                    v3_dot(w, n), c_ws[f], c_lt[f], mu_tor_r * c_ln[f]
                )
                w = spin_apply(w, n, d_lam)

        for idx, ct in enumerate(f_contacts):
            f = idx // _S
            r, n = ct["r"], ct["n"]
            u = v3_sub(cube_point_vel(v, w, r), _point_vel_cols(ct["cols"], qds[f]))
            tgt = tgs_target(f_d[idx], ct["rest"], it) if tgs else ct["target"]
            d_lam, f_ln[idx] = normal_step(v3_dot(u, n), tgt, ct["wn"], f_ln[idx])
            p = v3_scale(n, d_lam)
            v, w = cube_apply(v, w, r, p)
            qds[f] = _apply_impulse_cols(ct["minv_cols"], qds[f], p, -1.0)
            if tgs:
                u = v3_sub(
                    cube_point_vel(v, w, r), _point_vel_cols(ct["cols"], qds[f])
                )
                f_d[idx] = f_d[idx] - v3_dot(u, n) * h_it
            mu_l = params.mu_link_cube * f_ln[idx]
            for which in (0, 1):
                t_vec = ct["t1"] if which == 0 else ct["t2"]
                w_t = ct["wt1"] if which == 0 else ct["wt2"]
                lam_prev = f_l1[idx] if which == 0 else f_l2[idx]
                u = v3_sub(cube_point_vel(v, w, r), _point_vel_cols(ct["cols"], qds[f]))
                d_lam, new_lam = friction_step(v3_dot(u, t_vec), w_t, lam_prev, mu_l)
                if which == 0:
                    f_l1[idx] = new_lam
                else:
                    f_l2[idx] = new_lam
                p = v3_scale(t_vec, d_lam)
                v, w = cube_apply(v, w, r, p)
                qds[f] = _apply_impulse_cols(ct["minv_cols"], qds[f], p, -1.0)

        for f, ct in enumerate(d_contacts):
            u = _tip_point_vel(fingers[f], qds[f])
            tgt = (tgs_target(d_d[f], ct["rest"], it, bias_cap=cfg.finger_bias_cap)
                   if tgs else ct["target"])
            d_lam, d_ln[f] = normal_step(u[2], tgt, ct["wn"], d_ln[f])
            qds[f] = _apply_tip_impulse(fingers[f], qds[f], (z, z, d_lam), 1.0)
            mu_l = params.mu_tip_ground * d_ln[f]
            u = _tip_point_vel(fingers[f], qds[f])
            if tgs:
                d_d[f] = d_d[f] - u[2] * h_it
            d_lam, d_l1[f] = friction_step(u[0], ct["wt1"], d_l1[f], mu_l)
            qds[f] = _apply_tip_impulse(fingers[f], qds[f], (d_lam, z, z), 1.0)
            u = _tip_point_vel(fingers[f], qds[f])
            d_lam, d_l2[f] = friction_step(u[1], ct["wt2"], d_l2[f], mu_l)
            qds[f] = _apply_tip_impulse(fingers[f], qds[f], (z, d_lam, z), 1.0)

        for f, ct in enumerate(e_contacts):
            n = ct["n"]
            u = _tip_point_vel(fingers[f], qds[f])
            tgt = (tgs_target(e_d[f], ct["rest"], it, bias_cap=cfg.finger_bias_cap)
                   if tgs else ct["target"])
            d_lam, e_ln[f] = normal_step(v3_dot(u, n), tgt, ct["wn"], e_ln[f])
            qds[f] = _apply_tip_impulse(fingers[f], qds[f], v3_scale(n, d_lam), 1.0)
            if tgs:
                u = _tip_point_vel(fingers[f], qds[f])
                e_d[f] = e_d[f] - v3_dot(u, n) * h_it
            mu_l = params.mu_tip_wall * e_ln[f]
            for which in (0, 1):
                t_vec = ct["t1"] if which == 0 else ct["t2"]
                w_t = ct["wt1"] if which == 0 else ct["wt2"]
                lam_prev = e_l1[f] if which == 0 else e_l2[f]
                u = _tip_point_vel(fingers[f], qds[f])
                d_lam, new_lam = friction_step(v3_dot(u, t_vec), w_t, lam_prev, mu_l)
                if which == 0:
                    e_l1[f] = new_lam
                else:
                    e_l2[f] = new_lam
                qds[f] = _apply_tip_impulse(fingers[f], qds[f], v3_scale(t_vec, d_lam), 1.0)

        lam = (tuple(a_ln), tuple(a_l1), tuple(a_l2), tuple(a_lt),
               tuple(b_ln), tuple(b_l1), tuple(b_l2), tuple(b_lt),
               tuple(c_ln), tuple(c_l1), tuple(c_l2), tuple(c_lt),
               tuple(d_ln), tuple(d_l1), tuple(d_l2),
               tuple(e_ln), tuple(e_l1), tuple(e_l2),
               tuple(f_ln), tuple(f_l1), tuple(f_l2))
        if tgs:
            dep = (tuple(a_d), tuple(b_d), tuple(c_d),
                   tuple(d_d), tuple(e_d), tuple(f_d))
            # mini-step pose integration; contact frames stay frozen at
            # substep start while depths integrate alongside
            p_pos, p_quat, p_q = poses
            p_pos = tuple(p_pos[i] + h_it * v[i] for i in range(3))
            p_quat = quat_integrate4(p_quat, w, h_it)
            p_q = tuple(
                p_q[3 * f + j] + h_it * qds[f][j]
                for f in range(3) for j in range(3)
            )
            return (v, w, qds[0], qds[1], qds[2], lam, dep,
                    (p_pos, p_quat, p_q))
        return v, w, qds[0], qds[1], qds[2], lam

    za = tuple(z for _ in range(len(a_contacts)))
    zb = tuple(z for _ in range(len(b_contacts)))
    zc = tuple(z for _ in range(len(c_contacts)))
    zd = tuple(z for _ in range(len(d_contacts)))
    ze = tuple(z for _ in range(len(e_contacts)))
    zf = tuple(z for _ in range(len(f_contacts)))
    lam0 = (za, za, za, za, zb, zb, zb, zb,
            zc, zc, zc, zc, zd, zd, zd,
            ze, ze, ze, zf, zf, zf)
    if tgs:
        dep0 = (tuple(ct["depth"] + z for ct in a_contacts),
                tuple(ct["depth"] + z for ct in b_contacts),
                tuple(ct["depth"] + z for ct in c_contacts),
                tuple(ct["depth"] + z for ct in d_contacts),
                tuple(ct["depth"] + z for ct in e_contacts),
                tuple(ct["depth"] + z for ct in f_contacts))
        poses0 = (pos, quat, tuple(state.q[i] + z for i in range(9)))
        carry = (v, w, qd_f[0], qd_f[1], qd_f[2], lam0, dep0, poses0)
        for it in range(cfg.solver_iterations):
            carry = sweep(it, carry)
        v, w, qd0, qd1, qd2, lam, _, tgs_poses = carry
    else:
        carry = (v, w, qd_f[0], qd_f[1], qd_f[2], lam0)
        for it in range(cfg.solver_iterations):
            carry = sweep(it, carry)
        v, w, qd0, qd1, qd2, lam = carry
    qd_f = [qd0, qd1, qd2]

    # ---- fingertip contact impulses (wrench sensing) ----------------------
    (_, _, _, _, _, _, _, _, c_ln, c_l1, c_l2, _, d_ln, d_l1, d_l2,
     e_ln, e_l1, e_l2, _, _, _) = lam
    tip_imp = []
    tip_timp = []
    zv = (z, z, z)
    for f in range(3):
        ct = c_contacts[f]
        imp_c = v3_scale(
            v3_add(
                v3_add(v3_scale(ct["n"], c_ln[f]), v3_scale(ct["t1"], c_l1[f])),
                v3_scale(ct["t2"], c_l2[f]),
            ),
            -1.0,
        )
        center = v3_add(fingers[f].tip_w, (0.0, 0.0, _TIP_OFF_Z))
        arm_c = v3_sub(ct["point"], fingers[f].tip_w)
        imp = imp_c
        timp = v3_cross(arm_c, imp_c)
        if cfg.enable_tip_ground:
            imp_d = (d_l1[f], d_l2[f], d_ln[f])
            arm_d = v3_sub(
                (center[0], center[1], center[2] - params.tip_radius),
                fingers[f].tip_w,
            )
            imp = v3_add(imp, imp_d)
            timp = v3_add(timp, v3_cross(arm_d, imp_d))
        if cfg.enable_tip_wall:
            et = e_contacts[f]
            imp_e = v3_add(
                v3_add(v3_scale(et["n"], e_ln[f]), v3_scale(et["t1"], e_l1[f])),
                v3_scale(et["t2"], e_l2[f]),
            )
            arm_e = v3_sub(
                v3_sub(center, v3_scale(et["n"], params.tip_radius)),
                fingers[f].tip_w,
            )
            imp = v3_add(imp, imp_e)
            timp = v3_add(timp, v3_cross(arm_e, imp_e))
        imp = v3_add(imp, zv)
        timp = v3_add(timp, zv)
        tip_imp.append(imp)
        tip_timp.append(timp)

    # ---- integrate positions + joint limits -------------------------------
    jlow = tuple(float(x) for x in cfg.joint_limit_lower)
    jhigh = tuple(float(x) for x in cfg.joint_limit_upper)
    q_new, qd_out = [], []
    for f in range(3):
        for j in range(3):
            gi = 3 * f + j
            qv = (tgs_poses[2][gi] if tgs
                  else state.q[gi] + h * qd_f[f][j])
            qc = _clip(qv, jlow[gi], jhigh[gi])
            qdv = qd_f[f][j]
            at_lower = (qv <= jlow[gi]) & (qdv < 0.0)
            at_upper = (qv >= jhigh[gi]) & (qdv > 0.0)
            qdv = torch.where(at_lower | at_upper, 0.0, qdv)
            qdv = _clip(qdv, -params.velocity_limit, params.velocity_limit)
            q_new.append(qc)
            qd_out.append(qdv)

    w_norm = torch.sqrt(torch.clamp_min(v3_dot(w, w), 1e-18))
    w_scale = torch.where(w_norm > _MAX_CUBE_ANGVEL, _MAX_CUBE_ANGVEL / w_norm, 1.0)
    w = v3_scale(w, w_scale)

    if tgs:
        new_pos, new_quat = tgs_poses[0], tgs_poses[1]
    else:
        new_quat = quat_integrate4(quat, w, h)
        new_pos = tuple(pos[i] + h * v[i] for i in range(3))
    return (tuple(q_new), tuple(qd_out), new_pos, new_quat, tuple(v), tuple(w),
            tip_imp, tip_timp)


# ---------------------------------------------------------------------------
# Packing: the component-major (C, N) layout shared with the CUDA kernel
# ---------------------------------------------------------------------------


def pack_state(ps: PhysicsState) -> torch.Tensor:
    """(N,)-batched PhysicsState -> contiguous (31, N)."""
    return torch.cat(
        [ps.q.T, ps.qd.T, ps.cube_pos.T, ps.cube_quat.T,
         ps.cube_linvel.T, ps.cube_angvel.T], dim=0
    ).contiguous()


def unpack_state(arr: torch.Tensor) -> PhysicsState:
    return PhysicsState(
        q=arr[0:9].T, qd=arr[9:18].T, cube_pos=arr[18:21].T,
        cube_quat=arr[21:25].T, cube_linvel=arr[25:28].T, cube_angvel=arr[28:31].T,
    )


def pack_params(sp: SceneParams, n: int) -> torch.Tensor:
    """(N,)-batched (or unbatched, broadcast) SceneParams -> (40, N)."""
    rows = []
    for name, k in PARAM_FIELDS:
        leaf = getattr(sp, name)
        if k == 1:
            rows.append(leaf.expand(n)[None, :])
        else:
            if leaf.dim() == 1:
                leaf = leaf.expand(n, k)
            rows.append(leaf.T)
    return torch.cat(rows, dim=0).contiguous()


def rows_namespace(state31, params40):
    """Component-row views of packed state and params, as the substep reads
    them: ``state.q`` is a 9-tuple of (N,) rows, ``params.cube_mass`` a row."""
    rows = [state31[i] for i in range(STATE_ROWS)]
    state = SimpleNamespace(
        q=tuple(rows[0:9]), qd=tuple(rows[9:18]), cube_pos=tuple(rows[18:21]),
        cube_quat=tuple(rows[21:25]), cube_linvel=tuple(rows[25:28]),
        cube_angvel=tuple(rows[28:31]),
    )
    fields = {}
    off = 0
    for name, k in PARAM_FIELDS:
        fields[name] = (tuple(params40[off + i] for i in range(k)) if k > 1
                        else params40[off])
        off += k
    return state, SimpleNamespace(**fields)


def step_packed(state31: torch.Tensor, params40: torch.Tensor, tau9: torch.Tensor,
                cfg: SolverConfig, dt: float):
    """One control step on the packed layout: ``cfg.substeps`` substeps of
    h = dt / substeps. Returns (state' (31, N), impulse sums (18, N):
    force impulses of fingers 0-2, then torque impulses of fingers 0-2)."""
    h = dt / cfg.substeps
    state, params = rows_namespace(state31, params40)
    tau = tuple(tau9[i] for i in range(9))
    acc = [torch.zeros_like(state31[0]) for _ in range(WRENCH_ROWS)]
    for _ in range(cfg.substeps):
        q, qd, pos, quat, v, w, tip_imp, tip_timp = _substep_fields(
            state, tau, params, cfg, h
        )
        flat = ([tip_imp[f][i] for f in range(3) for i in range(3)]
                + [tip_timp[f][i] for f in range(3) for i in range(3)])
        acc = [acc[j] + flat[j] for j in range(WRENCH_ROWS)]
        state = SimpleNamespace(q=q, qd=qd, cube_pos=pos, cube_quat=quat,
                                cube_linvel=v, cube_angvel=w)
    out = torch.stack(
        list(state.q) + list(state.qd) + list(state.cube_pos)
        + list(state.cube_quat) + list(state.cube_linvel) + list(state.cube_angvel)
    )
    return out, torch.stack(acc)


def wrench_from_impulses(imp18: torch.Tensor, dt: float) -> torch.Tensor:
    """(18, N) impulse sums -> (N, 3, 6) tip wrench [force3 torque3] / dt."""
    return torch.stack(
        [
            torch.stack([imp18[3 * f + i] for i in range(3)]
                        + [imp18[9 + 3 * f + i] for i in range(3)], dim=-1)
            for f in range(3)
        ],
        dim=1,
    ) / dt


def physics_step_v2(state: PhysicsState, tau: torch.Tensor, params: SceneParams,
                    cfg: SolverConfig, dt: float = 0.02):
    """Batched physics step: state (N,)-batched, tau (N, 9), params batched
    or broadcastable. Returns (new_state, tip_wrench (N, 3, 6))."""
    n = state.q.shape[0]
    out, imp = step_packed(
        pack_state(state), pack_params(params, n), tau.T.contiguous(), cfg, dt
    )
    return unpack_state(out), wrench_from_impulses(imp, dt)


# ---------------------------------------------------------------------------
# Fingertip kinematics (the env's observation path)
# ---------------------------------------------------------------------------


def _quat_from_m3(m):
    """Branch-free Shepperd selection, scalar components."""
    m00, m01, m02 = m[0]
    m10, m11, m12 = m[1]
    m20, m21, m22 = m[2]
    trace = m00 + m11 + m22

    def sq(x):
        return torch.sqrt(torch.clamp_min(x, 1e-12))

    qw0 = sq(1.0 + trace) * 0.5
    s0 = 0.25 / qw0
    c0 = ((m21 - m12) * s0, (m02 - m20) * s0, (m10 - m01) * s0, qw0)
    qx1 = sq(1.0 + m00 - m11 - m22) * 0.5
    s1 = 0.25 / qx1
    c1 = (qx1, (m01 + m10) * s1, (m02 + m20) * s1, (m21 - m12) * s1)
    qy2 = sq(1.0 - m00 + m11 - m22) * 0.5
    s2 = 0.25 / qy2
    c2 = ((m01 + m10) * s2, qy2, (m12 + m21) * s2, (m02 - m20) * s2)
    qz3 = sq(1.0 - m00 - m11 + m22) * 0.5
    s3 = 0.25 / qz3
    c3 = ((m02 + m20) * s3, (m12 + m21) * s3, qz3, (m10 - m01) * s3)

    cond0 = trace > 0.0
    cond1 = (m00 > m11) & (m00 > m22)
    cond2 = m11 > m22
    q = tuple(
        torch.where(cond0, c0[i],
                    torch.where(cond1, c1[i], torch.where(cond2, c2[i], c3[i])))
        for i in range(4)
    )
    return quat_normalize4(q)


def fingertip_components_v2(q_cols, qd_cols):
    """Fingertip state components via the scalar FK path.

    ``q_cols``/``qd_cols``: 9-tuples of (N,) columns. Returns a 3-tuple (one
    per finger) of (pos3, quat4, linvel3, angvel3) component tuples."""
    out = []
    for f in range(3):
        q = (q_cols[3 * f], q_cols[3 * f + 1], q_cols[3 * f + 2])
        qd = (qd_cols[3 * f], qd_cols[3 * f + 1], qd_cols[3 * f + 2])
        c1, s1 = torch.cos(q[0]), torch.sin(q[0])
        c2, s2 = torch.cos(q[1]), torch.sin(q[1])
        c3, s3 = torch.cos(q[2]), torch.sin(q[2])
        r1 = m3_rot_y(c1, s1)
        r2 = m3_mul(r1, m3_rot_x(c2, s2))
        r3 = m3_mul(r2, m3_rot_x(c3, s3))
        p2 = m3_matvec(r1, _O2)
        p3 = v3_add(p2, m3_matvec(r2, _O3))
        tip = v3_add(p3, m3_matvec(r3, _TIP))
        zero = torch.zeros_like(c1)
        a1 = (zero, torch.ones_like(c1), zero)
        a2 = (r1[0][0], r1[1][0], r1[2][0])
        a3 = (r2[0][0], r2[1][0], r2[2][0])
        joints = ((zero, zero, zero), p2, p3)
        axes = (a1, a2, a3)
        lin = (zero, zero, zero)
        ang = (zero, zero, zero)
        for i in range(3):
            col = v3_cross(axes[i], v3_sub(tip, joints[i]))
            lin = v3_add(lin, v3_scale(col, qd[i]))
            ang = v3_add(ang, v3_scale(axes[i], qd[i]))
        tip_w = v3_add((0.0, 0.0, _MOUNT_Z), _mount_rotate(f, tip))
        lin_w = _mount_rotate(f, lin)
        ang_w = _mount_rotate(f, ang)
        c, s = _MOUNT_CS[f]
        mount = ((c, -s, 0.0), (s, c, 0.0), (0.0, 0.0, 1.0))
        rot_w = m3_mul(mount, r3)
        quat_w = _quat_from_m3(rot_w)
        out.append((tip_w, quat_w, lin_w, ang_w))
    return tuple(out)

