"""Collision queries and the clamped impulse updates of the contact solver
(counterpart of ``leibnizgym_tpu/ops/contact.py``).

The scene has a fixed contact graph (object points x ground and arena wall,
tip spheres x object, ground and wall, lower-link samples x object), so
every query is branch-free: inactive contacts fall out of the impulse
clamping. The reference writes these for one env and vmaps them; here every
function takes leading batch dims (``...``) on every tensor argument, so
``ops/engine.py`` calls them on whole (N,) or (N, slots) batches.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from leibnizgym_tpu_torch.ops.dynamics import _cross
from leibnizgym_tpu_torch.ops.kinematics import const
from leibnizgym_tpu_torch.ops.types import SolverConfig
from leibnizgym_tpu_torch.utils.math import quat_to_matrix, saturate

# the 8 corner sign combinations of a box
_CORNER_SIGNS = np.array(
    [[sx, sy, sz] for sx in (-1.0, 1.0) for sy in (-1.0, 1.0) for sz in (-1.0, 1.0)]
)


def _tangent_basis(n: torch.Tensor):
    """Two orthonormal tangents (..., 3) for unit normals ``n`` (..., 3)."""
    # the axis least aligned with n
    ex, ey = const([1.0, 0.0, 0.0], n), const([0.0, 1.0, 0.0], n)
    a = torch.where((torch.abs(n[..., 0]) < 0.9)[..., None], ex, ey)
    t1 = _cross(n, a)
    t1 = t1 / torch.clamp_min(torch.linalg.vector_norm(t1, dim=-1, keepdim=True), 1e-9)
    t2 = _cross(n, t1)
    return t1, t2


class CubeBody(NamedTuple):
    """Object quantities the solver needs, per env."""

    pos: torch.Tensor  # (..., 3)
    rot: torch.Tensor  # (..., 3, 3)
    inv_mass: torch.Tensor  # (...,)
    inv_inertia_w: torch.Tensor  # (..., 3, 3) world-frame inverse inertia


def cube_body(pos, quat, mass, inertia_diag) -> CubeBody:
    rot = quat_to_matrix(quat)
    inv_i_body = torch.diag_embed(1.0 / inertia_diag)
    return CubeBody(pos=pos, rot=rot, inv_mass=1.0 / mass,
                    inv_inertia_w=rot @ inv_i_body @ rot.transpose(-1, -2))


def closest_point_on_box(center_local: torch.Tensor, half: torch.Tensor):
    """Sphere center vs box in box-local coordinates, (..., 3) each.

    Returns (normal_local (..., 3) from the box surface toward the center,
    signed distance (...,) of the center to the surface, negative inside,
    surface point (..., 3)). A center inside pushes out through the nearest
    face; the outside test is sqrt-free, so a center on the surface gets a
    face normal, never a zero one."""
    half = half.expand_as(center_local)
    clamped = saturate(center_local, -half, half)
    delta = center_local - clamped
    dist_sq = (delta * delta).sum(-1)
    outside = dist_sq > 1e-16
    dist = torch.sqrt(torch.clamp_min(dist_sq, 1e-18))
    n_out = delta / dist[..., None]

    face_gap = half - torch.abs(center_local)  # >= 0 inside
    axis = torch.argmin(face_gap, dim=-1, keepdim=True)
    sign = torch.sign(torch.gather(center_local, -1, axis) + 1e-12)
    n_in = torch.zeros_like(center_local).scatter(-1, axis, sign)
    gap_axis = torch.gather(face_gap, -1, axis)
    inside_dist = -gap_axis[..., 0]

    normal = torch.where(outside[..., None], n_out, n_in)
    sdist = torch.where(outside, dist, inside_dist)
    surface_local = torch.where(outside[..., None], clamped, center_local + n_in * gap_axis)
    return normal, sdist, surface_local


def solve_contact_normal(u_n, target, w_n, lam):
    """One clamped normal-impulse update; returns (d_lambda, new_lambda)."""
    d_lam = (target - u_n) / w_n
    new_lam = torch.clamp_min(lam + d_lam, 0.0)
    return new_lam - lam, new_lam


def solve_contact_friction(u_t, w_t, lam_t, mu_lam_n):
    """One clamped friction-impulse update along a tangent direction."""
    d_lam = -u_t / w_t
    new_lam = saturate(lam_t + d_lam, -mu_lam_n, mu_lam_n)
    return new_lam - lam_t, new_lam


def contact_target(depth, v_n0, restitution, bounce_threshold, h: float, cfg: SolverConfig,
                   bias_cap: float | None = None) -> torch.Tensor:
    """Velocity target of the normal constraint.

    Penetrating: Baumgarte bias beta/h * (depth - slop), capped at
    ``bias_cap`` m/s when given (finger-only contacts). Separated:
    speculative -gap/h. Restitution (``restitution_target``) can only raise
    the target."""
    pen_bias = cfg.baumgarte / h * torch.clamp_min(depth - cfg.contact_slop, 0.0)
    if bias_cap is not None:
        pen_bias = torch.clamp_max(pen_bias, bias_cap)
    bias = torch.where(depth > 0.0, pen_bias, depth / h)
    return torch.maximum(bias, restitution_target(depth, v_n0, restitution,
                                                  bounce_threshold, h))


def restitution_target(depth, v_n0, restitution, bounce_threshold, h: float) -> torch.Tensor:
    """Restitution part of the normal target, -inf when inactive: -e * v_n0
    when the impact is faster than the bounce threshold and the pair is
    predicted to touch within this substep (depth - v_n0 * h > 0)."""
    touching = depth - v_n0 * h > 0.0
    return torch.where((v_n0 < -bounce_threshold) & touching, -restitution * v_n0,
                       -torch.inf)
