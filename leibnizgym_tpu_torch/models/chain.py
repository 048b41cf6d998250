"""Generic robot-chain model built from any trifinger-family URDF
(counterpart of ``leibnizgym_tpu/models/chain.py``).

The baked tables in :mod:`leibnizgym_tpu_torch.models.trifinger` cover the
robot the RL environment uses (trifingerpro). This module generalizes that
derivation to every robot variant of the family (the URDFs under
``resources/assets/robots/``: trifinger, trifingeredu, finger, fingerpro,
fingeredu, ...): it walks the parsed kinematic tree into a
:class:`ChainModel` of per-finger tables that
:mod:`leibnizgym_tpu_torch.ops.generic_chain` can simulate.

All variants share the trifinger family shape: F identical fixed-base
3-DoF serial chains (F = 1 or 3), each mounted by a sequence of fixed
joints, with a fixed tip frame after the last revolute joint.
``chain_from_urdf`` asserts this shape instead of assuming trifingerpro's particular axes,
offsets, or mount yaws (edu, for example, uses different joint axes and
off-center mounts).

Everything here is numpy at build time; ``ops.generic_chain`` turns the
arrays into tensors on the caller's device and dtype.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from leibnizgym_tpu_torch.models.urdf import Joint, UrdfModel, parse_urdf


def _rpy_to_matrix(rpy: np.ndarray) -> np.ndarray:
    """URDF fixed-axis roll-pitch-yaw to rotation matrix (Rz @ Ry @ Rx)."""
    r, p, y = [float(v) for v in rpy]
    cr, sr = np.cos(r), np.sin(r)
    cp, sp = np.cos(p), np.sin(p)
    cy, sy = np.cos(y), np.sin(y)
    rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
    return rz @ ry @ rx


def _full_inertia(diag: np.ndarray, off: np.ndarray, rpy: np.ndarray) -> np.ndarray:
    """3x3 inertia about the COM in the *link* frame from URDF fields
    (ixx iyy izz), (ixy ixz iyz), and the inertial-origin rotation."""
    i = np.array(
        [
            [diag[0], off[0], off[1]],
            [off[0], diag[1], off[2]],
            [off[1], off[2], diag[2]],
        ],
        dtype=np.float64,
    )
    r = _rpy_to_matrix(rpy)
    return r @ i @ r.T


def _merge_full(m1, c1, i1, m2, c2, i2):
    """Merge two bodies given (mass, com, full 3x3 inertia about own com in
    a common frame) -> (mass, com, full 3x3 inertia about the merged com).
    Full-matrix version of models.trifinger._merge_bodies."""
    m = m1 + m2
    c = (m1 * c1 + m2 * c2) / m

    def shift(mass, com, i):
        d = com - c
        return i + mass * (np.dot(d, d) * np.eye(3) - np.outer(d, d))

    return m, c, shift(m1, c1, i1) + shift(m2, c2, i2)


@dataclasses.dataclass(frozen=True)
class ChainModel:
    """Per-finger chain tables for a trifinger-family robot.

    All fingers share one chain description; per-finger differences live in
    ``mount_rot``/``mount_pos`` (the composed fixed transforms base -> finger
    frame). Link tables cover (upper, middle, lower+tip-merged), matching the
    convention of models/trifinger.py.
    """

    name: str
    num_fingers: int
    mount_rot: np.ndarray  # (F, 3, 3)
    mount_pos: np.ndarray  # (F, 3)
    joint_xyz: np.ndarray  # (3, 3) revolute-joint origin translation (parent frame)
    joint_rot: np.ndarray  # (3, 3, 3) revolute-joint origin rotation
    joint_axis: np.ndarray  # (3, 3) rotation axis in the joint frame (unit)
    tip_xyz: np.ndarray  # (3,) lower-link -> tip translation (lower frame)
    link_masses: np.ndarray  # (3,)
    link_coms: np.ndarray  # (3, 3) COM in link frame (relative to its joint)
    link_inertias: np.ndarray  # (3, 3, 3) about COM, link frame
    joint_lower: np.ndarray  # (3,)
    joint_upper: np.ndarray  # (3,)
    effort_limit: np.ndarray  # (3,)
    velocity_limit: np.ndarray  # (3,)

    def as_tuples(self):
        """Hashable nested-tuple form (static-config friendly)."""

        def t(a):
            a = np.asarray(a, dtype=np.float64)
            return tuple(map(tuple, a)) if a.ndim > 1 else tuple(a.tolist())

        return tuple(
            (f.name, t(getattr(self, f.name)))
            for f in dataclasses.fields(self)
            if f.name not in ("name", "num_fingers")
        )


def _compose_fixed(joints: List[Joint]) -> tuple[np.ndarray, np.ndarray]:
    """Compose a run of fixed joints into one (rot, pos) transform."""
    rot = np.eye(3)
    pos = np.zeros(3)
    for j in joints:
        pos = pos + rot @ np.asarray(j.origin_xyz, dtype=np.float64)
        rot = rot @ _rpy_to_matrix(j.origin_rpy)
    return rot, pos


def _tip_links(model: UrdfModel) -> List[str]:
    """Leaf links whose root path crosses exactly 3 revolute joints."""
    parents = {j.parent for j in model.joints}
    tips = []
    for name in model.links:
        if name in parents:
            continue
        chain = model.chain_to(name)
        if sum(1 for j in chain if j.type == "revolute") == 3:
            tips.append(name)
    return sorted(tips)


def chain_from_urdf(path: str) -> ChainModel:
    """Build a :class:`ChainModel` from any trifinger-family URDF."""
    model = parse_urdf(path)
    tips = _tip_links(model)
    if not tips:
        raise ValueError(f"{path}: no 3-DoF finger chains found")

    mounts_r, mounts_p = [], []
    shared = None
    for tip in tips:
        chain = model.chain_to(tip)
        first_rev = next(i for i, j in enumerate(chain) if j.type == "revolute")
        rev = [j for j in chain[first_rev:] if j.type == "revolute"]
        post = [j for j in chain[first_rev:] if j.type == "fixed"]
        if len(rev) != 3:
            raise ValueError(f"{path}: {tip} chain is not 3-DoF")
        # mount = composed fixed transforms before the first revolute joint,
        # including that joint's own origin handled below in joint_xyz/rot
        m_rot, m_pos = _compose_fixed(chain[:first_rev])
        mounts_r.append(m_rot)
        mounts_p.append(m_pos)

        tip_rot, tip_pos = _compose_fixed(post)
        del tip_rot  # the tip is treated as a point + merged inertia

        # link tables: upper, middle, lower (+ tip body merged into lower)
        names = [j.child for j in rev]
        links = [model.links[n] for n in names]
        masses = [l.mass for l in links]
        coms = [np.asarray(l.com, dtype=np.float64) for l in links]
        inertias = [
            _full_inertia(l.inertia_diag, l.inertia_off, l.com_rpy) for l in links
        ]
        tip_link = model.links[tip]
        if tip_link.mass > 0:
            m, c, i = _merge_full(
                masses[2], coms[2], inertias[2],
                tip_link.mass, tip_pos + np.asarray(tip_link.com, dtype=np.float64),
                _full_inertia(tip_link.inertia_diag, tip_link.inertia_off,
                              tip_link.com_rpy),
            )
            masses[2], coms[2], inertias[2] = m, c, i

        desc = dict(
            joint_xyz=np.stack([j.origin_xyz for j in rev]).astype(np.float64),
            joint_rot=np.stack([_rpy_to_matrix(j.origin_rpy) for j in rev]),
            joint_axis=np.stack(
                [np.asarray(j.axis, dtype=np.float64)
                 / np.linalg.norm(j.axis) for j in rev]
            ),
            tip_xyz=tip_pos,
            link_masses=np.array(masses, dtype=np.float64),
            link_coms=np.stack(coms),
            link_inertias=np.stack(inertias),
            joint_lower=np.array([j.lower for j in rev]),
            joint_upper=np.array([j.upper for j in rev]),
            effort_limit=np.array([j.effort for j in rev]),
            velocity_limit=np.array([j.velocity for j in rev]),
        )
        if shared is None:
            shared = desc
        else:
            for k, v in desc.items():
                if not np.allclose(shared[k], v, atol=1e-9):
                    raise ValueError(
                        f"{path}: fingers differ in {k} — not a shared-chain "
                        "trifinger-family robot"
                    )

    return ChainModel(
        name=model.name,
        num_fingers=len(tips),
        mount_rot=np.stack(mounts_r).astype(np.float32),
        mount_pos=np.stack(mounts_p).astype(np.float32),
        **{k: np.asarray(v, dtype=np.float32) for k, v in shared.items()},
    )
