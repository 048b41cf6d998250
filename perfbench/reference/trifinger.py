"""TriFinger-Pro robot model tables and cube/scene constants.

The port's own copy of the JAX package's ``leibnizgym_tpu/models/trifinger.py``
(plain numpy). The port imports nothing of the JAX package;
``tests/test_torch_copies.py`` holds every public constant here equal to the
JAX package's, so the two cannot drift.

These tables are *derived from* (not copied out of) the reference URDF assets:

- robot kinematics/inertials: trifingerpro.urdf
  (resources/assets/trifinger/robot_properties_fingers/urdf/pro/
   trifingerpro.urdf:51-189, 461-475): three identical 3-DoF serial chains
  mounted on a holder at z=0.29 with yaw 0 / -120deg / -240deg.
- cube: cube_multicolor_rrc.urdf (0.065 m box, density 291.3).
- stage: high_table_boundary.urdf collision meshes measured; the arena wall is
  a cylinder of inner radius ~0.191 m, height ~0.176 m; the table surface
  coincides with the ground plane z=0.
- fingertip collision mesh (SIM__BL-Finger_Tip_actual_tip.obj) measured:
  bounding sphere radius ~0.0105 m centered ~1.3 mm above the tip frame.

The three fingers share one chain description; per-finger differences are the
mount yaw only — so batched dynamics treats (env, finger) as one flat batch
axis and never branches per finger.
"""

from __future__ import annotations

import numpy as np

# ---------------------------------------------------------------------------
# Kinematic chain (finger-local frame; identical for all three fingers)
# ---------------------------------------------------------------------------

# holder height above the world origin (trifingerpro.urdf:54 base_to_upper_holder)
MOUNT_HEIGHT = 0.29
# mount yaw of each finger about z (trifingerpro.urdf:461-475)
FINGER_MOUNT_YAWS = np.array([0.0, -2.09439510239, -4.18879020479], dtype=np.float32)

# translation from the previous joint frame to each joint frame, expressed in
# the parent *link* frame (trifingerpro.urdf:170-189):
#   joint 1 (base_to_upper):   at the finger base origin
#   joint 2 (upper_to_middle): (0.01685, 0.0505, 0) in the upper-link frame
#   joint 3 (middle_to_lower): (0.04922, 0, -0.16) in the middle-link frame
JOINT_OFFSETS = np.array(
    [
        [0.0, 0.0, 0.0],
        [0.01685, 0.0505, 0.0],
        [0.04922, 0.0, -0.16],
    ],
    dtype=np.float32,
)

# rotation axes in the respective parent frames: y, x, x (urdf:174, 181, 188)
JOINT_AXES = np.array(
    [
        [0.0, 1.0, 0.0],
        [1.0, 0.0, 0.0],
        [1.0, 0.0, 0.0],
    ],
    dtype=np.float32,
)

# fixed transform lower-link -> tip frame (urdf:161-168)
TIP_OFFSET = np.array([0.0185, 0.0, -0.1626], dtype=np.float32)

# URDF joint limits (urdf:173-188). The env uses tighter soft limits; these
# are the hard mechanical ones.
URDF_JOINT_LOWER = np.array([-0.9, -1.57, -2.7], dtype=np.float32)
URDF_JOINT_UPPER = np.array([1.4, 1.57, 0.0], dtype=np.float32)

# ---------------------------------------------------------------------------
# Link inertials (urdf:95-158). The tip link (m=0.031) is welded to the lower
# link, so we merge the two into one composite body here.
# ---------------------------------------------------------------------------


def _merge_bodies(m1, c1, i1_diag, m2, c2, i2_diag):
    """Merge two bodies given (mass, com, diag inertia about own com in a
    common frame) into (mass, com, full 3x3 inertia about merged com)."""
    m = m1 + m2
    c = (m1 * c1 + m2 * c2) / m

    def shift(mass, com, i_diag):
        d = com - c
        i = np.diag(i_diag).astype(np.float64)
        return i + mass * (np.dot(d, d) * np.eye(3) - np.outer(d, d))

    return m, c, shift(m1, c1, i1_diag) + shift(m2, c2, i2_diag)


_upper_m = 0.26
_upper_com = np.array([0.0, 0.06, 0.0])
_upper_inertia = np.diag([4.59333333333e-4, 6.93333333333e-5, 4.59333333333e-4])

_middle_m = 0.25
_middle_com = np.array([0.028, 0.0, -0.08])
_middle_inertia = np.diag([4.41666666667e-4, 4.41666666667e-4, 6.66666666667e-5])

_lower_tip_m, _lower_tip_com, _lower_tip_inertia = _merge_bodies(
    0.021, np.array([0.0, 0.0, -0.06]), np.array([3.5e-5, 3.5e-5, 1.4e-6]),
    0.031, TIP_OFFSET.astype(np.float64), np.full(3, 5.16666666667e-7),
)

# per-link mass, COM (link frame), inertia about COM (link frame), links =
# (upper, middle, lower+tip)
LINK_MASSES = np.array([_upper_m, _middle_m, _lower_tip_m], dtype=np.float32)
LINK_COMS = np.stack(
    [_upper_com, _middle_com, _lower_tip_com]
).astype(np.float32)
LINK_INERTIAS = np.stack(
    [_upper_inertia, _middle_inertia, _lower_tip_inertia]
).astype(np.float32)

# ---------------------------------------------------------------------------
# Soft limits & actuation (reference trifinger_env.py:149-224)
# ---------------------------------------------------------------------------

MAX_TORQUE_NM = 0.36
MAX_VELOCITY_RADPS = 10.0

# env-level joint limits per finger (trifinger_env.py:156-158)
JOINT_POS_LOW = np.array([-0.33, 0.0, -2.7], dtype=np.float32)
JOINT_POS_HIGH = np.array([1.0, 1.57, 0.0], dtype=np.float32)
JOINT_POS_DEFAULT = np.array([0.0, 0.9, -1.7], dtype=np.float32)

# PD gains per finger joint (trifinger_env.py:216-224)
PD_STIFFNESS = np.array([10.0, 10.0, 10.0], dtype=np.float32)
PD_DAMPING = np.array([0.1, 0.3, 0.001], dtype=np.float32)
SAFETY_DAMPING = np.array([0.08, 0.08, 0.04], dtype=np.float32)

# ---------------------------------------------------------------------------
# Collision geometry
# ---------------------------------------------------------------------------

# fingertip collision approximated as a sphere (measured from the tip mesh)
TIP_SPHERE_RADIUS = 0.0105
TIP_SPHERE_OFFSET = np.array([0.0, 0.0, 0.0013], dtype=np.float32)

# arena boundary wall (measured from convex_table_boundary meshes)
WALL_INNER_RADIUS = 0.191
WALL_HEIGHT = 0.176

# measured profile of the reference boundary (high_table_boundary.stl inner
# envelope, scripts/asset_tools.py deviation): a vertical cylinder of radius
# WALL_CONE_BASE_RADIUS up to WALL_CONE_KNEE_Z, then a cone flaring at
# WALL_CONE_SLOPE (dr/dz). Selected via gym config arena.profile="cone";
# the default arena stays the straight cylinder above (PARITY.md).
WALL_CONE_BASE_RADIUS = 0.1945
WALL_CONE_KNEE_Z = 0.034
WALL_CONE_SLOPE = 0.577

# lower-link shaft collision samples: (fraction along the knee->tip segment,
# sphere radius). Radii measured from cross-sections of the reference lower
# link mesh (SIM__BL-Finger_Tip_without_tip.obj: shaft p95 radius ~0.013 near
# the knee tapering to ~0.0115 mid-span). These analytic spheres replace the
# V-HACD convex pieces the reference collides for the forearm
# (trifinger_env.py:874-937) — they stop a policy from pushing the lower link
# through the cube while staying branch-free on TPU.
LOWER_LINK_SAMPLES = ((0.30, 0.013), (0.65, 0.0115))

# ---------------------------------------------------------------------------
# Cube (cube_multicolor_rrc.urdf: 0.065 m box, density 291.3)
# ---------------------------------------------------------------------------

CUBE_SIZE = 0.065
CUBE_DENSITY = 291.3
CUBE_MASS = float(CUBE_DENSITY * CUBE_SIZE**3)  # ~0.080 kg

# material properties (reference trifinger_env.py:874-937, _setup_sim:360-367)
ROBOT_FRICTION = 1.0
ROBOT_RESTITUTION = 0.8
OBJECT_FRICTION = 1.0
OBJECT_TORSION_FRICTION = 0.001
OBJECT_RESTITUTION = 0.0
STAGE_FRICTION = 1.0
GROUND_FRICTION = 0.1

# IsaacGym AssetOptions defaults applied to the assets
ROBOT_ANGULAR_DAMPING = 0.01  # trifinger_env.py:866
CUBE_ANGULAR_DAMPING = 0.5  # gymapi.AssetOptions() default (not overridden)
CUBE_LINEAR_DAMPING = 0.0


# ---------------------------------------------------------------------------
# Ball (ball.urdf: 0.0375 m radius sphere, mass 0.25, declared inertia 1e-4;
# reference resources/assets/trifinger/objects/urdf/ball.urdf)
# ---------------------------------------------------------------------------

BALL_RADIUS = 0.0375
BALL_MASS = 0.25
# the URDF declares 1e-4 (slightly below the solid-sphere 2/5 m r^2 = 1.41e-4);
# IsaacGym uses declared inertias as-is, so the default ball keeps them
BALL_INERTIA = 1e-4


def cube_inertia_diag(mass: float, size) -> np.ndarray:
    """Diagonal inertia of a solid cuboid about its COM."""
    if np.isscalar(size):
        sx = sy = sz = float(size)
    else:
        sx, sy, sz = (float(s) for s in size)
    return np.array(
        [
            mass / 12.0 * (sy * sy + sz * sz),
            mass / 12.0 * (sx * sx + sz * sz),
            mass / 12.0 * (sx * sx + sy * sy),
        ],
        dtype=np.float32,
    )
