"""Physics datatypes (counterpart of ``leibnizgym_tpu/ops/types.py``).

``PhysicsState`` and ``SceneParams`` are dataclasses of float32 tensors.
Every field may carry a leading env batch dim; ``SceneParams.default()`` is
unbatched and ``broadcast(n)`` makes the per-env (DR-shaped) copy the env
keeps. ``SolverConfig`` is a frozen dataclass of Python numbers.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from perfbench.reference import trifinger as tf_model


def _tensor(x, device=None, dtype=torch.float32) -> torch.Tensor:
    """A float32-rounded constant (the reference's dtype) in ``dtype``."""
    return torch.as_tensor(np.asarray(x, np.float32), device=device).to(dtype)


class _TensorFields:
    """replace / to / broadcast helpers shared by the tensor dataclasses."""

    def replace(self, **changes):
        return dataclasses.replace(self, **changes)

    def fields(self):
        return {f.name: getattr(self, f.name) for f in dataclasses.fields(self)}

    def map(self, fn):
        return type(self)(**{k: fn(v) for k, v in self.fields().items()})


@dataclasses.dataclass
class PhysicsState(_TensorFields):
    """Dynamic state of one or a batch of TriFinger scenes (31 floats each)."""

    q: torch.Tensor  # (..., 9) joint positions, finger-major
    qd: torch.Tensor  # (..., 9) joint velocities
    cube_pos: torch.Tensor  # (..., 3)
    cube_quat: torch.Tensor  # (..., 4) xyzw
    cube_linvel: torch.Tensor  # (..., 3)
    cube_angvel: torch.Tensor  # (..., 3)


@dataclasses.dataclass
class SceneParams(_TensorFields):
    """Physical parameters of the scene; the domain-randomization surface."""

    gravity: torch.Tensor  # (3,)
    link_masses: torch.Tensor  # (3,)
    joint_damping: torch.Tensor  # (3,)
    armature: torch.Tensor  # (3,)
    torque_limit: torch.Tensor  # ()
    velocity_limit: torch.Tensor  # ()
    cube_mass: torch.Tensor  # ()
    cube_half_extents: torch.Tensor  # (3,)
    cube_inertia: torch.Tensor  # (3,)
    cube_linear_damping: torch.Tensor  # ()
    cube_angular_damping: torch.Tensor  # ()
    mu_tip_cube: torch.Tensor
    mu_cube_ground: torch.Tensor
    mu_cube_wall: torch.Tensor
    mu_tip_ground: torch.Tensor
    restitution_tip_cube: torch.Tensor
    restitution_cube_ground: torch.Tensor
    restitution_tip_ground: torch.Tensor
    tip_radius: torch.Tensor
    bounce_threshold: torch.Tensor
    wall_radius: torch.Tensor
    wall_slope: torch.Tensor
    wall_knee_z: torch.Tensor
    mu_tip_wall: torch.Tensor
    restitution_tip_wall: torch.Tensor
    mu_link_cube: torch.Tensor
    restitution_link_cube: torch.Tensor
    mu_torsion: torch.Tensor
    torsion_patch_radius: torch.Tensor

    def broadcast(self, n: int) -> "SceneParams":
        """Per-env copy: every field gets a leading (n,) dim."""
        return self.map(lambda x: x.expand((n,) + tuple(x.shape)).clone())

    @classmethod
    def default(cls, object_size=None, object_density: float | None = None,
                object_shape: str = "box", device=None,
                dtype=torch.float32) -> "SceneParams":
        """RRC cube defaults; ``object_shape="sphere"`` selects ball.urdf
        (``object_size`` is then the diameter and ``cube_half_extents[0]``
        the radius). Same values as the reference's ``SceneParams.default``."""
        if object_shape == "sphere":
            size = np.broadcast_to(np.asarray(
                2 * tf_model.BALL_RADIUS if object_size is None else object_size,
                np.float64,
            ), (3,))
            radius = float(size[0]) / 2
            if object_density is None:
                mass = tf_model.BALL_MASS * (radius / tf_model.BALL_RADIUS) ** 3
            else:
                mass = float(object_density * 4.0 / 3.0 * np.pi * radius**3)
            return cls.default(
                object_size=size, object_density=mass / float(np.prod(size)),
                device=device, dtype=dtype,
            ).replace(
                cube_inertia=_tensor(tf_model.ball_inertia_diag(mass, radius), device, dtype),
            )
        size = np.asarray(
            tf_model.CUBE_SIZE if object_size is None else object_size, np.float64
        )
        size = np.broadcast_to(size, (3,))
        density = tf_model.CUBE_DENSITY if object_density is None else object_density
        mass = float(density * size[0] * size[1] * size[2])

        def combine(a, b):
            # PhysX default pair combine mode: average
            return 0.5 * (a + b)

        t = lambda x: _tensor(x, device, dtype)  # noqa: E731
        return cls(
            gravity=t([0.0, 0.0, -9.81]),
            link_masses=t(tf_model.LINK_MASSES),
            joint_damping=t(np.zeros(3)),
            armature=t(np.zeros(3)),
            torque_limit=t(tf_model.MAX_TORQUE_NM),
            velocity_limit=t(tf_model.MAX_VELOCITY_RADPS),
            cube_mass=t(mass),
            cube_half_extents=t(size / 2),
            cube_inertia=t(tf_model.cube_inertia_diag(mass, size)),
            cube_linear_damping=t(tf_model.CUBE_LINEAR_DAMPING),
            cube_angular_damping=t(tf_model.CUBE_ANGULAR_DAMPING),
            mu_tip_cube=t(combine(tf_model.ROBOT_FRICTION, tf_model.OBJECT_FRICTION)),
            mu_cube_ground=t(combine(tf_model.OBJECT_FRICTION, tf_model.GROUND_FRICTION)),
            mu_cube_wall=t(combine(tf_model.OBJECT_FRICTION, tf_model.STAGE_FRICTION)),
            mu_tip_ground=t(combine(tf_model.ROBOT_FRICTION, tf_model.GROUND_FRICTION)),
            restitution_tip_cube=t(
                combine(tf_model.ROBOT_RESTITUTION, tf_model.OBJECT_RESTITUTION)
            ),
            restitution_cube_ground=t(0.0),
            restitution_tip_ground=t(combine(tf_model.ROBOT_RESTITUTION, 0.0)),
            tip_radius=t(tf_model.TIP_SPHERE_RADIUS),
            bounce_threshold=t(0.5),
            wall_radius=t(tf_model.WALL_INNER_RADIUS),
            wall_slope=t(0.0),
            wall_knee_z=t(0.0),
            mu_tip_wall=t(combine(tf_model.ROBOT_FRICTION, tf_model.STAGE_FRICTION)),
            restitution_tip_wall=t(combine(tf_model.ROBOT_RESTITUTION, 0.0)),
            mu_link_cube=t(combine(tf_model.ROBOT_FRICTION, tf_model.OBJECT_FRICTION)),
            restitution_link_cube=t(
                combine(tf_model.ROBOT_RESTITUTION, tf_model.OBJECT_RESTITUTION)
            ),
            mu_torsion=t(combine(0.0, tf_model.OBJECT_TORSION_FRICTION)),
            torsion_patch_radius=t(0.01),
        )


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Static solver configuration (see the reference's field notes).

    solver_type: 0 = velocity-level PGS + Baumgarte, 1 = TGS mini-steps.
    object_shape: 0 = box, 1 = sphere. The ``enable_*`` gates drop a contact
    group entirely (no queries, no solver slots)."""

    substeps: int = 4
    solver_iterations: int = 8
    solver_type: int = 0
    object_shape: int = 0
    baumgarte: float = 0.2
    tgs_bias: float = 0.7
    contact_slop: float = 0.001
    w_min: float = 0.05
    finger_bias_cap: float = 2.0
    joint_limit_lower: tuple = tuple(np.tile(tf_model.JOINT_POS_LOW, 3).tolist())
    joint_limit_upper: tuple = tuple(np.tile(tf_model.JOINT_POS_HIGH, 3).tolist())
    enable_cube_wall: bool = True
    enable_tip_ground: bool = True
    enable_tip_wall: bool = True
    enable_link_cube: bool = True
    enable_torsion: bool = True
