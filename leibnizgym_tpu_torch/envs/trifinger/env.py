"""TriFinger environment: functional MDP core + stateful wrapper (counterpart
of ``leibnizgym_tpu/envs/trifinger/env.py``).

    env_step: (EnvStatic, EnvParams, EnvState, action, draws)
              -> (EnvState, obs, states, reward, dones, info)

batched over the env axis on one torch device. All randomness is "draw,
then a pure function of the draws": the stateful ``TrifingerEnv`` draws the
(n, 25) uniform blocks of a full reset and of a goal reset from its
``torch.Generator`` each step, and tests inject the reference's draws. The
physics step is the CUDA kernel on a CUDA device and its plain PyTorch
version on the CPU (``ops/cuda_engine.py``).

Reference quirks kept: zero action on an env's reset step; dones = reset AND
goal_reset under ``dones_mode: "and"``; with success termination off,
``successes`` becomes a 0/1 flag; the ``robot_a`` state slot holds the
applied torque; frame counters become float before ``* num_envs``.

Not in the port yet (a config that turns one on raises NotImplementedError
naming its ROADMAP.md item): domain randomization, goal rotation, keypoint
observations, observation noise, the goal-orientation and tolerance
curricula.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from leibnizgym_tpu_torch.models import trifinger as tf_model
from leibnizgym_tpu.utils.helpers import merged_dict
from leibnizgym_tpu.utils.message import print_info
from leibnizgym_tpu_torch.envs.env_base import EnvBase
from leibnizgym_tpu_torch.envs.trifinger import sample as sampling
from leibnizgym_tpu_torch.envs.trifinger.config import (
    SIM_DEFAULT_CONFIG_DICT,
    TRIFINGER_DEFAULT_CONFIG_DICT,
)
from leibnizgym_tpu_torch.envs.trifinger.dims import CuboidalObject, SphereObject
from leibnizgym_tpu_torch.envs.trifinger.rewards import (
    RewardTermSpec,
    build_reward_specs,
    compute_rewards_c,
    quat_diff_rad_c,
)
from leibnizgym_tpu_torch.ops.cuda_engine import physics_step_cuda, physics_step_plain
from leibnizgym_tpu_torch.ops.engine_v2 import fingertip_components_v2
from leibnizgym_tpu_torch.ops.types import PhysicsState, SceneParams, SolverConfig
from leibnizgym_tpu_torch.utils.math import (
    saturate,
    scale_transform,
    unscale_transform,
)

_NOT_PORTED = "is not in the PyTorch port yet (ROADMAP.md queue 1, item 11)"

# ---------------------------------------------------------------------------
# Static environment description
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class EnvStatic:
    num_envs: int
    episode_length: int
    task_difficulty: int
    command_mode: str
    normalize_obs: bool
    normalize_action: bool
    apply_safety_damping: bool
    asymmetric_obs: bool
    enable_ft_sensors: bool
    robot_reset_type: str
    robot_dof_pos_stddev: float
    robot_dof_vel_stddev: float
    object_reset_type: str
    termination_activate: bool
    termination_bonus: float
    position_tolerance: float
    orientation_tolerance: float
    dones_mode: str
    control_decimation: int
    dt: float
    reward_specs: Tuple[RewardTermSpec, ...]
    solver: SolverConfig

    @property
    def action_dim(self) -> int:
        return 18 if self.command_mode == "position_impedance" else 9

    @property
    def obs_dim(self) -> int:
        return 9 + 9 + 7 + 7 + self.action_dim

    @property
    def state_dim(self) -> int:
        if not self.asymmetric_obs:
            return 0
        return self.obs_dim + 6 + 3 * 13 + 9 + 3 * 6

    def reward_spec_dict(self) -> Dict[str, RewardTermSpec]:
        return {s.name: s for s in self.reward_specs}


@dataclasses.dataclass
class EnvParams:
    obs_scale_low: torch.Tensor
    obs_scale_high: torch.Tensor
    state_scale_low: torch.Tensor
    state_scale_high: torch.Tensor
    action_scale_low: torch.Tensor
    action_scale_high: torch.Tensor
    pd_stiffness: torch.Tensor  # (9,)
    pd_damping: torch.Tensor  # (9,)
    safety_damping: torch.Tensor  # (9,)
    torque_low: torch.Tensor  # (9,)
    torque_high: torch.Tensor  # (9,)
    dof_default_pos: torch.Tensor  # (9,)
    dof_default_vel: torch.Tensor  # (9,)
    max_com_distance: torch.Tensor  # ()
    object_min_height: torch.Tensor  # ()
    object_max_height: torch.Tensor  # ()
    object_radius_3d: torch.Tensor  # ()
    object_size_z: torch.Tensor  # ()
    scene_base: SceneParams  # unbatched template


@dataclasses.dataclass
class EnvState:
    """Full environment state, batched over the env axis. ``*_cm`` fields
    are component-major (k, N), as in the reference."""

    physics: PhysicsState  # (N, ...)
    scene: SceneParams  # (N, ...) per-env physics params
    pd_scale: torch.Tensor  # (N, 2) scale on (pd_stiffness, pd_damping)
    goal_pose_cm: torch.Tensor  # (7, N) [x y z qx qy qz qw]
    goal_angvel_cm: torch.Tensor  # (3, N)
    action_buf: torch.Tensor  # (N, A)
    applied_torque: torch.Tensor  # (N, 9)
    tip_wrench: torch.Tensor  # (N, 18) [f0: force3 torque3 | f1 | f2]
    reset_buf: torch.Tensor  # (N,) bool
    goal_reset_buf: torch.Tensor  # (N,) bool
    steps_count: torch.Tensor  # (N,) int32
    successes: torch.Tensor  # (N,) int32
    tip_pos_prev_cm: torch.Tensor  # (9, N) previous-step tip xyz, finger-major
    obj_posquat_prev_cm: torch.Tensor  # (7, N) previous-step object pos+quat
    frames: int  # simulator frame counter (host side)

    def replace(self, **changes) -> "EnvState":
        return dataclasses.replace(self, **changes)

    @property
    def goal_pose(self) -> torch.Tensor:
        return self.goal_pose_cm.T


# ---------------------------------------------------------------------------
# Builders
# ---------------------------------------------------------------------------


def build_static(config: dict) -> EnvStatic:
    rs = config["reset_distribution"]
    term = config["termination_conditions"]["success"]
    sim = config["sim"]
    unported = {
        "domain_randomization": bool(
            config.get("domain_randomization", {}).get("activate", False)),
        "goal rotation": bool(config["goal_movement"]["rotation"]["activate"]),
        "keypoint observations": bool(config.get("use_keypoint_obs", False)),
        "observation noise": float(config.get("obs_noise_std", 0.0)) > 0.0,
        "the goal curriculum": bool(config.get("goal_curriculum", {})),
        "tolerance annealing": float(term.get("tolerance_anneal_frames", 0.0)) > 0.0,
    }
    for name, on in unported.items():
        if on:
            raise NotImplementedError(f"{name} {_NOT_PORTED}")
    tpu_solver = str(sim["physx"].get("tpu_solver", "tgs"))
    if tpu_solver not in ("pgs", "tgs"):
        raise ValueError(
            f"Invalid sim.physx.tpu_solver: {tpu_solver!r} not in ['pgs', 'tgs']."
        )
    object_type = str(config.get("object_type", "cube"))
    if object_type not in ("cube", "sphere"):
        raise ValueError(
            f"Invalid object_type: {object_type!r} not in ['cube', 'sphere']."
        )
    pairs = dict(sim.get("contact_pairs", {}) or {})
    unknown = set(pairs) - {"cube_wall", "tip_ground", "tip_wall", "link_cube", "torsion"}
    if unknown:
        raise ValueError(f"Invalid sim.contact_pairs keys: {sorted(unknown)}")
    solver = SolverConfig(
        substeps=int(sim["substeps"]),
        solver_iterations=int(sim["physx"]["num_position_iterations"]),
        solver_type=1 if tpu_solver == "tgs" else 0,
        object_shape=1 if object_type == "sphere" else 0,
        enable_cube_wall=bool(pairs.get("cube_wall", True)),
        enable_tip_ground=bool(pairs.get("tip_ground", True)),
        enable_tip_wall=bool(pairs.get("tip_wall", True)),
        enable_link_cube=bool(pairs.get("link_cube", True)),
        enable_torsion=bool(pairs.get("torsion", True)),
    )
    specs = build_reward_specs(config["reward_terms"])
    return EnvStatic(
        num_envs=int(config["num_instances"]),
        episode_length=int(config["episode_length"] or 0),
        task_difficulty=int(config["task_difficulty"]),
        command_mode=str(config["command_mode"]),
        normalize_obs=bool(config["normalize_obs"]),
        normalize_action=bool(config["normalize_action"]),
        apply_safety_damping=bool(config["apply_safety_damping"]),
        asymmetric_obs=bool(config["asymmetric_obs"]),
        enable_ft_sensors=bool(config["enable_ft_sensors"] or config["asymmetric_obs"]),
        robot_reset_type=str(rs["robot_initial_state"]["type"]),
        robot_dof_pos_stddev=float(rs["robot_initial_state"]["dof_pos_stddev"]),
        robot_dof_vel_stddev=float(rs["robot_initial_state"]["dof_vel_stddev"]),
        object_reset_type=str(rs["object_initial_state"]["type"]),
        termination_activate=bool(term["activate"]),
        termination_bonus=float(term["bonus"]),
        position_tolerance=float(term["position_tolerance"]),
        orientation_tolerance=float(term["orientation_tolerance"]),
        dones_mode=str(config.get("dones_mode", "and")),
        control_decimation=int(config["control_decimation"]),
        dt=float(sim["dt"]),
        reward_specs=tuple(specs[name] for name in sorted(specs)),
        solver=solver,
    )


def build_params(static: EnvStatic, object_dims, arena: Optional[dict] = None,
                 object_density: Optional[float] = None, device="cpu",
                 dtype=torch.float32) -> EnvParams:
    """Scale vectors and sampling geometry, as the reference assembles them.
    ``dtype`` is the env's working type (float32; float64 on the CPU for
    tests that compare formulas without float32 rounding)."""
    jpos_low = np.tile(tf_model.JOINT_POS_LOW, 3)
    jpos_high = np.tile(tf_model.JOINT_POS_HIGH, 3)
    jvel_low = np.full(9, -tf_model.MAX_VELOCITY_RADPS, np.float32)
    jvel_high = np.full(9, tf_model.MAX_VELOCITY_RADPS, np.float32)
    jtorque_low = np.full(9, -tf_model.MAX_TORQUE_NM, np.float32)
    jtorque_high = np.full(9, tf_model.MAX_TORQUE_NM, np.float32)
    obj_pos_low = np.array([-0.3, -0.3, 0.0], np.float32)
    obj_pos_high = np.array([0.3, 0.3, 0.3], np.float32)
    ori_low = -np.ones(4, np.float32)
    ori_high = np.ones(4, np.float32)
    stiffness_low = np.tile([1.0, 1.0, 1.0], 3).astype(np.float32)
    stiffness_high = np.tile([50.0, 50.0, 50.0], 3).astype(np.float32)

    if static.command_mode == "position":
        act_low, act_high = jpos_low, jpos_high
    elif static.command_mode == "torque":
        act_low, act_high = jtorque_low, jtorque_high
    elif static.command_mode == "position_impedance":
        act_low = np.concatenate([jpos_low, stiffness_low])
        act_high = np.concatenate([jpos_high, stiffness_high])
    else:
        raise ValueError(
            f"Invalid command mode: {static.command_mode!r} not in "
            "['torque', 'position', 'position_impedance']."
        )

    if static.normalize_action:
        obs_act_low = np.full(static.action_dim, -1.0, np.float32)
        obs_act_high = np.full(static.action_dim, 1.0, np.float32)
    else:
        obs_act_low, obs_act_high = act_low, act_high

    obs_low = np.concatenate(
        [jpos_low, jvel_low, obj_pos_low, ori_low, obj_pos_low, ori_low, obs_act_low]
    )
    obs_high = np.concatenate(
        [jpos_high, jvel_high, obj_pos_high, ori_high, obj_pos_high, ori_high, obs_act_high]
    )
    if static.asymmetric_obs:
        ftip_low = np.concatenate(
            [np.array([-0.4, -0.4, 0.0]), ori_low, np.full(6, -0.2)]
        ).astype(np.float32)
        ftip_high = np.concatenate(
            [np.array([0.4, 0.4, 0.5]), ori_high, np.full(6, 0.2)]
        ).astype(np.float32)
        state_low = np.concatenate(
            [obs_low, np.full(6, -0.5, np.float32), np.tile(ftip_low, 3), jtorque_low,
             np.tile(np.full(6, -1.0, np.float32), 3)]
        )
        state_high = np.concatenate(
            [obs_high, np.full(6, 0.5, np.float32), np.tile(ftip_high, 3), jtorque_high,
             np.tile(np.full(6, 1.0, np.float32), 3)]
        )
        assert state_low.shape[0] == static.state_dim
    else:
        state_low = np.zeros(0, np.float32)
        state_high = np.zeros(0, np.float32)
    assert obs_low.shape[0] == static.obs_dim
    assert act_low.shape[0] == static.action_dim

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device).to(dtype)

    return EnvParams(
        obs_scale_low=t(obs_low),
        obs_scale_high=t(obs_high),
        state_scale_low=t(state_low),
        state_scale_high=t(state_high),
        action_scale_low=t(act_low),
        action_scale_high=t(act_high),
        pd_stiffness=t(np.tile(tf_model.PD_STIFFNESS, 3)),
        pd_damping=t(np.tile(tf_model.PD_DAMPING, 3)),
        safety_damping=t(np.tile(tf_model.SAFETY_DAMPING, 3)),
        torque_low=t(jtorque_low),
        torque_high=t(jtorque_high),
        dof_default_pos=t(np.tile(tf_model.JOINT_POS_DEFAULT, 3)),
        dof_default_vel=t(np.zeros(9)),
        max_com_distance=t(object_dims.max_com_distance_to_center),
        object_min_height=t(object_dims.min_height),
        object_max_height=t(object_dims.max_height),
        object_radius_3d=t(object_dims.radius_3d),
        object_size_z=t(object_dims.size[2]),
        scene_base=_scene_with_arena(
            SceneParams.default(
                object_size=object_dims.size,
                object_density=object_density,
                object_shape="sphere" if static.solver.object_shape == 1 else "box",
                device=device, dtype=dtype,
            ),
            arena or {},
        ),
    )


def _scene_with_arena(scene: SceneParams, arena: dict) -> SceneParams:
    """Apply the gym ``arena`` config to the wall profile: ``profile: "cone"``
    (the default) is the measured reference boundary, ``"cylinder"`` the
    straight wall; explicit ``wall_*`` keys override single values."""
    known = {"profile", "wall_radius", "wall_slope", "wall_knee_z"}
    unknown = set(arena) - known
    if unknown:
        raise ValueError(
            f"unknown arena config key(s) {sorted(unknown)}; valid: {sorted(known)}"
        )
    like = scene.wall_radius

    def t(x):
        return torch.as_tensor(np.float32(x), device=like.device).to(like.dtype)

    profile = str(arena.get("profile", "cone"))
    if profile == "cone":
        scene = scene.replace(
            wall_radius=t(tf_model.WALL_CONE_BASE_RADIUS),
            wall_slope=t(tf_model.WALL_CONE_SLOPE),
            wall_knee_z=t(tf_model.WALL_CONE_KNEE_Z),
        )
    elif profile != "cylinder":
        raise ValueError(f"unknown arena.profile {profile!r}; valid: 'cylinder', 'cone'")
    for key in ("wall_radius", "wall_slope", "wall_knee_z"):
        if key in arena:
            scene = scene.replace(**{key: t(float(arena[key]))})
    return scene


# ---------------------------------------------------------------------------
# Draws and samplers. One reset draws one (n, 25) uniform block:
#   0:18 robot noise | 18:21 object r, theta, yaw | 21:25 goal r, theta, z, yaw
# and, for difficulties 4-6, one (n, 8) normal block (0:4 goal orientation).
# ---------------------------------------------------------------------------

N_UNIFORM = 25
N_NORMAL = 8


def needs_normals(static: EnvStatic) -> bool:
    return static.task_difficulty in (4, 5, 6)


def draw_reset_randoms(static: EnvStatic, generator: torch.Generator, n: int, device,
                       dtype=torch.float32):
    """(uniform (n, 25), normal (n, 8) or None) from ``generator``."""
    u = torch.rand((n, N_UNIFORM), generator=generator, device=device, dtype=dtype)
    if needs_normals(static):
        return u, torch.randn((n, N_NORMAL), generator=generator, device=device,
                              dtype=dtype)
    return u, None


def _sample_robot_state(static: EnvStatic, params: EnvParams, u: torch.Tensor, n: int):
    q = params.dof_default_pos.expand(n, 9)
    qd = params.dof_default_vel.expand(n, 9)
    if static.robot_reset_type == "random":
        noise = 2.0 * u[:, 0:18] - 1.0
        q = q + static.robot_dof_pos_stddev * noise[:, 0:9]
        qd = qd + static.robot_dof_vel_stddev * noise[:, 9:18]
    elif static.robot_reset_type not in ("default", "none"):
        raise ValueError(f"Invalid robot reset distribution: {static.robot_reset_type!r}")
    return q, qd


def _sample_object_state(static: EnvStatic, params: EnvParams, u: torch.Tensor, n: int):
    """(pos 3-tuple, quat 4-tuple) of (N,) component columns."""
    if static.object_reset_type == "default":
        z = params.object_min_height.expand(n)
        zero = torch.zeros_like(u[:, 0])
        pos = (zero, zero, z)
        quat = sampling.default_orientation(n, u.device, u.dtype)
    elif static.object_reset_type in ("random", "none"):
        x, y = sampling.random_xy_from_uniform(u[:, 18:20], params.max_com_distance)
        z = (params.object_size_z / 2).expand(n)
        pos = (x, y, z)
        quat = sampling.random_yaw_orientation_from_uniform(u[:, 20])
    else:
        raise ValueError(
            f"Invalid object reset distribution: {static.object_reset_type!r}"
        )
    return pos, tuple(quat[:, i] for i in range(4))


def _sample_goal_poses(static: EnvStatic, params: EnvParams, u: torch.Tensor, norm, n: int):
    """Per-difficulty goal sampling; returns (pose_cm (7, N), angvel_cm (3, N))."""
    d = static.task_difficulty
    u_xy = u[:, 21:23]
    u_z = u[:, 23]
    u_yaw = u[:, 24]
    zero = torch.zeros_like(u[:, 0])
    if d == -1:
        x, y = sampling.random_xy_from_uniform(u_xy, params.max_com_distance)
        z = (params.object_size_z / 2).expand(n)
        ori = sampling.random_yaw_orientation_from_uniform(u_yaw)
    elif d == 1:
        x, y = sampling.random_xy_from_uniform(u_xy, params.max_com_distance)
        z = (params.object_size_z / 2).expand(n)
        ori = sampling.default_orientation(n, u.device)
    elif d == 2:
        x, y = zero, zero
        z = (params.object_min_height + 0.05).expand(n)
        ori = sampling.default_orientation(n, u.device)
    elif d == 3:
        x, y = sampling.random_xy_from_uniform(u_xy, params.max_com_distance)
        z = sampling.random_z_from_uniform(
            u_z, params.object_min_height, params.object_max_height
        )
        ori = sampling.default_orientation(n, u.device)
    elif d in (4, 5):
        x, y = sampling.random_xy_from_uniform(u_xy, params.max_com_distance)
        z = sampling.random_z_from_uniform(
            u_z, params.object_radius_3d, params.object_max_height
        )
        ori = sampling.random_orientation_from_normal(norm[:, 0:4])
    elif d == 6:
        x, y = zero, zero
        z = (params.object_min_height + 0.05).expand(n)
        ori = sampling.random_orientation_from_normal(norm[:, 0:4])
    else:
        raise ValueError(f"Invalid difficulty index for task: {d}.")
    pose_cm = torch.stack([x, y, z, ori[:, 0], ori[:, 1], ori[:, 2], ori[:, 3]])
    return pose_cm, torch.zeros((3, n), device=u.device, dtype=u.dtype)


# ---------------------------------------------------------------------------
# Torque pipeline
# ---------------------------------------------------------------------------


def compute_torque(static: EnvStatic, params: EnvParams, action_buf: torch.Tensor,
                   q: torch.Tensor, qd: torch.Tensor,
                   pd_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    if static.normalize_action:
        action_tf = unscale_transform(
            action_buf, params.action_scale_low, params.action_scale_high
        )
    else:
        action_tf = action_buf
    if pd_scale is None:
        kp_s = kd_s = 1.0
    else:
        kp_s, kd_s = pd_scale[..., 0:1], pd_scale[..., 1:2]

    if static.command_mode == "torque":
        computed = action_tf
    elif static.command_mode == "position":
        computed = (kp_s * params.pd_stiffness * (action_tf - q)
                    - kd_s * params.pd_damping * qd)
    elif static.command_mode == "position_impedance":
        desired = action_tf[..., 0:9]
        stiffness = action_tf[..., 9:18]
        computed = stiffness * (desired - q) - kd_s * params.pd_damping * qd
    else:
        raise ValueError(f"Invalid command mode: {static.command_mode!r}")

    applied = saturate(computed, params.torque_low, params.torque_high)
    if static.apply_safety_damping:
        applied = applied - params.safety_damping * qd
        applied = saturate(applied, params.torque_low, params.torque_high)
    return applied


# ---------------------------------------------------------------------------
# Simulation + observation assembly
# ---------------------------------------------------------------------------


def _simulate(static: EnvStatic, physics: PhysicsState, tau: torch.Tensor,
              scene: SceneParams, n_calls: int):
    """``n_calls`` physics steps: the CUDA kernel on a CUDA device, the plain
    version on the CPU."""
    step = physics_step_cuda if physics.q.is_cuda else physics_step_plain
    wrench = torch.zeros((tau.shape[0], 3, 6), device=tau.device, dtype=tau.dtype)
    for _ in range(n_calls):
        physics, wrench = step(physics, tau, scene, static.solver, static.dt)
    return physics, wrench


def _fingertip_components(physics: PhysicsState):
    q_cols = tuple(physics.q[:, i] for i in range(9))
    qd_cols = tuple(physics.qd[:, i] for i in range(9))
    return fingertip_components_v2(q_cols, qd_cols)


def _object_components(physics: PhysicsState):
    return (
        tuple(physics.cube_pos[:, i] for i in range(3)),
        tuple(physics.cube_quat[:, i] for i in range(4)),
        tuple(physics.cube_linvel[:, i] for i in range(3)),
        tuple(physics.cube_angvel[:, i] for i in range(3)),
    )


def _assemble_obs_raw(physics: PhysicsState, obj_pos, obj_quat, goal_pos, goal_quat,
                      action_buf: torch.Tensor) -> torch.Tensor:
    """Unnormalized observation [q | qd | object pose | goal pose | action]."""
    pose_cols = list(obj_pos) + list(obj_quat) + list(goal_pos) + list(goal_quat)
    return torch.cat(
        [physics.q, physics.qd, torch.stack(pose_cols, dim=-1), action_buf], dim=-1
    )


def _fill_states(static: EnvStatic, params: EnvParams, obs_raw: torch.Tensor,
                 obj_linvel, obj_angvel, tips, applied_torque: torch.Tensor,
                 tip_wrench: torch.Tensor) -> torch.Tensor:
    """Asymmetric 113-dim privileged state from the *unnormalized* obs."""
    if not static.asymmetric_obs:
        return obs_raw.new_zeros(obs_raw.shape[:-1] + (0,))
    tip_cols = []
    for (tp, tq, tl, ta) in tips:
        tip_cols.extend(tp)
        tip_cols.extend(tq)
        tip_cols.extend(tl)
        tip_cols.extend(ta)
    states = torch.cat(
        [
            obs_raw,
            torch.stack(list(obj_linvel) + list(obj_angvel), dim=-1),
            torch.stack(tip_cols, dim=-1),
            applied_torque,
            tip_wrench,
        ],
        dim=-1,
    )
    if static.normalize_obs:
        states = scale_transform(states, params.state_scale_low, params.state_scale_high)
    return states


# ---------------------------------------------------------------------------
# Reset / step cores
# ---------------------------------------------------------------------------


def _masked_full_reset(static: EnvStatic, params: EnvParams, state: EnvState,
                       mask: torch.Tensor, u: torch.Tensor, norm) -> EnvState:
    """Apply a full reset to the envs selected by ``mask`` (N,), from the
    draws ``u`` (n, 25) and ``norm`` (n, 8) or None."""
    n = static.num_envs
    q_s, qd_s = _sample_robot_state(static, params, u, n)
    obj_pos_s, obj_quat_s = _sample_object_state(static, params, u, n)
    goal_cm_s, angvel_cm_s = _sample_goal_poses(static, params, u, norm, n)

    m1 = mask[:, None]
    mrow = mask[None, :]
    physics = state.physics
    if static.robot_reset_type != "none":
        physics = physics.replace(
            q=torch.where(m1, q_s, physics.q),
            qd=torch.where(m1, qd_s, physics.qd),
        )
    obj_posquat_prev_cm = state.obj_posquat_prev_cm
    if static.object_reset_type != "none":
        physics = physics.replace(
            cube_pos=torch.where(m1, torch.stack(obj_pos_s, dim=-1), physics.cube_pos),
            cube_quat=torch.where(m1, torch.stack(obj_quat_s, dim=-1), physics.cube_quat),
            cube_linvel=torch.where(m1, 0.0, physics.cube_linvel),
            cube_angvel=torch.where(m1, 0.0, physics.cube_angvel),
        )
        # a full reset refreshes the object history slot with the sampled pose
        # but leaves the fingertip history stale (reference quirk)
        obj_posquat_prev_cm = torch.where(
            mrow, torch.stack(obj_pos_s + obj_quat_s), obj_posquat_prev_cm
        )
    return state.replace(
        physics=physics,
        goal_pose_cm=torch.where(mrow, goal_cm_s, state.goal_pose_cm),
        goal_angvel_cm=torch.where(mrow, angvel_cm_s, state.goal_angvel_cm),
        obj_posquat_prev_cm=obj_posquat_prev_cm,
        reset_buf=state.reset_buf & ~mask,
        steps_count=torch.where(mask, 0, state.steps_count),
        successes=torch.where(mask, 0, state.successes),
    )


def _masked_goal_reset(static: EnvStatic, params: EnvParams, state: EnvState,
                       mask: torch.Tensor, u: torch.Tensor, norm) -> EnvState:
    goal_cm_s, angvel_cm_s = _sample_goal_poses(static, params, u, norm, static.num_envs)
    mrow = mask[None, :]
    return state.replace(
        goal_pose_cm=torch.where(mrow, goal_cm_s, state.goal_pose_cm),
        goal_angvel_cm=torch.where(mrow, angvel_cm_s, state.goal_angvel_cm),
        goal_reset_buf=state.goal_reset_buf & ~mask,
    )


def _check_termination(static: EnvStatic, obj_pos, obj_quat, goal_pos, goal_quat,
                       reward, goal_reset_buf, successes, info):
    """Success termination (+bonus) on the position / orientation tolerances."""
    dx = goal_pos[0] - obj_pos[0]
    dy = goal_pos[1] - obj_pos[1]
    dz = goal_pos[2] - obj_pos[2]
    pos_dist = torch.sqrt(dx * dx + dy * dy + dz * dz)
    goal_position_reset = pos_dist <= static.position_tolerance
    info["env/current_position_goal/count"] = torch.sum(goal_position_reset)
    ori_dist = quat_diff_rad_c(obj_quat, goal_quat)
    goal_orientation_reset = ori_dist <= static.orientation_tolerance
    info["env/current_orientation_goal/count"] = torch.sum(goal_orientation_reset)
    info["env/pos_dist_mean"] = torch.mean(pos_dist)
    info["env/ori_dist_mean"] = torch.mean(ori_dist)

    if static.task_difficulty < 4:
        completion = goal_position_reset
    elif static.task_difficulty == 4:
        completion = goal_position_reset & goal_orientation_reset
    else:
        completion = goal_orientation_reset

    if static.termination_activate:
        reward = reward + static.termination_bonus * completion.to(reward.dtype)
        goal_reset_buf = completion
        successes = successes + completion.to(successes.dtype)
    else:
        # reference quirk: successes becomes a 0/1 flag when termination is off
        successes = (goal_reset_buf & (successes > 0)).to(successes.dtype)
    info["env/average_consecutive_success"] = torch.mean(successes.to(torch.float32))
    return reward, goal_reset_buf, successes, info


def env_step(static: EnvStatic, params: EnvParams, state: EnvState,
             action: torch.Tensor, draws):
    """One MDP step for all envs. ``draws`` = (u_reset, norm_reset, u_goal,
    norm_goal): the random blocks of this step's full and goal resets."""
    u_reset, norm_reset, u_goal, norm_goal = draws
    n = static.num_envs
    info: Dict[str, torch.Tensor] = {}

    # reset envs first: observations need post-reset physics
    reset_mask = state.reset_buf
    goal_mask = state.goal_reset_buf
    action_buf = torch.where(reset_mask[:, None], 0.0, action)
    state = _masked_full_reset(static, params, state, reset_mask, u_reset, norm_reset)
    state = _masked_goal_reset(static, params, state, goal_mask, u_goal, norm_goal)

    tau = compute_torque(static, params, action_buf, state.physics.q, state.physics.qd,
                         state.pd_scale)
    physics, tip_wrench6 = _simulate(
        static, state.physics, tau, state.scene, static.control_decimation
    )
    tip_wrench = tip_wrench6.reshape(n, 18)
    frames = state.frames + static.control_decimation

    goal_pose_cm = state.goal_pose_cm
    goal_pos = tuple(goal_pose_cm[i] for i in range(3))
    goal_quat = tuple(goal_pose_cm[i] for i in range(3, 7))

    tips = _fingertip_components(physics)
    obj_pos, obj_quat, obj_linvel, obj_angvel = _object_components(physics)
    tip_pos = tuple(t[0] for t in tips)
    tip_pos_prev = tuple(
        tuple(state.tip_pos_prev_cm[3 * f + c] for c in range(3)) for f in range(3)
    )
    obj_pos_prev = tuple(state.obj_posquat_prev_cm[i] for i in range(3))
    obj_quat_prev = tuple(state.obj_posquat_prev_cm[i] for i in range(3, 7))

    # float before `* n`: an integer product overflows past 2.1 B env steps
    env_steps_count = torch.tensor(float(frames), device=tau.device) * n
    half_cols = tuple(state.scene.cube_half_extents[:, i] for i in range(3))
    reward, term_values = compute_rewards_c(
        static.reward_spec_dict(), static.dt, env_steps_count,
        tip_pos, tip_pos_prev, obj_pos, obj_quat, obj_pos_prev, obj_quat_prev,
        goal_pos, goal_quat, half_extents=half_cols,
    )
    for name, value in term_values.items():
        info[f"env/rewards/{name}"] = torch.mean(value)

    reward, goal_reset_buf, successes, info = _check_termination(
        static, obj_pos, obj_quat, goal_pos, goal_quat, reward,
        state.goal_reset_buf, state.successes, info,
    )

    steps_count = state.steps_count + 1
    reset_buf = state.reset_buf
    if static.episode_length:
        reset_buf = reset_buf | (steps_count >= static.episode_length)
    if static.dones_mode == "and":
        dones = reset_buf & goal_reset_buf
    else:
        dones = reset_buf | goal_reset_buf

    obs_raw = _assemble_obs_raw(physics, obj_pos, obj_quat, goal_pos, goal_quat, action_buf)
    obs = (scale_transform(obs_raw, params.obs_scale_low, params.obs_scale_high)
           if static.normalize_obs else obs_raw)
    states = _fill_states(static, params, obs_raw, obj_linvel, obj_angvel, tips, tau,
                          tip_wrench)

    new_state = state.replace(
        physics=physics,
        goal_pose_cm=goal_pose_cm,
        action_buf=action_buf,
        applied_torque=tau,
        tip_wrench=tip_wrench,
        reset_buf=reset_buf,
        goal_reset_buf=goal_reset_buf,
        steps_count=steps_count,
        successes=successes,
        tip_pos_prev_cm=torch.stack([tip_pos[f][c] for f in range(3) for c in range(3)]),
        obj_posquat_prev_cm=torch.stack(list(obj_pos) + list(obj_quat)),
        frames=frames,
    )
    return new_state, obs, states, reward, dones, info


def initial_state(static: EnvStatic, params: EnvParams) -> EnvState:
    """The all-default state a full reset starts from, on the params' device
    and in their dtype."""
    n = static.num_envs
    like = params.dof_default_pos
    device, dtype = like.device, like.dtype
    zeros = lambda *shape: torch.zeros(shape, device=device, dtype=dtype)  # noqa: E731
    return EnvState(
        physics=PhysicsState.default(n, device, dtype),
        scene=params.scene_base.broadcast(n),
        pd_scale=torch.ones((n, 2), device=device, dtype=dtype),
        goal_pose_cm=torch.tensor(
            [[0.0], [0.0], [0.0], [0.0], [0.0], [0.0], [1.0]], device=device, dtype=dtype
        ).repeat(1, n),
        goal_angvel_cm=zeros(3, n),
        action_buf=zeros(n, static.action_dim),
        applied_torque=zeros(n, 9),
        tip_wrench=zeros(n, 18),
        reset_buf=torch.zeros(n, dtype=torch.bool, device=device),
        goal_reset_buf=torch.zeros(n, dtype=torch.bool, device=device),
        steps_count=torch.zeros(n, dtype=torch.int32, device=device),
        successes=torch.zeros(n, dtype=torch.int32, device=device),
        tip_pos_prev_cm=zeros(9, n),
        obj_posquat_prev_cm=zeros(7, n),
        frames=0,
    )


def env_reset(static: EnvStatic, params: EnvParams, u: torch.Tensor, norm=None):
    """Full reset of all envs from the draws (u (n, 25), norm): reset, a
    zero-action torque, ONE physics call, observations."""
    n = static.num_envs
    device = u.device
    state = initial_state(static, params)
    state = _masked_full_reset(
        static, params, state, torch.ones(n, dtype=torch.bool, device=device), u, norm
    )
    tau = compute_torque(static, params, state.action_buf, state.physics.q,
                         state.physics.qd, state.pd_scale)
    physics, tip_wrench6 = _simulate(static, state.physics, tau, state.scene, 1)

    tips = _fingertip_components(physics)
    obj_pos, obj_quat, _, _ = _object_components(physics)
    goal_pos = tuple(state.goal_pose_cm[i] for i in range(3))
    goal_quat = tuple(state.goal_pose_cm[i] for i in range(3, 7))
    obs = _assemble_obs_raw(physics, obj_pos, obj_quat, goal_pos, goal_quat,
                            state.action_buf)
    if static.normalize_obs:
        obs = scale_transform(obs, params.obs_scale_low, params.obs_scale_high)
    state = state.replace(
        physics=physics,
        applied_torque=tau,
        tip_wrench=tip_wrench6.reshape(n, 18),
        tip_pos_prev_cm=torch.stack([tips[f][0][c] for f in range(3) for c in range(3)]),
        obj_posquat_prev_cm=torch.stack(list(obj_pos) + list(obj_quat)),
        frames=state.frames + 1,
    )
    return state, obs


# ---------------------------------------------------------------------------
# Stateful wrapper
# ---------------------------------------------------------------------------


class TrifingerEnv(EnvBase):
    """Stateful wrapper with the reference's public surface (``reset()``,
    ``step(action)``, ``get_state()``, buffer properties) on an explicit
    torch ``device``."""

    def __init__(self, config: Optional[dict] = None, device="cpu",
                 verbose: bool = True, dtype=torch.float32):
        merged = merged_dict(dict(SIM_DEFAULT_CONFIG_DICT), TRIFINGER_DEFAULT_CONFIG_DICT)
        if config is not None:
            merged = merged_dict(merged, config)
        if merged["asymmetric_obs"]:
            merged["enable_ft_sensors"] = True
        object_type = str(merged.get("object_type", "cube"))
        object_size = merged.get(
            "object_size", 2 * tf_model.BALL_RADIUS if object_type == "sphere" else 0.065,
        )
        dims_cls = SphereObject if object_type == "sphere" else CuboidalObject
        self._object_dims = dims_cls(
            float(object_size) if np.isscalar(object_size)
            else tuple(float(s) for s in object_size)
        )
        self.static = build_static(merged)
        density = merged.get("object_density")
        self.params = build_params(
            self.static, self._object_dims, arena=merged.get("arena"),
            object_density=None if density is None else float(density), device=device,
            dtype=dtype,
        )
        self.dtype = dtype
        obs_spec = {
            "robot_q": 9, "robot_u": 9, "object_q": 7, "object_q_des": 7,
            "command": self.static.action_dim,
        }
        action_spec = {"command": self.static.action_dim}
        state_spec = {
            **obs_spec, "object_u": 6, "fingertip_state": 39, "robot_a": 9,
            "fingertip_wrench": 18,
        } if self.static.asymmetric_obs else {}
        EnvBase.__init__(self, obs_spec, action_spec, state_spec, merged,
                         device=device, verbose=False)
        self.verbose = verbose
        if verbose:
            print_info(
                f"TrifingerEnv[torch {self.device}]: N={self.static.num_envs} "
                f"difficulty={self.static.task_difficulty} "
                f"obs={self.static.obs_dim} states={self.static.state_dim} "
                f"actions={self.static.action_dim}"
            )

    def draw(self):
        """One reset's random blocks from the env's generator."""
        return draw_reset_randoms(self.static, self.generator, self.static.num_envs,
                                  self.device, self.dtype)

    def reset(self):
        self._state, obs = env_reset(self.static, self.params, *self.draw())
        self._last = (obs, None, None, None, {})
        return obs

    def step(self, action, draws=None):
        """One step; ``draws`` (u_reset, norm_reset, u_goal, norm_goal) are
        drawn from the env's generator unless given."""
        expected = (self.static.num_envs, self.static.action_dim)
        if tuple(action.shape) != expected:
            raise ValueError(
                f"Invalid shape for tensor `action`. Input: {tuple(action.shape)}"
                f" != {expected}."
            )
        if draws is None:
            draws = self.draw() + self.draw()
        self._state, obs, states, reward, dones, info = env_step(
            self.static, self.params, self._state, action, draws
        )
        self._last = (obs, states, reward, dones, info)
        return obs, reward, dones, info

    def get_state(self):
        return self._last[1]
