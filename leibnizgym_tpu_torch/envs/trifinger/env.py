"""TriFinger environment: functional MDP core + stateful wrapper (counterpart
of ``leibnizgym_tpu/envs/trifinger/env.py``).

    env_step: (EnvStatic, EnvParams, EnvState, action, draws)
              -> (EnvState, obs, states, reward, dones, info)

batched over the env axis on one torch device. All randomness is "draw,
then a pure function of the draws": the stateful ``TrifingerEnv`` draws each
step's blocks (``draw_step_randoms``: full reset, goal reset, domain
randomization, observation noise) from its ``torch.Generator``, and tests
inject the reference's draws. The physics step is the config's ``engine``
(``EnvStatic.engine``): ``"pallas"``, the default on a CUDA device, is the
CUDA kernel (its plain PyTorch version on CPU tensors, the counterpart of
Pallas interpret mode); ``"soa"``, the default on the CPU, is that plain
version on any device; ``"reference"`` is the batch-first reference engine
(``ops/engine.py``).

Reference quirks kept: zero action on an env's reset step; dones = reset AND
goal_reset under ``dones_mode: "and"``; with success termination off,
``successes`` becomes a 0/1 flag; the ``robot_a`` state slot holds the
applied torque; frame counters become float32 before ``* num_envs``.

The flagship recipe's features are in: domain randomization (``dr/``),
keypoint observations, goal rotation, observation noise, the frame-ramp and
success-gated (``EnvParams.curriculum_level``) goal and tolerance curricula.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from leibnizgym_tpu_torch import dr
from leibnizgym_tpu_torch.models import trifinger as tf_model
from leibnizgym_tpu_torch.utils.helpers import merged_dict, resolve_device
from leibnizgym_tpu_torch.utils.message import print_info
from leibnizgym_tpu_torch.envs.env_base import EnvBase
from leibnizgym_tpu_torch.envs.trifinger import sample as sampling
from leibnizgym_tpu_torch.envs.trifinger.config import (
    SIM_DEFAULT_CONFIG_DICT,
    TRIFINGER_DEFAULT_CONFIG_DICT,
)
from leibnizgym_tpu_torch.envs.trifinger.dims import CuboidalObject, SphereObject
from leibnizgym_tpu_torch.envs.trifinger.rewards import (
    RewardTermSpec,
    _qmul_c,
    build_reward_specs,
    compute_rewards_c,
    quat_diff_rad_c,
    quat_rotate_c,
)
from leibnizgym_tpu_torch.ops import cuda_engine
from leibnizgym_tpu_torch.ops import engine as reference_engine
from leibnizgym_tpu_torch.ops.capture import Captured
from leibnizgym_tpu_torch.ops.cuda_engine import physics_step_cuda, physics_step_plain
from leibnizgym_tpu_torch.ops.types import PhysicsState, SceneParams, SolverConfig
from leibnizgym_tpu_torch.parallel.mesh import shard_batch
from leibnizgym_tpu_torch.utils.math import (
    saturate,
    scale_transform,
    unscale_transform,
)

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
    goal_rotation_active: bool
    goal_rate_magnitude: float
    termination_activate: bool
    termination_bonus: float
    position_tolerance: float
    orientation_tolerance: float
    # the tolerance curriculum: a lerp from *_init to the final tolerance,
    # driven by curriculum_level when success-gated, else by env-steps over
    # tolerance_anneal_frames (0: off)
    position_tolerance_init: float
    orientation_tolerance_init: float
    tolerance_anneal_frames: float
    # the goal-orientation curriculum (difficulties 4-6): the swing of goal
    # orientations scaled from ori_difficulty_init to 1, by the same level or
    # by env-steps over ori_difficulty_anneal_frames (0: off)
    ori_difficulty_init: float
    ori_difficulty_anneal_frames: float
    curriculum_success_gated: bool
    dones_mode: str
    control_decimation: int
    dt: float
    dr_activate: bool
    dr_ranges: Tuple[Tuple[str, float, float], ...]  # (name, lo, hi), configured
    dr_pd_gain_scale: Tuple[float, float]
    engine: str  # "pallas" (the CUDA kernel) | "soa" (its plain version) | "reference"
    use_keypoint_obs: bool  # append 8 object + 8 goal cube corners to the obs
    obs_noise_std: float  # in normalized obs units, policy obs only; 0: off
    reward_specs: Tuple[RewardTermSpec, ...]
    solver: SolverConfig
    # envs over every rank of a data-parallel run (0: num_envs, one process);
    # the env-step counters that drive the frame-ramped curricula count them
    num_envs_global: int = 0

    @property
    def envs_counted(self) -> int:
        return self.num_envs_global or self.num_envs

    @property
    def action_dim(self) -> int:
        return 18 if self.command_mode == "position_impedance" else 9

    @property
    def obs_dim(self) -> int:
        return 9 + 9 + 7 + 7 + self.action_dim + (48 if self.use_keypoint_obs else 0)

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
    # success-gated curriculum level in [0, 1], moved by the runner's
    # controller; read only when static.curriculum_success_gated
    curriculum_level: torch.Tensor  # ()

    def with_curriculum_level(self, level: float) -> "EnvParams":
        """A copy at ``level``; the tensors other than the level are shared."""
        like = self.dof_default_pos
        return dataclasses.replace(self, curriculum_level=torch.full(
            (), float(level), device=like.device, dtype=like.dtype))

    def set_curriculum_level_(self, level: float) -> None:
        """Write ``level`` into the level tensor in place, so that a captured
        step or epoch that reads it sees the new level."""
        self.curriculum_level.fill_(float(level))


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
    frames: torch.Tensor  # () int32, simulator frame counter, on the env's device

    def replace(self, **changes) -> "EnvState":
        return dataclasses.replace(self, **changes)

    @property
    def goal_pose(self) -> torch.Tensor:
        return self.goal_pose_cm.T


def env_state_tensors(state: EnvState) -> Dict[str, torch.Tensor]:
    """Every tensor of ``state`` under a flat name: the fields of
    ``physics`` and ``scene`` prefixed with ``physics_`` / ``scene_``
    (``physics_q``, ``scene_cube_mass``), the others under their own name
    (``goal_pose_cm``, ``reset_buf``, ``frames``)."""
    out = {}
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        if isinstance(v, (PhysicsState, SceneParams)):
            out.update({f"{f.name}_{k}": x for k, x in v.fields().items()})
        elif torch.is_tensor(v):
            out[f.name] = v
    return out


def env_state_from_tensors(tensors: Dict[str, torch.Tensor], frames=None) -> EnvState:
    """The inverse of ``env_state_tensors``. ``frames`` (an int or a 0-d
    tensor) stands in for a ``tensors`` that lacks it, as those written
    before the counter moved onto the device do; it becomes a 0-d int32
    tensor on the device of the other tensors."""
    nested = {"physics": PhysicsState, "scene": SceneParams}
    kw = {name: cls(**{f.name: tensors[f"{name}_{f.name}"] for f in dataclasses.fields(cls)})
          for name, cls in nested.items()}
    kw.update({f.name: tensors[f.name] for f in dataclasses.fields(EnvState)
               if f.name not in nested and f.name != "frames"})
    frames = tensors.get("frames", frames)
    if frames is None:
        raise KeyError("frames")
    return EnvState(frames=frames_tensor(frames, kw["reset_buf"].device), **kw)


def frames_tensor(frames, device) -> torch.Tensor:
    """``frames`` (an int, a numpy scalar or a tensor) as a 0-d int32 tensor
    on ``device``."""
    return torch.as_tensor(np.array(frames, np.int32) if not torch.is_tensor(frames)
                           else frames, device=device).to(torch.int32).reshape(())


def clone_state(state: EnvState) -> EnvState:
    """Every tensor of ``state`` copied into memory of its own."""
    return env_state_from_tensors({k: v.clone() for k, v in env_state_tensors(state).items()})


def copy_state_(dst: EnvState, src: EnvState) -> None:
    """Write ``src`` into the tensors of ``dst`` in place (a captured step
    keeps the addresses it was captured with)."""
    srcs = env_state_tensors(src)
    for k, d in env_state_tensors(dst).items():
        d.copy_(srcs[k])


# ---------------------------------------------------------------------------
# Builders
# ---------------------------------------------------------------------------


ENGINES = ("soa", "pallas", "reference")


def resolve_engine(engine, device="cuda:0") -> str:
    """The config's ``engine``: None means ``"pallas"`` (the kernel) on a CUDA
    device and ``"soa"`` (its plain version) elsewhere, as the reference
    picks Pallas on the TPU only; any value outside ENGINES is an error."""
    if engine is None:
        engine = "pallas" if torch.device(device).type == "cuda" else "soa"
    engine = str(engine)
    if engine not in ENGINES:
        raise ValueError(f"Invalid engine: {engine!r} not in {list(ENGINES)}.")
    return engine


def build_static(config: dict, device="cuda:0") -> EnvStatic:
    """The static description of ``config``; ``device`` resolves the
    default ``engine``."""
    rs = config["reset_distribution"]
    term = config["termination_conditions"]["success"]
    sim = config["sim"]
    dr_cfg = config.get("domain_randomization", {})
    curriculum = config.get("goal_curriculum", {})
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
        goal_rotation_active=bool(config["goal_movement"]["rotation"]["activate"]),
        goal_rate_magnitude=float(config["goal_movement"]["rotation"]["rate_magnitude"]),
        termination_activate=bool(term["activate"]),
        termination_bonus=float(term["bonus"]),
        position_tolerance=float(term["position_tolerance"]),
        orientation_tolerance=float(term["orientation_tolerance"]),
        position_tolerance_init=float(
            term.get("position_tolerance_init", term["position_tolerance"])),
        orientation_tolerance_init=float(
            term.get("orientation_tolerance_init", term["orientation_tolerance"])),
        tolerance_anneal_frames=float(term.get("tolerance_anneal_frames", 0.0)),
        ori_difficulty_init=float(curriculum.get("orientation_difficulty_init", 1.0)),
        ori_difficulty_anneal_frames=float(curriculum.get("anneal_frames", 0.0)),
        curriculum_success_gated=bool(curriculum.get("success_gated", False)),
        dones_mode=str(config.get("dones_mode", "and")),
        control_decimation=int(config["control_decimation"]),
        dt=float(sim["dt"]),
        dr_activate=bool(dr_cfg.get("activate", False)),
        dr_ranges=tuple((k, float(dr_cfg[k][0]), float(dr_cfg[k][1]))
                        for k in dr.DR_DEFAULTS if k in dr_cfg),
        dr_pd_gain_scale=tuple(float(x) for x in dr_cfg.get("pd_gain_scale", (1.0, 1.0))),
        engine=resolve_engine(config.get("engine"), device),
        use_keypoint_obs=bool(config.get("use_keypoint_obs", False)),
        obs_noise_std=float(config.get("obs_noise_std", 0.0)),
        reward_specs=tuple(specs[name] for name in sorted(specs)),
        solver=solver,
    )


def build_params(static: EnvStatic, object_dims, arena: Optional[dict] = None,
                 object_density: Optional[float] = None, device="cuda:0",
                 dtype=torch.float32) -> EnvParams:
    """Scale vectors and sampling geometry, as the reference assembles them.
    ``dtype`` is the env's working type (float32; float64 on the CPU for
    tests that compare formulas without float32 rounding). ``device``
    defaults to ``cuda:0``; CPU callers pass ``device="cpu"``."""
    device = resolve_device(device)
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
    if static.use_keypoint_obs:
        # 8 object + 8 goal corners: position limits widened by the half-diagonal
        pad = float(object_dims.radius_3d)
        kp_low = np.tile(obj_pos_low - pad, 8).astype(np.float32)
        kp_high = np.tile(obj_pos_high + pad, 8).astype(np.float32)
        obs_low = np.concatenate([obs_low, kp_low, kp_low])
        obs_high = np.concatenate([obs_high, kp_high, kp_high])
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
        curriculum_level=torch.zeros((), device=device, dtype=dtype),
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
# and, for difficulties 4-6 or goal rotation, one (n, 8) normal block
#   0:4 goal orientation | 4:8 goal angular velocity.
# A full reset with DR on adds the scene (n, 7) and PD-gain (n, 2) uniform
# blocks of ``dr``; observation noise is an (n, obs_dim) normal block.
# ---------------------------------------------------------------------------

N_UNIFORM = 25
N_NORMAL = 8


def needs_normals(static: EnvStatic) -> bool:
    return static.task_difficulty in (4, 5, 6) or static.goal_rotation_active


def draw_reset_randoms(static: EnvStatic, generator: torch.Generator, n: int, device,
                       dtype=torch.float32):
    """(uniform (n, 25), normal (n, 8) or None) from ``generator``."""
    u = torch.rand((n, N_UNIFORM), generator=generator, device=device, dtype=dtype)
    if needs_normals(static):
        return u, torch.randn((n, N_NORMAL), generator=generator, device=device,
                              dtype=dtype)
    return u, None


def _draw_extras(static: EnvStatic, generator: torch.Generator, n: int, device, dtype):
    """(DR blocks or None, observation noise or None)."""
    blocks = dr.draw_uniforms(generator, n, device, dtype) if static.dr_activate else None
    noise = (torch.randn((n, static.obs_dim), generator=generator, device=device, dtype=dtype)
             if static.obs_noise_std > 0.0 else None)
    return blocks, noise


def draw_init_randoms(static: EnvStatic, generator: torch.Generator, n: int, device,
                      dtype=torch.float32):
    """The draws of one ``env_reset``: (u, norm, dr, obs_noise)."""
    return (draw_reset_randoms(static, generator, n, device, dtype)
            + _draw_extras(static, generator, n, device, dtype))


def draw_step_randoms(static: EnvStatic, generator: torch.Generator, n: int, device,
                      dtype=torch.float32):
    """The draws of one ``env_step``: (u_reset, norm_reset, u_goal, norm_goal,
    dr, obs_noise)."""
    return (draw_reset_randoms(static, generator, n, device, dtype)
            + draw_reset_randoms(static, generator, n, device, dtype)
            + _draw_extras(static, generator, n, device, dtype))


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


def _ori_difficulty_frac(static: EnvStatic, params: EnvParams, frames: torch.Tensor):
    """The goal-orientation curriculum's swing fraction in [init, 1], from the
    success-gated level or the frame ramp; None when the curriculum is off.
    The ramp is float32, as in the reference."""
    if static.curriculum_success_gated:
        t = torch.clamp(params.curriculum_level, 0.0, 1.0)
    elif static.ori_difficulty_anneal_frames > 0.0:
        env_steps = frames.to(torch.float32) * static.envs_counted
        t = torch.clamp(env_steps / static.ori_difficulty_anneal_frames, 0.0, 1.0)
    else:
        return None
    return static.ori_difficulty_init + t * (1.0 - static.ori_difficulty_init)


def _sample_goal_poses(static: EnvStatic, params: EnvParams, u: torch.Tensor, norm, n: int,
                       ori_frac=None):
    """Per-difficulty goal sampling; returns (pose_cm (7, N), angvel_cm (3, N)).
    ``ori_frac`` scales the swing of the goal orientations of difficulties 4-6."""
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
    if ori_frac is not None and d in (4, 5, 6):
        ori = sampling.scale_orientation_swing(ori, ori_frac)
    pose_cm = torch.stack([x, y, z, ori[:, 0], ori[:, 1], ori[:, 2], ori[:, 3]])
    if static.goal_rotation_active:
        angvel_cm = sampling.random_angular_vel_from_normal(
            norm[:, 4:8], static.goal_rate_magnitude).T
    else:
        angvel_cm = torch.zeros((3, n), device=u.device, dtype=u.dtype)
    return pose_cm, angvel_cm


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
    """``n_calls`` physics steps of ``static.engine``."""
    step = {"pallas": physics_step_cuda, "soa": physics_step_plain,
            "reference": reference_engine.physics_step}[static.engine]
    wrench = torch.zeros((tau.shape[0], 3, 6), device=tau.device, dtype=tau.dtype)
    for _ in range(n_calls):
        physics, wrench = step(physics, tau, scene, static.solver, static.dt)
    return physics, wrench


def _fingertip_components(physics: PhysicsState):
    """Per finger (pos3, quat4, linvel3, angvel3) of (N,) columns: one
    launch of the fingertip kernel on the card, the plain version on the
    CPU (``cuda_engine.fingertip_components_cuda``)."""
    return cuda_engine.fingertip_components_cuda(physics.q, physics.qd)


def _object_components(physics: PhysicsState):
    return (
        tuple(physics.cube_pos[:, i] for i in range(3)),
        tuple(physics.cube_quat[:, i] for i in range(4)),
        tuple(physics.cube_linvel[:, i] for i in range(3)),
        tuple(physics.cube_angvel[:, i] for i in range(3)),
    )


_KP_SIGNS = tuple((sx, sy, sz) for sx in (-1.0, 1.0) for sy in (-1.0, 1.0)
                  for sz in (-1.0, 1.0))


def _cube_keypoint_cols(pos, quat, half):
    """24 columns: the world positions of the 8 cube corners, corner-major,
    from component tuples of (N,) columns."""
    cols = []
    for sx, sy, sz in _KP_SIGNS:
        cx, cy, cz = quat_rotate_c(quat, (sx * half[0], sy * half[1], sz * half[2]))
        cols.extend((pos[0] + cx, pos[1] + cy, pos[2] + cz))
    return cols


def _assemble_obs_raw(static: EnvStatic, scene: SceneParams, physics: PhysicsState,
                      obj_pos, obj_quat, goal_pos, goal_quat,
                      action_buf: torch.Tensor) -> torch.Tensor:
    """Unnormalized observation [q | qd | object pose | goal pose | action
    (| object keypoints | goal keypoints)], the keypoints from the per-env
    (randomized) half extents of ``scene``."""
    pose_cols = list(obj_pos) + list(obj_quat) + list(goal_pos) + list(goal_quat)
    parts = [physics.q, physics.qd, torch.stack(pose_cols, dim=-1), action_buf]
    if static.use_keypoint_obs:
        half = tuple(scene.cube_half_extents[:, i] for i in range(3))
        parts.append(torch.stack(_cube_keypoint_cols(obj_pos, obj_quat, half)
                                 + _cube_keypoint_cols(goal_pos, goal_quat, half), dim=-1))
    return torch.cat(parts, dim=-1)


def _observe(static: EnvStatic, params: EnvParams, obs_raw: torch.Tensor, noise):
    """The policy observation: normalized when configured, plus Gaussian
    noise of ``obs_noise_std`` normalized units from the draws ``noise``."""
    obs = (scale_transform(obs_raw, params.obs_scale_low, params.obs_scale_high)
           if static.normalize_obs else obs_raw)
    if static.obs_noise_std > 0.0:
        if noise is None:
            raise ValueError("obs_noise_std > 0 needs the observation-noise draws")
        noise = static.obs_noise_std * noise
        if not static.normalize_obs:
            noise = noise * (params.obs_scale_high - params.obs_scale_low) * 0.5
        obs = obs + noise
    return obs


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
                       mask: torch.Tensor, u: torch.Tensor, norm, dr_blocks=None) -> EnvState:
    """Apply a full reset to the envs selected by ``mask`` (N,), from the
    draws ``u`` (n, 25), ``norm`` (n, 8) or None and, with DR on,
    ``dr_blocks`` = (scene (n, 7), PD gains (n, 2))."""
    n = static.num_envs
    q_s, qd_s = _sample_robot_state(static, params, u, n)
    obj_pos_s, obj_quat_s = _sample_object_state(static, params, u, n)
    goal_cm_s, angvel_cm_s = _sample_goal_poses(
        static, params, u, norm, n, _ori_difficulty_frac(static, params, state.frames))

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
    scene, pd_scale = state.scene, state.pd_scale
    if static.dr_activate:
        if dr_blocks is None:
            raise ValueError("domain randomization is on: a full reset needs the DR draws")
        u_scene, u_pd = dr_blocks
        drawn = dr.sample_scene_params_from_uniform(
            u_scene, params.scene_base, {k: (lo, hi) for k, lo, hi in static.dr_ranges})
        scene = SceneParams(**{
            k: torch.where(mask.reshape((n,) + (1,) * (v.dim() - 1)), v, getattr(scene, k))
            for k, v in drawn.fields().items()})
        pd_scale = torch.where(
            m1, dr.sample_pd_scale_from_uniform(u_pd, static.dr_pd_gain_scale), pd_scale)
    return state.replace(
        physics=physics,
        scene=scene,
        pd_scale=pd_scale,
        goal_pose_cm=torch.where(mrow, goal_cm_s, state.goal_pose_cm),
        goal_angvel_cm=torch.where(mrow, angvel_cm_s, state.goal_angvel_cm),
        obj_posquat_prev_cm=obj_posquat_prev_cm,
        reset_buf=state.reset_buf & ~mask,
        steps_count=torch.where(mask, 0, state.steps_count),
        successes=torch.where(mask, 0, state.successes),
    )


def _masked_goal_reset(static: EnvStatic, params: EnvParams, state: EnvState,
                       mask: torch.Tensor, u: torch.Tensor, norm) -> EnvState:
    goal_cm_s, angvel_cm_s = _sample_goal_poses(
        static, params, u, norm, static.num_envs,
        _ori_difficulty_frac(static, params, state.frames))
    mrow = mask[None, :]
    return state.replace(
        goal_pose_cm=torch.where(mrow, goal_cm_s, state.goal_pose_cm),
        goal_angvel_cm=torch.where(mrow, angvel_cm_s, state.goal_angvel_cm),
        goal_reset_buf=state.goal_reset_buf & ~mask,
    )


def _check_termination(static: EnvStatic, obj_pos, obj_quat, goal_pos, goal_quat,
                       reward, goal_reset_buf, successes, info, env_steps_count,
                       curriculum_level):
    """Success termination (+bonus) on the position / orientation tolerances.
    Under the tolerance curriculum each tolerance is the lerp from its
    ``*_init`` value to its final value at the success-gated
    ``curriculum_level``, or at env-steps / ``tolerance_anneal_frames``."""
    pos_tol, ori_tol = static.position_tolerance, static.orientation_tolerance
    if static.curriculum_success_gated:
        frac = torch.clamp(curriculum_level, 0.0, 1.0)
    elif static.tolerance_anneal_frames > 0.0:
        frac = torch.clamp(env_steps_count / static.tolerance_anneal_frames, 0.0, 1.0)
    else:
        frac = None
    if frac is not None:
        pos_tol = static.position_tolerance_init + frac * (
            static.position_tolerance - static.position_tolerance_init)
        ori_tol = static.orientation_tolerance_init + frac * (
            static.orientation_tolerance - static.orientation_tolerance_init)
        info["env/position_tolerance"] = pos_tol
        info["env/orientation_tolerance"] = ori_tol
    dx = goal_pos[0] - obj_pos[0]
    dy = goal_pos[1] - obj_pos[1]
    dz = goal_pos[2] - obj_pos[2]
    pos_dist = torch.sqrt(dx * dx + dy * dy + dz * dz)
    goal_position_reset = pos_dist <= pos_tol
    info["env/current_position_goal/count"] = torch.sum(goal_position_reset)
    ori_dist = quat_diff_rad_c(obj_quat, goal_quat)
    goal_orientation_reset = ori_dist <= ori_tol
    info["env/current_orientation_goal/count"] = torch.sum(goal_orientation_reset)
    info["env/pos_dist_mean"] = torch.mean(pos_dist)
    info["env/ori_dist_mean"] = torch.mean(ori_dist)
    if static.curriculum_success_gated:
        # the share of envs inside the FINAL tolerances, whatever the level
        strict = ((pos_dist <= static.position_tolerance)
                  & (ori_dist <= static.orientation_tolerance))
        info["env/strict_success_frac"] = torch.mean(strict.to(torch.float32))
        info["env/curriculum_level"] = frac

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
    norm_goal, dr, obs_noise), ``draw_step_randoms``' layout: the random
    blocks of this step's full and goal resets, then the DR blocks and the
    observation noise, which may be left out (or None) where the config does
    not use them."""
    u_reset, norm_reset, u_goal, norm_goal, dr_blocks, obs_noise = (tuple(draws)
                                                                    + (None, None))[:6]
    n = static.num_envs
    info: Dict[str, torch.Tensor] = {}

    # reset envs first: observations need post-reset physics
    reset_mask = state.reset_buf
    goal_mask = state.goal_reset_buf
    action_buf = torch.where(reset_mask[:, None], 0.0, action)
    state = _masked_full_reset(static, params, state, reset_mask, u_reset, norm_reset,
                               dr_blocks)
    state = _masked_goal_reset(static, params, state, goal_mask, u_goal, norm_goal)

    tau = compute_torque(static, params, action_buf, state.physics.q, state.physics.qd,
                         state.pd_scale)
    physics, tip_wrench6 = _simulate(
        static, state.physics, tau, state.scene, static.control_decimation
    )
    tip_wrench = tip_wrench6.reshape(n, 18)
    frames = state.frames + static.control_decimation

    # goal rotation: the first-order update q' = normalize(q + h/2 * (w, 0) q)
    goal_pose_cm = state.goal_pose_cm
    if static.goal_rotation_active:
        h = static.dt * static.control_decimation
        q = tuple(goal_pose_cm[3 + i] for i in range(4))
        w = tuple(state.goal_angvel_cm[i] for i in range(3))
        dq = _qmul_c(w + (torch.zeros_like(w[0]),), q)
        nq = [q[i] + 0.5 * h * dq[i] for i in range(4)]
        inv = torch.rsqrt(nq[0] ** 2 + nq[1] ** 2 + nq[2] ** 2 + nq[3] ** 2)
        goal_pose_cm = torch.cat([goal_pose_cm[0:3], torch.stack([c * inv for c in nq])])
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

    # float before the product: an integer one overflows past 2.1 B env steps
    env_steps_count = frames.to(torch.float32) * static.envs_counted
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
        state.goal_reset_buf, state.successes, info, env_steps_count,
        params.curriculum_level,
    )

    steps_count = state.steps_count + 1
    reset_buf = state.reset_buf
    if static.episode_length:
        reset_buf = reset_buf | (steps_count >= static.episode_length)
    if static.dones_mode == "and":
        dones = reset_buf & goal_reset_buf
    else:
        dones = reset_buf | goal_reset_buf

    obs_raw = _assemble_obs_raw(static, state.scene, physics, obj_pos, obj_quat, goal_pos,
                                goal_quat, action_buf)
    obs = _observe(static, params, obs_raw, obs_noise)
    states =_fill_states(static, params, obs_raw, obj_linvel, obj_angvel, tips, tau,
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
    # PhysicsState.default's values, written on the device (no host copy,
    # so that a captured reset holds them)
    cube_pos, cube_quat, goal_pose_cm = zeros(n, 3), zeros(n, 4), zeros(7, n)
    cube_pos[:, 2].fill_(float(np.float32(tf_model.CUBE_SIZE / 2)))
    cube_quat[:, 3].fill_(1.0)
    goal_pose_cm[6].fill_(1.0)  # identity quaternion
    physics = PhysicsState(q=params.dof_default_pos.expand(n, 9).clone(), qd=zeros(n, 9),
                           cube_pos=cube_pos, cube_quat=cube_quat, cube_linvel=zeros(n, 3),
                           cube_angvel=zeros(n, 3))
    return EnvState(
        physics=physics,
        scene=params.scene_base.broadcast(n),
        pd_scale=torch.ones((n, 2), device=device, dtype=dtype),
        goal_pose_cm=goal_pose_cm,
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
        frames=torch.zeros((), dtype=torch.int32, device=device),
    )


def env_reset(static: EnvStatic, params: EnvParams, u: torch.Tensor, norm=None,
              dr_blocks=None, obs_noise=None):
    """Full reset of all envs from the draws (``draw_init_randoms``' layout:
    u (n, 25), norm, DR blocks, observation noise): reset, a zero-action
    torque, ONE physics call, observations."""
    n = static.num_envs
    device = u.device
    state = initial_state(static, params)
    state = _masked_full_reset(
        static, params, state, torch.ones(n, dtype=torch.bool, device=device), u, norm,
        dr_blocks,
    )
    tau = compute_torque(static, params, state.action_buf, state.physics.q,
                         state.physics.qd, state.pd_scale)
    physics, tip_wrench6 = _simulate(static, state.physics, tau, state.scene, 1)

    tips = _fingertip_components(physics)
    obj_pos, obj_quat, _, _ = _object_components(physics)
    goal_pos = tuple(state.goal_pose_cm[i] for i in range(3))
    goal_quat = tuple(state.goal_pose_cm[i] for i in range(3, 7))
    obs_raw = _assemble_obs_raw(static, state.scene, physics, obj_pos, obj_quat, goal_pos,
                                goal_quat, state.action_buf)
    obs = _observe(static, params, obs_raw, obs_noise)
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
    ``step(action)``, ``get_state()``, ``render()``, buffer properties) on a
    torch ``device``: ``cuda:0`` unless the caller passes another
    (``device="cpu"`` on the CPU); asking for CUDA without a card is an
    error. ``visualize`` opens the live viewer on ``render()``.

    With a ``shard`` (``parallel.DataShard``) the env is this rank's part of
    a data-parallel run: ``config["num_instances"]`` is the global count,
    the env steps the shard's ``n_local`` envs, its draws are the global
    blocks' rows of the shard, and the env-step counters count every
    rank's envs.

    On a CUDA device ``reset`` and ``step`` replay captured ``env_reset`` /
    ``env_step`` graphs (``ops/capture.py`` ``Captured``, captured again for
    new ``params`` or inputs of another layout), the counterpart of the
    reference's ``jax.jit(env_step)`` / ``jax.jit(env_reset)``; both write
    the env's one state in place. On the CPU they run eagerly. Either way
    they return tensors of their own, and ``state`` a copy of the env
    state."""

    def __init__(self, config: Optional[dict] = None, device="cuda:0",
                 verbose: bool = True, visualize: bool = False, dtype=torch.float32,
                 shard=None):
        device = resolve_device(device)
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
        self.static = build_static(merged, device)
        self.shard = shard
        if shard is not None:
            if shard.n_global != self.static.num_envs:
                raise ValueError(f"shard of {shard.n_global} envs for num_instances "
                                 f"{self.static.num_envs}")
            self.static = dataclasses.replace(self.static, num_envs=shard.n_local,
                                              num_envs_global=shard.n_global)
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
        if self.static.use_keypoint_obs:
            obs_spec.update(object_keypoints=24, goal_keypoints=24)
        action_spec = {"command": self.static.action_dim}
        state_spec = {
            **obs_spec, "object_u": 6, "fingertip_state": 39, "robot_a": 9,
            "fingertip_wrench": 18,
        } if self.static.asymmetric_obs else {}
        EnvBase.__init__(self, obs_spec, action_spec, state_spec, merged,
                         device=device, verbose=False, visualize=visualize)
        self.num_instances = self.static.num_envs
        self.verbose = verbose
        self._graphs = None
        if self.device.type == "cuda":
            self._graphs = {name: Captured(body, self.device, lambda: (self.params,))
                            for name, body in (("reset", self._reset_body),
                                               ("step", self._step_body))}
        if verbose:
            print_info(
                f"TrifingerEnv[torch {self.device}]: N={self.static.num_envs} "
                f"difficulty={self.static.task_difficulty} "
                f"obs={self.static.obs_dim} states={self.static.state_dim} "
                f"actions={self.static.action_dim}"
            )

    def reset(self, draws=None):
        """Full reset; ``draws`` (``draw_init_randoms``' layout) are drawn from
        the env's generator unless given."""
        if draws is None:
            draws = self._draw(draw_init_randoms)
        if self._graphs is not None:
            (obs,) = self._graphs["reset"](tuple(draws))
        else:
            self._state, obs = env_reset(self.static, self.params, *draws)
        self._last = (obs, None, None, None, {})
        return obs

    def step(self, action, draws=None):
        """One step; ``draws`` (``draw_step_randoms``' layout) are drawn from
        the env's generator unless given."""
        expected = (self.static.num_envs, self.static.action_dim)
        if tuple(action.shape) != expected:
            raise ValueError(
                f"Invalid shape for tensor `action`. Input: {tuple(action.shape)}"
                f" != {expected}."
            )
        if draws is None:
            draws = self._draw(draw_step_randoms)
        if self._graphs is not None:
            if self._state is None:
                raise RuntimeError("step() before reset()")
            obs, states, reward, dones, info = self._graphs["step"](action, tuple(draws))
        else:
            self._state, obs, states, reward, dones, info = env_step(
                self.static, self.params, self._state, action, draws
            )
        self._last = (obs, states, reward, dones, info)
        return obs, reward, dones, info

    def _reset_body(self, draws):
        state, obs = env_reset(self.static, self.params, *draws)
        if self._state is None:
            self._state = clone_state(state)
        else:
            copy_state_(self._state, state)
        return (obs,)

    def _step_body(self, action, draws):
        new_state, *outs = env_step(self.static, self.params, self._state, action, draws)
        copy_state_(self._state, new_state)
        return tuple(outs)

    @property
    def state(self):
        """The full functional EnvState; a copy where graphs step the env's
        own state tensors in place."""
        if self._graphs is not None and self._state is not None:
            return clone_state(self._state)
        return self._state

    def _draw(self, draw):
        """``draw``'s blocks from the env's generator: the global blocks'
        rows of the shard under one, else this env's own."""
        st = self.static
        return shard_batch(draw(st, self.generator, st.envs_counted, self.device, self.dtype),
                           self.shard)

    def get_state(self):
        return self._last[1]
