"""Reward terms for the TriFinger task (counterpart of
``leibnizgym_tpu/envs/trifinger/rewards.py``).

``compute_rewards_c`` (what the env calls) takes (N,) component columns;
each term is a pure function of those plus a frozen spec (weight,
activation, schedule).
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch



@dataclasses.dataclass(frozen=True)
class RewardTermSpec:
    """Static configuration of one reward term."""

    name: str
    activate: bool
    weight: float
    norm_p: int = 2
    epsilon: float = 0.1
    scale: float = 1.0
    sched_start: float = 0.0
    sched_end: float = 0.0

    @property
    def sched_enabled(self) -> bool:
        return self.sched_start != self.sched_end

    @classmethod
    def from_config(cls, name: str, conf: dict) -> "RewardTermSpec":
        return cls(
            name=name,
            activate=bool(conf.get("activate", False)),
            weight=float(conf.get("weight", 0.0)),
            norm_p=int(conf.get("norm_p", 2)),
            epsilon=float(conf.get("epsilon", 0.1)),
            scale=float(conf.get("scale", 1.0)),
            sched_start=float(
                conf.get("thresh_sched_start", conf.get("linear_schedule_start", 0.0))
            ),
            sched_end=float(
                conf.get("thresh_sched_end", conf.get("linear_schedule_end", 0.0))
            ),
        )


# aggregation order of the terms
REWARD_TERM_NAMES = (
    "finger_reach_object_rate",
    "finger_move_penalty",
    "object_dist",
    "object_rot",
    "object_rot_delta",
    "object_move",
    "keypoint_dist",
)


def build_reward_specs(reward_config: Dict[str, dict]) -> Dict[str, RewardTermSpec]:
    """All specs from the env's ``reward_terms`` section; missing terms are
    created inactive."""
    return {
        name: RewardTermSpec.from_config(
            name, reward_config.get(name, {"activate": False})
        )
        for name in REWARD_TERM_NAMES
    }


def lgsk_kernel(x: torch.Tensor, scale: float = 50.0) -> torch.Tensor:
    """Logistic kernel bounding input to (0, 0.25]."""
    scaled = x * scale
    return 1.0 / (torch.exp(scaled) + 2.0 + torch.exp(-scaled))


def _window_sched(spec: RewardTermSpec, step: torch.Tensor):
    """Indicator of ``step`` in [sched_start, sched_end] (1.0 if disabled)."""
    if not spec.sched_enabled:
        return torch.ones_like(step)
    inside = (step >= spec.sched_start) & (step <= spec.sched_end)
    return inside.to(torch.float32)


def _linear_sched(spec: RewardTermSpec, step: torch.Tensor):
    """Linear ramp of ``step`` across [sched_start, sched_end] (1.0 if disabled)."""
    if not spec.sched_enabled:
        return torch.ones_like(step)
    val = (step - spec.sched_start) / (spec.sched_end - spec.sched_start)
    return torch.clamp(val, 0.0, 1.0)


_KP_SIGNS = np.array(
    [[sx, sy, sz] for sx in (-1.0, 1.0) for sy in (-1.0, 1.0) for sz in (-1.0, 1.0)]
)


def _qmul_c(a, b):
    """Hamilton product on (x, y, z, w) component 4-tuples."""
    x1, y1, z1, w1 = a
    x2, y2, z2, w2 = b
    return (
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
    )


def quat_diff_rad_c(qa, qb):
    """2 * asin(min(|vec(qa * conj(qb))|, 1)) on component tuples."""
    bx, by, bz, bw = qb
    mx, my, mz, _ = _qmul_c(qa, (-bx, -by, -bz, bw))
    vec_norm = torch.sqrt(mx * mx + my * my + mz * mz)
    return 2.0 * torch.asin(torch.clamp(vec_norm, max=1.0))


def quat_rotate_c(q, v):
    """Rotate component vec3 ``v`` by component quaternion ``q``."""
    qx, qy, qz, qw = q
    vx, vy, vz = v
    tx = 2.0 * (qy * vz - qz * vy)
    ty = 2.0 * (qz * vx - qx * vz)
    tz = 2.0 * (qx * vy - qy * vx)
    return (
        vx + qw * tx + (qy * tz - qz * ty),
        vy + qw * ty + (qz * tx - qx * tz),
        vz + qw * tz + (qx * ty - qy * tx),
    )


def _dist3_c(a, b):
    dx, dy, dz = a[0] - b[0], a[1] - b[1], a[2] - b[2]
    return torch.sqrt(dx * dx + dy * dy + dz * dz)


def _norm_p_c(dx, dy, dz, p: int):
    if p == 2:
        return torch.sqrt(dx * dx + dy * dy + dz * dz)
    ax, ay, az = torch.abs(dx), torch.abs(dy), torch.abs(dz)
    if p == 1:
        return ax + ay + az
    s = ax ** p + ay ** p + az ** p
    return s ** (1.0 / p)


def compute_rewards_c(
    specs: Dict[str, RewardTermSpec],
    dt: float,
    env_steps_count: torch.Tensor,
    tip_pos,            # 3-tuple of vec3 component tuples of (N,)
    tip_pos_prev,       # 3-tuple of vec3 component tuples of (N,)
    obj_pos, obj_quat,  # vec3 / quat4 component tuples
    obj_pos_prev, obj_quat_prev,
    goal_pos, goal_quat,
    half_extents=None,  # vec3 component tuple (per-env half extents)
):
    """Total reward and the active terms' values (reference order)."""
    step = env_steps_count.to(torch.float32)
    values = {}

    spec = specs["finger_reach_object_rate"]
    sched = _window_sched(spec, step)
    total_rate = 0.0
    for f in range(3):
        curr = _norm_p_c(
            tip_pos[f][0] - obj_pos[0], tip_pos[f][1] - obj_pos[1],
            tip_pos[f][2] - obj_pos[2], spec.norm_p,
        )
        prev = _norm_p_c(
            tip_pos_prev[f][0] - obj_pos_prev[0],
            tip_pos_prev[f][1] - obj_pos_prev[1],
            tip_pos_prev[f][2] - obj_pos_prev[2], spec.norm_p,
        )
        total_rate = total_rate + (curr - prev)
    values["finger_reach_object_rate"] = spec.weight * sched * total_rate

    spec = specs["finger_move_penalty"]
    sq = 0.0
    for f in range(3):
        for c in range(3):
            v = (tip_pos[f][c] - tip_pos_prev[f][c]) / dt
            sq = sq + v * v
    values["finger_move_penalty"] = spec.weight * sq

    spec = specs["object_dist"]
    dist = _dist3_c(obj_pos, goal_pos)
    values["object_dist"] = (
        spec.weight * dt * _window_sched(spec, step) * lgsk_kernel(dist)
    )

    spec = specs["object_rot"]
    angles = quat_diff_rad_c(obj_quat, goal_quat)
    values["object_rot"] = spec.weight * (
        _window_sched(spec, step) * dt / (spec.scale * torch.abs(angles) + spec.scale)
    )

    spec = specs["object_rot_delta"]
    last_angles = torch.abs(quat_diff_rad_c(obj_quat_prev, goal_quat))
    values["object_rot_delta"] = spec.weight * _linear_sched(spec, step) * (
        torch.abs(angles) - last_angles
    )

    spec = specs["object_move"]
    values["object_move"] = spec.weight * (dist - _dist3_c(obj_pos_prev, goal_pos))

    spec = specs["keypoint_dist"]
    if spec.activate:
        if half_extents is None:
            raise ValueError("keypoint_dist reward requires half_extents")
        kernel_scale = spec.scale if spec.scale != 1.0 else 30.0
        acc = 0.0
        for sx in (-1.0, 1.0):
            for sy in (-1.0, 1.0):
                for sz in (-1.0, 1.0):
                    local = (
                        sx * half_extents[0],
                        sy * half_extents[1],
                        sz * half_extents[2],
                    )
                    oc = quat_rotate_c(obj_quat, local)
                    gc = quat_rotate_c(goal_quat, local)
                    d = torch.sqrt(
                        (obj_pos[0] + oc[0] - goal_pos[0] - gc[0]) ** 2
                        + (obj_pos[1] + oc[1] - goal_pos[1] - gc[1]) ** 2
                        + (obj_pos[2] + oc[2] - goal_pos[2] - gc[2]) ** 2
                    )
                    acc = acc + lgsk_kernel(d, scale=kernel_scale)
        values["keypoint_dist"] = (
            spec.weight * dt * _window_sched(spec, step) * (acc / 8.0)
        )
    else:
        values["keypoint_dist"] = torch.zeros_like(values["object_dist"])

    total = torch.zeros_like(values["object_dist"])
    active_values = {}
    for name in REWARD_TERM_NAMES:
        if specs[name].activate:
            total = total + values[name]
            active_values[name] = values[name]
    return total, active_values
