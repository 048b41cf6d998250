"""Env configurations for the tests of the MDP tail kernel
(``csrc/physics_step.cu`` ``mdp_tail_kernel``): its host build in float64
(tests/test_torch_kernel_host.py) and the card (tests/test_torch_cuda.py).
Imports no JAX."""

import copy
import dataclasses

import torch

from leibnizgym_tpu_torch.config.presets import GYM_PRESETS
from leibnizgym_tpu_torch.envs.trifinger import env as tenv
from leibnizgym_tpu_torch.utils.helpers import update_dict

# every term active, keypoints in the observation without normalization,
# observation noise, no asymmetric states, termination off, dones "or", a
# frame-ramped tolerance; the schedules are placed around the step's count
# by SCHEDULES
_ALL_TERMS = {
    "finger_reach_object_rate": {"activate": True, "weight": -750.0},
    "finger_move_penalty": {"activate": True, "weight": -0.1},
    "object_dist": {"activate": True, "weight": 2000.0},
    "object_rot": {"activate": True, "weight": 300.0, "scale": 3.0},
    "object_rot_delta": {"activate": True, "weight": -250.0},
    "object_move": {"activate": True, "weight": -750.0},
    "keypoint_dist": {"activate": True, "weight": 2000.0, "scale": 1.0},
}
BRANCHES = {
    "use_keypoint_obs": True, "normalize_obs": False, "obs_noise_std": 0.02,
    "asymmetric_obs": False, "dones_mode": "or", "reward_terms": _ALL_TERMS,
    "termination_conditions": {"success": {
        "activate": False, "position_tolerance_init": 0.08, "orientation_tolerance_init": 1.2,
        "tolerance_anneal_frames": 1.0}},
}
_TERMINATING = {"termination_conditions": {"success": {"activate": True}}}
# case -> (preset, config changes, curriculum level, norm_p and schedules
# (None: the preset's), final tolerances pinned to row 3's distances)
TAIL_CASES = {
    "d1": ("trifinger_difficulty_1", {}, None, None, False),
    "d1_at_tolerance": ("trifinger_difficulty_1", _TERMINATING, None, None, True),
    "d5_at_tolerance": ("trifinger_difficulty_1", dict(_TERMINATING, task_difficulty=5), None,
                        None, True),
    "d4_dr": ("trifinger_difficulty_4_curriculum_dr", {}, 0.3, None, False),
    "d4_dr_at_tolerance": ("trifinger_difficulty_4_curriculum_dr", {}, 0.3, None, True),
    "d4_rotating": ("trifinger_difficulty_4_curriculum_rotating", {}, 0.7, None, False),
    # the keypoint reward without keypoint observations; 18 action columns
    "d4_keypoints": ("trifinger_difficulty_4_keypoints", {}, None, None, False),
    "d1_impedance": ("trifinger_difficulty_1", {"command_mode": "position_impedance"}, None,
                     None, False),
    "branches_p1_inside": ("trifinger_difficulty_1", BRANCHES, None, (1, "inside"), False),
    "branches_p3_inside": ("trifinger_difficulty_1", BRANCHES, None, (3, "inside"), False),
    "branches_p1_before": ("trifinger_difficulty_1", BRANCHES, None, (1, "before"), False),
    "branches_p3_after": ("trifinger_difficulty_1", BRANCHES, None, (3, "after"), False),
}
# (window start, end, linear start, end) around the step's count s: inside
# the window and a quarter up the ramp, the window and ramp still ahead, or
# both behind
SCHEDULES = {
    "inside": lambda s: (s - 100.0, s + 100.0, s - 50.0, s + 150.0),
    "before": lambda s: (s + 1.0, s + 100.0, s + 1.0, s + 100.0),
    "after": lambda s: (s - 100.0, s - 1.0, s - 100.0, s - 1.0),
}
_WINDOWED = ("finger_reach_object_rate", "object_dist", "object_rot", "keypoint_dist")


def tail_env(preset: str, changes: dict, level, n: int, device, dtype=torch.float32,
             solver=(2, 2)):
    """The preset with ``changes`` at ``n`` envs, asymmetric states unless
    the changes turn them off, a 15-step episode, ``solver`` (substeps,
    solver iterations), the success-gated ``level`` where given."""
    cfg = copy.deepcopy(GYM_PRESETS[preset])
    cfg.pop("rlg_overrides", None)
    cfg.update(num_instances=n, asymmetric_obs=True, episode_length=15)
    update_dict(cfg, copy.deepcopy(changes))
    cfg["sim"]["substeps"], cfg["sim"]["physx"]["num_position_iterations"] = solver
    env = tenv.TrifingerEnv(config=cfg, device=device, dtype=dtype, verbose=False)
    if level is not None:
        env.params = env.params.with_curriculum_level(level)
    return env


def with_schedules(static, frames: int, norm_p: int, where: str):
    """``static`` with every term's norm_p and schedules placed by
    SCHEDULES[where] around the env-step count of the step from ``frames``,
    and the tolerance ramp half way."""
    step = float((frames + static.control_decimation) * static.envs_counted)
    w0, w1, l0, l1 = SCHEDULES[where](step)
    specs = []
    for spec in static.reward_specs:
        if spec.name in _WINDOWED:
            spec = dataclasses.replace(spec, sched_start=w0, sched_end=w1)
        elif spec.name == "object_rot_delta":
            spec = dataclasses.replace(spec, sched_start=l0, sched_end=l1)
        specs.append(dataclasses.replace(spec, norm_p=norm_p))
    return dataclasses.replace(static, reward_specs=tuple(specs),
                               tolerance_anneal_frames=2.0 * step)


def step_inputs(env, seed: int, steps: int = 6):
    """A state after ``steps`` seeded random steps, with rows 1 and 7
    flagged for a full reset, 2, 7 and 11 for a goal reset, 3 and 4 one step
    from the episode's end and 2 and 5 holding successes; the next step's
    action and draws."""
    st, dev, dtype = env.static, env.device, env.dtype
    n = st.num_envs
    gen = torch.Generator(device=dev).manual_seed(seed)
    env.reset(tenv.draw_init_randoms(st, gen, n, dev, dtype))
    for _ in range(steps):
        action = torch.rand((n, st.action_dim), generator=gen, device=dev, dtype=dtype)
        env.step(action * 2.0 - 1.0, tenv.draw_step_randoms(st, gen, n, dev, dtype))
    state = env.state
    state.reset_buf[[1, 7]] = True
    state.goal_reset_buf[[2, 7, 11]] = True
    state.steps_count[[3, 4]] = st.episode_length - 1
    state.successes[[2, 5]] = 3
    action = torch.rand((n, st.action_dim), generator=gen, device=dev, dtype=dtype) * 2 - 1
    return state, action, tenv.draw_step_randoms(st, gen, n, dev, dtype)
