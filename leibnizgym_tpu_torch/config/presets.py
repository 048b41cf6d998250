"""Config presets + CLI override parsing (the Hydra-equivalent layer).

Mirrors the reference's structured configs exactly:
- gym presets = scripts/rlg_hydra.py:58-182 (Trifinger base + Difficulty1-4;
  note these differ from TRIFINGER_DEFAULT_CONFIG_DICT: command_mode torque,
  termination success deactivated, rot/move rewards off except Difficulty4)
- rlg agent config = resources/config/rlg/asymm.yaml
- Args = rlg_hydra.py:195-232
- update_cfg cross-propagation = rlg_hydra.py:251-286

Hydra itself is not a dependency: `parse_cli` implements the same
``group=preset`` and ``a.b.c=value`` dot-override surface on plain dicts.

The port's own copy of the JAX package's ``leibnizgym_tpu/config/presets.py``;
``tests/test_torch_copies.py`` holds ``GYM_PRESETS`` and ``default_config()``
deep-equal to the JAX package's.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, List

import yaml

# ---------------------------------------------------------------------------
# gym group (environment) presets
# ---------------------------------------------------------------------------

_TRIFINGER_BASE: Dict[str, Any] = {
    "env_name": "Trifinger",
    "episode_length": 750,
    "task_difficulty": 1,
    "enable_ft_sensors": False,
    "asymmetric_obs": False,
    "normalize_obs": True,
    "apply_safety_damping": True,
    "command_mode": "torque",
    "normalize_action": True,
    "spacing": 1.0,
    "aggregate_mode": True,
    "control_decimation": 1,
    "physics_engine": "tpu",
    "sim": {
        "dt": 0.02,
        "substeps": 4,
        "up_axis": "z",
        "gravity": [0.0, 0.0, -9.81],
        "physx": {
            "num_threads": 4,
            "solver_type": 1,
            "num_position_iterations": 8,
            "num_velocity_iterations": 0,
            "contact_offset": 0.002,
            "rest_offset": 0.0,
            "bounce_threshold_velocity": 0.5,
            "max_depenetration_velocity": 1000.0,
        },
    },
    "reset_distribution": {
        "object_initial_state": {"type": "random"},
        "robot_initial_state": {
            "dof_pos_stddev": 0.4,
            "dof_vel_stddev": 0.2,
            "type": "default",
        },
    },
    "reward_terms": {
        "finger_move_penalty": {"activate": True, "weight": -0.1},
        "finger_reach_object_rate": {"activate": True, "norm_p": 2, "weight": -750},
        "object_dist": {"activate": True, "weight": 2000},
        "object_rot": {"activate": False, "weight": 300},
        "object_rot_delta": {"activate": False, "weight": -250},
        "object_move": {"activate": False, "weight": -750},
    },
    "termination_conditions": {
        "success": {
            "activate": False,
            "bonus": 5000.0,
            "orientation_tolerance": 0.1,
            "position_tolerance": 0.01,
        }
    },
}


def _difficulty(n: int, extra: Dict[str, Any] | None = None) -> Dict[str, Any]:
    cfg = copy.deepcopy(_TRIFINGER_BASE)
    cfg["task_difficulty"] = n
    if extra:
        from leibnizgym_tpu_torch.utils.helpers import update_dict

        update_dict(cfg, extra)
    return cfg


# Difficulty-4 preset overrides (rlg_hydra.py:136-182)
_D4_EXTRA = {
    "reward_terms": {
        "finger_move_penalty": {"activate": True, "weight": -0.1},
        "finger_reach_object_rate": {
            "activate": True, "norm_p": 2, "weight": -250,
            "thresh_sched_start": 0, "thresh_sched_end": 1e7,
        },
        "object_dist": {
            "activate": True, "weight": 2000,
            "thresh_sched_start": 0, "thresh_sched_end": 10e10,
        },
        "object_rot": {
            "activate": True, "weight": 2000, "epsilon": 0.01, "scale": 3.0,
            "thresh_sched_start": 1e7, "thresh_sched_end": 1e10,
        },
        "object_rot_delta": {"activate": False, "weight": -250},
        "object_move": {"activate": False, "weight": -750},
    },
    "termination_conditions": {
        "success": {
            "activate": False, "bonus": 5000.0,
            "orientation_tolerance": 0.25, "position_tolerance": 0.02,
        }
    },
}

# TPU-build extension: difficulty 4 with the keypoint reward replacing the
# separate pos/rot terms (the literature's fix for 6-DoF reposing; the
# reference's own D4 preset is annotated as experimental)
_D4_KP_EXTRA = {
    "reward_terms": {
        "finger_move_penalty": {"activate": True, "weight": -0.1},
        "finger_reach_object_rate": {
            "activate": True, "norm_p": 2, "weight": -250,
            "thresh_sched_start": 0, "thresh_sched_end": 5e7,
        },
        "object_dist": {"activate": False, "weight": 2000},
        "object_rot": {"activate": False, "weight": 2000},
        "object_rot_delta": {"activate": False, "weight": -250},
        "object_move": {"activate": False, "weight": -750},
        "keypoint_dist": {"activate": True, "weight": 2000, "scale": 30.0},
    },
    "termination_conditions": {
        "success": {
            "activate": False, "bonus": 5000.0,
            "orientation_tolerance": 0.25, "position_tolerance": 0.02,
        }
    },
}

# TPU-build extension: the 6-DoF curriculum recipe (round-1 negative results
# showed fixed tight tolerances never fire the joint pos+ori bonus, so no
# orientation gradient forms). Keypoint obs + keypoint reward + success bonus
# with tolerances annealed loose -> tight over the first 2B env-steps.
_D4_CURRICULUM_EXTRA = {
    "use_keypoint_obs": True,
    "reward_terms": {
        "finger_move_penalty": {"activate": True, "weight": -0.1},
        "finger_reach_object_rate": {
            "activate": True, "norm_p": 2, "weight": -250,
            "thresh_sched_start": 0, "thresh_sched_end": 5e7,
        },
        "object_dist": {"activate": False, "weight": 2000},
        "object_rot": {"activate": False, "weight": 2000},
        "object_rot_delta": {"activate": False, "weight": -250},
        "object_move": {"activate": False, "weight": -750},
        "keypoint_dist": {"activate": True, "weight": 2000, "scale": 30.0},
    },
    "termination_conditions": {
        "success": {
            "activate": True, "bonus": 5000.0,
            "position_tolerance": 0.02, "orientation_tolerance": 0.25,
            "position_tolerance_init": 0.05, "orientation_tolerance_init": 0.8,
        }
    },
    # SUCCESS-GATED difficulty (round-2 v2): one level scalar drives both the
    # goal-orientation difficulty (swing 0.2 -> 1.0) and the success
    # tolerances (5 cm/0.8 rad -> 2 cm/0.25 rad). A host controller raises
    # the level only while measured successes-per-episode stay above
    # up_threshold and retreats when they collapse — the frame-based ramp
    # this replaces outpaced learning and drove success to zero (RESULTS.md)
    "goal_curriculum": {
        "orientation_difficulty_init": 0.2,
        "success_gated": True,
        "up_threshold": 0.5,
        "down_threshold": 0.1,
        "up_step": 0.005,
        "down_step": 0.02,
        "window_samples": 4,
    },
    # agent-side half of the recipe (applied to rlg.params.config when this
    # gym preset is selected): sigma floor ~0.2 against premature entropy
    # collapse, and a doubled KL target — the +5000 success bonus fires from
    # the start here (easy yaw-only goals, loose tolerances), inflating
    # per-minibatch KL and pinning the adaptive LR at min_lr otherwise
    "rlg_overrides": {"log_std_min": -1.6, "lr_threshold": 0.016},
}

# TPU-build extension: difficulty 3 with full domain randomization + obs
# noise — the sim-to-real recipe the reference left as comments
# (trifinger_env.py:385-392). The RESULTS.md round-2 DR run used these
# ranges via CLI overrides; this preset formalizes them.
_D3_DR_EXTRA = {
    "obs_noise_std": 0.01,
    "domain_randomization": {
        "activate": True,
        "cube_mass_scale": [0.8, 1.2],
        "cube_size_scale": [0.97, 1.03],
        "link_mass_scale": [0.9, 1.1],
        "friction_scale": [0.7, 1.3],
        "restitution_range": [0.0, 0.8],
        "pd_gain_scale": [0.9, 1.1],
    },
}

def _merged(*extras: Dict[str, Any]) -> Dict[str, Any]:
    from leibnizgym_tpu_torch.utils.helpers import update_dict

    out: Dict[str, Any] = {}
    for e in extras:
        update_dict(out, copy.deepcopy(e))
    return out


GYM_PRESETS: Dict[str, Dict[str, Any]] = {
    "trifinger_difficulty_1": _difficulty(1),
    "trifinger_difficulty_2": _difficulty(2),
    "trifinger_difficulty_3": _difficulty(3),
    "trifinger_difficulty_3_dr": _difficulty(3, _D3_DR_EXTRA),
    "trifinger_difficulty_4": _difficulty(4, _D4_EXTRA),
    "trifinger_difficulty_4_keypoints": _difficulty(4, _D4_KP_EXTRA),
    "trifinger_difficulty_4_curriculum": _difficulty(4, _D4_CURRICULUM_EXTRA),
    # sim-to-real grade: the 6-DoF curriculum under full physics
    # randomization (the combination the TriFinger paper trains for
    # transfer; the reference repo itself never implemented DR)
    "trifinger_difficulty_4_curriculum_dr": _difficulty(
        4, _merged(_D4_CURRICULUM_EXTRA, {
            "domain_randomization": _D3_DR_EXTRA["domain_randomization"],
        })
    ),
    # moving-goal task: the 6-DoF curriculum with goal_movement.rotation
    # active at the reference's default rate (trifinger_env.py:69-74,
    # rate_magnitude=0.5 = stdev of the goal's angular velocity; integrated
    # per step as in __update_goal_movement_pre, :1267-1284). The reference
    # ships this config surface but never trained it.
    "trifinger_difficulty_4_curriculum_rotating": _difficulty(
        4, _merged(_D4_CURRICULUM_EXTRA, {
            "goal_movement": {
                "rotation": {"activate": True, "rate_magnitude": 0.5},
            },
        })
    ),
    # RRC phase-3 cuboid object (reference asset
    # objects/urdf/cube_multicolor_rrc_phase3.urdf: 2x8x2 cm box,
    # density 500) on the difficulty-1 task — exercises the per-axis
    # object_size path (env.py cuboid support)
    "trifinger_difficulty_1_phase3": _difficulty(1, {
        "object_type": "cube",
        "object_size": [0.02, 0.08, 0.02],
        "object_density": 500.0,
    }),
}

# ---------------------------------------------------------------------------
# rlg group (agent) presets
# ---------------------------------------------------------------------------


def rlg_asymm_config() -> Dict[str, Any]:
    """The asymm.yaml agent config as a dict."""
    return {
        "asymmetric_obs": True,
        "params": {
            "algo": {"name": "a2c_continuous"},
            "model": {"name": "continuous_a2c_logstd"},
            "network": {
                "separate": True,
                "name": "actor_critic",
                "space": {
                    "continuous": {
                        "mu_activation": "None",
                        "sigma_activation": "None",
                        "mu_init": {"name": "variance_scaling_initializer", "scale": 0.02},
                        "sigma_init": {"name": "const_initializer", "val": 0},
                        "fixed_sigma": True,
                    }
                },
                "mlp": {
                    "units": [400, 200, 100],
                    "activation": "elu",
                    "d2rl": False,
                    "initializer": {"name": "default", "scale": 2},
                    "regularizer": {"name": "None"},
                },
            },
            "load_checkpoint": False,
            "load_path": "nn/weights",
            "config": {
                "name": "trifinger",
                "env_name": "rlgpu",
                "ppo": True,
                "normalize_input": False,
                "reward_shaper": {"scale_value": 0.01},
                "normalize_advantage": True,
                "gamma": 0.99,
                "tau": 0.95,
                "learning_rate": 3e-4,
                "lr_schedule": "adaptive",
                "lr_threshold": 0.008,
                "score_to_win": 1000000,
                "max_epochs": 100000,
                "save_best_after": 500,
                "save_frequency": 100,
                "print_stats": True,
                "grad_norm": 1.0,
                "entropy_coef": 0.0,
                "truncate_grads": True,
                "e_clip": 0.2,
                "steps_num": 32,
                "minibatch_size": 8192,
                "mini_epochs": 4,
                "critic_coef": 4,
                "clip_value": False,
                "seq_len": 4,
                "bounds_loss_coef": 0.0001,
                "central_value_config": {
                    "seq_length": 4,
                    "minibatch_size": 8192,
                    "mini_epochs": 4,
                    "lr": 5e-4,
                    "clip_value": False,
                    "normalize_input": False,
                    "grad_norm": 1.0,
                    "truncate_grads": True,
                    "network": {
                        "name": "actor_critic",
                        "central_value": True,
                        "mlp": {
                            "units": [400, 200, 100],
                            "activation": "elu",
                            "d2rl": False,
                            "initializer": {
                                "name": "variance_scaling_initializer",
                                "scale": 2,
                            },
                            "regularizer": {"name": "None"},
                        },
                    },
                },
            },
        },
    }


def rlg_vanilla_config() -> Dict[str, Any]:
    """Symmetric (non-central-value) PPO variant — the 'vanilla' training
    type referenced by the README's training curves."""
    cfg = rlg_asymm_config()
    cfg["asymmetric_obs"] = False
    del cfg["params"]["config"]["central_value_config"]
    return cfg


RLG_PRESETS = {
    "asymm": rlg_asymm_config,
    "vanilla": rlg_vanilla_config,
}

# ---------------------------------------------------------------------------
# args group (rlg_hydra.py:195-232)
# ---------------------------------------------------------------------------


def default_args() -> Dict[str, Any]:
    return {
        "task": "Trifinger",
        "task_type": "Python",
        "experiment_name": "Base",
        "num_envs": 256,
        "randomize": False,
        "seed": 7,
        "verbose": False,
        "logdir": "logs/",
        "physics_engine": "tpu",
        "device": "TPU",
        "ppo_device": "TPU",
        "play": False,
        "train": True,
        "checkpoint": "",
        "headless": True,
        "wandb_project_name": "trifinger-manip",
        "wandb_log": False,
        "max_epochs": None,  # TPU-build extra: cap epochs from the CLI
        "play_steps": 1000,
        # multi-host: initialize jax.distributed before device use (pod
        # slices; auto-detected rendezvous unless coordinator given)
        "watchdog_timeout": None,  # seconds; exit(42) on stall for supervisor
        "multihost": False,
        "coordinator_address": None,
        "num_processes": None,
        "process_id": None,
    }


def default_config() -> Dict[str, Any]:
    return {
        "gym": copy.deepcopy(GYM_PRESETS["trifinger_difficulty_1"]),
        "rlg": rlg_asymm_config(),
        "args": default_args(),
        "output_root": "./output",
    }


# ---------------------------------------------------------------------------
# CLI parsing: `group=preset` and dotted overrides, Hydra-style
# ---------------------------------------------------------------------------


def _set_dotted(cfg: dict, dotted: str, value: Any):
    keys = dotted.split(".")
    node = cfg
    for k in keys[:-1]:
        if k not in node or not isinstance(node[k], dict):
            node[k] = {}
        node = node[k]
    node[keys[-1]] = value


def parse_cli(argv: List[str]) -> Dict[str, Any]:
    """Parse Hydra-style overrides into a full config dict."""
    cfg = default_config()
    for arg in argv:
        if "=" not in arg:
            raise ValueError(f"Expected key=value override, got: {arg!r}")
        key, raw = arg.split("=", 1)
        value = yaml.safe_load(raw)
        if key == "gym":
            if value not in GYM_PRESETS:
                raise ValueError(
                    f"Unknown gym preset {value!r}; options: {sorted(GYM_PRESETS)}"
                )
            cfg["gym"] = copy.deepcopy(GYM_PRESETS[value])
            # a gym preset may carry agent-side settings its recipe depends
            # on (e.g. the D4 curriculum's sigma floor / KL target); applied
            # here so later rlg.* dot-overrides on the CLI still win
            for k, v in cfg["gym"].pop("rlg_overrides", {}).items():
                cfg["rlg"]["params"]["config"][k] = v
        elif key == "rlg":
            if value not in RLG_PRESETS:
                raise ValueError(
                    f"Unknown rlg preset {value!r}; options: {sorted(RLG_PRESETS)}"
                )
            cfg["rlg"] = RLG_PRESETS[value]()
        else:
            _set_dotted(cfg, key, value)
    return cfg


def update_cfg(cfg: Dict[str, Any]) -> Dict[str, Any]:
    """Cross-propagate args into gym/rlg configs (rlg_hydra.py:251-286)."""
    args = cfg["args"]
    args["train"] = not args["play"]
    cfg["gym"]["num_instances"] = args["num_envs"]
    cfg["gym"]["asymmetric_obs"] = cfg["rlg"]["asymmetric_obs"]
    if args["experiment_name"] != "Base":
        cfg["rlg"]["params"]["config"]["name"] = (
            f"{args['experiment_name']}_{args['task_type']}_{args['device']}_tpu"
        )
    cfg["rlg"]["params"]["load_checkpoint"] = args["checkpoint"] != ""
    cfg["rlg"]["params"]["load_path"] = args["checkpoint"]
    rlg_conf = cfg["rlg"]["params"]["config"]
    rlg_conf["minibatch_size"] = args["num_envs"]
    rlg_conf["num_actors"] = args["num_envs"]
    if "central_value_config" in rlg_conf:
        rlg_conf["central_value_config"]["minibatch_size"] = args["num_envs"]
    cfg["gym"]["seed"] = args["seed"]
    cfg["rlg"]["seed"] = args["seed"]
    return cfg
