"""Default configuration dictionaries for the TriFinger task (counterpart of
``leibnizgym_tpu/envs/trifinger/config.py``; the same keys and values).

Sim defaults live in ``envs.env_base.SIM_DEFAULT_CONFIG_DICT`` and are
re-exported here.
"""

from __future__ import annotations

SIM_DEFAULT_CONFIG_DICT = {
    "seed": 0,
    "num_instances": 1,
    "spacing": 1.0,
    "control_decimation": 1,
    "episode_length": None,
    "aggregate_mode": True,
    "physics_engine": "tpu",
    "sim": {
        "dt": 0.02,
        "substeps": 2,
        "up_axis": "z",
        "gravity": [0.0, 0.0, -9.81],
        "num_client_threads": 0,
        "use_gpu_pipeline": False,
        "physx": {
            "solver_type": 1,
            "num_position_iterations": 4,
            "num_velocity_iterations": 0,
            "num_threads": 4,
            "use_gpu": False,
            "num_subscenes": 0,
            "max_gpu_contact_pairs": 8 * 1024 * 1024,
            "contact_offset": 0.002,
            "rest_offset": 0.0,
            "bounce_threshold_velocity": 0.5,
            "max_depenetration_velocity": 1000.0,
        },
    },
}

TRIFINGER_DEFAULT_CONFIG_DICT = {
    "episode_length": 750,
    "task_difficulty": 1,
    # object asset selection (reference ships cube_multicolor_rrc.urdf and
    # ball.urdf, trifinger_env.py:140 + objects/urdf/ball.urdf):
    # "cube" (default) or "sphere". object_size (scalar or [x, y, z]) overrides
    # the edge length / diameter.
    "object_type": "cube",
    "enable_ft_sensors": False,
    "command_mode": "position",
    "apply_safety_damping": True,
    "asymmetric_obs": False,
    "normalize_obs": True,
    # gaussian observation noise std in normalized obs units (the
    # reference's planned hook, trifinger_env.py:979); 0 = off
    "obs_noise_std": 0.0,
    "normalize_action": True,
    "reset_distribution": {
        "robot_initial_state": {
            "type": "default",
            "dof_pos_stddev": 0.4,
            "dof_vel_stddev": 0.2,
        },
        "object_initial_state": {
            "type": "random",
        },
    },
    "goal_movement": {
        "rotation": {
            "activate": False,
            "rate_magnitude": 0.5,
        },
    },
    "reward_terms": {
        "finger_reach_object_rate": {
            "activate": True,
            "weight": -750,
            "norm_p": 2,
        },
        "finger_move_penalty": {
            "activate": True,
            "weight": -0.1,
        },
        "object_dist": {
            "activate": True,
            "weight": 2000,
        },
        "object_rot": {
            "activate": True,
            "weight": 300,
        },
        "object_rot_delta": {
            "activate": True,
            "weight": -250,
        },
        "object_move": {
            "activate": True,
            "weight": -750,
        },
        # TPU-build extension: cube-corner keypoint reward (pos+ori jointly)
        "keypoint_dist": {
            "activate": False,
            "weight": 2000,
            "scale": 30.0,
        },
    },
    "termination_conditions": {
        "success": {
            "activate": True,
            "bonus": 5000.0,
            "position_tolerance": 0.01,
            "orientation_tolerance": 0.2,
        }
    },
    # TPU-build extras ------------------------------------------------------
    # "and" reproduces the reference dones semantics (env_base.py:399
    # logical_and of reset & goal_reset — see SURVEY.md §3.2 warning);
    # "or" is the arguably-intended fix.
    "dones_mode": "and",
    # physics engine: "pallas" (the CUDA kernel; its plain version on CPU
    # tensors), "soa" (the plain version on any device) or "reference" (the
    # batch-first reference engine, ops/engine.py); None = "pallas" on a CUDA
    # device, "soa" on the CPU
    "engine": None,
    # optional cube-corner keypoint observations (8 object + 8 goal corners)
    "use_keypoint_obs": False,
    # domain randomization (reference dr/ package is an empty stub; these
    # realize the randomization wish-list at trifinger_env.py:385-392)
    "domain_randomization": {
        "activate": False,
        "cube_mass_scale": [0.8, 1.2],
        "cube_size_scale": [0.97, 1.03],
        "link_mass_scale": [0.9, 1.1],
        "friction_scale": [0.7, 1.3],
        "restitution_range": [0.0, 0.8],
        "pd_gain_scale": [0.9, 1.1],
    },
}
