"""Environment base class (counterpart of ``leibnizgym_tpu/envs/env_base.py``).

Carries what is shared across tasks: the config merge against the sim
defaults, spec bookkeeping and the buffer-shaped property surface, an
explicit ``device``, the ``torch.Generator`` that all of the env's random
draws come from, and ``render()``, the live viewer of env 0.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from leibnizgym_tpu_torch.utils.helpers import merged_dict, resolve_device
from leibnizgym_tpu_torch.utils.message import print_dict, print_info, print_warn

# default simulator configuration (the same keys and values as the reference
# package; PhysX-only knobs are accepted and ignored)
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


class EnvBase:
    """Base class for batched environments on one torch device."""

    def __init__(self, obs_spec: Dict[str, int], action_spec: Dict[str, int],
                 state_spec: Dict[str, int], config: Optional[dict] = None,
                 device="cuda:0", verbose: bool = True, visualize: bool = False):
        self.obs_spec = dict(obs_spec)
        self.action_spec = dict(action_spec)
        self.state_spec = dict(state_spec)
        self.device = resolve_device(device)
        self.verbose = verbose
        self.visualize = visualize
        self.config = merged_dict(dict(SIM_DEFAULT_CONFIG_DICT), config or {})
        if verbose:
            print_info("Environment configuration:")
            print_dict(self.config, nesting=0)
        self.num_instances = int(self.config["num_instances"])
        self.control_decimation = int(self.config["control_decimation"])
        self.episode_length = self.config["episode_length"]
        self.generator = torch.Generator(device=self.device)
        self.seed(int(self.config.get("seed", 0)))
        self._state = None
        self._last = None  # (obs, states, reward, dones, info)

    # ------------------------------------------------------------ properties

    def get_num_instances(self) -> int:
        return self.num_instances

    def get_obs_dim(self) -> int:
        return sum(self.obs_spec.values())

    def get_state_dim(self) -> int:
        return sum(self.state_spec.values())

    def get_action_dim(self) -> int:
        return sum(self.action_spec.values())

    def get_obs_shape(self):
        return (self.num_instances, self.get_obs_dim())

    def get_state_shape(self):
        return (self.num_instances, self.get_state_dim())

    def get_action_shape(self):
        return (self.num_instances, self.get_action_dim())

    @property
    def state(self):
        """The full functional EnvState."""
        return self._state

    @property
    def obs_buf(self):
        return self._last[0] if self._last else None

    @property
    def states_buf(self):
        return self._last[1] if self._last else None

    @property
    def reward_buf(self):
        return self._last[2] if self._last else None

    @property
    def dones_buf(self):
        return self._last[3] if self._last else None

    @property
    def env_steps_count(self) -> int:
        """Total env steps aggregated across instances (frames * N)."""
        frames = int(self._state.frames) if self._state is not None else 0
        return frames * self.num_instances

    def get_gravity(self) -> np.ndarray:
        return np.asarray(self.config["sim"]["gravity"])

    # ------------------------------------------------------------ operations

    def seed(self, seed: Optional[int] = None):
        self.generator.manual_seed(int(seed or 0))

    def dump_config(self, filename: str):
        import yaml

        if not filename.endswith(".yaml"):
            filename += ".yaml"
        dir_name = os.path.dirname(filename)
        if dir_name:
            os.makedirs(dir_name, exist_ok=True)
        with open(filename, "w") as f:
            yaml.dump(self.config, f)

    def render(self):
        """Live interactive view of env 0 (reference env_base.py:403-427:
        draw the viewer, poll the ESC / V keyboard events). Needs
        ``visualize=True`` (the reference's ``not headless``) and a
        matplotlib GUI backend. Without ``visualize`` it warns once; where
        the viewer cannot open (no display) it warns once and turns
        rendering off. Only the window is skipped then: the env, its device
        and its physics run as before."""
        if not self.visualize:
            if not getattr(self, "_render_warned", False):
                self._render_warned = True
                print_warn(
                    "render() called with visualize=False; pass visualize=True "
                    "(args.headless=False) for the live viewer, or use "
                    "leibnizgym_tpu_torch/scripts/replay_viewer.py offline."
                )
            return
        if getattr(self, "_viewer_failed", False):
            return
        viewer = getattr(self, "_viewer", None)
        if viewer is None:
            try:
                from leibnizgym_tpu_torch.utils.viewer import LiveViewer

                viewer = self._viewer = LiveViewer()
            except Exception as e:  # the window alone: no GUI backend, no display
                self._viewer_failed = True
                print_warn(f"live viewer unavailable ({e}); rendering off")
                return
        if not viewer.update(self.state):
            self.visualize = False  # ESC: stop rendering (reference QUIT)

    def close(self):
        pass

    def reset(self):
        raise NotImplementedError

    def step(self, action):
        raise NotImplementedError
