"""Legacy-style argparse CLI + YAML config loading (counterpart of
``leibnizgym_tpu/config/config_utils.py``).

It reads the YAML files under the repo's ``resources/config/trifinger/`` and
falls back to the port's own presets (``config/presets.py``) where they are
absent. The benchmark flags (num_proc/random_actions/bench_len/bench_file)
are those that ``leibnizgym_tpu_torch/scripts/benchmark.py`` takes.
"""

from __future__ import annotations

import argparse
import os
from typing import Tuple

import yaml

from leibnizgym_tpu_torch.utils.errors import InvalidTaskNameError
from leibnizgym_tpu_torch.utils.helpers import get_resources_dir, update_dict


def join_config_path(config_root: str, *parts: str) -> str:
    return os.path.join(config_root, *parts)


def retrieve_cfg_paths(task: str, training_type: str = "asymm") -> Tuple[str, str]:
    """Paths of the env + agent YAMLs for a task."""
    if task != "Trifinger":
        raise InvalidTaskNameError(task)
    root = join_config_path(get_resources_dir(), "config")
    cfg_env = join_config_path(root, "trifinger", "gym", "default.yaml")
    cfg_train = join_config_path(root, "trifinger", "rlg", f"{training_type}_ppo.yaml")
    return cfg_env, cfg_train


def load_cfg(task: str, training_type: str = "asymm") -> Tuple[dict, dict]:
    """Load env + agent config dicts, falling back to built-in presets when
    the YAML files are absent."""
    from leibnizgym_tpu_torch.config.presets import GYM_PRESETS, RLG_PRESETS

    cfg_env_path, cfg_train_path = retrieve_cfg_paths(task, training_type)
    if os.path.exists(cfg_env_path):
        with open(cfg_env_path) as f:
            cfg_env = yaml.safe_load(f)
    else:
        cfg_env = GYM_PRESETS["trifinger_difficulty_1"].copy()
    if os.path.exists(cfg_train_path):
        with open(cfg_train_path) as f:
            cfg_train = yaml.safe_load(f)
    else:
        cfg_train = RLG_PRESETS["asymm" if "asym" in training_type else "vanilla"]()
    return cfg_env, cfg_train


def update_cfg_from_args(cfg_env: dict, cfg_train: dict, args) -> Tuple[dict, dict]:
    """Merge CLI args into loaded configs (reference update_cfg semantics)."""
    overrides = {
        "num_instances": args.num_envs,
        "seed": args.seed,
    }
    if args.episode_length is not None:
        overrides["episode_length"] = args.episode_length
    if args.task_difficulty is not None:
        overrides["task_difficulty"] = args.task_difficulty
    update_dict(cfg_env, overrides)
    asym = "asym" in args.training_type
    cfg_env["asymmetric_obs"] = asym
    conf = cfg_train["params"]["config"]
    conf["minibatch_size"] = args.num_envs
    conf["num_actors"] = args.num_envs
    if "central_value_config" in conf:
        conf["central_value_config"]["minibatch_size"] = args.num_envs
    return cfg_env, cfg_train


def get_args(argv=None) -> argparse.Namespace:
    """Full legacy CLI surface (reference get_args, config_utils.py:196-300)."""
    p = argparse.ArgumentParser("leibnizgym_tpu legacy CLI")
    p.add_argument("--task", type=str, default="Trifinger")
    p.add_argument("--training_type", type=str, default="asymm_ppo",
                   choices=["vanilla_ppo", "asymm_ppo"])
    p.add_argument("--num_envs", type=int, default=256)
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--episode_length", type=int, default=None)
    p.add_argument("--task_difficulty", type=int, default=None)
    p.add_argument("--max_epochs", type=int, default=None)
    p.add_argument("--play", action="store_true")
    p.add_argument("--checkpoint", type=str, default="")
    p.add_argument("--logdir", type=str, default="logs/")
    p.add_argument("--headless", action="store_true", default=True)
    p.add_argument("--verbose", action="store_true")
    p.add_argument("--randomize", action="store_true",
                   help="enable dr/ domain randomization")
    # benchmark flags (functional, unlike the reference's stubs)
    p.add_argument("--num_proc", type=int, default=1)
    p.add_argument("--random_actions", action="store_true")
    p.add_argument("--bench_len", type=int, default=100)
    p.add_argument("--bench_file", type=str, default=None)
    return p.parse_args(argv)
