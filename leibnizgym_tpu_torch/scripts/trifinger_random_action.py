"""Random-action throughput demo (counterpart of the repo's
``scripts/trifinger_random_action.py``).

    NUM_ENVS=8192 python -m leibnizgym_tpu_torch.scripts.trifinger_random_action
    NUM_ENVS=8 DEVICE=cpu python -m leibnizgym_tpu_torch.scripts.trifinger_random_action

Steps ``NUM_ENVS`` (default 8192) env instances (D1, torque, 2 substeps)
with uniform random torque actions in 50-step chunks and prints env-steps/s
after every chunk until Ctrl-C. The env runs on ``DEVICE`` (default
``cuda:0``, where each step launches the physics kernel and the fingertip
kernel once each); the first
chunk is a warm-up.
"""

from __future__ import annotations

import os
import time

import torch

from leibnizgym_tpu_torch.envs.trifinger.env import TrifingerEnv
from leibnizgym_tpu_torch.utils.helpers import synchronize
from leibnizgym_tpu_torch.utils.message import print_info

NUM_ENVS = int(os.environ.get("NUM_ENVS", 8192))
DEVICE = os.environ.get("DEVICE", "cuda:0")
CHUNK = 50


def make_env(num_envs: int = NUM_ENVS, device=DEVICE, verbose: bool = True) -> TrifingerEnv:
    """The demo's env, seeded and reset."""
    env = TrifingerEnv(
        config={"num_instances": num_envs, "command_mode": "torque",
                "sim": {"substeps": 2}},
        device=device, verbose=verbose,
    )
    env.seed(0)
    env.reset()
    return env


def chunk(env: TrifingerEnv, generator: torch.Generator, length: int = CHUNK) -> float:
    """``length`` steps of uniform random actions in [-1, 1] from
    ``generator``; returns env-steps/s (host clock, synchronized on a card)."""
    shape = (env.get_num_instances(), env.get_action_dim())
    synchronize(env.device)
    t0 = time.perf_counter()
    for _ in range(length):
        env.step(torch.rand(shape, generator=generator, device=env.device) * 2.0 - 1.0)
    synchronize(env.device)
    return shape[0] * length / (time.perf_counter() - t0)


def main():
    env = make_env()
    generator = torch.Generator(device=env.device).manual_seed(1)
    chunk(env, generator)
    print_info("warmed up; entering loop (Ctrl-C to stop)")
    while True:
        print_info(f"{chunk(env, generator):,.0f} env-steps/s")


if __name__ == "__main__":
    main()
