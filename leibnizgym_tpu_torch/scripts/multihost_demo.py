"""Multi-process data-parallel training demo (counterpart of
``scripts/multihost_demo.py``): three PPO epochs with the env axis sharded
over the ranks and the learner replicated, gradients all-reduced.

    # one terminal each, or let a test spawn both
    python -m leibnizgym_tpu_torch.scripts.multihost_demo 0 2 --device cpu
    python -m leibnizgym_tpu_torch.scripts.multihost_demo 1 2 --device cpu

Rank and world come from the arguments, else from ``RANK`` / ``WORLD_SIZE``
(``torchrun``); the rendezvous from ``COORD_ADDR`` (``host:port`` or a
``tcp://`` / ``file://`` URL, default ``localhost:9911``), and the envs per
rank from ``ENVS_PER_DEVICE`` (default 8). The backend is NCCL on CUDA and
gloo on the CPU unless ``--backend`` says otherwise (gloo lets several ranks
share one GPU). Each rank runs on ``cuda:{rank % device_count}`` unless
``--device`` names another. A world of 1 runs without a process group
unless ``--backend`` names one. On a card the epochs replay CUDA graphs
(the reference jits its step), NCCL collectives and all; under gloo they
run eagerly (``learning/graphs.py`` ``epoch_for``). Every rank prints the
same ``loss ... kl ...`` line: the learner is replicated.
"""

from __future__ import annotations

import argparse
import os
import sys

import torch

from leibnizgym_tpu_torch.envs.trifinger.env import TrifingerEnv
from leibnizgym_tpu_torch.learning.graphs import epoch_for
from leibnizgym_tpu_torch.learning.ppo import PPOConfig, init_train_state
from leibnizgym_tpu_torch.parallel.mesh import (
    data_shard,
    initialize_distributed,
    shutdown_distributed,
)
from leibnizgym_tpu_torch.utils.helpers import resolve_device


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("rank", type=int, nargs="?", default=int(os.environ.get("RANK", 0)))
    ap.add_argument("world", type=int, nargs="?", default=int(os.environ.get("WORLD_SIZE", 1)))
    ap.add_argument("--device", default=None, help="torch device (default: cuda:{rank})")
    ap.add_argument("--backend", default=None, help="nccl or gloo (default: by device)")
    return ap


def main(argv=None) -> dict:
    args = parser().parse_args(argv)
    rank, world = args.rank, args.world
    coordinator = os.environ.get("COORD_ADDR", "localhost:9911")
    envs_per_device = int(os.environ.get("ENVS_PER_DEVICE", 8))
    device = resolve_device(args.device if args.device is not None
                            else f"cuda:{rank % max(torch.cuda.device_count(), 1)}",
                            cpu_hint="--device cpu")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    shard = None
    n = envs_per_device * world
    if world > 1 or args.backend:
        initialize_distributed(coordinator, world, rank, backend=args.backend
                               or ("nccl" if device.type == "cuda" else "gloo"))
        shard = data_shard(n)
    print(f"[{rank}] {world} rank(s) on {device}; {n} envs, {envs_per_device} here", flush=True)

    env = TrifingerEnv(config={"num_instances": n, "command_mode": "torque",
                               "asymmetric_obs": True, "sim": {"substeps": 2}},
                       device=device, verbose=False, shard=shard)
    cfg = PPOConfig(horizon=4, minibatch_size=n, mini_epochs=2, cv_minibatch_size=n,
                    cv_mini_epochs=2)
    ts = init_train_state(cfg, env.static, env.params, seed=0, shard=shard)
    epoch = epoch_for(device, shard, f"[{rank}] ")
    for _ in range(3):
        metrics = epoch(cfg, env.static, env.params, ts)
    total, kl = float(metrics["losses/total"]), float(metrics["info/kl"])
    print(f"[{rank}] 3 sharded train steps OK: loss {total:.6f} kl {kl:.6f}", flush=True)
    if shard is not None:
        del epoch  # its CUDA graphs hold the group's NCCL collectives
        shutdown_distributed()
    return {"loss": total, "kl": kl}


if __name__ == "__main__":
    main(sys.argv[1:])
