"""Training CLI of the port, with the override surface of ``scripts/train.py``:

    python -m leibnizgym_tpu_torch.scripts.train gym=trifinger_difficulty_1 args.num_envs=8192
    python -m leibnizgym_tpu_torch.scripts.train gym=trifinger_difficulty_1 args.device=cpu \\
        args.num_envs=8 args.max_epochs=2
    python -m leibnizgym_tpu_torch.scripts.train args.play=True \\
        args.checkpoint=logs/<stamp>/nn/best
    python -m leibnizgym_tpu_torch.scripts.train rlg.params.config.mixed_precision=True
    python -m leibnizgym_tpu_torch.scripts.train rlg.params.config.nan_telemetry=True

``args.device`` is a torch device string; the default ``TPU`` means
``cuda:0``, and asking for CUDA where there is none is an error. Every
agent setting of the reference is honoured, bfloat16 towers and
``nan_telemetry`` included (``learning/ppo.py``); the TPU scheduling knobs
are read and ignored. ``args.wandb_log=True`` logs to wandb as the
reference does, and trains without it, with a note, where wandb is not
installed. ``args.headless=False`` opens the live viewer for play.

``args.multihost=True`` joins a process group before the device is touched,
one process per GPU: with ``torchrun`` (its environment gives the
rendezvous), or with ``args.coordinator_address`` (``host:port``, a
``tcp://`` or ``file://`` URL), ``args.num_processes`` and
``args.process_id``. NCCL on CUDA, gloo on the CPU; each rank takes
``cuda:{LOCAL_RANK % device_count}`` and ``args.num_envs`` / W envs, and
leaves the group at the end (``parallel/mesh.py`` ``shutdown_distributed``):

    torchrun --nproc_per_node 2 -m leibnizgym_tpu_torch.scripts.train args.multihost=True \\
        args.num_envs=16384
"""

from __future__ import annotations

import os
import sys

import torch

from leibnizgym_tpu_torch.utils.message import print_dict, print_info
from leibnizgym_tpu_torch.config.presets import parse_cli, update_cfg
from leibnizgym_tpu_torch.learning.train import run_training


def main(argv):
    cfg = update_cfg(parse_cli(argv))
    args = cfg["args"]
    device = args["device"]
    if args.get("multihost"):
        from leibnizgym_tpu_torch.learning.runner import resolve_device
        from leibnizgym_tpu_torch.parallel.mesh import initialize_distributed, local_rank

        cpu = resolve_device(device).type == "cpu"  # CUDA without a card raises here
        initialize_distributed(
            coordinator_address=args.get("coordinator_address"),
            num_processes=args.get("num_processes"),
            process_id=args.get("process_id"),
            backend="gloo" if cpu else "nccl",
            timeout=args.get("watchdog_timeout"),
        )
        if not cpu:
            device = f"cuda:{local_rank() % torch.cuda.device_count()}"
            torch.cuda.set_device(device)
    if args["wandb_log"]:
        try:
            import wandb

            wandb.init(
                project=args["wandb_project_name"],
                config=cfg,
                sync_tensorboard=True,
                id=os.environ.get("SLURM_JOB_ID"),
                resume="allow",
            )
        except ImportError:
            print_info("wandb not installed; continuing without it")
    if args["verbose"]:
        print_info("Full configuration:")
        print_dict(cfg)
    out = run_training(
        task_cfg=cfg["gym"],
        agent_cfg=cfg["rlg"],
        logdir=args["logdir"],
        seed=args["seed"],
        train=args["train"],
        checkpoint=args["checkpoint"],
        max_epochs=args["max_epochs"],
        play_steps=args["play_steps"],
        verbose=args["verbose"],
        watchdog_timeout=args.get("watchdog_timeout"),
        visualize=not args.get("headless", True),
        device=device,
    )
    if args.get("multihost"):
        from leibnizgym_tpu_torch.parallel.mesh import shutdown_distributed

        shutdown_distributed()
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
