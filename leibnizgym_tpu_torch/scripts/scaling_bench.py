"""Scaling benchmark: env and PPO throughput against the number of devices
(counterpart of ``scripts/scaling_bench.py``), one process per device.

For each device count k, k ranks (``parallel/launch.py``) each step
``--envs-per-device`` envs with random actions: a warm-up rollout of
``--steps`` steps, then a timed one; with ``--train`` also one warm-up PPO
epoch and three timed ones (horizon 8, 2 + 2 mini-epochs; on the card CUDA
graph replays with their NCCL collectives, as the reference jits them). Throughput is
k x envs-per-device x steps over the slowest rank's time (the ranks meet
at a barrier before and after), and the scaling efficiency is the rollout
rate over k times the first count's.

    python -m leibnizgym_tpu_torch.scripts.scaling_bench --envs-per-device 8192 --train
    python -m leibnizgym_tpu_torch.scripts.scaling_bench --device cpu --envs-per-device 8 \\
        --steps 2 --train --device-counts 1 2

On the card the ranks use NCCL and ``cuda:0`` ... ``cuda:k-1``, and the
counts go up to ``torch.cuda.device_count()``; ``--device cpu`` runs gloo
processes on the CPU (counts 1 and 2 unless given), as the reference runs
on virtual CPU devices.
"""

from __future__ import annotations

import argparse
import sys
import time

import torch
import torch.distributed as dist

from leibnizgym_tpu_torch.utils.helpers import device_name, resolve_device, smi, synchronize


def bench_rank(envs_per_device: int, steps: int, train: bool, device: str) -> dict:
    """One rank's part of a device count (run by ``parallel.launch``):
    returns its timed seconds and the count's env-steps/s."""
    from leibnizgym_tpu_torch.envs.trifinger.env import TrifingerEnv
    from leibnizgym_tpu_torch.learning.graphs import epoch_for
    from leibnizgym_tpu_torch.learning.ppo import PPOConfig, init_train_state
    from leibnizgym_tpu_torch.ops import cuda_engine
    from leibnizgym_tpu_torch.parallel.mesh import data_shard, shard_batch

    rank, world = dist.get_rank(), dist.get_world_size()
    dev = torch.device(f"cuda:{rank}" if device == "cuda" else device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    n = envs_per_device * world
    shard = data_shard(n)
    env = TrifingerEnv(config={"num_instances": n, "command_mode": "torque",
                               "asymmetric_obs": train, "sim": {"substeps": 2}},
                       device=dev, verbose=False, shard=shard)
    gen = torch.Generator(device=dev).manual_seed(1)

    def timed(fn) -> float:
        synchronize(dev)
        dist.barrier()
        t0 = time.perf_counter()
        fn()
        synchronize(dev)
        dist.barrier()
        return time.perf_counter() - t0

    def rollout():
        for _ in range(steps):
            action = torch.rand((n, env.static.action_dim), generator=gen, device=dev)
            env.step(shard_batch(action * 2.0 - 1.0, shard))

    env.reset()
    rollout()
    out = {"rollout_s": timed(rollout)}
    out["rollout_sps"] = n * steps / out["rollout_s"]
    if train:
        cfg = PPOConfig(horizon=8, minibatch_size=max(n, 32), mini_epochs=2,
                        cv_minibatch_size=max(n, 32), cv_mini_epochs=2)
        ts = init_train_state(cfg, env.static, env.params, seed=0, shard=shard)
        epoch = epoch_for(dev, shard)
        epoch(cfg, env.static, env.params, ts)  # on a card: the warm-up, then the capture
        iters = 3
        out["train_s"] = timed(lambda: [epoch(cfg, env.static, env.params, ts)
                                        for _ in range(iters)])
        out["train_sps"] = n * cfg.horizon * iters / out["train_s"]
    out["kernel_launches"] = cuda_engine.launch_count  # 0 on the CPU
    return out


def bench_devices(k: int, envs_per_device: int, steps: int, train: bool, device: str) -> dict:
    """Rank 0's result for ``k`` devices, one process each."""
    from leibnizgym_tpu_torch.parallel.launch import launch

    backend = "nccl" if device == "cuda" else "gloo"
    return launch("leibnizgym_tpu_torch.scripts.scaling_bench:bench_rank", k,
                  dict(envs_per_device=envs_per_device, steps=steps, train=train,
                       device=device), backend=backend, timeout=1800)[0]


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--envs-per-device", type=int, default=1024)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--train", action="store_true")
    ap.add_argument("--device-counts", type=int, nargs="*", default=None)
    ap.add_argument("--device", default="cuda", help="cuda (one card per rank) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device, cpu_hint="--device cpu")
    if dev.type == "cuda":
        total = torch.cuda.device_count()
        counts = args.device_counts or sorted({1, 2, 4, 8, total} & set(range(1, total + 1)))
        if max(counts) > total:
            raise ValueError(f"device counts {counts} exceed the {total} card(s)")
        print(f"devices available: {total} ({device_name(dev)}; {smi()})", flush=True)
    else:
        counts = args.device_counts or [1, 2]
        print(f"devices: {counts} gloo processes on the CPU", flush=True)
    base, rows = None, []
    for k in counts:
        r = bench_devices(k, args.envs_per_device, args.steps, args.train, dev.type)
        base = base if base is not None else r["rollout_sps"]
        eff = r["rollout_sps"] / (base * k) * 100.0
        line = (f"devices={k}: rollout {r['rollout_sps']:,.0f} env-steps/s "
                f"(scaling eff {eff:.0f}%)")
        if "train_sps" in r:
            line += f" | train {r['train_sps']:,.0f} env-steps/s"
        print(line, flush=True)
        rows.append(dict(r, devices=k, scaling_eff=eff))
    return rows


if __name__ == "__main__":
    main(sys.argv[1:])
