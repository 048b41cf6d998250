"""Env-step throughput sweep over env counts (counterpart of the repo's
``scripts/benchmark.py``, the harness the legacy CLI's benchmark flags name:
``config/config_utils.py``).

    python -m leibnizgym_tpu_torch.scripts.benchmark --num_envs_sweep 1024 4096 8192 16384 \\
        --bench_len 100 --bench_file /tmp/bench.yaml
    python -m leibnizgym_tpu_torch.scripts.benchmark --num_envs_sweep 8 --bench_len 3 \\
        --device cpu

For each env count: a D1 torque env on the device (``cuda:0`` unless
``--device cpu``), one reset, a warm-up chunk of ``bench_len`` steps of
uniform random actions in [-1, 1] and a timed chunk of as many (host clock
around work that ends in ``torch.cuda.synchronize``). On the card each env
step replays the env's captured step (the reference times its jitted one)
and launches the physics kernel and the fingertip kernel once each, so a
count costs 2 * (1 + 2 * bench_len) launches. The YAML (``--bench_file``) has the reference script's keys;
``device`` is the card's name (``cpu`` on the CPU). A user tool: it prints
env-steps/s of the env alone, not a training rate.
"""

from __future__ import annotations

import argparse
import time

import torch
import yaml

from leibnizgym_tpu_torch.envs.trifinger.env import TrifingerEnv
from leibnizgym_tpu_torch.utils.helpers import device_name, resolve_device, synchronize
from leibnizgym_tpu_torch.utils.message import print_info


def bench_one(num_envs: int, bench_len: int, substeps: int, random_actions: bool,
              device="cuda:0") -> float:
    """Env-steps/s of ``bench_len`` steps at ``num_envs`` after a warm-up
    chunk of as many."""
    device = resolve_device(device, cpu_hint="--device cpu")
    env = TrifingerEnv(
        config={"num_instances": num_envs, "command_mode": "torque",
                "sim": {"substeps": substeps}},
        device=device, verbose=False,
    )
    env.seed(0)
    env.reset()
    actions = torch.Generator(device=device).manual_seed(1)
    shape = (num_envs, env.get_action_dim())

    def chunk():
        for _ in range(bench_len):
            if random_actions:
                action = torch.rand(shape, generator=actions, device=device) * 2.0 - 1.0
            else:
                action = torch.zeros(shape, device=device)
            env.step(action)

    chunk()
    synchronize(device)
    t0 = time.perf_counter()
    chunk()
    synchronize(device)
    return num_envs * bench_len / (time.perf_counter() - t0)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--num_envs_sweep", type=int, nargs="+",
                    default=[1024, 4096, 8192, 16384])
    ap.add_argument("--bench_len", type=int, default=100)
    ap.add_argument("--substeps", type=int, default=2)
    ap.add_argument("--random_actions", action="store_true", default=True)
    ap.add_argument("--bench_file", type=str, default=None)
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args(argv)

    results = {}
    for n in args.num_envs_sweep:
        sps = bench_one(n, args.bench_len, args.substeps, args.random_actions, args.device)
        results[n] = round(sps, 1)
        print_info(f"num_envs={n}: {sps:,.0f} env-steps/s "
                   f"({sps / n:,.1f} steps/s/env)")
    payload = {
        "device": device_name(resolve_device(args.device, cpu_hint="--device cpu")),
        "substeps": args.substeps,
        "bench_len": args.bench_len,
        "env_steps_per_sec": results,
    }
    if args.bench_file:
        with open(args.bench_file, "w") as f:
            yaml.dump(payload, f)
        print_info(f"wrote {args.bench_file}")
    return payload


if __name__ == "__main__":
    main()
