#!/usr/bin/env python3
"""Where a one-rank NCCL process group's cost goes in a D1 training epoch.

    python3 tools/nccl_w1_profile.py [--num-envs 8192] [--epochs 3]

Six turns in one process on one card, each on the D1 preset with the
asymmetric agent at ``--num-envs`` envs, seed 0, built anew: for each of two
paths, ``ppo.train_iteration`` called epoch by epoch (each epoch ending in a
read of its loss) and ``Runner.train`` (its host pipeline, snapshots and
logging), the path without a process group, as the one rank of an NCCL
group (``world_size=1``), and without one again (the host's drift). A turn
runs a warm-up epoch and ``--epochs`` timed ones: rollout and update on
CUDA events, the host's time to enqueue the update, and the epoch from one
start to the next. Then it traces one more epoch with torch.profiler: the
device's busy time (the union of its kernel, memcpy and memset intervals),
the kernels, and the CUDA runtime calls and CPU operators that took the most
host time. Prints each figure beside the card's name and power limit, and
one JSON line last; the traces (~100 MB each at 8192 envs) are kept only
when ``--trace-dir`` is given.
"""

from __future__ import annotations

import argparse
import collections
import copy
import json
import os
import sys
import tempfile
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

TOP = 12
PATHS = ("train_iteration", "runner")


def d1_config(num_envs: int) -> dict:
    from leibnizgym_tpu_torch.config.presets import default_config, update_cfg

    cfg = default_config()
    cfg["args"].update(num_envs=num_envs, seed=0)
    return update_cfg(cfg)


class Marks:
    """``ppo.train_iteration`` with a CUDA event and a host time at its start
    and after each of its phases, one row per epoch."""

    def __init__(self):
        self.rows = []

    def train_iter(self, pcfg, static, env_params, ts):
        from leibnizgym_tpu_torch.learning import ppo

        row = {}
        self.rows.append(row)

        def mark(name):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            row[name] = (ev, time.perf_counter())

        mark("start")
        return ppo.train_iteration(pcfg, static, env_params, ts, on_phase=mark)

    def split(self, rows) -> dict:
        """Medians (ms) over ``rows`` of the rollout, the update, the host's
        update enqueue and the epoch (start to next start)."""
        out = {"rollout_ms": [r["start"][0].elapsed_time(r["rollout"][0]) for r in rows],
               "update_ms": [r["gae"][0].elapsed_time(r["update"][0]) for r in rows],
               "update_host_enqueue_ms": [(r["update"][1] - r["gae"][1]) * 1e3 for r in rows],
               "epoch_ms": [a["start"][0].elapsed_time(b["start"][0])
                            for a, b in zip(rows, rows[1:])]}
        return {k: sorted(v)[len(v) // 2] for k, v in out.items()}


def build(path: str, num_envs: int, dev, logdir: str):
    """(marks, run(k): k more epochs on ``path``) for a fresh D1 run, one rank
    of the process group where there is one."""
    import torch.distributed as dist

    from leibnizgym_tpu_torch.envs.trifinger.env import TrifingerEnv
    from leibnizgym_tpu_torch.learning import ppo
    from leibnizgym_tpu_torch.learning.runner import Runner
    from leibnizgym_tpu_torch.parallel.mesh import data_shard

    cfg, marks = d1_config(num_envs), Marks()
    if path == "runner":
        runner = Runner(copy.deepcopy(cfg["gym"]), cfg["rlg"]["params"], logdir=logdir, seed=0,
                        device=dev)
        runner._train_iter = marks.train_iter
        runner.reset()
        return marks, lambda k: runner.train(max_epochs=int(runner.ts.epoch) + k)
    pcfg = ppo.PPOConfig.from_rlg_params(cfg["rlg"]["params"], num_envs)
    shard = data_shard(num_envs) if dist.is_initialized() else None
    env = TrifingerEnv(cfg["gym"], device=dev, verbose=False, shard=shard)
    ts = ppo.init_train_state(pcfg, env.static, env.params, 0, shard=shard)

    def run(k):
        for _ in range(k):
            float(marks.train_iter(pcfg, env.static, env.params, ts)["losses/total"])

    return marks, run


def turn(path: str, tag: str, num_envs: int, epochs: int, dev, trace_dir: str) -> dict:
    from torch.profiler import ProfilerActivity, profile

    from leibnizgym_tpu_torch.scripts.profile_env import DEVICE_CATS, _union_ms
    from leibnizgym_tpu_torch.utils.helpers import smi

    with tempfile.TemporaryDirectory() as logdir:
        marks, run = build(path, num_envs, dev, logdir)
        run(1 + epochs)  # a warm-up epoch, then the timed ones
        torch.cuda.synchronize()
        med = marks.split(marks.rows[1:])
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run(1)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    os.makedirs(trace_dir, exist_ok=True)
    trace_path = os.path.join(trace_dir, f"nccl_w1_profile_{path}_{tag}.json")
    prof.export_chrome_trace(trace_path)
    with open(trace_path) as f:
        trace = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    dev_events = [e for e in trace if e.get("cat") in DEVICE_CATS]
    runtime = collections.defaultdict(lambda: [0.0, 0])
    for e in trace:
        if e.get("cat") in ("cuda_runtime", "cuda_driver"):
            runtime[e["name"]][0] += e["dur"] / 1e3
            runtime[e["name"]][1] += 1
    ops = sorted(prof.key_averages(), key=lambda a: -a.self_cpu_time_total)[:TOP]
    out = {
        "path": path, "tag": tag, "median": med, "profiled_wall_ms": wall_ms,
        "device_busy_ms": _union_ms((e["ts"], e["ts"] + e["dur"]) for e in dev_events),
        "kernels": sum(e["cat"] == "kernel" for e in dev_events),
        "runtime_top": sorted(([n, ms, k] for n, (ms, k) in runtime.items()),
                              key=lambda x: -x[1])[:TOP],
        "cpu_ops_top": [[a.key, a.self_cpu_time_total / 1e3, a.count] for a in ops],
    }
    where, name = smi(), f"{path} {tag}"
    print(f"{where} {name} epochs={epochs} " + " ".join(f"{k}={v:.3f}" for k, v in med.items())
          + f" profiled_wall_ms={wall_ms:.3f} device_busy_ms={out['device_busy_ms']:.3f} "
          f"kernels={out['kernels']}", flush=True)
    for n, ms, k in out["runtime_top"]:
        print(f"{where} {name} runtime ms={ms:.3f} calls={k} name={n[:100]}", flush=True)
    for n, ms, k in out["cpu_ops_top"]:
        print(f"{where} {name} cpu_self ms={ms:.3f} calls={k} op={n[:100]}", flush=True)
    return out


def main(argv=None) -> dict:
    import torch.distributed as dist

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--num-envs", type=int, default=8192)
    ap.add_argument("--epochs", type=int, default=3, help="timed epochs per turn")
    ap.add_argument("--trace-dir", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("nccl_w1_profile: no CUDA device", file=sys.stderr)
        sys.exit(1)
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        run = dict(num_envs=args.num_envs, epochs=args.epochs, dev=dev,
                   trace_dir=args.trace_dir or tmp)
        for path in PATHS:
            out[f"{path}/plain_1"] = turn(path, "plain_1", **run)
            dist.init_process_group("nccl", init_method=f"file://{tmp}/rendezvous_{path}",
                                    world_size=1, rank=0)
            try:
                out[f"{path}/nccl_w1"] = turn(path, "nccl_w1", **run)
            finally:
                dist.destroy_process_group()
            out[f"{path}/plain_2"] = turn(path, "plain_2", **run)
    print(json.dumps({k: {kk: v[kk] for kk in ("median", "profiled_wall_ms", "device_busy_ms",
                                                "kernels")} for k, v in out.items()}),
          flush=True)
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
