"""Train D1 with the port's CLI for several seeds at once and summarise the
learning curves.

    python3 tools/learning_runs.py                 # 8192 envs, 300 epochs, on cuda:0
    python3 tools/learning_runs.py --num-envs 8 --epochs 2 --device cpu \\
        --extra gym.sim.substeps=1 rlg.params.config.steps_num=2

The runs are seeds 42, 7 and 123 in float32 and seed 42 with bfloat16
networks, each one process of

    python -m leibnizgym_tpu_torch.scripts.train gym=trifinger_difficulty_1
        args.num_envs=N args.max_epochs=E args.seed=S args.logdir=... args.verbose=True
        [rlg.params.config.mixed_precision=True]

(``args.verbose`` makes the runner print every epoch). All start together,
so they share the card and the host's cores: their epoch times are those of
runs sharing the card, not of one run alone. Each run's output goes to
``OUT/<run>.log``; its logdir (checkpoints) under ``--logdir-root``.

Printed per run: ``ep_rew`` (the mean return of the last 100 finished
episodes) every 10 epochs, the final one, the wall time and the median epoch
(32 x N / the runner's per-epoch frames per second, epochs 2 on). The last
line is the JSON summary, also written to ``OUT/summary.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from leibnizgym_tpu_torch.utils.helpers import smi  # noqa: E402

RUNS = (("f32_s42", 42, False), ("f32_s7", 7, False), ("f32_s123", 123, False),
        ("bf16_s42", 42, True))
EPOCH_LINE = re.compile(r"epoch (\d+)/\d+ frames (\d+) fps ([\d,]+) ep_rew (\S+) "
                        r"kl (\S+) lr (\S+)")


def parse_log(text: str, horizon: int, num_envs: int) -> dict:
    """Per-epoch ep_rew, kl, lr and epoch seconds from the runner's lines."""
    rows = {}
    for m in EPOCH_LINE.finditer(text):
        epoch = int(m.group(1))
        fps = float(m.group(3).replace(",", ""))
        rows[epoch] = {"ep_rew": float(m.group(4)), "kl": float(m.group(5)),
                       "lr": float(m.group(6)),
                       "epoch_s": horizon * num_envs / fps if fps > 0 else float("inf")}
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--num-envs", type=int, default=8192)
    ap.add_argument("--epochs", type=int, default=300)
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--out", default="output/learning")
    ap.add_argument("--logdir-root", default=None,
                    help="where the runs' logdirs go (default: a temporary directory)")
    ap.add_argument("--runs", nargs="*", default=[r[0] for r in RUNS],
                    choices=[r[0] for r in RUNS])
    ap.add_argument("--extra", nargs="*", default=[], help="more CLI overrides for every run")
    ap.add_argument("--threads", type=int, default=2, help="OMP_NUM_THREADS of each run")
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    card = smi()
    print(card, flush=True)
    logroot = args.logdir_root or tempfile.mkdtemp(prefix="learning_runs_")
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS=str(args.threads))
    procs = {}
    for name, seed, bf16 in RUNS:
        if name not in args.runs:
            continue
        cmd = [sys.executable, "-m", "leibnizgym_tpu_torch.scripts.train",
               "gym=trifinger_difficulty_1", f"args.num_envs={args.num_envs}",
               f"args.max_epochs={args.epochs}", f"args.seed={seed}",
               f"args.logdir={os.path.join(logroot, name)}", f"args.device={args.device}",
               "args.verbose=True", *(["rlg.params.config.mixed_precision=True"] if bf16 else []),
               *args.extra]
        log = open(os.path.join(args.out, f"{name}.log"), "w")
        procs[name] = (subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=log,
                                        stderr=subprocess.STDOUT), log, time.perf_counter())
    summary, failed = {"card": card, "num_envs": args.num_envs, "epochs": args.epochs,
                       "concurrent_runs": len(procs), "runs": {}}, []
    try:
        for name, (proc, log, t0) in procs.items():
            rc = proc.wait()
            wall = time.perf_counter() - t0
            log.close()
            with open(log.name) as f:
                rows = parse_log(f.read(), 32, args.num_envs)
            epochs = sorted(rows)
            if rc != 0 or not epochs or epochs[-1] != args.epochs:
                failed.append(name)
            tens = {e: rows[e]["ep_rew"] for e in epochs if e % 10 == 0}
            times = [rows[e]["epoch_s"] for e in epochs if e >= 2]
            run = {"rc": rc, "wall_s": wall,
                   "final_ep_rew": rows[epochs[-1]]["ep_rew"] if epochs else None,
                   "median_epoch_s": float(np.median(times)) if times else None,
                   "ep_rew_every_10": tens,
                   "lr_every_10": {e: rows[e]["lr"] for e in tens},
                   "kl_every_10": {e: rows[e]["kl"] for e in tens}}
            summary["runs"][name] = run
            print(f"{card} run={name} rc={rc} wall_s={wall:.1f} "
                  f"median_epoch_s={run['median_epoch_s']} final_ep_rew={run['final_ep_rew']}",
                  flush=True)
            print(f"run={name} ep_rew_every_10 " + " ".join(f"{e}:{v}" for e, v in tens.items()),
                  flush=True)
    finally:
        for proc, _, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
    f32 = [r["final_ep_rew"] for n, r in summary["runs"].items()
           if n.startswith("f32") and r["final_ep_rew"] is not None]
    summary["f32_median_final"] = float(np.median(f32)) if f32 else None
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps({k: v for k, v in summary.items() if k != "runs"}
                     | {"finals": {n: r["final_ep_rew"] for n, r in summary["runs"].items()}}),
          flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
