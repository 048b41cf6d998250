"""Train with the port's CLI for several seeds at once and summarise the
learning curves, for one of the reference's training recipes.

    python3 tools/learning_runs.py                      # asymm: D1, 8192 envs, 300 epochs
    python3 tools/learning_runs.py --recipe vanilla     # D1, rlg=vanilla
    python3 tools/learning_runs.py --recipe position    # D1, gym.command_mode=position
    python3 tools/learning_runs.py --recipe d4_dr       # the D4 + DR flagship, seed 42
    python3 tools/learning_runs.py --num-envs 8 --epochs 2 --device cpu \\
        --extra gym.sim.substeps=1 rlg.params.config.steps_num=2

The recipes (``RECIPES``):

- ``asymm`` (the default): D1 with the asymmetric agent config, seeds 42, 7
  and 123 in float32 and seed 42 with bfloat16 networks, 300 epochs;
- ``vanilla``: D1 under ``rlg=vanilla`` (no central value, obs 41 for actor
  and critic), seeds 42, 7 and 123, 300 epochs;
- ``position``: D1 under ``gym.command_mode=position``, the same seeds;
- ``d4_dr``: ``gym=trifinger_difficulty_4_curriculum_dr`` (asymmetric agent
  config and the preset's ``rlg_overrides``), seed 42, 7630 epochs (2.0 B
  frames at 8192 envs), run under ``scripts/supervise_train.sh``. It stops
  once the curriculum level has held at 1.0 for ``--hold-epochs`` epochs (or
  at ``--deadline-s`` seconds), then evaluates the run's
  ``nn/best_curriculum`` with ``scripts/eval_policy.py`` (``--eval-envs`` x
  ``--eval-steps``, deterministic, level 1.0, strict tolerances, the
  preset's DR active). The summary gives the first frame at level 1.0 and
  the checkpoint's path.

Each run is one process of

    python -m leibnizgym_tpu_torch.scripts.train gym=<preset> args.num_envs=N
        args.max_epochs=E args.seed=S args.logdir=... args.verbose=True [recipe overrides]

(``args.verbose`` makes the runner print every epoch). A recipe's runs start
together, so they share the card and the host's cores: their epoch times
are those of runs sharing the card, not of one run alone. Each run's output
goes to ``OUT/<run>.log``; its logdir (checkpoints) under ``--logdir-root``.

Printed per run: ``ep_rew`` (the mean return of the last 100 finished
episodes) every 10 epochs, the final one, the wall time and the median epoch
(32 x N / the runner's per-epoch frames per second, epochs 2 on). The last
line is the JSON summary, also written to ``OUT/summary.json``.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import signal
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from leibnizgym_tpu_torch.utils.helpers import smi  # noqa: E402

D1 = ["gym=trifinger_difficulty_1"]
D4_DR = "trifinger_difficulty_4_curriculum_dr"
# recipe -> (epochs, runs of (name, seed, CLI overrides))
RECIPES = {
    "asymm": (300, (("f32_s42", 42, D1), ("f32_s7", 7, D1), ("f32_s123", 123, D1),
                    ("bf16_s42", 42, D1 + ["rlg.params.config.mixed_precision=True"]))),
    "vanilla": (300, tuple((f"vanilla_s{s}", s, ["rlg=vanilla"] + D1) for s in (42, 7, 123))),
    "position": (300, tuple((f"position_s{s}", s, D1 + ["gym.command_mode=position"])
                            for s in (42, 7, 123))),
    "d4_dr": (7630, (("d4dr_s42", 42, [f"gym={D4_DR}", "args.watchdog_timeout=600"]),)),
}
RUN_NAMES = sorted({name for _, runs in RECIPES.values() for name, _, _ in runs})
EPOCH_LINE = re.compile(r"epoch (\d+)/\d+ frames (\d+) fps ([\d,]+) ep_rew (\S+) "
                        r"kl (\S+) lr (\S+)(?: level (\S+))?")
# the level the runner prints with three decimals
LEVEL_ONE = 0.9995


def parse_log(text: str, horizon: int, num_envs: int) -> dict:
    """Per-epoch ep_rew, kl, lr, epoch seconds, frames and, in a
    success-gated curriculum run, the level from the runner's lines."""
    rows = {}
    for m in EPOCH_LINE.finditer(text):
        epoch = int(m.group(1))
        fps = float(m.group(3).replace(",", ""))
        rows[epoch] = {"ep_rew": float(m.group(4)), "kl": float(m.group(5)),
                       "lr": float(m.group(6)),
                       "epoch_s": horizon * num_envs / fps if fps > 0 else float("inf"),
                       "frames": int(m.group(2))}
        if m.group(7) is not None:
            rows[epoch]["level"] = float(m.group(7))
    return rows


def level_one(rows: dict):
    """(first frame at level 1.0, epochs the level has held there since it
    last arrived) of a curriculum run's rows."""
    first, held = None, 0
    for e in sorted(rows):
        at_one = rows[e].get("level", 0.0) >= LEVEL_ONE
        if at_one and first is None:
            first = rows[e]["frames"]
        held = held + 1 if at_one else 0
    return first, held


def _stop_group(proc):
    """End a process started in its own session, and all it started."""
    for sig, wait in ((signal.SIGTERM, 30), (signal.SIGKILL, 30)):
        if proc.poll() is not None:
            return
        try:
            os.killpg(proc.pid, sig)
        except ProcessLookupError:
            return
        try:
            proc.wait(wait)
        except subprocess.TimeoutExpired:
            pass


def _watch_curriculum(proc, log_path: str, hold_epochs: int, deadline_s, t0: float):
    """Wait for a supervised curriculum run: stop it once the level has held
    at 1.0 for ``hold_epochs`` epochs or at the deadline. Returns why it
    ended."""
    while proc.poll() is None:
        time.sleep(5.0)
        with open(log_path) as f:
            _, held = level_one(parse_log(f.read(), 32, 1))
        if held >= hold_epochs:
            _stop_group(proc)
            return f"level 1.0 held for {held} epochs"
        if deadline_s is not None and time.perf_counter() - t0 > deadline_s:
            _stop_group(proc)
            return f"deadline {deadline_s} s"
    return f"exit {proc.returncode}"


def _evaluate(checkpoint: str, args, env: dict) -> dict:
    """``scripts/eval_policy.py`` on ``checkpoint`` at level 1.0,
    deterministic, with the preset's DR; its JSON and wall time."""
    out = os.path.join(args.out, "d4dr_s42_eval.json")
    extra = [s for e in args.extra if e.startswith("gym.") for s in ("--set", e)]
    cmd = [sys.executable, "-m", "leibnizgym_tpu_torch.scripts.eval_policy",
           "--checkpoint", checkpoint, "--gym", D4_DR,
           "--num_envs", str(args.eval_envs), "--num_steps", str(args.eval_steps),
           "--level", "1.0", "--json_out", out, "--set", f"args.device={args.device}", *extra]
    t0 = time.perf_counter()
    with open(os.path.join(args.out, "d4dr_s42_eval.log"), "w") as log:
        rc = subprocess.run(cmd, cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT).returncode
    result = {"rc": rc, "wall_s": time.perf_counter() - t0, "json": out}
    if rc == 0:
        with open(out) as f:
            result["stats"] = json.load(f)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--recipe", choices=sorted(RECIPES), default="asymm")
    ap.add_argument("--num-envs", type=int, default=8192)
    ap.add_argument("--epochs", type=int, default=None,
                    help="max epochs of each run (default: the recipe's)")
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--out", default="output/learning")
    ap.add_argument("--logdir-root", default=None,
                    help="where the runs' logdirs go (default: a temporary directory)")
    ap.add_argument("--runs", nargs="*", default=None, choices=RUN_NAMES,
                    help="a subset of the recipe's runs (default: all of them)")
    ap.add_argument("--extra", nargs="*", default=[], help="more CLI overrides for every run")
    ap.add_argument("--threads", type=int, default=2, help="OMP_NUM_THREADS of each run")
    ap.add_argument("--hold-epochs", type=int, default=200,
                    help="d4_dr: stop once the level has held at 1.0 this long")
    ap.add_argument("--deadline-s", type=float, default=None,
                    help="d4_dr: stop training after this many seconds, then evaluate")
    ap.add_argument("--eval-envs", type=int, default=256)
    ap.add_argument("--eval-steps", type=int, default=1500)
    args = ap.parse_args(argv)

    default_epochs, runs = RECIPES[args.recipe]
    epochs_max = args.epochs or default_epochs
    if args.runs is not None:
        unknown = sorted(set(args.runs) - {r[0] for r in runs})
        if unknown or not args.runs:
            ap.error(f"--runs must name runs of --recipe {args.recipe} "
                     f"({', '.join(r[0] for r in runs)}); got {args.runs}")
        runs = [r for r in runs if r[0] in args.runs]
    curriculum = args.recipe == "d4_dr"
    os.makedirs(args.out, exist_ok=True)
    card = smi()
    print(card, flush=True)
    logroot = args.logdir_root or tempfile.mkdtemp(prefix="learning_runs_")
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS=str(args.threads),
               PYTHONUNBUFFERED="1")
    procs = {}
    for name, seed, overrides in runs:
        logdir = os.path.join(logroot, name)
        common = [f"args.num_envs={args.num_envs}", f"args.max_epochs={epochs_max}",
                  f"args.seed={seed}", f"args.device={args.device}", "args.verbose=True",
                  *overrides, *args.extra]
        if curriculum:
            # restarts resume from nn/last; every CLI start opens a new stamp
            cmd = ["bash", os.path.join(ROOT, "leibnizgym_tpu_torch/scripts/supervise_train.sh"),
                   logdir, *common]
        else:
            cmd = [sys.executable, "-m", "leibnizgym_tpu_torch.scripts.train",
                   f"args.logdir={logdir}", *common]
        log = open(os.path.join(args.out, f"{name}.log"), "w")
        procs[name] = (subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=log,
                                        stderr=subprocess.STDOUT, start_new_session=True),
                       log, time.perf_counter(), logdir)
    summary, failed = {"card": card, "recipe": args.recipe, "num_envs": args.num_envs,
                       "epochs": epochs_max, "concurrent_runs": len(procs), "runs": {}}, []
    try:
        for name, (proc, log, t0, logdir) in procs.items():
            ended = (_watch_curriculum(proc, log.name, args.hold_epochs, args.deadline_s, t0)
                     if curriculum else None)
            rc = proc.wait()
            wall = time.perf_counter() - t0
            log.close()
            with open(log.name) as f:
                rows = parse_log(f.read(), 32, args.num_envs)
            epochs = sorted(rows)
            tens = {e: rows[e]["ep_rew"] for e in epochs if e % 10 == 0}
            times = [rows[e]["epoch_s"] for e in epochs if e >= 2]
            run = {"rc": rc, "wall_s": wall, "epochs_run": epochs[-1] if epochs else 0,
                   "final_ep_rew": rows[epochs[-1]]["ep_rew"] if epochs else None,
                   "median_epoch_s": float(np.median(times)) if times else None,
                   "ep_rew_every_10": tens,
                   "lr_every_10": {e: rows[e]["lr"] for e in tens},
                   "kl_every_10": {e: rows[e]["kl"] for e in tens}}
            if curriculum:
                first, held = level_one(rows)
                best = sorted(glob.glob(os.path.join(logdir, "*", "nn", "best_curriculum")),
                              key=os.path.getmtime)
                run.update({"ended": ended, "first_frame_at_level_1": first,
                            "epochs_held_at_level_1": held,
                            "level_every_10": {e: rows[e].get("level") for e in tens},
                            "best_curriculum": best[-1] if best else None,
                            "eval": _evaluate(best[-1], args, env) if best else None})
                # a stop once the level has held, or at the deadline, ends
                # the supervisor with a signal; an exit of its own must be 0
                if (not epochs or run["eval"] is None or run["eval"]["rc"] != 0
                        or (ended.startswith("exit") and rc != 0)):
                    failed.append(name)
            elif rc != 0 or not epochs or epochs[-1] != epochs_max:
                failed.append(name)
            summary["runs"][name] = run
            print(f"{card} run={name} rc={rc} wall_s={wall:.1f} "
                  f"median_epoch_s={run['median_epoch_s']} final_ep_rew={run['final_ep_rew']}",
                  flush=True)
            print(f"run={name} ep_rew_every_10 " + " ".join(f"{e}:{v}" for e, v in tens.items()),
                  flush=True)
            if curriculum:
                print(f"{card} run={name} ended={ended} first_frame_at_level_1={first} "
                      f"best_curriculum={run['best_curriculum']}", flush=True)
                if run["eval"] is not None:
                    print(f"{card} run={name} eval rc={run['eval']['rc']} "
                          + json.dumps(run["eval"].get("stats")), flush=True)
    finally:
        for proc, _, _, _ in procs.values():
            _stop_group(proc)
    f32 = [r["final_ep_rew"] for n, r in summary["runs"].items()
           if not n.startswith("bf16") and r["final_ep_rew"] is not None]
    summary["f32_median_final"] = float(np.median(f32)) if f32 else None
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps({k: v for k, v in summary.items() if k != "runs"}
                     | {"finals": {n: r["final_ep_rew"] for n, r in summary["runs"].items()}}),
          flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
