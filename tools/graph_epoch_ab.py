"""Eager against graphed training epochs, in turns on one card, on the D1 and
D4 + DR presets.

    python3 tools/graph_epoch_ab.py [--pairs 4] [--epochs 5] [--presets d1 d4]

Each turn builds chip_smoke.py's phase-5 (D1) or phase-6 (D4 + DR) Runner at
8192 envs, seed 0, full widths, and trains ``--epochs`` epochs through
``Runner.train`` with its epoch either ``ppo.train_iteration`` (eager) or
the Runner's own captured epoch (``learning/graphs.py``, graphed; its first
epoch captures). The medians of the epoch (start to next start) and of its
rollout / GAE / update split come from CUDA events, epoch 1 left out, as in
phases 5 and 6. A pair is one turn of each mode from the same seed, the
first turn alternating between the modes; the two learners (parameters,
Adam state, lr, rollout carry) after the turn must be bitwise equal.
Printed last, beside the card's name and power limit: per preset and
phase, the median over the turns of each mode, the graphed / eager ratio of
those medians and of each pair. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
from leibnizgym_tpu_torch.learning import ppo  # noqa: E402
from leibnizgym_tpu_torch.learning.runner import Runner  # noqa: E402
from leibnizgym_tpu_torch.utils.helpers import smi  # noqa: E402

PHASES = ("epoch", "rollout", "gae", "update")
PRESETS = {"d1": chip_smoke.d1_config, "d4": chip_smoke.d4_config}


def turn(preset: str, graphed: bool, epochs: int, tag: str):
    """One training run: (the medians (ms) of its timed epochs by phase,
    its learner state on the CPU)."""
    cfg = PRESETS[preset](8192)
    marks, history = [], []
    with tempfile.TemporaryDirectory() as logdir:
        runner = Runner(cfg["gym"], cfg["rlg"]["params"], logdir=logdir,
                        seed=chip_smoke.SEED, device=torch.device("cuda", 0))
        if graphed:
            runner._train_iter = chip_smoke.graphed_train_iter(tag, runner, history, marks)
        else:
            runner._train_iter = chip_smoke.marked_train_iter(history, marks,
                                                              ppo.train_iteration)
        runner.reset()
        runner.train(max_epochs=epochs)
        torch.cuda.synchronize()
        if runner.writer is not None:
            runner.writer.close()
    h = runner.ppo_cfg.horizon
    chip_smoke.check_epoch_metrics(tag, history, epochs, h, 8192)
    state = {k: v.detach().cpu() for k, v in chip_smoke.learner_state(runner).items()}
    return chip_smoke.print_epoch_split(tag, marks, epochs, h, 8192), state


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pairs", type=int, default=4)
    ap.add_argument("--epochs", type=int, default=5)
    ap.add_argument("--presets", nargs="+", choices=sorted(PRESETS), default=["d1", "d4"])
    args = ap.parse_args(argv)
    if args.epochs < 3:
        ap.error("--epochs must be >= 3: a warm-up, then two epoch starts to time between")
    if not torch.cuda.is_available():
        print("graph_epoch_ab: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    turn("d1", False, 3, "warmup")  # builds the kernel, fills the allocator
    card = smi()
    for preset in args.presets:
        runs = {"eager": [], "graphed": []}
        for p in range(args.pairs):
            order = ("eager", "graphed") if p % 2 == 0 else ("graphed", "eager")
            states = {}
            for mode in order:
                split, states[mode] = turn(preset, mode == "graphed", args.epochs,
                                           f"{preset}_pair{p}_{mode}")
                runs[mode].append(split)
            diff = chip_smoke.unequal(states["eager"], states["graphed"])
            print(f"{card} {preset} pair{p} learner_bitwise={not diff} "
                  f"unequal={sorted(diff)[:4]}", flush=True)
            chip_smoke.check(not diff, f"{preset} pair {p}: graphed and eager learners differ")
        for ph in PHASES:
            eager = np.array([r[ph] for r in runs["eager"]])
            graphed = np.array([r[ph] for r in runs["graphed"]])
            ratios = graphed / eager
            print(f"{card} {preset} {ph}_ms eager_median={np.median(eager):.3f} "
                  f"graphed_median={np.median(graphed):.3f} "
                  f"ratio_of_medians={np.median(graphed) / np.median(eager):.4f} "
                  f"pair_ratios=" + ",".join(f"{x:.4f}" for x in ratios)
                  + f" eager_all=" + ",".join(f"{x:.3f}" for x in eager)
                  + f" graphed_all=" + ",".join(f"{x:.3f}" for x in graphed), flush=True)
    if chip_smoke.failures:
        print(f"graph_epoch_ab: {len(chip_smoke.failures)} check(s) failed", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
