"""Float32 against bfloat16 towers on the D1 training epoch, in turns on one card.

    python3 tools/bf16_epoch_ab.py [--pairs 8] [--epochs 5]

Each turn builds chip_smoke.py's phase-5 run (the D1 preset with the
asymmetric agent config at 8192 envs, full widths, seed 0) with float32 or
bfloat16 towers (``mixed_precision``), trains ``--epochs`` epochs through
``Runner.train`` (the first a warm-up) and takes the medians of the epoch
(start to next start) and of its rollout / GAE / update split with CUDA
events, as phases 5 and 8 do. A pair is one turn of each; the first turn
of a pair alternates between the dtypes. Printed last, beside the card's
name and power limit: per phase, the median over the turns of each dtype,
the bfloat16 / float32 ratio of those medians and of each pair, and the
number of pairs in which bfloat16 was faster. Needs a CUDA device.
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
from leibnizgym_tpu_torch.learning.runner import Runner  # noqa: E402
from leibnizgym_tpu_torch.utils.helpers import smi  # noqa: E402

PHASES = ("epoch", "rollout", "gae", "update")


def turn(bf16: bool, epochs: int, tag: str) -> dict:
    """One training run; the medians (ms) of its timed epochs by phase."""
    cfg = chip_smoke.d1_config(8192, mixed_precision=bf16)
    marks, history = [], []
    with tempfile.TemporaryDirectory() as logdir:
        runner = Runner(cfg["gym"], cfg["rlg"]["params"], logdir=logdir,
                        seed=chip_smoke.SEED, device=torch.device("cuda", 0))
        chip_smoke.check_d1_widths(tag, runner)
        runner._train_iter = chip_smoke.marked_train_iter(history, marks)
        runner.reset()
        runner.train(max_epochs=epochs)
        torch.cuda.synchronize()
        if runner.writer is not None:
            runner.writer.close()
    chip_smoke.check_epoch_metrics(tag, history, epochs, runner.ppo_cfg.horizon, 8192)
    return chip_smoke.print_epoch_split(tag, marks, epochs, runner.ppo_cfg.horizon, 8192)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pairs", type=int, default=8)
    ap.add_argument("--epochs", type=int, default=5)
    args = ap.parse_args(argv)
    if args.epochs < 3:
        ap.error("--epochs must be >= 3: a warm-up, then two epoch starts to time between")
    if not torch.cuda.is_available():
        print("bf16_epoch_ab: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    turn(False, 3, "warmup")  # builds the kernel, fills the allocator
    runs = {"f32": [], "bf16": []}
    for p in range(args.pairs):
        order = ("f32", "bf16") if p % 2 == 0 else ("bf16", "f32")
        for name in order:
            runs[name].append(turn(name == "bf16", args.epochs, f"pair{p}_{name}"))
    if chip_smoke.failures:
        print(f"bf16_epoch_ab: {len(chip_smoke.failures)} check(s) failed", file=sys.stderr)
        return 1
    card = smi()
    for ph in PHASES:
        f32 = np.array([r[ph] for r in runs["f32"]])
        bf16 = np.array([r[ph] for r in runs["bf16"]])
        ratios = bf16 / f32
        print(f"{card} {ph}_ms f32_median={np.median(f32):.3f} bf16_median={np.median(bf16):.3f} "
              f"ratio_of_medians={np.median(bf16) / np.median(f32):.4f} "
              f"pair_ratios=" + ",".join(f"{x:.3f}" for x in ratios)
              + f" bf16_faster_pairs={int((ratios < 1).sum())}/{len(ratios)} "
              f"f32_quartiles={np.percentile(f32, 25):.3f},{np.percentile(f32, 75):.3f}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
