"""Eager against graphed training epochs, in turns on one card: the D1 and
D4 + DR presets, D1 as the one rank of an NCCL process group, and D1 with
``nan_telemetry``.

    python3 tools/graph_epoch_ab.py [--pairs 4] [--epochs 5] [--presets d1 d4 d1_nccl d1_nan]

Each turn builds chip_smoke.py's phase-5 (D1) or phase-6 (D4 + DR) Runner at
8192 envs, seed 0, full widths, and trains ``--epochs`` epochs through
``Runner.train`` with its epoch either ``ppo.train_iteration`` (eager) or
the Runner's own captured epoch (``learning/graphs.py``, graphed; its first
epoch captures). ``d1_nccl`` has three modes: eager and graphed as the one
rank of an NCCL group (a fresh group for the turn; the graphed epoch's
collectives captured), and graphed without a group; ``d1_nan`` runs D1 with
``nan_telemetry`` (the loop at depth 1, the pre-epoch clone). The medians
of the epoch (start to next start) and of its rollout / GAE / update split
come from CUDA events, epoch 1 left out, as in phases 5 and 6. A round is
one turn of each mode from the same seed, the first mode rotating from
round to round; the learners (parameters, Adam state, lr, rollout carry)
after the turns of a round must be bitwise equal. Printed last, beside the
card's name and power limit: per preset and phase, the median over the
turns of each mode, and each mode's ratio to the first mode (eager) of
those medians and of each round. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

import chip_smoke  # noqa: E402
from leibnizgym_tpu_torch.learning import ppo  # noqa: E402
from leibnizgym_tpu_torch.learning.runner import Runner  # noqa: E402
from leibnizgym_tpu_torch.utils.helpers import smi  # noqa: E402

PHASES = ("epoch", "rollout", "gae", "update")
# preset -> (config, modes); a mode is "eager" or "graphed", "_nccl" as the
# one rank of an NCCL group
PRESETS = {
    "d1": (chip_smoke.d1_config, ("eager", "graphed")),
    "d4": (chip_smoke.d4_config, ("eager", "graphed")),
    "d1_nccl": (chip_smoke.d1_config, ("eager_nccl", "graphed_nccl", "graphed")),
    "d1_nan": (lambda n: chip_smoke.d1_config(n, nan_telemetry=True), ("eager", "graphed")),
}


@contextlib.contextmanager
def process_group(nccl: bool):
    """A one-rank NCCL group for the block, or nothing."""
    if not nccl:
        yield
        return
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/rendezvous",
                                world_size=1, rank=0)
        try:
            yield
        finally:
            dist.destroy_process_group()


def turn(preset: str, mode: str, epochs: int, tag: str):
    """One training run: (the medians (ms) of its timed epochs by phase,
    its learner state on the CPU)."""
    cfg = PRESETS[preset][0](8192)
    marks, history = [], []
    with tempfile.TemporaryDirectory() as logdir, process_group(mode.endswith("_nccl")):
        runner = Runner(cfg["gym"], cfg["rlg"]["params"], logdir=logdir,
                        seed=chip_smoke.SEED, device=torch.device("cuda", 0))
        chip_smoke.check((runner.shard is not None) == mode.endswith("_nccl"),
                         f"{tag}: the Runner's process group")
        if mode.startswith("graphed"):
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
    turn("d1", "graphed", 3, "warmup")  # builds the kernel, fills the allocator
    card = smi()
    for preset in args.presets:
        modes = PRESETS[preset][1]
        runs = {mode: [] for mode in modes}
        for p in range(args.pairs):
            order = modes[p % len(modes):] + modes[:p % len(modes)]
            states = {}
            for mode in order:
                split, states[mode] = turn(preset, mode, args.epochs, f"{preset}_pair{p}_{mode}")
                runs[mode].append(split)
            for mode in modes[1:]:
                diff = chip_smoke.unequal(states[modes[0]], states[mode])
                print(f"{card} {preset} pair{p} {modes[0]}_vs_{mode} learner_bitwise={not diff} "
                      f"unequal={sorted(diff)[:4]}", flush=True)
                chip_smoke.check(not diff, f"{preset} pair {p}: {mode} and {modes[0]} learners "
                                 "differ")
        for ph in PHASES:
            base = np.array([r[ph] for r in runs[modes[0]]])
            line = f"{card} {preset} {ph}_ms"
            for mode in modes:
                xs = np.array([r[ph] for r in runs[mode]])
                line += f" {mode}_median={np.median(xs):.3f} {mode}_all=" + ",".join(
                    f"{x:.3f}" for x in xs)
                if mode != modes[0]:
                    line += (f" {mode}_ratio_of_medians={np.median(xs) / np.median(base):.4f} "
                             f"{mode}_pair_ratios=" + ",".join(f"{x:.4f}" for x in xs / base))
            print(line, flush=True)
    if chip_smoke.failures:
        print(f"graph_epoch_ab: {len(chip_smoke.failures)} check(s) failed", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
