#!/usr/bin/env python3
"""Data-parallel D1 training over W cards against one card, one process per
card (``leibnizgym_tpu_torch/parallel/``).

    python3 tools/dp_cards.py                      # W = every card here, NCCL
    python3 tools/dp_cards.py --device cuda:0 --world 4   # 4 gloo ranks sharing one card
    python3 tools/dp_cards.py --device cpu --world 4 --num-envs 8 --horizon 4 --substeps 2

``--device cuda`` puts each rank on its own card under NCCL; a card's name
(``cuda:0``) puts every rank on that card under gloo; ``cpu`` runs gloo on
the CPU. Three runs of the D1 preset with the asymmetric agent, ``--epochs``
epochs each, seed 0, in the port's epoch (``graphs.epoch_for``: on a card
CUDA-graph replays, NCCL collectives captured; under gloo or on the CPU
``ppo.train_iteration``, eagerly) and, on a card, again eagerly:

1. one rank, no process group, ``--num-envs`` envs;
2. W ranks sharing the same global ``--num-envs`` (strong scaling): the
   ranks' learners bit-identical, and each epoch's losses, KL and lr against
   run 1's as the largest relative difference. These are free runs: cuBLAS
   rounds the ranks' smaller batches apart from run 1's and contacts
   amplify it over the rollout (``chip_smoke.py`` phase 11 (b) holds the
   parts that chaos cannot enter), so the difference is reported, not held;
3. W ranks of ``--num-envs`` envs each (weak scaling): training env-steps/s
   against run 1's, and the efficiency.

On a card each rank's learner after a graphed run must be bitwise equal to
its learner after the eager run of the same layout. It then runs
``chip_smoke.py`` phase 11 (b)'s checks at W ranks in the same layout of ranks and cards (``chip_smoke.dp_ranks``): every
recorded kernel launch of the ranks' first epoch, joined and stepped once
by the 1-rank kernel, lands on the ranks' outputs; each rank's update on
its shard of a 1-rank epoch's trajectory has the 1-rank update's first-step
gradient (``chip_smoke.GRAD1_RTOL``), and the same update with each of
``chip_smoke.FAULTS`` planted has not. The whole epoch's figures print
ungated, beside the 1-rank update with every observation one ulp up: the
256 steps amplify rounding by themselves, so whether a sound epoch stays
within phase 11 (b)'s whole-epoch bound depends on the sum's order. The
free run's first epoch prints against the 1-rank one, step by step. A
failed check makes the exit code 1.

Epoch times are start-to-start on the host clock after the first epoch
(each epoch ends in a read of its metrics), the slowest rank's. Prints the
runs' figures as one JSON line before the checks, and again with the
checks' as the last line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

KEYS = ("losses/total", "losses/a_loss", "losses/c_loss", "losses/cv_loss", "info/kl", "info/lr")


def d1_run(num_envs: int, epochs: int, horizon: int, substeps: int, device: str,
           graphed: bool = True) -> dict:
    """The D1 preset for ``epochs`` epochs on this rank (a process group if
    one exists), graphed (``graphs.epoch_for``) or eager: per-epoch metrics
    and seconds, the learner's checksum and its flat float64 copy."""
    import torch.distributed as dist

    from leibnizgym_tpu_torch.config.presets import default_config, update_cfg
    from leibnizgym_tpu_torch.envs.trifinger.env import TrifingerEnv
    from leibnizgym_tpu_torch.learning import ppo
    from leibnizgym_tpu_torch.learning.graphs import GraphedEpoch, epoch_for
    from leibnizgym_tpu_torch.parallel.mesh import data_shard
    from leibnizgym_tpu_torch.utils.helpers import synchronize

    grouped = dist.is_initialized()
    dev = torch.device(f"cuda:{dist.get_rank() if grouped else 0}" if device == "cuda"
                       else device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        torch.backends.cuda.matmul.allow_tf32 = False
    cfg = default_config()
    cfg["args"].update(num_envs=num_envs, seed=0)
    cfg = update_cfg(cfg)
    cfg["gym"]["sim"]["substeps"] = substeps
    cfg["rlg"]["params"]["config"]["steps_num"] = horizon
    pcfg = ppo.PPOConfig.from_rlg_params(cfg["rlg"]["params"], num_envs)
    shard = data_shard(num_envs) if grouped else None
    env = TrifingerEnv(cfg["gym"], device=dev, verbose=False, shard=shard)
    ts = ppo.init_train_state(pcfg, env.static, env.params, 0, shard=shard)
    epoch = epoch_for(dev, shard) if graphed else ppo.train_iteration
    rows, stamps = [], []
    for _ in range(epochs):
        stamps.append(time.perf_counter())
        m = epoch(pcfg, env.static, env.params, ts)
        rows.append({k: float(m[k]) for k in KEYS})  # reads back: the epoch has ended
    synchronize(dev)
    stamps.append(time.perf_counter())
    flat = torch.cat([t.detach().double().reshape(-1) for t in ts.learner_tensors()])
    return {"rows": rows, "epoch_s": [b - a for a, b in zip(stamps[1:], stamps[2:])],
            "checksum": [float(flat.sum()), float(flat.abs().sum())], "learner": flat.cpu(),
            "graphed": isinstance(epoch, GraphedEpoch),
            "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"}


def main(argv=None) -> dict:
    from leibnizgym_tpu_torch.parallel.launch import launch
    from leibnizgym_tpu_torch.utils.helpers import smi

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--world", type=int, default=None, help="ranks (default: every card)")
    ap.add_argument("--num-envs", type=int, default=8192)
    ap.add_argument("--epochs", type=int, default=4)
    ap.add_argument("--horizon", type=int, default=32)
    ap.add_argument("--substeps", type=int, default=4)
    ap.add_argument("--device", default="cuda",
                    help="cuda (one card per rank, NCCL), a card (every rank on it, gloo) or cpu")
    args = ap.parse_args(argv)
    world = args.world or torch.cuda.device_count()
    run = dict(epochs=args.epochs, horizon=args.horizon, substeps=args.substeps,
               device=args.device)
    backend = "nccl" if args.device == "cuda" else "gloo"
    on_card = args.device.startswith("cuda")
    target = "tools.dp_cards:d1_run"

    modes = {}
    for mode in ("graphed", "eager") if on_card else ("graphed",):
        mrun = dict(run, graphed=mode == "graphed")
        one = d1_run(args.num_envs, **mrun)
        strong = launch(target, world, dict(mrun, num_envs=args.num_envs), backend=backend,
                        timeout=1800)
        weak = launch(target, world, dict(mrun, num_envs=args.num_envs * world),
                      backend=backend, timeout=1800)
        modes[mode] = (one, strong, weak)
    bitwise = gap = within = None
    if on_card:  # each rank's learner, graphed against eager, in each layout
        def every_rank(runs):
            return [runs[0]] + runs[1] + runs[2]

        pairs = list(zip(every_rank(modes["graphed"]), every_rank(modes["eager"])))
        bitwise = all(torch.equal(g["learner"], e["learner"]) for g, e in pairs)
        # where they differ: the largest difference and the share within 1e-5
        gap = max(float((g["learner"] - e["learner"]).abs().max()) for g, e in pairs)
        within = min(float(((g["learner"] - e["learner"]).abs() <= 1e-5).double().mean())
                     for g, e in pairs)
    one, strong, weak = modes["graphed"]

    rel = max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-12)
              for a, b in zip(strong[0]["rows"], one["rows"]) for k in KEYS)
    replicated = all(r["checksum"] == runs[0]["checksum"] for runs in (strong, weak)
                     for r in runs)

    def sps(runs, n):
        worst = [max(r["epoch_s"][e] for r in runs) for e in range(len(runs[0]["epoch_s"]))]
        worst.sort()
        return args.horizon * n / worst[len(worst) // 2]

    out = {
        "devices": one["device"], "smi": smi() if on_card else "cpu",
        "world": world, "num_envs": args.num_envs, "epochs": args.epochs,
        "strong_free_run_max_rel_diff": rel, "learners_replicated": replicated,
        "graphed_epochs": [one["graphed"]] + [r["graphed"] for r in strong + weak],
        "graphed_equals_eager_bitwise": bitwise, "graphed_vs_eager_max_abs": gap,
        "graphed_vs_eager_within_1e-5": within,
    }
    # the graphed runs' figures, then the eager ones' under "eager"
    for mode, (m_one, m_strong, m_weak) in modes.items():
        one_sps = sps([m_one], args.num_envs)
        weak_sps = sps(m_weak, args.num_envs * world)
        figures = {
            "one_rank_env_steps_per_s": one_sps,
            "strong_env_steps_per_s": sps(m_strong, args.num_envs),
            "weak_env_steps_per_s": weak_sps,
            "weak_scaling_eff": weak_sps / (world * one_sps),
            "epoch_s": {"one": m_one["epoch_s"], "strong": [r["epoch_s"] for r in m_strong],
                        "weak": [r["epoch_s"] for r in m_weak]},
        }
        if mode == "graphed":
            out.update(figures)
        else:
            out["eager"] = figures
    for e, (a, b) in enumerate(zip(one["rows"], strong[0]["rows"]), 1):
        print(f"epoch {e} one_rank " + " ".join(f"{k}={a[k]:.6g}" for k in KEYS), flush=True)
        print(f"epoch {e} {world}_ranks " + " ".join(f"{k}={b[k]:.6g}" for k in KEYS), flush=True)
    print(json.dumps(out), flush=True)  # the runs' figures, before the checks
    controlled = None
    if on_card:
        import chip_smoke

        card = torch.device("cuda", 0) if args.device == "cuda" else torch.device(args.device)
        with tempfile.TemporaryDirectory() as tmp:
            controlled = chip_smoke.dp_ranks(
                card, chip_smoke.d1_config(args.num_envs), args.num_envs, tmp, world, backend,
                spread=args.device == "cuda", whole_epoch=False, faults=chip_smoke.FAULTS,
                control=True, tag=f"dp_cards W={world}")
        controlled["failures"] = list(chip_smoke.failures)
    out["controlled"] = controlled
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    result = main(sys.argv[1:])
    sys.exit(1 if (result["controlled"] or {}).get("failures")
             or result["graphed_equals_eager_bitwise"] is False else 0)
