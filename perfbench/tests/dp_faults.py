"""Faults planted in a data-parallel training cell's ranks, for the controls
of ``test_bench_dp.py`` (on the CPU, cut to 32 envs a rank) and, at the
cell's own size, on the cards:

    python3 -m perfbench.tests.dp_faults --workload <cell> --fault <name> --seed <n>

Each fault is planted in rank 0 (this process) by the caller and in the
children by the launch target of the same name, which plants it and then
runs the driver's ``child``:

- ``allreduce_left_out``: the last rank issues each minibatch step's
  all-reduce but keeps its own gradients and KL (the mean is not copied
  back), so its learner drifts from the others';
- ``grads_summed``: every rank's gradients and KL summed over the ranks
  instead of averaged;
- ``advs_per_rank``: every rank normalises its advantages over its own envs
  instead of the global batch.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

FAULTS = ("allreduce_left_out", "grads_summed", "advs_per_rank")


def plant(fault: str, setattr_, rank: int, world: int) -> None:
    """Plant ``fault`` in this process, as rank ``rank`` of ``world``,
    through ``setattr_`` (``monkeypatch.setattr`` in a test)."""
    from leibnizgym_tpu_torch.learning import ppo

    reduce_mean, mean_std = ppo.all_reduce_mean_, ppo.global_mean_std
    if fault == "allreduce_left_out":
        if rank == world - 1:
            setattr_(ppo, "all_reduce_mean_",
                     lambda tensors, shard: reduce_mean([t.clone() for t in tensors], shard))
    elif fault == "grads_summed":
        def summed(tensors, shard):
            reduce_mean(tensors, shard)
            for t in tensors:
                t.mul_(shard.world)

        setattr_(ppo, "all_reduce_mean_", summed)
    elif fault == "advs_per_rank":
        setattr_(ppo, "global_mean_std", lambda x, shard: mean_std(x, None))
    else:
        raise ValueError(f"no fault {fault!r}; the faults are {FAULTS}")


def _child(fault: str, kwargs: dict):
    import torch.distributed as dist

    from perfbench.drivers import train_dp

    plant(fault, setattr, dist.get_rank(), dist.get_world_size())
    return train_dp.child(**kwargs)


def allreduce_left_out(**kwargs):
    return _child("allreduce_left_out", kwargs)


def grads_summed(**kwargs):
    return _child("grads_summed", kwargs)


def advs_per_rank(**kwargs):
    return _child("advs_per_rank", kwargs)


def planted(cell, fault: str, setattr_) -> None:
    """``cell`` (a resolved data-parallel cell) with ``fault`` planted in
    this process as rank 0 and in the children it starts."""
    plant(fault, setattr_, 0, int(cell.config["deployment"]["ranks"]))
    setattr_(cell.driver, "CHILD", f"perfbench.tests.dp_faults:{fault}")


def main(argv) -> int:
    """One run of the cell at its own size on the cards with ``--fault``
    planted: the check's numbers beside their limits, as a JSON line."""
    import os

    import torch

    from perfbench import harness

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--fault", required=True, choices=FAULTS)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=1.0)
    args = p.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = harness.resolve(harness.load_json(os.path.join(harness.ROOT, "BENCHMARK.json")),
                           args.workload)
    planted(cell, args.fault, setattr)
    result = harness.run_cell(cell, args.seed, args.seconds, False, "cuda:0",
                              time.perf_counter())
    print(json.dumps({"fault": args.fault, "seed": args.seed, "correct": result["correct"],
                      "checks": result["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
