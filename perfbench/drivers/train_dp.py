"""The ``train_dp`` traffic: ``drivers/train.py``'s graphed PPO training as
rl_games' multi-GPU deployment, one process per card, each a rank of one
process group, as ``scripts/train.py args.multihost=True`` runs it.

Sizes: rl_games ``multi_gpu`` reads a configuration's env count and
minibatch per process, and the port's ``PPOConfig`` reads them over the
global batch. So for W ranks (the configuration's ``deployment.ranks``) of
``num_envs`` envs each (the traffic's), every rank builds its Runner with
``num_instances`` = ``num_actors`` = W x ``num_envs`` and the actor's and
the central value's ``minibatch_size`` = W x the configuration's: each
rank's minibatch step then takes one time row of its own envs, as a
one-process run of the configuration does, and the collectives are the
only new work (``global_config``).

Ranks: rank 0 is this process on ``ctx.device``; ranks 1..W-1 are children
(``parallel/launch.py`` ``join``, file rendezvous, the launch's timeout on
every collective) on ``cuda:1``..``cuda:W-1``, or gloo ranks on the CPU.
The children start first, so their start-up overlaps rank 0's. Every rank
joins the group (``parallel/mesh.py`` ``initialize_distributed``, NCCL on
the card), builds its Runner (``Runner(...)``, ``reset()``) and runs
``drivers/train.py``'s set-up: the checked epochs through ``Runner.train``
(the first eager, then the capture), then two that time an epoch. The
window's epochs are rank 0's count (as ``drivers/train.py`` counts them),
which an all-reduce hands to every rank. The window opens after a barrier
that follows every rank's set-up and closes once every rank has
synchronised its device; ``train_env_steps_per_s`` is the global frames
(epochs x horizon x W x ``num_envs``) over rank 0's window. With ``--trace
1`` every rank then trains ``profile_epochs`` more, rank 0 under the
profiler. ``memory_peak_bytes`` is the fullest device's.

The check (``checks/train_dp.py``): every rank records its part of the
checked epochs and of the replayed one, hands it to rank 0 with its
learner after the window, and rank 0 compares the joined records with the
plain reference run as one process over all envs, and counts the ranks
whose learner is not bitwise rank 0's (``rank_learner_mismatch``).
"""

from __future__ import annotations

import copy
import math
import os
import time

import torch
import torch.distributed as dist

from perfbench import harness, trace
from perfbench.checks import train as check
from perfbench.checks import train_dp as dp_check
from perfbench.drivers import train as base

# the children's function; a test points it at one that plants a fault first
CHILD = "perfbench.drivers.train_dp:child"


def global_config(config: dict, world: int, num_envs: int) -> dict:
    """``config`` at the global sizes of ``world`` ranks of ``num_envs``
    envs and the configuration's per-process minibatches (module
    docstring)."""
    cfg = copy.deepcopy(config)
    n = world * num_envs
    cfg["gym"]["num_instances"] = n
    c = cfg["rlg_params"]["config"]
    c["num_actors"] = n
    c["minibatch_size"] = world * int(c["minibatch_size"])
    cv = c.get("central_value_config")
    if cv is not None:
        cv["minibatch_size"] = world * int(cv["minibatch_size"])
    return cfg


def _world(config: dict) -> int:
    return int(config["deployment"]["ranks"])


def setup(ctx, world: int):
    """(runner, epoch hook, recorder, epoch seconds) of this rank, as
    ``drivers/train.py`` ``setup``, at the global sizes."""
    from leibnizgym_tpu_torch.learning.runner import Runner

    traffic, device = ctx.traffic, ctx.device
    n = world * int(traffic["num_envs"])
    cfg = global_config(ctx.config, world, int(traffic["num_envs"]))
    checked = int(traffic["check_epochs"])
    runner = Runner(dict(cfg["gym"]), copy.deepcopy(cfg["rlg_params"]),
                    logdir=os.path.join(ctx.tmpdir, "perfbench_logs", ctx.cell["name"]),
                    seed=ctx.seed, verbose=False, device=device)
    shard = runner.shard
    assert shard is not None and shard.world == world
    rec = dp_check.ShardRecorder(cfg, n, ctx.seed, device, checked,
                                 int(traffic["rollout_check_rows"]),
                                 int(traffic["rollout_check_steps"]),
                                 window_start=checked + base.TIMING_EPOCHS,
                                 lo=shard.lo, hi=shard.hi)
    runner.reset()
    rec.load_weights(runner.ts)
    if not ctx.on_card:
        # the CPU tests drive the card's epoch object, whose bodies run
        # eagerly off the card (the Runner picks ppo.train_iteration there)
        from leibnizgym_tpu_torch.learning.graphs import GraphedEpoch

        runner._train_iter = GraphedEpoch()
    hook = base.EpochHook(runner._train_iter, rec)
    runner._train_iter = hook
    runner.train(max_epochs=checked)
    t0 = time.perf_counter()
    runner.train(max_epochs=checked + base.TIMING_EPOCHS)
    ctx.sync()
    return runner, hook, rec, (time.perf_counter() - t0) / base.TIMING_EPOCHS


def _all_max(ctx, value: int) -> int:
    """The largest of every rank's ``value``; every rank has synchronised
    its device when it returns."""
    x = torch.tensor([value], dtype=torch.int64, device=ctx.device)
    dist.all_reduce(x, op=dist.ReduceOp.MAX)
    ctx.sync()
    return int(x.item())


def train_rank(ctx, world: int, on_open=None) -> dict:
    """This rank's set-up, window and (with ``ctx.trace``) profiled epochs;
    ``on_open`` (rank 0's) is called where the window opens. Returns the
    window's epochs and host seconds, its spans and the profiled stretch's
    summary (rank 0's), the check's recorder, the learner and the device's
    memory peak; the Runner is gone."""
    runner, hook, rec, epoch_s = setup(ctx, world)
    traffic = ctx.traffic
    lead = on_open is not None  # rank 0: counts the window, keeps its spans, profiles
    start = int(runner.ts.epoch)
    want = 0
    if lead:
        want = max(int(traffic["min_window_epochs"]), math.ceil(ctx.seconds / epoch_s),
                   rec.replay_epoch - start + 1)
    epochs = _all_max(ctx, want)
    spans = hook.spans = trace.EventSpans(ctx.on_card) if lead else None
    shard = runner.shard
    host_s = sum(shard.seconds.values())
    _all_max(ctx, 0)  # every rank's set-up is done
    if lead:
        on_open()
    t0 = time.perf_counter()
    runner.train(max_epochs=start + epochs)
    ctx.sync()
    _all_max(ctx, 0)  # every rank has synchronised
    wall = time.perf_counter() - t0
    out = {"epochs": epochs, "window_s": wall, "spans": spans,
           "collective_host_s": sum(shard.seconds.values()) - host_s,
           "backend": shard.backend, "horizon": runner.ppo_cfg.horizon}
    if spans is not None:
        spans.mark("start")  # closes the last epoch
        ctx.sync()
    hook.spans = None
    if ctx.trace:
        prof = trace.profiler() if lead else None
        if prof is not None:
            prof.start()
        runner.train(max_epochs=start + epochs + int(traffic["profile_epochs"]))
        ctx.sync()
        if prof is not None:
            prof.stop()
            out["trace"] = trace.summarize(prof)
    rec.replay_to_host()
    out["learner"] = dp_check.learner_state(runner.ts)
    out["memory_peak_bytes"] = (torch.cuda.max_memory_allocated(ctx.device) if ctx.on_card
                                else 0)
    if runner.writer is not None:
        runner.writer.close()
    del runner, hook
    ctx.free()
    out["rec"] = rec
    return out


def child(cell: dict, config: dict, traffic: dict, seed: int, seconds: float, trace_on: bool,
          device: str, tmpdir: str) -> dict:
    """Rank 1..W-1 of a run (``parallel/launch.py`` calls it inside the
    group): its records of the check, its learner and its memory peak."""
    rank = dist.get_rank()
    if device == "cuda":
        device = f"cuda:{rank}"
        torch.cuda.set_device(device)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    ctx = harness.Context(root=harness.ROOT, cell=cell, config=config, traffic=traffic,
                          seed=seed, seconds=seconds, trace=trace_on, device=device,
                          tmpdir=tmpdir, t_start=time.perf_counter())
    out = train_rank(ctx, _world(config))
    return {"records": out["rec"].records(), "learner": out["learner"],
            "memory_peak_bytes": int(out["memory_peak_bytes"])}


def run(ctx) -> dict:
    from leibnizgym_tpu_torch.parallel.launch import join

    world = _world(ctx.config)
    traffic = ctx.traffic
    kwargs = {"cell": ctx.cell, "config": ctx.config, "traffic": traffic, "seed": ctx.seed,
              "seconds": ctx.seconds, "trace_on": ctx.trace,
              "device": "cuda" if ctx.on_card else "cpu", "tmpdir": ctx.tmpdir}
    with join(CHILD, world, kwargs, backend="nccl" if ctx.on_card else "gloo",
              timeout=float(traffic["launch_timeout_s"]) + ctx.seconds) as ranks:
        mine = train_rank(ctx, world, on_open=ctx.setup_done)
        others = ranks.results()
    rec = mine["rec"]
    parts = [rec.records()] + [o["records"] for o in others]
    dp_check.merge(rec, parts)
    n = world * int(traffic["num_envs"])
    ev, between = mine["spans"].events, mine["spans"].between_ms
    starts = ev["start"]
    result = {
        "e2e": {"train_env_steps_per_s": mine["epochs"] * mine["horizon"] * n
                / mine["window_s"]},
        "spans": {"epoch_ms": between(starts[:-1], starts[1:]),
                  "rollout_ms": between(starts[:-1], ev["rollout"]),
                  "gae_ms": between(ev["rollout"], ev["gae"]),
                  "update_ms": between(ev["gae"], ev["update"]),
                  "runner_gap_ms": between(ev["update"], starts[1:])},
        "counters": {"epochs": mine["epochs"], "window_s": mine["window_s"], "num_envs": n,
                     "ranks": world, "profile_epochs": int(traffic["profile_epochs"])},
        "attempted": mine["epochs"],
        "failed": 0,
        "memory_peak_bytes": max([mine["memory_peak_bytes"]]
                                 + [o["memory_peak_bytes"] for o in others]),
    }
    if mine["backend"] == "gloo":  # its collectives run on the host (metrics/allreduce_ms)
        result["counters"]["collective_host_s"] = mine["collective_host_s"]
    if "trace" in mine:
        result["trace"] = mine["trace"]
    mismatch = dp_check.rank_learner_mismatch([mine["learner"]]
                                              + [o["learner"] for o in others])
    del others, parts
    numbers, seconds = check.compare(rec, ctx.device)
    result["numbers"] = dict(numbers, rank_learner_mismatch=mismatch)
    ctx.log("the check took " + ", ".join(f"{k} {v:.1f}" for k, v in seconds.items()))
    return result
