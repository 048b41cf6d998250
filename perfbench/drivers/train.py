"""The ``train`` traffic: graphed PPO training through ``Runner.train``.

Set-up builds the Runner as ``scripts/train.py`` builds it (``Runner(...)``,
``reset()``; its summary writer and checkpoints on, its log directory under
``$TMPDIR``), loads the benchmark's starting weights into it, and trains the
checked epochs through ``Runner.train`` with the benchmark's draws (the
first epoch runs eagerly and captures the CUDA graphs; the others replay),
then two more epochs with the program's own draws, which time an epoch. The
window is one ``Runner.train`` call over as many epochs as fill
``--seconds`` at that pace (at least ``min_window_epochs``, and at least
through the epoch that the check replays, ``Recorder.replay_epoch``): a
closed loop, each epoch enqueued when the host loop hands it on.

The epoch function the Runner calls is wrapped (``EpochHook``) to record a
CUDA event at each epoch's start and at the end of its rollout, GAE and
update phases, through the epoch function's own ``on_phase``, and to take
the check's copies (``checks/train.py``).
"""

from __future__ import annotations

import copy
import math
import os
import time

import torch

from perfbench import trace, yardstick
from perfbench.checks import train as check


TIMING_EPOCHS = 2  # after the checked epochs, in set-up: they time an epoch


class EpochHook:
    """Stands in for the Runner's epoch function: passes the benchmark's
    draws to the checked epochs and to the replayed one, takes the check's
    copies, and records the spans."""

    def __init__(self, epoch_fn, recorder: check.Recorder):
        self.fn, self.rec = epoch_fn, recorder
        self.spans = None
        self.calls = 0
        self.mode = None  # "check", "replay" or None in the running epoch

    def _phase(self, name: str) -> None:
        if name == "rollout":
            if self.mode == "check":
                self.rec.on_rollout(self.fn.traj)
            elif self.mode == "replay":
                self.rec.replay_rollout(self.fn.traj)
        if self.spans is not None:
            self.spans.mark(name)

    def __call__(self, cfg, static, env_params, ts):
        if self.spans is not None:
            self.spans.mark("start")
        epoch, self.calls = self.calls, self.calls + 1
        self.mode, draws = None, {}
        if not self.rec.done:
            self.mode, draws = "check", self.rec.draws()
        elif epoch == self.rec.replay_epoch:
            self.mode, draws = "replay", self.rec.replay_start(ts, env_params)
        metrics = self.fn(cfg, static, env_params, ts, on_phase=self._phase, **draws)
        if self.mode == "check":
            self.rec.after(ts, self.fn)
        return metrics


def setup(ctx):
    """(runner, epoch hook, check recorder, epoch seconds): the Runner built
    and trained through the checked epochs and two more, which time an
    epoch."""
    from leibnizgym_tpu_torch.learning.runner import Runner

    cfg, traffic, device = ctx.config, ctx.traffic, ctx.device
    n = int(traffic["num_envs"])
    task = dict(cfg["gym"], num_instances=n)
    agent = copy.deepcopy(cfg["rlg_params"])
    agent["config"]["num_actors"] = n
    logdir = os.path.join(ctx.tmpdir, "perfbench_logs", ctx.cell["name"])
    checked = int(traffic["check_epochs"])
    rec = check.Recorder(cfg, n, ctx.seed, device, checked, int(traffic["rollout_check_rows"]),
                         int(traffic["rollout_check_steps"]), window_start=checked + TIMING_EPOCHS)

    runner = Runner(task, agent, logdir=logdir, seed=ctx.seed, verbose=False, device=device)
    runner.reset()
    rec.load_weights(runner.ts)
    if not ctx.on_card:
        # the CPU tests drive the card's epoch object, whose bodies run
        # eagerly off the card (the Runner picks ppo.train_iteration there)
        from leibnizgym_tpu_torch.learning.graphs import GraphedEpoch

        runner._train_iter = GraphedEpoch()
    hook = EpochHook(runner._train_iter, rec)
    runner._train_iter = hook
    ctx.log(f"summary writer: {type(runner.writer).__name__ if runner.writer else 'none'}")

    runner.train(max_epochs=checked)
    t0 = time.perf_counter()
    runner.train(max_epochs=checked + TIMING_EPOCHS)
    ctx.sync()
    epoch_s = (time.perf_counter() - t0) / TIMING_EPOCHS
    return runner, hook, rec, epoch_s


def run(ctx) -> dict:
    runner, hook, rec, epoch_s = setup(ctx)
    cfg, traffic, n = ctx.config, ctx.traffic, int(ctx.traffic["num_envs"])
    start = int(runner.ts.epoch)
    epochs = max(int(traffic["min_window_epochs"]), math.ceil(ctx.seconds / epoch_s),
                 rec.replay_epoch - start + 1)
    hook.spans = trace.EventSpans(ctx.on_card)
    ctx.setup_done()
    t0 = time.perf_counter()
    runner.train(max_epochs=start + epochs)
    ctx.sync()
    wall = time.perf_counter() - t0
    hook.spans.mark("start")  # closes the last epoch
    ctx.sync()
    rec.replay_to_host()
    ev = hook.spans.events
    between = hook.spans.between_ms
    starts = ev["start"]
    spans = {
        "epoch_ms": between(starts[:-1], starts[1:]),
        "rollout_ms": between(starts[:-1], ev["rollout"]),
        "gae_ms": between(ev["rollout"], ev["gae"]),
        "update_ms": between(ev["gae"], ev["update"]),
        "runner_gap_ms": between(ev["update"], starts[1:]),
    }
    frames = epochs * runner.ppo_cfg.horizon * n
    result = {
        "e2e": {"train_env_steps_per_s": frames / wall},
        "spans": spans,
        "counters": {"epochs": epochs, "window_s": wall, "num_envs": n,
                     "epoch_flops": _epoch_flops(cfg, rec.cfg, rec.static, n)},
        "attempted": epochs,
        "failed": 0,
    }
    if ctx.trace:
        prof = trace.profiler()
        hook.spans = None
        prof.start()
        runner.train(max_epochs=start + epochs + int(traffic["profile_epochs"]))
        ctx.sync()
        prof.stop()
        result["trace"] = trace.summarize(prof)
        result["counters"]["profiled_env_steps"] = (int(traffic["profile_epochs"])
                                                    * runner.ppo_cfg.horizon)
    result["memory_peak_bytes"] = torch.cuda.max_memory_allocated() if ctx.on_card else 0
    if runner.writer is not None:
        runner.writer.close()
    del runner, hook
    ctx.free()
    result["numbers"], seconds = check.compare(rec, ctx.device)
    ctx.log("the check took " + ", ".join(f"{k} {v:.1f}" for k, v in seconds.items()))
    return result


def _epoch_flops(config: dict, ppo_cfg, static, n: int) -> float:
    """The model FLOPs of one epoch at this configuration's widths
    (``yardstick.epoch_model_flops``)."""
    asym = ppo_cfg.central_value and static.asymmetric_obs
    ac, cv = yardstick.network_macs(static.obs_dim * ppo_cfg.frames, static.state_dim,
                                    static.action_dim, ppo_cfg.units, asym)
    h = ppo_cfg.horizon
    ac_mb = max(h * n // ppo_cfg.minibatch_size, 1)
    cv_mb = max(h * n // ppo_cfg.cv_minibatch_size, 1)
    return yardstick.epoch_model_flops(
        n, h, ac, cv, ppo_cfg.mini_epochs * ac_mb, h * n // ac_mb,
        ppo_cfg.cv_mini_epochs * cv_mb if asym else 0, h * n // cv_mb,
        config["physics_kernel"]["ops_per_env"])
