"""Top-level training entry, the run_rlg equivalent (counterpart of
``leibnizgym_tpu/learning/train.py``): build the env from the task config
and the learner from the rl_games-style agent config, then train or play."""

from __future__ import annotations

import os
import threading
import time
from typing import Optional

from leibnizgym_tpu_torch.utils.message import print_info
from leibnizgym_tpu_torch.learning.runner import Runner


def run_training(task_cfg: dict, agent_cfg: dict, logdir: str = "logs", seed: int = 7,
                 train: bool = True, checkpoint: str = "",
                 max_epochs: Optional[int] = None, play_steps: int = 1000,
                 verbose: bool = False, watchdog_timeout: Optional[float] = None,
                 visualize: bool = False, device="TPU"):
    """Train or play, mirroring rl_games Runner.run(vargs). ``device`` is a
    torch device string; ``"TPU"``, the shared config's default, means
    ``cuda:0``."""
    init_done = threading.Event()
    if watchdog_timeout and train:
        # Init-phase failure detector: building the Runner is the first device
        # touch, and a wedged device can hang there before Runner.train()
        # arms its epoch watchdog. A one-shot deadline covers it;
        # Runner.train()'s own watchdog takes over once it starts.
        deadline = time.time() + max(watchdog_timeout, Runner._FIRST_EPOCH_WATCHDOG_FLOOR)

        def init_watch():
            while not init_done.is_set():
                if time.time() > deadline:
                    print_info("INIT WATCHDOG: device/env init did not complete in time — "
                               "exiting 42 for supervised restart")
                    os._exit(42)
                time.sleep(5.0)

        threading.Thread(target=init_watch, daemon=True).start()
    try:
        runner = Runner(task_cfg=task_cfg, agent_params=agent_cfg["params"], logdir=logdir,
                        seed=seed, verbose=verbose, device=device, visualize=visualize)
        runner.reset()
        if checkpoint:
            runner.restore(checkpoint)
    finally:
        init_done.set()
    if train:
        return runner.train(max_epochs=max_epochs, watchdog_timeout=watchdog_timeout)
    return runner.play(num_steps=play_steps)


def make_train_step_for_dryrun(env, frames: int = 1):
    """(train_step, ts): one PPO epoch at tiny shapes on ``env`` (horizon 4,
    2 + 2 mini-epochs, one minibatch of all envs a step), for the
    multi-process dry run. Under ``env.shard`` the train state is that
    rank's. ``train_step(ts)`` runs one epoch in place and returns its
    metrics; ``frames`` > 1 runs the frame stack of the flagship recipe. On
    a CUDA device the epoch replays CUDA graphs (``learning/graphs.py``, the
    reference's ``jax.jit(train_iteration)``), without a shard and under
    NCCL; under gloo it runs eagerly (``graphs.epoch_for``).
    ``train_step.epoch`` is the epoch function."""
    from leibnizgym_tpu_torch.learning.graphs import epoch_for
    from leibnizgym_tpu_torch.learning.ppo import PPOConfig, init_train_state

    n = env.static.envs_counted
    cfg = PPOConfig(horizon=4, minibatch_size=n, mini_epochs=2, cv_minibatch_size=n,
                    cv_mini_epochs=2, frames=frames)
    ts = init_train_state(cfg, env.static, env.params, 0, shard=env.shard)
    epoch = epoch_for(env.device, env.shard, "[dryrun] ")

    def train_step(ts):
        return epoch(cfg, env.static, env.params, ts)

    train_step.epoch = epoch

    print_info(f"[dryrun] PPO train step built: {n} envs, "
               f"{ts.shard.world if ts.shard is not None else 1} rank(s)")
    return train_step, ts
