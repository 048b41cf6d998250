"""Training runner: the rl_games ``Runner`` equivalent (counterpart of
``leibnizgym_tpu/learning/runner.py``).

One class owns the env, the learner (``learning/ppo.py``), TensorBoard
logging, checkpoints under ``nn/`` and the play path, on one explicit torch
device.

Host pipelining: ``train`` leaves up to ``host_pipeline_depth`` epochs'
metrics on the device before reading them, so the per-epoch read-back does
not wait for the device. The update changes the parameters in place, so
each pending epoch keeps a snapshot of its own learner state, cloned on the
device (both state dicts, both Adam states and ``lr``: ~4.6 MB at the D1
widths). A checkpoint taken while processing an epoch (``best``, ``last``,
``nan_halt``) therefore holds that epoch's policy, as in the reference.

Checkpoints are ``torch.save`` files (``nn/<name>``) of plain tensors and
numbers: both state dicts, both optimizer states, ``lr``, ``epoch``,
``frame`` and, when the curriculum is success-gated, its level. The env
state is not saved; envs reset on resume, as in the reference. ``restore``
also takes the weights-only ``.npz`` policies of
``leibnizgym_tpu_torch/resources/policies/``.
"""

from __future__ import annotations

import collections
import os
import threading
import time
from datetime import datetime
from typing import Optional

import numpy as np
import torch
import yaml

from leibnizgym_tpu.utils import print_error, print_info, print_notify, print_warn
from leibnizgym_tpu_torch.convert import checkpoint_from_npz
from leibnizgym_tpu_torch.envs.trifinger.env import TrifingerEnv
from leibnizgym_tpu_torch.learning.ppo import (
    PPOConfig,
    TrainState,
    init_train_state,
    make_optimizers,
    train_iteration,
)


def resolve_device(name) -> torch.device:
    """The torch device for an ``args.device`` string. The shared config's
    default ``"TPU"`` means ``cuda:0``; a CUDA device without a card is an
    error, never a silent CPU run."""
    device = torch.device("cuda", 0) if str(name).upper() == "TPU" else torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {name!r} asks for CUDA, but torch.cuda.is_available() is False; "
            "pass args.device=cpu to train on the CPU"
        )
    return device


def _summary_writer_cls():
    try:
        from tensorboardX import SummaryWriter
    except ImportError:
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            return None
    return SummaryWriter


def fetch_metrics(metrics: dict) -> dict:
    """Metrics to numpy with one device-to-host copy for all scalars and
    one per vector."""
    scalar = [k for k, v in metrics.items() if torch.is_tensor(v) and v.dim() == 0]
    out = {k: np.asarray(v) for k, v in metrics.items() if not torch.is_tensor(v)}
    if scalar:
        values = torch.stack([metrics[k].to(torch.float64) for k in scalar]).cpu().numpy()
        out.update(zip(scalar, values))
    out.update({k: v.cpu().numpy() for k, v in metrics.items()
                if torch.is_tensor(v) and v.dim() > 0})
    return out


class AverageMeter:
    """Mean over the last ``maxlen`` completed games (rl_games parity)."""

    def __init__(self, maxlen: int = 100):
        self._buf = collections.deque(maxlen=maxlen)

    def update(self, values):
        self._buf.extend(np.atleast_1d(values).tolist())

    @property
    def current_size(self):
        return len(self._buf)

    def get_mean(self):
        return float(np.mean(self._buf)) if self._buf else 0.0


class Runner:
    """Owns env + learner on one device; trains or plays."""

    def __init__(self, task_cfg: dict, agent_params: dict, logdir: str = "logs",
                 seed: int = 7, verbose: bool = False, device="TPU",
                 visualize: bool = False):
        if visualize:
            raise NotImplementedError(
                "the viewer is not in the PyTorch port yet (ROADMAP.md queue 1, item 14)")
        self.verbose = verbose
        self.device = resolve_device(device)
        num_actors = int(task_cfg.get("num_instances", 256))
        self.ppo_cfg = PPOConfig.from_rlg_params(agent_params, num_actors)
        self.env = TrifingerEnv(config=task_cfg, device=self.device, verbose=verbose)
        self.static, self.env_params = self.env.static, self.env.params
        self.seed = seed

        # log directories (reference run_rlg: nn/, runs/, timestamped)
        stamp = datetime.now().strftime("%m-%d-%Y-%H-%M-%S")
        self.logdir = os.path.join(logdir, stamp)
        self.nn_dir = os.path.join(self.logdir, "nn")
        os.makedirs(self.nn_dir, exist_ok=True)
        with open(os.path.join(self.logdir, "agent_config.yaml"), "w") as f:
            yaml.dump(agent_params, f)
        self.env.dump_config(os.path.join(self.logdir, "env_config.yaml"))
        writer_cls = _summary_writer_cls()
        self.writer = (writer_cls(os.path.join(self.logdir, "summaries"))
                       if writer_cls is not None else None)
        print_notify(f"Saving logs at: {self.logdir}")

        self._train_iter = train_iteration
        self.game_rewards = AverageMeter(self.ppo_cfg.games_to_track)
        self.ts: Optional[TrainState] = None

        # success-gated curriculum controller (host side of the env's
        # goal_curriculum.success_gated): advances / retreats the env's
        # curriculum level on successes per finished episode. Episodes finish
        # synchronised (timeout resets), so one sample arrives per
        # ~episode_length / horizon epochs; steps are sized per sample.
        gc = dict(task_cfg.get("goal_curriculum", {}) or {})
        self._cur_gated = bool(gc.get("success_gated", False))
        self._cur_level = 0.0
        if self._cur_gated:
            self._cur_up_thresh = float(gc.get("up_threshold", 0.5))
            self._cur_down_thresh = float(gc.get("down_threshold", 0.1))
            self._cur_up_step = float(gc.get("up_step", 0.005))
            self._cur_down_step = float(gc.get("down_step", 0.02))
            self._cur_window = int(gc.get("window_samples", 4))
            self._suc_win = collections.deque(maxlen=self._cur_window)
            self._strict_win = collections.deque(maxlen=64)
            self._best_cur_score = -1.0
            self._last_cur_save = 0.0

    def _set_curriculum_level(self, level: float):
        self._cur_level = float(np.clip(level, 0.0, 1.0))
        self.env_params = self.env_params.with_curriculum_level(self._cur_level)

    # ------------------------------------------------------------------ setup

    def reset(self):
        self.ts = init_train_state(self.ppo_cfg, self.static, self.env_params, self.seed)

    # ----------------------------------------------------------- checkpointing

    def _ckpt_payload(self, clone: bool = False) -> dict:
        """The learner state a checkpoint holds; ``clone`` copies every tensor
        on the device (the pipeline's per-epoch snapshot)."""
        ts = self.ts

        def tensors(d):
            return {k: v.detach().clone() if clone else v.detach() for k, v in d.items()}

        def opt_state(opt):
            s = opt.state_dict()
            return {"count": s["count"], "mu": tensors(s["mu"]), "nu": tensors(s["nu"])}

        payload = {
            "ac_state_dict": tensors(ts.actor_critic.state_dict()),
            "cv_state_dict": (tensors(ts.central_value.state_dict())
                              if ts.central_value is not None else None),
            "ac_opt_state": opt_state(ts.ac_opt),
            "cv_opt_state": opt_state(ts.cv_opt) if ts.cv_opt is not None else None,
            "lr": ts.lr.clone() if clone else ts.lr,
            "epoch": ts.epoch,
            "frame": ts.frame,
        }
        if self._cur_gated:
            # resume must not restart the curriculum from easy
            payload["curriculum_level"] = self._cur_level
        return payload

    def save(self, name: str, payload: Optional[dict] = None) -> str:
        """Write ``payload`` (default: the current learner state) to
        ``nn/<name>``; the train loop passes the snapshot of the epoch whose
        metrics triggered the save."""
        path = os.path.abspath(os.path.join(self.nn_dir, name))
        payload = payload if payload is not None else self._ckpt_payload()
        torch.save(_to_cpu(payload), path)
        return path

    def restore(self, path: str):
        """Load a checkpoint: a ``torch.save`` file of this runner, or a
        weights-only ``.npz`` policy (``convert.checkpoint_from_npz``). When
        its optimizer states do not match this learner's structure, fall back
        loudly to the weights, ``lr`` (where it has one), ``epoch`` and
        ``frame``, with fresh optimizers."""
        if self.ts is None:
            self.reset()
        ts = self.ts
        if str(path).endswith(".npz"):
            payload = checkpoint_from_npz(path, self.device)
        else:
            payload = torch.load(path, map_location=self.device, weights_only=True)
        ts.actor_critic.load_state_dict(payload["ac_state_dict"])
        if ts.central_value is not None:
            ts.central_value.load_state_dict(payload["cv_state_dict"])
        try:
            ts.ac_opt.load_state_dict(payload["ac_opt_state"])
            if ts.cv_opt is not None:
                ts.cv_opt.load_state_dict(payload["cv_opt_state"])
        except (KeyError, TypeError, ValueError) as e:
            print_warn(
                f"Checkpoint {path} does not match the full training-state structure "
                f"({type(e).__name__}: {e}); restored the weights only. Optimizer state "
                "is re-initialized."
            )
            ts.ac_opt, ts.cv_opt = make_optimizers(self.ppo_cfg, ts.actor_critic,
                                                   ts.central_value)
        if "lr" in payload:
            ts.lr = torch.as_tensor(payload["lr"], dtype=torch.float32, device=self.device)
        ts.epoch = int(payload["epoch"])
        ts.frame = int(payload["frame"])
        if "curriculum_level" in payload:
            self._set_curriculum_level(float(payload["curriculum_level"]))
            print_info(f"Restored curriculum level: {self._cur_level:.3f}")
        print_info(f"Restored checkpoint: {path}")

    # ---------------------------------------------------------------- training

    def _start_watchdog(self, timeout: float):
        """Failure detector for a wedged device: if no epoch completes within
        the current ``self._watchdog_timeout`` seconds, exit(42) so a
        supervisor can restart with a checkpoint. A blocked device call
        cannot be interrupted from Python, so a hard exit is the only
        reliable escape. The timeout is read each cycle, so the caller can
        arm it loose (first epoch) and tighten it once progress begins."""
        self._watchdog_timeout = timeout
        self._last_progress = time.time()
        self._watchdog_armed = True

        def watch():
            while self._watchdog_armed:
                t = self._watchdog_timeout
                time.sleep(min(max(t / 4, 1.0), 5.0))
                if not self._watchdog_armed:
                    return
                if time.time() - self._last_progress > t:
                    print_notify(f"WATCHDOG: no training progress for {t:.0f}s — "
                                 "exiting 42 for supervised restart")
                    os._exit(42)

        threading.Thread(target=watch, daemon=True).start()

    def _stop_watchdog(self):
        self._watchdog_armed = False

    # the first epoch builds the physics kernel; the watchdog runs with this
    # floor until it completes
    _FIRST_EPOCH_WATCHDOG_FLOOR = 1800.0

    def train(self, max_epochs: Optional[int] = None,
              watchdog_timeout: Optional[float] = None):
        if self.ts is None:
            self.reset()
        cfg = self.ppo_cfg
        epochs = max_epochs if max_epochs is not None else cfg.max_epochs
        t_start = time.time()
        if watchdog_timeout:
            self._start_watchdog(max(watchdog_timeout, self._FIRST_EPOCH_WATCHDOG_FLOOR))
        depth = max(1, cfg.host_pipeline_depth)
        pending = collections.deque()  # (epoch, device metrics, that epoch's snapshot)
        self._best_reward = -float("inf")
        last_t = time.time()
        stop = False

        def process(epoch: int, metrics: dict, dt: float, snapshot) -> bool:
            """Handle one epoch's fetched metrics; True = stop training."""
            self._last_progress = time.time()
            # the first PROCESSED epoch (start_epoch + 1 on a resume): drop the
            # first-epoch floor back to the caller's timeout
            if epoch == start_epoch + 1 and watchdog_timeout:
                self._watchdog_timeout = watchdog_timeout
            frame = int(metrics["info/frames"])
            # each finished episode contributes its own return (rl_games
            # game_rewards parity)
            fin_rets = np.asarray(metrics.pop("episodes/finished_returns"))
            fin_n = np.asarray(metrics.pop("episodes/finished_n"))
            if fin_n.sum() > 0:
                self.game_rewards.update(fin_rets[fin_n > 0])
            if self._cur_gated:
                self._curriculum_update(metrics, frame, snapshot)
            fps = cfg.horizon * self.static.num_envs / dt
            if self.writer is not None:
                for k, v in metrics.items():
                    self.writer.add_scalar(k, float(v), frame)
                self.writer.add_scalar("performance/fps", fps, frame)
                if self.game_rewards.current_size > 0:
                    self.writer.add_scalar("rewards0/frame", self.game_rewards.get_mean(), frame)
            if self.verbose or epoch % 10 == 0:
                print_info(
                    f"epoch {epoch}/{epochs} frames {frame} fps {fps:,.0f} "
                    f"ep_rew {self.game_rewards.get_mean():.1f} "
                    f"kl {float(metrics['info/kl']):.4f} lr {float(metrics['info/lr']):.2e}"
                )
            mean_rew = self.game_rewards.get_mean()
            if (epoch >= cfg.save_best_after and self.game_rewards.current_size > 0
                    and mean_rew > self._best_reward):
                self._best_reward = mean_rew
                self.save("best", snapshot)
            if cfg.save_frequency and epoch % cfg.save_frequency == 0:
                self.save("last", snapshot)
            if self.game_rewards.current_size > 0 and mean_rew >= cfg.score_to_win:
                print_notify(f"score_to_win reached ({mean_rew:.1f} >= {cfg.score_to_win}); "
                             "stopping early")
                return True
            if not np.isfinite(float(metrics["info/kl"])):
                # the parameters are garbage once kl is non-finite: halt, and
                # keep the FIRST bad epoch's state, not the pipeline head
                print_error(f"non-finite kl at epoch {epoch}; halting")
                self.save("nan_halt", snapshot)
                return True
            return False

        # max_epochs is a TOTAL budget across restarts: a resume restores
        # ts.epoch from the checkpoint and trains the remainder
        start_epoch = int(self.ts.epoch)
        if start_epoch >= epochs:
            # a finished run re-invoked with the same budget must not
            # overwrite its final checkpoint with the restored state
            print_notify(f"resumed at epoch {start_epoch} >= max_epochs {epochs}; "
                         "nothing to train")
            self._stop_watchdog()
            return self.game_rewards.get_mean()

        def pop_and_process():
            nonlocal last_t
            e, m, snap = pending.popleft()
            now = time.time()
            dt, last_t = now - last_t, now
            return process(e, fetch_metrics(m), dt, snap)

        try:
            for epoch in range(start_epoch + 1, epochs + 1):
                metrics = self._train_iter(cfg, self.static, self.env_params, self.ts)
                # at depth 1 the epoch is processed now, on the current state
                pending.append((epoch, metrics,
                                self._ckpt_payload(clone=True) if depth > 1 else None))
                if len(pending) >= depth:
                    stop = pop_and_process()
                    if stop:
                        break
            while pending and not stop:
                stop = pop_and_process()
        finally:
            # the watchdog must not shoot a process that now does something
            # else (eval, checkpoint IO, a long-lived test session)
            self._stop_watchdog()
        self.save("final")
        print_notify(
            f"Training done: epoch {int(self.ts.epoch)}/{epochs}, {int(self.ts.frame)} frames, "
            f"{time.time() - t_start:.0f}s, best ep reward {self._best_reward:.1f}"
        )
        return self.game_rewards.get_mean()

    def _curriculum_update(self, metrics: dict, frame: int, snapshot):
        """One epoch of the success-gated controller."""
        fc = float(metrics.get("episodes/finished_count", 0.0))
        self._strict_win.append(float(metrics.get("env/strict_success_frac", 0.0)))
        if fc <= 0:
            return
        # one sample per synchronised episode boundary: successes per
        # finished episode under the CURRENT tolerances
        spe = float(metrics["episodes/finished_success_sum"]) / fc
        self._suc_win.append(spe)
        m = float(np.mean(self._suc_win))
        lvl = self._cur_level
        if len(self._suc_win) == self._suc_win.maxlen and m > self._cur_up_thresh:
            lvl += self._cur_up_step
        elif m < self._cur_down_thresh and lvl > 0.0:
            lvl -= self._cur_down_step
        if lvl != self._cur_level:
            self._set_curriculum_level(lvl)
        if self.writer is not None:
            self.writer.add_scalar("curriculum/success_per_episode", spe, frame)
            self.writer.add_scalar("curriculum/level_target", self._cur_level, frame)
        # capability checkpoint: highest level reached, ties broken by
        # strict-tolerance success; throttled to one save a minute
        score = (float(metrics.get("env/curriculum_level", 0.0)) * 10.0
                 + float(np.mean(self._strict_win)))
        now = time.time()
        if score > self._best_cur_score and now - self._last_cur_save > 60.0:
            self._best_cur_score = score
            self._last_cur_save = now
            self.save("best_curriculum", snapshot)

    # ---------------------------------------------------------------- playing

    def make_policy(self, deterministic: bool = True,
                    curriculum_level: Optional[float] = None):
        """The deployment-side policy: ``(obs, generator=None) -> action``
        over the current actor, with the training-time obs and action clips.
        In success-gated curriculum mode the env is set to full difficulty
        (level 1.0) unless ``curriculum_level`` overrides it."""
        if self._cur_gated:
            lvl = 1.0 if curriculum_level is None else float(curriculum_level)
            self.env.params = self.env.params.with_curriculum_level(lvl)
            print_info(f"play: curriculum level {lvl:.2f}")
        cfg = self.ppo_cfg
        actor_critic = self.ts.actor_critic

        @torch.no_grad()
        def policy(obs, generator: Optional[torch.Generator] = None):
            mu, log_std, _ = actor_critic(torch.clamp(obs, -cfg.clip_obs, cfg.clip_obs))
            action = mu
            if not deterministic:
                action = mu + torch.exp(log_std) * torch.randn(
                    mu.shape, generator=generator, device=mu.device)
            return torch.clamp(action, -cfg.clip_actions, cfg.clip_actions)

        return policy

    def wrap_env(self, env=None):
        """The inference-side obs wrappers the policy was trained with:
        FrameStack when ``frames > 1``."""
        from leibnizgym_tpu_torch.wrappers import stack_if_frames

        return stack_if_frames(env if env is not None else self.env, self.ppo_cfg.frames)

    def play(self, checkpoint: Optional[str] = None, num_steps: int = 1000,
             deterministic: bool = True, curriculum_level: Optional[float] = None):
        """Run the trained policy; returns the mean accumulated reward."""
        if self.ts is None:
            self.reset()
        if checkpoint:
            self.restore(checkpoint)
        policy = self.make_policy(deterministic, curriculum_level)
        env = self.wrap_env()
        obs = env.reset()
        generator = torch.Generator(device=self.device).manual_seed(0)
        total_reward = torch.zeros(self.static.num_envs, dtype=torch.float64,
                                   device=self.device)
        for _ in range(num_steps):
            obs, reward, _, _ = env.step(policy(obs, generator))
            total_reward += reward
        mean_r = float(total_reward.mean())
        print_info(f"play: {num_steps} steps, mean accumulated reward {mean_r:.1f}")
        return mean_r


def _to_cpu(x):
    if torch.is_tensor(x):
        return x.detach().cpu()
    if isinstance(x, dict):
        return {k: _to_cpu(v) for k, v in x.items()}
    return x
