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

Data parallelism: where a process group exists (``parallel.
initialize_distributed``, ``args.multihost``), the Runner is one rank of
it. Its env steps ``num_instances / W`` envs (an error when W does not
divide it), its learner is rank 0's, broadcast at reset, and the epoch's
reductions are collectives (``learning/ppo.py``), so every rank sees the
same metrics, curriculum level and stopping decisions. Only rank 0 writes
the log directory, TensorBoard and checkpoints. Every rank restores a
checkpoint, and since the learner is replicated, a checkpoint of a W-rank
run restores in a 1-rank run and the other way round. Each rank runs its
own watchdog; the process group's timeout bounds a collective whose peer
has exited.

``visualize=True`` opens the live viewer (``utils/viewer.py``), drawn at
every ``play`` step.

On a CUDA device ``train`` runs each epoch as CUDA-graph replays
(``learning/graphs.py``, the counterpart of the reference's
``jax.jit(train_iteration)``), alone, as a rank of an NCCL group (its
collectives captured) and with ``nan_telemetry``; the epoch and frame
bookkeeping, the metrics pipeline and the curriculum controller stay on the
host. The controller writes the level into the env params' tensor in place,
a restore writes into the learner's tensors in place, and the pipeline's
pending metrics and snapshots are copies. The play policy of
``make_policy`` replays a graph too (the reference jits it), beside the
env's captured step. Under a gloo group on a card the epoch runs eagerly and
says so: gloo runs its collectives on the host.

With ``nan_telemetry`` the loop runs at depth 1 and keeps the whole train
state before each epoch (``nan_dump_payload``: the checkpoint payload, the
rollout carry and the generator's state, cloned on the device). A halt on a
non-finite KL prints the epoch's ``nan/*`` metrics and writes that state as
``nan_prev_ts.pt`` into the logdir, beside ``env_config.yaml`` and
``agent_config.yaml``, for ``scripts/nan_replay.py``.

Tracing (``utils/trace.py``, in memory; ranges in a ``torch.profiler``
trace while one records): ``train`` is a ``runner.train`` span, each
host-loop iteration a ``runner.iteration`` (its ``epoch``) holding
``epoch`` (the epoch function; ``replays``: its graph replays, from
``ops/capture.py`` ``replay_count``; ``launches``: its hand-written kernels'
launches, from ``cuda_engine.launch_count``, a replay adding those its
graph captured; as a rank of a process group ``collectives``:
the change of its ``DataShard.counts`` by kind, which a graph's replays add
to), ``runner.snapshot``, ``runner.readback``
(``read``: the epoch read back) and ``runner.process`` with
``runner.summary``, ``runner.curriculum`` and ``runner.checkpoint``
(``name``; every ``_write``); Python's collections of generations 1 and 2
are ``host.gc`` spans while ``train`` runs. An epoch's device marks are
resolved once its metrics have been read back.
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
import torch.distributed as dist
import yaml

from leibnizgym_tpu_torch.utils.helpers import resolve_device as _resolve_device
from leibnizgym_tpu_torch.utils.message import print_error, print_info, print_notify, print_warn
# the module, not its function: convert imports learning.ppo, so this
# package, and may be the one still importing
from leibnizgym_tpu_torch import convert
from leibnizgym_tpu_torch.envs.trifinger.env import TrifingerEnv, env_state_tensors
from leibnizgym_tpu_torch.learning.ppo import (
    PPOConfig,
    TrainState,
    init_train_state,
    make_optimizers,
)
from leibnizgym_tpu_torch.learning.graphs import GraphedPolicy, epoch_for
from leibnizgym_tpu_torch.ops import capture, cuda_engine
from leibnizgym_tpu_torch.parallel.mesh import all_reduce_mean_, data_shard
from leibnizgym_tpu_torch.utils import trace


def resolve_device(name) -> torch.device:
    """The torch device for an ``args.device`` string. The shared config's
    default ``"TPU"`` means ``cuda:0``; a CUDA device without a card is an
    error, never a silent CPU run."""
    return _resolve_device(name, cpu_hint="args.device=cpu")


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
    """Owns env + learner on one device, as one rank where a process group
    exists; trains or plays."""

    shard = None  # this rank's DataShard, or None alone

    @property
    def is_main(self) -> bool:
        """Rank 0, or the only process: the one that writes."""
        return self.shard is None or self.shard.rank == 0

    @property
    def num_envs_global(self) -> int:
        return self.shard.n_global if self.shard is not None else self.static.num_envs

    def __init__(self, task_cfg: dict, agent_params: dict, logdir: str = "logs",
                 seed: int = 7, verbose: bool = False, device="TPU",
                 visualize: bool = False):
        self.verbose = verbose
        self.device = resolve_device(device)
        num_actors = int(task_cfg.get("num_instances", 256))
        self.ppo_cfg = PPOConfig.from_rlg_params(agent_params, num_actors)
        if dist.is_available() and dist.is_initialized():
            self.shard = data_shard(num_actors)
        self.env = TrifingerEnv(config=task_cfg, device=self.device, verbose=verbose,
                                visualize=visualize, shard=self.shard)
        # the learner's params; the env keeps its own level tensor for play
        # (make_policy), so that play does not move the trained level
        self.static, self.env_params = self.env.static, self.env.params
        self.env.params = self.env_params.with_curriculum_level(0.0)
        self.seed = seed

        # log directories (reference run_rlg: nn/, runs/, timestamped), rank 0's
        stamp = datetime.now().strftime("%m-%d-%Y-%H-%M-%S")
        self.logdir = os.path.join(logdir, stamp)
        self.nn_dir = os.path.join(self.logdir, "nn")
        self.writer = None
        if self.is_main:
            os.makedirs(self.nn_dir, exist_ok=True)
            with open(os.path.join(self.logdir, "agent_config.yaml"), "w") as f:
                yaml.dump(agent_params, f)
            self.env.dump_config(os.path.join(self.logdir, "env_config.yaml"))
            writer_cls = _summary_writer_cls()
            if writer_cls is not None:
                self.writer = writer_cls(os.path.join(self.logdir, "summaries"))
            print_notify(f"Saving logs at: {self.logdir}")
        if self.shard is not None and self.is_main:
            print_info(f"Runner: {num_actors} envs over {self.shard.world} ranks "
                       f"({dist.get_backend()}), {self.shard.n_local} on each")

        self._train_iter = epoch_for(self.device, self.shard, "Runner: ")
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
        # in place: the captured epoch reads the level's tensor
        self._cur_level = float(np.clip(level, 0.0, 1.0))
        self.env_params.set_curriculum_level_(self._cur_level)

    # ------------------------------------------------------------------ setup

    def reset(self):
        self.ts = init_train_state(self.ppo_cfg, self.static, self.env_params, self.seed,
                                   shard=self.shard)

    # ----------------------------------------------------------- checkpointing

    def _ckpt_payload(self, clone: bool = False, ts: Optional[TrainState] = None) -> dict:
        """The learner state a checkpoint holds, of ``ts`` (default: the
        current train state); ``clone`` copies every tensor on the device (the
        pipeline's per-epoch snapshot)."""
        ts = ts if ts is not None else self.ts

        def tensors(d):
            return {k: v.detach().clone() if clone else v.detach() for k, v in d.items()}

        def opt_state(opt):
            s = opt.state_dict()
            return {"count": s["count"].clone() if clone else s["count"],
                    "mu": tensors(s["mu"]), "nu": tensors(s["nu"])}

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

    def nan_dump_payload(self) -> dict:
        """The whole train state, cloned on the device: the checkpoint
        payload, the rollout carry (every env state tensor by its
        ``env_state_tensors`` name, ``frames``, obs, states, episode
        accumulators) and the state of the train state's generator, which
        draws the next epoch's action noise, env draws and permutations."""
        ts = self.ts
        carry = ts.carry
        payload = self._ckpt_payload(clone=True)
        payload["carry"] = {
            "env_state": {k: v.clone() for k, v in env_state_tensors(carry.env_state).items()},
            "frames": carry.env_state.frames.clone(),
            "obs": carry.obs.clone(), "states": carry.states.clone(),
            "ep_return": carry.ep_return.clone(), "ep_len": carry.ep_len.clone(),
        }
        payload["generator_state"] = ts.generator.get_state()
        payload["generator_device"] = str(ts.generator.device)
        return payload

    def save(self, name: str, ts: Optional[TrainState] = None, wait: bool = True) -> Optional[str]:
        """Checkpoint ``ts`` (default: the current train state) to
        ``nn/<name>``. Returns the absolute path; None on a rank other than
        0, which writes nothing. ``torch.save`` is synchronous, so the file is
        complete on return and ``wait`` has no effect; it is kept for the
        reference's signature, whose checkpointer commits in the
        background."""
        return self._write(name, self._ckpt_payload(ts=ts))

    def _write(self, name: str, payload: Optional[dict] = None) -> Optional[str]:
        """Write ``payload`` (a ``_ckpt_payload``; None: the current learner
        state) to ``nn/<name>`` on rank 0. The train loop passes the snapshot
        of the epoch whose metrics triggered the save."""
        if not self.is_main:
            return None
        with trace.span("runner.checkpoint", name=name):
            path = os.path.abspath(os.path.join(self.nn_dir, name))
            payload = payload if payload is not None else self._ckpt_payload()
            torch.save(_to_cpu(payload), path)
        return path

    def flush_saves(self):
        """Wait for in-flight checkpoints: none, every ``save`` is
        synchronous (the reference's are committed in the background)."""

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
            payload = convert.checkpoint_from_npz(path, self.device)
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
            ts.lr.copy_(torch.as_tensor(payload["lr"], dtype=torch.float32).reshape(()))
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
        trace.sync_clock()
        with trace.span("runner.train"), trace.gc_spans():
            return self._train(max_epochs, watchdog_timeout)

    def _train(self, max_epochs: Optional[int], watchdog_timeout: Optional[float]):
        if self.ts is None:
            self.reset()
        cfg = self.ppo_cfg
        epochs = max_epochs if max_epochs is not None else cfg.max_epochs
        t_start = time.time()
        if watchdog_timeout:
            self._start_watchdog(max(watchdog_timeout, self._FIRST_EPOCH_WATCHDOG_FLOOR))
        # nan_telemetry needs the state just before the first bad epoch
        depth = 1 if cfg.nan_telemetry else max(1, cfg.host_pipeline_depth)
        pending = collections.deque()  # (epoch, device metrics, that epoch's snapshot)
        shard = self.shard
        prev_state = None  # nan_telemetry: the state before the running epoch
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
                with trace.span("runner.curriculum"):
                    self._curriculum_update(metrics, frame, snapshot)
            fps = cfg.horizon * self.num_envs_global / dt
            if self.writer is not None:
                with trace.span("runner.summary"):
                    for k, v in metrics.items():
                        self.writer.add_scalar(k, float(v), frame)
                    self.writer.add_scalar("performance/fps", fps, frame)
                    if self.game_rewards.current_size > 0:
                        self.writer.add_scalar("rewards0/frame", self.game_rewards.get_mean(),
                                               frame)
            if self.is_main and (self.verbose or epoch % 10 == 0):
                print_info(
                    f"epoch {epoch}/{epochs} frames {frame} fps {fps:,.0f} "
                    f"ep_rew {self.game_rewards.get_mean():.1f} "
                    f"kl {float(metrics['info/kl']):.4f} lr {float(metrics['info/lr']):.2e}"
                    + (f" level {float(metrics.get('env/curriculum_level', 0.0)):.3f}"
                       if self._cur_gated else "")
                )
            mean_rew = self.game_rewards.get_mean()
            if (epoch >= cfg.save_best_after and self.game_rewards.current_size > 0
                    and mean_rew > self._best_reward):
                self._best_reward = mean_rew
                self._write("best", snapshot)
            if cfg.save_frequency and epoch % cfg.save_frequency == 0:
                self._write("last", snapshot)
            if self.game_rewards.current_size > 0 and mean_rew >= cfg.score_to_win:
                print_notify(f"score_to_win reached ({mean_rew:.1f} >= {cfg.score_to_win}); "
                             "stopping early")
                return True
            if not np.isfinite(float(metrics["info/kl"])):
                # the parameters are garbage once kl is non-finite: halt, and
                # keep the FIRST bad epoch's state, not the pipeline head
                print_error(f"non-finite kl at epoch {epoch}; halting. " + " ".join(
                    f"{k}={float(v):.3g}" for k, v in sorted(metrics.items())
                    if k.startswith("nan/")))
                if prev_state is not None and self.is_main:
                    path = os.path.join(self.logdir, "nan_prev_ts.pt")
                    torch.save(_to_cpu(prev_state), path)
                    print_error(f"pre-nan train state dumped to {path}")
                self._write("nan_halt", snapshot)
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
            e, m, snap, epoch_span = pending.popleft()
            now = time.time()
            dt, last_t = now - last_t, now
            with trace.span("runner.readback", read=e):
                m = fetch_metrics(m)
            # the read-back waited for the epoch's device marks
            trace.resolve(epoch_span)
            with trace.span("runner.process"):
                return process(e, m, dt, snap)

        try:
            for epoch in range(start_epoch + 1, epochs + 1):
                with trace.iteration(epoch):
                    if cfg.nan_telemetry:
                        prev_state = self.nan_dump_payload()
                    with trace.span("epoch") as epoch_span:
                        replays = capture.replay_count
                        launches = cuda_engine.launch_count
                        issued = collections.Counter(shard.counts) if shard is not None else None
                        metrics = self._train_iter(cfg, self.static, self.env_params, self.ts)
                        epoch_span.attrs["replays"] = capture.replay_count - replays
                        epoch_span.attrs["launches"] = cuda_engine.launch_count - launches
                        if shard is not None:
                            epoch_span.attrs["collectives"] = dict(shard.counts - issued)
                    # at depth 1 the epoch is processed now, on the current state
                    snapshot = None
                    if depth > 1:
                        with trace.span("runner.snapshot"):
                            snapshot = self._ckpt_payload(clone=True)
                    pending.append((epoch, metrics, snapshot, epoch_span))
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
            self._write("best_curriculum", snapshot)

    # ---------------------------------------------------------------- playing

    def make_policy(self, deterministic: bool = True,
                    curriculum_level: Optional[float] = None):
        """The deployment-side policy: ``(obs, generator=None) -> action``
        over the current actor, with the training-time obs and action clips
        (``graphs.GraphedPolicy``: one CUDA graph on the card). In
        success-gated curriculum mode the env is set to full difficulty
        (level 1.0) unless ``curriculum_level`` overrides it."""
        if self._cur_gated:
            lvl = 1.0 if curriculum_level is None else float(curriculum_level)
            self.env.params.set_curriculum_level_(lvl)
            print_info(f"play: curriculum level {lvl:.2f}")
        return GraphedPolicy(self.ppo_cfg, self.ts.actor_critic, self.num_envs_global,
                             deterministic, self.shard)

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
            if self.env.visualize:  # live viewer (reference render-per-step)
                self.env.render()
        mean_r = total_reward.mean()
        if self.shard is not None:
            all_reduce_mean_([mean_r], self.shard)
        mean_r = float(mean_r)
        print_info(f"play: {num_steps} steps, mean accumulated reward {mean_r:.1f}")
        return mean_r


def _to_cpu(x):
    if torch.is_tensor(x):
        return x.detach().cpu()
    if isinstance(x, dict):
        return {k: _to_cpu(v) for k, v in x.items()}
    return x
