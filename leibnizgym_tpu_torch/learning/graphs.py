"""The PPO epoch as CUDA-graph replays (the counterpart of the reference's
``jax.jit(train_iteration)``, ``learning/runner.py:105`` and
``learning/train.py:107``, whose ``lax.scan`` loops keep the whole epoch on
the device).

``GraphedEpoch`` is called like ``ppo.train_iteration`` and computes the
same epoch from the same draws. It captures four graphs that share one
memory pool:

- ``rollout``: the whole horizon (policy, action noise, env step with its
  physics kernel launch, episode bookkeeping), then the new carry written
  into the learner's carry tensors in place;
- ``gae``: the last value, GAE, advantage normalisation and the minibatch
  sources, and the two step counters set to 0;
- ``ac``: one actor-critic minibatch step (forward, ``torch.autograd.grad``,
  clip + Adam, adaptive lr written into ``ts.lr``); its minibatch is
  ``index_select`` of the row of a static index buffer that a device counter
  names, and its loss terms go into that counter's column of a static
  buffer, so its replays go back to back;
- ``cv``: one central-value step, the same way.

Granularity: the rollout is one graph for the whole horizon rather than
one per env step, since a per-step graph would need an output slot per step
and the horizon's tens of thousands of nodes then launch as one call; a
minibatch step is one graph, replayed ``mini_epochs x minibatches`` times,
since the count depends on the layout and one step holds a few hundred
nodes. An epoch is ``2 + steps`` graph launches besides the draws.

Draws: the action noise, the env draws and the permutations come from the
train state's generator, drawn on the host's side of the graph in the order
``ppo.train_iteration`` draws them (per step the noise, then the env draws;
then the permutations), and copied into static buffers; a caller may pass
them as ``train_iteration`` takes them. So the graphed epoch equals the
eager one fed the same generator state or the same draws.

Capture: the first epoch after set-up runs the same bodies eagerly on a side
stream (the warm-up that PyTorch's CUDA-graph notes ask for, and a real
epoch: its launches are counted and its metrics returned), then captures the
graphs; later epochs replay them. A capture that fails raises; nothing falls
back to eager. The graphs read the learner's own tensors (parameters, Adam
moments and counts, ``ts.lr``, the carry) and the env params (the
success-gated curriculum level, written in place by the runner). A
checkpoint restore writes into those tensors in place, so the graphs stay
valid; anything that replaces one of those objects (a new train state,
fresh optimizers after a restore that does not match, new env params) makes
the next epoch set up and capture again.

Pool sharing is safe because the graphs replay in the order they were
captured, and everything an epoch returns is computed or copied out of the
graphs' buffers before the next epoch's rollout replays.

On the CPU nothing is captured: every epoch runs the bodies, which is how
the CPU tests hold them to ``train_iteration``. The data-parallel epoch (a
``ts.shard``) and ``nan_telemetry`` are not captured (``Runner`` runs them
eagerly); ``GraphedEpoch`` raises on them.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import torch

from leibnizgym_tpu_torch.envs.trifinger.env import (
    EnvParams,
    EnvStatic,
    clone_nested,
    copy_nested_,
    draw_step_randoms,
)
from leibnizgym_tpu_torch.learning import ppo
from leibnizgym_tpu_torch.ops import cuda_engine

__all__ = ["GraphedEpoch"]


class GraphedEpoch:
    """``ppo.train_iteration`` captured as CUDA graphs on a CUDA device, its
    bodies run eagerly on the CPU (module docstring)."""

    def __init__(self):
        self._key = None
        self.graphs: Optional[Dict[str, cuda_engine.CountedGraph]] = None

    # ----------------------------------------------------------------- set-up

    def _setup(self, cfg: ppo.PPOConfig, static: EnvStatic, params: EnvParams,
               ts: ppo.TrainState) -> None:
        self.cfg, self.static, self.params, self.ts = cfg, static, params, ts
        self.graphs = None
        self.pool = None
        device = ts.lr.device
        h, n = cfg.horizon, static.num_envs
        self.asym = ts.central_value is not None
        (ac_mb, ac_w, _), cv = ppo._layouts(cfg, h, n, self.asym)
        self.ac_steps = cfg.mini_epochs * ac_mb
        self.cv_steps = cfg.cv_mini_epochs * cv[0] if self.asym else 0
        self.ac_idx = torch.zeros((self.ac_steps, ac_w), dtype=torch.int64, device=device)
        self.ac_step = torch.zeros(1, dtype=torch.int64, device=device)
        self.ac_terms = torch.zeros((5, self.ac_steps), dtype=torch.float32, device=device)
        if self.asym:
            self.cv_idx = torch.zeros((self.cv_steps, cv[1]), dtype=torch.int64, device=device)
            self.cv_step = torch.zeros(1, dtype=torch.int64, device=device)
            self.cv_losses = torch.zeros(self.cv_steps, dtype=torch.float32, device=device)
        self.noise = self.env_draws = None  # the first epoch's draws become the buffers

    def _check(self, cfg, static, params, ts) -> None:
        if ts.shard is not None:
            raise ValueError("GraphedEpoch does not capture the data-parallel epoch; "
                             "use ppo.train_iteration")
        if cfg.nan_telemetry:
            raise ValueError("GraphedEpoch does not capture nan_telemetry; "
                             "use ppo.train_iteration")
        key = (cfg, static, params, ts, ts.actor_critic, ts.central_value, ts.ac_opt,
               ts.cv_opt, ts.lr, ts.carry, ts.carry.env_state)
        if self._key is None or any(a is not b for a, b in zip(key, self._key)):
            self._setup(cfg, static, params, ts)
            self._key = key

    def _load_draws(self, noise, env_draws, perms) -> None:
        """This epoch's draws into the static buffers, drawn from the train
        state's generator in ``train_iteration``'s order where not given."""
        cfg, st, ts = self.cfg, self.static, self.ts
        device, n = ts.lr.device, st.num_envs
        like = ts.carry.obs
        steps_noise, steps_draws = [], []
        for t in range(cfg.horizon):
            steps_noise.append(noise[t] if noise is not None else torch.randn(
                (n, st.action_dim), generator=ts.generator, device=device))
            steps_draws.append(env_draws[t] if env_draws is not None else draw_step_randoms(
                st, ts.generator, n, device, like.dtype))
        if perms is None:
            perms = ppo.draw_permutations(cfg, cfg.horizon, n, self.asym, ts.generator, device)
        # env_step's layout: six blocks, None where the config draws none
        steps_draws = [(tuple(d) + (None,) * 6)[:6] for d in steps_draws]
        if self.noise is None:
            self.noise = torch.stack(steps_noise)
            self.env_draws = [clone_nested(d) for d in steps_draws]
        else:
            self.noise.copy_(torch.stack(steps_noise) if noise is None else noise)
            for dst, src in zip(self.env_draws, steps_draws):
                copy_nested_(dst, src)
        ac_idx, cv_idx = ppo.minibatch_indices(cfg, cfg.horizon, n, self.asym, perms)
        self.ac_idx.copy_(ac_idx)
        if self.asym:
            self.cv_idx.copy_(cv_idx)

    # ----------------------------------------------------------------- bodies

    def _rollout_body(self) -> None:
        ts = self.ts
        carry, self.traj = ppo.rollout(self.cfg, self.static, self.params, ts.carry,
                                       ts.actor_critic, ts.central_value, noise=self.noise,
                                       env_draws=self.env_draws)
        ts.carry.copy_(carry)

    def _gae_body(self) -> None:
        ts = self.ts
        with torch.no_grad():
            _, _, last_value = ppo.policy_and_value(ts.actor_critic, ts.central_value,
                                                    ts.carry.obs, ts.carry.states)
            advs, returns = ppo.advantages(self.cfg, self.traj, last_value)
        self.ac_data, self.cv_data = ppo.minibatch_sources(self.cfg, self.traj, advs, returns,
                                                           self.asym)
        self.ac_step.zero_()
        if self.asym:
            self.cv_step.zero_()

    def _ac_body(self) -> None:
        ts = self.ts
        idx = self.ac_idx.index_select(0, self.ac_step).reshape(-1)
        mb = {k: v.index_select(0, idx) for k, v in self.ac_data.items()}
        lr, terms = ppo.actor_critic_step(self.cfg, ts.actor_critic, ts.ac_opt, ts.lr, mb)
        with torch.no_grad():
            ts.lr.copy_(lr)
            self.ac_terms.index_copy_(1, self.ac_step, torch.stack(terms)[:, None])
            self.ac_step.add_(1)

    def _cv_body(self) -> None:
        ts = self.ts
        idx = self.cv_idx.index_select(0, self.cv_step).reshape(-1)
        states, returns = self.cv_data
        loss = ppo.central_value_step(self.cfg, ts.central_value, ts.cv_opt,
                                      states.index_select(0, idx), returns.index_select(0, idx))
        with torch.no_grad():
            self.cv_losses.index_copy_(0, self.cv_step, loss[None])
            self.cv_step.add_(1)

    def _phases(self):
        return (("rollout", self._rollout_body, 1), ("gae", self._gae_body, 1),
                ("ac", self._ac_body, self.ac_steps), ("cv", self._cv_body, self.cv_steps))

    # ------------------------------------------------------------------- epoch

    def _run(self, on_phase, replay: bool) -> None:
        for name, body, times in self._phases():
            for _ in range(times):
                self.graphs[name].replay() if replay else body()
            if on_phase is not None and name != "ac":
                on_phase("update" if name == "cv" else name)

    def _metrics(self) -> Dict[str, torch.Tensor]:
        cfg = self.cfg
        return ppo.finish_epoch(cfg, self.ts, self.traj, list(self.ac_terms),
                                self.cv_losses if self.asym else None,
                                cfg.horizon * self.static.num_envs, clone=True)

    def _capture_graphs(self) -> None:
        cuda_engine.prepare(self.ts.lr.device)
        self.pool = torch.cuda.graph_pool_handle()
        graphs = {}
        for name, body, times in self._phases():
            if times:
                graphs[name] = cuda_engine.CountedGraph()
                with graphs[name].capture(pool=self.pool):
                    body()
        self.graphs = graphs

    def __call__(self, cfg: ppo.PPOConfig, static: EnvStatic, env_params: EnvParams,
                 ts: ppo.TrainState, noise: Optional[torch.Tensor] = None,
                 env_draws: Optional[Sequence] = None,
                 perms: Optional[Sequence[torch.Tensor]] = None,
                 on_phase: Optional[Callable[[str], None]] = None) -> Dict[str, torch.Tensor]:
        """One epoch on ``ts``, in place, as ``ppo.train_iteration``; the
        metrics are the same dict, every tensor in memory of its own."""
        self._check(cfg, static, env_params, ts)
        self._load_draws(noise, env_draws, perms)
        if not ts.lr.is_cuda:
            self._run(on_phase, replay=False)
            return self._metrics()
        if self.graphs is not None:
            self._run(on_phase, replay=True)
            return self._metrics()
        # the warm-up: this epoch, eagerly, on a side stream; then capture
        main = torch.cuda.current_stream()
        side = torch.cuda.Stream()
        side.wait_stream(main)
        with torch.cuda.stream(side):
            self._run(on_phase, replay=False)
            metrics = self._metrics()
        main.wait_stream(side)
        self._capture_graphs()
        return metrics
