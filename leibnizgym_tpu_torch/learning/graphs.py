"""The PPO epoch and the play policy as CUDA-graph replays (the counterpart of
the reference's ``jax.jit(train_iteration)``, ``learning/runner.py:105`` and
``learning/train.py:107``, whose ``lax.scan`` loops keep the whole epoch on
the device, and of its jitted ``_policy``, ``learning/runner.py:517``).

``GraphedEpoch`` is called like ``ppo.train_iteration`` and computes the
same epoch from the same draws, alone, as one rank of an NCCL process group
(``ts.shard``) and with ``nan_telemetry``. It captures four graphs that
share one memory pool:

- ``rollout``: the whole horizon (policy, action noise, env step with its
  physics and fingertip kernel launches, episode bookkeeping), then the new
  carry written into the learner's carry tensors in place;
- ``gae``: the last value, GAE, advantage normalisation (under a shard its
  two all-reduces) and the minibatch sources (under a shard and the
  global-shuffle layout, the trajectory's all-gather), and the two step
  counters set to 0;
- ``ac``: one actor-critic minibatch step (forward, ``torch.autograd.grad``,
  under a shard the gradients' and KL's all-reduce, clip + Adam, adaptive lr
  written into ``ts.lr``); its minibatch is ``index_select`` of the row of a
  static index buffer that a device counter names, and its loss terms (with
  ``nan_telemetry`` a sixth row, the pre-clip gradient norm) go into that
  counter's column of a static buffer, so its replays go back to back;
- ``cv``: one central-value step, the same way.

After the replays, ``ppo.finish_epoch`` assembles the metrics eagerly from
the graphs' buffers, as ``ppo.update`` does after its steps: the ``nan/*``
metrics, then under a shard the metrics' all-reduce. So the epoch's
collectives are captured but that one (two with ``nan_telemetry``), which
shares the communicator with them.

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
them as ``train_iteration`` takes them. Under a shard the noise and env
draws are the global blocks, of which the buffers keep the rank's rows, and
the permutations run over the global batch. So the graphed epoch equals the
eager one fed the same generator state or the same draws, and a NaN dump
(which holds the generator's state) replays eagerly.

Collectives: NCCL issues its kernels on its own stream, joined to the
capturing stream by events, so a graph holds them; gloo runs its
collectives on the host, which a graph cannot hold, so a gloo shard on a
CUDA device raises here and ``epoch_for`` gives the eager epoch for it,
saying so. The communicator is made at the learner's first broadcast,
before any capture. ``DataShard.counts`` is counted in Python, so each
graph records the collectives it captured and each replay adds them; every
capture runs in ``thread_local`` error mode, since a process group's
watchdog thread queries CUDA events while it is open (both
``ops/capture.py`` ``CountedGraph``).

Capture: the first epoch after set-up runs the same bodies eagerly on a side
stream (``capture.warm_up``; a real epoch: its launches and collectives are
counted and its metrics returned), then captures the graphs; later epochs
replay them. A capture that fails raises; nothing falls back to eager. The
graphs read the learner's own tensors (parameters, Adam moments and
counts, ``ts.lr``, the carry) and the env params (the success-gated
curriculum level, written in place by the runner). A checkpoint restore writes into those tensors in place, so the
graphs stay valid; anything that replaces one of those objects (a new train
state, fresh optimizers after a restore that does not match, new env
params) makes the next epoch set up and capture again.

Pool sharing is safe because the graphs replay in the order they were
captured, and everything an epoch returns is computed or copied out of the
graphs' buffers before the next epoch's rollout replays.

``GraphedPolicy`` is ``Runner.make_policy``'s policy: one graph of the obs
clamp, the actor's forward, the noise and the action clamp
(``capture.Captured``), its noise drawn outside (under a shard the global
block's rows), captured again when the obs or noise layout changes; the
action is cloned out.

On the CPU nothing is captured: every call runs the bodies, which is how the
CPU tests hold them to ``train_iteration`` and the eager policy.

Tracing (``utils/trace.py``): an epoch's spans are ``epoch.setup`` (on a
new key the buffers, on the card also the warm-up epoch and the capture),
``epoch.draws``, ``epoch.launch.rollout`` / ``.gae`` / ``.update`` (each
phase's replays; off the card its bodies, each run counted in
``capture.replay_count`` as the replay it stands for) and
``epoch.metrics``; the device marks go at the epoch's start and after each
phase, on the epoch's stream (the warm-up's on its side stream), never
inside a capture.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import torch

from leibnizgym_tpu_torch.envs.trifinger.env import EnvParams, EnvStatic, draw_step_randoms
from leibnizgym_tpu_torch.learning import ppo
from leibnizgym_tpu_torch.ops import capture
from leibnizgym_tpu_torch.parallel.mesh import DataShard, shard_batch
from leibnizgym_tpu_torch.utils import trace
from leibnizgym_tpu_torch.utils.message import print_info

__all__ = ["GraphedEpoch", "GraphedPolicy", "epoch_for"]


def _capturable(shard: Optional[DataShard]) -> bool:
    """Whether a CUDA graph can hold ``shard``'s collectives (none without
    a shard)."""
    return shard is None or shard.backend == "nccl"


def epoch_for(device: torch.device, shard: Optional[DataShard] = None, who: str = "") -> Callable:
    """The epoch function of a caller on ``device``: ``GraphedEpoch()`` on a
    CUDA device without a process group or under NCCL, else
    ``ppo.train_iteration`` (on the CPU; on a CUDA device under gloo, whose
    collectives run on the host, which ``who`` then prints)."""
    if torch.device(device).type != "cuda":
        return ppo.train_iteration
    if not _capturable(shard):
        print_info(f"{who}the data-parallel epoch runs eagerly: {shard.backend} runs its "
                   "collectives on the host, which a CUDA graph cannot hold (NCCL is "
                   "captured)")
        return ppo.train_iteration
    return GraphedEpoch()


class GraphedEpoch:
    """``ppo.train_iteration`` captured as CUDA graphs on a CUDA device, its
    bodies run eagerly on the CPU (module docstring)."""

    def __init__(self):
        self._key = None
        self.graphs: Optional[Dict[str, capture.CountedGraph]] = None

    # ----------------------------------------------------------------- set-up

    def _setup(self, cfg: ppo.PPOConfig, static: EnvStatic, params: EnvParams,
               ts: ppo.TrainState) -> None:
        self.cfg, self.static, self.params, self.ts = cfg, static, params, ts
        self.graphs = None
        device = ts.lr.device
        h = cfg.horizon
        self.n_all = ts.shard.n_global if ts.shard is not None else static.num_envs
        self.asym = ts.central_value is not None
        (ac_mb, ac_w, _), cv = ppo._layouts(cfg, h, self.n_all, self.asym)
        self.ac_steps = cfg.mini_epochs * ac_mb
        self.cv_steps = cfg.cv_mini_epochs * cv[0] if self.asym else 0
        self.ac_idx = torch.zeros((self.ac_steps, ac_w), dtype=torch.int64, device=device)
        self.ac_step = torch.zeros(1, dtype=torch.int64, device=device)
        terms = 6 if cfg.nan_telemetry else 5  # the pre-clip gradient norm last
        self.ac_terms = torch.zeros((terms, self.ac_steps), dtype=torch.float32, device=device)
        if self.asym:
            self.cv_idx = torch.zeros((self.cv_steps, cv[1]), dtype=torch.int64, device=device)
            self.cv_step = torch.zeros(1, dtype=torch.int64, device=device)
            self.cv_losses = torch.zeros(self.cv_steps, dtype=torch.float32, device=device)
        self.noise = self.env_draws = None  # the first epoch's draws become the buffers

    def _new_key(self, cfg, static, params, ts) -> Optional[tuple]:
        """The objects the buffers and graphs are bound to, where one is not
        the object they were set up for; else None."""
        if ts.lr.is_cuda and not _capturable(ts.shard):
            raise ValueError(f"GraphedEpoch: a {ts.shard.backend} shard's collectives run on "
                             "the host, which a CUDA graph cannot hold; use NCCL, or "
                             "ppo.train_iteration")
        key = (cfg, static, params, ts, ts.actor_critic, ts.central_value, ts.ac_opt,
               ts.cv_opt, ts.lr, ts.carry, ts.carry.env_state, ts.shard)
        if self._key is None or any(a is not b for a, b in zip(key, self._key)):
            return key
        return None

    def _load_draws(self, noise, env_draws, perms) -> None:
        """This epoch's draws into the static buffers, drawn from the train
        state's generator in ``train_iteration``'s order where not given;
        under a shard, the global blocks' rows of the rank."""
        cfg, st, ts = self.cfg, self.static, self.ts
        device, n_all, shard = ts.lr.device, self.n_all, ts.shard
        like = ts.carry.obs
        steps_noise, steps_draws = [], []
        for t in range(cfg.horizon):
            steps_noise.append(shard_batch(noise[t] if noise is not None else torch.randn(
                (n_all, st.action_dim), generator=ts.generator, device=device), shard))
            steps_draws.append(shard_batch(env_draws[t] if env_draws is not None else
                                           draw_step_randoms(st, ts.generator, n_all, device,
                                                             like.dtype), shard))
        if perms is None:
            perms = ppo.draw_permutations(cfg, cfg.horizon, n_all, self.asym, ts.generator,
                                          device)
        # env_step's layout: six blocks, None where the config draws none (a
        # step given None draws nothing)
        steps_draws = [d if d is None else (tuple(d) + (None,) * 6)[:6] for d in steps_draws]
        if self.noise is None:
            self.noise = torch.stack(steps_noise)
            self.env_draws = [capture.clone_nested(d) for d in steps_draws]
        else:
            self.noise.copy_(torch.stack(steps_noise))
            for dst, src in zip(self.env_draws, steps_draws):
                capture.copy_nested_(dst, src)
        ac_idx, cv_idx = ppo.minibatch_indices(cfg, cfg.horizon, n_all, self.asym, perms)
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
            self.advs, self.returns = ppo.advantages(self.cfg, self.traj, last_value, ts.shard)
        self.ac_data, self.cv_data = ppo.minibatch_sources(self.cfg, self.traj, self.advs,
                                                           self.returns, self.asym, ts.shard)
        self.ac_step.zero_()
        if self.asym:
            self.cv_step.zero_()

    def _ac_body(self) -> None:
        ts = self.ts
        idx = self.ac_idx.index_select(0, self.ac_step).reshape(-1)
        mb = {k: v.index_select(0, idx) for k, v in self.ac_data.items()}
        lr, terms = ppo.actor_critic_step(self.cfg, ts.actor_critic, ts.ac_opt, ts.lr, mb,
                                          ts.shard)
        with torch.no_grad():
            ts.lr.copy_(lr)
            self.ac_terms.index_copy_(1, self.ac_step, torch.stack(terms)[:, None])
            self.ac_step.add_(1)

    def _cv_body(self) -> None:
        ts = self.ts
        idx = self.cv_idx.index_select(0, self.cv_step).reshape(-1)
        states, returns = self.cv_data
        loss = ppo.central_value_step(self.cfg, ts.central_value, ts.cv_opt,
                                      states.index_select(0, idx), returns.index_select(0, idx),
                                      ts.shard)
        with torch.no_grad():
            self.cv_losses.index_copy_(0, self.cv_step, loss[None])
            self.cv_step.add_(1)

    def _phases(self):
        return (("rollout", self._rollout_body, 1), ("gae", self._gae_body, 1),
                ("ac", self._ac_body, self.ac_steps), ("cv", self._cv_body, self.cv_steps))

    # ------------------------------------------------------------------- epoch

    def _run(self, on_phase, replay: bool) -> None:
        """Each phase's replays (or bodies) in an ``epoch.launch.<phase>``
        span, then its device mark and ``on_phase``. Off the card each body
        run counts as the replay it stands for."""
        cuda = self.ts.lr.is_cuda
        steps = self._phases()
        for phase, graphs in (("rollout", steps[:1]), ("gae", steps[1:2]), ("update", steps[2:])):
            with trace.span("epoch.launch." + phase):
                for name, body, times in graphs:
                    for _ in range(times):
                        self.graphs[name].replay() if replay else body()
                    if not cuda:
                        capture.replay_count += times
                trace.mark(phase, cuda)
            if on_phase is not None:
                on_phase(phase)

    def _metrics(self) -> Dict[str, torch.Tensor]:
        with trace.span("epoch.metrics"):
            return ppo.finish_epoch(self.cfg, self.ts, self.traj, list(self.ac_terms),
                                    self.cv_losses if self.asym else None, self.advs,
                                    self.returns, clone=True)

    def _capture_graphs(self) -> None:
        shard = self.ts.shard
        pool = torch.cuda.graph_pool_handle()
        graphs = {}
        for name, body, times in self._phases():
            if times:
                graphs[name] = capture.CountedGraph(
                    shard.counts if shard is not None else None)
                with graphs[name].capture(pool=pool):
                    body()
        self.graphs = graphs

    def __call__(self, cfg: ppo.PPOConfig, static: EnvStatic, env_params: EnvParams,
                 ts: ppo.TrainState, noise: Optional[torch.Tensor] = None,
                 env_draws: Optional[Sequence] = None,
                 perms: Optional[Sequence[torch.Tensor]] = None,
                 on_phase: Optional[Callable[[str], None]] = None) -> Dict[str, torch.Tensor]:
        """One epoch on ``ts``, in place, as ``ppo.train_iteration``; the
        metrics are the same dict, every tensor in memory of its own."""
        cuda = ts.lr.is_cuda
        key = self._new_key(cfg, static, env_params, ts)
        if key is not None or (cuda and self.graphs is None):
            with trace.span("epoch.setup"):
                if key is not None:
                    self._setup(cfg, static, env_params, ts)
                    self._key = key
                if cuda:
                    return self._warm_up(noise, env_draws, perms, on_phase)
        trace.mark("start", cuda)
        with trace.span("epoch.draws"):
            self._load_draws(noise, env_draws, perms)
        self._run(on_phase, replay=cuda)
        return self._metrics()

    def _warm_up(self, noise, env_draws, perms, on_phase) -> Dict[str, torch.Tensor]:
        """This epoch, eagerly, on a side stream, where its marks go too; then
        the capture."""
        with trace.span("epoch.draws"):
            self._load_draws(noise, env_draws, perms)
        with capture.warm_up():
            trace.mark("start", True)
            self._run(on_phase, replay=False)
            metrics = self._metrics()
        self._capture_graphs()
        return metrics


class GraphedPolicy:
    """``(obs, generator=None) -> action``: the clipped obs through the
    actor, its mean, or with ``deterministic`` False the mean plus the
    action noise drawn from ``generator`` over ``n_draw`` envs (under
    ``shard`` the global block, of which the rank keeps its rows), clipped;
    one CUDA graph on a CUDA device (module docstring), the body itself on
    the CPU."""

    def __init__(self, cfg: ppo.PPOConfig, actor_critic, n_draw: int,
                 deterministic: bool = True, shard: Optional[DataShard] = None):
        self.cfg, self.actor_critic, self.deterministic = cfg, actor_critic, deterministic
        self.shard, self.n_draw = shard, n_draw
        self.captured = capture.Captured(self._body, actor_critic.log_std.device)

    @torch.no_grad()
    def _body(self, obs: torch.Tensor, noise: Optional[torch.Tensor]) -> torch.Tensor:
        cfg = self.cfg
        mu, log_std, _ = self.actor_critic(torch.clamp(obs, -cfg.clip_obs, cfg.clip_obs))
        action = mu if self.deterministic else mu + torch.exp(log_std) * noise
        return torch.clamp(action, -cfg.clip_actions, cfg.clip_actions)

    def __call__(self, obs: torch.Tensor,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
        noise = None
        if not self.deterministic:
            noise = shard_batch(torch.randn((self.n_draw, self.actor_critic.log_std.shape[0]),
                                            generator=generator, device=obs.device), self.shard)
        return self.captured(obs, noise) if obs.is_cuda else self._body(obs, noise)
