"""PPO with an asymmetric central value (counterpart of
``leibnizgym_tpu/learning/ppo.py``).

One ``train_iteration`` is the reference's epoch: ``cfg.horizon`` rollout
steps of policy + env (actions clipped before the env, observations and
states clipped after it, rewards scaled by the reward shaper, per-env
episode bookkeeping, an optional frame stack), GAE, whole-batch advantage
normalisation, then ``mini_epochs`` passes of actor-critic minibatch steps
(clipped surrogate, critic MSE, entropy, bounds loss, global-norm clip,
Adam, adaptive-KL learning rate) and ``cv_mini_epochs`` passes of
central-value steps.

Every random draw is "draw, then a pure function of the draws": the action
noise and env reset blocks of the rollout, and the minibatch permutations,
come from the train state's ``torch.Generator`` unless a caller injects
them, as the parity tests do with the reference's draws. The learning rate
stays a 0-d device tensor updated with ``torch.where``, and the Adam step
counts are 0-d int32 device tensors (optax keeps ``count`` so), so an epoch
reads nothing back from the device. The modules, the optimizer states, the
learning rate and the rollout carry are updated in place: their tensors live
as long as the learner, which lets ``learning/graphs.py`` capture the epoch
as CUDA graphs that keep their addresses.

A ``TrainState`` with a ``shard`` (``parallel.DataShard``) is one rank of a
data-parallel run: its rollout steps the rank's envs with the global draws'
rows (the permutations are then the same on every rank), and the epoch's
batch-wide reductions become collectives (``parallel/mesh.py``): the
advantage mean and std, each minibatch step's gradients (before the clip,
so that it sees the global norm) with the step's KL packed in, the
trajectory for the global-shuffle layout only, and the metrics. The
time-sliced layout gathers nothing.

``network_dtype: bfloat16`` (or ``mixed_precision``) runs the towers'
matmuls in bfloat16 (``models/networks.py``); the policy math (neglogp, KL,
losses) and Adam stay float32. ``nan_telemetry`` adds the reference's
``nan/*`` metrics (finiteness flags and magnitudes of every stage, the
pre-clip gradient norm and KL of every actor-critic step), still as device
tensors. The TPU scheduling knobs ``fused_update``, ``fused_rollout`` and
``update_unroll`` leave the math unchanged and are read and ignored.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from leibnizgym_tpu_torch.envs.trifinger.env import (
    EnvParams,
    EnvState,
    EnvStatic,
    clone_state,
    copy_state_,
    draw_init_randoms,
    draw_step_randoms,
    env_reset,
    env_state_tensors,
    env_step,
)
from leibnizgym_tpu_torch.models.networks import (
    ActorCritic,
    CentralValue,
    gaussian_entropy,
    gaussian_kl,
    gaussian_neglogp,
)
from leibnizgym_tpu_torch.parallel.mesh import (
    DataShard,
    all_gather_envs,
    all_reduce_mean_,
    broadcast_,
    global_mean_std,
    reduce_metrics,
    shard_batch,
)
from leibnizgym_tpu_torch.utils import trace


@dataclasses.dataclass(frozen=True)
class PPOConfig:
    """Hyperparameters (defaults = asymm.yaml), the reference's fields less
    the TPU scheduling knobs listed in the module docstring."""

    gamma: float = 0.99
    tau: float = 0.95
    learning_rate: float = 3e-4
    lr_schedule: str = "adaptive"
    kl_threshold: float = 0.008
    min_lr: float = 1e-6
    max_lr: float = 1e-2
    e_clip: float = 0.2
    horizon: int = 32
    minibatch_size: int = 8192
    mini_epochs: int = 4
    critic_coef: float = 4.0
    entropy_coef: float = 0.0
    bounds_loss_coef: float = 1e-4
    bounds_soft: float = 1.1
    grad_norm: float = 1.0
    truncate_grads: bool = True
    clip_value: bool = False
    normalize_advantage: bool = True
    reward_shaper_scale: float = 0.01
    clip_obs: float = 5.0
    clip_actions: float = 1.0
    # the actor sees the last `frames` clipped observations, oldest first;
    # the stack rolls through per-env resets (rl_games' vectorised FrameStack)
    frames: int = 1
    max_epochs: int = 100000
    save_best_after: int = 500
    save_frequency: int = 100
    score_to_win: float = 1e6
    games_to_track: int = 100
    central_value: bool = True
    cv_learning_rate: float = 5e-4
    cv_mini_epochs: int = 4
    cv_minibatch_size: int = 8192
    shuffle_minibatches: bool = True
    units: Tuple[int, ...] = (400, 200, 100)
    # compute dtype of the towers, "float32" or "bfloat16"
    network_dtype: str = "float32"
    log_std_min: float = -20.0
    # nan/* metrics of every stage; the runner then keeps the pre-epoch
    # state and dumps it at a NaN halt (learning/runner.py)
    nan_telemetry: bool = False
    # epochs whose metrics the runner leaves on the device before reading
    # them (learning/runner.py); nan_telemetry forces 1
    host_pipeline_depth: int = 4

    @property
    def torch_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.network_dtype == "bfloat16" else torch.float32

    @classmethod
    def from_rlg_params(cls, params: dict, num_actors: int) -> "PPOConfig":
        """From an rl_games-style ``params`` dict (asymm.yaml schema);
        ``num_actors`` is the default minibatch size."""
        c = params["config"]
        cv = c.get("central_value_config")
        units = tuple(params.get("network", {}).get("mlp", {}).get("units", (400, 200, 100)))
        return cls(
            gamma=float(c.get("gamma", 0.99)),
            tau=float(c.get("tau", 0.95)),
            learning_rate=float(c.get("learning_rate", 3e-4)),
            lr_schedule=str(c.get("lr_schedule", "adaptive")),
            kl_threshold=float(c.get("lr_threshold", c.get("kl_threshold", 0.008))),
            e_clip=float(c.get("e_clip", 0.2)),
            horizon=int(c.get("steps_num", c.get("horizon_length", 32))),
            minibatch_size=int(c.get("minibatch_size", num_actors)),
            mini_epochs=int(c.get("mini_epochs", 4)),
            critic_coef=float(c.get("critic_coef", 4)),
            entropy_coef=float(c.get("entropy_coef", 0.0)),
            bounds_loss_coef=float(c.get("bounds_loss_coef", 1e-4) or 0.0),
            grad_norm=float(c.get("grad_norm", 1.0)),
            truncate_grads=bool(c.get("truncate_grads", True)),
            clip_value=bool(c.get("clip_value", False)),
            normalize_advantage=bool(c.get("normalize_advantage", True)),
            reward_shaper_scale=float(c.get("reward_shaper", {}).get("scale_value", 1.0)),
            frames=int(c.get("frames", 1)),
            max_epochs=int(c.get("max_epochs", 100000)),
            save_best_after=int(c.get("save_best_after", 500)),
            save_frequency=int(c.get("save_frequency", 100)),
            score_to_win=float(c.get("score_to_win", 1e6)),
            games_to_track=int(c.get("games_to_track", 100)),
            central_value=cv is not None,
            cv_learning_rate=float(cv["lr"]) if cv else 5e-4,
            cv_mini_epochs=int(cv.get("mini_epochs", 4)) if cv else 4,
            cv_minibatch_size=int(cv.get("minibatch_size", num_actors)) if cv else 8192,
            units=units,
            network_dtype=("bfloat16" if (c.get("mixed_precision")
                                          or c.get("network_dtype") == "bfloat16")
                           else "float32"),
            nan_telemetry=bool(c.get("nan_telemetry", False)),
            log_std_min=float(c.get("log_std_min", -20.0)),
            host_pipeline_depth=int(c.get("host_pipeline_depth", 4)),
        )


# ---------------------------------------------------------------------------
# Networks and optimizers
# ---------------------------------------------------------------------------


def make_networks(cfg: PPOConfig, static: EnvStatic, device=None,
                  generator: Optional[torch.Generator] = None):
    """(actor_critic, central_value or None), randomly initialised from
    ``generator`` (a CPU generator), computing in ``cfg.network_dtype``; the
    central value exists for an asymmetric config on an env with privileged
    states."""
    dtype = cfg.torch_dtype
    actor_critic = ActorCritic(static.obs_dim * cfg.frames, static.action_dim, cfg.units,
                               log_std_min=cfg.log_std_min, generator=generator, dtype=dtype)
    central_value = (CentralValue(static.state_dim, cfg.units, generator=generator, dtype=dtype)
                     if cfg.central_value and static.asymmetric_obs else None)
    if central_value is not None:
        central_value = central_value.to(device)
    return actor_critic.to(device), central_value


class ClippedAdam:
    """``optax.chain(clip_by_global_norm(max_norm), scale_by_adam(eps=1e-8))``
    followed by ``-lr`` (the reference's ``make_optimizers`` + ``_apply_lr``),
    written to optax's formulas with ``torch._foreach_*`` ops:

    - the clip divides by the global norm and multiplies by ``max_norm``
      only when the norm is >= ``max_norm`` (torch's ``clip_grad_norm_``
      scales by ``max_norm / (norm + 1e-6)``, another number);
    - the moments are ``(1 - b) * g + b * m``, bias-corrected by
      ``1 - b ** count`` in float32 as optax computes it, with ``count`` a
      0-d int32 tensor on the parameters' device (optax's ``count``), so a
      step reads nothing from the host and a captured step counts on. The
      power is taken in float64 and rounded once to float32, as the host's
      float32 ``powf`` rounds it (the card's float32 ``pow`` misses that by
      an ulp at 27 of the counts 1-512), and the moments are divided by it
      as PyTorch divides a tensor by a host float: by true division on the
      CPU, by multiplying with its float32 reciprocal on the card. The
      step's numbers are then those of a count kept on the host;
    - ``lr`` may be a 0-d device tensor.

    Every state tensor is written in place, ``load_state_dict`` included.

    ``max_norm`` None is ``truncate_grads: False``. In a data-parallel
    learner the minibatch steps average the gradients over the ranks before
    ``step`` (as Horovod's distributed optimizer does), so every replica
    steps alike.
    """

    b1, b2, eps = 0.9, 0.999, 1e-8

    def __init__(self, named_params: Iterable[Tuple[str, torch.Tensor]],
                 max_norm: Optional[float]):
        self.names, params = zip(*named_params)
        self.params: List[torch.Tensor] = list(params)
        self.max_norm = max_norm
        self.count = torch.zeros((), dtype=torch.int32, device=self.params[0].device)
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    @staticmethod
    def _bias_correction(decay: float, count: torch.Tensor) -> torch.Tensor:
        """``1 - decay ** count`` in float32 on ``count``'s device (the power
        through float64, class docstring)."""
        power = torch.pow(float(np.float32(decay)), count.to(torch.float64))
        return 1.0 - power.to(torch.float32)

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor], lr,
             want_norm: bool = False) -> Optional[torch.Tensor]:
        """One update at ``lr``. Returns the global norm of ``grads`` before
        the clip (a 0-d device tensor) when the clip or ``want_norm`` needs
        it, else None."""
        grads = list(grads)  # fresh tensors from autograd.grad, scaled in place
        g_norm = None
        if self.max_norm is not None or want_norm:
            g_norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        if self.max_norm is not None:
            keep = g_norm < self.max_norm
            torch._foreach_div_(grads, torch.where(keep, 1.0, g_norm))
            torch._foreach_mul_(grads, torch.where(keep, 1.0, self.max_norm).to(g_norm.dtype))
        torch._foreach_mul_(self.mu, self.b1)
        torch._foreach_add_(self.mu, torch._foreach_mul(grads, 1.0 - self.b1))
        sq = torch._foreach_mul(grads, grads)
        torch._foreach_mul_(sq, 1.0 - self.b2)
        torch._foreach_mul_(self.nu, self.b2)
        torch._foreach_add_(self.nu, sq)
        self.count.add_(1)
        bc1 = self._bias_correction(self.b1, self.count)
        bc2 = self._bias_correction(self.b2, self.count)
        if bc1.is_cuda:  # a host scalar's division on the card (class docstring)
            upd = torch._foreach_mul(self.mu, torch.reciprocal(bc1))
            den = torch._foreach_mul(self.nu, torch.reciprocal(bc2))
        else:
            upd = torch._foreach_div(self.mu, bc1)
            den = torch._foreach_div(self.nu, bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.eps)
        torch._foreach_div_(upd, den)
        torch._foreach_mul_(upd, -lr)
        torch._foreach_add_(self.params, upd)
        return g_norm

    def state_dict(self) -> dict:
        return {"count": self.count, "mu": dict(zip(self.names, self.mu)),
                "nu": dict(zip(self.names, self.nu))}

    def load_state_dict(self, state: dict) -> None:
        """Copy ``state`` into this optimizer's tensors, in place; its
        ``count`` may be an int (checkpoints written before the count moved
        onto the device) or a tensor. Raises KeyError / ValueError, before
        changing anything, when ``state`` does not hold a moment of each
        parameter's shape."""
        count = state["count"]
        for key in ("mu", "nu"):
            if set(state[key]) != set(self.names):
                raise KeyError(f"optimizer {key} names {sorted(state[key])} != {sorted(self.names)}")
            for name, p in zip(self.names, self.params):
                if tuple(state[key][name].shape) != tuple(p.shape):
                    raise ValueError(f"optimizer {key}[{name}] shape "
                                     f"{tuple(state[key][name].shape)} != {tuple(p.shape)}")
        # copies: the optimizer steps its moments in place, and must not step
        # the caller's tensors (a checkpoint kept to restore again)
        with torch.no_grad():
            for key, own in (("mu", self.mu), ("nu", self.nu)):
                for name, dst in zip(self.names, own):
                    dst.copy_(state[key][name])
            self.count.copy_(torch.as_tensor(count).reshape(()))


def make_optimizers(cfg: PPOConfig, actor_critic: ActorCritic,
                    central_value: Optional[CentralValue]):
    """(actor-critic optimizer, central-value optimizer or None)."""
    max_norm = cfg.grad_norm if cfg.truncate_grads else None
    cv_opt = (ClippedAdam(central_value.named_parameters(), max_norm)
              if central_value is not None else None)
    return ClippedAdam(actor_critic.named_parameters(), max_norm), cv_opt


# ---------------------------------------------------------------------------
# State
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class RolloutCarry:
    """What one rollout hands the next: env state, clipped (and, with
    ``frames > 1``, stacked) obs, clipped states and the per-env episode
    accumulators."""

    env_state: EnvState
    obs: torch.Tensor  # (N, obs_dim * frames), clipped
    states: torch.Tensor  # (N, state_dim), clipped
    ep_return: torch.Tensor  # (N,) raw reward accumulator
    ep_len: torch.Tensor  # (N,) int32

    @classmethod
    def start(cls, env_state: EnvState, obs: torch.Tensor, state_dim: int,
              cfg: PPOConfig) -> "RolloutCarry":
        """From a reset: clip the obs, tile it into the initial frame stack
        (FrameStack.reset parity), zero states and accumulators. Every env
        state tensor gets memory of its own, as ``copy_`` writes into it."""
        n = obs.shape[0]
        obs = torch.clamp(obs, -cfg.clip_obs, cfg.clip_obs)
        return cls(
            env_state=clone_state(env_state),
            obs=obs.repeat(1, cfg.frames) if cfg.frames > 1 else obs,
            states=obs.new_zeros((n, state_dim)),
            ep_return=obs.new_zeros(n),
            ep_len=torch.zeros(n, dtype=torch.int32, device=obs.device),
        )

    def copy_(self, other: "RolloutCarry") -> None:
        """Write ``other`` into this carry's tensors in place."""
        copy_state_(self.env_state, other.env_state)
        for name in ("obs", "states", "ep_return", "ep_len"):
            getattr(self, name).copy_(getattr(other, name))


@dataclasses.dataclass
class TrainState:
    """The learner and its rollout carry (the reference's ``PPOTrainState``,
    also exported under that name).
    ``train_iteration`` updates it in place. ``shard`` makes it one rank of a
    data-parallel run (module docstring)."""

    actor_critic: ActorCritic
    central_value: Optional[CentralValue]
    ac_opt: ClippedAdam
    cv_opt: Optional[ClippedAdam]
    lr: torch.Tensor  # () float32, on the device
    carry: RolloutCarry
    generator: torch.Generator  # on the device: action noise, resets, permutations
    epoch: int = 0
    frame: int = 0  # env frames trained on, over every rank
    shard: Optional[DataShard] = None

    @classmethod
    def create(cls, cfg: PPOConfig, actor_critic: ActorCritic,
               central_value: Optional[CentralValue], carry: RolloutCarry,
               generator: torch.Generator, shard: Optional[DataShard] = None) -> "TrainState":
        ac_opt, cv_opt = make_optimizers(cfg, actor_critic, central_value)
        lr = torch.tensor(cfg.learning_rate, dtype=torch.float32, device=carry.obs.device)
        return cls(actor_critic, central_value, ac_opt, cv_opt, lr, carry, generator,
                   shard=shard)

    def learner_tensors(self) -> List[torch.Tensor]:
        """The parameters of both networks and ``lr``: what every rank holds
        alike."""
        nets = [self.actor_critic] + ([self.central_value] if self.central_value is not None
                                      else [])
        return [p.data for net in nets for p in net.parameters()] + [self.lr]


PPOTrainState = TrainState


def init_train_state(cfg: PPOConfig, static: EnvStatic, params: EnvParams,
                     seed: int, shard: Optional[DataShard] = None) -> TrainState:
    """Reset every env, random networks and fresh optimizers, from ``seed``,
    on the device and in the dtype of ``params``. Under a ``shard`` the
    reset draws are the global blocks' rows of the shard, and rank 0's
    learner is broadcast to every rank."""
    like = params.dof_default_pos
    generator = torch.Generator(device=like.device).manual_seed(seed)
    n_draw = shard.n_global if shard is not None else static.num_envs
    env_state, obs = env_reset(static, params, *shard_batch(draw_init_randoms(
        static, generator, n_draw, like.device, like.dtype), shard))
    carry = RolloutCarry.start(env_state, obs, static.state_dim, cfg)
    actor_critic, central_value = make_networks(
        cfg, static, like.device, torch.Generator().manual_seed(seed))
    ts = TrainState.create(cfg, actor_critic, central_value, carry, generator, shard)
    if shard is not None:
        broadcast_(ts.learner_tensors(), shard)
    return ts


@dataclasses.dataclass
class Trajectory:
    """Time-major (horizon, N, ...) rollout buffers plus episode stats."""

    obs: torch.Tensor
    states: torch.Tensor
    action: torch.Tensor
    mu: torch.Tensor
    log_std: torch.Tensor
    neglogp: torch.Tensor
    value: torch.Tensor
    reward: torch.Tensor  # shaped
    done: torch.Tensor  # float
    fin_ret: torch.Tensor  # (N,) return of each env's last finished episode
    fin_n: torch.Tensor  # (N,) episodes finished per env
    fin_suc: torch.Tensor  # () successes of the finished episodes
    info: Dict[str, torch.Tensor]  # the last step's env info


# ---------------------------------------------------------------------------
# Rollout and GAE
# ---------------------------------------------------------------------------


def policy_and_value(actor_critic, central_value, obs, states):
    mu, log_std, own_value = actor_critic(obs)
    if central_value is not None:
        return mu, log_std, central_value(states)
    return mu, log_std, own_value


@torch.no_grad()
def rollout(cfg: PPOConfig, static: EnvStatic, env_params: EnvParams,
            carry: RolloutCarry, actor_critic, central_value=None,
            generator: Optional[torch.Generator] = None,
            noise: Optional[torch.Tensor] = None,
            env_draws: Optional[Sequence] = None,
            shard: Optional[DataShard] = None) -> Tuple[RolloutCarry, Trajectory]:
    """``cfg.horizon`` steps of policy + env. Action noise is ``noise[t]``
    when given (horizon, N, A), else drawn from ``generator``; env reset
    draws are ``env_draws[t]`` when given, else drawn from ``generator``.
    Under a ``shard`` the draws, drawn or given, are the global blocks, and
    the rank keeps its rows."""
    n = static.num_envs
    n_draw = shard.n_global if shard is not None else n
    env_state, obs, states = carry.env_state, carry.obs, carry.states
    ep_ret, ep_len = carry.ep_return, carry.ep_len
    fin_ret = obs.new_zeros(n)
    fin_n = torch.zeros(n, dtype=torch.int32, device=obs.device)
    fin_suc = obs.new_zeros(())
    asym = central_value is not None
    info: Dict[str, torch.Tensor] = {}
    out = {k: [] for k in ("obs", "states", "action", "mu", "log_std", "neglogp",
                           "value", "reward", "done")}
    for t in range(cfg.horizon):
        mu, log_std, value = policy_and_value(actor_critic, central_value, obs, states)
        eps = shard_batch(noise[t] if noise is not None else torch.randn(
            (n_draw, mu.shape[1]), generator=generator, device=mu.device), shard)
        action = mu + torch.exp(log_std) * eps
        neglogp = gaussian_neglogp(mu, log_std, action)
        clipped = torch.clamp(action, -cfg.clip_actions, cfg.clip_actions)
        if env_draws is not None:
            draws = shard_batch(env_draws[t], shard)
        else:
            draws = shard_batch(draw_step_randoms(static, generator, n_draw, obs.device,
                                                  obs.dtype), shard)
        env_state, next_obs, next_states, reward, done, info = env_step(
            static, env_params, env_state, clipped, draws
        )
        next_obs = torch.clamp(next_obs, -cfg.clip_obs, cfg.clip_obs)
        if cfg.frames > 1:
            # drop the oldest frame, append the new one; never cleared on reset
            next_obs = torch.cat([obs[:, static.obs_dim:], next_obs], dim=-1)
        if asym:
            next_states = torch.clamp(next_states, -cfg.clip_obs, cfg.clip_obs)
        shaped = reward * cfg.reward_shaper_scale

        # an env flagged for reset finishes its episode this step
        ep_ret = ep_ret + reward
        ep_len = ep_len + 1
        finished = env_state.reset_buf
        fin_ret = torch.where(finished, ep_ret, fin_ret)
        fin_n = fin_n + finished.to(fin_n.dtype)
        fin_suc = fin_suc + torch.sum(
            torch.where(finished, env_state.successes, 0).to(fin_suc.dtype)
        )
        ep_ret = torch.where(finished, 0.0, ep_ret)
        ep_len = torch.where(finished, 0, ep_len)

        for k, v in (("obs", obs), ("states", states), ("action", action), ("mu", mu),
                     ("log_std", log_std), ("neglogp", neglogp), ("value", value),
                     ("reward", shaped), ("done", done.to(obs.dtype))):
            out[k].append(v)
        obs, states = next_obs, next_states
    traj = Trajectory(**{k: torch.stack(v) for k, v in out.items()},
                      fin_ret=fin_ret, fin_n=fin_n, fin_suc=fin_suc, info=info)
    return RolloutCarry(env_state, obs, states, ep_ret, ep_len), traj


def gae(cfg: PPOConfig, rewards: torch.Tensor, values: torch.Tensor,
        dones: torch.Tensor, last_value: torch.Tensor) -> torch.Tensor:
    """rl_games discount_values: nextnonterminal[t] = 1 - done_after_t.
    All inputs time-major (horizon, N); returns the advantages."""
    next_values = torch.cat([values[1:], last_value[None]], dim=0)
    advs = torch.empty_like(values)
    lastgaelam = torch.zeros_like(last_value)
    dones = dones.to(values.dtype)
    for t in reversed(range(values.shape[0])):
        nonterminal = 1.0 - dones[t]
        delta = rewards[t] + cfg.gamma * next_values[t] * nonterminal - values[t]
        lastgaelam = delta + cfg.gamma * cfg.tau * nonterminal * lastgaelam
        advs[t] = lastgaelam
    return advs


# ---------------------------------------------------------------------------
# Minibatch schedules
# ---------------------------------------------------------------------------


def minibatch_layout(shuffle: bool, h: int, n: int, minibatch_size: int):
    """(num_mb, width, time_sliced). Time-sliced minibatches are
    ``width = h // num_mb`` whole timestep rows of all n envs, drawn from a
    permutation of the h rows (reference ppo.py:424-442); otherwise each is
    ``width`` samples of a permutation of all h * n (the rl_games shuffle,
    the tail past ``num_mb * width`` unused)."""
    batch = h * n
    num_mb = max(batch // minibatch_size, 1)
    time_sliced = shuffle and num_mb <= h and h % num_mb == 0
    return num_mb, (h // num_mb if time_sliced else batch // num_mb), time_sliced


def _layouts(cfg: PPOConfig, h: int, n: int, asym: bool):
    ac = minibatch_layout(cfg.shuffle_minibatches, h, n, cfg.minibatch_size)
    cv = minibatch_layout(cfg.shuffle_minibatches, h, n, cfg.cv_minibatch_size) if asym else None
    return ac, cv


def draw_permutations(cfg: PPOConfig, h: int, n: int, asym: bool,
                      generator: Optional[torch.Generator], device) -> List[torch.Tensor]:
    """Every mini-epoch's permutation up front, the actor's first, then the
    central value's (reference ppo.py:506-557): of the h rows when
    time-sliced, else of the h * n samples. The actor's flat order is the
    identity without ``shuffle_minibatches``; the central value's is always
    shuffled, as in the reference."""
    (_, _, ac_ts), cv = _layouts(cfg, h, n, asym)

    def perm(size):
        return torch.randperm(size, generator=generator, device=device)

    perms = []
    for _ in range(cfg.mini_epochs):
        if ac_ts:
            perms.append(perm(h))
        elif cfg.shuffle_minibatches:
            perms.append(perm(h * n))
        else:
            perms.append(torch.arange(h * n, device=device))
    if asym:
        perms += [perm(h if cv[2] else h * n) for _ in range(cfg.cv_mini_epochs)]
    return perms


def minibatch_indices(cfg: PPOConfig, h: int, n: int, asym: bool,
                      perms: Sequence[torch.Tensor]):
    """(actor indices (mini_epochs * num_mb, width), central-value indices or
    None) from ``draw_permutations``' output."""
    (ac_mb, ac_w, _), cv = _layouts(cfg, h, n, asym)

    def cut(ps, num_mb, width):
        return torch.cat([p[: num_mb * width].reshape(num_mb, width) for p in ps])

    ac_idx = cut(perms[: cfg.mini_epochs], ac_mb, ac_w)
    cv_idx = cut(perms[cfg.mini_epochs:], cv[0], cv[1]) if asym else None
    return ac_idx, cv_idx


# ---------------------------------------------------------------------------
# Losses and update steps
# ---------------------------------------------------------------------------


def ac_loss_terms(cfg: PPOConfig, mb: Dict[str, torch.Tensor], mu, log_std, value):
    """PPO surrogate + critic + entropy + bounds terms on a minibatch, given
    the network outputs; returns (total, (a_loss, c_loss, entropy, b_loss, kl))."""
    neglogp = gaussian_neglogp(mu, log_std, mb["action"])
    ratio = torch.exp(mb["neglogp"] - neglogp)
    surr1 = -mb["advs"] * ratio
    surr2 = -mb["advs"] * torch.clamp(ratio, 1.0 - cfg.e_clip, 1.0 + cfg.e_clip)
    a_loss = torch.mean(torch.maximum(surr1, surr2))
    if cfg.clip_value:
        v_clipped = mb["value"] + torch.clamp(value - mb["value"], -cfg.e_clip, cfg.e_clip)
        c_loss = torch.mean(torch.maximum(torch.square(value - mb["returns"]),
                                          torch.square(v_clipped - mb["returns"])))
    else:
        c_loss = torch.mean(torch.square(value - mb["returns"]))
    entropy = torch.mean(gaussian_entropy(log_std))
    mu_high = torch.square(torch.clamp(mu - cfg.bounds_soft, min=0.0))
    mu_low = torch.square(torch.clamp(mu + cfg.bounds_soft, max=0.0))
    b_loss = torch.mean(torch.sum(mu_high + mu_low, dim=-1))
    total = (a_loss + 0.5 * c_loss * cfg.critic_coef - cfg.entropy_coef * entropy
             + cfg.bounds_loss_coef * b_loss)
    kl = gaussian_kl(mb["mu"], mb["log_std"], mu, log_std)
    return total, (a_loss, c_loss, entropy, b_loss, kl)


def adapt_lr(cfg: PPOConfig, lr: torch.Tensor, kl: torch.Tensor) -> torch.Tensor:
    """rl_games AdaptiveScheduler on device tensors: /1.5 above twice the
    threshold, x1.5 below half of it, clamped to [min_lr, max_lr]."""
    lr = torch.where(kl > 2.0 * cfg.kl_threshold, torch.clamp(lr / 1.5, min=cfg.min_lr), lr)
    return torch.where(kl < 0.5 * cfg.kl_threshold, torch.clamp(lr * 1.5, max=cfg.max_lr), lr)


def actor_critic_step(cfg: PPOConfig, actor_critic: ActorCritic, opt: ClippedAdam,
                      lr: torch.Tensor, mb: Dict[str, torch.Tensor],
                      shard: Optional[DataShard] = None):
    """One minibatch step: loss, gradients, clip + Adam at ``lr``, then the
    adaptive learning rate from this step's KL. Returns (new lr, (total,
    a_loss, c_loss, entropy, kl)), all device tensors; with ``nan_telemetry``
    the terms end with the gradients' global norm before the clip. Under a
    ``shard`` the gradients and the KL are averaged over the ranks in one
    all-reduce before the clip, so that the clip sees the global norm and
    every rank takes the same step and lr."""
    mu, log_std, value = actor_critic(mb["obs"])
    total, (a_loss, c_loss, entropy, _, kl) = ac_loss_terms(cfg, mb, mu, log_std, value)
    grads = torch.autograd.grad(total, opt.params)
    kl = kl.detach()
    if shard is not None:
        all_reduce_mean_(list(grads) + [kl], shard)
    g_norm = opt.step(grads, lr, want_norm=cfg.nan_telemetry)
    if cfg.lr_schedule == "adaptive":
        lr = adapt_lr(cfg, lr, kl)
    terms = tuple(x.detach() for x in (total, a_loss, c_loss, entropy)) + (kl,)
    return lr, terms + ((g_norm,) if cfg.nan_telemetry else ())


def central_value_step(cfg: PPOConfig, central_value: CentralValue, opt: ClippedAdam,
                       states: torch.Tensor, returns: torch.Tensor,
                       shard: Optional[DataShard] = None) -> torch.Tensor:
    """One central-value step: MSE on the returns, clip + Adam at the
    constant ``cv_learning_rate``, the gradients averaged over the ranks
    first under a ``shard``. Returns the loss."""
    loss = torch.mean(torch.square(central_value(states) - returns))
    grads = torch.autograd.grad(loss, opt.params)
    if shard is not None:
        all_reduce_mean_(grads, shard)
    opt.step(grads, cfg.cv_learning_rate)
    return loss.detach()


# ---------------------------------------------------------------------------
# One epoch
# ---------------------------------------------------------------------------


def train_iteration(cfg: PPOConfig, static: EnvStatic, env_params: EnvParams,
                    ts: TrainState, noise: Optional[torch.Tensor] = None,
                    env_draws: Optional[Sequence] = None,
                    perms: Optional[Sequence[torch.Tensor]] = None,
                    on_phase: Optional[Callable[[str], None]] = None) -> Dict[str, torch.Tensor]:
    """One PPO epoch on ``ts``, in place: rollout, GAE, minibatch updates.
    Returns the reference's metrics as device tensors (the per-env
    ``episodes/finished_*`` vectors and the last step's ``env/*`` info
    included). ``noise``, ``env_draws`` and ``perms`` (``draw_permutations``'
    layout) replace the generator's draws when given; ``on_phase`` is called
    with "rollout", "gae" and "update" as each phase has been enqueued. Each
    phase runs in an ``epoch.launch.<phase>`` span and ends in its device
    mark, the epoch's start marked too (``utils/trace.py``), as in
    ``learning/graphs.py``."""
    ac, cv = ts.actor_critic, ts.central_value
    trace.mark("start", ts.lr.is_cuda)
    with trace.span("epoch.launch.rollout"):
        carry, traj = rollout(cfg, static, env_params, ts.carry, ac, cv,
                              generator=ts.generator, noise=noise, env_draws=env_draws,
                              shard=ts.shard)
        ts.carry.copy_(carry)
        with torch.no_grad():
            _, _, last_value = policy_and_value(ac, cv, ts.carry.obs, ts.carry.states)
        trace.mark("rollout", ts.lr.is_cuda)
    if on_phase is not None:
        on_phase("rollout")
    return update(cfg, ts, traj, last_value, perms=perms, on_phase=on_phase)


def _flat_batch(tensors: Dict[str, torch.Tensor],
                shard: Optional[DataShard]) -> Dict[str, torch.Tensor]:
    """Time-major (h, n, ...) tensors as the flat (h * N, ...) batch of the
    rl_games shuffle; under a ``shard`` the global batch, every tensor
    all-gathered in one collective (the reference's partitioner gathers the
    trajectory for this layout too, ppo.py:423-428)."""
    if shard is not None:
        h, n = next(iter(tensors.values())).shape[:2]
        widths = [v[0, 0].numel() for v in tensors.values()]
        packed = all_gather_envs(torch.cat([v.reshape(h, n, -1) for v in tensors.values()], -1),
                                 shard)
        tensors = {k: x.reshape((h, shard.n_global) + v.shape[2:])
                   for (k, v), x in zip(tensors.items(), packed.split(widths, -1))}
    return {k: v.reshape((-1,) + v.shape[2:]) for k, v in tensors.items()}


def advantages(cfg: PPOConfig, traj: Trajectory, last_value: torch.Tensor,
               shard: Optional[DataShard] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(advantages, returns) of a trajectory: GAE, returns = advantages +
    values, then the advantages normalised over the (global) batch when
    configured."""
    advs = gae(cfg, traj.reward, traj.value, traj.done, last_value)
    returns = advs + traj.value
    if cfg.normalize_advantage:
        mean, std = global_mean_std(advs, shard)
        advs = (advs - mean) / (std + 1e-8)
    return advs, returns


AC_KEYS = ("obs", "action", "mu", "log_std", "neglogp", "advs", "returns", "value")


def minibatch_sources(cfg: PPOConfig, traj: Trajectory, advs: torch.Tensor,
                      returns: torch.Tensor, asym: bool, shard: Optional[DataShard] = None):
    """(the actor-critic step's tensors by ``AC_KEYS``, (states, returns) of
    the central-value step or None): the time-major (h, n, ...) tensors
    where the layout is time-sliced, else the flat (h * N, ...) batch, so
    that a minibatch is ``index_select(0, idx)`` of a row of
    ``minibatch_indices``."""
    h, n = traj.value.shape
    n_all = shard.n_global if shard is not None else n
    (_, _, ac_ts), cv_layout = _layouts(cfg, h, n_all, asym)
    fields = {"obs": traj.obs, "action": traj.action, "mu": traj.mu, "log_std": traj.log_std,
              "neglogp": traj.neglogp, "advs": advs, "returns": returns, "value": traj.value,
              "states": traj.states}
    flat_keys = [] if ac_ts else list(AC_KEYS)
    if asym and not cv_layout[2]:
        flat_keys += ["states"] + ([] if flat_keys else ["returns"])
    # a time-sliced minibatch takes its rows of the rank's own envs; a flat
    # one is the same global minibatch on every rank, which computes all of
    # it (the reference's partitioner replicates it after its all-gather)
    flat = _flat_batch({k: fields[k] for k in flat_keys}, shard) if flat_keys else {}
    data = {k: fields[k] if ac_ts else flat[k] for k in AC_KEYS}
    cv_data = None
    if asym:
        src = fields if cv_layout[2] else flat
        cv_data = (src["states"], src["returns"])
    return data, cv_data


def finish_epoch(cfg: PPOConfig, ts: TrainState, traj: Trajectory,
                 per_step: Sequence[torch.Tensor], cv_losses: Optional[torch.Tensor],
                 advs: torch.Tensor, returns: torch.Tensor,
                 clone: bool = False) -> Dict[str, torch.Tensor]:
    """Count the epoch on the host (``ts.epoch``, and ``ts.frame`` by the
    global batch) and assemble its metrics from the trajectory, the
    actor-critic steps' terms (``per_step``: one (steps,) tensor per term,
    in ``actor_critic_step``'s order) and the central-value losses (None
    without a central value); then, with ``nan_telemetry``, the ``nan/*``
    metrics of the trajectory, the advantages and returns and the steps'
    KL and gradient norms, and under ``ts.shard`` every metric reduced over
    the ranks. ``clone`` copies the tensors passed through unchanged, for a
    caller whose buffers the next epoch overwrites."""
    h, n = traj.value.shape
    ts.epoch += 1
    ts.frame += h * (ts.shard.n_global if ts.shard is not None else n)
    keep = (lambda x: x.clone()) if clone else (lambda x: x)
    total, a_loss, c_loss, entropy, kl = (x.mean() for x in per_step[:5])
    cv_loss = cv_losses.mean() if cv_losses is not None else traj.value.new_zeros(())
    fin_n = traj.fin_n
    metrics = {
        "losses/total": total,
        "losses/a_loss": a_loss,
        "losses/c_loss": c_loss,
        "losses/entropy": entropy,
        "losses/cv_loss": cv_loss,
        "info/kl": kl,
        # a copy: the learner's lr is written in place by the next epoch
        "info/lr": ts.lr.clone(),
        "info/epochs": float(ts.epoch),
        "info/frames": float(ts.frame),
        "rewards/step_mean": torch.mean(traj.reward) / cfg.reward_shaper_scale,
        "episodes/finished_return_sum": torch.sum(torch.where(fin_n > 0, traj.fin_ret, 0.0)),
        "episodes/finished_count": torch.sum(fin_n).to(torch.float32),
        "episodes/finished_success_sum": keep(traj.fin_suc),
        # per-env vectors (the runner pops them before scalar logging)
        "episodes/finished_returns": keep(traj.fin_ret),
        "episodes/finished_n": keep(fin_n),
        **{k: keep(v) for k, v in traj.info.items()},
    }
    if cfg.nan_telemetry:
        metrics.update(nan_metrics(traj, ts, advs, returns, kl_trace=per_step[4],
                                   grad_norms=per_step[5]))
    if ts.shard is not None:
        metrics = reduce_metrics(metrics, ts.shard)
    return metrics


def update(cfg: PPOConfig, ts: TrainState, traj: Trajectory, last_value: torch.Tensor,
           perms: Optional[Sequence[torch.Tensor]] = None,
           on_phase: Optional[Callable[[str], None]] = None) -> Dict[str, torch.Tensor]:
    """The learning half of ``train_iteration`` on a rollout's trajectory
    and its last value: GAE, advantage normalisation, the actor-critic and
    central-value minibatch steps; updates ``ts`` in place and returns the
    epoch's metrics. Under ``ts.shard`` the trajectory is the rank's envs of
    the global one, and the layouts follow the global N."""
    shard = ts.shard
    h, n = traj.value.shape
    n_all = shard.n_global if shard is not None else n
    ac, cv = ts.actor_critic, ts.central_value
    asym = cv is not None
    cuda = ts.lr.is_cuda

    with trace.span("epoch.launch.gae"):
        advs, returns = advantages(cfg, traj, last_value, shard)
        trace.mark("gae", cuda)
    if on_phase is not None:
        on_phase("gae")

    with trace.span("epoch.launch.update"):
        if perms is None:
            perms = draw_permutations(cfg, h, n_all, asym, ts.generator, advs.device)
        ac_idx, cv_idx = minibatch_indices(cfg, h, n_all, asym, perms)
        data, cv_data = minibatch_sources(cfg, traj, advs, returns, asym, shard)
        lr, ac_terms = ts.lr, []
        for idx in ac_idx:
            mb = {k: v.index_select(0, idx) for k, v in data.items()}
            lr, terms = actor_critic_step(cfg, ac, ts.ac_opt, lr, mb, shard)
            ac_terms.append(terms)
        ts.lr.copy_(lr)
        cv_losses = None
        if asym:
            s, r = cv_data
            cv_losses = torch.stack([central_value_step(cfg, cv, ts.cv_opt,
                                                        s.index_select(0, idx),
                                                        r.index_select(0, idx), shard)
                                     for idx in cv_idx])
        trace.mark("update", cuda)
    if on_phase is not None:
        on_phase("update")

    with trace.span("epoch.metrics"):
        per_step = [torch.stack(x) for x in zip(*ac_terms)]
        return finish_epoch(cfg, ts, traj, per_step, cv_losses, advs, returns)


def _fin(x: torch.Tensor) -> torch.Tensor:
    return torch.isfinite(x).all().to(torch.float32)


def _amax(x: torch.Tensor) -> torch.Tensor:
    # the reference cannot reduce an empty tensor (no privileged states);
    # the port gives 0 there
    return x.abs().max() if x.numel() else x.new_zeros(())


def nan_metrics(traj: Trajectory, ts: TrainState, advs: torch.Tensor, returns: torch.Tensor,
                kl_trace: torch.Tensor, grad_norms: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The reference's ``nan/*`` metrics (ppo.py:823-856), 0-d device
    tensors: per stage a finiteness flag (1.0 / 0.0) and the largest
    magnitude, over the rollout buffers, the env state after the rollout,
    the normalised advantages and returns, every actor-critic step's
    pre-clip gradient norm and KL (``kl_first_bad``: the flat index of the
    first non-finite KL, -1 if none) and the actor-critic's parameters."""
    env_tensors = [v for v in env_state_tensors(ts.carry.env_state).values()
                   if v.is_floating_point()]
    kl_bad = ~torch.isfinite(kl_trace.reshape(-1))
    params = [p.detach() for p in ts.actor_critic.parameters()]
    return {
        "nan/obs_fin": _fin(traj.obs), "nan/obs_max": _amax(traj.obs),
        "nan/states_fin": _fin(traj.states), "nan/states_max": _amax(traj.states),
        "nan/act_fin": _fin(traj.action), "nan/act_max": _amax(traj.action),
        "nan/rew_fin": _fin(traj.reward), "nan/rew_max": _amax(traj.reward),
        "nan/val_fin": _fin(traj.value), "nan/val_max": _amax(traj.value),
        "nan/neglogp_max": _amax(traj.neglogp),
        "nan/logstd_min": traj.log_std.min(), "nan/logstd_max": traj.log_std.max(),
        "nan/envstate_fin": torch.stack([torch.isfinite(x).all() for x in env_tensors])
                                 .all().to(torch.float32),
        "nan/adv_fin": _fin(advs), "nan/adv_max": _amax(advs),
        "nan/ret_max": _amax(returns),
        "nan/grad_fin": _fin(grad_norms), "nan/grad_max": _amax(grad_norms),
        "nan/kl_mb_fin": _fin(kl_trace),
        "nan/kl_first_bad": torch.where(kl_bad.any(), torch.argmax(kl_bad.to(torch.int8)),
                                        -1).to(torch.float32),
        "nan/params_fin": _fin(torch.linalg.vector_norm(
            torch.stack(torch._foreach_norm(params)))),
    }
