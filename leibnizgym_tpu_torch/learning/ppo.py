"""PPO rollout and GAE (the acting half of ``leibnizgym_tpu/learning/ppo.py``).

``rollout`` runs ``cfg.horizon`` steps of policy + env, as the reference's
``train_iteration`` rollout scan does: Gaussian actions from the actor with
the asymmetric central value's values, actions clipped before the env,
observations and states clipped after it, rewards scaled by the reward
shaper, and per-env episode bookkeeping. ``gae`` is rl_games'
discount_values. The update (losses, Adam, adaptive KL learning rate) is
not in the port yet (ROADMAP.md queue 1, item 8).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch

from leibnizgym_tpu_torch.envs.trifinger.env import (
    EnvParams,
    EnvState,
    EnvStatic,
    draw_reset_randoms,
    env_step,
)
from leibnizgym_tpu_torch.models.networks import (
    ActorCritic,
    CentralValue,
    gaussian_neglogp,
)


@dataclasses.dataclass(frozen=True)
class PPOConfig:
    """The hyperparameters the rollout needs (defaults = asymm.yaml)."""

    gamma: float = 0.99
    tau: float = 0.95
    horizon: int = 32
    reward_shaper_scale: float = 0.01
    clip_obs: float = 5.0
    clip_actions: float = 1.0
    units: Tuple[int, ...] = (400, 200, 100)
    log_std_min: float = -20.0
    central_value: bool = True

    @classmethod
    def from_rlg_params(cls, params: dict) -> "PPOConfig":
        """From an rl_games-style ``params`` dict (asymm.yaml schema)."""
        c = params["config"]
        if int(c.get("frames", 1)) != 1:
            raise NotImplementedError(
                "frame stacking is not in the PyTorch port yet (ROADMAP.md queue 1, item 12)"
            )
        units = tuple(params.get("network", {}).get("mlp", {}).get("units", (400, 200, 100)))
        return cls(
            gamma=float(c.get("gamma", 0.99)),
            tau=float(c.get("tau", 0.95)),
            horizon=int(c.get("steps_num", c.get("horizon_length", 32))),
            reward_shaper_scale=float(c.get("reward_shaper", {}).get("scale_value", 1.0)),
            units=units,
            log_std_min=float(c.get("log_std_min", -20.0)),
            central_value=c.get("central_value_config") is not None,
        )


@dataclasses.dataclass
class RolloutCarry:
    """What one rollout hands the next: env state, clipped obs/states and
    the per-env episode accumulators."""

    env_state: EnvState
    obs: torch.Tensor  # (N, obs_dim), clipped
    states: torch.Tensor  # (N, state_dim), clipped
    ep_return: torch.Tensor  # (N,) raw reward accumulator
    ep_len: torch.Tensor  # (N,) int32

    @classmethod
    def start(cls, env_state: EnvState, obs: torch.Tensor, state_dim: int,
              cfg: PPOConfig) -> "RolloutCarry":
        n = obs.shape[0]
        return cls(
            env_state=env_state,
            obs=torch.clamp(obs, -cfg.clip_obs, cfg.clip_obs),
            states=obs.new_zeros((n, state_dim)),
            ep_return=obs.new_zeros(n),
            ep_len=torch.zeros(n, dtype=torch.int32, device=obs.device),
        )


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


def make_networks(cfg: PPOConfig, static: EnvStatic, device=None,
                  generator: Optional[torch.Generator] = None):
    """(actor_critic, central_value or None), randomly initialised from
    ``generator``; the central value exists for an asymmetric config on an
    env with privileged states, as in the reference's ``make_networks``."""
    actor_critic = ActorCritic(static.obs_dim, static.action_dim, cfg.units,
                               log_std_min=cfg.log_std_min, generator=generator)
    central_value = (CentralValue(static.state_dim, cfg.units, generator=generator)
                     if cfg.central_value and static.asymmetric_obs else None)
    if central_value is not None:
        central_value = central_value.to(device)
    return actor_critic.to(device), central_value


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
            env_draws: Optional[Sequence] = None) -> Tuple[RolloutCarry, Trajectory]:
    """``cfg.horizon`` steps of policy + env. Action noise is ``noise[t]``
    when given (horizon, N, A), else drawn from ``generator``; env reset
    draws are ``env_draws[t]`` when given, else drawn from ``generator``."""
    n = static.num_envs
    env_state, obs, states = carry.env_state, carry.obs, carry.states
    ep_ret, ep_len = carry.ep_return, carry.ep_len
    fin_ret = obs.new_zeros(n)
    fin_n = torch.zeros(n, dtype=torch.int32, device=obs.device)
    fin_suc = obs.new_zeros(())
    asym = central_value is not None
    out = {k: [] for k in ("obs", "states", "action", "mu", "log_std", "neglogp",
                           "value", "reward", "done")}
    for t in range(cfg.horizon):
        mu, log_std, value = policy_and_value(actor_critic, central_value, obs, states)
        eps = (noise[t] if noise is not None
               else torch.randn(mu.shape, generator=generator, device=mu.device))
        action = mu + torch.exp(log_std) * eps
        neglogp = gaussian_neglogp(mu, log_std, action)
        clipped = torch.clamp(action, -cfg.clip_actions, cfg.clip_actions)
        if env_draws is not None:
            draws = env_draws[t]
        else:
            draws = (draw_reset_randoms(static, generator, n, obs.device, obs.dtype)
                     + draw_reset_randoms(static, generator, n, obs.device, obs.dtype))
        env_state, next_obs, next_states, reward, done, _ = env_step(
            static, env_params, env_state, clipped, draws
        )
        next_obs = torch.clamp(next_obs, -cfg.clip_obs, cfg.clip_obs)
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
                      fin_ret=fin_ret, fin_n=fin_n, fin_suc=fin_suc)
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
