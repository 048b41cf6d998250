"""Actor-critic and central-value networks (counterpart of
``leibnizgym_tpu/models/networks.py``).

rl_games ``actor_critic`` with ``separate: True``: independent actor and
critic MLP towers (400/200/100, ELU), a state-independent ``log_std``
initialised to 0 and clipped to [log_std_min, log_std_max], a ``mu`` head
initialised with variance scaling 0.02, and a central value net of the same
shape on the privileged state. Layer names follow the flax modules
(``actor_i``, ``critic_i``, ``mu``, ``value``, ``log_std``, ``dense_i``) so
``convert.flax_params_to_state_dict`` loads reference weights directly.
The matmuls are plain ``nn.Linear`` parameters on cuBLAS.

``dtype`` is the towers' compute dtype, as flax ``nn.Dense(dtype=...)``
takes it: the parameters stay float32; with ``torch.bfloat16`` each layer
casts its input, weight and bias to bfloat16, and the product, the bias add
and the ELU run in bfloat16; ``mu`` and ``value`` come out as float32. The
``log_std`` clip stays float32.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn
from torch.nn import functional as F


def _variance_scaling_(w: torch.Tensor, scale: float,
                       generator: Optional[torch.Generator] = None):
    """flax variance_scaling(scale, "fan_in", "truncated_normal") on a
    torch (out, in) weight: a normal truncated at 2 std, rescaled so the
    truncated distribution has variance scale / fan_in."""
    fan_in = w.shape[1]
    std = math.sqrt(scale / fan_in) / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(w, std=std, a=-2.0 * std, b=2.0 * std, generator=generator)


def _dense(in_f: int, out_f: int, scale: float, generator) -> nn.Linear:
    layer = nn.Linear(in_f, out_f)
    _variance_scaling_(layer.weight, scale, generator)
    nn.init.zeros_(layer.bias)
    return layer


def _add_tower(module: nn.Module, in_dim: int, units: Sequence[int], prefix: str,
               generator) -> list:
    """Add layers ``{prefix}_0..`` (flax names) to ``module``; returns the names."""
    names = []
    for i, width in enumerate(units):
        names.append(f"{prefix}_{i}")
        setattr(module, names[-1], _dense(in_dim, width, 2.0, generator))
        in_dim = width
    return names


def _dense_in(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``layer(x)`` in ``dtype``: the product rounded to it, then the bias
    added in it (flax Dense's ``dot_general`` then ``+ bias``)."""
    if dtype == torch.float32:
        return layer(x)
    return F.linear(x.to(dtype), layer.weight.to(dtype)) + layer.bias.to(dtype)


def _run_tower(module: nn.Module, names, x, dtype=torch.float32):
    for name in names:
        x = F.elu(_dense_in(getattr(module, name), x, dtype))
    return x


class ActorCritic(nn.Module):
    """Separate actor/critic towers + fixed log-std (continuous_a2c_logstd).
    ``forward(obs)`` returns (mu, log_std broadcast to mu, value)."""

    def __init__(self, obs_dim: int, action_dim: int,
                 units: Sequence[int] = (400, 200, 100), mu_init_scale: float = 0.02,
                 log_std_min: float = -20.0, log_std_max: float = 2.0,
                 generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.log_std_min = log_std_min
        self.log_std_max = log_std_max
        self._actor = _add_tower(self, obs_dim, units, "actor", generator)
        self.mu = _dense(units[-1], action_dim, mu_init_scale, generator)
        self.log_std = nn.Parameter(torch.zeros(action_dim))
        self._critic = _add_tower(self, obs_dim, units, "critic", generator)
        self.value = _dense(units[-1], 1, 2.0, generator)

    def forward(self, obs: torch.Tensor):
        dt = self.dtype
        mu = _dense_in(self.mu, _run_tower(self, self._actor, obs, dt), dt).float()
        log_std = torch.clamp(self.log_std, self.log_std_min, self.log_std_max)
        value = _dense_in(self.value, _run_tower(self, self._critic, obs, dt), dt).float()
        return mu, log_std.expand_as(mu), value[..., 0]


class CentralValue(nn.Module):
    """Privileged-state value network (asymm.yaml central_value_config)."""

    def __init__(self, state_dim: int, units: Sequence[int] = (400, 200, 100),
                 generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self._hidden = _add_tower(self, state_dim, units, "dense", generator)
        self.value = _dense(units[-1], 1, 2.0, generator)

    def forward(self, states: torch.Tensor):
        h = _run_tower(self, self._hidden, states, self.dtype)
        return _dense_in(self.value, h, self.dtype).float()[..., 0]


def gaussian_neglogp(mu: torch.Tensor, log_std: torch.Tensor,
                     action: torch.Tensor) -> torch.Tensor:
    """Negative log-density of a diagonal Gaussian (rl_games neglogp form)."""
    var = torch.exp(2.0 * log_std)
    return 0.5 * torch.sum(
        torch.square(action - mu) / var + 2.0 * log_std + math.log(2.0 * math.pi),
        dim=-1,
    )


def gaussian_kl(mu0: torch.Tensor, log_std0: torch.Tensor, mu1: torch.Tensor,
                log_std1: torch.Tensor) -> torch.Tensor:
    """Analytic KL(p0 || p1), summed over action dims, mean over the batch
    (rl_games torch_ext.policy_kl)."""
    sig0sq = torch.exp(2.0 * log_std0)
    sig1sq = torch.exp(2.0 * log_std1)
    kl = log_std1 - log_std0 + (sig0sq + torch.square(mu0 - mu1)) / (2.0 * sig1sq) - 0.5
    return torch.mean(torch.sum(kl, dim=-1))


def gaussian_entropy(log_std: torch.Tensor) -> torch.Tensor:
    """Entropy of the diagonal Gaussian, summed over dims."""
    return torch.sum(log_std + 0.5 * math.log(2.0 * math.pi * math.e), dim=-1)
