"""MDP datatypes shared by environments (counterpart of
``leibnizgym_tpu/utils/mdp.py``).

The reference's ``RewardTerm`` maps to the pure-function + frozen-spec
pattern in ``envs.trifinger.rewards``; this module re-exports the spec type
and defines the step output container.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from leibnizgym_tpu_torch.envs.trifinger.rewards import RewardTermSpec  # noqa: F401


@dataclasses.dataclass
class Transition:
    """One environment transition (batched over envs)."""

    obs: torch.Tensor
    states: torch.Tensor
    reward: torch.Tensor
    done: torch.Tensor
    info: Dict[str, torch.Tensor]
