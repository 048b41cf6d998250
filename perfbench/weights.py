"""The networks' starting weights, made by the benchmark from the seed on the
device, in one draw, and handed alike to the program and to the reference.

The distribution is the program's own initialisation (``models/networks.py``):
flax's variance scaling, a normal truncated at two standard deviations with
variance ``scale / fan_in`` (scale 2 for the towers and the value heads, 0.02
for the ``mu`` head), zero biases and a zero ``log_std``.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
from torch import nn

_TRUNC_STD = 0.87962566103423978  # std of a standard normal truncated at +-2


def _scale(name: str) -> float:
    return 0.02 if name.startswith("mu.") else 2.0


def initial_state_dict(module: nn.Module, generator: torch.Generator, device) -> Dict[str, torch.Tensor]:
    """A state dict of ``module``'s names and shapes, float32 on ``device``:
    every weight from one uniform draw of ``generator``, mapped through the
    inverse normal CDF into the truncated normal; biases and ``log_std``
    zero."""
    shapes = {k: tuple(v.shape) for k, v in module.state_dict().items()}
    weights = [k for k, s in shapes.items() if k.endswith(".weight")]
    total = sum(math.prod(shapes[k]) for k in weights)
    lo = 0.5 * math.erfc(2.0 / math.sqrt(2.0))  # Phi(-2)
    u = torch.rand(total, generator=generator, device=device, dtype=torch.float64)
    z = torch.special.ndtri(lo + u * (1.0 - 2.0 * lo))
    out, at = {}, 0
    for k, shape in shapes.items():
        if k in weights:
            size = math.prod(shape)
            std = math.sqrt(_scale(k) / shape[1]) / _TRUNC_STD
            out[k] = (z[at:at + size] * std).to(torch.float32).reshape(shape)
            at += size
        else:
            out[k] = torch.zeros(shape, dtype=torch.float32, device=device)
    return out
