"""Normalization transforms, quaternion algebra and the 3x3 helpers of the
robot dynamics on tensors (counterpart of ``leibnizgym_tpu/utils/math.py``). Quaternions are (x, y, z, w), real part
last; every function broadcasts over leading batch dims."""

from __future__ import annotations

import torch


def scale_transform(x: torch.Tensor, lower: torch.Tensor, upper: torch.Tensor) -> torch.Tensor:
    """Normalize ``x`` from ``[lower, upper]`` to ``[-1, 1]``."""
    offset = (lower + upper) * 0.5
    return 2.0 * (x - offset) / (upper - lower)


def unscale_transform(x: torch.Tensor, lower: torch.Tensor, upper: torch.Tensor) -> torch.Tensor:
    """Denormalize ``x`` from ``[-1, 1]`` to ``[lower, upper]``."""
    offset = (lower + upper) * 0.5
    return x * (upper - lower) * 0.5 + offset


def saturate(x: torch.Tensor, lower: torch.Tensor, upper: torch.Tensor) -> torch.Tensor:
    """Clamp ``x`` to ``[lower, upper]``."""
    return torch.maximum(torch.minimum(x, upper), lower)


def quaternion_from_euler_xyz(roll: torch.Tensor, pitch: torch.Tensor,
                              yaw: torch.Tensor) -> torch.Tensor:
    """Euler XYZ (radians) to quaternion (x, y, z, w)."""
    cy = torch.cos(yaw * 0.5)
    sy = torch.sin(yaw * 0.5)
    cr = torch.cos(roll * 0.5)
    sr = torch.sin(roll * 0.5)
    cp = torch.cos(pitch * 0.5)
    sp = torch.sin(pitch * 0.5)
    qw = cy * cr * cp + sy * sr * sp
    qx = cy * sr * cp - sy * cr * sp
    qy = cy * cr * sp + sy * sr * cp
    qz = sy * cr * cp - cy * sr * sp
    return torch.stack([qx, qy, qz, qw], dim=-1)

