"""Resource dir, recursive dict merge, seeding, the device rule of the
port's entry points and the card's name beside measurements.

``get_resources_dir``, ``update_dict``, ``merged_dict`` and
``set_np_formatting`` are the port's own copies of the JAX package's
``leibnizgym_tpu/utils/helpers.py`` (``tests/test_torch_copies.py`` holds
them to it); ``set_seed`` returns a ``torch.Generator`` where the JAX one
returns a PRNG key.
"""

from __future__ import annotations

import collections.abc
import copy
import os
import random
import subprocess

import numpy as np
import torch


def get_resources_dir() -> str:
    """Path to the ``resources`` directory shipped with the package."""
    resources_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..", "resources")
    return os.path.abspath(resources_dir)


def update_dict(orig_dict: dict, new_dict: collections.abc.Mapping) -> dict:
    """Recursively merge ``new_dict`` into ``orig_dict`` (in place) and return it."""
    for keyname, value in new_dict.items():
        if isinstance(value, collections.abc.Mapping):
            orig_dict[keyname] = update_dict(orig_dict.get(keyname, {}), value)
        else:
            orig_dict[keyname] = value
    return orig_dict


def merged_dict(orig_dict: dict, new_dict: collections.abc.Mapping) -> dict:
    """Pure variant of :func:`update_dict` — deep-copies before merging."""
    return update_dict(copy.deepcopy(orig_dict), new_dict)


def set_np_formatting():
    """Numpy print formatting (rlgpu.utils.config.set_np_formatting parity)."""
    np.set_printoptions(
        edgeitems=30, infstr="inf", linewidth=4000, nanstr="nan",
        precision=2, suppress=False, threshold=10000, formatter=None,
    )


def set_seed(seed: int, device="cpu") -> torch.Generator:
    """Seed Python's, numpy's and torch's global generators and return a
    ``torch.Generator`` on ``device`` seeded with ``seed`` (the JAX package
    returns ``jax.random.PRNGKey(seed)``; the two give different streams)."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    generator = torch.Generator(device=device)
    generator.manual_seed(seed)
    return generator


def resolve_device(name="cuda:0", cpu_hint: str = 'device="cpu"') -> torch.device:
    """The torch device for a device name. ``"TPU"`` (the shared config's
    default) means ``cuda:0``. A CUDA device without a card is an error
    naming ``cpu_hint``, never a silent CPU run."""
    device = torch.device("cuda", 0) if str(name).upper() == "TPU" else torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {name!r} asks for CUDA, but torch.cuda.is_available() is False; "
            f"pass {cpu_hint} to run on the CPU"
        )
    return device


def device_name(device: torch.device) -> str:
    """The card's name for a CUDA device, else the device string (``cpu``)."""
    return torch.cuda.get_device_name(device) if device.type == "cuda" else str(device)


def synchronize(device: torch.device):
    """Wait for the device's queued work (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def smi() -> str:
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader`` gives them (first card), to print beside a time."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60).stdout.strip()
    except OSError:
        out = ""
    return out.splitlines()[0] if out else "nvidia-smi: n/a"
