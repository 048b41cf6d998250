"""Recursive dict merge, the device rule of the port's entry points and the
card's name beside measurements.

``update_dict`` and ``merged_dict`` are the port's own copies of the JAX
package's ``leibnizgym_tpu/utils/helpers.py`` (``tests/test_torch_copies.py``
holds them to it).
"""

from __future__ import annotations

import collections.abc
import copy
import subprocess

import torch


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
