"""Device resolution for the port's entry points.

Entry points run on the card unless the caller names another device:
``device=None`` means CUDA, and with no CUDA device present that is an
error, never a quiet run on the CPU. Operators take the device of the
tensors they are given.
"""

from __future__ import annotations

import subprocess

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; None selects ``cuda`` and raises
    when no CUDA device is available."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available: pass device='cpu' to run on the "
            "CPU explicitly")
    return torch.device("cuda")


def card_line() -> str:
    """The first card's name and power limit as ``nvidia-smi`` prints them
    (``name,power.limit``): every timing is reported beside it, since a
    card set below its maximum power runs slower under load."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
