"""XXH64's constants and mixing steps over int64 lanes, shared by the row
hash (``ops/hash.py``) and the string byte hash (``ops/strings.py``).

Every 64-bit lane is an int64 tensor holding the uint64 bits: add,
multiply and xor wrap exactly as uint64 does, and the constants past
2^63 are written as their signed images. Right shifts are made logical
by masking after the (arithmetic) shift.
"""

from __future__ import annotations

import torch


def s64(u: int) -> int:
    """The int64 image of a uint64 constant."""
    return u - (1 << 64) if u >= 1 << 63 else u


P1 = s64(0x9E3779B185EBCA87)
P2 = s64(0xC2B2AE3D4F54DE4F)
P3 = s64(0x165667B19E3779F9)
P4 = s64(0x85EBCA77C2B2AE63)
P5 = s64(0x27D4EB2F165667C5)


def lsr(x: torch.Tensor, r: int) -> torch.Tensor:
    """Logical right shift of int64 lanes holding uint64 bits."""
    return (x >> r) & ((1 << (64 - r)) - 1)


def rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return (x << r) | lsr(x, 64 - r)


def avalanche(h: torch.Tensor) -> torch.Tensor:
    h = h ^ lsr(h, 33)
    h = h * P2
    h = h ^ lsr(h, 29)
    h = h * P3
    return h ^ lsr(h, 32)
