"""Validity bit packing (counterpart of
``spark_rapids_jni_tpu/columnar/bitmask.py``).

Validity stays unpacked on the device, one bool per row. The packed-row
validity tail packs it little-endian within a byte: bit ``i % 8`` of byte
``i // 8``.
"""

from __future__ import annotations

import torch


def pack_bits_last_axis(bits: torch.Tensor) -> torch.Tensor:
    """Pack bool[..., k] into uint8[..., ceil(k/8)], bit i%8 of byte i//8
    set <=> bits[..., i]. Trailing pad bits are 0."""
    k = bits.shape[-1]
    n_bytes = (k + 7) // 8
    lead = bits.shape[:-1]
    padded = torch.zeros((*lead, n_bytes * 8), dtype=torch.uint8,
                         device=bits.device)
    padded[..., :k] = bits.to(torch.uint8)
    shifts = torch.arange(8, dtype=torch.uint8, device=bits.device)
    return (padded.reshape(*lead, n_bytes, 8) << shifts).sum(
        dim=-1, dtype=torch.uint8)


def unpack_bits(packed: torch.Tensor, n: int) -> torch.Tensor:
    """Unpack a little-endian uint8 bitmask into bool[n]; the inverse of
    :func:`pack_bits_last_axis` on one axis."""
    shifts = torch.arange(8, dtype=torch.uint8, device=packed.device)
    return ((packed[:, None] >> shifts) & 1).reshape(-1)[:n].bool()
