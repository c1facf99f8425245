"""The shuffle's wire codec (counterpart of ``spark_rapids_jni_tpu/
parallel/wire.py``): planner-declared transforms with a static output
size and a dynamic overflow flag.

``BitPack(bits=12, reference=8400)`` packs each value' = value -
reference into ``bits`` bits, 32 values per ``bits`` uint32 words. A
value outside [0, 2^bits) sets the shuffle's ``narrowing_overflow`` flag
(detection, never silent truncation), as a narrowing wire dtype does.

Pack layout: value j of a block occupies bits [j*bits, (j+1)*bits) of
the little-endian uint32 word stream, the Parquet/ORC bit-packing order.
The arithmetic runs in int64 lanes (torch has no shifts of uint32 on
every device); packed words come back as ``torch.uint32``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

__all__ = ["BitPack", "pack_bits", "unpack_bits", "shuffle_wire_bytes"]

_MASK32 = 0xFFFFFFFF


@dataclass(frozen=True)
class BitPack:
    """Planner-declared wire spec: k-bit frame-of-reference packing."""

    bits: int
    reference: int = 0

    def __post_init__(self) -> None:
        if not 1 <= self.bits <= 32:
            raise ValueError("bits must be in [1, 32]")

    def words_for(self, n: int) -> int:
        """uint32 words needed for n values (static)."""
        return (n * self.bits + 31) // 32


def _as_int64(values: torch.Tensor) -> torch.Tensor:
    if values.dtype == torch.uint64:
        return values.view(torch.int64)
    if values.dtype in (torch.uint16, torch.uint32):
        signed = {torch.uint16: torch.int16, torch.uint32: torch.int32}
        bits = values.dtype.itemsize * 8
        return values.view(signed[values.dtype]).to(torch.int64) \
            & ((1 << bits) - 1)
    return values.to(torch.int64)


def pack_bits(values: torch.Tensor,
              spec: BitPack) -> tuple[torch.Tensor, torch.Tensor]:
    """Pack integer ``values`` (trailing axis = values) into uint32 words.
    Returns (packed[..., W], overflowed 0-d bool). Leading axes (the
    per-destination blocks of a send buffer) pack independently.

    Each output word ORs the at most ceil(32/bits)+1 values whose bit
    fields overlap it: a static loop of gathers, as in the reference."""
    bits = spec.bits
    n = int(values.shape[-1])
    w = spec.words_for(n)
    device = values.device
    v64 = _as_int64(values) - spec.reference
    overflow = ((v64 < 0) | (v64 >= (1 << bits))).any()
    v = v64 & ((1 << bits) - 1)

    word_bit0 = np.arange(w, dtype=np.int64) * 32
    j_min = word_bit0 // bits
    k_max = int(np.max((word_bit0 + 31) // bits - j_min)) if w else 0

    packed = torch.zeros(values.shape[:-1] + (w,), dtype=torch.int64,
                         device=device)
    for k in range(k_max + 1):
        j = j_min + k
        jc = torch.from_numpy(np.minimum(j, max(n - 1, 0))).to(device)
        vj = v[..., jc] if n else torch.zeros_like(packed)
        # shift of value j relative to the word's start, in (-32, 32):
        # negative = the value started in an earlier word
        shift = j * bits - word_bit0
        left = torch.from_numpy(np.where(shift > 0, shift, 0)).to(device)
        right = torch.from_numpy(np.where(shift < 0, -shift, 0)).to(device)
        contrib = ((vj << left) & _MASK32) >> right
        valid_j = torch.from_numpy(j < n).to(device)
        packed = packed | torch.where(valid_j, contrib, 0)
    return packed.to(torch.uint32), overflow


def unpack_bits(packed: torch.Tensor, n: int, spec: BitPack,
                dtype: torch.dtype) -> torch.Tensor:
    """Inverse of :func:`pack_bits`: uint32 words -> n values of
    ``dtype``."""
    bits = spec.bits
    w = int(packed.shape[-1])
    device = packed.device
    words = _as_int64(packed)
    bit0 = np.arange(n, dtype=np.int64) * bits
    word = torch.from_numpy(bit0 // 32).to(device)
    off = torch.from_numpy(bit0 % 32).to(device)
    low = words[..., word] >> off
    spill = off + bits > 32
    nxt = words[..., (word + 1).clamp(max=max(w - 1, 0))]
    high = torch.where(spill, (nxt << torch.where(spill, 32 - off, 1))
                       & _MASK32, 0)
    v = (low | high) & ((1 << bits) - 1)
    out = v + spec.reference
    if dtype == torch.uint64:
        return out.view(torch.uint64)
    return out.to(dtype)


def shuffle_wire_bytes(table, wire_dtypes, capacity: int,
                       num_devices: int) -> dict:
    """Planner accounting: bytes one executor sends into the all-to-all
    per ``hash_shuffle`` call, per column plus masks, with and without
    the declared wire specs. Static, from shapes: masks count one byte a
    slot (the port sends them as uint8)."""
    size = num_devices * capacity
    per_col_raw: list[int] = []
    per_col_wire: list[int] = []
    for i, col in enumerate(table.columns):
        wire = None if wire_dtypes is None else wire_dtypes[i]
        if col.dtype.is_string:
            from spark_rapids_jni_tpu_torch.ops.strings import pad_strings

            width = int(pad_strings(col).chars.shape[1])
            raw = size * (4 + width)  # int32 lengths + char matrix
            per_col_raw.append(raw)
            per_col_wire.append(raw)
            continue
        elem = col.dtype.size_bytes
        per_col_raw.append(size * elem)
        if isinstance(wire, BitPack):
            per_col_wire.append(num_devices * wire.words_for(capacity) * 4)
        elif wire is not None:
            per_col_wire.append(size * wire.size_bytes)
        else:
            per_col_wire.append(size * elem)
    mask_bytes = size * (1 + len(table.columns))  # occupied + per-col validity
    return {
        "raw_bytes": sum(per_col_raw) + mask_bytes,
        "wire_bytes": sum(per_col_wire) + mask_bytes,
        "per_column_raw": per_col_raw,
        "per_column_wire": per_col_wire,
        "mask_bytes": mask_bytes,
    }
