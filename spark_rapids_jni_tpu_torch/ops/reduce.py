"""Column-level scalar reductions (counterpart of
``spark_rapids_jni_tpu/ops/reduce.py``): COUNT, SUM, MIN, MAX and MEAN
with SQL null semantics (nulls are skipped; an all-null column's SUM,
MIN, MAX and MEAN are null). Each returns device scalars, (value,
valid), so callers compose them without a host read.

Integral and decimal sums accumulate in int64 (unsigned ones in uint64
bits), exact and wrapping; float sums keep the column's dtype, in an
order that differs from the reference's. STRING and DECIMAL128 MIN/MAX
take row 0 or the last valid row of one nulls-last sort, and return a
1-row column (STRING padded). DECIMAL128 SUM is exact in four 32-bit
limb lanes (a total past 128 bits is null), and its MEAN the exact long
division of ``ops/_decimal128.py``, both as (2,) limb pairs.
"""

from __future__ import annotations

import numpy as np
import torch

from spark_rapids_jni_tpu_torch.columnar import Column, Table
from spark_rapids_jni_tpu_torch.ops._decimal128 import (
    _mean128_exact,
    recombine_sum128,
    split_sum128_lanes,
)
from spark_rapids_jni_tpu_torch.ops.sort import gather, int64_value, sort_order


def count(col: Column) -> torch.Tensor:
    """Non-null count, int64 (always valid)."""
    return col.valid_mask().to(torch.int64).sum()


def sum_(col: Column):
    """(sum, valid): integers and decimals in int64, unsigned integers in
    uint64 (the same wrapping bits), floats in their own dtype; DECIMAL128
    as an exact (2,) limb pair, null past 128 bits."""
    if col.dtype.is_string:
        raise TypeError("SUM of a STRING column")
    valid = col.valid_mask()
    has_any = valid.any()
    if col.dtype.is_decimal128:
        lo = torch.where(valid, col.data[:, 0], 0)
        hi = torch.where(valid, col.data[:, 1], 0)
        lanes = [lane.sum() for lane in split_sum128_lanes(lo, hi)]
        lo_t, hi_t, ovf = recombine_sum128(*lanes)
        return torch.stack([lo_t, hi_t]), has_any & ~ovf
    kind = col.dtype.storage_dtype.kind
    if kind in ("i", "u", "b"):
        total = torch.where(valid, int64_value(col.data), 0).sum()
        return (total.view(torch.uint64) if kind == "u" else total), has_any
    return torch.where(valid, col.data, 0).sum(), has_any


def _minmax(col: Column, op: str):
    if col.dtype.is_string or col.dtype.is_decimal128:
        # the winner is row 0 / the last valid row of the nulls-last order
        order = sort_order(Table([col]), [0], nulls_first=[False])
        valid = col.valid_mask()
        pos = 0 if op == "min" else (
            valid.to(torch.int64).sum() - 1).clamp(min=0)
        winner = gather(Table([col]), order[pos].reshape(1)).column(0)
        return winner, valid.any()
    np_dt = col.dtype.storage_dtype
    if np_dt.kind == "f":
        neutral = np.inf if op == "min" else -np.inf
    else:
        info = np.iinfo(np_dt)
        neutral = int(info.max if op == "min" else info.min)
    valid = col.valid_mask()
    data = col.data
    if data.dtype == torch.uint64:
        # compare in the sign-flipped image, which keeps uint64 order
        img = data.view(torch.int64) ^ (-(1 << 63))
        red = torch.where(valid, img, neutral - (1 << 63))
        red = red.min() if op == "min" else red.max()
        return (red ^ (-(1 << 63))).view(torch.uint64), valid.any()
    if data.dtype in (torch.uint16, torch.uint32):
        red = torch.where(valid, data.to(torch.int64), neutral)
        red = red.min() if op == "min" else red.max()
        return red.to(data.dtype), valid.any()
    vals = torch.where(valid, data, torch.tensor(neutral, dtype=data.dtype,
                                                 device=data.device))
    return (vals.min() if op == "min" else vals.max()), valid.any()


def min_(col: Column):
    return _minmax(col, "min")


def max_(col: Column):
    return _minmax(col, "max")


def mean(col: Column):
    """(mean, valid) as FLOAT64, decimals rescaled to their true value
    (the groupby mean's contract); DECIMAL128 as the exact (2,) limb pair
    of the unscaled mean at 4 more fractional digits."""
    total, has_any = sum_(col)
    if col.dtype.is_decimal128:
        limbs, overflow = _mean128_exact(total[0:1], total[1:2],
                                         count(col).reshape(1))
        return limbs[0], has_any & ~overflow[0]
    if total.dtype == torch.uint64:
        # the unsigned value, rounded once: two exact 32-bit halves
        bits = total.view(torch.int64)
        total = ((bits >> 32) & 0xFFFFFFFF).to(torch.float64) * 2.0 ** 32 \
            + (bits & 0xFFFFFFFF).to(torch.float64)
    m = total.to(torch.float64) / count(col).clamp(min=1).to(torch.float64)
    if col.dtype.is_decimal:
        m = m * (10.0 ** col.dtype.scale)
    return m, has_any
