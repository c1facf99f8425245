"""Distributed ORDER BY (counterpart of ``spark_rapids_jni_tpu/parallel/
sort.py``): a range-partitioned global sort over the executor mesh,
Spark's ``RangePartitioner`` + per-partition sort.

Splitters are planned on the host from a bounded sample of the primary
key; every row's destination is one ``searchsorted`` over them, the
exchange is the hash shuffle's transport (``shuffle_by_partition``), and
each executor finishes with a local ``sort_table``. Concatenating the
executors' partitions in order IS the global order; ties on the primary
key stay co-located, so secondary keys order exactly.

Primary keys may be fixed-width, DECIMAL128 or STRING (strings bucket on
an 8-byte big-endian prefix; equal prefixes co-locate, so exactness
holds). Encoded keys live in int64 lanes: every encoding is shifted
right one bit into [1, 2^63), so signed order is the reference's
unsigned order.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from spark_rapids_jni_tpu_torch.columnar import Column, Table
from spark_rapids_jni_tpu_torch.ops.sort import (
    INT64_MIN,
    gather,
    order_key,
    sort_table,
)
from spark_rapids_jni_tpu_torch.parallel.shuffle import shuffle_by_partition
from spark_rapids_jni_tpu_torch.utils.tracing import func_range

__all__ = ["plan_splitters", "DistributedSort", "distributed_sort"]

_LOW63 = (1 << 63) - 1


def _unsigned_bits(x: torch.Tensor) -> tuple[torch.Tensor, int]:
    """The reference's order-preserving unsigned key of an integer or
    float32 column, as the int64 bit pattern of that unsigned value, and
    its width in bits."""
    bits = x.dtype.itemsize * 8
    if x.dtype == torch.float32:
        u = x.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
        enc = torch.where(u >> 31 == 1, u ^ 0xFFFFFFFF, u ^ 0x80000000)
        # every NaN (either sign) above +inf, as Spark orders NaN
        return torch.where(torch.isnan(x), 0xFFFFFFFF, enc), 32
    if x.dtype in (torch.uint64, torch.int64):
        k = x.view(torch.int64)
        return (k if x.dtype == torch.uint64 else k ^ INT64_MIN), 64
    k = order_key(x)
    if x.dtype.is_signed:
        k = k + (1 << (bits - 1))
    return k, bits


def _encode_primary(col: Column) -> torch.Tensor:
    """Order-preserving encoding of the primary sort key in [1, 2^63) as
    int64; nulls encode as 0, below every valid value (nulls first).

    Strings bucket on their first 8 bytes (big-endian): a prefix is the
    major component of memcmp order and equal prefixes collapse to one
    bucket, so ties stay co-located and the local sort's full keys keep
    the global order exact (DECIMAL128 buckets on its sign-flipped high
    limb, FLOAT64 on its float32 truncation, by the same argument)."""
    if col.dtype.is_string:
        from spark_rapids_jni_tpu_torch.ops.strings import pad_strings

        p = pad_strings(col)
        mat, lengths = p.chars, p.data
        col = p
        enc = torch.zeros((p.size,), dtype=torch.int64, device=mat.device)
        for b in range(min(8, int(mat.shape[1]))):
            byte = torch.where(b < lengths, mat[:, b].to(torch.int64), 0)
            enc = enc | (byte << (8 * (7 - b)))
    elif col.dtype.is_decimal128:
        enc = col.data[:, 1] ^ INT64_MIN
    elif col.data.dtype == torch.float64:
        enc32, _ = _unsigned_bits(col.data.to(torch.float32))
        enc = enc32 << 32
    else:
        enc, bits = _unsigned_bits(col.data)
        if bits < 64:
            enc = enc << (64 - bits)
    # a logical shift right by one into [0, 2^63), then 0 kept for nulls
    enc = ((enc >> 1) & _LOW63).clamp(min=1)
    return torch.where(col.valid_mask(), enc, 0)


def plan_splitters(table: Table, key: int, num_partitions: int,
                   sample_size: int = 65536) -> np.ndarray:
    """Host-side range planning: ``num_partitions - 1`` ascending
    splitters (uint64, the reference's type; every value is below 2^63)
    from the quantiles of a bounded strided sample of the encoded
    primary key. ``table`` is the whole table (a sharded one seen whole:
    ``distributed.global_table``)."""
    col = table.column(key)
    n = col.size
    if n == 0:
        return np.zeros(max(num_partitions - 1, 0), dtype=np.uint64)
    if n > sample_size:
        idx = torch.from_numpy(
            np.linspace(0, n - 1, sample_size).astype(np.int64)
        ).to(col.device)
        col = gather(Table([col]), idx).column(0)
    enc = _encode_primary(col).cpu().numpy().astype(np.uint64)
    qs = np.linspace(0, 1, num_partitions + 1)[1:-1]
    return np.quantile(enc, qs, method="nearest").astype(np.uint64)


class DistributedSort(NamedTuple):
    table: list        # per-executor sorted partitions, executor order
    num_rows: list     # per-executor 0-d int64 real rows
    overflowed: list   # per-executor range-shuffle capacity overflow


@func_range("distributed_sort")
def distributed_sort(
    table: Sequence[Table],
    keys: Sequence[int],
    mesh,
    ascending: Sequence[bool] | None = None,
    capacity: Optional[int] = None,
    row_valid: Optional[Sequence[torch.Tensor]] = None,
    splitters: Optional[np.ndarray] = None,
) -> DistributedSort:
    """Global multi-key sort: range-shuffle by the primary key, then a
    local sort per executor. ``table`` is the sharded table
    (``shard_table``); pass its ``row_valid`` so padding rows drop
    before the exchange. Executor e's partition holds the e-th ascending
    key range, so ``collect`` concatenation is globally ordered.
    Ascending only, as in the reference (reverse the collected result
    for all-descending orders)."""
    from spark_rapids_jni_tpu_torch import types as t
    from spark_rapids_jni_tpu_torch.parallel.distributed import global_table

    tables = list(table)
    keys = list(keys)
    if ascending is not None and not all(ascending):
        raise NotImplementedError(
            "distributed_sort is ascending-only this round; reverse the "
            "collected result for all-descending orders")
    d = mesh.size
    if splitters is None:
        whole = global_table(mesh, [Table([tb.column(keys[0])])
                                    for tb in tables])
        splitters = plan_splitters(whole, 0, d)
    spl = np.asarray(splitters, dtype=np.uint64).astype(np.int64)
    parts = []
    for tb in tables:
        enc = _encode_primary(tb.column(keys[0]))
        s = torch.from_numpy(spl).to(enc.device)
        parts.append(torch.searchsorted(s, enc, right=True).to(torch.int32))
    shuffled = shuffle_by_partition(mesh, tables, parts, capacity=capacity,
                                    row_valid=row_valid)
    out, n_real = [], []
    for sh in shuffled:
        # the occupancy mask as the MOST significant key (descending:
        # real rows first), so phantom slots never interleave with real
        # null-key rows; the user keys keep nulls-first order
        mask_col = Column(t.UINT8, sh.row_valid.to(torch.uint8))
        aug = Table([mask_col] + list(sh.table.columns))
        ordered = sort_table(aug, [0] + [k + 1 for k in keys],
                             ascending=[False] + [True] * len(keys))
        out.append(Table(ordered.columns[1:]))
        n_real.append(sh.row_valid.to(torch.int64).sum())
    return DistributedSort(out, n_real, [sh.overflowed for sh in shuffled])
