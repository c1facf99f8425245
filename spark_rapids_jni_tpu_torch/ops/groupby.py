"""Bounded-domain groupby (counterpart of the bounded part of
``spark_rapids_jni_tpu/ops/groupby.py``).

When the planner declares each key column's candidate values, grouping
needs no sort: dense group ids come from a search in the tiny sorted
domain, and every aggregate is a per-group reduction in one streaming
pass — the ``groupby.bounded_accumulate`` kernel on the card
(ops/kernels/groupby_accumulate.py). The sort-based general groupby is
not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from spark_rapids_jni_tpu_torch.columnar import Column, Table
from spark_rapids_jni_tpu_torch.ops import kernels
from spark_rapids_jni_tpu_torch.ops.kernels import groupby_accumulate as kga
from spark_rapids_jni_tpu_torch.types import DType, TypeId


def minmax_sentinel(dt: DType, op: str):
    """The null-neutral fill for a min/max reduction over ``dt``: the
    dtype's +inf/max for ``min``, -inf/min for ``max``."""
    np_dt = dt.storage_dtype
    if np_dt.kind == "f":
        lo, hi = -float("inf"), float("inf")
    else:
        info = np.iinfo(np_dt)
        lo, hi = int(info.min), int(info.max)
    return hi if op == "min" else lo


def _sum_dtype(dt: DType) -> DType:
    """Spark widens SUM: integral -> INT64, decimal keeps scale (wider
    precision), floats stay floating."""
    if dt.is_decimal128:
        raise NotImplementedError(
            "DECIMAL128 aggregation is not supported yet (limb-pair "
            "arithmetic); cast to DECIMAL64 first if the values fit"
        )
    kind = dt.storage_dtype.kind
    if dt.is_decimal:
        return DType(TypeId.DECIMAL64, dt.scale)
    if kind in ("i", "u", "b"):
        return DType(TypeId.INT64)
    return dt


# torch has no comparison kernels for these: they widen to int64, which
# keeps their order and value
_WIDEN = (torch.uint16, torch.uint32)


def _ordered(x: torch.Tensor) -> torch.Tensor:
    if x.dtype in _WIDEN:
        return x.to(torch.int64)
    if x.dtype == torch.uint64:
        raise NotImplementedError(
            "uint64 keys and min/max are not ported yet")
    return x


def bounded_group_layout(domain_lens: Sequence[int]):
    """Static layout of the bounded-groupby output.

    One slot per combination of (domain value | null) per key:
    ``m = prod(len+1)``. Returns ``(sizes, m, codes, order)`` where
    ``codes[g, pos]`` is key ``pos``'s domain index for group ``g``
    (``== domain_lens[pos]`` means the null slot) and ``order`` is the
    output permutation — real-key groups first in lexicographic key
    order, null-key groups after (ORDER BY ... NULLS LAST at no device
    cost).
    """
    sizes = [int(l) + 1 for l in domain_lens]
    m = int(np.prod(sizes)) if sizes else 1
    codes = np.zeros((m, len(sizes)), dtype=np.int64)
    for pos, size in enumerate(sizes):
        stride = int(np.prod(sizes[pos + 1:])) or 1
        codes[:, pos] = (np.arange(m) // stride) % size
    has_null = (codes == (np.asarray(sizes) - 1)).any(axis=1) \
        if sizes else np.zeros((m,), bool)
    order = np.asarray(
        sorted(range(m), key=lambda g: (bool(has_null[g]), g)),
        dtype=np.int64)
    return sizes, m, codes, order


class BoundedLanes(NamedTuple):
    """The accumulate kernel's lanes for one bounded groupby, and where
    each aggregate's lane sits."""

    lanes: list
    rows: int
    vcount: dict  # col_idx -> lane
    sums: dict  # col_idx -> lane
    minmax: dict  # (col_idx, op) -> lane


def bounded_lanes(table: Table, aggs) -> BoundedLanes:
    """A row-count lane, a valid-count lane per column, a sum lane per
    summed column and a sentinel-neutral lane per min/max, each reading
    the column's storage and validity as they are."""
    lanes: list[kga.Lane] = []

    def add(op, values, valid, neutral):
        lanes.append(kga.Lane(op, values, valid, neutral))
        return len(lanes) - 1

    rows = add("sum", None, None, 0)
    vcount: dict[int, int] = {}
    sums: dict[int, int] = {}
    minmax: dict[tuple[int, str], int] = {}
    for col_idx, op in aggs:
        c = table.column(col_idx)
        if col_idx not in vcount:
            vcount[col_idx] = add("sum", None, c.validity, 0)
        if op in ("sum", "mean") and col_idx not in sums:
            sums[col_idx] = add("sum", c.data, c.validity, 0)
        if op in ("min", "max") and (col_idx, op) not in minmax:
            minmax[(col_idx, op)] = add(
                op, c.data, c.validity, minmax_sentinel(c.dtype, op))
    return BoundedLanes(lanes, rows, vcount, sums, minmax)


class BoundedGroupByResult(NamedTuple):
    """Output of groupby_aggregate_bounded: one row per domain combination
    (null slots included), in a STATIC order — real-key groups first in
    lexicographic key order, null-key groups after. Empty combinations
    carry validity False everywhere."""

    table: Table
    # bool[m]: at least one input row landed in this group
    present: torch.Tensor
    # 0-d bool: some row's key value was outside its declared domain (and
    # not null) — that row is in NO group; the caller must re-plan
    domain_miss: torch.Tensor


def dense_gid(table: Table, keys, key_domains, m: int,
              row_valid: Optional[torch.Tensor]):
    """Dense group id per row over the domain cross product, and whether
    any existing, non-null key missed its domain."""
    n = table.num_rows
    device = table.columns[0].device if table.columns else None
    gid = torch.zeros((n,), dtype=torch.int32, device=device)
    domain_miss = torch.zeros((), dtype=torch.bool, device=device)
    for k, dom in zip(keys, key_domains):
        c = table.column(k)
        if c.dtype.is_decimal128:
            raise NotImplementedError(
                "bounded-domain keys are fixed-width scalars")
        data = _ordered(c.data)
        dom_arr = torch.tensor(sorted(dom), dtype=data.dtype, device=device)
        valid = c.valid_mask()
        code = torch.searchsorted(dom_arr, data).to(torch.int32)
        clipped = code.clamp(0, len(dom) - 1)
        hit = dom_arr[clipped.long()] == data
        miss_rows = valid & ~hit
        if row_valid is not None:
            miss_rows = miss_rows & row_valid
        domain_miss = domain_miss | miss_rows.any()
        # null slot = len(dom); missed rows park there too but are
        # excluded from every group by the miss flag contract
        code = torch.where(valid & hit, clipped, len(dom))
        gid = gid * (len(dom) + 1) + code
    if row_valid is not None:
        # non-rows (shard padding) match NO group, not even the null slot
        gid = torch.where(row_valid, gid, m)
    return gid, domain_miss


def groupby_aggregate_bounded(
    table: Table,
    keys: Sequence[int],
    aggs: Sequence[tuple[int, str]],
    key_domains: Sequence[Sequence[int]],
    row_valid: Optional[torch.Tensor] = None,
) -> BoundedGroupByResult:
    """Groupby with PLANNER-DECLARED key domains: no sort, no gather —
    one streaming pass.

    ``key_domains``: one sequence of candidate raw values per key column.
    Each key also gets an implicit NULL slot (Spark: null keys form their
    own group), so m = prod(len(d)+1). Supported aggs: sum, count, mean,
    min, max. Rows whose key value is outside its domain land in no group
    and raise ``domain_miss``.

    ``row_valid``: bool[n] marking rows that EXIST — False rows join NO
    group, not even the null slot, and never raise ``domain_miss``.
    """
    for _, op in aggs:
        if op not in ("sum", "count", "mean", "min", "max"):
            raise ValueError(
                f"groupby_aggregate_bounded supports sum/count/mean/min/"
                f"max, not {op!r} (use groupby_aggregate)"
            )
    if len(key_domains) != len(keys):
        raise ValueError("one domain per key column required")
    for col_idx, op in aggs:
        dt = table.column(col_idx).dtype
        if dt.is_decimal128 and op != "count":
            raise NotImplementedError(
                "DECIMAL128 aggregation is not supported yet (limb-pair "
                "arithmetic); cast to DECIMAL64 first if the values fit")
    _, m, slot_codes, order = bounded_group_layout(
        [len(d) for d in key_domains])
    gid, domain_miss = dense_gid(table, keys, key_domains, m, row_valid)
    device = gid.device

    # every (group, lane) partial from ONE accumulate: the kernel for CUDA
    # tensors, its plain version for CPU ones
    lanes = bounded_lanes(table, aggs)
    reason = kga.unsupported_reason(lanes.lanes, m)
    if reason is None:
        acc = kga.accumulate(gid, lanes.lanes, m).unbind(1)
    else:
        kernels.fall_back(kga.NAME, reason)
        if gid.is_cuda:
            raise NotImplementedError(
                f"groupby_aggregate_bounded: the {kga.NAME} kernel does not "
                f"take this input ({reason}), and a CUDA input never runs "
                f"the plain version")
        acc = kga.reduce_lanes_plain(gid, lanes.lanes, m)

    present = acc[lanes.rows] > 0

    out_cols: list[Column] = []
    # static key materialization: group g's key tuple is known from the
    # layout; null slot -> validity False
    for pos, (k, dom) in enumerate(zip(keys, key_domains)):
        c = table.column(k)
        vals = np.zeros((m,), dtype=c.dtype.storage_dtype)
        kvalid = np.zeros((m,), dtype=bool)
        dom_sorted = sorted(dom)
        for g in range(m):
            code = slot_codes[g, pos]
            if code < len(dom_sorted):
                vals[g] = dom_sorted[code]
                kvalid[g] = True
        out_cols.append(Column(
            c.dtype, torch.from_numpy(vals).to(device),
            torch.from_numpy(kvalid).to(device) & present))

    for col_idx, op in aggs:
        c = table.column(col_idx)
        vcount = acc[lanes.vcount[col_idx]]
        if op == "count":
            out_cols.append(Column(DType(TypeId.INT64), vcount, present))
            continue
        if op in ("sum", "mean"):
            acc_dt = _sum_dtype(c.dtype)
            total = acc[lanes.sums[col_idx]]  # int64, or float64 for floats
            if op == "sum":
                out_cols.append(Column(
                    acc_dt, total.to(acc_dt.torch_dtype), vcount > 0))
            else:
                denom = torch.clamp(vcount, min=1).to(torch.float64)
                mean = total.to(torch.float64) / denom
                if c.dtype.is_decimal:
                    mean = mean * (10.0 ** c.dtype.scale)
                out_cols.append(
                    Column(DType(TypeId.FLOAT64), mean, vcount > 0))
            continue
        # min / max
        red = acc[lanes.minmax[(col_idx, op)]].to(c.data.dtype)
        out_cols.append(Column(c.dtype, red, vcount > 0))

    # static reorder from the shared layout: real-key groups first
    # (lexicographic), null-key groups after
    perm = torch.from_numpy(order).to(device)
    out_cols = [
        Column(c.dtype, c.data[perm],
               None if c.validity is None else c.validity[perm])
        for c in out_cols
    ]
    return BoundedGroupByResult(Table(out_cols), present[perm], domain_miss)
