"""Groupby-aggregate (counterpart of ``spark_rapids_jni_tpu/ops/groupby.py``:
fixed-width aggregates; fixed-width and STRING keys).

Two plans:

- bounded: when the planner declares each key column's candidate values,
  grouping needs no sort: dense group ids come from a search in the tiny
  sorted domain, and every aggregate is a per-group reduction in one
  streaming pass — the ``groupby.bounded_accumulate`` kernel on the card
  (ops/kernels/groupby_accumulate.py);
- general (``groupby_aggregate``): stable-sort the rows by their keys,
  mark where the key tuple changes, number the groups with a cumulative
  sum and reduce each contiguous group — plain torch ops, as the
  reference left them to XLA.

Null semantics are Spark's: null keys form their own group; aggregates
skip null values; COUNT counts non-null; an all-null group's SUM, MIN,
MAX and MEAN are null.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from spark_rapids_jni_tpu_torch.columnar import Column, Table
from spark_rapids_jni_tpu_torch.columnar.column import _indexable, take, zeros
from spark_rapids_jni_tpu_torch.ops import kernels
from spark_rapids_jni_tpu_torch.ops.kernels import groupby_accumulate as kga
from spark_rapids_jni_tpu_torch.ops.sort import (
    INT64_MIN,
    gather,
    int64_value,
    order_key,
    sort_order,
)
from spark_rapids_jni_tpu_torch.ops.strings import (
    gather_strings,
    strings_equal_prev,
)
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
        if c.dtype.is_decimal128 or c.dtype.is_string:
            raise NotImplementedError(
                "bounded-domain keys are fixed-width scalars (string keys "
                "are dictionary-encoded by plan_groupby first)")
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
        if dt.is_string and op != "count":
            raise NotImplementedError(
                f"bounded {op} of a STRING column is not ported yet "
                f"(ROADMAP.md Queue 1 entry 3)")
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


# ---- the general sort-based groupby ---------------------------------------

# the reference's aggregate names; only _PORTED_AGGS run here so far
SUPPORTED_AGGS = ("sum", "count", "min", "max", "mean", "var", "std",
                  "var_pop", "std_pop", "nunique", "first", "last",
                  "first_include_nulls", "last_include_nulls")
SUPPORTED_BINARY_AGGS = ("covar_samp", "covar_pop", "corr")
_PORTED_AGGS = ("sum", "count", "mean", "min", "max")
_WIDE_UNSIGNED = (torch.uint16, torch.uint32, torch.uint64)


class GroupByResult(NamedTuple):
    """Keys then aggregates, padded to ``max_groups`` rows."""

    table: Table
    num_groups: torch.Tensor  # 0-d int64
    # True when num_groups exceeded max_groups: the excess groups were
    # dropped and the caller grows the bound and retries
    overflowed: torch.Tensor | bool = False
    # the DECIMAL128 sum overflow flag; no DECIMAL128 sum is ported, so
    # the port never sets it
    sum_overflow: torch.Tensor | bool = False

    def compact(self) -> Table:
        """Host-side trim to the real group count."""
        if bool(self.overflowed):
            raise ValueError(
                "groupby output overflowed max_groups (groups were "
                "dropped); grow and retry before compacting")
        from spark_rapids_jni_tpu_torch.ops.table_ops import trim_table

        return trim_table(self.table, int(self.num_groups))


def _col_values_equal_prev(c: Column) -> torch.Tensor:
    """bool[n-1]: row i+1's value equals row i's (validity ignored; NaNs
    compare equal, the grouping convention)."""
    if c.dtype.is_string:
        return strings_equal_prev(c)
    if c.dtype.is_decimal128:
        return (c.data[1:] == c.data[:-1]).all(dim=-1)
    d = _indexable(c.data)
    eq = d[1:] == d[:-1]
    if d.is_floating_point():
        eq = eq | (torch.isnan(d[1:]) & torch.isnan(d[:-1]))
    return eq


def _rows_equal_prev(table: Table, keys: Sequence[int]) -> torch.Tensor:
    """bool[n]: row i has the same key tuple (null-ness included) as row
    i-1; row 0 never does."""
    n = table.num_rows
    device = table.columns[0].device if table.columns else None
    same = torch.ones((n,), dtype=torch.bool, device=device)
    if n == 0:
        return same
    for k in keys:
        c = table.column(k)
        valid = c.valid_mask()
        eq_valid = valid[1:] == valid[:-1]
        both_null = ~valid[1:] & ~valid[:-1]
        same[1:] &= (_col_values_equal_prev(c) & valid[1:] & eq_valid) \
            | both_null
    same[0] = False
    return same


def _dense_group_bounds(group_id: Optional[torch.Tensor], n: int, m: int,
                        device) -> tuple:
    """(num_groups, g_lo, g_hi) from sorted dense group ids: group g is
    rows [g_lo[g], g_hi[g]) (empty for absent groups). ``group_id`` is
    None only when n == 0."""
    zero = torch.zeros((m,), dtype=torch.int64, device=device)
    if group_id is None or n == 0:
        return torch.zeros((), dtype=torch.int64, device=device), zero, zero
    garange = torch.arange(m, dtype=torch.int64, device=device)
    return (group_id[-1] + 1,
            torch.searchsorted(group_id, garange),
            torch.searchsorted(group_id, garange, right=True))


def _gather_group_keys(sorted_tbl: Table, keys: Sequence[int],
                       first_idx: torch.Tensor, m: int,
                       n: int) -> list[Column]:
    """One output row per group: each key column at its group's first
    sorted row (absent groups have first_idx == n and a null key). String
    keys come back padded."""
    out: list[Column] = []
    for k in keys:
        c = sorted_tbl.column(k)
        if n == 0 and c.dtype.is_string:
            out.append(Column(
                c.dtype, torch.zeros((m,), dtype=torch.int32, device=c.device),
                torch.zeros((m,), dtype=torch.bool, device=c.device),
                chars=torch.zeros((m, 1), dtype=torch.uint8, device=c.device)))
            continue
        if n == 0:
            out.append(Column(
                c.dtype, zeros((m, *c.data.shape[1:]), c.data.dtype, c.device),
                torch.zeros((m,), dtype=torch.bool, device=c.device)))
            continue
        safe = first_idx.clamp(0, n - 1)
        valid = c.valid_mask()[safe] & (first_idx < n)
        if c.dtype.is_string:
            g = gather_strings(c, safe)
            out.append(Column(c.dtype, g.data, valid, chars=g.chars))
        else:
            out.append(Column(c.dtype, take(c.data, safe), valid))
    return out


def _range_sums_from_cumsum(cs: torch.Tensor, lo: torch.Tensor,
                            hi: torch.Tensor) -> torch.Tensor:
    """Per-range sums over rows [lo, hi) from an inclusive cumsum; empty
    ranges give 0. Exact for int64 (wrapping) lanes."""
    n = cs.shape[0]
    upper = cs[(hi - 1).clamp(0, n - 1)]
    lower = torch.where(lo > 0, cs[(lo - 1).clamp(0, n - 1)], 0)
    return torch.where(hi > lo, upper - lower, 0)


def _segmented_extremum(vv: torch.Tensor, first_row: torch.Tensor,
                        op: str) -> torch.Tensor:
    """Inclusive running min/max within each group along sorted rows
    (``first_row[i]`` is the first row of row i's group): a log-depth
    doubling scan. NaN propagates, as in the reference's scan."""
    pick = torch.minimum if op == "min" else torch.maximum
    n = vv.shape[0]
    idx = torch.arange(n, dtype=torch.int64, device=vv.device)
    run, step = vv, 1
    while step < n:
        nxt = run.clone()
        ok = idx[step:] - step >= first_row[step:]
        nxt[step:] = torch.where(ok, pick(run[step:], run[:-step]),
                                 run[step:])
        run, step = nxt, step * 2
    return run


def _minmax_column(c: Column, op: str, first_row: torch.Tensor,
                   g_hi: torch.Tensor, vcount: torch.Tensor, m: int,
                   n: int) -> Column:
    """MIN/MAX of a fixed-width column per group, null-neutral."""
    if n == 0:
        return Column(c.dtype, zeros((m,), c.data.dtype, c.device),
                      vcount > 0)
    wide = c.data.dtype in _WIDE_UNSIGNED
    key = order_key(c.data) if wide else c.data
    sentinel = minmax_sentinel(c.dtype, op)
    if c.data.dtype == torch.uint64:
        sentinel = (1 << 63) - 1 if op == "min" else INT64_MIN
    vv = torch.where(c.valid_mask(), key, sentinel)
    red = _segmented_extremum(vv, first_row, op)[(g_hi - 1).clamp(0, n - 1)]
    if c.data.dtype == torch.uint64:
        red = (red ^ INT64_MIN).view(torch.uint64)
    elif wide:
        signed = {torch.uint16: torch.int16, torch.uint32: torch.int32}
        red = red.to(signed[c.data.dtype]).view(c.data.dtype)
    return Column(c.dtype, red, vcount > 0)


def _check_aggs(table: Table, aggs) -> None:
    for col_idx, op in aggs:
        if isinstance(op, tuple):
            if len(op) != 2 or op[0] not in SUPPORTED_BINARY_AGGS:
                raise ValueError(f"unsupported binary aggregation {op!r}")
            raise NotImplementedError(
                f"{op[0]} is not ported yet (ROADMAP.md Queue 1 item 6)")
        if op not in SUPPORTED_AGGS:
            raise ValueError(f"unsupported aggregation {op!r}")
        if op not in _PORTED_AGGS:
            raise NotImplementedError(
                f"{op} is not ported yet (ROADMAP.md Queue 1 item 6)")
        if table.column(col_idx).dtype.is_decimal128 and op != "count":
            raise NotImplementedError(
                f"DECIMAL128 {op} is not ported yet (limb-pair arithmetic, "
                f"ROADMAP.md Queue 1 item 6)")
        if table.column(col_idx).dtype.is_string and op != "count":
            raise NotImplementedError(
                f"{op} of a STRING column is not ported yet (ROADMAP.md "
                f"Queue 1 entry 3)")


def groupby_aggregate(
    table: Table,
    keys: Sequence[int],
    aggs: Sequence[tuple[int, str]],
    max_groups: Optional[int] = None,
    row_valid: Optional[torch.Tensor] = None,
) -> GroupByResult:
    """Group by ``keys``; compute ``[(value_col, op)]`` aggregates (sum,
    count, mean, min, max over fixed-width columns).

    Returns the keys and one column per aggregate, in order, padded to
    ``max_groups`` rows (default: n, which never overflows), with groups
    in key order (ascending, nulls first). If the true group count
    exceeds ``max_groups``, the excess groups are dropped and
    ``overflowed`` is set. Rows where ``row_valid`` is False are phantom
    rows: they join no group and no aggregate.

    Integral and decimal sums are exact int64 segment sums (wrapping);
    float sums are taken in float64 in an unspecified order."""
    _check_aggs(table, aggs)
    n = table.num_rows
    m = n if max_groups is None else int(max_groups)
    device = table.columns[0].device if table.columns else None

    order = sort_order(table, keys, row_valid=row_valid)
    srt = gather(table, order)
    same = _rows_equal_prev(srt, keys)
    if row_valid is not None:
        # phantoms sort last and merge into the last real group, where
        # their null cells are neutral for every aggregate
        same = same | ~row_valid[order]
    starts = ~same
    gid = torch.cumsum(starts.to(torch.int64), 0) - 1 if n else None
    num_groups, g_lo, g_hi = _dense_group_bounds(gid, n, m, device)
    overflowed = num_groups > m
    first_idx = torch.where(g_hi > g_lo, g_lo, n)
    out_cols = _gather_group_keys(srt, keys, first_idx, m, n)
    garange = torch.arange(m, dtype=torch.int64, device=device)

    def seg_sum(values: torch.Tensor) -> torch.Tensor:
        """[m] per-group sums of one lane (each lane scanned on its own:
        a cumsum along the rows of an (n, k) stack runs k threads on the
        card). int64 lanes are prefix differences, exact; float64 lanes
        add group by group in an unspecified order."""
        if n == 0:
            return torch.zeros((m,), dtype=values.dtype, device=device)
        if values.is_floating_point():
            out = torch.zeros((m + 1,), dtype=values.dtype, device=device)
            return out.index_add_(0, gid.clamp(max=m), values)[:m]
        return _range_sums_from_cumsum(torch.cumsum(values, 0), g_lo, g_hi)

    # sibling aggregates on one column share their segment sums
    sums: dict = {}

    def seg(key, make) -> torch.Tensor:
        if key not in sums:
            sums[key] = seg_sum(make())
        return sums[key]

    first_row = None  # the first sorted row of each row's group
    if n and any(op in ("min", "max") for _, op in aggs):
        idx = torch.arange(n, dtype=torch.int64, device=device)
        first_row = torch.cummax(torch.where(starts, idx, 0), 0).values

    for col_idx, op in aggs:
        c = srt.column(col_idx)
        valid = c.valid_mask()
        vcount = seg((col_idx, "count"), lambda: valid.to(torch.int64))
        if op == "count":
            out_cols.append(Column(DType(TypeId.INT64), vcount,
                                   garange < num_groups))
        elif op in ("sum", "mean"):
            if c.data.is_floating_point():
                total = seg((col_idx, "sum"), lambda: torch.where(
                    valid, c.data.to(torch.float64), 0.0))
            else:
                total = seg((col_idx, "sum"), lambda: torch.where(
                    valid, int64_value(c.data), 0))
            if op == "sum":
                acc_dt = _sum_dtype(c.dtype)
                out_cols.append(Column(acc_dt, total.to(acc_dt.torch_dtype),
                                       vcount > 0))
            else:
                mean = total.to(torch.float64) \
                    / vcount.clamp(min=1).to(torch.float64)
                if c.dtype.is_decimal:
                    mean = mean * (10.0 ** c.dtype.scale)
                out_cols.append(Column(DType(TypeId.FLOAT64), mean,
                                       vcount > 0))
        else:
            out_cols.append(_minmax_column(c, op, first_row, g_hi, vcount,
                                           m, n))
    return GroupByResult(Table(out_cols), num_groups, overflowed, False)
