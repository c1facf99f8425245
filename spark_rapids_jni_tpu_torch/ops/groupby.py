"""Groupby-aggregate (counterpart of ``spark_rapids_jni_tpu/ops/groupby.py``):
every aggregate of the reference over fixed-width, DECIMAL128 and STRING
columns, keyed by any of them.

Two plans:

- bounded: when the planner declares each key column's candidate values,
  grouping needs no sort: dense group ids come from a search in the tiny
  sorted domain, and every aggregate is a per-group reduction in one
  streaming pass — the ``groupby.bounded_accumulate`` kernel on the card
  (ops/kernels/groupby_accumulate.py), integer, uint64 and float lanes;
- general (``groupby_aggregate``): stable-sort the rows by their keys,
  mark where the key tuple changes, number the groups with a cumulative
  sum and reduce each contiguous group — plain torch ops, as the
  reference left them to XLA. Each lane (a column's values, its validity,
  a 32- or 16-bit limb of a DECIMAL128 value) is built, reduced to its m
  group sums and freed on its own: the reference's (n, k) stack of lanes
  would hold 64 int64 lanes of n rows for a DECIMAL128 ``corr``.

Null semantics are Spark's: null keys form their own group; aggregates
skip null values; COUNT counts non-null; an all-null group's SUM, MIN,
MAX and MEAN are null.
"""

from __future__ import annotations

import numbers
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from spark_rapids_jni_tpu_torch.columnar import Column, Table
from spark_rapids_jni_tpu_torch.columnar.column import _indexable, take, zeros
from spark_rapids_jni_tpu_torch.ops import kernels
from spark_rapids_jni_tpu_torch.ops._decimal128 import (  # noqa: F401
    _carry_norm16,
    _conv_limbs16,
    _i128_mag_limbs16,
    _limbs16_to_f64,
    _mean128_exact,
    _negate_limbs16_if,
    _signed_sub_limbs16,
    _sub_limbs16,
    conv_norm16_stream,
    recombine_sum128,
    split_sum128_lanes,
    sum128_lane,
    var128_numerator,
)
from spark_rapids_jni_tpu_torch.ops.kernels import groupby_accumulate as kga
from spark_rapids_jni_tpu_torch.ops.kernels import segment_sum as kss
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
from spark_rapids_jni_tpu_torch.types import DType, TypeId, decimal128


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
    precision), floats stay floating. DECIMAL128 sums take the exact limb
    path of the general groupby; the bounded plan refuses them, as the
    reference's does."""
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
    """An integer key column in a dtype torch can compare and search:
    uint16/uint32 widened, uint64 as its order image (``order_key``)."""
    if x.dtype in _WIDEN or x.dtype == torch.uint64:
        return order_key(x)
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
    the column's storage and validity as they are. A column the bounded
    plan cannot aggregate raises the reference's error: a STRING or
    DECIMAL128 min/max ``TypeError`` (not fixed-width), a DECIMAL128 sum
    or mean ``NotImplementedError``."""
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
            _sum_dtype(c.dtype)
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
        dom_vals = sorted(int(v) for v in dom)
        if c.data.dtype == torch.uint64:
            dom_vals = [v - (1 << 63) for v in dom_vals]  # order image
        dom_arr = torch.tensor(dom_vals, dtype=data.dtype, device=device)
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
    min, max, over integer, uint64 and float columns. Rows whose key value
    is outside its domain land in no group and raise ``domain_miss``.

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
    lanes = bounded_lanes(table, aggs)
    _, m, slot_codes, order = bounded_group_layout(
        [len(d) for d in key_domains])
    gid, domain_miss = dense_gid(table, keys, key_domains, m, row_valid)
    device = gid.device

    # every (group, lane) partial from ONE accumulate: the kernel for CUDA
    # tensors, its plain version for CPU ones
    reason = kga.unsupported_reason(lanes.lanes, m)
    if reason is not None:
        kernels.fall_back(kga.NAME, reason)
        if gid.is_cuda:
            raise NotImplementedError(
                f"groupby_aggregate_bounded: the {kga.NAME} kernel does not "
                f"take this input ({reason}), and a CUDA input never runs "
                f"the plain version")
        acc = kga.accumulate_plain(gid, lanes.lanes, m)
    else:
        acc = kga.accumulate(gid, lanes.lanes, m)

    present = acc[:, lanes.rows] > 0

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
        vcount = acc[:, lanes.vcount[col_idx]]
        if op == "count":
            out_cols.append(Column(DType(TypeId.INT64), vcount, present))
            continue
        if op in ("sum", "mean"):
            acc_dt = _sum_dtype(c.dtype)
            total = acc[:, lanes.sums[col_idx]]
            if c.data.is_floating_point():
                total = total.view(torch.float64)
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
        # min / max: each cell holds the 64-bit pattern of its value
        red = acc[:, lanes.minmax[(col_idx, op)]]
        if c.data.is_floating_point():
            red = red.view(torch.float64).to(c.data.dtype)
        elif c.data.dtype == torch.uint64:
            red = red.view(torch.uint64)
        else:
            red = red.to(c.data.dtype)
        out_cols.append(Column(c.dtype, red, vcount > 0))

    # static reorder from the shared layout: real-key groups first
    # (lexicographic), null-key groups after
    perm = torch.from_numpy(order).to(device)
    out_cols = [
        Column(c.dtype, take(c.data, perm),
               None if c.validity is None else c.validity[perm])
        for c in out_cols
    ]
    return BoundedGroupByResult(Table(out_cols), present[perm], domain_miss)


# ---- the general sort-based groupby ---------------------------------------

SUPPORTED_AGGS = ("sum", "count", "min", "max", "mean", "var", "std",
                  "var_pop", "std_pop", "nunique", "first", "last",
                  "first_include_nulls", "last_include_nulls")
# two-column aggregates: the agg spec is (col_x, (op, col_y))
SUPPORTED_BINARY_AGGS = ("covar_samp", "covar_pop", "corr")
_WIDE_UNSIGNED = (torch.uint16, torch.uint32, torch.uint64)
_F64 = DType(TypeId.FLOAT64)
_I64 = DType(TypeId.INT64)


class GroupByResult(NamedTuple):
    """Keys then aggregates, padded to ``max_groups`` rows."""

    table: Table
    num_groups: torch.Tensor  # 0-d int64
    # True when num_groups exceeded max_groups: the excess groups were
    # dropped and the caller grows the bound and retries
    overflowed: torch.Tensor | bool = False
    # True when a DECIMAL128 SUM or MEAN exceeded 128 bits in some group:
    # that group's value is null, never a wrapped value
    sum_overflow: torch.Tensor | bool = False

    def compact(self) -> Table:
        """Host-side trim to the real group count."""
        if bool(self.overflowed):
            raise ValueError(
                "groupby output overflowed max_groups (groups were "
                "dropped); grow and retry (groupby_aggregate_auto) before "
                "compacting")
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


def _empty_column(c: Column, m: int, validity: torch.Tensor) -> Column:
    """``m`` zero rows of ``c``'s type (a STRING column padded, width 1)."""
    if c.dtype.is_string:
        return Column(c.dtype, torch.zeros((m,), dtype=torch.int32,
                                           device=c.device), validity,
                      chars=torch.zeros((m, 1), dtype=torch.uint8,
                                        device=c.device))
    return Column(c.dtype, zeros((m, *c.data.shape[1:]), c.data.dtype,
                                 c.device), validity)


def _take_column(c: Column, rows: torch.Tensor, validity) -> Column:
    """Column ``c`` at ``rows`` (in range) with the given validity."""
    if c.dtype.is_string:
        g = gather_strings(c, rows)
        return Column(c.dtype, g.data, validity, chars=g.chars)
    return Column(c.dtype, take(c.data, rows), validity)


def _gather_group_keys(sorted_tbl: Table, keys: Sequence[int],
                       first_idx: torch.Tensor, m: int,
                       n: int) -> list[Column]:
    """One output row per group: each key column at its group's first
    sorted row (absent groups have first_idx == n and a null key). String
    keys come back padded."""
    out: list[Column] = []
    for k in keys:
        c = sorted_tbl.column(k)
        if n == 0:
            out.append(_empty_column(
                c, m, torch.zeros((m,), dtype=torch.bool, device=c.device)))
            continue
        safe = first_idx.clamp(0, n - 1)
        out.append(_take_column(c, safe, c.valid_mask()[safe] & (first_idx < n)))
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


def _assoc_scan(combine, elems: list) -> list:
    """``jax.lax.associative_scan`` along dim 0 with its pairing: combine
    adjacent pairs, scan the half recursively, then fill the even
    positions, ~2·log2(n) passes. Each element of the result is the same
    tree of ``combine`` calls as the reference's, so float adds round
    alike (each add is one IEEE operation on either device)."""
    n = elems[0].shape[0]
    if n < 2:
        return elems
    odd = _assoc_scan(combine, combine([e[0:-1:2] for e in elems],
                                       [e[1::2] for e in elems]))
    tail = [e[2::2] for e in elems]
    even = combine([o[:-1] for o in odd] if n % 2 == 0 else odd, tail)
    out = []
    for e, ev, od in zip(elems, even, odd):
        r = torch.empty_like(e)
        r[0] = e[0]
        r[2::2] = ev
        r[1::2] = od
        out.append(r)
    return out


def _segmented_sum_scan(stack: torch.Tensor,
                        seg_start: torch.Tensor) -> torch.Tensor:
    """Inclusive running sum of each lane of ``stack`` (n, k) within the
    segments that start where ``seg_start`` is True. Integer lanes are a
    cumsum less its value before the segment's first row: exact, wrapping
    included. Float lanes never difference global prefixes (small
    segments after large ones would cancel away): they take the
    reference's segmented-sum scan, (value, flag) pairs combined as
    ``where(flag_b, v_b, v_a + v_b)`` in ``associative_scan``'s order, so
    each sum is bit-identical to the reference's."""
    n = stack.shape[0]
    if n == 0:
        return stack
    if not stack.is_floating_point():
        first = _starts(seg_start)
        cs = torch.cumsum(stack, 0)
        return cs - (cs[first] - stack[first])

    def combine(a, b):
        (av, af), (bv, bf) = a, b
        return [torch.where(bf[:, None], bv, av + bv), af | bf]

    return _assoc_scan(combine, [stack, seg_start])[0]


def _starts(seg_start: torch.Tensor) -> torch.Tensor:
    """Each row's segment start (int64): a binary search of the
    non-decreasing segment ids, as ``_Groups.first_row``."""
    sid = torch.cumsum(seg_start.to(torch.int64), 0)
    return torch.searchsorted(sid, sid)


def _to_f64(x: torch.Tensor) -> torch.Tensor:
    """Values as float64, uint64 by its unsigned value (two exact 32-bit
    halves, one rounding)."""
    if x.dtype == torch.uint64:
        bits = x.view(torch.int64)
        return ((bits >> 32) & 0xFFFFFFFF).to(torch.float64) * 2.0 ** 32 \
            + (bits & 0xFFFFFFFF).to(torch.float64)
    return x.to(torch.float64)


def _as_i128(c: Column, mask: torch.Tensor):
    """A DECIMAL128 or integer column as a masked (lo, hi) int64 pair:
    unsigned storage zero-extends, signed sign-extends."""
    if c.dtype.is_decimal128:
        return (torch.where(mask, c.data[:, 0], 0),
                torch.where(mask, c.data[:, 1], 0))
    v = torch.where(mask, int64_value(c.data), 0)
    if c.dtype.storage_dtype.kind == "u":
        return v, torch.zeros_like(v)
    return v, v >> 63


def _gather_used(table: Table, order: torch.Tensor, used) -> Table:
    """The table with the columns in ``used`` gathered by ``order``; the
    others, which nothing reads, stay as they are."""
    idx = sorted(used)
    got = dict(zip(idx, gather(Table([table.column(i) for i in idx]),
                               order).columns))
    return Table([got.get(i, c) for i, c in enumerate(table.columns)])


class _Groups:
    """The sorted rows' groups and the memo of per-group lane sums: each
    lane is built by its ``make`` only when first asked for, reduced to
    [m] and dropped."""

    def __init__(self, same: torch.Tensor, n: int, m: int, device):
        self.n, self.m, self.device = n, m, device
        self.gid = torch.cumsum((~same).to(torch.int64), 0) - 1 if n else None
        self.num_groups, self.g_lo, self.g_hi = _dense_group_bounds(
            self.gid, n, m, device)
        self.garange = torch.arange(m, dtype=torch.int64, device=device)
        self._sums: dict = {}
        self._first_row = None

    def seg_sum(self, values: torch.Tensor) -> torch.Tensor:
        """[m] per-group sums of one lane. int64 lanes are prefix
        differences, exact; float64 lanes go to the segment-sum kernel on
        the card (an order fixed by the group bounds, the same bits run to
        run) and to its plain ``index_add_`` on the CPU."""
        if self.n == 0:
            return torch.zeros((self.m,), dtype=values.dtype,
                               device=self.device)
        if values.is_floating_point():
            return kss.segment_sum(values, self.gid, self.g_lo, self.g_hi)
        return _range_sums_from_cumsum(torch.cumsum(values, 0), self.g_lo,
                                       self.g_hi)

    def sum(self, key, make) -> torch.Tensor:
        if key not in self._sums:
            self._sums[key] = self.seg_sum(make())
        return self._sums[key]

    def per_row(self, vals: torch.Tensor) -> torch.Tensor:
        """An [m] per-group value at each sorted row (rows of groups past
        m read group m - 1's, as the reference's clamped gather does)."""
        if self.m == 0:
            return torch.zeros((self.n,), dtype=vals.dtype, device=self.device)
        return vals[self.gid.clamp(max=self.m - 1)]

    @property
    def first_row(self) -> torch.Tensor:
        """The first sorted row of each row's group: a binary search of
        the non-decreasing group ids (``torch.cummax`` of 60M int64 took
        ~180 ms on the card, ~50x a search)."""
        if self._first_row is None:
            self._first_row = torch.searchsorted(self.gid, self.gid)
        return self._first_row

    def group_reduce(self, v: torch.Tensor, op: str, init: int) -> torch.Tensor:
        """[m] per-group ``amin``/``amax`` of int64 ``v`` (exact in any
        order), ``init`` for a group with no row; rows of groups past m
        reduce into a dropped slot."""
        out = torch.full((self.m + 1,), init, dtype=v.dtype,
                         device=self.device)
        out.scatter_reduce_(0, self.gid.clamp(max=self.m), v, reduce=op,
                            include_self=True)
        return out[:self.m]

    @property
    def last_row(self) -> torch.Tensor:
        """Each group's last sorted row (absent groups: row n - 1)."""
        return (self.g_hi - 1).clamp(0, max(self.n - 1, 0))


def _minmax_column(c: Column, op: str, G: _Groups, vcount) -> Column:
    """MIN/MAX of a fixed-width column per group, null-neutral."""
    n, m = G.n, G.m
    if n == 0:
        return Column(c.dtype, zeros((m,), c.data.dtype, c.device),
                      vcount > 0)
    wide = c.data.dtype in _WIDE_UNSIGNED
    key = order_key(c.data) if wide else c.data
    sentinel = minmax_sentinel(c.dtype, op)
    if c.data.dtype == torch.uint64:
        sentinel = (1 << 63) - 1 if op == "min" else INT64_MIN
    vv = torch.where(c.valid_mask(), key, sentinel)
    red = _segmented_extremum(vv, G.first_row, op)[G.last_row]
    if red.is_floating_point():
        # torch's minimum/maximum return a NaN of their own bits; XLA's,
        # the canonical quiet NaN
        red = torch.where(torch.isnan(red), float("nan"), red)
    if c.data.dtype == torch.uint64:
        red = (red ^ INT64_MIN).view(torch.uint64)
    elif wide:
        signed = {torch.uint16: torch.int16, torch.uint32: torch.int32}
        red = red.to(signed[c.data.dtype]).view(c.data.dtype)
    return Column(c.dtype, red, vcount > 0)


def _rank_minmax(c: Column, op: str, G: _Groups, vcount, cache: dict) -> Column:
    """MIN/MAX of a column with no elementwise-reducible storage (STRING,
    DECIMAL128 limb pairs): rank rows by value order (one nulls-last sort
    of the value column, shared by the column's min and max), reduce the
    int ranks per group, gather the winning row."""
    n = G.n
    if n == 0:
        return _empty_column(c, G.m, vcount > 0)
    if id(c) not in cache:
        order_c = sort_order(Table([c]), [0], nulls_first=[False])
        rank = torch.empty_like(order_c)
        rank[order_c] = torch.arange(n, dtype=torch.int64, device=c.device)
        cache[id(c)] = (order_c, rank)
    order_v, rank = cache[id(c)]
    valid = c.valid_mask()
    # null values never win: the worst rank for the op (n for min, -1 for
    # max), which an all-null group keeps
    worst = n if op == "min" else -1
    best = G.group_reduce(torch.where(valid, rank, worst), f"a{op}", worst)
    winner_row = order_v[best.clamp(0, n - 1)]
    return _take_column(c, winner_row, vcount > 0)


def _first_last_column(c: Column, op: str, G: _Groups) -> Column:
    """first/last (skipping nulls, Spark's ignoreNulls=true) and their
    *_include_nulls variants (the group's first / last row). Rows are
    key-sorted stably, so order within a group is input order."""
    n, m = G.n, G.m
    if n == 0:
        return _empty_column(c, m, torch.zeros((m,), dtype=torch.bool,
                                               device=c.device))
    valid = c.valid_mask()
    live = G.g_hi > G.g_lo
    if op.endswith("_include_nulls"):
        win = torch.where(live, G.g_lo if op.startswith("first")
                          else G.g_hi - 1, -1)
        row = win.clamp(0, n - 1)
        return _take_column(c, row, (win >= 0) & valid[row])
    # the group's first (last) valid row, -1 when none
    idx = torch.arange(n, dtype=torch.int64, device=c.device)
    if op == "first":
        win = G.group_reduce(torch.where(valid, idx, n), "amin", n)
        win = torch.where(win == n, -1, win)
    else:
        win = G.group_reduce(torch.where(valid, idx, -1), "amax", -1)
    row = win.clamp(0, n - 1)
    return _take_column(c, row, (win >= 0) & live)


def _check_aggs(table: Table, aggs) -> None:
    for _, op in aggs:
        if isinstance(op, tuple):
            if (len(op) != 2 or op[0] not in SUPPORTED_BINARY_AGGS
                    or not isinstance(op[1], numbers.Integral)
                    or not 0 <= op[1] < table.num_columns):
                raise ValueError(
                    f"unsupported binary aggregation {op!r}; expected "
                    f"(op, col_y) with op in {SUPPORTED_BINARY_AGGS} and "
                    f"col_y a column index of the input table")
        elif op not in SUPPORTED_AGGS:
            raise ValueError(f"unsupported aggregation {op!r}")


class _Aggregator:
    """The aggregates of one general groupby over its sorted rows; the
    reference's plan and consume loops, one aggregate at a time."""

    def __init__(self, table, srt, keys, row_valid, G: _Groups):
        self.table, self.srt, self.keys = table, srt, keys
        self.row_valid, self.G = row_valid, G
        self.rank_cache: dict = {}
        self.var_cache: dict = {}
        self.covar_cache: dict = {}
        self.sum_overflow = torch.zeros((), dtype=torch.bool,
                                        device=G.device)

    def vcount(self, col_idx: int) -> torch.Tensor:
        c = self.srt.column(col_idx)
        return self.G.sum((col_idx, "count"),
                          lambda: c.valid_mask().to(torch.int64))

    def sum_lane(self, col_idx: int) -> torch.Tensor:
        """The masked group sum of a column: exact int64 for integral and
        decimal storage (uint64 on its bits), float64 otherwise."""
        c = self.srt.column(col_idx)
        if c.data.is_floating_point():
            return self.G.sum((col_idx, "sum_f"), lambda: torch.where(
                c.valid_mask(), c.data.to(torch.float64), 0.0))
        return self.G.sum((col_idx, "sum_i"), lambda: torch.where(
            c.valid_mask(), int64_value(c.data), 0))

    def column(self, col_idx: int, op) -> Column:
        G = self.G
        c = self.srt.column(col_idx)
        if isinstance(op, tuple):
            return self.binary(col_idx, op[0], op[1])
        if op == "nunique":
            return self.nunique(col_idx)
        if op in ("first", "last", "first_include_nulls",
                  "last_include_nulls"):
            return _first_last_column(c, op, G)
        vcount = self.vcount(col_idx)
        if op == "count":
            return Column(_I64, vcount, G.garange < G.num_groups)
        if op in ("sum", "mean") and c.dtype.is_decimal128:
            return self.sum128(col_idx, op, vcount)
        if op in ("sum", "mean"):
            acc_dt = _sum_dtype(c.dtype)
            # a FLOAT32 column's sum is rounded to float32 before its mean
            total = self.sum_lane(col_idx).to(acc_dt.torch_dtype)
            if op == "sum":
                return Column(acc_dt, total, vcount > 0)
            mean = total.to(torch.float64) \
                / vcount.clamp(min=1).to(torch.float64)
            if c.dtype.is_decimal:
                mean = mean * (10.0 ** c.dtype.scale)
            return Column(_F64, mean, vcount > 0)
        if op in ("var", "std", "var_pop", "std_pop"):
            return self.variance(col_idx, op, vcount)
        # min / max
        if c.dtype.is_string or c.dtype.is_decimal128:
            return _rank_minmax(c, op, G, vcount, self.rank_cache)
        return _minmax_column(c, op, G, vcount)

    def sum128(self, col_idx: int, op: str, vcount) -> Column:
        """Exact DECIMAL128 SUM (four 32-bit limb lanes, carry
        recombination; past 128 bits the group is null and sum_overflow
        set) and MEAN (the exact sum over the count by long division, at
        4 more fractional digits, as Spark's avg(decimal))."""
        G = self.G
        c = self.srt.column(col_idx)
        valid = c.valid_mask()

        def lane(k):
            return sum128_lane(torch.where(valid, c.data[:, 0], 0),
                               torch.where(valid, c.data[:, 1], 0), k)

        s = [G.sum((col_idx, "s128", k), lambda k=k: lane(k))
             for k in range(4)]
        lo, hi, ovf = recombine_sum128(*s)
        ovf_g = ovf & (vcount > 0)
        if op == "mean":
            out, div_ovf = _mean128_exact(lo, hi, vcount)
            ovf_g = ovf_g | (div_ovf & (vcount > 0))
            dt = decimal128(c.dtype.scale - 4)
        else:
            out, dt = torch.stack([lo, hi], dim=-1), c.dtype
        self.sum_overflow = self.sum_overflow | (
            ovf_g & (G.garange < G.num_groups)).any()
        return Column(dt, out, (vcount > 0) & ~ovf_g)

    def _limb_sums(self, key, lo_hi, mask_neg=None):
        """The 8 signed base-2^16 limb-lane sums of Σ±|U| for the masked
        (lo, hi) pair ``lo_hi()``."""
        G = self.G
        if (key, 0) not in G._sums:
            mag, neg = _i128_mag_limbs16(*lo_hi())
            for k in range(8):
                G.sum((key, k), lambda k=k: torch.where(neg, -mag[k], mag[k]))
        return [G._sums[(key, k)] for k in range(8)]

    def _prod_sums(self, key, width, pair):
        """The limb-lane sums of the per-row products |X|·|Y| (normalized
        to ``width`` limbs, signed by ``pair()``'s sign), one lane at a
        time."""
        G = self.G
        if (key, 0) not in G._sums:
            magx, magy, neg = pair()
            for k, limb in enumerate(conv_norm16_stream(magx, magy, width)):
                G._sums[(key, k)] = G.seg_sum(
                    limb if neg is None else torch.where(neg, -limb, limb))
        return [G._sums[(key, k)] for k in range(width)]

    def variance(self, col_idx: int, op: str, vcount) -> Column:
        G = self.G
        c = self.srt.column(col_idx)
        pop = op.endswith("_pop")
        if c.dtype.is_decimal128:
            # exact wide second moments: n·ΣU² − (ΣU)² in limb arithmetic,
            # rounded to float64 once, × 10^(2·scale)
            if col_idx not in self.var_cache:
                valid = c.valid_mask()

                def lo_hi():
                    return (torch.where(valid, c.data[:, 0], 0),
                            torch.where(valid, c.data[:, 1], 0))

                def squares():
                    mag, _ = _i128_mag_limbs16(*lo_hi())
                    return mag, mag, None

                s = self._limb_sums((col_idx, "v128s"), lo_hi)
                q = self._prod_sums((col_idx, "v128q"), 16, squares)
                num = var128_numerator(s, q, vcount)
                self.var_cache[col_idx] = num * (10.0 ** (2 * c.dtype.scale))
            denom = vcount * vcount if pop else vcount * (vcount - 1)
            var = self.var_cache[col_idx] / denom.clamp(min=1).to(torch.float64)
        else:
            # two-pass centered form in float64; M2 shared by all four
            if c.dtype.is_string or \
                    c.dtype.storage_dtype.kind not in ("i", "u", "f"):
                raise TypeError(
                    f"var/std need a numeric column, got {c.dtype}")
            if col_idx not in self.var_cache:
                scale_f = (10.0 ** c.dtype.scale) if c.dtype.is_decimal \
                    else 1.0
                denom = vcount.clamp(min=1).to(torch.float64)
                mean_g = self.sum_lane(col_idx).to(torch.float64) * scale_f \
                    / denom
                if G.n:
                    x = _to_f64(c.data) * scale_f
                    centered = torch.where(c.valid_mask(),
                                           x - G.per_row(mean_g), 0.0)
                    m2 = G.seg_sum(centered * centered)
                else:
                    m2 = torch.zeros((G.m,), dtype=torch.float64,
                                     device=G.device)
                self.var_cache[col_idx] = m2
            var = self.var_cache[col_idx] / (
                vcount - (0 if pop else 1)).clamp(min=1).to(torch.float64)
        out = torch.sqrt(var) if op.startswith("std") else var
        return Column(_F64, out, vcount > (0 if pop else 1))

    def binary(self, col_idx: int, kind: str, oidx: int) -> Column:
        """covar_samp / covar_pop / corr over the rows where both
        operands are non-null (Spark's Covariance/Corr)."""
        G = self.G
        c, cy = self.srt.column(col_idx), self.srt.column(oidx)
        for cc in (c, cy):
            if cc.dtype.is_string or (
                    not cc.dtype.is_decimal128
                    and cc.dtype.storage_dtype.kind not in ("i", "u", "f")):
                raise TypeError(f"{kind} needs numeric columns, got {cc.dtype}")
        pair = (col_idx, oidx)

        def both():
            return c.valid_mask() & cy.valid_mask()

        vcount = G.sum((pair, "count2"), lambda: both().to(torch.int64))
        if c.dtype.is_decimal128 or cy.dtype.is_decimal128:
            for cc in (c, cy):
                if (not cc.dtype.is_decimal128
                        and cc.dtype.storage_dtype.kind not in ("i", "u")):
                    raise TypeError(
                        f"{kind} with a DECIMAL128 operand needs an "
                        f"integral-storage partner, got {cc.dtype}")
            num, var_nums = self._covar128(c, cy, pair, kind == "corr",
                                           vcount, both)
            scale = sum((cc.dtype.scale if cc.dtype.is_decimal else 0)
                        for cc in (c, cy))
            if kind == "corr":
                out = num / torch.sqrt(var_nums[0] * var_nums[1])
                validity = vcount > 0
            elif kind == "covar_pop":
                out = num / (vcount * vcount).clamp(min=1).to(
                    torch.float64) * (10.0 ** scale)
                validity = vcount > 0
            else:
                out = num / (vcount * (vcount - 1)).clamp(min=1).to(
                    torch.float64) * (10.0 ** scale)
                validity = vcount > 1
            return Column(_F64, out, validity)
        if pair not in self.covar_cache:
            # pairwise centered moments Σcx·cy, Σcx², Σcy² (float64
            # two-pass, the var posture), shared by corr and covar
            def lane_sum(cc, tag):
                def make():
                    v = torch.where(both(), cc.data, torch.zeros_like(cc.data))
                    return v.to(torch.float64) if v.is_floating_point() \
                        else int64_value(v)
                return G.sum((pair, tag), make)

            denom = vcount.clamp(min=1).to(torch.float64)
            means = []
            for cc, tag in ((c, "sx"), (cy, "sy")):
                sf = (10.0 ** cc.dtype.scale) if cc.dtype.is_decimal else 1.0
                means.append((lane_sum(cc, tag).to(torch.float64) * sf / denom,
                              sf))
            if G.n:
                bm = both()
                (mean_x, sfx), (mean_y, sfy) = means
                cxv = torch.where(bm, _to_f64(c.data) * sfx
                                  - G.per_row(mean_x), 0.0)
                cyv = torch.where(bm, _to_f64(cy.data) * sfy
                                  - G.per_row(mean_y), 0.0)
                moments = (G.seg_sum(cxv * cyv), G.seg_sum(cxv * cxv),
                           G.seg_sum(cyv * cyv))
            else:
                z = torch.zeros((G.m,), dtype=torch.float64, device=G.device)
                moments = (z, z, z)
            self.covar_cache[pair] = moments
        sxy, sxx, syy = self.covar_cache[pair]
        if kind == "corr":
            # constant series / singleton groups give 0/0 -> NaN (Spark's
            # Corr); only empty groups are null
            return Column(_F64, sxy / torch.sqrt(sxx * syy), vcount > 0)
        if kind == "covar_pop":
            return Column(_F64, sxy / vcount.clamp(min=1).to(torch.float64),
                          vcount > 0)
        return Column(_F64, sxy / (vcount - 1).clamp(min=1).to(torch.float64),
                      vcount > 1)

    def _covar128(self, c, cy, pair, corr: bool, vcount, both):
        """Exact numerator n·ΣXY − ΣX·ΣY (sign-magnitude base-2^16, 25
        limbs) rounded to float64 once, and for corr the two exact
        variance numerators."""
        width = 25
        key = (pair, "128pair")
        if (key, "num") not in self.covar_cache:
            def lo_hi(cc):
                return lambda: _as_i128(cc, both())

            sx, sy = (self._limb_sums((key, tag), lo_hi(cc))
                      for cc, tag in ((c, "cx128"), (cy, "cy128")))
            sxl, cxc = _carry_norm16(sx, 12)
            sx_neg = cxc < 0
            sxl = _negate_limbs16_if(sxl, sx_neg)
            syl, cyc = _carry_norm16(sy, 12)
            sy_neg = cyc < 0
            syl = _negate_limbs16_if(syl, sy_neg)

            def products():
                magx, negx = _i128_mag_limbs16(*_as_i128(c, both()))
                magy, negy = _i128_mag_limbs16(*_as_i128(cy, both()))
                return magx, magy, negx != negy

            sxy = self._prod_sums((key, "cxy128"), 16, products)
            sxyl, cxyc = _carry_norm16(sxy, 20)
            sxy_neg = cxyc < 0
            sxyl = _negate_limbs16_if(sxyl, sxy_neg)
            # A = n·|ΣXY| (sign sxy_neg), B = |ΣX|·|ΣY| (sign xor)
            a_mag, _ = _carry_norm16([l * vcount for l in sxyl], width)
            b_mag, _ = _carry_norm16(_conv_limbs16(sxl, syl), width)
            n_mag, n_neg = _signed_sub_limbs16(a_mag, sxy_neg, b_mag,
                                               sx_neg != sy_neg)
            self.covar_cache[(key, "num")] = torch.where(
                n_neg, -1.0, 1.0) * _limbs16_to_f64(n_mag)
            self.covar_cache[(key, "sums")] = (sxl, syl)
        var_nums = None
        if corr:
            if (key, "varnums") not in self.covar_cache:
                sxl, syl = self.covar_cache[(key, "sums")]
                vn = []
                for cc, sl, tag in ((c, sxl, "cqx128"), (cy, syl, "cqy128")):
                    def squares(cc=cc):
                        mag, _ = _i128_mag_limbs16(*_as_i128(cc, both()))
                        return mag, mag, None

                    q = self._prod_sums((key, tag), 16, squares)
                    ql, _ = _carry_norm16(q, 20)
                    nq, _ = _carry_norm16([x * vcount for x in ql], width)
                    bsq, _ = _carry_norm16(_conv_limbs16(sl, sl), width)
                    vn.append(_limbs16_to_f64(_sub_limbs16(nq, bsq)))
                self.covar_cache[(key, "varnums")] = vn
            var_nums = self.covar_cache[(key, "varnums")]
        return self.covar_cache[(key, "num")], var_nums

    def nunique(self, col_idx: int) -> Column:
        """Distinct non-null values per group: a second sort by (keys,
        value) with value nulls last; count the rows that start a new
        valid value run within their group."""
        G = self.G
        keys = list(self.keys)
        table = self.table
        nf = [True] * len(keys) + [False]
        order2 = sort_order(table, keys + [col_idx], nulls_first=nf,
                            row_valid=self.row_valid)
        sub = gather(Table([table.column(k) for k in keys]
                           + [table.column(col_idx)]), order2)
        same_k = _rows_equal_prev(sub, list(range(len(keys))))
        if self.row_valid is not None:
            # phantom rows merge into the last group here too
            same_k = same_k | ~self.row_valid[order2]
        if G.n:
            vcol = sub.column(len(keys))
            vvalid = vcol.valid_mask()
            prev_same_valid = torch.cat([
                torch.zeros((1,), dtype=torch.bool, device=G.device),
                _col_values_equal_prev(vcol) & vvalid[:-1]])
            flag = vvalid & (~same_k | ~prev_same_valid)
            gid2 = torch.cumsum((~same_k).to(torch.int64), 0) - 1
            lo2 = torch.searchsorted(gid2, G.garange)
            hi2 = torch.searchsorted(gid2, G.garange, right=True)
            cnt = _range_sums_from_cumsum(
                torch.cumsum(flag.to(torch.int64), 0), lo2, hi2)
        else:
            cnt = torch.zeros((G.m,), dtype=torch.int64, device=G.device)
        return Column(_I64, cnt, G.garange < G.num_groups)


def groupby_aggregate(
    table: Table,
    keys: Sequence[int],
    aggs: Sequence[tuple[int, str]],
    max_groups: Optional[int] = None,
    row_valid: Optional[torch.Tensor] = None,
) -> GroupByResult:
    """Group by ``keys``; compute ``[(value_col, op)]`` aggregates: every
    op of ``SUPPORTED_AGGS``, and ``(col_x, (op, col_y))`` for the ops of
    ``SUPPORTED_BINARY_AGGS``.

    Returns the keys and one column per aggregate, in order, padded to
    ``max_groups`` rows (default: n, which never overflows), with groups
    in key order (ascending, nulls first). If the true group count
    exceeds ``max_groups``, the excess groups are dropped and
    ``overflowed`` is set. Rows where ``row_valid`` is False are phantom
    rows: they sort last and merge into the last group, where their null
    cells are neutral.

    Integral and decimal sums are exact int64 segment sums (wrapping);
    DECIMAL128 sums, means and variances are exact limb arithmetic; float
    sums and the float64 two-pass moments add in an unspecified order."""
    _check_aggs(table, aggs)
    n = table.num_rows
    m = n if max_groups is None else int(max_groups)
    device = table.columns[0].device if table.columns else None

    order = sort_order(table, keys, row_valid=row_valid)
    used = set(keys) | {c for c, _ in aggs} | {
        op[1] for _, op in aggs if isinstance(op, tuple)}
    srt = _gather_used(table, order, used)
    same = _rows_equal_prev(srt, keys)
    if row_valid is not None:
        same = same | ~row_valid[order]
    G = _Groups(same, n, m, device)
    first_idx = torch.where(G.g_hi > G.g_lo, G.g_lo, n)
    out_cols = _gather_group_keys(srt, keys, first_idx, m, n)
    agg = _Aggregator(table, srt, keys, row_valid, G)
    for col_idx, op in aggs:
        out_cols.append(agg.column(col_idx, op))
    return GroupByResult(Table(out_cols), G.num_groups, G.num_groups > m,
                         agg.sum_overflow)


def groupby_aggregate_auto(
    table: Table,
    keys: Sequence[int],
    aggs: Sequence[tuple[int, str]],
    initial_max_groups: int,
    growth: int = 4,
) -> GroupByResult:
    """Grow-and-retry around the cardinality bound: start at
    ``initial_max_groups`` and multiply by ``growth`` until the result
    fits (capped at n, which always fits). The growth runs through the
    shared ladder (``resilience.escalate``, rung ``grow_capacity``) with
    the reference's capacity schedule min(initial·growth^k, n); with
    ``resilience.enabled=false`` the plain loop runs."""
    from spark_rapids_jni_tpu_torch.runtime import resilience

    n = table.num_rows
    m = max(1, int(initial_max_groups))
    if not resilience.enabled() or n < 1:
        while True:
            res = groupby_aggregate(table, keys, aggs, max_groups=min(m, n))
            if m >= n or not bool(res.overflowed):
                return res
            m *= growth

    def _attempt(cap):
        res = groupby_aggregate(table, keys, aggs, max_groups=cap)
        # cap == n always fits (distinct groups <= rows)
        return res, cap < n and bool(res.overflowed), None

    return resilience.escalate(
        "groupby_aggregate_auto", _attempt, seam="dispatch.execute",
        initial=m, growth=growth, max_capacity=n, rows=n)


def groupby_percentile(
    table: Table,
    keys: Sequence[int],
    value_col: int,
    qs: Sequence[float],
    max_groups: Optional[int] = None,
) -> GroupByResult:
    """Exact per-group percentiles (Spark ``percentile``: linear
    interpolation between closest ranks over non-null values; the median
    is ``qs=[0.5]``). Output: keys + one FLOAT64 column per q.

    One sort by (keys..., value) with value nulls last, so each group's
    valid values occupy the contiguous run [g_lo, g_lo + cnt); every
    percentile is two gathers at computed offsets."""
    qs = [float(q) for q in qs]
    if not qs or any(q < 0.0 or q > 1.0 for q in qs):
        raise ValueError("percentile fractions must be in [0, 1]")
    c_in = table.column(value_col)
    if c_in.dtype.is_string or c_in.dtype.is_decimal128:
        raise NotImplementedError(
            "groupby_percentile needs fixed-width numeric values")
    n = table.num_rows
    m = n if max_groups is None else int(max_groups)
    device = c_in.device
    order = sort_order(table, list(keys) + [value_col],
                       nulls_first=[True] * len(keys) + [False])
    srt = _gather_used(table, order, set(keys) | {value_col})
    G = _Groups(_rows_equal_prev(srt, keys), n, m, device)
    first_idx = torch.where(G.g_hi > G.g_lo, G.g_lo, n)
    out_cols = _gather_group_keys(srt, keys, first_idx, m, n)

    c = srt.column(value_col)
    cnt = G.seg_sum(c.valid_mask().to(torch.int64))
    vals = _to_f64(c.data)
    if c.dtype.is_decimal:
        vals = vals * (10.0 ** c.dtype.scale)
    for q in qs:
        p = q * (cnt - 1).to(torch.float64)
        lo_off = torch.floor(p).to(torch.int64)
        frac = p - lo_off.to(torch.float64)
        i0 = G.g_lo + lo_off
        i1 = G.g_lo + torch.minimum(lo_off + 1, cnt - 1)
        if n:
            v0 = vals[i0.clamp(0, n - 1)]
            v1 = vals[i1.clamp(0, n - 1)]
            out = v0 * (1.0 - frac) + v1 * frac
        else:
            out = torch.zeros((m,), dtype=torch.float64, device=device)
        out_cols.append(Column(_F64, out, cnt > 0))
    return GroupByResult(Table(out_cols), G.num_groups, G.num_groups > m)
