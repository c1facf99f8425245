"""Table-level operators (counterpart of
``spark_rapids_jni_tpu/ops/table_ops.py``): the host-side trim of a
padded-plus-count result, concatenate, boolean-mask compaction, distinct,
contiguous_split and the set operations EXCEPT and INTERSECT.

Compaction keeps the reference's padded-plus-count contract: kept rows
first in input order, padded to the input size with null rows, and the
real row count beside (``compact()`` trims on the host). The order is a
stable sort on the drop flag, and distinct and the set operations are
one sort of the keys plus a neighbour compare: no hash table, so the
join probe kernel is not on these paths.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from spark_rapids_jni_tpu_torch.columnar import Column, Table
from spark_rapids_jni_tpu_torch.columnar.column import cat
from spark_rapids_jni_tpu_torch.ops.sort import gather, sort_order
from spark_rapids_jni_tpu_torch.ops.strings import pad_to_common_width
from spark_rapids_jni_tpu_torch.types import DType, TypeId


def _slice_column(c: Column, lo: int, hi: int) -> Column:
    """Rows [lo, hi) of one column, every layout: fixed-width, limb pair,
    padded string, Arrow string, STRUCT (its fields sliced alike) and
    LIST (whose offsets are re-based to the slice's first byte or
    element, one host read of the two bounds)."""
    validity = None if c.validity is None else c.validity[lo:hi]
    if c.is_struct:
        return Column(c.dtype, c.data[lo:hi], validity, children=[
            _slice_column(f, lo, hi) for f in c.children])
    if c.dtype.is_list or (c.dtype.is_string and not c.is_padded_string):
        base_lo, base_hi = (int(v) for v in c.data[[lo, hi]].tolist())
        offsets = c.data[lo:hi + 1] - base_lo
        if c.dtype.is_list:
            return Column(c.dtype, offsets, validity, children=[
                _slice_column(c.children[0], base_lo, base_hi)])
        return Column(c.dtype, offsets, validity,
                      chars=c.chars[base_lo:base_hi])
    return Column(c.dtype, c.data[lo:hi], validity,
                  None if c.chars is None else c.chars[lo:hi])


def _slice_rows(table: Table, lo: int, hi: int) -> Table:
    return Table([_slice_column(c, lo, hi) for c in table.columns])


def trim_table(table: Table, k: int) -> Table:
    """The first ``k`` rows of a padded result (views, except an Arrow
    string or LIST column's re-based offsets)."""
    return _slice_rows(table, 0, k)


class CompactResult(NamedTuple):
    table: Table             # kept rows first, padded to the input size
    num_rows: torch.Tensor   # 0-d int64: the real row count

    def compact(self) -> Table:
        """Host-side trim to the real row count."""
        return trim_table(self.table, int(self.num_rows))


def _concat_columns(cols: Sequence[Column]) -> Column:
    dtype = cols[0].dtype
    for c in cols[1:]:
        if c.dtype != dtype:
            raise TypeError(
                f"concatenate: column dtypes differ ({c.dtype} vs {dtype})")
    if all(c.validity is None for c in cols):
        validity = None  # keep the no-null-mask form
    else:
        validity = torch.cat([c.valid_mask() for c in cols])
    if cols[0].is_struct:
        return Column(dtype, torch.cat([c.data for c in cols]), validity,
                      children=[_concat_columns([c.children[i] for c in cols])
                                for i in range(len(cols[0].children))])
    if dtype.is_list:
        # host-level: trim each child to its live element range, shift
        # the offsets by the running child total, concat the children
        offs, kids, base = [], [], 0
        for c in cols:
            live = int(c.data[-1]) if c.size else 0
            offs.append(c.data[:-1].to(torch.int64) + base)
            kids.append(_slice_column(c.children[0], 0, live))
            base += live
        if base > np.iinfo(np.int32).max:
            raise ValueError(
                f"concatenated LIST child holds {base} elements, over the "
                "int32 Arrow offset bound (2^31-1); concatenate in batches")
        offs.append(torch.tensor([base], dtype=torch.int64,
                                 device=cols[0].device))
        return Column(dtype, torch.cat(offs).to(torch.int32), validity,
                      children=[_concat_columns(kids)])
    if dtype.is_string:
        if any(c.is_padded_string for c in cols):
            padded = pad_to_common_width(cols)
            return Column(dtype, torch.cat([p.data for p in padded]),
                          validity,
                          chars=torch.cat([p.chars for p in padded]))
        # Arrow: shift each column's offsets by the bytes written so far
        offs, base = [], 0
        for c in cols:
            offs.append(c.data[:-1] + base)
            if c.size:
                base = base + c.data[-1]
        offs.append(torch.as_tensor(base, dtype=torch.int32,
                                    device=cols[0].device).reshape(1))
        return Column(dtype, torch.cat(offs).to(torch.int32), validity,
                      chars=torch.cat([c.chars for c in cols]))
    return Column(dtype, cat([c.data for c in cols]), validity)


def concatenate(tables: Sequence[Table]) -> Table:
    """Row-wise concatenation (cuDF ``concatenate``): schemas must match;
    string columns concatenate in either layout (Arrow offsets re-based
    on the device; padded layouts widened to the widest), LIST columns
    with their children trimmed to the live elements, STRUCT columns
    field by field."""
    tables = list(tables)
    if not tables:
        raise ValueError("concatenate needs at least one table")
    ncols = tables[0].num_columns
    for tb in tables[1:]:
        if tb.num_columns != ncols:
            raise TypeError("concatenate: column counts differ")
    return Table([_concat_columns([tb.column(i) for tb in tables])
                  for i in range(ncols)])


def _gather_mask_tail(table: Table, order: torch.Tensor,
                      num: torch.Tensor) -> Table:
    """One gather by ``order`` with rows past ``num`` forced null
    (padding must not read as stale duplicates)."""
    out = gather(table, order)
    j = torch.arange(table.num_rows, device=order.device)
    return Table([Column(c.dtype, c.data, c.valid_mask() & (j < num),
                         chars=c.chars) for c in out.columns])


def _stable_front(flag: torch.Tensor) -> torch.Tensor:
    """The stable permutation putting the rows where ``flag`` is True
    first, each side in input order."""
    return torch.argsort((~flag).to(torch.int8), stable=True)


def apply_boolean_mask(table: Table, mask: torch.Tensor) -> CompactResult:
    """Stream compaction (cuDF ``apply_boolean_mask``): keep the rows
    where ``mask`` is True, in input order, padded to the input size with
    ``num_rows`` beside."""
    n = table.num_rows
    if tuple(mask.shape) != (n,):
        raise ValueError(f"mask shape {tuple(mask.shape)} != ({n},)")
    keep = mask.to(torch.bool)
    num = keep.to(torch.int64).sum()
    return CompactResult(_gather_mask_tail(table, _stable_front(keep), num),
                         num)


def distinct(table: Table, keys: Optional[Sequence[int]] = None) -> CompactResult:
    """Distinct key tuples (cuDF ``distinct`` / Spark dropDuplicates): one
    row per distinct tuple over ``keys`` (default: all columns); null
    tuples count as equal. Rows come in key order, padded, with the
    distinct count beside."""
    from spark_rapids_jni_tpu_torch.ops.groupby import _rows_equal_prev

    ks = list(range(table.num_columns)) if keys is None else list(keys)
    order = sort_order(table, ks)
    key_sorted = gather(Table([table.column(k) for k in ks]), order)
    same = _rows_equal_prev(key_sorted, list(range(len(ks))))
    num = (~same).to(torch.int64).sum()
    return CompactResult(
        _gather_mask_tail(table, order[_stable_front(~same)], num), num)


def contiguous_split(table: Table, splits: Sequence[int]) -> list[Table]:
    """Split rows at the given indices (cuDF ``contiguous_split``):
    ``splits=[a, b]`` gives the tables of rows [0,a), [a,b), [b,n), each
    of slices of the parent's buffers."""
    n = table.num_rows
    bounds = [0] + [int(x) for x in splits] + [n]
    for lo, hi in zip(bounds, bounds[1:]):
        if lo > hi or lo < 0 or hi > n:
            raise ValueError(f"bad split bounds {splits} for {n} rows")
    return [_slice_rows(table, lo, hi) for lo, hi in zip(bounds, bounds[1:])]


def _set_op(left: Table, right: Table, keep_matched: bool) -> CompactResult:
    """EXCEPT/INTERSECT: the distinct left tuples, marked and
    concatenated with the right rows, one sort over all columns with the
    side as the last key, and a neighbour compare — each left tuple's
    only same-key follower can be a right row. NULL tuples compare equal
    (set semantics), unlike an equi-join's keys."""
    from spark_rapids_jni_tpu_torch.ops.groupby import _rows_equal_prev

    if left.num_columns != right.num_columns:
        raise ValueError("set ops need matching column counts")
    for i in range(left.num_columns):
        if left.column(i).dtype != right.column(i).dtype:
            raise TypeError(
                f"set ops need matching dtypes at column {i}: "
                f"{left.column(i).dtype} vs {right.column(i).dtype}")
    l0 = distinct(left).compact()

    def with_side(tbl: Table, side: int) -> Table:
        device = tbl.columns[0].device
        flag = Column(DType(TypeId.INT8), torch.full(
            (tbl.num_rows,), side, dtype=torch.int8, device=device))
        return Table(list(tbl.columns) + [flag])

    allt = concatenate([with_side(l0, 0), with_side(right, 1)])
    nk = left.num_columns
    ks = list(range(nk))
    sall = gather(allt, sort_order(allt, ks + [nk]))
    same = _rows_equal_prev(sall, ks)
    next_same = torch.cat([same[1:], torch.zeros(
        (1,), dtype=torch.bool, device=same.device)])
    mask = (sall.column(nk).data == 0) & (next_same == keep_matched)
    num = mask.to(torch.int64).sum()
    return CompactResult(
        _gather_mask_tail(Table([sall.column(i) for i in ks]),
                          _stable_front(mask), num), num)


def except_rows(left: Table, right: Table) -> CompactResult:
    """SQL EXCEPT (DISTINCT): distinct left tuples with no equal tuple in
    right; NULLs compare equal."""
    return _set_op(left, right, keep_matched=False)


def intersect_rows(left: Table, right: Table) -> CompactResult:
    """SQL INTERSECT (DISTINCT): distinct left tuples that also appear in
    right; NULLs compare equal."""
    return _set_op(left, right, keep_matched=True)
