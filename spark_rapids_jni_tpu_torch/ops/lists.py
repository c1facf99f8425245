"""LIST-column operators (counterpart of ``spark_rapids_jni_tpu/ops/lists.py``):
explode/posexplode, collect_list/collect_set, the array functions and
the padded wire layout.

The designs are the reference's, in plain torch ops on the rows' device:

- ``explode``: each output slot finds its parent row with one
  ``searchsorted`` against the per-row start positions, then gathers;
  outer explode adds one slot per empty or null list (start = offsets +
  running empty count), which gives Spark's interleaved row order with
  the output padded to the worst case (``row_valid`` marks live slots);
- ``groupby_collect``: a stable key sort, then one stable sort on the
  keep flag compacts each group's kept values into a dense child in
  input order; offsets are the cumsum of the per-group keep counts.
  ``distinct=True`` sorts by (keys, value) and keeps first occurrences.

Where the port differs on purpose (ROADMAP.md Queue 3):

- ``sequence`` sizes its child to the elements it holds (the reference
  pads it to ``n * max_length``: 61 billion at SF10) and raises when the
  offsets would pass 2^31 - 1 (the reference's int32 cast wraps);
- ``array_sum`` of float elements sums each list on its own with the
  segmented scan; the reference differences global cumsum prefixes
  (whose rounding the card would not reproduce anyway);
- ``array_join`` builds its bytes on the device (the reference joins
  Python strings on the host);
- ``array_min``/``array_max``/``array_position`` read the hit positions
  and the sparse table's level per row without the reference's stacked
  (levels, n) gathers.

Null semantics are Spark's: collect_list/collect_set skip null values
and give empty lists (never null) for groups with no kept value; explode
drops null and empty lists, explode_outer emits one all-null row for
each.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from spark_rapids_jni_tpu_torch.columnar import Column, Table
from spark_rapids_jni_tpu_torch.columnar.column import (
    _SIGNED_VIEW,
    _indexable,
    take,
    zeros,
)
from spark_rapids_jni_tpu_torch.ops.groupby import (
    _col_values_equal_prev,
    _dense_group_bounds,
    _gather_group_keys,
    _rows_equal_prev,
    _segmented_sum_scan,
    _sum_dtype,
)
from spark_rapids_jni_tpu_torch.ops.sort import (
    INT64_MIN,
    gather,
    order_key,
    sort_order,
)
from spark_rapids_jni_tpu_torch.types import BOOL8, INT32, INT64, STRING, DType, TypeId
from spark_rapids_jni_tpu_torch.utils.tracing import func_range

_WIDE_UNSIGNED = (torch.uint16, torch.uint32, torch.uint64)
INT32_MAX = (1 << 31) - 1


def _check_list(col: Column, op: str) -> None:
    if col.dtype.type_id != TypeId.LIST:
        raise TypeError(f"{op} needs a LIST column, got {col.dtype}")


def _prefix(x: torch.Tensor) -> torch.Tensor:
    """Exclusive-then-inclusive prefix sums: [0, x0, x0+x1, ...] (int64)."""
    out = torch.zeros((x.shape[0] + 1,), dtype=torch.int64, device=x.device)
    out[1:] = torch.cumsum(x.to(torch.int64), 0)
    return out


def _row_of(starts: torch.Tensor, k: torch.Tensor, n: int) -> torch.Tensor:
    """The row whose [starts[r], starts[r+1]) holds each position ``k``
    (clipped to [0, n-1])."""
    return (torch.searchsorted(starts, k, right=True) - 1).clamp(
        0, max(n - 1, 0))


def make_list_column(values: Sequence, element_dtype: DType,
                     device=None) -> Column:
    """A LIST column from ``[[...], None, [...]]`` (None = null list) on
    ``device`` (None: the CUDA device)."""
    offsets = np.zeros(len(values) + 1, dtype=np.int32)
    flat: list = []
    valid = np.ones(len(values), dtype=bool)
    for i, v in enumerate(values):
        if v is None:
            valid[i] = False
            offsets[i + 1] = offsets[i]
        else:
            flat.extend(v)
            offsets[i + 1] = offsets[i] + len(v)
    child = Column.from_pylist(flat, element_dtype, device)
    device = child.device
    return Column(DType(TypeId.LIST), torch.from_numpy(offsets).to(device),
                  None if valid.all() else torch.from_numpy(valid).to(device),
                  children=[child])


class ExplodeResult(NamedTuple):
    table: Table              # exploded rows, padded to the static bound
    row_valid: torch.Tensor   # bool[out_n]: live output slots
    num_rows: torch.Tensor    # 0-d int64: the real output row count


def _gather_any(c: Column, idx: torch.Tensor, extra_valid) -> Column:
    """A non-LIST column at ``idx`` with extra invalidation (strings come
    back padded); an empty column gives null rows."""
    if c.size == 0:
        m = idx.shape[0]
        none = torch.zeros((m,), dtype=torch.bool, device=idx.device)
        if c.dtype.is_string:
            return Column(c.dtype, torch.zeros((m,), dtype=torch.int32,
                                               device=idx.device), none,
                          chars=torch.zeros((m, 1), dtype=torch.uint8,
                                            device=idx.device))
        return Column(c.dtype, zeros((m, *c.data.shape[1:]), c.data.dtype,
                                     idx.device), none)
    valid = c.valid_mask()[idx] & extra_valid
    if c.dtype.is_string:
        from spark_rapids_jni_tpu_torch.ops.strings import gather_strings

        g = gather_strings(c, idx)
        return Column(c.dtype, g.data, valid, chars=g.chars)
    return Column(c.dtype, take(c.data, idx), valid)


@func_range("explode")
def explode(table: Table, col_idx: int, *, outer: bool = False,
            position: bool = False) -> ExplodeResult:
    """Explode the LIST column ``col_idx``: one output row per element,
    the other columns repeated, in Spark's interleaved order.

    ``outer=True`` (``explode_outer``) keeps a row whose list is empty or
    null as one row with a null element. ``position=True``
    (``posexplode``) inserts an INT32 0-based position column just before
    the element column. The output is padded to the static worst case
    (child length, + row count when outer); ``row_valid`` marks the live
    slots and ``num_rows`` is the real count."""
    lc = table.column(col_idx)
    _check_list(lc, "explode")
    child = lc.children[0]
    if child.dtype.type_id == TypeId.LIST:
        raise NotImplementedError("explode of nested LIST-of-LIST")
    n = lc.size
    device = lc.device
    offsets = lc.data.to(torch.int64)
    # null lists count as length 0 (they give a row only under outer)
    lens = torch.where(lc.valid_mask(), offsets[1:] - offsets[:-1], 0)
    starts = _prefix(lens)
    if outer:
        starts = starts + _prefix(lens == 0)
    total = starts[-1]
    out_n = child.size + (n if outer else 0)
    k = torch.arange(out_n, dtype=torch.int64, device=device)
    parent = _row_of(starts, k, n)
    lens_p = torch.cat([lens, lens.new_zeros(1)])  # row 0 when n == 0
    j = k - starts[parent]
    live = k < total
    has_elem = live & (j < lens_p[parent])
    eidx = (offsets[parent] + j).clamp(0, max(child.size - 1, 0))
    out_cols: list[Column] = []
    for ci in range(table.num_columns):
        if ci == col_idx:
            if position:
                out_cols.append(Column(INT32, j.to(torch.int32), has_elem))
            out_cols.append(_gather_any(child, eidx, has_elem))
        else:
            c = table.column(ci)
            if c.dtype.type_id in (TypeId.LIST, TypeId.STRUCT):
                raise NotImplementedError(
                    "explode alongside other nested columns")
            out_cols.append(_gather_any(c, parent, live))
    return ExplodeResult(Table(out_cols), live, total)


class CollectResult(NamedTuple):
    table: Table              # keys then ONE LIST column, padded to n rows
    num_groups: torch.Tensor  # 0-d int64


@func_range("groupby_collect")
def groupby_collect(table: Table, keys: Sequence[int], value_col: int,
                    *, distinct: bool = False) -> CollectResult:
    """collect_list (``distinct=False``) / collect_set (``distinct=True``)
    of ``value_col`` grouped by ``keys``.

    The LIST child holds every kept value, groups concatenated in key
    order; offsets are the cumsum of the per-group keep counts. A group
    with no kept value gets an empty list. The output is padded to n
    rows, as groupby_aggregate's; trim with ``num_groups`` (the child is
    padded too: only elements below each list's offsets are read)."""
    if table.column(value_col).dtype.type_id in (TypeId.LIST, TypeId.STRUCT):
        raise NotImplementedError("collect of nested columns")
    n = table.num_rows
    m = n
    device = table.column(value_col).device
    sub = Table([table.column(k) for k in keys] + [table.column(value_col)])
    kix = list(range(len(keys)))
    vix = len(keys)
    if distinct:
        order = sort_order(sub, kix + [vix],
                           nulls_first=[True] * len(keys) + [False])
    else:
        order = sort_order(sub, kix)
    ssub = gather(sub, order)
    same = _rows_equal_prev(ssub, kix)
    gid = torch.cumsum((~same).to(torch.int64), 0) - 1 if n else None
    num_groups, g_lo, g_hi = _dense_group_bounds(gid, n, m, device)
    first_idx = torch.where(g_hi > g_lo, g_lo, n)
    out_cols = _gather_group_keys(ssub, kix, first_idx, m, n)

    vc = ssub.column(vix)
    keep = vc.valid_mask()
    if distinct and n:
        # drop repeats of a value within a group (adjacent after the
        # value sort)
        prev_same_valid = torch.cat([keep.new_zeros(1),
                                     _col_values_equal_prev(vc) & keep[:-1]])
        keep = keep & (~same | ~prev_same_valid)
    if n:
        pref0 = _prefix(keep)
        counts = pref0[g_hi] - pref0[g_lo]
        # kept rows first, stably: their sorted order is group order, so
        # the compacted prefix is the dense child
        comp = torch.argsort((~keep).to(torch.int8), stable=True)
        child = _gather_any(vc, comp, True)
    else:
        counts = torch.zeros((m,), dtype=torch.int64, device=device)
        child = vc
    offsets = _prefix(counts).to(torch.int32)
    garange = torch.arange(m, dtype=torch.int64, device=device)
    out_cols.append(Column(DType(TypeId.LIST), offsets,
                           garange < num_groups, children=[child]))
    return CollectResult(Table(out_cols), num_groups)


@func_range("array_size")
def array_size(col: Column) -> Column:
    """Spark ``size``/``cardinality``: elements per list; a null list
    gives null."""
    _check_list(col, "array_size")
    lens = (col.data[1:] - col.data[:-1]).to(torch.int32)
    return Column(INT32, lens,
                  col.valid_mask() if col.validity is not None else None)


def _eq_scalar(child: Column, value) -> torch.Tensor:
    """bool[child_n]: valid child elements equal to the scalar ``value``."""
    if child.dtype.is_decimal128:
        v = int(value)
        lo = int(np.int64(np.uint64(v & 0xFFFFFFFFFFFFFFFF)))
        eq = (child.data[:, 0] == lo) & (child.data[:, 1] == (v >> 64))
    elif child.dtype.is_string:
        return _scalar_string_hit(child, value)
    elif child.data.dtype in _WIDE_UNSIGNED:
        target = torch.tensor([value], dtype=child.data.dtype)
        eq = order_key(child.data) == int(order_key(target)[0])
    else:
        eq = child.data == value
    return eq & child.valid_mask()


def _scalar_string_hit(child: Column, value) -> torch.Tensor:
    """bool[child_n]: child strings equal to the scalar (padded compare;
    absent when longer than the padded width)."""
    from spark_rapids_jni_tpu_torch.ops import strings as s

    p = s.pad_strings(child)
    vb = str(value).encode()
    w = p.chars.shape[1]
    if len(vb) > w:
        return torch.zeros((child.size,), dtype=torch.bool,
                           device=child.device)
    target = torch.zeros((w,), dtype=torch.uint8, device=child.device)
    target[:len(vb)] = torch.tensor(list(vb), dtype=torch.uint8)
    return ((p.data == len(vb)) & (p.chars == target[None, :]).all(dim=1)
            & p.valid_mask())


def _range_any(flags: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """bool[n]: ANY of ``flags`` within each [offsets[i], offsets[i+1])
    (one cumsum and a prefix difference)."""
    pref = _prefix(flags)
    off = offsets.to(torch.int64)
    return (pref[off[1:]] - pref[off[:-1]]) > 0


@func_range("array_contains")
def array_contains(col: Column, value) -> Column:
    """Spark ``array_contains(list, value)``: TRUE when found; NULL when
    not found but the list has a null element; FALSE otherwise; a null
    list gives null."""
    _check_list(col, "array_contains")
    child = col.children[0]
    found = _range_any(_eq_scalar(child, value), col.data)
    has_null_elem = _range_any(~child.valid_mask(), col.data)
    validity = col.valid_mask() & (found | ~has_null_elem)
    return Column(BOOL8, found.to(torch.uint8), validity)


@func_range("element_at")
def element_at(col: Column, k: int) -> Column:
    """Spark ``element_at(list, k)``: 1-based; a negative k counts from
    the end; out of bounds gives null (non-ANSI)."""
    _check_list(col, "element_at")
    if k == 0:
        raise ValueError("element_at index is 1-based (k != 0)")
    child = col.children[0]
    off = col.data.to(torch.int64)
    lens = off[1:] - off[:-1]
    if k > 0:
        pos, in_b = off[:-1] + (k - 1), k <= lens
    else:
        pos, in_b = off[1:] + k, -k <= lens
    valid = in_b & col.valid_mask()
    return _gather_any(child, pos.clamp(0, max(child.size - 1, 0)), valid)


@func_range("array_join")
def array_join(col: Column, sep: str,
               null_replacement: str | None = None) -> Column:
    """Spark ``array_join``: STRING list elements joined with ``sep``;
    null elements are skipped unless ``null_replacement`` is given. The
    bytes are built on the device: every output byte finds its element
    by one ``searchsorted`` and copies from the separator, the element's
    bytes or the replacement. Arrow-laid result."""
    from spark_rapids_jni_tpu_torch.ops.strings import unpad_strings

    _check_list(col, "array_join")
    child = col.children[0]
    if not child.dtype.is_string:
        raise TypeError("array_join needs LIST<STRING>")
    device = col.device
    n, child_n = col.size, child.size
    arrow = unpad_strings(child) if child.is_padded_string else child
    coff = arrow.data.to(torch.int64)
    sep_b = torch.tensor(list(sep.encode()), dtype=torch.uint8,
                         device=device)
    rep = None if null_replacement is None else null_replacement.encode()
    rep_b = torch.tensor(list(rep or b""), dtype=torch.uint8, device=device)
    parent = _parent_ids(col).to(torch.int64)
    off = col.data.to(torch.int64)
    in_row = (parent < n) & (torch.arange(child_n, device=device) >= off[0])
    row_valid = torch.cat([col.valid_mask(), col.valid_mask().new_zeros(1)])
    evalid = child.valid_mask()
    keep = in_row & row_valid[parent] & (evalid | (rep is not None))
    piece = torch.where(evalid, coff[1:] - coff[:-1], len(rep or b""))
    # kept elements before this one in its row: a separator goes first
    pk = _prefix(keep)
    lo_p = torch.cat([off[:-1], off.new_zeros(1)])[parent]
    sep_len = torch.where(pk[:-1] - pk[lo_p] > 0, sep_b.shape[0], 0)
    out_len = torch.where(keep, sep_len + piece, 0)
    ol = _prefix(out_len)
    row_len = ol[off[1:]] - ol[off[:-1]]
    offsets = _prefix(row_len)
    total = int(offsets[-1])
    if total > INT32_MAX:
        raise ValueError(f"array_join output holds {total} bytes, over "
                         "int32 offsets")
    b = torch.arange(total, dtype=torch.int64, device=device) + ol[off[0]]
    e = torch.searchsorted(ol[1:], b, right=True)
    within = b - ol[e]
    is_sep = within < sep_len[e]
    q = within - sep_len[e]
    from_elem = arrow.chars[(coff[e] + q).clamp(0, max(
        arrow.chars.shape[0] - 1, 0))] if arrow.chars.numel() \
        else torch.zeros_like(b, dtype=torch.uint8)
    from_rep = rep_b[q.clamp(0, max(rep_b.shape[0] - 1, 0))] \
        if rep_b.numel() else torch.zeros_like(b, dtype=torch.uint8)
    from_sep = sep_b[within.clamp(0, max(sep_b.shape[0] - 1, 0))] \
        if sep_b.numel() else torch.zeros_like(b, dtype=torch.uint8)
    chars = torch.where(is_sep, from_sep,
                        torch.where(evalid[e], from_elem, from_rep))
    valid = col.valid_mask()
    return Column(STRING, offsets.to(torch.int32),
                  None if bool(valid.all()) else valid, chars=chars)


def _parent_ids(col: Column) -> torch.Tensor:
    """int32 parent row of each child element (a search of the offsets).
    Child slots at or past offsets[-1] (the padded tails array_distinct
    and groupby_collect leave) get the sentinel ``n``: they sort after
    every real row and match no row's range."""
    child_n, n = col.children[0].size, col.size
    off = col.data.to(torch.int64)
    k = torch.arange(child_n, dtype=torch.int64, device=off.device)
    return torch.where(k < off[-1], _row_of(off, k, n), n).to(torch.int32)


@func_range("sort_array")
def sort_array(col: Column, ascending: bool = True) -> Column:
    """Spark ``sort_array``: elements sorted within each list (offsets
    unchanged; one sort of (parent, value)). Null elements first when
    ascending, last when descending."""
    _check_list(col, "sort_array")
    child = col.children[0]
    ptbl = Table([Column(INT32, _parent_ids(col)), child])
    order = sort_order(ptbl, [0, 1], ascending=[True, ascending],
                       nulls_first=[True, ascending])
    schild = gather(Table([child]), order).column(0)
    return Column(col.dtype, col.data, col.validity, children=[schild])


@func_range("array_position")
def array_position(col: Column, value) -> Column:
    """Spark ``array_position``: the 1-based index of the first element
    equal to ``value``, 0 when absent, null for a null list. Null
    elements never match. The first hit at or after each list's start is
    one search of the sorted hit positions."""
    _check_list(col, "array_position")
    child = col.children[0]
    child_n = child.size
    device = col.device
    if child_n:
        hits = torch.nonzero(_eq_scalar(child, value)).flatten()
        off = col.data.to(torch.int64)
        lo = off[:-1].clamp(0, child_n - 1)
        at = torch.searchsorted(hits, lo)
        first_in = hits[at.clamp(max=max(hits.shape[0] - 1, 0))] \
            if hits.numel() else torch.full_like(lo, child_n)
        first_in = torch.where(at < hits.shape[0], first_in, child_n)
        # a hit of a later row must not leak backwards
        pos = torch.where((first_in < off[1:]) & (first_in >= off[:-1]),
                          first_in - off[:-1] + 1, 0)
    else:
        pos = torch.zeros((col.size,), dtype=torch.int64, device=device)
    return Column(INT64, pos,
                  col.valid_mask() if col.validity is not None else None)


@func_range("array_distinct")
def array_distinct(col: Column) -> Column:
    """Spark ``array_distinct``: duplicates removed, first occurrences
    kept in order. One sort of (parent, value) marks first occurrences;
    the keep flags go back to child order with one scatter; the kept
    elements compact into a dense child with prefix-sum offsets."""
    _check_list(col, "array_distinct")
    child = col.children[0]
    if child.size == 0:
        return col
    ptbl = Table([Column(INT32, _parent_ids(col)), child])
    order = sort_order(ptbl, [0, 1], nulls_first=[True, True])
    svals = gather(ptbl, order)
    sp = svals.column(0).data
    sc = svals.column(1)
    v1 = sc.valid_mask()
    same_val = (_col_values_equal_prev(sc) & v1[1:] & v1[:-1]) \
        | (~v1[1:] & ~v1[:-1])
    dup = torch.cat([v1.new_zeros(1), (sp[1:] == sp[:-1]) & same_val])
    keep = torch.empty_like(dup)
    keep[order] = ~dup
    new_off = _prefix(keep)[col.data.to(torch.int64)].to(torch.int32)
    comp = torch.argsort((~keep).to(torch.int8), stable=True)
    return Column(col.dtype, new_off, col.validity,
                  children=[_gather_any(child, comp, True)])


@func_range("arrays_overlap")
def arrays_overlap(a: Column, b: Column) -> Column:
    """Spark ``arrays_overlap``: TRUE when the rows' lists share a
    non-null element; NULL when they do not but both are non-empty and
    either has a null element; FALSE otherwise; a null list gives null."""
    from spark_rapids_jni_tpu_torch.ops.table_ops import concatenate

    for c in (a, b):
        if c.dtype.type_id != TypeId.LIST:
            raise TypeError(
                f"arrays_overlap needs LIST columns, got {c.dtype}")
    ca, cb = a.children[0], b.children[0]
    if ca.dtype != cb.dtype:
        raise TypeError("arrays_overlap needs matching element dtypes")
    if a.size != b.size:
        raise ValueError(
            f"arrays_overlap needs equal row counts, got {a.size} vs "
            f"{b.size}")
    n = a.size
    device = a.device
    i8 = DType(TypeId.INT8)

    def side(col: Column, child: Column, s: int) -> Table:
        flag = torch.full((child.size,), s, dtype=torch.int8, device=device)
        return Table([Column(INT32, _parent_ids(col)), child,
                      Column(i8, flag)])

    allt = concatenate([side(a, ca, 0), side(b, cb, 1)])
    order = sort_order(allt, [0, 1, 2], nulls_first=[True, False, True])
    sv = gather(allt, order)
    sp = sv.column(0).data
    sc = sv.column(1)
    v1 = sc.valid_mask()
    pairhit = (sp[1:] == sp[:-1]) & _col_values_equal_prev(sc) & v1[1:] \
        & v1[:-1] & (sv.column(2).data[1:] != sv.column(2).data[:-1])
    cnt = torch.zeros((n,), dtype=torch.int64, device=device)
    if ca.size + cb.size > 1:
        pref = _prefix(pairhit)
        pr = torch.arange(n, dtype=torch.int32, device=device)
        hit_parent = sp[1:].contiguous()
        cnt = pref[torch.searchsorted(hit_parent, pr, right=True)] \
            - pref[torch.searchsorted(hit_parent, pr)]
    overlap = cnt > 0

    def any_null(col: Column) -> torch.Tensor:
        c = col.children[0]
        if c.validity is None:
            return torch.zeros((n,), dtype=torch.bool, device=device)
        return _range_any(~c.valid_mask(), col.data)

    def nonempty(col: Column) -> torch.Tensor:
        return col.data[1:] > col.data[:-1]

    has_null = (any_null(a) | any_null(b)) & nonempty(a) & nonempty(b)
    validity = a.valid_mask() & b.valid_mask() & (overlap | ~has_null)
    return Column(BOOL8, overlap.to(torch.uint8), validity)


@func_range("sequence")
def sequence(start: Column, stop: Column, step: Column | int = 1,
             max_length: int = 1024) -> Column:
    """Spark ``sequence(start, stop, step)``: one inclusive arithmetic
    range per row as LIST<INT64>.

    Reads the host for its errors: a row longer than ``max_length``
    raises; a step moving away from stop raises like Spark's
    ILLEGAL_SEQUENCE_BOUNDARIES (a zero step is legal only when start ==
    stop); so do offsets past 2^31 - 1. Null operands give a null row.
    The child holds exactly the rows' elements."""
    n = start.size
    device = start.device
    if isinstance(step, int):
        step_data = torch.full((n,), step, dtype=torch.int64, device=device)
        step_valid = torch.ones((n,), dtype=torch.bool, device=device)
    else:
        step_data = step.data.to(torch.int64)
        step_valid = step.valid_mask()
    a = start.data.to(torch.int64)
    b = stop.data.to(torch.int64)
    ok = start.valid_mask() & stop.valid_mask() & step_valid
    zero_ok = (step_data == 0) & (a == b)
    right_dir = torch.where(step_data > 0, b >= a,
                            torch.where(step_data < 0, b <= a, a == b))
    if bool((ok & ~right_dir).any()):
        raise ValueError(
            "sequence step moves away from stop (or is zero with "
            "start != stop) — Spark ILLEGAL_SEQUENCE_BOUNDARIES")
    safe_step = torch.where(step_data == 0, 1, step_data)
    lens = torch.where(
        ok & right_dir,
        torch.where(zero_ok, 1,
                    torch.div(b - a, safe_step, rounding_mode="floor") + 1),
        0)
    if bool((lens > max_length).any()):
        raise ValueError(
            f"sequence row exceeds max_length={max_length} elements; "
            "raise max_length (static child budget)")
    offsets = _prefix(lens)
    child_n = int(offsets[-1])
    if child_n > INT32_MAX:
        raise ValueError(
            f"sequence holds {child_n} elements, over the int32 offset "
            "bound (2^31-1); split the rows")
    k = torch.arange(child_n, dtype=torch.int64, device=device)
    parent = _row_of(offsets, k, n)
    vals = a[parent] + (k - offsets[parent]) * step_data[parent]
    child = Column(INT64, vals, torch.ones((child_n,), dtype=torch.bool,
                                           device=device))
    validity = None if (start.validity is None and stop.validity is None
                        and not isinstance(step, Column)) else ok
    return Column(DType(TypeId.LIST), offsets.to(torch.int32), validity,
                  children=[child])


def _list_ranges(col: Column):
    off = col.data.to(torch.int64)
    return off[:-1], off[1:]


@func_range("array_sum")
def array_sum(col: Column) -> Column:
    """Per-list SUM of numeric elements (nulls skipped; empty and
    all-null lists give null). Integer sums are cumsum differences,
    exact; float lists are summed each on its own (segmented scan)."""
    _check_list(col, "array_sum")
    child = col.children[0]
    if child.dtype.is_string or child.dtype.is_decimal128:
        raise TypeError("array_sum needs numeric elements")
    valid = child.valid_mask()
    acc_dt = _sum_dtype(child.dtype)
    lo, hi = _list_ranges(col)
    cnt = _prefix(valid)
    cnt = cnt[hi] - cnt[lo]
    if child.data.is_floating_point():
        total = torch.zeros(lo.shape, dtype=torch.float64, device=col.device)
        if child.size:
            vv = torch.where(valid, child.data.to(torch.float64), 0.0)
            # a segment starts at each list's first element
            seg = torch.zeros((child.size,), dtype=torch.bool,
                              device=col.device)
            seg[0] = True
            seg[lo[lo < child.size]] = True
            run = _segmented_sum_scan(vv[:, None], seg)[:, 0]
            total = torch.where(hi > lo, run[(hi - 1).clamp(
                0, child.size - 1)], 0.0)
    else:
        from spark_rapids_jni_tpu_torch.ops.sort import int64_value

        pref = _prefix(torch.where(valid, int64_value(child.data), 0))
        total = pref[hi] - pref[lo]
    return Column(acc_dt, total.to(acc_dt.torch_dtype),
                  col.valid_mask() & (cnt > 0))


def _ordered(x: torch.Tensor) -> torch.Tensor:
    """Values as an order-keeping tensor torch can compare."""
    return order_key(x) if x.dtype in _WIDE_UNSIGNED else x


def _unordered(r: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    if dtype == torch.uint64:
        return (r ^ INT64_MIN).view(torch.uint64)
    if dtype in (torch.uint16, torch.uint32):
        return r.to(_SIGNED_VIEW[dtype]).view(dtype)
    return r


def _sentinel(dtype: torch.dtype, op: str):
    """The null-neutral fill for min/max over ``_ordered`` values."""
    if dtype.is_floating_point:
        return float("inf") if op == "min" else -float("inf")
    info = torch.iinfo(torch.int64 if dtype == torch.uint64 else dtype)
    return info.max if op == "min" else info.min


def sparse_table_extremum(vv: torch.Tensor, lo: torch.Tensor,
                          hi: torch.Tensor, nlev: int, pick) -> torch.Tensor:
    """``pick`` over vv[lo .. hi] inclusive per row (hi >= lo): a sparse
    table of ``nlev`` levels (level l holds the extremum of vv[i : i +
    2^l]), two overlapping 2^k blocks a row, each read at level k
    directly. ``nlev`` must cover the widest range."""
    m = vv.shape[0]
    idx = torch.arange(m, dtype=torch.int64, device=vv.device)
    levels = [vv]
    for lev in range(nlev - 1):
        prev = levels[-1]
        levels.append(pick(prev, prev[(idx + (1 << lev)).clamp(max=m - 1)]))
    flat = torch.stack(levels).reshape(-1)
    length = hi - lo + 1
    k = torch.zeros_like(length)
    for lev in range(1, nlev):
        k += length >= (1 << lev)
    span = torch.ones_like(k) << k

    def at(i):
        return flat[k * m + i.clamp(0, m - 1)]

    return pick(at(lo), at(hi - span + 1))


def _array_extremum(col: Column, op: str) -> Column:
    _check_list(col, f"array_{op}")
    child = col.children[0]
    if child.dtype.is_string or child.dtype.is_decimal128:
        raise NotImplementedError(f"array_{op} on non-fixed-width elements")
    child_n, n = child.size, col.size
    lo, hi = _list_ranges(col)
    if child_n == 0:
        return Column(child.dtype, zeros((n,), child.data.dtype, col.device),
                      torch.zeros((n,), dtype=torch.bool, device=col.device))
    is_float = child.data.is_floating_point()
    vv = torch.where(child.valid_mask(), _ordered(child.data),
                     _sentinel(child.data.dtype, op))
    if is_float:
        # Spark orders NaN greatest: array_max with a NaN is NaN,
        # array_min skips NaNs (unless all are NaN). NaN maps to +inf for
        # the scan and comes back where +inf won (a genuine +inf element
        # reads as NaN too, as in the reference)
        vv = torch.where(torch.isnan(vv), torch.inf, vv)
    pick = torch.minimum if op == "min" else torch.maximum
    max_len = int((hi - lo).max()) if n else 1
    nlev = max(1, max(max_len, 1).bit_length())
    # the reference's span: a row covers [lo, lo + max(len, 1) - 1]
    out = sparse_table_extremum(vv, lo, lo + (hi - lo).clamp(min=1) - 1,
                                nlev, pick)
    if is_float:
        out = torch.where(torch.isinf(out) & (out > 0), float("nan"), out)
    else:
        out = _unordered(out, child.data.dtype)
    cnt = _range_any(child.valid_mask(), col.data)
    return Column(child.dtype, out, col.valid_mask() & cnt)


@func_range("array_min")
def array_min(col: Column) -> Column:
    """Per-list MIN (nulls skipped; empty and all-null lists null)."""
    return _array_extremum(col, "min")


@func_range("array_max")
def array_max(col: Column) -> Column:
    return _array_extremum(col, "max")


@func_range("array_slice")
def array_slice(col: Column, start: int, length: int) -> Column:
    """Spark ``slice(arr, start, length)``: 1-based start (a negative one
    counts from the end; past the head gives an empty list), ``length``
    elements, into a dense child (explode-style parent mapping)."""
    _check_list(col, "array_slice")
    if start == 0:
        raise ValueError("slice start is 1-based (non-zero)")
    if length < 0:
        raise ValueError("slice length must be >= 0")
    lo, hi = _list_ranges(col)
    if start > 0:
        s0 = lo + (start - 1)
    else:
        cand = hi + start
        s0 = torch.where(cand >= lo, cand, hi)
    s0 = torch.minimum(s0, hi)
    e0 = torch.minimum(s0 + length, hi)
    new_off = _prefix((e0 - s0).clamp(min=0))
    n = col.size
    child = col.children[0]
    child_n = child.size
    k = torch.arange(child_n, dtype=torch.int64, device=col.device)
    parent = _row_of(new_off, k, n)
    s0_p = torch.cat([s0, s0.new_zeros(1)])
    src = (s0_p[parent] + k - new_off[parent]).clamp(0, max(child_n - 1, 0))
    new_child = _gather_any(child, src, k < new_off[-1])
    return Column(col.dtype, new_off.to(torch.int32), col.validity,
                  children=[new_child])


# ---------------------------------------------------------------------------
# The padded wire layout of LIST columns: data = int32 per-row lengths,
# children[0] = an element column whose data is an (n, L) matrix with
# (n, L) element validity.
# ---------------------------------------------------------------------------


def is_padded_list(col: Column) -> bool:
    """The Column property: the mandatory 2-D element validity marks the
    layout."""
    return col.is_padded_list


def max_list_length(col: Column) -> int:
    """The longest list's length (0 for no rows); one host read."""
    if col.data.shape[0] <= 1:
        return 0
    return int((col.data[1:] - col.data[:-1]).max())


@func_range("pad_lists")
def pad_lists(col: Column, max_len: int | None = None) -> Column:
    """Offsets layout -> padded wire layout. ``max_len`` must bound every
    row's length (read from the host by default). Plain fixed-width
    elements only (DECIMAL128 and strings are not wire layouts)."""
    _check_list(col, "pad_lists")
    if col.is_padded_list:
        return col
    child = col.children[0]
    if not child.dtype.is_fixed_width or child.dtype.is_string:
        raise NotImplementedError(
            "pad_lists supports plain fixed-width elements only")
    if max_len is None:
        max_len = max_list_length(col)
    L = max(int(max_len), 1)
    off = col.data.to(torch.int64)
    lens = off[1:] - off[:-1]
    n, child_n = col.size, child.size
    j = torch.arange(L, dtype=torch.int64, device=col.device)[None, :]
    src = (off[:-1][:, None] + j).clamp(0, max(child_n - 1, 0))
    in_row = j < lens[:, None]
    if child_n:
        mat = take(child.data, src)
        evalid = child.valid_mask()[src] & in_row
    else:
        mat = zeros((n, L), child.data.dtype, col.device)
        evalid = torch.zeros((n, L), dtype=torch.bool, device=col.device)
    mat = torch.where(in_row, _indexable(mat), 0).view(mat.dtype)
    return Column(col.dtype, lens.to(torch.int32), col.validity,
                  children=[Column(child.dtype, mat, evalid)])


@func_range("unpad_lists")
def unpad_lists(col: Column) -> Column:
    """Padded wire layout -> offsets layout: a child of n * L slots, the
    live elements compacted to the front (explode-style mapping)."""
    if not col.is_padded_list:
        return col
    lens = col.data.to(torch.int64)
    elem = col.children[0]
    n, L = int(elem.data.shape[0]), int(elem.data.shape[1])
    offsets = _prefix(lens)
    k = torch.arange(max(n * L, 1), dtype=torch.int64, device=col.device)
    parent = _row_of(offsets, k, n)
    live = k < offsets[-1]
    if n == 0:
        flatv = zeros((1,), elem.data.dtype, col.device)
        flat_valid = torch.zeros((1,), dtype=torch.bool, device=col.device)
    else:
        j = (k - offsets[parent]).clamp(0, L - 1)
        flatv = _indexable(elem.data)[parent, j]
        flat_valid = elem.valid_mask()[parent, j] & live
        flatv = torch.where(live, flatv, 0).view(elem.data.dtype)
    return Column(col.dtype, offsets.to(torch.int32), col.validity,
                  children=[Column(elem.dtype, flatv, flat_valid)])
