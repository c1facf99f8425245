"""Equi-join (counterpart of ``spark_rapids_jni_tpu/ops/join.py``).

A sort + binary-search join, as in the reference: sort the build side
once (nulls banished past the valid prefix, which is then overwritten
with the dtype's max), find each probe key's match run [lo, hi) in it —
the ``join.hash_probe`` kernel on the card (``ops/hash.py``) — lay the
output pairs out with a prefix sum, and resolve output row j to (probe
row, match ordinal) with a search over the offsets. The caller supplies
``out_size`` (capacity) and gets gather maps plus the true match count.
SQL semantics: a NULL in any key column matches nothing.

Multi-column, float, DECIMAL128 and STRING keys are exact, not hashed:
both sides' key tuples are dense-rank encoded over their union (one sort
of the concatenated keys; string keys padded to one width first), and
the join runs on the int32 ranks. String payload columns come back in
the padded layout.

Indices are int64 (torch's index type; the reference's are int32), and
index values on rows with ``row_valid`` False are unspecified.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from spark_rapids_jni_tpu_torch.columnar import Column, Table
from spark_rapids_jni_tpu_torch.columnar.column import (
    _indexable,
    cat,
    take,
    zeros,
)
from spark_rapids_jni_tpu_torch.ops.groupby import _rows_equal_prev
from spark_rapids_jni_tpu_torch.ops.hash import probe_sorted_lo_hi
from spark_rapids_jni_tpu_torch.ops.sort import (
    _int_field,
    _pack,
    gather,
    lexsort,
    sort_order,
)
from spark_rapids_jni_tpu_torch.ops.strings import (
    gather_strings,
    pad_strings,
    pad_to_common_width,
)

_JOIN_TYPES = ("inner", "left", "left_semi", "left_anti", "right", "full")


class JoinMaps(NamedTuple):
    """Gather maps describing join output rows (padded to out_size)."""

    left_index: torch.Tensor   # int64[out_size] into the left table
    right_index: torch.Tensor  # int64[out_size] into the right table
    right_valid: torch.Tensor  # bool: False on left-join unmatched rows
    row_valid: torch.Tensor    # bool: False on padding rows
    total: torch.Tensor        # 0-d int64: true number of output rows
    # bool: False on right/full-join rows with no left match (null left)
    left_valid: torch.Tensor


def _at(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[idx]`` with ``idx`` clamped into range (zeros from an empty
    ``x``): the reference's clamped gather."""
    if x.shape[0] == 0:
        return torch.zeros(idx.shape, dtype=x.dtype, device=idx.device)
    return x[idx.clamp(0, x.shape[0] - 1)]


def _sorted_valid_keys(key: torch.Tensor, valid: torch.Tensor):
    """Sort one side with nulls banished past the valid prefix (stable by
    key, then stable by null rank), then overwrite the tail with the
    dtype's max so a binary search over it stays sound whatever bytes the
    null rows hold. Returns (sorted_key, n_valid, perm)."""
    n = key.shape[0]
    perm = lexsort(_pack([_int_field(key),
                          ((~valid).to(torch.int64), 1)]), n, key.device)
    n_valid = valid.to(torch.int64).sum()
    # the max's bit pattern in the signed view: all ones for unsigned
    np_dt = np.dtype(str(key.dtype).removeprefix("torch."))
    sentinel = -1 if np_dt.kind == "u" and np_dt.itemsize > 1 \
        else int(np.iinfo(np_dt).max)
    in_prefix = torch.arange(n, dtype=torch.int64, device=key.device) < n_valid
    sorted_key = torch.where(in_prefix, _indexable(take(key, perm)),
                             sentinel).view(key.dtype)
    return sorted_key, n_valid, perm


def _join_maps_impl(
    left_key: torch.Tensor,
    left_valid: torch.Tensor,
    right_key: torch.Tensor,
    right_valid: torch.Tensor,
    out_size: int,
    how: str,
    left_row_valid: Optional[torch.Tensor] = None,
    right_row_valid: Optional[torch.Tensor] = None,
) -> JoinMaps:
    n_left = left_key.shape[0]
    n_right = right_key.shape[0]
    device = left_key.device
    # rows that are not rows at all (padding, phantom slots) never match
    if left_row_valid is not None:
        left_valid = left_valid & left_row_valid
    if right_row_valid is not None:
        right_valid = right_valid & right_row_valid
    sorted_key, n_valid_right, perm = _sorted_valid_keys(right_key,
                                                         right_valid)

    # match runs per probe row (empty when the probe key is null)
    lo, hi = probe_sorted_lo_hi(sorted_key, left_key)
    hi = torch.minimum(hi, n_valid_right)  # the sentinel tail never matches
    lo = torch.minimum(lo, hi)
    counts = torch.where(left_valid, hi - lo, 0)
    if how in ("left", "full"):
        out_per_row = counts.clamp(min=1)  # unmatched probe row emits one
    elif how == "left_semi":
        out_per_row = (counts > 0).to(torch.int64)
    elif how == "left_anti":
        # a NULL probe key matches nothing, so it qualifies
        out_per_row = (counts == 0).to(torch.int64)
    else:  # inner, right
        out_per_row = counts
    if left_row_valid is not None and how not in ("inner", "right"):
        # phantom probe rows emit nothing, even unmatched
        out_per_row = torch.where(left_row_valid, out_per_row, 0)
    offsets = torch.cumsum(out_per_row, 0)
    zero = torch.zeros((), dtype=torch.int64, device=device)
    probe_total = offsets[-1] if n_left else zero

    j = torch.arange(out_size, dtype=torch.int64, device=device)
    left_row = torch.searchsorted(offsets, j, right=True) if n_left \
        else torch.zeros_like(j)
    left_row = left_row.clamp(0, max(n_left - 1, 0))
    base = torch.where(left_row > 0, _at(offsets, left_row - 1), 0)
    ordinal = j - base
    matched = _at(counts, left_row) > 0
    right_pos = (_at(lo, left_row) + ordinal).clamp(0, max(n_right - 1, 0))
    right_row = _at(perm, right_pos)

    if how not in ("right", "full"):
        row_valid = j < probe_total
        right_ok = matched & row_valid if how != "left_anti" \
            else torch.zeros_like(row_valid)
        return JoinMaps(left_row, right_row, right_ok, row_valid,
                        probe_total, row_valid)

    # right/full outer: append build rows no valid probe row matched, with
    # a null left side — the mirror of the probe phase
    sorted_left, n_valid_left, _ = _sorted_valid_keys(left_key, left_valid)
    l_lo, l_hi = probe_sorted_lo_hi(sorted_left, right_key)
    l_hi = torch.minimum(l_hi, n_valid_left)
    exists_in_left = torch.minimum(l_lo, l_hi) < l_hi
    unmatched = ~(right_valid & exists_in_left)
    if right_row_valid is not None:
        unmatched = unmatched & right_row_valid  # phantom slots emit nothing
    r_off = torch.cumsum(unmatched.to(torch.int64), 0)
    total = probe_total + (r_off[-1] if n_right else zero)

    is_extra = (j >= probe_total) & (j < total)
    k = (j - probe_total).clamp(min=0)
    extra_right = torch.searchsorted(r_off, k, right=True) if n_right \
        else torch.zeros_like(k)
    extra_right = extra_right.clamp(0, max(n_right - 1, 0))
    row_valid = j < total
    return JoinMaps(
        left_index=left_row,
        right_index=torch.where(is_extra, extra_right, right_row),
        right_valid=(matched | is_extra) & row_valid,
        row_valid=row_valid,
        total=total,
        left_valid=row_valid & ~is_extra,
    )


def _concat_key_columns(lc: Column, rc: Column) -> Column:
    """One key column from both tables stacked (left rows first), for the
    union rank encoding."""
    if lc.dtype.is_string != rc.dtype.is_string:
        raise TypeError("join key types must match (string vs non-string)")
    validity = torch.cat([lc.valid_mask(), rc.valid_mask()])
    if lc.dtype.is_string:
        lp, rp = pad_to_common_width([lc, rc])
        return Column(lc.dtype, torch.cat([lp.data, rp.data]), validity,
                      chars=torch.cat([lp.chars, rp.chars]))
    if lc.dtype.is_decimal or rc.dtype.is_decimal:
        # unscaled storage comparison is only sound at equal scales
        if lc.dtype != rc.dtype:
            raise TypeError(
                f"decimal join keys must have identical type+scale, got "
                f"{lc.dtype} vs {rc.dtype} (rescale first)")
    elif lc.dtype.storage_dtype != rc.dtype.storage_dtype:
        raise TypeError("join key storage types must match")
    return Column(lc.dtype, cat([lc.data, rc.data]), validity)


def rank_encode_keys(
    left: Table, right: Table,
    left_on: Sequence[int], right_on: Sequence[int],
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact join-key encoding: int32 dense ranks of the key tuples over
    the union of both tables. ``lkey[i] == rkey[j]`` iff the tuples are
    equal (nulls compare equal here; the join's validity masks exclude
    them). One sort of nl + nr rows."""
    nl = left.num_rows
    combined = Table([
        _concat_key_columns(left.column(i), right.column(j))
        for i, j in zip(left_on, right_on)
    ])
    ks = list(range(combined.num_columns))
    order = sort_order(combined, ks)
    same = _rows_equal_prev(gather(combined, order), ks)
    gid = (torch.cumsum((~same).to(torch.int64), 0) - 1).to(torch.int32)
    ranks = torch.empty_like(gid)
    ranks[order] = gid  # ranks of the rows in their input order
    return ranks[:nl], ranks[nl:]


def _join_impl(left: Table, right: Table, lkeys, rkeys, out_size: int,
               how: str, left_row_valid, right_row_valid) -> JoinMaps:
    lvalid = left.column(lkeys[0]).valid_mask()
    for k in lkeys[1:]:
        lvalid = lvalid & left.column(k).valid_mask()
    rvalid = right.column(rkeys[0]).valid_mask()
    for k in rkeys[1:]:
        rvalid = rvalid & right.column(k).valid_mask()

    lc = left.column(lkeys[0])
    rc0 = right.column(rkeys[0])
    single_integral = (
        len(lkeys) == 1
        and lc.dtype == rc0.dtype  # decimal scale included
        and not lc.dtype.is_decimal128  # limb pairs go via rank encoding
        and lc.dtype.is_fixed_width
        and lc.dtype.storage_dtype.kind in ("i", "u")
    )
    if single_integral:
        # integral values are their own exact encoding
        lkey, rkey = lc.data, rc0.data
    else:
        lkey, rkey = rank_encode_keys(left, right, list(lkeys), list(rkeys))
    return _join_maps_impl(lkey, lvalid, rkey, rvalid, out_size, how,
                           left_row_valid, right_row_valid)


def join(
    left: Table,
    right: Table,
    left_on: int | Sequence[int],
    right_on: int | Sequence[int],
    out_size: int,
    how: str = "inner",
    left_row_valid: Optional[torch.Tensor] = None,
    right_row_valid: Optional[torch.Tensor] = None,
) -> JoinMaps:
    """Equi-join returning gather maps; single- or multi-column keys of
    any fixed-width type. ``out_size`` caps the output (check ``total <=
    out_size``, or use ``join_auto``). ``left_row_valid`` /
    ``right_row_valid`` mark which rows exist at all (False = padding, a
    row that emits nothing even under an outer join).

    Join types: ``inner``, ``left``, ``left_semi`` (one row per probe
    row with a match; right side = first match), ``left_anti`` (one row
    per probe row with no match — null keys qualify; right side null),
    ``right`` (inner + unmatched build rows with a null left), ``full``
    (left + unmatched build rows with a null left)."""
    if how not in _JOIN_TYPES:
        raise ValueError(
            f"unsupported join type {how!r}; valid: {_JOIN_TYPES}")
    left_keys = [left_on] if isinstance(left_on, int) else list(left_on)
    right_keys = [right_on] if isinstance(right_on, int) else list(right_on)
    if len(left_keys) != len(right_keys) or not left_keys:
        raise ValueError("left_on and right_on must be equal-length, "
                         "non-empty")
    return _join_impl(left, right, [int(k) for k in left_keys],
                      [int(k) for k in right_keys], int(out_size), how,
                      left_row_valid, right_row_valid)


def _gather_out(c: Column, idx: torch.Tensor,
                validity: torch.Tensor) -> Column:
    if c.dtype.is_string:
        p = pad_strings(c)
        if c.size == 0:  # an empty build: zero lengths and bytes
            return Column(c.dtype, torch.zeros(
                idx.shape, dtype=torch.int32, device=c.device), validity,
                chars=torch.zeros((idx.shape[0], p.chars.shape[1]),
                                  dtype=torch.uint8, device=c.device))
        g = gather_strings(p, idx)
        return Column(c.dtype, g.data, validity, chars=g.chars)
    if c.size == 0:
        data = zeros((idx.shape[0], *c.data.shape[1:]), c.data.dtype,
                     c.device)
    else:
        data = take(c.data, idx)
    return Column(c.dtype, data, validity)


def apply_join_maps(left: Table, right: Table, maps: JoinMaps) -> Table:
    """Materialize the joined table: left columns then right columns.
    Padding rows carry validity False everywhere; unmatched right sides
    (left/full join) and unmatched left sides (right/full join) are
    null. String columns come back padded."""
    cols: list[Column] = []
    for c in left.columns:
        validity = (_at(c.valid_mask(), maps.left_index) & maps.left_valid
                    & maps.row_valid)
        cols.append(_gather_out(c, maps.left_index, validity))
    for c in right.columns:
        validity = (_at(c.valid_mask(), maps.right_index) & maps.right_valid
                    & maps.row_valid)
        cols.append(_gather_out(c, maps.right_index, validity))
    return Table(cols)


def join_auto(
    left: Table,
    right: Table,
    left_on: int | Sequence[int],
    right_on: int | Sequence[int],
    initial_out_size: int | None = None,
    how: str = "inner",
    growth: int = 4,
) -> tuple[JoinMaps, Table]:
    """Grow-and-retry around the output capacity: run with a guessed
    ``out_size``; while ``total`` exceeds it, grow to max(total,
    out_size * growth) and rerun. The growth runs through the shared
    ladder (``resilience.escalate``): an overflowed attempt reports its
    exact need (``total``), so the schedule is the plain loop's; with
    ``resilience.enabled=false`` the plain loop runs. Returns (maps,
    materialized table)."""
    from spark_rapids_jni_tpu_torch.runtime import resilience

    n = max(left.num_rows, 1)
    out_size = int(initial_out_size) if initial_out_size else n
    if not resilience.enabled():
        while True:
            maps = join(left, right, left_on, right_on, out_size, how=how)
            total = int(maps.total)
            if total <= out_size:
                return maps, apply_join_maps(left, right, maps)
            out_size = max(total, out_size * growth)

    def _attempt(cap):
        maps = join(left, right, left_on, right_on, cap, how=how)
        total = int(maps.total)
        if total <= cap:
            return (maps, apply_join_maps(left, right, maps)), False, None
        return None, True, total

    return resilience.escalate(
        "join_auto", _attempt, seam="dispatch.execute", initial=out_size,
        growth=growth, rows=n)
