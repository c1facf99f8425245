"""Planner-declared plans (counterpart of part of
``spark_rapids_jni_tpu/ops/planner.py``).

- Bounded groupby: when every key column's candidate values are known at
  plan time (DDL facts such as TPC-H's CHAR(1) flag domains),
  ``plan_groupby`` lowers the groupby to ``groupby_aggregate_bounded``:
  no sort, no gather, one streaming pass. ``domain_miss`` is the runtime
  escape hatch: out-of-domain data must re-plan, it is never silently
  dropped. String keys are dictionary-encoded on the device against
  their domain (``encode_string_key``) and decoded back to static
  strings at the output. Any other groupby lowers to the general
  sort-based ``groupby_aggregate``, bounded by the budget, and
  ``plan_groupby_auto`` grows the budget until the groups fit.
  ``month_bucket`` turns a date column into a key with a small declared
  domain (``month_domain``), which puts date rollups on the bounded plan.
- Dense primary-key join (``dense_pk_join``): a LEFT join against a
  build side whose keys are declared unique in [key_lo, key_hi] — a
  gather (clustered) or one sort plus a search, never the join kernel.
  ``pk_violation`` is its escape hatch.
- Dense-id reductions (``dense_id_counts``, ``dense_id_sums``): COUNT and
  exact int64 SUM per group when the key already is the group id in
  [0, m) — no sort. The reference streams a one-hot compare per row block
  (its TPU form); here they are ``bincount`` and ``index_add_``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from spark_rapids_jni_tpu_torch import types as t
from spark_rapids_jni_tpu_torch.columnar import Column, Table
from spark_rapids_jni_tpu_torch.columnar.column import take, zeros
from spark_rapids_jni_tpu_torch.ops._calendar import civil_from_days
from spark_rapids_jni_tpu_torch.ops.datetime import _days_since_epoch
from spark_rapids_jni_tpu_torch.ops.groupby import (
    bounded_group_layout,
    bounded_lanes,
    dense_gid,
    groupby_aggregate,
    groupby_aggregate_bounded,
)
from spark_rapids_jni_tpu_torch.ops.sort import (
    gather,
    int64_value,
    order_key,
    sort_table,
)
from spark_rapids_jni_tpu_torch.ops.strings import pad_strings, static_strings
from spark_rapids_jni_tpu_torch.runtime.resilience import FatalExecutionError


class Domain(NamedTuple):
    """Planner-declared candidate values for one groupby key column:
    storage scalars for fixed-width keys, ``str`` for string keys, kept
    sorted so the group output order is ORDER BY ... NULLS LAST.
    ``source`` is provenance ("ddl", "dictionary", "observed", ...),
    never branched on."""

    values: tuple
    kind: str  # "scalar" | "string"
    source: str


def scalar_domain(values: Sequence, source: str = "ddl") -> Domain:
    vals = tuple(sorted(set(int(v) for v in values)))
    if not vals:
        raise ValueError("empty domain")
    return Domain(vals, "scalar", source)


def string_domain(values: Sequence[str], source: str = "ddl") -> Domain:
    """A string key's domain, sorted byte-wise: the collation of the
    string sort keys, so the bounded output order is the one
    ``sort_table`` gives."""
    vals = tuple(sorted(set(values), key=lambda v: v.encode()))
    if not vals:
        raise ValueError("empty domain")
    return Domain(vals, "string", source)


_OBSERVED_DEFAULT_CAP = 1024


def observed_domain(col: Column, max_size: int = _OBSERVED_DEFAULT_CAP,
                    source: str = "observed") -> Domain | None:
    """Planning-time statistics: the column's distinct non-null values,
    read on the host, or None when there are more than ``max_size`` of
    them (or none) and the key is not boundable."""
    if col.dtype.is_string:
        vals = sorted({v for v in col.to_pylist() if v is not None},
                      key=lambda v: v.encode())
        if len(vals) > max_size:
            return None
        return Domain(tuple(vals), "string", source) if vals else None
    if col.dtype.is_decimal128:
        return None
    data, valid = col.to_numpy()
    if valid is not None:
        data = data[valid]
    vals = np.unique(data)
    if vals.size > max_size or vals.size == 0:
        return None
    return Domain(tuple(int(v) for v in vals), "scalar", source)


def domain_from_parquet(path, column: int,
                        max_size: int = _OBSERVED_DEFAULT_CAP,
                        sample_row_groups: int = 1,
                        device=None) -> Domain | None:
    """Planner-time domain of one Parquet column: decode the first
    ``sample_row_groups`` row groups of ``column`` through the native
    reader and take the observed distinct values. A sample, so the
    domain is declared ``source="observed"`` and the runtime
    ``domain_miss`` check stays the backstop: a wrong sample means a
    re-plan, never a wrong answer."""
    from spark_rapids_jni_tpu_torch.parquet.reader import (
        read_table,
        row_group_info,
    )

    n_groups = len(row_group_info(path))
    groups = list(range(min(sample_row_groups, n_groups)))
    tbl = read_table(path, columns=[column], row_groups=groups,
                     device=device)
    return observed_domain(tbl.column(0), max_size=max_size)


def month_code(year: int, month: int) -> int:
    """Static month-bucket code: year*12 + (month-1)."""
    return year * 12 + (month - 1)


def month_bucket(col: Column) -> Column:
    """Derived key column: the calendar-month bucket of a date column
    (int32 ``year*12 + month-1``). Date cardinality is unbounded; the
    month buckets of any query's date range are few, which puts
    date-bucketed rollups on the sort-free plan."""
    y, mth, _ = civil_from_days(_days_since_epoch(col))
    code = y.to(torch.int32) * 12 + (mth.to(torch.int32) - 1)
    return Column(t.INT32, code, col.validity)


def month_domain(year_lo: int, month_lo: int, year_hi: int, month_hi: int,
                 source: str = "ddl") -> Domain:
    """All month-bucket codes in [year_lo-month_lo, year_hi-month_hi]
    inclusive: the domain a planner derives from a date-range predicate
    or min/max column statistics."""
    lo = month_code(year_lo, month_lo)
    hi = month_code(year_hi, month_hi)
    if hi < lo:
        raise ValueError("month range is empty")
    return Domain(tuple(range(lo, hi + 1)), "scalar", source)


def encode_string_key(col: Column, domain: Domain) -> Column:
    """Dictionary-encode a string key against its declared domain on the
    device: one compare of the padded bytes per domain value. The code
    is the value's index in the sorted domain; a row outside the domain
    gets ``len(domain)`` (a ``domain_miss`` in the bounded groupby); null
    rows stay null. As in the reference, the compare covers the whole
    zero-padded row and not its length, so a row that is a domain value
    followed by NUL bytes takes that value's code."""
    if domain.kind != "string":
        raise ValueError("encode_string_key needs a string domain")
    col = pad_strings(col)
    n, w = int(col.chars.shape[0]), int(col.chars.shape[1])
    k = len(domain.values)
    code = torch.full((n,), k, dtype=torch.int32, device=col.device)
    for idx, v in enumerate(domain.values):
        b = v.encode()
        if len(b) > w:
            continue  # longer than every row: cannot match
        target = np.zeros((w,), np.uint8)
        target[:len(b)] = np.frombuffer(b, np.uint8)
        hit = (col.chars == torch.from_numpy(target).to(col.device)).all(1)
        code = torch.where(hit, idx, code)
    return Column(t.INT32, code, col.validity)


def _decode_string_key(dom: Domain, codes: np.ndarray, order: np.ndarray,
                       present: torch.Tensor) -> Column:
    """The bounded output's string key column, built on the host from the
    static layout: slot i holds the domain value of code
    ``codes[order[i]]`` (null past the domain)."""
    vals = [dom.values[c] if c < len(dom.values) else None
            for c in codes[order]]
    lens, mat = static_strings(vals, present.device)
    valid = torch.tensor([v is not None for v in vals], device=present.device)
    return Column(t.STRING, lens, valid & present, chars=mat)


def _encode_keys(table: Table, keys, domains):
    """The bounded plan's input: string keys replaced by their domain
    codes. Returns (table, per-key domain values, {key position: string
    Domain})."""
    work_cols = list(table.columns)
    key_domains: list[Sequence[int]] = []
    strings: dict[int, Domain] = {}
    for pos, (k, dom) in enumerate(zip(keys, domains)):
        if dom.kind == "string":
            work_cols[k] = encode_string_key(table.column(k), dom)
            key_domains.append(tuple(range(len(dom.values))))
            strings[pos] = dom
        else:
            key_domains.append(dom.values)
    return Table(work_cols), key_domains, strings


def bounded_accumulate_inputs(table: Table, keys, aggs, domains,
                              row_valid: Optional[torch.Tensor] = None):
    """(gid, lanes, m): the accumulate kernel's inputs in the bounded plan
    ``plan_groupby`` lowers this groupby to, for timing and checking the
    kernel alone."""
    work, key_domains, _ = _encode_keys(table, keys, domains)
    _, m, _, _ = bounded_group_layout([len(d) for d in key_domains])
    gid, _ = dense_gid(work, keys, key_domains, m, row_valid)
    return gid, bounded_lanes(work, aggs).lanes, m


class PlannedGroupBy(NamedTuple):
    """Result of ``plan_groupby`` over both lowerings: ``table`` rows in
    key order with null-key groups last. On the bounded plan the shape is
    the static slot count m and ``present`` marks live groups; on the
    general plan the shape is the padded budget and ``present`` marks the
    first ``num_groups`` rows. ``domain_miss`` is the bounded plan's
    re-plan signal (False on the general plan); ``overflowed`` the general
    plan's (the data held more groups than the budget: grow and retry),
    always False on the bounded plan, whose slot count is checked at plan
    time."""

    table: Table
    present: torch.Tensor
    domain_miss: torch.Tensor
    lowered: str  # "bounded" | "general"
    overflowed: object = False


def plan_groupby(
    table: Table,
    keys: Sequence[int],
    aggs: Sequence[tuple[int, str]],
    domains: Sequence[Optional[Domain]],
    budget: int = 4096,
    row_valid: Optional[torch.Tensor] = None,
) -> PlannedGroupBy:
    """Lower a groupby to the sort-free bounded plan when the planner can
    bound every key, else to the general sort-based plan.

    Bounded: each key has a ``Domain``, the slot count
    ``prod(len(d)+1)`` fits ``budget`` and every agg is in the
    single-pass set (sum/count/mean/min/max). String keys are encoded to
    dense codes on the device and decoded to static strings at the
    output. General: ``groupby_aggregate`` with at most ``budget``
    groups, then one sort of its keys with nulls last.

    ``row_valid``: bool[n] marking rows that EXIST. On the bounded plan
    non-rows join no slot; on the general plan their keys and values are
    nulled, so they fold into the null-key group."""
    if len(domains) != len(keys):
        raise ValueError("one Domain (or None) per key required")
    bounded_ok = (
        all(d is not None for d in domains)
        and all(op in ("sum", "count", "mean", "min", "max")
                for _, op in aggs)
        and int(np.prod([len(d.values) + 1 for d in domains])) <= budget
    )
    if not bounded_ok:
        if row_valid is not None:
            table = Table([
                Column(c.dtype, c.data, c.valid_mask() & row_valid,
                       chars=c.chars, children=c.children)
                for c in table.columns
            ])
        g = groupby_aggregate(table, keys=list(keys), aggs=list(aggs),
                              max_groups=min(budget, table.num_rows) or 1)
        srt = sort_table(g.table, list(range(len(keys))),
                         nulls_first=[False] * len(keys))
        present = torch.arange(srt.num_rows, device=g.num_groups.device) \
            < g.num_groups
        return PlannedGroupBy(
            srt, present,
            torch.zeros((), dtype=torch.bool, device=present.device),
            "general", g.overflowed)
    work, key_domains, strings = _encode_keys(table, keys, domains)
    res = groupby_aggregate_bounded(
        work, keys=list(keys), aggs=list(aggs), key_domains=key_domains,
        row_valid=row_valid)
    out_cols = list(res.table.columns)
    if strings:
        _, _, codes, order = bounded_group_layout(
            [len(d) for d in key_domains])
        for pos, dom in strings.items():
            out_cols[pos] = _decode_string_key(dom, codes[:, pos], order,
                                               res.present)
    return PlannedGroupBy(Table(out_cols), res.present, res.domain_miss,
                          "bounded")


class PlanBudgetExceeded(FatalExecutionError, ValueError):
    """A groupby's distinct-group count exceeded ``max_budget``: a
    ``FatalExecutionError`` of the resilience taxonomy (the budget is a
    caller's contract, not a transient condition) that is still the
    ValueError callers match on."""


def plan_groupby_auto(
    table: Table,
    keys: Sequence[int],
    aggs: Sequence[tuple[int, str]],
    domains: Sequence[Optional[Domain]],
    budget: int = 4096,
    max_budget: Optional[int] = None,
    row_valid: Optional[torch.Tensor] = None,
) -> PlannedGroupBy:
    """``plan_groupby`` that grows the budget: when the general plan
    drops groups (``overflowed``), double the budget and retry until the
    result is complete. The growth runs through the shared ladder
    (``resilience.escalate``) with the reference's budget schedule
    min(b·2^k, cap); with ``resilience.enabled=false`` the plain loop
    runs. Past ``max_budget`` (default: the row count) it raises
    :class:`PlanBudgetExceeded`."""
    from spark_rapids_jni_tpu_torch.runtime import resilience

    cap = max_budget if max_budget is not None else max(table.num_rows, 1)
    # clamp both ways: a sub-positive budget would loop forever (0*2 == 0)
    # and a starting budget above the cap would silently ignore it
    b = min(max(budget, 1), cap)
    if not resilience.enabled():
        while True:
            res = plan_groupby(table, keys, aggs, domains, budget=b,
                               row_valid=row_valid)
            if not bool(res.overflowed) or b >= cap:
                if bool(res.overflowed):
                    raise PlanBudgetExceeded(
                        f"groupby exceeded max_budget={cap} distinct groups")
                return res
            b = min(b * 2, cap)

    def _attempt(budget_):
        res = plan_groupby(table, keys, aggs, domains, budget=budget_,
                           row_valid=row_valid)
        return res, bool(res.overflowed), None

    return resilience.escalate(
        "plan_groupby_auto", _attempt, seam="dispatch.execute",
        initial=b, growth=2, max_capacity=cap,
        exhaust=lambda c, steps: PlanBudgetExceeded(
            f"groupby exceeded max_budget={cap} distinct groups"))


_INT64_MAX = (1 << 63) - 1


def _key_image(v: int, np_dt: np.dtype) -> int:
    """A Python key bound in ``order_key``'s image of ``np_dt``; a bound
    outside the dtype raises OverflowError, as numpy's scalar conversion
    does in the reference."""
    info = np.iinfo(np_dt)
    if not info.min <= v <= info.max:
        raise OverflowError(
            f"Python integer {v} out of bounds for {np_dt.name}")
    return v - (1 << 63) if np_dt == np.uint64 else v


class DensePkJoinResult(NamedTuple):
    """LEFT PK-join result: one output row per probe row (PK fanout is at
    most 1). Probe columns first, then build columns; unmatched probe
    rows carry null build columns."""

    table: Table
    matched: torch.Tensor       # bool[n] probe rows with a build match
    total: torch.Tensor         # 0-d int64 match count
    # True when the declared layout lied: a clustered slot held a
    # different valid key, or (sorted mode) the build side held duplicate
    # or out-of-range keys. The caller re-plans on the general join.
    pk_violation: torch.Tensor


def dense_pk_join(
    probe: Table,
    build: Table,
    probe_key: int,
    build_key: int,
    key_lo: int,
    key_hi: int,
    clustered: bool = False,
) -> DensePkJoinResult:
    """LEFT join against a DECLARED dense primary-key build side: the
    build key column holds unique keys from [key_lo, key_hi].

    - ``clustered=True``: build row i holds key ``key_lo + i``; the join
      is arithmetic plus one row gather, and each gathered key is checked
      against the probe key (``pk_violation`` if a slot holds another
      valid key).
    - ``clustered=False``: one stable sort of the build side, a binary
      search per probe key; duplicate or out-of-range build keys raise
      ``pk_violation``.

    Build rows with null keys are filtered rows: probes pointing at them
    are unmatched, not violations. Keys compare in their order image
    (``order_key``: uint64 with its sign bit flipped), so UINT64 keys
    and ranges past 2^63 match by value."""
    nb = build.num_rows
    pk = probe.column(probe_key)
    bk = build.column(build_key)
    if not (pk.dtype.is_fixed_width and bk.dtype.is_fixed_width) \
            or pk.dtype.storage_dtype.kind not in ("i", "u") \
            or bk.dtype.storage_dtype.kind not in ("i", "u"):
        raise NotImplementedError(
            "dense PK keys are integers (dictionary-encode first)")
    p_dt, b_dt = pk.dtype.storage_dtype, bk.dtype.storage_dtype
    if (p_dt == np.uint64) != (b_dt == np.uint64) and min(
            np.iinfo(p_dt).min, np.iinfo(b_dt).min) < 0:
        raise TypeError("dense PK keys: uint64 and a signed key dtype "
                        "have no common exact order")
    pimg = order_key(pk.data)
    plo, phi = _key_image(key_lo, p_dt), _key_image(key_hi, p_dt)
    in_range = pk.valid_mask() & (pimg >= plo) & (pimg <= phi)
    if clustered:
        if key_hi - key_lo + 1 != nb:
            raise ValueError(
                f"clustered dense PK needs build rows == key range "
                f"({nb} != {key_hi - key_lo + 1})")
        if key_hi > _INT64_MAX:
            # as in the reference, whose int64 offsets overflow here
            raise OverflowError(
                f"clustered dense PK range [{key_lo}, {key_hi}] passes "
                f"int64's max")
        pdata = int64_value(pk.data)
        pos = (pdata - key_lo).clamp(0, max(nb - 1, 0))
        bkey_at = int64_value(take(bk.data, pos))
        bvalid_at = bk.valid_mask()[pos]
        matched = in_range & bvalid_at & (bkey_at == pdata)
        pk_violation = (in_range & bvalid_at & (bkey_at != pdata)).any()
    else:
        # null keys become the dtype max so the sorted keys are globally
        # monotone; a declared range reaching that max would collide
        bvalid = bk.valid_mask()
        dt_max = int(np.iinfo(b_dt).max)
        if key_hi >= dt_max:
            raise ValueError(
                f"dense PK range [{key_lo}, {key_hi}] reaches "
                f"iinfo({b_dt.name}).max, the null sentinel; widen the "
                f"key dtype or shrink the range")
        bimg = order_key(bk.data)
        top = _key_image(dt_max, b_dt)  # above every in-range key
        skey, perm = torch.sort(torch.where(bvalid, bimg, top), stable=True)
        n_valid = bvalid.to(torch.int64).sum()
        pos0 = torch.searchsorted(skey, pimg)
        safe = pos0.clamp(0, max(nb - 1, 0))
        hit = (pos0 < n_valid) & (skey[safe] == pimg) if nb \
            else torch.zeros_like(in_range)
        pos = perm[safe] if nb else safe
        matched = in_range & hit
        dup = ((skey[1:] == skey[:-1]) & (
            torch.arange(1, nb, device=bk.device) < n_valid)).any()
        oor = (bvalid & ((bimg < _key_image(key_lo, b_dt))
                         | (bimg > _key_image(key_hi, b_dt)))).any()
        pk_violation = dup | oor
    out_cols = list(probe.columns)
    if nb:
        gathered = gather(build, pos).columns
    else:
        gathered = [_empty_rows(c, pos.shape[0]) for c in build.columns]
    for c in gathered:
        out_cols.append(Column(c.dtype, c.data, c.valid_mask() & matched,
                               c.chars))
    return DensePkJoinResult(Table(out_cols), matched,
                             matched.to(torch.int64).sum(), pk_violation)


def _empty_rows(c: Column, n: int) -> Column:
    """``n`` zero rows of ``c``'s type (string columns padded)."""
    if c.dtype.is_string:
        w = int(pad_strings(c).chars.shape[1])
        return Column(c.dtype, zeros((n,), torch.int32, c.device), None,
                      zeros((n, w), torch.uint8, c.device))
    return Column(c.dtype, zeros((n, *c.data.shape[1:]), c.data.dtype,
                                 c.device))


def _dense_ids(gid: torch.Tensor, m: int) -> torch.Tensor:
    """``gid`` as int64 slots with every id outside [0, m) sent to the
    discard slot m. The range check runs in the input's own dtype before
    any narrowing or widening, so an int64 id past 2^31 cannot wrap into
    [0, m). (A Python scalar past the dtype's range would wrap in the
    compare, so ``gid < m`` is only tested where m is in range.)"""
    ok = gid >= 0
    if m <= torch.iinfo(gid.dtype).max:
        ok = ok & (gid < m)
    return torch.where(ok, gid.to(torch.int64), m)


def dense_id_counts(gid: torch.Tensor, m: int) -> torch.Tensor:
    """COUNT(*) per dense group id: int64[m], entry g the number of rows
    whose ``gid`` is g. Ids outside [0, m) (filtered, invalid or padding
    rows) count nowhere."""
    return torch.bincount(_dense_ids(gid, m), minlength=m + 1)[:m]


def dense_id_sums(gid: torch.Tensor, values: torch.Tensor,
                  m: int) -> torch.Tensor:
    """SUM(values) per dense group id: int64[m], exact and wrapping like
    any int64 sum (``index_add_`` on int64, never ``bincount``'s float64
    weights). Rows whose id is outside [0, m) add nowhere; callers zero
    the values of null rows first (SQL null semantics)."""
    ids = _dense_ids(gid, m)
    out = torch.zeros((m + 1,), dtype=torch.int64, device=gid.device)
    out.index_add_(0, ids, values.to(torch.int64))
    return out[:m]
