"""Planner-declared plans (counterpart of part of
``spark_rapids_jni_tpu/ops/planner.py``).

- Bounded groupby: when every key column's candidate values are known at
  plan time (DDL facts such as TPC-H's CHAR(1) flag domains),
  ``plan_groupby`` lowers the groupby to ``groupby_aggregate_bounded``:
  no sort, no gather, one streaming pass. ``domain_miss`` is the runtime
  escape hatch: out-of-domain data must re-plan, it is never silently
  dropped. The general sort-based lowering of ``plan_groupby`` is not
  ported yet (ROADMAP.md Queue 1 item 6).
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

from spark_rapids_jni_tpu_torch.columnar import Column, Table
from spark_rapids_jni_tpu_torch.columnar.column import take, zeros
from spark_rapids_jni_tpu_torch.ops.groupby import groupby_aggregate_bounded
from spark_rapids_jni_tpu_torch.ops.sort import gather, int64_value


class Domain(NamedTuple):
    """Planner-declared candidate values for one groupby key column,
    kept sorted so the group output order is ORDER BY ... NULLS LAST.
    ``source`` is provenance ("ddl", "dictionary", ...), never branched
    on."""

    values: tuple
    kind: str  # "scalar" (the only kind ported so far)
    source: str


def scalar_domain(values: Sequence, source: str = "ddl") -> Domain:
    vals = tuple(sorted(set(int(v) for v in values)))
    if not vals:
        raise ValueError("empty domain")
    return Domain(vals, "scalar", source)


class PlannedGroupBy(NamedTuple):
    """Result of ``plan_groupby``: ``table`` rows in key order with
    null-key groups last, ``present`` marking live groups, ``domain_miss``
    the re-plan signal, ``lowered`` the static plan fact and
    ``overflowed`` always False on the bounded plan (its slot count is
    checked at plan time)."""

    table: Table
    present: torch.Tensor
    domain_miss: torch.Tensor
    lowered: str  # "bounded"
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
    bound every key: each key has a scalar ``Domain``, the slot count
    ``prod(len(d)+1)`` fits ``budget`` and every agg is in the
    single-pass set (sum/count/mean/min/max).

    ``row_valid``: bool[n] marking rows that EXIST; non-rows join no
    slot."""
    if len(domains) != len(keys):
        raise ValueError("one Domain (or None) per key required")
    bounded_ok = (
        all(d is not None for d in domains)
        and all(op in ("sum", "count", "mean", "min", "max")
                for _, op in aggs)
        and int(np.prod([len(d.values) + 1 for d in domains])) <= budget
    )
    if not bounded_ok:
        raise NotImplementedError(
            "plan_groupby: the general sort-based lowering is not ported "
            "yet (ROADMAP.md Queue 1 item 6: sort and general groupby)")
    if any(d.kind != "scalar" for d in domains):
        raise NotImplementedError(
            "plan_groupby: string-key domains are not ported yet "
            "(ROADMAP.md Queue 1 item 10: strings)")
    res = groupby_aggregate_bounded(
        table, keys=list(keys), aggs=list(aggs),
        key_domains=[d.values for d in domains], row_valid=row_valid)
    return PlannedGroupBy(res.table, res.present, res.domain_miss,
                          "bounded")


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
    are unmatched, not violations."""
    nb = build.num_rows
    pk = probe.column(probe_key)
    bk = build.column(build_key)
    if not (pk.dtype.is_fixed_width and bk.dtype.is_fixed_width) \
            or pk.dtype.storage_dtype.kind not in ("i", "u") \
            or bk.dtype.storage_dtype.kind not in ("i", "u"):
        raise NotImplementedError(
            "dense PK keys are integers (dictionary-encode first)")
    pdata = int64_value(pk.data)
    in_range = pk.valid_mask() & (pdata >= key_lo) & (pdata <= key_hi)
    if clustered:
        if key_hi - key_lo + 1 != nb:
            raise ValueError(
                f"clustered dense PK needs build rows == key range "
                f"({nb} != {key_hi - key_lo + 1})")
        pos = (pdata - key_lo).clamp(0, max(nb - 1, 0))
        bkey_at = int64_value(take(bk.data, pos))
        bvalid_at = bk.valid_mask()[pos]
        matched = in_range & bvalid_at & (bkey_at == pdata)
        pk_violation = (in_range & bvalid_at & (bkey_at != pdata)).any()
    else:
        # null keys become the dtype max so the sorted keys are globally
        # monotone; a declared range reaching that max would collide
        bvalid = bk.valid_mask()
        np_dt = bk.dtype.storage_dtype
        dt_max = int(np.iinfo(np_dt).max)
        if key_hi >= dt_max:
            raise ValueError(
                f"dense PK range [{key_lo}, {key_hi}] reaches "
                f"iinfo({np_dt.name}).max, the null sentinel; widen the "
                f"key dtype or shrink the range")
        bdata = int64_value(bk.data)
        top = min(dt_max, (1 << 63) - 1)  # above every in-range key
        skey, perm = torch.sort(torch.where(bvalid, bdata, top), stable=True)
        n_valid = bvalid.to(torch.int64).sum()
        pos0 = torch.searchsorted(skey, pdata)
        safe = pos0.clamp(0, max(nb - 1, 0))
        hit = (pos0 < n_valid) & (skey[safe] == pdata) if nb \
            else torch.zeros_like(in_range)
        pos = perm[safe] if nb else safe
        matched = in_range & hit
        dup = ((skey[1:] == skey[:-1]) & (
            torch.arange(1, nb, device=bk.device) < n_valid)).any()
        oor = (bvalid & ((bdata < key_lo) | (bdata > key_hi))).any()
        pk_violation = dup | oor
    out_cols = list(probe.columns)
    if nb:
        gathered = gather(build, pos).columns
    else:
        gathered = [Column(c.dtype, zeros(
            (pos.shape[0], *c.data.shape[1:]), c.data.dtype, c.device))
            for c in build.columns]
    for c in gathered:
        out_cols.append(Column(c.dtype, c.data, c.valid_mask() & matched))
    return DensePkJoinResult(Table(out_cols), matched,
                             matched.to(torch.int64).sum(), pk_violation)


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
