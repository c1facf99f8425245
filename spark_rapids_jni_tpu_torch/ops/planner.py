"""Bounded-domain groupby planning (counterpart of the bounded part of
``spark_rapids_jni_tpu/ops/planner.py``).

When every key column's candidate values are known at plan time (DDL
facts such as TPC-H's CHAR(1) flag domains), ``plan_groupby`` lowers the
groupby to ``groupby_aggregate_bounded``: no sort, no gather, one
streaming pass. ``domain_miss`` is the runtime escape hatch: out-of-domain
data must re-plan, it is never silently dropped.

Only the bounded lowering is ported. The general sort-based lowering
raises ``NotImplementedError`` until the sort and the general groupby are
ported (ROADMAP.md, Queue 1 item 6).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from spark_rapids_jni_tpu_torch.columnar import Table
from spark_rapids_jni_tpu_torch.ops.groupby import groupby_aggregate_bounded


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
