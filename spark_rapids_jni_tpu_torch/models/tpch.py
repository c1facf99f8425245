"""TPC-H workload pipelines (counterpart of
``spark_rapids_jni_tpu/models/tpch.py``, q1 and q3 parts).

TPC-H q1 (pricing summary report):

    SELECT l_returnflag, l_linestatus,
           sum(l_quantity), sum(l_extendedprice),
           sum(l_extendedprice*(1-l_discount)),
           sum(l_extendedprice*(1-l_discount)*(1+l_tax)),
           avg(l_quantity), avg(l_extendedprice), avg(l_discount), count(*)
    FROM lineitem WHERE l_shipdate <= date '1998-12-01' - 90 days
    GROUP BY l_returnflag, l_linestatus ORDER BY l_returnflag, l_linestatus

Money columns use decimal64(-2) (the spec's DECIMAL(12,2)). q1, q3 and
q6 are the reference's plans (``runtime/fusion.py``) and run through
``fusion.execute``, as there: the general q1 is the filter/derive work
table, the sort-based groupby with the plan's group budget, and the
ORDER BY; the planned q1 lowers the groupby through ``plan_groupby``
with the DDL flag domains. The other TPC-H plans compose their
operators directly, as the reference's do. The fused single-kernel q1
is ``ops/kernels/q1.py::tpch_q1_pallas``.
The general q1 also takes STRING flags (``lineitem_table_strings``).
TPC-H q3, q6, q5, q12, q14, q4, q19, q17, q10 and q13 are further down.
"""

from __future__ import annotations

import numpy as np

from typing import NamedTuple

import torch

from spark_rapids_jni_tpu_torch import types as t
from spark_rapids_jni_tpu_torch.columnar import Column, Table
from spark_rapids_jni_tpu_torch.ops.groupby import (
    GroupByResult,
    bounded_group_layout,
    bounded_lanes,
    dense_gid,
    groupby_aggregate,
)
from spark_rapids_jni_tpu_torch.ops.join import (
    _sorted_valid_keys,
    apply_join_maps,
    join,
)
from spark_rapids_jni_tpu_torch.ops.planner import (
    PlannedGroupBy,
    bounded_accumulate_inputs,
    dense_pk_join,
    plan_groupby,
    scalar_domain,
    string_domain,
)
from spark_rapids_jni_tpu_torch.ops.sort import gather, sort_order, sort_table
from spark_rapids_jni_tpu_torch.ops.strings import (
    gather_strings,
    like,
    pad_strings,
    static_strings,
)
from spark_rapids_jni_tpu_torch.ops.table_ops import trim_table
from spark_rapids_jni_tpu_torch.runtime import fusion, rtfilter
from spark_rapids_jni_tpu_torch.utils.platform import resolve_device

# lineitem columns used by q1 (positions in the table below)
L_QUANTITY = 0
L_EXTENDEDPRICE = 1
L_DISCOUNT = 2
L_TAX = 3
L_RETURNFLAG = 4
L_LINESTATUS = 5
L_SHIPDATE = 6

# 1998-12-01 minus 90 days, in days since epoch (Spark DateType encoding)
_Q1_CUTOFF_DAYS = 10560

# q1 groups by two one-byte flags: at most 3*2 real groups plus the
# null-key pseudo-group, so the general plan's group budget is 64
_Q1_GROUP_BUDGET = 64

# The q1 aggregate plan over _q1_work_table's column layout.
_Q1_AGGS = [
    (2, "sum"),    # sum_qty
    (3, "sum"),    # sum_base_price
    (5, "sum"),    # sum_disc_price
    (6, "sum"),    # sum_charge
    (2, "mean"),   # avg_qty
    (3, "mean"),   # avg_price
    (4, "mean"),   # avg_disc
    (2, "count"),  # count_order
]

# TPC-H DDL domains for the q1 flags (the spec fixes returnflag to
# 'A'/'N'/'R' and linestatus to 'F'/'O').
_Q1_RF_DOMAIN = (ord("A"), ord("N"), ord("R"))
_Q1_LS_DOMAIN = (ord("F"), ord("O"))

LINEITEM_SCHEMA = [
    t.decimal64(-2),      # l_quantity  DECIMAL(12,2)
    t.decimal64(-2),      # l_extendedprice
    t.decimal64(-2),      # l_discount
    t.decimal64(-2),      # l_tax
    t.INT8,               # l_returnflag  ('A','N','R' as bytes)
    t.INT8,               # l_linestatus  ('F','O')
    t.TIMESTAMP_DAYS,     # l_shipdate
]


def lineitem_table(num_rows: int, seed: int = 0, device=None) -> Table:
    """Synthetic lineitem batch with TPC-H-like value distributions: the
    reference generator's numpy draws, in the same order, so the same
    seed gives the same rows. ``device=None`` puts the columns on the
    CUDA device and raises when there is none."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    qty = rng.integers(100, 51_00, num_rows).astype(np.int64)       # 1..50 qty
    price = rng.integers(90_000, 10_500_000, num_rows).astype(np.int64)
    disc = rng.integers(0, 11, num_rows).astype(np.int64)           # 0.00-0.10
    tax = rng.integers(0, 9, num_rows).astype(np.int64)             # 0.00-0.08
    rflag = rng.choice(np.frombuffer(b"ANR", dtype=np.int8), num_rows)
    lstatus = rng.choice(np.frombuffer(b"FO", dtype=np.int8), num_rows)
    shipdate = rng.integers(8400, 10957, num_rows).astype(np.int32)
    arrays = (qty, price, disc, tax, rflag, lstatus, shipdate)
    return Table([
        Column.from_numpy(a, dt, device=device)
        for a, dt in zip(arrays, LINEITEM_SCHEMA)
    ])


def lineitem_table_strings(num_rows: int, seed: int = 0,
                           device=None) -> Table:
    """``lineitem_table`` with STRING returnflag and linestatus columns
    (CHAR(1) in TPC-H), the reference's ``lineitem_table_strings`` built
    on the device: each flag is one byte, so the offsets are 0..n and
    the chars are the flag bytes."""
    base = lineitem_table(num_rows, seed, device)
    cols = list(base.columns)
    offsets = torch.arange(num_rows + 1, dtype=torch.int32,
                           device=cols[0].device)
    for i in (L_RETURNFLAG, L_LINESTATUS):
        cols[i] = Column(t.STRING, offsets, None,
                         chars=cols[i].data.view(torch.uint8))
    return Table(cols)


def _q1_work_table(lineitem: Table) -> Table:
    """Shared q1 front half: WHERE filter + derived decimal columns.

    The filter keeps shapes static by masking validity instead of
    compacting rows (masked rows fall out of every null-skipping
    aggregate). STRING keys are padded first (a read of the longest row
    to the host)."""
    ship = lineitem.column(L_SHIPDATE)
    keep = (ship.data <= _Q1_CUTOFF_DAYS) & ship.valid_mask()

    def masked(col: Column) -> Column:
        return Column(col.dtype, col.data, col.valid_mask() & keep)

    qty = masked(lineitem.column(L_QUANTITY))
    price = masked(lineitem.column(L_EXTENDEDPRICE))
    disc = masked(lineitem.column(L_DISCOUNT))
    tax = masked(lineitem.column(L_TAX))

    # disc_price = price * (1 - disc): decimal multiply at scale -4.
    # Null in any operand nulls the product (SQL three-valued arithmetic).
    dp_valid = price.valid_mask() & disc.valid_mask()
    disc_price = Column(
        t.decimal64(-4), price.data * (100 - disc.data), dp_valid
    )
    # charge = disc_price * (1 + tax): scale -6
    charge = Column(
        t.decimal64(-6), disc_price.data * (100 + tax.data),
        dp_valid & tax.valid_mask(),
    )

    # Masked rows must not create key groups: zero out key bytes for them.
    def masked_key(c: Column) -> Column:
        if c.dtype.is_string:
            p = pad_strings(c)
            return Column(p.dtype, p.data.masked_fill(~keep, 0), keep,
                          chars=p.chars.masked_fill(~keep[:, None], 0))
        return Column(c.dtype, c.data.masked_fill(~keep, 0), keep)

    return Table(
        [
            masked_key(lineitem.column(L_RETURNFLAG)),
            masked_key(lineitem.column(L_LINESTATUS)),
            qty,
            price,
            disc,
            disc_price,
            charge,
        ]
    )


def _q1_planned_plan() -> fusion.Plan:
    """q1 with PLANNER-DECLARED key domains, the reference's plan: the
    work table, then the groupby lowered by ``plan_groupby`` onto the
    sort-free bounded plan (the accumulate kernel on the card)."""
    return fusion.Plan("tpch_q1_planned", fusion.GroupBy(
        fusion.Project(fusion.Scan("lineitem"), _q1_work_table),
        (0, 1), tuple(_Q1_AGGS),
        domains=(scalar_domain(_Q1_RF_DOMAIN),
                 scalar_domain(_Q1_LS_DOMAIN)),
        label="plan"))


def tpch_q1_planned_result(lineitem: Table) -> PlannedGroupBy:
    """q1 with PLANNER-DECLARED key domains: the flag domains come from
    the TPC-H DDL, so grouping needs no sort — one streaming pass
    (groupby_aggregate_bounded, the accumulate kernel on the card) — and
    the output order is static (real groups lexicographic, null groups
    last). Returns the planner result so callers can observe
    ``domain_miss``."""
    out = fusion.execute(_q1_planned_plan(), {"lineitem": lineitem})
    res = PlannedGroupBy(out.table, out.meta["plan.present"],
                         out.meta["plan.domain_miss"],
                         out.meta["plan.lowered"],
                         out.meta["plan.overflowed"])
    if res.lowered != "bounded":
        raise AssertionError("q1's declared domains must lower to the "
                             "bounded plan")
    return res


def tpch_q1_planned(lineitem: Table) -> Table:
    """Planned q1, table only. Out-of-domain key bytes fold into the
    null-key group without signal here; callers that must detect that use
    ``tpch_q1_planned_result().domain_miss``."""
    return tpch_q1_planned_result(lineitem).table


def q1_accumulate_inputs(lineitem: Table):
    """(gid, lanes, m): the bounded accumulate kernel's inputs in planned
    q1 over ``lineitem``, for timing and checking the kernel alone."""
    work = _q1_work_table(lineitem)
    domains = [scalar_domain(_Q1_RF_DOMAIN).values,
               scalar_domain(_Q1_LS_DOMAIN).values]
    _, m, _, _ = bounded_group_layout([len(d) for d in domains])
    gid, _ = dense_gid(work, (0, 1), domains, m, None)
    return gid, bounded_lanes(work, _Q1_AGGS).lanes, m


def tpch_q1_numpy(lineitem: Table) -> dict:
    """Host oracle: same query in numpy, keyed by (returnflag, linestatus)."""
    def host(i):
        return lineitem.column(i).data.cpu().numpy()

    keep = host(L_SHIPDATE) <= _Q1_CUTOFF_DAYS
    # one stable sort by group (int16 keys: numpy's radix sort) puts
    # each group's rows in one block, in their row order
    gid = (host(L_RETURNFLAG)[keep].astype(np.int16) << 8) \
        | host(L_LINESTATUS)[keep].astype(np.uint8)
    order = np.argsort(gid, kind="stable")
    gid = gid[order]
    qty, price, disc, tax = (host(c)[keep][order] for c in (
        L_QUANTITY, L_EXTENDEDPRICE, L_DISCOUNT, L_TAX))
    starts = np.flatnonzero(np.r_[True, gid[1:] != gid[:-1]]) \
        if len(gid) else np.zeros((0,), np.int64)
    out = {}
    for a, b in zip(starts, np.r_[starts[1:], len(gid)]):
        g = slice(a, b)
        dp = price[g] * (100 - disc[g])
        out[(int(gid[a]) >> 8, int(np.int8(gid[a] & 0xFF)))] = {
            "sum_qty": int(qty[g].sum()),
            "sum_base_price": int(price[g].sum()),
            "sum_disc_price": int(dp.sum()),
            "sum_charge": int((dp * (100 + tax[g])).sum()),
            # true values: unscaled decimal(scale -2) means x 10^-2
            "avg_qty": qty[g].mean() * 1e-2,
            "avg_price": price[g].mean() * 1e-2,
            "avg_disc": disc[g].mean() * 1e-2,
            "count": int(b - a),
        }
    return out


class Q1Result(NamedTuple):
    result: GroupByResult  # grouped aggregates, padded; sorted by flag/status


def _q1_plan() -> fusion.Plan:
    """q1's general plan (the reference's ``_q1_plan``): work table ->
    sort-based groupby under the group budget -> ORDER BY flag, status
    with nulls last, so the filtered-out null-key group follows the real
    ones."""
    return fusion.Plan("tpch_q1", fusion.Sort(
        fusion.GroupBy(
            fusion.Project(fusion.Scan("lineitem"), _q1_work_table),
            (0, 1), tuple(_Q1_AGGS), max_groups=_Q1_GROUP_BUDGET,
            label="groupby"),
        (0, 1), nulls_first=(False, False)))


def tpch_q1(lineitem: Table) -> Table:
    """General q1: filter -> derived columns -> groupby -> sort, padded to
    the 64-group budget. On data outside the TPC-H flag domains (64 or
    more distinct byte pairs) the excess groups are dropped; use
    ``tpch_q1_checked`` to turn that into an error."""
    return fusion.execute(_q1_plan(), {"lineitem": lineitem}).table


def tpch_q1_checked(lineitem: Table) -> Table:
    """General q1 that raises instead of silently dropping groups on
    out-of-contract data."""
    res = fusion.execute(_q1_plan(), {"lineitem": lineitem})
    if bool(res.meta["groupby.overflowed"]):
        raise ValueError(
            f"q1 key domain exceeded the plan's group budget "
            f"({int(res.meta['groupby.num_groups'])} > {_Q1_GROUP_BUDGET}): "
            f"the returnflag/linestatus bytes are outside the TPC-H "
            f"contract")
    return res.table


def tpch_q1_planned_checked(lineitem: Table) -> Table:
    """Planned q1 whose domain misses re-plan onto the general sort-based
    q1 instead of dropping rows."""
    res = tpch_q1_planned_result(lineitem)
    if bool(res.domain_miss):
        return tpch_q1_checked(lineitem)
    return res.table


# ---- out-of-core q1: per-chunk partials, merged -----------------------------

# Partial aggregates: sums and counts only, which merge associatively
# across chunks; the averages are finalized from the merged sums and
# counts. Indices refer to _q1_work_table's layout.
_Q1_PARTIAL_AGGS = [
    (2, "sum"),    # sum_qty
    (3, "sum"),    # sum_base_price
    (5, "sum"),    # sum_disc_price
    (6, "sum"),    # sum_charge
    (2, "count"),  # count_qty (also count_order)
    (3, "count"),  # count_price
    (4, "sum"),    # sum_disc
    (4, "count"),  # count_disc
]

# Merge-side aggregates over the partial layout: every lane sums.
_Q1_MERGE_AGGS = tuple((i, "sum") for i in range(2, 10))


def _q1_finalize(merged: Table) -> Table:
    """Merged sums and counts -> the q1 output schema (avg = sum/count,
    the groupby mean's arithmetic, so the bits equal ``tpch_q1``'s)."""
    rf, ls, sq, sp, sdp, sch, cq, cp, sd, cd = merged.columns

    def avg(total: Column, count: Column) -> Column:
        denom = count.data.clamp(min=1).to(torch.float64)
        return Column(
            t.FLOAT64,
            total.data.to(torch.float64) / denom
            * (10.0 ** total.dtype.scale),
            count.valid_mask() & (count.data > 0))

    return Table([rf, ls, sq, sp, sdp, sch, avg(sq, cq), avg(sp, cp),
                  avg(sd, cd), cq])


def _q1_partial_plan() -> fusion.Plan:
    """One chunk's q1 partial (the reference's ``_q1_partial_plan``): the
    work table and the partial groupby under
    ``min(_Q1_GROUP_BUDGET, chunk rows)`` groups (the sort-based
    groupby: no domains, so no kernel)."""
    return fusion.Plan("tpch_q1_partial", fusion.GroupBy(
        fusion.Project(fusion.Scan("chunk"), _q1_work_table),
        (0, 1), tuple(_Q1_PARTIAL_AGGS),
        max_groups=fusion.min_rows_of("chunk", _Q1_GROUP_BUDGET),
        label="partial"))


def _q1_merge_plan() -> fusion.Plan:
    """The stacked partials merged: sum-merge groupby, finalize, ORDER
    BY flag, status with nulls last."""
    return fusion.Plan("tpch_q1_merge", fusion.Sort(
        fusion.Project(
            fusion.GroupBy(fusion.Scan("partials"), (0, 1), _Q1_MERGE_AGGS,
                           label="merge"),
            _q1_finalize),
        (0, 1), nulls_first=(False, False)))


def _q1_partial(chunk: Table) -> Table:
    """A chunk's partial, trimmed to its real groups on the host (the
    chunk boundary, where a dynamic shape costs nothing)."""
    res = fusion.execute(_q1_partial_plan(), {"chunk": chunk})
    if bool(res.meta["partial.overflowed"]):
        raise ValueError(
            "q1 chunk exceeded the plan's group budget "
            f"({_Q1_GROUP_BUDGET}): flag bytes outside the contract")
    return trim_table(res.table, int(res.meta["partial.num_groups"]))


def _q1_merge(partials: Table) -> Table:
    return fusion.execute(_q1_merge_plan(), {"partials": partials}).table


def q1_row_chunked_fns():
    """``(partial_fn, merge_fn)`` of q1 over in-memory row chunks of a
    lineitem table: the algebra ``run_chunked_aggregate`` and the
    degradation ladder's out-of-core rung (``runtime/degrade.py``)
    take."""
    return _q1_partial, _q1_merge


def _money_retyped(chunk: Table, cols) -> Table:
    """``chunk`` with the columns ``cols`` (unscaled INT64 money in the
    file) typed decimal64(-2), the data unchanged."""
    out = list(chunk.columns)
    for i in cols:
        out[i] = Column(t.decimal64(-2), out[i].data, out[i].validity)
    return Table(out)


def tpch_q1_outofcore(path, *, budget_bytes: int, chunk_read_limit: int,
                      spill_budget_bytes: int | None = None,
                      compress_spill: bool = False, prefetch_depth: int = 0,
                      pipeline: bool | None = None, device=None,
                      spill_dir: str | None = None, cancel_token=None,
                      limiter=None):
    """q1 over a Parquet file larger than the device budget: chunked
    row-group reads, a partial per chunk, the partials through a
    SpillStore, the merge and the finalize (the reference's
    ``tpch_q1_outofcore``). The file holds the 7 q1 lineitem columns with
    the 4 money columns as unscaled int64 (bench.py's parquet_q1
    layout), typed decimal64(-2) after the read. Returns an
    ``OutOfCoreResult`` whose ``.table`` equals ``tpch_q1`` of the whole
    file.

    ``budget_bytes`` must cover one chunk and the merge window serially;
    with ``prefetch_depth`` > 0, ``prefetch_depth + 2`` chunks. With
    ``pipeline`` (None follows ``pipeline.enabled``) the reader's decode
    thunks run in a thread pool and admission blocks instead of raising;
    the bits stay the serial path's. ``spill_dir`` puts the spilled
    partials on disk (default: ``memory.spill_dir``). ``limiter`` lends
    a ``MemoryLimiter`` (its budget instead of ``budget_bytes``), so the
    caller can read its peak and usage after the run."""
    from spark_rapids_jni_tpu_torch.parquet.reader import (
        ParquetChunkedReader,
    )
    from spark_rapids_jni_tpu_torch.runtime.memory import (
        MemoryLimiter,
        SpillStore,
    )
    from spark_rapids_jni_tpu_torch.runtime.outofcore import (
        run_chunked_aggregate,
    )

    if limiter is None:
        limiter = MemoryLimiter(budget_bytes)
    spill = SpillStore(spill_budget_bytes if spill_budget_bytes is not None
                       else budget_bytes, compress_spill=compress_spill,
                       spill_dir=spill_dir)

    def partial_fn(chunk: Table) -> Table:
        return _q1_partial(_money_retyped(chunk, range(4)))

    reader = ParquetChunkedReader(path, chunk_read_limit=chunk_read_limit,
                                  device=resolve_device(device))
    # the reader itself, so the pipeline can take its decode thunks
    try:
        return run_chunked_aggregate(
            reader, partial_fn, _q1_merge, limiter=limiter, spill=spill,
            prefetch_depth=prefetch_depth, pipeline=pipeline,
            cancel_token=cancel_token)
    finally:
        spill.close()


# ---- TPC-H q3 (shipping priority): join + groupby + order-by ---------------
#
#   SELECT l_orderkey, sum(l_extendedprice*(1-l_discount)) AS revenue,
#          o_orderdate, o_shippriority
#   FROM customer, orders, lineitem
#   WHERE c_mktsegment = :seg AND c_custkey = o_custkey
#     AND l_orderkey = o_orderkey
#     AND o_orderdate < :cutoff AND l_shipdate > :cutoff
#   GROUP BY l_orderkey, o_orderdate, o_shippriority
#   ORDER BY revenue DESC, o_orderdate LIMIT 10

_Q3_CUTOFF_DAYS = 9204  # 1995-03-15
N_SEGMENTS = 5          # TPC-H market segments

# orders columns
O_ORDERKEY, O_CUSTKEY, O_ORDERDATE, O_SHIPPRIORITY = 0, 1, 2, 3
# customer columns
C_CUSTKEY, C_MKTSEGMENT = 0, 1
# q3 lineitem columns
L3_ORDERKEY, L3_EXTENDEDPRICE, L3_DISCOUNT, L3_SHIPDATE = 0, 1, 2, 3


def customer_table(num_rows: int, seed: int = 0, device=None) -> Table:
    """customer: [c_custkey 1..n, c_mktsegment in 0..4]. The reference
    generator's numpy draws; ``device=None`` means CUDA."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    return Table([
        Column.from_numpy(np.arange(1, num_rows + 1, dtype=np.int64),
                          device=device),
        Column.from_numpy(
            rng.integers(0, N_SEGMENTS, num_rows).astype(np.int8), t.INT8,
            device=device),
    ])


def orders_table(num_rows: int, num_customers: int, seed: int = 1,
                 device=None) -> Table:
    """orders: [o_orderkey 1..n, o_custkey, o_orderdate, o_shippriority]."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    return Table([
        Column.from_numpy(np.arange(1, num_rows + 1, dtype=np.int64),
                          device=device),
        Column.from_numpy(
            rng.integers(1, num_customers + 1, num_rows).astype(np.int64),
            device=device),
        Column.from_numpy(
            rng.integers(8400, 10957, num_rows).astype(np.int32),
            t.TIMESTAMP_DAYS, device=device),
        Column.from_numpy(rng.integers(0, 2, num_rows).astype(np.int32),
                          device=device),
    ])


def lineitem_q3_table(num_rows: int, num_orders: int, seed: int = 2,
                      device=None) -> Table:
    """q3's lineitem: [l_orderkey, l_extendedprice, l_discount,
    l_shipdate]."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    return Table([
        Column.from_numpy(
            rng.integers(1, num_orders + 1, num_rows).astype(np.int64),
            device=device),
        Column.from_numpy(
            rng.integers(90_000, 10_500_000, num_rows).astype(np.int64),
            t.decimal64(-2), device=device),
        Column.from_numpy(
            rng.integers(0, 11, num_rows).astype(np.int64), t.decimal64(-2),
            device=device),
        Column.from_numpy(
            rng.integers(8400, 10957, num_rows).astype(np.int32),
            t.TIMESTAMP_DAYS, device=device),
    ])


def _null_where(c: Column, drop: torch.Tensor) -> Column:
    return Column(c.dtype, c.data, c.valid_mask() & ~drop, c.chars)


def _q3_cust_fn(customer: Table, segment: int) -> Table:
    """Segment-filtered customer keys."""
    return Table([_null_where(
        customer.column(C_CUSTKEY),
        customer.column(C_MKTSEGMENT).data != segment)])


def _q3_orders_fn(orders: Table, cutoff: int) -> Table:
    """Date-filtered orders with the custkey join lane first."""
    okey = _null_where(orders.column(O_CUSTKEY),
                       orders.column(O_ORDERDATE).data >= cutoff)
    return Table([okey, orders.column(O_ORDERKEY),
                  orders.column(O_ORDERDATE),
                  orders.column(O_SHIPPRIORITY)])


def _q3_probe_fn(lineitem: Table, cutoff: int) -> Table:
    """Shipdate-filtered lineitem probe with its revenue lane."""
    lkey = _null_where(lineitem.column(L3_ORDERKEY),
                       lineitem.column(L3_SHIPDATE).data <= cutoff)
    price = lineitem.column(L3_EXTENDEDPRICE)
    disc = lineitem.column(L3_DISCOUNT)
    revenue = Column(t.decimal64(-4), price.data * (100 - disc.data),
                     price.valid_mask() & disc.valid_mask())
    return Table([lkey, revenue])


def _q3_build_fn(oc: Table) -> Table:
    """orders x customer join output -> the second join's build side:
    [orderkey (null where unmatched), orderdate, shippriority]."""
    # oc: [o_custkey, o_orderkey, o_orderdate, o_shippriority, c_custkey]
    matched = oc.column(4).valid_mask()
    return Table([_null_where(oc.column(1), ~matched), oc.column(2),
                  oc.column(3)])


def _q3_keyed_fn(j: Table) -> Table:
    """lineitem x orders join output -> the groupby's input
    [l_orderkey, o_orderdate, o_shippriority, revenue], unmatched rows
    null in every lane."""
    # j: [l_orderkey, revenue, o_orderkey, o_orderdate, o_shippriority]
    matched = j.column(2).valid_mask()
    return Table([
        _null_where(j.column(0), ~matched),
        _null_where(j.column(3), ~matched),
        _null_where(j.column(4), ~matched),
        Column(j.column(1).dtype, j.column(1).data,
               j.column(1).valid_mask() & matched),
    ])


def _q3_plan(segment: int, cutoff: int, out_factor: int) -> fusion.Plan:
    """General q3 (the reference's ``_q3_plan``): filter all three
    inputs, orders x customer (capacity: orders rows), lineitem x orders
    (capacity: ``out_factor`` x lineitem rows), the groupby padded to its
    input rows, ORDER BY revenue DESC, o_orderdate, nulls last (ties keep
    the groupby's key order)."""
    cust = fusion.Project(fusion.Scan("customer"), _q3_cust_fn, (segment,))
    ord_n = fusion.Project(fusion.Scan("orders"), _q3_orders_fn, (cutoff,))
    probe = fusion.Project(fusion.Scan("lineitem"), _q3_probe_fn, (cutoff,))
    j1 = fusion.Join(ord_n, cust, (0,), (0,), fusion.rows_of("orders"),
                     label="join1")
    build = fusion.Project(j1, _q3_build_fn)
    j2 = fusion.Join(probe, build, (0,), (0,),
                     fusion.rows_of("lineitem", out_factor), label="join2")
    g = fusion.GroupBy(fusion.Project(j2, _q3_keyed_fn), (0, 1, 2),
                       ((3, "sum"),), label="groupby")
    return fusion.Plan("tpch_q3", fusion.Sort(
        g, (3, 1), ascending=(False, True), nulls_first=(False, False)))


def _q3_bindings(customer: Table, orders: Table, lineitem: Table) -> dict:
    return {"customer": customer, "orders": orders, "lineitem": lineitem}


class Q3Result(NamedTuple):
    result: GroupByResult  # [l_orderkey, o_orderdate, o_shippriority, rev]
    join_total: torch.Tensor  # true lineitem x orders match count
    out_cap: int              # join output bound (check total <= cap)


def join_probe_inputs(plan, bindings: dict, labels) -> list:
    """The probe kernel's inputs at the ``fusion.Join`` nodes of ``plan``
    labelled ``labels``, for timing and checking the kernel alone:
    ``[(build, n_valid, probe), ...]``, each side a sub-plan run through
    ``fusion.execute`` and each build sorted and sentinel-padded as
    ``join`` gives it to the kernel."""
    joins = {n.label: n for n in fusion._topo(plan.root)
             if isinstance(n, fusion.Join)}
    out = []
    for label in labels:
        j = joins[label]
        probe, build = (
            fusion.execute(fusion.Plan(f"{plan.name}.{label}.{side}", node),
                           bindings).table.column(key)
            for side, node, key in (("probe", j.left, j.left_on[0]),
                                    ("build", j.right, j.right_on[0])))
        sorted_build, n_valid, _ = _sorted_valid_keys(build.data,
                                                      build.valid_mask())
        out.append((sorted_build, n_valid, probe.data))
    return out


def q3_probe_inputs(customer: Table, orders: Table, lineitem: Table,
                    segment: int = 0, cutoff: int = _Q3_CUTOFF_DAYS):
    """The join probe kernel's inputs at q3's two joins (sub-plans of
    ``_q3_plan``), for timing and checking the kernel alone: ((build,
    n_valid, probe) of join 1, the same of join 2)."""
    return tuple(join_probe_inputs(
        _q3_plan(segment, cutoff, 2),
        _q3_bindings(customer, orders, lineitem), ("join1", "join2")))


def tpch_q3(customer: Table, orders: Table, lineitem: Table,
            segment: int = 0, cutoff: int = _Q3_CUTOFF_DAYS,
            out_factor: int = 2) -> Q3Result:
    """General q3 through ``fusion.execute`` (``_q3_plan``). Callers
    compact (``num_groups`` rows) and check ``join_total <= out_cap``:
    past it, matches were dropped."""
    res = fusion.execute(_q3_plan(segment, cutoff, out_factor),
                         _q3_bindings(customer, orders, lineitem))
    return Q3Result(GroupByResult(res.table, res.meta["groupby.num_groups"]),
                    res.meta["join2.total"], lineitem.num_rows * out_factor)


class Q3PlannedResult(NamedTuple):
    result: GroupByResult  # [l_orderkey, o_orderdate, o_shippriority, rev]
    join_total: torch.Tensor
    # a dense-PK declaration was violated: re-plan on tpch_q3
    pk_violation: torch.Tensor


def _q3_build2_fn(j1t: Table) -> Table:
    """orders x customer dense-PK output -> the second lookup's build
    side; column 4's validity is the first join's matched mask."""
    # j1t: [o_custkey, o_orderkey, o_orderdate, o_shippriority, c_custkey]
    matched1 = j1t.column(4).valid_mask()
    return Table([_null_where(j1t.column(1), ~matched1), j1t.column(2),
                  j1t.column(3)])


def _q3_planned_keyed_fn(jt: Table) -> Table:
    """Dense-PK lineitem x orders output -> the groupby's input; the build
    columns already carry the matched mask."""
    # jt: [l_orderkey, revenue, o_orderkey, o_orderdate, o_shippriority]
    matched = jt.column(2).valid_mask()
    return Table([
        _null_where(jt.column(0), ~matched),
        jt.column(3),
        jt.column(4),
        Column(jt.column(1).dtype, jt.column(1).data,
               jt.column(1).valid_mask() & matched),
    ])


def _q3_planned_plan(segment: int, cutoff: int) -> fusion.Plan:
    """q3 with planner-declared dense clustered PKs (the reference's
    ``_q3_planned_plan``): both joins are ``DensePkJoin``s over the
    clustered customer and orders scans."""
    cust = fusion.Project(fusion.Scan("customer", bucket=False),
                          _q3_cust_fn, (segment,))
    ord_n = fusion.Project(fusion.Scan("orders", bucket=False),
                           _q3_orders_fn, (cutoff,))
    probe = fusion.Project(fusion.Scan("lineitem"), _q3_probe_fn, (cutoff,))
    # join 1: each order row looks up its customer (custkey 1..|C|)
    j1 = fusion.DensePkJoin(ord_n, cust, 0, 0, 1,
                            fusion.rows_of("customer"), clustered=True,
                            label="pk1")
    build2 = fusion.Project(j1, _q3_build2_fn)
    # join 2: each lineitem row looks up its order (orderkey 1..|O|)
    j2 = fusion.DensePkJoin(probe, build2, 0, 0, 1,
                            fusion.rows_of("orders"), clustered=True,
                            label="pk2")
    g = fusion.GroupBy(fusion.Project(j2, _q3_planned_keyed_fn), (0, 1, 2),
                       ((3, "sum"),), label="groupby")
    return fusion.Plan("tpch_q3_planned", fusion.Sort(
        g, (3, 1), ascending=(False, True), nulls_first=(False, False)))


def tpch_q3_planned(customer: Table, orders: Table, lineitem: Table,
                    segment: int = 0,
                    cutoff: int = _Q3_CUTOFF_DAYS) -> Q3PlannedResult:
    """q3 with PLANNER-DECLARED dense clustered primary keys (custkey =
    1..|C| in customer, orderkey = 1..|O| in orders, the TPC-H DDL and
    load-order facts): both joins are arithmetic plus a gather, with no
    join kernel and no capacity. One output row per lineitem row; the
    groupby stays sort-based."""
    res = fusion.execute(_q3_planned_plan(segment, cutoff),
                         _q3_bindings(customer, orders, lineitem))
    return Q3PlannedResult(
        GroupByResult(res.table, res.meta["groupby.num_groups"]),
        res.meta["pk2.total"],
        res.meta["pk1.pk_violation"] | res.meta["pk2.pk_violation"])


def _q3_partial_plan(cutoff: int) -> fusion.Plan:
    """One lineitem chunk's q3 partial (the reference's
    ``_q3_partial_plan``): the probe projection, the clustered dense-PK
    lookup into the resident ``build2`` (an exact scan: the clustered
    layout declares build rows == the key range), and the revenue
    partial groupby padded to the chunk's rows."""
    probe = fusion.Project(fusion.Scan("chunk"), _q3_probe_fn, (cutoff,))
    j2 = fusion.DensePkJoin(probe, fusion.Scan("build2", bucket=False),
                            0, 0, 1, fusion.rows_of("build2"),
                            clustered=True, label="pk2")
    return fusion.Plan("tpch_q3_partial", fusion.GroupBy(
        fusion.Project(j2, _q3_planned_keyed_fn), (0, 1, 2), ((3, "sum"),),
        max_groups=fusion.rows_of("chunk"), label="partial"))


def _q3_merge_plan() -> fusion.Plan:
    """The stacked q3 partials merged: sum-merge groupby, ORDER BY
    revenue DESC, o_orderdate (the null-key rows are trimmed on the
    host)."""
    return fusion.Plan("tpch_q3_merge", fusion.Sort(
        fusion.GroupBy(fusion.Scan("partials"), (0, 1, 2), ((3, "sum"),),
                       label="merge"),
        (3, 1), ascending=(False, True), nulls_first=(False, False)))


def _q3_merge(partials: Table) -> Table:
    srt = fusion.execute(_q3_merge_plan(), {"partials": partials}).table
    return trim_table(srt, int(srt.column(0).valid_mask().sum()))


def tpch_q3_outofcore(path, customer: Table, orders: Table, *,
                      budget_bytes: int, chunk_read_limit: int,
                      segment: int = 0, cutoff: int = _Q3_CUTOFF_DAYS,
                      prefetch_depth: int = 0, pipeline: bool | None = None,
                      spill_budget_bytes: int | None = None,
                      compress_spill: bool = False,
                      spill_dir: str | None = None, cancel_token=None,
                      limiter=None):
    """q3 over a lineitem Parquet file larger than the device budget (the
    reference's ``tpch_q3_outofcore``): customer and orders stay
    resident; the orders x customer lookup runs once into the resident
    build side; lineitem streams in row-group chunks, each joined by the
    clustered dense-PK lookup and partial-aggregated by orderkey; the
    trimmed partials merge at the end. File schema: [l_orderkey int64,
    l_extendedprice int64, l_discount int64, l_shipdate date32], the
    money typed decimal64(-2) after the read. Returns an
    ``OutOfCoreResult`` whose ``.table`` holds the valid q3 groups in the
    query's order.

    With ``rtfilter.enabled`` (off by default) and the learned gate's
    consent (``rtfilter.decide("tpch_q3_outofcore", "pk2", ...)``), the
    resident build side's order keys go into a bloom filter once, and
    every lineitem chunk is pruned of the rows whose order key it proves
    absent before the chunk is reserved and staged (``rtfilter.
    pruned_chunks``): fewer rows reserved, staged and joined, the same
    result. The gate and the filter's size take the build side's valid
    keys (one host read), where the reference takes its row count: the
    build is one row per order, most of them nulled by the date and
    segment predicates. ``spill_budget_bytes`` (default
    ``budget_bytes``), ``compress_spill`` and ``spill_dir`` shape the
    partials' SpillStore; ``limiter`` lends a ``MemoryLimiter``, as in
    ``tpch_q1_outofcore``."""
    from spark_rapids_jni_tpu_torch.parquet.reader import (
        ParquetChunkedReader,
    )
    from spark_rapids_jni_tpu_torch.runtime.memory import (
        MemoryLimiter,
        SpillStore,
    )
    from spark_rapids_jni_tpu_torch.runtime.outofcore import (
        run_chunked_aggregate,
    )

    if limiter is None:
        limiter = MemoryLimiter(budget_bytes)
    spill = SpillStore(spill_budget_bytes if spill_budget_bytes is not None
                       else budget_bytes, compress_spill=compress_spill,
                       spill_dir=spill_dir)
    # the resident build side, once: orders x customer by the clustered
    # custkey lookup, the date and segment predicates pushed in
    j1 = dense_pk_join(_q3_orders_fn(orders, cutoff),
                       _q3_cust_fn(customer, segment), 0, 0, 1,
                       customer.num_rows, clustered=True)
    if bool(j1.pk_violation):
        raise ValueError("customer PK declaration violated")
    build2 = _q3_build2_fn(j1.table)
    bkey = build2.column(0)
    n_keys = int(bkey.valid_mask().sum())
    decision = rtfilter.decide("tpch_q3_outofcore", "pk2", n_keys)

    def partial_fn(chunk: Table) -> Table:
        res = fusion.execute(_q3_partial_plan(cutoff),
                             {"chunk": _money_retyped(chunk, (1, 2)),
                              "build2": build2})
        if bool(res.meta["pk2.pk_violation"]):
            raise ValueError("orders PK declaration violated")
        return trim_table(res.table, int(res.meta["partial.num_groups"]))

    chunks = ParquetChunkedReader(
        path, chunk_read_limit=chunk_read_limit,
        device=customer.columns[0].device)
    if decision.apply:
        bf = rtfilter.build_filter(bkey.data, bkey.valid_mask(),
                                   expected_items=n_keys)
        chunks = rtfilter.pruned_chunks(chunks, bf, L3_ORDERKEY,
                                        plan_name="tpch_q3_outofcore",
                                        label="pk2")
    try:
        return run_chunked_aggregate(
            chunks, partial_fn, _q3_merge, limiter=limiter, spill=spill,
            prefetch_depth=prefetch_depth, pipeline=pipeline,
            cancel_token=cancel_token)
    finally:
        spill.close()


def tpch_q3_oracle(customer: Table, orders: Table, lineitem: Table,
                   segment: int = 0,
                   cutoff: int = _Q3_CUTOFF_DAYS) -> dict:
    """Host oracle in numpy, vectorized: the q3 groups as arrays
    ``orderkey, revenue, orderdate, shippriority`` in the query's order
    (revenue desc, orderdate asc, then orderkey asc, the groupby's key
    order). A key repeated among the qualifying orders takes its last
    row, as the reference's dict oracle does."""
    def host(tbl, i):
        return tbl.column(i).data.cpu().numpy()

    good_cust = host(customer, C_CUSTKEY)[
        host(customer, C_MKTSEGMENT) == segment]
    keep = (host(orders, O_ORDERDATE) < cutoff) \
        & _host_isin(host(orders, O_CUSTKEY), good_cust)
    okey = host(orders, O_ORDERKEY)[keep]
    ukey, first = np.unique(okey[::-1], return_index=True)
    last = len(okey) - 1 - first
    odate = host(orders, O_ORDERDATE)[keep][last]
    oprio = host(orders, O_SHIPPRIORITY)[keep][last]

    lmask = host(lineitem, L3_SHIPDATE) > cutoff
    lkey = host(lineitem, L3_ORDERKEY)[lmask]
    rev = host(lineitem, L3_EXTENDEDPRICE)[lmask] \
        * (100 - host(lineitem, L3_DISCOUNT)[lmask])
    hit, pos = _host_lookup(ukey, np.arange(len(ukey)), lkey)
    order = np.argsort(lkey[hit], kind="stable")
    gkey, grev, gpos = lkey[hit][order], rev[hit][order], pos[hit][order]
    starts = np.flatnonzero(np.r_[True, gkey[1:] != gkey[:-1]]) \
        if len(gkey) else np.zeros((0,), np.int64)
    keys = gkey[starts]
    revenue = np.add.reduceat(grev, starts) if len(gkey) else grev[:0]
    date, prio = odate[gpos[starts]], oprio[gpos[starts]]
    final = np.lexsort((keys, date, -revenue))
    return {"orderkey": keys[final], "revenue": revenue[final],
            "orderdate": date[final], "shippriority": prio[final]}


def tpch_q3_numpy(customer: Table, orders: Table, lineitem: Table,
                  segment: int = 0, cutoff: int = _Q3_CUTOFF_DAYS) -> dict:
    """Host oracle: {orderkey: (revenue, orderdate, shippriority)}."""
    o = tpch_q3_oracle(customer, orders, lineitem, segment, cutoff)
    return {int(k): (int(r), int(d), int(p)) for k, r, d, p in zip(
        o["orderkey"], o["revenue"], o["orderdate"], o["shippriority"])}


# ---- string columns of the generators, and host helpers of the oracles -----

def _vocab_strings(vocab, idx: np.ndarray, device) -> Column:
    """The Arrow STRING column whose row i is ``vocab[idx[i]]``, built on
    ``device`` from the indices (no Python list of rows): the rows'
    vocabulary bytes, padded, then compacted. Its offsets and chars are
    the bytes ``Column.from_pylist`` gives for the same rows."""
    lens, mat = static_strings(vocab, device)
    idx_t = torch.from_numpy(np.asarray(idx, np.int64)).to(device)
    row_lens, rows = lens[idx_t], mat[idx_t]
    chars = rows[torch.arange(rows.shape[1], dtype=torch.int32,
                              device=device)[None, :] < row_lens[:, None]]
    offsets = torch.zeros((idx_t.shape[0] + 1,), dtype=torch.int32,
                          device=device)
    offsets[1:] = torch.cumsum(row_lens, 0)
    return Column(t.STRING, offsets, None, chars=chars)


def _host(tbl: Table, i: int) -> np.ndarray:
    return tbl.column(i).data.cpu().numpy()


def _host_valid(tbl: Table, i: int) -> np.ndarray:
    return tbl.column(i).valid_mask().cpu().numpy()


def _host_strings(col: Column, rows=None) -> tuple:
    """(int32 lengths, uint8 (n, W) zero-padded bytes, validity) of a
    STRING column's rows (all, or those of the bool mask ``rows``), laid
    out on the host from the column's own buffers: the oracles share no
    code with the plans' device layout. W is the longest such row (at
    least 1)."""
    valid = col.valid_mask().cpu().numpy()
    if col.is_padded_string:
        lens, mat = col.data.cpu().numpy(), col.chars.cpu().numpy()
        if rows is not None:
            lens, mat, valid = lens[rows], mat[rows], valid[rows]
        return lens, mat, valid
    offsets = col.data.cpu().numpy().astype(np.int64)
    chars = col.chars.cpu().numpy()
    starts, lens = offsets[:-1], np.diff(offsets).astype(np.int32)
    if rows is not None:
        starts, lens, valid = starts[rows], lens[rows], valid[rows]
    mat = np.zeros((len(lens), max(int(lens.max(initial=0)), 1)), np.uint8)
    for j in range(mat.shape[1]):  # one byte column at a time
        has = lens > j
        mat[has, j] = chars[starts[has] + j]
    return lens, mat, valid


def _host_codes(col: Column, values) -> np.ndarray:
    """Per row, the index in ``values`` of the row's string (-1 for none
    and for null rows), on the host. An Arrow column compares only the
    rows of each value's length, a byte at a time."""
    if not col.is_padded_string:
        offsets = col.data.cpu().numpy().astype(np.int64)
        chars = col.chars.cpu().numpy()
        starts, lens = offsets[:-1], np.diff(offsets)
        codes = np.full(lens.shape, -1, np.int64)
        for k, v in enumerate(values):
            b = v.encode()
            rows = np.flatnonzero((lens == len(b)) & (codes < 0))
            for j, byte in enumerate(b):
                rows = rows[chars[starts[rows] + j] == byte]
            codes[rows] = k
        return np.where(col.valid_mask().cpu().numpy(), codes, -1)
    lens, mat, valid = _host_strings(col)
    codes = np.full(lens.shape, -1, np.int64)
    for k, v in enumerate(values):
        b = np.frombuffer(v.encode(), np.uint8)
        if len(b) > mat.shape[1]:
            continue
        hit = (lens == len(b)) & (mat[:, :len(b)] == b).all(1)
        codes[hit & (codes < 0)] = k
    return np.where(valid, codes, -1)


def _host_lookup(keys: np.ndarray, values: np.ndarray, probe: np.ndarray):
    """(found, value) of each probe key in ``keys``; a repeated key takes
    its last row's value, as a Python dict built row by row does.
    Compact keys (a range at most 16 times their count, or under 2^24)
    go through a direct-address table, one read per probe; others
    through a search of the sorted probes (a search per random probe
    misses the cache at every step)."""
    if (keys[1:] > keys[:-1]).all():  # sorted and unique already
        ukey, vals = keys, values
    else:
        ukey, first = np.unique(keys[::-1], return_index=True)
        vals = values[::-1][first]
    pos = np.full(probe.shape, -1, np.int64)
    if len(ukey):
        lo, hi = int(ukey[0]), int(ukey[-1])
        if hi - lo < max(16 * len(ukey), 1 << 24):
            slot = np.full(hi - lo + 1, -1, np.int64)
            slot[(ukey - lo).astype(np.int64)] = np.arange(len(ukey))
            inside = (probe >= lo) & (probe <= hi)
            pos[inside] = slot[(probe[inside] - lo).astype(np.int64)]
        else:
            order = np.argsort(probe, kind="stable")
            at = np.searchsorted(ukey, probe[order])
            safe = np.minimum(at, len(ukey) - 1)
            pos[order] = np.where(ukey[safe] == probe[order], safe, -1)
    found = pos >= 0
    out = np.zeros(probe.shape, values.dtype)
    out[found] = vals[pos[found]]
    return found, out


def _host_isin(probe: np.ndarray, keys: np.ndarray) -> np.ndarray:
    """``np.isin(probe, keys)``; compact integer keys (as in
    :func:`_host_lookup`) go through a direct-address table, one read
    per probe, in place of ``np.isin``'s sort of both arrays."""
    if not len(keys):
        return np.zeros(probe.shape, bool)
    lo, hi = int(keys.min()), int(keys.max())
    if hi - lo >= max(16 * len(keys), 1 << 24):
        return np.isin(probe, keys)
    table = np.zeros(hi - lo + 1, bool)
    table[(keys - lo).astype(np.int64)] = True
    inside = (probe >= lo) & (probe <= hi)
    out = np.zeros(probe.shape, bool)
    out[inside] = table[(probe[inside] - lo).astype(np.int64)]
    return out


def _host_group_sums(keys: np.ndarray, values: np.ndarray) -> dict:
    """{key: exact int64 sum of its values}."""
    uk, inv = np.unique(keys, return_inverse=True)
    sums = np.zeros(len(uk), np.int64)
    np.add.at(sums, inv, values.astype(np.int64))
    return {int(k): int(v) for k, v in zip(uk, sums)}


# ---- TPC-H q6 (forecasting revenue change): one masked reduction -----------

_Q6_DATE_LO = 8766
_Q6_DATE_HI = 9131
_Q6_DISC_LO = 5
_Q6_DISC_HI = 7
_Q6_QTY_HI = 2400


def _q6_reduce(lineitem: Table, row_valid) -> Table:
    """q6's masked multiply-accumulate as a ``Project(rowwise=False)``
    (the reference's ``_q6_reduce``): its 1-row output is its own row
    space. ``row_valid`` is the region mask, None in the port."""
    del row_valid
    qty = lineitem.column(L_QUANTITY)
    price = lineitem.column(L_EXTENDEDPRICE)
    disc = lineitem.column(L_DISCOUNT)
    ship = lineitem.column(L_SHIPDATE)
    sel = (qty.valid_mask() & price.valid_mask() & disc.valid_mask()
           & ship.valid_mask()
           & (ship.data >= _Q6_DATE_LO) & (ship.data < _Q6_DATE_HI)
           & (disc.data >= _Q6_DISC_LO) & (disc.data <= _Q6_DISC_HI)
           & (qty.data < _Q6_QTY_HI))
    prod = torch.where(sel, price.data * disc.data, 0)
    return Table([Column(t.decimal64(-4), prod.sum().reshape(1),
                         sel.any().reshape(1))])


def tpch_q6(lineitem: Table) -> Column:
    """TPC-H q6: SELECT sum(l_extendedprice * l_discount) WHERE shipdate
    in a year AND discount BETWEEN 0.05 AND 0.07 AND quantity < 24. One
    masked int64 multiply-accumulate over the q1 lineitem, one
    ``Project(rowwise=False)`` plan; a 1-row DECIMAL64(scale -4) column,
    null iff no row matched."""
    plan = fusion.Plan("tpch_q6", fusion.Project(
        fusion.Scan("lineitem"), _q6_reduce, rowwise=False))
    return fusion.execute(plan, {"lineitem": lineitem}).table.column(0)


def _q6_host_selection(lineitem: Table) -> np.ndarray:
    """q6's WHERE on the host arrays."""
    cols = (L_QUANTITY, L_EXTENDEDPRICE, L_DISCOUNT, L_SHIPDATE)
    qty, _, disc, ship = (_host(lineitem, c) for c in cols)
    valid = np.ones(lineitem.num_rows, dtype=bool)
    for c in cols:
        valid &= _host_valid(lineitem, c)
    return (valid & (ship >= _Q6_DATE_LO) & (ship < _Q6_DATE_HI)
            & (disc >= _Q6_DISC_LO) & (disc <= _Q6_DISC_HI)
            & (qty < _Q6_QTY_HI))


def tpch_q6_numpy(lineitem: Table) -> int:
    """Host oracle for q6 (exact Python-int arithmetic, scale -4)."""
    sel = _q6_host_selection(lineitem)
    price = _host(lineitem, L_EXTENDEDPRICE)[sel]
    disc = _host(lineitem, L_DISCOUNT)[sel]
    return int((price.astype(object) * disc.astype(object)).sum())


def tpch_q6_oracle(lineitem: Table) -> int:
    """q6's host oracle, vectorized: the same sum in int64 (exact below
    2^63, which TPC-H value ranges do not approach)."""
    sel = _q6_host_selection(lineitem)
    return int((_host(lineitem, L_EXTENDEDPRICE)[sel]
                * _host(lineitem, L_DISCOUNT)[sel]).sum())


# ---- TPC-H q5 (local supplier volume): four dense-PK lookups and the
# 25-nation bounded groupby ---------------------------------------------------

_Q5_NATIONS = (
    "ALGERIA", "ARGENTINA", "BRAZIL", "CANADA", "EGYPT", "ETHIOPIA",
    "FRANCE", "GERMANY", "INDIA", "INDONESIA", "IRAN", "IRAQ", "JAPAN",
    "JORDAN", "KENYA", "MOROCCO", "MOZAMBIQUE", "PERU", "CHINA",
    "ROMANIA", "SAUDI ARABIA", "VIETNAM", "RUSSIA", "UNITED KINGDOM",
    "UNITED STATES",
)
_Q5_N_REGIONS = 5
_Q5_YEAR_START = 8766   # 1994-01-01
_Q5_YEAR_END = 9131     # 1995-01-01

# nation columns
N_NATIONKEY, N_REGIONKEY = 0, 1
# supplier columns
S_SUPPKEY, S_NATIONKEY = 0, 1
# q5 customer columns
C5_CUSTKEY, C5_NATIONKEY = 0, 1
# q5 lineitem columns
L5_ORDERKEY, L5_SUPPKEY, L5_EXTENDEDPRICE, L5_DISCOUNT = 0, 1, 2, 3


def _keys_and_draw(num_rows: int, draw, device) -> Table:
    """[1..n int64 keys, an int64 column of ``draw``]."""
    return Table([
        Column.from_numpy(np.arange(1, num_rows + 1, dtype=np.int64),
                          device=device),
        Column.from_numpy(draw.astype(np.int64), device=device)])


def nation_table(seed: int = 0, device=None) -> Table:
    """nation: [n_nationkey 1..25, n_regionkey in 1..5]."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    return _keys_and_draw(25, rng.integers(1, _Q5_N_REGIONS + 1, 25), device)


def supplier_table(num_rows: int, seed: int = 9, device=None) -> Table:
    """supplier: [s_suppkey 1..n, s_nationkey in 1..25]."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    return _keys_and_draw(num_rows, rng.integers(1, 26, num_rows), device)


def customer_q5_table(num_rows: int, seed: int = 10, device=None) -> Table:
    """q5's customer: [c_custkey 1..n, c_nationkey in 1..25]."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    return _keys_and_draw(num_rows, rng.integers(1, 26, num_rows), device)


def lineitem_q5_table(num_rows: int, num_orders: int, num_suppliers: int,
                      seed: int = 11, device=None) -> Table:
    """q5's lineitem: [l_orderkey, l_suppkey, l_extendedprice,
    l_discount]."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    return Table([
        Column.from_numpy(
            rng.integers(1, num_orders + 1, num_rows).astype(np.int64),
            device=device),
        Column.from_numpy(
            rng.integers(1, num_suppliers + 1, num_rows).astype(np.int64),
            device=device),
        Column.from_numpy(
            rng.integers(90_000, 10_500_000, num_rows).astype(np.int64),
            t.decimal64(-2), device=device),
        Column.from_numpy(
            rng.integers(0, 11, num_rows).astype(np.int64), t.decimal64(-2),
            device=device),
    ])


def _times_10_20(p: torch.Tensor, neg: torch.Tensor):
    """(lo, hi) int64 limbs of p * 10^20 (0 <= p < 2^31), negated where
    ``neg``: three 32-bit partial products with their carries."""
    c = [(10**20 >> (32 * k)) & 0xFFFFFFFF for k in range(3)]
    t0 = p * c[0]
    t1 = p * c[1] + (t0 >> 32)
    t2 = p * c[2] + (t1 >> 32)
    lo = (t0 & 0xFFFFFFFF) | ((t1 & 0xFFFFFFFF) << 32)
    hi = t2
    return (torch.where(neg, ~lo + 1, lo),
            torch.where(neg, ~hi + (lo == 0).to(torch.int64), hi))


def lineitem_groupby_table(num_rows: int, num_orders: int,
                           num_suppliers: int, seed: int = 14,
                           device=None) -> tuple[Table, torch.Tensor]:
    """The groupby workload's lineitem: the seven ``lineitem_table``
    columns (seed 0), then q5's l_orderkey and l_suppkey, a FLOAT64 price
    (l_extendedprice / 100, divided by a device tensor; NaN in every
    997th row of June 1995), a UINT64 column (Spark's xxhash64 of
    l_orderkey, seed 42, viewed unsigned) and a DECIMAL128 one
    (l_extendedprice x 10^20 at scale -22, about 10 % of rows negative).
    Seeded nulls: l_quantity ~1 %, each flag ~0.5 %. Returns the table
    and the bool[n] of the negative DECIMAL128 rows."""
    from spark_rapids_jni_tpu_torch.ops.hash import xxhash64_long

    device = resolve_device(device)
    li = lineitem_table(num_rows, seed=0, device=device)
    q5 = lineitem_q5_table(num_rows, num_orders, num_suppliers,
                           device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    cols = list(li.columns)
    for i, frac in ((L_QUANTITY, 0.01), (L_RETURNFLAG, 0.005),
                    (L_LINESTATUS, 0.005)):
        valid = torch.rand(num_rows, generator=gen, device=device) >= frac
        cols[i] = Column(cols[i].dtype, cols[i].data, valid)
    neg = torch.rand(num_rows, generator=gen, device=device) < 0.1
    price = cols[L_EXTENDEDPRICE].data
    f64 = price.to(torch.float64) / torch.tensor(
        100.0, dtype=torch.float64, device=device)
    ship = cols[L_SHIPDATE].data
    june95 = (ship >= 9282) & (ship < 9312)  # 1995-06-01 .. 1995-06-30
    rowid = torch.arange(num_rows, device=device)
    f64 = torch.where(june95 & (rowid % 997 == 0), float("nan"), f64)
    okey = q5.column(L5_ORDERKEY)
    u64 = xxhash64_long(okey.data, torch.tensor(42, device=device)).view(
        torch.uint64)
    lo, hi = _times_10_20(price, neg)
    cols += [okey, q5.column(L5_SUPPKEY), Column(t.FLOAT64, f64),
             Column(t.UINT64, u64),
             Column(t.decimal128(-22), torch.stack([lo, hi], dim=1))]
    return Table(cols), neg


class Q5Result(NamedTuple):
    table: Table              # [n_nationkey, revenue, n_name], rev desc
    present: torch.Tensor
    pk_violation: torch.Tensor
    domain_miss: torch.Tensor


_Q5_AGGS = [(1, "sum")]


def _q5_keyed(customer: Table, orders: Table, lineitem: Table,
              supplier: Table, nation: Table, region_of_interest: int,
              year_start: int, year_end: int):
    """q5 up to its groupby, one row per lineitem row: the four clustered
    dense-PK lookups (supplier, orders with the date filter in its key,
    customer on the gathered o_custkey, nation with the region filter in
    its key), then [s_nationkey where kept, revenue]. Returns (keyed,
    pk_violation)."""
    n = lineitem.num_columns
    j_s = dense_pk_join(lineitem, supplier, L5_SUPPKEY, S_SUPPKEY,
                        1, supplier.num_rows, clustered=True)
    s_nation = j_s.table.column(n + 1)
    od = orders.column(O_ORDERDATE)
    date_ok = od.valid_mask() & (od.data >= year_start) \
        & (od.data < year_end)
    ord_build = Table([_null_where(orders.column(O_ORDERKEY), ~date_ok),
                       orders.column(O_CUSTKEY)])
    j_o = dense_pk_join(lineitem, ord_build, L5_ORDERKEY, 0,
                        1, orders.num_rows, clustered=True)
    # the gathered o_custkey's validity already holds the match
    j_c = dense_pk_join(Table([j_o.table.column(n + 1)]), customer, 0,
                        C5_CUSTKEY, 1, customer.num_rows, clustered=True)
    c_nation = j_c.table.column(2)
    nat_build = Table([_null_where(
        nation.column(N_NATIONKEY),
        nation.column(N_REGIONKEY).data != region_of_interest)])
    j_n = dense_pk_join(Table([s_nation]), nat_build, 0, 0, 1, 25,
                        clustered=True)
    keep = (j_s.matched & j_o.matched & j_c.matched & j_n.matched
            & (c_nation.data == s_nation.data))
    price = lineitem.column(L5_EXTENDEDPRICE)
    disc = lineitem.column(L5_DISCOUNT)
    rev_ok = keep & price.valid_mask() & disc.valid_mask()
    revenue = Column(t.decimal64(-4),
                     torch.where(rev_ok, price.data * (100 - disc.data), 0),
                     rev_ok)
    keyed = Table([Column(s_nation.dtype,
                          torch.where(keep, s_nation.data, 0), keep),
                   revenue])
    pk_violation = (j_s.pk_violation | j_o.pk_violation | j_c.pk_violation
                    | j_n.pk_violation)
    return keyed, pk_violation


def _q5_domains():
    return [scalar_domain(range(1, 26))]


def tpch_q5(customer: Table, orders: Table, lineitem: Table,
            supplier: Table, nation: Table, region_of_interest: int = 1,
            year_start: int = _Q5_YEAR_START,
            year_end: int = _Q5_YEAR_END) -> Q5Result:
    """q5 from planner facts alone, the reference's plan: every join a
    clustered dense-PK lookup (``_q5_keyed``), the GROUP BY nation the
    bounded groupby over the 25-value DDL domain (the accumulate kernel
    on the card, m = 26), then n_name attached from the static slot
    layout and the 26-row ORDER BY revenue DESC carrying it."""
    keyed, pk_violation = _q5_keyed(customer, orders, lineitem, supplier,
                                    nation, region_of_interest, year_start,
                                    year_end)
    g = plan_groupby(keyed, [0], _Q5_AGGS, _q5_domains())
    if g.lowered != "bounded":
        raise AssertionError("q5's nation domain must lower to the "
                             "bounded plan")
    # bounded slot i (< 25) is nation key i+1
    lens, mat = static_strings(
        list(_Q5_NATIONS) + [None] * (g.table.num_rows - len(_Q5_NATIONS)),
        g.present.device)
    names = Column(t.STRING, lens, g.table.column(0).valid_mask(), chars=mat)
    out = Table(list(g.table.columns) + [names])
    srt = gather(out, sort_order(out, [1], ascending=[False],
                                 nulls_first=[False]))
    # key valid <=> slot present, through the ORDER BY's permutation
    return Q5Result(srt, srt.column(0).valid_mask(), pk_violation,
                    g.domain_miss)


def q5_accumulate_inputs(customer: Table, orders: Table, lineitem: Table,
                         supplier: Table, nation: Table):
    """(gid, lanes, m): the accumulate kernel's inputs in q5 (m = 26)."""
    keyed, _ = _q5_keyed(customer, orders, lineitem, supplier, nation, 1,
                         _Q5_YEAR_START, _Q5_YEAR_END)
    return bounded_accumulate_inputs(keyed, [0], _Q5_AGGS, _q5_domains())


def tpch_q5_numpy(customer: Table, orders: Table, lineitem: Table,
                  supplier: Table, nation: Table,
                  region_of_interest: int = 1,
                  year_start: int = _Q5_YEAR_START,
                  year_end: int = _Q5_YEAR_END) -> dict:
    """Host oracle, a loop over lineitem: {n_nationkey: revenue}."""
    s_nat = {int(k): int(v) for k, v in zip(_host(supplier, S_SUPPKEY),
                                            _host(supplier, S_NATIONKEY))}
    c_nat = {int(k): int(v) for k, v in zip(_host(customer, C5_CUSTKEY),
                                            _host(customer, C5_NATIONKEY))}
    in_region = {int(k) for k, r in zip(_host(nation, N_NATIONKEY),
                                        _host(nation, N_REGIONKEY))
                 if int(r) == region_of_interest}
    o_info = {}
    for k, c, d in zip(_host(orders, O_ORDERKEY), _host(orders, O_CUSTKEY),
                       _host(orders, O_ORDERDATE)):
        if year_start <= int(d) < year_end:
            o_info[int(k)] = int(c)
    out: dict = {}
    lkey = _host(lineitem, L5_ORDERKEY)
    lsupp = _host(lineitem, L5_SUPPKEY)
    price = _host(lineitem, L5_EXTENDEDPRICE)
    disc = _host(lineitem, L5_DISCOUNT)
    for i in range(lineitem.num_rows):
        ok = int(lkey[i])
        if ok not in o_info:
            continue
        sn = s_nat.get(int(lsupp[i]))
        if sn is None or sn not in in_region:
            continue
        if c_nat.get(o_info[ok]) != sn:
            continue
        out[sn] = out.get(sn, 0) + int(price[i]) * (100 - int(disc[i]))
    return out


def tpch_q5_oracle(customer: Table, orders: Table, lineitem: Table,
                   supplier: Table, nation: Table,
                   region_of_interest: int = 1,
                   year_start: int = _Q5_YEAR_START,
                   year_end: int = _Q5_YEAR_END) -> dict:
    """``tpch_q5_numpy`` vectorized: {n_nationkey: revenue}."""
    od = _host(orders, O_ORDERDATE)
    o_keep = (od >= year_start) & (od < year_end)
    found_o, ocust = _host_lookup(_host(orders, O_ORDERKEY)[o_keep],
                                  _host(orders, O_CUSTKEY)[o_keep],
                                  _host(lineitem, L5_ORDERKEY))
    found_s, sn = _host_lookup(_host(supplier, S_SUPPKEY),
                               _host(supplier, S_NATIONKEY),
                               _host(lineitem, L5_SUPPKEY))
    region = _host(nation, N_NATIONKEY)[
        _host(nation, N_REGIONKEY) == region_of_interest]
    found_c, cn = _host_lookup(_host(customer, C5_CUSTKEY),
                               _host(customer, C5_NATIONKEY), ocust)
    ok = found_o & found_s & np.isin(sn, region) & found_c & (cn == sn)
    rev = _host(lineitem, L5_EXTENDEDPRICE)[ok] \
        * (100 - _host(lineitem, L5_DISCOUNT)[ok])
    return _host_group_sums(sn[ok], rev)


# ---- TPC-H q12 (shipping modes and order priority): a join, then a
# string-key groupby with CASE WHEN counts ------------------------------------

# q12 lineitem columns
L12_ORDERKEY, L12_SHIPMODE, L12_COMMITDATE = 0, 1, 2
L12_RECEIPTDATE, L12_SHIPDATE = 3, 4
# q12 orders columns
O12_ORDERKEY, O12_ORDERPRIORITY = 0, 1

_Q12_MODES = ("MAIL", "SHIP", "AIR", "RAIL", "TRUCK", "FOB", "REG AIR")
_Q12_PRIORITIES = ("1-URGENT", "2-HIGH", "3-MEDIUM",
                   "4-NOT SPECIFIED", "5-LOW")
_Q12_URGENT = ("1-URGENT", "2-HIGH")
_Q12_YEAR_START = 8766   # 1994-01-01 in days
_Q12_YEAR_END = 9131     # 1995-01-01
_Q12_AGGS = [(1, "sum"), (2, "sum")]


def lineitem_q12_table(num_rows: int, num_orders: int, seed: int = 3,
                       device=None) -> Table:
    """q12's lineitem: [l_orderkey, l_shipmode (STRING), l_commitdate,
    l_receiptdate, l_shipdate]."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    ship = rng.integers(8400, 10957, num_rows).astype(np.int32)
    commit = ship + rng.integers(-30, 60, num_rows).astype(np.int32)
    receipt = commit + rng.integers(-20, 40, num_rows).astype(np.int32)
    okey = rng.integers(1, num_orders + 1, num_rows).astype(np.int64)
    mode = rng.integers(0, len(_Q12_MODES), num_rows)
    return Table([
        Column.from_numpy(okey, device=device),
        _vocab_strings(_Q12_MODES, mode, device),
        Column.from_numpy(commit, t.TIMESTAMP_DAYS, device=device),
        Column.from_numpy(receipt, t.TIMESTAMP_DAYS, device=device),
        Column.from_numpy(ship, t.TIMESTAMP_DAYS, device=device),
    ])


def orders_q12_table(num_rows: int, seed: int = 4, device=None) -> Table:
    """q12's orders: [o_orderkey 1..n, o_orderpriority (STRING)]."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    return Table([
        Column.from_numpy(np.arange(1, num_rows + 1, dtype=np.int64),
                          device=device),
        _vocab_strings(_Q12_PRIORITIES, rng.integers(
            0, len(_Q12_PRIORITIES), num_rows), device),
    ])


def _q12_keep(lineitem: Table, mode_c: Column, modes: tuple,
              year_start: int, year_end: int) -> torch.Tensor:
    """q12's WHERE: shipmode IN the list (one LIKE per mode), the date
    sanity predicates, every operand non-null."""
    in_modes = torch.zeros((lineitem.num_rows,), dtype=torch.bool,
                           device=mode_c.device)
    for mname in modes:
        in_modes = in_modes | (like(mode_c, mname).data != 0)
    commit_c = lineitem.column(L12_COMMITDATE)
    receipt_c = lineitem.column(L12_RECEIPTDATE)
    ship_c = lineitem.column(L12_SHIPDATE)
    return (in_modes & mode_c.valid_mask() & commit_c.valid_mask()
            & receipt_c.valid_mask() & ship_c.valid_mask()
            & (commit_c.data < receipt_c.data)
            & (ship_c.data < commit_c.data)
            & (receipt_c.data >= year_start)
            & (receipt_c.data < year_end))


def _q12_priority_lanes(prio: Column, matched: torch.Tensor):
    """CASE WHEN o_orderpriority IN ('1-URGENT', '2-HIGH') as two int64
    count lanes."""
    urgent = (like(prio, "1-URGENT").data != 0) \
        | (like(prio, "2-HIGH").data != 0)
    high = Column(t.INT64, (matched & urgent).to(torch.int64), matched)
    low = Column(t.INT64, (matched & ~urgent).to(torch.int64), matched)
    return high, low


def _q12_joined(orders: Table, lineitem: Table, mode_c: Column,
                modes: tuple, year_start: int, year_end: int):
    """The WHERE as a nulled join key, the join to orders (capacity: the
    lineitem rows), and the matched mask. Returns (joined table
    [l_orderkey, l_shipmode, o_orderkey, o_orderpriority], maps,
    matched)."""
    keep = _q12_keep(lineitem, mode_c, modes, year_start, year_end)
    probe = Table([_null_where(lineitem.column(L12_ORDERKEY), ~keep),
                   mode_c])
    maps = join(probe, orders, 0, 0, out_size=lineitem.num_rows)
    j = apply_join_maps(probe, orders, maps)
    return j, maps, j.column(2).valid_mask()


class Q12Result(NamedTuple):
    result: GroupByResult  # [l_shipmode, high_line_count, low_line_count]
    join_total: torch.Tensor


def tpch_q12(orders: Table, lineitem: Table,
             modes: tuple = ("MAIL", "SHIP"),
             year_start: int = _Q12_YEAR_START,
             year_end: int = _Q12_YEAR_END) -> Q12Result:
    """General q12: lineitem filtered on the mode and date predicates,
    joined to orders on orderkey (the probe kernel on the card), grouped
    by shipmode with the CASE WHEN priority counts (sort-based, string
    key), ORDER BY shipmode with the null group last."""
    j, maps, matched = _q12_joined(orders, lineitem,
                                   lineitem.column(L12_SHIPMODE), modes,
                                   year_start, year_end)
    high, low = _q12_priority_lanes(j.column(3), matched)
    keyed = Table([_null_where(j.column(1), ~matched), high, low])
    g = groupby_aggregate(keyed, [0], _Q12_AGGS)
    srt = gather(g.table, sort_order(g.table, [0], nulls_first=[False]))
    return Q12Result(GroupByResult(srt, g.num_groups), maps.total)


def _q12_planned_keyed(orders: Table, lineitem: Table, modes: tuple,
                       year_start: int, year_end: int) -> Table:
    """Planned q12 up to its groupby: the shipmode padded once, the same
    join, then [shipmode (unmatched rows zeroed in lengths and bytes),
    high, low]."""
    mode_c = pad_strings(lineitem.column(L12_SHIPMODE))
    j, _, matched = _q12_joined(orders, lineitem, mode_c, modes, year_start,
                                year_end)
    high, low = _q12_priority_lanes(j.column(3), matched)
    mode_j = j.column(1)
    return Table([
        Column(mode_j.dtype, torch.where(matched, mode_j.data, 0), matched,
               chars=mode_j.chars.masked_fill(~matched[:, None], 0)),
        high, low])


def tpch_q12_planned_result(orders: Table, lineitem: Table,
                            modes: tuple = ("MAIL", "SHIP"),
                            year_start: int = _Q12_YEAR_START,
                            year_end: int = _Q12_YEAR_END) -> PlannedGroupBy:
    """q12 with the groupby on the sort-free plan: the shipmode key's
    domain is the query's own IN list, so the aggregation lowers to the
    bounded groupby (the accumulate kernel on the card, m = 3 for two
    modes), with the modes dictionary-encoded on the device and decoded
    to static strings. The join is the general one."""
    keyed = _q12_planned_keyed(orders, lineitem, modes, year_start,
                               year_end)
    return plan_groupby(keyed, [0], _Q12_AGGS, [string_domain(modes)])


def tpch_q12_planned(orders: Table, lineitem: Table,
                     modes: tuple = ("MAIL", "SHIP"),
                     year_start: int = _Q12_YEAR_START,
                     year_end: int = _Q12_YEAR_END) -> Table:
    """Planned q12, table only: [l_shipmode, high_line_count,
    low_line_count] in mode order, the null group last."""
    return tpch_q12_planned_result(orders, lineitem, modes, year_start,
                                   year_end).table


def q12_accumulate_inputs(orders: Table, lineitem: Table,
                          modes: tuple = ("MAIL", "SHIP")):
    """(gid, lanes, m): the accumulate kernel's inputs in planned q12."""
    keyed = _q12_planned_keyed(orders, lineitem, modes, _Q12_YEAR_START,
                               _Q12_YEAR_END)
    return bounded_accumulate_inputs(keyed, [0], _Q12_AGGS,
                                     [string_domain(modes)])


def q12_probe_inputs(orders: Table, lineitem: Table):
    """(build, n_valid, probe): the probe kernel's inputs at q12's join,
    the build sorted and sentinel-padded as ``join`` gives it (the probe
    is the raw key column: its nulls are applied after the probe)."""
    key = orders.column(O12_ORDERKEY)
    build, n_valid, _ = _sorted_valid_keys(key.data, key.valid_mask())
    return build, n_valid, lineitem.column(L12_ORDERKEY).data


def tpch_q12_numpy(orders: Table, lineitem: Table,
                   modes: tuple = ("MAIL", "SHIP"),
                   year_start: int = _Q12_YEAR_START,
                   year_end: int = _Q12_YEAR_END) -> dict:
    """Host oracle, a loop over lineitem: {shipmode: [high, low]}."""
    prio = {int(k): p for k, p in zip(
        _host(orders, O12_ORDERKEY).tolist(),
        orders.column(O12_ORDERPRIORITY).to_pylist())}
    out: dict = {}
    lmode = lineitem.column(L12_SHIPMODE).to_pylist()
    lkey = _host(lineitem, L12_ORDERKEY).tolist()
    commit = _host(lineitem, L12_COMMITDATE).tolist()
    receipt = _host(lineitem, L12_RECEIPTDATE).tolist()
    ship = _host(lineitem, L12_SHIPDATE).tolist()
    for i in range(lineitem.num_rows):
        if lmode[i] not in modes:
            continue
        if not (commit[i] < receipt[i] and ship[i] < commit[i]
                and year_start <= receipt[i] < year_end):
            continue
        p = prio.get(lkey[i])
        if p is None:
            continue
        counts = out.setdefault(lmode[i], [0, 0])
        counts[0 if p in _Q12_URGENT else 1] += 1
    return out


def tpch_q12_oracle(orders: Table, lineitem: Table,
                    modes: tuple = ("MAIL", "SHIP"),
                    year_start: int = _Q12_YEAR_START,
                    year_end: int = _Q12_YEAR_END) -> dict:
    """``tpch_q12_numpy`` vectorized: {shipmode: [high, low]}."""
    code = _host_codes(lineitem.column(L12_SHIPMODE), modes)
    commit = _host(lineitem, L12_COMMITDATE)
    receipt = _host(lineitem, L12_RECEIPTDATE)
    ship = _host(lineitem, L12_SHIPDATE)
    keep = (code >= 0) & (commit < receipt) & (ship < commit) \
        & (receipt >= year_start) & (receipt < year_end)
    prio = orders.column(O12_ORDERPRIORITY)
    # 1 = urgent, 0 = other, -1 = null priority (skipped, as None is)
    cls = np.where(_host_codes(prio, _Q12_URGENT) >= 0, 1, 0)
    cls = np.where(prio.valid_mask().cpu().numpy(), cls, -1)
    found, pcls = _host_lookup(_host(orders, O12_ORDERKEY), cls,
                               _host(lineitem, L12_ORDERKEY))
    ok = keep & found & (pcls >= 0)
    out = {}
    for k, mname in enumerate(modes):
        rows = ok & (code == k)
        if rows.any() and mname not in out:
            high = int((pcls[rows] == 1).sum())
            out[mname] = [high, int(rows.sum()) - high]
    return out


# ---- TPC-H q14 (promotion effect): a join, LIKE 'PROMO%' and two sums -------

P_PARTKEY, P_TYPE, P_BRAND, P_CONTAINER, P_SIZE = 0, 1, 2, 3, 4

_P_TYPES = ("PROMO BURNISHED COPPER", "PROMO PLATED BRASS",
            "STANDARD POLISHED TIN", "MEDIUM BRUSHED NICKEL",
            "ECONOMY ANODIZED STEEL", "SMALL PLATED COPPER")
_P_BRANDS = ("Brand#11", "Brand#12", "Brand#23", "Brand#34", "Brand#55")
_P_CONTAINERS = ("SM CASE", "SM BOX", "SM PACK", "SM PKG",
                 "MED BAG", "MED BOX", "MED PKG", "MED PACK",
                 "LG CASE", "LG BOX", "LG PACK", "LG PKG")

# q14 lineitem columns
L14_PARTKEY, L14_EXTENDEDPRICE, L14_DISCOUNT, L14_SHIPDATE = 0, 1, 2, 3

_Q14_MONTH_START = 9374  # 1995-09-01
_Q14_MONTH_END = 9404    # 1995-10-01


def part_table(num_rows: int, seed: int = 5, device=None) -> Table:
    """part: [p_partkey 1..n, p_type, p_brand, p_container (STRING),
    p_size]."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    types = rng.integers(0, len(_P_TYPES), num_rows)
    brands = rng.integers(0, len(_P_BRANDS), num_rows)
    containers = rng.integers(0, len(_P_CONTAINERS), num_rows)
    size = rng.integers(1, 51, num_rows).astype(np.int32)
    return Table([
        Column.from_numpy(np.arange(1, num_rows + 1, dtype=np.int64),
                          device=device),
        _vocab_strings(_P_TYPES, types, device),
        _vocab_strings(_P_BRANDS, brands, device),
        _vocab_strings(_P_CONTAINERS, containers, device),
        Column.from_numpy(size, device=device),
    ])


def lineitem_q14_table(num_rows: int, num_parts: int, seed: int = 6,
                       device=None) -> Table:
    """q14's lineitem: [l_partkey, l_extendedprice, l_discount,
    l_shipdate]."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    return Table([
        Column.from_numpy(
            rng.integers(1, num_parts + 1, num_rows).astype(np.int64),
            device=device),
        Column.from_numpy(
            rng.integers(90_000, 10_500_000, num_rows).astype(np.int64),
            t.decimal64(-2), device=device),
        Column.from_numpy(
            rng.integers(0, 11, num_rows).astype(np.int64), t.decimal64(-2),
            device=device),
        Column.from_numpy(
            rng.integers(8400, 10957, num_rows).astype(np.int32),
            t.TIMESTAMP_DAYS, device=device),
    ])


class Q14Result(NamedTuple):
    promo_revenue: torch.Tensor   # int64 unscaled decimal(-4)
    total_revenue: torch.Tensor   # int64 unscaled decimal(-4)
    join_total: torch.Tensor

    def ratio(self) -> float:
        """100 * promo / total (the published q14 metric), host side."""
        tot = int(self.total_revenue)
        return 100.0 * int(self.promo_revenue) / tot if tot else 0.0


class Q14PlannedResult(NamedTuple):
    promo_revenue: torch.Tensor
    total_revenue: torch.Tensor
    join_total: torch.Tensor
    pk_violation: torch.Tensor    # the declared clustered PK was a lie

    ratio = Q14Result.ratio


def _q14_inputs(lineitem: Table, month_start: int, month_end: int):
    """The month-filtered probe [l_partkey], the exact decimal(-4)
    revenue per lineitem row, and where it counts."""
    ship = lineitem.column(L14_SHIPDATE)
    keep = ship.valid_mask() & (ship.data >= month_start) \
        & (ship.data < month_end)
    price = lineitem.column(L14_EXTENDEDPRICE)
    disc = lineitem.column(L14_DISCOUNT)
    revenue = price.data * (100 - disc.data)
    rev_ok = price.valid_mask() & disc.valid_mask() & keep
    probe = Table([_null_where(lineitem.column(L14_PARTKEY), ~keep)])
    return probe, revenue, rev_ok


def _q14_sums(rev: torch.Tensor, p_type: Column):
    promo = like(p_type, "PROMO%").data != 0
    return torch.where(promo, rev, 0).sum(), rev.sum()


def tpch_q14(part: Table, lineitem: Table,
             month_start: int = _Q14_MONTH_START,
             month_end: int = _Q14_MONTH_END) -> Q14Result:
    """General q14: the month's lineitem joined to part (the probe kernel
    on the card), CASE WHEN p_type LIKE 'PROMO%' over the joined strings,
    and the two exact decimal(-4) sums. The revenue lanes are gathered by
    the join's left map."""
    probe, revenue, rev_ok = _q14_inputs(lineitem, month_start, month_end)
    build = Table([part.column(P_PARTKEY), part.column(P_TYPE)])
    maps = join(probe, build, 0, 0, out_size=lineitem.num_rows)
    li = maps.left_index.clamp(0, max(lineitem.num_rows - 1, 0))
    j = apply_join_maps(probe, build, maps)
    matched = j.column(1).valid_mask() & maps.row_valid
    rev_j = torch.where(matched & rev_ok[li], revenue[li], 0)
    return Q14Result(*_q14_sums(rev_j, j.column(2)), maps.total)


def tpch_q14_planned(part: Table, lineitem: Table,
                     month_start: int = _Q14_MONTH_START,
                     month_end: int = _Q14_MONTH_END) -> Q14PlannedResult:
    """q14 with the part join a declared clustered dense-PK lookup: a
    gather, no join kernel; its rows are the lineitem rows, so the
    revenue lanes need no gather."""
    probe, revenue, rev_ok = _q14_inputs(lineitem, month_start, month_end)
    build = Table([part.column(P_PARTKEY),
                   pad_strings(part.column(P_TYPE))])
    j = dense_pk_join(probe, build, 0, 0, 1, part.num_rows, clustered=True)
    rev_j = torch.where(j.matched & rev_ok, revenue, 0)
    return Q14PlannedResult(*_q14_sums(rev_j, j.table.column(2)), j.total,
                            j.pk_violation)


def q14_probe_inputs(part: Table, lineitem: Table):
    """(build, n_valid, probe): the probe kernel's inputs at q14's join."""
    key = part.column(P_PARTKEY)
    build, n_valid, _ = _sorted_valid_keys(key.data, key.valid_mask())
    return build, n_valid, lineitem.column(L14_PARTKEY).data


def tpch_q14_numpy(part: Table, lineitem: Table,
                   month_start: int = _Q14_MONTH_START,
                   month_end: int = _Q14_MONTH_END) -> tuple:
    """Host oracle, a loop over lineitem: (promo, total) revenue."""
    ptype = {int(k): v for k, v in zip(_host(part, P_PARTKEY).tolist(),
                                       part.column(P_TYPE).to_pylist())}
    lkey = _host(lineitem, L14_PARTKEY).tolist()
    price = _host(lineitem, L14_EXTENDEDPRICE).tolist()
    disc = _host(lineitem, L14_DISCOUNT).tolist()
    ship = _host(lineitem, L14_SHIPDATE).tolist()
    promo = total = 0
    for i in range(lineitem.num_rows):
        if not month_start <= ship[i] < month_end:
            continue
        tp = ptype.get(lkey[i])
        if tp is None:
            continue
        rev = price[i] * (100 - disc[i])
        total += rev
        if tp.startswith("PROMO"):
            promo += rev
    return promo, total


def tpch_q14_oracle(part: Table, lineitem: Table,
                    month_start: int = _Q14_MONTH_START,
                    month_end: int = _Q14_MONTH_END) -> tuple:
    """``tpch_q14_numpy`` vectorized: (promo, total) revenue."""
    lens, mat, valid = _host_strings(part.column(P_TYPE))
    pref = np.frombuffer(b"PROMO", np.uint8)
    is_promo = (lens >= len(pref)) & (mat[:, :len(pref)] == pref).all(1) \
        if mat.shape[1] >= len(pref) else np.zeros(lens.shape, bool)
    # 1 = promo, 0 = other, -1 = null type (skipped, as None is)
    cls = np.where(valid, is_promo.astype(np.int64), -1)
    ship = _host(lineitem, L14_SHIPDATE)
    found, pcls = _host_lookup(_host(part, P_PARTKEY), cls,
                               _host(lineitem, L14_PARTKEY))
    ok = (ship >= month_start) & (ship < month_end) & found & (pcls >= 0)
    rev = _host(lineitem, L14_EXTENDEDPRICE)[ok] \
        * (100 - _host(lineitem, L14_DISCOUNT)[ok])
    return int(rev[pcls[ok] == 1].sum()), int(rev.sum())


# ---- TPC-H q4 (order priority checking): EXISTS as a LEFT-SEMI join, then
# a string-key groupby ---------------------------------------------------------

# q4 orders columns
O4_ORDERKEY, O4_ORDERDATE, O4_ORDERPRIORITY = 0, 1, 2
_Q4_QTR_START = 8582   # 1993-07-01
_Q4_QTR_END = 8674     # 1993-10-01
_Q4_AGGS = [(1, "sum")]


def orders_q4_table(num_rows: int, seed: int = 8, device=None) -> Table:
    """q4's orders: [o_orderkey 1..n, o_orderdate, o_orderpriority
    (STRING)]."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    date = rng.integers(8400, 8800, num_rows).astype(np.int32)
    prio = rng.integers(0, len(_Q12_PRIORITIES), num_rows)
    return Table([
        Column.from_numpy(np.arange(1, num_rows + 1, dtype=np.int64),
                          device=device),
        Column.from_numpy(date, t.TIMESTAMP_DAYS, device=device),
        _vocab_strings(_Q12_PRIORITIES, prio, device),
    ])


def _q4_semi(orders: Table, lineitem: Table, prio_c: Column,
             qtr_start: int, qtr_end: int):
    """Orders of the quarter (nulled key otherwise) LEFT-SEMI joined to
    the late lineitem rows (commit < receipt; nulled key otherwise),
    capacity the orders rows. Returns (joined [o_orderkey,
    o_orderpriority, l_orderkey], maps)."""
    od = orders.column(O4_ORDERDATE)
    keep_o = od.valid_mask() & (od.data >= qtr_start) & (od.data < qtr_end)
    probe = Table([_null_where(orders.column(O4_ORDERKEY), ~keep_o), prio_c])
    commit_c = lineitem.column(L12_COMMITDATE)
    receipt_c = lineitem.column(L12_RECEIPTDATE)
    late = commit_c.valid_mask() & receipt_c.valid_mask() \
        & (commit_c.data < receipt_c.data)
    build = Table([_null_where(lineitem.column(L12_ORDERKEY), ~late)])
    maps = join(probe, build, 0, 0, out_size=orders.num_rows,
                how="left_semi")
    return apply_join_maps(probe, build, maps), maps


class Q4Result(NamedTuple):
    result: GroupByResult   # [o_orderpriority, order_count]
    join_total: torch.Tensor


def _count_lane(matched: torch.Tensor) -> Column:
    return Column(t.INT64, matched.to(torch.int64), matched)


def tpch_q4(orders: Table, lineitem: Table, qtr_start: int = _Q4_QTR_START,
            qtr_end: int = _Q4_QTR_END) -> Q4Result:
    """General q4: the orders of the quarter with EXISTS(a late lineitem)
    as a LEFT-SEMI join (the probe kernel on the card, into the whole
    lineitem key column), counted per priority by the sort-based
    groupby, ORDER BY priority with the null group last."""
    j, maps = _q4_semi(orders, lineitem, orders.column(O4_ORDERPRIORITY),
                       qtr_start, qtr_end)
    matched = maps.row_valid
    keyed = Table([_null_where(j.column(1), ~matched), _count_lane(matched)])
    g = groupby_aggregate(keyed, [0], _Q4_AGGS)
    srt = gather(g.table, sort_order(g.table, [0], nulls_first=[False]))
    return Q4Result(GroupByResult(srt, g.num_groups), maps.total)


def _q4_planned_keyed(orders: Table, lineitem: Table, qtr_start: int,
                      qtr_end: int) -> Table:
    prio_c = pad_strings(orders.column(O4_ORDERPRIORITY))
    j, maps = _q4_semi(orders, lineitem, prio_c, qtr_start, qtr_end)
    matched = maps.row_valid
    prio_j = j.column(1)
    return Table([
        Column(prio_j.dtype, torch.where(matched, prio_j.data, 0), matched,
               chars=prio_j.chars.masked_fill(~matched[:, None], 0)),
        _count_lane(matched)])


def tpch_q4_planned_result(orders: Table, lineitem: Table,
                           qtr_start: int = _Q4_QTR_START,
                           qtr_end: int = _Q4_QTR_END) -> PlannedGroupBy:
    """q4 with the groupby on the sort-free plan: o_orderpriority is a
    5-value DDL enum, so the COUNT(*) GROUP BY lowers to the bounded
    groupby (the accumulate kernel on the card, m = 6) with the
    priorities dictionary-encoded on the device. The EXISTS stays a
    LEFT-SEMI join."""
    keyed = _q4_planned_keyed(orders, lineitem, qtr_start, qtr_end)
    return plan_groupby(keyed, [0], _Q4_AGGS,
                        [string_domain(_Q12_PRIORITIES)])


def tpch_q4_planned(orders: Table, lineitem: Table,
                    qtr_start: int = _Q4_QTR_START,
                    qtr_end: int = _Q4_QTR_END) -> Table:
    """Planned q4, table only: [o_orderpriority, order_count] in priority
    order, the null group last."""
    return tpch_q4_planned_result(orders, lineitem, qtr_start,
                                  qtr_end).table


def q4_accumulate_inputs(orders: Table, lineitem: Table):
    """(gid, lanes, m): the accumulate kernel's inputs in planned q4."""
    keyed = _q4_planned_keyed(orders, lineitem, _Q4_QTR_START, _Q4_QTR_END)
    return bounded_accumulate_inputs(keyed, [0], _Q4_AGGS,
                                     [string_domain(_Q12_PRIORITIES)])


def q4_probe_inputs(orders: Table, lineitem: Table):
    """(build, n_valid, probe): the probe kernel's inputs at q4's
    LEFT-SEMI join, the late lineitem keys sorted and sentinel-padded."""
    commit_c = lineitem.column(L12_COMMITDATE)
    receipt_c = lineitem.column(L12_RECEIPTDATE)
    late = commit_c.valid_mask() & receipt_c.valid_mask() \
        & (commit_c.data < receipt_c.data)
    key = lineitem.column(L12_ORDERKEY)
    build, n_valid, _ = _sorted_valid_keys(key.data, key.valid_mask() & late)
    return build, n_valid, orders.column(O4_ORDERKEY).data


def tpch_q4_numpy(orders: Table, lineitem: Table,
                  qtr_start: int = _Q4_QTR_START,
                  qtr_end: int = _Q4_QTR_END) -> dict:
    """Host oracle, loops over both tables: {priority: order count}."""
    late_keys = set()
    lkey = _host(lineitem, L12_ORDERKEY).tolist()
    commit = _host(lineitem, L12_COMMITDATE).tolist()
    receipt = _host(lineitem, L12_RECEIPTDATE).tolist()
    for i in range(lineitem.num_rows):
        if commit[i] < receipt[i]:
            late_keys.add(lkey[i])
    out: dict = {}
    okey = _host(orders, O4_ORDERKEY).tolist()
    odate = _host(orders, O4_ORDERDATE).tolist()
    prio = orders.column(O4_ORDERPRIORITY).to_pylist()
    for i in range(orders.num_rows):
        if not qtr_start <= odate[i] < qtr_end:
            continue
        if okey[i] in late_keys:
            out[prio[i]] = out.get(prio[i], 0) + 1
    return out


def tpch_q4_oracle(orders: Table, lineitem: Table,
                   qtr_start: int = _Q4_QTR_START,
                   qtr_end: int = _Q4_QTR_END) -> dict:
    """``tpch_q4_numpy`` vectorized: {priority: order count}."""
    late = _host(lineitem, L12_COMMITDATE) < _host(lineitem,
                                                   L12_RECEIPTDATE)
    odate = _host(orders, O4_ORDERDATE)
    ok = (odate >= qtr_start) & (odate < qtr_end) & _host_isin(
        _host(orders, O4_ORDERKEY), _host(lineitem, L12_ORDERKEY)[late])
    lens, mat, valid = _host_strings(orders.column(O4_ORDERPRIORITY), ok)
    out: dict = {}
    if valid.any():
        rows = np.ascontiguousarray(np.concatenate([
            lens[valid, None].view(np.uint8).reshape(-1, 4), mat[valid]],
            1))
        # each row as one opaque value: a bytewise sort, not a sort of
        # one field per column
        keys = rows.view(np.dtype((np.void, rows.shape[1]))).reshape(-1)
        uniq, counts = np.unique(keys, return_counts=True)
        for r, c in zip(uniq, counts):
            r = np.frombuffer(r.tobytes(), np.uint8)
            n = int(r[:4].view(np.int32)[0])
            out[r[4:4 + n].tobytes().decode()] = int(c)
    if not valid.all():
        out[None] = int((~valid).sum())
    return out


# ---- TPC-H q19 (discounted revenue): a join and an OR of three AND-groups
# over brand, container and shipmode strings -----------------------------------

L19_PARTKEY, L19_QUANTITY, L19_EXTENDEDPRICE = 0, 1, 2
L19_DISCOUNT, L19_SHIPMODE, L19_SHIPINSTRUCT = 3, 4, 5

_Q19_MODES = ("AIR", "AIR REG", "TRUCK")
_Q19_INSTRUCTS = ("DELIVER IN PERSON", "COLLECT COD", "NONE",
                  "TAKE BACK RETURN")
# (brand, container prefix, qty_lo in whole units, size_hi)
_Q19_BRANCHES = (
    ("Brand#12", "SM", 1, 5),
    ("Brand#23", "MED", 10, 10),
    ("Brand#34", "LG", 20, 15),
)


def lineitem_q19_table(num_rows: int, num_parts: int, seed: int = 7,
                       device=None) -> Table:
    """q19's (and q17's) lineitem: [l_partkey, l_quantity,
    l_extendedprice, l_discount, l_shipmode, l_shipinstruct (STRING)]."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    partkey = rng.integers(1, num_parts + 1, num_rows).astype(np.int64)
    qty = rng.integers(100, 51_00, num_rows).astype(np.int64)
    price = rng.integers(90_000, 10_500_000, num_rows).astype(np.int64)
    disc = rng.integers(0, 11, num_rows).astype(np.int64)
    modes = rng.integers(0, len(_Q19_MODES), num_rows)
    instructs = rng.integers(0, len(_Q19_INSTRUCTS), num_rows)
    return Table([
        Column.from_numpy(partkey, device=device),
        Column.from_numpy(qty, t.decimal64(-2), device=device),
        Column.from_numpy(price, t.decimal64(-2), device=device),
        Column.from_numpy(disc, t.decimal64(-2), device=device),
        _vocab_strings(_Q19_MODES, modes, device),
        _vocab_strings(_Q19_INSTRUCTS, instructs, device),
    ])


class Q19Result(NamedTuple):
    revenue: torch.Tensor     # int64 unscaled decimal(-4)
    join_total: torch.Tensor


class Q19PlannedResult(NamedTuple):
    revenue: torch.Tensor     # int64 unscaled decimal(-4)
    join_total: torch.Tensor
    pk_violation: torch.Tensor


def _q19_revenue(brand_c: Column, cont_c: Column, size: torch.Tensor,
                 qty: torch.Tensor, price: torch.Tensor, disc: torch.Tensor,
                 mode_c: Column, instr_c: Column, keep: torch.Tensor,
                 branches: tuple) -> torch.Tensor:
    """The q19 predicate over rows already aligned with their part
    columns, and the exact decimal(-4) revenue sum of the rows it
    keeps."""
    air = (like(mode_c, "AIR").data != 0) | (like(mode_c, "AIR REG").data != 0)
    person = like(instr_c, "DELIVER IN PERSON").data != 0
    pred = torch.zeros(keep.shape, dtype=torch.bool, device=keep.device)
    for brand, cont_prefix, qty_lo, size_hi in branches:
        b = like(brand_c, brand).data != 0
        cont = like(cont_c, cont_prefix + "%").data != 0
        qok = (qty >= qty_lo * 100) & (qty <= (qty_lo + 10) * 100)
        sok = (size >= 1) & (size <= size_hi)
        pred = pred | (b & cont & qok & sok)
    pred = pred & air & person & keep
    return torch.where(pred, price * (100 - disc), 0).sum()


def _q19_lanes_ok(lineitem: Table) -> torch.Tensor:
    return (lineitem.column(L19_QUANTITY).valid_mask()
            & lineitem.column(L19_EXTENDEDPRICE).valid_mask()
            & lineitem.column(L19_DISCOUNT).valid_mask()
            & lineitem.column(L19_SHIPMODE).valid_mask()
            & lineitem.column(L19_SHIPINSTRUCT).valid_mask())


def tpch_q19(part: Table, lineitem: Table,
             branches: tuple = _Q19_BRANCHES) -> Q19Result:
    """General q19: lineitem joined to part on partkey (the probe kernel
    on the card), the OR-of-ANDs predicate as masks over the
    join-gathered part columns and the left-map-gathered lineitem lanes,
    and the exact int64 revenue sum."""
    n = lineitem.num_rows
    probe = Table([lineitem.column(L19_PARTKEY)])
    build = Table([part.column(P_PARTKEY), part.column(P_BRAND),
                   part.column(P_CONTAINER), part.column(P_SIZE)])
    maps = join(probe, build, 0, 0, out_size=n)
    li = maps.left_index.clamp(0, max(n - 1, 0))
    j = apply_join_maps(probe, build, maps)
    # j: [l_partkey, p_partkey, p_brand, p_container, p_size]
    matched = j.column(1).valid_mask() & maps.row_valid
    mode = gather_strings(pad_strings(lineitem.column(L19_SHIPMODE)), li)
    instr = gather_strings(pad_strings(lineitem.column(L19_SHIPINSTRUCT)),
                           li)
    revenue = _q19_revenue(
        j.column(2), j.column(3), j.column(4).data,
        lineitem.column(L19_QUANTITY).data[li],
        lineitem.column(L19_EXTENDEDPRICE).data[li],
        lineitem.column(L19_DISCOUNT).data[li],
        Column(t.STRING, mode.data, None, chars=mode.chars),
        Column(t.STRING, instr.data, None, chars=instr.chars),
        matched & _q19_lanes_ok(lineitem)[li], branches)
    return Q19Result(revenue, maps.total)


def tpch_q19_planned(part: Table, lineitem: Table,
                     branches: tuple = _Q19_BRANCHES) -> Q19PlannedResult:
    """q19 with the part join a declared clustered dense-PK lookup: no
    join kernel, and its output rows are the lineitem rows, so the
    lineitem lanes are read without a gather."""
    probe = Table([lineitem.column(L19_PARTKEY)])
    build = Table([part.column(P_PARTKEY),
                   pad_strings(part.column(P_BRAND)),
                   pad_strings(part.column(P_CONTAINER)),
                   part.column(P_SIZE)])
    j = dense_pk_join(probe, build, 0, 0, 1, part.num_rows, clustered=True)
    revenue = _q19_revenue(
        j.table.column(2), j.table.column(3), j.table.column(4).data,
        lineitem.column(L19_QUANTITY).data,
        lineitem.column(L19_EXTENDEDPRICE).data,
        lineitem.column(L19_DISCOUNT).data,
        pad_strings(lineitem.column(L19_SHIPMODE)),
        pad_strings(lineitem.column(L19_SHIPINSTRUCT)),
        j.matched & _q19_lanes_ok(lineitem), branches)
    return Q19PlannedResult(revenue, j.total, j.pk_violation)


def q19_probe_inputs(part: Table, lineitem: Table):
    """(build, n_valid, probe): the probe kernel's inputs at q19's join."""
    key = part.column(P_PARTKEY)
    build, n_valid, _ = _sorted_valid_keys(key.data, key.valid_mask())
    return build, n_valid, lineitem.column(L19_PARTKEY).data


def tpch_q19_numpy(part: Table, lineitem: Table,
                   branches: tuple = _Q19_BRANCHES) -> int:
    """Host oracle, a loop over lineitem: the revenue integer."""
    pinfo = {}
    pk = _host(part, P_PARTKEY).tolist()
    pb = part.column(P_BRAND).to_pylist()
    pc = part.column(P_CONTAINER).to_pylist()
    ps = _host(part, P_SIZE).tolist()
    for i in range(part.num_rows):
        pinfo[pk[i]] = (pb[i], pc[i], ps[i])
    lkey = _host(lineitem, L19_PARTKEY).tolist()
    qty = _host(lineitem, L19_QUANTITY).tolist()
    price = _host(lineitem, L19_EXTENDEDPRICE).tolist()
    disc = _host(lineitem, L19_DISCOUNT).tolist()
    mode = lineitem.column(L19_SHIPMODE).to_pylist()
    instr = lineitem.column(L19_SHIPINSTRUCT).to_pylist()
    total = 0
    for i in range(lineitem.num_rows):
        info = pinfo.get(lkey[i])
        if info is None:
            continue
        if mode[i] not in ("AIR", "AIR REG"):
            continue
        if instr[i] != "DELIVER IN PERSON":
            continue
        for brand, cont_prefix, qty_lo, size_hi in branches:
            if (info[0] == brand and info[1].startswith(cont_prefix)
                    and qty_lo * 100 <= qty[i] <= (qty_lo + 10) * 100
                    and 1 <= info[2] <= size_hi):
                total += price[i] * (100 - disc[i])
                break
    return total


def _host_prefix(col: Column, prefix: str) -> np.ndarray:
    """bool per row: the row starts with ``prefix`` (False for nulls)."""
    lens, mat, valid = _host_strings(col)
    pref = np.frombuffer(prefix.encode(), np.uint8)
    if len(pref) > mat.shape[1]:
        return np.zeros(lens.shape, bool)
    return valid & (lens >= len(pref)) & (mat[:, :len(pref)] == pref).all(1)


def tpch_q19_oracle(part: Table, lineitem: Table,
                    branches: tuple = _Q19_BRANCHES) -> int:
    """``tpch_q19_numpy`` vectorized: the revenue integer."""
    brand = _host_codes(part.column(P_BRAND), [b[0] for b in branches])
    size = _host(part, P_SIZE)
    # bit b: part rows that pass branch b's part conditions
    bits = np.zeros(part.num_rows, np.int64)
    for b, (_, cont_prefix, _, size_hi) in enumerate(branches):
        ok = (brand == b) & _host_prefix(part.column(P_CONTAINER),
                                         cont_prefix) \
            & (size >= 1) & (size <= size_hi)
        bits |= ok.astype(np.int64) << b
    found, pbits = _host_lookup(_host(part, P_PARTKEY), bits,
                                _host(lineitem, L19_PARTKEY))
    qty = _host(lineitem, L19_QUANTITY)
    hit = np.zeros(lineitem.num_rows, bool)
    for b, (_, _, qty_lo, _) in enumerate(branches):
        hit |= ((pbits >> b) & 1).astype(bool) \
            & (qty >= qty_lo * 100) & (qty <= (qty_lo + 10) * 100)
    hit &= found & (_host_codes(lineitem.column(L19_SHIPMODE),
                                ("AIR", "AIR REG")) >= 0) \
        & (_host_codes(lineitem.column(L19_SHIPINSTRUCT),
                       ("DELIVER IN PERSON",)) >= 0)
    return int((_host(lineitem, L19_EXTENDEDPRICE)[hit]
                * (100 - _host(lineitem, L19_DISCOUNT)[hit])).sum())


# ---- TPC-H q17 (small-quantity-order revenue): the correlated AVG as a
# groupby mean joined back, then an exact sum --------------------------------

class Q17Result(NamedTuple):
    yearly_total: torch.Tensor   # int64 unscaled decimal(-2)
    join_total: torch.Tensor

    def avg_yearly(self) -> float:
        """sum(l_extendedprice) / 7.0 in display units."""
        return int(self.yearly_total) / 100.0 / 7.0


def _q17_build(part: Table, brand: str, container: str) -> Table:
    """[p_partkey], null except for the parts of the brand and
    container."""
    sel = (like(part.column(P_BRAND), brand).data != 0) \
        & (like(part.column(P_CONTAINER), container).data != 0) \
        & part.column(P_PARTKEY).valid_mask()
    return Table([_null_where(part.column(P_PARTKEY), ~sel)])


def _q17_joined(part: Table, lineitem: Table, brand: str, container: str):
    """Join 1 and the groupby's input: (its maps, the clamped left map,
    [l_partkey, l_quantity] of the joined rows). The AVG runs over every
    selected row with a non-null quantity (a null price only drops the
    row from the final sum)."""
    n = lineitem.num_rows
    build = _q17_build(part, brand, container)
    probe = Table([lineitem.column(L19_PARTKEY)])
    maps = join(probe, build, 0, 0, out_size=n)
    li = maps.left_index.clamp(0, max(n - 1, 0))
    j = apply_join_maps(probe, build, maps)
    qty_c = lineitem.column(L19_QUANTITY)
    avg_ok = qty_c.valid_mask()[li] & j.column(1).valid_mask() \
        & maps.row_valid
    return maps, li, Table([_null_where(j.column(0), ~avg_ok),
                            Column(qty_c.dtype, qty_c.data[li], avg_ok)])


def tpch_q17(part: Table, lineitem: Table, brand: str = "Brand#23",
             container: str = "MED BOX") -> Q17Result:
    """q17: lineitem joined to the parts of one brand and container,
    keeping rows with l_quantity < 0.2 * avg(l_quantity) of their part.
    The correlated subquery is a groupby mean on partkey, joined back to
    the rows (two joins: the probe kernel twice on the card), then an
    exact sum of the kept prices."""
    n = lineitem.num_rows
    maps, li, keyed = _q17_joined(part, lineitem, brand, container)
    gt = groupby_aggregate(keyed, [0], [(1, "mean")]).table
    m2 = join(keyed, gt, 0, 0, out_size=n)
    li2 = m2.left_index.clamp(0, max(n - 1, 0))
    j2 = apply_join_maps(keyed, gt, m2)
    # j2: [l_partkey, l_quantity, g_partkey, g_mean]; quantity is the
    # unscaled decimal(-2), the mean a FLOAT64 in value units, compared
    # as the reference does: q < (0.2 * mean) * 100.0
    ok2 = j2.column(2).valid_mask() & m2.row_valid
    q2, mean2 = j2.column(1), j2.column(3)
    pred = (q2.data.to(torch.float64) < 0.2 * mean2.data * 100.0) \
        & ok2 & q2.valid_mask()
    row = li[li2]
    price_c = lineitem.column(L19_EXTENDEDPRICE)
    total = torch.where(pred & price_c.valid_mask()[row], price_c.data[row],
                        0).sum()
    return Q17Result(total, maps.total)


def q17_probe_inputs(part: Table, lineitem: Table,
                     brand: str = "Brand#23", container: str = "MED BOX"):
    """The probe kernel's inputs at q17's two joins, each (build,
    n_valid, probe): the selected parts' keys probed by l_partkey, then
    the groupby output's keys probed by the joined rows' keys."""
    key = _q17_build(part, brand, container).column(0)
    build1, n_valid1, _ = _sorted_valid_keys(key.data, key.valid_mask())
    _, _, keyed = _q17_joined(part, lineitem, brand, container)
    gkey = groupby_aggregate(keyed, [0], [(1, "mean")]).table.column(0)
    build2, n_valid2, _ = _sorted_valid_keys(gkey.data, gkey.valid_mask())
    return ((build1, n_valid1, lineitem.column(L19_PARTKEY).data),
            (build2, n_valid2, keyed.column(0).data))


def tpch_q17_numpy(part: Table, lineitem: Table, brand: str = "Brand#23",
                   container: str = "MED BOX") -> int:
    """Host oracle, loops over both tables: the kept prices' sum."""
    sel = set()
    pk = _host(part, P_PARTKEY).tolist()
    pb = part.column(P_BRAND).to_pylist()
    pc = part.column(P_CONTAINER).to_pylist()
    for i in range(part.num_rows):
        if pb[i] == brand and pc[i] == container:
            sel.add(pk[i])
    lkey = _host(lineitem, L19_PARTKEY).tolist()
    qty = _host(lineitem, L19_QUANTITY).tolist()
    price = _host(lineitem, L19_EXTENDEDPRICE).tolist()
    by_part: dict = {}
    for i in range(lineitem.num_rows):
        if lkey[i] in sel:
            by_part.setdefault(lkey[i], []).append(i)
    total = 0
    for rows in by_part.values():
        avg = sum(qty[i] for i in rows) / len(rows)
        for i in rows:
            if qty[i] < 0.2 * avg:
                total += price[i]
    return total


def _q17_selected(part: Table, lineitem: Table, brand: str,
                  container: str):
    """Host arrays of the lineitem rows of the selected parts: (quantity,
    their part's quantity sum, their part's row count, price)."""
    sel = (_host_codes(part.column(P_BRAND), (brand,)) == 0) \
        & (_host_codes(part.column(P_CONTAINER), (container,)) == 0)
    found, _ = _host_lookup(_host(part, P_PARTKEY)[sel],
                            np.zeros(int(sel.sum()), np.int64),
                            _host(lineitem, L19_PARTKEY))
    lkey = _host(lineitem, L19_PARTKEY)[found]
    qty = _host(lineitem, L19_QUANTITY)[found]
    _, inv = np.unique(lkey, return_inverse=True)
    sums = np.zeros(int(inv.max(initial=-1)) + 1, np.int64)
    np.add.at(sums, inv, qty)
    counts = np.bincount(inv, minlength=len(sums))
    return qty, sums[inv], counts[inv], \
        _host(lineitem, L19_EXTENDEDPRICE)[found]


def tpch_q17_oracle(part: Table, lineitem: Table, brand: str = "Brand#23",
                    container: str = "MED BOX",
                    plan_association: bool = False) -> int:
    """``tpch_q17_numpy`` vectorized: the kept prices' sum, keeping rows
    with q < 0.2 * (sum / count). With ``plan_association`` it keeps the
    rows the plan keeps, q < (0.2 * ((sum / count) * 0.01)) * 100.0 (the
    reference's mean in value units, then its association): the two
    differ on rows where q is within rounding of 0.2 * avg."""
    qty, sums, counts, price = _q17_selected(part, lineitem, brand,
                                             container)
    avg = sums.astype(np.float64) / counts  # exact int64 sums, one division
    if plan_association:
        keep = qty.astype(np.float64) < 0.2 * (avg * 0.01) * 100.0
    else:
        keep = qty < 0.2 * avg
    return int(price[keep].sum())


# ---- TPC-H q10 (returned-item reporting): two dense-PK lookups and a
# high-cardinality customer groupby ------------------------------------------

_Q10_QTR_START = 8582   # 1993-07-01
_Q10_QTR_END = 8674     # 1993-10-01
L10_RETURNFLAG = 4      # q3's lineitem with a returnflag column appended


class Q10Result(NamedTuple):
    result: GroupByResult   # [c_custkey, c_nationkey, revenue] rev desc
    join_total: torch.Tensor
    pk_violation: torch.Tensor


def tpch_q10(customer: Table, orders: Table, lineitem: Table,
             qtr_start: int = _Q10_QTR_START,
             qtr_end: int = _Q10_QTR_END) -> Q10Result:
    """q10: the returned lineitem rows, joined through the quarter's
    orders to the customer (both joins declared clustered dense-PK
    lookups: no join kernel), grouped by customer with the sort-based
    groupby (customers are too many for a declared domain), revenue
    descending. ``lineitem`` is q3's layout with an INT8 l_returnflag
    appended; ``customer`` is q5's [c_custkey, c_nationkey]. The LIMIT
    20 head is the caller's compact and slice."""
    n_cust, n_ord = customer.num_rows, orders.num_rows
    rf = lineitem.column(L10_RETURNFLAG)
    returned = rf.valid_mask() & (rf.data == ord("R"))
    price = lineitem.column(L3_EXTENDEDPRICE)
    disc = lineitem.column(L3_DISCOUNT)
    revenue = Column(t.decimal64(-4), price.data * (100 - disc.data),
                     price.valid_mask() & disc.valid_mask() & returned)
    probe = Table([_null_where(lineitem.column(L3_ORDERKEY), ~returned),
                   revenue])
    od = orders.column(O_ORDERDATE)
    in_qtr = od.valid_mask() & (od.data >= qtr_start) & (od.data < qtr_end)
    ord_build = Table([_null_where(orders.column(O_ORDERKEY), ~in_qtr),
                       orders.column(O_CUSTKEY)])
    j_o = dense_pk_join(probe, ord_build, 0, 0, 1, n_ord, clustered=True)
    j_c = dense_pk_join(Table([j_o.table.column(3)]), customer, 0,
                        C5_CUSTKEY, 1, n_cust, clustered=True)
    keep = j_o.matched & j_c.matched
    keyed = Table([
        _null_where(j_c.table.column(1), ~keep),
        j_c.table.column(2),
        Column(revenue.dtype, revenue.data, revenue.valid_mask() & keep),
    ])
    g = groupby_aggregate(keyed, [0, 1], [(2, "sum")])
    srt = sort_table(g.table, [2], ascending=[False], nulls_first=[False])
    return Q10Result(GroupByResult(srt, g.num_groups),
                     keep.to(torch.int64).sum(),
                     j_o.pk_violation | j_c.pk_violation)


def tpch_q10_numpy(customer: Table, orders: Table, lineitem: Table,
                   qtr_start: int = _Q10_QTR_START,
                   qtr_end: int = _Q10_QTR_END) -> dict:
    """Host oracle, loops over the tables: {c_custkey: (nationkey,
    revenue)}."""
    c_nat = dict(zip(_host(customer, C5_CUSTKEY).tolist(),
                     _host(customer, C5_NATIONKEY).tolist()))
    o_cust = {}
    for k, c, d in zip(_host(orders, O_ORDERKEY).tolist(),
                       _host(orders, O_CUSTKEY).tolist(),
                       _host(orders, O_ORDERDATE).tolist()):
        if qtr_start <= d < qtr_end:
            o_cust[k] = c
    out: dict = {}
    lkey = _host(lineitem, L3_ORDERKEY).tolist()
    price = _host(lineitem, L3_EXTENDEDPRICE).tolist()
    disc = _host(lineitem, L3_DISCOUNT).tolist()
    rf = _host(lineitem, L10_RETURNFLAG).tolist()
    for i in range(lineitem.num_rows):
        if rf[i] != ord("R"):
            continue
        cu = o_cust.get(lkey[i])
        if cu is None or cu not in c_nat:
            continue
        prev = out.get(cu, (c_nat[cu], 0))
        out[cu] = (c_nat[cu], prev[1] + price[i] * (100 - disc[i]))
    return out


def tpch_q10_oracle(customer: Table, orders: Table, lineitem: Table,
                    qtr_start: int = _Q10_QTR_START,
                    qtr_end: int = _Q10_QTR_END) -> dict:
    """``tpch_q10_numpy`` vectorized, as arrays ``custkey, nationkey,
    revenue`` in the query's order (revenue descending, then custkey
    ascending, the groupby's key order)."""
    odate = _host(orders, O_ORDERDATE)
    in_qtr = (odate >= qtr_start) & (odate < qtr_end)
    ret = _host(lineitem, L10_RETURNFLAG) == ord("R")
    found, cust = _host_lookup(_host(orders, O_ORDERKEY)[in_qtr],
                               _host(orders, O_CUSTKEY)[in_qtr],
                               _host(lineitem, L3_ORDERKEY)[ret])
    cust = cust[found]
    has_c, nat = _host_lookup(_host(customer, C5_CUSTKEY),
                              _host(customer, C5_NATIONKEY), cust)
    rev = (_host(lineitem, L3_EXTENDEDPRICE)[ret]
           * (100 - _host(lineitem, L3_DISCOUNT)[ret]))[found][has_c]
    cust, nat = cust[has_c], nat[has_c]
    keys, first, inv = np.unique(cust, return_index=True,
                                 return_inverse=True)
    sums = np.zeros(len(keys), np.int64)
    np.add.at(sums, inv, rev)
    order = np.lexsort((keys, -sums))
    return {"custkey": keys[order], "nationkey": nat[first][order],
            "revenue": sums[order]}


# ---- distributed plans (multiple executors, ``parallel/``) ----------------
#
# The reference runs each step inside ``jax.shard_map``; the port's steps
# take the executor mesh and the per-executor tables and run
# bulk-synchronously (``parallel/distributed.py``). Each plan takes whole
# tables in one process; ``tpch_q1_distributed`` also runs in a process
# group, where each rank passes its own lineitem rows.

_Q12_GROUP_BUDGET = 16  # |shipmode domain| = 7 plus the null pseudo-group


def q1_distributed_step(mesh, local: list):
    """The executors' q1 step: local partial groupby (truncated to the
    group budget) -> all-to-all shuffle by (returnflag, linestatus) ->
    merge groupby; afterward each executor owns a disjoint slice of the
    key space. Both halves are the out-of-core path's plans. The port's
    step takes the mesh and the executors' lineitem shards, where the
    reference's takes one device's shard inside ``shard_map``; returns
    (per-executor merged tables, per-executor group counts)."""
    from spark_rapids_jni_tpu_torch.parallel.shuffle import hash_shuffle

    budget = min(_Q1_GROUP_BUDGET, local[0].num_rows)
    partials, reals = [], []
    for shard in local:
        # the budget-bounded partial IS the head truncation: padded to
        # exactly ``budget`` rows, real groups first
        res = fusion.execute(_q1_partial_plan(), {"chunk": shard})
        partials.append(res.table)
        # only the real groups cross the wire: budget padding would all
        # hash to the null-key receiver
        ng = res.meta["partial.num_groups"]
        reals.append(torch.arange(budget, device=ng.device) < ng)
    shuffled = hash_shuffle(mesh, partials, [0, 1], capacity=budget,
                            row_valid=reals)
    # merge with max_groups=None: m = the shuffle buffer size, which can
    # never overflow
    merged = [fusion.execute(_q1_merge_plan(), {"partials": sh.table})
              for sh in shuffled]
    return ([m.table for m in merged],
            [m.meta["merge.num_groups"] for m in merged])


def tpch_q1_distributed(lineitem: Table, mesh) -> Table:
    """Multiple-executor q1: shard rows over the mesh, run the
    shuffle-backed step across it, then collect and sort the (tiny)
    result — the driver-side collect of the Spark job. In a process group
    ``lineitem`` is this rank's rows and every rank gets the result."""
    from spark_rapids_jni_tpu_torch.parallel.distributed import (
        collect,
        shard_table,
    )
    from spark_rapids_jni_tpu_torch.runtime import dispatch

    sharded = shard_table(lineitem, mesh)
    per_dev, num_groups = dispatch.sharded_call(
        "tpch_q1_distributed.step", lambda: q1_distributed_step,
        (mesh, sharded))
    result = collect(per_dev, num_groups, mesh)
    return sort_table(result, [0, 1], nulls_first=[False, False])


def _q3_inputs(customer: Table, orders: Table, lineitem: Table,
               segment: int, cutoff: int):
    """q3's filtered inputs shared by its distributed plans: the
    segment-filtered customer keys, the date-filtered orders and the
    shipdate-filtered lineitem probe with its revenue lane. Returns
    (cust, ord_t, probe)."""
    return (_q3_cust_fn(customer, segment), _q3_orders_fn(orders, cutoff),
            _q3_probe_fn(lineitem, cutoff))


def _q3_group_plan() -> fusion.Plan:
    """An executor's q3 tail (exchange 2's output -> keyed groupby)."""
    return fusion.Plan("tpch_q3_group", fusion.GroupBy(
        fusion.Project(fusion.Scan("joined"), _q3_keyed_fn), (0, 1, 2),
        ((3, "sum"),), label="groupby"))


def _q3_group_step(j: Table):
    """One executor's q3 group step over its joined rows: (table, group
    count)."""
    res = fusion.execute(_q3_group_plan(), {"joined": j})
    return res.table, res.meta["groupby.num_groups"]


def _valid_key_rows(srt: Table) -> Table:
    """The rows of a collected, sorted result whose key is valid (null
    keys sort last): the unmatched and padding pseudo-groups dropped."""
    return trim_table(srt, int(srt.column(0).valid_mask().sum()))


def tpch_q3_distributed(customer: Table, orders: Table, lineitem: Table,
                        mesh, segment: int = 0,
                        cutoff: int = _Q3_CUTOFF_DAYS,
                        out_factor: int = 4) -> Table:
    """Multiple-executor q3, the repartitioned two-exchange plan:
    exchange 1 co-locates orders and customers by custkey hash, exchange
    2 the qualifying orders with lineitem by orderkey hash (kernel D once
    per executor at each join). After exchange 2 every orderkey lives on
    one executor, so the per-executor groupbys partition the global
    answer; collect, one sort and the valid-key rows finish."""
    from spark_rapids_jni_tpu_torch.parallel.distributed import (
        any_executor,
        collect,
        distributed_join,
        shard_table,
    )

    d = mesh.size
    n_ord, n_li = orders.num_rows, lineitem.num_rows
    cust, ord_t, probe = _q3_inputs(customer, orders, lineitem, segment,
                                    cutoff)
    so, orv = shard_table(ord_t, mesh, return_row_valid=True)
    sc, crv = shard_table(cust, mesh, return_row_valid=True)
    res1 = distributed_join(
        so, sc, 0, 0, mesh,
        out_size_per_device=max(1, n_ord // max(d // 2, 1)),
        left_capacity=max(1, n_ord // d * 2),
        right_capacity=max(1, customer.num_rows // d * 2),
        left_row_valid=orv, right_row_valid=crv)
    if any_executor(mesh, res1.overflowed):
        raise ValueError("q3 exchange 1 overflowed; raise capacities")
    del so, sc, orv, crv
    # oc: [o_custkey, o_orderkey, o_orderdate, o_shippriority, c_custkey]
    build = [Table([
        Column(oc.column(1).dtype, oc.column(1).data,
               oc.column(1).valid_mask() & oc.column(4).valid_mask()),
        oc.column(2), oc.column(3)]) for oc in res1.table]
    del res1
    sp, prv = shard_table(probe, mesh, return_row_valid=True)
    # inner join: null-key build rows never match, so key validity
    # doubles as the row mask (no capacity spent on exchange-1 padding)
    res2 = distributed_join(
        sp, build, 0, 0, mesh,
        out_size_per_device=max(1, n_li * out_factor // max(d // 2, 1)),
        left_capacity=max(1, n_li // d * 2),
        right_capacity=max(1, build[0].num_rows // d * 2),
        left_row_valid=prv,
        right_row_valid=[b.column(0).valid_mask() for b in build])
    if any_executor(mesh, res2.overflowed):
        raise ValueError("q3 exchange 2 overflowed; raise capacities")
    del sp, prv, build
    joined = res2.table
    del res2
    grouped = []
    for e in range(len(joined)):
        grouped.append(_q3_group_step(joined[e]))
        joined[e] = None  # each executor's join output freed once grouped
    result = collect([g for g, _ in grouped], [n for _, n in grouped], mesh)
    return _valid_key_rows(sort_table(
        result, [3, 1], ascending=[False, True], nulls_first=[False, False]))


def tpch_q3_planned_distributed(customer: Table, orders: Table,
                                lineitem: Table, mesh, segment: int = 0,
                                cutoff: int = _Q3_CUTOFF_DAYS) -> Table:
    """Multiple-executor planned q3, the broadcast plan the dense-PK
    declarations unlock: customer and orders replicate to every executor,
    each runs both clustered-PK lookups on its lineitem shard (no join
    exchange, no kernel) and partial-aggregates revenue by orderkey; the
    only exchange is the partial-aggregate shuffle. Same contract as
    :func:`tpch_q3_distributed`. The replicated orders x customer lookup
    runs once per distinct device (executors sharing a device share it)."""
    from spark_rapids_jni_tpu_torch.parallel.distributed import (
        any_executor,
        collect,
        shard_table,
        table_to,
    )
    from spark_rapids_jni_tpu_torch.parallel.shuffle import hash_shuffle

    cust, ord_t, probe = _q3_inputs(customer, orders, lineitem, segment,
                                    cutoff)
    sp, prv = shard_table(probe, mesh, return_row_valid=True)
    n_cust, n_ord = customer.num_rows, orders.num_rows
    builds = {}
    partials, reals, viols = [], [], []
    for local, rv in zip(sp, prv):
        dev = local.columns[0].device
        if dev not in builds:
            j1 = dense_pk_join(table_to(ord_t, dev), table_to(cust, dev),
                               0, 0, 1, n_cust, clustered=True)
            builds[dev] = (Table([
                _null_where(j1.table.column(1), ~j1.matched),
                j1.table.column(2), j1.table.column(3)]), j1.pk_violation)
        build2, viol1 = builds[dev]
        j2 = dense_pk_join(local, build2, 0, 0, 1, n_ord, clustered=True)
        jt = j2.table
        matched = j2.matched & rv
        keyed = Table([
            _null_where(jt.column(0), ~matched), jt.column(3), jt.column(4),
            Column(jt.column(1).dtype, jt.column(1).data,
                   jt.column(1).valid_mask() & matched)])
        local_n = keyed.num_rows
        partial = groupby_aggregate(keyed, [0, 1, 2], [(3, "sum")],
                                    max_groups=local_n)
        partials.append(partial.table)
        reals.append(torch.arange(local_n, device=dev) < partial.num_groups)
        viols.append(viol1 | j2.pk_violation)
    del builds
    # a sender holds <= local_n real partial rows in all, so the lane
    # capacity local_n can never overflow
    shuffled = hash_shuffle(mesh, partials, [0], capacity=local_n,
                            row_valid=reals)
    del partials
    merged = [groupby_aggregate(sh.table, [0, 1, 2], [(3, "sum")])
              for sh in shuffled]
    if any_executor(mesh, viols):
        raise ValueError(
            "dense-PK declaration violated — re-plan with "
            "tpch_q3_distributed")
    result = collect([m.table for m in merged],
                     [m.num_groups for m in merged], mesh)
    return _valid_key_rows(sort_table(
        result, [3, 1], ascending=[False, True], nulls_first=[False, False]))


def tpch_q5_distributed(customer: Table, orders: Table, lineitem: Table,
                        supplier: Table, nation: Table, mesh,
                        region_of_interest: int = 1,
                        year_start: int = _Q5_YEAR_START,
                        year_end: int = _Q5_YEAR_END) -> Q5Result:
    """Multiple-executor q5 with ZERO shuffles: lineitem shards row-wise,
    the four dimension tables replicate, each executor runs the
    dense-PK lookups and the 25-slot bounded nation groupby on its shard
    (kernel A once per executor on the card), and the global merge is
    one sum over the 26-slot partials. The result is replicated; the
    schema is ``tpch_q5``'s."""
    from spark_rapids_jni_tpu_torch.parallel.distributed import (
        shard_table,
        table_to,
    )

    sl, rv = shard_table(lineitem, mesh, return_row_valid=True)
    gs, viols = [], []
    for local, lrv in zip(sl, rv):
        dev = local.columns[0].device
        keyed, viol = _q5_keyed(
            table_to(customer, dev), table_to(orders, dev), local,
            table_to(supplier, dev), table_to(nation, dev),
            region_of_interest, year_start, year_end)
        gs.append(plan_groupby(keyed, [0], _Q5_AGGS, _q5_domains(),
                               row_valid=lrv))
        viols.append(viol)
    if any(g.lowered != "bounded" for g in gs):
        raise AssertionError("q5's nation domain must lower to the "
                             "bounded plan")

    def flag(xs):
        return mesh.psum([x.to(torch.int32).reshape(-1) for x in xs])[0] > 0

    sums = mesh.psum([torch.where(g.table.column(1).valid_mask(),
                                  g.table.column(1).data, 0) for g in gs])[0]
    valid_g = flag([g.table.column(1).valid_mask() for g in gs])
    viol = flag(viols)[0]
    miss = flag([g.domain_miss for g in gs])[0]
    keys = gs[0].table.column(0).data
    lens, mat = static_strings(
        list(_Q5_NATIONS) + [None] * (keys.shape[0] - len(_Q5_NATIONS)),
        keys.device)
    out = Table([Column(t.INT64, keys, valid_g),
                 Column(t.decimal64(-4), sums, valid_g),
                 Column(t.STRING, lens, valid_g, chars=mat)])
    srt = sort_table(out, [1], ascending=[False], nulls_first=[False])
    return Q5Result(srt, srt.column(0).valid_mask(), viol, miss)


def tpch_q12_distributed(orders: Table, lineitem: Table, mesh,
                         modes: tuple = ("MAIL", "SHIP"),
                         year_start: int = _Q12_YEAR_START,
                         year_end: int = _Q12_YEAR_END) -> Table:
    """Multiple-executor q12: the repartitioned orderkey join (kernel D
    once per executor), then the two-phase aggregation — per-executor
    partial groupby on the shipmode domain, partial rows shuffled by key
    hash, merged, collected and shipmode-sorted."""
    from spark_rapids_jni_tpu_torch.parallel.distributed import (
        any_executor,
        collect,
        distributed_join,
        shard_table,
    )
    from spark_rapids_jni_tpu_torch.parallel.shuffle import hash_shuffle

    if len(modes) + 1 > _Q12_GROUP_BUDGET:
        raise ValueError(
            f"q12 mode domain {len(modes)} exceeds the partial-groupby "
            f"budget {_Q12_GROUP_BUDGET}")
    # WHERE -> nulled join key (the single-device plan's predicate)
    mode_c = pad_strings(lineitem.column(L12_SHIPMODE))
    keep = _q12_keep(lineitem, mode_c, modes, year_start, year_end)
    probe = Table([_null_where(lineitem.column(L12_ORDERKEY), ~keep),
                   mode_c])
    build = Table([orders.column(O12_ORDERKEY),
                   pad_strings(orders.column(O12_ORDERPRIORITY))])
    sl, lrv = shard_table(probe, mesh, return_row_valid=True)
    sr, rrv = shard_table(build, mesh, return_row_valid=True)
    nl = probe.num_rows
    d = mesh.size
    # per-executor capacities (the q3 sizing): 2x skew headroom; overflow
    # is checked below and is the caller's retry signal
    res = distributed_join(
        sl, sr, [0], [0], mesh,
        out_size_per_device=max(1, nl // d * 2),
        left_capacity=max(1, nl // d * 2),
        right_capacity=max(1, orders.num_rows // d * 2),
        left_row_valid=lrv, right_row_valid=rrv)
    if any_executor(mesh, res.overflowed):
        raise ValueError(
            "q12 join exchange overflowed its per-device capacity "
            "(key skew); retry with a larger capacity factor")
    del sl, sr, lrv, rrv
    partials, reals = [], []
    for j in res.table:
        # j: [l_orderkey, l_shipmode, o_orderkey, o_orderpriority]
        matched = j.column(2).valid_mask()
        high, low = _q12_priority_lanes(j.column(3), matched)
        mode_j = j.column(1)
        keyed = Table([
            Column(mode_j.dtype, torch.where(matched, mode_j.data, 0),
                   matched,
                   chars=mode_j.chars.masked_fill(~matched[:, None], 0)),
            high, low])
        budget = min(_Q12_GROUP_BUDGET, keyed.num_rows)
        partial = groupby_aggregate(keyed, [0], _Q12_AGGS,
                                    max_groups=budget)
        partials.append(partial.table)
        reals.append(torch.arange(budget, device=matched.device)
                     < partial.num_groups)
    del res
    shuffled = hash_shuffle(mesh, partials, [0], capacity=budget,
                            row_valid=reals)
    merged = [groupby_aggregate(sh.table, [0], _Q12_AGGS)
              for sh in shuffled]
    result = collect([m.table for m in merged],
                     [m.num_groups for m in merged], mesh)
    return _valid_key_rows(sort_table(result, [0], nulls_first=[False]))


# ---- TPC-H q13 (customer distribution) over the exchange -----------------
#
#   SELECT o_custkey, count(o_orderkey) FROM orders GROUP BY o_custkey
#
# q13's inner aggregation: order counts per customer key, a key space no
# slot table covers. The distributed form is partial counts per shard ->
# the hash-partitioned exchange by custkey (runtime/exchange.py) -> a sum
# per destination; the merge is re-applicable (a sum of counts), so the
# exchange's chunked spill merge composes with it.


def q13_partial_plan() -> fusion.Plan:
    """A shard's q13 partial: order counts per customer key, unbounded
    (``max_groups=None`` pads to the shard's rows and cannot
    overflow)."""
    return fusion.Plan("tpch_q13_partial", fusion.GroupBy(
        fusion.Scan("orders"), (O_CUSTKEY,), ((O_ORDERKEY, "count"),),
        max_groups=None, label="partial"))


def q13_merge_plan() -> fusion.Plan:
    """A destination's q13 merge: the partial counts summed per customer
    key (``merge(merge(a) + merge(b)) == merge(a + b)``)."""
    return fusion.Plan("tpch_q13_merge", fusion.GroupBy(
        fusion.Scan("partials"), (0,), ((1, "sum"),),
        max_groups=None, label="merge"))


def q13_exchange_plans(parts: int):
    """The (pack, merge) pair of the distributed q13: the pack plan roots
    an ``Exchange`` over the partial (key: the custkey output column;
    ``valid_meta`` trims the groupby's padding before the wire), the
    merge plan scans ``partials``. Drive it through
    ``QueryCluster.submit_exchange``, or :func:`tpch_q13_local`."""
    pack = fusion.Plan("tpch_q13_pack", fusion.Exchange(
        q13_partial_plan().root, keys=(0,), parts=int(parts),
        valid_meta="partial.num_groups", label="exchange"))
    return pack, q13_merge_plan()


def q13_midplan_plan(parts: int) -> fusion.Plan:
    """q13 as ONE plan with an interior ``Exchange`` (partial groupby ->
    exchange by custkey -> sum), which ``fusion.split_at_exchange``
    breaks into the pair of :func:`q13_exchange_plans`. ``parts=0``
    leaves the count to the learned-selectivity store."""
    return fusion.Plan("tpch_q13_midplan", fusion.GroupBy(
        fusion.Exchange(
            q13_partial_plan().root, keys=(0,), parts=int(parts),
            valid_meta="partial.num_groups", label="exchange"),
        (0,), ((1, "sum"),), max_groups=None, label="merge"))


def tpch_q13_local(orders: Table, parts: int = 1, *,
                   shard_keys=(O_ORDERKEY,)) -> Table:
    """The distributed q13 in one process, its bit-identity oracle: the
    same plans over the same shard split (``shard_keys`` must be the
    cluster's ``register_table`` keys) and the same source-then-flight
    regroup order as ``submit_exchange(...).result()``."""
    from spark_rapids_jni_tpu_torch.ops.table_ops import (
        _slice_rows,
        concatenate,
    )
    from spark_rapids_jni_tpu_torch.parallel import dcn
    from spark_rapids_jni_tpu_torch.runtime import exchange as xch

    parts = int(parts)
    pack, merge = q13_exchange_plans(parts)
    shards = (dcn.partition_for_slices(orders, list(shard_keys), parts)
              if parts > 1 else [orders])
    per_dest: list = [[] for _ in range(parts)]
    empty = None
    for shard in shards:
        fused = fusion.execute(pack, {"orders": shard})
        empty = _slice_rows(fused.table, 0, 0)
        for p, fls in enumerate(xch.split_wire(
                fused.table, fused.meta["exchange.row_counts"], parts)):
            per_dest[p].extend(fls)
    outs = []
    for flights in per_dest:
        if not flights:
            continue
        dest_in = flights[0] if len(flights) == 1 else concatenate(flights)
        res = fusion.execute(merge, {"partials": dest_in})
        outs.append(_slice_rows(res.table, 0,
                                int(res.meta["merge.num_groups"])))
    if not outs:
        res = fusion.execute(merge, {"partials": empty})
        return _slice_rows(res.table, 0, 0)
    return outs[0] if len(outs) == 1 else concatenate(outs)


def tpch_q13_reference(orders: Table) -> Table:
    """q13's order count per customer as one general groupby of orders on
    ``o_custkey`` (every group kept), trimmed to its groups, in key
    order: the same groups and counts as :func:`tpch_q13_local` up to
    row order."""
    g = groupby_aggregate(orders, [O_CUSTKEY], [(O_ORDERKEY, "count")],
                          max_groups=None)
    return trim_table(g.table, int(g.num_groups))


def tpch_q13_oracle(orders: Table) -> dict:
    """``tpch_q13_reference`` on the host: ``np.bincount`` of the
    customer keys (valid rows with a valid order key), restricted to the
    keys that occur, ascending."""
    ok = _host_valid(orders, O_CUSTKEY) & _host_valid(orders, O_ORDERKEY)
    counts = np.bincount(_host(orders, O_CUSTKEY)[ok])
    keys = np.flatnonzero(counts)
    return {"custkey": keys.astype(np.int64), "count": counts[keys]}


# ---- warm-up builders (runtime/server.QueryServer.warmup) -----------------
#
# The learned-estimate file keys plans as ``<plan>@<bucket>``; a new
# server replays its costliest ones through these builders at the
# signature's rows. Only single-table plans register: their bucket maps
# onto one table's rows (a multi-table plan such as q3 has no unique
# split of a total-row bucket).

def _register_warmup_builders() -> None:
    from spark_rapids_jni_tpu_torch.runtime.server import (
        register_warmup_builder,
    )

    register_warmup_builder(
        "tpch_q1", lambda rows: tpch_q1(lineitem_table(rows)))
    register_warmup_builder(
        "tpch_q1_planned",
        lambda rows: tpch_q1_planned(lineitem_table(rows)))
    register_warmup_builder(
        "tpch_q6", lambda rows: tpch_q6(lineitem_table(rows)))


_register_warmup_builders()
