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

Money columns use decimal64(-2) (the spec's DECIMAL(12,2)). Each plan
composes the nodes of the reference's fusion plan directly, in its
order: the general q1 is the filter/derive work table, the sort-based
groupby with the plan's group budget, and the ORDER BY; the planned q1
lowers the groupby through ``plan_groupby`` with the DDL flag domains.
The fused single-kernel q1 is ``ops/kernels/q1.py::tpch_q1_pallas``.
TPC-H q3 is further down.
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
    dense_pk_join,
    plan_groupby,
    scalar_domain,
)
from spark_rapids_jni_tpu_torch.ops.sort import gather, sort_order
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


def _q1_work_table(lineitem: Table) -> Table:
    """Shared q1 front half: WHERE filter + derived decimal columns.

    The filter keeps shapes static by masking validity instead of
    compacting rows (masked rows fall out of every null-skipping
    aggregate). Keys are fixed-width only in this port."""
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
        if not c.dtype.is_fixed_width:
            raise NotImplementedError(
                "q1 string flag columns are not ported yet")
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


def tpch_q1_planned_result(lineitem: Table) -> PlannedGroupBy:
    """q1 with PLANNER-DECLARED key domains: the flag domains come from
    the TPC-H DDL, so grouping needs no sort — one streaming pass
    (groupby_aggregate_bounded, the accumulate kernel on the card) — and
    the output order is static (real groups lexicographic, null groups
    last). Returns the planner result so callers can observe
    ``domain_miss``."""
    work = _q1_work_table(lineitem)
    res = plan_groupby(
        work, (0, 1), _Q1_AGGS,
        domains=(scalar_domain(_Q1_RF_DOMAIN), scalar_domain(_Q1_LS_DOMAIN)))
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

    qty = host(L_QUANTITY)
    price = host(L_EXTENDEDPRICE)
    disc = host(L_DISCOUNT)
    tax = host(L_TAX)
    rf = host(L_RETURNFLAG)
    ls = host(L_LINESTATUS)
    ship = host(L_SHIPDATE)
    keep = ship <= _Q1_CUTOFF_DAYS
    out = {}
    for f in np.unique(rf[keep]):
        for s in np.unique(ls[keep]):
            m = keep & (rf == f) & (ls == s)
            if not m.any():
                continue
            dp = price[m] * (100 - disc[m])
            out[(int(f), int(s))] = {
                "sum_qty": int(qty[m].sum()),
                "sum_base_price": int(price[m].sum()),
                "sum_disc_price": int(dp.sum()),
                "sum_charge": int((dp * (100 + tax[m])).sum()),
                # true values: unscaled decimal(scale -2) means x 10^-2
                "avg_qty": qty[m].mean() * 1e-2,
                "avg_price": price[m].mean() * 1e-2,
                "avg_disc": disc[m].mean() * 1e-2,
                "count": int(m.sum()),
            }
    return out


def _q1_general(lineitem: Table) -> GroupByResult:
    """q1's general plan (the reference's ``_q1_plan``): work table ->
    sort-based groupby under the group budget -> ORDER BY flag, status
    with nulls last, so the filtered-out null-key group follows the real
    ones."""
    g = groupby_aggregate(_q1_work_table(lineitem), (0, 1), _Q1_AGGS,
                          max_groups=_Q1_GROUP_BUDGET)
    order = sort_order(g.table, (0, 1), nulls_first=(False, False))
    return GroupByResult(gather(g.table, order), g.num_groups, g.overflowed)


def tpch_q1(lineitem: Table) -> Table:
    """General q1: filter -> derived columns -> groupby -> sort, padded to
    the 64-group budget. On data outside the TPC-H flag domains (64 or
    more distinct byte pairs) the excess groups are dropped; use
    ``tpch_q1_checked`` to turn that into an error."""
    return _q1_general(lineitem).table


def tpch_q1_checked(lineitem: Table) -> Table:
    """General q1 that raises instead of silently dropping groups on
    out-of-contract data."""
    res = _q1_general(lineitem)
    if bool(res.overflowed):
        raise ValueError(
            f"q1 key domain exceeded the plan's group budget "
            f"({int(res.num_groups)} > {_Q1_GROUP_BUDGET}): the "
            f"returnflag/linestatus bytes are outside the TPC-H contract")
    return res.table


def tpch_q1_planned_checked(lineitem: Table) -> Table:
    """Planned q1 whose domain misses re-plan onto the general sort-based
    q1 instead of dropping rows."""
    res = tpch_q1_planned_result(lineitem)
    if bool(res.domain_miss):
        return tpch_q1_checked(lineitem)
    return res.table


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
    return Column(c.dtype, c.data, c.valid_mask() & ~drop)


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


def _q3_inputs(customer: Table, orders: Table, lineitem: Table,
               segment: int, cutoff: int):
    """The filtered inputs both q3 plans share: (cust, ord_t, probe)."""
    return (_q3_cust_fn(customer, segment),
            _q3_orders_fn(orders, cutoff),
            _q3_probe_fn(lineitem, cutoff))


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


def _q3_order_by(g: GroupByResult) -> GroupByResult:
    """ORDER BY revenue DESC, o_orderdate, nulls last; ties keep the
    groupby's key order."""
    order = sort_order(g.table, (3, 1), ascending=(False, True),
                       nulls_first=(False, False))
    return GroupByResult(gather(g.table, order), g.num_groups)


class Q3Result(NamedTuple):
    result: GroupByResult  # [l_orderkey, o_orderdate, o_shippriority, rev]
    join_total: torch.Tensor  # true lineitem x orders match count
    out_cap: int              # join output bound (check total <= cap)


def _q3_joined(customer: Table, orders: Table, lineitem: Table,
               segment: int, cutoff: int, out_factor: int):
    """q3 up to the groupby: filter all three inputs, orders x customer
    (capacity: orders rows), lineitem x orders (capacity: ``out_factor``
    x lineitem rows). Returns (groupby input, join 2's total, its
    capacity)."""
    cust, ord_t, probe = _q3_inputs(customer, orders, lineitem, segment,
                                    cutoff)
    maps1 = join(ord_t, cust, [0], [0], orders.num_rows)
    build = _q3_build_fn(apply_join_maps(ord_t, cust, maps1))
    out_cap = lineitem.num_rows * out_factor
    maps2 = join(probe, build, [0], [0], out_cap)
    return (_q3_keyed_fn(apply_join_maps(probe, build, maps2)), maps2.total,
            out_cap)


def q3_probe_inputs(customer: Table, orders: Table, lineitem: Table,
                    segment: int = 0, cutoff: int = _Q3_CUTOFF_DAYS):
    """The join probe kernel's inputs at q3's two joins, for timing and
    checking the kernel alone: ((build, n_valid, probe) of join 1, the
    same of join 2), each build sorted and sentinel-padded as ``join``
    gives it to the kernel."""
    cust, ord_t, probe = _q3_inputs(customer, orders, lineitem, segment,
                                    cutoff)
    key = cust.column(0)
    build1, n_valid1, _ = _sorted_valid_keys(key.data, key.valid_mask())
    maps1 = join(ord_t, cust, [0], [0], orders.num_rows)
    key = _q3_build_fn(apply_join_maps(ord_t, cust, maps1)).column(0)
    build2, n_valid2, _ = _sorted_valid_keys(key.data, key.valid_mask())
    return ((build1, n_valid1, ord_t.column(0).data),
            (build2, n_valid2, probe.column(0).data))


def tpch_q3(customer: Table, orders: Table, lineitem: Table,
            segment: int = 0, cutoff: int = _Q3_CUTOFF_DAYS,
            out_factor: int = 2) -> Q3Result:
    """General q3, the reference's ``_q3_plan`` node by node: the two
    joins (``_q3_joined``), the groupby padded to its input rows, the
    ORDER BY. Callers compact (``num_groups`` rows) and check
    ``join_total <= out_cap``: past it, matches were dropped."""
    keyed, total, out_cap = _q3_joined(customer, orders, lineitem, segment,
                                       cutoff, out_factor)
    g = groupby_aggregate(keyed, (0, 1, 2), ((3, "sum"),))
    return Q3Result(_q3_order_by(g), total, out_cap)


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


def tpch_q3_planned(customer: Table, orders: Table, lineitem: Table,
                    segment: int = 0,
                    cutoff: int = _Q3_CUTOFF_DAYS) -> Q3PlannedResult:
    """q3 with PLANNER-DECLARED dense clustered primary keys (custkey =
    1..|C| in customer, orderkey = 1..|O| in orders, the TPC-H DDL and
    load-order facts): both joins are arithmetic plus a gather, with no
    join kernel and no capacity. One output row per lineitem row; the
    groupby stays sort-based."""
    cust, ord_t, probe = _q3_inputs(customer, orders, lineitem, segment,
                                    cutoff)
    j1 = dense_pk_join(ord_t, cust, 0, 0, 1, customer.num_rows,
                       clustered=True)
    build2 = _q3_build2_fn(j1.table)
    j2 = dense_pk_join(probe, build2, 0, 0, 1, orders.num_rows,
                       clustered=True)
    g = groupby_aggregate(_q3_planned_keyed_fn(j2.table), (0, 1, 2),
                          ((3, "sum"),))
    return Q3PlannedResult(_q3_order_by(g), j2.total,
                           j1.pk_violation | j2.pk_violation)


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
        & np.isin(host(orders, O_CUSTKEY), good_cust)
    okey = host(orders, O_ORDERKEY)[keep]
    ukey, first = np.unique(okey[::-1], return_index=True)
    last = len(okey) - 1 - first
    odate = host(orders, O_ORDERDATE)[keep][last]
    oprio = host(orders, O_SHIPPRIORITY)[keep][last]

    lmask = host(lineitem, L3_SHIPDATE) > cutoff
    lkey = host(lineitem, L3_ORDERKEY)[lmask]
    rev = host(lineitem, L3_EXTENDEDPRICE)[lmask] \
        * (100 - host(lineitem, L3_DISCOUNT)[lmask])
    pos = np.searchsorted(ukey, lkey)
    hit = pos < len(ukey)
    hit[hit] = ukey[pos[hit]] == lkey[hit]
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
