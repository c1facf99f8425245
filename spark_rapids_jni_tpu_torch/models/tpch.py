"""TPC-H workload pipelines (counterpart of
``spark_rapids_jni_tpu/models/tpch.py``, q1 part).

TPC-H q1 (pricing summary report):

    SELECT l_returnflag, l_linestatus,
           sum(l_quantity), sum(l_extendedprice),
           sum(l_extendedprice*(1-l_discount)),
           sum(l_extendedprice*(1-l_discount)*(1+l_tax)),
           avg(l_quantity), avg(l_extendedprice), avg(l_discount), count(*)
    FROM lineitem WHERE l_shipdate <= date '1998-12-01' - 90 days
    GROUP BY l_returnflag, l_linestatus ORDER BY l_returnflag, l_linestatus

Money columns use decimal64(-2) (the spec's DECIMAL(12,2)). The planned
q1 composes the reference's fusion plan directly: the filter/derive work
table, then ``plan_groupby`` with the DDL flag domains. The fused
single-kernel q1 is ``ops/kernels/q1.py::tpch_q1_pallas``.
"""

from __future__ import annotations

import numpy as np

from spark_rapids_jni_tpu_torch import types as t
from spark_rapids_jni_tpu_torch.columnar import Column, Table
from spark_rapids_jni_tpu_torch.ops.planner import (
    PlannedGroupBy,
    plan_groupby,
    scalar_domain,
)
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

