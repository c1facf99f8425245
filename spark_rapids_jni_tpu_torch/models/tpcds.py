"""TPC-DS join family (counterpart of ``spark_rapids_jni_tpu/models/tpcds.py``,
its single-device plans).

Structurally faithful, predicate-trimmed versions of q72 and q64, and
TPC-DS q3:

  q72: catalog_sales |x| date_dim (year filter) |x| item |x| inventory on
  the packed (item, week) key, with the post-filter
  inv_quantity_on_hand < cs_quantity, then a count per (item, brand),
  ORDER BY count desc, item.

  q64: store_sales(year1) |x| store_sales(year2) on the packed (item,
  customer) key, then a count per item, ORDER BY count desc, item.

  q3: store_sales |x| date_dim (month filter) |x| item (manufacturer
  filter), revenue per (d_year, i_brand_id), ORDER BY revenue desc.

A WHERE before a join nulls the join key (null keys never match); a
WHERE after a join nulls validity so the row falls out of the aggregate.
The general q72 and q64 are the reference's plans
(``runtime/fusion.py``) and run through ``fusion.execute``, as there
(join capacities from the fact table's row count, the groupby padded to
its input rows); the planned plans and q3 compose their operators
directly, as the reference's do, with the dense primary-key join and
the dense-id reductions of ``ops/planner.py``. On the card the general
plans' joins launch the join probe kernel (``join.hash_probe``): three
times per q72, once per q64; the planned plans and q3 launch none.

The generators draw the reference's numpy values from the same seeds, in
the same order and dtypes, so both packages see the same rows.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from spark_rapids_jni_tpu_torch import types as t
from spark_rapids_jni_tpu_torch.columnar import Column, Table
from spark_rapids_jni_tpu_torch.models.tpch import join_probe_inputs
from spark_rapids_jni_tpu_torch.ops.groupby import (
    GroupByResult,
    groupby_aggregate,
)
from spark_rapids_jni_tpu_torch.ops.planner import (
    dense_id_counts,
    dense_id_sums,
    dense_pk_join,
)
from spark_rapids_jni_tpu_torch.ops.sort import sort_table
from spark_rapids_jni_tpu_torch.runtime import fusion
from spark_rapids_jni_tpu_torch.utils.platform import resolve_device

# Composite-key packing bounds (the generators respect these).
MAX_WEEKS = 512
MAX_CUSTOMERS = 1 << 20


# ---- synthetic data (TPC-DS-flavored distributions) ------------------------


def _table(arrays, dtypes, device) -> Table:
    device = resolve_device(device)
    return Table([Column.from_numpy(a, dt, device=device)
                  for a, dt in zip(arrays, dtypes)])


def date_dim_table(num_days: int = 730, start_year: int = 2000,
                   device=None) -> Table:
    """d_date_sk, d_week_seq, d_year. ``device=None`` puts the columns on
    the CUDA device and raises when there is none."""
    sk = np.arange(1, num_days + 1, dtype=np.int64)
    week = ((sk - 1) // 7 + 1).astype(np.int64)
    year = (start_year + (sk - 1) // 365).astype(np.int32)
    return _table((sk, week, year), (t.INT64, t.INT64, t.INT32), device)


D_DATE_SK, D_WEEK_SEQ, D_YEAR = 0, 1, 2


def item_table(num_items: int = 1000, seed: int = 0, device=None) -> Table:
    """i_item_sk, i_brand_id, i_category_id."""
    rng = np.random.default_rng(seed)
    sk = np.arange(1, num_items + 1, dtype=np.int64)
    brand = rng.integers(1, 100, num_items).astype(np.int32)
    cat = rng.integers(1, 11, num_items).astype(np.int32)
    return _table((sk, brand, cat), (t.INT64, t.INT32, t.INT32), device)


I_ITEM_SK, I_BRAND_ID, I_CATEGORY_ID = 0, 1, 2


def catalog_sales_table(num_rows: int, num_items: int = 1000,
                        num_days: int = 730, seed: int = 1,
                        device=None) -> Table:
    """cs_item_sk, cs_sold_date_sk, cs_quantity, cs_order_number."""
    rng = np.random.default_rng(seed)
    item = rng.integers(1, num_items + 1, num_rows).astype(np.int64)
    date = rng.integers(1, num_days + 1, num_rows).astype(np.int64)
    qty = rng.integers(1, 100, num_rows).astype(np.int64)
    order = np.arange(num_rows, dtype=np.int64)
    return _table((item, date, qty, order), (t.INT64,) * 4, device)


CS_ITEM_SK, CS_SOLD_DATE_SK, CS_QUANTITY, CS_ORDER_NUMBER = 0, 1, 2, 3


def inventory_table(num_items: int = 1000, num_weeks: int = 105,
                    seed: int = 2, device=None) -> Table:
    """inv_item_sk, inv_week_seq, inv_quantity_on_hand: one row per
    (item, week), the TPC-DS inventory grain at one warehouse."""
    rng = np.random.default_rng(seed)
    item = np.repeat(np.arange(1, num_items + 1, dtype=np.int64), num_weeks)
    week = np.tile(np.arange(1, num_weeks + 1, dtype=np.int64), num_items)
    qty = rng.integers(0, 120, num_items * num_weeks).astype(np.int64)
    return _table((item, week, qty), (t.INT64,) * 3, device)


INV_ITEM_SK, INV_WEEK_SEQ, INV_QTY = 0, 1, 2


def store_sales_table(num_rows: int, num_items: int = 1000,
                      num_customers: int = 5000, num_days: int = 730,
                      seed: int = 3, device=None) -> Table:
    """ss_item_sk, ss_customer_sk, ss_sold_date_sk."""
    rng = np.random.default_rng(seed)
    item = rng.integers(1, num_items + 1, num_rows).astype(np.int64)
    cust = rng.integers(1, num_customers + 1, num_rows).astype(np.int64)
    date = rng.integers(1, num_days + 1, num_rows).astype(np.int64)
    return _table((item, cust, date), (t.INT64,) * 3, device)


SS_ITEM_SK, SS_CUSTOMER_SK, SS_SOLD_DATE_SK = 0, 1, 2


def _pack_key(a: Column, b: Column, b_bound: int) -> Column:
    """Exact composite int64 key a*b_bound + b (wrapping int64, as the
    reference's); null if either side is null."""
    return Column(t.INT64, a.data * b_bound + b.data,
                  a.valid_mask() & b.valid_mask())


def _null_keys_where(col: Column, drop: torch.Tensor) -> Column:
    """WHERE-before-join: null out the join key where ``drop`` (null keys
    never match). Validity only; the data stays."""
    return Column(col.dtype, col.data, col.valid_mask() & ~drop)


def _floor_div(x: torch.Tensor, d: int) -> torch.Tensor:
    """``x // d`` rounded down, as JAX's ``//`` on integers."""
    return torch.div(x, d, rounding_mode="floor")


# ---- q72 -------------------------------------------------------------------


def _q72_dd_fn(date_dim: Table, year: int) -> Table:
    """date_dim build side with WHERE d_year = year pushed into the key
    (wrong-year dates get null keys and never match)."""
    dd_key = _null_keys_where(date_dim.column(D_DATE_SK),
                              date_dim.column(D_YEAR).data != year)
    return Table([dd_key, date_dim.column(D_WEEK_SEQ)])


def _q72_probe_fn(j2: Table) -> Table:
    """sales x dates x items -> the composite (item, week) probe against
    the inventory grain: [key, cs_item, cs_qty, i_item_sk, i_brand_id]."""
    # j2: [cs_item, cs_date, cs_qty, cs_order, d_date_sk, d_week_seq,
    #      i_item_sk, i_brand_id, i_category_id]
    probe_key = _pack_key(
        Column(t.INT64, j2.column(0).data, j2.column(0).valid_mask()),
        Column(t.INT64, j2.column(5).data, j2.column(5).valid_mask()),
        MAX_WEEKS)
    return Table([probe_key] + [j2.column(i) for i in (0, 2, 6, 7)])


def _q72_inv_fn(inventory: Table) -> Table:
    """Inventory keyed by the packed (item, week) composite."""
    inv_key = _pack_key(inventory.column(INV_ITEM_SK),
                        inventory.column(INV_WEEK_SEQ), MAX_WEEKS)
    return Table([inv_key, inventory.column(INV_QTY)])


def _q72_keyed_fn(j3: Table) -> Table:
    """WHERE inv_quantity_on_hand < cs_quantity, after the join."""
    # j3: [key, cs_item, cs_qty, i_item_sk, i_brand, inv_key, inv_qty]
    short = j3.column(6).data < j3.column(2).data
    keep = j3.column(6).valid_mask() & j3.column(2).valid_mask() & short
    return Table([
        _null_keys_where(j3.column(3), ~keep),
        _null_keys_where(j3.column(4), ~keep),
        Column(t.INT64, j3.column(1).data, keep),
    ])


def _q72_plan(year: int, out_factor: int) -> fusion.Plan:
    """q72 (the reference's ``_q72_plan``): catalog_sales x year-filtered
    dates (join 1) x items (join 2), each at capacity ``catalog_sales``
    rows, the packed (item, week) probe x the inventory grain (join 3,
    ``out_factor`` x the fact rows), the post-filter, the count per
    (item, brand), ORDER BY count desc, item asc, nulls last."""
    cs = fusion.Scan("catalog_sales")
    dd = fusion.Project(fusion.Scan("date_dim"), _q72_dd_fn, (year,))
    j1 = fusion.Join(cs, dd, (CS_SOLD_DATE_SK,), (0,),
                     fusion.rows_of("catalog_sales"), label="join1")
    j2 = fusion.Join(j1, fusion.Scan("item"), (0,), (I_ITEM_SK,),
                     fusion.rows_of("catalog_sales"), label="join2")
    probe = fusion.Project(j2, _q72_probe_fn)
    inv = fusion.Project(fusion.Scan("inventory"), _q72_inv_fn)
    j3 = fusion.Join(probe, inv, (0,), (0,),
                     fusion.rows_of("catalog_sales", out_factor),
                     label="join3")
    g = fusion.GroupBy(fusion.Project(j3, _q72_keyed_fn), (0, 1),
                       ((2, "count"),), label="groupby")
    return fusion.Plan("tpcds_q72", fusion.Sort(
        g, (2, 0), ascending=(False, True), nulls_first=(False, False)))


def _q72_bindings(catalog_sales: Table, date_dim: Table, item: Table,
                  inventory: Table) -> dict:
    return {"catalog_sales": catalog_sales, "date_dim": date_dim,
            "item": item, "inventory": inventory}


def tpcds_q72(catalog_sales: Table, date_dim: Table, item: Table,
              inventory: Table, year: int = 2000,
              out_factor: int = 2) -> GroupByResult:
    """Count, per item, catalog sales in ``year`` where on-hand inventory
    in the sale's week was below the ordered quantity (the q72 core),
    through ``fusion.execute`` (``_q72_plan``). Returns groups
    (i_item_sk, i_brand_id, count) padded to join 3's capacity; callers
    ``compact()``."""
    res = fusion.execute(
        _q72_plan(year, out_factor),
        _q72_bindings(catalog_sales, date_dim, item, inventory))
    return GroupByResult(res.table, res.meta["groupby.num_groups"])


def q72_probe_inputs(catalog_sales: Table, date_dim: Table, item: Table,
                     inventory: Table, year: int = 2000) -> list:
    """The join probe kernel's inputs at q72's three joins (sub-plans of
    ``_q72_plan``): ``[(build, n_valid, probe), ...]``."""
    return join_probe_inputs(
        _q72_plan(year, 2),
        _q72_bindings(catalog_sales, date_dim, item, inventory),
        ("join1", "join2", "join3"))


class Q72PlannedResult(NamedTuple):
    table: Table              # [i_item_sk, i_brand_id, count], count desc
    present: torch.Tensor     # bool[num_items]: item had short sales
    pk_violation: torch.Tensor


def _q72_planned_counts(catalog_sales: Table, dd: Table, item: Table,
                        inventory: Table, num_weeks: int,
                        row_valid=None) -> tuple:
    """Planned q72's counts over one set of sales rows: (int64[num_items]
    short-sale counts per item, 0-d pk violation). ``dd`` is
    ``_q72_dd_fn``'s year-keyed date build; ``row_valid`` False rows
    (shard padding) count nowhere."""
    num_items = item.num_rows
    # join 1: sale -> its date row, the year filter in the build key
    j1 = dense_pk_join(catalog_sales, dd, CS_SOLD_DATE_SK, 0, 1,
                       dd.num_rows, clustered=True)
    # j1: [cs_item, cs_date, cs_qty, cs_order, d_date_sk, d_week_seq]
    # join 2: sale -> its item row
    j2 = dense_pk_join(j1.table, item, CS_ITEM_SK, I_ITEM_SK, 1, num_items,
                       clustered=True)
    # join 3: (item, week) -> the inventory grid row, pure arithmetic,
    # checked against the landed row (a non-grid layout would alias)
    cs_item = j2.table.column(0)
    week = j2.table.column(5)
    week64 = week.data.to(torch.int64)
    grid = (cs_item.data - 1) * num_weeks + (week64 - 1)
    in_grid = (j1.matched & j2.matched & cs_item.valid_mask()
               & week.valid_mask() & (week.data >= 1)
               & (week.data <= num_weeks) & (grid >= 0)
               & (grid < inventory.num_rows))
    if row_valid is not None:
        in_grid = in_grid & row_valid
    pos = grid.clamp(0, inventory.num_rows - 1)
    inv_qty = inventory.column(INV_QTY)
    grid_lie = (in_grid & (
        (inventory.column(INV_ITEM_SK).data[pos] != cs_item.data)
        | (inventory.column(INV_WEEK_SEQ).data[pos] != week64))).any()

    qty = j2.table.column(CS_QUANTITY)
    short = (inv_qty.valid_mask()[pos] & in_grid & qty.valid_mask()
             & (inv_qty.data[pos] < qty.data))
    counts = dense_id_counts(torch.where(short, cs_item.data - 1, num_items),
                             num_items)
    return counts, j1.pk_violation | j2.pk_violation | grid_lie


def _q72_planned_table(item: Table, counts: torch.Tensor) -> tuple:
    """Planned q72's output from the per-item counts: static item keys,
    brands by one clustered gather, ORDER BY count desc, item asc.
    Returns (table, present)."""
    present = counts > 0
    brand = item.column(I_BRAND_ID)
    out = Table([
        Column(t.INT64, torch.arange(1, item.num_rows + 1, dtype=torch.int64,
                                     device=counts.device), present),
        Column(brand.dtype, brand.data, brand.valid_mask() & present),
        Column(t.INT64, counts, present),
    ])
    return sort_table(out, [2, 0], ascending=[False, True],
                      nulls_first=[False, False]), present


def _q72_grid_weeks(item: Table, inventory: Table) -> int:
    if inventory.num_rows % item.num_rows:
        raise ValueError(
            "inventory is not a dense (item, week) grid — use tpcds_q72")
    return inventory.num_rows // item.num_rows


def tpcds_q72_planned(catalog_sales: Table, date_dim: Table, item: Table,
                      inventory: Table, year: int = 2000
                      ) -> Q72PlannedResult:
    """q72 on planner-declared fast paths: d_date_sk and i_item_sk are
    dense clustered primary keys (1..N in load order) and the inventory
    grain is a dense (item, week) grid, so all three joins are arithmetic
    plus a gather; the GROUP BY item is a dense-id COUNT; only the final
    ORDER BY sorts, over ``num_items`` rows. ``pk_violation`` reports a
    declaration the data broke (re-plan on ``tpcds_q72``)."""
    num_weeks = _q72_grid_weeks(item, inventory)
    counts, viol = _q72_planned_counts(
        catalog_sales, _q72_dd_fn(date_dim, year), item, inventory,
        num_weeks)
    srt, present = _q72_planned_table(item, counts)
    return Q72PlannedResult(srt, present, viol)


def _host(tbl: Table, i: int) -> np.ndarray:
    return tbl.column(i).data.cpu().numpy()


def tpcds_q72_numpy(catalog_sales: Table, date_dim: Table, item: Table,
                    inventory: Table, year: int = 2000) -> dict:
    """Host oracle, the reference's loop: {(item_sk, brand_id): count}."""
    cs_item = _host(catalog_sales, CS_ITEM_SK)
    cs_date = _host(catalog_sales, CS_SOLD_DATE_SK)
    cs_qty = _host(catalog_sales, CS_QUANTITY)
    d_sk = _host(date_dim, D_DATE_SK)
    d_week = _host(date_dim, D_WEEK_SEQ)
    d_year = _host(date_dim, D_YEAR)

    week_of_date = dict(zip(d_sk[d_year == year], d_week[d_year == year]))
    brand_of_item = dict(zip(_host(item, I_ITEM_SK), _host(item, I_BRAND_ID)))
    onhand = dict(zip(zip(_host(inventory, INV_ITEM_SK),
                          _host(inventory, INV_WEEK_SEQ)),
                      _host(inventory, INV_QTY)))
    out: dict = {}
    for k in range(len(cs_item)):
        wk = week_of_date.get(cs_date[k])
        if wk is None:
            continue
        br = brand_of_item.get(cs_item[k])
        if br is None:
            continue
        oh = onhand.get((cs_item[k], wk))
        if oh is None or not (oh < cs_qty[k]):
            continue
        key = (int(cs_item[k]), int(br))
        out[key] = out.get(key, 0) + 1
    return out


def _lookup(keys: np.ndarray, values: np.ndarray, probe: np.ndarray):
    """Dict-lookup semantics, vectorized: for each probe, the value of the
    LAST row with an equal key (as ``dict(zip(keys, values))`` keeps), and
    whether there is one. Returns (value, hit)."""
    ukey, first = np.unique(keys[::-1], return_index=True)
    uval = values[::-1][first]
    # numpy searches sorted probes far faster than scattered ones
    order = np.argsort(probe)
    pos = np.empty(len(probe), np.int64)
    pos[order] = np.searchsorted(ukey, probe[order])
    hit = pos < len(ukey)
    hit[hit] = ukey[pos[hit]] == probe[hit]
    return (uval[pos.clip(0, max(len(ukey) - 1, 0))] if len(ukey)
            else np.zeros_like(probe)), hit


def _group_rows(keys: list, values: np.ndarray) -> tuple:
    """GROUP BY the equal-length key arrays ``keys`` (first key major),
    SUM ``values``: (distinct key rows ascending, one array per key;
    their sums)."""
    order = np.lexsort(keys[::-1])
    ks = [k[order] for k in keys]
    if not len(order):
        return ks, values[:0]
    change = np.zeros(len(order), bool)
    change[0] = True
    for k in ks:
        change[1:] |= k[1:] != k[:-1]
    starts = np.flatnonzero(change)
    return [k[starts] for k in ks], np.add.reduceat(values[order], starts)


def tpcds_q72_oracle(catalog_sales: Table, date_dim: Table, item: Table,
                     inventory: Table, year: int = 2000) -> dict:
    """Host oracle in numpy, vectorized: the q72 groups as arrays
    ``item_sk, brand_id, count`` in the query's order (count desc, item
    asc). Same lookups as the loop oracle (a repeated key takes its last
    row)."""
    cs_item = _host(catalog_sales, CS_ITEM_SK)
    d_year = _host(date_dim, D_YEAR)
    in_year = d_year == year
    week, hit1 = _lookup(_host(date_dim, D_DATE_SK)[in_year],
                         _host(date_dim, D_WEEK_SEQ)[in_year],
                         _host(catalog_sales, CS_SOLD_DATE_SK))
    brand, hit2 = _lookup(_host(item, I_ITEM_SK), _host(item, I_BRAND_ID),
                          cs_item)
    # (item, week) pairs as one exact key: weeks stay below MAX_WEEKS
    inv_key = (_host(inventory, INV_ITEM_SK) * MAX_WEEKS
               + _host(inventory, INV_WEEK_SEQ))
    onhand, hit3 = _lookup(inv_key, _host(inventory, INV_QTY),
                           cs_item * MAX_WEEKS + week)
    keep = hit1 & hit2 & hit3 & (onhand < _host(catalog_sales, CS_QUANTITY))
    (items, brands), counts = _group_rows(
        [cs_item[keep], brand[keep]], np.ones(int(keep.sum()), np.int64))
    order = np.lexsort((items, -counts))
    return {"item_sk": items[order], "brand_id": brands[order],
            "count": counts[order]}


# ---- q64 -------------------------------------------------------------------


def _q64_year_slice(store_sales: Table, year: int, num_days_per_year: int,
                    base_year: int, keep_item: bool) -> Table:
    """One side of the cross-year self-join: the packed (item, customer)
    key, nulled outside ``year``."""
    yr = _floor_div(store_sales.column(SS_SOLD_DATE_SK).data - 1,
                    num_days_per_year)
    key = _pack_key(store_sales.column(SS_ITEM_SK),
                    store_sales.column(SS_CUSTOMER_SK), MAX_CUSTOMERS)
    cols = [_null_keys_where(key, yr != (year - base_year))]
    if keep_item:
        cols.append(store_sales.column(SS_ITEM_SK))
    return Table(cols)


def _q64_left_fn(store_sales: Table, year1: int, num_days_per_year: int,
                 base_year: int) -> Table:
    return _q64_year_slice(store_sales, year1, num_days_per_year, base_year,
                           keep_item=True)


def _q64_right_fn(store_sales: Table, year2: int, num_days_per_year: int,
                  base_year: int) -> Table:
    return _q64_year_slice(store_sales, year2, num_days_per_year, base_year,
                           keep_item=False)


def _q64_keyed_fn(joined: Table) -> Table:
    # joined: [key_y1, ss_item, key_y2]; matched rows = repeat purchases
    keep = joined.column(2).valid_mask()
    return Table([
        _null_keys_where(joined.column(1), ~keep),
        Column(t.INT64, joined.column(0).data, keep),
    ])


def _q64_plan(year1: int, year2: int, num_days_per_year: int,
              base_year: int, out_factor: int) -> fusion.Plan:
    """q64's cross-year self-join (the reference's ``_q64_plan``): both
    Projects hang off the same store_sales Scan; the join runs at
    ``out_factor`` x the fact rows; the count per item, ORDER BY count
    desc, item asc, nulls last."""
    ss = fusion.Scan("store_sales")
    left = fusion.Project(ss, _q64_left_fn,
                          (year1, num_days_per_year, base_year))
    right = fusion.Project(ss, _q64_right_fn,
                           (year2, num_days_per_year, base_year))
    j = fusion.Join(left, right, (0,), (0,),
                    fusion.rows_of("store_sales", out_factor), label="join")
    g = fusion.GroupBy(fusion.Project(j, _q64_keyed_fn), (0,),
                       ((1, "count"),), label="groupby")
    return fusion.Plan("tpcds_q64", fusion.Sort(
        g, (1, 0), ascending=(False, True), nulls_first=(False, False)))


class Q64Result(NamedTuple):
    result: GroupByResult
    join_total: torch.Tensor  # true self-join match count (0-d)
    out_size: int             # the join's capacity: past it, matches were
                              # dropped and the counts are unreliable


def tpcds_q64(store_sales: Table, year1: int = 2000, year2: int = 2001,
              num_days_per_year: int = 365, base_year: int = 2000,
              out_factor: int = 4) -> Q64Result:
    """Count, per item, (year1 purchase, year2 purchase) pairs by the same
    customer (q64's cross-year self-join core), through
    ``fusion.execute`` (``_q64_plan``). Groups are (ss_item_sk, count),
    padded; ``base_year`` anchors date_sk = 1. Check ``join_total <=
    out_size``: duplicate (item, customer) pairs multiply, so the
    self-join is not structurally bounded."""
    res = fusion.execute(
        _q64_plan(year1, year2, num_days_per_year, base_year, out_factor),
        {"store_sales": store_sales})
    return Q64Result(
        GroupByResult(res.table, res.meta["groupby.num_groups"]),
        res.meta["join.total"], store_sales.num_rows * out_factor)


def q64_probe_inputs(store_sales: Table, year1: int = 2000,
                     year2: int = 2001, num_days_per_year: int = 365,
                     base_year: int = 2000) -> tuple:
    """The join probe kernel's inputs at q64's self-join (sub-plans of
    ``_q64_plan``): (build, n_valid, probe)."""
    (row,) = join_probe_inputs(
        _q64_plan(year1, year2, num_days_per_year, base_year, 4),
        {"store_sales": store_sales}, ("join",))
    return row


class Q64PlannedResult(NamedTuple):
    result: GroupByResult     # [ss_item_sk, pair_count], count desc
    join_total: torch.Tensor  # the pair count the general plan materializes


def tpcds_q64_planned(store_sales: Table, year1: int = 2000,
                      year2: int = 2001, num_days_per_year: int = 365,
                      base_year: int = 2000) -> Q64PlannedResult:
    """q64's self-join eliminated by an exact aggregate rewrite: the COUNT
    over the (item, customer) self-join is the sum over pairs of
    cnt_y1(pair) * cnt_y2(pair). One sort-based groupby over the fact rows,
    one over the distinct pairs, no join, no capacity."""
    yr = _floor_div(store_sales.column(SS_SOLD_DATE_SK).data - 1,
                    num_days_per_year)
    in_y1 = yr == (year1 - base_year)
    in_y2 = yr == (year2 - base_year)
    key = _pack_key(store_sales.column(SS_ITEM_SK),
                    store_sales.column(SS_CUSTOMER_SK), MAX_CUSTOMERS)
    valid = key.valid_mask() & (in_y1 | in_y2)
    pair = Table([
        _null_keys_where(key, ~valid),
        Column(t.INT64, in_y1.to(torch.int64), valid),
        Column(t.INT64, in_y2.to(torch.int64), valid),
    ])
    per_pair = groupby_aggregate(pair, (0,), ((1, "sum"), (2, "sum")))
    pk, a, b = per_pair.table.columns
    pairs = a.data * b.data  # cnt_y1 * cnt_y2 per (item, customer)
    pvalid = (pk.valid_mask() & a.valid_mask() & b.valid_mask()
              & (pairs > 0))
    pairs = torch.where(pvalid, pairs, 0)
    item_of = Table([
        Column(t.INT64, _floor_div(pk.data, MAX_CUSTOMERS), pvalid),
        Column(t.INT64, pairs, pvalid),
    ])
    grouped = groupby_aggregate(item_of, (0,), ((1, "sum"),))
    srt = sort_table(grouped.table, [1, 0], ascending=[False, True],
                     nulls_first=[False, False])
    return Q64PlannedResult(GroupByResult(srt, grouped.num_groups),
                            pairs.sum())


def tpcds_q64_numpy(store_sales: Table, year1: int = 2000,
                    year2: int = 2001, num_days_per_year: int = 365) -> dict:
    """Host oracle, the reference's loop: {item_sk: pair count} over
    (item, customer) pairs."""
    item = _host(store_sales, SS_ITEM_SK)
    cust = _host(store_sales, SS_CUSTOMER_SK)
    yr = (_host(store_sales, SS_SOLD_DATE_SK) - 1) // num_days_per_year + 2000
    out: dict = {}
    y2_pairs: dict = {}
    for k in np.flatnonzero(yr == year2):
        p = (int(item[k]), int(cust[k]))
        y2_pairs[p] = y2_pairs.get(p, 0) + 1
    for k in np.flatnonzero(yr == year1):
        p = (int(item[k]), int(cust[k]))
        c2 = y2_pairs.get(p, 0)
        if c2:
            out[p[0]] = out.get(p[0], 0) + c2
    return out


def tpcds_q64_oracle(store_sales: Table, year1: int = 2000,
                     year2: int = 2001, num_days_per_year: int = 365) -> dict:
    """Host oracle in numpy, vectorized: the q64 groups as arrays
    ``item_sk, count`` in the query's order (count desc, item asc). Each
    year1 purchase meets every year2 purchase of its (item, customer)
    pair."""
    item = _host(store_sales, SS_ITEM_SK)
    cust = _host(store_sales, SS_CUSTOMER_SK)
    yr = (_host(store_sales, SS_SOLD_DATE_SK) - 1) // num_days_per_year + 2000
    y1, y2 = yr == year1, yr == year2
    # one exact key per (item, customer): customers stay below
    # MAX_CUSTOMERS
    key = item * MAX_CUSTOMERS + cust
    (pairs,), n2 = _group_rows([key[y2]], np.ones(int(y2.sum()), np.int64))
    c2, hit = _lookup(pairs, n2, key[y1])
    (items,), counts = _group_rows([item[y1][hit]], c2[hit])
    order = np.lexsort((items, -counts))
    return {"item_sk": items[order], "count": counts[order]}


# ---- distributed q72 and q64 (multiple executors, ``parallel/``) ------------
#
# The reference runs each step inside ``jax.shard_map``; the port's take
# the executor mesh and run bulk-synchronously over the executors
# (``parallel/distributed.py``), with whole tables given in one process.

# padded groupby outputs shuffle under a static per-executor group
# budget; the item dimension bounds distinct (item, brand) groups
_Q72_GROUP_BUDGET = 4096


def _compact_valid_keys(result: Table, num_key_cols: int,
                        order_keys, ascending) -> Table:
    """Drop the shuffle's phantom null-key group(s) from a collected
    result and apply the final ORDER BY — the shared tail of the
    distributed q72 and q64 plans."""
    keys_valid = result.column(0).valid_mask()
    for k in range(1, num_key_cols):
        keys_valid = keys_valid & result.column(k).valid_mask()
    cols = [Column(c.dtype, c.data[keys_valid], c.valid_mask()[keys_valid])
            for c in result.columns]
    return sort_table(Table(cols), order_keys, ascending=ascending,
                      nulls_first=[False] * len(order_keys))


def _merged_partials(mesh, partials: list, keys: list, group_budget: int,
                     what: str) -> Table:
    """The two-phase aggregation's second half: each executor's padded
    partial counts (a ``GroupByResult``) truncated to the group budget,
    shuffled by key hash, sum-merged, and collected. Raises when an
    executor held more groups than the budget."""
    from spark_rapids_jni_tpu_torch.parallel.distributed import (
        any_executor,
        collect,
        head_table,
    )
    from spark_rapids_jni_tpu_torch.parallel.shuffle import hash_shuffle

    if any_executor(mesh, [p.num_groups > group_budget for p in partials]):
        raise ValueError(
            f"per-device {what} group count exceeded the shuffle budget "
            f"({group_budget}); pass a larger group_budget")
    pts = [head_table(p.table, min(group_budget, p.table.num_rows))
           for p in partials]
    shuffled = hash_shuffle(mesh, pts, keys, capacity=pts[0].num_rows)
    merged = [groupby_aggregate(sh.table, keys, [(len(keys), "sum")])
              for sh in shuffled]
    return collect([m.table for m in merged],
                   [m.num_groups for m in merged], mesh)


def tpcds_q72_distributed(catalog_sales: Table, date_dim: Table,
                          item: Table, inventory: Table, mesh,
                          year: int = 2000, out_factor: int = 2,
                          group_budget: int = _Q72_GROUP_BUDGET) -> Table:
    """Multiple-executor q72 with Spark's broadcast-join plan: the fact
    table shards row-wise over the mesh, the three dimension tables
    replicate to every executor, each runs the whole join chain (kernel D
    three times per executor on the card) and the partial group count
    locally, and the partial counts merge through the shuffle as
    distributed q1's do. Returns the compacted global (item, brand,
    count) table, count desc, item asc."""
    from spark_rapids_jni_tpu_torch.parallel.distributed import (
        shard_table,
        table_to,
    )

    partials = []
    for local in shard_table(catalog_sales, mesh):
        dev = local.columns[0].device
        # padding rows carry null join keys (shard_table nulls their
        # validity), so they fall out of the first join
        partials.append(tpcds_q72(
            local, table_to(date_dim, dev), table_to(item, dev),
            table_to(inventory, dev), year=year, out_factor=out_factor))
    result = _merged_partials(mesh, partials, [0, 1], group_budget, "q72")
    return _compact_valid_keys(result, 2, [2, 0], [False, True])


def tpcds_q72_planned_distributed(catalog_sales: Table, date_dim: Table,
                                  item: Table, inventory: Table, mesh,
                                  year: int = 2000) -> Q72PlannedResult:
    """Multiple-executor planned q72 with ZERO shuffles: catalog_sales
    shards row-wise, the three dimension tables replicate, every
    executor runs the dense-PK and grid lookups and the dense-id COUNT
    on its shard (no kernel), and the global merge is one sum over the
    num_items count vector. Same schema as ``tpcds_q72_planned``; the
    result is replicated."""
    from spark_rapids_jni_tpu_torch.parallel.distributed import (
        shard_table,
        table_to,
    )

    num_weeks = _q72_grid_weeks(item, inventory)
    dd = _q72_dd_fn(date_dim, year)
    sharded, rv = shard_table(catalog_sales, mesh, return_row_valid=True)
    counts, viols = [], []
    for local, local_rv in zip(sharded, rv):
        dev = local.columns[0].device
        c, v = _q72_planned_counts(local, table_to(dd, dev),
                                   table_to(item, dev),
                                   table_to(inventory, dev), num_weeks,
                                   row_valid=local_rv)
        counts.append(c)
        viols.append(v.to(torch.int32).reshape(1))
    total = mesh.psum(counts)[0]
    viol = mesh.psum(viols)[0][0] > 0
    srt, present = _q72_planned_table(
        table_to(item, total.device), total)
    return Q72PlannedResult(srt, present, viol)


def tpcds_q64_distributed(store_sales: Table, mesh, year1: int = 2000,
                          year2: int = 2001, num_days_per_year: int = 365,
                          base_year: int = 2000, out_factor: int = 4,
                          group_budget: int = _Q72_GROUP_BUDGET) -> Table:
    """Multiple-executor q64: the cross-year self-join is big x big, so
    it takes the repartitioned plan: both year slices exchange rows by
    composite-key hash (``distributed_join``, kernel D once per executor
    on the card), each executor joins and partial-counts locally, and
    the partial counts merge through a second shuffle. Returns the
    compacted global (item, count) table, count desc, item asc."""
    from spark_rapids_jni_tpu_torch.parallel.distributed import (
        any_executor,
        distributed_join,
        shard_table,
    )

    n = store_sales.num_rows
    left = _q64_left_fn(store_sales, year1, num_days_per_year, base_year)
    right = _q64_right_fn(store_sales, year2, num_days_per_year, base_year)
    sl, lrv = shard_table(left, mesh, return_row_valid=True)
    sr, rrv = shard_table(right, mesh, return_row_valid=True)
    d = mesh.size
    out_cap = max(1, n * out_factor // max(d // 2, 1))
    res = distributed_join(
        sl, sr, 0, 0, mesh, out_size_per_device=out_cap,
        left_capacity=max(1, n // d * 2), right_capacity=max(1, n // d * 2),
        left_row_valid=lrv, right_row_valid=rrv)
    if any_executor(mesh, res.overflowed):
        raise ValueError("q64 join shuffle overflowed; raise capacities")
    if any_executor(mesh, [tot > out_cap for tot in res.total]):
        raise ValueError(
            "q64 device-local join output exceeded out_size_per_device "
            f"({out_cap}); raise out_factor (counts would silently "
            "truncate)")
    del sl, sr, lrv, rrv
    partials = [groupby_aggregate(_q64_keyed_fn(j), [0], [(1, "count")])
                for j in res.table]
    del res
    result = _merged_partials(mesh, partials, [0], group_budget, "q64")
    return _compact_valid_keys(result, 1, [1, 0], [False, True])


# ---- TPC-DS q3 (brand revenue by year) -------------------------------------
#
#   SELECT d_year, i_brand_id, sum(ss_ext_sales_price)
#   FROM date_dim, store_sales, item
#   WHERE d_date_sk = ss_sold_date_sk AND ss_item_sk = i_item_sk
#     AND i_manufact_id = :m AND d_moy = :month
#   GROUP BY d_year, i_brand_id ORDER BY d_year, sum desc

SS3_SOLD_DATE_SK, SS3_ITEM_SK, SS3_EXT_SALES_PRICE = 0, 1, 2
I3_ITEM_SK, I3_BRAND_ID, I3_MANUFACT_ID = 0, 1, 2


def item_q3_table(num_items: int = 1000, seed: int = 4,
                  device=None) -> Table:
    """i_item_sk, i_brand_id, i_manufact_id."""
    rng = np.random.default_rng(seed)
    arrays = (np.arange(1, num_items + 1, dtype=np.int64),
              rng.integers(1, 100, num_items).astype(np.int64),
              rng.integers(1, 50, num_items).astype(np.int64))
    return _table(arrays, (t.INT64,) * 3, device)


def store_sales_q3_table(num_rows: int, num_items: int = 1000,
                         num_days: int = 730, seed: int = 5,
                         device=None) -> Table:
    """ss_sold_date_sk, ss_item_sk, ss_ext_sales_price (decimal -2)."""
    rng = np.random.default_rng(seed)
    arrays = (rng.integers(1, num_days + 1, num_rows).astype(np.int64),
              rng.integers(1, num_items + 1, num_rows).astype(np.int64),
              rng.integers(100, 100_000, num_rows).astype(np.int64))
    return _table(arrays, (t.INT64, t.INT64, t.decimal64(-2)), device)


class Q3dsResult(NamedTuple):
    table: Table              # [d_year, i_brand_id, revenue], rev desc
    present: torch.Tensor
    pk_violation: torch.Tensor
    # a kept row's brand id fell outside the declared [1, num_brands]
    # domain: its revenue is NOT in the output; re-plan
    brand_domain_miss: torch.Tensor


def tpcds_q3(date_dim: Table, store_sales: Table, item: Table,
             manufact_id: int = 7, moy: int = 11, num_brands: int = 100,
             num_days_per_year: int = 365) -> Q3dsResult:
    """TPC-DS q3 as the all-planner-facts star plan: both dimension joins
    are dense clustered-PK lookups with the predicates pushed into the
    build keys (month into date_dim, manufacturer into item), and the
    (d_year, i_brand_id) groupby is a two-level dense-id SUM and COUNT
    over ``years x num_brands`` slots. Only the group table's final
    ORDER BY revenue sorts; ties keep slot order (year, then brand).
    ``num_brands`` is the declared brand domain: a kept row outside it
    sets ``brand_domain_miss`` instead of silently dropping revenue."""
    num_days = date_dim.num_rows
    num_years = (num_days + num_days_per_year - 1) // num_days_per_year

    # d_moy derives from the date grid; the month filter goes into keys
    sk = date_dim.column(D_DATE_SK).data
    moy_of = _floor_div(torch.remainder(sk - 1, num_days_per_year), 31) + 1
    dd = Table([_null_keys_where(date_dim.column(D_DATE_SK), moy_of != moy),
                date_dim.column(D_YEAR)])
    j1 = dense_pk_join(store_sales, dd, SS3_SOLD_DATE_SK, 0, 1, num_days,
                       clustered=True)
    year = j1.table.column(store_sales.num_columns + 1)
    base_year = date_dim.column(D_YEAR).data[0]  # a device scalar
    year_idx = year.data.to(torch.int64) - base_year

    it = Table([
        _null_keys_where(item.column(I3_ITEM_SK),
                         item.column(I3_MANUFACT_ID).data != manufact_id),
        item.column(I3_BRAND_ID)])
    j2 = dense_pk_join(store_sales, it, SS3_ITEM_SK, 0, 1, item.num_rows,
                       clustered=True)
    brand = j2.table.column(store_sales.num_columns + 1)

    price = store_sales.column(SS3_EXT_SALES_PRICE)
    keep = (j1.matched & j2.matched & brand.valid_mask()
            & price.valid_mask())
    brand_ok = (brand.data >= 1) & (brand.data <= num_brands)
    brand_domain_miss = (keep & ~brand_ok).any()
    year_ok = (year_idx >= 0) & (year_idx < num_years)
    m = num_years * num_brands
    gid = torch.where(keep & brand_ok & year_ok,
                      year_idx * num_brands + (brand.data - 1), m)
    sums = dense_id_sums(gid, torch.where(keep, price.data, 0), m)
    # presence is the row COUNT, not the sum: a group whose revenue nets
    # to exactly zero must still be emitted
    present = dense_id_counts(gid, m) > 0
    slot = torch.arange(m, dtype=torch.int64, device=sums.device)
    out = Table([
        Column(t.INT64, base_year + _floor_div(slot, num_brands), present),
        Column(t.INT64, 1 + torch.remainder(slot, num_brands), present),
        Column(t.decimal64(-2), sums, present),
    ])
    srt = sort_table(out, [2], ascending=[False], nulls_first=[False])
    return Q3dsResult(srt, srt.column(0).valid_mask(),
                      j1.pk_violation | j2.pk_violation, brand_domain_miss)


def tpcds_q3_numpy(date_dim: Table, store_sales: Table, item: Table,
                   manufact_id: int = 7, moy: int = 11,
                   num_days_per_year: int = 365) -> dict:
    """Host oracle, the reference's loop: {(d_year, i_brand_id): revenue}."""
    sk = _host(date_dim, D_DATE_SK)
    yr = _host(date_dim, D_YEAR)
    moy_of = ((sk - 1) % num_days_per_year) // 31 + 1
    day_year = {int(k): int(y) for k, y, m in zip(sk, yr, moy_of)
                if m == moy}
    brand_of = {}
    for k, b, mf in zip(_host(item, I3_ITEM_SK), _host(item, I3_BRAND_ID),
                        _host(item, I3_MANUFACT_ID)):
        if int(mf) == manufact_id:
            brand_of[int(k)] = int(b)
    out: dict = {}
    for d, i, p in zip(_host(store_sales, SS3_SOLD_DATE_SK),
                       _host(store_sales, SS3_ITEM_SK),
                       _host(store_sales, SS3_EXT_SALES_PRICE)):
        y = day_year.get(int(d))
        if y is None:
            continue
        b = brand_of.get(int(i))
        if b is None:
            continue
        out[(y, b)] = out.get((y, b), 0) + int(p)
    return out


def tpcds_q3_oracle(date_dim: Table, store_sales: Table, item: Table,
                    manufact_id: int = 7, moy: int = 11,
                    num_days_per_year: int = 365) -> dict:
    """Host oracle in numpy, vectorized: the q3 groups as arrays
    ``year, brand_id, revenue`` in the plan's order (revenue desc, ties
    by year then brand)."""
    sk = _host(date_dim, D_DATE_SK)
    in_moy = ((sk - 1) % num_days_per_year) // 31 + 1 == moy
    year, hit1 = _lookup(sk[in_moy], _host(date_dim, D_YEAR)[in_moy]
                         .astype(np.int64),
                         _host(store_sales, SS3_SOLD_DATE_SK))
    in_mf = _host(item, I3_MANUFACT_ID) == manufact_id
    brand, hit2 = _lookup(_host(item, I3_ITEM_SK)[in_mf],
                          _host(item, I3_BRAND_ID)[in_mf],
                          _host(store_sales, SS3_ITEM_SK))
    keep = hit1 & hit2
    (years, brands), revenue = _group_rows(
        [year[keep], brand[keep]],
        _host(store_sales, SS3_EXT_SALES_PRICE)[keep])
    order = np.lexsort((brands, years, -revenue))
    return {"year": years[order], "brand_id": brands[order],
            "revenue": revenue[order]}
