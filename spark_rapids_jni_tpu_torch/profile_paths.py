"""Where the time goes in the PyTorch/CUDA port's paths, on the card.

Usage: python3 -m spark_rapids_jni_tpu_torch.profile_paths [path ...]

With no arguments every path below is profiled; names (``q1_planned``,
``q1_fused``, ``to_rows``, ``q1_general``, ``q3``, ``q3_joins``,
``q3_groupby``, ``q3_order_by``, ``q3_planned``, ``tpcds_q72``,
``tpcds_q72_planned``, ``tpcds_q64``, ``tpcds_q64_planned``,
``tpcds_q3``, ``tpch_q12``, ``tpch_q12_planned``, ``tpch_q4``,
``tpch_q4_planned``, ``tpch_q14``, ``tpch_q14_planned``, ``tpch_q5``,
``tpch_q6``, ``cast_decimal``, ``cast_float``, ``cast_date``, ``q19``,
``q19_planned``, ``q17``, ``q10``, ``hash_lineitem``, ``hash_q12``,
``partition_hash``, ``bloom_build``, ``bloom_probe``, ``q1_strings``,
``q13``, ``rlike``, ``json_extract``, ``upper_mixed``,
``regexp_extract``, ``regexp_replace``, ``split``, ``monthly_rollup``,
``groupby_suppkey``, ``percentile``, ``plan_groupby_auto``,
``groupby_orderkey``, ``apply_boolean_mask``, ``distinct``,
``intersect_rows``, ``window_suppkey``, ``window_range``,
``window_orderkey``, ``collect_list``, ``explode``,
``split_posexplode``) select some of them.

For planned q1, fused q1, convert_to_rows and the general q1 over TPC-H
lineitem at scale factor 10 (59,986,052 rows), then for q3 at scale
factor 10 (1,500,000 customers, 15,000,000 orders, 59,986,052 lineitem
rows) as a whole, stage by stage (the joins, the groupby, the ORDER BY)
and planned, then for the TPC-DS plans at scale factor 10 (store_sales
28,800,991 rows, catalog_sales 14,401,261, item 102,000, customer
500,000; the generators' 730-day date_dim and 10,710,000-row
inventory), then for the string TPC-H plans and q6 at scale factor 10
(lineitem 59,986,052 rows, orders 15,000,000, part 2,000,000, customer
1,500,000, supplier 100,000), then for the parse casts of SF10 lineitem
text (l_extendedprice to decimal64(-2) and FLOAT64, l_shipdate to DATE,
59,986,052 rows each, rendered by the port's own number -> string casts)
and for TPC-H q19, planned q19, q17 and q10 at scale factor 10 (q10's
lineitem is q3's with a seeded l_returnflag appended), and for Spark's
row hash over SF10 lineitem and q12's lineitem, ``partition_hash`` of
q3's l_orderkey into 200 partitions, the q3-shaped runtime bloom filter
(built from the 15,000,000 orders before q3's cutoff, probed with
59,986,052 lineitem keys), the general q1 over STRING flags and q13's
single-pass reference, and for RLIKE over bench.py's 59,986,052 log
lines, get_json_object ``$.meta.w`` over its documents tiled to
59,986,052 rows, and upper of 1,000,000 mixed-script rows, and for
regexp_extract ``status=(\\d+)``, regexp_replace ``status=\\d+`` and
split on ' ' over the log lines, and for the groupby workload's SF10
lineitem (``tpch.lineitem_groupby_table``): the planned monthly rollup,
the general groupby by l_suppkey with its 16 aggregates, its
percentiles, ``plan_groupby_auto`` from 4,096, the groupby by l_orderkey,
``apply_boolean_mask`` with q6's predicate, ``distinct`` of the flags and
``intersect_rows`` of two l_orderkey slices, and, over the same
lineitem, the window PARTITION BY l_suppkey ORDER BY l_shipdate (its
sort with row_number, rank and ROWS 6 PRECEDING sums; RANGE 30
PRECEDING sum and max), PARTITION BY l_orderkey (row_number and the
running sum), collect_list of l_suppkey by l_orderkey and the explode
of its lists, and split on ' ' then posexplode of the log lines,
after a warm-up:
the wall time per run (host clock around
work that ends in a synchronize), then one ``torch.profiler`` window of
runs with the device time of each kernel and copy, and the device's busy
share of the window (their summed device time over the window's wall
time, profiler overhead included). Chrome traces go to
``chiprun_out/profile_<path>.json``.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

import numpy as np

from spark_rapids_jni_tpu_torch import types as t
from spark_rapids_jni_tpu_torch.columnar import Column, Table
from spark_rapids_jni_tpu_torch.columnar.column import string_column
from spark_rapids_jni_tpu_torch.models import bench_strings, tpcds, tpch
from spark_rapids_jni_tpu_torch.ops import strings
from spark_rapids_jni_tpu_torch.ops import bloom_filter as bf
from spark_rapids_jni_tpu_torch.ops import cast_strings as cs
from spark_rapids_jni_tpu_torch.ops.groupby import groupby_aggregate
from spark_rapids_jni_tpu_torch.ops.get_json_object import get_json_object
from spark_rapids_jni_tpu_torch.ops.hash import partition_hash, table_xxhash64
from spark_rapids_jni_tpu_torch.ops.kernels import _build, q1 as kq1
from spark_rapids_jni_tpu_torch.ops.row_conversion import convert_to_rows
from spark_rapids_jni_tpu_torch.runtime import fusion
from spark_rapids_jni_tpu_torch.utils.platform import card_line

ROOT = Path(__file__).resolve().parents[1]
ROWS = 59_986_052  # TPC-H SF10 lineitem
CUSTOMERS, ORDERS = 1_500_000, 15_000_000  # TPC-H SF10
PARTS, SUPPLIERS = 2_000_000, 100_000  # TPC-H SF10
# TPC-DS SF10: store_sales, catalog_sales, item, customer
DS_STORE_SALES, DS_CATALOG_SALES = 28_800_991, 14_401_261
DS_ITEMS, DS_CUSTOMERS = 102_000, 500_000
REPS = 5
Q3_REPS = 2
Q1_PATHS = ("q1_planned", "q1_fused", "to_rows", "q1_general")
MORE_PATHS = ("q19", "q19_planned", "q17", "q10")
HASH_PATHS = ("hash_lineitem", "hash_q12", "partition_hash", "bloom_build",
              "bloom_probe", "q1_strings", "q13")
ENGINE_PATHS = ("rlike", "json_extract", "upper_mixed")
CAPTURE_PATHS = ("regexp_extract", "regexp_replace", "split")
GROUPBY_PATHS = ("monthly_rollup", "groupby_suppkey", "percentile",
                 "plan_groupby_auto", "groupby_orderkey",
                 "apply_boolean_mask", "distinct", "intersect_rows")
OPERATOR_PATHS = ("window_suppkey", "window_range", "window_orderkey",
                  "collect_list", "explode", "split_posexplode")


def device_us(evt) -> float:
    return float(evt.self_device_time_total)


def profile_path(name, fn, reps, out_dir):
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / reps * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        window_us = (time.perf_counter() - t0) * 1e6
    # device-side events only (kernels, copies, memsets): an operator's
    # CPU-side entry carries its kernels' time too and would count twice
    rows = sorted(((device_us(e), e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and device_us(e) > 0),
                  reverse=True)
    busy_us = sum(us for us, _, _ in rows)
    print(f"== {name}: {wall_ms:.3f} ms per run (wall, no profiler); "
          f"device busy {busy_us / window_us:.3f} of the profiled window")
    for us, count, key in rows[:15]:
        print(f"   {us / reps / 1e3:9.3f} ms/run  x{count // reps:<3} {key[:200]}")
    prof.export_chrome_trace(str(out_dir / f"profile_{name}.json"))


def main(only: list[str]) -> int:
    if not torch.cuda.is_available():
        print("profile_paths: no CUDA device", file=sys.stderr)
        return 1
    print(f"card: {card_line()}; torch {torch.__version__}")
    _build.library()
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)

    def run(name, fn, reps=REPS):
        if not only or name in only:
            profile_path(name, fn, reps, out_dir)

    def wanted(prefix):
        return not only or any(name.startswith(prefix) for name in only)

    if not only or set(only) & set(Q1_PATHS):
        li = tpch.lineitem_table(ROWS, seed=0)
        run("q1_planned", lambda: tpch.tpch_q1_planned(li))
        run("q1_fused", lambda: kq1.tpch_q1_pallas(li))
        run("to_rows", lambda: convert_to_rows(li))
        run("q1_general", lambda: tpch.tpch_q1(li))
        del li
        torch.cuda.empty_cache()
    if wanted("q3"):
        profile_q3(run)
    if wanted("tpcds"):
        profile_tpcds(run)
    if wanted("tpch_"):
        profile_strings(run)
    if wanted("cast_"):
        profile_casts(run)
    if not only or set(only) & set(MORE_PATHS):
        profile_more(run)
    if not only or set(only) & set(HASH_PATHS):
        profile_hashing(run)
    if not only or set(only) & set(ENGINE_PATHS):
        profile_engines(run)
    if not only or set(only) & set(CAPTURE_PATHS):
        profile_capture(run)
    if not only or set(only) & set(GROUPBY_PATHS):
        profile_groupby(run)
    if not only or set(only) & set(OPERATOR_PATHS):
        profile_operators(run)
    return 0


def profile_q3(run) -> None:
    q3 = (tpch.customer_table(CUSTOMERS), tpch.orders_table(ORDERS, CUSTOMERS),
          tpch.lineitem_q3_table(ROWS, ORDERS))
    run("q3", lambda: tpch.tpch_q3(*q3), Q3_REPS)
    # the stages are sub-plans of q3's plan: the joins up to the keyed
    # table, the groupby over it, the ORDER BY over the groups
    sort = tpch._q3_plan(0, tpch._Q3_CUTOFF_DAYS, 2).root
    bound = dict(zip(("customer", "orders", "lineitem"), q3))

    def stage(name, node, tables):
        return fusion.execute(fusion.Plan(name, node), tables).table

    run("q3_joins", lambda: stage("q3_joins", sort.child.child, bound),
        Q3_REPS)
    keyed = {"keyed": stage("q3_joins", sort.child.child, bound)}
    group = sort.child._replace(child=fusion.Scan("keyed"))
    run("q3_groupby", lambda: stage("q3_groupby", group, keyed), Q3_REPS)
    g = {"g": stage("q3_groupby", group, keyed)}
    del keyed
    order_by = sort._replace(child=fusion.Scan("g"))
    run("q3_order_by", lambda: stage("q3_order_by", order_by, g), Q3_REPS)
    del g
    run("q3_planned", lambda: tpch.tpch_q3_planned(*q3), Q3_REPS)
    del q3
    torch.cuda.empty_cache()


def profile_tpcds(run) -> None:
    dd = tpcds.date_dim_table()
    q72 = (tpcds.catalog_sales_table(DS_CATALOG_SALES, num_items=DS_ITEMS),
           dd, tpcds.item_table(DS_ITEMS),
           tpcds.inventory_table(num_items=DS_ITEMS))
    run("tpcds_q72", lambda: tpcds.tpcds_q72(*q72), Q3_REPS)
    run("tpcds_q72_planned", lambda: tpcds.tpcds_q72_planned(*q72))
    del q72
    ss = tpcds.store_sales_table(DS_STORE_SALES, num_items=DS_ITEMS,
                                 num_customers=DS_CUSTOMERS)
    run("tpcds_q64", lambda: tpcds.tpcds_q64(ss), Q3_REPS)
    run("tpcds_q64_planned", lambda: tpcds.tpcds_q64_planned(ss), Q3_REPS)
    del ss
    q3 = (dd, tpcds.store_sales_q3_table(DS_STORE_SALES, num_items=DS_ITEMS),
          tpcds.item_q3_table(DS_ITEMS))
    run("tpcds_q3", lambda: tpcds.tpcds_q3(*q3))


def profile_strings(run) -> None:
    li = tpch.lineitem_q12_table(ROWS, ORDERS)
    o12, o4 = tpch.orders_q12_table(ORDERS), tpch.orders_q4_table(ORDERS)
    run("tpch_q12", lambda: tpch.tpch_q12(o12, li), Q3_REPS)
    run("tpch_q12_planned", lambda: tpch.tpch_q12_planned(o12, li), Q3_REPS)
    run("tpch_q4", lambda: tpch.tpch_q4(o4, li), Q3_REPS)
    run("tpch_q4_planned", lambda: tpch.tpch_q4_planned(o4, li), Q3_REPS)
    del li, o12, o4
    part = tpch.part_table(PARTS)
    li = tpch.lineitem_q14_table(ROWS, PARTS)
    run("tpch_q14", lambda: tpch.tpch_q14(part, li), Q3_REPS)
    run("tpch_q14_planned", lambda: tpch.tpch_q14_planned(part, li))
    del part, li
    q5 = (tpch.customer_q5_table(CUSTOMERS),
          tpch.orders_table(ORDERS, CUSTOMERS),
          tpch.lineitem_q5_table(ROWS, ORDERS, SUPPLIERS),
          tpch.supplier_table(SUPPLIERS), tpch.nation_table())
    run("tpch_q5", lambda: tpch.tpch_q5(*q5))
    del q5
    li = tpch.lineitem_table(ROWS, seed=0)
    run("tpch_q6", lambda: tpch.tpch_q6(li))



def profile_casts(run) -> None:
    li = tpch.lineitem_table(ROWS, seed=0)
    price = cs.decimal_to_string(li.column(tpch.L_EXTENDEDPRICE))
    ship = cs.date_to_string(li.column(tpch.L_SHIPDATE))
    del li
    run("cast_decimal", lambda: cs.string_to_decimal(price, t.decimal64(-2)))
    run("cast_float", lambda: cs.string_to_float(price, t.FLOAT64))
    run("cast_date", lambda: cs.string_to_date(ship))
    del price, ship
    torch.cuda.empty_cache()


def profile_more(run) -> None:
    part = tpch.part_table(PARTS)
    li = tpch.lineitem_q19_table(ROWS, PARTS)
    run("q19", lambda: tpch.tpch_q19(part, li), Q3_REPS)
    run("q19_planned", lambda: tpch.tpch_q19_planned(part, li), Q3_REPS)
    run("q17", lambda: tpch.tpch_q17(part, li), Q3_REPS)
    del part, li
    li3 = tpch.lineitem_q3_table(ROWS, ORDERS)
    flags = np.random.default_rng(10).choice(
        np.frombuffer(b"ANR", np.int8), ROWS)
    q10 = (tpch.customer_q5_table(CUSTOMERS),
           tpch.orders_table(ORDERS, CUSTOMERS),
           Table(list(li3.columns) + [Column.from_numpy(flags, t.INT8)]))
    del li3
    run("q10", lambda: tpch.tpch_q10(*q10), Q3_REPS)



def profile_hashing(run) -> None:
    li = tpch.lineitem_table(ROWS, seed=0)
    run("hash_lineitem", lambda: table_xxhash64(li))
    del li
    li = tpch.lineitem_q12_table(ROWS, ORDERS)
    run("hash_q12", lambda: table_xxhash64(li))
    del li
    keys = Table([tpch.lineitem_q3_table(ROWS, ORDERS).column(
        tpch.L3_ORDERKEY)])
    run("partition_hash", lambda: partition_hash(keys, [0], 200))
    orders = tpch.orders_table(ORDERS, CUSTOMERS)
    okey = orders.column(tpch.O_ORDERKEY).data
    keep = orders.column(tpch.O_ORDERDATE).data < tpch._Q3_CUTOFF_DAYS
    empty = bf.BloomFilter.optimal(int(keep.sum()), 0.03)
    run("bloom_build", lambda: bf.bloom_put_spark(empty, okey, keep))
    f = bf.bloom_put_spark(empty, okey, keep)
    run("bloom_probe", lambda: bf.bloom_might_contain_spark(
        f, keys.column(0).data))
    del keys, f, empty, okey, keep
    run("q13", lambda: tpch.tpch_q13_reference(orders), Q3_REPS)
    del orders
    li = tpch.lineitem_table_strings(ROWS, seed=0)
    run("q1_strings", lambda: tpch.tpch_q1(li), Q3_REPS)


def profile_engines(run) -> None:
    lines, _ = bench_strings.log_lines(ROWS, seed=12)
    run("rlike", lambda: strings.regexp_contains(lines, r"status=[45]\d\d"))
    del lines
    docs = bench_strings.json_docs(ROWS)
    run("json_extract", lambda: get_json_object(docs, "$.meta.w"), Q3_REPS)
    del docs
    mixed = string_column(bench_strings.mixed_script_rows(
        1_000_000, seed=14, special_share=0.01), device="cuda")
    run("upper_mixed", lambda: strings.upper(mixed))


def profile_capture(run) -> None:
    from spark_rapids_jni_tpu_torch.ops import strings_fns

    lines, _ = bench_strings.log_lines(ROWS, seed=12)
    run("regexp_extract",
        lambda: strings.regexp_extract(lines, r"status=(\d+)", 1), Q3_REPS)
    run("regexp_replace", lambda: strings.regexp_replace(
        lines, r"status=\d+", "status=XXX"), Q3_REPS)
    run("split", lambda: strings_fns.split(lines, " ", max_pieces=5), Q3_REPS)



def profile_groupby(run) -> None:
    from spark_rapids_jni_tpu_torch.columnar import Column, Table
    from spark_rapids_jni_tpu_torch.ops import table_ops
    from spark_rapids_jni_tpu_torch.ops.groupby import (
        groupby_aggregate,
        groupby_percentile,
    )
    from spark_rapids_jni_tpu_torch.ops.planner import (
        month_bucket,
        month_domain,
        plan_groupby,
        plan_groupby_auto,
        scalar_domain,
    )

    suppliers = 100_000
    tab, _ = tpch.lineitem_groupby_table(ROWS, ORDERS, suppliers)
    c = tab.columns
    work = Table([month_bucket(c[6]), c[4], c[5], c[0], c[1], c[9], c[10]])
    aggs = [(3, "sum"), (3, "mean"), (3, "min"), (3, "max"), (4, "sum"),
            (4, "mean"), (4, "min"), (4, "max"), (5, "sum"), (5, "min"),
            (5, "max"), (6, "min"), (6, "max"), (4, "count")]
    domains = [month_domain(1992, 12, 1999, 12),
               scalar_domain(np.frombuffer(b"ANR", np.int8).tolist()),
               scalar_domain(np.frombuffer(b"FO", np.int8).tolist())]
    run("monthly_rollup", lambda: plan_groupby(work, [0, 1, 2], aggs, domains))
    del work
    gtab = Table([c[8], c[0], c[1], c[7], c[11]])
    gaggs = ([(1, op) for op in ("var", "std", "var_pop", "std_pop")]
             + [(1, ("covar_samp", 2)), (1, ("corr", 2)), (3, "nunique")]
             + [(1, op) for op in ("first", "last", "first_include_nulls",
                                   "last_include_nulls")]
             + [(4, op) for op in ("sum", "mean", "min", "max", "var")])
    run("groupby_suppkey", lambda: groupby_aggregate(
        gtab, [0], gaggs, max_groups=suppliers), Q3_REPS)
    run("percentile", lambda: groupby_percentile(
        gtab, [0], 1, [0.25, 0.5, 0.9], max_groups=suppliers), Q3_REPS)
    run("plan_groupby_auto", lambda: plan_groupby_auto(
        gtab, [0], [(1, "sum"), (1, "count")], [None], budget=4096), Q3_REPS)
    del gtab
    otab = Table([c[7], c[1]])
    run("groupby_orderkey", lambda: groupby_aggregate(
        otab, [0], [(1, "sum"), (1, "count")], max_groups=ORDERS), Q3_REPS)
    del otab
    li = Table(c[:7])
    mask = torch.from_numpy(tpch._q6_host_selection(li)).to(c[0].device)
    run("apply_boolean_mask", lambda: table_ops.apply_boolean_mask(li, mask))
    flags = Table([c[4], c[5]])
    run("distinct", lambda: table_ops.distinct(flags))
    a, b, e = ROWS // 3, ROWS // 4, 2 * ROWS // 3
    left = Table([Column(c[7].dtype, c[7].data[:a])])
    right = Table([Column(c[7].dtype, c[7].data[b:e])])
    run("intersect_rows", lambda: table_ops.intersect_rows(left, right),
        Q3_REPS)



def profile_operators(run) -> None:
    from spark_rapids_jni_tpu_torch.ops import lists, strings_fns
    from spark_rapids_jni_tpu_torch.ops.table_ops import trim_table
    from spark_rapids_jni_tpu_torch.ops.window import Window

    tab, _ = tpch.lineitem_groupby_table(ROWS, ORDERS, SUPPLIERS)
    QTY, PRICE, SHIP, OKEY, SKEY = 0, 1, 6, 7, 8

    def window_suppkey():
        w = Window(tab, [SKEY], [SHIP])
        return w.row_number(), w.rank(), w.rolling_sum(PRICE, 6)

    run("window_suppkey", window_suppkey, Q3_REPS)

    def window_range():
        w = Window(tab, [SKEY], [SHIP])
        return (w.rolling_sum(QTY, 30, 0, "range"),
                w.rolling_max(PRICE, 30, 0, "range"))

    run("window_range", window_range, Q3_REPS)

    def window_orderkey():
        w = Window(tab, [OKEY], [SHIP])
        return w.row_number(), w.running_sum(PRICE)

    run("window_orderkey", window_orderkey, Q3_REPS)
    pairs = Table([tab.column(OKEY), tab.column(SKEY)])
    run("collect_list", lambda: lists.groupby_collect(pairs, [0], 1),
        Q3_REPS)
    res = lists.groupby_collect(pairs, [0], 1)
    coll = trim_table(res.table, int(res.num_groups))
    run("explode", lambda: lists.explode(coll, 1), Q3_REPS)
    del tab, pairs, res, coll
    torch.cuda.empty_cache()
    lines, _ = bench_strings.log_lines(ROWS, seed=12)
    run("split_posexplode", lambda: lists.explode(Table([strings_fns.split(
        lines, " ", max_pieces=5).column]), 0, position=True), Q3_REPS)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
