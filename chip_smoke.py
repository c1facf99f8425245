#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (spark_rapids_jni_tpu_torch).

Usage: python3 chip_smoke.py            (one CUDA device; no arguments)

Phases, each of which fails the run (non-zero exit) when it fails:

1. the card's name and power limit, the torch version, and the build of
   the CUDA kernels from ``spark_rapids_jni_tpu_torch/csrc``;
2. TPC-H lineitem at scale factor 10 (59,986,052 rows) on the card;
3. each kernel at the main path's shapes against its plain PyTorch
   version on the same inputs (exact equality), with median times over
   7 runs after a warm-up, CUDA events around each run
   (``spark_rapids_jni_tpu_torch/utils/timing.py``);
4. the three paths through the entry points a user calls, each with the
   launch counts set to 0 just before it and read just after:
   planned q1 (accumulate kernel), fused q1 (q1 kernel), and the row
   round trip (row transpose kernel); results checked against the numpy
   oracle, against each other and against the input;
5. the general (sort-based) q1 on the same lineitem, whose first six
   rows must equal the planned q1's;
6. TPC-H q3 at scale factor 10 (1,500,000 customers, 15,000,000 orders,
   59,986,052 lineitem rows) after the q1 lineitem is freed: the join
   probe kernel at both joins' shapes (and on int32 and uint64 keys)
   against its plain version, then ``tpch_q3`` with the counts
   reset (the probe kernel launched exactly twice, no fallback, the join
   within its capacity, the result equal to a vectorized numpy oracle)
   and ``tpch_q3_planned`` (no probe launch, no PK violation, the same
   result);
7. the TPC-DS join family at scale factor 10 (store_sales 28,800,991
   rows, catalog_sales 14,401,261, item 102,000, customer 500,000; the
   generators' 730-day date_dim and one-warehouse inventory, 10,710,000
   rows) after the q3 tables are freed: the join probe kernel at q72's
   three joins and q64's self-join against its plain version, then each
   of ``tpcds_q72`` (the probe launched exactly 3 times),
   ``tpcds_q72_planned`` (0), ``tpcds_q64`` (exactly 1), ``tpcds_q64_planned``
   (0) and ``tpcds_q3`` (0) with the counts reset before it, each equal
   to a vectorized numpy oracle and each planned plan to its general
   twin, and their host times;
8. the string TPC-H plans and q6 at scale factor 10 (lineitem
   59,986,052 rows, orders 15,000,000, part 2,000,000, customer
   1,500,000, supplier 100,000) after the TPC-DS tables are freed, one
   table group at a time: the accumulate kernel at the bounded groupbys
   of planned q12 (m = 3), planned q4 (m = 6) and q5 (m = 26), the join
   probe kernel at the joins of q12, q4 (LEFT-SEMI) and q14, each against
   its plain version; then ``tpch_q12``, ``tpch_q12_planned_result``,
   ``tpch_q4``, ``tpch_q4_planned_result``, ``tpch_q14``,
   ``tpch_q14_planned``, ``tpch_q5`` and ``tpch_q6``, each with the
   counts reset before it (the probe kernel once per general join, the
   accumulate kernel once per bounded groupby, nothing else), each equal
   to a vectorized numpy oracle and each planned plan to its general
   twin, their host times and the phase's peak device memory;
9. CastStrings over SF10 lineitem text (59,986,052 rows) after the
   string tables are freed: quantity, extendedprice, discount and tax
   rendered to Arrow STRING by ``decimal_to_string``, shipdate by
   ``date_to_string`` and q3's l_orderkey by ``integer_to_string``, the
   first 1,000,000 rows of each byte-equal to a numpy rendering; each
   parsed back (``string_to_decimal`` to decimal64(-2),
   ``string_to_date``, ``string_to_integer`` to INT64) equal to the
   generator's column; ``string_to_float`` of extendedprice bit-equal,
   on a 1,000,000-row slice, to the same function run on the CPU, with
   its ulp distance from numpy's correctly rounded parse; ``bench.py``'s
   CastStrings column (4,096 ``"{m}.{ff}"`` templates tiled to
   59,986,052 rows) parsed to FLOAT64 and decimal64(-2); each cast's
   host time (median of 3), rows/s and byte bound, and the phase's peak
   device memory;
10. TPC-H q19, planned q19, q17 and q10 at scale factor 10 (lineitem
   59,986,052 rows, part 2,000,000, orders 15,000,000, customer
   1,500,000): the join probe kernel at q19's join and q17's two joins
   against its plain version, then each plan with the counts reset
   before it (the probe kernel once in q19, twice in q17, never in
   planned q19 and q10; no fallback), each equal to its vectorized numpy
   oracle (q17's with the reference's float association; the rows where
   it and the loop oracle's differ must be exact ties, and are
   reported) and planned q19 to q19, their host times and the phase's
   peak device memory;
11. Spark's row hash, hash partitioning, the runtime bloom filter, the
   datetime ops, string-keyed q1 and q13 at scale factor 10, none of
   which launches a kernel of A-D (checked with the counts reset before
   each): ``table_xxhash64`` over lineitem (59,986,052 rows, 7 columns),
   over q12's lineitem (a STRING l_shipmode) and over one DECIMAL128
   column at every byte count, and ``partition_hash`` of q3's l_orderkey
   into 200 partitions, each equal on a seeded 4,000,000-row sample to a
   numpy XXH64 written here from the public spec; the q3-shaped runtime
   filter (``bloom_put_spark`` of the 15,000,000 orders before q3's
   cutoff, sized by ``optimal_params(n, 0.03)``) with its bits equal to
   a numpy putLong oracle, the merge of two halves equal to the whole,
   and ``bloom_might_contain_spark`` of every lineitem order key with no
   false negative and a false-positive share of at most 0.035; every
   datetime function over l_shipdate, a microsecond timestamp made from
   it and q12's receipt and commit dates, equal to a per-day table from
   Python's datetime; the general q1 over ``lineitem_table_strings``
   equal to the INT8 general q1 and the numpy oracle, and
   ``tpch_q13_reference`` over the SF10 orders equal to ``np.bincount``;
   each path's host time (median of 3) beside its byte bound, and each
   part's peak device memory (under 40 GiB);
12. the device string engines over 59,986,052 rows, none of which
   launches a kernel of A-D (checked with the counts reset before each):
   ``regexp_contains`` (RLIKE, ``bench.py``'s ``regexp``) over its log
   lines built on the card, ``status=[45]\\d\\d`` on the device DFA (the
   widest row fills the image, so the run ends on the sentinel step),
   equal to the generator's word indices and to Python ``re`` on a
   seeded 1,000,000-row sample, and a backreference the DFA refuses
   running the host engine over 1,000,000 rows, recorded; ``upper``,
   ``lower`` and ``substring`` (two with a negative start) over the log
   lines, equal to Python's on the sample, and over 1,000,000
   mixed-script rows whose special rows are mapped on the host and
   merged back, equal to Python's str methods (the Unicode database must
   be the CPU tests' 15.0.0); ``get_json_object`` (``json_extract``)
   over ``bench.py``'s 4,096 templates tiled to 59,986,052 padded rows
   for ``$.meta.w``, ``$.sku``, ``$.price`` and ``$.nope``, equal to
   Python ``json`` over the templates, and 1,000 escaped documents
   refused with ``NotImplementedError``, recorded; each path's host time
   (median of 3), rows/s and byte bound, the host fallbacks, and the
   phase's peak device memory (under 30 GiB);
13. regexp_extract, regexp_replace (the linear capture engine) and the
   string functions over the same 59,986,052 log lines, none of which
   launches a kernel of A-D (checked with the counts reset before each):
   ``regexp_extract`` of ``status=(\\d+)`` and ``id=(\\d+)``, equal to the
   generator's word indices (the first status word's code, the row
   number) and to Python ``re`` on a seeded 1,000,000-row sample;
   ``regexp_replace`` of ``status=\\d+`` by ``status=XXX`` on the device
   (at most 5 matches a row), equal to the lines drawn again with the
   status words rewritten and to ``re``; ``split`` on ' ' with at most 5
   pieces, its offsets, piece lengths and bytes equal to the words and
   to ``str.split``; ``length``, ``trim``, ``lpad(80, '*')``,
   ``reverse``, ``instr('status')``, ``translate`` of the digits and
   ``initcap``, each equal to a plain oracle over every row and to
   Python on the sample; ``concat_ws('|', ...)`` over SF10 lineitem's
   two STRING flags and the lines; three host routes over a
   1,000,000-row slice (a round-budget overflow, a group-ref
   replacement, an alternation), each recorded with its reason and
   equal to ``re``; each device path's host time (median of 3) beside
   its byte bound, and the phase's peak device memory (under 40 GiB);
14. the rest of the general groupby, the planner's general lowering and
   month buckets, the DECIMAL128 reductions and the table operations
   over SF10 lineitem (59,986,052 rows with q5's l_orderkey and
   l_suppkey, seeded nulls in l_quantity and the flags, a FLOAT64 price
   with NaN rows, Spark's xxhash64 of l_orderkey as UINT64, and
   l_extendedprice x 10^20 as DECIMAL128 with negative rows), each
   result held to a numpy or Python-int oracle: the planned monthly
   rollup by (month_bucket(l_shipdate), l_returnflag, l_linestatus),
   m = 1,032 slots and 16 lanes, bounded through kernel A (launched,
   no fallback) with A at that shape against its plain version; the
   general groupby by l_suppkey (100,000 groups: var/std/var_pop/
   std_pop, covar_samp, corr, nunique, first/last both ways, DECIMAL128
   sum/mean/min/max/var), its percentiles, ``plan_groupby_auto`` from a
   budget of 4,096 and the groupby by l_orderkey (15,000,000 groups),
   none launching A-D; the DECIMAL128 ``sum_``/``mean``/``min_``/
   ``max_``; ``concatenate``, ``apply_boolean_mask`` (q6's predicate),
   ``distinct``, ``contiguous_split``, ``intersect_rows`` and
   ``except_rows`` (no launch of A-D: the set operations sort, they do
   not probe); each path's host time (median of 3) beside its byte
   bound, and the phase's peak device memory (under 40 GiB);
15. one ``{"kernels": [...]}`` line, the card line, and the final
   ``{"ok": true, "device": {...}}`` line.

A JSON copy of the report goes to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import json
import math
import statistics
import sys
import time
from pathlib import Path

import torch

SF10_ROWS = 59_986_052     # TPC-H SF10 lineitem
ROWS = SF10_ROWS
Q3_CUSTOMERS = 1_500_000   # TPC-H SF10 customer
Q3_ORDERS = 15_000_000     # TPC-H SF10 orders
DS_STORE_SALES = 28_800_991    # TPC-DS SF10 store_sales
DS_CATALOG_SALES = 14_401_261  # TPC-DS SF10 catalog_sales
DS_ITEMS = 102_000             # TPC-DS SF10 item
DS_CUSTOMERS = 500_000         # TPC-DS SF10 customer
Q14_PARTS = 2_000_000          # TPC-H SF10 part
Q5_SUPPLIERS = 100_000         # TPC-H SF10 supplier
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (data sheet)
SCALAR_OPS_PER_S = 67e12   # H100 SXM float32 rate outside the tensor cores
OUT_DIR = Path(__file__).resolve().parent / "chiprun_out"


_T0 = time.perf_counter()


def log(msg: str) -> None:
    """A progress line, stamped with the seconds since the start."""
    print(f"[{time.perf_counter() - _T0:7.1f} s] {msg}", flush=True)


def host_median_s(fn, reps: int = 3, warm: bool = True) -> float:
    """Median wall time of ``fn()`` ending in a synchronize, in seconds;
    ``warm=False`` when a checked run of the same call came just before
    (it was the warm-up)."""
    if warm:
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def distinct_bytes(tensors) -> int:
    """Bytes of the distinct tensors among ``tensors`` (None skipped):
    each input counted once however many lanes read it."""
    seen = {}
    for x in tensors:
        if x is not None:
            seen[(x.data_ptr(), x.nbytes)] = x.nbytes
    return sum(seen.values())


def bound(nbytes: int, ops: int) -> tuple[float, str]:
    """Least time the card could take: the larger of bytes over the
    memory rate and operations over the scalar rate, in ms."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops / SCALAR_OPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    if a.dtype == torch.uint8:
        a, b = a.to(torch.int16), b.to(torch.int16)
    return float((a - b).abs().max()) if a.numel() else 0.0


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def _accumulate_row(gid, lanes, m: int, dev, what: str) -> dict:
    """Kernel A at one bounded groupby's shape against its plain version:
    exact for integer, uint64 and min/max lanes, float sum lanes within
    ``FLOAT_SUM_REL * sum(|x|)`` of each group; its time, the plain
    version's, the ``index_add_`` of the integer sum lanes' and the bound
    (every lane's inputs read once, the partials written once; one
    operation per row and lane)."""
    from spark_rapids_jni_tpu_torch.ops.kernels import groupby_accumulate as kga
    from spark_rapids_jni_tpu_torch.utils.timing import median_ms

    n = gid.shape[0]
    got = kga._accumulate_cuda(gid, lanes, m)
    want = kga.accumulate_plain(gid, lanes, m)
    torch.cuda.synchronize()
    fsum = [i for i, ln in enumerate(lanes) if ln.op == "sum"
            and ln.values is not None and ln.values.is_floating_point()]
    exact = [i for i in range(len(lanes)) if i not in fsum]
    require(torch.equal(got[:, exact], want[:, exact]),
            f"accumulate kernel != plain version ({what})")
    for i in fsum:
        g, w = got[:, i].view(torch.float64), want[:, i].view(torch.float64)
        nan = torch.isnan(w)
        near = (g - w).abs() <= kga.float_sum_bound(gid, lanes[i], m)
        require(bool(((torch.isnan(g) == nan) & (nan | near)).all()),
                f"accumulate kernel's float sum lane {i} past its bound "
                f"({what})")
    sum_lanes = [ln for ln in lanes if ln.op == "sum"
                 and ln.values is not None
                 and not ln.values.is_floating_point()]
    stacked = torch.stack([kga.lane_words(ln, n, dev) for ln in sum_lanes],
                          dim=1)
    lib = median_ms(lambda: torch.zeros(
        (m + 1, len(sum_lanes)), dtype=torch.int64, device=dev
    ).index_add_(0, gid, stacked))
    del stacked
    nbytes = distinct_bytes(
        [gid] + [ln.values for ln in lanes] + [ln.valid for ln in lanes]
    ) + got.nbytes
    b_ms, b_by = bound(nbytes, n * len(lanes))
    row = dict(
        m=m, lanes=len(lanes), rows=n, launches=kga.launches(m, len(lanes)),
        max_abs_err=max_abs_err(got[:, exact], want[:, exact]),
        float_sum_lanes=len(fsum),
        ms=median_ms(lambda: kga._accumulate_cuda(gid, lanes, m)),
        plain_ms=median_ms(lambda: kga.accumulate_plain(gid, lanes, m)),
        bound_ms=b_ms, bound_by=b_by, library_ms=lib)
    log(f"kernel A {kga.NAME} at {what}: m={m} lanes={len(lanes)} "
        f"({row['launches']} launch(es), {len(fsum)} float sum lanes within "
        f"bound, the rest exact); {row['ms']:.3f} ms (plain "
        f"{row['plain_ms']:.3f}, index_add_ {lib:.3f}, bound {b_ms:.3f} by "
        f"{b_by})")
    return row


def kernel_phases(li, dev):
    """Each kernel against its plain version at the main path's shapes."""
    from spark_rapids_jni_tpu_torch.models.tpch import q1_accumulate_inputs
    from spark_rapids_jni_tpu_torch.ops.bytecast import to_bytes
    from spark_rapids_jni_tpu_torch.ops.kernels import (
        groupby_accumulate as kga,
        q1 as kq1,
        row_transpose as krt,
    )
    from spark_rapids_jni_tpu_torch.ops.row_conversion import (
        compute_fixed_width_layout,
    )
    from spark_rapids_jni_tpu_torch.utils.timing import median_ms

    n = li.num_rows
    rows = {}

    # A: the bounded accumulate over the q1 work table, m = 12
    gid, lanes, m = q1_accumulate_inputs(li)
    row = _accumulate_row(gid, lanes, m, dev, "planned q1")
    rows["A"] = dict(
        name=kga.NAME, route="cuda",
        source="spark_rapids_jni_tpu_torch/csrc/groupby_accumulate.cu",
        replaces="spark_rapids_jni_tpu/ops/pallas/groupby_accumulate.py:178",
        **{k: row[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                               "bound_by", "library_ms")})
    del gid, lanes

    # B: the fused q1 over lineitem
    cols = [li.column(i).data for i in kq1._COLUMNS]
    got = kq1._q1_partials_cuda(*cols)
    want = kq1.q1_partials_plain(*cols)
    torch.cuda.synchronize()
    require(torch.equal(got, want), "q1 kernel != plain version")
    b_ms, b_by = bound(distinct_bytes(cols) + got.nbytes, n * 16)
    rows["B"] = dict(
        name=kq1.NAME, route="cuda",
        source="spark_rapids_jni_tpu_torch/csrc/q1.cu",
        replaces="spark_rapids_jni_tpu/ops/pallas/q1.py:168",
        max_abs_err=max_abs_err(got, want),
        ms=median_ms(lambda: kq1._q1_partials_cuda(*cols)),
        plain_ms=median_ms(lambda: kq1.q1_partials_plain(*cols)),
        bound_ms=b_ms, bound_by=b_by, library_ms=None)
    log(f"kernel B {kq1.NAME}: exact; {rows['B']['ms']:.3f} ms (plain "
        f"{rows['B']['plain_ms']:.3f}, no single PyTorch call computes "
        f"it, bound {b_ms:.3f})")
    del got, want

    # C: the row transpose of lineitem (48-byte rows)
    schema = li.schema()
    starts, _, spr = compute_fixed_width_layout(schema)
    datas = [c.data for c in li.columns]
    valids = [c.validity for c in li.columns]
    got = krt._assemble_rows_cuda(datas, valids, schema, starts, spr)
    want = krt.assemble_rows_plain(datas, valids, schema, starts, spr)
    torch.cuda.synchronize()
    require(torch.equal(got, want), "row transpose kernel != plain version")
    err = max_abs_err(got, want)
    del got, want
    # yardstick: one torch.cat of ready byte pieces, zero gap and pad
    # pieces included, which gives the same image for this all-valid table
    pieces, cursor = [], 0
    vld = torch.full((n, 1), (1 << len(schema)) - 1, dtype=torch.uint8,
                     device=dev)
    for start, piece in zip(
            starts + [starts[-1] + schema[-1].size_bytes, spr],
            [to_bytes(d, dt) for d, dt in zip(datas, schema)] + [vld, None]):
        if start > cursor:
            pieces.append(torch.zeros((n, start - cursor), dtype=torch.uint8,
                                      device=dev))
        if piece is not None:
            pieces.append(piece)
            cursor = start + piece.shape[1]
    lib = median_ms(lambda: torch.cat(pieces, dim=1))
    require(torch.equal(torch.cat(pieces, dim=1)[:4096],
                        krt.assemble_rows_plain(
                            [d[:4096] for d in datas], valids, schema,
                            starts, spr)), "yardstick differs")
    del pieces
    b_ms, b_by = bound(distinct_bytes(datas + valids) + n * spr, 0)
    rows["C"] = dict(
        name=krt.NAME, route="cuda",
        source="spark_rapids_jni_tpu_torch/csrc/row_transpose.cu",
        replaces="spark_rapids_jni_tpu/ops/pallas/row_transpose.py:103",
        max_abs_err=err,
        ms=median_ms(lambda: krt._assemble_rows_cuda(
            datas, valids, schema, starts, spr)),
        plain_ms=median_ms(lambda: krt.assemble_rows_plain(
            datas, valids, schema, starts, spr)),
        bound_ms=b_ms, bound_by=b_by, library_ms=lib)
    log(f"kernel C {krt.NAME}: {spr}-byte rows exact; "
        f"{rows['C']['ms']:.3f} ms (plain {rows['C']['plain_ms']:.3f}, "
        f"torch.cat {lib:.3f}, bound {b_ms:.3f})")
    return rows


def path_phases(li):
    """The three paths through the user entry points, counts per path."""
    from spark_rapids_jni_tpu_torch.models import tpch
    from spark_rapids_jni_tpu_torch.ops import kernels
    from spark_rapids_jni_tpu_torch.ops.kernels import (
        groupby_accumulate as kga,
        q1 as kq1,
        row_transpose as krt,
    )
    from spark_rapids_jni_tpu_torch.ops.row_conversion import (
        convert_from_rows,
        convert_to_rows,
    )

    n = li.num_rows
    launches = {}
    t0 = time.perf_counter()
    oracle = tpch.tpch_q1_numpy(li)
    log(f"numpy oracle: {time.perf_counter() - t0:.1f} s on the host")

    # planned q1
    kernels.reset_counts()
    res = tpch.tpch_q1_planned_result(li)
    torch.cuda.synchronize()
    launches[kga.NAME] = kernels.launches(kga.NAME)
    require(launches[kga.NAME] >= 1, "planned q1 never launched kernel A")
    require(not kernels.fallbacks(),
            f"planned q1 fell back: {kernels.fallbacks()}")
    require(not bool(res.domain_miss), "q1 domain miss on TPC-H data")
    planned = res.table
    names = ["sum_qty", "sum_base_price", "sum_disc_price", "sum_charge",
             "avg_qty", "avg_price", "avg_disc", "count"]
    host = [c.data[:6].cpu().numpy() for c in planned.columns]
    present = res.present[:6].cpu().numpy()
    require(int(present.sum()) == len(oracle), "q1 group count")
    for g in range(6):
        key = (int(host[0][g]), int(host[1][g]))
        require(present[g] and key in oracle, f"q1 group {key} missing")
        for j, name in enumerate(names):
            got, want = host[2 + j][g], oracle[key][name]
            if name.startswith("avg"):
                # numpy's mean sums floats pairwise; the port divides an
                # exact int64 total
                require(abs(got - want) <= 1e-12 * abs(want),
                        f"q1 {key} {name}: {got} vs {want}")
            else:
                require(int(got) == want, f"q1 {key} {name}: {got} vs {want}")
    log(f"planned q1: 6 groups match the numpy oracle; launches "
        f"{launches[kga.NAME]}, no fallback")

    # fused q1
    kernels.reset_counts()
    fused = kq1.tpch_q1_pallas(li)
    torch.cuda.synchronize()
    launches[kq1.NAME] = kernels.launches(kq1.NAME)
    require(launches[kq1.NAME] >= 1, "fused q1 never launched kernel B")
    require(not kernels.fallbacks(), f"fused q1 fell back: {kernels.fallbacks()}")
    for a, b in zip(fused.columns, planned.columns):
        require(a.dtype == b.dtype and torch.equal(a.data, b.data[:6])
                and torch.equal(a.validity, b.validity[:6]),
                f"fused q1 column {a.dtype} differs from planned")
    log(f"fused q1: bit-identical to planned; launches {launches[kq1.NAME]}")

    # row round trip
    kernels.reset_counts()
    batches = convert_to_rows(li)
    torch.cuda.synchronize()
    sizes = [b.num_rows for b in batches]
    start = 0
    for b in batches:
        back = convert_from_rows(b, li.schema())
        for c, orig in zip(back.columns, li.columns):
            require(torch.equal(c.data, orig.data[start:start + b.num_rows])
                    and bool(c.validity.all()), "row round trip differs")
        start += b.num_rows
    del back
    q1_rows = convert_to_rows(planned)
    require(convert_from_rows(q1_rows[0], planned.schema()).equals(planned),
            "q1 result row round trip differs")
    torch.cuda.synchronize()
    launches[krt.NAME] = kernels.launches(krt.NAME)
    require(launches[krt.NAME] >= 1, "row conversion never launched kernel C")
    require(not kernels.fallbacks(), f"rows fell back: {kernels.fallbacks()}")
    if n == SF10_ROWS:
        require(sizes == [44_739_232, 15_246_820], f"batches {sizes}")
    log(f"rows: batches {sizes} round-trip exactly; q1 result round-trips; "
        f"launches {launches[krt.NAME]}")
    del batches

    s_planned = host_median_s(lambda: tpch.tpch_q1_planned(li))
    s_fused = host_median_s(lambda: kq1.tpch_q1_pallas(li))
    log(f"q1 planned: {s_planned * 1e3:.3f} ms, {n / s_planned:.4g} rows/s; "
        f"q1 fused: {s_fused * 1e3:.3f} ms, {n / s_fused:.4g} rows/s")
    return launches, {"q1_planned_s": s_planned, "q1_fused_s": s_fused}, \
        oracle


def general_q1_phase(li) -> dict:
    """The general sort-based q1 on the SF10 lineitem: its first six rows
    equal the planned q1's bit for bit, and the checked wrapper passes."""
    from spark_rapids_jni_tpu_torch.models import tpch
    from spark_rapids_jni_tpu_torch.ops import kernels

    kernels.reset_counts()
    general = tpch.tpch_q1(li)
    torch.cuda.synchronize()
    require(not kernels.fallbacks(), f"q1 fell back: {kernels.fallbacks()}")
    planned = tpch.tpch_q1_planned(li)
    for a, b in zip(general.columns, planned.columns):
        require(a.dtype == b.dtype and torch.equal(a.data[:6], b.data[:6])
                and torch.equal(a.validity[:6], b.validity[:6]),
                f"general q1 column {a.dtype} differs from planned")
    tpch.tpch_q1_checked(li)
    s = host_median_s(lambda: tpch.tpch_q1(li))
    log(f"general q1: first 6 rows bit-identical to planned; "
        f"{s * 1e3:.3f} ms, {li.num_rows / s:.4g} rows/s")
    return {"q1_general_s": s}, general


def q3_tables():
    from spark_rapids_jni_tpu_torch.models import tpch

    t0 = time.perf_counter()
    tables = (tpch.customer_table(Q3_CUSTOMERS),
              tpch.orders_table(Q3_ORDERS, Q3_CUSTOMERS),
              tpch.lineitem_q3_table(ROWS, Q3_ORDERS))
    torch.cuda.synchronize()
    log(f"q3 tables: {Q3_CUSTOMERS} customers, {Q3_ORDERS} orders, {ROWS} "
        f"lineitem rows on the card in {time.perf_counter() - t0:.1f} s")
    return tables


def _probe_row(build, probe, what: str) -> tuple:
    """Kernel D against its plain version on keys already in the
    kernel's type; returns (max_abs_err, bound_ms, bound_by). The bound
    counts what the function needs, whatever the kernel does: the build's
    valid prefix (the sentinel tail past it is known without reading
    it), the probes and lo/hi once, and two bisections of that prefix per
    probe (one compare per step)."""
    from spark_rapids_jni_tpu_torch.ops.kernels import hash_probe as khp

    got = khp._probe_cuda(build, probe)
    want = khp.probe_lo_hi_plain(build, probe)
    torch.cuda.synchronize()
    require(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
            f"probe kernel != plain version ({what})")
    err = max(max_abs_err(got[0], want[0]), max_abs_err(got[1], want[1]))
    s = int((build < torch.iinfo(build.dtype).max).sum())
    b_ms, b_by = bound(s * build.element_size() + probe.nbytes
                       + 2 * got[0].nbytes,
                       2 * math.ceil(math.log2(s + 1)) * probe.shape[0])
    return err, b_ms, b_by


def _probe_join(build, n_valid, probe, what: str) -> dict:
    """Kernel D at one join's shape: exact against its plain version,
    its time, the plain version's, the ``torch.searchsorted`` pair's and
    the bound (``_probe_row``)."""
    from spark_rapids_jni_tpu_torch.ops.kernels import hash_probe as khp
    from spark_rapids_jni_tpu_torch.utils.timing import median_ms

    err, b_ms, b_by = _probe_row(build, probe, what)
    row = dict(
        build=build.shape[0], n_valid=int(n_valid), probe=probe.shape[0],
        max_abs_err=err,
        ms=median_ms(lambda: khp._probe_cuda(build, probe)),
        plain_ms=median_ms(lambda: khp.probe_lo_hi_plain(build, probe)),
        library_ms=median_ms(lambda: (
            torch.searchsorted(build, probe),
            torch.searchsorted(build, probe, right=True))),
        bound_ms=b_ms, bound_by=b_by)
    log(f"kernel D {khp.NAME} at {what}: build {row['build']} int64 keys "
        f"({row['n_valid']} valid), probe {row['probe']}, exact; "
        f"{row['ms']:.3f} ms (plain {row['plain_ms']:.3f}, searchsorted "
        f"pair {row['library_ms']:.3f}, bound {b_ms:.3f} by {b_by})")
    return row


def probe_phase(customer, orders, li3, dev) -> dict:
    """Kernel D at the shapes of q3's two joins (join 1: the order
    custkeys into the customer build; join 2: the filtered lineitem
    probe into the build of join 1's output, after
    ``_sorted_valid_keys``), then one int32 case (rank-encoded keys) and
    one uint64 case. Join 2 is the kernel's row in the report."""
    import numpy as np

    from spark_rapids_jni_tpu_torch.models.tpch import q3_probe_inputs
    from spark_rapids_jni_tpu_torch.ops.kernels import hash_probe as khp

    joins = q3_probe_inputs(customer, orders, li3)
    rows = {name: _probe_join(*join, f"q3 {name}")
            for name, join in zip(("join 1", "join 2"), joins)}
    # join 2 is the kernel's row in the report
    row = dict(name=khp.NAME, route="cuda",
               source="spark_rapids_jni_tpu_torch/csrc/hash_probe.cu",
               replaces="spark_rapids_jni_tpu/ops/pallas/hash_probe.py:114",
               **{k: rows["join 2"][k] for k in (
                   "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                   "library_ms")})
    del joins

    rng = np.random.default_rng(3)
    for np_dt, m, n in ((np.int32, 1 << 20, 1 << 22),
                        (np.uint64, 1 << 20, 1 << 22)):
        info = np.iinfo(np_dt)
        b = np.sort(rng.integers(0, 1 << 24, m).astype(np_dt))
        b[-m // 8:] = info.max
        p = rng.integers(0, 1 << 24, n).astype(np_dt)
        p[:2] = [info.min, info.max]
        kb, kp = khp.kernel_keys(torch.from_numpy(b).to(dev),
                                 torch.from_numpy(p).to(dev))
        e, _, _ = _probe_row(kb, kp, np.dtype(np_dt).name)
        require(e == 0.0, "probe error")
        log(f"kernel D on {np.dtype(np_dt).name} keys ({m} build, {n} "
            f"probe): exact")
    return row, rows


def _run_plan(name: str, fn, want: dict):
    """``fn()`` with the counts set to 0 just before it and read just
    after: each kernel launched exactly as often as ``want`` says
    (``{"A": n, "D": n}``, absent = 0), no fallback."""
    from spark_rapids_jni_tpu_torch.ops import kernels
    from spark_rapids_jni_tpu_torch.ops.kernels import (
        groupby_accumulate as kga,
        hash_probe as khp,
    )

    kernels.reset_counts()
    res = fn()
    torch.cuda.synchronize()
    got = {"A": kernels.launches(kga.NAME), "D": kernels.launches(khp.NAME)}
    require(got == {"A": want.get("A", 0), "D": want.get("D", 0)},
            f"{name} launched {got}, not {want}")
    require(not kernels.fallbacks(),
            f"{name} fell back: {kernels.fallbacks()}")
    return res, got


def q3_path_phase(customer, orders, li3) -> tuple:
    """``tpch_q3`` and ``tpch_q3_planned`` at SF10 through the entry
    points, each with the counts set to 0 just before it."""
    from spark_rapids_jni_tpu_torch.models import tpch

    torch.cuda.reset_peak_memory_stats()
    launches = {}
    res, launches["tpch_q3"] = _run_plan(
        "q3", lambda: tpch.tpch_q3(customer, orders, li3), {"D": 2})
    total, groups = int(res.join_total), int(res.result.num_groups)
    require(total <= res.out_cap, f"join 2 total {total} > {res.out_cap}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    got = res.result.compact()

    t0 = time.perf_counter()
    want = tpch.tpch_q3_oracle(customer, orders, li3)
    log(f"q3 numpy oracle: {time.perf_counter() - t0:.1f} s on the host")
    k = len(want["orderkey"])
    # the real groups, then the null-key group of the join's padding rows
    require(groups in (k, k + 1), f"q3 groups {groups} vs oracle {k}")
    for col, name in enumerate(("orderkey", "orderdate", "shippriority",
                                "revenue")):
        c = got.column(col)
        require(bool(c.validity[:k].all()), f"q3 {name}: null in a group")
        require(torch.equal(c.data[:k].cpu(), torch.from_numpy(want[name])),
                f"q3 {name} differs from the numpy oracle")
        if groups == k + 1:
            require(not bool(c.validity[k]), f"q3 {name}: null group")
    log(f"q3: {total} matched rows, {groups} groups ({k} real); equal to "
        f"the numpy oracle in value and order; launches "
        f"{launches['tpch_q3']}, "
        f"no fallback; peak device memory {peak:.2f} GiB")

    planned, launches["tpch_q3_planned"] = _run_plan(
        "planned q3", lambda: tpch.tpch_q3_planned(customer, orders, li3), {})
    require(not bool(planned.pk_violation), "planned q3: PK violation")
    require(int(planned.join_total) == total, "planned q3 match count")
    require(planned.result.compact().equals(got),
            "planned q3 differs from q3")
    log("planned q3: no probe launch, no PK violation, result equal to q3")
    del res, planned, got

    s = host_median_s(lambda: tpch.tpch_q3(customer, orders, li3))
    s_planned = host_median_s(
        lambda: tpch.tpch_q3_planned(customer, orders, li3))
    log(f"q3: {s * 1e3:.3f} ms, {li3.num_rows / s:.4g} lineitem rows/s; "
        f"planned q3: {s_planned * 1e3:.3f} ms, "
        f"{li3.num_rows / s_planned:.4g} rows/s")
    return launches, {"q3_s": s, "q3_planned_s": s_planned,
                      "q3_matched_rows": total, "q3_groups": groups,
                      "q3_peak_gib": peak}


def tpcds_tables() -> dict:
    """The TPC-DS SF10 tables on the card: q72's four, q64's store_sales
    and q3's store_sales and item (sharing q72's date_dim)."""
    from spark_rapids_jni_tpu_torch.models import tpcds

    t0 = time.perf_counter()
    dd = tpcds.date_dim_table()
    tables = dict(
        q72=(tpcds.catalog_sales_table(DS_CATALOG_SALES, num_items=DS_ITEMS),
             dd, tpcds.item_table(DS_ITEMS),
             tpcds.inventory_table(num_items=DS_ITEMS)),
        q64=(tpcds.store_sales_table(DS_STORE_SALES, num_items=DS_ITEMS,
                                     num_customers=DS_CUSTOMERS),),
        q3=(dd, tpcds.store_sales_q3_table(DS_STORE_SALES,
                                           num_items=DS_ITEMS),
            tpcds.item_q3_table(DS_ITEMS)))
    torch.cuda.synchronize()
    log(f"TPC-DS tables: catalog_sales {DS_CATALOG_SALES}, store_sales "
        f"{DS_STORE_SALES} (twice: q64's and q3's), item {DS_ITEMS}, "
        f"inventory {tables['q72'][3].num_rows}, date_dim {dd.num_rows} "
        f"rows on the card in {time.perf_counter() - t0:.1f} s")
    return tables


def tpcds_probe_phase(tables) -> dict:
    """Kernel D at q72's three joins and q64's self-join, each build
    sorted and sentinel-padded as ``join`` gives it to the kernel."""
    from spark_rapids_jni_tpu_torch.models import tpcds

    joins = dict(zip(("q72 join 1", "q72 join 2", "q72 join 3"),
                     tpcds.q72_probe_inputs(*tables["q72"])))
    joins["q64 self-join"] = tpcds.q64_probe_inputs(*tables["q64"])
    return {name: _probe_join(*join, name) for name, join in joins.items()}


def _require_columns(name: str, table, want: dict, k: int) -> None:
    """The first ``k`` rows of ``table`` are valid and equal the oracle's
    arrays (``want``, one per column, in order)."""
    for col, (what, values) in enumerate(want.items()):
        c = table.column(col)
        require(len(values) == k, f"{name}: oracle {what} has {len(values)}")
        require(bool(c.valid_mask()[:k].all()), f"{name} {what}: null")
        require(torch.equal(c.data[:k].cpu().to(torch.int64),
                            torch.from_numpy(values.astype("int64"))),
                f"{name} {what} differs from the numpy oracle")


def _require_same_rows(name: str, got, want, k: int) -> None:
    """The first ``k`` rows of two tables are valid and equal."""
    for a, b in zip(got.columns, want.columns):
        require(a.dtype == b.dtype and torch.equal(a.data[:k], b.data[:k])
                and bool(a.valid_mask()[:k].all())
                and bool(b.valid_mask()[:k].all()),
                f"{name} differs from its general twin")


def tpcds_path_phase(tables) -> tuple:
    """The five TPC-DS plans through the entry points at SF10: launch
    counts, results against the oracles and between twins, host times,
    and the phase's peak device memory."""
    from spark_rapids_jni_tpu_torch.models import tpcds

    q72, q64, q3 = tables["q72"], tables["q64"], tables["q3"]
    torch.cuda.reset_peak_memory_stats()
    launches = {}

    res, launches["tpcds_q72"] = _run_plan(
        "q72", lambda: tpcds.tpcds_q72(*q72), {"D": 3})
    t0 = time.perf_counter()
    want = tpcds.tpcds_q72_oracle(*q72)
    log(f"q72 numpy oracle: {time.perf_counter() - t0:.1f} s on the host")
    k, groups = len(want["item_sk"]), int(res.num_groups)
    # the real groups, then the null-key group of the unmatched rows
    require(groups in (k, k + 1), f"q72 groups {groups} vs oracle {k}")
    q72_table = res.compact()
    _require_columns("q72", q72_table, want, k)
    log(f"q72: {groups} groups ({k} real), equal to the numpy oracle in "
        f"value and order; probe launches 3, no fallback")

    planned, launches["tpcds_q72_planned"] = _run_plan(
        "planned q72", lambda: tpcds.tpcds_q72_planned(*q72), {})
    require(not bool(planned.pk_violation), "planned q72: PK violation")
    require(int(planned.present.sum()) == k, "planned q72 group count")
    _require_same_rows("planned q72", planned.table, q72_table, k)
    log("planned q72: no probe launch, no PK violation, equal to q72")
    del res, planned, q72_table

    res, launches["tpcds_q64"] = _run_plan(
        "q64", lambda: tpcds.tpcds_q64(*q64), {"D": 1})
    total = int(res.join_total)
    require(total <= res.out_size, f"q64 join total {total} > "
            f"{res.out_size}")
    want = tpcds.tpcds_q64_oracle(*q64)
    k, groups = len(want["item_sk"]), int(res.result.num_groups)
    require(groups in (k, k + 1), f"q64 groups {groups} vs oracle {k}")
    require(int(want["count"].sum()) == total, "q64 join total vs oracle")
    q64_table = res.result.compact()
    _require_columns("q64", q64_table, want, k)
    log(f"q64: {total} matched pairs (capacity {res.out_size}), {groups} "
        f"groups ({k} real), equal to the numpy oracle; probe launches 1")

    planned, launches["tpcds_q64_planned"] = _run_plan(
        "planned q64", lambda: tpcds.tpcds_q64_planned(*q64), {})
    require(int(planned.join_total) == total, "planned q64 pair count")
    _require_same_rows("planned q64", planned.result.table, q64_table, k)
    log("planned q64: no probe launch, same pair count, equal to q64")
    del res, planned, q64_table

    res, launches["tpcds_q3"] = _run_plan(
        "TPC-DS q3", lambda: tpcds.tpcds_q3(*q3), {})
    require(not bool(res.pk_violation), "TPC-DS q3: PK violation")
    require(not bool(res.brand_domain_miss), "TPC-DS q3: brand domain miss")
    want = tpcds.tpcds_q3_oracle(*q3)
    k = len(want["year"])
    require(int(res.present.sum()) == k, "TPC-DS q3 group count")
    _require_columns("TPC-DS q3", res.table, want, k)
    log(f"TPC-DS q3: {k} groups equal to the numpy oracle in value and "
        f"order; no probe launch, no PK violation, no brand domain miss")
    del res
    peak = torch.cuda.max_memory_allocated() / 2**30

    times = {}
    for name, args in (("tpcds_q72", q72), ("tpcds_q72_planned", q72),
                       ("tpcds_q64", q64), ("tpcds_q64_planned", q64),
                       ("tpcds_q3", q3)):
        fact_rows = max(tbl.num_rows for tbl in args)  # the fact table's
        s = host_median_s(lambda: getattr(tpcds, name)(*args))
        times[name] = {"s": s, "fact_rows_per_s": fact_rows / s}
        log(f"{name}: {s * 1e3:.3f} ms, {fact_rows / s:.4g} fact rows/s")
    log(f"peak device memory of the TPC-DS plans {peak:.2f} GiB")
    return launches, {"plans": times, "matched_pairs_q64": total,
                      "peak_gib": peak}


def _named_rows(table, present=None) -> list:
    """[(name, value, ...)] of a result table whose column 0 is a STRING
    key: its valid-key rows (among the ``present`` ones) in order."""
    from spark_rapids_jni_tpu_torch.ops.strings import gather_strings

    keep = table.column(0).valid_mask()
    if present is not None:
        keep = keep & present
    idx = torch.nonzero(keep).flatten()
    names = [b.decode()
             for b in gather_strings(table.column(0), idx).row_bytes()]
    return list(zip(names, *[c.data[idx].cpu().tolist()
                             for c in table.columns[1:]]))


def strings_tables(which: str):
    """The SF10 tables of one group of the string plans on the card."""
    from spark_rapids_jni_tpu_torch.models import tpch

    t0 = time.perf_counter()
    if which == "q12":  # q12 and q4 share q12's lineitem
        tables = dict(li=tpch.lineitem_q12_table(ROWS, Q3_ORDERS),
                      o12=tpch.orders_q12_table(Q3_ORDERS),
                      o4=tpch.orders_q4_table(Q3_ORDERS))
    elif which == "q14":
        tables = dict(part=tpch.part_table(Q14_PARTS),
                      li=tpch.lineitem_q14_table(ROWS, Q14_PARTS))
    elif which == "q5":
        tables = dict(args=(tpch.customer_q5_table(Q3_CUSTOMERS),
                            tpch.orders_table(Q3_ORDERS, Q3_CUSTOMERS),
                            tpch.lineitem_q5_table(ROWS, Q3_ORDERS,
                                                   Q5_SUPPLIERS),
                            tpch.supplier_table(Q5_SUPPLIERS),
                            tpch.nation_table()))
    else:
        tables = dict(li=tpch.lineitem_table(ROWS, seed=0))
    torch.cuda.synchronize()
    log(f"{which} tables on the card in {time.perf_counter() - t0:.1f} s")
    return tables


def _plan_times(plans: dict, rows: int) -> dict:
    """Host median of 3 per plan, and lineitem rows per second."""
    out = {}
    for name, fn in plans.items():
        s = host_median_s(fn)
        out[name] = {"s": s, "lineitem_rows_per_s": rows / s}
        log(f"{name}: {s * 1e3:.3f} ms, {rows / s:.4g} lineitem rows/s")
    return out


def strings_phase(dev) -> tuple:
    """The string TPC-H plans and q6 at SF10 (lineitem 59,986,052 rows,
    orders 15,000,000, part 2,000,000, customer 1,500,000, supplier
    100,000), one table group at a time: kernel A at the bounded
    groupbys of planned q12, planned q4 and q5, kernel D at the joins of
    q12, q4 and q14, each exact against its plain version; then the
    eight plans with their launch counts, each equal to its vectorized
    numpy oracle and each planned plan to its general twin; host times
    and the phase's peak device memory."""
    from spark_rapids_jni_tpu_torch.columnar import Table
    from spark_rapids_jni_tpu_torch.models import tpch

    torch.cuda.reset_peak_memory_stats()
    a_rows, d_rows, launches, times = {}, {}, {}, {}

    tb = strings_tables("q12")
    li, o12, o4 = tb["li"], tb["o12"], tb["o4"]
    d_rows["q12 join"] = _probe_join(*tpch.q12_probe_inputs(o12, li),
                                     "q12 join")
    d_rows["q4 LEFT-SEMI join"] = _probe_join(
        *tpch.q4_probe_inputs(o4, li), "q4 LEFT-SEMI join")
    a_rows["planned q12"] = _accumulate_row(
        *tpch.q12_accumulate_inputs(o12, li), dev, "planned q12")
    a_rows["planned q4"] = _accumulate_row(
        *tpch.q4_accumulate_inputs(o4, li), dev, "planned q4")

    res, launches["tpch_q12"] = _run_plan(
        "q12", lambda: tpch.tpch_q12(o12, li), {"D": 1})
    t0 = time.perf_counter()
    want = tpch.tpch_q12_oracle(o12, li)
    log(f"q12 numpy oracle: {time.perf_counter() - t0:.1f} s on the host")
    general = _named_rows(res.result.compact())
    require({n: [h, lo] for n, h, lo in general} == want,
            f"q12 {general} differs from the numpy oracle {want}")
    require(int(res.join_total) <= li.num_rows, "q12 join past capacity")
    planned, launches["tpch_q12_planned"] = _run_plan(
        "planned q12", lambda: tpch.tpch_q12_planned_result(o12, li),
        {"A": 1, "D": 1})
    require(not bool(planned.domain_miss), "planned q12: domain miss")
    require(_named_rows(planned.table, planned.present) == general,
            "planned q12 differs from q12")
    log(f"q12: {int(res.join_total)} matched rows, groups {general} equal "
        f"to the numpy oracle; planned q12 equal to q12; launches "
        f"{launches['tpch_q12']} / {launches['tpch_q12_planned']}")

    res, launches["tpch_q4"] = _run_plan(
        "q4", lambda: tpch.tpch_q4(o4, li), {"D": 1})
    t0 = time.perf_counter()
    want = tpch.tpch_q4_oracle(o4, li)
    log(f"q4 numpy oracle: {time.perf_counter() - t0:.1f} s on the host")
    general = _named_rows(res.result.compact())
    require(dict(general) == want,
            f"q4 {general} differs from the numpy oracle {want}")
    planned, launches["tpch_q4_planned"] = _run_plan(
        "planned q4", lambda: tpch.tpch_q4_planned_result(o4, li),
        {"A": 1, "D": 1})
    require(not bool(planned.domain_miss), "planned q4: domain miss")
    require(_named_rows(planned.table, planned.present) == general,
            "planned q4 differs from q4")
    log(f"q4: {int(res.join_total)} orders with a late lineitem, groups "
        f"{general} equal to the numpy oracle; planned q4 equal to q4; "
        f"launches {launches['tpch_q4']} / {launches['tpch_q4_planned']}")
    del res, planned
    times.update(_plan_times({
        "tpch_q12": lambda: tpch.tpch_q12(o12, li),
        "tpch_q12_planned": lambda: tpch.tpch_q12_planned(o12, li),
        "tpch_q4": lambda: tpch.tpch_q4(o4, li),
        "tpch_q4_planned": lambda: tpch.tpch_q4_planned(o4, li)}, ROWS))
    del tb, li, o12, o4
    torch.cuda.empty_cache()

    tb = strings_tables("q14")
    part, li = tb["part"], tb["li"]
    d_rows["q14 join"] = _probe_join(*tpch.q14_probe_inputs(part, li),
                                     "q14 join")
    res, launches["tpch_q14"] = _run_plan(
        "q14", lambda: tpch.tpch_q14(part, li), {"D": 1})
    want = tpch.tpch_q14_oracle(part, li)
    require((int(res.promo_revenue), int(res.total_revenue)) == want,
            f"q14 differs from the numpy oracle {want}")
    planned, launches["tpch_q14_planned"] = _run_plan(
        "planned q14", lambda: tpch.tpch_q14_planned(part, li), {})
    require(not bool(planned.pk_violation), "planned q14: PK violation")
    require(tuple(int(v) for v in planned[:3]) == tuple(
        int(v) for v in res), "planned q14 differs from q14")
    log(f"q14: promo {want[0]} of {want[1]} ({res.ratio():.4f} %), equal "
        f"to the numpy oracle; planned q14 equal; launches "
        f"{launches['tpch_q14']} / {launches['tpch_q14_planned']}")
    times.update(_plan_times({
        "tpch_q14": lambda: tpch.tpch_q14(part, li),
        "tpch_q14_planned": lambda: tpch.tpch_q14_planned(part, li)}, ROWS))
    del tb, part, li, res, planned
    torch.cuda.empty_cache()

    args = strings_tables("q5")["args"]
    a_rows["q5"] = _accumulate_row(*tpch.q5_accumulate_inputs(*args), dev,
                                   "q5")
    res, launches["tpch_q5"] = _run_plan(
        "q5", lambda: tpch.tpch_q5(*args), {"A": 1})
    require(not bool(res.pk_violation) and not bool(res.domain_miss),
            "q5: PK violation or domain miss")
    t0 = time.perf_counter()
    want = tpch.tpch_q5_oracle(*args)
    log(f"q5 numpy oracle: {time.perf_counter() - t0:.1f} s on the host")
    keys = res.table.column(0).data.cpu().tolist()
    rev = res.table.column(1).data.cpu().tolist()
    present = res.present.cpu().tolist()
    got = [(keys[i], rev[i]) for i in range(len(keys)) if present[i]]
    require(dict(got) == want and all(
        a[1] >= b[1] for a, b in zip(got, got[1:])),
        "q5 differs from the numpy oracle or is not in revenue order")
    names = _named_rows(Table([res.table.column(2), res.table.column(0)]),
                        res.present)
    require(names == [(tpch._Q5_NATIONS[k - 1], k) for k, _ in got],
            "q5 nation names out of step with their keys")
    log(f"q5: {len(got)} nations equal to the numpy oracle in revenue "
        f"order ({names[0][0]} first); launches {launches['tpch_q5']}")
    times.update(_plan_times({"tpch_q5": lambda: tpch.tpch_q5(*args)},
                             ROWS))
    del args, res
    torch.cuda.empty_cache()

    li = strings_tables("q6")["li"]
    res, launches["tpch_q6"] = _run_plan("q6", lambda: tpch.tpch_q6(li), {})
    want = tpch.tpch_q6_oracle(li)
    require(bool(res.validity[0]) and int(res.data[0]) == want,
            f"q6 {int(res.data[0])} differs from the numpy oracle {want}")
    log(f"q6: revenue {want} equal to the numpy oracle; no launch")
    times.update(_plan_times({"tpch_q6": lambda: tpch.tpch_q6(li)}, ROWS))
    del li, res
    torch.cuda.empty_cache()
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"peak device memory of the string plans {peak:.2f} GiB")
    return a_rows, d_rows, launches, {"plans": times, "peak_gib": peak}


CAST_SLICE = 1_000_000  # rows checked byte for byte and on the CPU


def _host_arrow(pieces) -> tuple:
    """(int32 offsets, uint8 chars) of a list of bytes."""
    import numpy as np

    offsets = np.zeros(len(pieces) + 1, np.int32)
    np.cumsum([len(p) for p in pieces], out=offsets[1:])
    return offsets, np.frombuffer(b"".join(pieces), np.uint8)


def _require_text_prefix(col, pieces, what: str) -> None:
    """The first ``len(pieces)`` rows of an Arrow STRING column are
    exactly ``pieces``, and the column has no null mask."""
    offsets, chars = _host_arrow(pieces)
    k = len(pieces)
    require(col.validity is None, f"{what}: a null mask on all-valid rows")
    require((col.data[:k + 1].cpu().numpy() == offsets).all(),
            f"{what}: offsets differ from the numpy rendering")
    require((col.chars[:int(offsets[-1])].cpu().numpy() == chars).all(),
            f"{what}: chars differ from the numpy rendering")


def _cpu_slice(col, k: int):
    """The first ``k`` rows of an Arrow STRING column, copied to the
    host."""
    from spark_rapids_jni_tpu_torch.columnar import Column

    offsets = col.data[:k + 1].cpu()
    return Column(col.dtype, offsets, None,
                  chars=col.chars[:int(offsets[-1])].cpu())


def _float_check(col, card_f64, strings, what: str) -> dict:
    """``string_to_float`` on the card bit-equal to the same function on
    the CPU over the first rows' bytes; ulp distance of those rows from
    numpy's correctly rounded parse."""
    import numpy as np

    from spark_rapids_jni_tpu_torch import types as t
    from spark_rapids_jni_tpu_torch.ops import cast_strings as cs

    k = len(strings)
    t0 = time.perf_counter()
    cpu = cs.string_to_float(_cpu_slice(col, k), t.FLOAT64)
    cpu_s = time.perf_counter() - t0
    got = card_f64.data[:k].cpu()
    require(got.numpy().tobytes() == cpu.data.numpy().tobytes()
            and torch.equal(card_f64.validity[:k].cpu(), cpu.validity),
            f"{what}: the card's float parse differs from the CPU's")
    exact = np.array(strings, dtype=np.float64)
    ulp = np.abs(got.numpy().view(np.int64) - exact.view(np.int64))
    out = {"rows": k, "rows_off": int((ulp > 0).sum()),
           "max_ulp": int(ulp.max()), "cpu_s": cpu_s}
    log(f"{what}: FLOAT64 parse on the card bit-equal to the CPU run over "
        f"{k} rows ({cpu_s:.1f} s on the host); {out['rows_off']} rows "
        f"off numpy's correctly rounded parse, at most {out['max_ulp']} "
        f"ulp")
    return out


def cast_phase(dev) -> dict:
    """CastStrings over SF10 lineitem rendered as text (the phase list in
    the module docstring)."""
    import numpy as np

    from spark_rapids_jni_tpu_torch import types as t
    from spark_rapids_jni_tpu_torch.models import tpch
    from spark_rapids_jni_tpu_torch.ops import cast_strings as cs

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    li = tpch.lineitem_table(ROWS, seed=0)
    cols = {"l_quantity": li.column(tpch.L_QUANTITY),
            "l_extendedprice": li.column(tpch.L_EXTENDEDPRICE),
            "l_discount": li.column(tpch.L_DISCOUNT),
            "l_tax": li.column(tpch.L_TAX),
            "l_shipdate": li.column(tpch.L_SHIPDATE),
            "l_orderkey": tpch.lineitem_q3_table(ROWS, Q3_ORDERS).column(
                tpch.L3_ORDERKEY)}
    del li
    torch.cuda.synchronize()
    log(f"cast inputs: {ROWS} lineitem rows on the card in "
        f"{time.perf_counter() - t0:.1f} s")
    dec = t.decimal64(-2)
    render = {name: cs.decimal_to_string for name in cols}
    render["l_shipdate"] = cs.date_to_string
    render["l_orderkey"] = cs.integer_to_string
    parse = {name: (lambda s: cs.string_to_decimal(s, dec)) for name in cols}
    parse["l_shipdate"] = cs.string_to_date
    parse["l_orderkey"] = lambda s: cs.string_to_integer(s, t.INT64)

    def numpy_text(name, k):
        v = cols[name].data[:k].cpu().numpy()
        if name == "l_shipdate":
            return [s.encode() for s in np.datetime_as_string(
                v.astype("datetime64[D]"))]
        if name == "l_orderkey":
            return [b"%d" % x for x in v.tolist()]
        return [b"%d.%02d" % (x // 100, x % 100) for x in v.tolist()]

    text, times, out = {}, {}, {}
    for name, col in cols.items():
        text[name] = render[name](col)
        _require_text_prefix(text[name], numpy_text(name, CAST_SLICE),
                             f"{render[name].__name__}({name})")
        back = parse[name](text[name])
        torch.cuda.synchronize()
        require(back.dtype == col.dtype and torch.equal(back.data, col.data)
                and bool(back.validity.all()),
                f"{name}: the parse of its text differs from the column")
    log(f"casts: {', '.join(cols)} rendered to text (first {CAST_SLICE} "
        f"rows byte-equal to numpy's) and parsed back exactly, "
        f"{ROWS} rows each")
    price_text = text["l_extendedprice"]
    f64 = cs.string_to_float(price_text, t.FLOAT64)
    require(bool(f64.validity.all()), "float parse: a null")
    out["float_l_extendedprice"] = _float_check(
        price_text, f64, [b.decode() for b in numpy_text(
            "l_extendedprice", CAST_SLICE)], "l_extendedprice")
    del f64

    # bench.py's CastStrings column, tiled on the card
    rng = np.random.default_rng(0)
    pool, unscaled = [], []
    for _ in range(4096):
        mant = int(rng.integers(-10_000_000, 10_000_000))
        frac = int(rng.integers(0, 100))
        pool.append(f"{mant}.{frac:02d}")
        unscaled.append((abs(mant) * 100 + frac) * (-1 if mant < 0 else 1))
    tile = np.arange(ROWS, dtype=np.int64) % len(pool)
    bench_col = tpch._vocab_strings(pool, tile, dev)
    bd = cs.string_to_decimal(bench_col, dec)
    want = torch.tensor(unscaled, dtype=torch.int64, device=dev)[
        torch.from_numpy(tile).to(dev)]
    require(torch.equal(bd.data, want) and bool(bd.validity.all()),
            "bench column: decimal parse differs from its templates")
    bf = cs.string_to_float(bench_col, t.FLOAT64)
    out["float_bench"] = _float_check(
        bench_col, bf, [pool[i] for i in tile[:CAST_SLICE]], "bench column")
    del bd, bf, want

    def bytes_of(*tensors):
        return sum(x.nbytes for x in tensors)

    cases = []
    for name, col in cols.items():
        s = text[name]
        cases.append((f"{render[name].__name__}({name})",
                      lambda c=col, f=render[name]: f(c),
                      bytes_of(col.data, s.data, s.chars)))
        # a parse writes its data and a one-byte validity per row
        cases.append((f"parse({name})", lambda s=s, f=parse[name]: f(s),
                      bytes_of(s.data, s.chars, col.data) + ROWS))
    cases.append(("string_to_float(l_extendedprice)",
                  lambda: cs.string_to_float(price_text, t.FLOAT64),
                  bytes_of(price_text.data, price_text.chars) + 9 * ROWS))
    for what, fn in (("string_to_float(bench)", lambda: cs.string_to_float(
            bench_col, t.FLOAT64)), ("string_to_decimal(bench)",
                                     lambda: cs.string_to_decimal(
                                         bench_col, dec))):
        cases.append((what, fn, bytes_of(bench_col.data, bench_col.chars)
                      + 9 * ROWS))
    for what, fn, nbytes in cases:
        sec = host_median_s(fn)
        b_ms, _ = bound(nbytes, 0)
        times[what] = {"s": sec, "rows_per_s": ROWS / sec,
                       "bound_ms": b_ms}
        log(f"{what}: {sec * 1e3:.3f} ms, {ROWS / sec:.4g} rows/s (byte "
            f"bound {b_ms:.3f} ms)")
    del text, cols, bench_col, price_text
    torch.cuda.empty_cache()
    peak = torch.cuda.max_memory_allocated() / 2**30
    require(peak < 40, f"cast phase peak {peak:.2f} GiB")
    log(f"peak device memory of the cast phase {peak:.2f} GiB")
    return {"casts": times, "peak_gib": peak, **out}


def more_plans_phase() -> tuple:
    """TPC-H q19, planned q19, q17 and q10 at SF10 (the phase list in
    the module docstring)."""
    import numpy as np

    from spark_rapids_jni_tpu_torch import types as t
    from spark_rapids_jni_tpu_torch.columnar import Column, Table
    from spark_rapids_jni_tpu_torch.models import tpch

    torch.cuda.reset_peak_memory_stats()
    d_rows, launches, times = {}, {}, {}
    t0 = time.perf_counter()
    part = tpch.part_table(Q14_PARTS)
    li = tpch.lineitem_q19_table(ROWS, Q14_PARTS)
    torch.cuda.synchronize()
    log(f"q19/q17 tables: part {Q14_PARTS}, lineitem {ROWS} on the card in "
        f"{time.perf_counter() - t0:.1f} s")
    d_rows["q19 join"] = _probe_join(*tpch.q19_probe_inputs(part, li),
                                     "q19 join")
    for name, join in zip(("q17 join 1", "q17 join 2"),
                          tpch.q17_probe_inputs(part, li)):
        d_rows[name] = _probe_join(*join, name)

    res, launches["tpch_q19"] = _run_plan(
        "q19", lambda: tpch.tpch_q19(part, li), {"D": 1})
    t0 = time.perf_counter()
    want = tpch.tpch_q19_oracle(part, li)
    log(f"q19 numpy oracle: {time.perf_counter() - t0:.1f} s on the host")
    require(int(res.revenue) == want and want > 0,
            f"q19 revenue {int(res.revenue)} differs from the oracle {want}")
    planned, launches["tpch_q19_planned"] = _run_plan(
        "planned q19", lambda: tpch.tpch_q19_planned(part, li), {})
    require(not bool(planned.pk_violation), "planned q19: PK violation")
    require(int(planned.revenue) == want
            and int(planned.join_total) == int(res.join_total),
            "planned q19 differs from q19")
    log(f"q19: revenue {want} over {int(res.join_total)} joined rows, "
        f"equal to the numpy oracle; planned q19 equal; launches "
        f"{launches['tpch_q19']} / {launches['tpch_q19_planned']}")
    res, launches["tpch_q17"] = _run_plan(
        "q17", lambda: tpch.tpch_q17(part, li), {"D": 2})
    t0 = time.perf_counter()
    want = tpch.tpch_q17_oracle(part, li, plan_association=True)
    sql = tpch.tpch_q17_oracle(part, li)
    log(f"q17 numpy oracles: {time.perf_counter() - t0:.1f} s on the host")
    require(int(res.yearly_total) == want and want > 0,
            f"q17 {int(res.yearly_total)} differs from the oracle {want}")
    # the reference's association, q < (0.2 * mean) * 100.0, against
    # the loop oracle's q < 0.2 * avg: every row they split must be an
    # exact tie, 5 * q * count == sum
    qty, sums, counts, _ = tpch._q17_selected(part, li, "Brand#23",
                                              "MED BOX")
    avg = sums.astype(np.float64) / counts
    split = (qty < 0.2 * avg) != (
        qty.astype(np.float64) < 0.2 * (avg * 0.01) * 100.0)
    require(bool((5 * qty[split] * counts[split] == sums[split]).all()),
            "q17: the two associations split a row that is not a tie")
    log(f"q17: yearly total {want} (avg_yearly {res.avg_yearly():.2f}) "
        f"over {int(res.join_total)} selected rows, equal to the numpy "
        f"oracle with the reference's association; the loop oracle's "
        f"{sql} differs by {want - sql} over {int(split.sum())} rows, each "
        f"an exact tie; launches {launches['tpch_q17']}")
    del res, planned
    times.update(_plan_times({
        "tpch_q19": lambda: tpch.tpch_q19(part, li),
        "tpch_q19_planned": lambda: tpch.tpch_q19_planned(part, li),
        "tpch_q17": lambda: tpch.tpch_q17(part, li)}, ROWS))
    del part, li
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    li3 = tpch.lineitem_q3_table(ROWS, Q3_ORDERS)
    flags = np.random.default_rng(10).choice(
        np.frombuffer(b"ANR", np.int8), ROWS)
    args = (tpch.customer_q5_table(Q3_CUSTOMERS),
            tpch.orders_table(Q3_ORDERS, Q3_CUSTOMERS),
            Table(list(li3.columns) + [Column.from_numpy(flags, t.INT8)]))
    del li3, flags
    torch.cuda.synchronize()
    log(f"q10 tables on the card in {time.perf_counter() - t0:.1f} s")
    res, launches["tpch_q10"] = _run_plan(
        "q10", lambda: tpch.tpch_q10(*args), {})
    require(not bool(res.pk_violation), "q10: PK violation")
    t0 = time.perf_counter()
    want = tpch.tpch_q10_oracle(*args)
    log(f"q10 numpy oracle: {time.perf_counter() - t0:.1f} s on the host")
    k, groups = len(want["custkey"]), int(res.result.num_groups)
    # the real groups, then the null-key group of the rows not kept
    require(groups in (k, k + 1), f"q10 groups {groups} vs oracle {k}")
    _require_columns("q10", res.result.compact(), want, k)
    log(f"q10: {int(res.join_total)} returned rows joined, {k} customers "
        f"equal to the numpy oracle in revenue order; no probe launch, no "
        f"PK violation")
    del res
    times.update(_plan_times({"tpch_q10": lambda: tpch.tpch_q10(*args)},
                             ROWS))
    del args
    torch.cuda.empty_cache()
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"peak device memory of q19, q17 and q10 {peak:.2f} GiB")
    return d_rows, launches, {"plans": times, "peak_gib": peak}


# ---- phase 11: Spark's row hash, hash partitioning, the runtime bloom
# filter, the datetime ops, string-keyed q1 and q13 ---------------------------

HASH_SAMPLE = 4_000_000  # rows of the numpy XXH64 oracle (seeded sample)
SHUFFLE_PARTITIONS = 200  # Spark's default spark.sql.shuffle.partitions


def np_xxh64_fixed(mat, seeds):
    """XXH64 (the public spec) of each row of the (n, L) uint8 matrix, all
    rows L bytes long, with per-row uint64 seeds; numpy uint64 lanes."""
    import numpy as np

    p1, p2, p3, p4, p5 = (np.uint64(p) for p in (
        0x9E3779B185EBCA87, 0xC2B2AE3D4F54DE4F, 0x165667B19E3779F9,
        0x85EBCA77C2B2AE63, 0x27D4EB2F165667C5))

    def rotl(x, r):
        return (x << np.uint64(r)) | (x >> np.uint64(64 - r))

    n, length = mat.shape
    u = mat.astype(np.uint64)

    def word(p, k):
        w = np.zeros(n, np.uint64)
        for i in range(k):
            w |= u[:, p + i] << np.uint64(8 * i)
        return w

    pos = 0
    with np.errstate(over="ignore"):
        if length >= 32:
            v = [seeds + p1 + p2, seeds + p2, seeds.copy(), seeds - p1]
            while pos + 32 <= length:
                for i in range(4):
                    v[i] = rotl(v[i] + word(pos + 8 * i, 8) * p2, 31) * p1
                pos += 32
            h = rotl(v[0], 1) + rotl(v[1], 7) + rotl(v[2], 12) \
                + rotl(v[3], 18)
            for vi in v:
                h = (h ^ (rotl(vi * p2, 31) * p1)) * p1 + p4
        else:
            h = seeds + p5
        h = h + np.uint64(length)
        while pos + 8 <= length:
            h = rotl(h ^ (rotl(word(pos, 8) * p2, 31) * p1), 27) * p1 + p4
            pos += 8
        if pos + 4 <= length:
            h = rotl(h ^ (word(pos, 4) * p1), 23) * p2 + p3
            pos += 4
        while pos < length:
            h = rotl(h ^ (u[:, pos] * p5), 11) * p1
            pos += 1
        h ^= h >> np.uint64(33)
        h *= p2
        h ^= h >> np.uint64(29)
        h *= p3
        h ^= h >> np.uint64(32)
    return h


def np_xxh64_rows(mat, lengths, seeds):
    """XXH64 of each row's first ``lengths[i]`` bytes of ``mat``, rows
    grouped by length."""
    import numpy as np

    out = np.empty(len(lengths), np.uint64)
    for length in np.unique(lengths):
        rows = lengths == length
        out[rows] = np_xxh64_fixed(mat[rows, :length], seeds[rows])
    return out


def _le_bytes(values, dtype):
    """(n, itemsize) little-endian bytes of ``values`` as ``dtype``."""
    import numpy as np

    v = np.ascontiguousarray(values.astype(np.dtype(dtype).newbyteorder("<")))
    return v.view(np.uint8).reshape(len(v), -1)


def _decimal128_bytes(limbs):
    """(n, 16) big-endian bytes and the minimal byte count (Java's
    BigInteger.toByteArray: bitLength // 8 + 1, bitLength of v or ~v)."""
    import numpy as np

    lo, hi = limbs[:, 0], limbs[:, 1]
    be = np.concatenate([hi.astype(">i8").view(np.uint8).reshape(-1, 8),
                         lo.astype(">i8").view(np.uint8).reshape(-1, 8)], 1)
    neg = hi < 0

    def bit_length(x):
        x = x.view(np.uint64).copy()
        n = (x != 0).astype(np.int64)
        for s in (32, 16, 8, 4, 2, 1):
            big = (x >> np.uint64(s)) != 0
            n += np.where(big, s, 0)
            x = np.where(big, x >> np.uint64(s), x)
        return n

    xh = np.where(neg, ~hi, hi)
    bits = np.where(xh != 0, 64 + bit_length(xh),
                    bit_length(np.where(neg, ~lo, lo)))
    return be, bits // 8 + 1


def _host_string_rows(col, rows):
    """(uint8 (k, W) zero-padded bytes, int64 lengths) of the given rows
    of a STRING column (either layout), gathered on the device and read
    to the host."""
    idx = torch.from_numpy(rows).to(col.device)
    if col.is_padded_string:
        lens, mat = col.data[idx], col.chars[idx]
    else:
        starts = col.data[idx].long()
        lens = col.data[idx + 1] - col.data[idx]
        j = torch.arange(max(int(lens.max()) if len(rows) else 0, 1),
                         device=col.device)
        mat = col.chars[(starts[:, None] + j).clamp_(
            max=max(int(col.chars.numel()) - 1, 0))]
        mat.masked_fill_(j[None, :] >= lens[:, None], 0)
    return mat.cpu().numpy(), lens.cpu().numpy().astype("int64")


def np_table_hash(table, rows, seed: int = 42):
    """Spark's row hash of ``rows`` of the table on the host: each value's
    bytes (hashInt: the int32 value, hashLong: the 8 bytes, -0.0 made
    0.0, DECIMAL128: the minimal big-endian bytes, STRING: its bytes)
    hashed with the running hash as seed; int64 bits."""
    import numpy as np

    from spark_rapids_jni_tpu_torch.types import TypeId

    rows_t = torch.from_numpy(rows)
    h = np.full(len(rows), seed, np.uint64)
    for col in table.columns:
        tid = col.dtype.type_id
        valid = col.valid_mask()[rows_t.to(col.device)].cpu().numpy()
        if tid == TypeId.STRING:
            mat, lens = _host_string_rows(col, rows)
            hashed = np_xxh64_rows(mat, lens, h)
        elif col.dtype.is_decimal128:
            be, nbytes = _decimal128_bytes(
                col.data[rows_t.to(col.device)].cpu().numpy())
            left = np.zeros_like(be)
            for k in range(16):  # left-align the minimal bytes
                src = np.clip(16 - nbytes + k, 0, 15)
                left[:, k] = be[np.arange(len(be)), src]
            hashed = np_xxh64_rows(left, nbytes, h)
        else:
            v = col.data[rows_t.to(col.device)].cpu().numpy()
            if v.dtype.kind == "f":
                v = np.where(v == 0, v.dtype.type(0), v)
                hashed = np_xxh64_fixed(v.view(np.uint8).reshape(
                    len(v), -1), h)
            elif v.dtype.itemsize <= 4:
                hashed = np_xxh64_fixed(_le_bytes(v, np.int32), h)
            else:
                hashed = np_xxh64_fixed(_le_bytes(v, np.int64), h)
        h = np.where(valid, hashed, h)
    return h.view(np.int64)


def np_murmur3_long(values, seed):
    """Murmur3_x86_32.hashLong (Spark) in numpy uint32 lanes."""
    import numpy as np

    def rotl32(x, r):
        return (x << np.uint32(r)) | (x >> np.uint32(32 - r))

    v = values.view(np.uint64)
    h1 = np.broadcast_to(np.asarray(seed, np.uint32), v.shape).copy()
    with np.errstate(over="ignore"):
        for word in ((v & np.uint64(0xFFFFFFFF)).astype(np.uint32),
                     (v >> np.uint64(32)).astype(np.uint32)):
            k1 = rotl32(word * np.uint32(0xCC9E2D51), 15) \
                * np.uint32(0x1B873593)
            h1 = rotl32(h1 ^ k1, 13) * np.uint32(5) + np.uint32(0xE6546B64)
        h1 ^= np.uint32(8)
        h1 = (h1 ^ (h1 >> np.uint32(16))) * np.uint32(0x85EBCA6B)
        h1 = (h1 ^ (h1 >> np.uint32(13))) * np.uint32(0xC2B2AE35)
        return h1 ^ (h1 >> np.uint32(16))


def np_spark_bloom_bits(keys, num_bits: int, num_hashes: int):
    """Spark's BloomFilterAggregate on the host: xxhash64(key, 42), then
    BloomFilterImpl.putLong; one byte per bit."""
    import numpy as np

    pre = np_xxh64_fixed(_le_bytes(keys, np.int64),
                         np.full(len(keys), 42, np.uint64)).view(np.int64)
    h1 = np_murmur3_long(pre, np.uint32(0))
    h2 = np_murmur3_long(pre, h1)
    bits = np.zeros(num_bits, np.uint8)
    with np.errstate(over="ignore"):
        for i in range(1, num_hashes + 1):
            c = (h1 + np.uint32(i) * h2).view(np.int32)
            c = np.where(c < 0, ~c, c)
            bits[c.astype(np.int64) % num_bits] = 1
    return bits


def _timed(what: str, fn, nbytes: int, rows: int,
           warm: bool = True) -> dict:
    """Host median of 3 of ``fn()`` beside its byte bound."""
    s = host_median_s(fn, warm=warm)
    b_ms, _ = bound(nbytes, 0)
    log(f"{what}: {s * 1e3:.3f} ms, {rows / s:.4g} rows/s (byte bound "
        f"{b_ms:.3f} ms)")
    return {"s": s, "rows_per_s": rows / s, "bound_ms": b_ms}


def _no_launch(name: str, fn):
    """``fn()`` with the counts set to 0 just before it and read just
    after: these paths launch no kernel of A-D and fall back nowhere."""
    from spark_rapids_jni_tpu_torch.ops import kernels

    kernels.reset_counts()
    res = fn()
    torch.cuda.synchronize()
    require(kernels.launches() == {} and not kernels.fallbacks(),
            f"{name}: launches {kernels.launches()}, fallbacks "
            f"{kernels.fallbacks()}")
    return res


def _sample_rows(n: int, k: int, seed: int):
    import numpy as np

    return np.sort(np.random.default_rng(seed).choice(n, min(k, n),
                                                      replace=False))


def hash_phase(li, li12, dev) -> dict:
    """``table_xxhash64`` over lineitem, q12's lineitem (a STRING column)
    and one DECIMAL128 column, ``partition_hash`` over q3's l_orderkey,
    each held to the numpy oracle on a seeded sample."""
    import numpy as np

    from spark_rapids_jni_tpu_torch import types as t
    from spark_rapids_jni_tpu_torch.columnar import Column, Table
    from spark_rapids_jni_tpu_torch.models import tpch
    from spark_rapids_jni_tpu_torch.ops.hash import (
        partition_hash,
        table_xxhash64,
    )

    torch.cuda.reset_peak_memory_stats()
    times = {}
    rows = _sample_rows(ROWS, HASH_SAMPLE, 12)

    def check(what, table, got):
        t0 = time.perf_counter()
        want = np_table_hash(table, rows)
        require(np.array_equal(got[torch.from_numpy(rows).to(dev)].cpu()
                               .numpy(), want),
                f"{what}: row hash differs from the numpy XXH64")
        log(f"{what}: {len(rows)} sampled rows equal to the numpy XXH64 "
            f"({time.perf_counter() - t0:.1f} s on the host)")

    got = _no_launch("hash lineitem", lambda: table_xxhash64(li))
    check("table_xxhash64(lineitem, 7 columns)", li, got)
    times["hash_lineitem"] = _timed(
        "table_xxhash64(lineitem)", lambda: table_xxhash64(li),
        distinct_bytes([c.data for c in li.columns]) + got.nbytes, ROWS)
    del got

    got = _no_launch("hash q12 lineitem", lambda: table_xxhash64(li12))
    check("table_xxhash64(q12 lineitem, STRING l_shipmode)", li12, got)
    times["hash_q12_lineitem"] = _timed(
        "table_xxhash64(q12 lineitem)", lambda: table_xxhash64(li12),
        distinct_bytes([c.data for c in li12.columns]
                       + [li12.column(1).chars]) + got.nbytes, ROWS)
    del got

    # one DECIMAL128 column across the signed range, at every byte count:
    # the high limb shifted right by 0..63 bits, and where that leaves
    # only sign bits, the low limb shifted too
    rng = np.random.default_rng(13)
    hi = rng.integers(-2**63, 2**63 - 1, ROWS, dtype=np.int64, endpoint=True)
    hi >>= rng.integers(0, 64, ROWS)
    lo = rng.integers(-2**63, 2**63 - 1, ROWS, dtype=np.int64, endpoint=True)
    short = rng.integers(0, 64, ROWS)
    mag = np.abs(lo >> 1) >> short
    lo = np.where(hi == 0, mag, np.where(hi == -1, ~mag, lo))
    dec = Table([Column.from_numpy(np.stack([lo, hi], 1), t.decimal128(-2))])
    del hi, lo, short, mag
    got = _no_launch("hash decimal128", lambda: table_xxhash64(dec))
    check("table_xxhash64(DECIMAL128)", dec, got)
    times["hash_decimal128"] = _timed(
        "table_xxhash64(DECIMAL128)", lambda: table_xxhash64(dec),
        dec.column(0).data.nbytes + got.nbytes, ROWS)
    del dec, got

    li3 = tpch.lineitem_q3_table(ROWS, Q3_ORDERS)
    keys = Table([li3.column(tpch.L3_ORDERKEY)])
    del li3
    parts = _no_launch("partition_hash", lambda: partition_hash(
        keys, [0], SHUFFLE_PARTITIONS))
    want = np_table_hash(keys, rows) % SHUFFLE_PARTITIONS
    require(np.array_equal(parts[torch.from_numpy(rows).to(dev)].cpu()
                           .numpy(), want.astype(np.int32)),
            "partition_hash differs from the numpy oracle")
    counts = torch.bincount(parts.to(torch.int64),
                            minlength=SHUFFLE_PARTITIONS)
    require(int(counts.sum()) == ROWS and len(counts) == SHUFFLE_PARTITIONS,
            "partition counts do not sum to the rows")
    log(f"partition_hash(l_orderkey, {SHUFFLE_PARTITIONS}): {len(rows)} "
        f"sampled rows equal to the numpy oracle; counts sum to {ROWS}; "
        f"largest {int(counts.max())}, smallest {int(counts.min())}")
    times["partition_hash"] = _timed(
        f"partition_hash(l_orderkey, {SHUFFLE_PARTITIONS})",
        lambda: partition_hash(keys, [0], SHUFFLE_PARTITIONS),
        keys.column(0).data.nbytes + parts.nbytes, ROWS)
    times["partition_hash"].update(largest=int(counts.max()),
                                   smallest=int(counts.min()))
    del keys, parts, counts
    torch.cuda.empty_cache()
    peak = torch.cuda.max_memory_allocated() / 2**30
    require(peak < 40, f"hash phase peak {peak:.2f} GiB")
    log(f"peak device memory of the hash phase {peak:.2f} GiB")
    return {"paths": times, "peak_gib": peak}


def bloom_phase() -> dict:
    """Spark's runtime join filter shaped on q3: built from the orders
    before q3's cutoff, probed with every lineitem order key."""
    import numpy as np

    from spark_rapids_jni_tpu_torch.models import tpch
    from spark_rapids_jni_tpu_torch.ops import bloom_filter as bf

    torch.cuda.reset_peak_memory_stats()
    times = {}
    orders = tpch.orders_table(Q3_ORDERS, Q3_CUSTOMERS)
    okey = orders.column(tpch.O_ORDERKEY).data
    keep = orders.column(tpch.O_ORDERDATE).data < tpch._Q3_CUTOFF_DAYS
    del orders
    n_build = int(keep.sum())
    m, k = bf.optimal_params(n_build, 0.03)
    empty = bf.BloomFilter.empty(m, k)

    def build():
        return bf.bloom_put_spark(empty, okey, keep)

    f = _no_launch("bloom build", build)
    keys_host = okey.cpu().numpy()[keep.cpu().numpy()]
    t0 = time.perf_counter()
    want = np_spark_bloom_bits(keys_host, m, k)
    require(np.array_equal(f.bits.cpu().numpy(), want),
            "bloom bits differ from the numpy putLong oracle")
    log(f"bloom build: {n_build} keys, {m} bits, {k} hashes; bits equal to "
        f"the numpy putLong oracle ({time.perf_counter() - t0:.1f} s on "
        f"the host)")
    half = Q3_ORDERS // 2
    merged = bf.bloom_merge(
        bf.bloom_put_spark(empty, okey[:half], keep[:half]),
        bf.bloom_put_spark(empty, okey[half:], keep[half:]))
    require(torch.equal(merged.bits, f.bits),
            "bloom_merge of the halves differs from the whole build")
    require(torch.equal(bf.BloomFilter.from_packed(
        f.to_packed(), m, k).bits, f.bits), "packed round trip differs")
    del merged

    lkey = tpch.lineitem_q3_table(ROWS, Q3_ORDERS).column(
        tpch.L3_ORDERKEY).data
    hit = _no_launch("bloom probe",
                     lambda: bf.bloom_might_contain_spark(f, lkey))
    member = np.zeros(Q3_ORDERS + 1, bool)
    member[keys_host] = True
    in_build = member[lkey.cpu().numpy()]
    hit_h = hit.cpu().numpy()
    require(bool(hit_h[in_build].all()), "bloom probe: a false negative")
    fp = float(hit_h[~in_build].mean())
    require(fp <= 0.035, f"bloom false-positive share {fp:.5f} > 0.035")
    log(f"bloom probe: {ROWS} lineitem keys, {int(in_build.sum())} in the "
        f"build, no false negative; false-positive share {fp:.5f} of "
        f"{int((~in_build).sum())} (design 0.03)")
    times["bloom_build"] = _timed(
        "bloom_put_spark (q3 orders)", build,
        okey.nbytes + keep.nbytes + f.bits.nbytes, Q3_ORDERS)
    times["bloom_probe"] = _timed(
        "bloom_might_contain_spark (lineitem)",
        lambda: bf.bloom_might_contain_spark(f, lkey),
        lkey.nbytes + f.bits.nbytes + hit.nbytes, ROWS)
    times["bloom_probe"].update(false_positive_share=fp, num_bits=m,
                                num_hashes=k, build_keys=n_build)
    del f, lkey, hit, okey, keep, empty
    torch.cuda.empty_cache()
    peak = torch.cuda.max_memory_allocated() / 2**30
    require(peak < 40, f"bloom phase peak {peak:.2f} GiB")
    log(f"peak device memory of the bloom phase {peak:.2f} GiB")
    return {"paths": times, "peak_gib": peak}


def _day_tables(lo: int, hi: int) -> dict:
    """Per-day answers for days lo..hi since 1970-01-01 from Python's
    datetime (the oracle of the date functions)."""
    import calendar
    import datetime as pydt

    import numpy as np

    epoch = pydt.date(1970, 1, 1)
    cols = {k: [] for k in (
        "year", "month", "day", "day_of_week", "day_of_week_spark",
        "day_of_year", "quarter", "last_day", "weekofyear", "trunc_year",
        "trunc_quarter", "trunc_month", "trunc_week", "next_day_tu",
        "add_months_1", "date_add_-45", "month_end")}

    def days(d):
        return (d - epoch).days

    for z in range(lo, hi + 1):
        d = epoch + pydt.timedelta(days=z)
        last = calendar.monthrange(d.year, d.month)[1]
        ny, nm = (d.year + 1, 1) if d.month == 12 else (d.year, d.month + 1)
        for key, val in (
                ("year", d.year), ("month", d.month), ("day", d.day),
                ("day_of_week", d.isoweekday()),
                ("day_of_week_spark", d.isoweekday() % 7 + 1),
                ("day_of_year", d.timetuple().tm_yday),
                ("quarter", (d.month - 1) // 3 + 1),
                ("last_day", days(d.replace(day=last))),
                ("weekofyear", d.isocalendar()[1]),
                ("trunc_year", days(pydt.date(d.year, 1, 1))),
                ("trunc_quarter", days(pydt.date(
                    d.year, (d.month - 1) // 3 * 3 + 1, 1))),
                ("trunc_month", days(d.replace(day=1))),
                ("trunc_week", z - d.weekday()),
                ("next_day_tu", z + (1 - d.weekday() + 6) % 7 + 1),
                ("add_months_1", days(pydt.date(ny, nm, min(
                    d.day, calendar.monthrange(ny, nm)[1])))),
                ("date_add_-45", z - 45), ("month_end", d.day == last)):
            cols[key].append(val)
    return {k: np.array(v) for k, v in cols.items()}


def _np_months_between(tab, lo, z1, s1, z2, s2):
    """Spark's months_between from the per-day calendar: whole months,
    plus ((dom1 - dom2) * 86400 + secs1 - secs2) / (31 * 86400) unless
    the days of month match or both are month ends; 8 decimals."""
    import numpy as np

    i1, i2 = z1 - lo, z2 - lo
    months = ((tab["year"][i1] - tab["year"][i2]) * 12
              + tab["month"][i1] - tab["month"][i2]).astype(np.float64)
    whole = (tab["day"][i1] == tab["day"][i2]) | (
        tab["month_end"][i1] & tab["month_end"][i2])
    secs = ((tab["day"][i1] - tab["day"][i2]) * 86_400 + s1 - s2)
    out = np.where(whole, months, months + secs.astype(np.float64)
                   / (31.0 * 86_400.0))
    return np.round(out * 1e8) / 1e8


def datetime_phase(li, li12, dev) -> dict:
    """Every datetime function over l_shipdate (and the timestamps made
    from it), datediff and months_between over q12's receipt and commit
    dates, each against the per-day Python datetime table."""
    import numpy as np

    from spark_rapids_jni_tpu_torch import types as t
    from spark_rapids_jni_tpu_torch.columnar import Column
    from spark_rapids_jni_tpu_torch.models import tpch
    from spark_rapids_jni_tpu_torch.ops import datetime as dt

    torch.cuda.reset_peak_memory_stats()
    ship = li.column(tpch.L_SHIPDATE)
    commit = li12.column(tpch.L12_COMMITDATE)
    receipt = li12.column(tpch.L12_RECEIPTDATE)
    micros = np.random.default_rng(14).integers(0, 86_400_000_000, ROWS)
    ship_h = ship.data.cpu().numpy().astype(np.int64)
    ts = Column.from_numpy(ship_h * 86_400_000_000 + micros,
                           t.TIMESTAMP_MICROSECONDS)
    lo = int(min(commit.data.min(), receipt.data.min(), ship.data.min()))
    hi = int(max(commit.data.max(), receipt.data.max(), ship.data.max()))
    t0 = time.perf_counter()
    tab = _day_tables(lo, hi)
    dev_tab = {k: torch.from_numpy(v.astype(np.int64)).to(dev)
               for k, v in tab.items()}
    log(f"datetime oracle: {hi - lo + 1} days from Python's datetime in "
        f"{time.perf_counter() - t0:.1f} s")
    idx = ship.data.to(torch.int64) - lo

    cases = {
        "year": ("year", dt.year), "month": ("month", dt.month),
        "day": ("day", dt.day), "day_of_week": ("day_of_week",
                                                dt.day_of_week),
        "day_of_week_spark": ("day_of_week_spark", dt.day_of_week_spark),
        "day_of_year": ("day_of_year", dt.day_of_year),
        "quarter": ("quarter", dt.quarter),
        "last_day": ("last_day", dt.last_day),
        "weekofyear": ("weekofyear", dt.weekofyear),
        "trunc(year)": ("trunc_year", lambda c: dt.trunc(c, "year")),
        "trunc(quarter)": ("trunc_quarter",
                           lambda c: dt.trunc(c, "quarter")),
        "trunc(month)": ("trunc_month", lambda c: dt.trunc(c, "month")),
        "trunc(week)": ("trunc_week", lambda c: dt.trunc(c, "week")),
        "next_day(TU)": ("next_day_tu", lambda c: dt.next_day(c, "TU")),
        "add_months(1)": ("add_months_1", lambda c: dt.add_months(c, 1)),
        "date_add(-45)": ("date_add_-45", lambda c: dt.date_add(c, -45)),
    }
    times = {}
    # 4-byte days in; 4-byte result and a 1-byte validity out
    day_bytes = 9 * ROWS
    for what, (key, fn) in cases.items():
        out = _no_launch(what, lambda: fn(ship))
        require(torch.equal(out.data.to(torch.int64), dev_tab[key][idx])
                and bool(out.validity.all()),
                f"{what} differs from Python's datetime")
        times[what] = _timed(what, lambda: fn(ship), day_bytes, ROWS)
    for what, fn, key in (("year(timestamp)", dt.year, "year"),
                          ("weekofyear(timestamp)", dt.weekofyear,
                           "weekofyear")):
        out = _no_launch(what, lambda: fn(ts))
        require(torch.equal(out.data.to(torch.int64), dev_tab[key][idx]),
                f"{what} differs from Python's datetime")
    micros_d = torch.from_numpy(micros).to(dev)
    for what, fn, want in (
            ("hour", dt.hour, micros_d // 3_600_000_000),
            ("minute", dt.minute, micros_d // 60_000_000 % 60),
            ("second", dt.second, micros_d // 1_000_000 % 60)):
        out = _no_launch(what, lambda: fn(ts))
        require(torch.equal(out.data.to(torch.int64), want),
                f"{what} differs from the intraday microseconds")
        times[what] = _timed(what, lambda: fn(ts), 14 * ROWS, ROWS)
    del micros_d

    out = _no_launch("datediff", lambda: dt.datediff(receipt, commit))
    require(torch.equal(out.data, receipt.data - commit.data),
            "datediff(receipt, commit) differs")
    times["datediff(receipt, commit)"] = _timed(
        "datediff(receipt, commit)", lambda: dt.datediff(receipt, commit),
        13 * ROWS, ROWS)
    r_h = receipt.data.cpu().numpy().astype(np.int64)
    c_h = commit.data.cpu().numpy().astype(np.int64)
    zeros = np.zeros(ROWS, np.int64)
    for what, a, b, want in (
            ("months_between(receipt, commit)", receipt, commit,
             _np_months_between(tab, lo, r_h, zeros, c_h, zeros)),
            ("months_between(timestamp, receipt)", ts, receipt,
             _np_months_between(tab, lo, ship_h, micros // 1_000_000,
                                r_h, zeros))):
        out = _no_launch(what, lambda: dt.months_between(a, b))
        require(np.array_equal(out.data.cpu().numpy(), want),
                f"{what} differs from the per-day oracle")
        in_bytes = a.data.element_size() + b.data.element_size()
        times[what] = _timed(what, lambda: dt.months_between(a, b),
                             (in_bytes + 9) * ROWS, ROWS)
    log(f"datetime: {len(cases) + 7} functions over {ROWS} rows equal to "
        f"Python's datetime (per-day table) and the intraday arithmetic")
    del ship, ts, commit, receipt, dev_tab, idx, out
    torch.cuda.empty_cache()
    peak = torch.cuda.max_memory_allocated() / 2**30
    require(peak < 40, f"datetime phase peak {peak:.2f} GiB")
    log(f"peak device memory of the datetime phase {peak:.2f} GiB")
    return {"paths": times, "peak_gib": peak}


def string_q1_q13_phase(q1_oracle: dict, flags) -> dict:
    """The general q1 over STRING flags against ``flags``, the INT8
    general q1 of the same lineitem, and the numpy oracle; q13's
    single-pass reference against np.bincount."""
    import numpy as np

    from spark_rapids_jni_tpu_torch.models import tpch

    torch.cuda.reset_peak_memory_stats()
    times = {}
    li_s = tpch.lineitem_table_strings(ROWS, seed=0)
    got = _no_launch("string q1", lambda: tpch.tpch_q1(li_s))
    for i, (a, b) in enumerate(zip(got.columns, flags.columns)):
        v = b.valid_mask()
        require(torch.equal(a.valid_mask(), v), f"string q1 column {i} "
                "validity differs from the INT8 q1")
        if i < 2:
            require(bool((a.data[v] == 1).all()) and torch.equal(
                a.chars[v, 0], b.data[v].view(torch.uint8)),
                f"string q1 key {i} differs from the INT8 flags")
        else:
            require(torch.equal(a.data[v], b.data[v]),
                    f"string q1 column {i} differs from the INT8 q1")
    keys = [(int(a), int(b)) for a, b in zip(
        got.column(0).chars[:6, 0].tolist(), got.column(1).chars[:6, 0]
        .tolist())]
    require(sorted(q1_oracle) == keys, f"string q1 groups {keys}")
    for g, key in enumerate(keys):
        for j, name in enumerate(("sum_qty", "sum_base_price",
                                  "sum_disc_price", "sum_charge")):
            require(int(got.column(2 + j).data[g]) == q1_oracle[key][name],
                    f"string q1 {key} {name}")
        require(int(got.column(9).data[g]) == q1_oracle[key]["count"],
                f"string q1 {key} count")
    log("string q1: the 6 groups equal the INT8 general q1 (flag bytes as "
        "one-character strings) and the numpy oracle; no launch")
    times["tpch_q1_strings"] = _timed(
        "tpch_q1(lineitem_table_strings)", lambda: tpch.tpch_q1(li_s),
        distinct_bytes([c.data for c in li_s.columns]
                       + [c.chars for c in li_s.columns]), ROWS)
    del li_s, got

    orders = tpch.orders_table(Q3_ORDERS, Q3_CUSTOMERS)
    got = _no_launch("q13", lambda: tpch.tpch_q13_reference(orders))
    t0 = time.perf_counter()
    want = tpch.tpch_q13_oracle(orders)
    require(np.array_equal(got.column(0).data.cpu().numpy(),
                           want["custkey"])
            and np.array_equal(got.column(1).data.cpu().numpy(),
                               want["count"]),
            "q13 counts differ from np.bincount")
    log(f"q13: {len(want['custkey'])} customers with orders, counts equal "
        f"to np.bincount in key order ({time.perf_counter() - t0:.1f} s on "
        f"the host); no launch")
    times["tpch_q13_reference"] = _timed(
        "tpch_q13_reference(orders)",
        lambda: tpch.tpch_q13_reference(orders),
        distinct_bytes([c.data for c in orders.columns[:2]])
        + got.column(0).data.nbytes + got.column(1).data.nbytes, Q3_ORDERS)
    del orders, got
    torch.cuda.empty_cache()
    peak = torch.cuda.max_memory_allocated() / 2**30
    require(peak < 40, f"string q1 and q13 peak {peak:.2f} GiB")
    log(f"peak device memory of string q1 and q13 {peak:.2f} GiB")
    return {"paths": times, "peak_gib": peak}


ENGINE_SAMPLE = 1_000_000  # rows of the host oracles and host-engine slices
UNICODE_VERSION = "15.0.0"  # the case tables' Unicode database (Python 3.12)
JSON_PATHS = ("$.meta.w", "$.sku", "$.price", "$.nope")


def _sampled_bytes(col, rows) -> list:
    """The given rows' bytes of a STRING column."""
    mat, lens = _host_string_rows(col, rows)
    return [mat[i, :lens[i]].tobytes() for i in range(len(rows))]


def _py_substr(s: str, start: int, length):
    """Spark's substr on a host string (the end of a negative start from
    the unclamped position)."""
    n = len(s)
    raw = n + start if start < 0 else start
    b = min(max(raw, 0), n)
    if length is None:
        return s[b:]
    e = min(max(raw + length, 0), n) if start < 0 else b + min(
        max(length, 0), n - b)
    return s[b:max(e, b)]


def _json_oracle(doc: str, path: str):
    """get_json_object of a flat-path ``$.a.b`` on the host: Python json,
    strings unquoted, numbers and containers as compact text, JSON null
    and missing keys None."""
    import json

    v = json.loads(doc)
    for key in path[2:].split("."):
        if not isinstance(v, dict) or key not in v:
            return None
        v = v[key]
    if v is None or isinstance(v, str):
        return v
    return json.dumps(v, separators=(",", ":"))


def _fallbacks_line(what: str) -> dict:
    from spark_rapids_jni_tpu_torch import telemetry

    fb = {f"{op}: {reason}": v for (op, reason), v in
          telemetry.fallbacks().items()}
    log(f"{what}: host fallbacks {fb if fb else 'none'}")
    return fb


def string_engines_phase(dev) -> dict:
    """RLIKE over bench.py's log lines (the device DFA, and the host engine
    for a refused pattern), substring, upper and lower over them and over
    a mixed-script column, and get_json_object over bench.py's documents
    (four paths, and an escaped column the port refuses), each against a
    host oracle, none launching a kernel of A-D."""
    import platform
    import re
    import unicodedata

    import numpy as np

    from spark_rapids_jni_tpu_torch import telemetry
    from spark_rapids_jni_tpu_torch.columnar import Column
    from spark_rapids_jni_tpu_torch.columnar.column import string_column
    from spark_rapids_jni_tpu_torch.models import bench_strings as bs
    from spark_rapids_jni_tpu_torch.ops import strings as st
    from spark_rapids_jni_tpu_torch.ops.get_json_object import (
        get_json_object,
    )
    from spark_rapids_jni_tpu_torch.ops.strings import static_strings
    from spark_rapids_jni_tpu_torch.types import STRING

    log(f"Unicode database {unicodedata.unidata_version} (Python "
        f"{platform.python_version()})")
    require(unicodedata.unidata_version == UNICODE_VERSION,
            f"the case tables need Unicode {UNICODE_VERSION}, the CPU "
            f"tests' database")
    torch.cuda.reset_peak_memory_stats()
    times, fallbacks = {}, {}
    rows = _sample_rows(ROWS, ENGINE_SAMPLE, 13)
    t0 = time.perf_counter()
    lines, words = bs.log_lines(ROWS, seed=12)
    lens = lines.data[1:] - lines.data[:-1]
    widest = int(lens.max())
    log(f"log lines: {ROWS} rows, {lines.chars.numel()} bytes, the widest "
        f"{widest} bytes, built in {time.perf_counter() - t0:.1f} s")
    text_bytes = lines.chars.nbytes + lines.data.nbytes

    # RLIKE on the device: the widest row fills the position-major image,
    # so the run ends with the sentinel step
    pattern = r"status=[45]\d\d"
    telemetry.reset()
    got = _no_launch("rlike", lambda: st.regexp_contains(lines, pattern))
    fallbacks["rlike"] = _fallbacks_line("rlike")
    require(not fallbacks["rlike"], "rlike took the host engine")
    want = (words == bs.LOG_WORDS.index("status=404")).any(0)
    require(got.validity is None and torch.equal(got.data.bool(), want),
            "rlike differs from the generator's word indices")
    sample = [b.decode() for b in _sampled_bytes(lines, rows)]
    rx = re.compile(pattern, re.ASCII)
    require(got.data[torch.from_numpy(rows).to(dev)].cpu().numpy()
            .astype(bool).tolist() == [rx.search(v) is not None
                                       for v in sample],
            "rlike differs from Python re on the sample")
    log(f"rlike {pattern}: {int(want.sum())} of {ROWS} lines match, equal "
        f"to the word indices and to Python re on {len(rows)} sampled "
        f"rows; widest row {widest} bytes = the image width (sentinel "
        f"step); no launch")
    times["rlike"] = _timed("regexp_contains(log lines)",
                            lambda: st.regexp_contains(lines, pattern),
                            text_bytes + ROWS, ROWS, warm=False)

    # a pattern the DFA refuses (a backreference): the host engine
    refused = r"status=(\d)0\1"
    head = Column(STRING, lines.data[:ENGINE_SAMPLE + 1], None,
                  chars=lines.chars[:int(lines.data[ENGINE_SAMPLE])])
    telemetry.reset()
    t0 = time.perf_counter()
    got = _no_launch("rlike host engine",
                     lambda: st.regexp_contains(head, refused))
    host_s = time.perf_counter() - t0
    fallbacks["rlike_host"] = _fallbacks_line("rlike, refused pattern")
    require(telemetry.fallbacks() == {
        ("regexp_contains", "unsupported regex atom: escape \\1"):
            {"calls": 1, "rows": ENGINE_SAMPLE}},
        "the refused pattern's host run is not recorded")
    require(torch.equal(got.data.bool(), want[:ENGINE_SAMPLE]),
            "the host engine differs from the word indices")
    log(f"rlike {refused} (refused by the DFA): the host engine over "
        f"{ENGINE_SAMPLE} rows in {host_s:.1f} s, equal to the word "
        f"indices, recorded")
    times["rlike_host_engine"] = {"s": host_s, "rows": ENGINE_SAMPLE}
    del got, want, head

    # substring, upper and lower over the log lines (ASCII: no host step)
    telemetry.reset()
    for name, fn, py in (
            ("upper", st.upper, str.upper), ("lower", st.lower, str.lower),
            ("substring_3_8", lambda c: st.substring(c, 3, 8),
             lambda v: _py_substr(v, 3, 8)),
            ("substring_-6_4", lambda c: st.substring(c, -6, 4),
             lambda v: _py_substr(v, -6, 4))):
        out = _no_launch(name, lambda: fn(lines))
        require([b.decode() for b in _sampled_bytes(out, rows)]
                == [py(v) for v in sample], f"{name} differs from Python")
        out_bytes = out.chars.nbytes + out.data.nbytes
        del out
        times[name] = _timed(f"{name}(log lines)", lambda: fn(lines),
                             text_bytes + out_bytes, ROWS, warm=False)
    fallbacks["log_case"] = _fallbacks_line("upper/lower of the log lines")
    require(not fallbacks["log_case"], "ASCII case mapping left the card")
    log(f"upper, lower, substring(3, 8) and substring(-6, 4) of the log "
        f"lines equal to Python's on {len(rows)} sampled rows")
    del lines, words, lens, sample
    torch.cuda.empty_cache()

    # a mixed-script column: special rows mapped on the host, merged back
    values = bs.mixed_script_rows(ENGINE_SAMPLE, seed=14,
                                  special_share=0.01)
    mixed = string_column(values, device=dev)
    for name, fn, py in (("upper_mixed", st.upper, str.upper),
                         ("lower_mixed", st.lower, str.lower)):
        telemetry.reset()
        out = _no_launch(name, lambda: fn(mixed))
        fallbacks[name] = _fallbacks_line(name)
        require(out.to_pylist() == [py(v) for v in values],
                f"{name} differs from Python")
        times[name] = _timed(f"{name} ({ENGINE_SAMPLE} rows)",
                             lambda: fn(mixed),
                             mixed.chars.nbytes + mixed.data.nbytes
                             + out.chars.nbytes + out.data.nbytes,
                             ENGINE_SAMPLE, warm=False)
    out = _no_launch("substring_mixed", lambda: st.substring(mixed, 2, 6))
    require(out.row_bytes() == [v.encode()[2:8] for v in values],
            "substring of the mixed column differs from Python")
    log(f"upper, lower and substring(2, 6) of {ENGINE_SAMPLE} mixed-script "
        f"rows equal to Python's str methods")
    del mixed, out, values

    # get_json_object over bench.py's documents, tiled to SF10 rows
    t0 = time.perf_counter()
    docs = bs.json_docs(ROWS)
    templates = bs.json_templates()
    tid = torch.arange(ROWS, device=dev) % len(templates)
    log(f"json documents: {ROWS} rows, padded width {docs.chars.shape[1]}, "
        f"built in {time.perf_counter() - t0:.1f} s")
    telemetry.reset()
    for path in JSON_PATHS:
        got = _no_launch(f"get_json_object {path}",
                         lambda: get_json_object(docs, path))
        want = [_json_oracle(d, path) for d in templates]
        wlen, wmat = static_strings(want, dev)
        wvalid = torch.tensor([v is not None for v in want], device=dev)
        ww = int(wmat.shape[1])
        require(torch.equal(got.validity, wvalid[tid])
                and torch.equal(got.data, wlen[tid])
                and torch.equal(got.chars[:, :ww], wmat[tid])
                and (got.chars.shape[1] <= ww
                     or int(got.chars[:, ww:].max()) == 0),
                f"get_json_object {path} differs from Python json")
        out_bytes = got.chars.nbytes + got.data.nbytes + got.validity.nbytes
        log(f"get_json_object {path}: {int(wvalid[tid].sum())} values, "
            f"equal to Python json over the templates; no launch")
        del got
        times[f"json {path}"] = _timed(
            f"get_json_object(docs, {path})",
            lambda: get_json_object(docs, path),
            docs.chars.nbytes + docs.data.nbytes + out_bytes, ROWS,
            warm=False)
    fallbacks["json"] = _fallbacks_line("get_json_object")
    require(not fallbacks["json"], "the eligible documents left the card")
    del docs, tid

    # escaped documents: the native engine's work, which the port refuses
    esc = [t.replace('"s', '"\\"s', 1) for t in templates[:1000]]
    lens_e, mat_e = static_strings(esc, dev)
    col = Column(STRING, lens_e, None, chars=mat_e)
    telemetry.reset()
    try:
        get_json_object(col, "$.sku")
        raise AssertionError("the escaped column did not raise")
    except NotImplementedError:
        pass
    fallbacks["json_escaped"] = _fallbacks_line("escaped documents")
    require(len(fallbacks["json_escaped"]) == 1,
            "the escaped column's refusal is not recorded")
    log("get_json_object over 1000 escaped documents: NotImplementedError "
        "(the native engine's work), recorded")
    torch.cuda.empty_cache()
    peak = torch.cuda.max_memory_allocated() / 2**30
    require(peak < 30, f"string engines phase peak {peak:.2f} GiB")
    log(f"peak device memory of the string engines phase {peak:.2f} GiB")
    return {"paths": times, "peak_gib": peak, "fallbacks": fallbacks}


# ---- phase 13: regexp_extract, regexp_replace and the string functions ------

SPLIT_SAMPLE = 100_000  # sampled rows whose pieces str.split checks
HOST_ROUTES = (  # (name, function, pattern, argument, Python re's
    # argument, reason recorded) over the first ENGINE_SAMPLE lines
    ("replace_overflow", "replace", r"\d", "#", "#",
     "match-round budget overflow: a row exceeded the device replace "
     "rounds; rerouting whole column to host"),
    ("replace_group_ref", "replace", r"status=(\d+)", "code=$1", r"code=\1",
     "group-ref/escape replacement: device engine handles literal "
     "replacements only"),
    ("extract_alternation", "extract", r"(GET|POST) (\S+)", 2, 2,
     "unsupported linear-capture atom: alternation"),
)


def _first_word(words, wanted):
    """Per row: whether a slot holds one of ``wanted`` (word indices),
    the first such word, and its slot."""
    n = int(words.shape[1])
    dev = words.device
    hit = torch.zeros(n, dtype=torch.bool, device=dev)
    word = torch.full((n,), -1, dtype=torch.int64, device=dev)
    slot = torch.zeros(n, dtype=torch.int64, device=dev)
    for s in range(int(words.shape[0])):
        w = words[s].to(torch.int64)
        m = ~hit & torch.isin(w, torch.tensor(wanted, device=dev))
        word = torch.where(m, w, word)
        slot = torch.where(m, s, slot)
        hit |= m
    return hit, word, slot


def _row_digits(n: int, dev):
    """Each row number's digit count and its digit bytes, (max_digits,
    n) uint8, most significant first (0 past the count)."""
    rowid = torch.arange(n, device=dev)
    max_digits = len(str(max(n - 1, 0)))
    ndig = torch.ones_like(rowid)
    for p in range(1, max_digits):
        ndig += rowid >= 10 ** p
    digits = torch.zeros((max_digits, n), dtype=torch.uint8, device=dev)
    for d in range(max_digits):
        v = rowid // 10 ** (ndig - 1 - d).clamp(min=0) % 10 + ord("0")
        digits[d] = torch.where(d < ndig, v, 0).to(torch.uint8)
    return ndig, digits


def _word_table(dev, width: int):
    """The nine log words as a (9, width) zero-padded byte table."""
    from spark_rapids_jni_tpu_torch.models import bench_strings as bs

    table = torch.zeros((len(bs.LOG_WORDS), width), dtype=torch.uint8)
    for i, w in enumerate(bs.LOG_WORDS):
        table[i, :len(w)] = torch.tensor(list(w.encode()), dtype=torch.uint8)
    return table.to(dev)


def _slot_lengths(words, ndig):
    """(MAX_WORDS, n) byte length of each slot (0 past the row's words)."""
    from spark_rapids_jni_tpu_torch.models import bench_strings as bs

    wlen = torch.tensor([len(w) for w in bs.LOG_WORDS], device=words.device)
    w = words.to(torch.int64)
    return torch.where(w >= 0, wlen[w.clamp(min=0)]
                       + (w == bs.ID_WORD) * ndig, 0).to(torch.int32)


def _arrow_lengths(col):
    return col.data[1:] - col.data[:-1]


def _arrow_block(col, width: int):
    """(r0, r1) -> the Arrow column's rows as a (c, width) block."""
    from spark_rapids_jni_tpu_torch.ops.strings import _gather_rows

    lens = _arrow_lengths(col)
    jdx = torch.arange(width, dtype=torch.int32, device=col.device)

    def block(r0, r1):
        out = torch.zeros((r1 - r0, width), dtype=torch.uint8,
                          device=col.device)
        _gather_rows(col.chars, col.data[r0:r1],
                     lens[r0:r1].clamp(max=width), jdx, out)
        return out
    return block


def _host_route(head, route) -> dict:
    """One host route over the head slice: its one fallback recorded,
    its result equal to Python re on a sample of the slice."""
    import re

    from spark_rapids_jni_tpu_torch import telemetry
    from spark_rapids_jni_tpu_torch.ops import strings as st

    name, kind, pattern, arg, py_arg, reason = route
    fn = st.regexp_replace if kind == "replace" else st.regexp_extract
    telemetry.reset()
    t0 = time.perf_counter()
    got = _no_launch(name, lambda: fn(head, pattern, arg))
    host_s = time.perf_counter() - t0
    fb = _fallbacks_line(name)
    require(telemetry.fallbacks() == {
        (f"regexp_{kind}", reason): {"calls": 1, "rows": ENGINE_SAMPLE}},
        f"{name}: the host run is not recorded with its reason")
    rows = _sample_rows(ENGINE_SAMPLE, 20_000, 17)
    sample = [b.decode() for b in _sampled_bytes(head, rows)]
    rx = re.compile(pattern, re.ASCII)
    if kind == "replace":
        want = [rx.sub(py_arg, v) for v in sample]
    else:
        want = [(m.group(py_arg) if (m := rx.search(v)) else "")
                for v in sample]
    require([b.decode() for b in _sampled_bytes(got, rows)] == want,
            f"{name} differs from Python re")
    log(f"{name}: the host engine over {ENGINE_SAMPLE} rows in "
        f"{host_s:.1f} s, equal to Python re on {len(rows)} sampled rows, "
        f"recorded")
    return {"s": host_s, "rows": ENGINE_SAMPLE, "fallbacks": fb}


def capture_phase(dev) -> dict:
    """regexp_extract and regexp_replace (the linear capture engine) and
    the string functions over bench.py's log lines, concat_ws over SF10
    lineitem's two STRING flags and the lines, and three host routes of
    the capture functions, each against the word indices and a Python
    oracle on a sample, none launching a kernel of A-D."""
    import re

    import numpy as np

    from spark_rapids_jni_tpu_torch import telemetry
    from spark_rapids_jni_tpu_torch.columnar import Column
    from spark_rapids_jni_tpu_torch.models import bench_strings as bs
    from spark_rapids_jni_tpu_torch.models import tpch
    from spark_rapids_jni_tpu_torch.ops import strings as st
    from spark_rapids_jni_tpu_torch.ops import strings_fns as sf
    from spark_rapids_jni_tpu_torch.ops.strings import shift_block
    from spark_rapids_jni_tpu_torch.types import STRING

    torch.cuda.reset_peak_memory_stats()
    times, fallbacks = {}, {}
    rows_np = _sample_rows(ROWS, ENGINE_SAMPLE, 16)
    rows = torch.from_numpy(rows_np).to(dev)
    lines, words = bs.log_lines(ROWS, seed=12)
    lens = _arrow_lengths(lines)
    widest = int(lens.max())
    text_bytes = lines.chars.nbytes + lines.data.nbytes
    sample = [b.decode() for b in _sampled_bytes(lines, rows_np)]
    ndig, digits = _row_digits(ROWS, dev)
    slot_len = _slot_lengths(words, ndig)
    log(f"log lines: {ROWS} rows, {lines.chars.numel()} bytes, the widest "
        f"{widest} bytes")
    telemetry.reset()

    def timed(name, fn, out_bytes):
        times[name] = _timed(f"{name}(log lines)", fn, text_bytes + out_bytes,
                             ROWS, warm=False)

    def nbytes(*tensors):
        return sum(x.nbytes for x in tensors if x is not None)

    # regexp_extract status=(\d+): the first status word's code
    pattern = r"status=(\d+)"
    got = _no_launch("regexp_extract status",
                     lambda: st.regexp_extract(lines, pattern, 1))
    hit, word, _ = _first_word(words, (3, 4))
    codes = torch.tensor([list(b"200"), list(b"404")], dtype=torch.uint8,
                         device=dev)
    want3 = torch.where(hit[:, None], codes[(word == 4).to(torch.int64)], 0)
    require(got.validity is None and got.chars.shape[1] == widest + 1
            and torch.equal(got.data, torch.where(hit, 3, 0).to(torch.int32))
            and torch.equal(got.chars[:, :3], want3)
            and int(got.chars[:, 3:].amax()) == 0,
            "regexp_extract status differs from the word indices")
    del want3
    rx = re.compile(pattern, re.ASCII)
    require([b.decode() for b in _sampled_bytes(got, rows_np)]
            == [(m.group(1) if (m := rx.search(v)) else "") for v in sample],
            "regexp_extract status differs from Python re")
    log(f"regexp_extract {pattern}: {int(hit.sum())} codes, equal to the "
        f"word indices and to Python re on {len(rows_np)} sampled rows")
    out = nbytes(got.chars, got.data)
    del got
    timed("regexp_extract_status",
          lambda: st.regexp_extract(lines, pattern, 1), out)

    # regexp_extract id=(\d+): the row number
    pattern = r"id=(\d+)"
    got = _no_launch("regexp_extract id",
                     lambda: st.regexp_extract(lines, pattern, 1))
    hit, _, _ = _first_word(words, (bs.ID_WORD,))
    md = int(digits.shape[0])
    require(torch.equal(got.data, torch.where(hit, ndig, 0).to(torch.int32))
            and torch.equal(got.chars[:, :md],
                            torch.where(hit[None, :], digits, 0).t())
            and int(got.chars[:, md:].amax()) == 0,
            "regexp_extract id differs from the row numbers")
    rx = re.compile(pattern, re.ASCII)
    require([b.decode() for b in _sampled_bytes(got, rows_np)]
            == [(m.group(1) if (m := rx.search(v)) else "") for v in sample],
            "regexp_extract id differs from Python re")
    log(f"regexp_extract {pattern}: {int(hit.sum())} row numbers, equal to "
        f"the word indices and to Python re on the sample")
    out = nbytes(got.chars, got.data)
    del got
    timed("regexp_extract_id", lambda: st.regexp_extract(lines, pattern, 1),
          out)

    # regexp_replace status=\d+ -> status=XXX: the lines drawn again with
    # the two status words rewritten
    vocab = tuple("status=XXX" if w.startswith("status=") else w
                  for w in bs.LOG_WORDS)
    want_col, _ = bs.log_lines(ROWS, seed=12, vocab=vocab)
    got = _no_launch("regexp_replace status", lambda: st.regexp_replace(
        lines, r"status=\d+", "status=XXX"))
    require(not telemetry.fallbacks(), "regexp_replace left the card")
    w_out = widest + 1 + 8 * 10 + 1
    require(got.chars.shape[1] == w_out
            and torch.equal(got.data, _arrow_lengths(want_col)),
            "regexp_replace lengths differ from the rewritten lines")
    require(_rows_equal(got, _arrow_block(want_col, w_out)),
            "regexp_replace differs from the rewritten lines")
    rx = re.compile(r"status=\d+", re.ASCII)
    require([b.decode() for b in _sampled_bytes(got, rows_np)]
            == [rx.sub("status=XXX", v) for v in sample],
            "regexp_replace differs from Python re")
    log("regexp_replace status=\\d+ -> status=XXX: equal to the lines drawn "
        "with the rewritten words and to Python re on the sample; no "
        "overflow (at most 5 matches a row)")
    out = nbytes(got.chars, got.data)
    del got, want_col
    timed("regexp_replace_status", lambda: st.regexp_replace(
        lines, r"status=\d+", "status=XXX"), out)
    torch.cuda.empty_cache()

    # split on ' ' (the split+explode shape): one piece a word
    res = _no_launch("split", lambda: sf.split(lines, " ", max_pieces=5))
    lc = res.column
    child = lc.children[0]
    nwords = (words >= 0).sum(0)
    want_off = torch.zeros(ROWS + 1, dtype=torch.int64, device=dev)
    want_off[1:] = torch.cumsum(nwords, 0)
    require(not bool(res.overflowed) and lc.validity is None
            and torch.equal(lc.data, want_off.to(torch.int32))
            and child.chars.shape == (int(want_off[-1]), widest),
            "split offsets differ from the word counts")
    # the child rows: word table bytes, then the row number for id=
    table = _word_table(dev, widest)
    offs = want_off

    def piece_block(q0, q1):
        q = torch.arange(q0, q1, device=dev)
        row = torch.searchsorted(offs[1:], q, right=True)
        w = words[q - offs[row], row].to(torch.int64)
        blk = table[w].clone()
        is_id = w == bs.ID_WORD
        for d in range(md):
            blk[:, 3 + d] = torch.where(is_id & (d < ndig[row]),
                                        digits[d, row], blk[:, 3 + d])
        return blk
    slot_flat = slot_len.t()[(words >= 0).t()]  # live slots, row-major
    require(torch.equal(child.data, slot_flat.to(torch.int32)),
            "split piece lengths differ from the word lengths")
    require(_rows_equal(child, piece_block),
            "split pieces differ from the words")
    k = min(SPLIT_SAMPLE, len(sample))  # str.split of a part of the sample
    starts = lc.data[rows[:k]].tolist()
    ends = lc.data[rows[:k] + 1].tolist()
    flat = _sampled_bytes(child, np.concatenate(
        [np.arange(a, b) for a, b in zip(starts, ends)]))
    at = np.cumsum([0] + [b - a for a, b in zip(starts, ends)])
    require([[x.decode() for x in flat[at[i]:at[i + 1]]] for i in range(k)]
            == [v.split(" ") for v in sample[:k]],
            "split differs from str.split")
    log(f"split(' ', max_pieces=5): {int(want_off[-1])} pieces, equal to "
        f"the word indices and to str.split on {k} sampled rows")
    out = nbytes(lc.data, child.data, child.chars)
    del res, lc, child, slot_flat
    timed("split", lambda: sf.split(lines, " ", max_pieces=5), out)
    torch.cuda.empty_cache()

    # the string functions, each against a plain oracle over every row
    # and against Python on the sample
    w = widest
    padded = st.pad_strings(lines)
    jdx = torch.arange(w, device=dev)
    lut = torch.arange(256, dtype=torch.uint8, device=dev)
    lut[ord("0"):ord("9") + 1] = torch.arange(
        ord("a"), ord("j") + 1, dtype=torch.uint8, device=dev)

    def rev_block(r0, r1):
        ln = lens[r0:r1, None]
        out = torch.gather(padded.chars[r0:r1], 1,
                           (ln - 1 - jdx).clamp(min=0).to(torch.int64))
        return out.masked_fill_(jdx >= ln, 0)

    def lpad_block(r0, r1):
        out = torch.empty((r1 - r0, 80), dtype=torch.uint8, device=dev)
        npad = 80 - lens[r0:r1]
        shift_block(padded.chars[r0:r1], -npad, torch.full_like(npad, 80),
                    out)
        j = torch.arange(80, device=dev)
        return out.masked_fill_(j < npad[:, None], ord("*"))

    vocab_cap = tuple(" ".join(x[:1].upper() + x[1:].lower()
                               for x in w_.split(" ")) for w_ in bs.LOG_WORDS)
    cap_col, _ = bs.log_lines(ROWS, seed=12, vocab=vocab_cap)
    # instr("status"): 1 + the byte offset of the first status word's slot
    hit, _, slot = _first_word(words, (3, 4))
    slot_start = torch.zeros(ROWS, dtype=torch.int64, device=dev)
    for s in range(1, bs.MAX_WORDS):
        slot_start += torch.where(slot >= s, slot_len[s - 1] + 1, 0)
    fns = {
        "length": (lambda: sf.length(lines), lambda v: len(v),
                   lambda got: torch.equal(got.data, lens)),
        "trim": (lambda: sf.trim(lines), lambda v: v.strip(" "),
                 lambda got: torch.equal(got.data, lens)
                 and torch.equal(got.chars, padded.chars)),
        "lpad_80": (lambda: sf.lpad(lines, 80, "*"),
                    lambda v: ("*" * 80 + v)[-80:],
                    lambda got: bool((got.data == 80).all())
                    and _rows_equal(got, lpad_block)),
        "reverse": (lambda: sf.reverse(lines), lambda v: v[::-1],
                    lambda got: torch.equal(got.data, lens)
                    and _rows_equal(got, rev_block)),
        "instr_status": (lambda: sf.instr(lines, "status"),
                         lambda v: v.find("status") + 1,
                         lambda got: torch.equal(got.data, torch.where(
                             hit, slot_start + 1, 0).to(torch.int32))),
        "translate_digits": (
            lambda: sf.translate(lines, "0123456789", "abcdefghij"),
            lambda v: v.translate(str.maketrans("0123456789",
                                                "abcdefghij")),
            lambda got: torch.equal(got.data, lens)
            and _rows_equal(got, lambda r0, r1: lut[
                padded.chars[r0:r1].to(torch.int64)])),
        "initcap": (lambda: sf.initcap(lines), _py_initcap,
                    lambda got: torch.equal(got.data, lens)
                    and _rows_equal(got, _arrow_block(cap_col, w))),
    }
    for name, (fn, py, oracle) in fns.items():
        got = _no_launch(name, fn)
        require(oracle(got), f"{name} differs from its oracle")
        if got.chars is None:
            vals = got.data[rows].tolist()
        else:
            vals = [b.decode() for b in _sampled_bytes(got, rows_np)]
        require(vals == [py(v) for v in sample],
                f"{name} differs from Python on the sample")
        out = nbytes(got.chars, got.data)
        del got
        timed(name, fn, out)
    fallbacks["string_functions"] = _fallbacks_line("string functions")
    require(not fallbacks["string_functions"],
            "an ASCII string function left the card")
    log("length, trim, lpad(80, '*'), reverse, instr('status'), translate "
        "and initcap over the log lines equal to their oracles over every "
        "row and to Python on the sample")
    del padded, cap_col
    torch.cuda.empty_cache()

    # concat_ws over SF10 lineitem's two STRING flags and the lines
    li_s = tpch.lineitem_table_strings(ROWS, seed=0)
    rf = li_s.column(tpch.L_RETURNFLAG)
    ls = li_s.column(tpch.L_LINESTATUS)
    del li_s
    torch.cuda.empty_cache()
    got = _no_launch("concat_ws",
                     lambda: sf.concat_ws("|", [rf, ls, lines]))
    line_block = _arrow_block(lines, w)

    def ws_block(r0, r1):
        out = torch.zeros((r1 - r0, w + 4), dtype=torch.uint8, device=dev)
        out[:, 0] = rf.chars[r0:r1]
        out[:, 1] = out[:, 3] = ord("|")
        out[:, 2] = ls.chars[r0:r1]
        out[:, 4:] = line_block(r0, r1)
        return out
    require(got.validity is None and torch.equal(got.data, lens + 4)
            and got.chars.shape[1] == w + 4 and _rows_equal(got, ws_block),
            "concat_ws differs from the flags and the lines")
    flags = [(chr(a), chr(b)) for a, b in zip(
        rf.chars[rows].tolist(), ls.chars[rows].tolist())]
    require([b.decode() for b in _sampled_bytes(got, rows_np)]
            == ["|".join((a, b, v)) for (a, b), v in zip(flags, sample)],
            "concat_ws differs from Python on the sample")
    log("concat_ws('|', [l_returnflag, l_linestatus, lines]): equal to the "
        "flags and the lines over every row and to Python on the sample")
    out = nbytes(got.chars, got.data, rf.chars, rf.data, ls.chars, ls.data)
    del got
    timed("concat_ws_flags_lines",
          lambda: sf.concat_ws("|", [rf, ls, lines]), out)
    del rf, ls
    torch.cuda.empty_cache()

    # host routes of the capture functions over a 1,000,000-row head
    head = Column(STRING, lines.data[:ENGINE_SAMPLE + 1], None,
                  chars=lines.chars[:int(lines.data[ENGINE_SAMPLE])])
    for route in HOST_ROUTES:
        times[route[0]] = _host_route(head, route)
    del head, lines, words
    torch.cuda.empty_cache()
    peak = torch.cuda.max_memory_allocated() / 2**30
    require(peak < 40, f"capture and string functions phase peak "
            f"{peak:.2f} GiB")
    log(f"peak device memory of the capture and string functions phase "
        f"{peak:.2f} GiB")
    return {"paths": times, "peak_gib": peak, "fallbacks": fallbacks}


def _rows_equal(got, want_fn) -> bool:
    from spark_rapids_jni_tpu_torch.ops.strings import row_chunks

    n, w = got.chars.shape
    return all(torch.equal(got.chars[r0:r1], want_fn(r0, r1))
               for r0, r1 in row_chunks(n, w))


def _py_initcap(v: str) -> str:
    """Spark's initcap on a host string: a letter after a space (or at
    the start) upper-cased, every other letter lower-cased."""
    return "".join(ch.upper() if i == 0 or v[i - 1] == " " else ch.lower()
                   for i, ch in enumerate(v))


SUPPLIERS = 100_000  # TPC-H SF10 supplier
DEC128_SHIFT = 10**20  # lineitem_groupby_table's DECIMAL128 x 10^20


def _i128(pairs) -> list:
    """Python ints of (n, 2) int64 limb pairs (host)."""
    return [(int(h) << 64) | (int(lo) & (2**64 - 1)) for lo, h in pairs]


def _half_up(a: int, b: int) -> int:
    q, r = divmod(abs(a), b)
    return (-1 if a < 0 else 1) * (q + (1 if 2 * r >= b else 0))


def _check_rollup(res, slots) -> int:
    """The planned rollup's present groups against the numpy oracle:
    every key tuple; counts, integer sums, means, min and max exact;
    the FLOAT64 sums within 1e-12 of the sum of |x| (another order)."""
    import numpy as np

    from spark_rapids_jni_tpu_torch.interop import table_to_numpy

    cols = table_to_numpy(res.table)
    present = res.present.cpu().numpy()
    got = {}
    for g in np.nonzero(present)[0]:
        key = tuple(None if c[3] is not None and not c[3][g] else int(c[2][g])
                    for c in cols[:3])
        got[key] = [(None if c[3] is not None and not c[3][g] else c[2][g])
                    for c in cols[3:]]
    require(set(got) == set(slots), f"rollup groups {len(got)} != "
            f"{len(slots)} of the oracle")
    for key, want in slots.items():
        row = got[key]
        for i, (g, w) in enumerate(zip(row, want)):
            if isinstance(w, tuple):  # (float sum, bound)
                ok = (np.isnan(g) and np.isnan(w[0])) \
                    or abs(float(g) - w[0]) <= w[1]
            elif isinstance(w, float) and np.isnan(w):
                ok = g is not None and np.isnan(g)
            else:
                ok = (g is None and w is None) or (
                    g is not None and w is not None and g == w)
            require(ok, f"rollup group {key} aggregate {i}: {g} != {w}")
    return len(got)


def _rollup_oracle(host) -> dict:
    """{(month code, returnflag, linestatus): aggregates} from the host
    arrays, in the order of ``groupby_phase``'s rollup aggregates."""
    import numpy as np

    qty, qv, price, rf, rfv, ls, lsv, ship, f64, u64 = (
        host[k] for k in ("qty", "qty_valid", "price", "rflag", "rflag_valid",
                          "lstat", "lstat_valid", "ship", "f64", "u64"))
    months = ship.astype("datetime64[D]").astype("datetime64[M]").astype(
        np.int64) + 1970 * 12

    def codes(v, offset):
        # the distinct values and each row's index among them: lookup
        # tables over the small value range, no sort
        present = np.flatnonzero(np.bincount(v + offset))
        lut = np.zeros(present[-1] + 1, np.int64)
        lut[present] = np.arange(len(present))
        return present - offset, lut[v + offset]

    m0 = int(months.min())
    mvals, mi = codes(months - m0, 0)
    mvals = mvals + m0
    rvals, ri = codes(rf.astype(np.int64), 128)
    lvals, si = codes(ls.astype(np.int64), 128)
    ri = np.where(rfv, ri, len(rvals))
    si = np.where(lsv, si, len(lvals))
    nr, ns = len(rvals) + 1, len(lvals) + 1
    gid = ((mi * nr + ri) * ns + si).astype(np.int64)
    k = len(mvals) * nr * ns
    order = np.argsort(gid.astype(np.int16), kind="stable")  # a radix sort
    sg = gid[order]
    starts = np.flatnonzero(np.r_[True, sg[1:] != sg[:-1]])
    ids = sg[starts]
    rows = np.bincount(gid, minlength=k)

    def per_group(vals, valid, lo, hi):
        # (min, max) of each group: one gather in group order
        v = vals[order] if valid is None else np.where(valid, vals, 0)[order]
        out = []
        for op, neutral in ((np.minimum, lo), (np.maximum, hi)):
            w = v if valid is None else np.where(valid[order], v, neutral)
            red = op.reduceat(w, starts)
            full = np.full(k, neutral, dtype=w.dtype)
            full[ids] = red
            out.append(full)
        return out

    qcnt = np.bincount(gid, weights=qv, minlength=k).astype(np.int64)
    qsum = np.bincount(gid, weights=np.where(qv, qty, 0),
                       minlength=k).astype(np.int64)
    psum = np.bincount(gid, weights=price, minlength=k).astype(np.int64)
    fok = ~np.isnan(f64)
    fsum = np.bincount(gid, weights=np.where(fok, f64, 0), minlength=k)
    fabs = np.bincount(gid, weights=np.where(fok, np.abs(f64), 0),
                       minlength=k)
    fnan = np.bincount(gid, weights=~fok, minlength=k) > 0
    i64max, i64min = np.iinfo(np.int64).max, np.iinfo(np.int64).min
    qmin, qmax = per_group(qty, qv, i64max, i64min)
    pmin, pmax = per_group(price, None, i64max, i64min)
    fmin, fmax = per_group(np.where(np.isnan(f64), 0.0, f64), None,
                           np.inf, -np.inf)  # NaN groups: set below
    umin, umax = per_group(u64, None, np.iinfo(np.uint64).max,
                           np.uint64(0))
    aggs = [
        qsum, (qsum / np.maximum(qcnt, 1)) * 0.01, qmin, qmax,
        psum, (psum / np.maximum(rows, 1)) * 0.01, pmin, pmax,
        None,  # the FLOAT64 sum: (value, bound) below
        fmin, fmax, umin, umax, rows,
    ]
    slots = {}
    for g in np.nonzero(rows)[0]:
        m_i, rest = divmod(int(g), nr * ns)
        r_i, s_i = divmod(rest, ns)
        key = (int(mvals[m_i]), None if r_i == len(rvals) else int(rvals[r_i]),
               None if s_i == len(lvals) else int(lvals[s_i]))
        row = []
        for j, a in enumerate(aggs):
            if j == 8:
                row.append((float("nan") if fnan[g] else float(fsum[g]),
                            1e-12 * float(fabs[g])))
            elif j in (9, 10) and fnan[g]:
                row.append(float("nan"))
            elif j < 4 and qcnt[g] == 0:
                row.append(None)
            else:
                row.append(a[g])
        slots[key] = row
    return slots


def groupby_phase(dev) -> tuple:
    """Phase 14: the rest of the general groupby, the planner's general
    lowering and month buckets, the DECIMAL128 reductions and the table
    operations over SF10 lineitem, each result held
    to a numpy or Python-int oracle (the table:
    ``tpch.lineitem_groupby_table``): (a) the planned monthly rollup,
    bounded, through kernel A (one launch, no fallback), with A at its
    shape against its plain version; (b) the general groupby by
    l_suppkey (100,000 groups: var/std/var_pop/std_pop, covar_samp and
    corr, nunique, first/last both ways, DECIMAL128 sum/mean/min/max/var,
    percentile), ``plan_groupby_auto`` from a budget of 4,096, and the
    groupby by l_orderkey (15,000,000 groups); (c) the DECIMAL128
    reductions; (d) concatenate, apply_boolean_mask (q6's predicate),
    distinct, contiguous_split, intersect_rows and except_rows. Host
    times (median of 3) beside byte bounds, launches and peak memory."""
    import numpy as np

    from spark_rapids_jni_tpu_torch.columnar import Column, Table
    from spark_rapids_jni_tpu_torch.models import tpch
    from spark_rapids_jni_tpu_torch.ops import reduce, table_ops
    from spark_rapids_jni_tpu_torch.ops.groupby import (
        groupby_aggregate,
        groupby_percentile,
    )
    from spark_rapids_jni_tpu_torch.ops.planner import (
        bounded_accumulate_inputs,
        month_bucket,
        month_domain,
        plan_groupby,
        plan_groupby_auto,
        scalar_domain,
    )

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tab, neg = tpch.lineitem_groupby_table(ROWS, Q3_ORDERS, SUPPLIERS)
    torch.cuda.synchronize()
    log(f"phase 14 table: {tab.num_rows} rows, {tab.num_columns} columns in "
        f"{time.perf_counter() - t0:.1f} s (host numpy {np.__version__})")
    QTY, PRICE, RFLAG, LSTAT, SHIP = 0, 1, 4, 5, 6
    OKEY, SKEY, F64, U64, D128 = 7, 8, 9, 10, 11
    times, launches = {}, {}

    def host(i):
        return tab.column(i).data.cpu().numpy()

    def hvalid(i):
        return tab.column(i).valid_mask().cpu().numpy()

    # ---- (a) the planned monthly rollup -------------------------------
    work = Table([month_bucket(tab.column(SHIP)), tab.column(RFLAG),
                  tab.column(LSTAT), tab.column(QTY), tab.column(PRICE),
                  tab.column(F64), tab.column(U64)])
    aggs = [(3, "sum"), (3, "mean"), (3, "min"), (3, "max"),
            (4, "sum"), (4, "mean"), (4, "min"), (4, "max"),
            (5, "sum"), (5, "min"), (5, "max"), (6, "min"), (6, "max"),
            (4, "count")]
    domains = [month_domain(1992, 12, 1999, 12),
               scalar_domain(np.frombuffer(b"ANR", np.int8).tolist()),
               scalar_domain(np.frombuffer(b"FO", np.int8).tolist())]
    a_row = _accumulate_row(
        *bounded_accumulate_inputs(work, [0, 1, 2], aggs, domains), dev,
        "the monthly rollup")
    res, launches["monthly_rollup"] = _run_plan(
        "monthly rollup", lambda: plan_groupby(work, [0, 1, 2], aggs, domains),
        {"A": a_row["launches"]})
    require(res.lowered == "bounded" and not bool(res.domain_miss),
            "the monthly rollup did not take the bounded plan cleanly")
    t1 = time.perf_counter()
    hostcols = dict(qty=host(QTY), qty_valid=hvalid(QTY), price=host(PRICE),
                    rflag=host(RFLAG), rflag_valid=hvalid(RFLAG),
                    lstat=host(LSTAT), lstat_valid=hvalid(LSTAT),
                    ship=host(SHIP), f64=host(F64), u64=host(U64))
    slots = _rollup_oracle(hostcols)
    groups = _check_rollup(res, slots)
    log(f"monthly rollup: m = {res.table.num_rows} slots, {groups} present "
        f"groups equal to the numpy oracle ({time.perf_counter() - t1:.1f} s "
        f"on the host); kernel A launched {launches['monthly_rollup']['A']}"
        f" time(s), no fallback")
    del hostcols, slots, res
    times["monthly_rollup"] = _timed(
        "plan_groupby(monthly rollup)",
        lambda: plan_groupby(work, [0, 1, 2], aggs, domains),
        distinct_bytes([c.data for c in work.columns]
                       + [c.validity for c in work.columns]), ROWS)
    del work

    # ---- (b) the general groupby by l_suppkey --------------------------
    gtab = Table([tab.column(SKEY), tab.column(QTY), tab.column(PRICE),
                  tab.column(OKEY), tab.column(D128)])
    gaggs = ([(1, op) for op in ("var", "std", "var_pop", "std_pop")]
             + [(1, ("covar_samp", 2)), (1, ("corr", 2)), (3, "nunique")]
             + [(1, op) for op in ("first", "last", "first_include_nulls",
                                   "last_include_nulls")]
             + [(4, op) for op in ("sum", "mean", "min", "max", "var")])
    g = _no_launch("general groupby", lambda: groupby_aggregate(
        gtab, [0], gaggs, max_groups=SUPPLIERS))
    t1 = time.perf_counter()
    _check_supplier_groups(g, gtab, gaggs)
    log(f"groupby by l_suppkey: {int(g.num_groups)} groups, "
        f"{len(gaggs)} aggregates equal to the numpy / Python-int oracle "
        f"({time.perf_counter() - t1:.1f} s on the host)")
    del g
    gbytes = distinct_bytes([c.data for c in gtab.columns]
                            + [c.validity for c in gtab.columns])
    times["groupby_suppkey"] = _timed(
        "groupby_aggregate(l_suppkey, 16 aggregates)",
        lambda: groupby_aggregate(gtab, [0], gaggs, max_groups=SUPPLIERS),
        gbytes, ROWS)
    qs = [0.25, 0.5, 0.9]
    pct = _no_launch("percentile", lambda: groupby_percentile(
        gtab, [0], 1, qs, max_groups=SUPPLIERS))
    _check_percentiles(pct, gtab, qs)
    times["percentile"] = _timed(
        "groupby_percentile(l_quantity by l_suppkey)",
        lambda: groupby_percentile(gtab, [0], 1, qs, max_groups=SUPPLIERS),
        gbytes, ROWS)
    del pct
    auto = _no_launch("plan_groupby_auto", lambda: plan_groupby_auto(
        gtab, [0], [(1, "sum"), (1, "count")], [None], budget=4096))
    _check_auto(auto, gtab)
    times["plan_groupby_auto"] = _timed(
        "plan_groupby_auto(l_suppkey, from 4,096)",
        lambda: plan_groupby_auto(gtab, [0], [(1, "sum"), (1, "count")],
                                  [None], budget=4096), gbytes, ROWS)
    del auto
    otab = Table([tab.column(OKEY), tab.column(PRICE)])
    og = _no_launch("groupby by l_orderkey", lambda: groupby_aggregate(
        otab, [0], [(1, "sum"), (1, "count")], max_groups=Q3_ORDERS))
    okeys = host(OKEY)
    want_sum = np.bincount(okeys, weights=host(PRICE)).astype(np.int64)
    want_cnt = np.bincount(okeys)
    live = np.nonzero(want_cnt)[0]
    k = int(og.num_groups)
    require(k == len(live) and not bool(og.overflowed),
            f"groupby by l_orderkey: {k} groups, oracle {len(live)}")
    require(np.array_equal(og.table.column(0).data[:k].cpu().numpy(), live)
            and np.array_equal(og.table.column(1).data[:k].cpu().numpy(),
                               want_sum[live])
            and np.array_equal(og.table.column(2).data[:k].cpu().numpy(),
                               want_cnt[live]),
            "groupby by l_orderkey differs from np.bincount")
    log(f"groupby by l_orderkey: {k} groups equal to np.bincount")
    del og, okeys, want_sum, want_cnt, live
    times["groupby_orderkey"] = _timed(
        "groupby_aggregate(l_orderkey, sum + count)",
        lambda: groupby_aggregate(otab, [0], [(1, "sum"), (1, "count")],
                                  max_groups=Q3_ORDERS),
        distinct_bytes([c.data for c in otab.columns]), ROWS)
    del otab

    # ---- (c) the DECIMAL128 reductions ---------------------------------
    d = tab.column(D128)
    signed = np.where(neg.cpu().numpy(), -host(PRICE), host(PRICE))
    total = int(signed.sum()) * DEC128_SHIFT
    want = {"sum_": total, "min_": int(signed.min()) * DEC128_SHIFT,
            "max_": int(signed.max()) * DEC128_SHIFT,
            "mean": _half_up(total * 10_000, ROWS)}
    for fn in ("sum_", "mean", "min_", "max_"):
        val, ok = _no_launch(fn, lambda: getattr(reduce, fn)(d))
        limbs = val.data if hasattr(val, "data") else val
        got = _i128(limbs.reshape(-1, 2).cpu().numpy())[0]
        require(bool(ok) and got == want[fn],
                f"DECIMAL128 {fn}: {got} != {want[fn]}")
        times[f"decimal128_{fn}"] = _timed(
            f"reduce.{fn}(DECIMAL128)", lambda: getattr(reduce, fn)(d),
            d.data.nbytes, ROWS)
    log(f"DECIMAL128 sum_/mean/min_/max_ equal to the Python-int oracle "
        f"(sum {total})")
    del d, signed

    # ---- (d) the table operations -------------------------------------
    li = Table(tab.columns[:7])
    half = ROWS // 2
    parts = table_ops.contiguous_split(li, [half])
    cat = _no_launch("concatenate", lambda: table_ops.concatenate(parts))
    require(all(a.equals(b) for a, b in zip(cat.columns, li.columns)),
            "concatenate of the two halves != the whole")
    del cat
    times["concatenate"] = _timed(
        "concatenate(two halves)", lambda: table_ops.concatenate(parts),
        2 * distinct_bytes([c.data for c in li.columns]
                           + [c.validity for c in li.columns]), ROWS)
    del parts
    sel = tpch._q6_host_selection(li)
    mask = torch.from_numpy(sel).to(dev)
    cm = _no_launch("apply_boolean_mask", lambda: table_ops.apply_boolean_mask(
        li, mask))
    k = int(cm.num_rows)
    require(k == int(sel.sum()) and np.array_equal(
        cm.table.column(PRICE).data[:k].cpu().numpy(), host(PRICE)[sel])
        and not bool(cm.table.column(PRICE).validity[k:].any()),
        "apply_boolean_mask(q6) differs from the numpy selection")
    log(f"apply_boolean_mask(q6's predicate): {k} rows, equal to the numpy "
        f"selection, null tail")
    del cm
    times["apply_boolean_mask"] = _timed(
        "apply_boolean_mask(q6)", lambda: table_ops.apply_boolean_mask(
            li, mask), 2 * distinct_bytes([c.data for c in li.columns]
                                          + [c.validity for c in li.columns]),
        ROWS)
    flags = Table([li.column(RFLAG), li.column(LSTAT)])
    dres = _no_launch("distinct", lambda: table_ops.distinct(flags))
    rv, lv = hvalid(RFLAG), hvalid(LSTAT)
    # one code a tuple: each flag + 129 (0 for null) in 9 bits
    codes = np.unique(np.where(rv, host(RFLAG).astype(np.int64) + 129, 0)
                      * 512 + np.where(lv, host(LSTAT).astype(np.int64)
                                       + 129, 0))
    want = {tuple(None if v == 0 else int(v) - 129
                  for v in divmod(int(c), 512)) for c in codes}
    out = dres.compact()
    got = list(zip(out.column(0).to_pylist(), out.column(1).to_pylist()))
    require(len(got) == len(want) and set(got) == want,
            f"distinct flags {got} != {sorted(want, key=str)}")
    log(f"distinct(returnflag, linestatus): {len(got)} tuples with nulls, "
        f"equal to the host set")
    del dres, out
    times["distinct"] = _timed(
        "distinct(flags)", lambda: table_ops.distinct(flags),
        distinct_bytes([c.data for c in flags.columns]
                       + [c.validity for c in flags.columns]), ROWS)
    cuts = sorted(np.random.default_rng(14).choice(ROWS, 10, replace=False))
    pieces = _no_launch("contiguous_split", lambda: table_ops.contiguous_split(
        li, cuts))
    bounds = [0] + [int(c) for c in cuts] + [ROWS]
    require(len(pieces) == 11 and all(
        p.num_rows == hi - lo and torch.equal(p.column(PRICE).data,
                                              li.column(PRICE).data[lo:hi])
        for p, lo, hi in zip(pieces, bounds, bounds[1:])),
        "contiguous_split pieces differ from the parent's slices")
    del pieces
    times["contiguous_split"] = _timed(
        "contiguous_split(10 points)",
        lambda: table_ops.contiguous_split(li, cuts), 0, ROWS)
    okey = tab.column(OKEY)
    # overlapping thirds: rows [0, n/3) and [n/4, 2n/3)
    a, b, c = ROWS // 3, ROWS // 4, 2 * ROWS // 3
    left = Table([Column(okey.dtype, okey.data[:a])])
    right = Table([Column(okey.dtype, okey.data[b:c])])
    okeys = host(OKEY)

    def distinct_sorted(v):  # l_orderkey < 2^24: two radix passes
        v = v[_radix_order(v, 32)]
        return v[np.r_[True, v[1:] != v[:-1]]]

    lo_h, ro_h = distinct_sorted(okeys[:a]), distinct_sorted(okeys[b:c])
    del okeys
    hit = ro_h[np.minimum(np.searchsorted(ro_h, lo_h), len(ro_h) - 1)] == lo_h
    oracle = {"intersect_rows": lo_h[hit], "except_rows": lo_h[~hit]}
    for name, want_vals in oracle.items():
        r = _no_launch(name, lambda: getattr(table_ops, name)(left, right))
        k = int(r.num_rows)
        vals = r.table.column(0).data[:k].cpu().numpy()
        require(k == len(want_vals) and np.array_equal(vals, want_vals),
                f"{name}: {k} rows, numpy {len(want_vals)}")
        log(f"{name}(l_orderkey[0:{a}], l_orderkey[{b}:{c}]): {k} rows, "
            f"equal to numpy")
        times[name] = _timed(
            f"{name}(l_orderkey slices)",
            lambda: getattr(table_ops, name)(left, right),
            left.column(0).data.nbytes + right.column(0).data.nbytes,
            a + c - b)
        del r
    del left, right, li, flags, okey, tab, gtab
    torch.cuda.empty_cache()
    peak = torch.cuda.max_memory_allocated() / 2**30
    require(peak < 40, f"phase 14 peak {peak:.2f} GiB")
    log(f"peak device memory of phase 14 {peak:.2f} GiB")
    return a_row, launches, {"paths": times, "peak_gib": peak}


class _Laps:
    """Host seconds of an oracle's steps, logged in one line."""

    def __init__(self, what: str):
        self.what, self.t0, self.steps = what, time.perf_counter(), []

    def __call__(self, step: str) -> None:
        t = time.perf_counter()
        self.steps.append(f"{step} {t - self.t0:.1f} s")
        self.t0 = t
        log(f"{self.what}: " + ", ".join(self.steps))


def _radix_order(key, bits: int):
    """The stable permutation sorting non-negative int64 ``key`` (below
    2^bits): numpy's stable sort of 16-bit digits is a radix sort, so
    least significant digit first it is O(n) a pass (its stable sort of
    int64 is a merge sort, several times slower at 60M rows)."""
    import numpy as np

    order = None
    for shift in range(0, bits, 16):
        digit = (key if order is None else key[order]) >> shift
        step = np.argsort((digit & 0xFFFF).astype(np.uint16), kind="stable")
        order = step if order is None else order[step]
    return order


def _supplier_groups(gtab):
    """Host arrays of the groupby-by-l_suppkey table: the keys, the
    present suppliers in order and each row's group index (a lookup
    table over the supplier ids: no sort)."""
    import numpy as np

    skey = gtab.column(0).data.cpu().numpy()
    keys = np.flatnonzero(np.bincount(skey))
    remap = np.zeros(int(skey.max()) + 1, np.int64)
    remap[keys] = np.arange(len(keys))
    return skey, keys, remap[skey]


def _first_last(order, gidx, pick, k):
    """Each group's first and last row among the rows where ``pick``
    (-1 where none), from ``order``, the rows stably sorted by group."""
    import numpy as np

    rows = order[pick[order]]
    cnt = np.bincount(gidx[rows], minlength=k)
    end = np.cumsum(cnt)
    first = np.where(cnt > 0, rows[np.minimum(end - cnt, len(rows) - 1)], -1)
    last = np.where(cnt > 0, rows[np.maximum(end - 1, 0)], -1)
    return first, last


def _check_supplier_groups(g, gtab, gaggs) -> None:
    """The groupby by l_suppkey against numpy / Python-int oracles: the
    keys, var/std/var_pop/std_pop of l_quantity and covar_samp/corr with
    l_extendedprice (exact integer numerators, float64 at the end;
    relative 1e-9 against the port's float64 two-pass), nunique of
    l_orderkey, first/last both ways (exact), and the DECIMAL128 sum,
    mean, min and max (exact) and var (relative 1e-12)."""
    import numpy as np

    laps = _Laps("supplier oracle")
    skey, keys, gidx = _supplier_groups(gtab)
    k = int(g.num_groups)
    require(k == len(keys) and not bool(g.overflowed),
            f"groupby by l_suppkey: {k} groups, oracle {len(keys)}")
    out = list(g.table.columns)
    require(np.array_equal(out[0].data[:k].cpu().numpy(), keys),
            "supplier keys differ")
    qty = gtab.column(1).data.cpu().numpy()
    qv = gtab.column(1).valid_mask().cpu().numpy()
    price = gtab.column(2).data.cpu().numpy()
    okey = gtab.column(3).data.cpu().numpy()
    neg = gtab.column(4).data[:, 1].cpu().numpy() < 0

    def seg(v):
        # float64 bincount sums: exact while every partial sum < 2^53
        return np.bincount(gidx, weights=v, minlength=k)

    x = np.where(qv, qty, 0)
    n = seg(qv).astype(np.int64)
    sx = seg(x).astype(np.int64)                   # < 600 * 5100
    sxx = seg(x * x).astype(np.int64)              # < 600 * 2.6e7
    px = np.where(qv, price, 0)
    sy = seg(px).astype(np.int64)                  # < 600 * 1.05e7
    sxy = seg(x * px).astype(np.int64)             # < 600 * 5.4e10
    syy = seg(px.astype(np.float64) ** 2)          # float64, for corr
    num_x = (n * sxx - sx * sx).astype(np.float64)  # exact in int64
    laps("host copies and sums")

    def col(i):
        c = out[1 + i]
        return c.data[:k].cpu().numpy(), c.valid_mask()[:k].cpu().numpy()

    def close(i, want, valid, what, rel=1e-9):
        got, gv = col(i)
        require(np.array_equal(gv, valid), f"{what}: validity")
        require(np.allclose(got[valid], want[valid], rtol=rel, atol=0,
                            equal_nan=True), f"{what}: values")

    nn = n.astype(np.float64)
    close(0, num_x / np.maximum(n * (n - 1), 1) * 1e-4, n > 1, "var")
    close(1, np.sqrt(num_x / np.maximum(n * (n - 1), 1) * 1e-4), n > 1, "std")
    close(2, num_x / np.maximum(n * n, 1) * 1e-4, n > 0, "var_pop")
    close(3, np.sqrt(num_x / np.maximum(n * n, 1) * 1e-4), n > 0, "std_pop")
    num_xy = (n * sxy - sx * sy).astype(np.float64)
    close(4, num_xy / np.maximum(n * (n - 1), 1) * 1e-4, n > 1, "covar_samp")
    close(5, num_xy / np.sqrt(num_x * (nn * syy - sy.astype(np.float64) ** 2)),
          n > 0, "corr", rel=1e-6)
    pair = gidx << 24 | okey  # l_orderkey < 2^24
    pair = pair[_radix_order(pair, 48)]
    new = np.r_[True, pair[1:] != pair[:-1]]
    nun = np.bincount(pair[new] >> 24, minlength=k)
    got, _ = col(6)
    require(np.array_equal(got, nun), "nunique(l_orderkey) differs")
    laps("moments and nunique")
    # first / last, skipping nulls and not: the input order within a group
    order = _radix_order(gidx, 32)
    fv, lv = _first_last(order, gidx, qv, k)
    fa, la = _first_last(order, gidx, np.ones_like(qv), k)
    for i, pos in enumerate((fv, lv, fa, la)):
        got, gv = col(7 + i)
        valid = (pos >= 0) & qv[np.maximum(pos, 0)]
        require(np.array_equal(gv, valid)
                and np.array_equal(got[valid], qty[pos[valid]]),
                f"{gaggs[7 + i][1]} differs")
    laps("first/last")
    # DECIMAL128: the exact sums from the signed prices; min/max over the
    # rows in group order
    signed = np.where(neg, -price, price)
    s = seg(signed).astype(np.int64)               # |sum| < 600 * 1.05e7
    cnt = np.bincount(gidx, minlength=k)
    starts = np.r_[0, np.cumsum(cnt)[:-1]]
    in_order = signed[order]
    mn = np.minimum.reduceat(in_order, starts)
    mx = np.maximum.reduceat(in_order, starts)
    got = [_i128(col(11 + i)[0]) for i in range(4)]
    want = [[int(v) * DEC128_SHIFT for v in s],
            [_half_up(int(v) * DEC128_SHIFT * 10_000, int(c))
             for v, c in zip(s, cnt)],
            [int(v) * DEC128_SHIFT for v in mn],
            [int(v) * DEC128_SHIFT for v in mx]]
    for name, a, b in zip(("sum", "mean", "min", "max"), got, want):
        require(a == b, f"DECIMAL128 {name} differs from the Python ints")
    # var: (c * sum(U^2) - sum(U)^2) / (c (c - 1)) with U = signed * 10^20
    # at scale -22; sum(U^2) in float64 (within 1e-15)
    s2 = seg(signed.astype(np.float64) ** 2)
    c = cnt.astype(np.float64)
    want_var = (c * s2 - s.astype(np.float64) ** 2) * 1e40 \
        / np.maximum(c * (c - 1), 1) * 1e-44
    gvar, gok = col(15)
    require(np.array_equal(gok, cnt > 1) and np.allclose(
        gvar[cnt > 1], want_var[cnt > 1], rtol=1e-12, atol=0),
        "DECIMAL128 var differs")
    laps("DECIMAL128")


def _check_percentiles(pct, gtab, qs) -> None:
    """groupby_percentile against each supplier's sorted valid values:
    linear interpolation between closest ranks, exact."""
    import numpy as np

    skey, keys, gidx = _supplier_groups(gtab)
    k = int(pct.num_groups)
    qty = gtab.column(1).data.cpu().numpy()
    qv = gtab.column(1).valid_mask().cpu().numpy()
    # rows sorted by (supplier, valid quantity), nulls past each group's
    # valid run: one sort of packed words
    word = (gidx << 14) | np.where(qv, qty, (1 << 14) - 1)
    srt = word[_radix_order(word, 32)]
    vals = (srt & ((1 << 14) - 1)).astype(np.float64) * 0.01
    lo = np.r_[0, np.cumsum(np.bincount(gidx, minlength=k))[:-1]]
    cnt = np.bincount(gidx, weights=qv, minlength=k).astype(np.int64)
    for i, q in enumerate(qs):
        p = q * (cnt - 1).astype(np.float64)
        lo_off = np.floor(p).astype(np.int64)
        frac = p - lo_off
        v0 = vals[np.clip(lo + lo_off, 0, len(vals) - 1)]
        v1 = vals[np.clip(lo + np.minimum(lo_off + 1, cnt - 1), 0,
                          len(vals) - 1)]
        want = v0 * (1.0 - frac) + v1 * frac
        c = pct.table.column(1 + i)
        got = c.data[:k].cpu().numpy()
        gv = c.valid_mask()[:k].cpu().numpy()
        require(np.array_equal(gv, cnt > 0)
                and np.array_equal(got[cnt > 0], want[cnt > 0]),
                f"percentile {q} differs from numpy")
    log(f"groupby_percentile({qs}) of l_quantity by l_suppkey: {k} groups "
        f"equal to numpy")


def _check_auto(auto, gtab) -> None:
    """plan_groupby_auto from 4,096: the general plan, grown to fit all
    suppliers (at SF10 the budget doubles to 131,072), no overflow, and
    sums and counts equal to np.bincount."""
    import numpy as np

    skey = gtab.column(0).data.cpu().numpy()
    qty = gtab.column(1).data.cpu().numpy()
    qv = gtab.column(1).valid_mask().cpu().numpy()
    live = np.unique(skey)
    k = int(auto.present.sum())
    budget = 4096
    while budget < len(live):
        budget *= 2
    require(auto.lowered == "general" and not bool(auto.overflowed)
            and k == len(live) and auto.table.num_rows == min(budget, ROWS),
            f"plan_groupby_auto: {auto.lowered}, {k} groups, "
            f"{auto.table.num_rows} rows")
    t = auto.table
    want_sum = np.bincount(skey, weights=np.where(qv, qty, 0)).astype(
        np.int64)[live]
    want_cnt = np.bincount(skey, weights=qv).astype(np.int64)[live]
    require(np.array_equal(t.column(0).data[:k].cpu().numpy(), live)
            and np.array_equal(t.column(1).data[:k].cpu().numpy(), want_sum)
            and np.array_equal(t.column(2).data[:k].cpu().numpy(), want_cnt),
            "plan_groupby_auto differs from np.bincount")
    log(f"plan_groupby_auto(l_suppkey) from 4,096: grew to "
        f"{auto.table.num_rows}, {k} groups equal to np.bincount")



def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from spark_rapids_jni_tpu_torch.models import tpch
    from spark_rapids_jni_tpu_torch.ops.kernels import _build
    from spark_rapids_jni_tpu_torch.utils.platform import card_line

    card = card_line()
    log(f"card: {card}; torch {torch.__version__} (CUDA {torch.version.cuda})")
    t0 = time.perf_counter()
    _build.library()
    log(f"kernels built in {time.perf_counter() - t0:.1f} s "
        f"(nvcc {_build.build_seconds})")
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "kernels_build.log").write_text(
        (_build.BUILD_DIR / "build.log").read_text())

    t0 = time.perf_counter()
    li = tpch.lineitem_table(ROWS, seed=0)
    dev = li.columns[0].device
    torch.cuda.synchronize()
    log(f"lineitem: {ROWS} rows on {dev} in {time.perf_counter() - t0:.1f} s")

    torch.cuda.reset_peak_memory_stats()
    kernel_rows = kernel_phases(li, dev)
    launches, path_times, q1_oracle = path_phases(li)
    q1_times, q1_general = general_q1_phase(li)
    path_times.update(q1_times)
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"peak device memory of the q1 and row phases {peak:.2f} GiB")
    del li
    torch.cuda.empty_cache()

    q3 = q3_tables()
    kernel_rows["D"], probe_rows = probe_phase(*q3, dev)
    path_times["probe_joins"] = probe_rows
    q3_launches, q3_numbers = q3_path_phase(*q3)
    path_times.update(q3_numbers)
    del q3
    torch.cuda.empty_cache()

    ds = tpcds_tables()
    path_times["tpcds_probe_joins"] = tpcds_probe_phase(ds)
    ds_launches, path_times["tpcds"] = tpcds_path_phase(ds)
    del ds
    torch.cuda.empty_cache()

    a_rows, d_rows, st_launches, path_times["strings"] = strings_phase(dev)
    path_times["strings"].update(accumulate_at=a_rows, probe_joins=d_rows)
    path_times["cast_strings"] = cast_phase(dev)
    d_rows, more_launches, path_times["tpch_more"] = more_plans_phase()
    path_times["tpch_more"].update(probe_joins=d_rows)
    # each path of the last phase launches none of A-D (_no_launch)
    li = tpch.lineitem_table(ROWS, seed=0)
    li12 = tpch.lineitem_q12_table(ROWS, Q3_ORDERS)
    path_times["hash"] = hash_phase(li, li12, dev)
    path_times["datetime"] = datetime_phase(li, li12, dev)
    del li, li12
    torch.cuda.empty_cache()
    path_times["bloom"] = bloom_phase()
    path_times["string_q1_q13"] = string_q1_q13_phase(q1_oracle, q1_general)
    path_times["string_engines"] = string_engines_phase(dev)
    path_times["capture_and_string_functions"] = capture_phase(dev)
    a_rollup, gb_launches, path_times["groupby_and_table_ops"] = \
        groupby_phase(dev)
    path_times["groupby_and_table_ops"]["accumulate_at"] = {
        "monthly rollup": a_rollup}
    # each kernel's launches on every path that runs it, each read just
    # after its run
    by_plan = {**q3_launches, **ds_launches, **st_launches, **more_launches,
               **gb_launches}
    kernel_rows["A"]["launches_by_path"] = {
        "tpch_q1_planned": launches[kernel_rows["A"]["name"]],
        **{p: n["A"] for p, n in by_plan.items() if n["A"]}}
    kernel_rows["D"]["launches_by_path"] = {
        p: n["D"] for p, n in by_plan.items() if n["D"]}
    for k in ("A", "D"):
        launches[kernel_rows[k]["name"]] = sum(
            kernel_rows[k]["launches_by_path"].values())

    report = {"kernels": []}
    for row in kernel_rows.values():
        report["kernels"].append(
            {**row, "launches": launches[row["name"]]})
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(
        {**report, "card": card, "rows": ROWS, **path_times,
         "peak_gib": peak, "torch": torch.__version__}, indent=1))
    print(json.dumps(report))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
