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
   through the native host engine, recorded and equal to Python
   ``json``; each path's host time
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
   over a quarter of SF10 lineitem (14,996,513 rows with q5's l_orderkey and
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
15. the readers, after the native library (``src/native``, built into
   ``build/torch_native/`` beside nvcc's kernel build): a quarter of
   SF10 lineitem (``READER_ROWS``, 14,996,513 rows) written as Parquet
   by ``chip_smoke_writers.py`` (bench.py's
   parquet_q1 layout: four unscaled INT64 money columns, the flags as
   INT32/INT_8 and l_shipdate as INT32/DATE with dictionaries;
   1,048,576-row row groups, 1 MiB snappy pages), ``read_table`` of it
   to the card (median of 3, split into native decode, copy-out into
   pinned memory and staging, the staging rate beside a plain pinned
   ``copy_`` of as many bytes) equal to the generator column by column,
   planned q1 (kernel A launched exactly once) and fused q1 (kernel B
   once) over it equal to the in-memory plans, parquet_q1 rows/s (read
   and planned q1) with the card's busy share from ``torch.profiler``;
   ``ParquetChunkedReader`` at 256 MiB (its plan equal to the
   reference's rule, the concatenated chunks equal to ``read_table``)
   serially and as ``chunk_sources(stage="host")`` decoded on 8
   threads; the footer pruned to 3 columns and filtered to half the row
   groups, and its serialized file re-parsed; TPC-DS q72 over
   catalog_sales (14,401,261 rows) written the same way and read in
   chunks, equal to the in-memory q72 with kernel D launched exactly 3
   times and nothing else; 6,000,000 lineitem rows as ORC through
   ``read_table`` and ``OrcChunkedReader``, equal to the generator; and
   ``get_json_object`` over 1,000,000 escaped and malformed documents
   through the native host engine, recorded and equal to Python
   ``json``; the files are deleted at the end of the phase;
16. the plan executor and the C ABI bridge: planned q1 (kernel A once),
   q6 (no launch) over SF10 lineitem and TPC-DS q72 over its SF10
   tables (kernel D three times) through ``fusion.execute``, each equal
   to the same nodes called by hand and timed against them interleaved
   (medians of 9 each, their difference); SF10 lineitem (two columns
   with every 7th row null) from its host bytes through the port's
   ``libtpudf_rt.so`` loaded with ctypes in this process:
   ``column_from_host``, ``convert_to_rows`` (2 batches, kernel C
   once), ``rows_to_host`` equal byte for byte to the direct
   ``convert_to_rows``, ``rows_from_host``, ``convert_from_rows`` and
   ``column_to_host`` equal to the input bytes and validity, each step's
   seconds and GB/s beside a plain pinned ``copy_`` of as many bytes,
   and the process's peak host memory; then the embedded-interpreter
   self test (a C program that owns ``Py_Initialize``) on the card
   where the interpreter has a shared libpython;
17. the remaining operators over an eighth of SF10 lineitem (7,498,256
   rows of ``tpch.lineitem_groupby_table``: the q1 columns with seeded nulls,
   q5's l_orderkey and l_suppkey, a FLOAT64 price with NaN rows, a
   DECIMAL128 column) and bench.py's log lines, none of which launches
   a kernel of A-D (the counts read after each part), each against a
   numpy oracle over every row: coalesce, nullif, greatest/least, abs,
   ceil/floor (+-inf and +-1e30 planted, saturating), round and
   pmod(l_orderkey, 200); the window PARTITION BY l_suppkey ORDER BY
   l_shipdate (100,000 partitions: the rank family, lag/lead, the
   running sum, ROWS 6 PRECEDING sum/mean/min/max, RANGE 30 PRECEDING
   sum and max, the DECIMAL128 rolling sum, the FLOAT64 rolling
   variance, first/last/nth value; the float functions bit-equal to the
   CPU's over 1,000,000 rows) and PARTITION BY l_orderkey (15,000,000
   partitions: row_number, running sum); collect_list of l_suppkey by
   l_orderkey and collect_set of l_shipdate by l_suppkey, the array
   functions over them, explode (inner, outer, position), the padded
   layout and back, ``sequence(1, row_number)``, ``split`` + posexplode
   of the log lines; a STRUCT of four amounts (every 13th null):
   struct_field, unpack_struct and the groupby over its fields,
   concatenate and contiguous_split, and a Parquet file of l_orderkey
   and the STRUCT (definition levels 0/1/2) read back, decode and
   assembly timed; each part's seconds and the phase's device peak;
18. memory and out-of-core at SF10: SF10 lineitem (59,986,052 rows)
   written as Parquet in phase 15's layout (about 58 row groups, 2.03
   GB) and ``tpch_q1_outofcore`` over it under a 1 GiB device budget in
   256 MiB chunks: serially, pipelined on 2 and on 8 decode threads,
   with a flipped checkpoint (replayed) and a transient decode fault
   (resumed), each equal to the in-memory general q1 and the numpy
   oracle, none launching A-D, each with its seconds and rows/s on the
   host clock, the pipeline's counters and the limiter's peak (within
   the budget, nothing left reserved), and the card's busy share from a
   profiled run just before the 8-thread one; q3's SF10 lineitem written the
   same way and ``tpch_q3_outofcore`` with customer and orders resident
   and the partials under a 16 MiB spill budget, once on the pinned host
   tier, once through the codec (and zstd where installed), once on a
   disk tier in a directory deleted after, each equal to ``tpch_q3`` in
   memory and its numpy oracle, with spills; one spill's drop of
   ``torch.cuda.memory_allocated``; and the degradation ladder over
   planned q1 in memory: the fused tier (kernel A once), then a real
   ``torch.OutOfMemoryError`` at the ``fusion.region`` seam classified
   ``ResourceExhausted`` and stepped to the out-of-core tier (8 chunks,
   no launch), with the same rows; the phase's seconds and device peak;
   and ``tpch_q3_outofcore`` twice more with the runtime filter on
   (``rtfilter.max_build_rows`` raised to 2,097,152): decided
   ``no_history_optimistic`` then ``selective``, each chunk pruned
   before staging, the rows in and pruned and the limiter's peak beside
   the unpruned run's, the same result and no launch;
19. serving at SF10 (lineitem and q3's tables resident): one
   ``QueryServer`` (two queries in flight, a 16 GiB logical budget, the
   runtime filter on, telemetry to a JSONL file) serving three sessions
   at once: "dashboard" planned q1, q6 and planned q1 again (a result
   cache hit, no wait), "analyst" q3 (the filter applied at join 1) and
   planned q3, "etl" general q1 and two plans sharing a Filter +
   Project prefix (the second a subplan hit); every result equal to
   ``fusion.execute`` of its plan and to its numpy oracle, kernel A
   launched once and D twice over the traffic, every span tree valid,
   per-session latency and queue wait; then on a second server with one
   worker an estimate over the budget rejected, a deadline expiring
   behind a blocked worker cancelled, and a real out-of-memory error at
   ``fusion.region`` stepped down the ladder to the out-of-core tier
   with the same rows; each server's ``limiter.used`` 0 after
   ``close()``; a third server warmed up from the first's learned
   estimates (``warmup(top_n=1)`` replays one plan);
20. multiple executors: four executors of one mesh spread round-robin
   over the visible cards (all four on ``cuda:0`` on a one-card
   machine); the eight distributed plans at SF10 (``tpch_q1``, ``q3``,
   planned ``q3``, ``q5``, ``q12``; TPC-DS ``q72``, planned ``q72`` and
   ``q64`` ``_distributed``) each equal to its single-device plan on
   the card, A and D launched exactly as counted (A 4 for q5; D 8, 4,
   12, 4 for q3, q12, q72, q64; none for the rest), each with its
   seconds beside the single-device plan's (medians of 3), its
   shuffle's wire bytes and its device peak; a one-rank NCCL world
   running distributed q1 through the process-group transport, equal
   to the local mesh's; over a quarter of SF10 lineitem (14,996,513
   rows) ``hash_shuffle`` alone (every executor gets exactly its
   partition's rows; bytes and seconds beside a device ``copy_``) and
   the distributed groupby (by l_suppkey), bounded groupby (A once an
   executor), percentile, window, collect_set, join (D once an
   executor) and sort, each equal to its single-device counterpart;
   an overflowing shuffle classified ``CapacityOverflow`` and the
   retry ladder's grown capacity giving the same groups;
21. across processes: SF10 orders through the DCN wire
   (``serialize_table``/``deserialize_table`` with the codec on and off,
   then a sealed loopback ``SliceLink``), each equal to the input; a
   ``QueryCluster`` of two host workers on the card (no supervisor memo,
   no worker result cache, so repeats run) with SF10 catalog_sales and
   orders registered: ``tpcds_q72_cluster`` with the runtime filter off
   and on, and q13's exchange direct, routed and as one plan, each
   bit-identical to the single-process result on the card (q13 also to
   its numpy oracle as a set of rows), D launched by the workers exactly
   3 a host a q72 run and never for q13, with seconds (median of 3),
   registration seconds, link and direct-flight bytes and the card's
   used bytes across processes; h0 held before its q72 partial and
   SIGKILLed: the shard re-homed, the result bit-identical, a classified
   host death and a restart, no leaked bytes, the dead host's memory
   given back; a ``QueryFleet`` of two replicas serving planned q1 and
   q6 over a quarter of SF10 lineitem to two sessions, bit-identical to
   ``fusion.execute``, the repeats memo-served, A launched once across
   the workers; ``exchange_local``, ``partitioned_groupby``,
   ``partitioned_join`` (D once a partition) and the one-plan q13 in
   this process, each equal to its single-device counterpart;
22. what the card once refused, at full width: ``plan_groupby_auto``
   over SF10 lineitem (59,986,052 rows) by l_suppkey with the DDL
   domain of 100,000 supplier keys from a budget of 4,096 (TPC-H q15's
   revenue-by-supplier aggregate: sum and count of l_quantity and
   l_extendedprice, their min and max), lowered to the bounded plan at
   m = 100,001 with kernel A launched exactly ``launches(m, L)`` times
   (one pass), equal to the same call with no domain (the general
   plan) and to ``np.bincount``, A alone at this shape against its
   plain version, and one float-sum lane at m = 100,001 (windows of
   groups) three times: the same bits each run, within
   ``FLOAT_SUM_REL * sum|x|`` of the plain version; ``convert_to_rows(enforce_row_limit=
   False)`` over 200 INT64 columns x 2,000,000 rows (1,632-byte rows)
   and 8,000 x 20,000 (65,000-byte rows), ~10 % nulls, kernel C once
   each, equal byte for byte to its plain version, the round trip
   through ``convert_from_rows`` exact, C's time (split into the
   wrapper's host time and the kernel's) beside its byte bound, its
   plain version and ``torch.cat`` of the ready byte pieces; the
   general groupby by l_suppkey of a FLOAT64 sum over a quarter of SF10
   lineitem three times, kernel E once a run, the same bits each run,
   within 1e-12 * sum|x| of the plain version and (count - 1) * eps *
   sum|x| of the exact sum, and E alone at this shape and with the same
   rows in one group against its plain version and ``index_add_``; no
   fallback anywhere in the phase;
23. one ``{"kernels": [...]}`` line (A-D and E, the general groupby's
   float sums), the card line, and the final ``{"ok": true, "device":
   {...}}`` line.

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
# phase 14 runs over a quarter of SF10 lineitem (half until phase 21
# came; its host oracles are most of its time), which keeps the whole
# script under 800 s
GROUPBY_ROWS = SF10_ROWS // 4
# phase 17 runs over an eighth of SF10 lineitem (a quarter until phase 21
# came, half until the serving phase), for the same reason
OPERATORS_ROWS = SF10_ROWS // 8
# phases 20 and 21 run their operators over a quarter of SF10 lineitem
EXECUTOR_ROWS = SF10_ROWS // 4
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


# kernel E's launches (the general groupby's float sums, wherever a path
# runs them), by the path whose counts were read
E_BY_PATH: dict = {}


def _launches_but_e(path: str) -> dict:
    """The launches since the last reset of every kernel but E, whose
    launches are recorded under ``path`` for its row of the kernels
    line: the paths' checks of A-D stay as they were."""
    from spark_rapids_jni_tpu_torch.ops import kernels
    from spark_rapids_jni_tpu_torch.ops.kernels import segment_sum as kss

    got = dict(kernels.launches())
    e = got.pop(kss.NAME, 0)
    if e:
        E_BY_PATH[path] = E_BY_PATH.get(path, 0) + e
    return got


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
        m=m, lanes=len(lanes), rows=n,
        launches=kga.launches(m, len(lanes), len(fsum)),
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
    from spark_rapids_jni_tpu_torch.utils.timing import (
        host_device_ms,
        median_ms,
    )

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
    host_ms, device_ms = host_device_ms(
        lambda: krt._prepare_cuda(datas, valids, schema, starts, spr),
        krt._launch_cuda)
    rows["C"] = dict(
        name=krt.NAME, route="cuda",
        source="spark_rapids_jni_tpu_torch/csrc/row_transpose.cu",
        replaces="spark_rapids_jni_tpu/ops/pallas/row_transpose.py:103",
        max_abs_err=err,
        ms=median_ms(lambda: krt._assemble_rows_cuda(
            datas, valids, schema, starts, spr)),
        plain_ms=median_ms(lambda: krt.assemble_rows_plain(
            datas, valids, schema, starts, spr)),
        bound_ms=b_ms, bound_by=b_by, library_ms=lib, host_ms=host_ms,
        device_ms=device_ms)
    log(f"kernel C {krt.NAME}: {spr}-byte rows exact; "
        f"{rows['C']['ms']:.3f} ms (wrapper's host {host_ms:.3f}, kernel "
        f"{device_ms:.3f}; plain {rows['C']['plain_ms']:.3f}, torch.cat "
        f"{lib:.3f}, bound {b_ms:.3f})")
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
    _launches_but_e(name)
    require(got == {"A": want.get("A", 0), "D": want.get("D", 0)},
            f"{name} launched {got}, not {want}")
    require(not kernels.fallbacks(),
            f"{name} fell back: {kernels.fallbacks()}")
    return res, got


def q3_path_phase(customer, orders, li3) -> tuple:
    """``tpch_q3`` and ``tpch_q3_planned`` at SF10 through the entry
    points, each with the counts set to 0 just before it; also returns
    the numpy oracle's groups (phase 19 serves the same tables)."""
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
                      "q3_peak_gib": peak}, want


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
    got = _launches_but_e(name)
    require(got == {} and not kernels.fallbacks(),
            f"{name}: launches {got}, fallbacks {kernels.fallbacks()}")
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

    # escaped documents: the native host engine's work (phase 15 runs it
    # over 1,000,000 documents)
    esc = [t.replace('"s', '"\\"s', 1) for t in templates[:1000]]
    lens_e, mat_e = static_strings(esc, dev)
    col = Column(STRING, lens_e, None, chars=mat_e)
    telemetry.reset()
    got = _no_launch("get_json_object (escaped)",
                     lambda: get_json_object(col, "$.meta.w"))
    require(got.to_pylist() == [_json_oracle(d, "$.meta.w") for d in esc],
            "the escaped documents differ from Python json")
    fallbacks["json_escaped"] = _fallbacks_line("escaped documents")
    require(len(fallbacks["json_escaped"]) == 1,
            "the escaped column's host engine run is not recorded")
    log("get_json_object over 1000 escaped documents: the native host "
        "engine, recorded, equal to Python json")
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
    operations over a quarter of SF10 lineitem (``GROUPBY_ROWS``), each held
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
    rows = GROUPBY_ROWS
    tab, neg = tpch.lineitem_groupby_table(rows, Q3_ORDERS, SUPPLIERS)
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
                       + [c.validity for c in work.columns]), rows)
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
        gbytes, rows)
    qs = [0.25, 0.5, 0.9]
    pct = _no_launch("percentile", lambda: groupby_percentile(
        gtab, [0], 1, qs, max_groups=SUPPLIERS))
    _check_percentiles(pct, gtab, qs)
    times["percentile"] = _timed(
        "groupby_percentile(l_quantity by l_suppkey)",
        lambda: groupby_percentile(gtab, [0], 1, qs, max_groups=SUPPLIERS),
        gbytes, rows)
    del pct
    auto = _no_launch("plan_groupby_auto", lambda: plan_groupby_auto(
        gtab, [0], [(1, "sum"), (1, "count")], [None], budget=4096))
    _check_auto(auto, gtab)
    times["plan_groupby_auto"] = _timed(
        "plan_groupby_auto(l_suppkey, from 4,096)",
        lambda: plan_groupby_auto(gtab, [0], [(1, "sum"), (1, "count")],
                                  [None], budget=4096), gbytes, rows)
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
        distinct_bytes([c.data for c in otab.columns]), rows)
    del otab

    # ---- (c) the DECIMAL128 reductions ---------------------------------
    d = tab.column(D128)
    signed = np.where(neg.cpu().numpy(), -host(PRICE), host(PRICE))
    total = int(signed.sum()) * DEC128_SHIFT
    want = {"sum_": total, "min_": int(signed.min()) * DEC128_SHIFT,
            "max_": int(signed.max()) * DEC128_SHIFT,
            "mean": _half_up(total * 10_000, rows)}
    for fn in ("sum_", "mean", "min_", "max_"):
        val, ok = _no_launch(fn, lambda: getattr(reduce, fn)(d))
        limbs = val.data if hasattr(val, "data") else val
        got = _i128(limbs.reshape(-1, 2).cpu().numpy())[0]
        require(bool(ok) and got == want[fn],
                f"DECIMAL128 {fn}: {got} != {want[fn]}")
        times[f"decimal128_{fn}"] = _timed(
            f"reduce.{fn}(DECIMAL128)", lambda: getattr(reduce, fn)(d),
            d.data.nbytes, rows)
    log(f"DECIMAL128 sum_/mean/min_/max_ equal to the Python-int oracle "
        f"(sum {total})")
    del d, signed

    # ---- (d) the table operations -------------------------------------
    li = Table(tab.columns[:7])
    half = rows // 2
    parts = table_ops.contiguous_split(li, [half])
    cat = _no_launch("concatenate", lambda: table_ops.concatenate(parts))
    require(all(a.equals(b) for a, b in zip(cat.columns, li.columns)),
            "concatenate of the two halves != the whole")
    del cat
    times["concatenate"] = _timed(
        "concatenate(two halves)", lambda: table_ops.concatenate(parts),
        2 * distinct_bytes([c.data for c in li.columns]
                           + [c.validity for c in li.columns]), rows)
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
        rows)
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
                       + [c.validity for c in flags.columns]), rows)
    cuts = sorted(np.random.default_rng(14).choice(rows, 10, replace=False))
    pieces = _no_launch("contiguous_split", lambda: table_ops.contiguous_split(
        li, cuts))
    bounds = [0] + [int(c) for c in cuts] + [rows]
    require(len(pieces) == 11 and all(
        p.num_rows == hi - lo and torch.equal(p.column(PRICE).data,
                                              li.column(PRICE).data[lo:hi])
        for p, lo, hi in zip(pieces, bounds, bounds[1:])),
        "contiguous_split pieces differ from the parent's slices")
    del pieces
    times["contiguous_split"] = _timed(
        "contiguous_split(10 points)",
        lambda: table_ops.contiguous_split(li, cuts), 0, rows)
    okey = tab.column(OKEY)
    # overlapping thirds: rows [0, n/3) and [n/4, 2n/3)
    a, b, c = rows // 3, rows // 4, 2 * rows // 3
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
            and k == len(live)
            and auto.table.num_rows == min(budget, gtab.num_rows),
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


# ---- phase 15: the readers (Parquet footer, Parquet and ORC data readers,
# chunked reads) staged through pinned memory ---------------------------------

# phase 15's lineitem file: a quarter of SF10, 15 row groups (its reads
# of the whole 2 GB SF10 file took 164 s of the script)
READER_ROWS = SF10_ROWS // 4
PARQUET_RG_ROWS = 1_048_576    # row group
PARQUET_PAGE_ROWS = 131_072    # 1 MiB PLAIN INT64 pages, pyarrow's default
CHUNK_READ_LIMIT = 256 * 2**20  # the chunked reads' byte budget
ORC_ROWS = 6_000_000           # lineitem rows written as ORC
ORC_STRIPE_ROWS = 1_048_576
JSON_HOST_DOCS = 1_000_000     # documents of the native JSON engine
POOL_THREADS = 8               # the decode pool of the chunked host read
DATA_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_files"
Q1_FILE_COLUMNS = ("l_quantity", "l_extendedprice", "l_discount", "l_tax",
                   "l_returnflag", "l_linestatus", "l_shipdate")


def _write_q1_parquet(path, rows: int) -> tuple:
    """``rows`` of SF10 lineitem (seed 0, on the host) written to
    ``path`` in bench.py's parquet_q1 layout: four unscaled INT64 money
    columns, the flags as INT32/INT_8 and l_shipdate as INT32/DATE with
    dictionaries, ``PARQUET_RG_ROWS``-row groups of ``PARQUET_PAGE_ROWS``
    snappy pages. Returns the generated table and the file's size."""
    import chip_smoke_writers as w
    from spark_rapids_jni_tpu_torch.models import tpch

    gen = tpch.lineitem_table(rows, seed=0, device="cpu")
    host = [c.data.numpy() for c in gen.columns]
    cols = [w.ParquetColumn(name, host[i], w.INT64)
            for i, name in enumerate(Q1_FILE_COLUMNS[:4])]
    cols += [w.ParquetColumn(Q1_FILE_COLUMNS[i], host[i], w.INT32,
                             w.CONV_INT_8, dictionary=True) for i in (4, 5)]
    cols.append(w.ParquetColumn("l_shipdate", host[6], w.INT32,
                                w.CONV_DATE, dictionary=True))
    return gen, w.write_parquet(path, cols, PARQUET_RG_ROWS,
                                PARQUET_PAGE_ROWS)


def _chunk_rule(infos, limit: int) -> list:
    """The reference's chunk plan (``ParquetChunkedReader._chunk_end``),
    written out again: each chunk is the longest run of row groups whose
    summed bytes fit ``limit``, at least one."""
    plans, start = [], 0
    while start < len(infos):
        end, total = start, 0
        while end < len(infos):
            total += infos[end][1]
            if end > start and total > limit:
                break
            end += 1
        plans.append(list(range(start, end)))
        start = end
    return plans


def _same_tables(what: str, got, want) -> None:
    """Same types, every data byte and the validity tri-state."""
    require(got.num_columns == want.num_columns, f"{what}: column count")
    for i, (a, b) in enumerate(zip(got.columns, want.columns)):
        require(a.dtype == b.dtype, f"{what} column {i}: {a.dtype} vs "
                f"{b.dtype}")
        require(a.data.device == b.data.device
                and torch.equal(a.data, b.data), f"{what} column {i} data")
        require((a.validity is None) == (b.validity is None)
                and (a.validity is None
                     or torch.equal(a.validity, b.validity)),
                f"{what} column {i} validity")


def _launched_only(what: str, fn, want: dict):
    """``fn()`` with the counts reset just before it and read just after:
    the kernels launched but E (recorded apart) are exactly ``want``
    (``{name: n}``), and no kernel fell back."""
    from spark_rapids_jni_tpu_torch.ops import kernels

    kernels.reset_counts()
    out = fn()
    torch.cuda.synchronize()
    got = _launches_but_e(what)
    require({k: v for k, v in got.items() if v} == want,
            f"{what} launched {got}, not {want}")
    require(not kernels.fallbacks(), f"{what} fell back: "
            f"{kernels.fallbacks()}")
    return out


def _busy_share(fn) -> tuple:
    """One run of ``fn`` under ``torch.profiler``: the device time of its
    kernels, copies and memsets over the run's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    busy_us = sum(float(e.self_device_time_total)
                  for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA)
    return busy_us / wall_us, busy_us / 1e3, wall_us / 1e3


def _pinned_copy_ms(nbytes: int, dev) -> float:
    """Median time of one plain pinned host-to-device ``copy_`` of
    ``nbytes``, the staging yardstick."""
    from spark_rapids_jni_tpu_torch.utils.timing import median_ms

    src = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    dst = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    ms = median_ms(lambda: dst.copy_(src, non_blocking=True), reps=3)
    del src, dst
    return ms


def _host_json_docs(n: int) -> tuple:
    """``n`` documents tiled from bench.py's 4,096 templates, every third
    with escapes in its sku (a quote, a tab and a \\u escape) and every
    fifth malformed in one of three ways (an unclosed object, a trailing
    word, an extra closing brace); with each template's repaired text,
    which Python's json parses as the streaming engine reads the
    malformed one: up to the fault."""
    from spark_rapids_jni_tpu_torch.models import bench_strings as bs

    docs, repaired = [], []
    for i, d in enumerate(bs.json_templates()):
        if i % 3 == 0:
            d = d.replace('"sku":"s', '"sku":"\\"s\\t\\u00e9', 1)
        fixed = d
        if i % 5 == 0:
            kind = (i // 5) % 3
            if kind == 0:
                d = d[:-1]
            elif kind == 1:
                d = d + " trailing"
            else:
                d = d + "}"
        docs.append(d)
        repaired.append(fixed)
    reps = -(-n // len(docs))
    return (docs * reps)[:n], repaired


def readers_phase(dev) -> tuple:
    """Phase 15: the port's readers over a quarter of SF10 lineitem
    (``READER_ROWS``) written as Parquet by ``chip_smoke_writers`` (the
    whole-file read, planned and fused q1
    over it, the chunked reads, the footer), TPC-DS q72 over its
    catalog_sales read in chunks, lineitem as ORC, and the native JSON
    engine; each result held to the generator or the in-memory run."""
    import concurrent.futures
    import shutil

    import numpy as np

    import chip_smoke_writers as w
    from spark_rapids_jni_tpu_torch import telemetry
    from spark_rapids_jni_tpu_torch import types as t
    from spark_rapids_jni_tpu_torch.columnar import Column, Table
    from spark_rapids_jni_tpu_torch.columnar.column import string_column
    from spark_rapids_jni_tpu_torch.models import tpcds, tpch
    from spark_rapids_jni_tpu_torch.ops.get_json_object import (
        get_json_object,
    )
    from spark_rapids_jni_tpu_torch.ops.kernels import (
        groupby_accumulate as kga,
        hash_probe as khp,
        q1 as kq1,
    )
    from spark_rapids_jni_tpu_torch.ops.table_ops import concatenate
    from spark_rapids_jni_tpu_torch.orc import OrcChunkedReader
    from spark_rapids_jni_tpu_torch.orc import read_table as orc_read
    from spark_rapids_jni_tpu_torch.parquet import (
        ParquetChunkedReader,
        ParquetFooter,
        read_table,
        row_group_info,
    )
    from spark_rapids_jni_tpu_torch.runtime import native

    out, launches = {}, {}
    torch.cuda.reset_peak_memory_stats()
    shutil.rmtree(DATA_DIR, ignore_errors=True)
    DATA_DIR.mkdir(parents=True)
    try:
        native.load_native()
        out["native_build"] = {"s": native.build_seconds}

        # ---- (a) lineitem as Parquet, bench.py's parquet_q1 layout
        t0 = time.perf_counter()
        path = DATA_DIR / "lineitem.parquet"
        gen, size = _write_q1_parquet(path, READER_ROWS)
        write_s = time.perf_counter() - t0
        infos = row_group_info(path)
        log(f"parquet lineitem: {READER_ROWS} rows, {len(infos)} row "
            f"groups, {size} bytes written in {write_s:.1f} s (numpy "
            f"writer)")
        out["parquet_file"] = {"bytes": size, "row_groups": len(infos),
                               "write_s": write_s}

        # ---- (b) the whole-file read: decode, copy-out, staging -------
        runs = []
        for _ in range(4):  # the first allocates the pinned blocks
            tm = {}
            t0 = time.perf_counter()
            tbl = read_table(path, timings=tm)
            torch.cuda.synchronize()
            tm["total_s"] = time.perf_counter() - t0
            runs.append(tm)
            if len(runs) < 4:
                del tbl
        first, timed = runs[0], runs[1:]
        med = {k: statistics.median(r[k] for r in timed)
               for k in ("decode_s", "copy_out_s", "stage_s", "total_s")}
        staged = timed[0]["staged_bytes"]
        plain_ms = _pinned_copy_ms(staged, dev)
        out["read_table"] = {
            "median_s": med, "first_s": first, "runs": timed,
            "staged_bytes": staged, "stage_gb_s": staged / med["stage_s"]
            / 1e9, "pinned_copy_ms": plain_ms,
            "pinned_copy_gb_s": staged / plain_ms / 1e6,
            "rows_per_s": READER_ROWS / med["total_s"]}
        log(f"read_table(path) to the card: median of 3 {med['total_s']:.3f}"
            f" s = native decode {med['decode_s']:.3f} + copy-out into "
            f"pinned memory {med['copy_out_s']:.3f} + staging and casts "
            f"{med['stage_s']:.3f} s ({staged / med['stage_s'] / 1e9:.2f} "
            f"GB/s of {staged} bytes; a plain pinned copy_ of as many bytes "
            f"{plain_ms:.3f} ms, {staged / plain_ms / 1e6:.2f} GB/s); first "
            f"read {first['total_s']:.3f} s (pinned blocks allocated)")

        # every column equals the generator's; the money columns are
        # unscaled INT64 in the file, as bench.py writes them
        money = t.decimal64(-2)

        def retyped(table):
            cs = list(table.columns)
            for i in range(4):
                cs[i] = Column(money, cs[i].data, cs[i].validity)
            return Table(cs)

        li = Table([Column(c.dtype, c.data.to(dev), None)
                    for c in gen.columns])
        del gen
        read_li = retyped(tbl)
        _same_tables("parquet lineitem", read_li, li)
        log("parquet lineitem: all 7 columns equal the generator's, no "
            "validity")

        # planned and fused q1 over the read table
        want_planned = tpch.tpch_q1_planned_result(li)
        want_fused = kq1.tpch_q1_pallas(li)
        res = _launched_only("parquet planned q1", lambda:
                             tpch.tpch_q1_planned_result(read_li),
                             {kga.NAME: 1})
        launches["parquet_q1_planned"] = {"A": 1}
        require(not bool(res.domain_miss), "parquet q1 domain miss")
        _same_tables("parquet planned q1", res.table, want_planned.table)
        require(torch.equal(res.present, want_planned.present),
                "parquet planned q1 groups")
        fused = _launched_only("parquet fused q1",
                               lambda: kq1.tpch_q1_pallas(read_li),
                               {kq1.NAME: 1})
        launches["parquet_q1_fused"] = {"B": 1}
        _same_tables("parquet fused q1", fused, want_fused)
        log("planned q1 over the read table equals the in-memory planned "
            "q1 (A launched once); fused q1 equals the in-memory fused q1 "
            "(B launched once); no fallback")
        del res, fused, want_planned, want_fused, read_li

        def parquet_q1():
            return tpch.tpch_q1_planned(retyped(read_table(path)))

        s = host_median_s(parquet_q1)
        q1_s = host_median_s(lambda: tpch.tpch_q1_planned(li), warm=False)
        share, busy_ms, wall_ms = _busy_share(parquet_q1)
        out["parquet_q1"] = {"s": s, "rows_per_s": READER_ROWS / s,
                             "q1_planned_in_memory_s": q1_s,
                             "device_busy_share": share,
                             "device_busy_ms": busy_ms,
                             "profiled_wall_ms": wall_ms}
        log(f"parquet_q1 (read_table + planned q1, median of 3): "
            f"{s:.3f} s, {READER_ROWS / s:.4g} rows/s (planned q1 alone "
            f"{q1_s * 1e3:.3f} ms); device busy {busy_ms:.1f} ms of "
            f"{wall_ms:.1f} ms profiled, share {share:.4f}")

        # ---- (c) chunked reads --------------------------------------
        rdr = ParquetChunkedReader(path, CHUNK_READ_LIMIT)
        plan = rdr.chunk_plan()
        require(plan == _chunk_rule(infos, CHUNK_READ_LIMIT),
                f"chunk plan {plan} differs from the reference's rule")
        t0 = time.perf_counter()
        chunks = list(rdr)
        torch.cuda.synchronize()
        chunked_s = time.perf_counter() - t0
        _same_tables("chunked read", concatenate(chunks), tbl)
        del chunks
        srcs = ParquetChunkedReader(path, CHUNK_READ_LIMIT).chunk_sources(
            stage="host")
        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(POOL_THREADS) as pool:
            host_chunks = list(pool.map(lambda f: f(), srcs))
        pool_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        staged_chunks = [c.stage() for c in host_chunks]
        torch.cuda.synchronize()
        pool_stage_s = time.perf_counter() - t0
        _same_tables("pooled chunked read", concatenate(staged_chunks), tbl)
        del host_chunks, staged_chunks
        out["chunked"] = {"chunks": len(plan), "limit_bytes":
                          CHUNK_READ_LIMIT, "serial_s": chunked_s,
                          "pool_threads": POOL_THREADS,
                          "pool_decode_s": pool_s,
                          "pool_stage_s": pool_stage_s}
        log(f"ParquetChunkedReader at {CHUNK_READ_LIMIT} bytes: {len(plan)}"
            f" chunks (the reference's rule), concatenated equal to "
            f"read_table; serial {chunked_s:.3f} s; chunk_sources(host) on "
            f"{POOL_THREADS} threads {pool_s:.3f} s + staging "
            f"{pool_stage_s:.3f} s, equal too")
        del tbl
        torch.cuda.empty_cache()

        # ---- (d) the footer ----------------------------------------
        fb = w.footer_bytes(path)
        starts = np.cumsum([4] + [b for _, b in infos[:-1]])
        mids = starts + np.array([b for _, b in infos]) // 2
        part_len = int(starts[len(infos) // 2])
        keep = (mids >= 0) & (mids < part_len)
        want_rows = int(sum(r for (r, _), k in zip(infos, keep) if k))
        names = ["l_quantity", "l_discount", "l_shipdate"]
        t0 = time.perf_counter()
        with ParquetFooter.read_and_filter(fb, 0, part_len, names,
                                           [0, 0, 0], 3) as ft:
            footer_s = time.perf_counter() - t0
            require((ft.num_rows, ft.num_columns) == (want_rows, 3),
                    f"footer {ft.num_rows} rows {ft.num_columns} columns, "
                    f"not {want_rows} and 3")
            image = ft.serialize_thrift_file()
        require(image[:4] == b"PAR1" and image[-4:] == b"PAR1",
                "serialized footer framing")
        with ParquetFooter.read_and_filter(image[4:-8], 0, -1, names,
                                           [0, 0, 0], 3) as again:
            require((again.num_rows, again.num_columns) == (want_rows, 3),
                    "the serialized footer re-parses differently")
        out["footer"] = {"bytes": len(fb), "row_groups_kept":
                         int(keep.sum()), "rows": want_rows, "s": footer_s}
        log(f"footer ({len(fb)} bytes): pruned to 3 columns and filtered to "
            f"bytes [0, {part_len}): {int(keep.sum())} of {len(infos)} row "
            f"groups, {want_rows} rows as counted here, in "
            f"{footer_s * 1e3:.3f} ms; the serialized file re-parses alike")

        # ---- (e) TPC-DS q72 over catalog_sales read in chunks --------
        q72 = (tpcds.catalog_sales_table(DS_CATALOG_SALES,
                                         num_items=DS_ITEMS),
               tpcds.date_dim_table(), tpcds.item_table(DS_ITEMS),
               tpcds.inventory_table(num_items=DS_ITEMS))
        want = tpcds.tpcds_q72(*q72).compact()
        cs_path = DATA_DIR / "catalog_sales_sf10.parquet"
        cs_host = [c.data.cpu().numpy() for c in q72[0].columns]
        cs_size = w.write_parquet(cs_path, [
            w.ParquetColumn(name, a, w.INT64) for name, a in zip(
                ("cs_item_sk", "cs_sold_date_sk", "cs_quantity",
                 "cs_order_number"), cs_host)],
            PARQUET_RG_ROWS, PARQUET_PAGE_ROWS)
        del cs_host
        t0 = time.perf_counter()
        cs_rdr = ParquetChunkedReader(cs_path, CHUNK_READ_LIMIT)
        cs_chunks = len(cs_rdr.chunk_plan())
        cs = concatenate(list(cs_rdr))
        torch.cuda.synchronize()
        cs_s = time.perf_counter() - t0
        _same_tables("catalog_sales read", cs, q72[0])
        res = _launched_only("parquet q72", lambda: tpcds.tpcds_q72(
            cs, *q72[1:]), {khp.NAME: 3})
        launches["parquet_q72"] = {"D": 3}
        _same_tables("parquet q72", res.compact(), want)
        out["q72"] = {"bytes": cs_size, "chunks": cs_chunks, "read_s": cs_s,
                      "rows_per_s": DS_CATALOG_SALES / cs_s}
        log(f"catalog_sales: {DS_CATALOG_SALES} rows, {cs_size} bytes, "
            f"read in {cs_chunks} chunks of at most {CHUNK_READ_LIMIT} bytes in {cs_s:.3f} s, "
            f"equal to the generator; q72 over it equals the in-memory q72, "
            f"D launched 3 times, nothing else")
        del q72, cs, res, want
        torch.cuda.empty_cache()

        # ---- (f) lineitem as ORC ------------------------------------
        ocols = [(Q1_FILE_COLUMNS[i], w.ORC_LONG,
                  li.column(i).data[:ORC_ROWS].cpu().numpy())
                 for i in range(4)]
        ocols += [(Q1_FILE_COLUMNS[i], w.ORC_BYTE,
                   li.column(i).data[:ORC_ROWS].cpu().numpy())
                  for i in (4, 5)]
        ocols.append(("l_shipdate", w.ORC_DATE,
                      li.column(6).data[:ORC_ROWS].cpu().numpy()))
        orc_path = DATA_DIR / "lineitem.orc"
        t0 = time.perf_counter()
        orc_size = w.write_orc(orc_path, ocols, ORC_STRIPE_ROWS)
        orc_write_s = time.perf_counter() - t0
        del ocols
        want = Table([Column(t.INT64 if i < 4 else c.dtype,
                             c.data[:ORC_ROWS], None)
                      for i, c in enumerate(li.columns)])
        orc_s = host_median_s(lambda: orc_read(orc_path))
        _same_tables("orc read_table", orc_read(orc_path), want)
        orc_chunks = list(OrcChunkedReader(orc_path, CHUNK_READ_LIMIT))
        _same_tables("orc chunked", concatenate(orc_chunks), want)
        out["orc"] = {"rows": ORC_ROWS, "bytes": orc_size,
                      "write_s": orc_write_s, "read_s": orc_s,
                      "rows_per_s": ORC_ROWS / orc_s,
                      "chunks": len(orc_chunks)}
        log(f"orc lineitem: {ORC_ROWS} rows, {orc_size} bytes written in "
            f"{orc_write_s:.1f} s; read_table {orc_s:.3f} s (median of 3), "
            f"{ORC_ROWS / orc_s:.4g} rows/s, and OrcChunkedReader "
            f"({len(orc_chunks)} chunks) equal to the generator")
        del orc_chunks, want, li
        torch.cuda.empty_cache()

        # ---- (g) the native JSON engine ------------------------------
        docs, repaired = _host_json_docs(JSON_HOST_DOCS)
        col = string_column(docs, device=dev)
        for path_ in JSON_PATHS:
            telemetry.reset()
            t0 = time.perf_counter()
            got = _launched_only(f"get_json_object {path_}",
                                 lambda: get_json_object(col, path_), {})
            json_s = time.perf_counter() - t0
            fb_ = telemetry.fallbacks()
            require(len(fb_) == 1 and next(iter(fb_.values())) == {
                "calls": 1, "rows": JSON_HOST_DOCS},
                f"the host engine's run is not recorded once: {fb_}")
            want = [_json_oracle(d, path_) for d in repaired]
            got_l = got.to_pylist()
            require(all(g == want[i % len(want)]
                        for i, g in enumerate(got_l)),
                    f"get_json_object {path_} (host engine) differs from "
                    f"Python json")
            out.setdefault("json_host", {})[path_] = {
                "s": json_s, "rows_per_s": JSON_HOST_DOCS / json_s}
            log(f"get_json_object {path_} over {JSON_HOST_DOCS} escaped and "
                f"malformed documents: native host engine (recorded), "
                f"{json_s:.3f} s, equal to Python json; no launch")
        del col, got
        peak = torch.cuda.max_memory_allocated() / 2**30
        out["peak_gib"] = peak
        log(f"peak device memory of the readers phase {peak:.2f} GiB")
    finally:
        shutil.rmtree(DATA_DIR, ignore_errors=True)
    return launches, out


BRIDGE_NULL_COLUMNS = (2, 6)  # l_discount, l_shipdate: every 7th row null
EXEC_REPS = 9  # interleaved runs of each plan, through execute and by hand


def _rt(lib, ok: bool, what: str) -> None:
    require(ok, f"{what}: {lib.tpudf_rt_last_error()!r}")


def _pinned_d2h_ms(nbytes: int, dev) -> float:
    """Median time of one plain device-to-pinned-host ``copy_`` of
    ``nbytes``, the read-back yardstick."""
    from spark_rapids_jni_tpu_torch.utils.timing import median_ms

    src = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    dst = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    ms = median_ms(lambda: dst.copy_(src, non_blocking=True), reps=3)
    del src, dst
    return ms


def _max_rss_gib() -> float:
    import resource

    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20


def _bridge_round_trip(li, dev) -> dict:
    """SF10 lineitem from host bytes through the port's C ABI
    (``libtpudf_rt.so`` over ctypes, in this process) to packed rows and
    back: each step's seconds and GB/s, the row image equal byte for byte
    to the direct ``convert_to_rows``, the columns equal to the input."""
    import ctypes

    import numpy as np

    from spark_rapids_jni_tpu_torch.ops import kernels
    from spark_rapids_jni_tpu_torch.ops.kernels import row_transpose as krt
    from spark_rapids_jni_tpu_torch.ops.row_conversion import convert_to_rows
    from spark_rapids_jni_tpu_torch.runtime import native

    out = {}
    t0 = time.perf_counter()
    lib = native.load_rt_bridge()
    _rt(lib, lib.tpudf_rt_init(str(Path(__file__).resolve().parent)
                               .encode(), b"") == 0, "tpudf_rt_init")
    out["load_init_s"] = time.perf_counter() - t0
    out["build_s"] = native.rt_build_seconds
    n = li.num_rows
    datas = [c.data.cpu().numpy() for c in li.columns]
    null_row = (np.arange(n) % 7 == 0)
    valids = [(~null_row).astype(np.uint8) if i in BRIDGE_NULL_COLUMNS
              else None for i in range(len(datas))]
    in_bytes = sum(d.nbytes for d in datas) + sum(
        v.nbytes for v in valids if v is not None)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    def from_host():
        return [lib.tpudf_rt_column_from_host(
            int(c.dtype.type_id), c.dtype.scale, n, d.ctypes.data, d.nbytes,
            None if v is None else v.ctypes.data)
            for c, d, v in zip(li.columns, datas, valids)]

    cols, s = timed(from_host)
    _rt(lib, all(h > 0 for h in cols), "column_from_host")
    out["column_from_host"] = {"s": s, "bytes": in_bytes,
                               "gb_per_s": in_bytes / s / 1e9,
                               "plain_pinned_copy_s":
                               _pinned_copy_ms(in_bytes, dev) / 1e3}
    arr = (ctypes.c_int64 * len(cols))(*cols)
    tbl = lib.tpudf_rt_table_create(arr, len(cols))
    _rt(lib, tbl > 0, "table_create")
    for h in cols:
        lib.tpudf_rt_free(h)

    batches = (ctypes.c_int64 * 4)()
    nb = ctypes.c_int32(0)
    kernels.reset_counts()
    rc, s = timed(lambda: lib.tpudf_rt_convert_to_rows(
        tbl, batches, 4, ctypes.byref(nb)))
    _rt(lib, rc == 0, "convert_to_rows")
    launches = kernels.launches()
    require(launches == {krt.NAME: 1} and not kernels.fallbacks(),
            f"the bridge's convert_to_rows launched {launches}")
    lib.tpudf_rt_free(tbl)
    handles = list(batches[:nb.value])
    sizes = []
    for h in handles:
        rn, rs = ctypes.c_int64(0), ctypes.c_int64(0)
        _rt(lib, lib.tpudf_rt_rows_info(h, ctypes.byref(rn),
                                        ctypes.byref(rs)) == 0, "rows_info")
        sizes.append((rn.value, rs.value))
    rows_bytes = sum(a * b for a, b in sizes)
    out["convert_to_rows"] = {"s": s, "batches": sizes,
                              "launches": launches}
    require(sum(a for a, _ in sizes) == n and len(sizes) == (
        2 if n == SF10_ROWS else len(sizes)), f"batches {sizes}")

    images = [np.empty(a * b, np.uint8) for a, b in sizes]

    def to_host():
        for h, img in zip(handles, images):
            _rt(lib, lib.tpudf_rt_rows_to_host(h, img.ctypes.data,
                                               img.nbytes) == 0,
                "rows_to_host")
    _, s = timed(to_host)
    out["rows_to_host"] = {"s": s, "bytes": rows_bytes,
                           "gb_per_s": rows_bytes / s / 1e9,
                           "plain_pinned_copy_s":
                           _pinned_d2h_ms(rows_bytes, dev) / 1e3}
    for h in handles:
        lib.tpudf_rt_free(h)
    direct = convert_to_rows(_null_every_7th(li, null_row, dev))
    for img, b in zip(images, direct, strict=True):
        require(torch.equal(torch.from_numpy(img).to(dev), b.data),
                "the bridge's row image differs from convert_to_rows")
    del direct
    torch.cuda.empty_cache()

    def from_rows_host():
        return [lib.tpudf_rt_rows_from_host(a, b, img.ctypes.data)
                for (a, b), img in zip(sizes, images)]
    back_rows, s = timed(from_rows_host)
    _rt(lib, all(h > 0 for h in back_rows), "rows_from_host")
    out["rows_from_host"] = {"s": s, "bytes": rows_bytes,
                             "gb_per_s": rows_bytes / s / 1e9,
                             "plain_pinned_copy_s":
                             _pinned_copy_ms(rows_bytes, dev) / 1e3}
    del images
    k = len(datas)
    tids = (ctypes.c_int32 * k)(*[int(c.dtype.type_id) for c in li.columns])
    scales = (ctypes.c_int32 * k)(*[c.dtype.scale for c in li.columns])

    def from_rows():
        return [lib.tpudf_rt_convert_from_rows(h, tids, scales, k)
                for h in back_rows]
    tables, s = timed(from_rows)
    _rt(lib, all(h > 0 for h in tables), "convert_from_rows")
    out["convert_from_rows"] = {"s": s}
    for h in back_rows:
        lib.tpudf_rt_free(h)

    got = [np.empty_like(d) for d in datas]
    got_v = [np.empty(n, np.uint8) for _ in datas]

    def to_host_cols():
        start = 0
        for h, (rn, _) in zip(tables, sizes):
            for i in range(k):
                col = lib.tpudf_rt_table_column(h, i)
                _rt(lib, col > 0, "table_column")
                dst, vdst = got[i][start:start + rn], got_v[i][start:
                                                              start + rn]
                _rt(lib, lib.tpudf_rt_column_to_host(
                    col, dst.ctypes.data, dst.nbytes, vdst.ctypes.data,
                    vdst.nbytes) == 0, "column_to_host")
                lib.tpudf_rt_free(col)
            start += rn
    _, s = timed(to_host_cols)
    out_bytes = sum(d.nbytes for d in datas) + n * k
    out["column_to_host"] = {"s": s, "bytes": out_bytes,
                             "gb_per_s": out_bytes / s / 1e9,
                             "plain_pinned_copy_s":
                             _pinned_d2h_ms(out_bytes, dev) / 1e3}
    for h in tables:
        lib.tpudf_rt_free(h)
    for i in range(k):
        require(np.array_equal(got[i], datas[i]),
                f"column {i} data differs after the round trip")
        want_v = np.ones(n, np.uint8) if valids[i] is None else valids[i]
        require(np.array_equal(got_v[i], want_v),
                f"column {i} validity differs after the round trip")
    out["host_max_rss_gib"] = _max_rss_gib()
    for step in ("column_from_host", "rows_to_host", "rows_from_host",
                 "column_to_host"):
        o = out[step]
        log(f"bridge {step}: {o['s']:.3f} s, {o['bytes']} bytes, "
            f"{o['gb_per_s']:.2f} GB/s (plain pinned copy_ "
            f"{o['plain_pinned_copy_s']:.3f} s)")
    log(f"bridge convert_to_rows: {out['convert_to_rows']['s']:.3f} s, "
        f"batches {sizes}, kernel C launched once; convert_from_rows "
        f"{out['convert_from_rows']['s']:.3f} s; the row image equals "
        f"convert_to_rows byte for byte and every column and validity "
        f"byte comes back; process max RSS {out['host_max_rss_gib']:.2f} "
        f"GiB")
    return out


def _null_every_7th(li, null_row, dev):
    """``li`` with the bridge's validity on ``BRIDGE_NULL_COLUMNS``."""
    from spark_rapids_jni_tpu_torch.columnar import Column, Table

    keep = torch.from_numpy(~null_row).to(dev)
    return Table([Column(c.dtype, c.data, keep if i in BRIDGE_NULL_COLUMNS
                         else c.validity)
                  for i, c in enumerate(li.columns)])


def _embedded_selftest() -> dict:
    """The C self test that owns ``Py_Initialize`` (the reference's
    8-column table through the ABI on the card), where the interpreter
    has a shared libpython."""
    import site
    import subprocess

    from spark_rapids_jni_tpu_torch.runtime import native

    exe = native.rt_selftest_path()
    if exe is None:
        log(f"embedded self test: not built, no shared libpython "
            f"({native.python_embed()})")
        return {"ran": False, "python": native.python_embed()}
    env = dict(__import__("os").environ, TPUDF_RT_PLATFORM="",
               TPUDF_PY_PATH=":".join([str(Path(__file__).resolve().parent),
                                       *site.getsitepackages()]))
    t0 = time.perf_counter()
    proc = subprocess.run([str(exe)], env=env, capture_output=True,
                          text=True, timeout=300)
    s = time.perf_counter() - t0
    require(proc.returncode == 0 and "all checks passed" in proc.stdout,
            f"embedded self test failed: {proc.stdout}{proc.stderr}")
    log(f"embedded self test on the card: all checks passed in {s:.1f} s")
    return {"ran": True, "s": s}


def _q72_by_hand(cs, dd, item, inv):
    """q72's nodes called by hand, in the plan's order (the composition
    the models had before they ran through ``fusion.execute``)."""
    from spark_rapids_jni_tpu_torch.models import tpcds
    from spark_rapids_jni_tpu_torch.ops.groupby import groupby_aggregate
    from spark_rapids_jni_tpu_torch.ops.join import apply_join_maps, join
    from spark_rapids_jni_tpu_torch.ops.sort import sort_table

    n = cs.num_rows
    d = tpcds._q72_dd_fn(dd, 2000)
    j1 = apply_join_maps(cs, d, join(cs, d, [tpcds.CS_SOLD_DATE_SK], [0], n))
    j2 = apply_join_maps(j1, item, join(j1, item, [0], [tpcds.I_ITEM_SK], n))
    probe, invk = tpcds._q72_probe_fn(j2), tpcds._q72_inv_fn(inv)
    maps = join(probe, invk, [0], [0], 2 * n)
    g = groupby_aggregate(tpcds._q72_keyed_fn(
        apply_join_maps(probe, invk, maps)), (0, 1), ((2, "count"),))
    return sort_table(g.table, [2, 0], ascending=[False, True],
                      nulls_first=[False, False]), g.num_groups


def _executor_cost(name: str, via_execute, by_hand, same) -> dict:
    """``via_execute`` and ``by_hand`` timed interleaved, EXEC_REPS runs
    each after one checked run of each: equal outputs, medians and their
    difference."""
    a, b = via_execute(), by_hand()
    torch.cuda.synchronize()
    require(same(a, b), f"{name}: execute differs from the hand-composed "
            f"nodes")
    del a, b
    times = {"execute": [], "hand": []}
    for _ in range(EXEC_REPS):
        for key, fn in (("execute", via_execute), ("hand", by_hand)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times[key].append(time.perf_counter() - t0)
    med = {k: statistics.median(v) * 1e3 for k, v in times.items()}
    row = {"execute_ms": med["execute"], "hand_ms": med["hand"],
           "difference_ms": med["execute"] - med["hand"]}
    log(f"{name}: through execute {row['execute_ms']:.3f} ms, by hand "
        f"{row['hand_ms']:.3f} ms (difference {row['difference_ms']:+.3f} "
        f"ms, medians of {EXEC_REPS} interleaved); outputs equal")
    return row


def executor_bridge_phase(dev) -> tuple:
    """Phase 16: the plan executor's own cost (planned q1, q6 and TPC-DS
    q72 through ``fusion.execute`` against their nodes called by hand,
    interleaved) and the SF10 row round trip through the port's C ABI,
    then the embedded-interpreter self test."""
    from spark_rapids_jni_tpu_torch.models import tpcds, tpch
    from spark_rapids_jni_tpu_torch.ops.planner import (
        plan_groupby,
        scalar_domain,
    )

    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    out, launches = {}, {}
    li = tpch.lineitem_table(ROWS, seed=0)
    domains = (scalar_domain(tpch._Q1_RF_DOMAIN),
               scalar_domain(tpch._Q1_LS_DOMAIN))

    def same_planned(a, b):
        return (a.table.equals(b.table) and torch.equal(a.present, b.present)
                and torch.equal(a.domain_miss, b.domain_miss))

    res, launches["executor: tpch_q1_planned"] = _run_plan(
        "planned q1 through execute",
        lambda: tpch.tpch_q1_planned_result(li), {"A": 1})
    require(not bool(res.domain_miss), "planned q1: domain miss")
    out["tpch_q1_planned"] = _executor_cost(
        "planned q1", lambda: tpch.tpch_q1_planned_result(li),
        lambda: plan_groupby(tpch._q1_work_table(li), (0, 1), tpch._Q1_AGGS,
                             domains), same_planned)
    _, launches["executor: tpch_q6"] = _run_plan(
        "q6 through execute", lambda: tpch.tpch_q6(li), {})
    out["tpch_q6"] = _executor_cost(
        "q6", lambda: tpch.tpch_q6(li),
        lambda: tpch._q6_reduce(li, None).column(0),
        lambda a, b: a.equals(b))
    out["bridge"] = _bridge_round_trip(li, dev)
    del li
    torch.cuda.empty_cache()

    q72 = (tpcds.catalog_sales_table(DS_CATALOG_SALES, num_items=DS_ITEMS),
           tpcds.date_dim_table(), tpcds.item_table(DS_ITEMS),
           tpcds.inventory_table(num_items=DS_ITEMS))
    _, launches["executor: tpcds_q72"] = _run_plan(
        "q72 through execute", lambda: tpcds.tpcds_q72(*q72), {"D": 3})
    out["tpcds_q72"] = _executor_cost(
        "TPC-DS q72", lambda: tpcds.tpcds_q72(*q72),
        lambda: _q72_by_hand(*q72),
        lambda a, b: a.table.equals(b[0])
        and int(a.num_groups) == int(b[1]))
    del q72
    torch.cuda.empty_cache()
    out["embedded_selftest"] = _embedded_selftest()
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"executor and bridge phase: {out['phase_s']:.1f} s, peak device "
        f"memory {out['peak_gib']:.2f} GiB")
    return launches, out


SEQ_MAX = 1024  # sequence's per-row bound (the reference's default)
WINDOW_CPU_SLICE = 1_000_000  # rows whose float window results the CPU
# computes again, bit for bit


def _h(x):
    """A device tensor on the host (numpy)."""
    return x.cpu().numpy()


def _hv(col):
    """A column's validity on the host (all True where it has none)."""
    import numpy as np

    if col.validity is None:
        return np.ones(col.size, bool)
    return _h(col.validity)


def _np_segments(key_sorted):
    """Segments of equal ``key_sorted`` values: (starts, sizes, each
    row's start and end)."""
    import numpy as np

    n = key_sorted.shape[0]
    new = np.empty(n, bool)
    new[:1] = True
    np.not_equal(key_sorted[1:], key_sorted[:-1], out=new[1:])
    starts = np.flatnonzero(new).astype(np.int32)  # int32: half the bytes
    sizes = np.diff(np.append(starts, np.int32(n)))
    return (starts, sizes, np.repeat(starts, sizes),
            np.repeat(starts + sizes - 1, sizes))


def _np_prefix(x):
    import numpy as np

    out = np.zeros(x.shape[0] + 1, np.int64)
    np.cumsum(x, out=out[1:])
    return out


def _np_range_reduce(ufunc, a, lo, hi, fill):
    """``ufunc`` over a[lo_i .. hi_i] inclusive for every i (non-empty
    ranges): one ``reduceat`` over the interleaved bounds."""
    import numpy as np

    ext = np.append(a, np.array([fill], a.dtype))
    idx = np.empty(2 * lo.shape[0], np.int64)
    idx[0::2], idx[1::2] = lo, hi + 1
    return ufunc.reduceat(ext, idx)[0::2]


def _np_times_1e20(s):
    """(lo, hi) int64 limbs of the 128-bit s * 10^20 for |s| < 2^32: the
    magnitude times the three 32-bit limbs of 10^20 (each product below
    2^64), recombined with the one carry, then negated where s < 0. The
    oracle of the DECIMAL128 rolling sums, whose inputs are
    l_extendedprice x 10^20."""
    import numpy as np

    mag = np.abs(s).astype(np.uint64)
    require(bool((mag >> np.uint64(32) == 0).all()), "|s| past 2^32")
    m32 = np.uint64(0xFFFFFFFF)
    c0, c1, c2 = ((10**20 >> (32 * k)) & 0xFFFFFFFF for k in range(3))
    p0, p1 = mag * np.uint64(c0), mag * np.uint64(c1)
    lo = p0 + ((p1 & m32) << np.uint64(32))
    hi = mag * np.uint64(c2) + (p1 >> np.uint64(32)) + (lo < p0).astype(
        np.uint64)
    neg = s < 0
    return (np.where(neg, ~lo + np.uint64(1), lo).view(np.int64),
            np.where(neg, ~hi + (lo == 0).astype(np.uint64), hi).view(
                np.int64))


class _Part:
    """One part of the operators phase: launches of A-D read at its end
    (none allowed), its seconds logged."""

    def __init__(self, name: str, parts: dict):
        from spark_rapids_jni_tpu_torch.ops import kernels

        self.name, self.parts = name, parts
        kernels.reset_counts()
        self.t0 = time.perf_counter()

    def done(self) -> None:
        from spark_rapids_jni_tpu_torch.ops import kernels

        torch.cuda.synchronize()
        s = time.perf_counter() - self.t0
        got = _launches_but_e(f"operators part {self.name}")
        require(got == {} and not kernels.fallbacks(),
                f"{self.name}: launches {got}, fallbacks "
                f"{kernels.fallbacks()}")
        self.parts[self.name] = s
        log(f"operators part {self.name}: {s:.1f} s, no launch of A-D")


def _sync_s(fn):
    """(result, seconds) of one run of ``fn`` ending in a synchronize."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0


def _equal_under(name, got, want_data, want_valid) -> None:
    """A result column equal to a numpy oracle: validity everywhere, data
    (bits, NaN positions) where valid."""
    import numpy as np

    gv = _hv(got)
    require(np.array_equal(gv, want_valid), f"{name}: validity differs")
    g, w = _h(got.data), np.asarray(want_data)
    if not gv.all():
        g, w = g[gv], w[gv]
    if g.dtype.kind == "f":
        nan = np.isnan(w)
        require(np.array_equal(np.isnan(g), nan)
                and np.array_equal(g[~nan], w[~nan]),
                f"{name}: values differ")
    else:
        require(np.array_equal(g, w), f"{name}: values differ")


def _near_under(name, got, want, want_valid, bound) -> float:
    """A float result within ``bound`` (per row) of a numpy oracle where
    valid, NaN where the oracle is; returns the largest difference."""
    import numpy as np

    gv = _hv(got)
    require(np.array_equal(gv, want_valid), f"{name}: validity differs")
    g, w = _h(got.data)[gv], want[gv]
    nan = np.isnan(w)
    require(np.array_equal(np.isnan(g), nan), f"{name}: NaN rows differ")
    err = np.abs(g[~nan] - w[~nan])
    require(bool((err <= bound[gv][~nan]).all()),
            f"{name}: past 1e-12 of its scale")
    return float(err.max(initial=0.0))


def _elementwise_part(tab, neg, host, dev, out) -> None:
    """coalesce, nullif, greatest/least, abs, ceil/floor, round and pmod
    over every row against numpy."""
    import numpy as np

    from spark_rapids_jni_tpu_torch.columnar import Column
    from spark_rapids_jni_tpu_torch.ops import elementwise as ew
    from spark_rapids_jni_tpu_torch.types import FLOAT64, INT64

    QTY, PRICE, DISC, TAX, F64, OKEY = 0, 1, 2, 3, 9, 7
    q, qv = host["qty"], host["qty_v"]
    d, t = host["disc"], host["tax"]
    col = tab.column
    got, s = _sync_s(lambda: ew.coalesce([col(QTY), col(TAX)]))
    _equal_under("coalesce", got, np.where(qv, q, t), np.ones_like(qv))
    out["coalesce_s"] = s
    got = ew.nullif(col(TAX), col(DISC))
    _equal_under("nullif", got, t, t != d)
    trio = [col(QTY), col(DISC), col(TAX)]
    big = np.where(qv, q, np.iinfo(np.int64).min)
    _equal_under("greatest", ew.greatest(trio),
                 np.maximum(np.maximum(big, d), t), np.ones_like(qv))
    small = np.where(qv, q, np.iinfo(np.int64).max)
    _equal_under("least", ew.least(trio),
                 np.minimum(np.minimum(small, d), t), np.ones_like(qv))
    # abs of the price negated on the generator's neg rows
    f = host["f64"]
    neg_f = torch.where(neg, -col(F64).data, col(F64).data)
    _equal_under("abs", ew.abs_(Column(FLOAT64, neg_f)), np.abs(f),
                 np.ones_like(qv))
    # ceil/floor with +-inf and +-1e30 planted beside the NaN rows
    plant = np.array([1, 977, 20_011, 5_000_003]) % host["n"]
    specials = np.array([np.inf, -np.inf, 1e30, -1e30])
    fp = f.copy()
    fp[plant] = specials
    dev_fp = col(F64).data.clone()
    dev_fp[torch.from_numpy(plant).to(dev)] = torch.tensor(
        specials, device=dev)
    src = Column(FLOAT64, dev_fp)
    imax, imin = np.iinfo(np.int64).max, np.iinfo(np.int64).min
    for name, fn, npf in (("ceil", ew.ceil, np.ceil),
                          ("floor", ew.floor, np.floor)):
        v = npf(fp)
        safe = np.where(np.isfinite(v) & (np.abs(v) < 2.0 ** 63), v, 0.0)
        want = np.where(np.isnan(v), 0, np.where(
            v >= 2.0 ** 63, imax, np.where(v <= -2.0 ** 63, imin,
                                           safe.astype(np.int64))))
        got = fn(src)
        require(got.dtype == INT64, f"{name}: not BIGINT")
        _equal_under(name, got, want, np.ones_like(qv))
    out["ceil_nan_rows"] = int(np.isnan(fp).sum())
    # round(l_extendedprice, 0): HALF_UP, sign times the magnitude rounded
    p = host["price"]
    want = np.sign(p) * ((np.abs(p) + 50) // 100)
    _equal_under("round_decimal", ew.round_decimal(col(PRICE), 0), want,
                 np.ones_like(qv))
    # pmod(l_orderkey, 200): Spark's default shuffle partition count
    div = Column(col(OKEY).dtype, torch.full_like(col(OKEY).data, 200))
    got, s = _sync_s(lambda: ew.pmod(col(OKEY), div))
    _equal_under("pmod", got, host["okey"] % 200, np.ones_like(qv))
    out["pmod_s"] = s


def _window_oracle(host, part_key, bits):
    """The sort by (part_key, l_shipdate), its segments and peer
    groups, as numpy arrays."""
    import numpy as np

    key = (part_key.astype(np.int64) << 14) | host["ship"]
    order = _radix_order(key, bits + 14)
    ks = key[order]
    pstarts, psize, p_start, p_end = _np_segments(part_key[order])
    _, _, peer_start, peer_end = _np_segments(ks)
    return order, ks, pstarts, psize, p_start, p_end, peer_start, peer_end


def _window_part(tab, host, dev, out) -> dict:
    """The supplier window (100,000 partitions of ~75 rows) and the
    order window (15,000,000 partitions of 1-18 rows) against numpy; the
    float functions bit-equal to the CPU's over a 1,000,000-row slice.
    The oracles live in sort order: each result is gathered into it on
    the card (a host scatter of 60M rows costs ~2 s)."""
    import numpy as np

    from spark_rapids_jni_tpu_torch.columnar import Column, Table
    from spark_rapids_jni_tpu_torch.columnar.column import take
    from spark_rapids_jni_tpu_torch.ops.table_ops import trim_table
    from spark_rapids_jni_tpu_torch.ops.window import Window

    QTY, PRICE, SHIP, OKEY, SKEY, F64, D128 = 0, 1, 6, 7, 8, 9, 11
    n = host["n"]
    idx = np.arange(n, dtype=np.int32)
    laps, t_lap = [], [time.perf_counter()]

    def lap(step):
        t = time.perf_counter()
        laps.append(f"{step} {t - t_lap[0]:.1f}")
        t_lap[0] = t

    w, s = _sync_s(lambda: Window(tab, [SKEY], [SHIP]))
    out["supplier_window_s"] = s
    o, ks, pstarts, psize, p_start, p_end, peer_start, peer_end = \
        host["sorts"]["supplier"].result()
    host["supp_ship_sorted"] = ks
    o_dev = torch.from_numpy(o).to(dev)
    log(f"window by l_suppkey: {psize.size} partitions, sorted in "
        f"{s:.3f} s on the card")
    lap("oracle sort")

    def S(col):
        """A result column in the oracle's sort order."""
        return Column(col.dtype, take(col.data, o_dev),
                      None if col.validity is None else col.validity[o_dev])

    every = np.ones(n, bool)
    size = p_end - p_start + 1
    rank = peer_start - p_start + 1
    peer_new = np.empty(n, bool)
    peer_new[0] = True
    np.not_equal(ks[1:], ks[:-1], out=peer_new[1:])
    dcum = np.cumsum(peer_new, dtype=np.int32)
    pos = idx - p_start
    q4, r4 = size // 4, size % 4
    big4 = r4 * (q4 + 1)
    tile = np.where(pos < big4, pos // np.maximum(q4 + 1, 1),
                    r4 + (pos - big4) // np.maximum(q4, 1)) + 1
    ints = {
        "row_number": (w.row_number, pos + 1),
        "rank": (w.rank, rank),
        "dense_rank": (w.dense_rank, dcum - dcum[p_start] + 1),
        "ntile_4": (lambda: w.ntile(4), tile),
    }
    for name, (fn, want) in ints.items():
        _equal_under(name, S(fn()), want, every)
    _equal_under("percent_rank", S(w.percent_rank()),
                 (rank - 1).astype(np.float64)
                 / np.maximum(size - 1, 1).astype(np.float64), every)
    _equal_under("cume_dist", S(w.cume_dist()),
                 (peer_end - p_start + 1).astype(np.float64)
                 / size.astype(np.float64), every)
    lap("rank family")
    price = host["price"][o]
    _equal_under("lag", S(w.lag(PRICE)), np.roll(price, 1),
                 idx - 1 >= p_start)
    _equal_under("lead", S(w.lead(PRICE)), np.roll(price, -1),
                 idx + 1 <= p_end)
    qv = host["qty_v"][o]
    qsrc = host["qty"][o]
    qpre, cpre = _np_prefix(np.where(qv, qsrc, 0)), _np_prefix(qv)
    got, s = _sync_s(lambda: w.running_sum(QTY))
    _equal_under("running_sum", S(got), qpre[idx + 1] - qpre[p_start],
                 cpre[idx + 1] - cpre[p_start] > 0)
    out["running_sum_s"] = s
    lap("lag, lead, running sum")
    # ROWS BETWEEN 6 PRECEDING AND CURRENT ROW
    lo = np.maximum(idx - 6, p_start)
    ppre = _np_prefix(price)
    psum = ppre[idx + 1] - ppre[lo]
    got, s = _sync_s(lambda: w.rolling_sum(PRICE, 6))
    _equal_under("rolling_sum", S(got), psum, every)
    out["rolling_sum_s"] = s
    absp = _np_prefix(np.abs(price))
    scale = (absp[idx + 1] - absp[p_start]).astype(np.float64) * 0.01
    want = psum.astype(np.float64) / (idx - lo + 1).astype(np.float64) * 0.01
    out["rolling_mean_max_err"] = _near_under(
        "rolling_mean", S(w.rolling_mean(PRICE, 6)), want, every,
        1e-12 * scale)
    qcnt = cpre[idx + 1] - cpre[lo]
    _equal_under("rolling_min", S(w.rolling_min(QTY, 6)), _np_range_reduce(
        np.minimum, np.where(qv, qsrc, 1 << 62), lo, idx, 1 << 62),
        qcnt > 0)
    _equal_under("rolling_max", S(w.rolling_max(QTY, 6)), _np_range_reduce(
        np.maximum, np.where(qv, qsrc, -(1 << 62)), lo, idx, -(1 << 62)),
        qcnt > 0)
    lap("ROWS frames")
    # RANGE BETWEEN 30 PRECEDING AND CURRENT ROW on l_shipdate (peers in)
    rlo = np.searchsorted(ks, ks - 30, side="left")
    rhi = peer_end  # the frame's end is the last row of the same day
    got, s = _sync_s(lambda: w.rolling_sum(QTY, 30, 0, "range"))
    _equal_under("range_sum", S(got), qpre[rhi + 1] - qpre[rlo],
                 cpre[rhi + 1] - cpre[rlo] > 0)
    out["range_sum_s"] = s
    got, s = _sync_s(lambda: w.rolling_max(PRICE, 30, 0, "range"))
    _equal_under("range_max", S(got), _np_range_reduce(
        np.maximum, price, rlo, rhi, 0), every)
    out["range_max_s"] = s
    out["range_widest"] = int((rhi - rlo + 1).max())
    del rlo
    lap("RANGE frames")
    # DECIMAL128 rolling sum (l_extendedprice x 10^20, negated rows)
    spre = _np_prefix(np.where(host["neg"][o], -price, price))
    lo_l, hi_l = _np_times_1e20(spre[idx + 1] - spre[lo])
    got = S(w.rolling_sum(D128, 6))
    require(bool(got.valid_mask().all()), "rolling_sum128: a null frame")
    g = _h(got.data)
    require(np.array_equal(g[:, 0], lo_l) and np.array_equal(g[:, 1], hi_l),
            "rolling_sum128 differs from the exact sums")
    del spre, lo_l, hi_l, g
    lap("DECIMAL128 sum")
    # rolling var of the FLOAT64 price over the same frames: a two-pass
    # numpy variance per frame; like the reference, a NaN row makes its
    # whole partition's variances NaN (they centre on the partition mean)
    f = host["f64"][o]
    fz = np.where(np.isnan(f), 0.0, f)
    fpre = np.concatenate([[0.0], np.cumsum(fz)])
    cnt = (idx - lo + 1).astype(np.float64)
    mean = (fpre[idx + 1] - fpre[lo]) / cnt
    ss = (fz - mean) ** 2
    for k in range(1, 7):  # the row k back, where the frame holds it
        d = np.zeros(n)
        d[k:] = (fz[:-k] - mean[k:]) ** 2
        ss += np.where(idx - k >= lo, d, 0.0)
    want = ss / np.maximum(cnt - 1, 1)
    pnan = np.add.reduceat(np.isnan(f).astype(np.int64), pstarts)
    want[np.repeat(pnan > 0, psize)] = np.nan
    sq = np.concatenate([[0.0], np.cumsum(fz * fz)])
    out["rolling_var_max_err"] = _near_under(
        "rolling_var", S(w.rolling_var(F64, 6)), want, cnt > 1,
        1e-12 * (sq[p_end + 1] - sq[p_start]))
    out["rolling_var_nan_partitions"] = int((pnan > 0).sum())
    del ss, d, mean, fz, fpre, sq
    lap("rolling var")
    _equal_under("first_value", S(w.first_value(PRICE)), price[p_start],
                 every)
    _equal_under("last_value", S(w.last_value(PRICE)), price[peer_end],
                 every)
    _equal_under("nth_value", S(w.nth_value(PRICE, 2)),
                 price[np.minimum(p_start + 1, n - 1)],
                 p_start + 1 <= peer_end)
    del w, o_dev
    torch.cuda.empty_cache()

    lap("first/last/nth")
    # the float functions on the card bit-equal to the CPU's, 1M rows
    k = min(WINDOW_CPU_SLICE, n)
    head = trim_table(tab, k)
    head_cpu = Table([Column(c.dtype, c.data.cpu(), None if c.validity is
                             None else c.validity.cpu())
                      for c in head.columns])
    wg, wc = Window(head, [SKEY], [SHIP]), Window(head_cpu, [SKEY], [SHIP])
    for name, call in (("percent_rank", lambda x: x.percent_rank()),
                       ("cume_dist", lambda x: x.cume_dist()),
                       ("rolling_mean", lambda x: x.rolling_mean(PRICE, 6)),
                       ("rolling_var", lambda x: x.rolling_var(F64, 6)),
                       ("running_sum_f64", lambda x: x.running_sum(F64)),
                       ("rolling_sum_f64", lambda x: x.rolling_sum(F64, 6))):
        a, b = call(wg), call(wc)
        require(torch.equal(_bits(a.data.cpu()), _bits(b.data))
                and torch.equal(a.valid_mask().cpu(), b.valid_mask()),
                f"{name}: the card's bits differ from the CPU's")
    del wg, wc, head, head_cpu
    lap("CPU slice")
    log(f"window by l_suppkey: 22 functions equal to numpy over {n} rows "
        f"(rolling mean within {out['rolling_mean_max_err']:.3g}, var "
        f"within {out['rolling_var_max_err']:.3g}; {int((pnan > 0).sum())}"
        f" partitions with a NaN price); 6 float functions bit-equal to "
        f"the CPU over {k} rows")

    # PARTITION BY l_orderkey ORDER BY l_shipdate: many tiny partitions
    w2, s = _sync_s(lambda: Window(tab, [OKEY], [SHIP]))
    out["order_window_s"] = s
    o2, _, _, psize2, p_start2, _, _, _ = host["sorts"]["order"].result()
    o_dev = torch.from_numpy(o2).to(dev)
    r, s = _sync_s(w2.row_number)
    _equal_under("row_number (orders)", S(r), idx - p_start2 + 1, every)
    out["order_row_number_s"] = s
    pre2 = _np_prefix(host["price"][o2])
    got, s = _sync_s(lambda: w2.running_sum(PRICE))
    _equal_under("running_sum (orders)", S(got),
                 pre2[idx + 1] - pre2[p_start2], every)
    out["order_running_sum_s"] = s
    log(f"window by l_orderkey: {psize2.size} partitions of "
        f"{int(psize2.min())}-{int(psize2.max())} rows, row_number and "
        f"running_sum equal to numpy")
    del w2, o_dev
    lap("order window")
    log("window part steps (s): " + ", ".join(laps))
    # row_number, held equal to numpy just above, feeds sequence(1, r)
    return {"row_number": r, "rn_host": _h(r.data)}


def _pair_order(host, okey_order):
    """The orders' (group, l_suppkey) pairs in l_orderkey order and the
    stable permutation sorting them (the sort_array and array_distinct
    oracles)."""
    import numpy as np

    o1 = okey_order.result()
    starts, counts, _, _ = _np_segments(host["okey"][o1])
    gid = np.repeat(np.arange(starts.size, dtype=np.int64), counts)
    pair = (gid << 17) | host["skey"][o1]
    return pair, _radix_order(pair, 41)


def _bits(x):
    return x.view(torch.int64) if x.dtype == torch.float64 else x


def _list_part(tab, host, dev, rn, out) -> None:
    """collect_list / collect_set, the array functions over them,
    explode and posexplode, the padded layout, sequence(1, r) and split
    + posexplode of the log lines, against numpy."""
    import numpy as np

    from spark_rapids_jni_tpu_torch.columnar import Column, Table
    from spark_rapids_jni_tpu_torch.models import bench_strings as bs
    from spark_rapids_jni_tpu_torch.ops import lists as ls
    from spark_rapids_jni_tpu_torch.ops import strings_fns as sf
    from spark_rapids_jni_tpu_torch.ops.table_ops import trim_table
    from spark_rapids_jni_tpu_torch.types import INT64

    SHIP, OKEY, SKEY = 6, 7, 8
    n = host["n"]
    okey, skey = host["okey"], host["skey"]
    laps, t_lap = [], [time.perf_counter()]

    def lap(step):
        t = time.perf_counter()
        laps.append(f"{step} {t - t_lap[0]:.1f}")
        t_lap[0] = t
    res, s = _sync_s(lambda: ls.groupby_collect(
        Table([tab.column(OKEY), tab.column(SKEY)]), [0], 1))
    out["collect_list_s"] = s
    g = int(res.num_groups)
    o1 = host["sorts"]["okey"].result()
    starts, counts, _, _ = _np_segments(okey[o1])
    child = skey[o1]
    require(g == starts.size, "collect_list: group count")
    coll = trim_table(res.table, g)
    L1 = coll.column(1)
    offs = _np_prefix(counts)
    require(np.array_equal(_h(coll.column(0).data), okey[o1][starts])
            and np.array_equal(_h(L1.data), offs)
            and np.array_equal(_h(L1.children[0].data)[:n], child),
            "collect_list differs from the key-sorted rows")
    log(f"collect_list(l_suppkey) by l_orderkey: {g} lists of "
        f"{int(counts.min())}-{int(counts.max())} in {s:.3f} s, equal to "
        f"numpy")
    lap("collect_list")
    every = np.ones(g, bool)
    gid = np.repeat(np.arange(g), counts)
    pos_in = np.arange(n) - np.repeat(starts, counts)
    _equal_under("array_size", ls.array_size(L1), counts, every)
    v = int(skey[12345 % n])
    hits = child == v
    _equal_under("array_contains", ls.array_contains(L1, v),
                 np.add.reduceat(hits.astype(np.int64), starts) > 0, every)
    _equal_under("element_at 1", ls.element_at(L1, 1), child[starts], every)
    _equal_under("element_at -1", ls.element_at(L1, -1),
                 child[starts + counts - 1], every)
    _equal_under("array_position", ls.array_position(L1, v), np.where(
        np.add.reduceat(hits.astype(np.int64), starts) > 0,
        np.minimum.reduceat(np.where(hits, pos_in, n), starts) + 1, 0),
        every)
    _equal_under("array_sum", ls.array_sum(L1),
                 np.add.reduceat(child, starts), every)
    _equal_under("array_min", ls.array_min(L1),
                 np.minimum.reduceat(child, starts), every)
    _equal_under("array_max", ls.array_max(L1),
                 np.maximum.reduceat(child, starts), every)
    lap("size, contains, element_at, position, sum, min, max")
    pair, sp = host["sorts"]["pair"].result()
    srt = ls.sort_array(L1)
    require(np.array_equal(_h(srt.children[0].data)[:n], child[sp]),
            "sort_array differs from numpy")
    first = np.ones(n, bool)
    first[1:] = pair[sp][1:] != pair[sp][:-1]
    keep = np.zeros(n, bool)
    keep[sp[first]] = True
    dist = ls.array_distinct(L1)
    require(np.array_equal(_h(dist.data), _np_prefix(
        np.add.reduceat(keep.astype(np.int64), starts)))
        and np.array_equal(_h(dist.children[0].data)[:int(keep.sum())],
                           child[keep]), "array_distinct differs from numpy")
    sl = ls.array_slice(L1, 2, 3)
    take = (pos_in >= 1) & (pos_in < 4)
    require(np.array_equal(_h(sl.data), _np_prefix(
        np.clip(counts - 1, 0, 3)))
        and np.array_equal(_h(sl.children[0].data)[:int(take.sum())],
                           child[take]), "array_slice differs from numpy")
    lap("sort_array, array_distinct, array_slice")
    # arrays_overlap with the lists of l_suppkey + 1: a row overlaps when
    # some s + 1 of the order is also in it
    plus = ls.groupby_collect(Table([tab.column(OKEY), Column(
        INT64, tab.column(SKEY).data + 1)]), [0], 1)
    L2 = trim_table(plus.table, g).column(1)
    uniq = pair[sp][first]
    probe = (gid.astype(np.int64) << 17) | (child + 1)
    at = np.minimum(np.searchsorted(uniq, probe), uniq.size - 1)
    _equal_under("arrays_overlap", ls.arrays_overlap(L1, L2),
                 np.add.reduceat((uniq[at] == probe).astype(np.int64),
                                 starts) > 0, every)
    del plus, L2, srt, dist
    lap("arrays_overlap")
    # explode: the (l_orderkey, l_suppkey) pairs in key-sorted stable order
    keys_col = coll.column(0)
    ex, s = _sync_s(lambda: ls.explode(coll, 1))
    out["explode_s"] = s
    require(int(ex.num_rows) == n and bool(ex.row_valid.all())
            and np.array_equal(_h(ex.table.column(0).data), okey[o1])
            and np.array_equal(_h(ex.table.column(1).data), child),
            "explode differs from the key-sorted pairs")
    pe = ls.explode(coll, 1, position=True)
    require(np.array_equal(_h(pe.table.column(1).data), pos_in),
            "posexplode positions differ")
    del ex, pe
    # explode_outer of the lists from the 5th element: empty lists give
    # one row with a null element
    tail = ls.array_slice(L1, 5, 3)
    eo = ls.explode(Table([keys_col, tail]), 1, outer=True)
    tl = np.clip(counts - 4, 0, 3)
    rows = np.maximum(tl, 1)
    total = int(rows.sum())
    ev = _hv(eo.table.column(1))[:total]
    want_v = np.repeat(tl > 0, rows)
    sel = (pos_in >= 4) & (pos_in < 7)
    require(int(eo.num_rows) == total and np.array_equal(ev, want_v)
            and np.array_equal(_h(eo.table.column(1).data)[:total][ev],
                               child[sel])
            and np.array_equal(_h(eo.table.column(0).data)[:total],
                               np.repeat(okey[o1][starts], rows)),
            "explode_outer differs from numpy")
    del eo, tail
    lap("explode, posexplode, explode_outer")
    # the padded wire layout and back, at the longest list's length
    width = ls.max_list_length(L1)
    require(width == int(counts.max()), "max_list_length")
    padded, s = _sync_s(lambda: ls.pad_lists(L1, width))
    back = ls.unpad_lists(padded)
    require(padded.is_padded_list and np.array_equal(_h(back.data), offs)
            and np.array_equal(_h(back.children[0].data)[:n], child),
            "pad_lists / unpad_lists round trip differs")
    out["pad_lists_s"] = s
    del padded, back, coll, res, L1
    torch.cuda.empty_cache()
    log(f"array functions over the {g} lists equal to numpy; explode "
        f"{n} rows in {out['explode_s']:.3f} s, posexplode, explode_outer "
        f"({total} rows), pad/unpad at L = {width}")

    lap("pad/unpad")
    # collect_set of l_shipdate by l_suppkey
    res, s = _sync_s(lambda: ls.groupby_collect(
        Table([tab.column(SKEY), tab.column(SHIP)]), [0], 1, distinct=True))
    out["collect_set_s"] = s
    ks = host["supp_ship_sorted"]  # the window oracle's sorted keys
    u = ks[np.append(True, ks[1:] != ks[:-1])]
    g2 = int(res.num_groups)
    sets = trim_table(res.table, g2).column(1)
    require(g2 == np.unique(skey).size
            and np.array_equal(_h(sets.data), _np_prefix(
                np.bincount(u >> 14)[np.unique(skey)]))
            and np.array_equal(_h(sets.children[0].data)[:u.size],
                               u & 0x3FFF),
            "collect_set differs from numpy's unique pairs")
    log(f"collect_set(l_shipdate) by l_suppkey: {g2} sets, {u.size} "
        f"values in {s:.3f} s, equal to numpy")
    del res, sets

    lap("collect_set")
    # sequence(1, r), r the order window's row_number
    r = rn["row_number"]
    ones = Column(INT64, torch.ones_like(r.data))
    seq, s = _sync_s(lambda: ls.sequence(ones, r, max_length=SEQ_MAX))
    out["sequence_s"] = s
    rh = rn["rn_host"]
    soff = _np_prefix(rh)
    total = int(soff[-1])
    require(np.array_equal(_h(seq.data), soff)
            and seq.children[0].size == total
            and np.array_equal(_h(seq.children[0].data),
                               np.arange(total) - np.repeat(soff[:-1], rh)
                               + 1), "sequence differs from numpy")
    out["sequence_elements"] = total
    log(f"sequence(1, row_number): {total} elements in {s:.3f} s, equal "
        f"to numpy")
    del seq, ones

    lap("sequence")
    # split on ' ' into at most 5 pieces, then posexplode
    lines, words = bs.log_lines(n, seed=12)
    sp_res = sf.split(lines, " ", max_pieces=5)
    ex, s = _sync_s(lambda: ls.explode(Table([sp_res.column]), 0,
                                       position=True))
    out["split_posexplode_s"] = s
    del sp_res
    torch.cuda.empty_cache()
    wt = np.ascontiguousarray(_h(words).T)  # (n, MAX_WORDS), -1 past
    live = wt >= 0                           # the words
    nwords = live.sum(1)
    pieces = int(nwords.sum())
    wstart = _np_prefix(nwords)
    rowid = np.arange(n, dtype=np.int32)
    ndig = np.ones(n, np.int16)
    for p in range(1, len(str(max(n - 1, 0)))):
        ndig += rowid >= 10 ** p
    wlen = np.array([len(x) for x in bs.LOG_WORDS], np.int16)
    slen = wlen[np.maximum(wt, 0)] + (wt == bs.ID_WORD) * ndig[:, None]
    require(int(ex.num_rows) == pieces and bool(ex.row_valid.all())
            and np.array_equal(_h(ex.table.column(0).data), np.arange(
                pieces, dtype=np.int32) - np.repeat(
                    wstart[:-1].astype(np.int32), nwords))
            and np.array_equal(_h(ex.table.column(1).data), slen[live]),
            "posexplode(split) differs from the word indices")
    del wt, live, slen, rowid
    rows = _sample_rows(n, SPLIT_SAMPLE, 21)
    wstart = _np_prefix(nwords)
    flat = np.concatenate([np.arange(wstart[i], wstart[i + 1])
                           for i in rows])
    got = _sampled_bytes(ex.table.column(1), flat)
    want = [x.encode() for v in _sampled_bytes(lines, rows)
            for x in v.decode().split(" ")]
    require(got == want, "posexplode(split) differs from str.split")
    log(f"split + posexplode: {pieces} rows in {s:.3f} s, positions and "
        f"lengths equal to the word indices, {len(rows)} sampled rows' "
        f"pieces equal to str.split")
    out["split_pieces"] = pieces
    del ex, lines, words
    lap("split + posexplode")
    log("list part steps (s): " + ", ".join(laps))


def _struct_part(tab, host, dev, out) -> None:
    """make_struct_column, struct_field, unpack_struct and the general
    groupby over the fields, concatenate and contiguous_split with the
    STRUCT, and a Parquet STRUCT file read back."""
    import numpy as np

    import chip_smoke_writers as w
    from spark_rapids_jni_tpu_torch.columnar import Table
    from spark_rapids_jni_tpu_torch.ops import structs as st
    from spark_rapids_jni_tpu_torch.ops import table_ops
    from spark_rapids_jni_tpu_torch.ops.groupby import groupby_aggregate
    from spark_rapids_jni_tpu_torch.parquet.reader import read_table

    QTY, PRICE, DISC, TAX, RFLAG, LSTAT, OKEY = 0, 1, 2, 3, 4, 5, 7
    n = host["n"]
    sv = np.arange(n) % 13 != 0
    sv_dev = torch.from_numpy(sv).to(dev)
    fields = [tab.column(i) for i in (QTY, PRICE, DISC, TAX)]
    s_col = st.make_struct_column(fields, sv_dev)
    fh = [(host["qty"], host["qty_v"]), (host["price"], np.ones(n, bool)),
          (host["disc"], np.ones(n, bool)), (host["tax"], np.ones(n, bool))]
    for i, (d, v) in enumerate(fh):
        _equal_under(f"struct_field {i}", st.struct_field(s_col, i), d,
                     v & sv)
    un = st.unpack_struct(Table([tab.column(RFLAG), tab.column(LSTAT),
                                 s_col]), 2)
    aggs = [(2, "sum"), (3, "sum"), (4, "sum"), (5, "sum"), (2, "count"),
            (3, "count")]
    res, s = _sync_s(lambda: groupby_aggregate(un, [0, 1], aggs,
                                               max_groups=16))
    out["struct_groupby_s"] = s
    tb = res.compact()
    # each row's group: its (flag, status) code, nulls first, through a
    # lookup table of the present codes (no sort)
    rk = np.where(host["rflag_v"], host["rflag"].astype(np.int64) + 129, 0)
    lk = np.where(host["lstat_v"], host["lstat"].astype(np.int64) + 129, 0)
    code = rk * 512 + lk
    codes = np.flatnonzero(np.bincount(code, minlength=512 * 512))
    remap = np.zeros(512 * 512, np.int64)
    remap[codes] = np.arange(codes.size)
    inv = remap[code]
    require(tb.num_rows == codes.size, "struct groupby: group count")
    for j, (ci, op) in enumerate(aggs):
        d, v = fh[ci - 2]
        vv = v & sv
        if op == "sum":
            want = np.bincount(inv, np.where(vv, d, 0),
                               codes.size).astype(np.int64)
        else:
            want = np.bincount(inv, vv, codes.size).astype(np.int64)
        require(np.array_equal(_h(tb.column(2 + j).data), want),
                f"struct groupby {op} of field {ci - 2} differs")
    log(f"STRUCT of 4 fields (every 13th null): struct_field, unpack_struct "
        f"and the groupby by (l_returnflag, l_linestatus), {codes.size} "
        f"groups, equal to numpy")
    # concatenate and contiguous_split of a table holding the STRUCT
    t2 = Table([tab.column(OKEY), s_col])
    cat, s = _sync_s(lambda: table_ops.concatenate([t2, t2]))
    out["struct_concatenate_s"] = s
    cs = cat.column(1)
    require(cs.size == 2 * n and torch.equal(cs.validity,
                                             torch.cat([sv_dev, sv_dev]))
            and all(torch.equal(cs.children[i].data[n:], fields[i].data)
                    and torch.equal(cs.children[i].valid_mask()[:n],
                                    fields[i].valid_mask())
                    for i in range(4)), "concatenate of the STRUCT differs")
    del cat, cs
    cuts = [n // 3, 2 * n // 3]
    pieces = table_ops.contiguous_split(t2, cuts)
    bounds = [0] + cuts + [n]
    require(all(p.column(1).size == b - a and torch.equal(
        p.column(1).children[1].data, fields[1].data[a:b])
        and torch.equal(p.column(1).validity, sv_dev[a:b])
        for p, a, b in zip(pieces, bounds, bounds[1:])),
        "contiguous_split of the STRUCT differs")
    del pieces
    # Parquet: l_orderkey and the STRUCT (an OPTIONAL group of OPTIONAL
    # leaves, definition levels 0/1/2)
    DATA_DIR.mkdir(parents=True, exist_ok=True)
    path = DATA_DIR / "lineitem_struct.parquet"
    t0 = time.perf_counter()
    size = w.write_parquet(path, [
        w.ParquetColumn("l_orderkey", host["okey"], w.INT64),
        w.ParquetGroup("amounts", [
            w.ParquetColumn(name, d, w.INT64, w.CONV_DECIMAL, scale=2,
                            precision=18, valid=v)
            for name, (d, v) in zip(("l_quantity", "l_extendedprice",
                                     "l_discount", "l_tax"), fh)], sv)],
        PARQUET_RG_ROWS, PARQUET_PAGE_ROWS)
    out["struct_parquet_write_s"] = time.perf_counter() - t0
    tm = {}
    got, s = _sync_s(lambda: read_table(str(path), device=dev, timings=tm))
    path.unlink()
    gs = got.column(1)
    require(torch.equal(got.column(0).data, tab.column(OKEY).data)
            and torch.equal(gs.validity, sv_dev)
            and all(torch.equal(gs.children[i].valid_mask(),
                                s_col.children[i].valid_mask() & sv_dev)
                    and torch.equal(torch.where(
                        gs.children[i].valid_mask(), gs.children[i].data, 0),
                        torch.where(gs.children[i].valid_mask(),
                                    fields[i].data, 0))
                    and gs.children[i].dtype == fields[i].dtype
                    for i in range(4)),
            "the Parquet STRUCT read differs from the columns")
    out["struct_parquet"] = {"bytes": size, "read_s": s, **tm}
    log(f"Parquet STRUCT file ({size / 1e9:.2f} GB, written in "
        f"{out['struct_parquet_write_s']:.1f} s): read_table {s:.3f} s = "
        f"native decode {tm['decode_s']:.3f} + nested copy-out "
        f"{tm['copy_out_s']:.3f} + assembly and staging "
        f"{tm['assemble_s']:.3f}; equal to the columns under validity")


def operators_phase(dev) -> dict:
    """Phase 17: the remaining operators over an eighth of SF10 lineitem
    (``OPERATORS_ROWS``, 7,498,256 rows of
    ``tpch.lineitem_groupby_table``, the SF10 widths): elementwise,
    window, lists and STRUCT, each against numpy, none launching a
    kernel of A-D."""
    import concurrent.futures

    import numpy as np

    from spark_rapids_jni_tpu_torch.models import tpch

    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    tab, neg = tpch.lineitem_groupby_table(OPERATORS_ROWS, Q3_ORDERS,
                                           SUPPLIERS)
    col = tab.column
    host = {"n": OPERATORS_ROWS, "qty": _h(col(0).data),
            "qty_v": _hv(col(0)),
            "price": _h(col(1).data), "disc": _h(col(2).data),
            "tax": _h(col(3).data), "rflag": _h(col(4).data),
            "rflag_v": _hv(col(4)), "lstat": _h(col(5).data),
            "lstat_v": _hv(col(5)), "ship": _h(col(6).data).astype(np.int64),
            "okey": _h(col(7).data), "skey": _h(col(8).data),
            "f64": _h(col(9).data), "neg": _h(neg)}
    log(f"phase 17 table: {OPERATORS_ROWS} rows on the card and the host "
        f"in {time.perf_counter() - t_phase:.1f} s")
    # the oracles' three radix sorts run on host threads (numpy's sorts
    # and gathers let go of the GIL) while the parts before them work
    pool = concurrent.futures.ThreadPoolExecutor(4)
    okey_order = pool.submit(_radix_order, host["okey"], 24)
    host["sorts"] = {
        "supplier": pool.submit(_window_oracle, host, host["skey"], 17),
        "order": pool.submit(_window_oracle, host, host["okey"], 24),
        "okey": okey_order,
        "pair": pool.submit(_pair_order, host, okey_order)}
    parts, out = {}, {}
    p = _Part("elementwise", parts)
    _elementwise_part(tab, neg, host, dev, out)
    p.done()
    p = _Part("window", parts)
    rn = _window_part(tab, host, dev, out)
    p.done()
    p = _Part("lists", parts)
    _list_part(tab, host, dev, rn, out)
    p.done()
    del rn
    torch.cuda.empty_cache()
    p = _Part("struct", parts)
    _struct_part(tab, host, dev, out)
    p.done()
    pool.shutdown()
    peak = torch.cuda.max_memory_allocated() / 2**30
    total = time.perf_counter() - t_phase
    log(f"phase 17 (remaining operators): {total:.1f} s, device peak "
        f"{peak:.2f} GiB; parts " + ", ".join(
            f"{k} {v:.1f} s" for k, v in parts.items()))
    del tab
    torch.cuda.empty_cache()
    return {"s": total, "peak_gib": peak, "parts_s": parts, **out}


OOC_BUDGET = 1 << 30             # the out-of-core runs' device budget
OOC_SPILL_BUDGET = 16 * 2**20    # q3: ~10 MB partials (~358,000 groups)
OOC_RECOVERY_SPILL = 1024        # q1's partials spill, so one can corrupt
LADDER_CHUNK_ROWS = 8_388_608    # degrade.chunk_rows: 8 chunks of SF10
RTF_MAX_BUILD_ROWS = 2_097_152   # rtfilter.max_build_rows at SF10


def _q1_rows(what: str, got, want) -> None:
    """``got``'s first six rows (the real q1 groups) equal ``want``'s bit
    for bit: types, data and validity."""
    require(got.num_columns == want.num_columns, f"{what}: column count")
    for i, (a, b) in enumerate(zip(got.columns, want.columns)):
        require(a.dtype == b.dtype and torch.equal(a.data[:6], b.data[:6])
                and torch.equal(a.valid_mask()[:6], b.valid_mask()[:6]),
                f"{what} column {i} differs from the in-memory q1")


def _q3_arrays(table) -> list:
    """The valid q3 groups of a result as host arrays (orderkey,
    orderdate, shippriority, revenue), in the table's order."""
    keep = table.column(0).valid_mask()
    return [c.data[keep].cpu().numpy() for c in table.columns]


def _ooc_run(what: str, fn, limiter, profiled: bool = True) -> tuple:
    """One out-of-core run timed on the host clock with the counts reset
    just before it: no kernel of A-D launched, the limiter's peak within
    its budget and nothing left reserved. Its result, seconds, the device
    peak beside what was allocated before the run, and the pipeline's
    counters; with ``profiled``, a run under ``torch.profiler`` first
    gives the card's busy share and is the timed run's warm-up (the
    profiler's host overhead stays out of the seconds)."""
    from spark_rapids_jni_tpu_torch import telemetry

    busy = {"busy_share": None, "busy_ms": None, "profiled_s": None}
    if profiled:
        share, busy_ms, wall_ms = _busy_share(
            lambda: _launched_only(f"{what}, profiled", fn, {}))
        require(limiter.used == 0,
                f"{what}, profiled: {limiter.used} bytes left reserved")
        busy = {"busy_share": share, "busy_ms": busy_ms,
                "profiled_s": wall_ms / 1e3}
    telemetry.reset()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    res = _launched_only(what, fn, {})
    s = time.perf_counter() - t0
    require(limiter.peak <= limiter.budget,
            f"{what}: limiter peak {limiter.peak} over {limiter.budget}")
    require(limiter.used == 0, f"{what}: {limiter.used} bytes left reserved")
    counters = {k: telemetry.counter(f"pipeline.{k}") for k in (
        "chunks", "decode_us", "transfer_us", "producer_stall_us",
        "consumer_stall_us")}
    return res, {"s": s, "chunks": res.chunks, "limiter_peak": limiter.peak,
                 "device_peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                 "resident_before_gib": resident / 2**30,
                 "spill": res.spill_stats, "pipeline": counters, **busy}


def _busy_text(row) -> str:
    """The profiled run's part of a log line."""
    if row["busy_share"] is None:
        return "not profiled"
    return (f"profiled run {row['profiled_s']:.3f} s, busy "
            f"{row['busy_share']:.4f}")


def _ooc_q1_part(path, q1_oracle, q1_general) -> dict:
    """Out-of-core q1 over the SF10 Parquet file: serial, pipelined on 2
    and on 8 decode threads, then a corrupt checkpoint and a transient
    decode fault, each equal to the in-memory q1 and the numpy oracle."""
    from spark_rapids_jni_tpu_torch import telemetry
    from spark_rapids_jni_tpu_torch.models import tpch
    from spark_rapids_jni_tpu_torch.runtime import faults, resilience
    from spark_rapids_jni_tpu_torch.runtime.memory import MemoryLimiter
    from spark_rapids_jni_tpu_torch.utils import config

    def check(what, res):
        _q1_rows(what, res.table, q1_general)
        host = [c.data[:6].cpu().numpy() for c in res.table.columns]
        names = ["sum_qty", "sum_base_price", "sum_disc_price",
                 "sum_charge", "avg_qty", "avg_price", "avg_disc", "count"]
        for g in range(6):
            key = (int(host[0][g]), int(host[1][g]))
            for j, name in enumerate(names):
                got, want = host[2 + j][g], q1_oracle[key][name]
                require(abs(got - want) <= 1e-12 * abs(want)
                        if name.startswith("avg") else int(got) == want,
                        f"{what} {key} {name}: {got} vs {want}")

    out = {}
    # (name, decode threads, queue depth (0: serial), injection); the
    # queue bounds the chunks decoding at once, so 8 threads get depth 8
    runs = (("serial", 2, 0, {}),
            ("pipelined, 2 decode threads", 2, 2, {}),
            ("pipelined, 8 decode threads", 8, 8, {}),
            ("corrupt checkpoint replayed", 8, 8, {
                "corrupt": faults.CorruptionSpec(
                    "integrity.checkpoint", "flip", seq=3, seed=1)}),
            ("transient decode fault resumed", 8, 8, {
                "fault": faults.FaultSpec(
                    "pipeline.decode", resilience.TransientDeviceError(
                        "injected transient decode fault"), seq=4)}))
    try:
        for what, threads, depth, inject in runs:
            config.set_option("pipeline.decode_threads", threads)
            limiter = MemoryLimiter(OOC_BUDGET)
            script = faults.FaultScript(
                [inject["fault"]] if "fault" in inject else [],
                corruptions=[inject["corrupt"]] if "corrupt" in inject
                else [])
            recovery = bool(inject)

            def run():
                with faults.inject(script):
                    return tpch.tpch_q1_outofcore(
                        path, budget_bytes=OOC_BUDGET,
                        chunk_read_limit=CHUNK_READ_LIMIT,
                        spill_budget_bytes=OOC_RECOVERY_SPILL if recovery
                        else None, prefetch_depth=depth,
                        pipeline=depth > 0, limiter=limiter)

            # one profiled run: the 8-thread one's (the others' were cut
            # for the script's time when phase 21 came)
            res, row = _ooc_run(f"out-of-core q1 ({what})", run, limiter,
                                profiled=what.endswith("8 decode threads"))
            check(f"out-of-core q1 ({what})", res)
            if recovery:
                kind = "integrity" if "corrupt" in inject else "resilience"
                events = [e["event"] for e in telemetry.events(kind)]
                require(len(script.fired) == 1 and "recovered" in events,
                        f"out-of-core q1 ({what}): fired {script.fired}, "
                        f"{kind} events {events}")
                row["events"] = events
            row["rows_per_s"] = ROWS / row["s"]
            out[what] = row
            p = row["pipeline"]
            log(f"out-of-core q1 ({what}): {row['s']:.3f} s, "
                f"{row['rows_per_s']:.4g} rows/s, {res.chunks} chunks, "
                f"limiter peak {limiter.peak} of {OOC_BUDGET}, device peak "
                f"{row['device_peak_gib']:.2f} GiB "
                f"({row['resident_before_gib']:.2f} before), "
                f"{_busy_text(row)}; "
                f"decode {p['decode_us'] / 1e6:.3f} "
                f"s, transfer {p['transfer_us'] / 1e6:.3f} s, stalls "
                f"producer {p['producer_stall_us'] / 1e6:.3f} / consumer "
                f"{p['consumer_stall_us'] / 1e6:.3f} s; spills "
                f"{res.spill_stats['spills']}; equal to the in-memory q1 and "
                f"the oracle; no launch" + (f"; {row['events']}"
                                            if recovery else ""))
    finally:
        config.reset_option("pipeline.decode_threads")
    return out


def _ooc_q3_part(dev, path, q3_oracle) -> dict:
    """Out-of-core q3 over the SF10 q3 lineitem file, customer and orders
    resident, partials under a 16 MiB spill budget: the host tier, the
    codec (and zstd where installed) and a disk tier, each equal to
    ``tpch_q3`` in memory and the numpy oracle (``q3_oracle``, phase
    6's); one spill's drop of ``torch.cuda.memory_allocated``; then the
    runtime filter's pruned runs (:func:`_pruned_q3_runs`)."""
    import numpy as np

    from spark_rapids_jni_tpu_torch.columnar import Column, Table
    from spark_rapids_jni_tpu_torch.models import tpch
    from spark_rapids_jni_tpu_torch.runtime import compress
    from spark_rapids_jni_tpu_torch.runtime.memory import (
        MemoryLimiter,
        SpillStore,
        table_nbytes,
    )
    from spark_rapids_jni_tpu_torch.utils import config

    customer, orders, li3 = q3_tables()
    want = _q3_arrays(tpch.tpch_q3(customer, orders, li3).result.compact())
    del li3
    torch.cuda.empty_cache()

    # one spill, measured: the allocator gets the table's blocks back
    big = Table([Column.from_numpy(np.arange(2**25, dtype=np.int64),
                                   device=dev)])
    nb = table_nbytes(big)
    store = SpillStore(nb)
    h = store.put(big)
    del big
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    store.spill(h)
    torch.cuda.synchronize()
    after = torch.cuda.memory_allocated()
    require(after <= before - nb, f"a spill of {nb} bytes lowered "
            f"memory_allocated by {before - after} only")
    require(store.get(h).column(0).data[-1].item() == 2**25 - 1,
            "the unspilled table differs")
    store.close()
    out = {"spill_drop": {"bytes": nb, "allocated_before": before,
                          "allocated_after": after}}
    log(f"one spill of {nb} bytes: memory_allocated {before} -> {after}")

    zstd = compress.zstd_available()
    if not zstd:
        try:
            SpillStore(1, compress_spill=True)
        except ModuleNotFoundError:
            pass
        else:
            require(False, "compress_spill without zstandard did not raise")
    o = q3_oracle
    wanted = [o["orderkey"], o["orderdate"], o["shippriority"], o["revenue"]]
    torch.cuda.empty_cache()
    spill_dir = DATA_DIR / "spill"
    runs = (("host tier", {}, {"compress.spill": False}),
            ("codec" + (" + zstd" if zstd else " (no zstandard here)"),
             {"compress_spill": zstd}, {}),
            ("disk tier", {"spill_dir": str(spill_dir)}, {}))
    try:
        config.set_option("pipeline.decode_threads", 8)
        for what, kw, options in runs:
            for k, v in options.items():
                config.set_option(k, v)
            limiter = MemoryLimiter(OOC_BUDGET)
            try:
                res, row = _ooc_run(
                    f"out-of-core q3 ({what})",
                    lambda: tpch.tpch_q3_outofcore(
                        path, customer, orders, budget_bytes=OOC_BUDGET,
                        chunk_read_limit=CHUNK_READ_LIMIT, pipeline=True,
                        prefetch_depth=8, spill_budget_bytes=OOC_SPILL_BUDGET,
                        limiter=limiter, **kw), limiter,
                    profiled=what == "host tier")
            finally:
                for k in options:
                    config.reset_option(k)
            got = _q3_arrays(res.table)
            for i, name in enumerate(("orderkey", "orderdate",
                                      "shippriority", "revenue")):
                require(np.array_equal(got[i], want[i]),
                        f"out-of-core q3 ({what}) {name} differs from "
                        f"tpch_q3")
                require(np.array_equal(got[i], wanted[i]),
                        f"out-of-core q3 ({what}) {name} differs from the "
                        f"oracle")
            st = res.spill_stats
            require(st["spills"] > 0, f"out-of-core q3 ({what}) never spilled")
            row["rows_per_s"] = ROWS / row["s"]
            out[what] = row
            log(f"out-of-core q3 ({what}): {row['s']:.3f} s, {res.chunks} "
                f"chunks, {len(got[0])} groups, limiter peak {limiter.peak} "
                f"of {OOC_BUDGET}, device peak {row['device_peak_gib']:.2f} "
                f"GiB ({row['resident_before_gib']:.2f} before), "
                f"{_busy_text(row)}; spills {st['spills']}, "
                f"unspills {st['unspills']}, {st['spilled_bytes']} bytes out; "
                f"equal to tpch_q3 and the oracle; no launch")
        require(not any(spill_dir.iterdir()), "spill files left behind")
    finally:
        config.reset_option("pipeline.decode_threads")
    out["pruned"] = _pruned_q3_runs(path, customer, orders, want, wanted,
                                    out["host tier"])
    return out


def _rtfilter_events(op: str) -> tuple:
    """The ``apply`` reasons and the summed rows in and rows passed of
    the runtime filter's records of ``op`` (a plan/join signature)."""
    from spark_rapids_jni_tpu_torch import telemetry

    recs = [e for e in telemetry.events("rtfilter") if e["op"] == op]
    seen = [e for e in recs if e["event"] == "observed"]
    return ([e["reason"] for e in recs if e["event"] == "apply"],
            sum(e["rows_in"] for e in seen),
            sum(e["rows_pass"] for e in seen))


def _pruned_q3_runs(path, customer, orders, want, wanted, unpruned) -> dict:
    """``tpch_q3_outofcore`` with the runtime filter on, twice, as the
    host tier's run: the first decides ``no_history_optimistic``, the
    second ``selective`` from the first's observed pass fraction; each
    equal to ``tpch_q3`` and the oracle, none launching A-D, its rows in
    and pruned and its limiter peak beside the unpruned run's. The SF10
    build side (about 966,000 qualifying orders) is over the default
    ``rtfilter.max_build_rows``, which is raised for these runs."""
    import numpy as np

    from spark_rapids_jni_tpu_torch import telemetry
    from spark_rapids_jni_tpu_torch.models import tpch
    from spark_rapids_jni_tpu_torch.runtime.memory import MemoryLimiter
    from spark_rapids_jni_tpu_torch.utils import config

    options = {"rtfilter.enabled": True,
               "rtfilter.max_build_rows": RTF_MAX_BUILD_ROWS,
               "compress.spill": False, "pipeline.decode_threads": 8}
    out = {}
    try:
        for k, v in options.items():
            config.set_option(k, v)
        for run, reason in enumerate(("no_history_optimistic",
                                      "selective"), 1):
            what = f"pruned out-of-core q3 (run {run})"
            limiter = MemoryLimiter(OOC_BUDGET)
            res, row = _ooc_run(what, lambda: tpch.tpch_q3_outofcore(
                path, customer, orders, budget_bytes=OOC_BUDGET,
                chunk_read_limit=CHUNK_READ_LIMIT, pipeline=True,
                prefetch_depth=8, spill_budget_bytes=OOC_SPILL_BUDGET,
                limiter=limiter), limiter, profiled=False)
            reasons, rows_in, rows_pass = _rtfilter_events(
                "tpch_q3_outofcore/pk2")
            require(reasons == [reason], f"{what}: decided {reasons}")
            require(rows_in == ROWS and 0 < rows_pass < rows_in,
                    f"{what}: {rows_pass} of {rows_in} rows passed")
            got = _q3_arrays(res.table)
            for i in range(4):
                require(np.array_equal(got[i], want[i])
                        and np.array_equal(got[i], wanted[i]),
                        f"{what}: column {i} differs from tpch_q3 or the "
                        f"oracle")
            prunes = telemetry.REGISTRY.histogram("rtfilter.prune_us")
            row.update(rows_in=rows_in, rows_pruned=rows_in - rows_pass,
                       reason=reason, unpruned_limiter_peak=unpruned[
                           "limiter_peak"], unpruned_s=unpruned["s"],
                       prunes=prunes.count, prune_s=prunes.sum / 1e6)
            out[f"run {run}"] = row
            log(f"{what}: {row['s']:.3f} s, decision {reason}, "
                f"{rows_in} rows in, {rows_in - rows_pass} pruned "
                f"({(rows_in - rows_pass) / rows_in:.4f}) by "
                f"{prunes.count} prunes taking {row['prune_s']:.3f} s of "
                f"host time (summed over the decode threads), limiter peak "
                f"{limiter.peak} (unpruned {unpruned['limiter_peak']}), "
                f"device peak {row['device_peak_gib']:.2f} GiB; equal to "
                f"tpch_q3 and the oracle; no launch")
    finally:
        for k in options:
            config.reset_option(k)
    return out


def _ladder_part(dev, q1_general) -> tuple:
    """The degradation ladder over planned q1 of SF10 lineitem in memory:
    without a fault the "fused" tier (kernel A once); then a real
    ``torch.OutOfMemoryError`` at ``fusion.region`` steps it to
    "outofcore" (8 chunks, no launch), with the same rows."""
    from spark_rapids_jni_tpu_torch import telemetry
    from spark_rapids_jni_tpu_torch.models import tpch
    from spark_rapids_jni_tpu_torch.ops.kernels import groupby_accumulate as kga
    from spark_rapids_jni_tpu_torch.runtime import degrade, faults, resilience
    from spark_rapids_jni_tpu_torch.runtime.memory import MemoryLimiter
    from spark_rapids_jni_tpu_torch.utils import config

    li = tpch.lineitem_table(ROWS, seed=0)
    limiter = MemoryLimiter(OOC_BUDGET)
    partial_fn, merge_fn = tpch.q1_row_chunked_fns()
    chunk_rows = []

    def counted(chunk):
        chunk_rows.append(chunk.num_rows)
        return partial_fn(chunk)

    query = degrade.DegradableQuery(
        tpch._q1_planned_plan(), {"lineitem": li},
        outofcore=degrade.row_chunked_tier({"lineitem": li}, "lineitem",
                                           counted, merge_fn,
                                           limiter=limiter))
    ctrl = degrade.DegradationController(limiter)
    config.set_option("degrade.chunk_rows", LADDER_CHUNK_ROWS)
    out = {}
    try:
        telemetry.reset()
        t0 = time.perf_counter()
        fused = _launched_only("ladder, no fault", lambda: ctrl.execute(query),
                               {kga.NAME: 1})
        out["fused_s"] = time.perf_counter() - t0
        _q1_rows("ladder fused tier", fused.table, q1_general)
        require(not telemetry.events("degrade"), "the ladder stepped "
                "without a fault")
        ooms = []

        def oom():
            total = torch.cuda.get_device_properties(dev).total_memory
            try:
                torch.empty(2 * total, dtype=torch.uint8, device=dev)
            except torch.OutOfMemoryError as exc:
                ooms.append(exc)
                raise
            raise AssertionError("allocated twice the card's memory")

        script = faults.FaultScript([faults.FaultSpec("fusion.region", oom)])
        t0 = time.perf_counter()
        with faults.inject(script):
            stepped = _launched_only("ladder after an out-of-memory error",
                                     lambda: ctrl.execute(query), {})
        out["outofcore_s"] = time.perf_counter() - t0
        torch.cuda.empty_cache()
        require(len(ooms) == 1 and resilience.classify(ooms[0])
                is resilience.ResourceExhausted,
                f"the card's out-of-memory error classified as "
                f"{[resilience.classify(e).__name__ for e in ooms]}")
        steps = [(e["event"], e["tier"], e["trigger"], e["rung"])
                 for e in telemetry.events("degrade")]
        require(steps == [("step", "outofcore", "ResourceExhausted", 2),
                          ("completed", "outofcore", "ResourceExhausted", 2)]
                and telemetry.counter("degrade.step") == 1,
                f"ladder events {steps}")
        n_chunks = -(-ROWS // LADDER_CHUNK_ROWS)
        require(len(chunk_rows) == n_chunks and stepped.meta == {
            "degrade.chunk_rows": LADDER_CHUNK_ROWS},
            f"out-of-core tier ran {len(chunk_rows)} chunks, {stepped.meta}")
        _q1_rows("ladder out-of-core tier", stepped.table, q1_general)
        require(limiter.used == 0, f"ladder left {limiter.used} reserved")
        out.update(steps=steps, chunks=len(chunk_rows),
                   oom=str(ooms[0]).split("\n")[0][:160])
        log(f"degradation ladder over planned q1: fused tier "
            f"{out['fused_s']:.3f} s (A once); torch.OutOfMemoryError -> "
            f"ResourceExhausted -> outofcore ({n_chunks} chunks of "
            f"{LADDER_CHUNK_ROWS} rows, no launch) {out['outofcore_s']:.3f} "
            f"s; events {steps}; same rows")
    finally:
        config.reset_option("degrade.chunk_rows")
        del li, query
        torch.cuda.empty_cache()
    return {"degradation ladder, fused tier": {"A": 1, "D": 0}}, out


def _write_q3_parquet(path) -> tuple:
    """q3's SF10 lineitem (its generator's seed, on the host) written to
    ``path``: l_orderkey, l_extendedprice and l_discount as INT64,
    l_shipdate as INT32/DATE with a dictionary; (size, seconds)."""
    from spark_rapids_jni_tpu_torch.models import tpch

    import chip_smoke_writers as w

    t0 = time.perf_counter()
    gen = tpch.lineitem_q3_table(ROWS, Q3_ORDERS, device="cpu")
    host = [c.data.numpy() for c in gen.columns]
    size = w.write_parquet(path, [
        w.ParquetColumn("l_orderkey", host[0], w.INT64),
        w.ParquetColumn("l_extendedprice", host[1], w.INT64),
        w.ParquetColumn("l_discount", host[2], w.INT64),
        w.ParquetColumn("l_shipdate", host[3], w.INT32, w.CONV_DATE,
                        dictionary=True)], PARQUET_RG_ROWS,
        PARQUET_PAGE_ROWS)
    return size, time.perf_counter() - t0


def memory_outofcore_phase(dev, q1_oracle, q1_general, q3_oracle) -> tuple:
    """Phase 18: memory and out-of-core at SF10: out-of-core q1 and q3
    over Parquet under a 1 GiB device budget (q3 also pruned by the
    runtime filter), and the degradation ladder over planned q1; every
    result against the in-memory plan and its numpy oracle."""
    import concurrent.futures
    import shutil

    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    out = {}
    shutil.rmtree(DATA_DIR, ignore_errors=True)
    DATA_DIR.mkdir(parents=True)
    try:
        # q3's file is written on a thread beside q1's (host work only),
        # and joined before any timed run
        pool = concurrent.futures.ThreadPoolExecutor(1)
        q3_path = DATA_DIR / "lineitem_q3.parquet"
        q3_write = pool.submit(_write_q3_parquet, q3_path)
        t0 = time.perf_counter()
        q1_path = DATA_DIR / "lineitem.parquet"
        _, size = _write_q1_parquet(q1_path, ROWS)
        out["q1_file"] = {"bytes": size, "write_s": time.perf_counter() - t0}
        q3_size, q3_s = q3_write.result()
        pool.shutdown()
        out["q3_file"] = {"bytes": q3_size, "write_s": q3_s}
        log(f"phase 18 files: q1 {ROWS} rows, {size} bytes written in "
            f"{out['q1_file']['write_s']:.1f} s; q3 {ROWS} rows, {q3_size} "
            f"bytes in {q3_s:.1f} s beside it; "
            f"{time.perf_counter() - t0:.1f} s together")
        out["q1"] = _ooc_q1_part(q1_path, q1_oracle, q1_general)
        q1_path.unlink()
        out["q3"] = _ooc_q3_part(dev, q3_path, q3_oracle)
    finally:
        shutil.rmtree(DATA_DIR, ignore_errors=True)
    launches, out["ladder"] = _ladder_part(dev, q1_general)
    out["s"] = time.perf_counter() - t_phase
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    log(f"phase 18 (memory and out-of-core): {out['s']:.1f} s, device peak "
        f"{out['peak_gib']:.2f} GiB")
    return launches, out


SERVE_BUDGET = 16 << 30        # phase 19's logical device budget
SERVE_CACHE_BYTES = 1 << 30    # cache.max_bytes: the etl prefix, ~0.84 GB
SERVE_WAIT_S = 600             # seconds a served query may take
ETL_SHIP_FROM = 9131           # 1995-01-01: the etl plans' date filter
Q3_SPLIT = (Q3_CUSTOMERS, Q3_ORDERS, SF10_ROWS)  # SF10's q3 proportions


def _etl_shipped_since(tab, day):
    """The etl plans' Filter: shipped on or after ``day``."""
    from spark_rapids_jni_tpu_torch.models import tpch

    return tab.column(tpch.L_SHIPDATE).data >= day


def _etl_revenue(tab):
    """The etl plans' rowwise Project: [l_shipdate, price * (100 -
    discount)], the revenue valid where both inputs are."""
    from spark_rapids_jni_tpu_torch import types as t
    from spark_rapids_jni_tpu_torch.columnar import Column, Table
    from spark_rapids_jni_tpu_torch.models import tpch

    price = tab.column(tpch.L_EXTENDEDPRICE)
    disc = tab.column(tpch.L_DISCOUNT)
    return Table([tab.column(tpch.L_SHIPDATE),
                  Column(t.decimal64(-4), price.data * (100 - disc.data),
                         price.valid_mask() & disc.valid_mask())])


def _etl_total(tab, row_valid):
    """Plan A's tail: the filtered revenue's sum and row count."""
    from spark_rapids_jni_tpu_torch import types as t
    from spark_rapids_jni_tpu_torch.columnar import Column, Table

    rev = tab.column(1)
    m = rev.valid_mask()
    return Table([Column(rev.dtype, torch.where(m, rev.data, 0).sum()
                         .reshape(1)),
                  Column(t.INT64, m.sum().reshape(1))])


def _etl_plans():
    """Two plans over lineitem sharing the prefix Filter(shipped since
    1995) -> Project(revenue): A totals it, B groups it by ship day."""
    from spark_rapids_jni_tpu_torch.runtime import fusion

    prefix = fusion.Project(fusion.Filter(
        fusion.Scan("lineitem"), _etl_shipped_since, (ETL_SHIP_FROM,)),
        _etl_revenue)
    return (fusion.Plan("etl_revenue_total", fusion.Project(
        prefix, _etl_total, rowwise=False)),
        fusion.Plan("etl_revenue_by_day", fusion.GroupBy(
            prefix, (0,), ((1, "sum"),), max_groups=4096, label="by_day")))


def _etl_oracle(li) -> dict:
    """The etl plans on the host: the total, the row count and the sums
    by ship day (exact: a day's sum stays far below 2^53)."""
    import numpy as np

    from spark_rapids_jni_tpu_torch.models import tpch

    def host(i):
        c = li.column(i)
        return c.data.cpu().numpy(), c.valid_mask().cpu().numpy()

    (ship, sv), (price, pv), (disc, dv) = (
        host(tpch.L_SHIPDATE), host(tpch.L_EXTENDEDPRICE),
        host(tpch.L_DISCOUNT))
    sel = sv & (ship >= ETL_SHIP_FROM) & pv & dv
    rev = price[sel] * (100 - disc[sel])
    days = ship[sel].astype(np.int64)
    lo = int(days.min())
    sums = np.bincount(days - lo, weights=rev.astype(np.float64))
    keep = np.bincount(days - lo) > 0
    return {"total": int(rev.sum()), "count": int(sel.sum()),
            "days": np.flatnonzero(keep) + lo,
            "by_day": sums[keep].astype(np.int64)}


def _q3_warmup(rows: int) -> None:
    """Warm-up builder of q3 (the script's: a multi-table plan has no
    builder of its own): ``rows`` total rows split in SF10's
    proportions."""
    from spark_rapids_jni_tpu_torch.models import tpch

    c, o, n = (max(1, rows * k // sum(Q3_SPLIT)) for k in Q3_SPLIT)
    tpch.tpch_q3(tpch.customer_table(c), tpch.orders_table(o, c),
                 tpch.lineitem_q3_table(n, o))


def _client(session, queries, out: dict, errors: list) -> None:
    """One session's client: submits its queries one after another,
    each after the previous one's result."""
    try:
        for what, plan, bindings, kw in queries:
            ticket = session.submit(plan, bindings, **kw)
            out[what] = (ticket, ticket.result(timeout=SERVE_WAIT_S))
    except BaseException as exc:  # re-raised on the main thread
        errors.append(exc)


def _served_traffic(li, q3b, tmp) -> tuple:
    """The three sessions through one ``QueryServer`` (two in flight, the
    runtime filter on): the launches, each query's (ticket, result), the
    traffic, the server's stats and per-session numbers, the span
    records and the traffic's seconds."""
    import threading

    from spark_rapids_jni_tpu_torch.models import tpch
    from spark_rapids_jni_tpu_torch.ops import kernels
    from spark_rapids_jni_tpu_torch.ops.kernels import (
        groupby_accumulate as kga,
        hash_probe as khp,
    )
    from spark_rapids_jni_tpu_torch.runtime import fusion, server
    from spark_rapids_jni_tpu_torch.telemetry import report

    etl_a, etl_b = _etl_plans()
    q6 = fusion.Plan("tpch_q6", fusion.Project(
        fusion.Scan("lineitem"), tpch._q6_reduce, rowwise=False))
    lb = {"lineitem": li}
    q3fp = {"cache_fingerprint": "tpch-sf10-q3-default-seeds"}
    traffic = {
        "dashboard": [("planned q1", tpch._q1_planned_plan(), lb, {}),
                      ("q6", q6, lb, {}),
                      ("planned q1 again", tpch._q1_planned_plan(), lb, {})],
        "analyst": [("q3", tpch._q3_plan(0, tpch._Q3_CUTOFF_DAYS, 2), q3b,
                     q3fp),
                    ("planned q3", tpch._q3_planned_plan(
                        0, tpch._Q3_CUTOFF_DAYS), q3b, q3fp)],
        "etl": [("q1", tpch._q1_plan(), lb, {}),
                ("etl total", etl_a, lb, {}),
                ("etl by day", etl_b, lb, {})]}
    served, errors = {}, []
    srv = server.QueryServer(budget_bytes=SERVE_BUDGET, max_inflight=2)
    try:
        sessions = {sid: srv.session(sid) for sid in traffic}
        kernels.reset_counts()
        t0 = time.perf_counter()
        threads = [threading.Thread(target=_client, args=(
            sessions[sid], qs, served, errors)) for sid, qs in traffic.items()]
        for th in threads:
            th.start()
        for th in threads:
            th.join(SERVE_WAIT_S)
        torch.cuda.synchronize()
        traffic_s = time.perf_counter() - t0
        if errors:
            raise errors[0]
        require(not any(th.is_alive() for th in threads),
                "a session's client did not finish")
        launches = {"A": kernels.launches(kga.NAME),
                    "D": kernels.launches(khp.NAME)}
        require(launches == {"A": 1, "D": 2},
                f"the served traffic launched {kernels.launches()}")
        require(not kernels.fallbacks(),
                f"the served traffic fell back: {kernels.fallbacks()}")
        stats = srv.stats()
        per_session = {sid: srv.session_stats(sid) for sid in traffic}
    finally:
        srv.close()
    require(srv.limiter.used == 0,
            f"{srv.limiter.used} bytes reserved after close()")
    records = report.load_jsonl(str(tmp / "run.jsonl"))
    return launches, served, traffic, stats, per_session, records, \
        traffic_s


def _check_served(served, traffic, li, q3b, q1_oracle, q1_general,
                  q3_oracle) -> dict:
    """Every served result against ``fusion.execute`` of its plan with no
    server, bit for bit, and against its numpy oracle."""
    import numpy as np

    from spark_rapids_jni_tpu_torch.models import tpch
    from spark_rapids_jni_tpu_torch.ops.groupby import GroupByResult
    from spark_rapids_jni_tpu_torch.runtime import fusion

    plans = {what: (plan, b) for qs in traffic.values()
             for what, plan, b, _ in qs}
    etl = _etl_oracle(li)
    q6 = tpch.tpch_q6_oracle(li)
    out = {}
    for what, (ticket, res) in served.items():
        plan, b = plans[what]
        direct = fusion.execute(plan, b)
        _same_tables(f"served {what}", res.table, direct.table)
        tab = res.table
        if what in ("planned q1", "planned q1 again", "q1"):
            _q1_rows(f"served {what}", tab, q1_general)
            host = [c.data[:6].cpu().numpy() for c in tab.columns]
            for g in range(6):
                key = (int(host[0][g]), int(host[1][g]))
                require(int(host[9][g]) == q1_oracle[key]["count"]
                        and int(host[2][g]) == q1_oracle[key]["sum_qty"],
                        f"served {what} group {key} differs from the oracle")
        elif what == "q6":
            require(int(tab.column(0).data[0]) == q6,
                    f"served q6 differs from the oracle {q6}")
        elif what in ("q3", "planned q3"):
            g = GroupByResult(tab, res.meta["groupby.num_groups"]).compact()
            got = _q3_arrays(g)
            for i, name in enumerate(("orderkey", "orderdate",
                                      "shippriority", "revenue")):
                require(np.array_equal(got[i], q3_oracle[name]),
                        f"served {what} {name} differs from the oracle")
        elif what == "etl total":
            require(int(tab.column(0).data[0]) == etl["total"]
                    and int(tab.column(1).data[0]) == etl["count"],
                    "served etl total differs from the oracle")
        else:  # etl by day
            k = int(res.meta["by_day.num_groups"])
            keys = tab.column(0)
            kv = keys.valid_mask()[:k].cpu().numpy()
            days = keys.data[:k].cpu().numpy()[kv]
            sums = tab.column(1).data[:k].cpu().numpy()[kv]
            require(np.array_equal(days, etl["days"])
                    and np.array_equal(sums, etl["by_day"]),
                    "served etl by day differs from the oracle")
        out[what] = {"latency_s": ticket.latency_s,
                     "queue_wait_s": ticket.queue_wait_s}
        del direct
    return out


def _refusals(li) -> dict:
    """On a second server with one worker: an estimate over the whole
    budget rejected; a deadline that expires behind a blocked worker,
    cancelled; planned q1 with a real out-of-memory error at the
    ``fusion.region`` seam stepped to the out-of-core tier, the same
    rows. ``limiter.used`` is 0 after ``close()``."""
    import threading

    from spark_rapids_jni_tpu_torch import telemetry
    from spark_rapids_jni_tpu_torch.models import tpch
    from spark_rapids_jni_tpu_torch.ops import kernels
    from spark_rapids_jni_tpu_torch.runtime import (
        degrade,
        faults,
        fusion,
        resilience,
        server,
    )
    from spark_rapids_jni_tpu_torch.utils import config

    q1p = tpch._q1_planned_plan()
    q6 = fusion.Plan("tpch_q6", fusion.Project(
        fusion.Scan("lineitem"), tpch._q6_reduce, rowwise=False))
    lb = {"lineitem": li}
    release, entered = threading.Event(), threading.Event()

    def block(seam, seq, ctx):
        if seam == "server.execute" and ctx["session"] == "blocker":
            entered.set()
            release.wait(SERVE_WAIT_S)

    out = {}
    dev = li.columns[0].device
    srv = server.QueryServer(budget_bytes=SERVE_BUDGET, max_inflight=1)
    try:
        big = srv.session("adhoc").submit(q6, lb,
                                          estimate_bytes=SERVE_BUDGET + 1)
        try:
            big.result(timeout=SERVE_WAIT_S)
            require(False, "an estimate over the budget was served")
        except server.QueryRejected as exc:
            require(exc.retry_after_s is None and big.status == "rejected",
                    f"rejection {exc.reason!r}")
            out["rejected"] = exc.reason
        with faults.inject(block):
            blocker = srv.session("blocker").submit(q1p, lb)
            require(entered.wait(SERVE_WAIT_S), "the blocker never ran")
            late = srv.session("late").submit(q6, lb, deadline_ms=100)
            time.sleep(0.5)
            release.set()
            try:
                late.result(timeout=SERVE_WAIT_S)
                require(False, "the expired query was served")
            except resilience.QueryCancelled as exc:
                require(late.status == "cancelled", late.status)
                out["cancelled"] = str(exc)
            blocker.result(timeout=SERVE_WAIT_S)

        def oom():
            total = torch.cuda.get_device_properties(dev).total_memory
            torch.empty(2 * total, dtype=torch.uint8, device=dev)
            raise AssertionError("allocated twice the card's memory")

        partial_fn, merge_fn = tpch.q1_row_chunked_fns()
        steps = telemetry.counter("degrade.step")
        config.set_option("cache.enabled", False)
        config.set_option("degrade.chunk_rows", LADDER_CHUNK_ROWS)
        script = faults.FaultScript([faults.FaultSpec("fusion.region", oom)])
        try:
            with faults.inject(script):
                kernels.reset_counts()
                ladder = srv.session("ladder").submit(
                    q1p, lb, outofcore=lambda b, lim:
                    degrade.row_chunked_tier(b, "lineitem", partial_fn,
                                             merge_fn, limiter=lim))
                res = ladder.result(timeout=SERVE_WAIT_S)
                torch.cuda.synchronize()
        finally:
            config.reset_option("cache.enabled")
            config.reset_option("degrade.chunk_rows")
        torch.cuda.empty_cache()
        require(script.fired and res.meta == {
            "degrade.chunk_rows": LADDER_CHUNK_ROWS},
            f"ladder: fired {script.fired}, meta {res.meta}")
        require(telemetry.counter("degrade.step") - steps == 1,
                "the ladder did not step exactly once")
        got = _launches_but_e("served ladder, out-of-core tier")
        require(not any(got.values()),
                f"the out-of-core tier launched {got}")
        _q1_rows("served ladder", res.table, fusion.execute(q1p, lb).table)
        out["ladder_s"] = ladder.latency_s
    finally:
        release.set()
        srv.close()
    require(srv.limiter.used == 0,
            f"{srv.limiter.used} bytes reserved after close()")
    return out


def serving_phase(dev, q1_oracle, q1_general, q3_oracle) -> tuple:
    """Phase 19: the serving stack at SF10. Three sessions through one
    ``QueryServer`` over resident SF10 lineitem and q3's tables, a result
    cache hit and a subplan hit, A once and D twice; three classified
    refusals; a second server's warm-up from the first's learned
    estimates."""
    import shutil

    from spark_rapids_jni_tpu_torch import telemetry
    from spark_rapids_jni_tpu_torch.models import tpch
    from spark_rapids_jni_tpu_torch.runtime import server
    from spark_rapids_jni_tpu_torch.telemetry import spans
    from spark_rapids_jni_tpu_torch.utils import config

    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    tmp = DATA_DIR / "serving"
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir(parents=True)
    options = {"telemetry.enabled": True,
               "telemetry.path": str(tmp / "run.jsonl"),
               "server.estimate_path": str(tmp / "learned.json"),
               "rtfilter.max_build_rows": RTF_MAX_BUILD_ROWS,
               "cache.max_bytes": SERVE_CACHE_BYTES}
    out = {}
    try:
        for k, v in options.items():
            config.set_option(k, v)
        li = tpch.lineitem_table(ROWS, seed=0)
        customer, orders, li3 = q3_tables()
        q3b = {"customer": customer, "orders": orders, "lineitem": li3}
        config.set_option("rtfilter.enabled", True)
        try:
            (launches, served, traffic, stats, per_session, records,
             traffic_s) = _served_traffic(li, q3b, tmp)
        finally:
            config.reset_option("rtfilter.enabled")
        # cache.hit counts every hit, the subplan's included (as the
        # reference's ResultCache.get does): one whole-query hit
        subplan_hits = telemetry.counter("cache.subplan_hit")
        require(stats["cache"]["hits"] - subplan_hits == 1
                and subplan_hits == 1, f"cache {stats['cache']}")
        require(served["planned q1 again"][0].queue_wait_s == 0.0,
                "the cached query waited")
        require(max(t.queue_wait_s for t, _ in served.values()) > 0,
                "no query waited for admission")
        reasons, rows_in, rows_pass = _rtfilter_events("tpch_q3/join1")
        require(reasons == ["no_history_optimistic"]
                and 0 < rows_pass < rows_in,
                f"q3's join 1 filter: {reasons}, {rows_pass}/{rows_in}")
        problems = spans.validate(records)
        require(not problems, f"span trees: {problems[:5]}")
        trace = spans.chrome_trace(records)
        n_spans = sum(1 for e in trace["traceEvents"] if e["ph"] == "X")
        queries = _check_served(served, traffic, li, q3b, q1_oracle,
                                q1_general, q3_oracle)
        for what, q in queries.items():
            log(f"served {what}: latency {q['latency_s'] * 1e3:.3f} ms, "
                f"queue wait {q['queue_wait_s'] * 1e3:.3f} ms; equal to "
                f"fusion.execute and the oracle")
        for sid, st in per_session.items():
            log(f"session {sid}: latency p50 {st['latency_ms_p50']:.3f} / "
                f"p95 {st['latency_ms_p95']:.3f} ms, queue wait p50 "
                f"{st['queue_wait_ms_p50']:.3f} / p95 "
                f"{st['queue_wait_ms_p95']:.3f} ms (histogram estimates)")
        log(f"served traffic: {traffic_s:.3f} s for 8 queries, launches "
            f"{launches}; q3 join 1 filter: {rows_in} rows in, "
            f"{rows_in - rows_pass} pruned; cache.hit "
            f"{stats['cache']['hits']} (1 whole query, {subplan_hits} "
            f"subplan); {len(records)} records, "
            f"{n_spans} spans, trees valid; stats {json.dumps(stats)}")
        out.update(traffic_s=traffic_s, launches=launches, queries=queries,
                   sessions=per_session, stats=stats, spans=n_spans,
                   rtfilter={"rows_in": rows_in,
                             "rows_pruned": rows_in - rows_pass})
        del served, q3b, customer, orders, li3
        torch.cuda.empty_cache()
        out["refusals"] = _refusals(li)
        log(f"refusals: rejected ({out['refusals']['rejected']}); "
            f"cancelled ({out['refusals']['cancelled'][:80]}); ladder "
            f"stepped to outofcore in {out['refusals']['ladder_s']:.3f} s, "
            f"same rows")
        del li
        torch.cuda.empty_cache()

        server.register_warmup_builder("tpch_q3", _q3_warmup)
        learned = json.loads((tmp / "learned.json").read_text())
        top = max(learned.items(), key=lambda kv: kv[1])
        with server.QueryServer(budget_bytes=SERVE_BUDGET) as srv:
            t0 = time.perf_counter()
            summary = srv.warmup(top_n=1)
            torch.cuda.synchronize()
        require(summary["compiled"] == 1, f"warm-up {summary}")
        out["warmup"] = {**summary, "signature": top[0],
                         "s": time.perf_counter() - t0}
        log(f"warm-up from the first server's learned estimates: "
            f"{summary}, top signature {top[0]} ({top[1]:.4g} bytes), "
            f"{out['warmup']['s']:.3f} s")
    finally:
        for k in options:
            config.reset_option(k)
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    out["s"] = time.perf_counter() - t_phase
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    log(f"phase 19 (serving): {out['s']:.1f} s, device peak "
        f"{out['peak_gib']:.2f} GiB")
    return {"served traffic (phase 19)": launches}, out


# ---- phase 20: multiple executors (parallel/) -------------------------------

MESH_EXECUTORS = 4           # executors, spread round-robin over the cards
# the distributed q72/q64 partial groups an executor may shuffle: every
# item and the null group (the plans' default, 4,096, is the reference's,
# sized for 1,000 items)
DS_GROUP_BUDGET = DS_ITEMS + 1
PG_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_pg"


def _executor_mesh():
    from spark_rapids_jni_tpu_torch.parallel import executor_mesh

    count = torch.cuda.device_count()
    devices = [torch.device("cuda", e % count) for e in range(MESH_EXECUTORS)]
    log(f"executor mesh: {MESH_EXECUTORS} executors on "
        f"{[str(d) for d in devices]} (torch.cuda.device_count() = {count})")
    return executor_mesh(MESH_EXECUTORS, devices)


def _key_rows(table, keys):
    """The rows of ``table`` whose key columns are all valid, sorted by
    those keys (stable)."""
    from spark_rapids_jni_tpu_torch.ops.sort import gather, sort_order

    keep = table.column(keys[0]).valid_mask()
    for k in keys[1:]:
        keep = keep & table.column(k).valid_mask()
    kept = gather(table, torch.nonzero(keep).flatten())
    return gather(kept, sort_order(kept, keys))


def _require_same_groups(name: str, got, want, keys, float_cols=()) -> int:
    """Two results hold the same groups: their valid-key rows, sorted by
    the keys, equal column for column (validity, and data where valid;
    STRING columns by row bytes; ``float_cols`` to 1e-12 relative, NaN
    equal). Returns the group count."""
    got, want = _key_rows(got, keys), _key_rows(want, keys)
    require(got.num_rows == want.num_rows,
            f"{name}: {got.num_rows} groups, single device {want.num_rows}")
    for i, (a, b) in enumerate(zip(got.columns, want.columns)):
        if i not in float_cols:
            # null-aware: validity, then data where valid (NaN == NaN)
            require(a.equals(b), f"{name} column {i} differs")
            continue
        va, vb = a.valid_mask(), b.valid_mask()
        require(torch.equal(va, vb), f"{name} column {i}: validity")
        x, y = a.data[va], b.data[vb]
        nan = torch.isnan(y)
        require(torch.equal(torch.isnan(x), nan)
                and bool(((x[~nan] - y[~nan]).abs()
                          <= 1e-12 * y[~nan].abs()).all()),
                f"{name} column {i}: floats differ")
    return got.num_rows


class _PlanRecorder:
    """Runs one distributed plan: launches of A and D set to 0 just
    before it and read just after (exactly ``want``, no fallback), the
    shuffle's wire bytes and the device peak of the run; then the host
    median of 3 runs of it and of its single-device twin."""

    def __init__(self):
        self.launches, self.rows, self.peak = {}, {}, 0.0

    def run(self, name: str, fn, want: dict, single):
        from spark_rapids_jni_tpu_torch import telemetry

        torch.cuda.reset_peak_memory_stats()
        wire0 = telemetry.counter("shuffle.wire_bytes")
        res, self.launches[name] = _run_plan(name, fn, want)
        wire = telemetry.counter("shuffle.wire_bytes") - wire0
        peak = torch.cuda.max_memory_allocated() / 2**30
        self.peak = max(self.peak, peak)
        twin = single()
        torch.cuda.synchronize()
        return res, twin, {"launches": self.launches[name],
                           "wire_bytes": wire, "peak_gib": peak}

    def time(self, name: str, fn, single, row: dict) -> None:
        row["s"] = host_median_s(fn, warm=False)
        row["single_s"] = host_median_s(single, warm=False)
        self.rows[name] = row
        log(f"{name}: {row['s'] * 1e3:.3f} ms over {MESH_EXECUTORS} "
            f"executors (single device {row['single_s'] * 1e3:.3f} ms), "
            f"shuffle_wire_bytes {row['wire_bytes']}, launches "
            f"{row['launches']}, device peak {row['peak_gib']:.2f} GiB")


def _nccl_q1(li, dev) -> dict:
    """A one-rank NCCL world runs distributed q1 through the
    process-group transport; equal to the local mesh's result."""
    import datetime
    import shutil

    import torch.distributed as tdist

    from spark_rapids_jni_tpu_torch.models import tpch
    from spark_rapids_jni_tpu_torch.parallel import executor_mesh

    shutil.rmtree(PG_DIR, ignore_errors=True)
    PG_DIR.mkdir(parents=True)
    t0 = time.perf_counter()
    tdist.init_process_group(
        "nccl", init_method=f"file://{PG_DIR / 'pg'}", rank=0,
        world_size=1, timeout=datetime.timedelta(seconds=120))
    try:
        nccl = executor_mesh(devices=[dev], group=tdist.group.WORLD)
        got, s = _sync_s(lambda: tpch.tpch_q1_distributed(li, nccl))
        want = tpch.tpch_q1_distributed(li, executor_mesh(1, [dev]))
        require(got.equals(want), "NCCL q1 differs from the local mesh")
    finally:
        tdist.destroy_process_group()
        shutil.rmtree(PG_DIR, ignore_errors=True)
    log(f"one-rank NCCL world: distributed q1 through the process group "
        f"{s * 1e3:.3f} ms, equal to the local mesh's; group destroyed "
        f"({time.perf_counter() - t0:.1f} s with init)")
    return {"s": s}


def _distributed_plans(mesh, dev, rec: _PlanRecorder) -> dict:
    """The eight distributed plans at SF10, each equal to its
    single-device plan on the card."""
    from spark_rapids_jni_tpu_torch.models import tpcds, tpch

    out = {}
    li = tpch.lineitem_table(ROWS, seed=0)
    fn = lambda: tpch.tpch_q1_distributed(li, mesh)  # noqa: E731
    single = lambda: tpch.tpch_q1(li)  # noqa: E731
    got, want, row = rec.run("tpch_q1_distributed", fn, {}, single)
    row["groups"] = _require_same_groups("q1", got, want, [0, 1],
                                         float_cols=(6, 7, 8))
    rec.time("tpch_q1_distributed", fn, single, row)
    out["nccl_q1"] = _nccl_q1(li, dev)
    del li, got, want
    torch.cuda.empty_cache()

    q3 = q3_tables()
    for name, fn, want_l, single in (
            ("tpch_q3_distributed",
             lambda: tpch.tpch_q3_distributed(*q3, mesh), {"D": 8},
             lambda: tpch.tpch_q3(*q3).result.compact()),
            ("tpch_q3_planned_distributed",
             lambda: tpch.tpch_q3_planned_distributed(*q3, mesh), {},
             lambda: tpch.tpch_q3_planned(*q3).result.compact())):
        got, want, row = rec.run(name, fn, want_l, single)
        row["groups"] = _require_same_groups(name, got, want, [0])
        del got, want
        torch.cuda.empty_cache()
        rec.time(name, fn, single, row)
    del q3
    torch.cuda.empty_cache()

    q5 = strings_tables("q5")["args"]
    fn = lambda: tpch.tpch_q5_distributed(*q5, mesh)  # noqa: E731
    single = lambda: tpch.tpch_q5(*q5)  # noqa: E731
    got, want, row = rec.run("tpch_q5_distributed", fn, {"A": 4}, single)
    require(not bool(got.pk_violation) and not bool(got.domain_miss)
            and torch.equal(got.present, want.present),
            "q5: present, PK violation or domain miss")
    row["groups"] = _require_same_groups(
        "q5", got.table, want.table, [0])
    rec.time("tpch_q5_distributed", fn, single, row)
    del q5, got, want
    torch.cuda.empty_cache()

    q12 = strings_tables("q12")
    o12, li12 = q12["o12"], q12["li"]
    del q12
    fn = lambda: tpch.tpch_q12_distributed(o12, li12, mesh)  # noqa: E731
    single = lambda: tpch.tpch_q12(o12, li12).result.compact()  # noqa
    got, want, row = rec.run("tpch_q12_distributed", fn, {"D": 4}, single)
    row["groups"] = _require_same_groups("q12", got, want, [0])
    rec.time("tpch_q12_distributed", fn, single, row)
    del o12, li12, got, want
    torch.cuda.empty_cache()

    ds = tpcds_tables()
    q72, q64 = ds["q72"], ds["q64"]
    del ds
    for name, fn, want_l, single, keys in (
            ("tpcds_q72_distributed",
             lambda: tpcds.tpcds_q72_distributed(
                 *q72, mesh, group_budget=DS_GROUP_BUDGET), {"D": 12},
             lambda: tpcds.tpcds_q72(*q72).compact(), [0, 1]),
            ("tpcds_q72_planned_distributed",
             lambda: tpcds.tpcds_q72_planned_distributed(*q72, mesh), {},
             lambda: tpcds.tpcds_q72_planned(*q72), None),
            ("tpcds_q64_distributed",
             lambda: tpcds.tpcds_q64_distributed(
                 *q64, mesh, group_budget=DS_GROUP_BUDGET), {"D": 4},
             lambda: tpcds.tpcds_q64(*q64).result.compact(), [0])):
        got, want, row = rec.run(name, fn, want_l, single)
        if keys is None:  # planned q72: replicated, the same slot table
            require(not bool(got.pk_violation)
                    and torch.equal(got.present, want.present)
                    and got.table.equals(want.table),
                    f"{name} differs from tpcds_q72_planned")
            row["groups"] = int(got.present.sum())
        else:
            row["groups"] = _require_same_groups(name, got, want, keys)
        del got, want
        torch.cuda.empty_cache()
        rec.time(name, fn, single, row)
    del q72, q64
    torch.cuda.empty_cache()
    return out


def _rowid_values(res_tables, row_valid, rowid_col, values, n):
    """Scatter per-executor result values (aligned to shuffled rows) back
    to input-row order through the row id column: (data, validity) of n
    rows (rows no executor holds stay invalid)."""
    data, valid = None, torch.zeros(n, dtype=torch.bool,
                                    device=values[0].device)
    for tbl, rv, col in zip(res_tables, row_valid, values):
        ids = tbl.column(rowid_col).data[rv]
        if data is None:
            data = torch.zeros((n,), dtype=col.data.dtype,
                               device=col.device)
        data[ids] = col.data[rv]
        valid[ids] = col.valid_mask()[rv]
    return data, valid


def _distributed_operators(mesh, dev, rec: _PlanRecorder) -> dict:
    """The operators over a quarter of SF10 lineitem, each equal to its
    single-device counterpart; the overflow and its retry."""
    import numpy as np

    from spark_rapids_jni_tpu_torch import telemetry
    from spark_rapids_jni_tpu_torch import types as t
    from spark_rapids_jni_tpu_torch.columnar import Column, Table
    from spark_rapids_jni_tpu_torch.models import tpch
    from spark_rapids_jni_tpu_torch.ops import join as pjoin
    from spark_rapids_jni_tpu_torch.ops import lists, planner
    from spark_rapids_jni_tpu_torch.ops.groupby import (
        groupby_aggregate,
        groupby_percentile,
    )
    from spark_rapids_jni_tpu_torch.ops.hash import partition_hash
    from spark_rapids_jni_tpu_torch.ops.sort import sort_table
    from spark_rapids_jni_tpu_torch.ops.window import Window
    from spark_rapids_jni_tpu_torch.parallel import (
        distributed as pdist,
        hash_shuffle,
        shuffle as pshuffle,
        shuffle_wire_bytes,
        sort as psort,
    )
    from spark_rapids_jni_tpu_torch.runtime import dispatch, resilience
    from spark_rapids_jni_tpu_torch.utils.timing import median_ms

    n = EXECUTOR_ROWS
    full, _ = tpch.lineitem_groupby_table(n, Q3_ORDERS, SUPPLIERS)
    c = full.column
    # [l_orderkey, l_suppkey, l_shipdate, l_extendedprice, price FLOAT64,
    #  l_returnflag, l_quantity, row id]
    tab = Table([c(7), c(8), c(6), c(1), c(9), c(4), c(0),
                 Column(t.INT64, torch.arange(n, device=dev))])
    del full, c
    shards, rv = pdist.shard_table(tab, mesh, return_row_valid=True)
    out, timed = {}, {}

    # the shuffle alone, by l_suppkey, beside a device copy of its bytes
    wire0 = telemetry.counter("shuffle.wire_bytes")
    res = hash_shuffle(mesh, shards, [1], row_valid=rv)
    wire = telemetry.counter("shuffle.wire_bytes") - wire0
    cap = res[0].table.num_rows // MESH_EXECUTORS
    require(wire == MESH_EXECUTORS * shuffle_wire_bytes(
        shards[0], None, cap, MESH_EXECUTORS)["wire_bytes"],
        f"shuffle wire bytes {wire}")
    part = partition_hash(tab, [1], MESH_EXECUTORS)
    for e, r in enumerate(res):
        require(not bool(r.overflowed), "shuffle overflowed")
        got_ids = r.table.column(7).data[r.row_valid]
        require(torch.equal(got_ids, torch.nonzero(part == e).flatten()),
                f"executor {e} received other rows than partition_hash's")
    del res, part
    s = host_median_s(lambda: hash_shuffle(mesh, shards, [1], row_valid=rv))
    src = torch.empty(wire, dtype=torch.uint8, device=dev)
    dst = torch.empty_like(src)
    copy_ms = median_ms(lambda: dst.copy_(src), reps=3)
    del src, dst
    out["hash_shuffle"] = {"s": s, "wire_bytes": wire, "capacity": cap,
                           "copy_ms": copy_ms}
    log(f"hash_shuffle of {n} rows (8 columns) by l_suppkey over "
        f"{MESH_EXECUTORS} executors: {s * 1e3:.3f} ms, {wire} wire bytes "
        f"({wire / s / 1e9:.1f} GB/s); a device copy_ of as many bytes "
        f"{copy_ms:.3f} ms; every executor got exactly its partition's "
        f"rows in input order")

    def timed_part(name, fn, single, want=None):
        got, twin, row = rec.run(name, fn, want or {}, single)
        timed[name] = row
        return got, twin, row

    aggs = [(3, "sum"), (3, "count"), (6, "min"), (6, "max"), (4, "max")]
    got, want, row = timed_part(
        "distributed_groupby_aggregate",
        lambda: pdist.distributed_groupby_aggregate(shards, [1], aggs, mesh),
        lambda: groupby_aggregate(tab, [1], aggs))
    merged = pdist.collect(got.table, got.num_groups, mesh)
    row["groups"] = _require_same_groups(
        "groupby by l_suppkey", merged, want.compact(), [0])
    baseline = merged
    rec.time("distributed_groupby_aggregate",
             lambda: pdist.distributed_groupby_aggregate(shards, [1], aggs,
                                                         mesh),
             lambda: groupby_aggregate(tab, [1], aggs), row)
    del got, want

    dom = [planner.scalar_domain([ord("A"), ord("N"), ord("R")])]
    bagg = [(3, "sum"), (3, "count"), (6, "min"), (6, "max"), (4, "max")]
    bfn = lambda: pdist.distributed_groupby_bounded(  # noqa: E731
        shards, [5], bagg, dom, mesh, row_valid=rv)
    bsingle = lambda: planner.plan_groupby(tab, [5], bagg, dom)  # noqa
    got, want, row = timed_part("distributed_groupby_bounded", bfn, bsingle,
                                {"A": MESH_EXECUTORS})
    require(torch.equal(got.present, want.present)
            and got.table.equals(want.table)
            and not bool(got.domain_miss),
            "distributed bounded groupby differs from plan_groupby")
    row["groups"] = int(got.present.sum())
    rec.time("distributed_groupby_bounded", bfn,
             lambda: planner.plan_groupby(tab, [5], bagg, dom), row)
    del got, want

    qs = [0.5, 0.9]
    pfn = lambda: pdist.distributed_groupby_percentile(  # noqa: E731
        shards, [1], 3, qs, mesh)
    psingle = lambda: groupby_percentile(tab, [1], 3, qs)  # noqa: E731
    got, want, row = timed_part("distributed_groupby_percentile", pfn,
                                psingle)
    row["groups"] = _require_same_groups(
        "percentile by l_suppkey",
        pdist.collect(got.table, got.num_groups, mesh), want.compact(), [0])
    rec.time("distributed_groupby_percentile", pfn, psingle, row)
    del got, want

    specs = [("row_number",), ("running_sum", 3)]
    wfn = lambda: pdist.distributed_window(  # noqa: E731
        shards, [1], [2], specs, mesh, rv)

    def wsingle():
        w = Window(tab, [1], [2])
        return [w.row_number(), w.running_sum(3)]

    got, want, row = timed_part("distributed_window", wfn, wsingle)
    for i, col in enumerate(want):
        data, valid = _rowid_values(got.table, got.row_valid, 7,
                                    [r.column(i) for r in got.results], n)
        require(torch.equal(valid, col.valid_mask())
                and torch.equal(data[valid], col.data[valid]),
                f"window spec {specs[i]} differs from the single Window")
    rec.time("distributed_window", wfn, wsingle, row)
    del got, want

    ccap = dispatch.quantize_capacity(
        math.ceil(shards[0].num_rows / MESH_EXECUTORS) * 2)
    cfn = lambda: pdist.distributed_groupby_collect(  # noqa: E731
        shards, [1], 2, mesh, ccap, distinct=True)
    csingle = lambda: lists.groupby_collect(  # noqa: E731
        tab, [1], 2, distinct=True)
    got, want, row = timed_part("distributed_groupby_collect", cfn, csingle)
    # the groups re-ordered by key on the host, lists compared whole
    gk, gv = _h(got.table.column(0).data), _hv(got.table.column(0))
    goff = _h(got.table.column(1).data).astype(np.int64)
    gch = _h(got.table.column(1).children[0].data)
    keep = np.flatnonzero(gv)
    keep = keep[np.argsort(gk[keep], kind="stable")]
    lens = goff[keep + 1] - goff[keep]
    starts = np.repeat(goff[keep] - np.r_[0, np.cumsum(lens)[:-1]], lens)
    k = int(want.num_groups)
    woff = _h(want.table.column(1).data[:k + 1]).astype(np.int64)
    require(np.array_equal(gk[keep], _h(want.table.column(0).data[:k]))
            and np.array_equal(lens, np.diff(woff))
            and np.array_equal(gch[starts + np.arange(len(starts))],
                               _h(want.table.column(1).children[0].data)
                               [:woff[-1]]),
            "collect_set by l_suppkey differs from groupby_collect")
    row["groups"] = k
    rec.time("distributed_groupby_collect", cfn, csingle, row)
    del got, want

    orders = tpch.orders_table(Q3_ORDERS, Q3_CUSTOMERS)
    probe = Table([tab.column(0), tab.column(7)])
    oshards, orv = pdist.shard_table(orders, mesh, return_row_valid=True)
    pshards = [Table([s.column(0), s.column(7)]) for s in shards]
    jcap = n // MESH_EXECUTORS * 2
    jfn = lambda: pdist.distributed_join(  # noqa: E731
        pshards, oshards, 0, 0, mesh, jcap, left_row_valid=rv,
        right_row_valid=orv,
        left_capacity=jcap, right_capacity=Q3_ORDERS // MESH_EXECUTORS * 2)

    def jsingle():
        maps = pjoin.join(probe, orders, 0, 0, n)
        return maps, pjoin.apply_join_maps(probe, orders, maps)

    got, (maps, want), row = timed_part("distributed_join", jfn, jsingle,
                                        {"D": MESH_EXECUTORS})
    require(not any(bool(o) for o in got.overflowed)
            and sum(int(x) for x in got.total) == int(maps.total),
            "distributed join: overflow or match count")
    joined = pdist.collect(got.table, got.total, mesh)
    row["rows"] = _require_same_groups(
        "join l_orderkey = o_orderkey", joined,
        pdist.head_table(want, int(maps.total)), [1])
    rec.time("distributed_join", jfn, jsingle, row)
    del got, want, maps, joined, orders, oshards, orv, pshards, probe

    sfn = lambda: psort.distributed_sort(  # noqa: E731
        shards, [0], mesh, row_valid=rv)
    ssingle = lambda: sort_table(tab, [0])  # noqa: E731
    got, want, row = timed_part("distributed_sort", sfn, ssingle)
    srt = pdist.collect(got.table, got.num_rows, mesh)
    require(srt.num_rows == n and srt.equals(want),
            "distributed sort by l_orderkey differs from sort_table")
    rec.time("distributed_sort", sfn, ssingle, row)
    del got, want, srt

    # overflow: half the most rows one executor sends one destination
    # drops rows, classified; the retry ladder's doubled capacity holds
    # them and gives the derived run's groups
    busiest = max(int(torch.bincount(partition_hash(
        s, [1], MESH_EXECUTORS), minlength=MESH_EXECUTORS).max())
        for s in shards)
    small = busiest // 2
    res = hash_shuffle(mesh, shards, [1], capacity=small, row_valid=rv)
    try:
        pshuffle.report_shuffle_telemetry(res, rows=n, capacity=small,
                                          raise_on_overflow=True)
        raise AssertionError("a half-capacity shuffle did not overflow")
    except resilience.CapacityOverflow as exc:
        require(resilience.classify(exc) is resilience.CapacityOverflow,
                "overflow not classified CapacityOverflow")
        reason = str(exc)
    del res
    n_events = len(telemetry.events("resilience"))
    retried = pdist.distributed_groupby_aggregate(shards, [1], aggs, mesh,
                                                  capacity=small)
    events = [e["event"] for e in
              telemetry.events("resilience")[n_events:]]
    require(events == ["escalate", "recovered"],
            f"retry ladder events {events}")
    _require_same_groups(
        "groupby after the retry",
        pdist.collect(retried.table, retried.num_groups, mesh), baseline,
        [0])
    out["overflow"] = {"capacity": small, "classified": "CapacityOverflow",
                       "events": events}
    log(f"overflow at capacity {small}: {reason[:120]}...; the retry ladder "
        f"{events} gave the derived capacity's groups")
    del retried, baseline, shards, rv, tab
    torch.cuda.empty_cache()
    out["operators"] = timed
    return out


def multi_executor_phase(dev) -> tuple:
    """Phase 20: the multiple-executor layer on the card. Four executors
    (round-robin over the visible cards); the eight distributed TPC-H
    and TPC-DS plans at SF10 and the distributed operators over a
    quarter of SF10 lineitem, each equal to its single-device
    counterpart with A and D launched exactly as counted; the overflow
    classified and retried; a one-rank NCCL world."""
    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    mesh = _executor_mesh()
    rec = _PlanRecorder()
    out = _distributed_plans(mesh, dev, rec)
    out.update(_distributed_operators(mesh, dev, rec))
    out["plans"] = {k: v for k, v in rec.rows.items()
                    if k not in out["operators"]}
    out["s"] = time.perf_counter() - t_phase
    out["peak_gib"] = max(rec.peak,
                          torch.cuda.max_memory_allocated() / 2**30)
    log(f"phase 20 (multiple executors): {out['s']:.1f} s, device peak "
        f"{out['peak_gib']:.2f} GiB")
    return rec.launches, out


# ---- phase 21: across processes (the DCN wire, QueryCluster, QueryFleet,
# the exchange) --------------------------------------------------------------

PROC_BOOT_S = 180.0  # seconds a fleet or cluster may take to boot
PROC_WAIT_S = 600.0  # seconds a query across processes may take
PROC_PARTS = 4       # destinations of the local exchange's operators
HOSTS = ("h0", "h1")      # the cluster's workers
REPLICAS = ("r0", "r1")   # the fleet's workers
KILLED_FREES = 256 << 20  # bytes a killed worker's exit frees at least
# each worker's QueryServer budget (server.hbm_budget_bytes, as phase 19's
# server): the default 1 GiB refuses an SF10 q72 partial (~1.9 GB)
PROC_WORKER_ENV = {"SPARK_RAPIDS_TPU_SERVER_HBM_BUDGET_BYTES":
                   str(SERVE_BUDGET)}


def _card_used() -> int:
    """Bytes in use on card 0 by every process (``mem_get_info``)."""
    free, total = torch.cuda.mem_get_info(0)
    return int(total - free)


def _worker_launches(fleet_or_cluster, workers) -> dict:
    """Each worker's kernel launches since its boot, from a report every
    one of ``workers`` (and no other) sent after this call:
    {worker: {"A": n, "D": n}}."""
    from spark_rapids_jni_tpu_torch.ops.kernels import (
        groupby_accumulate as kga,
        hash_probe as khp,
    )

    loads = fleet_or_cluster.fresh_loads()
    require(set(loads) == set(workers),
            f"launch reports from {sorted(loads)}, not {sorted(workers)}")
    return {rid: {"A": int(ld.get("launches", {}).get(kga.NAME, 0)),
                  "D": int(ld.get("launches", {}).get(khp.NAME, 0))}
            for rid, ld in loads.items()}


def _launch_delta(before: dict, after: dict) -> dict:
    require(set(before) == set(after),
            f"launch reports from {sorted(before)}, then {sorted(after)}")
    return {rid: {k: after[rid][k] - before[rid][k] for k in ("A", "D")}
            for rid in after}


def _wire_part(dev) -> dict:
    """SF10 orders through ``serialize_table`` / ``deserialize_table``
    with the codec on and off, then over a loopback ``SliceLink``; each
    result equal to the input."""
    import threading

    from spark_rapids_jni_tpu_torch.models import tpch
    from spark_rapids_jni_tpu_torch.parallel import dcn
    from spark_rapids_jni_tpu_torch.runtime import compress
    from spark_rapids_jni_tpu_torch.runtime.memory import table_nbytes
    from spark_rapids_jni_tpu_torch.utils import config

    orders = tpch.orders_table(Q3_ORDERS, Q3_CUSTOMERS)
    torch.cuda.synchronize()
    raw = table_nbytes(orders)
    zstd = compress.zstd_available()
    # without zstandard the legacy framing's level must be 0 (raw)
    level = 3 if zstd else 0
    out = {"rows": orders.num_rows, "raw_bytes": raw, "zstd": zstd}
    try:
        for codec in (True, False):
            config.set_option("compress.wire", codec)
            t0 = time.perf_counter()
            blob = dcn.serialize_table(orders, compress_level=level)
            ser = time.perf_counter() - t0
            t0 = time.perf_counter()
            back = dcn.deserialize_table(blob, device=dev)
            torch.cuda.synchronize()
            de = time.perf_counter() - t0
            require(back.equals(orders), f"wire round trip (codec {codec})")
            del back
            name = ("codec frames (flag 2)" + ("" if zstd else
                                               ", no zstd stage")
                    if codec else ("whole-buffer zstd (flag 1)" if zstd
                                   else "raw buffers (flag 0)"))
            out["codec" if codec else "plain"] = row = {
                "framing": name, "wire_bytes": len(blob),
                "serialize_s": ser, "deserialize_s": de,
                "serialize_gb_s": raw / ser / 1e9,
                "deserialize_gb_s": raw / de / 1e9}
            log(f"wire, {name}: {raw} bytes -> {len(blob)} on the wire; "
                f"serialize {ser:.3f} s ({row['serialize_gb_s']:.3f} GB/s), "
                f"deserialize onto the card {de:.3f} s "
                f"({row['deserialize_gb_s']:.3f} GB/s); equal")
            del blob
    finally:
        config.reset_option("compress.wire")
    srv = dcn.SliceServer()
    got, errors = {}, []

    def receive():
        try:
            link = srv.accept_link(timeout=PROC_WAIT_S, device=dev)
            try:
                got["t"] = link.recv_table()
            finally:
                link.close()
        except BaseException as exc:  # re-raised below
            errors.append(exc)

    th = threading.Thread(target=receive)
    th.start()
    t0 = time.perf_counter()
    try:
        link = dcn.SliceLink.connect(srv.port, retries=50, delay_s=0.05,
                                     device=dev)
        try:
            sent = link.send_table(orders, compress_level=level)
        finally:
            link.close()
        th.join(PROC_WAIT_S)
        torch.cuda.synchronize()
    finally:
        srv.close()
    link_s = time.perf_counter() - t0
    require(not errors and not th.is_alive(), f"SliceLink: {errors}")
    require(got["t"].equals(orders), "SliceLink loopback changed the table")
    out["slice_link"] = {"frame_bytes": sent, "s": link_s,
                         "gb_s": raw / link_s / 1e9}
    log(f"wire, loopback SliceLink (sealed, acknowledged): {sent} bytes "
        f"in {link_s:.3f} s ({raw / link_s / 1e9:.3f} GB/s of table); "
        "equal")
    return out


def _q72_want(q72):
    from spark_rapids_jni_tpu_torch.models import tpcds
    from spark_rapids_jni_tpu_torch.ops.table_ops import trim_table

    r = tpcds.tpcds_q72(*q72)
    return tpcds._compact_valid_keys(trim_table(r.table, int(r.num_groups)),
                                     2, [2, 0], [False, True])


def _timed_across(name: str, c, fn, want_fp, want_d: int, out: dict) -> None:
    """Three runs of ``fn``, the first checked (bit-identical to
    ``want_fp``, each worker's launches of D read from the workers around
    it: exactly ``want_d`` on each host); their median, the cluster's
    link and exchange bytes of the first, the card's used bytes across
    processes."""
    from spark_rapids_jni_tpu_torch import telemetry
    from spark_rapids_jni_tpu_torch.runtime import resultcache

    before = _worker_launches(c, HOSTS)
    link0 = telemetry.counter("fleet.link_bytes")
    direct0 = telemetry.counter("exchange.bytes_direct")
    t0 = time.perf_counter()
    res = fn()
    first = time.perf_counter() - t0
    got = _launch_delta(before, _worker_launches(c, HOSTS))
    require(resultcache.table_fingerprint(res) == want_fp,
            f"{name}: not bit-identical to the single-process result")
    require(all(n == {"A": 0, "D": want_d} for n in got.values()),
            f"{name}: workers launched {got}, not D {want_d} each")
    row = {"worker_launches": got,
           "link_bytes": telemetry.counter("fleet.link_bytes") - link0,
           "bytes_direct": telemetry.counter("exchange.bytes_direct")
           - direct0,
           "card_used_gib": _card_used() / 2**30}
    times = [first]
    for _ in range(2):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    row["s"] = statistics.median(times)
    out[name] = row
    log(f"{name}: {row['s']:.3f} s (median of 3: "
        + ", ".join(f"{x:.3f}" for x in times)
        + f"), link {row['link_bytes']} bytes, exchange direct "
        f"{row['bytes_direct']} bytes, worker launches {got}, card used "
        f"{row['card_used_gib']:.2f} GiB across processes; bit-identical")


def _failover_drill(c, q72, want_fp, hold, out: dict) -> None:
    """h0 held before it serves its q72 partial and SIGKILLed: the shard
    re-homed, the result bit-identical, a classified host death and a
    restart, no leaked bytes, and the card's memory given back."""
    import signal
    import threading

    from spark_rapids_jni_tpu_torch import telemetry
    from spark_rapids_jni_tpu_torch.models import tpcds
    from spark_rapids_jni_tpu_torch.parallel import dcn
    from spark_rapids_jni_tpu_torch.runtime import resultcache
    from spark_rapids_jni_tpu_torch.runtime.memory import table_nbytes
    from spark_rapids_jni_tpu_torch.utils import config

    shard0 = table_nbytes(dcn.partition_for_slices(q72[0], [0], 2)[0])
    deaths0 = len(telemetry.events("fleet"))
    # a slow restart: the dead host's memory is read before its
    # successor boots
    config.set_option("fleet.restart_backoff_s", 5.0)
    result, errors = {}, []

    def run():
        try:
            result["t"] = tpcds.tpcds_q72_cluster(
                c, "failover", *q72[1:], merge_timeout_s=PROC_WAIT_S)
        except BaseException as exc:  # re-raised below
            errors.append(exc)

    h0 = c._host("h0")
    hold.touch()
    th = threading.Thread(target=run)
    try:
        t0 = time.perf_counter()
        th.start()
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline and not h0.inflight:
            time.sleep(0.01)
        require(bool(h0.inflight), "h0 never took its partial")
        time.sleep(0.5)  # inside h0's hold: mid-partial
        torch.cuda.synchronize()
        before = _card_used()
        h0.proc.send_signal(signal.SIGKILL)
        hold.unlink()
        t_kill = time.perf_counter()
        low = before
        while time.perf_counter() - t_kill < 4.0:
            low = min(low, _card_used())
            time.sleep(0.02)
        # the dead process's memory comes back to the card (its shard and its
        # cached blocks), whatever h1 takes for the re-homed shard
        require(before - low >= max(KILLED_FREES, shard0),
                f"the dead host's memory stayed: {before} -> {low} bytes")
        th.join(PROC_WAIT_S)
        require(not errors and not th.is_alive(), f"failover: {errors}")
        took = time.perf_counter() - t0
        require(resultcache.table_fingerprint(result["t"]) == want_fp,
                "the failed-over q72 is not bit-identical")
        require(c._tables["catalog_sales"].owners[0] == "h1",
                f"shard 0 not re-homed: {c._tables['catalog_sales'].owners}")
        deaths = [r for r in telemetry.events("fleet")[deaths0:]
                  if r.get("event") in ("host_death", "replica_death")]
        require(len(deaths) == 2 and all(
            r["host"] == "h0" and r["error_kind"] == "ReplicaDeadError"
            for r in deaths), f"host death not classified: {deaths}")
        # the classified death's cause= field ("signal:SIGKILL")
        cause = [r["cause"] for r in deaths if "cause" in r][0]
        cause = cause.split("cause=", 1)[-1].split(",", 1)[0]
        require(c.wait_live(timeout=PROC_BOOT_S) == 2, "h0 did not restart")
        c.fresh_loads()
        require(c.leaked_bytes() == 0, f"leaked {c.leaked_bytes()} bytes")
        after = _card_used()
        # the shard moved to h1 (into its cached blocks, or beside them)
        # and h0 came back with a fresh context, its working memory gone
        require(after <= before + shard0,
                f"card used {before} before the kill, {after} after")
    finally:
        if hold.exists():
            hold.unlink()
        config.reset_option("fleet.restart_backoff_s")
    out["failover"] = {
        "s": took, "cause": cause,
        "used_before_kill_gib": before / 2**30,
        "used_low_after_kill_gib": low / 2**30,
        "used_after_restart_gib": after / 2**30, "shard0_gib": shard0 / 2**30}
    log(f"failover: h0 SIGKILLed mid-partial ({cause}), shard 0 re-homed "
        f"to h1, q72 bit-identical in {took:.1f} s; card used "
        f"{before / 2**30:.2f} GiB before the kill, {low / 2**30:.2f} "
        f"after, {after / 2**30:.2f} with h0 restarted; leaked 0")


def _cluster_part(dev, out: dict) -> dict:
    """SF10 catalog_sales and orders registered on a 2-host cluster on
    the card; q72 with the runtime filter off and on, q13's exchange
    direct, routed and as one plan, each bit-identical to the
    single-process result; then the failover drill."""
    from spark_rapids_jni_tpu_torch.models import tpcds, tpch
    from spark_rapids_jni_tpu_torch.runtime import cluster, fleet, resultcache
    from spark_rapids_jni_tpu_torch.utils import config

    fp = resultcache.table_fingerprint
    cs = tpcds.catalog_sales_table(DS_CATALOG_SALES, num_items=DS_ITEMS)
    q72 = (cs, tpcds.date_dim_table(), tpcds.item_table(DS_ITEMS),
           tpcds.inventory_table(num_items=DS_ITEMS))
    orders = tpch.orders_table(Q3_ORDERS, Q3_CUSTOMERS)
    q72_fp = fp(_q72_want(q72))
    q13_local = tpch.tpch_q13_local(orders, 2)
    q13_fp = fp(q13_local)
    oracle = tpch.tpch_q13_oracle(orders)
    keys, counts = (x.cpu().numpy() for x in (q13_local.column(0).data,
                                              q13_local.column(1).data))
    order = keys.argsort()
    require((keys[order] == oracle["custkey"]).all()
            and (counts[order] == oracle["count"]).all(),
            "q13 differs from the numpy oracle as a set of rows")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    used0 = _card_used()
    t0 = time.perf_counter()
    # repeats really run: no supervisor memo, no worker result cache
    config.set_option("fleet.result_memo_entries", 0)
    hold = DATA_DIR / "h0.hold"
    hold.parent.mkdir(parents=True, exist_ok=True)
    if hold.exists():
        hold.unlink()
    c = cluster.QueryCluster(
        len(HOSTS), device=dev, worker_env={**PROC_WORKER_ENV,
                                   "SPARK_RAPIDS_TPU_CACHE_ENABLED": "0"},
        per_replica_env={"h0": {fleet._ENV_SERVE_HOLD_FILE: str(hold)}})
    try:
        require(c.wait_live(timeout=PROC_BOOT_S) == len(HOSTS),
                "cluster boot")
        out["boot_s"] = time.perf_counter() - t0
        booted = _card_used()
        log(f"cluster of 2 hosts on {dev}: booted in {out['boot_s']:.1f} s; "
            f"card used {used0 / 2**30:.2f} -> {booted / 2**30:.2f} GiB "
            "(the two workers' contexts)")
        reg = {}
        for name, table, key in (("catalog_sales", cs, (0,)),
                                 ("orders", orders, (tpch.O_ORDERKEY,))):
            t0 = time.perf_counter()
            info = c.register_table(name, table, keys=key)
            reg[name] = {"s": time.perf_counter() - t0, **info}
            log(f"registered {name}: {info['rows']} rows as {info['parts']} "
                f"shards on {info['owners']} in {reg[name]['s']:.2f} s")
        out["register"] = reg
        start = _worker_launches(c, HOSTS)
        for rtf in (False, True):
            config.set_option("rtfilter.enabled", rtf)
            try:
                _timed_across(
                    f"q72 cluster (runtime filter {'on' if rtf else 'off'})",
                    c, lambda: tpcds.tpcds_q72_cluster(c, "q72", *q72[1:]),
                    q72_fp, 3, out)
            finally:
                config.reset_option("rtfilter.enabled")
        pack, merge = tpch.q13_exchange_plans(2)
        for mode, direct in (("direct", True), ("routed", False)):
            def run(direct=direct):
                return c.submit_exchange(
                    "q13", pack, merge, table="orders", binding="orders",
                    merge_binding="partials",
                    merge_valid_meta="merge.num_groups",
                    direct=direct).result(timeout=PROC_WAIT_S)

            _timed_across(f"q13 exchange ({mode})", c, run, q13_fp, 0, out)
        # flights a source packs: the routed form's partials carry them
        tickets = [c.submit_to_shard("q13", pack, table="orders",
                                     binding="orders", part=p)
                   for p in range(2)]
        out["q13_flights"] = [int(t.result(timeout=PROC_WAIT_S).meta[
            "exchange.flights"]) for t in tickets]
        log(f"q13 exchange flights per source: {out['q13_flights']} "
            f"(exchange.max_capacity_rows 65536: chunked flights)")
        _timed_across(
            "q13 exchange (one plan, q13_midplan_plan(0))", c,
            lambda: c.submit_exchange(
                "q13", tpch.q13_midplan_plan(0), table="orders",
                binding="orders").result(timeout=PROC_WAIT_S),
            q13_fp, 0, out)
        total = _launch_delta(start, _worker_launches(c, HOSTS))
        # q72: 3 probes a host a run (its three joins), 3 runs in each of
        # 2 modes; q13 and its flights none
        require(total == {h: {"A": 0, "D": 3 * 3 * 2} for h in HOSTS},
                f"cluster workers launched {total}")
        out["worker_launches"] = total
        require(c.leaked_bytes() == 0, f"leaked {c.leaked_bytes()} bytes")
        _failover_drill(c, q72, q72_fp, hold, out)
    finally:
        c.close()
        config.reset_option("fleet.result_memo_entries")
    out["card_used_after_close_gib"] = _card_used() / 2**30
    return {"A": 0, "D": sum(n["D"] for n in total.values())}


def _fleet_part(dev, out: dict) -> dict:
    """Planned q1 and q6 over a quarter of SF10 lineitem served by a
    2-replica fleet on the card to two sessions; each bit-identical to
    the in-process ``fusion.execute``, the repeats memo-served, kernel A
    launched once across the workers."""
    from spark_rapids_jni_tpu_torch.models import tpch
    from spark_rapids_jni_tpu_torch.runtime import fleet, fusion, resultcache

    fp = resultcache.table_fingerprint
    li = tpch.lineitem_table(EXECUTOR_ROWS, seed=0)
    q1p = tpch._q1_planned_plan()
    q6 = fusion.Plan("tpch_q6", fusion.Project(
        fusion.Scan("lineitem"), tpch._q6_reduce, rowwise=False))
    b = {"lineitem": li}
    wants = {p.name: fp(fusion.execute(p, b).table) for p in (q1p, q6)}
    t0 = time.perf_counter()
    f = fleet.QueryFleet(len(REPLICAS), device=dev,
                         worker_env=PROC_WORKER_ENV)
    try:
        require(f.wait_live(timeout=PROC_BOOT_S) == len(REPLICAS),
                "fleet boot")
        out["fleet_boot_s"] = time.perf_counter() - t0
        before = _worker_launches(f, REPLICAS)
        served = {}
        for session in ("dashboard", "analyst"):
            for plan in (q1p, q6):
                t0 = time.perf_counter()
                tk = f.submit(session, plan, b)
                res = tk.result(timeout=PROC_WAIT_S)
                torch.cuda.synchronize()
                s = time.perf_counter() - t0
                require(fp(res.table) == wants[plan.name],
                        f"fleet {plan.name} for {session} not bit-identical")
                served[f"{session} {plan.name}"] = {"s": s,
                                                    "replica": tk.replica}
        got = _launch_delta(before, _worker_launches(f, REPLICAS))
        require(sum(n["A"] for n in got.values()) == 1
                and sum(n["D"] for n in got.values()) == 0,
                f"fleet workers launched {got}, not A once")
        require([v["replica"] for k, v in served.items()
                 if k.startswith("analyst")] == ["supervisor"] * 2,
                f"the repeats were not memo-served: {served}")
        require(f.leaked_bytes() == 0, "the fleet leaked")
        out["fleet"] = {"served": served, "worker_launches": got}
        log(f"fleet of 2 replicas on {dev} (booted in "
            f"{out['fleet_boot_s']:.1f} s): " + ", ".join(
                f"{k} {v['s']:.3f} s on {v['replica']}"
                for k, v in served.items())
            + f"; worker launches {got}; bit-identical")
    finally:
        f.close()
    return {"A": 1, "D": 0}


def _local_exchange_part(dev, out: dict) -> dict:
    """The exchange in one process over a quarter of SF10 lineitem and
    SF10 orders, each equal to its single-device counterpart."""
    from spark_rapids_jni_tpu_torch import types as t
    from spark_rapids_jni_tpu_torch.columnar import Column, Table
    from spark_rapids_jni_tpu_torch.models import tpch
    from spark_rapids_jni_tpu_torch.ops.groupby import groupby_aggregate
    from spark_rapids_jni_tpu_torch.ops.hash import partition_hash
    from spark_rapids_jni_tpu_torch.ops.join import join_auto
    from spark_rapids_jni_tpu_torch.ops.sort import gather, sort_table
    from spark_rapids_jni_tpu_torch.ops.table_ops import trim_table
    from spark_rapids_jni_tpu_torch.runtime import exchange as xch
    from spark_rapids_jni_tpu_torch.runtime import fusion, resultcache

    fp = resultcache.table_fingerprint
    n = EXECUTOR_ROWS
    full, _ = tpch.lineitem_groupby_table(n, Q3_ORDERS, SUPPLIERS)
    c = full.column
    # [l_orderkey, l_suppkey, l_quantity, row id]
    tab = Table([c(7), c(8), c(0),
                 Column(t.INT64, torch.arange(n, device=dev))])
    del full, c
    rows = {}

    def timed(name, fn, want):
        res, _ = _run_plan(name, fn, want)
        rows[name] = {"s": host_median_s(fn, warm=False)}
        return res

    dests = timed("exchange_local", lambda: xch.exchange_local(
        tab, [1], PROC_PARTS), {})
    part = partition_hash(tab, [1], PROC_PARTS)
    for p, d in enumerate(dests):
        idx = torch.nonzero(part == p).flatten()
        # the source's rows (column 3 is the row id), in its order
        require(torch.equal(d.column(3).data, idx),
                f"exchange_local destination {p}: rows or their order")
        _require_same_groups(f"exchange_local destination {p}", d,
                             gather(tab, idx), [3])
    aggs = [(2, "sum"), (2, "count")]
    got = timed("partitioned_groupby", lambda: xch.partitioned_groupby(
        tab, [1], aggs, parts=PROC_PARTS), {})
    g = groupby_aggregate(tab, [1], aggs, max_groups=None)
    want = trim_table(g.table, int(g.num_groups))
    _require_same_groups("partitioned_groupby", got, want, [0])
    orders = tpch.orders_table(Q3_ORDERS, Q3_CUSTOMERS)
    left = Table([tab.column(0), tab.column(3)])
    got = timed("partitioned_join", lambda: xch.partitioned_join(
        left, orders, 0, 0, parts=PROC_PARTS), {"D": PROC_PARTS})
    maps, joined = join_auto(left, orders, 0, 0)
    want = trim_table(joined, int(maps.total))
    _same_tables("partitioned_join", sort_table(got, [1]),
                 sort_table(want, [1]))
    got = timed("q13 one plan (4 parts)", lambda: fusion.execute(
        tpch.q13_midplan_plan(PROC_PARTS), {"orders": orders}), {})
    require(fp(got.table) == fp(tpch.tpch_q13_local(orders, PROC_PARTS)),
            "q13_midplan_plan differs from tpch_q13_local")
    ref = tpch.tpch_q13_reference(orders)
    _require_same_groups("q13_midplan_plan", got.table, ref, [0])
    out["local_exchange"] = rows
    log("local exchange: " + ", ".join(
        f"{k} {v['s'] * 1e3:.1f} ms" for k, v in rows.items())
        + f" (median of 3; {PROC_PARTS} parts); each equal to its "
        "single-device counterpart; D once a partition in the join")
    return {"A": 0, "D": PROC_PARTS}


def across_processes_phase(dev) -> tuple:
    """Phase 21: the serving stack across processes on the card. The DCN
    wire over SF10 orders; a 2-host ``QueryCluster`` serving SF10 TPC-DS
    q72 (runtime filter off and on) and q13's exchange (direct, routed,
    one plan); a SIGKILLed host failing over; a 2-replica ``QueryFleet``
    serving planned q1 and q6; the exchange in one process. Every
    result bit-identical to its single-process result on the card, the
    workers' launches of A and D exactly as counted."""
    from spark_rapids_jni_tpu_torch.utils import config

    torch.cuda.reset_peak_memory_stats()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    out = {"wire": _wire_part(dev)}
    torch.cuda.empty_cache()
    # a pong every 0.1 s: the workers' launch reports come sooner
    config.set_option("fleet.heartbeat_interval_s", 0.1)
    try:
        launches = {"cluster q72 (workers)": _cluster_part(dev, out)}
        torch.cuda.empty_cache()
        launches["fleet planned q1 (workers)"] = _fleet_part(dev, out)
    finally:
        config.reset_option("fleet.heartbeat_interval_s")
    torch.cuda.empty_cache()
    launches["partitioned_join"] = _local_exchange_part(dev, out)
    out["s"] = time.perf_counter() - t_phase
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    log(f"phase 21 (across processes): {out['s']:.1f} s, the supervisor's "
        f"device peak {out['peak_gib']:.2f} GiB")
    return launches, out

# ---- phase 22: what the card refused ----------------------------------------

# (INT64 columns, rows): 1,632-byte rows x 2,000,000 (3.26 GB of rows) and
# 65,000-byte rows x 20,000 (1.3 GB)
WIDE_ROWS = ((200, 2_000_000), (8_000, 20_000))
FLOAT_SUM_RUNS = 3
# TPC-H q15's revenue-by-supplier aggregate: sum and count of l_quantity
# and l_extendedprice, and their min and max
SUPPLIER_AGGS = [(1, "sum"), (1, "count"), (2, "sum"), (2, "count"),
                 (1, "min"), (1, "max"), (2, "min"), (2, "max")]


def _bounded_suppliers_part(gtab, dev, out: dict) -> int:
    """(a) ``plan_groupby_auto`` over SF10 lineitem by l_suppkey with the
    DDL domain of 100,000 supplier keys from a budget of 4,096: the
    bounded plan at m = 100,001, kernel A launched ``launches(m, L)``
    times (one pass), equal to the same call with no domain (the
    general plan) and to ``np.bincount``; then A alone at this shape
    against its plain version, and A over one float-sum lane (the
    FLOAT64 price, column 3 of ``gtab``) at the same m three times: the
    same bits each run, within its bound. Returns A's launches."""
    import numpy as np

    from spark_rapids_jni_tpu_torch.ops.groupby import bounded_lanes
    from spark_rapids_jni_tpu_torch.ops.kernels import groupby_accumulate as kga
    from spark_rapids_jni_tpu_torch.ops.planner import (
        bounded_accumulate_inputs,
        plan_groupby_auto,
        scalar_domain,
    )

    m = SUPPLIERS + 1
    domains = [scalar_domain(range(1, SUPPLIERS + 1))]
    num_lanes = len(bounded_lanes(gtab, SUPPLIER_AGGS).lanes)
    want_a = kga.launches(m, num_lanes)
    plan = kga.launch_plan(m, num_lanes)
    t0 = time.perf_counter()
    res, got = _run_plan(
        "plan_groupby_auto(l_suppkey, DDL domain)",
        lambda: plan_groupby_auto(gtab, [0], SUPPLIER_AGGS, domains,
                                  budget=4096), {"A": want_a})
    s_bounded = time.perf_counter() - t0
    require(res.lowered == "bounded" and not bool(res.domain_miss)
            and res.table.num_rows == m,
            f"supplier keys: {res.lowered}, miss {bool(res.domain_miss)}, "
            f"{res.table.num_rows} slots")
    t0 = time.perf_counter()
    gen = _no_launch("plan_groupby_auto(l_suppkey, no domain)",
                     lambda: plan_groupby_auto(gtab, [0], SUPPLIER_AGGS,
                                               [None], budget=4096))
    s_general = time.perf_counter() - t0
    present = res.present
    k = int(present.sum())
    require(gen.lowered == "general" and int(gen.present.sum()) == k,
            f"general plan: {gen.lowered}, {int(gen.present.sum())} groups, "
            f"bounded {k}")
    # bounded slots in key order (no null key here) = the general plan's
    # rows sorted by key
    for i, (b, g) in enumerate(zip(res.table.columns, gen.table.columns)):
        bv, gv = b.valid_mask()[present], g.valid_mask()[:k]
        require(torch.equal(bv, gv)
                and torch.equal(b.data[present][bv], g.data[:k][gv]),
                f"bounded column {i} != the general plan's")
    skey = gtab.column(0).data.cpu().numpy()
    qty = gtab.column(1).data.cpu().numpy()
    qv = gtab.column(1).valid_mask().cpu().numpy()
    price = gtab.column(2).data.cpu().numpy()
    slots = np.flatnonzero(present.cpu().numpy())
    oracle = {1: np.bincount(skey, weights=np.where(qv, qty, 0), minlength=m),
              2: np.bincount(skey, weights=qv, minlength=m),
              3: np.bincount(skey, weights=price, minlength=m),
              4: np.bincount(skey, minlength=m)}
    require(np.array_equal(slots + 1, np.flatnonzero(oracle[4])),
            "present slots != the suppliers with rows")
    for col, want in oracle.items():
        got_col = res.table.column(col).data[present].cpu().numpy()
        require(np.array_equal(got_col, want[slots + 1].astype(np.int64)),
                f"supplier column {col} != np.bincount")
    log(f"bounded plan over supplier keys: m = {m}, {k} suppliers, kernel "
        f"A {got['A']} launch(es) (one pass over {plan.one_pass} of "
        f"{num_lanes} lanes), equal to the general plan and np.bincount; "
        f"{s_bounded:.1f} s (general attempts 4,096-65,536 included), "
        f"general {s_general:.1f} s")
    del gen, res
    gid, lanes, _ = bounded_accumulate_inputs(gtab, [0], SUPPLIER_AGGS,
                                              domains)
    row = _accumulate_row(gid, lanes, m, dev, "supplier keys")
    out["bounded_suppliers"] = dict(
        row, one_pass_lanes=plan.one_pass, s=s_bounded, general_s=s_general,
        groups=k, float_sum=_wide_float_sum(gid, gtab.column(3), m))
    return got["A"]


def _wide_float_sum(gid, col, m: int) -> dict:
    """A over one float-sum lane at m groups past shared memory (windows
    of the large kernel, a fixed order), ``FLOAT_SUM_RUNS`` times: the
    same bits each run, each sum within ``FLOAT_SUM_REL * sum|x|`` of the
    plain version's, NaN where it is; its time beside the plain
    version's."""
    from spark_rapids_jni_tpu_torch.ops.kernels import groupby_accumulate as kga
    from spark_rapids_jni_tpu_torch.utils.timing import median_ms

    lane = kga.Lane("sum", col.data, col.validity, 0.0)
    runs = [kga._accumulate_cuda(gid, [lane], m)
            for _ in range(FLOAT_SUM_RUNS)]
    require(all(torch.equal(runs[0], r) for r in runs[1:]),
            f"A's float sum at m = {m}: the bits differ between runs")
    g = runs[0][:, 0].view(torch.float64)
    w = kga.accumulate_plain(gid, [lane], m)[:, 0].view(torch.float64)
    nan = torch.isnan(w)
    near = (g - w).abs() <= kga.float_sum_bound(gid, lane, m)
    require(bool(((torch.isnan(g) == nan) & (nan | near)).all()),
            f"A's float sum at m = {m} past its bound")
    del runs
    row = dict(launches=kga.launches(m, 1, 1), runs=FLOAT_SUM_RUNS,
               nan_groups=int(nan.sum()),
               ms=median_ms(lambda: kga._accumulate_cuda(gid, [lane], m)),
               plain_ms=median_ms(lambda: kga.accumulate_plain(
                   gid, [lane], m)))
    log(f"kernel A, one float-sum lane at m = {m}: {row['launches']} "
        f"launches (windows), the same bits in {FLOAT_SUM_RUNS} runs, "
        f"within the bound; {row['ms']:.3f} ms (plain "
        f"{row['plain_ms']:.3f})")
    return row


def _wide_rows_part(dev, out: dict) -> int:
    """(b) ``convert_to_rows(enforce_row_limit=False)`` over INT64 tables
    of ``WIDE_ROWS`` with ~10 % nulls: kernel C once a table, no
    fallback, byte for byte its plain version; ``convert_from_rows`` of
    every batch gives the columns back exactly; C alone against its
    plain version, ``torch.cat`` of the ready byte pieces and its byte
    bound, its time split into the wrapper's host time and the kernel's.
    Returns C's launches."""
    from spark_rapids_jni_tpu_torch import types as t
    from spark_rapids_jni_tpu_torch.columnar import Column, Table
    from spark_rapids_jni_tpu_torch.columnar.bitmask import (
        pack_bits_last_axis,
    )
    from spark_rapids_jni_tpu_torch.ops.bytecast import to_bytes
    from spark_rapids_jni_tpu_torch.ops.kernels import row_transpose as krt
    from spark_rapids_jni_tpu_torch.ops.row_conversion import (
        compute_fixed_width_layout,
        convert_from_rows,
        convert_to_rows,
    )
    from spark_rapids_jni_tpu_torch.utils.timing import (
        host_device_ms,
        median_ms,
    )

    gen = torch.Generator(device=dev).manual_seed(22)
    launched = 0
    for ncols, n in WIDE_ROWS:
        data = torch.randint(-2**62, 2**62, (ncols, n), generator=gen,
                             device=dev, dtype=torch.int64)
        valid = torch.rand((ncols, n), generator=gen, device=dev) >= 0.1
        tbl = Table([Column(t.INT64, data[i], valid[i])
                     for i in range(ncols)])
        schema = tbl.schema()
        starts, sizes, spr = compute_fixed_width_layout(schema)
        what = f"convert_to_rows({ncols} INT64 columns, {spr}-byte rows)"
        batches = _launched_only(what, lambda: convert_to_rows(
            tbl, enforce_row_limit=False), {krt.NAME: 1})
        launched += 1
        datas = [c.data for c in tbl.columns]
        valids = [c.validity for c in tbl.columns]
        want = krt.assemble_rows_plain(datas, valids, schema, starts, spr)
        r0 = 0
        for b in batches:
            rows = b.data.view(b.num_rows, spr)
            require(torch.equal(rows, want[r0:r0 + b.num_rows]),
                    f"{what}: batch at row {r0} != the plain version")
            back = convert_from_rows(b, schema)
            require(torch.equal(torch.stack([c.data for c in back.columns]),
                                data[:, r0:r0 + b.num_rows])
                    and torch.equal(
                        torch.stack([c.validity for c in back.columns]),
                        valid[:, r0:r0 + b.num_rows]),
                    f"{what}: the round trip at row {r0} is not exact")
            del back
            r0 += b.num_rows
        require(r0 == n, f"{what}: batches hold {r0} rows")
        del batches
        # yardstick: one torch.cat of the ready byte pieces (each column's
        # bytes, the packed validity bytes, the pad), the same image
        pieces = [to_bytes(d, dt) for d, dt in zip(datas, schema)]
        pieces.append(pack_bits_last_axis(valid.t()))
        if spr > starts[-1] + 8 + pieces[-1].shape[1]:
            pieces.append(torch.zeros(
                (n, spr - starts[-1] - 8 - pieces[-1].shape[1]),
                dtype=torch.uint8, device=dev))
        require(torch.equal(torch.cat(pieces, dim=1), want),
                f"{what}: the yardstick differs")
        del want
        lib = median_ms(lambda: torch.cat(pieces, dim=1))
        del pieces
        plan = krt.tile_plan(starts, sizes, spr)
        b_ms, b_by = bound(data.nbytes + valid.nbytes + n * spr, 0)
        # the wrapper as convert_to_rows calls it
        host_ms, device_ms = host_device_ms(
            lambda: krt._prepare_cuda(datas, valids, schema, starts, spr),
            krt._launch_cuda)
        row = dict(
            columns=ncols, rows=n, row_bytes=spr, launches=1,
            rows_per_block=plan.rows, segments=len(plan.segments),
            smem_per_block=plan.smem, max_abs_err=0.0,
            ms=median_ms(lambda: krt._assemble_rows_cuda(
                datas, valids, schema, starts, spr)),
            host_ms=host_ms, device_ms=device_ms,
            plain_ms=median_ms(lambda: krt.assemble_rows_plain(
                datas, valids, schema, starts, spr)),
            bound_ms=b_ms, bound_by=b_by, library_ms=lib)
        out[f"wide_rows_{spr}"] = row
        log(f"kernel C at {spr}-byte rows x {n}: {n * spr / 1e9:.2f} GB, "
            f"{len(plan.segments)} segments of {plan.rows} rows a block, "
            f"{plan.smem} bytes of shared memory; equal to the plain "
            f"version byte for byte, round trip exact; {row['ms']:.3f} ms "
            f"(wrapper's host {host_ms:.3f}, kernel {device_ms:.3f}; plain "
            f"{row['plain_ms']:.3f}, torch.cat {lib:.3f}, bound {b_ms:.3f} "
            f"by {b_by})")
        del tbl, datas, valids, data, valid
        torch.cuda.empty_cache()
    return launched


def _float_sums_part(ftab, dev, out: dict) -> tuple:
    """(c) the general groupby by l_suppkey of a FLOAT64 sum over a quarter
    of SF10 lineitem, three runs: kernel E once a run, the same bits
    each time, each sum within 1e-12 * sum|x| of the plain version's and
    within (count - 1) * eps * sum|x| of the exact sum (a long double
    sum on the host), NaN where a group holds one; then E alone at this
    shape against its plain version, and bit for bit the groupby's; then
    the same rows in one group. Returns (E's kernel row, its launches)."""
    import numpy as np

    from spark_rapids_jni_tpu_torch.ops import groupby as gb
    from spark_rapids_jni_tpu_torch.ops import kernels
    from spark_rapids_jni_tpu_torch.ops.kernels import segment_sum as kss
    from spark_rapids_jni_tpu_torch.utils.timing import median_ms

    n = ftab.num_rows
    runs, launched = [], 0
    for i in range(FLOAT_SUM_RUNS):
        kernels.reset_counts()
        g = gb.groupby_aggregate(ftab, [0], [(1, "sum")],
                                 max_groups=SUPPLIERS)
        torch.cuda.synchronize()
        got = kernels.launches()
        require(got == {kss.NAME: 1} and not kernels.fallbacks(),
                f"float sums run {i}: launched {got}, fell back "
                f"{kernels.fallbacks()}")
        launched += 1
        k = int(g.num_groups)
        runs.append(g.table.column(1).data[:k].clone())
        del g
    E_BY_PATH["float sums by l_suppkey"] = launched
    require(all(torch.equal(r.view(torch.int64), runs[0].view(torch.int64))
                for r in runs), "float sums differ between runs")
    # the same sums from the kernel's and the plain version's inputs: the
    # rows sorted by key (stable), the groups' bounds
    key_sorted, order = torch.sort(ftab.column(0).data, stable=True)
    same = torch.cat([torch.zeros(1, dtype=torch.bool, device=dev),
                      key_sorted[1:] == key_sorted[:-1]])
    G = gb._Groups(same, n, SUPPLIERS, dev)
    vals = ftab.column(1).data[order].to(torch.float64)
    del key_sorted, order, same
    got = kss._segment_sum_cuda(vals, G.gid, G.g_lo, G.g_hi)
    want = kss.segment_sum_plain(vals, G.gid, SUPPLIERS)
    torch.cuda.synchronize()
    require(torch.equal(got[:k].view(torch.int64),
                        runs[0].view(torch.int64)),
            "kernel E at the groupby's inputs != the groupby's sums")
    nan = torch.isnan(want)
    near = (got - want).abs() <= kss.sum_bound(vals, G.gid, SUPPLIERS)
    require(torch.equal(torch.isnan(got), nan) and bool((nan | near).all()),
            "kernel E past 1e-12 * sum|x| of its plain version")
    h_vals = vals.cpu().numpy()
    lo, hi = G.g_lo[:k].cpu().numpy(), G.g_hi[:k].cpu().numpy()
    exact = np.add.reduceat(h_vals.astype(np.longdouble), lo)
    absum = np.add.reduceat(np.abs(h_vals), lo)
    count = hi - lo
    h_got = got[:k].cpu().numpy()
    fin = np.isfinite(exact)
    # the long double sum's own error is (count - 1) * 2^-64 * sum|x|
    tol = (count - 1) * (np.finfo(np.float64).eps + 2.0 ** -63) * absum
    err = np.abs(h_got.astype(np.longdouble) - exact)
    require(bool((err[fin] <= tol[fin]).all())
            and np.array_equal(np.isnan(h_got), np.isnan(exact)),
            "kernel E past (count - 1) * eps * sum|x| of the exact sum")
    m = SUPPLIERS
    idx = G.gid.clamp(max=m)
    zeros = torch.zeros(m + 1, dtype=torch.float64, device=dev)
    b_ms, b_by = bound(vals.nbytes + G.g_lo.nbytes + G.g_hi.nbytes
                       + got.nbytes, n)
    row = dict(
        name=kss.NAME, route="cuda",
        source="spark_rapids_jni_tpu_torch/csrc/segment_sum.cu",
        replaces="spark_rapids_jni_tpu/ops/groupby.py:186 "
                 "(_segmented_sum_scan, an XLA scan)",
        max_abs_err=float((got - want)[~nan].abs().max()),
        ms=median_ms(lambda: kss._segment_sum_cuda(vals, G.gid, G.g_lo,
                                                   G.g_hi)),
        plain_ms=median_ms(lambda: kss.segment_sum_plain(vals, G.gid, m)),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=median_ms(lambda: zeros.index_add_(0, idx, vals)))
    skew = _one_group_sums(vals, dev)
    out["float_sums"] = dict(
        rows=n, groups=k, runs=FLOAT_SUM_RUNS, nan_groups=int(nan.sum()),
        max_rel_to_exact=float(np.max(err[fin] / np.maximum(
            absum[fin], 1e-300))), one_group=skew, **{x: row[x] for x in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "library_ms")})
    log(f"float sums by l_suppkey over {n} rows: {k} groups, kernel E once "
        f"a run, the same bits in {FLOAT_SUM_RUNS} runs, within 1e-12 * "
        f"sum|x| of the plain version and (count - 1) * eps * sum|x| of "
        f"the exact sum ({int(nan.sum())} NaN groups); E {row['ms']:.3f} ms "
        f"(plain {row['plain_ms']:.3f}, index_add_ {row['library_ms']:.3f}, "
        f"bound {b_ms:.3f} by {b_by}); the same rows in one group "
        f"{skew['ms']:.3f} ms (plain {skew['plain_ms']:.3f}, index_add_ "
        f"{skew['library_ms']:.3f})")
    return row, launched


def _one_group_sums(vals, dev) -> dict:
    """Kernel E with every row in one group (NaN rows read as 0.0, so the
    sum is finite): the same bits in ``FLOAT_SUM_RUNS`` runs, within its
    bounds of the plain version and of a long double sum, and its time
    beside the 100,000 groups' (the skew target: within 2x)."""
    import numpy as np

    from spark_rapids_jni_tpu_torch.ops.kernels import segment_sum as kss
    from spark_rapids_jni_tpu_torch.utils.timing import median_ms

    n = vals.shape[0]
    x = torch.nan_to_num(vals, nan=0.0)
    gid = torch.zeros(n, dtype=torch.int64, device=dev)
    lo = torch.zeros(1, dtype=torch.int64, device=dev)
    hi = torch.full((1,), n, dtype=torch.int64, device=dev)
    runs = [kss._segment_sum_cuda(x, gid, lo, hi)
            for _ in range(FLOAT_SUM_RUNS)]
    want = kss.segment_sum_plain(x, gid, 1)
    torch.cuda.synchronize()
    require(all(torch.equal(r.view(torch.int64), runs[0].view(torch.int64))
                for r in runs), "one group: sums differ between runs")
    got = float(runs[0][0])
    h = x.cpu().numpy()
    exact = np.sum(h.astype(np.longdouble))
    absum = float(np.abs(h).sum())
    require(abs(got - float(want[0])) <= kss.SUM_REL * absum
            and abs(np.longdouble(got) - exact) <= (n - 1) * (
                np.finfo(np.float64).eps + 2.0 ** -63) * absum,
            "one group: kernel E past its bounds")
    zeros = torch.zeros(2, dtype=torch.float64, device=dev)
    b_ms, _ = bound(x.nbytes + 24, n)
    return dict(
        max_abs_err=abs(got - float(want[0])),
        ms=median_ms(lambda: kss._segment_sum_cuda(x, gid, lo, hi)),
        plain_ms=median_ms(lambda: kss.segment_sum_plain(x, gid, 1)),
        library_ms=median_ms(lambda: zeros.index_add_(0, gid, x)),
        bound_ms=b_ms)


def refused_inputs_phase(dev) -> tuple:
    """Phase 22: what the card once refused, at full width on one H100.
    (a) the bounded plan over SF10's 100,000 supplier keys (kernel A in
    one pass; one float-sum lane in windows of groups); (b) rows of 1,632 and 65,000 bytes (kernel C's
    tiled path); (c) the general groupby's float sums in a
    fixed order (kernel E). Returns ({path: {kernel: launches}}, E's
    kernel row, the phase's numbers)."""
    from spark_rapids_jni_tpu_torch.columnar import Table
    from spark_rapids_jni_tpu_torch.models import tpch
    from spark_rapids_jni_tpu_torch.ops import kernels

    torch.cuda.reset_peak_memory_stats()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    kernels.reset_counts()
    tab, _ = tpch.lineitem_groupby_table(ROWS, Q3_ORDERS, SUPPLIERS)
    QTY, PRICE, SKEY, F64 = 0, 1, 8, 9
    gtab = Table([tab.column(SKEY), tab.column(QTY), tab.column(PRICE),
                  tab.column(F64)])
    q = ROWS // 4
    fcols = [tab.column(SKEY), tab.column(F64)]
    ftab = Table([type(c)(c.dtype, c.data[:q], None if c.validity is None
                          else c.validity[:q]) for c in fcols])
    del tab, fcols
    torch.cuda.synchronize()
    log(f"phase 22 tables: {ROWS} rows by l_suppkey in "
        f"{time.perf_counter() - t_phase:.1f} s")
    out = {}
    a = _bounded_suppliers_part(gtab, dev, out)
    del gtab
    torch.cuda.empty_cache()
    c = _wide_rows_part(dev, out)
    e_row, e = _float_sums_part(ftab, dev, out)
    del ftab
    torch.cuda.empty_cache()
    require(not kernels.fallbacks(), f"phase 22 fell back: "
            f"{kernels.fallbacks()}")
    out["s"] = time.perf_counter() - t_phase
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    log(f"phase 22 (what the card refused): {out['s']:.1f} s (target 60), "
        f"device peak {out['peak_gib']:.2f} GiB, launches A {a}, C {c}, "
        f"E {e}, no fallback")
    launches = {"bounded plan over supplier keys": {"A": a},
                "wide rows": {"C": c}}
    return launches, e_row, out


def _start_native_build():
    """Build the readers' native library on a thread while nvcc builds
    the kernels; the returned call waits for it and raises its error."""
    import threading

    from spark_rapids_jni_tpu_torch.runtime import native

    errors = []

    def build():
        try:
            native.load_native()
            native.load_rt_bridge()
        except BaseException as exc:  # re-raised on the main thread
            errors.append(exc)

    th = threading.Thread(target=build)
    th.start()

    def wait():
        th.join()
        if errors:
            raise errors[0]
        if native.build_seconds is None:
            log(f"native library: {native.load_native().path} (no build)")
        else:
            log(f"native library built in {native.build_seconds:.1f} s")
        log(f"bridge library {native.RT_LIB_NAME}: built in "
            f"{native.rt_build_seconds} s (None: current)")
        (OUT_DIR / "native_build.log").write_text("\n".join(
            (native.BUILD_DIR / name).read_text()
            for name in ("build.log", "rt_build.log")
            if (native.BUILD_DIR / name).exists()))

    return wait


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
    native_build = _start_native_build()
    _build.library()
    log(f"kernels built in {time.perf_counter() - t0:.1f} s "
        f"(nvcc {_build.build_seconds})")
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "kernels_build.log").write_text(
        (_build.BUILD_DIR / "build.log").read_text())
    native_build()

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
    q3_launches, q3_numbers, q3_oracle = q3_path_phase(*q3)
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
    rd_launches, path_times["readers"] = readers_phase(dev)
    ex_launches, path_times["executor_and_bridge"] = \
        executor_bridge_phase(dev)
    # launches none of A-D (checked after each of its parts)
    path_times["remaining_operators"] = operators_phase(dev)
    oc_launches, path_times["memory_outofcore"] = memory_outofcore_phase(
        dev, q1_oracle, q1_general, q3_oracle)
    sv_launches, path_times["serving"] = serving_phase(
        dev, q1_oracle, q1_general, q3_oracle)
    mx_launches, path_times["multiple_executors"] = multi_executor_phase(dev)
    xp_launches, path_times["across_processes"] = across_processes_phase(dev)
    rf_launches, kernel_rows["E"], path_times["refused_inputs"] = \
        refused_inputs_phase(dev)
    # each kernel's launches on every path that runs it, each read just
    # after its run
    by_plan = {**q3_launches, **ds_launches, **st_launches, **more_launches,
               **gb_launches, **{p: {"A": n.get("A", 0), "D": n.get("D", 0)}
                                 for p, n in rd_launches.items()},
               **ex_launches, **oc_launches, **sv_launches,
               **mx_launches, **xp_launches}
    kernel_rows["A"]["launches_by_path"] = {
        "tpch_q1_planned": launches[kernel_rows["A"]["name"]],
        **{p: n["A"] for p, n in by_plan.items() if n["A"]}}
    kernel_rows["D"]["launches_by_path"] = {
        p: n["D"] for p, n in by_plan.items() if n["D"]}
    kernel_rows["C"]["launches_by_path"] = {
        "row round trip": launches[kernel_rows["C"]["name"]],
        "bridge convert_to_rows": path_times["executor_and_bridge"][
            "bridge"]["convert_to_rows"]["launches"][kernel_rows["C"]["name"]]}
    # phases 1-21 alone, then phase 22's paths and E's wherever it ran
    earlier = {k: sum(kernel_rows[k]["launches_by_path"].values())
               for k in ("A", "C", "D")}
    log(f"launches of phases 1-21: A {earlier['A']}, C {earlier['C']}, "
        f"D {earlier['D']}")
    path_times["launches_phases_1_21"] = earlier
    for path, counts in rf_launches.items():
        for k, n in counts.items():
            kernel_rows[k]["launches_by_path"][path] = n
    kernel_rows["E"]["launches_by_path"] = dict(E_BY_PATH)
    for k in ("A", "C", "D", "E"):
        launches[kernel_rows[k]["name"]] = sum(
            kernel_rows[k]["launches_by_path"].values())

    report = {"kernels": []}
    for row in kernel_rows.values():
        report["kernels"].append(
            {**row, "launches": launches[row["name"]]})
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(
        {**report, "card": card, "rows": ROWS, **path_times,
         "peak_gib": peak, "torch": torch.__version__}, indent=1))
    log(f"chip_smoke: {time.perf_counter() - _T0:.1f} s")
    print(json.dumps(report))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
