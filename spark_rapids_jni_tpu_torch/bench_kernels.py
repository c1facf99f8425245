"""Device times of kernels A (bounded accumulate), B (fused q1) and D
(join probe) alone, for comparing two versions of their sources on one
card in one call.

Usage, from the root of a checkout (or of a copy of it whose ``csrc/``
holds a variant of a kernel)::

    python3 -m spark_rapids_jni_tpu_torch.bench_kernels            # main path
    python3 -m spark_rapids_jni_tpu_torch.bench_kernels --q1       # A and B
    python3 -m spark_rapids_jni_tpu_torch.bench_kernels --large    # A, m > 16
    python3 -m spark_rapids_jni_tpu_torch.bench_kernels --sass     # atomics

Main path: A over TPC-H q1's work table at SF10 (59,986,052 lineitem rows,
m = 12 slots, 11 lanes); B over the same lineitem's seven q1 columns
(``B_exact``: its result equals ``q1_partials_plain``'s, so a variant of
``csrc/q1.cu`` is timed beside its check); D at both joins of TPC-H q3 at
SF10 (join 1: 15,000,000 order custkeys into the 1,500,000-slot customer
build; join 2: the filtered lineitem orderkeys into the 15,000,000-slot
build of join 1's output). ``--q1`` stops after A and B.

``--large``: A's side past 16 groups, over SF10's 59,986,052 rows:

- planned q1's, q12's and q4's A (m = 12, 3 and 6: the small kernel) and
  q5's (m = 26, ~99.9 % of the rows in its null slot), the main path's
  shapes beside it;
- m = 64 (8 lanes: sums, counts, a min and a max, with and without
  validity) and m = 2048 (1 sum lane), group ids uniform over [0, m]
  (rows in no group included) or all in one group;
- the planned monthly rollup of ``chip_smoke.py``'s phase 14 at full SF10
  (``lineitem_groupby_table``, m = 1,032, 16 lanes, 931 live groups),
  all 16 lanes, then split by lane kind: the float-sum lane alone, the
  float and uint64 min/max (4 lanes), the integer sums and counts (7)
  and the integer min/max (4);
- phase 22's bounded plan over the 100,000 supplier keys (m = 100,001,
  q15's 9 lanes by l_suppkey) with the ids as they are, with every row in
  one group, and with half the rows in one hot group; then one float-sum
  lane (the FLOAT64 price) at m = 100,001.

Each ``--large`` shape is checked once against the plain version (exact,
float sums within ``FLOAT_SUM_REL * sum|x|``: ``*_exact``) and its
launches counted (``*_launches``). ``--sass``: the kernel library's
atomic instructions per kernel (``cuobjdump -sass``; a 64-bit shared
add/min/max shows as ``ATOMS.CAST.SPIN.64``, a compare-and-swap loop).
Each time is the median of 7 runs between CUDA events after one warm-up
(``utils/timing.py``), the wrapper included. Prints one JSON line with
the card's name and power limit.
"""

from __future__ import annotations

import json
import sys

import torch

SF10_ROWS = 59_986_052
CUSTOMERS, ORDERS = 1_500_000, 15_000_000
SUPPLIERS = 100_000  # TPC-H SF10 supplier


def main_path(report: dict, q1_only: bool) -> None:
    from spark_rapids_jni_tpu_torch.models import tpch
    from spark_rapids_jni_tpu_torch.ops.kernels import (
        groupby_accumulate as kga,
        hash_probe as khp,
        q1 as kq1,
    )
    from spark_rapids_jni_tpu_torch.utils.timing import median_ms

    li = tpch.lineitem_table(SF10_ROWS, seed=0)
    gid, lanes, m = tpch.q1_accumulate_inputs(li)
    report["A_ms"] = median_ms(lambda: kga._accumulate_cuda(gid, lanes, m))
    del gid, lanes
    cols = [li.column(i).data for i in kq1._COLUMNS]
    report["B_exact"] = torch.equal(kq1._q1_partials_cuda(*cols),
                                    kq1.q1_partials_plain(*cols))
    report["B_ms"] = median_ms(lambda: kq1._q1_partials_cuda(*cols))
    del li, cols
    torch.cuda.empty_cache()
    if q1_only:
        return

    q3 = (tpch.customer_table(CUSTOMERS), tpch.orders_table(ORDERS, CUSTOMERS),
          tpch.lineitem_q3_table(SF10_ROWS, ORDERS))
    for name, (build, n_valid, probe) in zip(("join1", "join2"),
                                             tpch.q3_probe_inputs(*q3)):
        report[f"D_{name}_ms"] = median_ms(
            lambda: khp._probe_cuda(build, probe))
        report[f"D_{name}_shape"] = [build.shape[0], int(n_valid),
                                     probe.shape[0]]


def _time_accumulate(report: dict, key: str, gid, lanes, m) -> None:
    """A at one shape: its ms, launches, and whether it equals the plain
    version (float sums within their bound)."""
    from spark_rapids_jni_tpu_torch.ops import kernels
    from spark_rapids_jni_tpu_torch.ops.kernels import groupby_accumulate as kga
    from spark_rapids_jni_tpu_torch.utils.timing import median_ms

    assert kga.unsupported_reason(lanes, m) is None
    kernels.reset_counts()
    got = kga._accumulate_cuda(gid, lanes, m)
    report[f"{key}_launches"] = kernels.launches(kga.NAME)
    want = kga.accumulate_plain(gid, lanes, m)
    exact = True
    for i, lane in enumerate(lanes):
        if lane.op == "sum" and lane.values is not None \
                and lane.values.is_floating_point():
            g, w = got[:, i].view(torch.float64), want[:, i].view(torch.float64)
            nan = torch.isnan(w)
            near = (g - w).abs() <= kga.float_sum_bound(gid, lane, m)
            exact &= bool(((torch.isnan(g) == nan) & (nan | near)).all())
        else:
            exact &= torch.equal(got[:, i], want[:, i])
    report[f"{key}_exact"] = exact
    del got, want
    report[f"{key}_ms"] = median_ms(
        lambda: kga._accumulate_cuda(gid, lanes, m))


def large_domains(report: dict, dev=None) -> None:
    import numpy as np

    from spark_rapids_jni_tpu_torch.columnar import Table
    from spark_rapids_jni_tpu_torch.models import tpch
    from spark_rapids_jni_tpu_torch.ops.kernels import groupby_accumulate as kga
    from spark_rapids_jni_tpu_torch.ops.planner import (
        bounded_accumulate_inputs,
        month_bucket,
        month_domain,
        scalar_domain,
    )

    n, dev = SF10_ROWS, dev or torch.device("cuda")
    # the main path's shapes that share this code: planned q1 (m = 12,
    # the small kernel) and q5 (m = 26, one hot slot)
    li = tpch.lineitem_table(n, seed=0, device=dev)
    _time_accumulate(report, "A_q1", *tpch.q1_accumulate_inputs(li))
    del li
    q5 = (tpch.customer_q5_table(CUSTOMERS, device=dev),
          tpch.orders_table(ORDERS, CUSTOMERS, device=dev),
          tpch.lineitem_q5_table(n, ORDERS, SUPPLIERS, device=dev),
          tpch.supplier_table(SUPPLIERS, device=dev),
          tpch.nation_table(device=dev))
    _time_accumulate(report, "A_q5", *tpch.q5_accumulate_inputs(*q5))
    del q5
    li12 = tpch.lineitem_q12_table(n, ORDERS, device=dev)
    _time_accumulate(report, "A_q12", *tpch.q12_accumulate_inputs(
        tpch.orders_q12_table(ORDERS, device=dev), li12))
    _time_accumulate(report, "A_q4", *tpch.q4_accumulate_inputs(
        tpch.orders_q4_table(ORDERS, device=dev), li12))
    del li12
    torch.cuda.empty_cache()
    gen = torch.Generator(device=dev).manual_seed(0)
    i64 = torch.randint(-2**40, 2**40, (n,), generator=gen, device=dev)
    i32 = torch.randint(-2**31, 2**31, (n,), generator=gen, device=dev,
                        dtype=torch.int32)
    i8 = torch.randint(-128, 128, (n,), generator=gen, device=dev,
                       dtype=torch.int8)
    valid = torch.rand(n, generator=gen, device=dev) > 0.1
    lanes_64 = [kga.Lane("sum", i64, valid, 0), kga.Lane("sum", i32, None, 0),
                kga.Lane("sum", None, None, 0), kga.Lane("sum", None, valid, 0),
                kga.Lane("min", i64, valid, 2**63 - 1),
                kga.Lane("max", i64, None, -2**63),
                kga.Lane("sum", i8, valid, 0),
                kga.Lane("max", i32, valid, -2**31)]
    for m, lanes in ((64, lanes_64), (2048, [kga.Lane("sum", i64, valid, 0)])):
        for ids in ("uniform", "one_group"):
            gid = (torch.randint(0, m + 1, (n,), generator=gen, device=dev,
                                 dtype=torch.int32) if ids == "uniform"
                   else torch.full((n,), m - 1, dtype=torch.int32, device=dev))
            _time_accumulate(report, f"A_m{m}_L{len(lanes)}_{ids}", gid,
                             lanes, m)
    del i64, i32, i8, valid, lanes_64, gid
    torch.cuda.empty_cache()

    # the monthly rollup and the supplier keys over one table
    tab, _ = tpch.lineitem_groupby_table(n, ORDERS, SUPPLIERS, device=dev)
    QTY, PRICE, RFLAG, LSTAT, SHIP, SKEY, F64, U64 = 0, 1, 4, 5, 6, 8, 9, 10
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
    gid, lanes, m = bounded_accumulate_inputs(work, [0, 1, 2], aggs, domains)
    del work

    def kind(lane):
        if lane.values is None or not lane.values.is_floating_point() \
                and lane.values.dtype != torch.uint64:
            return "int_sums_counts" if lane.op == "sum" else "int_minmax"
        return "float_sum" if lane.op == "sum" else "float_uint64_minmax"

    report["A_rollup_m"] = m
    report["A_rollup_live_groups"] = int(torch.unique(gid).numel())
    _time_accumulate(report, f"A_rollup_all{len(lanes)}", gid, lanes, m)
    for k in ("float_sum", "float_uint64_minmax", "int_sums_counts",
              "int_minmax"):
        pick = [ln for ln in lanes if kind(ln) == k]
        _time_accumulate(report, f"A_rollup_{k}{len(pick)}", gid, pick, m)
    del gid, lanes
    torch.cuda.empty_cache()

    supplier_aggs = [(1, "sum"), (1, "count"), (2, "sum"), (2, "count"),
                     (1, "min"), (1, "max"), (2, "min"), (2, "max")]
    gtab = Table([tab.column(SKEY), tab.column(QTY), tab.column(PRICE)])
    gid, lanes, m = bounded_accumulate_inputs(
        gtab, [0], supplier_aggs, [scalar_domain(range(1, SUPPLIERS + 1))])
    report["A_suppliers_m"] = m
    _time_accumulate(report, f"A_suppliers_L{len(lanes)}", gid, lanes, m)
    one = torch.full_like(gid, 1)
    _time_accumulate(report, f"A_suppliers_L{len(lanes)}_one_group", one,
                     lanes, m)
    hot = torch.where(torch.rand(n, generator=gen, device=dev) < 0.5, one,
                      gid)
    _time_accumulate(report, f"A_suppliers_L{len(lanes)}_hot_half", hot,
                     lanes, m)
    del one, hot
    f64 = tab.column(F64)
    _time_accumulate(report, "A_suppliers_float_sum1", gid,
                     [kga.Lane("sum", f64.data, f64.validity, 0.0)], m)


def sass_atomics(report: dict) -> None:
    """The library's atomic instructions per kernel of A, from
    ``cuobjdump -sass`` (demangled with ``cu++filt`` where present)."""
    import collections
    import re
    import shutil
    import subprocess
    from pathlib import Path

    from spark_rapids_jni_tpu_torch.ops.kernels import _build

    _build.library()
    lib = _build.BUILD_DIR / _build.LIB_NAME
    tools = Path("/usr/local/cuda/bin")
    cuobjdump = shutil.which("cuobjdump") or str(tools / "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    counts: dict = collections.defaultdict(collections.Counter)
    fn = None
    for line in sass.splitlines():
        head = re.search(r"Function : (\S+)", line)
        if head:
            fn = head.group(1)
            continue
        for op in re.findall(r"\b((?:ATOM|RED)[A-Z0-9_.]*)", line):
            if op.startswith("REDUX"):  # a warp reduction, no atomic
                continue
            counts[fn][op] += 1
    names = [f for f in counts if "accumulate" in f or "cells" in f]
    filt = shutil.which("cu++filt") or str(tools / "cu++filt")
    demangled = names
    if names and Path(filt).exists():
        demangled = subprocess.run([filt], input="\n".join(names),
                                   capture_output=True, text=True,
                                   check=True).stdout.split("\n")
    report["A_sass_atomics"] = {
        d.strip(): dict(counts[f]) for f, d in zip(names, demangled)}


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        print("bench_kernels: no CUDA device", file=sys.stderr)
        return 1
    from spark_rapids_jni_tpu_torch.ops.kernels import groupby_accumulate
    from spark_rapids_jni_tpu_torch.utils.platform import card_line

    report = {"card": card_line(), "package": groupby_accumulate.__file__}
    if "--sass" in argv:
        sass_atomics(report)
    elif "--large" in argv:
        large_domains(report)
    else:
        main_path(report, q1_only="--q1" in argv)
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
