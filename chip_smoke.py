#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (spark_rapids_jni_tpu_torch).

Usage: python3 chip_smoke.py            (one CUDA device; no arguments)

Phases, each of which fails the run (non-zero exit) when it fails:

1. the card's name and power limit, the torch version, and the build of
   the CUDA kernels from ``spark_rapids_jni_tpu_torch/csrc``;
2. TPC-H lineitem at scale factor 10 (59,986,052 rows) on the card;
3. each kernel at the main path's shapes against its plain PyTorch
   version on the same inputs (exact equality), with median times over
   REPS runs after a warm-up, CUDA events around each run;
4. the three paths through the entry points a user calls, each with the
   launch counts set to 0 just before it and read just after:
   planned q1 (accumulate kernel), fused q1 (q1 kernel), and the row
   round trip (row transpose kernel); results checked against the numpy
   oracle, against each other and against the input;
5. one ``{"kernels": [...]}`` line, the card line, and the final
   ``{"ok": true, "device": {...}}`` line.

A JSON copy of the report goes to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import json
import statistics
import sys
import time
from pathlib import Path

import torch

SF10_ROWS = 59_986_052     # TPC-H SF10 lineitem
ROWS = SF10_ROWS
REPS = 7                   # timed runs per measurement, after one warm-up
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (data sheet)
SCALAR_OPS_PER_S = 67e12   # H100 SXM float32 rate outside the tensor cores
OUT_DIR = Path(__file__).resolve().parent / "chiprun_out"


def log(msg: str) -> None:
    print(msg, flush=True)


def median_ms(fn, reps: int = REPS) -> float:
    """Median device time of ``fn()`` in ms: one warm-up, then ``reps``
    runs, each between two CUDA events."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def host_median_s(fn, reps: int = 3) -> float:
    """Median wall time of ``fn()`` ending in a synchronize, in seconds."""
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


def kernel_phases(li, dev):
    """Each kernel against its plain version at the main path's shapes."""
    from spark_rapids_jni_tpu_torch.models import tpch
    from spark_rapids_jni_tpu_torch.ops import groupby
    from spark_rapids_jni_tpu_torch.ops.bytecast import to_bytes
    from spark_rapids_jni_tpu_torch.ops.kernels import (
        groupby_accumulate as kga,
        q1 as kq1,
        row_transpose as krt,
    )
    from spark_rapids_jni_tpu_torch.ops.planner import scalar_domain
    from spark_rapids_jni_tpu_torch.ops.row_conversion import (
        compute_fixed_width_layout,
    )

    n = li.num_rows
    rows = {}

    # A: the bounded accumulate over the q1 work table, m = 12
    work = tpch._q1_work_table(li)
    domains = [scalar_domain(tpch._Q1_RF_DOMAIN).values,
               scalar_domain(tpch._Q1_LS_DOMAIN).values]
    _, m, _, _ = groupby.bounded_group_layout([len(d) for d in domains])
    gid, _ = groupby.dense_gid(work, (0, 1), domains, m, None)
    lanes = groupby.bounded_lanes(work, tpch._Q1_AGGS).lanes
    got = kga._accumulate_cuda(gid, lanes, m)
    want = kga.accumulate_plain(gid, lanes, m)
    torch.cuda.synchronize()
    require(torch.equal(got, want), "accumulate kernel != plain version")
    sum_lanes = [ln for ln in lanes if ln.op == "sum" and ln.values is not None]
    stacked = torch.stack([kga._lane_values(ln, n, dev) for ln in sum_lanes],
                          dim=1)
    lib = median_ms(lambda: torch.zeros(
        (m + 1, len(sum_lanes)), dtype=torch.int64, device=dev
    ).index_add_(0, gid, stacked))
    del stacked
    nbytes = distinct_bytes(
        [gid] + [ln.values for ln in lanes] + [ln.valid for ln in lanes]
    ) + got.nbytes
    b_ms, b_by = bound(nbytes, n * len(lanes))
    rows["A"] = dict(
        name=kga.NAME, route="cuda",
        source="spark_rapids_jni_tpu_torch/csrc/groupby_accumulate.cu",
        replaces="spark_rapids_jni_tpu/ops/pallas/groupby_accumulate.py:178",
        max_abs_err=max_abs_err(got, want),
        ms=median_ms(lambda: kga._accumulate_cuda(gid, lanes, m)),
        plain_ms=median_ms(lambda: kga.accumulate_plain(gid, lanes, m)),
        bound_ms=b_ms, bound_by=b_by, library_ms=lib)
    log(f"kernel A {kga.NAME}: m={m} lanes={len(lanes)} exact; "
        f"{rows['A']['ms']:.3f} ms (plain {rows['A']['plain_ms']:.3f}, "
        f"index_add_ {lib:.3f}, bound {b_ms:.3f})")
    del work, gid, lanes, got, want

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
    return launches, {"q1_planned_s": s_planned, "q1_fused_s": s_fused}


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

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    li = tpch.lineitem_table(ROWS, seed=0)
    torch.cuda.synchronize()
    log(f"lineitem: {ROWS} rows on {dev} in {time.perf_counter() - t0:.1f} s")

    torch.cuda.reset_peak_memory_stats()
    kernel_rows = kernel_phases(li, dev)
    launches, path_times = path_phases(li)
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"peak device memory {peak:.2f} GiB")

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
