"""Device times of kernels A (bounded accumulate), B (fused q1) and D
(join probe) alone, for comparing two versions of their sources on one
card in one call.

Usage, from the root of a checkout (or of a copy of it whose ``csrc/``
holds a variant of a kernel)::

    python3 -m spark_rapids_jni_tpu_torch.bench_kernels            # main path
    python3 -m spark_rapids_jni_tpu_torch.bench_kernels --q1       # A and B
    python3 -m spark_rapids_jni_tpu_torch.bench_kernels --large    # A, m > 16

Main path: A over TPC-H q1's work table at SF10 (59,986,052 lineitem rows,
m = 12 slots, 11 lanes); B over the same lineitem's seven q1 columns
(``B_exact``: its result equals ``q1_partials_plain``'s, so a variant of
``csrc/q1.cu`` is timed beside its check); D at both joins of TPC-H q3 at
SF10 (join 1: 15,000,000 order custkeys into the 1,500,000-slot customer
build; join 2: the filtered lineitem orderkeys into the 15,000,000-slot
build of join 1's output). ``--q1`` stops after A and B. ``--large``: A's
warp-aggregated side, which no TPC-H path reaches, over 59,986,052 rows
at m = 64 (8 lanes: sums, counts, a min and a max, with and without
validity) and at m = 2048 (1 sum lane, the m * L cap), with group ids
uniform over [0, m] (rows in no group included) or all in one group.
Each time is the median of 7 runs between CUDA events after one warm-up
(``utils/timing.py``). Prints one JSON line with the card's name and
power limit.
"""

from __future__ import annotations

import json
import sys

import torch

SF10_ROWS = 59_986_052
CUSTOMERS, ORDERS = 1_500_000, 15_000_000


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


def large_domains(report: dict) -> None:
    from spark_rapids_jni_tpu_torch.ops.kernels import groupby_accumulate as kga
    from spark_rapids_jni_tpu_torch.utils.timing import median_ms

    n, dev = SF10_ROWS, torch.device("cuda")
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
        assert kga.unsupported_reason(lanes, m) is None
        for ids in ("uniform", "one_group"):
            gid = (torch.randint(0, m + 1, (n,), generator=gen, device=dev,
                                 dtype=torch.int32) if ids == "uniform"
                   else torch.full((n,), m - 1, dtype=torch.int32, device=dev))
            report[f"A_m{m}_L{len(lanes)}_{ids}_ms"] = median_ms(
                lambda: kga._accumulate_cuda(gid, lanes, m))


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        print("bench_kernels: no CUDA device", file=sys.stderr)
        return 1
    from spark_rapids_jni_tpu_torch.ops.kernels import groupby_accumulate
    from spark_rapids_jni_tpu_torch.utils.platform import card_line

    report = {"card": card_line(), "package": groupby_accumulate.__file__}
    if "--large" in argv:
        large_domains(report)
    else:
        main_path(report, q1_only="--q1" in argv)
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
