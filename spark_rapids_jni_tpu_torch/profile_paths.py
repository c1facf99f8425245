"""Where the time goes in the PyTorch/CUDA port's three paths, on the card.

Usage: python3 -m spark_rapids_jni_tpu_torch.profile_paths

For planned q1, fused q1 and convert_to_rows over TPC-H lineitem at scale
factor 10 (59,986,052 rows), after a warm-up: the wall time per run
(host clock around work that ends in a synchronize), then one
``torch.profiler`` window of REPS runs with the device time of each
kernel and copy, and the device's busy share of the window (their summed
device time over the window's wall time, profiler overhead included).
Chrome traces go to ``chiprun_out/profile_<path>.json``.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from spark_rapids_jni_tpu_torch.models import tpch
from spark_rapids_jni_tpu_torch.ops.kernels import _build, q1 as kq1
from spark_rapids_jni_tpu_torch.ops.row_conversion import convert_to_rows
from spark_rapids_jni_tpu_torch.utils.platform import card_line

ROOT = Path(__file__).resolve().parents[1]
ROWS = 59_986_052  # TPC-H SF10 lineitem
REPS = 5


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
    for us, count, key in rows[:12]:
        print(f"   {us / reps / 1e3:9.3f} ms/run  x{count // reps:<3} {key[:90]}")
    prof.export_chrome_trace(str(out_dir / f"profile_{name}.json"))


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_paths: no CUDA device", file=sys.stderr)
        return 1
    print(f"card: {card_line()}; torch {torch.__version__}")
    _build.library()
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    li = tpch.lineitem_table(ROWS, seed=0)
    profile_path("q1_planned", lambda: tpch.tpch_q1_planned(li), REPS,
                 out_dir)
    profile_path("q1_fused", lambda: kq1.tpch_q1_pallas(li), REPS,
                 out_dir)
    profile_path("to_rows", lambda: convert_to_rows(li), REPS, out_dir)
    return 0


if __name__ == "__main__":
    sys.exit(main())
