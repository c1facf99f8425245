"""Device timing on the card: the one clock ``chip_smoke.py`` and
``bench_kernels`` read."""

from __future__ import annotations

import statistics
import time

import torch


def median_ms(fn, reps: int = 7) -> float:
    """Median device time of ``fn()`` in ms: one warm-up, then ``reps``
    runs, each between two CUDA events (the host work ``fn`` does before
    its launches is inside the events)."""
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


def host_device_ms(prepare, launch, reps: int = 7) -> tuple[float, float]:
    """(host ms, device ms) of a wrapper split at its launch: the median
    host-clock time of ``prep = prepare()`` (its checks, descriptors and
    allocations, up to the launch) and the median time between two CUDA
    events around ``launch(prep)`` alone; one warm-up of each."""
    launch(prepare())
    torch.cuda.synchronize()
    host, device = [], []
    for _ in range(reps):
        t0 = time.perf_counter()
        prep = prepare()
        host.append((time.perf_counter() - t0) * 1e3)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        launch(prep)
        end.record()
        torch.cuda.synchronize()
        device.append(start.elapsed_time(end))
    return statistics.median(host), statistics.median(device)
