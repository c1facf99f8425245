"""Device timing on the card: the one clock ``chip_smoke.py`` and
``bench_kernels`` read."""

from __future__ import annotations

import statistics

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
