"""Join probe: the match-run bounds of every probe key in the sorted build
keys, as one CUDA kernel.

Replaces the Pallas kernel ``spark_rapids_jni_tpu/ops/pallas/
hash_probe.py`` (``probe_lo_hi``, body ``_probe_kernel``). For each probe
key p over the sentinel-padded sorted build keys::

    lo = #(build <  p)   ==  searchsorted(build, p, side="left")
    hi = #(build <= p)   ==  searchsorted(build, p, side="right")

both int64. The sentinel tail counts like any key (a probe equal to the
dtype max counts the sentinels in ``hi``); the join clamps ``hi`` to its
valid prefix afterwards, so the kernel knows nothing of ``n_valid``.

The TPU kernel took only int32 keys and at most 2048 build keys
(``MAX_BUILD``, what its SMEM held), and fell back on anything else with
``key_width`` or ``build_too_large``. Every join key of the TPC-H and
TPC-DS generators is int64, so the reference never ran it on its own
queries. Here the build stays in device memory and is searched through a
sector-line index built at each launch, so neither cap exists and neither
reason can fire on the card: int32 keys take the int32 instance, every
other integer key the int64 one (uint64 through a sign-bit flip of both
sides, which keeps its order). Source: ``csrc/hash_probe.cu``, which says
what bounds it and how the index is laid out; :func:`probe_lo_hi_plain`
repeats its search step for step.
"""

from __future__ import annotations

import ctypes
import math

import torch

from spark_rapids_jni_tpu_torch.ops.kernels import (
    _build,
    count_launch,
    register_kernel,
)
from spark_rapids_jni_tpu_torch.ops.sort import order_key

NAME = "join.hash_probe"

register_kernel(
    NAME,
    oracle="spark_rapids_jni_tpu_torch.ops.kernels.hash_probe"
           ".probe_lo_hi_plain",
    source="csrc/hash_probe.cu",
    replaces="spark_rapids_jni_tpu/ops/pallas/hash_probe.py:114 "
             "probe_lo_hi",
    doc="per-probe-key match-run bounds [lo, hi) over the sorted build "
        "keys through a small index, no build-size cap",
)


def kernel_keys(sorted_key: torch.Tensor, probe_key: torch.Tensor):
    """Both sides in the kernel's key type, order kept: int32 stays,
    every other integer type becomes int64 (uint64 by a sign-bit flip)."""
    if sorted_key.dtype != probe_key.dtype:
        raise TypeError(f"{NAME}: build and probe keys differ in type "
                        f"({sorted_key.dtype} vs {probe_key.dtype})")
    if sorted_key.is_floating_point() or sorted_key.dtype == torch.bool:
        raise TypeError(f"{NAME}: keys must be integers, got "
                        f"{sorted_key.dtype}")
    if sorted_key.dtype == torch.int32:
        return sorted_key, probe_key
    return order_key(sorted_key), order_key(probe_key)


def probe_lo_hi(sorted_key: torch.Tensor, probe_key: torch.Tensor):
    """(lo, hi) int64[n]: the searchsorted left/right pair of every probe
    key in the sorted build keys. CUDA tensors launch the kernel, CPU
    tensors run :func:`probe_lo_hi_plain`."""
    build, probe = kernel_keys(sorted_key, probe_key)
    if build.is_cuda:
        return _probe_cuda(build, probe)
    return probe_lo_hi_plain(build, probe)


LINE_BYTES = 32   # bytes per index line (one L2 sector): the kernel's kLineBytes
TOP_KEYS = 16384  # most keys of the top level: the kernel's kTopKeys


def line_keys(dtype: torch.dtype) -> int:
    """Keys per index line, the index's fanout: 4 int64 or 8 int32."""
    return LINE_BYTES // dtype.itemsize


def level_sizes(s: int, line: int, top_keys: int = TOP_KEYS) -> list[int]:
    """Sizes of the index levels over the build's first ``s`` keys:
    c_0 = s, c_(k+1) = ceil(c_k / line), up to the first level of at most
    ``top_keys`` keys (the top)."""
    sizes = [s]
    while sizes[-1] > top_keys:
        sizes.append(-(-sizes[-1] // line))
    return sizes


def _bisect(keys: torch.Tensor, probe: torch.Tensor, lo: torch.Tensor,
            hi: torch.Tensor, strict: bool, rounds: int) -> torch.Tensor:
    """First index in [lo, hi) whose key is not below the probe
    (``strict``: not below or equal), else ``hi``: the kernel's bisection,
    one vectorized round per halving."""
    m = keys.shape[0]
    for _ in range(rounds):
        active = lo < hi
        mid = lo + ((hi - lo) >> 1)
        key = keys[mid.clamp(0, max(m - 1, 0))]
        right = active & ((key <= probe) if strict else (key < probe))
        lo = torch.where(right, mid + 1, lo)
        hi = torch.where(active & ~right, mid, hi)
    return lo


def _scan_line(keys: torch.Tensor, base: torch.Tensor, probe: torch.Tensor,
               strict: bool, line: int) -> torch.Tensor:
    """Keys of the ``line``-key line at ``base`` below the probe
    (``strict``: below or equal); keys past the end count as the max,
    i.e. never."""
    n_keys = keys.shape[0]
    count = torch.zeros_like(base)
    for q in range(line):
        idx = base + q
        key = keys[idx.clamp(max=n_keys - 1)]
        hit = (key <= probe) if strict else (key < probe)
        count += (hit & (idx < n_keys)).to(torch.int64)
    return count


def _gallop_above(build: torch.Tensor, probe: torch.Tensor,
                  start: torch.Tensor, s: int) -> torch.Tensor:
    """First index in [start, s) whose key is above the probe, given that
    the key before ``start`` is not: keys at start, start+2, start+5, ...
    (the step doubling) until one is above the probe or s, then a
    bisection of the last step. ceil(log2(s+1)) rounds bound each."""
    rounds = math.ceil(math.log2(s + 1))
    a, h, step = start, start, torch.ones_like(start)
    for _ in range(rounds + 1):
        go = (h < s) & (build[h.clamp(max=s - 1)] <= probe)
        a = torch.where(go, h + 1, a)
        h = torch.where(go, h + 1 + step, h)
        step = torch.where(go, step * 2, step)
    return _bisect(build, probe, a, h.clamp(max=s), True, rounds)


def probe_lo_hi_plain(build: torch.Tensor, probe: torch.Tensor,
                      top_keys: int = TOP_KEYS):
    """Plain PyTorch version of the kernel over keys already in the
    kernel's type, step for step:

    - s = #(build < max): keys at [s, m) are the max, so a probe equal to
      the max gets (s, m) and every other probe stays inside [0, s);
    - the index over [0, s), fanout F = :func:`line_keys` (one 32-byte
      line): level k holds build[min(F^k (j+1) - 1, s-1)] for
      j < ceil(s / F^k), up to the top level of at most ``top_keys`` keys
      (:func:`level_sizes`);
    - a bisection of the top (ceil(log2(c_top + 1)) rounds); if the top
      is the build itself, a second bisection from ``lo`` gives ``hi``;
    - else one F-key line per lower level: j <- F j + #(line < p); the
      build's own line gives lo and hi = F j + #(line <= p), and a line
      whose F keys are all <= p gallops on from its end.
    """
    m, n = build.shape[0], probe.shape[0]
    device = probe.device
    if m == 0:
        zero = torch.zeros((n,), dtype=torch.int64, device=device)
        return zero, zero.clone()
    top_val = torch.iinfo(build.dtype).max
    at_max = probe == top_val
    s = int((build < top_val).sum())
    lo = torch.full((n,), s, dtype=torch.int64, device=device)
    hi = lo.clone()
    if s > 0:
        line = line_keys(build.dtype)
        sizes = level_sizes(s, line, top_keys)
        t = len(sizes) - 1
        pos = [torch.arange(1, c + 1, dtype=torch.int64, device=device)
               for c in sizes]
        levels = [build[:s]] + [
            build[(pos[k] * line ** k - 1).clamp(max=s - 1)]
            for k in range(1, t + 1)]
        top, c_top = levels[t], sizes[t]
        rounds = math.ceil(math.log2(c_top + 1))
        zero = torch.zeros((n,), dtype=torch.int64, device=device)
        j = _bisect(top, probe, zero, torch.full_like(zero, c_top), False,
                    rounds)
        if t == 0:
            lo = j
            hi = _bisect(top, probe, j, torch.full_like(zero, s), True,
                         rounds)
        else:
            above_all = j == c_top
            j = j.clamp(max=c_top - 1)
            for k in range(t - 1, 0, -1):
                j = j * line + _scan_line(levels[k], j * line, probe, False,
                                          line)
            base = j * line
            lt = _scan_line(build, base, probe, False, line)
            le = _scan_line(build, base, probe, True, line)
            hi_line = base + le
            full = ((le == line) & ~at_max).nonzero().squeeze(1)
            if full.numel():
                hi_line[full] = _gallop_above(build, probe[full],
                                              base[full] + line, s)
            lo = torch.where(above_all, s, base + lt)
            hi = torch.where(above_all, s, hi_line)
    lo = torch.where(at_max, s, lo)
    hi = torch.where(at_max, m, hi)
    return lo, hi


def _probe_cuda(build: torch.Tensor, probe: torch.Tensor):
    if build.dtype not in (torch.int32, torch.int64) \
            or probe.dtype != build.dtype or build.ndim != 1 \
            or probe.ndim != 1 or probe.device != build.device:
        raise TypeError(f"{NAME}: keys must be int32 or int64 vectors of "
                        f"one type on one device")
    device = probe.device
    build, probe = build.contiguous(), probe.contiguous()
    if build.data_ptr() % 16:
        build = build.clone()  # the kernel reads 16-byte vectors
    n, m = probe.shape[0], build.shape[0]
    bits = build.dtype.itemsize * 8
    lo, hi = torch.empty((2, n), dtype=torch.int64, device=device)
    if n == 0:
        return lo, hi  # nothing to probe, nothing to launch
    index_bytes = _build.function(
        "srjt_hash_probe_index_bytes", [ctypes.c_int64, ctypes.c_int32],
        restype=ctypes.c_int64)(m, bits)
    index = torch.empty((index_bytes,), dtype=torch.uint8, device=device)
    fn = _build.function("srjt_hash_probe", [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_int32, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int32, ctypes.c_void_p])
    count_launch(NAME)
    status = fn(build.data_ptr(), m, probe.data_ptr(), n, bits,
                index.data_ptr(), lo.data_ptr(), hi.data_ptr(),
                _build.sm_count(device), _build.stream_handle(device))
    _build.check(status, NAME)
    return lo, hi
