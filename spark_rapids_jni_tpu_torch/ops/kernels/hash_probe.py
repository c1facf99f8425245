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
queries. Here the build stays in device memory and each thread searches
it twice (a binary search for ``lo``, then a galloping search from
``lo`` for ``hi``), so neither cap exists and neither reason can fire on
the card: int32 keys take the int32 instance, every other
integer key the int64 one (uint64 through a sign-bit flip of both sides,
which keeps its order). Source: ``csrc/hash_probe.cu``, which says what
bounds it.
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
        "keys: two binary searches per thread, no build-size cap",
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


def _bisect(build: torch.Tensor, probe: torch.Tensor, lo: torch.Tensor,
            hi: torch.Tensor, strict: bool, rounds: int) -> torch.Tensor:
    """First index in [lo, hi) whose key is not below the probe
    (``strict``: not below or equal), else ``hi``: the kernel's bisection,
    one vectorized round per halving."""
    m = build.shape[0]
    for _ in range(rounds):
        active = lo < hi
        mid = lo + ((hi - lo) >> 1)
        key = build[mid.clamp(max=m - 1)]
        right = active & ((key <= probe) if strict else (key < probe))
        lo = torch.where(right, mid + 1, lo)
        hi = torch.where(active & ~right, mid, hi)
    return lo


def probe_lo_hi_plain(build: torch.Tensor, probe: torch.Tensor):
    """Plain PyTorch version of the kernel over keys already in the
    kernel's type, round for round: ``lo`` by bisecting [0, m); ``hi`` by
    galloping from ``lo`` (keys at lo, lo+2, lo+5, ..., the step doubling,
    until one is above the probe or the end), then bisecting the last
    step. R = ceil(log2(m+1)) rounds bound each phase."""
    m = build.shape[0]
    zero = torch.zeros(probe.shape, dtype=torch.int64, device=probe.device)
    if m == 0:
        return zero, zero.clone()
    rounds = math.ceil(math.log2(m + 1))
    lo = _bisect(build, probe, zero, torch.full_like(zero, m), False, rounds)
    # after k gallop rounds hi >= lo + 2^k, so R rounds reach the end
    a, hi, step = lo, lo, torch.ones_like(lo)
    for _ in range(rounds):
        go = (hi < m) & (build[hi.clamp(max=m - 1)] <= probe)
        a = torch.where(go, hi + 1, a)
        hi = torch.where(go, hi + 1 + step, hi)
        step = torch.where(go, step * 2, step)
    return lo, _bisect(build, probe, a, hi.clamp(max=m), True, rounds)


def _probe_cuda(build: torch.Tensor, probe: torch.Tensor):
    if build.dtype not in (torch.int32, torch.int64) \
            or probe.dtype != build.dtype or build.ndim != 1 \
            or probe.ndim != 1 or probe.device != build.device:
        raise TypeError(f"{NAME}: keys must be int32 or int64 vectors of "
                        f"one type on one device")
    device = probe.device
    build, probe = build.contiguous(), probe.contiguous()
    n, m = probe.shape[0], build.shape[0]
    lo = torch.empty((n,), dtype=torch.int64, device=device)
    hi = torch.empty((n,), dtype=torch.int64, device=device)
    if n == 0:
        return lo, hi  # nothing to probe, nothing to launch
    fn = _build.function("srjt_hash_probe", [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_int32, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32,
        ctypes.c_void_p])
    count_launch(NAME)
    status = fn(build.data_ptr(), m, probe.data_ptr(), n,
                build.dtype.itemsize * 8, lo.data_ptr(), hi.data_ptr(),
                _build.sm_count(device), _build.stream_handle(device))
    _build.check(status, NAME)
    return lo, hi
