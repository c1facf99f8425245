"""The general groupby's float64 group sums in a fixed order, as one CUDA
kernel.

Replaces no Pallas kernel: it is the counterpart of the reference's
``_segmented_sum_scan`` (``spark_rapids_jni_tpu/ops/groupby.py``), an
associative scan that XLA runs in an order fixed by its shape. Source:
``csrc/segment_sum.cu``, which says how the order is fixed (chunks of
``CHUNK`` rows, each summed by a warp in a fixed tree, the chunk sums of a
group folded in index order), what bounds it on an H100 (bytes) and how
its warps find their rows (blocks of ``CHUNK`` sorted rows and each
row's group id: no prefix pass, no search).

Group ``g`` is the contiguous sorted rows ``[g_lo[g], g_hi[g])``; rows of
groups past ``m`` belong to no range and are dropped. The kernel's sums
repeat bit for bit run to run, whatever its grid; the plain version
(``index_add_``, the general groupby's body before the kernel) adds in
another order, so the two agree within ``SUM_REL * sum(|x|)`` per group,
and each lies within ``(count - 1) * eps * sum(|x|)`` of the exact sum.
"""

from __future__ import annotations

import ctypes

import torch

from spark_rapids_jni_tpu_torch.ops.kernels import (
    _build,
    count_launch,
    register_kernel,
)

NAME = "groupby.segment_sum"
CHUNK = 1024  # rows a warp sums, 32 a lane: kChunk in csrc/segment_sum.cu
SUM_REL = 1e-12  # |kernel - plain| <= this * sum(|x|) per group
_BLOCKS_PER_SM = 8

register_kernel(
    NAME,
    oracle="spark_rapids_jni_tpu_torch.ops.kernels.segment_sum"
           ".segment_sum_plain",
    source="csrc/segment_sum.cu",
    replaces="spark_rapids_jni_tpu/ops/groupby.py:186 _segmented_sum_scan "
             "(an XLA scan, no Pallas kernel)",
    doc="float64 sum of each group's contiguous sorted rows in an order "
        "fixed by the group bounds: chunk sums in a fixed tree, folded in "
        "chunk order",
)


def segment_sum(values: torch.Tensor, gid: torch.Tensor, g_lo: torch.Tensor,
                g_hi: torch.Tensor) -> torch.Tensor:
    """float64[m]: the sum of ``values`` over each group's rows ``[g_lo[g],
    g_hi[g])`` (``gid``: each sorted row's group, the plain version's
    index). CUDA tensors launch the kernel, CPU tensors run
    :func:`segment_sum_plain`."""
    if values.is_cuda:
        return _segment_sum_cuda(values, gid, g_lo, g_hi)
    return segment_sum_plain(values, gid, g_lo.shape[0])


def segment_sum_plain(values: torch.Tensor, gid: torch.Tensor,
                      m: int) -> torch.Tensor:
    """Plain PyTorch version: one ``index_add_`` into m + 1 slots (the
    last takes the rows of groups past m), in the order the device
    picks."""
    out = torch.zeros((m + 1,), dtype=values.dtype, device=values.device)
    return out.index_add_(0, gid.clamp(max=m), values)[:m]


def sum_bound(values: torch.Tensor, gid: torch.Tensor, m: int) -> torch.Tensor:
    """float64[m]: ``SUM_REL * sum(|x|)`` over each group's rows, the
    distance the kernel's sum may keep from the plain version's."""
    return SUM_REL * segment_sum_plain(values.abs(), gid, m)


def _segment_sum_cuda(values: torch.Tensor, gid: torch.Tensor,
                      g_lo: torch.Tensor, g_hi: torch.Tensor,
                      blocks: int | None = None) -> torch.Tensor:
    """The kernel on CUDA tensors: nothing runs before it but one
    allocation, the output and its scratch (two chunk sums per ``CHUNK``
    rows). ``blocks``: the most blocks a launch takes
    (default 8 a SM); any count gives the same bits."""
    m, n = g_lo.shape[0], values.shape[0]
    device = values.device
    if values.dtype != torch.float64 or values.ndim != 1:
        raise TypeError(f"{NAME}: values must be float64[n], got "
                        f"{values.dtype}{tuple(values.shape)}")
    if gid.dtype != torch.int64 or gid.shape != (n,) \
            or gid.device != device:
        raise TypeError(f"{NAME}: gid must be int64[{n}] on {device}")
    for b in (g_lo, g_hi):
        if b.dtype != torch.int64 or b.shape != (m,) or b.device != device:
            raise TypeError(f"{NAME}: bounds must be int64[{m}] on {device}")
    if m == 0 or n == 0:  # no rows: every sum is 0.0, nothing to launch
        return torch.zeros((m,), dtype=torch.float64, device=device)
    values, gid = values.contiguous(), gid.contiguous()
    g_lo, g_hi = g_lo.contiguous(), g_hi.contiguous()
    # one allocation: the output, then the scratch
    buf = torch.empty((m + 2 * ((n + CHUNK - 1) // CHUNK),),
                      dtype=torch.float64, device=device)
    out, partial = buf[:m], buf[m:]
    if blocks is None:
        blocks = _build.sm_count(device) * _BLOCKS_PER_SM
    fn = _build.function("srjt_segment_sum", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int32,
        ctypes.c_void_p, ctypes.c_void_p])
    count_launch(NAME)
    status = fn(values.data_ptr(), gid.data_ptr(), g_lo.data_ptr(),
                g_hi.data_ptr(), m, n, partial.data_ptr(), blocks,
                out.data_ptr(), _build.stream_handle(device))
    _build.check(status, NAME)
    return out
