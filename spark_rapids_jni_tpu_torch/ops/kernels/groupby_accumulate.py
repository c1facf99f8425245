"""Bounded-groupby accumulate: the per-(group, lane) reduction of
``groupby_aggregate_bounded`` as one CUDA kernel.

Replaces the Pallas kernel ``spark_rapids_jni_tpu/ops/pallas/
groupby_accumulate.py`` (``accumulate``, body ``_make_kernel``). Source:
``csrc/groupby_accumulate.cu``, which says what bounds it on an H100
(bytes), how its design differs from the TPU kernel (native int64 lanes,
no limb split, validity applied in the kernel) and how it avoids
same-address atomics per row (per-thread partials in shared memory for
m <= 16, warp-aggregated updates above).

A lane is ``(op, values, valid, neutral)``: ``op`` is sum, min or max;
``values`` a tensor[n] or None for the constant 1 (row and valid
counts); ``valid`` a bool tensor[n] or None for "every row valid";
``neutral`` what an invalid row or an empty group contributes (0 for
sums, the dtype's sentinel for min/max). The kernel takes integer lanes:
their sums wrap in int64, which does not depend on the order of their
terms, so the kernel and the plain version agree bit for bit. Float
lanes (whose sums depend on that order) and uint64 min/max exist only in
:func:`reduce_lanes_plain`, for CPU tensors.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Sequence

import torch

from spark_rapids_jni_tpu_torch.ops.kernels import (
    _build,
    count_launch,
    register_kernel,
)

NAME = "groupby.bounded_accumulate"
_MAX_CELLS = 2048  # m*L int64 partials per block: 16 KB of shared memory
_PARAM_LANES = 64  # lanes the kernel takes in its launch parameters

register_kernel(
    NAME,
    oracle="spark_rapids_jni_tpu_torch.ops.kernels.groupby_accumulate"
           ".accumulate_plain",
    source="csrc/groupby_accumulate.cu",
    replaces="spark_rapids_jni_tpu/ops/pallas/groupby_accumulate.py:178 "
             "accumulate",
    doc="per-group sums / counts / min / max over planner-declared "
        "bounded key domains, int64 lanes, validity applied in-kernel",
)

_OPS = {"sum": 0, "min": 1, "max": 2}
_KINDS = {
    torch.int8: 1, torch.int16: 2, torch.int32: 3, torch.int64: 4,
    torch.uint8: 5, torch.bool: 5, torch.uint16: 6, torch.uint32: 7,
    torch.uint64: 8,
}


class Lane(NamedTuple):
    op: str                         # "sum" | "min" | "max"
    values: Optional[torch.Tensor]  # None: the constant 1
    valid: Optional[torch.Tensor]   # None: every row valid
    neutral: int | float


def unsupported_reason(lanes: Sequence[Lane], m: int) -> str | None:
    """Why the kernel cannot take these lanes over ``m`` groups, or None.
    The caller counts a reason through ``kernels.fall_back``; a CUDA
    input then raises, a CPU one runs :func:`reduce_lanes_plain`."""
    for lane in lanes:
        if lane.values is None:
            continue
        if lane.values.dtype not in _KINDS:
            # float sums depend on the order of their terms
            return "float_agg" if lane.op == "sum" else "minmax_width"
        if lane.op != "sum" and lane.values.dtype == torch.uint64:
            # int64 lanes would not keep uint64 order
            return "minmax_width"
    if m * len(lanes) > _MAX_CELLS:
        return "too_many_lanes"
    return None


def accumulate(gid: torch.Tensor, lanes: Sequence[Lane], m: int) -> torch.Tensor:
    """int64[m, L]: lane ``l`` of group ``g`` reduced over the rows with
    ``gid == g``; ``gid`` is int32[n] in [0, m], where m joins no group.
    CUDA tensors launch the kernel, CPU tensors run
    :func:`accumulate_plain`."""
    if gid.is_cuda:
        return _accumulate_cuda(gid, lanes, m)
    return accumulate_plain(gid, lanes, m)


def _lane_values(lane: Lane, n: int, device) -> torch.Tensor:
    """The lane's value per row, the neutral where invalid: int64 for
    counts and integers, float64 for float sums, the column's own float
    dtype for float min/max."""
    if lane.values is None:
        v = torch.ones((n,), dtype=torch.int64, device=device)
    elif lane.values.is_floating_point():
        v = lane.values.to(torch.float64) if lane.op == "sum" \
            else lane.values
    elif lane.values.dtype == torch.uint64:
        if lane.op != "sum":
            raise NotImplementedError("uint64 min/max is not ported yet")
        v = lane.values.view(torch.int64)  # sums wrap on the bit pattern
    else:
        v = lane.values.to(torch.int64)
    if lane.valid is not None:
        v = torch.where(lane.valid, v, lane.neutral)
    return v


def reduce_lanes_plain(gid: torch.Tensor, lanes: Sequence[Lane],
                       m: int) -> list[torch.Tensor]:
    """One [m] reduction per lane, in the lane's dtype: a masked
    whole-column reduction per (group, lane). Takes every lane, float
    lanes included."""
    n = gid.shape[0]
    device = gid.device
    masks = [gid == g for g in range(m)]
    cols = []
    for lane in lanes:
        v = _lane_values(lane, n, device)
        if n == 0:
            cols.append(torch.full((m,), lane.neutral, dtype=v.dtype,
                                   device=device))
            continue
        reduce_fn = {"sum": torch.sum, "min": torch.amin,
                     "max": torch.amax}[lane.op]
        cols.append(torch.stack([
            reduce_fn(torch.where(mask, v, lane.neutral)) for mask in masks
        ]))
    return cols


def accumulate_plain(gid: torch.Tensor, lanes: Sequence[Lane],
                     m: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel over integer lanes:
    int64[m, L]. It reduces each (group, lane) as one masked whole-column
    reduction, not in the kernel's order (tiles, per-thread partials,
    warp folds): a wrapping int64 sum, a min and a max do not depend on
    the order of their terms, so the two agree bit for bit."""
    return torch.stack(reduce_lanes_plain(gid, lanes, m), dim=1)


def _accumulate_cuda(gid: torch.Tensor, lanes: Sequence[Lane],
                     m: int) -> torch.Tensor:
    n = gid.shape[0]
    reason = unsupported_reason(lanes, m)
    if reason is not None:
        raise NotImplementedError(f"{NAME}: the kernel does not take this "
                                  f"input ({reason})")
    if gid.dtype != torch.int32 or gid.ndim != 1:
        raise TypeError(f"{NAME}: gid must be int32[n], got {gid.dtype}")
    device = gid.device
    gid = gid.contiguous()
    keep = [gid]  # every tensor the launch reads, alive until enqueued
    rows = []
    for lane in lanes:
        vptr = 0
        if lane.values is not None:
            vals = lane.values.contiguous()
            if vals.device != device or vals.shape != (n,) \
                    or vals.dtype not in _KINDS:
                raise TypeError(
                    f"{NAME}: lane values must be an integer tensor[{n}] "
                    f"on {device}, got {vals.dtype}{tuple(vals.shape)} on "
                    f"{vals.device}")
            keep.append(vals)
            vptr = vals.data_ptr()
        mptr = 0
        if lane.valid is not None:
            valid = lane.valid.contiguous()
            if valid.device != device or valid.shape != (n,) \
                    or valid.dtype != torch.bool:
                raise TypeError(f"{NAME}: lane validity must be bool[{n}] "
                                f"on {device}")
            keep.append(valid)
            mptr = valid.data_ptr()
        kind = 0 if lane.values is None else _KINDS[lane.values.dtype]
        rows += [vptr, mptr, kind, _OPS[lane.op], int(lane.neutral)]
    if n == 0:
        # no rows: every cell keeps its neutral, nothing to launch
        return torch.tensor([int(lane.neutral) for lane in lanes],
                            dtype=torch.int64, device=device).repeat(m, 1)
    # the descriptors go to the launch as host memory: up to _PARAM_LANES
    # lanes ride in its parameters, more are copied to lanes_dev
    desc = (ctypes.c_int64 * len(rows))(*rows)
    lanes_dev = torch.empty((len(lanes), 5), dtype=torch.int64,
                            device=device) \
        if len(lanes) > _PARAM_LANES else None
    out = torch.empty((m, len(lanes)), dtype=torch.int64, device=device)
    fn = _build.function("srjt_groupby_accumulate", [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32,
        ctypes.c_void_p])
    count_launch(NAME)
    status = fn(gid.data_ptr(), n, ctypes.addressof(desc), len(lanes), m,
                0 if lanes_dev is None else lanes_dev.data_ptr(),
                out.data_ptr(), _build.sm_count(device),
                _build.stream_handle(device))
    _build.check(status, NAME)
    return out
