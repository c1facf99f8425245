"""Bounded-groupby accumulate: the per-(group, lane) reduction of
``groupby_aggregate_bounded`` as one CUDA kernel.

Replaces the Pallas kernel ``spark_rapids_jni_tpu/ops/pallas/
groupby_accumulate.py`` (``accumulate``, body ``_make_kernel``). Source:
``csrc/groupby_accumulate.cu``, which says what bounds it on an H100
(bytes), how its design differs from the TPU kernel (native int64 lanes,
no limb split, validity applied in the kernel, float and uint64 lanes)
and how it avoids same-address atomics per row (per-thread partials in
shared memory for m <= 16, warp-aggregated updates above). A domain too
wide for one lane's partials in shared memory takes one pass with its
partials in global memory, except its float sums, whose order must be
fixed: they split into windows of groups, a launch each
(:func:`launch_plan`).

A lane is ``(op, values, valid, neutral)``: ``op`` is sum, min or max;
``values`` a tensor[n] or None for the constant 1 (row and valid
counts); ``valid`` a bool tensor[n] or None for "every row valid";
``neutral`` what an invalid row or an empty group contributes (0 for
sums, the dtype's sentinel for min/max: ``2**64 - 1`` for a uint64 min,
``inf`` for a float min).

Every cell of the result is the 64-bit pattern of its value, int64[m, L]:

- integer sums wrap in int64 (a uint64 sum on its bits), integer min/max
  are the value; neither depends on the order of the rows, so the kernel
  and the plain version agree bit for bit;
- a uint64 min/max holds the uint64 bits (``.view(torch.uint64)``);
- a float lane (float32 widened exactly) holds float64 bits
  (``.view(torch.float64)``). Min and max follow the IEEE total order
  (a tie of -0.0 and +0.0 gives -0.0 for min, +0.0 for max) and return
  the canonical NaN when any row is NaN: exact too. A float sum adds in
  float64 in an order fixed by the launch shape (the same run to run),
  not the plain version's: the two agree within
  ``FLOAT_SUM_REL * sum(|x|)`` per group.
"""

from __future__ import annotations

import ctypes
import struct
from typing import NamedTuple, Optional, Sequence

import torch

from spark_rapids_jni_tpu_torch.ops.kernels import (
    _build,
    count_launch,
    register_kernel,
)

NAME = "groupby.bounded_accumulate"
_PARAM_LANES = 64  # lanes one launch takes in its parameters
_MAX_SMEM = 232_448  # dynamic shared memory a block may opt in to (sm_90)
_SMALL_M = 16  # the largest m of the per-thread kernel
_TURN_BYTES = 16  # the large kernel's float-sum turn counter
_TILE = 8192  # the per-thread kernel's rows per tile (one byte of gid each)
# bytes a row of one lane is reckoned to read when windows are chosen (an
# int64 or float64 value); gid is 4 more a launch
_LANE_BYTES = 8
FLOAT_SUM_REL = 1e-12  # float sums: |kernel - plain| <= this * sum(|x|)

register_kernel(
    NAME,
    oracle="spark_rapids_jni_tpu_torch.ops.kernels.groupby_accumulate"
           ".accumulate_plain",
    source="csrc/groupby_accumulate.cu",
    replaces="spark_rapids_jni_tpu/ops/pallas/groupby_accumulate.py:178 "
             "accumulate",
    doc="per-group sums / counts / min / max over planner-declared "
        "bounded key domains: integer, uint64 and float lanes, validity "
        "applied in-kernel",
)

_OPS = {"sum": 0, "min": 1, "max": 2}
_SUM_F = 3
_KINDS = {
    torch.int8: 1, torch.int16: 2, torch.int32: 3, torch.int64: 4,
    torch.uint8: 5, torch.bool: 5, torch.uint16: 6, torch.uint32: 7,
    torch.uint64: 8, torch.float32: 9, torch.float64: 10,
}
INT64_MIN = -(1 << 63)
INT64_MAX = (1 << 63) - 1
CANONICAL_NAN_BITS = 0x7FF8000000000000


class Lane(NamedTuple):
    op: str                         # "sum" | "min" | "max"
    values: Optional[torch.Tensor]  # None: the constant 1
    valid: Optional[torch.Tensor]   # None: every row valid
    neutral: int | float


def lanes_per_launch(m: int) -> int:
    """How many lanes one launch of a shared-memory kernel over ``m``
    groups takes: at most ``_PARAM_LANES``, and as many as fit the block's
    shared memory (40 bytes a lane and 8 a partial; the per-thread
    kernel's 256 private columns and 8,192-row gid tile, or the large
    kernel's 16-byte turn counter and two-byte tag a group). Below 1 the
    domain takes the one-pass kernel (:func:`launch_plan`)."""
    if m <= _SMALL_M:
        per = (_MAX_SMEM - _TILE - 8 * 256 * m) // (40 + 8 * m)
    else:
        per = (_MAX_SMEM - _TURN_BYTES - 2 * m) // (40 + 8 * m)
    return min(_PARAM_LANES, per)


def _widest(per: int) -> int:
    """The widest window (past ``_SMALL_M``) whose launch takes ``per``
    lanes: (MAX_SMEM - 16 - 2w) >= per * (40 + 8w)."""
    return (_MAX_SMEM - _TURN_BYTES - 40 * per) // (8 * per + 2)


class LaunchPlan(NamedTuple):
    """How one accumulate over ``m`` groups launches.

    ``one_pass``: lanes the one-pass kernel takes (partials in global
    memory, ``_PARAM_LANES`` lanes a launch): every lane but the float
    sums when the domain is past one launch's shared memory, else 0.
    ``windows``/``per``: the shared-memory launches, one a window
    ``(g0, w)`` of groups and group of ``per`` lanes: every lane over the
    one window ``[0, m)`` when the domain fits, else the float sums alone
    over windows of near-equal width (none without float sums)."""

    one_pass: int
    windows: list
    per: int


def launch_plan(m: int, num_lanes: int, float_sums: int = 0) -> LaunchPlan:
    """The :class:`LaunchPlan` of ``num_lanes`` lanes over ``m`` groups,
    ``float_sums`` of them float sums. Past one launch's shared memory the
    float sums split into windows; of the splits, the one that reads the
    fewest bytes a row: windows x (4 bytes of gid a launch + 8 a lane)."""
    per = lanes_per_launch(m)
    if per >= 1:
        return LaunchPlan(0, [(0, m)], per)
    if not float_sums:
        return LaunchPlan(num_lanes, [], 0)
    best = None
    for p in range(1, min(float_sums, _PARAM_LANES) + 1):
        count = -(-m // _widest(p))
        cost = count * (4 * -(-float_sums // p) + _LANE_BYTES * float_sums)
        if best is None or cost < best[0]:
            best = (cost, count)
    count = best[1]
    base, extra = divmod(m, count)
    windows, g0 = [], 0
    for i in range(count):
        w = base + (i < extra)
        windows.append((g0, w))
        g0 += w
    # the widest window sets the lanes every launch takes
    return LaunchPlan(num_lanes - float_sums, windows,
                      lanes_per_launch(base + (extra > 0)))


def unsupported_reason(lanes: Sequence[Lane], m: int) -> str | None:
    """Why the kernel cannot take these lanes, or None (any ``m`` an
    int32 gid can name: wide domains split into windows). The caller
    counts a reason through ``kernels.fall_back``; a CUDA input then
    raises, a CPU one runs :func:`accumulate_plain`."""
    for lane in lanes:
        if lane.values is not None and lane.values.dtype not in _KINDS:
            return "float_agg" if lane.op == "sum" else "minmax_width"
    return None


def accumulate(gid: torch.Tensor, lanes: Sequence[Lane], m: int) -> torch.Tensor:
    """int64[m, L]: lane ``l`` of group ``g`` reduced over the rows with
    ``gid == g``, as the 64-bit pattern of its value; ``gid`` is int32[n]
    in [0, m], where m joins no group. CUDA tensors launch the kernel
    (``launches(m, L)`` times), CPU tensors run :func:`accumulate_plain`."""
    if gid.is_cuda:
        return _accumulate_cuda(gid, lanes, m)
    return accumulate_plain(gid, lanes, m)


def launches(m: int, num_lanes: int, float_sums: int = 0) -> int:
    """Kernel launches of one accumulate of ``num_lanes`` lanes over ``m``
    groups, ``float_sums`` of them float sums: a shared-memory launch a
    window and group of lanes, a one-pass launch a group of up to
    ``_PARAM_LANES`` lanes. Past one launch's shared memory identical
    lanes run once: there ``num_lanes`` counts distinct lanes."""
    plan = launch_plan(m, num_lanes, float_sums)
    shared = float_sums if plan.one_pass else num_lanes
    windowed = len(plan.windows) * -(-shared // plan.per) if shared else 0
    return windowed + -(-plan.one_pass // _PARAM_LANES)


def _is_float(lane: Lane) -> bool:
    return lane.values is not None and lane.values.is_floating_point()


def _is_float_sum(lane: Lane) -> bool:
    return lane.op == "sum" and _is_float(lane)


def _float_key(x: torch.Tensor, op: str) -> torch.Tensor:
    """float64 values as int64 keys of the IEEE total order; NaN takes
    the key that wins ``op``."""
    bits = x.view(torch.int64)
    key = torch.where(bits >= 0, bits, bits ^ INT64_MAX)
    return torch.where(torch.isnan(x), INT64_MIN if op == "min" else INT64_MAX,
                       key)


def _neutral_key(lane: Lane) -> int:
    """The lane's neutral in the int64 word the kernel combines."""
    if lane.values is None:
        return int(lane.neutral)
    dt = lane.values.dtype
    if _is_float(lane):
        if lane.op == "sum":
            return struct.unpack("<q", struct.pack("<d", float(lane.neutral)))[0]
        x = torch.tensor([float(lane.neutral)], dtype=torch.float64)
        return int(_float_key(x, lane.op)[0])
    if dt == torch.uint64:
        v = int(lane.neutral)
        return v - (1 << 63) if lane.op != "sum" else \
            v - (1 << 64) if v > INT64_MAX else v
    return int(lane.neutral)


def lane_words(lane: Lane, n: int, device) -> torch.Tensor:
    """The lane's word per row, its neutral where invalid: int64 values
    for counts and integers (a uint64 sum on its bits), int64 order keys
    for uint64 and float min/max, float64 values for float sums."""
    if lane.values is None:
        v = torch.ones((n,), dtype=torch.int64, device=device)
    elif _is_float(lane):
        x = lane.values.to(torch.float64)
        v = x if lane.op == "sum" else _float_key(x, lane.op)
    elif lane.values.dtype == torch.uint64:
        v = lane.values.view(torch.int64)
        if lane.op != "sum":
            v = v ^ INT64_MIN
    else:
        v = lane.values.to(torch.int64)
    if lane.valid is not None:
        neutral = float(lane.neutral) if v.is_floating_point() \
            else _neutral_key(lane)
        v = torch.where(lane.valid, v, neutral)
    return v


def _decode(lane: Lane, words: torch.Tensor) -> torch.Tensor:
    """Finished words back to each value's 64-bit pattern (int64)."""
    if words.is_floating_point():
        return words.view(torch.int64)
    if lane.op == "sum" or lane.values is None:
        return words
    if lane.values.dtype == torch.uint64:
        return words ^ INT64_MIN
    if _is_float(lane):
        nan_key = INT64_MIN if lane.op == "min" else INT64_MAX
        bits = torch.where(words >= 0, words, words ^ INT64_MAX)
        return torch.where(words == nan_key, CANONICAL_NAN_BITS, bits)
    return words


def accumulate_plain(gid: torch.Tensor, lanes: Sequence[Lane],
                     m: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel: int64[m, L], one
    ``scatter_reduce_`` per lane into m + 1 slots (the last takes the
    rows in no group) over the same words the kernel combines. Integer
    sums, min and max do not depend on the order of their terms, so the
    two agree bit for bit; float sums are added in another order."""
    n = gid.shape[0]
    device = gid.device
    idx = gid.to(torch.int64)
    cols = []
    for lane in lanes:
        v = lane_words(lane, n, device)
        init = float(lane.neutral) if v.is_floating_point() \
            else _neutral_key(lane)
        out = torch.full((m + 1,), init, dtype=v.dtype, device=device)
        if n:
            reduce = {"sum": "sum", "min": "amin", "max": "amax"}[lane.op]
            out.scatter_reduce_(0, idx, v, reduce=reduce, include_self=True)
        cols.append(_decode(lane, out[:m]))
    return torch.stack(cols, dim=1) if cols else \
        torch.zeros((m, 0), dtype=torch.int64, device=device)


def float_sum_bound(gid: torch.Tensor, lane: Lane, m: int) -> torch.Tensor:
    """float64[m]: ``FLOAT_SUM_REL * sum(|x|)`` over each group's valid
    rows, the distance a float sum lane of the kernel may keep from the
    plain version's."""
    absl = Lane("sum", lane.values.abs(), lane.valid, 0.0)
    return FLOAT_SUM_REL * accumulate_plain(gid, [absl], m)[:, 0].view(
        torch.float64)


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
    if n == 0 or not lanes:
        # no rows: every cell keeps its neutral, nothing to launch
        return accumulate_plain(gid, lanes, m)
    gid = gid.contiguous()
    per = lanes_per_launch(m)
    if per >= 1:  # the domain fits shared memory
        outs = [_launch(gid, lanes[i:i + per], m, [(0, m)], device)
                for i in range(0, len(lanes), per)]
        return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)
    # past shared memory, identical lanes (the planner repeats a count
    # lane for each aggregate that needs one) run once: there a lane
    # costs per-row work on every row
    first: dict = {}
    cols = [first.setdefault(_lane_key(lane), len(first)) for lane in lanes]
    if len(first) < len(lanes):
        distinct = [None] * len(first)
        for lane, c in zip(lanes, cols):
            distinct[c] = lane
        return _accumulate_cuda(gid, distinct, m)[:, cols]
    fsum = [i for i, lane in enumerate(lanes) if _is_float_sum(lane)]
    plan = launch_plan(m, len(lanes), len(fsum))
    # every lane but the float sums in one pass, the float sums in
    # windows; each part's columns into their places
    rest = [i for i in range(len(lanes)) if i not in fsum]
    parts = [(rest[i:i + _PARAM_LANES],
              _launch_one_pass(gid, [lanes[j] for j in
                                     rest[i:i + _PARAM_LANES]], m, device))
             for i in range(0, len(rest), _PARAM_LANES)]
    parts += [(fsum[i:i + plan.per],
               _launch(gid, [lanes[j] for j in fsum[i:i + plan.per]], m,
                       plan.windows, device))
              for i in range(0, len(fsum), max(plan.per, 1))]
    if len(parts) == 1:
        return parts[0][1]
    out = torch.empty((m, len(lanes)), dtype=torch.int64, device=device)
    for cols, part in parts:
        out[:, cols] = part
    return out


def _lane_key(lane: Lane) -> tuple:
    """What decides a lane's column: its op, its neutral and the tensors
    (by identity: a cheap test on the host) of its values and validity."""
    return (lane.op, lane.neutral, id(lane.values), id(lane.valid))


_shapes: dict = {}  # (device, m or None, lanes, floats) -> (threads, per SM)


def _shape(device, m: Optional[int], num_lanes: int,
           floats: bool) -> tuple[int, int]:
    """(threads, blocks an SM) of a shared-memory launch over ``m``
    groups, or of the one-pass kernel (``m`` None), from the kernel's
    occupancy; cached. ``floats``: a float lane is among them, which
    takes the kernels that hold the float paths."""
    key = (device, m, num_lanes, floats)
    if key not in _shapes:
        threads, per_sm = ctypes.c_int32(0), ctypes.c_int32(0)
        if m is None:
            fn = _build.function("srjt_groupby_accumulate_one_pass_shape", [
                ctypes.c_int32, ctypes.c_int32, ctypes.c_void_p,
                ctypes.c_void_p])
            status = fn(num_lanes, int(floats), ctypes.byref(threads),
                        ctypes.byref(per_sm))
        else:
            fn = _build.function("srjt_groupby_accumulate_shape", [
                ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
                ctypes.c_void_p, ctypes.c_void_p])
            status = fn(num_lanes, m, int(floats), ctypes.byref(threads),
                        ctypes.byref(per_sm))
        _build.check(status, NAME)
        _shapes[key] = (threads.value, per_sm.value)
    return _shapes[key]


def _grid(n: int, num_lanes: int, m: int, floats: bool,
          device) -> tuple[int, int]:
    """(threads, blocks) of one shared-memory launch: the kernel's block
    size and as many blocks as the card holds at once, no more than there
    are tiles (m <= 16) or blocks' worth of rows."""
    threads, per_sm = _shape(device, m, num_lanes, floats)
    rows_per_block = _TILE if m <= _SMALL_M else threads
    work = -(-n // rows_per_block)
    return threads, max(1, min(work, _build.sm_count(device) * per_sm))


def _descriptors(lanes: Sequence[Lane], n: int, device):
    """(int64[L, 5] host descriptors, tensors to keep alive until the
    launch is enqueued, any float lane) of these lanes."""
    keep, rows = [], []
    for lane in lanes:
        vptr = 0
        if lane.values is not None:
            vals = lane.values.contiguous()
            if vals.device != device or vals.shape != (n,):
                raise TypeError(
                    f"{NAME}: lane values must be a tensor[{n}] on {device}, "
                    f"got {vals.dtype}{tuple(vals.shape)} on {vals.device}")
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
        op = _SUM_F if _is_float_sum(lane) else _OPS[lane.op]
        rows += [vptr, mptr, kind, op, _neutral_key(lane)]
    # the lane descriptors go to the launch as host memory, in its
    # parameters
    desc = (ctypes.c_int64 * len(rows))(*rows)
    return desc, keep, any(_is_float(lane) for lane in lanes)


def _launch(gid: torch.Tensor, lanes: Sequence[Lane], m: int,
            windows: Sequence[tuple[int, int]], device) -> torch.Tensor:
    """int64[m, L] of these lanes (as many as a launch takes) from the
    shared-memory kernels: one launch a window of groups."""
    n = gid.shape[0]
    desc, keep, floats = _descriptors(lanes, n, device)
    shapes = [(g0, w, *_grid(n, len(lanes), w, floats, device))
              for g0, w in windows]
    # each block writes its window's partials to its row of scratch,
    # which the windows take in turn (one stream orders them)
    cells = m * len(lanes)
    scratch_cells = max(blocks * w * len(lanes)
                        for _, w, _, blocks in shapes)
    buf = torch.empty((cells + scratch_cells,), dtype=torch.int64,
                      device=device)  # one allocation: out, then scratch
    out, scratch = buf[:cells].view(m, len(lanes)), buf[cells:]
    fn = _build.function("srjt_groupby_accumulate", [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_void_p, ctypes.c_int32, ctypes.c_void_p, ctypes.c_void_p])
    for g0, w, threads, blocks in shapes:
        count_launch(NAME)
        status = fn(gid.data_ptr(), n, ctypes.addressof(desc), len(lanes), w,
                    g0, int(floats), threads, scratch.data_ptr(), blocks,
                    out[g0:].data_ptr(), _build.stream_handle(device))
        _build.check(status, NAME)
    return out


def _launch_one_pass(gid: torch.Tensor, lanes: Sequence[Lane], m: int,
                     device) -> torch.Tensor:
    """int64[m, L] of these lanes (no float sum among them, at most
    ``_PARAM_LANES``) from one launch of the one-pass kernel."""
    n = gid.shape[0]
    desc, keep, floats = _descriptors(lanes, n, device)
    threads, per_sm = _shape(device, None, len(lanes), floats)
    blocks = max(1, min(-(-n // threads), _build.sm_count(device) * per_sm))
    out = torch.empty((m, len(lanes)), dtype=torch.int64, device=device)
    fn = _build.function("srjt_groupby_accumulate_one_pass", [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_void_p,
        ctypes.c_void_p])
    count_launch(NAME)
    status = fn(gid.data_ptr(), n, ctypes.addressof(desc), len(lanes), m,
                int(floats), blocks, out.data_ptr(),
                _build.stream_handle(device))
    _build.check(status, NAME)
    return out
