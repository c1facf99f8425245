"""Column->row byte interleave (the ``convert_to_rows`` hot path) as one
CUDA kernel.

Replaces the Pallas kernel ``spark_rapids_jni_tpu/ops/pallas/
row_transpose.py`` (``assemble_rows``, body ``_make_kernel``). Source:
``csrc/row_transpose.cu``, which says what bounds it on an H100 (bytes)
and how its design differs from the TPU kernel (it reads the column
storage and bool validity directly). Rows of up to ``MAX_ROW`` (1,536)
bytes stage 128 whole rows a block, the original CUDA design; wider rows
take the tiled kernel, whose work :func:`tile_plan` lays out: a block
takes ``TILE_ROWS`` rows of one segment of the row image.

Both versions build the packed row image of fixed-width columns: column
``i``'s little-endian bytes at ``starts[i]``, the validity bytes at
``starts[-1] + sizes[-1]`` (bit col % 8 of byte col // 8), zero alignment
gaps and a zero pad to ``size_per_row``.
"""

from __future__ import annotations

import bisect
import ctypes
import functools
import operator
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from spark_rapids_jni_tpu_torch.columnar.bitmask import pack_bits_last_axis
from spark_rapids_jni_tpu_torch.ops.bytecast import to_bytes
from spark_rapids_jni_tpu_torch.ops.kernels import (
    _build,
    count_launch,
    register_kernel,
)
from spark_rapids_jni_tpu_torch.types import DType

NAME = "row_conversion.to_rows"
MAX_ROW = 1536  # widest row of the 128-row kernel (kMaxRow)
TILE_ROWS = 32  # rows a block of the tiled kernel
TILE_SMEM = 48 * 1024  # a tiled block's shared memory at most: 4 a SM
_BANK_BYTES = 128  # one pass over the 32 shared-memory banks
# shared memory a segment's block keeps per data column, validity column
# and 8-byte word of its descriptors (TileCol, ValidCol, the first column
# of each word in csrc/row_transpose.cu)
_COL_INFO, _VALID_INFO, _WORD_INFO = 32, 16, 4

register_kernel(
    NAME,
    oracle="spark_rapids_jni_tpu_torch.ops.kernels.row_transpose"
           ".assemble_rows_plain",
    source="csrc/row_transpose.cu",
    replaces="spark_rapids_jni_tpu/ops/pallas/row_transpose.py:103 "
             "assemble_rows",
    doc="column->row byte interleave of fixed-width columns + packed "
        "validity into the uint8 row image: 128 whole rows a block to "
        "1,536 bytes, tiles of rows x row segments past",
)


def assemble_rows(
    datas: Sequence[torch.Tensor],
    valids: Sequence[Optional[torch.Tensor]],
    schema: Sequence[DType],
    starts: Sequence[int],
    size_per_row: int,
) -> torch.Tensor:
    """uint8[n, size_per_row] row image of the columns ``datas`` (with
    bool ``valids``, None = all valid). CUDA tensors launch the kernel,
    CPU tensors run :func:`assemble_rows_plain`."""
    if datas[0].is_cuda:
        return _assemble_rows_cuda(datas, valids, schema, starts,
                                   size_per_row)
    return assemble_rows_plain(datas, valids, schema, starts, size_per_row)


def assemble_rows_plain(datas, valids, schema, starts,
                        size_per_row) -> torch.Tensor:
    """Plain PyTorch version: each column's byte view and the packed
    validity bytes concatenated with zero gaps."""
    n = datas[0].shape[0]
    device = datas[0].device
    pieces = [to_bytes(d, dt) for d, dt in zip(datas, schema)]
    piece_starts = list(starts) + [starts[-1] + schema[-1].size_bytes]
    masks = [torch.ones((n,), dtype=torch.bool, device=device)
             if v is None else v for v in valids]
    pieces.append(pack_bits_last_axis(torch.stack(masks, dim=1)))
    padded: list[torch.Tensor] = []
    cursor = 0
    for start, piece in zip(piece_starts, pieces):
        if start > cursor:  # alignment padding before this piece
            padded.append(torch.zeros((n, start - cursor), dtype=torch.uint8,
                                      device=device))
        padded.append(piece)
        cursor = start + piece.shape[1]
    if size_per_row > cursor:  # trailing pad to the 64-bit row boundary
        padded.append(torch.zeros((n, size_per_row - cursor),
                                  dtype=torch.uint8, device=device))
    return torch.cat(padded, dim=1)


# ---- the tile plan of rows past MAX_ROW ------------------------------------


class TileSegment(NamedTuple):
    """One segment of the row image and the shared memory its blocks use
    (offsets from the start of a block's shared memory)."""

    begin: int  # row bytes [begin, end): multiples of 8
    end: int
    cols: range  # the columns whose fields lie in it
    vbytes: range  # its validity bytes (0: the first after the columns)
    packed_off: int  # the tile's packed validity bytes, rows x stride
    info_off: int  # the descriptors: columns, validity columns, words
    smem: int  # the shared memory its blocks need


class TilePlan(NamedTuple):
    """The tiled kernel's work: a block takes ``rows`` rows of one
    segment; the segments cover the row image, byte for byte, once."""

    rows: int
    segments: tuple
    data_off: tuple  # each column's staged rows, in its data segment
    valid_off: tuple  # each column's staged validity, in its segment
    smem: int  # the launch's shared memory a block: the largest segment's

    def grid(self, n: int) -> int:
        """Blocks of a launch over ``n`` rows: tiles x segments."""
        return -(-n // self.rows) * len(self.segments)


def _align16(x: int) -> int:
    return (x + 15) & ~15


def packed_stride(nbytes: int) -> int:
    """Bytes a row of a tile's packed validity takes: ``nbytes`` rounded
    up to 4, an odd count of 4-byte words so that 32 rows' bytes fall in
    32 distinct banks."""
    return 4 * (((nbytes + 3) // 4) | 1)


def _place(off: int, start: int) -> int:
    """Where a column's staged rows go after ``off``: 16-byte aligned (for
    ``cp.async``), at the bank of its 16-byte block of the row, so the
    lanes that assemble neighbouring 16-byte blocks of a row read from
    distinct banks."""
    off = _align16(off)
    return off + (16 * (start // 16 % 8) - off) % _BANK_BYTES


class _Units(NamedTuple):
    """Units that a segment takes whole, in row order: a 16-byte block of
    the data area or an 8-byte word of the validity area, each with the
    columns whose fields start in it and the validity bytes it holds."""

    cols: list  # (first, last + 1) column of each unit
    vbytes: list  # (first, last + 1) validity byte of each unit
    ends: list  # the row byte each unit ends at


def _data_units(starts, data_end: int) -> _Units:
    """The 16-byte blocks of ``[0, data_end)``: no column crosses a
    multiple of 16 (each is aligned to its size, at most 16)."""
    cols, ends = [], []
    c, nd = 0, bisect.bisect_left(starts, data_end)
    while c < nd:
        k = starts[c] // 16
        c2 = bisect.bisect_left(starts, 16 * k + 16, c, nd)
        cols.append((c, c2))
        ends.append(min(16 * k + 16, data_end))
        c = c2
    return _Units(cols, [(0, 0)] * len(cols), ends)


def _validity_units(starts, data_end: int, vld_base: int, row_size: int,
                    ncols: int) -> _Units:
    """The 8-byte words of ``[data_end, row_size)``: the validity bytes,
    the trailing pad and, in the first word, the columns that end in it
    before the validity bytes."""
    cols, vbytes, ends = [], [], []
    nd = bisect.bisect_left(starts, data_end)
    nvb = (ncols + 7) // 8
    for p in range(data_end, row_size, 8):
        cols.append((nd, ncols) if p == data_end else (ncols, ncols))
        lo = min(max(p - vld_base, 0), nvb)
        vbytes.append((lo, min(max(p + 8 - vld_base, 0), nvb)))
        ends.append(p + 8)
    return _Units(cols, vbytes, ends)


def _smem(rows: int, off: int, ncol: int, nvb: int, nvc: int,
          nbytes: int) -> tuple:
    """(packed_off, info_off, smem) of a segment of ``nbytes`` row bytes
    whose data columns' staging ends at ``off``: ``ncol`` columns,
    ``nvb`` validity bytes of ``nvc`` columns."""
    packed_off = _align16(off) + nvc * _align16(rows)
    info_off = _align16(packed_off + (rows * packed_stride(nvb)
                                      if nvb else 0))
    return packed_off, info_off, info_off + _COL_INFO * ncol \
        + _VALID_INFO * nvc + _WORD_INFO * nbytes // 8


def _grow(units: _Units, i: int, begin: int, starts, sizes, ncols: int,
          rows: int, limit: int):
    """Units [i, j) from row byte ``begin`` as one segment, j as large as
    ``limit`` bytes of shared memory allow (at least i + 1): (j, its
    :class:`TileSegment`, each column's staging offset)."""
    c0, v0 = units.cols[i][0], units.vbytes[i][0]
    offs, off, j, got = [], 0, i, None
    while j < len(units.ends):
        c_lo, c_hi = units.cols[j]
        more = []
        for c in range(c_lo, c_hi):
            off = _place(off, starts[c])
            more.append(off)
            off += rows * sizes[c]
        v1 = units.vbytes[j][1]
        nvc = max(min(8 * v1, ncols) - 8 * v0, 0)
        c1 = c0 + len(offs) + len(more)
        end = units.ends[j]
        packed_off, info_off, smem = _smem(rows, off, c1 - c0, v1 - v0, nvc,
                                           end - begin)
        if got is not None and smem > limit:
            break
        offs += more
        got = TileSegment(begin, end, range(c0, c1), range(v0, v1),
                          packed_off, info_off, smem)
        j += 1
    return j, got, offs


def _cut(units: _Units, begin: int, starts, sizes, ncols: int) -> list:
    """Units cut greedily into segments, each as long as ``TILE_SMEM``
    bytes of shared memory allow."""
    out, i, at = [], 0, begin
    while i < len(units.ends):
        i, seg, offs = _grow(units, i, at, starts, sizes, ncols, TILE_ROWS,
                             TILE_SMEM)
        if seg.smem > TILE_SMEM:
            raise ValueError(f"{NAME}: one unit of the row needs "
                             f"{seg.smem} bytes of shared memory")
        out.append((seg, offs))
        at = seg.end
    return out


@functools.lru_cache(maxsize=64)
def _tile_plan(starts: tuple, sizes: tuple, row_size: int) -> TilePlan:
    ncols = len(starts)
    rows = TILE_ROWS
    vld_base = starts[-1] + sizes[-1]
    data_end = vld_base // 8 * 8
    data_off, valid_off = [0] * ncols, [0] * ncols
    parts = _cut(_data_units(starts, data_end), 0, starts, sizes,
                 ncols) if data_end else []
    parts += _cut(_validity_units(starts, data_end, vld_base, row_size,
                                  ncols), data_end, starts, sizes, ncols)
    for seg, offs in parts:
        data_off[seg.cols.start:seg.cols.stop] = offs
        v = _align16(offs[-1] + rows * sizes[seg.cols.stop - 1]) \
            if offs else 0
        for c in range(8 * seg.vbytes.start, min(8 * seg.vbytes.stop,
                                                 ncols)):
            valid_off[c] = v
            v += _align16(rows)
    segments = tuple(seg for seg, _ in parts)
    return TilePlan(rows, segments, tuple(data_off), tuple(valid_off),
                    max(seg.smem for seg in segments))


def tile_plan(starts: Sequence[int], sizes: Sequence[int],
              row_size: int) -> TilePlan:
    """The tiled kernel's plan for the row layout ``starts``/``sizes``
    (``compute_fixed_width_layout``'s; the row ``row_size`` bytes):

    - the data area ``[0, vld_base)`` rounded down to 8 bytes is cut at
      multiples of 16 into data segments (no column crosses one);
    - the rest, from that 8-byte word on, is cut at words into validity
      segments: the validity bytes, the pad to 8 bytes and, in the first,
      the columns that end before the validity bytes in the same word;
    - a block stages each of its segment's columns' ``TILE_ROWS`` values
      and each of its validity columns' ``TILE_ROWS`` bools in shared
      memory, and needs at most ``TILE_SMEM`` bytes of it.
    """
    return _tile_plan(tuple(starts), tuple(sizes), int(row_size))


def descriptors(plan: TilePlan, starts: Sequence[int],
                sizes: Sequence[int]) -> np.ndarray:
    """The tiled kernel's descriptors as int32, the data and validity
    pointers (int64 slots 0 and 1 of each column) left 0: a TileCol of 8
    int32 a column, then a Segment of 8 int32 a segment."""
    ncols = len(starts)
    cols = np.zeros((ncols, 8), dtype=np.int32)
    cols[:, 4], cols[:, 5] = starts, sizes
    cols[:, 6], cols[:, 7] = plan.data_off, plan.valid_off
    segs = np.array([(s.begin // 8, s.end // 8, s.cols.start, s.cols.stop,
                      s.vbytes.start, s.vbytes.stop, s.packed_off,
                      s.info_off) for s in plan.segments], dtype=np.int32)
    return np.concatenate([cols.reshape(-1), segs.reshape(-1)])


# ---- the wrapper ------------------------------------------------------------

_SHAPE = operator.attrgetter("shape")
_NBYTES = operator.attrgetter("nbytes")
_NDIM = operator.attrgetter("ndim")
_DTYPE = operator.attrgetter("dtype")


@functools.lru_cache(maxsize=64)
def _template(schema: tuple, starts: tuple, row_size: int):
    """(the schema's element sizes, int32 descriptors with the pointers
    left 0, the tile plan or None for the 128-row kernel) of a layout."""
    sizes = tuple(dt.size_bytes for dt in schema)
    if row_size <= MAX_ROW:
        cols = np.zeros((len(starts), 8), dtype=np.int32)
        cols[:, 4], cols[:, 6] = starts, sizes  # int64 slots 2 and 3
        return sizes, cols.reshape(-1), None
    plan = _tile_plan(starts, sizes, row_size)
    return sizes, descriptors(plan, starts, sizes), plan


class _Launch(NamedTuple):
    """A prepared launch: the kernel entry point and its arguments, the
    output, and the tensors it reads (alive until it is enqueued)."""

    fn: object
    args: tuple
    out: torch.Tensor
    keep: tuple


def _bad_column(datas, valids, schema, n: int, device) -> str:
    """The message for the first column the kernel does not take."""
    for data, valid, dt in zip(datas, valids, schema):
        if data.device != device or data.shape[0] != n \
                or data.nbytes != n * dt.size_bytes:
            return (f"{NAME}: column of {dt} must hold {n} rows of "
                    f"{dt.size_bytes} bytes on {device}")
        if valid is not None and (valid.device != device
                                  or valid.shape != (n,)
                                  or valid.dtype != torch.bool):
            return f"{NAME}: validity must be bool[{n}] on {device}"
    return f"{NAME}: a column is on another device"


def _prepare_cuda(datas, valids, schema, starts,
                  size_per_row) -> _Launch:
    """Everything up to the launch, on the host: the checks (one pass of
    each over the columns), the descriptors from the layout's cached
    template, their copy from pinned memory (the caching host allocator
    holds the buffer until the copy has run) and the output."""
    n = datas[0].shape[0]
    device = datas[0].device
    index = datas[0].get_device()
    sizes, template, plan = _template(tuple(schema), tuple(starts),
                                      size_per_row)
    datas = list(map(torch.Tensor.contiguous, datas))
    have = [v for v in valids if v is not None]
    have = list(map(torch.Tensor.contiguous, have))
    if len(have) < len(valids):
        rest = iter(have)
        valids = [v if v is None else next(rest) for v in valids]
    if set(map(torch.Tensor.get_device, datas)) != {index} \
            or {s[0] for s in map(_SHAPE, datas)} != {n} \
            or list(map(_NBYTES, datas)) != [n * s for s in sizes] \
            or (have and (set(map(torch.Tensor.get_device, have)) != {index}
                          or set(map(_DTYPE, have)) != {torch.bool}
                          or set(map(_NDIM, have)) != {1}
                          or set(map(_NBYTES, have)) != {n})):
        raise TypeError(_bad_column(datas, valids, schema, n, device))
    out = torch.empty((n, size_per_row), dtype=torch.uint8, device=device)
    if n == 0:
        return _Launch(None, (), out, ())
    host = torch.empty(template.shape, dtype=torch.int32, pin_memory=True)
    buf = host.numpy()
    buf[:] = template
    ptrs = buf[:8 * len(sizes)].view(np.int64).reshape(-1, 4)
    ptrs[:, 0] = list(map(torch.Tensor.data_ptr, datas))
    ptrs[:, 1] = list(map(torch.Tensor.data_ptr, have)) \
        if len(have) == len(valids) \
        else [0 if v is None else v.data_ptr() for v in valids]
    desc = host.to(device, non_blocking=True)
    vld_base = int(starts[-1]) + sizes[-1]
    stream = _build.stream_handle(device)
    if plan is None:
        fn = _build.function("srjt_assemble_rows", [
            ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int32, ctypes.c_void_p, ctypes.c_void_p])
        args = (desc.data_ptr(), len(sizes), n, size_per_row, vld_base,
                out.data_ptr(), stream)
    else:
        fn = _build.function("srjt_assemble_rows_tiled", [
            ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
            ctypes.c_void_p, ctypes.c_void_p])
        args = (desc.data_ptr(), len(sizes), len(plan.segments), plan.rows,
                plan.smem, n, size_per_row, vld_base, out.data_ptr(), stream)
    return _Launch(fn, args, out, (desc, datas, have))


def _launch_cuda(prep: _Launch) -> torch.Tensor:
    """Enqueue a prepared launch (none for no rows); its output."""
    if prep.fn is not None:
        count_launch(NAME)
        _build.check(prep.fn(*prep.args), NAME)
    return prep.out


def _assemble_rows_cuda(datas, valids, schema, starts,
                        size_per_row) -> torch.Tensor:
    return _launch_cuda(_prepare_cuda(datas, valids, schema, starts,
                                      size_per_row))
