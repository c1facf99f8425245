"""Column->row byte interleave (the ``convert_to_rows`` hot path) as one
CUDA kernel.

Replaces the Pallas kernel ``spark_rapids_jni_tpu/ops/pallas/
row_transpose.py`` (``assemble_rows``, body ``_make_kernel``). Source:
``csrc/row_transpose.cu``, which says what bounds it on an H100 (bytes)
and how its design differs from the TPU kernel (it reads the column
storage and bool validity directly and stages 128 rows in shared memory,
the original CUDA design). It takes rows of any width: past 1,536 bytes
a block stages as many rows as its shared memory holds, and past 227 KiB
the fields go straight to the output.

Both versions build the packed row image of fixed-width columns: column
``i``'s little-endian bytes at ``starts[i]``, the validity bytes at
``starts[-1] + sizes[-1]`` (bit col % 8 of byte col // 8), zero alignment
gaps and a zero pad to ``size_per_row``.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Sequence

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

register_kernel(
    NAME,
    oracle="spark_rapids_jni_tpu_torch.ops.kernels.row_transpose"
           ".assemble_rows_plain",
    source="csrc/row_transpose.cu",
    replaces="spark_rapids_jni_tpu/ops/pallas/row_transpose.py:103 "
             "assemble_rows",
    doc="column->row byte interleave of fixed-width columns + packed "
        "validity into the uint8 row image, rows staged per block (as "
        "many as fit, 128 at most), any row width",
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


def _assemble_rows_cuda(datas, valids, schema, starts,
                        size_per_row) -> torch.Tensor:
    n = datas[0].shape[0]
    device = datas[0].device
    keep = []  # every tensor the launch reads, alive until enqueued
    rows = []
    for data, valid, dt, start in zip(datas, valids, schema, starts):
        data = data.contiguous()
        if data.device != device or data.shape[0] != n \
                or data.element_size() * math.prod(data.shape[1:]) \
                != dt.size_bytes:
            raise TypeError(f"{NAME}: column of {dt} must hold {n} rows of "
                            f"{dt.size_bytes} bytes on {device}")
        keep.append(data)
        vptr = 0
        if valid is not None:
            valid = valid.contiguous()
            if valid.device != device or valid.shape != (n,) \
                    or valid.dtype != torch.bool:
                raise TypeError(f"{NAME}: validity must be bool[{n}] on "
                                f"{device}")
            keep.append(valid)
            vptr = valid.data_ptr()
        rows.append([data.data_ptr(), vptr, int(start), dt.size_bytes])
    desc = torch.tensor(rows, dtype=torch.int64).to(device)
    out = torch.empty((n, size_per_row), dtype=torch.uint8, device=device)
    if n == 0:
        return out  # no rows: nothing to launch
    vld_base = int(starts[-1]) + schema[-1].size_bytes
    fn = _build.function("srjt_assemble_rows", [
        ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int32, ctypes.c_void_p, ctypes.c_void_p])
    count_launch(NAME)
    status = fn(desc.data_ptr(), len(rows), n, size_per_row, vld_base,
                out.data_ptr(), _build.stream_handle(device))
    _build.check(status, NAME)
    return out
