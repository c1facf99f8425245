"""The device-runtime bridge: the Python entry points that the port's
``libtpudf_rt.so`` calls (counterpart of the reference's
``runtime/bridge.py``, with its function names, arguments and byte
formats).

A JVM or any native caller drives the port through the handle-model C
ABI of ``runtime/native_src/rt_bridge.cpp`` (the reference's JNI
analogue): the library either embeds a CPython interpreter that owns the
CUDA runtime, or is loaded into a running Python process with ctypes.
Every C entry point takes the GIL and calls the function of the same
name here; the handles it holds are the objects these functions return
(``Column``, ``Table``, ``RowsColumn``).

Host and device meet as raw little-endian bytes: one byte of validity a
row (0 = null), DECIMAL128 as 16 bytes a row (the int64[n, 2] limb
pair), a packed-rows batch as its row image. Bytes from the host are
copied once into a page-locked buffer and staged with one asynchronous
copy (``runtime/memory.py``); bytes to the host come back through a
page-locked buffer after the device is synchronised, so a handle made
on one thread reads right on another.

``init_platform("")`` selects the CUDA device and raises without one:
there is no CPU fallback. ``init_platform("cpu")`` selects the CPU (the
tests).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from spark_rapids_jni_tpu_torch.columnar import Column, Table
from spark_rapids_jni_tpu_torch.ops.row_conversion import (
    RowsColumn,
    convert_from_rows as _convert_from_rows,
    convert_to_rows as _convert_to_rows,
)
from spark_rapids_jni_tpu_torch.runtime.memory import host_empty, stage_tensor
from spark_rapids_jni_tpu_torch.types import DType, TypeId
from spark_rapids_jni_tpu_torch.utils.platform import resolve_device

_device: Optional[torch.device] = None


def init_platform(platform: str) -> None:
    """Pin the device before the first column: "" = the CUDA device
    (raises when ``torch.cuda.is_available()`` is false), "cpu" = the
    CPU."""
    global _device
    if platform not in ("", "cpu"):
        raise ValueError(f"unknown platform {platform!r}: '' (the CUDA "
                         "device) or 'cpu'")
    dev = resolve_device("cpu" if platform == "cpu" else None)
    if dev.type == "cuda":
        torch.cuda.init()  # fail fast if the runtime cannot initialise
    _device = dev


def _target() -> torch.device:
    return _device if _device is not None else resolve_device(None)


def _stage(data: bytes, nbytes: int, device: torch.device) -> torch.Tensor:
    """The first ``nbytes`` of ``data`` as uint8 on ``device``: one
    memcpy into a page-locked buffer, one asynchronous copy."""
    if len(data) < nbytes:
        raise ValueError(f"{nbytes} bytes expected, {len(data)} given")
    buf = host_empty(nbytes, torch.uint8, device)
    buf.numpy()[:] = np.frombuffer(data, dtype=np.uint8, count=nbytes)
    return stage_tensor(buf, device)


def _to_host(x: torch.Tensor) -> bytes:
    """``x``'s bytes on the host, after every queued write to it."""
    if x.device.type == "cpu":
        return x.contiguous().numpy().tobytes()
    buf = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    buf.copy_(x, non_blocking=True)
    torch.cuda.synchronize(x.device)
    return buf.numpy().tobytes()


def column_from_host(type_id: int, scale: int, n: int, data: bytes,
                     validity: Optional[bytes]) -> Column:
    """A device column from little-endian host bytes. ``validity`` is
    one byte a row (0 = null), or None for all-valid."""
    dt = DType(TypeId(type_id), scale)
    if not (dt.is_fixed_width or dt.is_decimal128):
        raise TypeError(f"column_from_host takes fixed-width types, not "
                        f"{dt}")
    dev = _target()
    raw = _stage(data, n * dt.size_bytes, dev)
    if dt.is_decimal128:
        values = raw.view(torch.int64).reshape(n, 2)
    else:
        values = raw.view(dt.torch_dtype)
    vmask = None
    if validity is not None:
        vmask = _stage(validity, n, dev) != 0
    return Column(dt, values, vmask)


def table_create(cols: list[Column]) -> Table:
    return Table(list(cols))


def table_num_columns(table: Table) -> int:
    return table.num_columns


def table_num_rows(table: Table) -> int:
    return table.num_rows


def table_column(table: Table, i: int) -> Column:
    return table.column(i)


def column_info(col: Column) -> tuple[int, int, int]:
    return int(col.dtype.type_id), col.dtype.scale, col.size


def column_to_host(col: Column) -> tuple[bytes, bytes]:
    """Device column -> (data bytes, one byte of validity a row)."""
    return _to_host(col.data), _to_host(col.valid_mask().to(torch.uint8))


def convert_to_rows(table: Table) -> list[RowsColumn]:
    """Packed-row batches, each under 2^31 bytes."""
    return _convert_to_rows(table)


def convert_from_rows(rows: RowsColumn, type_ids: list[int],
                      scales: list[int]) -> Table:
    schema = [DType(TypeId(t), s) for t, s in zip(type_ids, scales)]
    return _convert_from_rows(rows, schema)


def rows_info(rows: RowsColumn) -> tuple[int, int]:
    return rows.num_rows, rows.row_size


def rows_to_host(rows: RowsColumn) -> bytes:
    return _to_host(rows.data)


def rows_from_host(num_rows: int, row_size: int, data: bytes) -> RowsColumn:
    return RowsColumn(num_rows, row_size,
                      _stage(data, num_rows * row_size, _target()))
