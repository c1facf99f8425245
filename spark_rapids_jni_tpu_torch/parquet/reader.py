"""Parquet data reader: native page decode staged into CUDA tables
(counterpart of the reference's ``parquet/reader.py``).

Pages are decoded on the host by the native engine (``libtpudf``, C++,
``src/native/src/parquet_reader.cpp``) into Arrow-layout buffers. The
engine's copy-out lands in pinned CPU tensors, which go to the card with
one asynchronous copy each (``runtime/memory.py``). Chunked reads iterate
runs of row groups bounded by a byte budget, the external contract of
cuDF's chunked reader.

Type mapping (physical + converted type -> DType), Spark's vectorized
reader's:

  BOOLEAN              -> BOOL8
  INT32                -> INT32 | INT8/16 (INT_8/INT_16) | UINT_8/16/32 |
                          TIMESTAMP_DAYS (DATE) | DECIMAL32
  INT64                -> INT64 | UINT_64 | TIMESTAMP_MILLIS/MICROS |
                          DECIMAL64
  FLOAT / DOUBLE       -> FLOAT32 / FLOAT64
  BYTE_ARRAY           -> STRING
  FIXED_LEN_BYTE_ARRAY -> DECIMAL64 (type_length <= 8) or DECIMAL128
                          (9..16): big-endian two's-complement unscaled,
                          widened on the target device

Narrowing casts and the decimal widening run after staging, on the
target device (a column's ``finish``, ``runtime/memory.py``), so the
card receives the file's physical values, for ``stage="host"`` as for a
direct read; the same functions run on the CPU for CPU reads, with the
same bits.
"""

from __future__ import annotations

import ctypes
import functools
import os
import struct
import time
from typing import Optional, Sequence

import numpy as np
import torch

from spark_rapids_jni_tpu_torch import types as t
from spark_rapids_jni_tpu_torch.columnar import Table
from spark_rapids_jni_tpu_torch.parquet import nested as nst
from spark_rapids_jni_tpu_torch.parquet.footer import MalformedFileError
from spark_rapids_jni_tpu_torch.runtime import faults, integrity
from spark_rapids_jni_tpu_torch.runtime.memory import (
    ByteBudgetChunks,
    _col_from_host,
    host_empty,
    host_table_chunk,
)
from spark_rapids_jni_tpu_torch.runtime.native import load_native
from spark_rapids_jni_tpu_torch.types import DType, TypeId
from spark_rapids_jni_tpu_torch.utils.fspath import as_fs_path
from spark_rapids_jni_tpu_torch.utils.platform import resolve_device
from spark_rapids_jni_tpu_torch.utils.tracing import func_range

# parquet.thrift enums (public spec)
_PHYS_BOOLEAN, _PHYS_INT32, _PHYS_INT64 = 0, 1, 2
_PHYS_INT96, _PHYS_FLOAT, _PHYS_DOUBLE = 3, 4, 5
_PHYS_BYTE_ARRAY, _PHYS_FLBA = 6, 7
_CONV_UTF8, _CONV_DECIMAL, _CONV_DATE = 0, 5, 6
_CONV_TS_MILLIS, _CONV_TS_MICROS = 9, 10
_CONV_UINT8, _CONV_UINT16, _CONV_UINT32, _CONV_UINT64 = 11, 12, 13, 14
_CONV_INT8, _CONV_INT16, _CONV_INT32, _CONV_INT64 = 15, 16, 17, 18

_PHYS_WIDTH = {_PHYS_BOOLEAN: 1, _PHYS_INT32: 4, _PHYS_INT64: 8,
               _PHYS_FLOAT: 4, _PHYS_DOUBLE: 8}
_PHYS_TORCH = {_PHYS_BOOLEAN: torch.uint8, _PHYS_INT32: torch.int32,
               _PHYS_INT64: torch.int64, _PHYS_FLOAT: torch.float32,
               _PHYS_DOUBLE: torch.float64}


def _map_dtype(phys: int, conv: int, scale: int, type_length: int) -> DType:
    if phys == _PHYS_BOOLEAN:
        return t.BOOL8
    if phys == _PHYS_FLOAT:
        return t.FLOAT32
    if phys == _PHYS_DOUBLE:
        return t.FLOAT64
    if phys == _PHYS_BYTE_ARRAY:
        return t.STRING
    if phys == _PHYS_INT32:
        if conv == _CONV_DATE:
            return t.TIMESTAMP_DAYS
        if conv == _CONV_DECIMAL:
            return t.decimal32(-scale)
        if conv == _CONV_INT8:
            return t.INT8
        if conv == _CONV_INT16:
            return t.INT16
        if conv == _CONV_UINT8:
            return t.UINT8
        if conv == _CONV_UINT16:
            return t.UINT16
        if conv == _CONV_UINT32:
            return t.UINT32
        return t.INT32
    if phys == _PHYS_INT64:
        if conv == _CONV_DECIMAL:
            return t.decimal64(-scale)
        if conv == _CONV_TS_MILLIS:
            return DType(TypeId.TIMESTAMP_MILLISECONDS)
        if conv == _CONV_TS_MICROS:
            return DType(TypeId.TIMESTAMP_MICROSECONDS)
        if conv == _CONV_UINT64:
            return t.UINT64
        return t.INT64
    if phys == _PHYS_FLBA:
        if conv == _CONV_DECIMAL and 0 < type_length <= 8:
            return t.decimal64(-scale)
        if conv == _CONV_DECIMAL and 8 < type_length <= 16:
            return t.decimal128(-scale)
        raise NotImplementedError(
            "FIXED_LEN_BYTE_ARRAY is only supported as DECIMAL with "
            "type_length <= 16")
    raise NotImplementedError(f"unsupported parquet physical type {phys}")


def _flba_to_int64(raw: torch.Tensor, width: int) -> torch.Tensor:
    """Big-endian two's-complement unscaled decimal bytes (uint8[n *
    width]) -> int64[n], on ``raw``'s device."""
    m = raw.reshape(-1, width).to(torch.int64)
    out = torch.where(m[:, 0] >= 128, -1, 0).to(torch.int64)
    for k in range(width):
        out = (out << 8) | m[:, k]
    return out


def _flba_to_int128(raw: torch.Tensor, width: int) -> torch.Tensor:
    """Big-endian two's-complement unscaled decimal bytes (9..16 a value)
    -> int64[n, 2] limb pairs (lo, hi), on ``raw``'s device. The shifts
    run in int64 lanes; ``(lo >> 56) & 0xFF`` is the logical shift."""
    m = raw.reshape(-1, width).to(torch.int64)
    lo = torch.zeros(m.shape[0], dtype=torch.int64, device=raw.device)
    hi = torch.zeros_like(lo)
    for k in range(width):  # big-endian: shift the 128-bit value left 8
        hi = (hi << 8) | ((lo >> 56) & 0xFF)
        lo = (lo << 8) | m[:, k]
    if width < 16:  # sign-extend bits [8 * width, 128) of negative values
        shift = 8 * width - 64  # in (0, 64) for widths 9..15
        mask = (-1 << shift) & 0xFFFFFFFFFFFFFFFF
        mask -= 1 << 64 if mask >> 63 else 0
        hi = torch.where(m[:, 0] >= 128, hi | mask, hi)
    return torch.stack([lo, hi], dim=1)


def _as_storage(values: torch.Tensor, dtype: DType) -> torch.Tensor:
    """Physical values -> the column's storage dtype, as numpy's
    ``astype`` would give them (narrowing keeps the low bits)."""
    target = dtype.torch_dtype
    if values.dtype == target:
        return values
    if values.element_size() == target.itemsize:
        return values.view(target)
    if target == torch.uint16:
        return values.to(torch.int16).view(torch.uint16)
    return values.to(target)


def _finish(raw: torch.Tensor, dtype: DType, phys: int,
            tlen: int) -> torch.Tensor:
    """A column's raw bytes (uint8, any device) -> its storage tensor."""
    if phys == _PHYS_FLBA:
        if dtype.is_decimal128:
            return _flba_to_int128(raw, tlen)
        return _flba_to_int64(raw, tlen)
    return _as_storage(raw.view(_PHYS_TORCH[phys]), dtype)


def _check(lib, ok: bool, what: str) -> None:
    # a decode failure on untrusted bytes is malformed input
    if not ok:
        raise integrity.reject_malformed(
            f"parquet.{what}", f"{what}: {lib.last_error()}",
            exc_type=MalformedFileError)


_PAR1 = b"PAR1"


def _validate_parquet_envelope(data) -> None:
    """Before any decoder touches the bytes: leading and trailing magic,
    and the footer length field against the file size."""
    if not integrity.enabled():
        return
    path = as_fs_path(data)
    if path is None:
        n = len(data)
        head, tail = bytes(data[:4]), bytes(data[-12:])
    else:
        try:
            n = os.path.getsize(path)
            with open(path, "rb") as fh:
                head = fh.read(4)
                fh.seek(max(0, n - 12))
                tail = fh.read(12)
        except OSError:
            return  # unreadable path: the native open reports it
    if n < 12:
        raise integrity.reject_malformed(
            "parquet.envelope", "file too short to be parquet",
            exc_type=MalformedFileError, size=n)
    if head != _PAR1:
        raise integrity.reject_malformed(
            "parquet.envelope", "bad leading magic (not a parquet file)",
            exc_type=MalformedFileError, size=n)
    if tail[-4:] != _PAR1:
        raise integrity.reject_malformed(
            "parquet.envelope",
            "bad trailing magic (truncated or clobbered file)",
            exc_type=MalformedFileError, size=n)
    (footer_len,) = struct.unpack("<I", tail[-8:-4])
    if footer_len == 0 or footer_len + 12 > n:
        raise integrity.reject_malformed(
            "parquet.envelope",
            "footer length field points outside the file",
            exc_type=MalformedFileError, footer_len=footer_len, size=n)


def _validate_flat_column(num_rows: int, phys: int, data_bytes: int,
                          chars_bytes: int, offsets=None) -> None:
    """Decoded sizes against the declared row count, and string offsets
    monotone and inside the character buffer, before anything is
    staged (a device gather has no fault to catch)."""
    if not integrity.enabled():
        return
    if num_rows < 0 or data_bytes < 0 or chars_bytes < 0:
        raise integrity.reject_malformed(
            "parquet.column", "negative size from decoder",
            exc_type=MalformedFileError, rows=num_rows,
            data_bytes=data_bytes, chars_bytes=chars_bytes)
    if phys == _PHYS_BYTE_ARRAY:
        if offsets.shape[0] != num_rows + 1:
            raise integrity.reject_malformed(
                "parquet.column",
                "string offsets disagree with declared row count",
                exc_type=MalformedFileError, rows=num_rows,
                offsets=int(offsets.shape[0]))
        if int(offsets[0]) != 0 or int(offsets[-1]) != chars_bytes or (
                num_rows > 0 and bool(np.any(np.diff(offsets) < 0))):
            raise integrity.reject_malformed(
                "parquet.column",
                "string offsets inconsistent with character payload",
                exc_type=MalformedFileError, rows=num_rows,
                chars_bytes=chars_bytes)
    elif phys in _PHYS_WIDTH and data_bytes != num_rows * _PHYS_WIDTH[phys]:
        raise integrity.reject_malformed(
            "parquet.column",
            "column payload size disagrees with declared row count",
            exc_type=MalformedFileError, rows=num_rows,
            data_bytes=data_bytes, width=_PHYS_WIDTH[phys])


def _i32_array(vals: Optional[Sequence[int]]):
    """None -> a null pointer (select all); an empty list stays a
    non-null zero-length selection (select none)."""
    if vals is None:
        return None, 0
    return (ctypes.c_int32 * len(vals))(*vals), len(vals)


def _ptr(x: Optional[torch.Tensor]):
    return None if x is None else ctypes.c_void_p(x.data_ptr())


def row_group_info(data) -> list[tuple[int, int]]:
    """[(num_rows, byte_size)] per row group, the chunk-planning probe
    (bytes or a path; a path maps only the footer's pages)."""
    _validate_parquet_envelope(data)
    lib = load_native()
    cap = 4096
    path = as_fs_path(data)
    while True:
        nr = (ctypes.c_int64 * cap)()
        bs = (ctypes.c_int64 * cap)()
        if path is not None:
            n = lib.tpudf_parquet_row_groups_path(path, nr, bs, cap)
        else:
            n = lib.tpudf_parquet_row_groups(data, len(data), nr, bs, cap)
        _check(lib, n >= 0, "row_group_info")
        if n <= cap:
            return [(nr[i], bs[i]) for i in range(n)]
        cap = n


def _finisher(dtype: DType, phys: int, tlen: int):
    """The ``finish`` of a flat column: None for strings (offsets and
    characters are their storage), else ``_finish`` over its raw bytes."""
    if dtype.is_string:
        return None
    return functools.partial(_finish, dtype=dtype, phys=phys, tlen=tlen)


def _copy_flat_column(lib, handle: int, i: int, device: torch.device):
    """Copy-out of one flat leaf: the engine writes straight into the
    host buffers given here (pinned for a CUDA ``device``). Returns the
    column's snapshot over its physical values, its ``finish`` and its
    row count."""
    meta = (ctypes.c_int32 * 7)()
    sizes = (ctypes.c_int64 * 3)()
    _check(lib, lib.tpudf_read_col_meta(handle, i, meta, sizes) == 0,
           "col_meta")
    phys, conv, scale, _prec, tlen, _opt, has_valid = list(meta)
    data_bytes, chars_bytes, num_rows = list(sizes)
    dtype = _map_dtype(phys, conv, scale, tlen)
    vbuf = host_empty(num_rows, torch.uint8, device) if has_valid else None
    chars = None
    if phys == _PHYS_BYTE_ARRAY:
        offsets = host_empty(num_rows + 1, torch.int32, device)
        chars = host_empty(max(chars_bytes, 1), torch.uint8, device)
        _check(lib, lib.tpudf_read_col_copy(
            handle, i, None, _ptr(offsets), _ptr(chars), _ptr(vbuf)) == 0,
            "col_copy")
        _validate_flat_column(num_rows, phys, data_bytes, chars_bytes,
                              offsets.numpy())
        raw, chars = offsets, chars[:chars_bytes]
    else:
        raw = host_empty(max(data_bytes, 1), torch.uint8, device)
        _check(lib, lib.tpudf_read_col_copy(
            handle, i, _ptr(raw), None, None, _ptr(vbuf)) == 0, "col_copy")
        if not (phys == _PHYS_FLBA and dtype.is_decimal128):
            _validate_flat_column(num_rows, phys, data_bytes, chars_bytes)
        raw = raw[:data_bytes]
    validity = None if vbuf is None else vbuf.view(torch.bool)
    return ((dtype, raw, validity, chars, None), _finisher(dtype, phys, tlen),
            num_rows)


def _check_row_agreement(prev: "int | None", rows: int, col: int) -> None:
    """Every column of one read must agree on the row count."""
    if prev is None or not integrity.enabled():
        return
    if rows != prev:
        raise integrity.reject_malformed(
            "parquet.table", "columns disagree on row count",
            exc_type=MalformedFileError, column=col, rows=rows,
            expected=prev)


def _read_leaf_data(lib, handle: int, leaf_index: int) -> nst.LeafData:
    """One nested leaf's compact values and levels (host numpy)."""
    meta = (ctypes.c_int32 * 10)()
    sizes = (ctypes.c_int64 * 5)()
    _check(lib, lib.tpudf_read_col_meta2(handle, leaf_index, meta, sizes)
           == 0, "col_meta2")
    phys, conv, scale, _prec, tlen = meta[0], meta[1], meta[2], meta[3], \
        meta[4]
    max_rep = meta[8]
    data_bytes, chars_bytes, _num_rows, n_levels, n_present = list(sizes)
    dtype = _map_dtype(phys, conv, scale, tlen)

    defs = np.empty(max(n_levels, 1), dtype=np.uint8)
    reps = np.empty(max(n_levels, 1), dtype=np.uint8) if max_rep else None
    _check(lib, lib.tpudf_read_col_levels(
        handle, leaf_index, defs.ctypes.data_as(ctypes.c_void_p),
        None if reps is None else reps.ctypes.data_as(ctypes.c_void_p))
        == 0, "col_levels")
    defs = defs[:n_levels]
    reps = None if reps is None else reps[:n_levels]

    values = offsets = chars = None
    if phys == _PHYS_BYTE_ARRAY:
        offsets = np.empty(n_present + 1, dtype=np.int32)
        chars = np.empty(max(chars_bytes, 1), dtype=np.uint8)
        _check(lib, lib.tpudf_read_col_copy(
            handle, leaf_index, None, offsets.ctypes.data_as(ctypes.c_void_p),
            chars.ctypes.data_as(ctypes.c_void_p), None) == 0, "col_copy")
        chars = chars[:chars_bytes]
    else:
        raw = np.empty(max(data_bytes, 1), dtype=np.uint8)
        _check(lib, lib.tpudf_read_col_copy(
            handle, leaf_index, raw.ctypes.data_as(ctypes.c_void_p), None,
            None, None) == 0, "col_copy")
        if phys == _PHYS_FLBA and dtype.is_decimal128:
            raise NotImplementedError(
                "DECIMAL128 inside nested columns is not supported yet")
        values = _finish(torch.from_numpy(raw[:data_bytes]), dtype, phys,
                         tlen).numpy()
    return nst.LeafData(values, offsets, chars, defs, reps, dtype)


def _read_nested(lib, handle: int, tree, device: torch.device,
                 timings: Optional[dict]) -> Table:
    """A table whose schema holds LIST or STRUCT columns. ``timings``,
    when given, receives the seconds of the nested leaves' copy-out
    (``copy_out_s``) and of the assembly and staging of every column
    (``assemble_s``)."""
    t0 = time.perf_counter()
    leaf_data = {}
    for nd in tree:
        if nd.is_leaf:
            continue  # top-level flat leaves take the row-aligned path
        for lf in nst.leaves_of(nd):
            leaf_data[lf.leaf_index] = _read_leaf_data(lib, handle,
                                                       lf.leaf_index)
    t1 = time.perf_counter()
    out = []
    for nd in tree:
        if nd.is_leaf:
            snap, fin, _ = _copy_flat_column(lib, handle, nd.leaf_index,
                                             device)
            out.append(_col_from_host(snap, device, fin))
        elif nd.converted == nst._CONV_LIST or (
                len(nd.children) == 1 and nd.children[0].repetition == 2):
            out.append(nst.assemble_list(nd, leaf_data, device))
        else:
            out.append(nst.assemble_struct(nd, leaf_data, device))
    if timings is not None:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        timings.update(copy_out_s=t1 - t0,
                       assemble_s=time.perf_counter() - t1)
    return Table(out)


@func_range("parquet_read_table")
def read_table(
    data,
    columns: Optional[Sequence[int]] = None,
    row_groups: Optional[Sequence[int]] = None,
    stage: str = "device",
    device=None,
    timings: Optional[dict] = None,
):
    """Decode a Parquet file into a Table on ``device`` (None: the CUDA
    device; raises without one).

    ``data`` is in-memory bytes or a filesystem path; a path decodes
    through a native mmap, which faults in only the selected row groups'
    byte ranges. ``columns``/``row_groups`` select (None: all; an empty
    list: none). ``stage="host"`` stops at the host boundary and returns
    a ``HostTableChunk`` (flat schemas only) whose ``stage()`` gives the
    same Table. ``timings``, when given, receives the seconds of the
    native decode (``decode_s``), the copy-out into host buffers
    (``copy_out_s``) and, for ``stage="device"``, the staging and casts
    on the device up to a synchronize (``stage_s``), with the staged
    bytes (``staged_bytes``); for a nested schema, the decode, the
    nested leaves' copy-out and the assembly with its staging
    (``assemble_s``)."""
    if stage not in ("device", "host"):
        raise ValueError(f"unknown stage {stage!r}")
    device = resolve_device(device)
    if as_fs_path(data) is None:
        # chaos window of untrusted ingest: a fault script may corrupt
        # the bytes before any validation runs
        data = faults.fire_corrupt("integrity.ingest", 0, data)
    _validate_parquet_envelope(data)
    lib = load_native()
    cols, n_cols = _i32_array(columns)
    rgs, n_rgs = _i32_array(row_groups)
    path = as_fs_path(data)
    t0 = time.perf_counter()
    if path is not None:
        handle = lib.tpudf_parquet_read_path(path, cols, n_cols, rgs, n_rgs)
    else:
        handle = lib.tpudf_parquet_read(data, len(data), cols, n_cols, rgs,
                                        n_rgs)
    _check(lib, handle != 0, "parquet read")
    t1 = time.perf_counter()
    try:
        n_columns = lib.tpudf_read_num_columns(handle)
        _check(lib, n_columns >= 0, "num_columns")
        desc_raw = lib.tpudf_read_schema_desc(handle)
        _check(lib, desc_raw is not None, "schema_desc")
        tree = nst.parse_schema_desc(desc_raw.decode())
        for nd in tree:
            if nd.is_leaf and nd.repetition == 2:
                raise NotImplementedError(
                    f"legacy 1-level repeated field {nd.name!r} is not "
                    "supported (rewrite as a 3-level LIST)")
        if any(not nd.is_leaf for nd in tree):
            if stage == "host":
                raise NotImplementedError(
                    "host-staged decode (stage='host') supports flat "
                    "schemas only; nested columns assemble on device")
            if columns is not None:
                raise NotImplementedError(
                    "column selection over nested schemas is not supported "
                    "yet; read all columns")
            if timings is not None:
                timings["decode_s"] = t1 - t0
            return _read_nested(lib, handle, tree, device, timings)
        snaps, finish, rows_seen = [], [], None
        for i in range(n_columns):
            snap, fin, rows = _copy_flat_column(lib, handle, i, device)
            _check_row_agreement(rows_seen, rows, i)
            rows_seen = rows
            snaps.append(snap)
            finish.append(fin)
    finally:
        lib.tpudf_read_close(handle)
    t2 = time.perf_counter()
    chunk = host_table_chunk(snaps, rows_seen or 0, device, finish)
    out = chunk if stage == "host" else chunk.stage()
    if timings is not None:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        timings.update(
            decode_s=t1 - t0, copy_out_s=t2 - t1,
            stage_s=time.perf_counter() - t2,
            staged_bytes=sum(x.nbytes for snap in snaps for x in snap[1:4]
                             if x is not None))
    return out


class ParquetChunkedReader(ByteBudgetChunks):
    """A Parquet file as a sequence of Tables bounded by a byte budget,
    at row-group granularity (``runtime/memory.ByteBudgetChunks``)."""

    def __init__(self, data, chunk_read_limit: int,
                 columns: Optional[Sequence[int]] = None, device=None):
        columns = list(columns) if columns is not None else None
        device = resolve_device(device)
        super().__init__(
            row_group_info(data), chunk_read_limit,
            lambda rgs, stage: read_table(data, columns, rgs, stage=stage,
                                          device=device))
