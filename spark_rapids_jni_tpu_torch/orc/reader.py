"""ORC reader: native stripe decode staged into CUDA tables (counterpart
of the reference's ``orc/reader.py``).

Decode is C++ (``src/native/src/orc_reader.cpp``); its copy-out lands in
pinned CPU tensors that go to the card with one asynchronous copy each
(``runtime/memory.py``), and the narrowing casts run there. Chunked reads
iterate stripes under a byte budget, the stripe being ORC's row group.

Type mapping (ORC kind -> DType):
  BOOLEAN -> BOOL8        BYTE -> INT8       SHORT -> INT16
  INT -> INT32            LONG -> INT64      FLOAT/DOUBLE -> FLOAT32/64
  STRING/VARCHAR/CHAR/BINARY -> STRING       DATE -> TIMESTAMP_DAYS
  TIMESTAMP -> TIMESTAMP_MICROS (unix epoch; decoded natively), with a
  non-UTC writer time zone converted wall clock -> UTC through the tz
  database by pyarrow's ``assume_timezone`` (earliest candidate for
  ambiguous and nonexistent local times), as in the reference. pyarrow
  is imported only there: a file written in such a zone raises
  ``ImportError`` where pyarrow is absent.
  DECIMAL(p<=18, s) -> decimal64(-s)   DECIMAL(p>18, s) -> decimal128(-s)
"""

from __future__ import annotations

import ctypes
import functools
import os
from typing import Optional, Sequence

import numpy as np
import torch

from spark_rapids_jni_tpu_torch import types as t
from spark_rapids_jni_tpu_torch.parquet.footer import MalformedFileError
from spark_rapids_jni_tpu_torch.parquet.reader import (
    _as_storage,
    _i32_array,
    _ptr,
)
from spark_rapids_jni_tpu_torch.runtime import faults, integrity
from spark_rapids_jni_tpu_torch.runtime.memory import (
    ByteBudgetChunks,
    host_empty,
    host_table_chunk,
)
from spark_rapids_jni_tpu_torch.runtime.native import load_native
from spark_rapids_jni_tpu_torch.utils.fspath import as_fs_path
from spark_rapids_jni_tpu_torch.utils.platform import resolve_device
from spark_rapids_jni_tpu_torch.utils.tracing import func_range

_K_BOOLEAN, _K_BYTE, _K_SHORT, _K_INT, _K_LONG = 0, 1, 2, 3, 4
_K_FLOAT, _K_DOUBLE, _K_STRING, _K_BINARY, _K_TIMESTAMP = 5, 6, 7, 8, 9
_K_DECIMAL, _K_DATE, _K_VARCHAR, _K_CHAR = 14, 15, 16, 17

_STRING_KINDS = (_K_STRING, _K_VARCHAR, _K_CHAR, _K_BINARY)


def _map_dtype(kind: int, scale: int, precision: int = 0):
    if kind == _K_DECIMAL and precision > 18:
        return t.decimal128(-scale)
    return {
        _K_BOOLEAN: t.BOOL8,
        _K_BYTE: t.INT8,
        _K_SHORT: t.INT16,
        _K_INT: t.INT32,
        _K_LONG: t.INT64,
        _K_FLOAT: t.FLOAT32,
        _K_DOUBLE: t.FLOAT64,
        _K_STRING: t.STRING,
        _K_BINARY: t.STRING,   # raw bytes ride the string layout
        _K_VARCHAR: t.STRING,
        _K_CHAR: t.STRING,
        _K_TIMESTAMP: t.TIMESTAMP_MICROSECONDS,
        _K_DATE: t.TIMESTAMP_DAYS,
        _K_DECIMAL: t.decimal64(-scale),
    }[kind]


def _check(lib, ok: bool, what: str) -> None:
    # a decode failure on untrusted bytes is malformed input
    if not ok:
        raise integrity.reject_malformed(
            f"orc.{what}", f"{what}: {lib.last_error()}",
            exc_type=MalformedFileError)


_ORC_MAGIC = b"ORC"


def _validate_orc_envelope(data) -> None:
    """Before any decoder touches the bytes: leading magic, trailing
    postscript magic, and the postscript length against the file size."""
    if not integrity.enabled():
        return
    path = as_fs_path(data)
    if path is None:
        n = len(data)
        head, tail = bytes(data[:3]), bytes(data[-4:])
    else:
        try:
            n = os.path.getsize(path)
            with open(path, "rb") as fh:
                head = fh.read(3)
                fh.seek(max(0, n - 4))
                tail = fh.read(4)
        except OSError:
            return  # unreadable path: the native open reports it
    if n < 8:
        raise integrity.reject_malformed(
            "orc.envelope", "file too short to be ORC",
            exc_type=MalformedFileError, size=n)
    if head != _ORC_MAGIC:
        raise integrity.reject_malformed(
            "orc.envelope", "bad leading magic (not an ORC file)",
            exc_type=MalformedFileError, size=n)
    if tail[:3] != _ORC_MAGIC:
        raise integrity.reject_malformed(
            "orc.envelope",
            "bad trailing postscript magic (truncated or clobbered file)",
            exc_type=MalformedFileError, size=n)
    ps_len = tail[3]
    # the postscript and its length byte fit between head magic and EOF
    if ps_len == 0 or ps_len + 1 > n - len(_ORC_MAGIC):
        raise integrity.reject_malformed(
            "orc.envelope", "postscript length field points outside the file",
            exc_type=MalformedFileError, ps_len=ps_len, size=n)


def _check_orc_rows(prev: "int | None", rows: int, col: int) -> None:
    """Every column of one read must agree on the row count."""
    if not integrity.enabled():
        return
    if rows < 0:
        raise integrity.reject_malformed(
            "orc.column", "negative row count from decoder",
            exc_type=MalformedFileError, column=col, rows=rows)
    if prev is not None and rows != prev:
        raise integrity.reject_malformed(
            "orc.table", "columns disagree on row count",
            exc_type=MalformedFileError, column=col, rows=rows,
            expected=prev)


def _check_orc_string(offsets: np.ndarray, num_rows: int,
                      chars_bytes: int, col: int) -> None:
    """String offsets zero-based, monotone and ending at the character
    payload's size, before a device gather can index past it."""
    if not integrity.enabled():
        return
    if chars_bytes < 0 or int(offsets[0]) != 0 \
            or int(offsets[-1]) != chars_bytes \
            or (num_rows > 0 and bool(np.any(np.diff(offsets) < 0))):
        raise integrity.reject_malformed(
            "orc.column",
            "string offsets inconsistent with character payload",
            exc_type=MalformedFileError, column=col, rows=num_rows,
            chars_bytes=chars_bytes)


_UTC_NAMES = ("", "UTC", "GMT", "Etc/UTC", "Etc/GMT")


def _wall_to_utc_micros(raw: np.ndarray, valid, tz: str) -> np.ndarray:
    """Wall-clock micros in the writer's zone -> unix-epoch UTC micros
    through the tz database (pyarrow's; imported here only)."""
    import pyarrow as pa
    import pyarrow.compute as pc

    mask = None if valid is None else ~np.asarray(valid, dtype=bool)
    arr = pa.array(raw.view("datetime64[us]"), mask=mask)
    out = pc.assume_timezone(arr, tz, ambiguous="earliest",
                             nonexistent="earliest")
    return np.asarray(out.cast(pa.int64()).fill_null(0))


def stripe_info(data) -> list[tuple[int, int]]:
    """[(num_rows, data_bytes)] per stripe, the chunk-planning probe
    (bytes or a path; a path maps only the tail's pages)."""
    _validate_orc_envelope(data)
    lib = load_native()
    cap = 4096
    path = as_fs_path(data)
    while True:
        nr = (ctypes.c_int64 * cap)()
        bs = (ctypes.c_int64 * cap)()
        if path is not None:
            n = lib.tpudf_orc_stripes_path(path, nr, bs, cap)
        else:
            n = lib.tpudf_orc_stripes(data, len(data), nr, bs, cap)
        _check(lib, n >= 0, "stripe_info")
        if n <= cap:
            return [(nr[i], bs[i]) for i in range(n)]
        cap = n


def _finish(raw: torch.Tensor, kind: int, dtype) -> torch.Tensor:
    """The engine's int64 lanes -> the column's storage, on ``raw``'s
    device."""
    if kind == _K_FLOAT:  # the float's bits sit in the low 32 bits
        return raw.to(torch.int32).view(torch.float32)
    if kind == _K_DOUBLE:
        return raw.view(torch.float64)
    return _as_storage(raw, dtype)


@func_range("orc_read_table")
def read_table(data, columns: Optional[Sequence[int]] = None,
               stripes: Optional[Sequence[int]] = None,
               stage: str = "device", device=None):
    """Decode an ORC file into a Table on ``device`` (None: the CUDA
    device; raises without one). ``data`` is bytes or a path (a native
    mmap that faults in only the selected stripes). None selects all
    columns or stripes, an empty list none. ``stage="host"`` returns a
    ``HostTableChunk`` whose ``stage()`` gives the same Table."""
    if stage not in ("device", "host"):
        raise ValueError(f"unknown stage {stage!r}")
    device = resolve_device(device)
    if as_fs_path(data) is None:
        # chaos window of untrusted ingest
        data = faults.fire_corrupt("integrity.ingest", 0, data)
    _validate_orc_envelope(data)
    lib = load_native()
    cols, n_cols = _i32_array(columns)
    sts, n_sts = _i32_array(stripes)
    path = as_fs_path(data)
    if path is not None:
        handle = lib.tpudf_orc_read_path(path, cols, n_cols, sts, n_sts)
    else:
        handle = lib.tpudf_orc_read(data, len(data), cols, n_cols, sts,
                                    n_sts)
    _check(lib, handle != 0, "orc read")
    # copy every column out to host buffers first; staging follows (or,
    # for stage="host", is the caller's)
    snaps, finish = [], []
    table_rows = 0
    try:
        tz_raw = lib.tpudf_orc_writer_timezone(handle)
        _check(lib, tz_raw is not None, "writer_timezone")
        writer_tz = tz_raw.decode("utf-8")
        n_columns = lib.tpudf_orc_num_columns(handle)
        _check(lib, n_columns >= 0, "num_columns")
        for i in range(n_columns):
            meta = (ctypes.c_int32 * 4)()
            sizes = (ctypes.c_int64 * 2)()
            _check(lib, lib.tpudf_orc_col_meta(handle, i, meta, sizes) == 0,
                   "col_meta")
            kind, prec, scale, has_valid = list(meta)
            num_rows, chars_bytes = list(sizes)
            _check_orc_rows(table_rows if i else None, num_rows, i)
            table_rows = num_rows
            dtype = _map_dtype(kind, scale, prec)
            vbuf = host_empty(num_rows, torch.uint8, device) \
                if has_valid else None
            validity = None if vbuf is None else vbuf.view(torch.bool)
            if kind in _STRING_KINDS:
                offsets = host_empty(num_rows + 1, torch.int32, device)
                chars = host_empty(max(chars_bytes, 1), torch.uint8, device)
                _check(lib, lib.tpudf_orc_col_copy(
                    handle, i, None, _ptr(offsets), _ptr(chars), _ptr(vbuf))
                    == 0, "col_copy")
                _check_orc_string(offsets.numpy(), num_rows, chars_bytes, i)
                snaps.append((dtype, offsets, validity, chars[:chars_bytes],
                              None))
                finish.append(None)
                continue
            n_vals = 2 * num_rows if dtype.is_decimal128 else num_rows
            raw = host_empty(max(n_vals, 1), torch.int64, device)
            _check(lib, lib.tpudf_orc_col_copy(
                handle, i, _ptr(raw), None, None, _ptr(vbuf)) == 0,
                "col_copy")
            raw = raw[:n_vals]
            if dtype.is_decimal128:
                raw = raw.reshape(num_rows, 2)
            elif kind == _K_TIMESTAMP and writer_tz not in _UTC_NAMES:
                raw.numpy()[:] = _wall_to_utc_micros(
                    raw.numpy(), None if vbuf is None else vbuf.numpy(),
                    writer_tz)
            snaps.append((dtype, raw, validity, None, None))
            finish.append(None if dtype.is_decimal128 else
                          functools.partial(_finish, kind=kind, dtype=dtype))
    finally:
        lib.tpudf_orc_close(handle)
    chunk = host_table_chunk(snaps, table_rows, device, finish)
    return chunk if stage == "host" else chunk.stage()


class OrcChunkedReader(ByteBudgetChunks):
    """An ORC file as Tables bounded by a byte budget, chunk boundaries
    at stripe granularity (``runtime/memory.ByteBudgetChunks``)."""

    def __init__(self, data, chunk_read_limit: int,
                 columns: Optional[Sequence[int]] = None, device=None):
        columns = list(columns) if columns is not None else None
        device = resolve_device(device)
        super().__init__(
            stripe_info(data), chunk_read_limit,
            lambda sts, stage: read_table(data, columns, sts, stage=stage,
                                          device=device))
        # cross-stripe invariants (agreeing writer time zones) are
        # checked per native read, so a conflict between stripes of
        # different chunks would pass chunk by chunk: walk every stripe
        # footer once up front, decoding no column
        read_table(data, columns=[], device=device)
