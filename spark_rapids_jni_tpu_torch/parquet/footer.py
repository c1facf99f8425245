"""Parquet footer prune/filter over the native engine (counterpart of the
reference's ``parquet/footer.py``, the ParquetFooter API of the RAPIDS
jar: readAndFilter, getNumRows, getNumColumns, serializeThriftFile and
close). The work is C++ (``src/native/src/parquet_footer.cpp``); the
footer crosses the boundary as an int64 handle."""

from __future__ import annotations

import ctypes
from typing import Sequence

from spark_rapids_jni_tpu_torch.errors import MalformedInputError
from spark_rapids_jni_tpu_torch.runtime import integrity
from spark_rapids_jni_tpu_torch.runtime.native import load_native
from spark_rapids_jni_tpu_torch.utils.tracing import func_range


class NativeError(RuntimeError):
    """The native engine reported a failure."""


class MalformedFileError(MalformedInputError, NativeError):
    """Untrusted Parquet/ORC input failed structural validation: a
    :class:`MalformedInputError` for whoever classifies input faults,
    and a :class:`NativeError` for callers that catch the engine's
    failures, as in the reference."""


class ParquetFooter:
    def __init__(self, handle: int):
        if handle == 0:
            raise ValueError("null footer handle")
        self._handle = handle

    @classmethod
    @func_range("ParquetFooter.readAndFilter")
    def read_and_filter(
        cls,
        buffer: bytes,
        part_offset: int,
        part_length: int,
        names: Sequence[str],
        num_children: Sequence[int],
        parent_num_children: int,
        ignore_case: bool = False,
    ) -> "ParquetFooter":
        """Parse a raw thrift footer (no PAR1 framing), prune it to the
        requested depth-first column tree and keep the row groups whose
        midpoint lies in the byte range (a negative ``part_length``
        keeps them all). With ``ignore_case`` the caller lowercases
        ``names`` first, as the reference documents."""
        if len(names) != len(num_children):
            raise ValueError("names and num_children must have equal length")
        if integrity.enabled():
            if len(buffer) == 0:
                raise integrity.reject_malformed(
                    "parquet.footer", "empty thrift footer buffer",
                    exc_type=MalformedFileError)
            if part_offset < 0:
                raise integrity.reject_malformed(
                    "parquet.footer", "negative partition offset",
                    exc_type=MalformedFileError, part_offset=part_offset)
        lib = load_native()
        c_names = (ctypes.c_char_p * len(names))(
            *[n.encode() for n in names])
        c_children = (ctypes.c_int32 * len(num_children))(*num_children)
        handle = lib.tpudf_footer_read_and_filter(
            buffer, len(buffer), part_offset, part_length, c_names,
            c_children, len(names), parent_num_children,
            1 if ignore_case else 0)
        if handle == 0:
            raise integrity.reject_malformed(
                "parquet.footer", lib.last_error(),
                exc_type=MalformedFileError)
        return cls(handle)

    def _require_open(self) -> int:
        if self._handle == 0:
            raise ValueError("footer is closed")
        return self._handle

    @property
    def num_rows(self) -> int:
        lib = load_native()
        out = lib.tpudf_footer_num_rows(self._require_open())
        if out < 0:
            raise NativeError(lib.last_error())
        return out

    @property
    def num_columns(self) -> int:
        lib = load_native()
        out = lib.tpudf_footer_num_columns(self._require_open())
        if out < 0:
            raise NativeError(lib.last_error())
        return out

    @func_range("ParquetFooter.serializeThriftFile")
    def serialize_thrift_file(self) -> bytes:
        """A legal footer file image: PAR1, the thrift footer, its
        length and PAR1."""
        lib = load_native()
        out = ctypes.POINTER(ctypes.c_uint8)()
        out_len = ctypes.c_uint64()
        rc = lib.tpudf_footer_serialize(
            self._require_open(), ctypes.byref(out), ctypes.byref(out_len))
        if rc != 0:
            raise NativeError(lib.last_error())
        try:
            return ctypes.string_at(out, out_len.value)
        finally:
            lib.tpudf_free_buffer(out)

    def close(self) -> None:
        if self._handle != 0:
            load_native().tpudf_footer_close(self._handle)
            self._handle = 0

    def __enter__(self) -> "ParquetFooter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
