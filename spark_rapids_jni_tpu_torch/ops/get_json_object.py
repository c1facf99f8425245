"""get_json_object over STRING columns, Spark SQL's JSONPath extractor
(counterpart of the reference's ``ops/get_json_object.py``).

Two engines behind one dispatcher, as in the reference:

* the device engine (``ops/json_device.py``), taken when every row is
  escape-free and structurally sane (one scalar eligibility fetch
  decides);
* the native host engine, the reference's byte state machine in its C++
  library (``runtime/native.py``), for escaped or malformed documents:
  the column goes to the host, the engine decodes escapes and validates
  the full grammar, and the result comes back to the column's device.
  Each such call is recorded in ``telemetry.fallbacks()``.

Path grammar: ``$``, ``.field``, ``['field']``, ``[index]``; wildcards
and garbage raise ValueError before an engine is chosen.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from spark_rapids_jni_tpu_torch import telemetry
from spark_rapids_jni_tpu_torch import types as t
from spark_rapids_jni_tpu_torch.columnar import Column
from spark_rapids_jni_tpu_torch.parquet.footer import NativeError
from spark_rapids_jni_tpu_torch.runtime.native import load_native
from spark_rapids_jni_tpu_torch.utils.tracing import func_range

_HOST_REASON = ("escaped or malformed documents: escape decoding and full "
                "grammar validation live in the native host engine")


def get_json_object(col: Column, path: str) -> Column:
    """Extract ``path`` from every JSON document in a STRING column: the
    device engine's result when the column is eligible, the host engine
    otherwise."""
    if not col.dtype.is_string:
        raise TypeError("get_json_object requires a STRING column")
    from spark_rapids_jni_tpu_torch.ops import json_device as jd

    # one device pass computes the extraction AND the eligibility verdict;
    # only the one-byte verdict crosses to the host
    result, eligible = jd.extract_with_eligibility(col, path)
    if bool(eligible):
        return result
    return get_json_object_host(col, path)


@func_range("get_json_object_host")
def get_json_object_host(col: Column, path: str) -> Column:
    """The native host engine: one round trip of the column to the host
    (escape decoding and full grammar validation live there), recorded
    as a fallback; the result lands on the column's device."""
    if not col.dtype.is_string:
        raise TypeError("get_json_object requires a STRING column")
    from spark_rapids_jni_tpu_torch.ops.json_device import parse_json_path

    parse_json_path(path)  # a bad path is the caller's ValueError first
    telemetry.record_fallback("get_json_object", _HOST_REASON,
                              rows=col.size)
    if col.is_padded_string:
        from spark_rapids_jni_tpu_torch.ops.strings import unpad_strings

        col = unpad_strings(col)
    lib = load_native()
    n = col.size
    offsets = np.ascontiguousarray(col.data.cpu().numpy(), dtype=np.int32)
    chars = np.ascontiguousarray(col.chars.cpu().numpy(), dtype=np.uint8)
    if chars.size == 0:
        chars = np.zeros(1, dtype=np.uint8)
    valid_in = None if col.validity is None else np.ascontiguousarray(
        col.validity.cpu().numpy(), dtype=np.uint8)
    out_chars = ctypes.POINTER(ctypes.c_uint8)()
    out_len = ctypes.c_int64()
    out_offsets = np.empty(n + 1, dtype=np.int32)
    out_valid = np.empty(n, dtype=np.uint8)
    rc = lib.tpudf_get_json_object(
        chars.ctypes.data_as(ctypes.c_void_p),
        offsets.ctypes.data_as(ctypes.c_void_p),
        None if valid_in is None
        else valid_in.ctypes.data_as(ctypes.c_void_p),
        n, path.encode(), ctypes.byref(out_chars), ctypes.byref(out_len),
        out_offsets.ctypes.data_as(ctypes.c_void_p),
        out_valid.ctypes.data_as(ctypes.c_void_p))
    if rc != 0:
        msg = lib.last_error()
        # path errors carry a fixed "JSONPath: " prefix (the caller's
        # ValueError); anything else is an engine failure
        if msg.startswith("JSONPath:"):
            raise ValueError(msg)
        raise NativeError(msg)
    try:
        nbytes = out_len.value
        payload = np.ctypeslib.as_array(out_chars, shape=(max(nbytes, 1),))
        result_chars = np.array(payload[:nbytes], dtype=np.uint8, copy=True)
    finally:
        lib.tpudf_free_buffer(out_chars)
    dev = col.device
    return Column(t.STRING, torch.from_numpy(out_offsets).to(dev),
                  torch.from_numpy(out_valid.astype(bool)).to(dev),
                  chars=torch.from_numpy(result_chars).to(dev))


def json_tuple(col: Column, *fields: str) -> list:
    """Spark ``json_tuple(json, f1, f2, ...)``: one STRING column per
    top-level field, each through the two-engine ``get_json_object``
    with the ``$.field`` path (one full pass per field)."""
    if not fields:
        raise ValueError("json_tuple needs at least one field name")
    out = []
    for f in fields:
        if not f or any(ch in f for ch in ".[]'\"$*"):
            raise ValueError(
                f"json_tuple field {f!r} must be a plain top-level key "
                "(use get_json_object for nested paths)")
        out.append(get_json_object(col, f"$.{f}"))
    return out
