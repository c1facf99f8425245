"""get_json_object over STRING columns, Spark SQL's JSONPath extractor
(counterpart of the reference's ``ops/get_json_object.py``).

Two engines behind one dispatcher, as in the reference:

* the device engine (``ops/json_device.py``), taken when every row is
  escape-free and structurally sane (one scalar eligibility fetch
  decides);
* the native host engine, the reference's byte state machine in its C++
  library, for escaped or malformed documents. The port does not build
  that library yet (ROADMAP.md Queue 1 entry 5, the readers), so
  ``get_json_object_host`` records the fallback and raises
  ``NotImplementedError``: a written gap, not a quiet path.

Path grammar: ``$``, ``.field``, ``['field']``, ``[index]``; wildcards
and garbage raise ValueError before an engine is chosen.
"""

from __future__ import annotations

from spark_rapids_jni_tpu_torch import telemetry
from spark_rapids_jni_tpu_torch.columnar import Column

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


def get_json_object_host(col: Column, path: str) -> Column:
    """The native host engine's path: recorded, then NotImplementedError
    (the library it calls is built with the readers, Queue 1 entry 5)."""
    if not col.dtype.is_string:
        raise TypeError("get_json_object requires a STRING column")
    from spark_rapids_jni_tpu_torch.ops.json_device import parse_json_path

    parse_json_path(path)  # a bad path is the caller's ValueError first
    telemetry.record_fallback("get_json_object", _HOST_REASON,
                              rows=col.size)
    raise NotImplementedError(
        "get_json_object's host engine (escaped or malformed JSON) needs "
        "the native library, which the port does not build yet: ROADMAP.md "
        "Queue 1 entry 5")


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
