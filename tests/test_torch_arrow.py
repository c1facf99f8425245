"""The port's Arrow interop (``columnar/arrow.py``) against the JAX
package on the CPU: ``from_arrow`` of every mapped type (integers,
floats, booleans, string, large_string and binary, decimal128 at
precision <= 18 and above, date32, timestamps of each unit) with null
tails and chunked columns gives the reference's table bit for bit, at
the reference's edge row counts; ``to_arrow`` gives the reference's
pyarrow table, and the round trip gives back the input. The cases the
reference refuses (a nullable boolean column, non-UTF-8 binary; ROADMAP
Queue 3) are held to pyarrow itself."""

from __future__ import annotations

import decimal

import numpy as np
import pyarrow as pa
import pytest

from spark_rapids_jni_tpu.columnar.arrow import (
    from_arrow as jfrom_arrow,
    to_arrow as jto_arrow,
)
from spark_rapids_jni_tpu_torch import types as t
from spark_rapids_jni_tpu_torch.columnar import Column, Table
from spark_rapids_jni_tpu_torch.columnar.arrow import from_arrow, to_arrow
from torch_parity import EDGE_ROWS, assert_same_table, null_tail

D = decimal.Decimal


def _arrow_table(n: int, seed: int):
    rng = np.random.default_rng(seed)
    valid = null_tail(n, seed)

    def nulls(vals):
        return [v if ok else None for v, ok in zip(vals, valid)]

    return pa.table({
        "i8": pa.array(nulls(rng.integers(-128, 128, n).tolist()),
                       pa.int8()),
        "i64": pa.array(nulls(rng.integers(
            -2**63, 2**63 - 1, n, dtype=np.int64).tolist()), pa.int64()),
        "u64": pa.array(rng.integers(0, 2**64 - 1, n, dtype=np.uint64)),
        "f32": pa.array(nulls(rng.standard_normal(n).astype(
            np.float32).tolist()), pa.float32()),
        "f64": pa.array(rng.standard_normal(n)),
        "b": pa.array([bool(x) for x in rng.integers(0, 2, n)]),
        "s": pa.array(nulls([["", "héllo", "a b"][i % 3] + "x" * (i % 9)
                             for i in range(n)]), pa.string()),
        "ls": pa.array(nulls([f"k{i}" for i in range(n)]),
                       pa.large_string()),
        "bin": pa.array(nulls([bytes([65 + i % 26]) * (i % 4)
                               for i in range(n)]), pa.binary()),
        "d64": pa.array(nulls([D(int(x)).scaleb(-2) for x in rng.integers(
            -10**15, 10**15, n)]), pa.decimal128(18, 2)),
        "d128": pa.array(nulls([D(int(x) * 10**12 + 7).scaleb(-3)
                                for x in rng.integers(-2**62, 2**62, n)]),
                         pa.decimal128(38, 3)),
        "date": pa.array(nulls(rng.integers(-100_000, 100_000, n).tolist()),
                         pa.date32()),
        "ts_us": pa.array(nulls(rng.integers(-2**50, 2**50, n).tolist()),
                          pa.timestamp("us")),
        "ts_ms": pa.array(nulls(rng.integers(-2**40, 2**40, n).tolist()),
                          pa.timestamp("ms")),
        "ts_s": pa.array(rng.integers(-2**30, 2**30, n).tolist(),
                         pa.timestamp("s")),
    })


@pytest.mark.parametrize("n", EDGE_ROWS)
def test_from_and_to_arrow_match_reference(n):
    pt = _arrow_table(n, seed=n)
    if n > 2:  # chunked columns
        pt = pa.concat_tables([pt.slice(0, n // 3), pt.slice(n // 3)])
    got = from_arrow(pt, device="cpu")
    want = jfrom_arrow(pt)
    assert_same_table(got, want)
    back = to_arrow(got, names=pt.column_names)
    wback = jto_arrow(want, names=pt.column_names)
    assert back.column_names == wback.column_names
    for name in pt.column_names:
        assert back.column(name).type == wback.column(name).type, name
        assert back.column(name).equals(wback.column(name)), name
    # the round trip keeps the values (timestamps come back in us,
    # booleans as uint8, as in the reference)
    for name in ("i8", "i64", "u64", "f32", "f64", "s", "d64", "d128",
                 "date", "ts_us"):
        assert back.column(name).to_pylist() == \
            pt.column(name).to_pylist(), name


def test_duplicate_names_round_trip():
    c = Column.from_numpy(np.arange(4, dtype=np.int64), device="cpu")
    tbl = to_arrow(Table([c, c]), names=["x", "x"])
    assert tbl.column_names == ["x", "x"]
    assert from_arrow(tbl, device="cpu").num_columns == 2


def test_cases_the_reference_refuses_are_held_to_pyarrow():
    pt = pa.table({"b": pa.array([True, None, False]),
                   "bin": pa.array([b"\xff\xfe", None, b"ok"], pa.binary())})
    got = from_arrow(pt, device="cpu")
    assert got.column(0).dtype == t.BOOL8
    assert got.column(0).to_pylist() == [True, None, False]
    assert got.column(1).row_bytes() == [b"\xff\xfe", b"", b"ok"]
    assert got.column(1).validity.tolist() == [True, False, True]
    with pytest.raises(pa.ArrowInvalid):
        jfrom_arrow(pt.select(["b"]))
    with pytest.raises(UnicodeEncodeError):
        jfrom_arrow(pt.select(["bin"]))


def test_wide_decimal_and_decimal256_exact():
    vals = [D(2**126 - 1), D(-2**126), None, D(0)]
    for ty in (pa.decimal128(38, 0), pa.decimal256(40, 0)):
        pt = pa.table({"d": pa.array(vals, ty)})
        got = from_arrow(pt, device="cpu")
        assert got.column(0).dtype == t.decimal128(0)
        assert got.column(0).to_pylist() == [
            None if v is None else int(v) for v in vals]
        assert_same_table(got, jfrom_arrow(pt))
