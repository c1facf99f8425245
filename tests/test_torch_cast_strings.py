"""The port's CastStrings (``ops/cast_strings.py``) and civil calendar
(``ops/_calendar.py``) against the JAX package on the CPU: the edge
inputs, the float parse over 20,000-row sets, the number -> string casts
(at the reference's edge row counts with null tails) and the calendar;
the parse casts of seeded strings at those counts are in
``tests/test_torch_cast_strings_rows.py``.

Every cast compares EXACTLY: types, validity, and every data byte, under
nulls too; a STRING result compares its offsets, chars and validity
tri-state byte for byte. That includes the FLOAT32 and FLOAT64 parses,
which the port computes in the reference's order with the reference's
constants (module docstring of ``ops/cast_strings.py``): bit-equal over
20,000 seeded strings of mixed shapes, 20,000 of ``bench.py``'s
CastStrings shape, and the edge inputs (subnormal results, overflow,
exponents past 308 and 400). No input is exempt.

The reference's exact casts run traced into one XLA program per shape;
its float parse runs eagerly, op by op (``torch_parity.cast_reference``)."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu import types as jt
from spark_rapids_jni_tpu.ops import _calendar as jcal
from spark_rapids_jni_tpu.ops import cast_strings as jcs
from spark_rapids_jni_tpu_torch import telemetry
from spark_rapids_jni_tpu_torch import types as t
from spark_rapids_jni_tpu_torch.columnar import Column
from spark_rapids_jni_tpu_torch.ops import _calendar as pcal
from spark_rapids_jni_tpu_torch.ops import cast_strings as pcs
from spark_rapids_jni_tpu_torch.ops.strings import pad_strings
from torch_parity import (
    EDGE_ROWS,
    assert_same_array,
    assert_same_column,
    bench_strings,
    both_fixed,
    both_strings,
    cast_port,
    cast_reference,
    check_parse,
    jax_table,
    mixed_float_strings,
    null_tail,
)

# ---- edge inputs --------------------------------------------------------------

INT_EDGES = [
    "123", "-45", "+7", "  42  ", "0", "", "abc", "12x", "--4", "4-", "1.5",
    None, "+", "-", " ", "\t9\n", "9223372036854775807",
    "9223372036854775808", "-9223372036854775808", "-9223372036854775809",
    "18446744073709551615", "18446744073709551616", "99999999999999999999",
    "00000000000000000000001", "0000000000000000000000000000000001",
    "-0", "+0", "127", "128", "-128", "-129", "255", "256", "32767",
    "32768", "-32768", "2147483647", "2147483648", "-2147483648",
    "4294967295", "4294967296", "1" * 33, " " * 40 + "5", "1 2", "٣",
]


@pytest.mark.parametrize("dtype", ["INT8", "INT16", "INT32", "INT64",
                                   "UINT8", "UINT16", "UINT32", "UINT64"])
def test_string_to_integer_edges(dtype):
    check_parse("integer", dtype, INT_EDGES)


DEC_EDGES = [
    "1.23", "4.5", "-0.07", "100", "2.999", "1.2.3", "abc", "", ".", "1..2",
    "0.125", "0.124", "-0.125", "0.115", "9999999.99", "99999999999.0",
    "9999999.995", "0000000001.0", "  -3.14159  ", "+.5", "5.", "-.",
    "999999999999999999", "9999999999999999.995", "0.005", "-0.005",
    "123456789012345678901234567890", "1e5", None, "0.0000000000000000001",
    "00000000000000000000000000000001.5",
]


@pytest.mark.parametrize("dtype", ["decimal64:-2", "decimal32:-2",
                                   "decimal64:0", "decimal64:-4",
                                   "decimal32:-9", "decimal64:2",
                                   "decimal64:-18"])
def test_string_to_decimal_edges(dtype):
    check_parse("decimal", dtype, DEC_EDGES)


FLOAT_EDGES = [
    "1.5", "-2.25", "3", "1e3", "2.5e-2", "  7.0  ", "Infinity", "-Infinity",
    "inf", "-inf", "+inf", "INF", "NaN", "nan", "-NaN", "infinit", "infinityy",
    "1e", "e5", "1.2e3.4", "abc", "", "1 2", "0e400", "0.0e999", "-0e999",
    "1e99999999999", "-1e99999999999", "1e-99999999999", "1e308", "1e309",
    "9e308", "1.7976931348623157e308", "1.7976931348623157E+308", "2e308",
    "1e-307", "1e-308", "2.2250738585072014e-308", "0.001e-306", "2.5e-310",
    "4.9e-324", "1e-323", "1e-400", "1e400", "1e-330", "123456789e-320",
    "0.022250738585072014e-306", "1.17549435e-38", "1.1754943e-38",
    "1.17549430e-38", "1.1754942e-38", "-1e-40", "1e-45", "1.4e-45",
    "3.4028235e38", "3.4028236e38", "3.5e38", "-3.4028235e38",
    "0.1", "0.3", "1.0000000000000002", "9007199254740993",
    "123456789012345678901234567890", "0.000000000000000000000000000001",
    ".5", "5.", "-.5e1", "1E+5", "1e+05", "1e-05", "+1.5e-3", "1e4e5",
    "1ee5", "1e--5", "00001.5", None, "infinity" + " " * 24 + "X",
    " " * 40 + "1.5", "1.5" + " " * 40, "\t-2.5e3\n",
]


@pytest.mark.parametrize("dtype", ["FLOAT64", "FLOAT32"])
def test_string_to_float_edges(dtype):
    check_parse("float", dtype, FLOAT_EDGES)


BOOL_EDGES = ["true", "TRUE", " t ", "y", "Yes", "1", "false", "F", "no",
              "N", "0", "truthy", "", "2", None, "tru", "\ttrue\n", "yEs",
              "  " * 30 + "no", "fAlSe", "t r", "ye"]


def test_string_to_boolean_edges():
    check_parse("boolean", None, BOOL_EDGES)


DATE_EDGES = [
    "2020-01-01", "2020-1-2", "2020-02-29", "2019-02-29", "2020-13-01",
    "2020-02-30", "20-01-01", "2020/01/01", "2020-1-", "x020-01-01",
    "2020-01-01x", "2020--1-01", "2021-00-10", "2021-04-31", None,
    "2020-011-1", "0001-01-01", "9999-12-31", "0000-03-01", "1900-02-29",
    "2000-02-29", " " * 40 + "2020-01-02", "2020-01-02" + " " * 40,
    "\t2020-1-2 \n", "20 20-01-02", "   ", "", "2020-01-02T00:00",
    "2020-1-02", "2020-01-2", "12020-01-01", "-2020-01-01", "2020-01-01 ",
]


def test_string_to_date_edges():
    check_parse("date", None, DATE_EDGES)


TS_EDGES = [
    "2020-01-01 25:00:00", "2020-01-01 10:61:00", "2020-01-01 10:00",
    "2020-01-01 10:00:00.", "2020-01-01 10:00:00.1234567",
    "2020-01-01X10:00:00", "2020-13-01 00:00:00", None,
    "2020-01-01 1:2:3:4", "  2020-1-2 3:4:5  ", "2020-01-02T03:04:05.5",
    "2020-01-02", "2020-01-02 23:59:59.999999", "1969-12-31 23:59:59.1",
    "0001-01-01 00:00:00", "9999-12-31T23:59:59.000001", "2020-01-02 3:4",
    "2020-01-02 03:04:05.12", "2020-01-02 :04:05", "2020-01-02  03:04:05",
    "2020-01-02 03:04:5.", "", "2020-01-02T", "2020-01-02 03:04:05" + " " * 9,
]


def test_string_to_timestamp_edges():
    check_parse("timestamp", None, TS_EDGES)


def test_trailing_empty_row_reads_the_previous_byte_as_the_reference_does():
    """A reference fault the port keeps (ROADMAP Queue 3): a valid empty
    row at the very end of the chars buffer clips its trim index onto the
    buffer's last byte, so it reads as that one byte. ['0', ''] casts to
    BOOL8 as [False, False], not [False, null]."""
    got = check_parse("boolean", None, ["0", ""])
    assert got.to_pylist() == [False, False]
    assert check_parse("boolean", None, ["0", "", "x"]).to_pylist() == [
        False, None, None]


def test_numeric_parses_ignore_input_validity_as_the_reference_does():
    """A reference fault the port keeps (ROADMAP Queue 3): the integer,
    decimal and float parses never read the input's validity, so a null
    row whose bytes hold a number parses as a valid value; the date,
    timestamp and boolean casts mask it."""
    vals, valid = ["5", "1.5", "2020-01-01", "t"], np.zeros(4, bool)
    assert check_parse("integer", "INT64", vals, valid).to_pylist() == [
        5, None, None, None]
    assert check_parse("float", "FLOAT64", vals, valid).to_pylist() == [
        5.0, 1.5, None, None]
    assert check_parse("decimal", "decimal64:-2", vals,
                       valid).to_pylist() == [500, 150, None, None]
    for kind in ("boolean", "date", "timestamp"):
        assert check_parse(kind, None, vals, valid).to_pylist() == [None] * 4


def test_padded_input_parses_as_its_arrow_layout():
    vals = ["12", " -7 ", "1.25", "x", None, "2020-02-29", "true"]
    arrow, ref = both_strings(vals)
    padded = pad_strings(arrow)
    for kind, name in (("integer", "INT64"), ("decimal", "decimal64:-2"),
                       ("float", "FLOAT64"), ("boolean", None),
                       ("date", None), ("timestamp", None)):
        assert_same_column(cast_port(kind, name, padded),
                           cast_reference(kind, name)(ref))


# ---- seeded strings at the edge row counts -----------------------------------


# ---- the float parse: bit-equal on two 20,000-row sets ----------------------

@pytest.mark.parametrize("dtype", ["FLOAT64", "FLOAT32"])
@pytest.mark.parametrize("which", ["mixed", "bench"])
def test_float_parse_bit_equal_on_20000_strings(which, dtype):
    vals = mixed_float_strings(20_000, 17) if which == "mixed" \
        else bench_strings(20_000)
    got = check_parse("float", dtype, vals)
    assert bool(got.validity.all())


def test_float64_parse_is_not_correctly_rounded_as_the_reference():
    """The reference's FLOAT64 parse (and so the port's) is not Python's
    correctly rounded ``float()`` (ROADMAP Queue 3), counted on the two
    20,000-row sets: (rows flushed to zero where Python gives a nonzero,
    of them rows whose true value is normal, other rows that differ,
    their largest distance in ulp). A normal value flushes when its
    decimal exponent is -308 or less: the reference's power of ten is
    subnormal there and XLA flushes it ('969245e-308' parses as 0.0,
    not 9.69245e-303)."""
    for vals, want in ((mixed_float_strings(20_000, 17), (129, 32, 7549, 5)),
                       (bench_strings(20_000), (0, 0, 4267, 1))):
        port, _ = both_strings(vals)
        got = pcs.string_to_float(port, t.FLOAT64).data.numpy()
        exact = np.array([float(v) for v in vals])
        flushed = (got == 0) & (exact != 0)
        ulp = np.abs(got.view(np.int64) - exact.view(np.int64))[~flushed]
        assert (int(flushed.sum()),
                int((flushed & (np.abs(exact) >= 2.0 ** -1022)).sum()),
                int((ulp > 0).sum()), int(ulp.max())) == want


# ---- number -> string ---------------------------------------------------------


# ---- number -> string ---------------------------------------------------------

def _int_values(np_dt, n: int, rng) -> np.ndarray:
    info = np.iinfo(np_dt)
    edges = [info.min, info.max, 0, 1, info.max - 1, info.min + 1]
    if np_dt == np.uint64:
        edges += [2**63 - 1, 2**63, 2**63 + 1]
    body = rng.integers(info.min, info.max, n, dtype=np_dt, endpoint=True)
    return np.concatenate([np.array(edges, dtype=np_dt), body]).astype(np_dt)


INT_TYPES = {np.int8: jt.TypeId.INT8, np.int16: jt.TypeId.INT16,
             np.int32: jt.TypeId.INT32, np.int64: jt.TypeId.INT64,
             np.uint8: jt.TypeId.UINT8, np.uint16: jt.TypeId.UINT16,
             np.uint32: jt.TypeId.UINT32, np.uint64: jt.TypeId.UINT64}


@pytest.mark.parametrize("n", EDGE_ROWS)
def test_number_to_string_at_edge_row_counts(n):
    rng = np.random.default_rng(n)
    valid = null_tail(n, n)
    for np_dt, tid in INT_TYPES.items():
        data = _int_values(np_dt, n, rng)[:n]
        got, want = both_fixed(data, tid, valid=valid)
        assert_same_column(pcs.integer_to_string(got),
                           jcs.integer_to_string(want))
    for scale in (-2, 0, -4, 3, -19):
        data = rng.integers(-2**63, 2**63 - 1, n, dtype=np.int64,
                            endpoint=True)
        data[: min(n, 3)] = [-2**63, 2**63 - 1, 0][: min(n, 3)]
        got, want = both_fixed(data, jt.TypeId.DECIMAL64, scale, valid)
        assert_same_column(pcs.decimal_to_string(got),
                           jcs.decimal_to_string(want))
    data = rng.integers(-10**9 + 1, 10**9, n).astype(np.int32)
    got, want = both_fixed(data, jt.TypeId.DECIMAL32, -9, valid)
    assert_same_column(pcs.decimal_to_string(got),
                       jcs.decimal_to_string(want))
    data = rng.integers(0, 3, n).astype(np.uint8)
    got, want = both_fixed(data, jt.TypeId.BOOL8, valid=valid)
    assert_same_column(pcs.boolean_to_string(got),
                       jcs.boolean_to_string(want))
    data = rng.integers(-2**31, 2**31, n, dtype=np.int64).astype(np.int32)
    data[: min(n, 2)] = [-2**31, 2**31 - 1][: min(n, 2)]
    got, want = both_fixed(data, jt.TypeId.TIMESTAMP_DAYS, valid=valid)
    assert_same_column(pcs.date_to_string(got), jcs.date_to_string(want))
    for np_dt, tid, top in ((np.float64, jt.TypeId.FLOAT64, 300),
                            (np.float32, jt.TypeId.FLOAT32, 30)):
        data = (rng.standard_normal(n) * 10.0 ** rng.integers(
            -top, top, n)).astype(np_dt)
        got, want = both_fixed(data, tid, valid=valid)
        assert_same_column(pcs.float_to_string(got),
                           jcs.float_to_string(want))


def test_number_to_string_all_valid_and_empty():
    """No validity mask in, none out; zero rows give zero bytes."""
    for data, tid, scale in ((np.arange(-5, 6, dtype=np.int64),
                              jt.TypeId.INT64, 0),
                             (np.zeros(0, np.int64), jt.TypeId.DECIMAL64, -2),
                             (np.zeros(0, np.int32),
                              jt.TypeId.TIMESTAMP_DAYS, 0)):
        got, want = both_fixed(data, tid, scale)
        fn = {jt.TypeId.INT64: "integer_to_string",
              jt.TypeId.DECIMAL64: "decimal_to_string",
              jt.TypeId.TIMESTAMP_DAYS: "date_to_string"}[tid]
        assert_same_column(getattr(pcs, fn)(got), getattr(jcs, fn)(want))
    got, want = both_fixed(np.array([1, 0], np.uint8), jt.TypeId.BOOL8,
                            valid=np.array([True, True]))
    out = pcs.boolean_to_string(got)
    assert out.validity is None  # a mask of all-valid rows is dropped
    assert_same_column(out, jcs.boolean_to_string(want))


def test_digit_matrix_u64_matches_reference():
    vals = np.array([0, 1, 9, 10, 2**63 - 1, 2**63, 2**64 - 1, 2**63 + 1,
                     10**19, 10**19 - 1, 12345678901234567890], np.uint64)
    got = pcs._digit_matrix_u64(torch.from_numpy(vals.view(np.int64)))
    want = jcs._digit_matrix_u64(jax_table([(int(jt.TypeId.UINT64), 0, vals,
                                             None)]).column(0).data)
    assert_same_array(got.numpy(), np.asarray(want))
    neg, mag = pcs._signed_magnitude(torch.tensor(
        [-2**63, -1, 0, 2**63 - 1]))
    assert mag.view(torch.uint64).tolist() == [2**63, 1, 0, 2**63 - 1]
    assert neg.tolist() == [True, True, False, False]


def test_float_to_string_records_its_host_fallback():
    telemetry.reset()
    got, _ = both_fixed(np.array([1.5, -0.0], np.float64),
                         jt.TypeId.FLOAT64)
    assert pcs.float_to_string(got).to_pylist() == ["1.5", "-0.0"]
    (key, rec), = telemetry.fallbacks().items()
    assert key[0] == "float_to_string" and rec == {"calls": 1, "rows": 2}
    pcs.integer_to_string(both_fixed(np.arange(3), jt.TypeId.INT64)[0])
    assert telemetry.fallbacks()[key]["calls"] == 1  # the device path


def test_round_trips_through_text_at_scale():
    rng = np.random.default_rng(5)
    days = rng.integers(-700_000, 2_900_000, 4000).astype(np.int32)
    col = Column.from_numpy(days, t.TIMESTAMP_DAYS, device="cpu")
    back = pcs.string_to_date(pcs.date_to_string(col))
    assert bool(back.validity.all())
    assert torch.equal(back.data, col.data)
    vals = rng.integers(-10**17, 10**17, 4000)
    dcol = Column.from_numpy(vals, t.decimal64(-4), device="cpu")
    back = pcs.string_to_decimal(pcs.decimal_to_string(dcol), t.decimal64(-4))
    assert bool(back.validity.all()) and torch.equal(back.data, dcol.data)


# ---- the civil calendar --------------------------------------------------------

def test_calendar_matches_reference_over_the_whole_range():
    import jax.numpy as jnp

    days = np.arange(-800_000, 3_000_001, dtype=np.int64)
    got = pcal.civil_from_days(torch.from_numpy(days))
    want = jcal.civil_from_days(jnp.asarray(days))
    for g, w in zip(got, want):
        assert_same_array(g.numpy(), np.asarray(w))
    back = pcal.days_from_civil(*got)
    assert_same_array(back.numpy(), np.asarray(jcal.days_from_civil(*want)))
    assert_same_array(back.numpy(), days)
