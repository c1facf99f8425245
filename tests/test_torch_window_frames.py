"""The port's ``Window`` against the JAX package's beyond the main table
of ``test_torch_window.py``: RANGE frames over a FLOAT64 ORDER BY key
with null and NaN runs, over a DECIMAL64 key with decimal bounds, and
over INT64 keys at the type's edges (saturated bounds); DECIMAL128
rolling sums that overflow 128 bits (null, never wrapped); a
multi-key spec (a STRING and an INT8 partition key, a descending
nulls-last INT32 order key and a FLOAT32 one) with STRING lag, lead and
first/last/nth values; unsigned and BOOL8 columns; and the reference's
error cases. Equal row for row under validity, float bits included; the
reference runs traced, one program a spec and row count."""

from __future__ import annotations

import functools

import numpy as np
import pytest

from spark_rapids_jni_tpu.ops.window import Window as JWindow
from spark_rapids_jni_tpu_torch.ops.window import Window
from torch_parity import (
    arrow_strings,
    assert_same_rows,
    error_of,
    jax_table,
    jref,
    null_tail,
    to_port,
)

FRAME_ROWS = [1, 256, 257, 2049]
INT64_MIN, INT64_MAX = -(1 << 63), (1 << 63) - 1


def _range_columns(n: int, seed: int) -> list:
    """[partition INT32, FLOAT64 key (NaN and null runs, ties), DECIMAL64
    key (scale -2, nulls), INT64 key at the edges, INT64 values, FLOAT64
    values, DECIMAL128 values near 2^126 (frames overflow), UINT32 key,
    UINT64 values, BOOL8 values]."""
    rng = np.random.default_rng(seed)
    fkey = rng.integers(0, 40, n) * 0.25
    fkey[rng.random(n) < 0.08] = np.nan
    edge = rng.choice([INT64_MIN, INT64_MIN + 3, -5, 0, 7, INT64_MAX - 4,
                       INT64_MAX], n)
    big = rng.integers(0, 2**62, n) | (1 << 62)
    d128 = np.stack([rng.integers(-2**62, 2**62, n), big], axis=1)
    return [
        (3, 0, rng.integers(0, max(1, n // 30), n).astype(np.int32), None),
        (10, 0, fkey, rng.random(n) > 0.1),
        (26, -2, rng.integers(-500, 500, n), rng.random(n) > 0.1),
        (4, 0, edge.astype(np.int64), None),
        (4, 0, rng.integers(-10**6, 10**6, n), null_tail(n, seed)),
        (10, 0, rng.standard_normal(n) * 1e3, null_tail(n, seed + 1)),
        (27, -1, d128.astype(np.int64), null_tail(n, seed + 2)),
        (7, 0, rng.integers(0, 60, n).astype(np.uint32), None),
        (8, 0, rng.integers(0, 2**63, n, dtype=np.uint64) * 2 + 1,
         null_tail(n, seed + 3)),
        (11, 0, rng.integers(0, 2, n).astype(np.uint8), null_tail(n, seed + 4)),
    ]


PART, FKEY, DKEY, EKEY, IVAL, FVAL, D128, UKEY, U64, BOOL = range(10)

# (spec: (partition_by, order_by, ascending, nulls_first), calls)
SPECS = {
    "float_key": (([PART], [FKEY], None, None), {
        "sum": ("rolling_sum", (IVAL, 1.5, 0.5, "range")),
        "count": ("rolling_count", (FVAL, 0.0, 0.0, "range")),
        "max": ("rolling_max", (FVAL, 2.0, 1.0, "range")),
        "min": ("rolling_min", (IVAL, 0.75, 0.25, "range")),
        "mean": ("rolling_mean", (FVAL, 1.0, 1.0, "range")),
        "var": ("rolling_var", (FVAL, 2.0, 0.0, 1, "range")),
        "d128": ("rolling_sum", (D128, 0.5, 0.0, "range")),
        "rank": ("rank", ()),
        "dense_rank": ("dense_rank", ()),
        "cume_dist": ("cume_dist", ()),
        "last_value": ("last_value", (FVAL,)),
    }),
    "decimal_key": (([PART], [DKEY], None, None), {
        "sum": ("rolling_sum", (IVAL, 0.29, 1.5, "range")),
        "count": ("rolling_count", (IVAL, 2, 0, "range")),
        "max": ("rolling_max", (FVAL, 0.5, 0.5, "range")),
    }),
    "edge_key": (([PART], [EKEY], None, None), {
        "sum": ("rolling_sum", (IVAL, 10, 10, "range")),
        "count": ("rolling_count", (IVAL, 4, 0, "range")),
        "min": ("rolling_min", (FVAL, 0, 7, "range")),
    }),
    "unsigned": (([PART], [UKEY], None, None), {
        "sum": ("rolling_sum", (BOOL, 3, 0, "range")),
        "running_sum_bool": ("running_sum", (BOOL,)),
        "running_min_u64": ("running_min", (U64,)),
        "running_max_u64": ("running_max", (U64,)),
        "rolling_max_u64": ("rolling_max", (U64, 2, 2)),
        "d128_rows": ("rolling_sum", (D128, 3, 1)),
    }),
}


def _multi_key_columns(n: int, seed: int) -> list:
    """[STRING partition (nulls), INT8 partition, INT32 order (nulls),
    FLOAT32 order, STRING values (nulls), INT64 values]."""
    rng = np.random.default_rng(seed)
    words = ["", "north", "south", "east"]
    skey = [words[i] for i in rng.integers(0, len(words), n)]
    off, chars, _ = arrow_strings(skey)
    vals = [f"v{i % 97}" * (i % 4) for i in range(n)]
    voff, vchars, _ = arrow_strings(vals)
    return [
        (23, 0, (off, chars), rng.random(n) > 0.1),
        (1, 0, rng.integers(0, 3, n).astype(np.int8), None),
        (3, 0, rng.integers(0, 9, n).astype(np.int32), rng.random(n) > 0.1),
        (9, 0, rng.integers(0, 4, n).astype(np.float32) * 0.5, None),
        (23, 0, (voff, vchars), null_tail(n, seed)),
        (4, 0, rng.integers(-99, 99, n), None),
    ]


MULTI = (([0, 1], [2, 3], [False, True], [False, True]), {
    "row_number": ("row_number", ()),
    "rank": ("rank", ()),
    "dense_rank": ("dense_rank", ()),
    "percent_rank": ("percent_rank", ()),
    "cume_dist": ("cume_dist", ()),
    "ntile": ("ntile", (3,)),
    "lag_str": ("lag", (4, 2)),
    "lead_str": ("lead", (4,)),
    "first_str": ("first_value", (4,)),
    "last_str": ("last_value", (4,)),
    "nth_str": ("nth_value", (4, 3)),
    "running_max": ("running_max", (5,)),
    "rolling_sum": ("rolling_sum", (5, 2, 2)),
    "rolling_count_str": ("rolling_count", (4, 1, 1)),
})


@functools.lru_cache(maxsize=None)
def _case(n: int, spec_name: str):
    if spec_name == "multi_key":
        cols, (spec, calls) = _multi_key_columns(n, n), MULTI
    else:
        cols, (spec, calls) = _range_columns(n, n), SPECS[spec_name]
    jt = jax_table(cols)

    def every_call(t):
        w = JWindow(t, *spec)
        return {k: getattr(w, name)(*args)
                for k, (name, args) in calls.items()}

    return Window(to_port(jt), *spec), jref(every_call, jt), calls


# the float key and the multi-key spec at every count of FRAME_ROWS; the
# other key types, whose functions those cover, at 257 and 2049 rows
CASES = [(n, s, c) for s, (_, calls) in
         list(SPECS.items()) + [("multi_key", MULTI)] for c in calls
         for n in (FRAME_ROWS if s in ("float_key", "multi_key")
                   else (257, 2049))]


@pytest.mark.parametrize("n,spec_name,call", CASES)
def test_window_frames(n, spec_name, call):
    port, want, calls = _case(n, spec_name)
    name, args = calls[call]
    assert_same_rows(getattr(port, name)(*args), want[call],
                     f"{spec_name} {call}")


def test_decimal128_overflow_is_null():
    """Frames whose DECIMAL128 sum passes 128 bits are null in both."""
    port, want, _ = _case(257, "float_key")
    got = port.rolling_sum(D128, 0.5, 0.0, "range")
    ref = want["d128"]
    assert not bool(got.validity.all())  # some frames overflow
    assert got.validity.tolist() == np.asarray(ref.validity).tolist()


def test_window_errors_match_reference():
    cols = _range_columns(64, 3) + [
        (23, 0, arrow_strings(["a", "b"] * 32)[:2], None)]
    jt = jax_table(cols)
    pt = to_port(jt)
    STR_COL = len(cols) - 1
    cases = [
        ("two order keys", lambda W, t: W(t, [PART], [FKEY, DKEY])
         .rolling_sum(IVAL, 1, 0, "range")),
        ("descending", lambda W, t: W(t, [PART], [FKEY], [False], [True])
         .rolling_sum(IVAL, 1, 0, "range")),
        ("nulls last", lambda W, t: W(t, [PART], [FKEY], [True], [False])
         .rolling_sum(IVAL, 1, 0, "range")),
        ("string key", lambda W, t: W(t, [PART], [STR_COL])
         .rolling_sum(IVAL, 1, 0, "range")),
        ("uint64 key", lambda W, t: W(t, [PART], [U64])
         .rolling_sum(IVAL, 1, 0, "range")),
        ("bound scale", lambda W, t: W(t, [PART], [DKEY])
         .rolling_sum(IVAL, 0.001, 0, "range")),
        ("negative range", lambda W, t: W(t, [PART], [FKEY])
         .rolling_sum(IVAL, -1, 0, "range")),
        ("negative rows", lambda W, t: W(t, [PART], [FKEY])
         .rolling_sum(IVAL, 1, -2)),
        ("frame kind", lambda W, t: W(t, [PART], [FKEY])
         .rolling_sum(IVAL, 1, 0, "groups")),
        ("lag", lambda W, t: W(t, [PART], [FKEY]).lag(IVAL, -1)),
        ("lead", lambda W, t: W(t, [PART], [FKEY]).lead(IVAL, -1)),
        ("ntile", lambda W, t: W(t, [PART], [FKEY]).ntile(0)),
        ("nth_value", lambda W, t: W(t, [PART], [FKEY]).nth_value(IVAL, 0)),
        ("ddof", lambda W, t: W(t, [PART], [FKEY]).rolling_var(FVAL, 2, 0, 2)),
        ("var string", lambda W, t: W(t, [PART], [FKEY])
         .rolling_var(STR_COL, 2)),
        ("running string", lambda W, t: W(t, [PART], [FKEY])
         .running_sum(STR_COL)),
        ("running d128", lambda W, t: W(t, [PART], [FKEY]).running_max(D128)),
        ("rolling string", lambda W, t: W(t, [PART], [FKEY])
         .rolling_min(STR_COL, 2)),
        ("mean d128", lambda W, t: W(t, [PART], [FKEY])
         .rolling_mean(D128, 2)),
    ]
    for what, fn in cases:
        got = error_of(lambda: fn(Window, pt))
        want = error_of(lambda: fn(JWindow, jt))
        assert got == want and got is not None, (what, got, want)


def test_rolling_var_nan_spreads_over_its_partition():
    """The reference centres each frame on the partition mean, so one NaN
    makes every variance of its partition NaN (a reference fault,
    ROADMAP.md Queue 3); the port keeps the reference's answer."""
    cols = [(3, 0, np.zeros(5, np.int32), None),
            (3, 0, np.arange(5, dtype=np.int32), None),
            (10, 0, np.array([1.0, np.nan, 2.0, 3.0, 4.0]), None)]
    jt = jax_table(cols)
    got = Window(to_port(jt), [0], [1]).rolling_var(2, 1)
    want = JWindow(jt, [0], [1]).rolling_var(2, 1)
    assert_same_rows(got, want, "rolling_var")
    assert np.isnan(got.data.numpy()[3:]).all()  # 0.5 in Spark
