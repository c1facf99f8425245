"""The port's elementwise SQL functions (``ops/elementwise.py``) against
the JAX package's on the same inputs: every row count of ``EDGE_ROWS``
with null tails, each result equal row for row under validity (type,
validity and the value's bytes: exact for ints, decimals, strings and
float bits). The float -> BIGINT cast's saturation and pmod's edges
(INT64_MIN % -1, zero and negative divisors, float operands) have cases
of their own, as do the reference's error types."""

from __future__ import annotations

import numpy as np
import pytest

from spark_rapids_jni_tpu.ops import elementwise as je
from spark_rapids_jni_tpu_torch.ops import elementwise as pe
from torch_parity import (
    EDGE_ROWS,
    arrow_strings,
    assert_same_rows,
    both_spec,
    error_of,
    null_tail,
)

I8, I32, I64, U32, U64, F32, F64, D32, D64, D128, STR = \
    1, 3, 4, 7, 8, 9, 10, 25, 26, 27, 23
INT64_MIN, INT64_MAX = -(1 << 63), (1 << 63) - 1
FLOAT_EDGES = [np.nan, np.inf, -np.inf, 1e30, -1e30, 2.0 ** 63, -2.0 ** 63,
               2.0 ** 63 - 1024, 2.5, -2.5, -0.0, 0.0, 0.49, -0.51]


def _col(n, seed, tid, scale=0, *, nulls=True, kind="int"):
    """A seeded column spec with a null tail (every second seed none)."""
    rng = np.random.default_rng(seed)
    valid = null_tail(n, seed) if nulls else None
    if tid == STR:
        words = ["", "a", "bb", "ccc", "dddd", "é", "zz"]
        vals = [words[i] for i in rng.integers(0, len(words), n)]
        off, chars, _ = arrow_strings(vals)
        return (tid, 0, (off, chars), valid)
    if tid == D128:
        return (tid, scale, rng.integers(-2**62, 2**62, (n, 2),
                                         dtype=np.int64), valid)
    if tid in (F32, F64):
        v = rng.standard_normal(n) * 10.0 ** rng.integers(-3, 8, n)
        k = rng.random(n) < 0.3
        v[k] = np.array(FLOAT_EDGES)[rng.integers(0, len(FLOAT_EDGES),
                                                 int(k.sum()))]
        return (tid, 0, v.astype(np.float32 if tid == F32 else np.float64),
                valid)
    dt = {I8: np.int8, I32: np.int32, I64: np.int64, U32: np.uint32,
          U64: np.uint64, D32: np.int32, D64: np.int64}[tid]
    info = np.iinfo(dt)
    if kind == "small":
        v = rng.integers(-20, 20, n) if info.min < 0 \
            else rng.integers(0, 20, n)
    else:
        v = rng.integers(int(info.min), int(info.max), n, dtype=dt,
                         endpoint=True)
    return (tid, scale, np.asarray(v).astype(dt), valid)


def both(spec):
    return both_spec(spec)


# ---- coalesce / nullif ------------------------------------------------------

@pytest.mark.parametrize("n", EDGE_ROWS)
@pytest.mark.parametrize("tid", [I32, F64, D128, STR])
def test_coalesce(n, tid):
    cols = [both(_col(n, n + 7 * i, tid, -3 if tid == D128 else 0))
            for i in range(3)]
    got = pe.coalesce([p for p, _ in cols])
    want = je.coalesce([j for _, j in cols])
    assert_same_rows(got, want, "coalesce")


@pytest.mark.parametrize("n", EDGE_ROWS)
@pytest.mark.parametrize("tid", [I64, F64, D128, STR, U64])
def test_nullif(n, tid):
    a = _col(n, n, tid, -2 if tid == D128 else 0)
    b = _col(n, n + 1, tid, -2 if tid == D128 else 0)
    # plant equal values in a third of the rows
    rng = np.random.default_rng(n)
    eq = rng.random(n) < 0.33
    if tid == STR:
        rows = [x for x in (_string_list(a[2]))]
        brows = _string_list(b[2])
        brows = [r if not e else s for r, s, e in zip(brows, rows, eq)]
        off, chars, _ = arrow_strings([r.decode() for r in brows])
        b = (STR, 0, (off, chars), b[3])
    else:
        data = b[2].copy()
        data[eq] = a[2][eq]
        b = (b[0], b[1], data, b[3])
    (pa, ja), (pb, jb) = both(a), both(b)
    assert_same_rows(pe.nullif(pa, pb), je.nullif(ja, jb), "nullif")


def _string_list(data):
    off, chars = data
    blob = chars.tobytes()
    return [blob[off[i]:off[i + 1]] for i in range(len(off) - 1)]


# ---- greatest / least / abs -------------------------------------------------

@pytest.mark.parametrize("n", EDGE_ROWS)
@pytest.mark.parametrize("tid", [I8, I64, F32, F64, D64, U32, U64])
@pytest.mark.parametrize("op", ["greatest", "least"])
def test_greatest_least(n, tid, op):
    cols = [both(_col(n, 3 * n + i, tid, -2 if tid == D64 else 0))
            for i in range(3)]
    got = getattr(pe, op)([p for p, _ in cols])
    want = getattr(je, op)([j for _, j in cols])
    assert_same_rows(got, want, op)


@pytest.mark.parametrize("n", EDGE_ROWS)
@pytest.mark.parametrize("tid", [I8, I32, I64, F32, F64, U32])
def test_abs(n, tid):
    p, j = both(_col(n, n, tid))
    assert_same_rows(pe.abs_(p), je.abs_(j), "abs")


# ---- ceil / floor / round ----------------------------------------------------

@pytest.mark.parametrize("n", EDGE_ROWS)
@pytest.mark.parametrize("case", ["f64", "f32", "d64", "d32_pos_scale",
                                  "i32", "u64"])
@pytest.mark.parametrize("op", ["ceil", "floor"])
def test_ceil_floor(n, case, op):
    spec = {"f64": (F64, 0), "f32": (F32, 0), "d64": (D64, -2),
            "d32_pos_scale": (D32, 1), "i32": (I32, 0),
            "u64": (U64, 0)}[case]
    kind = "small" if case == "d32_pos_scale" else "int"
    p, j = both(_col(n, n + 5, *spec, kind=kind))
    assert_same_rows(getattr(pe, op)(p), getattr(je, op)(j), op)


def test_float_to_bigint_saturates_like_java():
    p, j = both((F64, 0, np.array([np.nan, np.inf, -np.inf, 1e30, -1e30,
                                   2.5, -2.5, 2.0 ** 63, -2.0 ** 63]), None))
    got = pe.ceil(p)
    assert got.data.tolist() == [0, INT64_MAX, INT64_MIN, INT64_MAX,
                                 INT64_MIN, 3, -2, INT64_MAX, INT64_MIN]
    assert_same_rows(got, je.ceil(j), "ceil")
    assert pe.floor(p).data.tolist()[5:7] == [2, -3]


@pytest.mark.parametrize("n", EDGE_ROWS)
@pytest.mark.parametrize("scale,d", [(-4, 0), (-4, 2), (-4, -1), (-2, 0),
                                     (-3, 1), (-2, 5)])
def test_round_decimal(n, scale, d):
    p, j = both(_col(n, n + 9, D64, scale))
    assert_same_rows(pe.round_decimal(p, d), je.round_decimal(j, d),
                     "round_decimal")
    p, j = both(_col(n, n + 10, D32, scale))
    assert_same_rows(pe.round_decimal(p, d), je.round_decimal(j, d),
                     "round_decimal 32")


def test_round_decimal_ties_are_half_up():
    p, j = both((D64, -2, np.array([150, -150, 250, -250, 149, -151, 50,
                                    -50]), None))
    got = pe.round_decimal(p, 0)
    assert got.data.tolist() == [2, -2, 3, -3, 1, -2, 1, -1]
    assert_same_rows(got, je.round_decimal(j, 0), "round ties")


# ---- pmod ---------------------------------------------------------------------

@pytest.mark.parametrize("n", EDGE_ROWS)
@pytest.mark.parametrize("tid", [I8, I32, I64, F32, F64, U32, U64])
def test_pmod(n, tid):
    a = _col(n, n, tid)
    b = _col(n, n + 1, tid, kind="small")  # zero and negative divisors
    (pa, ja), (pb, jb) = both(a), both(b)
    assert_same_rows(pe.pmod(pa, pb), je.pmod(ja, jb), "pmod")


def test_pmod_edges():
    a = np.array([INT64_MIN, INT64_MIN, INT64_MAX, -7, 7, -7, 7, 0, 5,
                  INT64_MIN], np.int64)
    b = np.array([-1, 1, -1, 3, -3, -3, 3, 0, 0, INT64_MIN], np.int64)
    (pa, ja), (pb, jb) = both((I64, 0, a, None)), both((I64, 0, b, None))
    got = pe.pmod(pa, pb)
    assert got.data.tolist()[:7] == [0, 0, 0, 2, 1, -1, 1]
    assert got.validity.tolist() == [True] * 7 + [False, False, True]
    assert_same_rows(got, je.pmod(ja, jb), "pmod edges")
    fa = np.array([-7.5, 7.5, -0.0, 1e300, -1e-300, np.nan, 5.0, np.inf])
    fb = np.array([2.0, -2.0, 3.0, 7.0, 3.0, 2.0, 0.0, 2.0])
    (pa, ja), (pb, jb) = both((F64, 0, fa, None)), both((F64, 0, fb, None))
    assert_same_rows(pe.pmod(pa, pb), je.pmod(ja, jb), "float pmod")
    # Spark's default shuffle partition count over hashed keys
    keys = np.random.default_rng(3).integers(INT64_MIN, INT64_MAX, 4096,
                                             dtype=np.int64)
    (pa, ja) = both((I64, 0, keys, None))
    (pb, jb) = both((I64, 0, np.full(4096, 200, np.int64), None))
    got = pe.pmod(pa, pb)
    assert got.data.tolist() == (keys % 200).tolist()
    assert_same_rows(got, je.pmod(ja, jb), "pmod 200")


# ---- errors -------------------------------------------------------------------

def test_errors_match_reference():
    (pi, ji) = both(_col(8, 1, I32))
    (pl, jl) = both(_col(8, 2, I64))
    (pf, jf) = both(_col(8, 3, F64))
    (ps, js) = both(_col(8, 4, STR))
    (pd, jd) = both(_col(8, 5, D128, -2))
    cases = [
        ("coalesce", lambda m, a, b, s, d, f: m.coalesce([])),
        ("coalesce types", lambda m, a, b, s, d, f: m.coalesce([a, b])),
        ("nullif types", lambda m, a, b, s, d, f: m.nullif(a, b)),
        ("greatest one", lambda m, a, b, s, d, f: m.greatest([a])),
        ("least strings", lambda m, a, b, s, d, f: m.least([s, s])),
        ("greatest d128", lambda m, a, b, s, d, f: m.greatest([d, d])),
        ("abs string", lambda m, a, b, s, d, f: m.abs_(s)),
        ("ceil d128", lambda m, a, b, s, d, f: m.ceil(d)),
        ("round float", lambda m, a, b, s, d, f: m.round_decimal(f, 0)),
        ("round d128", lambda m, a, b, s, d, f: m.round_decimal(d, 0)),
        ("pmod types", lambda m, a, b, s, d, f: m.pmod(a, b)),
        ("pmod string", lambda m, a, b, s, d, f: m.pmod(s, s)),
    ]
    for what, fn in cases:
        got = error_of(lambda: fn(pe, pi, pl, ps, pd, pf))
        want = error_of(lambda: fn(je, ji, jl, js, jd, jf))
        assert got == want and got is not None, (what, got, want)
    # a round to at least the column's scale returns the column itself
    (p2, _) = both(_col(8, 6, D64, -2))
    assert pe.round_decimal(p2, 2) is p2
