"""The rest of the port's general groupby against the JAX package: var,
std, var_pop, std_pop, covar_samp, covar_pop, corr, nunique, first,
last and their *_include_nulls forms, DECIMAL128 sum/mean/min/max/var,
STRING min/max and UINT64 keys and values (both plans), with
``groupby_aggregate_auto`` and ``groupby_percentile``, at the reference's
edge row counts with null tails.

Tolerances: every integer, DECIMAL128 sum/mean/min/max, nunique,
first/last, min/max, percentile and key column is compared byte for
byte, over the real groups, with the row order. FLOAT64 results of float
sums added in another order than XLA's are held to ``rel * max(|want|,
max |want|)``: ``REL_SUM`` for float-column sums and means,
``REL_MOMENTS`` for the float64 two-pass var/std/covar/corr (the
centered sums of squares and products). The reference groupby runs
traced into one XLA program (``traced_reference``: ~10 s a row count for
every aggregate, against minutes op by op); XLA fuses the last float
steps of the exact DECIMAL128 var/std there, so those are held to
``REL_FUSED`` (one ulp seen) — test_torch_decimal128.py holds them
exact against the eager reference."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu import types as jt
from spark_rapids_jni_tpu.ops import groupby as jgroupby
from spark_rapids_jni_tpu_torch.ops import groupby, kernels
from torch_parity import (
    EDGE_ROWS,
    arrow_strings,
    assert_same_array,
    assert_same_groups,
    assert_same_table,
    jax_table,
    to_port,
    traced_reference,
)

REL_SUM = 1e-12
REL_MOMENTS = 1e-9
REL_FUSED = 1e-15

T = jt.TypeId
WORDS = ["", "a", "ab", "b", "zeta", "zz", "été", "a\x00"]


def host_table(n: int, seed: int) -> list:
    """Keys: INT8 (five values) and STRING (four words); values: INT64,
    FLOAT64 (NaN, +-0.0), FLOAT32, UINT64 (full range), DECIMAL64,
    DECIMAL128 (both limbs), STRING, INT32, BOOL8, UINT32. Each column
    but the first key has a null tail."""
    rng = np.random.default_rng(seed)

    def nulls(frac=0.2):
        valid = rng.random(n) > frac
        valid[-max(1, n // 7):] = False
        return valid

    f64 = rng.standard_normal(n) * 1e3
    f64[rng.random(n) < 0.02] = np.nan
    f64[rng.random(n) < 0.02] = -0.0
    words = [WORDS[i] for i in rng.integers(0, len(WORDS), n)]
    kwords = [WORDS[i] for i in rng.integers(1, 5, n)]
    d128 = np.stack([rng.integers(-2**63, 2**63 - 1, n, dtype=np.int64),
                     rng.integers(-2**20, 2**20, n)], axis=1)
    return [
        (int(T.INT8), 0, rng.integers(-2, 3, n).astype(np.int8), None),
        (int(T.STRING), 0, arrow_strings(kwords)[:2], nulls(0.05)),
        (int(T.INT64), 0, rng.integers(-2**40, 2**40, n), nulls()),
        (int(T.FLOAT64), 0, f64, nulls()),
        (int(T.FLOAT32), 0, rng.standard_normal(n).astype(np.float32),
         nulls()),
        (int(T.UINT64), 0, rng.integers(0, 2**64 - 1, n, dtype=np.uint64),
         nulls()),
        (int(T.DECIMAL64), -2, rng.integers(-10**12, 10**12, n), nulls()),
        (int(T.DECIMAL128), -3, d128, nulls()),
        (int(T.STRING), 0, arrow_strings(words)[:2], nulls()),
        (int(T.INT32), 0, rng.integers(-2**31, 2**31, n).astype(np.int32),
         nulls()),
        (int(T.BOOL8), 0, rng.integers(0, 2, n).astype(np.uint8), nulls()),
        (int(T.UINT32), 0, rng.integers(0, 2**32, n).astype(np.uint32),
         nulls()),
    ]


MOMENTS = ("var", "std", "var_pop", "std_pop")
FIRST_LAST = ("first", "last", "first_include_nulls", "last_include_nulls")
AGGS = (
    [(2, "count"), (8, "count")]
    + [(c, op) for c in (2, 3, 4, 5, 6, 7, 9, 10, 11) for op in ("sum", "mean")]
    + [(c, op) for c in (2, 3, 4, 5, 6, 7, 8, 9, 11) for op in ("min", "max")]
    + [(c, op) for c in (2, 3, 5, 6, 7) for op in MOMENTS]
    + [(c, "nunique") for c in (2, 3, 7, 8)]
    + [(c, op) for c in (3, 7, 8) for op in FIRST_LAST]
    + [(2, ("covar_samp", 9)), (3, ("covar_pop", 4)), (6, ("corr", 9)),
       (2, ("corr", 3)), (5, ("covar_samp", 11))]
)
KEYS = [0, 1]
def tolerances(host, aggs, nkeys=len(KEYS)) -> dict:
    """{output column: relative bound} of the float results of float sums
    (see the module docstring); every other column is exact."""
    tol = {}
    for i, (col, op) in enumerate(aggs):
        dt = host[col][0]
        floating = dt in (int(T.FLOAT32), int(T.FLOAT64))
        if isinstance(op, tuple) or (op in MOMENTS and dt != int(T.DECIMAL128)):
            tol[nkeys + i] = REL_MOMENTS
        elif op in MOMENTS:
            tol[nkeys + i] = REL_FUSED
        elif op in ("sum", "mean") and floating:
            tol[nkeys + i] = REL_SUM
    return tol


def _both(host, keys, aggs, max_groups=None, row_valid=None):
    """The port's groupby and the reference's, traced into one program."""
    jtab = jax_table(host)
    rv = None if row_valid is None else jnp.asarray(row_valid)
    want = traced_reference(
        lambda t, r: jgroupby._groupby_aggregate_impl(
            ((t, r),), None, None, keys=tuple(keys),
            aggs=tuple(aggs), max_groups=max_groups), jtab, rv)
    got = groupby.groupby_aggregate(
        to_port(jtab), keys, aggs, max_groups=max_groups,
        row_valid=None if row_valid is None else torch.from_numpy(row_valid))
    return got, want


@pytest.mark.parametrize("n", EDGE_ROWS)
def test_every_aggregate_matches_reference(n):
    host = host_table(n, n)
    got, want = _both(host, KEYS, AGGS)
    assert_same_groups(got, want, tolerances(host, AGGS))
    assert bool(got.sum_overflow) == bool(want.sum_overflow) is False


def test_empty_table_matches_reference():
    host = host_table(0, 0)
    aggs = AGGS[::3]
    got, want = _both(host, KEYS, aggs)
    assert_same_groups(got, want, tolerances(host, aggs))


def test_phantom_rows_and_overflow_match_reference():
    n = 2049
    host = host_table(n, 5)
    aggs = [a for a in AGGS if a[1] in MOMENTS + FIRST_LAST
            + ("nunique", "min")][::2]
    row_valid = np.random.default_rng(5).random(n) > 0.15
    got, want = _both(host, [0], aggs, row_valid=row_valid)
    assert_same_groups(got, want, tolerances(host, aggs, 1))
    got, want = _both(host, KEYS, aggs, max_groups=7)
    assert bool(got.overflowed)
    assert_same_groups(got, want, tolerances(host, aggs))


@pytest.mark.parametrize("start,final", [(1, 16), (3, 12), (64, 40)])
def test_groupby_aggregate_auto_matches_reference(start, final):
    # 5 groups in 40 rows: the bound grows 1 -> 4 -> 16, 3 -> 12, and 64
    # is capped at the row count
    host = host_table(40, 8)
    aggs = [(2, "sum"), (7, "mean")]
    got = groupby.groupby_aggregate_auto(to_port(jax_table(host)), [0], aggs,
                                         start)
    assert got.table.num_rows == final
    _, want = _both(host, [0], aggs, max_groups=final)
    assert_same_groups(got, want)


@pytest.mark.parametrize("n", [0] + EDGE_ROWS)
def test_groupby_percentile_matches_reference(n):
    # eager reference: traced, XLA contracts v0 * (1 - f) + v1 * f into a
    # fused multiply-add and the interpolated values move by an ulp
    host = host_table(n, n + 3)
    qs = [0.0, 0.25, 0.5, 0.9, 1.0]
    jtab = jax_table(host)
    for col in (3,) if n != 2049 else (2, 3, 6):
        want = jgroupby.groupby_percentile(jtab, KEYS, col, qs)
        got = groupby.groupby_percentile(to_port(jtab), KEYS, col, qs)
        assert_same_groups(got, want)
    with pytest.raises(NotImplementedError):
        groupby.groupby_percentile(to_port(jtab), KEYS, 7, qs)


def _uint64_keys(n, seed):
    rng = np.random.default_rng(seed)
    dom = np.array([0, 5, 2**63 - 1, 2**63, 2**63 + 7, 2**64 - 1], np.uint64)
    return dom, [
        (int(T.UINT64), 0, rng.choice(dom, n), rng.random(n) > 0.1),
        (int(T.UINT64), 0, rng.integers(0, 2**64 - 1, n, dtype=np.uint64),
         rng.random(n) > 0.1),
        (int(T.FLOAT64), 0, rng.standard_normal(n), rng.random(n) > 0.1),
    ]


@pytest.mark.parametrize("n", [257, 2049])
def test_uint64_keys_match_reference_on_both_plans(n):
    dom, host = _uint64_keys(n, n)
    aggs = [(1, "sum"), (1, "min"), (1, "max"), (2, "max"), (2, "count")]
    got, want = _both(host, [0], aggs)
    assert_same_groups(got, want)
    jtab = jax_table(host)
    kernels.reset_counts()
    gb = groupby.groupby_aggregate_bounded(to_port(jtab), [0], aggs,
                                           [dom.tolist()])
    wb = jgroupby.groupby_aggregate_bounded(jtab, [0], aggs, [dom.tolist()])
    # the kernel's inputs all: no fallback
    assert kernels.fallbacks() == {}
    assert_same_table(gb.table, wb.table)
    assert_same_array(gb.present.numpy(), wb.present)


def test_string_sums_and_float_var_refuse_as_the_reference():
    # the reference raises the same TypeErrors (a STRING column has no
    # numeric storage) while it traces: checked once, on the sum
    with pytest.raises(TypeError):
        jgroupby.groupby_aggregate(jax_table(host_table(20, 1)), [0],
                                   [(8, "sum")])
    host = host_table(20, 1)
    port = to_port(jax_table(host))
    for agg in [(8, "sum"), (8, "var"), (8, ("corr", 2))]:
        with pytest.raises(TypeError):
            groupby.groupby_aggregate(port, [0], [agg])
    with pytest.raises(ValueError):
        groupby.groupby_aggregate(port, [0], [(2, ("corr", 99))])


def test_bounded_string_min_max_raise_the_reference_error():
    """The bounded plan takes no STRING or DECIMAL128 min/max: the port
    raises the reference's TypeError (the type is not fixed-width), and
    a DECIMAL128 sum its NotImplementedError; the general plan computes
    them all."""
    host = host_table(50, 2)
    jtab = jax_table(host)
    port = to_port(jtab)
    dom = [(-2, -1, 0, 1, 2)]
    for agg, err, msg in [((8, "min"), TypeError, "STRING is not fixed"),
                          ((7, "max"), TypeError, "DECIMAL128 is not fixed"),
                          ((7, "sum"), NotImplementedError, "DECIMAL128")]:
        with pytest.raises(err, match=msg):
            jgroupby.groupby_aggregate_bounded(jtab, [0], [agg], dom)
        with pytest.raises(err, match=msg):
            groupby.groupby_aggregate_bounded(port, [0], [agg], dom)
