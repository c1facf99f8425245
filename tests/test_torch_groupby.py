"""The port's general sort-based groupby against the JAX package: sum,
count, mean, min and max over every fixed-width family, null and NaN
keys, null values, ``max_groups`` below the group count (``overflowed``),
phantom rows (``row_valid``) and n = 0. ``num_groups``, ``overflowed``
and the compacted table are compared: exact, except float-valued sums
and means, which are held to a relative 1e-12 (the summation order
differs)."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu import types as jt
from spark_rapids_jni_tpu.ops import groupby as jgroupby
from spark_rapids_jni_tpu_torch.interop import table_to_numpy
from spark_rapids_jni_tpu_torch.ops import groupby
from torch_parity import (
    EDGE_ROWS,
    assert_same_array,
    assert_same_groups,
    host_columns,
    jax_table,
    to_port,
)

REL = 1e-12

# key columns 0-2, value columns 3-12
AGGS = (
    [(c, "sum") for c in (3, 4, 5, 6, 7, 8, 9, 10, 11, 12)]
    + [(c, "mean") for c in (3, 6, 7, 8)]
    + [(3, "count"), (8, "count"), (0, "count")]
    + [(3, "min"), (4, "max"), (5, "min"), (7, "max"), (8, "min"),
       (8, "max"), (9, "max"), (10, "min"), (10, "max"), (12, "min")]
)
# the edge-row sweep: one of each aggregate, signed, decimal, float and
# uint64 columns
EDGE_AGGS = [(3, "sum"), (8, "sum"), (7, "mean"), (6, "count"),
             (10, "min"), (9, "max")]


def host_table(n: int, seed: int) -> list:
    """Keys: int8 (few values), float64 (NaN of both signs, +-0.0),
    TIMESTAMP_DAYS; values: int32, uint16, uint32, int64, DECIMAL64,
    float64, float32, uint64, int8, BOOL8. Every other column has a null
    tail."""
    rng = np.random.default_rng(seed)

    def nulls(k):
        if k % 2 == 0:
            return None
        valid = rng.random(n) > 0.2
        valid[-max(1, n // 6):] = False
        return valid

    T = jt.TypeId
    specs = [
        (T.INT8, 0, rng.integers(-2, 3, n).astype(np.int8)),
        (T.FLOAT64, 0, rng.choice(np.asarray(
            [np.nan, -np.nan, 0.0, -0.0, 2.5]), n)),
        (T.TIMESTAMP_DAYS, 0, rng.integers(0, 2, n).astype(np.int32)),
        (T.INT32, 0, rng.integers(-2**31, 2**31, n).astype(np.int32)),
        (T.UINT16, 0, rng.integers(0, 2**16, n).astype(np.uint16)),
        (T.UINT32, 0, rng.integers(0, 2**32, n).astype(np.uint32)),
        (T.INT64, 0, rng.integers(-2**62, 2**62, n)),
        (T.DECIMAL64, -2, rng.integers(-10**12, 10**12, n)),
        (T.FLOAT64, 0, rng.uniform(1.0, 2.0, n) * 1e6),
        (T.FLOAT32, 0, rng.uniform(1.0, 2.0, n).astype(np.float32)),
        (T.UINT64, 0, rng.integers(0, 2**64 - 1, n, dtype=np.uint64)),
        (T.INT8, 0, rng.integers(-128, 128, n).astype(np.int8)),
        (T.BOOL8, 0, rng.integers(0, 2, n).astype(np.uint8)),
    ]
    return [(int(t), s, d, nulls(k)) for k, (t, s, d) in enumerate(specs)]


def _float_valued(jres, col: int, aggs) -> bool:
    """Column ``col`` of the output holds a float sum or mean."""
    nkeys = len(jres.table.columns) - len(aggs)
    if col < nkeys:
        return False
    _, op = aggs[col - nkeys]
    return op in ("sum", "mean") and \
        np.asarray(jres.table.columns[col].data).dtype.kind == "f"


def assert_groupby_matches(got, want, aggs):
    assert int(got.num_groups) == int(want.num_groups)
    assert bool(got.overflowed) == bool(want.overflowed)
    rows = min(int(want.num_groups), want.table.num_rows)
    got_cols = table_to_numpy(got.table)
    want_cols = host_columns(want.table)
    assert len(got_cols) == len(want_cols)
    for i, (g, w) in enumerate(zip(got_cols, want_cols)):
        assert g[:2] == w[:2], f"column {i}: type"
        gv = g[3] if g[3] is not None else np.ones(len(g[2]), bool)
        wv = w[3] if w[3] is not None else np.ones(len(w[2]), bool)
        assert_same_array(gv[:rows], wv[:rows], f"column {i} validity")
        if _float_valued(want, i, aggs):
            gd, wd = g[2][:rows], w[2][:rows]
            assert gd.dtype == wd.dtype
            np.testing.assert_allclose(gd, wd, rtol=REL, atol=0,
                                       err_msg=f"column {i}")
        else:
            assert_same_array(g[2][:rows], w[2][:rows], f"column {i} data")


def _both(host, keys, aggs, max_groups=None, row_valid=None):
    jtab = jax_table(host)
    want = jgroupby.groupby_aggregate(
        jtab, keys, aggs, max_groups=max_groups,
        row_valid=None if row_valid is None else jnp.asarray(row_valid))
    got = groupby.groupby_aggregate(
        to_port(jtab), keys, aggs, max_groups=max_groups,
        row_valid=None if row_valid is None else torch.from_numpy(row_valid))
    return got, want


@pytest.mark.parametrize("n", [0] + EDGE_ROWS)
def test_groupby_matches_reference(n):
    got, want = _both(host_table(n, n), [0, 1, 2], EDGE_AGGS)
    assert_groupby_matches(got, want, EDGE_AGGS)
    assert got.table.num_rows == n


def test_every_value_type_matches_reference():
    n = 2049
    got, want = _both(host_table(n, n + 2), [0, 1, 2], AGGS)
    assert_groupby_matches(got, want, AGGS)


def test_groupby_overflow_matches_reference():
    host = host_table(2049, 3)
    got, want = _both(host, [0, 1, 2], AGGS[:8], max_groups=5)
    assert bool(got.overflowed) and int(got.num_groups) > 5
    assert_groupby_matches(got, want, AGGS[:8])
    with pytest.raises(ValueError, match="overflowed"):
        got.compact()


@pytest.mark.parametrize("n", [257, 2048])
def test_groupby_phantom_rows_match_reference(n):
    host = host_table(n, n + 1)
    row_valid = np.random.default_rng(n).random(n) > 0.15
    got, want = _both(host, [0, 2], EDGE_AGGS, row_valid=row_valid)
    assert_groupby_matches(got, want, EDGE_AGGS)


def test_compact_trims_to_the_groups():
    host = host_table(300, 9)
    got, want = _both(host, [2], [(3, "sum")])
    assert int(got.num_groups) == 2
    compact = got.compact()
    assert compact.num_rows == 2
    assert compact.equals(groupby.GroupByResult(
        got.table, got.num_groups).compact())


@pytest.mark.parametrize("agg,err", [
    ((3, "var"), None),
    ((3, "std_pop"), None),
    ((3, "nunique"), None),
    ((3, "first"), None),
    ((3, "last_include_nulls"), None),
    ((3, ("corr", 6)), None),
    ((3, "median"), ValueError),
])
def test_unported_aggregates_raise(agg, err):
    """The aggregates the port once refused now match the reference (var
    and corr within their relative bound: float sums in another order);
    an unknown aggregate still raises ValueError."""
    host = host_table(10, 0)
    if err is not None:
        with pytest.raises(err):
            groupby.groupby_aggregate(to_port(jax_table(host)), [0], [agg])
        return
    got, want = _both(host, [0], [agg])
    tol = {1: 1e-9} if agg[1] in ("var", "std_pop") \
        or isinstance(agg[1], tuple) else {}
    assert_same_groups(got, want, tol)


def test_decimal128_aggregates_raise_but_count():
    """DECIMAL128 sum, mean, min and max, once refused, match the
    reference exactly, as count did."""
    n = 20
    rng = np.random.default_rng(0)
    host = [(int(jt.TypeId.INT8), 0, rng.integers(0, 3, n).astype(np.int8),
             None),
            (int(jt.TypeId.DECIMAL128), -3,
             rng.integers(-9, 9, (n, 2)).astype(np.int64), None)]
    for op in ("sum", "mean", "min", "max"):
        got, want = _both(host, [0], [(1, op)])
        assert_same_groups(got, want)
    got, want = _both(host, [1, 0], [(1, "count")])
    assert_groupby_matches(got, want, [(1, "count")])
