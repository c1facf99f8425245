"""The port's bounded groupby against the JAX package: sum / count /
mean / min / max with null keys, null values, ``row_valid``, domain
misses, an empty table, and the inputs the reference keeps off its
kernel (wide domains, float and uint64 lanes) that the port's takes,
plus the plain accumulate kernel against the reference Pallas kernel in
interpret mode.

Exact, float64 means included: both sides divide the same exact int64
total by the same count. Float-column SUM/MEAN is the one exception (see
``test_float_aggregates_fall_back``)."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu import types as jt
from spark_rapids_jni_tpu.ops.groupby import (
    groupby_aggregate_bounded as j_bounded,
)
from spark_rapids_jni_tpu.ops.pallas import groupby_accumulate as jga
from spark_rapids_jni_tpu_torch.ops import kernels
from spark_rapids_jni_tpu.ops.table_ops import trim_table as jtrim
from spark_rapids_jni_tpu_torch.ops.groupby import (
    bounded_lanes,
    groupby_aggregate_bounded,
)
from spark_rapids_jni_tpu_torch.ops.table_ops import trim_table
from spark_rapids_jni_tpu_torch.ops.kernels import groupby_accumulate as kga
from spark_rapids_jni_tpu_torch.ops.planner import plan_groupby, scalar_domain
from torch_parity import (
    EDGE_ROWS,
    assert_same_array,
    assert_same_table,
    assert_same_valid_table,
    jax_table,
    to_port,
)

DOMAINS = [(0, 5, 10), (1, 2)]
AGGS = [(2, "sum"), (2, "count"), (2, "mean"), (3, "min"), (3, "max"),
        (3, "sum"), (4, "mean"), (4, "min"), (5, "max"), (5, "sum"),
        (6, "count"), (6, "sum"), (7, "mean"), (7, "max")]


def _input(n, seed, miss=False):
    rng = np.random.default_rng(seed)

    def tail(frac):
        valid = rng.random(n) > 0.1
        valid[-max(1, int(n * frac)):] = False
        return valid

    k0 = rng.choice(np.array([0, 5, 10], np.int32), n)
    if miss and n:
        k0[rng.random(n) < 0.05] = 7  # outside the declared domain
    k1 = rng.choice(np.array([1, 2], np.int8), n)
    cols = [
        (jt.TypeId.INT32, 0, k0, tail(0.25)),
        (jt.TypeId.INT8, 0, k1, None),
        (jt.TypeId.INT64, 0, rng.integers(-2**62, 2**62, n), tail(0.125)),
        (jt.TypeId.INT8, 0, rng.integers(-128, 128, n).astype(np.int8), None),
        (jt.TypeId.INT32, 0, rng.integers(-2**31, 2**31, n).astype(np.int32),
         tail(0.3)),
        (jt.TypeId.UINT16, 0, rng.integers(0, 2**16, n).astype(np.uint16),
         tail(0.2)),
        (jt.TypeId.BOOL8, 0, (rng.random(n) > 0.5).astype(np.uint8), None),
        (jt.TypeId.DECIMAL64, -2, rng.integers(-10**12, 10**12, n),
         tail(0.5)),
    ]
    return jax_table([(int(tid), s, d, v) for tid, s, d, v in cols])


def _compare(jtab, aggs=AGGS, domains=DOMAINS, row_valid=None):
    ptab = to_port(jtab)
    keys = list(range(len(domains)))
    got = groupby_aggregate_bounded(
        ptab, keys, aggs, domains,
        None if row_valid is None else torch.from_numpy(row_valid))
    want = j_bounded(jtab, keys, aggs, domains,
                     None if row_valid is None else jnp.asarray(row_valid))
    assert_same_table(got.table, want.table)
    assert_same_array(got.present.numpy(), want.present)
    assert_same_array(got.domain_miss.numpy(), want.domain_miss)
    return got


@pytest.mark.parametrize("n", EDGE_ROWS)
def test_bounded_groupby_matches_reference(n):
    kernels.reset_counts()
    _compare(_input(n, seed=n))
    # CPU tensors take the kernel's plain version: no launch, no fallback
    assert kernels.launches() == {} and kernels.fallbacks() == {}


@pytest.mark.parametrize("n", [257, 2049])
def test_row_valid_and_domain_miss(n):
    jtab = _input(n, seed=n + 1, miss=True)
    row_valid = np.random.default_rng(n).random(n) > 0.3
    res = _compare(jtab, row_valid=row_valid)
    assert bool(res.domain_miss)
    res = _compare(jtab)
    assert bool(res.domain_miss)


def test_empty_table():
    kernels.reset_counts()
    _compare(_input(0, seed=0))
    # an empty input is no fallback: the accumulate takes n == 0
    assert kernels.launches() == {} and kernels.fallbacks() == {}


def test_too_many_lanes_falls_back():
    """101 slots x 22 lanes, past the TPU kernel's 2048 cells (the
    reference falls back with too_many_lanes): the port's kernel takes
    them, so no fallback is counted, and the result matches."""
    n = 600
    rng = np.random.default_rng(1)
    # 100-value domain -> m = 101 slots; 1 row lane + 7 columns x (valid
    # count, sum, max) = 22 lanes
    cols = [(int(jt.TypeId.INT32), 0,
             rng.integers(0, 105, n).astype(np.int32), None)]
    cols += [(int(jt.TypeId.INT64), 0, rng.integers(-99, 99, n),
              rng.random(n) > 0.1) for _ in range(7)]
    aggs = [(c, op) for c in range(1, 8) for op in ("sum", "max")]
    kernels.reset_counts()
    res = _compare(jax_table(cols), aggs=aggs, domains=[tuple(range(100))])
    assert bool(res.domain_miss)
    assert kga.unsupported_reason(
        bounded_lanes(to_port(jax_table(cols)), aggs).lanes, 101) is None
    assert kernels.fallbacks() == {}


def test_float_aggregates_fall_back():
    """Float min/max and float sums, which the reference keeps off its
    kernel (minmax_width, float_agg), are kernel inputs in the port: no
    fallback is counted. Min/max are exact (NaN masks equal, values ==);
    sums and means are held to a relative 1e-12 (float64 sums in another
    order; the float32 column's sum is rounded to float32)."""
    n = 2049
    rng = np.random.default_rng(2)
    f64 = rng.standard_normal(n)
    f64[rng.random(n) < 0.05] = np.nan
    jtab = jax_table([
        (int(jt.TypeId.INT8), 0, rng.integers(1, 3, n).astype(np.int8), None),
        (int(jt.TypeId.FLOAT64), 0, f64, rng.random(n) > 0.2),
        (int(jt.TypeId.FLOAT32), 0, rng.standard_normal(n).astype(np.float32),
         None),
    ])
    ptab = to_port(jtab)
    for aggs in ([(1, "min"), (1, "max"), (2, "max"), (1, "count")],
                 [(1, "sum"), (1, "mean"), (2, "sum")]):
        kernels.reset_counts()
        got = groupby_aggregate_bounded(ptab, [0], aggs, [(1, 2)])
        want = j_bounded(jtab, [0], aggs, [(1, 2)])
        assert kernels.fallbacks() == {}
        for i, (g, w) in enumerate(zip(got.table.columns,
                                       want.table.columns)):
            gd, wd = g.data.numpy(), np.asarray(w.data)
            assert gd.dtype == wd.dtype
            assert_same_array(np.isnan(gd) if gd.dtype.kind == "f"
                              else gd == gd, np.isnan(wd) if wd.dtype.kind
                              == "f" else wd == wd, f"column {i} NaNs")
            if aggs[0][1] == "sum" and i > 0:
                rtol = 1e-5 if gd.dtype == np.float32 else 1e-12
                np.testing.assert_allclose(gd, wd, rtol=rtol,
                                           err_msg=f"column {i}")
            else:
                ok = (gd == wd) | (np.isnan(gd) & np.isnan(wd)) \
                    if gd.dtype.kind == "f" else gd == wd
                assert ok.all(), f"column {i}"
            assert_same_array(g.validity.numpy(), w.validity)


def test_plan_groupby_bounded_and_general():
    jtab = _input(300, seed=4)
    doms = [scalar_domain(d) for d in DOMAINS]
    res = plan_groupby(to_port(jtab), [0, 1], AGGS, doms)
    assert res.lowered == "bounded" and res.overflowed is False
    want = j_bounded(jtab, [0, 1], AGGS, DOMAINS)
    assert_same_table(res.table, want.table)
    # one key without a domain: the general lowering, as the reference's
    from spark_rapids_jni_tpu.ops import planner as jplanner

    gen = plan_groupby(to_port(jtab), [0, 1], AGGS, [doms[0], None])
    jdoms = [jplanner.Domain(d.values, d.kind, d.source) for d in doms]
    jgen = jplanner.plan_groupby(jtab, [0, 1], AGGS, [jdoms[0], None])
    assert gen.lowered == jgen.lowered == "general"
    assert not bool(gen.overflowed)
    k = int(np.asarray(jgen.present).sum())
    assert int(gen.present.sum()) == k
    assert_same_valid_table(trim_table(gen.table, k),
                            jtrim(jgen.table, k))


def test_plain_kernel_matches_pallas_interpret():
    n, m = 2049, 5
    rng = np.random.default_rng(9)
    gid = rng.integers(0, m + 1, n).astype(np.int32)  # m: no group
    meta = (("sum", 0), ("sum", 0), ("min", 2**31 - 1), ("max", -2**31),
            ("sum", 0))
    values = [np.ones(n, np.int32),
              rng.integers(-2**15, 2**15, n).astype(np.int32),
              rng.integers(-2**31, 2**31, n).astype(np.int32),
              rng.integers(-2**31, 2**31, n).astype(np.int32),
              rng.integers(0, 2**15, n).astype(np.int32)]
    sums, mins, maxs = jga.accumulate(
        jnp.asarray(gid), [jnp.asarray(v) for v in values], meta, m,
        interpret=True)
    lanes = [kga.Lane(op, torch.from_numpy(v), None, neutral)
             for (op, neutral), v in zip(meta, values)]
    got = kga.accumulate_plain(torch.from_numpy(gid), lanes, m).numpy()
    for li, (op, _) in enumerate(meta):
        want = {"sum": sums, "min": mins, "max": maxs}[op][:, li]
        assert_same_array(got[:, li], np.asarray(want).astype(np.int64), op)
