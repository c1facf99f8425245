"""The port's exact DECIMAL128 arithmetic against the JAX package: the
limb helpers (``split_sum128_lanes``, ``recombine_sum128``,
``_mean128_exact``, the base-2^16 var numerator), the reductions
``sum_``/``mean``/``min_``/``max_``, and the groupby's DECIMAL128 sum,
mean, var/std/var_pop/std_pop and the covar_samp/covar_pop/corr pairs
with DECIMAL128, integer and UINT64 partners, with the overflow flag.

Every result is compared byte for byte: the sums and means are integer
limb arithmetic, and var/covar round an exact limb numerator to float64
once and then take the reference's own float steps. The one exception
is corr, whose last float steps the reference's traced program
(``dispatch.call``) computes otherwise than op by op (one ulp seen):
corr is held to ``REL_CORR`` (4 ulps)."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu import types as jt
from spark_rapids_jni_tpu.columnar import Column as JColumn
from spark_rapids_jni_tpu.ops import cast_strings as jcs
from spark_rapids_jni_tpu.ops import groupby as jgroupby
from spark_rapids_jni_tpu.ops import reduce as jreduce
from spark_rapids_jni_tpu_torch import types as t
from spark_rapids_jni_tpu_torch.columnar import Column
from spark_rapids_jni_tpu_torch.ops import _decimal128 as d128
from spark_rapids_jni_tpu_torch.ops import cast_strings as pcs
from spark_rapids_jni_tpu_torch.ops import groupby, reduce
from torch_parity import (
    DEC128_EDGES,
    EDGE_ROWS,
    assert_same_array,
    assert_same_groups,
    both_fixed,
    dec128_limbs,
    jax_table,
    to_port,
)

REL_CORR = 4 * 2.0 ** -52
T = jt.TypeId


def wide_values(n: int, seed: int, bits: int = 100) -> np.ndarray:
    """int64[n, 2] limbs: the byte-image edge values, then seeded values
    of up to ``bits`` bits of either sign."""
    rng = np.random.default_rng(seed)
    vals = list(DEC128_EDGES[:n])
    while len(vals) < n:
        v = int(rng.integers(0, 2**62)) << int(rng.integers(0, bits - 61))
        vals.append(v if rng.random() < 0.5 else -v)
    return dec128_limbs(vals[:n])


def null_tail(n: int, seed: int) -> np.ndarray:
    valid = np.random.default_rng(seed).random(n) > 0.2
    valid[-max(1, n // 5):] = False
    return valid


@pytest.mark.parametrize("n", EDGE_ROWS)
def test_reductions_match_reference(n):
    # sums within 128 bits: 100-bit values; edge values only at n = 1
    data = wide_values(n, n, bits=100) if n > 1 else dec128_limbs([2**100])
    port, ref = both_fixed(data, T.DECIMAL128, -4, null_tail(n, n))
    for fn in ("sum_", "mean", "min_", "max_"):
        got, got_ok = getattr(reduce, fn)(port)
        want, want_ok = getattr(jreduce, fn)(ref)
        assert bool(got_ok) == bool(want_ok), fn
        if isinstance(want, JColumn):
            assert_same_array(got.data.numpy(), want.data, fn)
        else:
            assert_same_array(got.numpy(), want, fn)


def test_reduction_sum_past_128_bits_is_null():
    big = 2**127 - 1
    port, ref = both_fixed(dec128_limbs([big, big, 5]), T.DECIMAL128, 0)
    got, ok = reduce.sum_(port)
    want, want_ok = jreduce.sum_(ref)
    assert not bool(ok) and not bool(want_ok)
    assert_same_array(got.numpy(), want)
    got, ok = reduce.mean(port)
    assert not bool(ok)


def test_limb_helpers_match_reference():
    rng = np.random.default_rng(3)
    data = wide_values(2049, 3, bits=126)
    lo, hi = torch.from_numpy(data[:, 0]), torch.from_numpy(data[:, 1])
    jlo, jhi = jnp.asarray(data[:, 0]), jnp.asarray(data[:, 1])
    for got, want in zip(d128.split_sum128_lanes(lo, hi),
                         jgroupby.split_sum128_lanes(jlo, jhi)):
        assert_same_array(got.numpy(), want)
    sums = [torch.from_numpy(rng.integers(-2**45, 2**45, 64))
            for _ in range(4)]
    for got, want in zip(d128.recombine_sum128(*sums),
                         jgroupby.recombine_sum128(
                             *[jnp.asarray(s.numpy()) for s in sums])):
        assert_same_array(got.numpy(), want)
    # counts at the edges the long division meets, up to 2^31 - 1
    counts = np.array([0, 1, 2, 3, 7, 10_000, 2**31 - 1] * 293)[:2049]
    got, g_ovf = d128._mean128_exact(lo, hi, torch.from_numpy(counts))
    want, w_ovf = jgroupby._mean128_exact(jlo, jhi, jnp.asarray(counts))
    assert_same_array(got.numpy(), want)
    assert_same_array(g_ovf.numpy(), w_ovf)


def test_mean_counts_past_2_31_are_guarded():
    """Counts of 2^31 or more would overflow the int64 long division: the
    port nulls and flags them (the reference, in uint64, computes counts
    below 2^32); no group of an input below 2^31 rows has one."""
    lo = torch.tensor([10**18, -5, 0])
    hi = torch.tensor([3, -1, 0])
    counts = torch.tensor([2**31, 2**32 + 5, 2**31 - 1])
    _, ovf = d128._mean128_exact(lo, hi, counts)
    assert ovf.tolist() == [True, True, False]


def _wide_table(n, seed):
    rng = np.random.default_rng(seed)
    return [
        (int(T.INT8), 0, rng.integers(0, 4, n).astype(np.int8), None),
        (int(T.DECIMAL128), -3, wide_values(n, seed, bits=110),
         null_tail(n, seed)),
        (int(T.DECIMAL128), -2, wide_values(n, seed + 1, bits=90),
         null_tail(n, seed + 1)),
        (int(T.INT64), 0, rng.integers(-2**62, 2**62, n), null_tail(n, 7)),
        (int(T.UINT64), 0, rng.integers(0, 2**64 - 1, n, dtype=np.uint64),
         null_tail(n, 8)),
    ]


WIDE_AGGS = ([(1, op) for op in ("sum", "mean", "var", "std", "var_pop",
                                 "std_pop", "min", "max")]
             + [(1, ("covar_samp", 2)), (1, ("covar_pop", 3)),
                (2, ("covar_samp", 4)), (1, ("corr", 2)),
                (2, ("corr", 3)), (3, ("corr", 1))])


@pytest.mark.parametrize("n", [257, 2049])
def test_groupby_decimal128_matches_reference(n):
    host = _wide_table(n, n)
    jtab = jax_table(host)
    want = jgroupby.groupby_aggregate(jtab, [0], WIDE_AGGS)
    got = groupby.groupby_aggregate(to_port(jtab), [0], WIDE_AGGS)
    tol = {1 + i: REL_CORR for i, (_, op) in enumerate(WIDE_AGGS)
           if isinstance(op, tuple) and op[0] == "corr"}
    assert_same_groups(got, want, tol)
    assert bool(got.sum_overflow) == bool(want.sum_overflow)


def test_groupby_sum_and_mean_overflow_match_reference():
    """Group 1's sum passes 2^127 (null, flagged), group 2's sum fits but
    its mean's 10^4 widening does not, group 3 is fine."""
    big = 2**127 - 1
    keys = np.array([1, 1, 2, 2, 3], np.int64)
    vals = dec128_limbs([big, big, 2**126, 2**126 - 1 - 2**126, 7])
    host = [(int(T.INT64), 0, keys, None),
            (int(T.DECIMAL128), 0, vals, None)]
    jtab = jax_table(host)
    for op in ("sum", "mean"):
        want = jgroupby.groupby_aggregate(jtab, [0], [(1, op)])
        got = groupby.groupby_aggregate(to_port(jtab), [0], [(1, op)])
        assert_same_groups(got, want)
        assert bool(got.sum_overflow) and bool(want.sum_overflow)


def test_decimal_to_string_refuses_decimal128_as_the_reference():
    """Neither side renders DECIMAL128 (Spark's DECIMAL(38)): the
    reference fails inside its digit matrix (a broadcast ValueError), the
    port refuses up front with NotImplementedError."""
    vals = [5, -12345, None, 2**70]
    ref = JColumn.from_pylist(vals, jt.DType(T.DECIMAL128, -2))
    port = Column.from_pylist(vals, t.DType(t.TypeId.DECIMAL128, -2),
                              device="cpu")
    with pytest.raises(ValueError, match="Incompatible shapes"):
        jcs.decimal_to_string(ref)
    with pytest.raises(NotImplementedError, match="DECIMAL128"):
        pcs.decimal_to_string(port)
