"""What the port's kernels once refused, and the JAX package's last public
names, held to the JAX package on the CPU.

- The bounded groupby over a wide declared domain: ``plan_groupby_auto``
  grows its budget until the domain's slots fit, then lowers to the
  bounded plan, as the reference does; kernel A's launch plan splits a
  domain past one launch's shared memory into windows of groups
  (``launch_plan``, ``launches``) instead of refusing it.
- Rows wider than the row transpose's 128-row staging (1,632 and 16,256
  bytes) convert with no fallback, byte-equal to the reference's
  ``enforce_row_limit=False`` image.
- The general groupby's float sums: the segment-sum wrapper on the CPU is
  its plain ``index_add_``, with no launch counted.
- ``pack_validity``/``unpack_validity``, ``Table.from_pylists``,
  ``ResultCache.invalidate``, ``default_staging_pool`` and ``Q1Result``.

Integers and bytes compare exactly."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu import types as jt
from spark_rapids_jni_tpu.columnar import pack_validity as j_pack
from spark_rapids_jni_tpu.columnar import unpack_validity as j_unpack
from spark_rapids_jni_tpu.columnar import Table as JTable
from spark_rapids_jni_tpu.models import tpch as jtpch
from spark_rapids_jni_tpu.ops import planner as jplanner
from spark_rapids_jni_tpu.ops import row_conversion as jrc
from spark_rapids_jni_tpu.runtime import fusion as jfusion
from spark_rapids_jni_tpu.runtime import memory as jmemory
from spark_rapids_jni_tpu.runtime import resultcache as jresultcache
from spark_rapids_jni_tpu_torch import types as t
from spark_rapids_jni_tpu_torch.columnar import (
    Table,
    pack_validity,
    unpack_validity,
)
from spark_rapids_jni_tpu_torch.models import tpch
from spark_rapids_jni_tpu_torch.ops import kernels, planner
from spark_rapids_jni_tpu_torch.ops import row_conversion as rc
from spark_rapids_jni_tpu_torch.ops.groupby import GroupByResult, bounded_lanes
from spark_rapids_jni_tpu_torch.ops.kernels import groupby_accumulate as kga
from spark_rapids_jni_tpu_torch.ops.kernels import segment_sum as kss
from spark_rapids_jni_tpu_torch.runtime import fusion, memory, resultcache
from torch_parity import (
    assert_same_array,
    assert_same_table,
    jax_table,
    quick_reference_compiles,
    to_port,
)

T = jt.TypeId


# ---- the bounded plan over a wide declared domain ---------------------------


def test_plan_groupby_auto_turns_bounded_as_the_budget_grows():
    """A 300-key domain (301 slots) from a budget of 64: the general plan
    overflows at 64, 128 and 256 groups, then 512 slots hold the domain
    and the plan lowers to the bounded one, equal to the reference's."""
    n = 3000
    rng = np.random.default_rng(19)
    # keys 0..329: the 30 past the domain are domain misses, as are
    # the reference's
    host = [(int(T.INT64), 0, rng.integers(0, 330, n), rng.random(n) > 0.05),
            (int(T.INT64), 0, rng.integers(-10**6, 10**6, n),
             rng.random(n) > 0.1),
            (int(T.DECIMAL64), -2, rng.integers(1, 10**7, n), None)]
    jtab = jax_table(host)
    aggs = [(1, "sum"), (1, "count"), (2, "min"), (2, "max")]
    kernels.reset_counts()
    got = planner.plan_groupby_auto(to_port(jtab), [0], aggs,
                                    [planner.scalar_domain(range(300))],
                                    budget=64)
    with quick_reference_compiles():
        want = jplanner.plan_groupby_auto(
            jtab, [0], aggs, [jplanner.scalar_domain(range(300))], budget=64)
    assert got.lowered == want.lowered == "bounded"
    assert bool(got.domain_miss) and bool(want.domain_miss)
    assert kernels.fallbacks() == {}
    assert_same_table(got.table, want.table)
    assert_same_array(got.present.numpy(), want.present)


@pytest.mark.parametrize("num_lanes", [1, 8, 9, 64])
def test_accumulate_splits_a_wide_domain_into_windows(num_lanes):
    """m = 100,001 slots (SF10's supplier keys and the null slot): no
    reason to refuse; windows of near-equal width tile [0, m), each
    within one launch's shared memory, and ``launches`` counts a launch
    a window and group of lanes. Of the splits, the windows chosen read
    the fewest bytes a row."""
    m = 100_001
    lanes = [kga.Lane("sum", torch.zeros(4, dtype=torch.int64), None, 0)
             ] * num_lanes
    assert kga.unsupported_reason(lanes, m) is None
    windows, per = kga.launch_plan(m, num_lanes)
    assert windows[0][0] == 0 and sum(w for _, w in windows) == m
    assert all(a + w == b for (a, w), (b, _) in zip(windows, windows[1:]))
    assert max(w for _, w in windows) - min(w for _, w in windows) <= 1
    assert all(kga.lanes_per_launch(w) >= per >= 1 for _, w in windows)
    assert kga.launches(m, num_lanes) == len(windows) * -(-num_lanes // per)

    def cost(count, p):
        return count * (4 * -(-num_lanes // p) + 8 * num_lanes)

    for p in range(1, min(num_lanes, 64) + 1):
        fewest = -(-m // kga._widest(p))
        assert kga.lanes_per_launch(kga._widest(p)) >= p
        assert cost(len(windows), per) <= cost(fewest, p)
    # with one lane a launch, windows = ceil(m / widest) = 5
    assert len(windows) == 5


@pytest.mark.parametrize("m,num_lanes,want", [
    (3, 5, 1), (6, 3, 1), (12, 13, 1), (26, 3, 1), (1_032, 16, 1),
    (1_032, 40, 2), (23_236, 1, 1), (23_300, 1, 2), (40_000, 2, 4)])
def test_accumulate_launch_counts(m, num_lanes, want):
    """Domains one launch holds keep one window and their lane split
    (planned q12, q4, q1, q5, the monthly rollup); wider ones split."""
    assert kga.launches(m, num_lanes) == want
    windows, _ = kga.launch_plan(m, num_lanes)
    assert (len(windows) == 1) == (kga.lanes_per_launch(m) >= 1)


def test_bounded_groupby_past_one_launch_counts_no_fallback():
    """40,000 slots on the CPU: the plain version, no fallback counted
    (the kernel takes the domain in windows on the card)."""
    n = 500
    rng = np.random.default_rng(7)
    tab = Table.from_pylists([
        (rng.integers(0, 40_000, n).tolist(), t.INT32),
        (rng.integers(-99, 99, n).tolist(), t.INT64)], device="cpu")
    aggs = [(1, "sum"), (1, "count"), (1, "max")]
    kernels.reset_counts()
    res = planner.plan_groupby(tab, [0], aggs,
                               [planner.scalar_domain(range(39_999))],
                               budget=1 << 16)
    assert res.lowered == "bounded"
    assert kernels.fallbacks() == {} and kernels.launches() == {}
    assert kga.unsupported_reason(bounded_lanes(tab, aggs).lanes,
                                  res.table.num_rows) is None
    keys = tab.column(0).data.numpy()
    vals = tab.column(1).data.numpy()
    present = res.present.numpy()
    for k in np.unique(keys)[:20]:
        slot = int(k)  # domain 0..39,998 in order; 39,999 misses
        if k >= 39_999:
            continue
        assert present[slot]
        assert int(res.table.column(1).data[slot]) == int(vals[keys == k].sum())
        assert int(res.table.column(2).data[slot]) == int((keys == k).sum())


# ---- rows of any width ------------------------------------------------------


@pytest.mark.parametrize("ncols,n", [(200, 40), (2000, 9)])
def test_wide_rows_match_reference(ncols, n):
    """200 INT64 columns (1,632-byte rows) and 2,000 (16,256-byte rows),
    10 % nulls: the row image equals the reference's (its
    ``enforce_row_limit=False`` body, ``_to_rows_impl``, run eagerly: its
    jitted form compiles a 2,000-column program for ~40 s), with no
    fallback counted, and the round trip is exact."""
    rng = np.random.default_rng(ncols)
    host = [(int(T.INT64), 0, rng.integers(-2**62, 2**62, n),
             rng.random(n) > 0.1) for _ in range(ncols)]
    jtab = jax_table(host)
    ptab = to_port(jtab)
    kernels.reset_counts()
    got = rc.convert_to_rows(ptab, enforce_row_limit=False)
    assert kernels.fallbacks() == {} and kernels.launches() == {}
    want = np.asarray(jrc._to_rows_impl(
        [c.data for c in jtab.columns], [c.valid_mask() for c in jtab.columns],
        tuple(jtab.schema())))
    assert [b.row_size for b in got] == [want.shape[1]]
    assert got[0].data.numpy().tobytes() == want.tobytes()
    back = rc.convert_from_rows(got[0], ptab.schema())
    for a, b in zip(back.columns, ptab.columns):
        assert torch.equal(a.valid_mask(), b.valid_mask())
        assert torch.equal(a.data[a.valid_mask()], b.data[b.valid_mask()])


# ---- the general groupby's float sums ---------------------------------------


def test_segment_sum_runs_its_plain_version_on_the_cpu():
    """On CPU tensors the wrapper is ``index_add_`` into m + 1 slots (rows
    of groups past m dropped), and counts no launch; the registry names
    the plain version as the kernel's oracle."""
    rng = np.random.default_rng(3)
    gid = torch.from_numpy(np.sort(rng.integers(0, 7, 200)))
    vals = torch.from_numpy(rng.standard_normal(200))
    m = 5
    lo = torch.searchsorted(gid, torch.arange(m))
    hi = torch.searchsorted(gid, torch.arange(m), right=True)
    kernels.reset_counts()
    got = kss.segment_sum(vals, gid, lo, hi)
    assert kernels.launches() == {}
    want = torch.zeros(m + 1, dtype=torch.float64).index_add_(
        0, gid.clamp(max=m), vals)[:m]
    assert torch.equal(got, want)
    for g in range(m):
        exact = float(vals[gid == g].sum())
        assert abs(float(got[g]) - exact) <= float(
            kss.sum_bound(vals, gid, m)[g]) + 1e-15
    spec = kernels.registered()[kss.NAME]
    assert spec.oracle.endswith("segment_sum.segment_sum_plain")
    assert spec.source == "csrc/segment_sum.cu"


# ---- the reference's last public names --------------------------------------


@pytest.mark.parametrize("n", [1, 256, 2049])
def test_pack_and_unpack_validity_match_reference(n):
    valid = np.random.default_rng(n).random(n) > 0.4
    got = pack_validity(torch.from_numpy(valid))
    want = j_pack(jnp.asarray(valid))
    assert_same_array(got.numpy(), want)
    assert_same_array(unpack_validity(got, n).numpy(),
                      j_unpack(want, n))


def test_table_from_pylists_matches_reference():
    cols = [([1, None, 3, -7], "INT32"), ([None, 2**40, -1, 0], "INT64"),
            ([1.5, None, float("inf"), -0.0], "FLOAT64"),
            ([True, False, None, True], "BOOL8")]
    got = Table.from_pylists(
        [(v, t.DType(getattr(t.TypeId, k))) for v, k in cols], device="cpu")
    want = JTable.from_pylists(
        [(v, jt.DType(getattr(jt.TypeId, k))) for v, k in cols])
    assert_same_table(got, want)


def _cached(mod, store_mod, fusion_mod, table, total):
    limiter = store_mod.MemoryLimiter(1 << 24)
    cache = mod.ResultCache(store_mod.SpillStore(1 << 24), limiter,
                            max_bytes=1 << 22)
    key = mod.CacheKey("sig", "fp")
    assert cache.put(key, fusion_mod.FusedResult(table, {"x.total": total}))
    return cache, key, limiter


def test_result_cache_invalidate_matches_reference():
    host = [(int(T.INT64), 0, np.arange(64), None)]
    outcomes = []
    for mod, store_mod, fusion_mod, table, total in (
            (resultcache, memory, fusion, to_port(jax_table(host)),
             torch.tensor(64)),
            (jresultcache, jmemory, jfusion, jax_table(host),
             jnp.asarray(64))):
        cache, key, limiter = _cached(mod, store_mod, fusion_mod, table,
                                      total)
        used = limiter.used
        outcomes.append((used > 0, cache.invalidate(key), cache.get(key),
                         cache.invalidate(key), limiter.used,
                         cache.stats()["entries"]))
    assert outcomes[0] == outcomes[1] == (True, True, None, False, 0, 0)


def test_default_staging_pool_and_q1_result():
    pool = memory.default_staging_pool()
    assert pool is memory.default_staging_pool()
    assert isinstance(pool, memory.HostStagingPool)
    assert isinstance(jmemory.default_staging_pool(), jmemory.HostStagingPool)
    buf = pool.take(100)
    assert buf.dtype == torch.uint8 and buf.numel() == 128
    pool.give(buf)
    assert pool.take(90) is buf
    assert tpch.Q1Result._fields == jtpch.Q1Result._fields == ("result",)
    li = Table.from_pylists([([1, 2], t.INT32)], device="cpu")
    res = tpch.Q1Result(GroupByResult(li, torch.tensor(2)))
    assert res.result.table is li
