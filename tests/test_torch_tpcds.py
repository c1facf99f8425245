"""The port's TPC-DS family (q72, q64, q3; general and planned) and the
dense-id reductions against the JAX package: the seven generators,
``dense_id_counts`` / ``dense_id_sums`` (ids out of range both ways, an
int64 id past 2^31, no rows, wrapping sums), ``tpcds_q72``,
``tpcds_q72_planned``, ``tpcds_q64``, ``tpcds_q64_planned`` and
``tpcds_q3`` (their tables, ``num_groups``, ``join_total``, ``out_size``,
``pk_violation``, ``brand_domain_miss``), and the vectorized numpy
oracles against the reference's loop oracles. Exact. The reference runs
the general plans fused over bucket-padded inputs, so the bytes under a
null in their outputs come from its padding rows and are not compared."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu.models import tpcds as jtpcds
from spark_rapids_jni_tpu.ops import planner as jplanner
from spark_rapids_jni_tpu_torch.models import tpcds
from spark_rapids_jni_tpu_torch.ops import kernels, planner
from torch_parity import (
    assert_same_array,
    assert_same_table,
    assert_same_valid_table,
)

# fact rows and item count: one mid size, then the edge fact counts over
# small dimension tables
Q72_SIZES = [(4000, 150)] + [(n, 30) for n in (1, 255, 257, 2048, 2049)]
Q64_SIZES = [(6000, 60, 300)] + [(n, 12, 20)
                                  for n in (1, 255, 257, 2048, 2049)]
Q3_SIZES = [(20000, 300), (257, 40), (2049, 40)]


def _pair(name, *args, **kw):
    """One generator of both packages on the same arguments."""
    return (getattr(tpcds, name)(*args, device="cpu", **kw),
            getattr(jtpcds, name)(*args, **kw))


def _q72_tables(n, items, seed=1):
    tables = [_pair("catalog_sales_table", n, num_items=items, seed=seed),
              _pair("date_dim_table"),
              _pair("item_table", items),
              _pair("inventory_table", num_items=items)]
    return tuple(p for p, _ in tables), tuple(r for _, r in tables)


def _q3_tables(n, items, seed=5):
    tables = [_pair("date_dim_table"), _pair("store_sales_q3_table", n,
                                             num_items=items, seed=seed),
              _pair("item_q3_table", items)]
    return tuple(p for p, _ in tables), tuple(r for _, r in tables)


@pytest.mark.parametrize("seed", [0, 7])
def test_generators_match_reference(seed):
    pairs = [
        _pair("date_dim_table", 400, 1998),
        _pair("item_table", 50, seed),
        _pair("catalog_sales_table", 1000, 50, 400, seed),
        _pair("inventory_table", 50, 9, seed),
        _pair("store_sales_table", 1000, 50, 70, 400, seed),
        _pair("item_q3_table", 50, seed),
        _pair("store_sales_q3_table", 1000, 50, 400, seed),
    ]
    for port, ref in pairs:
        assert_same_table(port, ref)


def _dense_ids_case(case):
    rng = np.random.default_rng(len(case))
    m = 37
    if case == "empty":
        return np.zeros(0, np.int32), np.zeros(0, np.int64), m
    gid = rng.integers(-5, m + 5, 3001).astype(np.int32)  # < 0 and >= m
    vals = rng.integers(-10**6, 10**6, 3001)
    if case == "wide_ids":
        # int64 ids past 2^31 whose low 32 bits land inside [0, m)
        gid = gid.astype(np.int64)
        gid[::7] = (1 << 32) + 3
        gid[1::11] = (1 << 31) + 1
    elif case == "wrapping":
        vals = rng.integers(2**62, 2**63 - 1, 3001, dtype=np.int64)
    elif case == "one_slot":
        m = 1
    return gid, vals, m


@pytest.mark.parametrize("case", ["mixed", "wide_ids", "wrapping",
                                  "one_slot", "empty"])
def test_dense_id_reductions_match_reference(case):
    gid, vals, m = _dense_ids_case(case)
    got = planner.dense_id_counts(torch.from_numpy(gid), m)
    assert_same_array(got.numpy(), np.asarray(
        jplanner.dense_id_counts(jnp.asarray(gid), m)), "counts")
    got = planner.dense_id_sums(torch.from_numpy(gid),
                                torch.from_numpy(vals), m)
    want = np.asarray(jplanner.dense_id_sums(jnp.asarray(gid),
                                             jnp.asarray(vals), m))
    assert_same_array(got.numpy(), want, "sums")
    # and against numpy's own wrapping int64 sum per slot
    ok = (gid >= 0) & (gid < m)
    slot_sum = np.zeros(m, np.int64)
    np.add.at(slot_sum, gid[ok], vals[ok])
    assert_same_array(got.numpy(), slot_sum, "numpy sums")


@pytest.fixture(scope="module", params=Q72_SIZES,
                ids=lambda s: "x".join(map(str, s)))
def q72_runs(request):
    """Both packages' q72 plans on one set of tables, computed once."""
    port, ref = _q72_tables(*request.param)
    kernels.reset_counts()
    got, planned = tpcds.tpcds_q72(*port), tpcds.tpcds_q72_planned(*port)
    launches = kernels.launches()
    return dict(port=port, ref=ref, got=got, planned=planned,
                want=jtpcds.tpcds_q72(*ref),
                want_planned=jtpcds.tpcds_q72_planned(*ref),
                launches=launches)


def test_q72_matches_reference(q72_runs):
    got, want = q72_runs["got"], q72_runs["want"]
    assert int(got.num_groups) == int(want.num_groups)
    assert_same_valid_table(got.table, want.table)
    # the CPU path runs kernel D's plain version: no launch counted
    assert q72_runs["launches"] == {}


def test_q72_planned_matches_reference(q72_runs):
    got, want = q72_runs["planned"], q72_runs["want_planned"]
    assert bool(got.pk_violation) == bool(want.pk_violation) is False
    assert_same_array(got.present.numpy(), np.asarray(want.present))
    assert_same_valid_table(got.table, want.table)
    # the planned plan's real groups are the general plan's, in order
    k = int(got.present.sum())
    general = q72_runs["got"].compact()
    for a, b in zip(got.table.columns, general.columns):
        assert torch.equal(a.data[:k], b.data[:k])


def test_q72_oracles_agree(q72_runs):
    port, ref = q72_runs["port"], q72_runs["ref"]
    want = jtpcds.tpcds_q72_numpy(*ref)
    assert tpcds.tpcds_q72_numpy(*port) == want
    o = tpcds.tpcds_q72_oracle(*port)
    assert {(int(i), int(b)): int(c) for i, b, c in zip(
        o["item_sk"], o["brand_id"], o["count"])} == want
    # the oracle's order is the query's: count desc, item asc
    res = q72_runs["got"].compact()
    k = len(o["item_sk"])
    for col, name in enumerate(("item_sk", "brand_id", "count")):
        np.testing.assert_array_equal(res.column(col).data[:k].numpy(),
                                      o[name])


def test_q72_other_year_and_capacity():
    port, ref = _q72_tables(3000, 80, seed=4)
    got = tpcds.tpcds_q72(*port, year=2001, out_factor=1)
    want = jtpcds.tpcds_q72(*ref, year=2001, out_factor=1)
    assert int(got.num_groups) == int(want.num_groups)
    assert_same_valid_table(got.table, want.table)
    assert tpcds.tpcds_q72_numpy(*port, year=2001) \
        == jtpcds.tpcds_q72_numpy(*ref, year=2001)


def test_q72_probe_inputs_are_the_joins_builds():
    port, _ = _q72_tables(2049, 30)
    joins = tpcds.q72_probe_inputs(*port)
    # join 1: the 730-day dimension, one year of it valid
    assert [b.shape[0] for b, _, _ in joins] == [730, 30, 30 * 105]
    assert [int(v) for _, v, _ in joins] == [365, 30, 30 * 105]
    assert [p.shape[0] for _, _, p in joins] == [2049] * 3
    for build, n_valid, _ in joins:
        s = int(n_valid)
        assert bool((build[1:s] >= build[:s - 1]).all())
        assert bool((build[s:] == torch.iinfo(build.dtype).max).all())


@pytest.fixture(scope="module", params=Q64_SIZES,
                ids=lambda s: "x".join(map(str, s)))
def q64_runs(request):
    n, items, customers = request.param
    port, ref = _pair("store_sales_table", n, num_items=items,
                      num_customers=customers)
    kernels.reset_counts()
    got, planned = tpcds.tpcds_q64(port), tpcds.tpcds_q64_planned(port)
    launches = kernels.launches()
    return dict(port=port, ref=ref, got=got, planned=planned,
                want=jtpcds.tpcds_q64(ref),
                want_planned=jtpcds.tpcds_q64_planned(ref),
                launches=launches)


def test_q64_matches_reference(q64_runs):
    got, want = q64_runs["got"], q64_runs["want"]
    assert int(got.join_total) == int(want.join_total)
    assert got.out_size == want.out_size
    assert int(got.join_total) <= got.out_size
    assert int(got.result.num_groups) == int(want.result.num_groups)
    assert_same_valid_table(got.result.table, want.result.table)
    assert q64_runs["launches"] == {}


def test_q64_planned_matches_reference(q64_runs):
    got, want = q64_runs["planned"], q64_runs["want_planned"]
    assert int(got.join_total) == int(want.join_total)
    assert int(got.join_total) == int(q64_runs["got"].join_total)
    assert int(got.result.num_groups) == int(want.result.num_groups)
    assert_same_valid_table(got.result.table, want.result.table)


def test_q64_oracles_agree(q64_runs):
    port, ref = q64_runs["port"], q64_runs["ref"]
    want = jtpcds.tpcds_q64_numpy(ref)
    assert tpcds.tpcds_q64_numpy(port) == want
    o = tpcds.tpcds_q64_oracle(port)
    assert dict(zip(o["item_sk"].tolist(), o["count"].tolist())) == want
    res = q64_runs["got"].result.compact()
    k = len(o["item_sk"])
    for col, name in enumerate(("item_sk", "count")):
        np.testing.assert_array_equal(res.column(col).data[:k].numpy(),
                                      o[name])


def test_q64_truncation_is_detectable():
    # three items and five customers: pairs repeat, the join overflows
    port, ref = _pair("store_sales_table", 2000, num_items=3,
                      num_customers=5)
    got = tpcds.tpcds_q64(port, out_factor=1)
    want = jtpcds.tpcds_q64(ref, out_factor=1)
    assert int(got.join_total) == int(want.join_total) > got.out_size
    assert int(got.result.num_groups) == int(want.result.num_groups)
    assert_same_valid_table(got.result.table, want.result.table)


def test_q64_probe_inputs_are_the_self_join_build():
    port, _ = _pair("store_sales_table", 2049, num_items=12,
                    num_customers=20)
    build, n_valid, probe = tpcds.q64_probe_inputs(port)
    s = int(n_valid)
    assert build.shape[0] == probe.shape[0] == 2049
    assert 0 < s < 2049  # one year's rows valid, the rest the sentinel
    assert bool((build[1:s] >= build[:s - 1]).all())
    assert int(build[:s].unique().numel()) < s  # duplicate pairs
    assert bool((build[s:] == torch.iinfo(build.dtype).max).all())


@pytest.mark.parametrize("size", Q3_SIZES, ids=lambda s: "x".join(map(str, s)))
def test_q3_matches_reference(size):
    port, ref = _q3_tables(*size)
    kernels.reset_counts()
    got = tpcds.tpcds_q3(*port)
    assert kernels.launches() == {}
    want = jtpcds.tpcds_q3(*ref)
    assert bool(got.pk_violation) == bool(want.pk_violation) is False
    assert bool(got.brand_domain_miss) == bool(want.brand_domain_miss)
    assert_same_array(got.present.numpy(), np.asarray(want.present))
    assert_same_table(got.table, want.table)
    assert got.table.column(0).dtype == got.table.column(1).dtype
    wantd = jtpcds.tpcds_q3_numpy(*ref)
    assert tpcds.tpcds_q3_numpy(*port) == wantd
    o = tpcds.tpcds_q3_oracle(*port)
    assert {(int(y), int(b)): int(r) for y, b, r in zip(
        o["year"], o["brand_id"], o["revenue"])} == wantd
    k = len(o["year"])
    for col, name in enumerate(("year", "brand_id", "revenue")):
        np.testing.assert_array_equal(got.table.column(col).data[:k].numpy(),
                                      o[name])


def test_q3_brand_domain_miss():
    # a declared brand domain smaller than the data's: flagged, as in the
    # reference, and the out-of-domain revenue is not in the table
    port, ref = _q3_tables(5000, 60)
    got = tpcds.tpcds_q3(*port, manufact_id=3, num_brands=40)
    want = jtpcds.tpcds_q3(*ref, manufact_id=3, num_brands=40)
    assert bool(got.brand_domain_miss) == bool(want.brand_domain_miss)
    assert bool(got.brand_domain_miss)
    assert_same_table(got.table, want.table)
