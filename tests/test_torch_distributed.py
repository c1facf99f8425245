"""The port's distributed TPC-H and TPC-DS plans against the JAX
package's on the CPU, and against the port's numpy oracles: q1, q3 and
planned q3, q5, q12; TPC-DS q72, planned q72 and q64. The reference runs
on ``executor_mesh(4)`` over the conftest's virtual CPU devices, the
port on a mesh of 4 executors on ``cpu``, over the same generated tables
(a few hundred fact rows, not a multiple of 4, so the last executor holds
padding rows). Every comparison is exact."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import torch_parity as tp
from spark_rapids_jni_tpu.models import tpcds as jds
from spark_rapids_jni_tpu.models import tpch as jtpch
from spark_rapids_jni_tpu.parallel.mesh import executor_mesh as jexecutor_mesh
from spark_rapids_jni_tpu_torch.models import tpcds, tpch
from spark_rapids_jni_tpu_torch.parallel.mesh import executor_mesh

D = 4
FACT_ROWS = 403


@pytest.fixture(scope="module", autouse=True)
def _quick_reference_compiles():
    with tp.quick_reference_compiles():
        yield


@pytest.fixture(scope="module")
def jmesh():
    return jexecutor_mesh(D)


@pytest.fixture(scope="module")
def pmesh():
    return executor_mesh(D, ["cpu"] * D)


def _port(*jtables):
    return [tp.to_port(x) for x in jtables]


def _rows_of(table, k=None) -> list:
    cols = [c.data[:k].tolist() for c in table.columns]
    return list(zip(*cols))


def test_q1_distributed(jmesh, pmesh):
    li = jtpch.lineitem_table(FACT_ROWS, seed=3)
    (pli,) = _port(li)
    got = tpch.tpch_q1_distributed(pli, pmesh)
    tp.assert_same_valid_table(got, jtpch.tpch_q1_distributed(li, jmesh))
    want = tpch.tpch_q1_numpy(pli)
    # the real groups sort first; null-key rows are the executors'
    # phantom groups (the reference's too)
    k = int((got.column(0).valid_mask() & got.column(1).valid_mask()).sum())
    assert k == len(want)
    for row in _rows_of(got, k):
        w = want[(row[0], row[1])]
        assert list(row[2:6]) == [w["sum_qty"], w["sum_base_price"],
                                  w["sum_disc_price"], w["sum_charge"]]
        assert row[9] == w["count"]


@pytest.fixture(scope="module")
def q3_tables():
    c = jtpch.customer_table(30)
    o = jtpch.orders_table(200, 30)
    li = jtpch.lineitem_q3_table(FACT_ROWS, 200)
    return (c, o, li), _port(c, o, li)


def _same_as_q3_oracle(got, port_tables):
    want = tpch.tpch_q3_oracle(*port_tables)
    assert got.num_rows == len(want["orderkey"])
    for col, name in enumerate(("orderkey", "orderdate", "shippriority",
                                "revenue")):
        c = got.column(col)
        assert bool(c.valid_mask().all())
        assert c.data.tolist() == want[name].tolist(), name


def test_q3_distributed(jmesh, pmesh, q3_tables):
    jtables, ptables = q3_tables
    got = tpch.tpch_q3_distributed(*ptables, pmesh)
    tp.assert_same_valid_table(got, jtpch.tpch_q3_distributed(*jtables,
                                                               jmesh))
    _same_as_q3_oracle(got, ptables)


def test_q3_planned_distributed(jmesh, pmesh, q3_tables):
    jtables, ptables = q3_tables
    got = tpch.tpch_q3_planned_distributed(*ptables, pmesh)
    tp.assert_same_valid_table(
        got, jtpch.tpch_q3_planned_distributed(*jtables, jmesh))
    _same_as_q3_oracle(got, ptables)


def test_q5_distributed(jmesh, pmesh):
    jtables = (jtpch.customer_q5_table(60), jtpch.orders_table(300, 60),
               jtpch.lineitem_q5_table(FACT_ROWS, 300, 10),
               jtpch.supplier_table(10), jtpch.nation_table())
    ptables = _port(*jtables)
    got = tpch.tpch_q5_distributed(*ptables, pmesh)
    want = jtpch.tpch_q5_distributed(*jtables, jmesh)
    tp.assert_same_valid_table(got.table, want.table)
    tp.assert_same_array(got.present.numpy(), np.asarray(want.present))
    assert not bool(got.pk_violation) and not bool(got.domain_miss)
    single = tpch.tpch_q5(*ptables)
    assert torch.equal(got.present, single.present)
    k = int(got.present.sum())
    assert _rows_of(got.table, k) == _rows_of(single.table, k)
    oracle = tpch.tpch_q5_oracle(*ptables)
    assert {r[0]: r[1] for r in _rows_of(got.table, k)} == oracle


def test_q12_distributed(jmesh, pmesh):
    o = jtpch.orders_q12_table(300)
    li = jtpch.lineitem_q12_table(FACT_ROWS, 300)
    po, pli = _port(o, li)
    got = tpch.tpch_q12_distributed(po, pli, pmesh)
    tp.assert_same_valid_table(got, jtpch.tpch_q12_distributed(o, li,
                                                               jmesh))
    names = [bytes(got.column(0).chars[i, :int(got.column(0).data[i])]
                   .tolist()).decode() for i in range(got.num_rows)]
    want = tpch.tpch_q12_oracle(po, pli)
    assert names == sorted(want)
    assert {n: [int(got.column(1).data[i]), int(got.column(2).data[i])]
            for i, n in enumerate(names)} == want


@pytest.fixture(scope="module")
def q72_tables():
    jtables = (jds.catalog_sales_table(FACT_ROWS, 20), jds.date_dim_table(),
               jds.item_table(20), jds.inventory_table(20))
    return jtables, _port(*jtables)


def test_q72_distributed(jmesh, pmesh, q72_tables):
    jtables, ptables = q72_tables
    got = tpcds.tpcds_q72_distributed(*ptables, pmesh)
    tp.assert_same_valid_table(got, jds.tpcds_q72_distributed(*jtables,
                                                              jmesh))
    want = tpcds.tpcds_q72_oracle(*ptables)
    assert [c.data.tolist() for c in got.columns] == [
        want["item_sk"].tolist(), want["brand_id"].tolist(),
        want["count"].tolist()]
    with pytest.raises(ValueError, match="group_budget"):
        tpcds.tpcds_q72_distributed(*ptables, pmesh, group_budget=1)


def test_q72_planned_distributed(jmesh, pmesh, q72_tables):
    jtables, ptables = q72_tables
    got = tpcds.tpcds_q72_planned_distributed(*ptables, pmesh)
    want = jds.tpcds_q72_planned_distributed(*jtables, jmesh)
    tp.assert_same_valid_table(got.table, want.table)
    tp.assert_same_array(got.present.numpy(), np.asarray(want.present))
    assert not bool(got.pk_violation)
    single = tpcds.tpcds_q72_planned(*ptables)
    assert torch.equal(got.present, single.present)
    assert got.table.equals(single.table)


def test_q64_distributed(jmesh, pmesh):
    ss = jds.store_sales_table(FACT_ROWS, 20, 30)
    (pss,) = _port(ss)
    got = tpcds.tpcds_q64_distributed(pss, pmesh)
    tp.assert_same_valid_table(got, jds.tpcds_q64_distributed(ss, jmesh))
    want = tpcds.tpcds_q64_oracle(pss)
    assert [c.data.tolist() for c in got.columns] == [
        want["item_sk"].tolist(), want["count"].tolist()]
