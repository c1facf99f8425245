"""The port's TPC-H q1 against the JAX package: the lineitem generator,
the filter/derive work table, the planned q1 (all 12 slots with
``present`` and ``domain_miss``), the fused q1 (against the reference
Pallas kernel in interpret mode and against the planned q1) and the
numpy oracle. Exact."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu.models import tpch as jtpch
from spark_rapids_jni_tpu.ops.pallas import q1 as jq1
from spark_rapids_jni_tpu_torch.columnar import Column, Table
from spark_rapids_jni_tpu_torch.models import tpch
from spark_rapids_jni_tpu_torch.ops import kernels
from spark_rapids_jni_tpu_torch.ops.kernels import q1 as kq1
from torch_parity import (
    assert_same_array,
    assert_same_table,
    host_columns,
    jax_table,
    to_port,
)

Q1_ROWS = [1, 2047, 2048, 2049, 10000]


def _lineitems(n, seed=0):
    return tpch.lineitem_table(n, seed=seed, device="cpu"), \
        jtpch.lineitem_table(n, seed=seed)


def _head(jtab, rows):
    """The first ``rows`` rows of a JAX table, as a JAX table."""
    return jax_table([(tid, s, d[:rows], None if v is None else v[:rows])
                      for tid, s, d, v in host_columns(jtab)])


@pytest.mark.parametrize("seed", [0, 1, 42])
def test_lineitem_generator_matches_reference(seed):
    port, ref = _lineitems(1000, seed)
    assert_same_table(port, ref)
    assert port.schema() == tpch.LINEITEM_SCHEMA


@pytest.mark.parametrize("n", Q1_ROWS)
def test_work_table_matches_reference(n):
    port, ref = _lineitems(n, seed=n)
    assert_same_table(tpch._q1_work_table(port), jtpch._q1_work_table(ref))


@pytest.mark.parametrize("n", Q1_ROWS)
def test_planned_q1_matches_reference(n):
    port, ref = _lineitems(n, seed=n)
    got = tpch.tpch_q1_planned_result(port)
    want = jtpch.tpch_q1_planned_result(ref)
    assert got.lowered == want.lowered == "bounded"
    assert got.table.num_rows == 12
    assert_same_table(got.table, want.table)
    assert_same_array(got.present.numpy(), want.present)
    assert_same_array(got.domain_miss.numpy(), want.domain_miss)
    assert_same_table(tpch.tpch_q1_planned(port), want.table)


@pytest.mark.parametrize("n", [1, 2047, 2048, 10000])
def test_fused_q1_matches_reference_planned(n):
    port, ref = _lineitems(n, seed=n)
    got = kq1.tpch_q1_pallas(port)
    assert_same_table(got, _head(jtpch.tpch_q1_planned(ref), 6))
    assert_same_table(got, _head(tpch.tpch_q1_planned(port), 6))


def test_fused_q1_matches_pallas_interpret():
    port, ref = _lineitems(2049, seed=5)
    kernels.reset_counts()
    got = kq1.tpch_q1_pallas(port)
    assert kernels.launches() == {} and kernels.fallbacks() == {}
    assert_same_table(got, jq1.tpch_q1_pallas(ref, interpret=True))


def test_q1_with_nulls_and_domain_miss_matches_reference():
    n = 3000
    rng = np.random.default_rng(11)
    host = host_columns(jtpch.lineitem_table(n, seed=11))
    rf = host[tpch.L_RETURNFLAG][2].copy()
    rf[rng.random(n) < 0.02] = ord("X")  # outside the DDL domain
    host[tpch.L_RETURNFLAG] = (*host[tpch.L_RETURNFLAG][:2], rf, None)
    for col in (tpch.L_QUANTITY, tpch.L_SHIPDATE, tpch.L_RETURNFLAG):
        tid, scale, data, _ = host[col]
        host[col] = (tid, scale, data, rng.random(n) > 0.1)
    ref = jax_table(host)
    got = tpch.tpch_q1_planned_result(to_port(ref))
    want = jtpch.tpch_q1_planned_result(ref)
    assert bool(got.domain_miss) and bool(want.domain_miss)
    assert_same_table(got.table, want.table)
    assert_same_array(got.present.numpy(), want.present)


def test_fused_q1_rejects_nullable_inputs():
    port, _ = _lineitems(64)
    cols = list(port.columns)
    cols[tpch.L_TAX] = Column(cols[tpch.L_TAX].dtype, cols[tpch.L_TAX].data,
                              torch.ones(64, dtype=torch.bool))
    with pytest.raises(NotImplementedError, match="non-nullable"):
        kq1.tpch_q1_pallas(Table(cols))


def test_fused_q1_empty_input_falls_back():
    port, _ = _lineitems(0)
    kernels.reset_counts()
    got = kq1.tpch_q1_pallas(port)
    # an empty input is no fallback: the fused q1 takes n == 0
    assert kernels.launches() == {} and kernels.fallbacks() == {}
    assert not bool(got.column(0).validity.any())


def test_fused_q1_outputs_own_their_keys():
    # the group keys are cloned per call from one copy per device: two
    # outputs share no storage, so writing one leaves the other as it was
    port, _ = _lineitems(500, seed=4)
    a, b = kq1.tpch_q1_pallas(port), kq1.tpch_q1_pallas(port)
    for k in (0, 1):
        ka, kb = a.column(k).data, b.column(k).data
        assert ka.untyped_storage().data_ptr() != \
            kb.untyped_storage().data_ptr()
        before = kb.clone()
        ka.fill_(0)
        assert torch.equal(kb, before)
    assert kq1.tpch_q1_pallas(port).equals(b)


def test_q1_partials_slots():
    port, _ = _lineitems(4000, seed=2)
    cols = [port.column(i).data.clone() for i in kq1._COLUMNS]
    cols[4][:100] = ord("X")
    agg = kq1.q1_partials(*cols)
    ship, rf = cols[6], cols[4]
    assert int(agg[:, 0].sum()) == 4000
    assert int(agg[6, 0]) == int((ship > tpch._Q1_CUTOFF_DAYS).sum())
    assert int(agg[7, 0]) == int(((ship <= tpch._Q1_CUTOFF_DAYS)
                                  & (rf == ord("X"))).sum())


@pytest.mark.parametrize("n", [1, 2049, 10000])
def test_numpy_oracle_matches_reference(n):
    port, ref = _lineitems(n, seed=n + 3)
    assert tpch.tpch_q1_numpy(port) == jtpch.tpch_q1_numpy(ref)
