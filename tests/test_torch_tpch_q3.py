"""The port's TPC-H q3 (general and planned) and general q1 against the
JAX package: the three q3 generators, ``tpch_q3`` and
``tpch_q3_planned`` (``num_groups``, ``join_total``, ``out_cap``,
``pk_violation`` and the compacted tables), the vectorized numpy oracle
against the reference's loop oracle, and ``tpch_q1`` /
``tpch_q1_checked`` / ``tpch_q1_planned_checked``. Exact: types,
validity and every valid value. The reference runs these plans fused
over bucket-padded inputs, so the bytes under a null (the null-key
group's key, the absent groups) come from its padding rows and are not
compared."""

from __future__ import annotations

import numpy as np
import pytest

from spark_rapids_jni_tpu.models import tpch as jtpch
from spark_rapids_jni_tpu_torch.models import tpch
from spark_rapids_jni_tpu_torch.ops import kernels
from spark_rapids_jni_tpu_torch.ops.kernels import hash_probe as khp
from torch_parity import (
    assert_same_table,
    assert_same_valid_table,
    host_columns,
    jax_table,
    to_port,
)

# customers, orders, lineitem rows: the small q3 and an edge sweep of
# lineitem sizes over small dimension tables
SIZES = [(2000, 20000, 80000)] + [(20, 200, n)
                                   for n in (1, 255, 257, 2048, 2049)]


def _q3_tables(c, o, li, seed=0):
    port = (tpch.customer_table(c, seed, device="cpu"),
            tpch.orders_table(o, c, seed + 1, device="cpu"),
            tpch.lineitem_q3_table(li, o, seed + 2, device="cpu"))
    ref = (jtpch.customer_table(c, seed), jtpch.orders_table(o, c, seed + 1),
           jtpch.lineitem_q3_table(li, o, seed + 2))
    return port, ref


@pytest.fixture(scope="module", params=SIZES, ids=lambda s: "x".join(map(str, s)))
def q3_runs(request):
    """Both packages' q3 results on one set of tables, computed once."""
    port, ref = _q3_tables(*request.param)
    kernels.reset_counts()
    got = tpch.tpch_q3(*port)
    planned = tpch.tpch_q3_planned(*port)
    launches = kernels.launches()
    return dict(port=port, ref=ref, got=got, planned=planned,
                want=jtpch.tpch_q3(*ref), want_planned=jtpch.tpch_q3_planned(*ref),
                launches=launches)


def _compact_ref(res) -> object:
    """The reference's compacted q3 table, as a JAX table."""
    k = int(res.result.num_groups)
    return jax_table([(tid, s, d[:k], None if v is None else v[:k])
                      for tid, s, d, v in host_columns(res.result.table)])


@pytest.mark.parametrize("seed", [0, 5, 11])
def test_q3_generators_match_reference(seed):
    port, ref = _q3_tables(50, 400, 1000, seed)
    for p, r in zip(port, ref):
        assert_same_table(p, r)


def test_q3_matches_reference(q3_runs):
    got, want = q3_runs["got"], q3_runs["want"]
    assert int(got.result.num_groups) == int(want.result.num_groups)
    assert int(got.join_total) == int(want.join_total)
    assert got.out_cap == want.out_cap
    assert int(got.join_total) <= got.out_cap
    assert_same_valid_table(got.result.compact(), _compact_ref(want))
    # the CPU path runs kernel D's plain version: no launch counted
    assert q3_runs["launches"] == {}


def test_q3_planned_matches_reference(q3_runs):
    got, want = q3_runs["planned"], q3_runs["want_planned"]
    assert int(got.result.num_groups) == int(want.result.num_groups)
    assert int(got.join_total) == int(want.join_total)
    assert bool(got.pk_violation) == bool(want.pk_violation) is False
    assert_same_valid_table(got.result.compact(), _compact_ref(want))
    # the planned and the general q3 agree on every valid value
    assert got.result.compact().equals(q3_runs["got"].result.compact())


def test_q3_oracles_agree(q3_runs):
    port, ref = q3_runs["port"], q3_runs["ref"]
    want = jtpch.tpch_q3_numpy(*ref)
    assert tpch.tpch_q3_numpy(*port) == want
    # the oracle's order is the query's: revenue desc, orderdate, key
    o = tpch.tpch_q3_oracle(*port)
    res = q3_runs["got"].result.compact()
    k = len(o["orderkey"])
    for col, name in enumerate(("orderkey", "orderdate", "shippriority",
                                "revenue")):
        np.testing.assert_array_equal(res.column(col).data[:k].numpy(),
                                      o[name])


def test_q3_with_other_segment_and_cutoff():
    port, ref = _q3_tables(300, 3000, 9000, seed=3)
    got = tpch.tpch_q3(*port, segment=3, cutoff=9500)
    want = jtpch.tpch_q3(*ref, segment=3, cutoff=9500)
    assert int(got.join_total) == int(want.join_total)
    assert_same_valid_table(got.result.compact(), _compact_ref(want))


@pytest.mark.parametrize("n", [1, 2049, 10000])
def test_general_q1_matches_reference(n):
    port = tpch.lineitem_table(n, seed=n, device="cpu")
    ref = jtpch.lineitem_table(n, seed=n)
    got = tpch.tpch_q1(port)
    assert got.num_rows == tpch._Q1_GROUP_BUDGET
    assert_same_valid_table(got, jtpch.tpch_q1(ref))
    assert_same_valid_table(tpch.tpch_q1_checked(port),
                            jtpch.tpch_q1_checked(ref))
    assert_same_valid_table(tpch.tpch_q1_planned_checked(port),
                            jtpch.tpch_q1_planned_checked(ref))
    # the first six rows are the planned q1's real groups, bit for bit
    planned = tpch.tpch_q1_planned(port)
    for a, b in zip(got.columns, planned.columns):
        ok = b.validity[:6]
        assert bool((a.validity[:6] == ok).all())
        assert bool((a.data[:6][ok] == b.data[:6][ok]).all())


def test_planned_checked_replans_on_domain_miss():
    n = 3000
    host = host_columns(jtpch.lineitem_table(n, seed=4))
    rf = host[tpch.L_RETURNFLAG][2].copy()
    rf[::50] = ord("X")  # outside the DDL domain
    host[tpch.L_RETURNFLAG] = (*host[tpch.L_RETURNFLAG][:2], rf, None)
    ref = jax_table(host)
    got = tpch.tpch_q1_planned_checked(to_port(ref))
    assert got.num_rows == tpch._Q1_GROUP_BUDGET  # the general plan ran
    assert_same_valid_table(got, jtpch.tpch_q1_planned_checked(ref))


def test_q1_checked_raises_past_the_group_budget():
    n = 4000
    host = host_columns(jtpch.lineitem_table(n, seed=6))
    rf = np.arange(n, dtype=np.int64).astype(np.int8)  # 256 flag values
    host[tpch.L_RETURNFLAG] = (*host[tpch.L_RETURNFLAG][:2], rf, None)
    port = to_port(jax_table(host))
    with pytest.raises(ValueError, match="group budget"):
        tpch.tpch_q1_checked(port)
    assert tpch.tpch_q1(port).num_rows == tpch._Q1_GROUP_BUDGET


def test_q3_probe_keys_are_int64():
    # every TPC-H join key is int64: the reference's Pallas probe would
    # fall back (key_width); the port's probe takes them as they are
    port, _ = _q3_tables(20, 200, 300)
    build, probe = khp.kernel_keys(port[1].column(0).data,
                                   port[2].column(0).data)
    assert build.dtype == probe.dtype == port[2].column(0).data.dtype
