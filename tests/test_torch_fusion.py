"""The port's plan IR and executor (``runtime/fusion.py``) against the JAX
package's, over the TPC-H plans.

- Each TPC-H entry point that runs through ``fusion.execute`` (general,
  checked, planned and planned-checked q1, q6, q3 and planned q3)
  equals the reference's ``execute`` of the same plan at
  1/255/256/257/2047/2048/2049 rows with null tails, its meta included.
  The reference runs its fused (bucket-padded, traced) region at two of
  the row counts and its ``force_staged`` walk at the others
  (``torch_parity.FUSED_ROWS``); its contract makes the two
  bit-identical. Tables compare under validity: the reference's null
  slots hold bytes of padding rows.
- The planned q1's domain miss re-plans as the reference's; the checked
  q1 raises past its group budget.
- ``plan_fingerprint`` (the package prefix mapped) and
  ``estimate_hbm_bytes`` of the query plans equal the reference's, and
  misuse raises as there: an unbound scan, an unresolvable row spec, a
  local callable, mixed bucket flags; a failing node propagates.

TPC-DS q72 and q64 and the hand-built plans of every node type are in
``tests/test_torch_fusion_nodes.py``."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu.models import tpch as jtpch
from spark_rapids_jni_tpu.ops import planner as jplanner
from spark_rapids_jni_tpu.runtime import fusion as jfusion
from spark_rapids_jni_tpu_torch import telemetry, types as t
from spark_rapids_jni_tpu_torch.columnar import Column, Table
from spark_rapids_jni_tpu_torch.models import tpch
from spark_rapids_jni_tpu_torch.ops import kernels
from spark_rapids_jni_tpu_torch.ops.planner import scalar_domain
from spark_rapids_jni_tpu_torch.runtime import fusion
from torch_parity import (
    EDGE_ROWS,
    assert_same_valid_table,
    host_columns,
    jax_table,
    mapped_fingerprint,
    ref_execute,
    same_meta,
    to_port,
    with_null_tails,
)

def _ref_q1_planned_plan():
    return jfusion.Plan("tpch_q1_planned", jfusion.GroupBy(
        jfusion.Project(jfusion.Scan("lineitem"), jtpch._q1_work_table),
        (0, 1), tuple(jtpch._Q1_AGGS),
        domains=(jplanner.scalar_domain(jtpch._Q1_RF_DOMAIN),
                 jplanner.scalar_domain(jtpch._Q1_LS_DOMAIN)),
        label="plan"))


def _q6_plan(fz, reduce_fn):
    return fz.Plan("tpch_q6", fz.Project(fz.Scan("lineitem"), reduce_fn,
                                         rowwise=False))


def _lineitems(n):
    return with_null_tails(jtpch.lineitem_table(n, seed=n), (0, 3, 4, 6),
                            seed=n)


@pytest.mark.parametrize("n", EDGE_ROWS)
def test_q1_family_matches_reference_execute(n):
    li, jli = _lineitems(n)
    b, jb = {"lineitem": li}, {"lineitem": jli}

    want = ref_execute(jtpch._q1_plan(), jb, n)
    got = fusion.execute(tpch._q1_plan(), b)
    same_meta(got.meta, want.meta)
    for table in (got.table, tpch.tpch_q1(li), tpch.tpch_q1_checked(li)):
        assert_same_valid_table(table, want.table)

    want = ref_execute(_ref_q1_planned_plan(), jb, n)
    got = fusion.execute(tpch._q1_planned_plan(), b)
    same_meta(got.meta, want.meta)
    res = tpch.tpch_q1_planned_result(li)
    for table in (got.table, res.table, tpch.tpch_q1_planned(li),
                  tpch.tpch_q1_planned_checked(li)):
        assert_same_valid_table(table, want.table)
    assert np.asarray(res.present).tolist() == \
        np.asarray(want.meta["plan.present"]).tolist()
    assert not bool(res.domain_miss) and res.lowered == "bounded"

    want = ref_execute(_q6_plan(jfusion, jtpch._q6_reduce), jb, n)
    got = fusion.execute(_q6_plan(fusion, tpch._q6_reduce), b)
    assert got.meta == want.meta == {}
    assert_same_valid_table(got.table, want.table)
    assert_same_valid_table(Table([tpch.tpch_q6(li)]), want.table)


def test_q1_planned_domain_miss_replans_identically():
    n = 2049
    host = host_columns(jtpch.lineitem_table(n, seed=3))
    rf = host[tpch.L_RETURNFLAG][2].copy()
    rf[5] = ord("X")  # outside the declared 'A'/'N'/'R' domain
    host[tpch.L_RETURNFLAG] = (*host[tpch.L_RETURNFLAG][:2], rf, None)
    jli = jax_table(host)
    li = to_port(jli)
    got, want = tpch.tpch_q1_planned_result(li), \
        jtpch.tpch_q1_planned_result(jli)
    assert bool(got.domain_miss) and bool(want.domain_miss)
    # the checked wrapper re-plans onto the general q1, in both packages
    assert_same_valid_table(tpch.tpch_q1_planned_checked(li),
                            jtpch.tpch_q1_planned_checked(jli))
    assert_same_valid_table(tpch.tpch_q1_planned_checked(li),
                            tpch.tpch_q1(li))


def test_q1_checked_raises_past_the_group_budget():
    n = 300
    host = host_columns(jtpch.lineitem_table(n, seed=4))
    for col in (tpch.L_RETURNFLAG, tpch.L_LINESTATUS):
        tid, scale, _, _ = host[col]
        host[col] = (tid, scale, np.arange(n, dtype=np.int8), None)
    host[tpch.L_SHIPDATE] = (*host[tpch.L_SHIPDATE][:2],
                             np.zeros(n, np.int32), None)
    jli = jax_table(host)
    with pytest.raises(ValueError, match="group budget"):
        tpch.tpch_q1_checked(to_port(jli))
    with pytest.raises(ValueError, match="group budget"):
        jtpch.tpch_q1_checked(jli)


def _q3_tables(n):
    port, ref = [], []
    for tab, cols in ((jtpch.customer_table(20, seed=n), ()),
                      (jtpch.orders_table(200, 20, seed=n + 1), (2,)),
                      (jtpch.lineitem_q3_table(n, 200, seed=n + 2),
                       (0, 1))):
        p, r = with_null_tails(tab, cols, seed=n)
        port.append(p)
        ref.append(r)
    return tuple(port), tuple(ref)


@pytest.mark.parametrize("n", EDGE_ROWS)
def test_q3_and_planned_q3_match_reference_execute(n):
    port, ref = _q3_tables(n)
    b = dict(zip(("customer", "orders", "lineitem"), port))
    jb = dict(zip(("customer", "orders", "lineitem"), ref))

    want = ref_execute(jtpch._q3_plan(0, jtpch._Q3_CUTOFF_DAYS, 2), jb, n)
    got = fusion.execute(tpch._q3_plan(0, tpch._Q3_CUTOFF_DAYS, 2), b)
    same_meta(got.meta, want.meta)
    res = tpch.tpch_q3(*port)
    for table in (got.table, res.result.table):
        assert_same_valid_table(table, want.table)
    assert int(res.result.num_groups) == int(want.meta["groupby.num_groups"])
    assert int(res.join_total) == int(want.meta["join2.total"])
    assert res.out_cap == 2 * n

    want = ref_execute(jtpch._q3_planned_plan(0, jtpch._Q3_CUTOFF_DAYS),
                        jb, n)
    got = fusion.execute(tpch._q3_planned_plan(0, tpch._Q3_CUTOFF_DAYS), b)
    same_meta(got.meta, want.meta)
    res = tpch.tpch_q3_planned(*port)
    for table in (got.table, res.result.table):
        assert_same_valid_table(table, want.table)
    assert int(res.join_total) == int(want.meta["pk2.total"])
    assert bool(res.pk_violation) == bool(
        want.meta["pk1.pk_violation"] | want.meta["pk2.pk_violation"])


def test_cpu_plans_count_no_launch_and_no_fallback():
    li, _ = _lineitems(2049)
    kernels.reset_counts()
    telemetry.reset()
    tpch.tpch_q1_planned(li)
    tpch.tpch_q1(li)
    tpch.tpch_q6(li)
    assert kernels.launches() == {} and kernels.fallbacks() == {}
    assert fusion.stats() == {"regions": 3, "nodes_fused": 3 + 4 + 2}


# ---- IR helpers ------------------------------------------------------------


def test_fingerprints_and_estimates_of_the_query_plans_match_reference():
    li, jli = _lineitems(257)
    (cu, od, l3), (jcu, jod, jl3) = _q3_tables(255)
    q3b = dict(customer=cu, orders=od, lineitem=l3)
    jq3b = dict(customer=jcu, orders=jod, lineitem=jl3)
    pairs = [
        (tpch._q1_plan(), jtpch._q1_plan(), {"lineitem": li},
         {"lineitem": jli}),
        (tpch._q1_planned_plan(), _ref_q1_planned_plan(), {"lineitem": li},
         {"lineitem": jli}),
        (tpch._q3_plan(1, 9000, 3), jtpch._q3_plan(1, 9000, 3), q3b, jq3b),
        (tpch._q3_planned_plan(2, 9100), jtpch._q3_planned_plan(2, 9100),
         q3b, jq3b),
    ]
    for port, ref, b, jb in pairs:
        assert port.name == ref.name
        assert fusion.plan_fingerprint(port, b) == \
            mapped_fingerprint(jfusion.plan_fingerprint(ref, jb))
        assert fusion.estimate_hbm_bytes(port, b) == \
            jfusion.estimate_hbm_bytes(ref, jb)
        assert [len(c) and c[2] for c in fusion.scan_prefix_chains(
            port.root)] == [len(c) and c[2]
                            for c in jfusion.scan_prefix_chains(ref.root)]


def _port_table(n=4):
    return Table([Column(t.INT64, torch.arange(n, dtype=torch.int64))])


def test_unbound_scan_raises():
    with pytest.raises(KeyError, match="unbound table 'missing'"):
        fusion.execute(fusion.Plan("p", fusion.Scan("missing")), {})


def test_inconsistent_bucket_flags_raise():
    plan = fusion.Plan("p", fusion.Join(
        fusion.Scan("t"), fusion.Scan("t", bucket=False), (0,), (0,),
        fusion.rows_of("t")))
    with pytest.raises(ValueError, match="both bucketed and exact"):
        fusion.execute(plan, {"t": _port_table()})


def test_local_callables_are_rejected():
    plan = fusion.Plan("p", fusion.Project(fusion.Scan("t"),
                                           lambda tbl: tbl))
    with pytest.raises(ValueError, match="module-level"):
        fusion.execute(plan, {"t": _port_table()})

    def local_pred(tbl):
        return tbl.column(0).data > 0

    with pytest.raises(ValueError, match="module-level"):
        fusion.plan_fingerprint(fusion.Plan("p", fusion.Filter(
            fusion.Scan("t"), local_pred)), {"t": _port_table()})


def test_unresolvable_row_spec_raises():
    plan = fusion.Plan("p", fusion.Join(
        fusion.Scan("t"), fusion.Scan("t"), (0,), (0,),
        ("bogus_spec", "t", 1)))
    with pytest.raises(ValueError, match="unresolvable row spec"):
        fusion.execute(plan, {"t": _port_table()})


def test_row_specs_resolve_as_reference():
    for spec, rows in ((fusion.rows_of("t", 3), 10),
                       (fusion.min_rows_of("t", 7), 10),
                       (fusion.min_rows_of("t", 7), 4), (None, 3), (12, 3)):
        assert fusion._resolve(spec, {"t": rows}) == \
            jfusion._resolve(spec, {"t": rows})


def test_failing_node_propagates_and_nothing_reruns():
    calls = []

    class Token:
        def check(self, where):
            calls.append(where)

    plan = fusion.Plan("p", fusion.Project(fusion.Scan("t"),
                                           _raise_in_region))
    with pytest.raises(RuntimeError, match="region failed"):
        fusion.execute(plan, {"t": _port_table()}, cancel_token=Token())
    assert calls == ["fusion.p"]


def _raise_in_region(tbl):
    raise RuntimeError("region failed")


def test_planned_lowering_matches_plan_groupby():
    li, jli = _lineitems(300)
    node, jnode = tpch._q1_planned_plan().root, _ref_q1_planned_plan().root
    assert fusion._planned_lowering(node) == "bounded"
    # 12 slots over a budget of 8, or a key without a domain: general
    for kw in ({"budget": 8},
               {"domains": (scalar_domain(tpch._Q1_RF_DOMAIN), None)}):
        jkw = dict(kw)
        if "domains" in kw:
            jkw["domains"] = (jplanner.scalar_domain(jtpch._Q1_RF_DOMAIN),
                              None)
        assert fusion._planned_lowering(node._replace(**kw)) == "general"
        got = fusion.execute(fusion.Plan("p", node._replace(**kw)),
                             {"lineitem": li})
        want = jfusion.execute(jfusion.Plan("p", jnode._replace(**jkw)),
                               {"lineitem": jli}, force_staged=True)
        assert got.meta["plan.lowered"] == "general"
        same_meta(got.meta, want.meta)
        assert_same_valid_table(got.table, want.table)
