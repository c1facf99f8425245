"""The port's executor (``runtime/fusion.py``) against the JAX
package's over TPC-DS q72 and q64 and over hand-built plans.

- ``tpcds_q72`` and ``tpcds_q64`` equal the reference's ``execute`` of
  the same plans at 1/255/256/257/2047/2048/2049 fact rows with null
  tails, meta included (fused at ``torch_parity.FUSED_ROWS``, staged at
  the others; tables under validity).
- Hand-built plans use every node the executor evaluates: Filter, Limit
  (clamped to its input rows), Sort with mixed ``ascending`` /
  ``nulls_first``, Join of ``how`` left, left_semi and left_anti,
  DensePkJoin, BloomBuild/BloomProbe, packed bloom bits and a Project
  with ``rowwise=False``, each built for both packages from module-level
  functions of this file (``*_port`` / ``*_ref`` pairs); their tables,
  meta, fingerprints and ``estimate_hbm_bytes`` equal the reference's.
- ``split_at_exchange`` and ``replace_node`` equal the reference's, and
  an Exchange (the root's wire form and meta, and a mid-plan one run as
  region -> exchange -> region) executes to the reference's result."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu import types as jt
from spark_rapids_jni_tpu.columnar import Column as JColumn, Table as JTable
from spark_rapids_jni_tpu.models import tpcds as jtpcds
from spark_rapids_jni_tpu.runtime import fusion as jfusion
from spark_rapids_jni_tpu_torch import types as t
from spark_rapids_jni_tpu_torch.columnar import Column, Table
from spark_rapids_jni_tpu_torch.models import tpcds, tpch
from spark_rapids_jni_tpu_torch.runtime import fusion
from torch_parity import (
    EDGE_ROWS,
    assert_same_valid_table,
    jax_table,
    mapped_fingerprint,
    null_tail,
    ref_execute,
    same_meta,
    to_port,
    with_null_tails,
)


def _pair(name, *args, **kw):
    return (getattr(tpcds, name)(*args, device="cpu", **kw),
            getattr(jtpcds, name)(*args, **kw))


@pytest.mark.parametrize("n", EDGE_ROWS)
def test_q72_and_q64_match_reference_execute(n):
    cs, jcs = with_null_tails(jtpcds.catalog_sales_table(
        n, num_items=30, seed=n), (tpcds.CS_SOLD_DATE_SK, tpcds.CS_QUANTITY),
        seed=n)
    (dd, jdd), (item, jitem), (inv, jinv) = (
        _pair("date_dim_table"), _pair("item_table", 30),
        _pair("inventory_table", num_items=30))
    b = dict(catalog_sales=cs, date_dim=dd, item=item, inventory=inv)
    jb = dict(catalog_sales=jcs, date_dim=jdd, item=jitem, inventory=jinv)
    want = ref_execute(jtpcds._q72_plan(2000, 2), jb, n)
    got = fusion.execute(tpcds._q72_plan(2000, 2), b)
    same_meta(got.meta, want.meta)
    res = tpcds.tpcds_q72(cs, dd, item, inv)
    for table in (got.table, res.table):
        assert_same_valid_table(table, want.table)
    assert int(res.num_groups) == int(want.meta["groupby.num_groups"])

    ss, jss = with_null_tails(jtpcds.store_sales_table(
        n, num_items=12, num_customers=20, seed=n),
        (tpcds.SS_ITEM_SK, tpcds.SS_CUSTOMER_SK), seed=n)
    want = ref_execute(jtpcds._q64_plan(2000, 2001, 365, 2000, 4),
                        {"store_sales": jss}, n)
    got = fusion.execute(tpcds._q64_plan(2000, 2001, 365, 2000, 4),
                         {"store_sales": ss})
    same_meta(got.meta, want.meta)
    res = tpcds.tpcds_q64(ss)
    for table in (got.table, res.result.table):
        assert_same_valid_table(table, want.table)
    assert int(res.join_total) == int(want.meta["join.total"])
    assert res.out_size == 4 * n


# ---- hand-built plans: every node the executor evaluates -------------------


def _keep_not_mod3(tbl):
    """Filter: value column 1 not divisible by 3 (both packages)."""
    return tbl.column(1).data % 3 != 0


def _sum_valid_port(tbl, row_valid, col):
    c = tbl.column(col)
    assert row_valid is None
    total = torch.where(c.valid_mask(), c.data, 0).sum().reshape(1)
    return Table([Column(t.INT64, total, c.valid_mask().any().reshape(1))])


def _sum_valid_ref(tbl, row_valid, col):
    c = tbl.column(col)
    keep = c.valid_mask() if row_valid is None else c.valid_mask() & row_valid
    total = jnp.sum(jnp.where(keep, c.data, 0)).reshape(1)
    return JTable([JColumn(jt.INT64, total, jnp.any(keep).reshape(1))])


def _node_plans(fz, sum_fn, packed_bits: bool):
    t_, u_ = fz.Scan("t"), fz.Scan("u")
    sort_keys = dict(ascending=(True, False), nulls_first=(False, True))
    plans = {
        "filter_left_join_sort_limit": fz.Plan("left", fz.Limit(fz.Sort(
            fz.Join(fz.Filter(t_, _keep_not_mod3), u_, (0,), (0,),
                    fz.rows_of("t", 2), how="left", label="jl"),
            (0, 3), **sort_keys), 100)),
        "semi_anti": fz.Plan("semi", fz.Join(
            fz.Join(t_, u_, (0,), (0,), fz.rows_of("t"), how="left_semi",
                    label="semi"),
            u_, (1,), (0,), fz.rows_of("t"), how="left_anti",
            label="anti")),
        "sort_limit_clamped": fz.Plan("sort", fz.Limit(
            fz.Sort(t_, (0, 2), **sort_keys), 10**6)),
        "dense_pk_reduce": fz.Plan("pk", fz.Project(
            fz.DensePkJoin(t_, fz.Scan("u", bucket=False), 0, 0, 1,
                           fz.rows_of("u"), clustered=True, label="pk"),
            sum_fn, (4,), rowwise=False)),
        "bloom_join_groupby": fz.Plan("bloom", fz.GroupBy(
            fz.Join(fz.BloomProbe(t_, fz.BloomBuild(u_, 0, 4096, 3),
                                  0, 4096, 3, label="rtf"),
                    u_, (0,), (0,), fz.rows_of("t"), label="j"),
            (0,), ((1, "sum"), (1, "count")), max_groups=64)),
    }
    if packed_bits:
        plans["packed_bloom"] = fz.Plan("packed", fz.BloomProbe(
            t_, fz.Scan("bits", bucket=False), 0, 4096, 3, packed=True,
            label="rtf"))
    return plans


def _node_tables(n, seed):
    rng = np.random.default_rng(seed)
    m = 40
    key = rng.integers(0, 2 * m, n).astype(np.int64)
    t_host = [(int(jt.TypeId.INT64), 0, key, null_tail(n, seed)),
              (int(jt.TypeId.INT64), 0,
               rng.integers(-50, 50, n).astype(np.int64), None),
              (int(jt.TypeId.INT32), 0,
               rng.integers(0, 5, n).astype(np.int32),
               rng.random(n) > 0.3)]
    u_host = [(int(jt.TypeId.INT64), 0, np.arange(1, m + 1, dtype=np.int64),
               rng.random(m) > 0.1),
              (int(jt.TypeId.INT64), 0,
               rng.integers(0, 9, m).astype(np.int64), None)]
    from spark_rapids_jni_tpu.ops import bloom_filter as jbloom

    bf = jbloom.bloom_put_spark(jbloom.BloomFilter.empty(4096, 3),
                                jnp.asarray(u_host[0][2][::2]))
    bits = [(int(jt.TypeId.UINT8), 0, np.asarray(bf.to_packed()), None)]
    ref = {name: jax_table(h) for name, h in
           (("t", t_host), ("u", u_host), ("bits", bits))}
    return {name: to_port(tab) for name, tab in ref.items()}, ref


@pytest.mark.parametrize("n", [257, 2049])
def test_hand_built_plans_match_reference(n):
    port_tabs, ref_tabs = _node_tables(n, seed=n)
    ports = _node_plans(fusion, _sum_valid_port, True)
    refs = _node_plans(jfusion, _sum_valid_ref, True)
    for name, plan in ports.items():
        want = ref_execute(refs[name], ref_tabs, n)
        got = fusion.execute(plan, port_tabs)
        same_meta(got.meta, want.meta)
        assert_same_valid_table(got.table, want.table)
        assert fusion.plan_fingerprint(plan, port_tabs) == \
            mapped_fingerprint(jfusion.plan_fingerprint(refs[name], ref_tabs))
        assert fusion.estimate_hbm_bytes(plan, port_tabs) == \
            jfusion.estimate_hbm_bytes(refs[name], ref_tabs)
    # the limit clamps to the sort's input rows, as the reference's does
    assert fusion.execute(ports["sort_limit_clamped"],
                          port_tabs).table.num_rows == n


def _exchange_plans(fz):
    g = fz.GroupBy(fz.Scan("t"), (0,), ((1, "sum"),), label="partial")
    x = fz.Exchange(g, (0,), 2, capacity=fz.rows_of("t"),
                    valid_meta="partial.num_groups")
    return (fz.Plan("root_x", x),
            fz.Plan("mid_x", fz.GroupBy(x, (0,), ((1, "sum"),),
                                        label="merge")))


def test_split_at_exchange_and_replace_node_match_reference():
    port_tabs, ref_tabs = _node_tables(100, seed=1)
    (p_root, p_mid), (r_root, r_mid) = (_exchange_plans(fusion),
                                        _exchange_plans(jfusion))
    assert fusion.split_at_exchange(p_root) is None
    assert jfusion.split_at_exchange(r_root) is None
    pack, merge, binding, x = fusion.split_at_exchange(p_mid)
    jpack, jmerge, jbinding, _ = jfusion.split_at_exchange(r_mid)
    assert (pack.name, merge.name, binding) == \
        (jpack.name, jmerge.name, jbinding)
    assert pack.root is x and merge.root.child == fusion.Scan(binding)
    for port, ref in ((p_root, r_root), (p_mid, r_mid)):
        assert fusion.estimate_hbm_bytes(port, port_tabs) == \
            jfusion.estimate_hbm_bytes(ref, ref_tabs)
        assert fusion.plan_fingerprint(port, port_tabs) == \
            jfusion.plan_fingerprint(ref, ref_tabs)
    # replace_node keeps untouched subtrees and shared nodes shared
    plan = tpch._q3_plan(0, 9204, 2)
    j2 = plan.root.child.child.child
    new_root = fusion.replace_node(plan.root, j2.left, fusion.Scan("p"))
    new_j2 = new_root.child.child.child
    assert new_j2.right is j2.right and new_j2.left == fusion.Scan("p")
    assert fusion.replace_node(plan.root, fusion.Scan("nope"),
                               fusion.Scan("x")) is plan.root


def test_exchange_and_runtime_filters_name_their_roadmap_entries():
    """An Exchange executes as the reference's does: the root's wire
    table and routing meta, and the mid-plan plan's result."""
    port_tabs, ref_tabs = _node_tables(50, seed=2)
    (root, mid), (jroot, jmid) = (_exchange_plans(fusion),
                                  _exchange_plans(jfusion))
    got, want = (fusion.execute(root, port_tabs),
                 jfusion.execute(jroot, ref_tabs))
    for key in ("parts", "capacity", "flights", "row_counts", "rows"):
        assert got.meta[f"exchange.{key}"] == want.meta[f"exchange.{key}"]
    assert_same_valid_table(got.table, want.table)
    got, want = (fusion.execute(mid, port_tabs),
                 jfusion.execute(jmid, ref_tabs))
    assert got.meta["exchange.dests"] == want.meta["exchange.dests"]
    assert_same_valid_table(got.table, want.table)


