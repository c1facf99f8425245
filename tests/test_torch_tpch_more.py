"""The port's TPC-H q19 (general and planned), q17 and q10 against the JAX
package at small sizes, as the reference's own tests run them
(``tests/test_tpch.py``, ``tests/test_planner.py``): the q19/q17
generator byte for byte, each plan's results, each vectorized oracle
against its loop oracle and against the plan, and planned q19 against
q19. Exact: q19 and q17 give the same revenue integer, q10 the same
groups, nation keys and revenues in the reference's order. The
reference's q19 and q10 run traced into one XLA program per size
(integer results); q17, which compares a float mean, runs eagerly.
Then the general q1 over STRING flags (``lineitem_table_strings``, byte
for byte with the reference's generator) and q13's single-pass
reference, with null tails, at the reference's edge row counts."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu.columnar import Column as JColumn, Table as JTable
from spark_rapids_jni_tpu.models import tpch as jtpch
from spark_rapids_jni_tpu_torch import types as t
from spark_rapids_jni_tpu_torch.columnar import Column, Table
from spark_rapids_jni_tpu_torch.models import tpch
from spark_rapids_jni_tpu_torch.ops import kernels
from torch_parity import (
    EDGE_ROWS,
    assert_same_table,
    assert_same_valid_table,
    host_columns,
    jax_table,
    null_tail,
    to_port,
    traced_reference,
)


def _run(fn, *args):
    """``fn(*args)`` on CPU tables: the plain versions run, so no kernel
    launch is counted and nothing falls back."""
    kernels.reset_counts()
    res = fn(*args)
    assert kernels.launches() == {}
    assert not kernels.fallbacks()
    return res


@pytest.mark.parametrize("rows,parts", [(2049, 300), (257, 20)])
def test_lineitem_q19_generator_matches_reference(rows, parts):
    assert_same_table(tpch.lineitem_q19_table(rows, parts, device="cpu"),
                      jtpch.lineitem_q19_table(rows, parts))


# (parts, lineitem rows, key range of l_partkey): the reference tests'
# sizes and an edge-sized one
Q19_SIZES = [(150, 2500, 180), (20, 257, 24)]


@pytest.mark.parametrize("parts,rows,keys", Q19_SIZES)
def test_q19_matches_reference(parts, rows, keys):
    part, jpart = (tpch.part_table(parts, device="cpu"),
                   jtpch.part_table(parts))
    li, jli = (tpch.lineitem_q19_table(rows, keys, device="cpu"),
               jtpch.lineitem_q19_table(rows, keys))
    got = _run(tpch.tpch_q19, part, li)
    want = traced_reference(jtpch.tpch_q19, jpart, jli)
    assert int(got.revenue) == int(want.revenue)
    assert int(got.join_total) == int(want.join_total)
    planned = _run(tpch.tpch_q19_planned, part, li)
    wplanned = traced_reference(jtpch.tpch_q19_planned, jpart, jli)
    assert int(planned.revenue) == int(wplanned.revenue) == int(got.revenue)
    assert int(planned.join_total) == int(wplanned.join_total)
    assert bool(planned.pk_violation) == bool(wplanned.pk_violation) is False
    oracle = tpch.tpch_q19_oracle(part, li)
    assert oracle == tpch.tpch_q19_numpy(part, li) \
        == jtpch.tpch_q19_numpy(jpart, jli) == int(got.revenue)
    if parts == 150:
        assert oracle > 0  # the synthetic distributions must hit


Q17_SIZES = [(120, 3000, 120), (300, 2049, 300)]


@pytest.mark.parametrize("parts,rows,keys", Q17_SIZES)
def test_q17_matches_reference(parts, rows, keys):
    part, jpart = (tpch.part_table(parts, device="cpu"),
                   jtpch.part_table(parts))
    li, jli = (tpch.lineitem_q19_table(rows, keys, device="cpu"),
               jtpch.lineitem_q19_table(rows, keys))
    got = _run(tpch.tpch_q17, part, li)
    want = jtpch.tpch_q17(jpart, jli)
    assert int(got.yearly_total) == int(want.yearly_total)
    assert int(got.join_total) == int(want.join_total)
    assert got.avg_yearly() == want.avg_yearly()
    oracle = tpch.tpch_q17_oracle(part, li)
    assert oracle == tpch.tpch_q17_numpy(part, li) \
        == jtpch.tpch_q17_numpy(jpart, jli) == int(got.yearly_total) \
        == tpch.tpch_q17_oracle(part, li, plan_association=True)
    if parts == 120:
        assert oracle > 0  # the synthetic distributions must hit


def test_q17_boundary_rows_fall_as_in_the_reference():
    """Rows whose quantity equals 0.2 * avg in exact arithmetic: the
    port's mean has the reference's bits and the comparison its
    association, so each boundary row falls the same way. Part 4 is the
    SF10 row that the reference's association keeps and SQL's exact
    comparison (and the loop oracle) drops: 463 against 0.2 * 76,395 /
    33 = 463 exactly (ROADMAP Queue 3)."""
    part_rows = [(1, "Brand#23", "MED BOX"), (2, "Brand#23", "MED BOX"),
                 (3, "Brand#11", "MED BOX"), (4, "Brand#23", "MED BOX")]
    # part 1: avg 500 -> 0.2 * avg = 100; part 2: avg 777 / 3 units;
    # part 4: 33 rows summing to 76,395, one of them 463
    lines = [(1, 100), (1, 100), (1, 100), (1, 100), (1, 2100),
             (2, 100), (2, 3), (2, 2228), (3, 1), (4, 463)] \
        + [(4, 2373)] * 31 + [(4, 2369)]
    pk = np.array([p[0] for p in part_rows], np.int64)
    size = np.ones(len(part_rows), np.int32)

    def strings(vals):
        return (np.cumsum([0] + [len(v) for v in vals]).astype(np.int32),
                np.frombuffer("".join(vals).encode(), np.uint8).copy())

    from spark_rapids_jni_tpu import types as jt

    sid, did = int(jt.TypeId.STRING), int(jt.TypeId.DECIMAL64)
    part_cols = [(int(jt.TypeId.INT64), 0, pk, None),
                 (sid, 0, strings(["x"] * len(part_rows)), None),
                 (sid, 0, strings([p[1] for p in part_rows]), None),
                 (sid, 0, strings([p[2] for p in part_rows]), None),
                 (int(jt.TypeId.INT32), 0, size, None)]
    n = len(lines)
    li_cols = [(int(jt.TypeId.INT64), 0,
                np.array([x[0] for x in lines], np.int64), None),
               (did, -2, np.array([x[1] for x in lines], np.int64), None),
               (did, -2, np.arange(1, n + 1, dtype=np.int64) * 1000, None),
               (did, -2, np.zeros(n, np.int64), None),
               (sid, 0, strings(["AIR"] * n), None),
               (sid, 0, strings(["NONE"] * n), None)]
    jpart, jli = jax_table(part_cols), jax_table(li_cols)
    part, li = to_port(jpart), to_port(jli)
    got = tpch.tpch_q17(part, li)
    want = jtpch.tpch_q17(jpart, jli)
    assert int(got.yearly_total) == int(want.yearly_total) \
        == tpch.tpch_q17_oracle(part, li, plan_association=True)
    # the loop oracle drops the 463 row (lineitem row 9, price 10,000)
    assert tpch.tpch_q17_oracle(part, li) == tpch.tpch_q17_numpy(part, li) \
        == jtpch.tpch_q17_numpy(jpart, jli) == int(got.yearly_total) - 10_000


def _q10_inputs(n_cust, n_ord, n, seed):
    """q10's input as the reference's test builds it: q3's lineitem with
    an INT8 l_returnflag drawn from b"ANR" appended."""
    flags = np.random.default_rng(seed).choice(
        np.frombuffer(b"ANR", np.int8), n)
    c = tpch.customer_q5_table(n_cust, device="cpu")
    o = tpch.orders_table(n_ord, n_cust, device="cpu")
    li3 = tpch.lineitem_q3_table(n, n_ord, device="cpu")
    li = Table(list(li3.columns) + [Column.from_numpy(flags, t.INT8,
                                                      device="cpu")])
    jc = jtpch.customer_q5_table(n_cust)
    jo = jtpch.orders_table(n_ord, n_cust)
    jli3 = jtpch.lineitem_q3_table(n, n_ord)
    jli = JTable(list(jli3.columns) + [JColumn.from_numpy(flags)])
    return (c, o, li), (jc, jo, jli)


def _compact_ref(gb):
    k = int(gb.num_groups)
    return jax_table([(tid, s, d[:k], None if v is None else v[:k])
                      for tid, s, d, v in host_columns(gb.table)])


@pytest.mark.parametrize("n_cust,n_ord,n", [(40, 150, 1200), (7, 30, 257)])
def test_q10_matches_reference(n_cust, n_ord, n):
    args, jargs = _q10_inputs(n_cust, n_ord, n, seed=n)
    got = _run(tpch.tpch_q10, *args)
    want = traced_reference(jtpch.tpch_q10, *jargs)
    assert bool(got.pk_violation) == bool(want.pk_violation) is False
    assert int(got.join_total) == int(want.join_total)
    assert int(got.result.num_groups) == int(want.result.num_groups)
    assert_same_valid_table(got.result.compact(), _compact_ref(want.result))

    oracle = tpch.tpch_q10_oracle(*args)
    table = {int(k): (int(a), int(b)) for k, a, b in zip(
        oracle["custkey"], oracle["nationkey"], oracle["revenue"])}
    assert table == tpch.tpch_q10_numpy(*args) \
        == jtpch.tpch_q10_numpy(*jargs)
    # the real groups, in the oracle's order, ahead of the null group
    rows = got.result.compact()
    k = len(oracle["custkey"])
    for col, name in enumerate(("custkey", "nationkey", "revenue")):
        assert rows.column(col).to_pylist()[:k] == oracle[name].tolist()
    assert all(v is None for v in rows.column(0).to_pylist()[k:])


# ---- string-keyed q1 and q13 -------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("rows", [1, 2049])
def test_lineitem_strings_generator_matches_reference(rows, seed):
    assert_same_table(
        tpch.lineitem_table_strings(rows, seed, device="cpu"),
        jtpch.lineitem_table_strings(rows, seed))


def _with_null_tails(jtable, cols, seed):
    """The reference table with null tails on columns ``cols``, in the
    port and in the reference."""
    host = host_columns(jtable)
    n = jtable.num_rows
    for i in cols:
        tid, scale, data, _ = host[i]
        host[i] = (tid, scale, data, null_tail(n, seed + i))
    return to_port(jax_table(host)), jax_table(host)


@pytest.mark.parametrize("n", EDGE_ROWS)
def test_string_q1_matches_reference(n):
    """The general q1 over STRING flags (a sort-based groupby on two
    STRING keys) with null flags and shipdates, against the reference's
    fused q1 (its null slots hold padding bytes: compared under
    validity); without nulls it equals the INT8 q1 at the same seed."""
    port, ref = _with_null_tails(
        jtpch.lineitem_table_strings(n, n % 3),
        (tpch.L_RETURNFLAG, tpch.L_LINESTATUS, tpch.L_SHIPDATE), n)
    assert_same_valid_table(_run(tpch.tpch_q1, port), jtpch.tpch_q1(ref))
    got = _run(tpch.tpch_q1, tpch.lineitem_table_strings(n, 1, "cpu"))
    flags = tpch.tpch_q1(tpch.lineitem_table(n, 1, "cpu"))
    for i, (a, b) in enumerate(zip(got.columns, flags.columns)):
        assert torch.equal(a.valid_mask(), b.valid_mask())
        if i < 2:  # one-byte strings: the flag bytes under validity
            v = a.valid_mask()
            assert bool((a.data[v] == 1).all())
            assert torch.equal(a.chars[v, 0], b.data[v].view(torch.uint8))
        else:
            assert torch.equal(a.data, b.data)


@pytest.mark.parametrize("n", EDGE_ROWS)
def test_q13_matches_reference(n):
    ref = jtpch.orders_table(n, max(n // 8, 1), seed=n)
    got = _run(tpch.tpch_q13_reference, to_port(ref))
    assert_same_table(got, jtpch.tpch_q13_reference(ref))
    want = tpch.tpch_q13_oracle(to_port(ref))
    assert got.column(0).data.numpy().tolist() == want["custkey"].tolist()
    assert got.column(1).data.numpy().tolist() == want["count"].tolist()
    # null customer keys form one group; null order keys are not counted
    port, ref = _with_null_tails(ref, (tpch.O_ORDERKEY, tpch.O_CUSTKEY), n)
    assert_same_table(_run(tpch.tpch_q13_reference, port),
                      jtpch.tpch_q13_reference(ref))
