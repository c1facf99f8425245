"""The port's string TPC-H plans, and q6, against the JAX package: the
new generators byte for byte; ``tpch_q6``, ``tpch_q12`` and its planned
twin, ``tpch_q4`` and its planned twin, ``tpch_q14`` and its planned
twin, and ``tpch_q5`` at small sizes (lineitem in the low thousands);
each planned plan against its general twin; each vectorized oracle
against its loop oracle and against the plan. Exact: types, validity
and every valid value; the reference's plans fill null slots from their
dispatch padding, so tables compare under validity. The reference's
q12, q4 and q14 plans and their planned twins run traced into one XLA
program (``traced_reference``), which compiles them once per size;
their results are integers, so the trace changes none."""

from __future__ import annotations

import numpy as np
import pytest

from spark_rapids_jni_tpu.models import tpch as jtpch
from spark_rapids_jni_tpu_torch.models import tpch
from spark_rapids_jni_tpu_torch.ops import kernels
from torch_parity import (
    assert_same_array,
    assert_same_table,
    assert_same_valid_table,
    host_columns,
    jax_table,
    traced_reference,
)

N = 2049

GENERATORS = {
    "lineitem_q12": ((N, 300), {}),
    "orders_q12": ((N,), {}),
    "orders_q4": ((N,), {}),
    "part": ((N,), {}),
    "lineitem_q14": ((N, 300), {}),
    "nation": ((), {}),
    "supplier": ((N,), {}),
    "customer_q5": ((N,), {}),
    "lineitem_q5": ((N, 300, 50), {"seed": 4}),
}


@pytest.mark.parametrize("name", list(GENERATORS))
def test_generators_match_reference(name):
    args, kw = GENERATORS[name]
    got = getattr(tpch, f"{name}_table")(*args, **kw, device="cpu")
    want = getattr(jtpch, f"{name}_table")(*args, **kw)
    assert_same_table(got, want)


def _both(name, *args, **kw):
    """The generator's table in both packages."""
    return (getattr(tpch, f"{name}_table")(*args, **kw, device="cpu"),
            getattr(jtpch, f"{name}_table")(*args, **kw))


# (orders, lineitem) rows: a small plan and an edge-sized lineitem
SIZES = [(300, 3000), (20, 257)]


@pytest.fixture(scope="module", params=SIZES, ids=lambda s: "x".join(map(str, s)))
def tables(request):
    o, li = request.param
    out = dict(
        o12=_both("orders_q12", o), l12=_both("lineitem_q12", li, o),
        o4=_both("orders_q4", o), part=_both("part", max(o // 3, 1)),
        l14=_both("lineitem_q14", li, max(o // 3, 1)),
        c5=_both("customer_q5", max(o // 4, 1)),
        s5=_both("supplier", 25), n5=_both("nation"),
        l5=_both("lineitem_q5", li, o, 25), l6=_both("lineitem", li))
    out["o5"] = (tpch.orders_table(o, max(o // 4, 1), device="cpu"),
                 jtpch.orders_table(o, max(o // 4, 1)))
    return out


def _port(tables, *names):
    return [tables[n][0] for n in names]


def _ref(tables, *names):
    return [tables[n][1] for n in names]


def _compact_ref(gb):
    """A reference GroupByResult's first ``num_groups`` rows."""
    k = int(gb.num_groups)
    return jax_table([(tid, s, (d[0][:k], d[1][:k]) if isinstance(d, tuple)
                       else d[:k], None if v is None else v[:k])
                      for tid, s, d, v in host_columns(gb.table)])


def _arrays(planned_fn):
    """A reference planned plan returning (table, present, domain_miss):
    its result without the ``lowered`` string, which jit cannot return."""
    return lambda *args: tuple(planned_fn(*args))[:3]


def _run(fn, *args):
    """``fn(*args)`` on CPU tables: the plain versions run, so no kernel
    launch is counted."""
    kernels.reset_counts()
    res = fn(*args)
    assert kernels.launches() == {}
    assert not kernels.fallbacks()
    return res


def test_q6_matches_reference(tables):
    li, jli = tables["l6"]
    got = _run(tpch.tpch_q6, li)
    want = jtpch.tpch_q6(jli)
    assert_same_valid_table(tpch.Table([got]), type(jli)([want]))
    assert int(got.data[0]) == tpch.tpch_q6_oracle(li) \
        == tpch.tpch_q6_numpy(li) == jtpch.tpch_q6_numpy(jli)


def test_q12_matches_reference(tables):
    args, jargs = _port(tables, "o12", "l12"), _ref(tables, "o12", "l12")
    got = _run(tpch.tpch_q12, *args)
    want = traced_reference(jtpch.tpch_q12, *jargs)
    assert int(got.join_total) == int(want.join_total)
    assert int(got.result.num_groups) == int(want.result.num_groups)
    assert_same_valid_table(got.result.compact(), _compact_ref(want.result))

    planned = _run(tpch.tpch_q12_planned_result, *args)
    wtable, wpresent, wmiss = traced_reference(
        _arrays(jtpch.tpch_q12_planned_result), *jargs)
    assert planned.lowered == "bounded"
    assert bool(planned.domain_miss) == bool(wmiss) is False
    assert_same_array(planned.present.numpy(), np.asarray(wpresent))
    assert_same_valid_table(planned.table, wtable)
    # the planned twin: the same groups in the same order
    k = int(planned.present.sum())
    assert planned.table.column(0).to_pylist()[:k] \
        == got.result.compact().column(0).to_pylist()[:k]
    for c in (1, 2):
        assert_same_array(planned.table.column(c).data[:k].numpy(),
                          got.result.table.column(c).data[:k].numpy())

    oracle = tpch.tpch_q12_oracle(*args)
    assert oracle == tpch.tpch_q12_numpy(*args) \
        == jtpch.tpch_q12_numpy(*jargs)
    rows = got.result.compact()
    assert {m: [int(rows.column(1).data[i]), int(rows.column(2).data[i])]
            for i, m in enumerate(rows.column(0).to_pylist())
            if m is not None} == oracle


def test_q4_matches_reference(tables):
    args, jargs = _port(tables, "o4", "l12"), _ref(tables, "o4", "l12")
    got = _run(tpch.tpch_q4, *args)
    want = traced_reference(jtpch.tpch_q4, *jargs)
    assert int(got.join_total) == int(want.join_total)
    assert int(got.result.num_groups) == int(want.result.num_groups)
    assert_same_valid_table(got.result.compact(), _compact_ref(want.result))

    planned = _run(tpch.tpch_q4_planned_result, *args)
    wtable, wpresent, wmiss = traced_reference(
        _arrays(jtpch.tpch_q4_planned_result), *jargs)
    assert planned.lowered == "bounded"
    assert bool(planned.domain_miss) == bool(wmiss) is False
    assert_same_array(planned.present.numpy(), np.asarray(wpresent))
    assert_same_valid_table(planned.table, wtable)

    oracle = tpch.tpch_q4_oracle(*args)
    assert oracle == tpch.tpch_q4_numpy(*args) \
        == jtpch.tpch_q4_numpy(*jargs)
    present = planned.present.numpy()
    names = planned.table.column(0).to_pylist()
    counts = planned.table.column(1).data.numpy()
    # the null group holds the semi join's padding rows, counted 0
    assert {names[i]: int(counts[i]) for i in np.flatnonzero(present)
            if names[i] is not None} == oracle
    rows = got.result.compact()
    assert {m: int(rows.column(1).data[i])
            for i, m in enumerate(rows.column(0).to_pylist())
            if m is not None} == oracle


def test_q14_matches_reference(tables):
    args, jargs = _port(tables, "part", "l14"), _ref(tables, "part", "l14")
    got = _run(tpch.tpch_q14, *args)
    want = traced_reference(jtpch.tpch_q14, *jargs)
    planned = _run(tpch.tpch_q14_planned, *args)
    wplanned = traced_reference(jtpch.tpch_q14_planned, *jargs)
    for res, ref in ((got, want), (planned, wplanned)):
        assert int(res.promo_revenue) == int(ref.promo_revenue)
        assert int(res.total_revenue) == int(ref.total_revenue)
        assert int(res.join_total) == int(ref.join_total)
        assert res.ratio() == ref.ratio()
    assert not bool(planned.pk_violation) and not bool(
        wplanned.pk_violation)
    assert tpch.tpch_q14_oracle(*args) == tpch.tpch_q14_numpy(*args) \
        == jtpch.tpch_q14_numpy(*jargs) \
        == (int(got.promo_revenue), int(got.total_revenue))


def test_q5_matches_reference(tables):
    names = ("c5", "o5", "l5", "s5", "n5")
    args, jargs = _port(tables, *names), _ref(tables, *names)
    got = _run(tpch.tpch_q5, *args)
    want = jtpch.tpch_q5(*jargs)
    assert bool(got.pk_violation) == bool(want.pk_violation) is False
    assert bool(got.domain_miss) == bool(want.domain_miss) is False
    assert_same_array(got.present.numpy(), np.asarray(want.present))
    assert_same_valid_table(got.table, want.table)
    oracle = tpch.tpch_q5_oracle(*args)
    assert oracle == tpch.tpch_q5_numpy(*args) \
        == jtpch.tpch_q5_numpy(*jargs)
    keys = got.table.column(0).data.numpy()
    rev = got.table.column(1).data.numpy()
    assert {int(keys[i]): int(rev[i])
            for i in np.flatnonzero(got.present.numpy())} == oracle


@pytest.mark.parametrize("span", [50, 10**12])
def test_oracle_lookup_takes_the_last_row_like_a_dict(span):
    # the vectorized oracles' key lookup, on repeated keys in a compact
    # range (direct table) and a sparse one (sorted-probe search)
    rng = np.random.default_rng(span % 97)
    keys = rng.integers(0, span, 40) * (1 if span < 100 else 7919)
    values = rng.integers(-5, 5, 40)
    probe = np.concatenate([keys, rng.integers(-3, span + 3, 200)])
    found, got = tpch._host_lookup(keys, values, probe)
    table = dict(zip(keys.tolist(), values.tolist()))
    assert found.tolist() == [int(p) in table for p in probe]
    assert [int(v) for v, f in zip(got, found) if f] \
        == [table[int(p)] for p in probe if int(p) in table]
