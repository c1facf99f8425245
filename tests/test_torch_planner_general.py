"""The planner's general lowering against the JAX package:
``plan_groupby`` on keys with no domain, slot counts past the budget and
aggregates outside the single-pass set (the sort-based groupby, keys
sorted nulls last, ``present``, ``overflowed``, and ``row_valid`` nulling
the absent rows), ``plan_groupby_auto``'s budget growth and
``PlanBudgetExceeded``, and the month buckets (``month_code``,
``month_bucket``, ``month_domain``) feeding the bounded plan, at the
reference's edge row counts with null tails.

Every result is exact: the row order, the validity and every valid
value (the reference's padded rows past the groups hold whatever its
bucketed padding left, so the general plan compares valid cells), and
float64 means (the same exact int64 sum over the same count). The
general plan's var is held to a relative 1e-9 (float64 sums in another
order)."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu import types as jt
from spark_rapids_jni_tpu.columnar import Table as JTable
from spark_rapids_jni_tpu.ops import planner as jplanner
from spark_rapids_jni_tpu.ops.table_ops import trim_table as jtrim
from spark_rapids_jni_tpu_torch.columnar import Table
from spark_rapids_jni_tpu_torch.ops import planner
from spark_rapids_jni_tpu_torch.ops.table_ops import trim_table
from torch_parity import (
    EDGE_ROWS,
    arrow_strings,
    assert_same_array,
    assert_same_table,
    assert_same_valid_table,
    jax_table,
    seeded_days,
    to_port,
)

T = jt.TypeId
FLAGS = ["A", "N", "R"]


def host_table(n: int, seed: int) -> list:
    """l_shipdate-like days in 1992-1998 (null tail), a STRING flag, an
    INT64 key of ~n/3 values, INT64 and DECIMAL64 values."""
    rng = np.random.default_rng(seed)
    valid = rng.random(n) > 0.1
    valid[-max(1, n // 9):] = False
    flags = [FLAGS[i] for i in rng.integers(0, 3, n)]
    return [
        (int(T.TIMESTAMP_DAYS), 0,
         rng.integers(8035, 10591, n).astype(np.int32), valid),
        (int(T.STRING), 0, arrow_strings(flags)[:2], rng.random(n) > 0.05),
        (int(T.INT64), 0, rng.integers(0, max(1, n // 3), n), None),
        (int(T.INT64), 0, rng.integers(-10**9, 10**9, n),
         rng.random(n) > 0.2),
        (int(T.DECIMAL64), -2, rng.integers(1, 10**7, n), None),
    ]


def _domains(port: bool, with_months: bool):
    mod = planner if port else jplanner
    months = mod.month_domain(1992, 1, 1998, 12) if with_months else None
    return [months, mod.string_domain(FLAGS)]


def _trimmed(got, want):
    k = int(np.asarray(want.present).sum())
    assert int(got.present.sum()) == k
    assert_same_array(got.present.numpy(), want.present)
    return trim_table(got.table, k), jtrim(want.table, k)


@pytest.mark.parametrize("n", EDGE_ROWS)
def test_month_buckets_match_reference(n):
    days = seeded_days(n, n)
    valid = np.random.default_rng(n).random(n) > 0.2
    jtab = jax_table([(int(T.TIMESTAMP_DAYS), 0, days, valid)])
    assert_same_table(Table([planner.month_bucket(to_port(jtab).column(0))]),
                      JTable([jplanner.month_bucket(jtab.column(0))]))
    assert planner.month_code(1995, 3) == jplanner.month_code(1995, 3)
    assert planner.month_domain(1992, 11, 1993, 2) == tuple(
        jplanner.month_domain(1992, 11, 1993, 2))
    with pytest.raises(ValueError):
        planner.month_domain(1993, 2, 1992, 11)


@pytest.mark.parametrize("n", [1, 256, 2049])
def test_monthly_rollup_takes_the_bounded_plan(n):
    """(month_bucket(day), flag) with 84 months and 3 flags: the bounded
    plan, as the reference's."""
    jtab = jax_table(host_table(n, n))
    ptab = to_port(jtab)
    aggs = [(3, "sum"), (3, "mean"), (3, "min"), (4, "max"), (3, "count")]

    def keyed(tab, mod):
        cols = list(tab.columns)
        cols[0] = mod.month_bucket(cols[0])
        return type(tab)(cols)

    got = planner.plan_groupby(keyed(ptab, planner), [0, 1], aggs,
                               _domains(True, True))
    want = jplanner.plan_groupby(keyed(jtab, jplanner), [0, 1], aggs,
                                 _domains(False, True))
    assert got.lowered == want.lowered == "bounded"
    assert_same_table(got.table, want.table)
    assert_same_array(got.present.numpy(), want.present)


@pytest.mark.parametrize("n", [255, 2048])
def test_general_lowering_matches_reference(n):
    jtab = jax_table(host_table(n, n + 1))
    ptab = to_port(jtab)
    # a key with no domain; a domain whose slots pass the budget (and
    # the groups too: overflowed); an aggregate outside the single-pass
    # set
    cases = [([2, 1], [(3, "sum"), (4, "mean"), (3, "max")], [None, 1], 4096),
             ([0, 1], [(3, "sum"), (3, "count")], [0, 1], 100),
             ([1], [(3, "nunique"), (3, "first")], [1], 4096)]
    for keys, aggs, dom_pos, budget in cases:
        pd = [None if p is None else _domains(True, True)[p] for p in dom_pos]
        jd = [None if p is None else _domains(False, True)[p] for p in dom_pos]
        got = planner.plan_groupby(ptab, keys, aggs, pd, budget=budget)
        want = jplanner.plan_groupby(jtab, keys, aggs, jd, budget=budget)
        assert got.lowered == want.lowered == "general"
        assert bool(got.overflowed) == bool(want.overflowed) == (budget < n)
        assert not bool(got.domain_miss)
        assert_same_valid_table(*_trimmed(got, want))


def test_general_lowering_row_valid_and_overflow():
    n = 2049
    jtab = jax_table(host_table(n, 9))
    ptab = to_port(jtab)
    rv = np.random.default_rng(9).random(n) > 0.3
    aggs = [(3, "sum"), (4, "max"), (3, "var")]
    got = planner.plan_groupby(ptab, [2], aggs, [None],
                               row_valid=torch.from_numpy(rv))
    want = jplanner.plan_groupby(jtab, [2], aggs, [None],
                                 row_valid=jnp.asarray(rv))
    g, w = _trimmed(got, want)
    # var: float64 sums in another order
    np.testing.assert_allclose(g.column(3).data.numpy(),
                               np.asarray(w.column(3).data), rtol=1e-9)
    assert_same_valid_table(type(g)(g.columns[:3]), type(w)(w.columns[:3]))
    # a budget under the group count drops groups and says so
    got = planner.plan_groupby(ptab, [2], aggs[:2], [None], budget=64)
    want = jplanner.plan_groupby(jtab, [2], aggs[:2], [None], budget=64)
    assert bool(got.overflowed) and bool(want.overflowed)
    assert_same_valid_table(*_trimmed(got, want))


@pytest.mark.parametrize("budget,max_budget,n", [
    (16, None, 60), (8, 4096, 60), (0, None, 12)])
def test_plan_groupby_auto_matches_reference(budget, max_budget, n):
    # 20 (4) groups: the budget grows 16 -> 32, 8 -> 16 -> 32, and a
    # budget of 0 starts at 1
    jtab = jax_table(host_table(n, 4))
    aggs = [(3, "sum"), (4, "min")]
    got = planner.plan_groupby_auto(to_port(jtab), [2], aggs, [None],
                                    budget=budget, max_budget=max_budget)
    want = jplanner.plan_groupby_auto(jtab, [2], aggs, [None], budget=budget,
                                      max_budget=max_budget)
    assert got.table.num_rows == want.table.num_rows
    assert_same_valid_table(*_trimmed(got, want))
    # fewer slots than groups at the cap
    with pytest.raises(planner.PlanBudgetExceeded):
        planner.plan_groupby_auto(to_port(jtab), [2], aggs, [None],
                                  budget=1, max_budget=2)
    assert issubclass(planner.PlanBudgetExceeded, ValueError)
