"""The port's serving runtime (``runtime/server.py``) against the JAX
package's.

- Sessions submitting q1, planned q1, q3 and q6 at once, two queries in
  flight, get ``fusion.execute``'s bits and the reference's
  ``execute``'s.
- With one worker and a scripted submission sequence, the order in which
  sessions run equals the reference server's (round robin: a light
  session is not starved behind a heavy one's backlog).
- Refusals are classified: an estimate over the whole budget and a full
  queue reject (``QueryRejected``), a deadline that expires while the
  query waits behind a blocked worker resolves ``cancelled``, a failing
  query resolves ``failed``; a pressure failure steps the ladder to the
  out-of-core tier with the same rows.
- The learned-estimate file merges two writers and discards a corrupt
  file; ``warmup`` replays the costliest signature through its builder.
- A host-decoded chunk binding is staged to the same table.
- ``limiter.used`` is 0 after every success, failure and cancel.

Every wait carries its own time limit (``result(timeout=)``,
``join(timeout=)``, ``Event.wait(timeout)``). Inputs are made from seeds
with numpy. Tolerance: exact everywhere."""

from __future__ import annotations

import json
import threading
import time

import pytest
import torch

from spark_rapids_jni_tpu.models import tpch as jtpch
from spark_rapids_jni_tpu.runtime import faults as jfaults
from spark_rapids_jni_tpu.runtime import fusion as jfusion
from spark_rapids_jni_tpu.runtime import server as jserver
from spark_rapids_jni_tpu.runtime.memory import MemoryLimiter as JLimiter
from spark_rapids_jni_tpu.telemetry import REGISTRY as JREGISTRY
from spark_rapids_jni_tpu.utils import config as jconfig
from spark_rapids_jni_tpu_torch import telemetry
from spark_rapids_jni_tpu_torch.columnar import Column, Table
from spark_rapids_jni_tpu_torch.models import tpch
from spark_rapids_jni_tpu_torch.runtime import (
    degrade,
    faults,
    fusion,
    resilience,
    server,
)
from spark_rapids_jni_tpu_torch.runtime.memory import (
    MemoryLimiter,
    host_table_chunk,
)
from spark_rapids_jni_tpu_torch.telemetry import spans, top
from spark_rapids_jni_tpu_torch.utils import config
from torch_parity import (
    assert_same_valid_table,
    jax_table,
    ref_execute,
    with_null_tails,
)

WAIT_S = 60  # seconds a ticket, a join or an event may take


@pytest.fixture(autouse=True)
def _reset():
    telemetry.reset()
    JREGISTRY.reset()
    yield
    for name in ("server.estimate_path", "server.estimate_save_interval_s",
                 "degrade.chunk_rows", "telemetry.enabled"):
        config.reset_option(name)


def _q6_plan(fz, reduce_fn):
    return fz.Plan("tpch_q6", fz.Project(fz.Scan("lineitem"), reduce_fn,
                                         rowwise=False))


def _queries(n, seed):
    """(port plan, port bindings, reference plan, reference bindings)
    of q1, planned q1, q3 and q6 over ``n`` lineitem rows."""
    li, jli = with_null_tails(jtpch.lineitem_table(n, seed=seed),
                              (0, 3, 4, 6), seed=seed)
    tabs = [with_null_tails(tab, cols, seed=seed) for tab, cols in (
        (jtpch.customer_table(20, seed=seed), ()),
        (jtpch.orders_table(200, 20, seed=seed + 1), (2,)),
        (jtpch.lineitem_q3_table(n, 200, seed=seed + 2), (0, 1)))]
    q3 = dict(zip(("customer", "orders", "lineitem"), (p for p, _ in tabs)))
    jq3 = dict(zip(("customer", "orders", "lineitem"), (r for _, r in tabs)))
    return [
        (tpch._q1_plan(), {"lineitem": li}, jtpch._q1_plan(),
         {"lineitem": jli}),
        (tpch._q1_planned_plan(), {"lineitem": li}, None, None),
        (tpch._q3_plan(0, tpch._Q3_CUTOFF_DAYS, 2), q3,
         jtpch._q3_plan(0, jtpch._Q3_CUTOFF_DAYS, 2), jq3),
        (_q6_plan(fusion, tpch._q6_reduce), {"lineitem": li},
         _q6_plan(jfusion, jtpch._q6_reduce), {"lineitem": jli}),
    ]


def test_concurrent_sessions_equal_execute_and_the_reference():
    n = 257
    queries = _queries(n, 5)
    results = []
    with server.QueryServer(budget_bytes=1 << 28, max_inflight=2) as srv:
        for _ in range(2):  # the second round is served from the cache
            tickets = [(srv.session(f"s{i % 3}").submit(q[0], q[1]), q)
                       for i, q in enumerate(queries)]
            results += [(tk.result(timeout=WAIT_S), q) for tk, q in tickets]
        stats = srv.stats()
    for res, (plan, b, jplan, jb) in results:
        assert res.table.equals(fusion.execute(plan, b).table)
        if jplan is not None:
            assert_same_valid_table(res.table,
                                    ref_execute(jplan, jb, n).table)
    assert stats["served"] == 8 and stats["cache"]["hits"] == 4
    assert srv.limiter.used == 0


def _ident(tab):
    return tab


def _run_order(srv_mod, faults_mod, limiter, plan, table):
    """Sessions ``heavy`` (a query held at admission, then a backlog of
    three) and ``light`` (one query) on one worker: the order the
    ``server.execute`` seam sees them."""
    order = []
    picked = threading.Event()

    def probe(seam, seq, ctx):
        if seam == "server.admit":
            picked.set()
        elif seam == "server.execute":
            order.append(ctx["session"])

    with faults_mod.inject(probe):
        with srv_mod.QueryServer(limiter=limiter, max_inflight=1,
                                 admission_timeout_s=WAIT_S) as srv:
            heavy, light = srv.session("heavy"), srv.session("light")
            first = heavy.submit(plan, {"t": table}, estimate_bytes=100)
            assert picked.wait(WAIT_S)
            backlog = [heavy.submit(plan, {"t": table}, estimate_bytes=100)
                       for _ in range(3)]
            lone = light.submit(plan, {"t": table}, estimate_bytes=100)
            limiter.release(990)
            for tk in [first, lone] + backlog:
                tk.result(timeout=WAIT_S)
    return order


def test_round_robin_order_equals_the_reference():
    # the cache off in both, so every repeat runs
    config.set_option("cache.enabled", False)
    jconfig.set_option("cache.enabled", False)
    try:
        values = torch.arange(64).numpy()
        host = [(int(Column.from_numpy(values, device="cpu").dtype.type_id),
                 0, values, None)]
        lim, jlim = MemoryLimiter(1000), JLimiter(1000)
        lim.reserve(990)
        jlim.reserve(990)
        got = _run_order(server, faults, lim,
                         fusion.Plan("rr", fusion.Project(fusion.Scan("t"),
                                                          _ident)),
                         Table([Column.from_numpy(values, device="cpu")]))
        want = _run_order(jserver, jfaults, jlim,
                          jfusion.Plan("rr", jfusion.Project(
                              jfusion.Scan("t"), _ident)), jax_table(host))
    finally:
        config.reset_option("cache.enabled")
        jconfig.reset_option("cache.enabled")
    assert got == want == ["heavy", "light", "heavy", "heavy", "heavy"]
    assert lim.used == 0 and jlim.used == 0


def test_rejections_cancellation_and_failure_are_classified():
    li = tpch.lineitem_table(600, device="cpu")
    plan, b = tpch._q1_planned_plan(), {"lineitem": li}
    release = threading.Event()
    entered = threading.Event()

    def block(seam, seq, ctx):
        if seam == "server.execute" and ctx["session"] == "blocker":
            entered.set()
            assert release.wait(WAIT_S)

    with faults.inject(block):
        with server.QueryServer(budget_bytes=1 << 26, max_inflight=1,
                                queue_depth=1) as srv:
            big = srv.session("a").submit(plan, b, estimate_bytes=1 << 30)
            with pytest.raises(server.QueryRejected) as err:
                big.result(timeout=WAIT_S)
            assert err.value.retry_after_s is None and "whole budget" in \
                err.value.reason and big.status == "rejected"
            blocker = srv.session("blocker").submit(plan, b)
            assert entered.wait(WAIT_S)
            late = srv.session("late").submit(plan, b, deadline_ms=50)
            full = srv.session("late").submit(plan, b)
            with pytest.raises(server.QueryRejected) as err:
                full.result(timeout=WAIT_S)
            assert "queue full" in err.value.reason
            assert err.value.retry_after_s > 0
            snap = srv.inspect()
            assert [q["session"] for q in snap["inflight"]] == ["blocker"]
            assert "blocker" in top.render_top(snap)
            time.sleep(0.2)                       # the deadline expires
            release.set()
            with pytest.raises(resilience.QueryCancelled):
                late.result(timeout=WAIT_S)
            assert late.status == "cancelled"
            blocker.result(timeout=WAIT_S)
            bad = srv.session("a").submit(plan, {"lineitem": Table(
                li.columns[:2])})
            with pytest.raises(IndexError):
                bad.result(timeout=WAIT_S)
            assert bad.status == "failed"
    # (the served results' cache entries hold their charges until close)
    assert srv.limiter.used == 0
    stats = srv.session_stats("late")
    assert (stats["rejected"], stats["cancelled"]) == (1, 1)
    assert srv.stats()["failed"] == 1
    assert [e["event"] for e in telemetry.events("server")
            if e["session"] == "late"] == [
        "submitted", "queued", "submitted", "rejected", "cancelled"]


def test_pressure_failure_steps_the_ladder_to_the_same_rows():
    li = tpch.lineitem_table(4096, device="cpu")
    plan, b = tpch._q1_planned_plan(), {"lineitem": li}
    want = fusion.execute(plan, b).table
    partial_fn, merge_fn = tpch.q1_row_chunked_fns()
    config.set_option("degrade.chunk_rows", 1024)
    config.set_option("telemetry.enabled", True)
    script = faults.FaultScript([faults.FaultSpec(
        "fusion.region", resilience.ResourceExhausted("injected"))])
    with faults.inject(script):
        with server.QueryServer(budget_bytes=1 << 26) as srv:
            res = srv.session("x").submit(
                plan, b, outofcore=lambda bind, lim: degrade.row_chunked_tier(
                    bind, "lineitem", partial_fn, merge_fn,
                    limiter=lim)).result(timeout=WAIT_S)
    assert res.meta == {"degrade.chunk_rows": 1024}
    for got, exp in zip(res.table.columns, want.columns):
        assert torch.equal(got.data[:6], exp.data[:6])
        assert torch.equal(got.valid_mask()[:6], exp.valid_mask()[:6])
    assert telemetry.counter("degrade.step") == 1
    assert srv.stats()["degrade_steps"] == 1
    recs = telemetry.events("span")
    assert spans.validate(recs) == []
    assert {r["op"]: r["status"] for r in recs}["query.tpch_q1_planned"] \
        == "degraded"
    assert srv.limiter.used == 0


def test_learned_estimates_merge_warm_up_and_discard_corruption(tmp_path):
    path = tmp_path / "learned.json"
    config.set_option("server.estimate_path", str(path))
    config.set_option("server.estimate_save_interval_s", 0.0)
    li = tpch.lineitem_table(600, device="cpu")
    for plan in (tpch._q1_planned_plan(), _q6_plan(fusion, tpch._q6_reduce)):
        with server.QueryServer(budget_bytes=1 << 26) as srv:
            srv.session("s").submit(plan, {"lineitem": li}).result(
                timeout=WAIT_S)
    learned = json.loads(path.read_text())
    assert sorted(learned) == ["tpch_q1_planned@1024", "tpch_q6@1024"]
    rows = []
    server.register_warmup_builder("tpch_q6", rows.append)
    try:
        path.write_text(json.dumps({"tpch_q6@1024": learned["tpch_q6@1024"],
                                    "unknown@64": 1e12, "tpch_q6@0": 1e11}))
        with server.QueryServer(budget_bytes=1 << 26) as srv:
            summary = srv.warmup(top_n=3)
            assert srv.warmup(top_n=0)["attempted"] == 0
    finally:
        server.register_warmup_builder(
            "tpch_q6", lambda n: tpch.tpch_q6(tpch.lineitem_table(n)))
    assert summary == {"attempted": 1, "compiled": 1, "skipped": 2,
                       "failed": 0} and rows == [1024]
    path.write_text("{torn")
    with server.QueryServer(budget_bytes=1 << 26) as srv:
        assert srv.stats()["learned_signatures"] == 0
    assert telemetry.counter("server.estimate_state_discarded") == 1
    assert [e["trigger"] for e in telemetry.events("degrade")
            if e["event"] == "state_discarded"] == ["corrupt"]


def test_host_chunk_binding_is_staged_to_the_same_table():
    li = tpch.lineitem_table(700, device="cpu")
    snaps = [(c.dtype, c.data, c.validity, None, None) for c in li.columns]
    chunk = host_table_chunk(snaps, li.num_rows, "cpu")
    plan = _q6_plan(fusion, tpch._q6_reduce)
    with server.QueryServer(budget_bytes=1 << 26) as srv:
        got = srv.session("s").submit(plan, {"lineitem": chunk}).result(
            timeout=WAIT_S)
        assert srv._stage_bindings({"lineitem": chunk})["lineitem"].equals(
            li)
    assert got.table.equals(fusion.execute(plan, {"lineitem": li}).table)
    assert srv.limiter.used == 0
