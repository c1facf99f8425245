"""The port's resilience layer (``runtime/resilience.py``,
``runtime/faults.py``) against the JAX package's: the taxonomy classifies
each class, and a ``torch.OutOfMemoryError``, as the reference classifies
its own and XLA's memory exhaustion; ``retrying``'s and ``escalate``'s
schedules and their ``resilience`` events equal the reference's; seeded
fault scripts fire at the same seams and sequence numbers; the plan
walk's ``fusion.region`` seam replays a transient fault; the groupby,
join and planner auto loops give the plain loops' results through
``escalate``. Tolerance: exact everywhere."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu import telemetry as jtelemetry
from spark_rapids_jni_tpu.runtime import faults as jfaults
from spark_rapids_jni_tpu.runtime import resilience as jres
from spark_rapids_jni_tpu.runtime.memory import (
    MemoryLimitExceeded as JMemoryLimitExceeded,
)
from spark_rapids_jni_tpu.utils import config as jconfig
from spark_rapids_jni_tpu_torch import errors, telemetry
from spark_rapids_jni_tpu_torch.columnar import Column, Table
from spark_rapids_jni_tpu_torch.models import tpch
from spark_rapids_jni_tpu_torch.ops.groupby import groupby_aggregate_auto
from spark_rapids_jni_tpu_torch.ops.join import join_auto
from spark_rapids_jni_tpu_torch.ops.planner import (
    PlanBudgetExceeded,
    plan_groupby_auto,
)
from spark_rapids_jni_tpu_torch.runtime import faults, fusion, resilience
from spark_rapids_jni_tpu_torch.runtime.memory import MemoryLimitExceeded
from spark_rapids_jni_tpu_torch.utils import config
from torch_ooc import port_events, reference_events

TAXONOMY = ("TransientDeviceError", "CapacityOverflow", "ResourceExhausted",
            "TransportError", "CorruptDataError", "MalformedInputError",
            "FatalExecutionError", "QueryCancelled", "ReplicaDeadError")


@pytest.fixture(autouse=True)
def _reset():
    telemetry.reset()
    jtelemetry.drain()
    jconfig.set_option("telemetry.enabled", True)
    yield
    jtelemetry.drain()
    for name in ("resilience.enabled", "resilience.max_attempts",
                 "resilience.growth", "telemetry.enabled"):
        jconfig.reset_option(name)
    for name in ("resilience.enabled", "resilience.max_attempts",
                 "resilience.growth"):
        config.reset_option(name)


def _both(name):
    return getattr(resilience, name), getattr(jres, name)


@pytest.mark.parametrize("name", TAXONOMY)
def test_taxonomy_classifies_as_the_reference(name):
    cls, jcls = _both(name)
    exc, jexc = cls("x", rows=3), jcls("x", rows=3)
    assert resilience.classify(exc) is cls
    assert jres.classify(jexc) is jcls
    assert resilience.is_transient(exc) == jres.is_transient(jexc)
    assert str(exc) == str(jexc) and exc.context == jexc.context
    assert isinstance(exc, resilience.ResilienceError)


@pytest.mark.parametrize("make", [
    lambda: MemoryError(), lambda: RuntimeError("RESOURCE_EXHAUSTED: hbm"),
    lambda: RuntimeError("?"), lambda: ValueError("bad"),
    lambda: ConnectionError("reset"), lambda: EOFError()],
    ids=["memory", "marker", "runtime", "value", "socket", "eof"])
def test_foreign_exceptions_classify_as_the_reference(make):
    exc = make()
    assert resilience.classify(exc).__name__ == jres.classify(exc).__name__
    assert resilience.is_transient(exc) == jres.is_transient(exc) is False


def test_memory_exhaustion_is_resource_exhausted():
    assert resilience.classify(MemoryLimitExceeded("over")) \
        is resilience.ResourceExhausted
    assert jres.classify(JMemoryLimitExceeded("over")) is jres.ResourceExhausted
    # the caching allocator's refusal is a RuntimeError, not a MemoryError
    oom = torch.OutOfMemoryError("CUDA out of memory. Tried to allocate")
    assert not isinstance(oom, MemoryError)
    assert resilience.classify(oom) is resilience.ResourceExhausted
    assert not resilience.is_transient(oom)


def test_malformed_input_is_the_taxonomy_class():
    assert errors.MalformedInputError is resilience.MalformedInputError
    with pytest.raises(resilience.ResilienceError):
        raise errors.MalformedInputError("bad file", op="footer")
    assert not resilience.is_transient(errors.MalformedInputError("x"))


def test_worker_exit_waits_for_the_fleet():
    with pytest.raises(NotImplementedError, match="entries 11-12"):
        resilience.classify_worker_exit(-9)


def _flaky(pkg, fails: int):
    calls = []

    def fn():
        calls.append(1)
        if len(calls) <= fails:
            raise pkg.TransientDeviceError("flaky device")
        return "ok"

    return fn, calls


@pytest.mark.parametrize("fails", [0, 1, 3])
def test_retrying_schedule_and_events_equal_the_reference(fails):
    fn, calls = _flaky(resilience, fails)
    jfn, jcalls = _flaky(jres, fails)
    assert resilience.retrying("t", fn, seam="outofcore.chunk") == "ok"
    assert jres.retrying("t", jfn, seam="outofcore.chunk") == "ok"
    assert len(calls) == len(jcalls) == fails + 1
    assert port_events("resilience") == reference_events("resilience")
    assert telemetry.counter("resilience.retry") == fails


def test_retrying_exhaustion_equals_the_reference():
    config.set_option("resilience.max_attempts", 3)
    jconfig.set_option("resilience.max_attempts", 3)
    fn, _ = _flaky(resilience, 10)
    jfn, _ = _flaky(jres, 10)
    with pytest.raises(resilience.FatalExecutionError) as ei:
        resilience.retrying("t", fn, seam="outofcore.merge", chunk=2)
    with pytest.raises(jres.FatalExecutionError) as ej:
        jres.retrying("t", jfn, seam="outofcore.merge", chunk=2)
    assert str(ei.value) == str(ej.value)
    assert isinstance(ei.value.__cause__, resilience.TransientDeviceError)
    assert port_events("resilience") == reference_events("resilience")


def test_retrying_passes_foreign_and_disabled_through():
    original = ValueError("not ours")

    def boom():
        raise original

    with pytest.raises(ValueError) as ei:
        resilience.retrying("t", boom, seam="outofcore.chunk")
    assert ei.value is original
    config.set_option("resilience.enabled", False)
    fn, calls = _flaky(resilience, 1)
    with pytest.raises(resilience.TransientDeviceError):
        resilience.retrying("t", fn, seam="outofcore.chunk")
    assert len(calls) == 1 and telemetry.events() == []
    assert resilience.retry_or_none("t", lambda: 5, seam="s") == (5, None)
    got, exc = resilience.retry_or_none("t", boom, seam="s")
    assert got is None and exc is original


ESCALATIONS = [
    # (initial, growth, max_capacity, needs more below, required)
    (2, 4, 100, 10**9, None),
    (4, 2, None, 77, 77),
    (3, 4, 50, 40, None),
    (1, 2, 8, 5, None),
]


@pytest.mark.parametrize("initial,growth,cap,below,required", ESCALATIONS)
def test_escalate_schedule_and_events_equal_the_reference(
        initial, growth, cap, below, required):
    def run(pkg):
        caps = []

        def attempt(c):
            caps.append(c)
            return ("done", c), c < below, required

        try:
            out = pkg.escalate("t", attempt, seam="dispatch.execute",
                               initial=initial, growth=growth,
                               max_capacity=cap, rows=9)
        except pkg.FatalExecutionError as exc:
            out = str(exc)
        return caps, out

    assert run(resilience) == run(jres)
    assert port_events("resilience") == reference_events("resilience")


def test_escalate_exhaust_keeps_the_site_exception():
    with pytest.raises(PlanBudgetExceeded, match="site says no"):
        resilience.escalate(
            "t", lambda c: (None, True, None), seam="dispatch.execute",
            initial=2, max_capacity=4,
            exhaust=lambda c, steps: PlanBudgetExceeded("site says no"))


def _drive(pkg, script, n=40):
    hits = []
    with pkg.inject(script):
        for seq in range(n):
            for seam in ("outofcore.chunk", "pipeline.decode"):
                try:
                    pkg.fire(seam, seq)
                except RuntimeError:
                    hits.append((seam, seq))
    return hits, script.fired


@pytest.mark.parametrize("seed,rate,max_faults", [
    (42, 0.3, None), (7, 0.5, 5), (1, 1.0, 3), (3, 0.0, None)])
def test_seeded_fault_scripts_fire_as_the_reference(seed, rate, max_faults):
    def script(pkg):
        return pkg.FaultScript(
            [pkg.FaultSpec("pipeline.decode", RuntimeError, seq=4)],
            seed=seed, rate=rate, seams=["outofcore.chunk"],
            max_faults=max_faults)

    assert _drive(faults, script(faults)) == _drive(jfaults, script(jfaults))
    assert faults.active_injector() is None


def test_fault_registry_counts_nests_and_rejects_unknown_seams():
    with pytest.raises(ValueError, match="unknown fault seam"):
        faults.FaultSpec("not.a.seam", RuntimeError)
    with pytest.raises(ValueError, match="unknown fault seam"):
        with faults.inject(lambda *a: None):
            faults.fire("not.a.seam", 0)
    outer, inner = [], []
    with faults.inject(lambda s, q, c: outer.append((s, q))):
        with faults.inject(lambda s, q, c: inner.append((s, q))):
            faults.fire("memory.reserve", 1)
        faults.fire("memory.reserve", 2)
    assert (inner, outer) == ([("memory.reserve", 1)],
                              [("memory.reserve", 2)])
    script = faults.FaultScript(
        [faults.FaultSpec("spill.spill", resilience.TransientDeviceError)])
    with faults.inject(script):
        with pytest.raises(resilience.TransientDeviceError):
            faults.fire("spill.spill", 7)
        faults.fire("spill.spill", 8)
    assert script.fired == [("spill.spill", 7)]
    assert telemetry.counter("faults.injected.spill.spill") == 1


def test_cancel_token_checks_and_fires_its_seam():
    token = resilience.CancelToken(label="q")
    seen = []
    with faults.inject(lambda s, q, c: seen.append((s, q, c["where"]))):
        token.check("a")
        token.cancel("caller")
        with pytest.raises(resilience.QueryCancelled, match="cancelled at b"):
            token.check("b")
    assert seen == [("server.cancel", 1, "a"), ("server.cancel", 2, "b")]
    late = resilience.CancelToken(deadline_ms=1)
    import time

    time.sleep(0.01)
    assert late.cancelled() and late.event.is_set()
    assert late.remaining_s() == 0.0


@pytest.fixture(scope="module")
def small_lineitem():
    return tpch.lineitem_table(2049, seed=5, device="cpu")


def _same(a: Table, b: Table) -> None:
    assert a.num_rows == b.num_rows
    for x, y in zip(a.columns, b.columns):
        assert x.dtype == y.dtype
        assert torch.equal(x.valid_mask(), y.valid_mask())
        v = x.valid_mask()
        assert torch.equal(x.data[v], y.data[v])


def test_plan_walk_replays_a_transient_region_fault(small_lineitem):
    plan, binding = tpch._q1_planned_plan(), {"lineitem": small_lineitem}
    want = fusion.execute(plan, binding).table
    script = faults.FaultScript([faults.FaultSpec(
        "fusion.region", resilience.TransientDeviceError, times=2)])
    with faults.inject(script):
        got = fusion.execute(plan, binding).table
    _same(got, want)
    assert [e[1] for e in port_events("resilience")] == \
        ["retry", "retry", "recovered"]
    assert {e[2] for e in port_events("resilience")} == {"fusion.region"}
    # not transient, or resilience off: the fault propagates, no rung
    for exc, enabled in ((resilience.ResourceExhausted, True),
                         (resilience.TransientDeviceError, False)):
        config.set_option("resilience.enabled", enabled)
        with faults.inject(faults.FaultScript(
                [faults.FaultSpec("fusion.region", exc)])):
            with pytest.raises(exc):
                fusion.execute(plan, binding)


def test_exhausted_region_retries_raise_fatal(small_lineitem):
    config.set_option("resilience.max_attempts", 2)
    with faults.inject(faults.FaultScript([faults.FaultSpec(
            "fusion.region", resilience.TransientDeviceError, times=5)])):
        with pytest.raises(resilience.FatalExecutionError,
                           match="retries exhausted after 2"):
            fusion.execute(tpch._q1_plan(),
                           {"lineitem": small_lineitem})


def _keyed_table(n: int, groups: int) -> Table:
    rng = np.random.default_rng(groups)
    return Table([
        Column.from_numpy(rng.integers(0, groups, n).astype(np.int64),
                          device="cpu"),
        Column.from_numpy(rng.integers(-50, 50, n).astype(np.int64),
                          device="cpu")])


def test_groupby_auto_escalates_on_the_plain_schedule():
    tab = _keyed_table(500, 200)
    aggs = [(1, "sum"), (1, "count")]
    got = groupby_aggregate_auto(tab, [0], aggs, initial_max_groups=4)
    caps = [e["capacity"] for e in telemetry.events("resilience")
            if e["event"] == "escalate"]
    assert caps == [16, 64, 256]
    assert port_events("resilience")[-1][1] == "recovered"
    config.set_option("resilience.enabled", False)
    plain = groupby_aggregate_auto(tab, [0], aggs, initial_max_groups=4)
    _same(got.table, plain.table)
    distinct = len(np.unique(tab.column(0).data.numpy()))
    assert int(got.num_groups) == int(plain.num_groups) == distinct


def test_join_auto_jumps_to_the_reported_total():
    left, right = _keyed_table(300, 20), _keyed_table(200, 20)
    maps, tab = join_auto(left, right, 0, 0, initial_out_size=8)
    caps = [e["capacity"] for e in telemetry.events("resilience")
            if e["event"] == "escalate"]
    total = int(maps.total)
    assert caps == [total] and total > 32
    config.set_option("resilience.enabled", False)
    pmaps, ptab = join_auto(left, right, 0, 0, initial_out_size=8)
    assert int(pmaps.total) == total
    _same(tab, ptab)


def test_plan_budget_exhaustion_is_fatal_and_a_value_error():
    from spark_rapids_jni_tpu_torch.ops.planner import scalar_domain

    tab = _keyed_table(400, 300)
    with pytest.raises(PlanBudgetExceeded, match="max_budget=64") as ei:
        plan_groupby_auto(tab, [0], [(1, "sum")], [None], budget=4,
                          max_budget=64)
    assert isinstance(ei.value, ValueError)
    assert isinstance(ei.value, resilience.FatalExecutionError)
    assert resilience.classify(ei.value) is PlanBudgetExceeded
    caps = [e["capacity"] for e in telemetry.events("resilience")
            if e["event"] == "escalate"]
    assert caps == [8, 16, 32, 64]
    res = plan_groupby_auto(tab, [0], [(1, "sum")],
                            [scalar_domain(tuple(range(300)))], budget=4)
    assert not bool(res.overflowed)
