"""The port's degradation ladder (``runtime/degrade.py``) against the JAX
package's, on q1 over the same lineitem: a classified pressure failure
steps the port fused -> outofcore (rung 0 -> 2) where the reference
steps fused -> staged -> outofcore, and the ``degrade`` events and the
observer's calls equal the reference's with rung 1 left out; the answer
equals the in-memory plan's valid rows bit for bit; the chunk halves on
a further failure, the parked rung waits for the drain, exhaustion
re-raises the original failure, a cancel passes straight through, and
``degrade.enabled=false`` is a plain ``fusion.execute``. A
``torch.OutOfMemoryError`` triggers the ladder as ``ResourceExhausted``.
Every wait carries its own time limit. Tolerance: exact everywhere."""

from __future__ import annotations

import threading

import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu import telemetry as jtelemetry
from spark_rapids_jni_tpu.runtime import degrade as jdegrade
from spark_rapids_jni_tpu.runtime import faults as jfaults
from spark_rapids_jni_tpu.runtime import resilience as jres
from spark_rapids_jni_tpu.runtime.memory import MemoryLimiter as JLimiter
from spark_rapids_jni_tpu.utils import config as jconfig
from spark_rapids_jni_tpu_torch import telemetry
from spark_rapids_jni_tpu_torch.columnar.column import string_column
from spark_rapids_jni_tpu_torch.columnar import Table
from spark_rapids_jni_tpu_torch.models import tpch
from spark_rapids_jni_tpu_torch.runtime import degrade, faults, fusion
from spark_rapids_jni_tpu_torch.runtime import resilience
from spark_rapids_jni_tpu_torch.runtime.memory import MemoryLimiter
from spark_rapids_jni_tpu_torch.utils import config
from torch_ooc import port_events, reference_events
from torch_parity import jax_table

ROWS = 2048
CHUNK_ROWS = 512
OPTIONS = ("degrade.enabled", "degrade.max_steps", "degrade.chunk_rows",
           "degrade.park_timeout_s")


@pytest.fixture(autouse=True)
def _reset():
    telemetry.reset()
    jtelemetry.drain()
    jconfig.set_option("telemetry.enabled", True)
    for pkg in (config, jconfig):
        pkg.set_option("degrade.chunk_rows", CHUNK_ROWS)
    yield
    jtelemetry.drain()
    for name in OPTIONS:
        config.reset_option(name)
        jconfig.reset_option(name)
    jconfig.reset_option("telemetry.enabled")


@pytest.fixture(scope="module")
def lineitem():
    return tpch.lineitem_table(ROWS, seed=3, device="cpu")


def _valid_rows(table) -> list:
    """The rows whose two key columns are valid, as bytes per column."""
    cols = [(c.data.numpy(), c.valid_mask().numpy()) for c in table.columns]
    keep = cols[0][1] & cols[1][1]
    return [tuple(d[r].tobytes() if v[r] else None for d, v in cols)
            for r in np.flatnonzero(keep)]


def _ref_valid_rows(jtable) -> list:
    cols = [(np.asarray(c.data), np.asarray(c.valid_mask()))
            for c in jtable.columns]
    keep = cols[0][1] & cols[1][1]
    return [tuple(d[r].tobytes() if v[r] else None for d, v in cols)
            for r in np.flatnonzero(keep)]


def _query(li, limiter, plan=None):
    partial_fn, merge_fn = tpch.q1_row_chunked_fns()
    runner = degrade.row_chunked_tier({"lineitem": li}, "lineitem",
                                      partial_fn, merge_fn, limiter=limiter)
    return degrade.DegradableQuery(plan or tpch._q1_plan(),
                                   {"lineitem": li}, outofcore=runner)


def _pressure_script(pkg, *seqs, exc=None):
    """A ResourceExhausted (a distinct instance each) at the
    ``fusion.region`` firings ``seqs``."""
    return pkg.FaultScript([pkg.FaultSpec(
        "fusion.region", exc or pkg_res(pkg).ResourceExhausted(
            f"injected pressure {s}"), seq=s) for s in seqs])


def pkg_res(pkg):
    return resilience if pkg is faults else jres


@pytest.fixture(scope="module")
def reference_ladder():
    """The reference's ladder over the same lineitem: fused and staged
    both fail (the region seam fires 0 and 1), the out-of-core rung
    answers; its events, observer calls and valid rows."""
    from spark_rapids_jni_tpu.models import tpch as jtpch

    jconfig.set_option("telemetry.enabled", True)
    jconfig.set_option("degrade.chunk_rows", CHUNK_ROWS)
    jtelemetry.drain()
    try:
        li = jtpch.lineitem_table(ROWS, seed=3)
        lim = JLimiter(1 << 24)
        partial_fn, merge_fn = jtpch.q1_row_chunked_fns()
        runner = jdegrade.row_chunked_tier({"lineitem": li}, "lineitem",
                                           partial_fn, merge_fn, limiter=lim)
        seen = []
        with jfaults.inject(_pressure_script(jfaults, 0, 1)):
            res = jdegrade.DegradationController(lim).execute(
                jdegrade.DegradableQuery(jtpch._q1_plan(), {"lineitem": li},
                                         outofcore=runner),
                observer=lambda *a: seen.append(a))
        return (reference_events("degrade"), seen,
                _ref_valid_rows(res.table), lim.used)
    finally:
        jconfig.reset_option("degrade.chunk_rows")


def test_pressure_steps_to_outofcore_as_the_reference(lineitem,
                                                      reference_ladder):
    lim = MemoryLimiter(1 << 24)
    seen = []
    with faults.inject(_pressure_script(faults, 0)):
        res = degrade.DegradationController(lim).execute(
            _query(lineitem, lim), observer=lambda *a: seen.append(a))
    events, jseen, jrows, jused = reference_ladder
    assert port_events("degrade") == [e for e in events if e[1] != "staged"]
    assert seen == [s for s in jseen if s[0] != "staged"]
    assert seen == [("fused", 0, 0, None), ("outofcore", 2, 2, CHUNK_ROWS)]
    assert telemetry.counter("degrade.step") == 1
    want = fusion.execute(tpch._q1_plan(), {"lineitem": lineitem}).table
    assert _valid_rows(res.table) == _valid_rows(want) == jrows
    assert res.meta == {"degrade.chunk_rows": CHUNK_ROWS}
    assert lim.used == jused == 0


def test_planned_q1_degrades_to_the_same_rows(lineitem):
    lim = MemoryLimiter(1 << 24)
    oom = torch.OutOfMemoryError("CUDA out of memory. Tried to allocate")
    with faults.inject(_pressure_script(faults, 0, exc=oom)):
        res = degrade.DegradationController(lim).execute(
            _query(lineitem, lim, tpch._q1_planned_plan()))
    assert [e[:2] for e in port_events("degrade")] == [
        ("step", "outofcore"), ("completed", "outofcore")]
    assert port_events("degrade")[0][2] == "ResourceExhausted"
    want = tpch.tpch_q1_planned(lineitem)
    assert _valid_rows(res.table) == _valid_rows(want)
    assert lim.used == 0


def test_further_pressure_halves_the_chunk(lineitem):
    lim = MemoryLimiter(1 << 24)
    seen = []
    script = faults.FaultScript([
        faults.FaultSpec("fusion.region", resilience.ResourceExhausted("a"),
                         seq=0),
        faults.FaultSpec("outofcore.chunk",
                         resilience.ResourceExhausted("b"), seq=1)])
    with faults.inject(script):
        res = degrade.DegradationController(lim).execute(
            _query(lineitem, lim), observer=lambda *a: seen.append(a))
    assert [s[3] for s in seen] == [None, CHUNK_ROWS, CHUNK_ROWS // 2]
    assert [(e[0], e[3]) for e in port_events("degrade")] == [
        ("step", 2), ("step", 3), ("completed", 3)]
    want = fusion.execute(tpch._q1_plan(), {"lineitem": lineitem}).table
    assert _valid_rows(res.table) == _valid_rows(want)
    assert lim.used == 0


def test_exhaustion_reraises_the_original(lineitem):
    config.set_option("degrade.max_steps", 2)
    lim = MemoryLimiter(1 << 24)
    first = resilience.ResourceExhausted("first")
    script = faults.FaultScript([
        faults.FaultSpec("fusion.region", first, seq=0),
        faults.FaultSpec("outofcore.chunk",
                         resilience.ResourceExhausted("again"), times=5)])
    with faults.inject(script):
        with pytest.raises(resilience.ResourceExhausted) as ei:
            degrade.DegradationController(lim).execute(_query(lineitem, lim))
    assert ei.value is first
    assert port_events("degrade")[-1][0] == "exhausted"
    assert lim.used == 0


def test_parked_rung_waits_for_the_drain_then_retries(lineitem):
    config.set_option("degrade.park_timeout_s", 20.0)
    lim = MemoryLimiter(1000, low_watermark=0.5)
    lim.reserve(900)
    query = degrade.DegradableQuery(tpch._q1_plan(), {"lineitem": lineitem})
    drain = threading.Timer(0.1, lim.release, (900,))
    drain.start()
    seen = []
    with faults.inject(_pressure_script(faults, 0)):
        res = degrade.DegradationController(lim).execute(
            query, observer=lambda *a: seen.append(a))
    drain.join(20)
    assert [s[:2] for s in seen] == [("fused", 0), ("parked", 2),
                                     ("fused", 0)]
    assert [e[0] for e in port_events("degrade")] == [
        "step", "parked", "resumed", "completed"]
    want = fusion.execute(tpch._q1_plan(), {"lineitem": lineitem}).table
    assert _valid_rows(res.table) == _valid_rows(want)


def test_parked_timeout_reraises_the_original(lineitem):
    config.set_option("degrade.park_timeout_s", 0.05)
    lim = MemoryLimiter(1000, low_watermark=0.5)
    lim.reserve(900)
    first = resilience.ResourceExhausted("held")
    with faults.inject(faults.FaultScript(
            [faults.FaultSpec("fusion.region", first)])):
        with pytest.raises(resilience.ResourceExhausted) as ei:
            degrade.DegradationController(lim).execute(degrade.DegradableQuery(
                tpch._q1_plan(), {"lineitem": lineitem}))
    assert ei.value is first
    assert port_events("degrade")[-1][:2] == ("exhausted", "parked")


def test_step_seam_injects_mid_degrade(lineitem):
    lim = MemoryLimiter(1 << 24)
    script = faults.FaultScript([
        faults.FaultSpec("fusion.region", resilience.ResourceExhausted("p")),
        faults.FaultSpec("degrade.step", RuntimeError("mid-degrade"))])
    with faults.inject(script):
        with pytest.raises(RuntimeError, match="mid-degrade"):
            degrade.DegradationController(lim).execute(_query(lineitem, lim))
    assert script.fired == [("fusion.region", 0), ("degrade.step", 2)]


@pytest.mark.parametrize("exc", [ValueError("not pressure"),
                                 resilience.QueryCancelled("stop")],
                         ids=["foreign", "cancelled"])
def test_other_failures_pass_straight_through(lineitem, exc):
    lim = MemoryLimiter(1 << 24)
    with faults.inject(faults.FaultScript(
            [faults.FaultSpec("fusion.region", exc)])):
        with pytest.raises(type(exc)) as ei:
            degrade.DegradationController(lim).execute(_query(lineitem, lim))
    assert ei.value is exc and port_events("degrade") == []


def test_disabled_is_a_plain_execute(lineitem):
    config.set_option("degrade.enabled", False)
    lim = MemoryLimiter(1 << 24)
    query = _query(lineitem, lim)
    res = degrade.DegradationController(lim).execute(query)
    want = fusion.execute(tpch._q1_plan(), {"lineitem": lineitem})
    assert res.table.equals(want.table)
    with faults.inject(_pressure_script(faults, 0)):
        with pytest.raises(resilience.ResourceExhausted):
            degrade.DegradationController(lim).execute(query)


def test_unsliceable_scan_has_no_outofcore_rung():
    from spark_rapids_jni_tpu import types as jt

    values = ["a", "bcd", None, "x"]  # 5 Arrow chars for 4 rows
    arrow = Table([string_column(values, device="cpu")])
    runner = degrade.row_chunked_tier({"s": arrow}, "s", None, None,
                                      limiter=MemoryLimiter(100))
    assert runner is None
    assert port_events("degrade") == [
        ("tier_unavailable", "outofcore", "not_row_sliceable", 2)]
    # the reference decides the same on the same layout
    offs = np.array([0, 1, 4, 4, 5], np.int32)
    chars = np.frombuffer(b"abcdx", np.uint8).copy()
    jarrow = jax_table([(int(jt.TypeId.STRING), 0, (offs, chars),
                         np.array([1, 1, 0, 1], bool))])
    assert jdegrade.row_chunked_tier(
        {"s": jarrow}, "s", None, None, limiter=JLimiter(100)) is None
    assert degrade._row_sliceable(tpch.lineitem_table(4, device="cpu"))
