"""The port's pipelined executor (``runtime/pipeline.py``) and the modes
of ``run_chunked_aggregate`` against the JAX package's, over the same
q1-shaped chunks: serial, prefetch and pipelined at depths 1, 2 and 4
give the reference's table; chunks arrive in source order; a fault in
any stage surfaces at its chunk and releases every reservation; a budget
of about one chunk degrades to serial without deadlock; a corrupt
checkpoint is replayed and a transient decode fault resumes from the
checkpoints, with the same bits and the same ``integrity`` and
``resilience`` events as the reference's. Every wait carries its own
time limit. Tolerance: exact everywhere."""

from __future__ import annotations

import gc
import threading
import time
import weakref

import pytest

from spark_rapids_jni_tpu import telemetry as jtelemetry
from spark_rapids_jni_tpu.runtime import faults as jfaults
from spark_rapids_jni_tpu.runtime import resilience as jres
from spark_rapids_jni_tpu.runtime.memory import MemoryLimiter as JLimiter
from spark_rapids_jni_tpu.runtime.outofcore import (
    run_chunked_aggregate as jrun,
)
from spark_rapids_jni_tpu.utils import config as jconfig
from spark_rapids_jni_tpu_torch import telemetry
from spark_rapids_jni_tpu_torch.columnar import Column, Table
from spark_rapids_jni_tpu_torch.runtime import faults, resilience
from spark_rapids_jni_tpu_torch.runtime import pipeline as pl
from spark_rapids_jni_tpu_torch.runtime.memory import (
    MemoryLimiter,
    MemoryLimitExceeded,
    table_nbytes,
)
from spark_rapids_jni_tpu_torch.runtime.outofcore import run_chunked_aggregate
from spark_rapids_jni_tpu_torch.utils import config
from torch_ooc import (
    port_chunks,
    port_events,
    port_host_sources,
    port_merge,
    port_partial,
    reference_chunks,
    reference_events,
    reference_host_sources,
    reference_merge,
    reference_partial,
)
from torch_parity import assert_same_table

JOIN_S = 30  # seconds a run on a watchdog thread may take


@pytest.fixture(autouse=True)
def _reset():
    telemetry.reset()
    jtelemetry.drain()
    jconfig.set_option("telemetry.enabled", True)
    yield
    jtelemetry.drain()
    jconfig.reset_option("telemetry.enabled")
    config.reset_option("pipeline.enabled")


@pytest.fixture(scope="module")
def probe():
    jchunks = reference_chunks()
    want = jrun(iter(jchunks), reference_partial, reference_merge,
                limiter=JLimiter(1 << 20), pipeline=False)
    return port_chunks(jchunks), jchunks, want.table


def _per(chunks):
    return max(table_nbytes(c) for c in chunks)


def _run(chunks, limiter, **kw):
    return run_chunked_aggregate(port_host_sources(chunks), port_partial,
                                 port_merge, limiter=limiter, pipeline=True,
                                 **kw)


@pytest.mark.parametrize("mode,depth", [
    ("serial", 0), ("prefetch", 2), ("pipelined", 1), ("pipelined", 2),
    ("pipelined", 4)])
def test_modes_equal_the_reference(probe, mode, depth):
    chunks, _, want = probe
    limiter = MemoryLimiter(_per(chunks) * (depth + 4))
    src = port_host_sources(chunks) if mode == "pipelined" else iter(chunks)
    res = run_chunked_aggregate(src, port_partial, port_merge,
                                limiter=limiter, prefetch_depth=depth,
                                pipeline=mode == "pipelined")
    assert res.chunks == len(chunks)
    assert_same_table(res.table, want)
    assert limiter.used == 0
    if mode == "pipelined":
        assert telemetry.counter("pipeline.chunks") == len(chunks)
        assert telemetry.gauge("pipeline.chunks_in_flight") == 0


def test_chunks_arrive_in_source_order(probe):
    chunks, _, _ = probe

    def slow_early(stage, seq):
        if stage == "decode" and seq < 2:
            time.sleep(0.05)

    with pl.inject_fault(slow_early):
        got = list(pl.pipeline_chunks(port_host_sources(chunks), depth=4,
                                      decode_threads=4))
    assert [g.equals(c) for g, c in zip(got, chunks)] == [True] * len(chunks)


def test_materialized_tables_ride_the_pipeline(probe):
    chunks, _, _ = probe
    limiter = MemoryLimiter(_per(chunks) * 8)
    for i, chunk in enumerate(pl.pipeline_chunks(chunks, limiter=limiter,
                                                 depth=2)):
        assert chunk.equals(chunks[i])
        limiter.release(table_nbytes(chunk))
    assert limiter.used == 0


@pytest.mark.parametrize("stage", ["decode", "staging", "transfer"])
def test_worker_stage_fault_surfaces_at_its_chunk(probe, stage):
    chunks, _, _ = probe
    limiter = MemoryLimiter(_per(chunks) * 16)

    def hook(st, seq):
        if st == stage and seq == 2:
            raise RuntimeError(f"injected {stage}")

    got = []
    with pl.inject_fault(hook):
        with pytest.raises(RuntimeError, match=f"injected {stage}"):
            for chunk in pl.pipeline_chunks(port_host_sources(chunks),
                                            limiter=limiter, depth=4):
                got.append(chunk)
                limiter.release(table_nbytes(chunk))
    assert len(got) == 2 and limiter.used == 0
    assert telemetry.counter("pipeline.faults_injected") == 1


@pytest.mark.parametrize("stage", ["compute", "merge"])
def test_consumer_stage_fault_releases(probe, stage):
    chunks, _, _ = probe
    limiter = MemoryLimiter(_per(chunks) * 16)
    config.set_option("pipeline.enabled", True)

    def hook(st, seq):
        if st == stage:
            raise ValueError(f"injected {stage}")

    with pl.inject_fault(hook):
        with pytest.raises(ValueError, match=f"injected {stage}"):
            run_chunked_aggregate(port_host_sources(chunks), port_partial,
                                  port_merge, limiter=limiter)
    assert limiter.used == 0


def test_consumer_abort_releases_undelivered(probe):
    chunks, _, _ = probe
    per = table_nbytes(chunks[0])
    limiter = MemoryLimiter(per * 16)
    stream = pl.pipeline_chunks(port_host_sources(chunks), limiter=limiter,
                                depth=4)
    first = next(stream)
    stream.close()
    assert limiter.used == per and first.equals(chunks[0])


def _tracked_sources(chunks, made, fail_first=False):
    """Thunks making fresh copies of ``chunks``, each copy's first
    tensor weakly referenced in ``made[i]``; with ``fail_first`` chunk 0
    fails after the others have decoded."""
    def source(i):
        def make():
            if fail_first and i == 0:
                time.sleep(0.2)
                raise RuntimeError("injected decode")
            t = Table([Column(c.dtype, c.data.clone()) for c in
                       chunks[i].columns])
            made[i] = weakref.ref(t.columns[0].data)
            return t
        return make
    return [source(i) for i in range(len(chunks))]


def test_delivered_chunks_are_not_held(probe):
    # the caller's chunk frees once the caller drops it, not at the end
    # of the stream (a held chunk is device memory the limiter no longer
    # counts)
    chunks, _, _ = probe
    made = {}
    gc.collect()
    gc.disable()
    try:
        for i, chunk in enumerate(pl.pipeline_chunks(
                _tracked_sources(chunks, made), depth=4, decode_threads=4)):
            assert chunk.num_rows == chunks[i].num_rows
            if i:
                assert made[i - 1]() is None
    finally:
        gc.enable()


def test_failure_frees_completed_chunks_without_a_collection(probe):
    # chunk 0 fails after 1-3 finished decoding: their futures must not
    # outlive the failure in a reference cycle through its traceback
    chunks, _, _ = probe
    made = {}
    gc.collect()
    gc.disable()
    try:
        try:
            for _ in pl.pipeline_chunks(
                    _tracked_sources(chunks, made, fail_first=True),
                    depth=4, decode_threads=4):
                pass
        except RuntimeError:
            pass
        assert sorted(made) == [1, 2, 3]
        assert [r() is None for r in made.values()] == [True] * 3
    finally:
        gc.enable()


def test_minimum_budget_degrades_to_serial_without_deadlock(probe):
    chunks, _, want = probe
    per = _per(chunks)
    budget = per * 2 + per // 2 + 4096
    limiter = MemoryLimiter(budget)
    out = []
    th = threading.Thread(target=lambda: out.append(
        _run(chunks, limiter, prefetch_depth=4)))
    th.start()
    th.join(JOIN_S)
    assert not th.is_alive() and out, "the pipeline deadlocked"
    assert out[0].peak_bytes <= budget and limiter.used == 0
    assert_same_table(out[0].table, want)


def test_oversized_chunk_fails_loud(probe):
    chunks, _, _ = probe
    limiter = MemoryLimiter(table_nbytes(chunks[0]) // 2)
    with pytest.raises(MemoryLimitExceeded):
        list(pl.pipeline_chunks(port_host_sources(chunks), limiter=limiter,
                                depth=2))
    assert limiter.used == 0


def test_depth_and_routing_options(probe, monkeypatch):
    monkeypatch.setenv("SPARK_RAPIDS_TPU_PIPELINE_PREFETCH", "7")
    assert pl.configured_prefetch_depth() == 7
    monkeypatch.setenv("SPARK_RAPIDS_TPU_PIPELINE_PREFETCH", "0")
    assert pl.configured_prefetch_depth() == 1
    monkeypatch.delenv("SPARK_RAPIDS_TPU_PIPELINE_PREFETCH")
    assert pl.configured_prefetch_depth() == 2
    assert pl.configured_decode_threads() == 2
    chunks, _, _ = probe
    config.set_option("pipeline.enabled", True)
    run_chunked_aggregate(port_host_sources(chunks[:2]), port_partial,
                          port_merge, limiter=MemoryLimiter(1 << 20))
    assert telemetry.counter("pipeline.runs") == 1
    pool = pl.shared_decode_pool()
    assert pl.shared_decode_pool() is pool
    pl.reset_shared_decode_pool()


def _spill_budget(chunks):
    """Room for one partial: every later put spills the one before."""
    return table_nbytes(port_partial(chunks[0])) + 8


def test_corrupt_checkpoint_replays_as_the_reference(probe):
    chunks, jchunks, want = probe
    limiter = MemoryLimiter(_per(chunks) * 8)
    script = faults.FaultScript(corruptions=[faults.CorruptionSpec(
        "integrity.checkpoint", "flip", seq=2, seed=5)])
    with faults.inject(script):
        res = _run(chunks, limiter, prefetch_depth=2,
                   spill_budget_bytes=_spill_budget(chunks))
    assert_same_table(res.table, want)
    assert limiter.used == 0 and script.fired == [("integrity.checkpoint", 2)]
    jlim = JLimiter(_per(chunks) * 8)
    jscript = jfaults.FaultScript(corruptions=[jfaults.CorruptionSpec(
        "integrity.checkpoint", "flip", seq=2, seed=5)])
    with jfaults.inject(jscript):
        jrun(reference_host_sources(jchunks), reference_partial,
             reference_merge, limiter=jlim, prefetch_depth=2, pipeline=True,
             spill_budget_bytes=_spill_budget(chunks))
    events = port_events("integrity")
    assert events == reference_events("integrity")
    assert [e[1] for e in events] == ["mismatch", "replay", "recovered"]


def test_transient_decode_fault_resumes_as_the_reference(probe):
    chunks, jchunks, want = probe
    limiter = MemoryLimiter(_per(chunks) * 8)
    script = faults.FaultScript([faults.FaultSpec(
        "pipeline.decode", resilience.TransientDeviceError, seq=2)])
    with faults.inject(script):
        res = _run(chunks, limiter, prefetch_depth=2)
    assert_same_table(res.table, want)
    assert limiter.used == 0
    jlim = JLimiter(_per(chunks) * 8)
    with jfaults.inject(jfaults.FaultScript([jfaults.FaultSpec(
            "pipeline.decode", jres.TransientDeviceError, seq=2)])):
        jrun(reference_host_sources(jchunks), reference_partial,
             reference_merge, limiter=jlim, prefetch_depth=2, pipeline=True)
    events = port_events("resilience")
    assert events == reference_events("resilience")
    assert [e[1] for e in events] == ["retry", "recovered"]


def test_resume_exhaustion_is_fatal_and_releases(probe):
    chunks, _, _ = probe
    config_attempts = 2
    limiter = MemoryLimiter(_per(chunks) * 8)
    config.set_option("resilience.max_attempts", config_attempts)
    try:
        with faults.inject(faults.FaultScript([faults.FaultSpec(
                "pipeline.transfer", resilience.TransientDeviceError,
                times=10)])):
            with pytest.raises(resilience.FatalExecutionError,
                               match="resume retries exhausted"):
                _run(chunks, limiter, prefetch_depth=2)
    finally:
        config.reset_option("resilience.max_attempts")
    assert limiter.used == 0
