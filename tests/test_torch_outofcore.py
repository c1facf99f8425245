"""The port's out-of-core executor (``runtime/outofcore.py``) and its TPC-H
entry points against the JAX package's: ``tpch_q1_outofcore`` and
``tpch_q3_outofcore`` over the same Parquet files, serial, with
prefetch and pipelined, equal the reference's results and the in-memory
plans bit for bit; the ORC chunked reader streams through the same
executor to the reference's result; every limiter ends at ``used == 0``
after success, failure, a retried merge and cancellation (the executor's
modes against the reference's over the same chunks are in
``test_torch_pipeline.py``). Chunks are few
and of equal size, so the reference compiles few shapes. Tolerance:
exact everywhere (float averages compared by their bits)."""

from __future__ import annotations

import numpy as np
import pytest

from spark_rapids_jni_tpu.runtime.memory import MemoryLimiter as JLimiter
from spark_rapids_jni_tpu.runtime.outofcore import (
    run_chunked_aggregate as jrun,
)
from spark_rapids_jni_tpu_torch import telemetry
from spark_rapids_jni_tpu_torch.models import tpch
from spark_rapids_jni_tpu_torch.runtime import resilience
from spark_rapids_jni_tpu_torch.runtime.memory import (
    MemoryLimiter,
    MemoryLimitExceeded,
    table_nbytes,
)
from spark_rapids_jni_tpu_torch.runtime.outofcore import (
    prefetch_chunks,
    run_chunked_aggregate,
)
from torch_ooc import (
    port_chunks,
    port_host_sources,
    port_merge,
    port_partial,
    write_q1_file,
    write_q3_file,
)
from torch_parity import reference_native

Q1_ROWS, Q1_GROUP_ROWS = 8000, 2000   # 4 row groups, 4 chunks
Q3_ROWS, Q3_GROUP_ROWS = 8000, 2000


@pytest.fixture(autouse=True)
def _reference_loader(monkeypatch):
    reference_native(monkeypatch)
    telemetry.reset()


def _key_rows(cols, nkeys: int = 1) -> list:
    """``[(bytes of each column's value), ...]`` of the rows whose first
    ``nkeys`` columns are valid, in order; ``cols`` is ``[(data,
    valid)]`` as numpy."""
    keep = np.logical_and.reduce([cols[i][1] for i in range(nkeys)])
    return [tuple(d[r].tobytes() if v[r] else None for d, v in cols)
            for r in np.flatnonzero(keep)]


def _port_cols(table):
    return [(c.data.numpy(), c.valid_mask().numpy()) for c in table.columns]


def _ref_cols(jtable):
    return [(np.asarray(c.data), np.asarray(c.valid_mask()))
            for c in jtable.columns]


@pytest.fixture(scope="module")
def q1_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("q1") / "lineitem.parquet"
    li = write_q1_file(path, Q1_ROWS, Q1_GROUP_ROWS)
    return str(path), li


@pytest.fixture(scope="module")
def q1_reference(q1_file):
    import pytest as _pytest

    from spark_rapids_jni_tpu.models import tpch as jtpch

    mp = _pytest.MonkeyPatch()
    reference_native(mp)
    try:
        res = jtpch.tpch_q1_outofcore(
            q1_file[0], budget_bytes=1 << 20, chunk_read_limit=1,
            spill_budget_bytes=1024)
    finally:
        mp.undo()
    return _key_rows(_ref_cols(res.table), 2)


@pytest.mark.parametrize("mode", ["serial", "prefetch", "pipelined"])
def test_q1_outofcore_equals_the_reference(q1_file, q1_reference, mode):
    path, li = q1_file
    # the whole file would not fit; prefetch holds depth + 2 chunks
    budget = table_nbytes(li) // (1 if mode == "prefetch" else 2)
    res = tpch.tpch_q1_outofcore(
        path, budget_bytes=budget, chunk_read_limit=1,
        spill_budget_bytes=1024, device="cpu",
        prefetch_depth=1 if mode == "prefetch" else 0,
        pipeline=mode == "pipelined")
    assert res.chunks == Q1_ROWS // Q1_GROUP_ROWS
    assert res.peak_bytes <= budget
    assert res.spill_stats["spills"] > 0
    got = _key_rows(_port_cols(res.table), 2)
    assert got == q1_reference
    assert got == _key_rows(_port_cols(tpch.tpch_q1(li)), 2)


def test_q1_outofcore_fails_loud_on_an_oversized_chunk(q1_file):
    with pytest.raises(MemoryLimitExceeded):
        tpch.tpch_q1_outofcore(q1_file[0], budget_bytes=1024,
                               chunk_read_limit=1, device="cpu")


@pytest.mark.parametrize("pipelined", [False, True])
def test_q3_outofcore_equals_the_reference(tmp_path, pipelined):
    from spark_rapids_jni_tpu.models import tpch as jtpch

    c = tpch.customer_table(48, device="cpu")
    o = tpch.orders_table(200, 48, device="cpu")
    li = tpch.lineitem_q3_table(Q3_ROWS, 200, device="cpu")
    path = str(tmp_path / "li_q3.parquet")
    write_q3_file(path, li, Q3_GROUP_ROWS)
    budget = table_nbytes(li) // 2
    res = tpch.tpch_q3_outofcore(path, c, o, budget_bytes=budget,
                                 chunk_read_limit=1, pipeline=pipelined,
                                 spill_budget_bytes=2048)
    assert res.chunks == Q3_ROWS // Q3_GROUP_ROWS
    assert res.peak_bytes <= budget and res.spill_stats["spills"] > 0
    got = _key_rows(_port_cols(res.table))
    if not pipelined:
        # the reference takes rtfilter's default (off), as the port does
        want = jtpch.tpch_q3_outofcore(
            path, jtpch.customer_table(48), jtpch.orders_table(200, 48),
            budget_bytes=1 << 20, chunk_read_limit=1)
        assert got == _key_rows(_ref_cols(want.table))
    oracle = tpch.tpch_q3_numpy(c, o, li)
    tbl = res.table
    assert {int(k): (int(r), int(d), int(p)) for k, d, p, r in zip(
        *[x.data.tolist() for x in tbl.columns])} == oracle


@pytest.fixture(scope="module")
def probe():
    chunks = port_chunks()
    want = run_chunked_aggregate(iter(chunks), port_partial, port_merge,
                                 limiter=MemoryLimiter(1 << 20),
                                 pipeline=False)
    return chunks, want.table


def _budget(chunks, k=8):
    return max(table_nbytes(c) for c in chunks) * k


def test_serial_holds_one_chunk_at_a_time(probe):
    chunks, _ = probe
    per = max(table_nbytes(c) for c in chunks)
    limiter = MemoryLimiter(per * 3)
    res = run_chunked_aggregate(iter(chunks), port_partial, port_merge,
                                limiter=limiter)
    # one chunk resident at a time, plus the merge window
    assert res.peak_bytes < 2 * per and limiter.used == 0


@pytest.mark.parametrize("mode", ["serial", "prefetch", "pipelined"])
def test_partial_failure_leaves_no_reservation(probe, mode):
    chunks, _ = probe
    limiter = MemoryLimiter(_budget(chunks, 16))
    calls = []

    def partial(c):
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("compute failed")
        return port_partial(c)

    src = port_host_sources(chunks) if mode == "pipelined" else iter(chunks)
    with pytest.raises(RuntimeError, match="compute failed"):
        run_chunked_aggregate(src, partial, port_merge, limiter=limiter,
                              prefetch_depth=2 if mode != "serial" else 0,
                              pipeline=mode == "pipelined")
    assert limiter.used == 0


@pytest.mark.parametrize("at", [2, 4], ids=["chunk", "restore"])
def test_cancel_leaves_no_reservation(probe, at):
    chunks, _ = probe
    limiter = MemoryLimiter(_budget(chunks, 8))
    token = resilience.CancelToken(label="q")
    calls = []

    def partial(c):
        calls.append(1)
        if len(calls) == at:  # the 4th is the last: cancels the restore
            token.cancel("caller")
        return port_partial(c)

    with pytest.raises(resilience.QueryCancelled):
        run_chunked_aggregate(port_host_sources(chunks), partial, port_merge,
                              limiter=limiter, pipeline=True,
                              cancel_token=token)
    assert limiter.used == 0


def test_transient_merge_fault_retries_with_one_reservation(probe):
    from spark_rapids_jni_tpu_torch.runtime import faults

    chunks, want = probe
    limiter = MemoryLimiter(_budget(chunks))
    script = faults.FaultScript([faults.FaultSpec(
        "outofcore.merge", resilience.TransientDeviceError, times=2)])
    with faults.inject(script):
        res = run_chunked_aggregate(iter(chunks), port_partial, port_merge,
                                    limiter=limiter)
    assert res.table.equals(want)
    assert limiter.used == 0 and len(script.fired) == 2


def test_empty_stream_raises():
    with pytest.raises(ValueError, match="empty input stream"):
        run_chunked_aggregate(iter([]), lambda c: c, lambda p: p,
                              limiter=MemoryLimiter(1 << 20))


def test_prefetch_releases_on_consumer_abort(probe):
    chunks, _ = probe
    per = table_nbytes(chunks[0])
    limiter = MemoryLimiter(per * 8)
    stream = prefetch_chunks(iter(chunks), depth=2, limiter=limiter)
    first = next(stream)
    stream.close()
    assert limiter.used == per and first.num_rows == chunks[0].num_rows


def test_orc_chunks_stream_through_the_same_executor(rng):
    from spark_rapids_jni_tpu.orc import OrcChunkedReader as JOrcReader
    from spark_rapids_jni_tpu_torch.ops.groupby import groupby_aggregate
    from spark_rapids_jni_tpu_torch.ops.table_ops import trim_table
    from spark_rapids_jni_tpu_torch.orc import OrcChunkedReader

    from tests import orc_util as ou

    n = 1200
    keys = rng.integers(0, 5, n).tolist()
    vals = rng.integers(-1000, 1000, n).tolist()
    data = ou.write_orc([ou.ColumnSpec("k", ou.LONG, keys),
                         ou.ColumnSpec("v", ou.LONG, vals)],
                        stripe_size=300)  # 4 stripes

    def partial_fn(chunk):
        g = groupby_aggregate(chunk, keys=[0], aggs=[(1, "sum")],
                              max_groups=16)
        return trim_table(g.table, int(g.num_groups))

    def merge_fn(partials):
        g = groupby_aggregate(partials, keys=[0], aggs=[(1, "sum")])
        return trim_table(g.table, int(g.num_groups))

    limiter = MemoryLimiter(1 << 16)
    res = run_chunked_aggregate(
        OrcChunkedReader(data, chunk_read_limit=1, device="cpu"),
        partial_fn, merge_fn, limiter=limiter, pipeline=True)
    assert res.chunks == 4 and limiter.used == 0
    oracle = {}
    for k, v in zip(keys, vals):
        oracle[k] = oracle.get(k, 0) + v
    assert dict(zip(*[c.data.tolist() for c in res.table.columns])) == oracle
    jlim = JLimiter(1 << 16)
    want = jrun(iter(JOrcReader(data, chunk_read_limit=1)),
                _reference_orc_partial, _reference_orc_merge, limiter=jlim)
    assert want.chunks == 4 and jlim.used == 0
    assert _key_rows(_port_cols(res.table)) == _key_rows(_ref_cols(
        want.table))


def _reference_orc_partial(chunk):
    from spark_rapids_jni_tpu.ops.groupby import groupby_aggregate
    from spark_rapids_jni_tpu.ops.table_ops import trim_table

    g = groupby_aggregate(chunk, keys=[0], aggs=[(1, "sum")], max_groups=16)
    return trim_table(g.table, int(g.num_groups))


def _reference_orc_merge(partials):
    from spark_rapids_jni_tpu.ops.groupby import groupby_aggregate
    from spark_rapids_jni_tpu.ops.table_ops import trim_table

    g = groupby_aggregate(partials, keys=[0], aggs=[(1, "sum")])
    return trim_table(g.table, int(g.num_groups))
