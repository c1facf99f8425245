"""The port's multiple-executor layer (``spark_rapids_jni_tpu_torch/
parallel/``) against the JAX package's on the CPU: the wire codec, the
all-to-all shuffle (every executor's output slots), and the distributed
operators. The reference runs on ``executor_mesh(4)`` over the conftest's
virtual CPU devices, the port on a mesh of 4 executors on ``cpu``; the
same seeded numpy inputs feed both. Exact, except float lanes folded
across executors, held to ``1e-12 * sum|x|`` per slot."""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import torch_parity as tp
from spark_rapids_jni_tpu import types as jt
from spark_rapids_jni_tpu.parallel import distributed as jdist
from spark_rapids_jni_tpu.parallel import shuffle as jshuffle
from spark_rapids_jni_tpu.parallel import sort as jsort
from spark_rapids_jni_tpu.parallel import wire as jwire
from spark_rapids_jni_tpu.parallel.mesh import EXEC_AXIS as JAXIS
from spark_rapids_jni_tpu.parallel.mesh import executor_mesh as jexecutor_mesh
from spark_rapids_jni_tpu_torch import telemetry
from spark_rapids_jni_tpu_torch import types as t
from spark_rapids_jni_tpu_torch.columnar import Column, Table
from spark_rapids_jni_tpu_torch.interop import table_to_numpy
from spark_rapids_jni_tpu_torch.ops import planner
from spark_rapids_jni_tpu_torch.parallel import distributed as dist
from spark_rapids_jni_tpu_torch.parallel import sort as psort
from spark_rapids_jni_tpu_torch.parallel import wire
from spark_rapids_jni_tpu_torch.parallel.mesh import executor_mesh
from spark_rapids_jni_tpu_torch.parallel.shuffle import (
    classify_overflow,
    hash_shuffle,
    report_shuffle_telemetry,
    shuffle_by_partition,
)
from spark_rapids_jni_tpu_torch.runtime import resilience

D = 4
ROWS = 203  # not a multiple of D: the last executor holds padding rows


@pytest.fixture(scope="module", autouse=True)
def _quick_reference_compiles():
    with tp.quick_reference_compiles():
        yield


@pytest.fixture(scope="module")
def jmesh():
    return jexecutor_mesh(D)


@pytest.fixture(scope="module")
def pmesh():
    return executor_mesh(D, ["cpu"] * D)


def _host_columns(n: int, seed: int) -> list:
    """int64 keys with nulls (37 values), int32 values with nulls, a
    STRING column with nulls, DECIMAL128 limbs, float64 values."""
    rng = np.random.default_rng(seed)
    words = ["", "a", "ab", "shuffle", "executor-mesh", "zz", "SF10"]
    strings = [words[i] for i in rng.integers(0, len(words), n)]
    offsets, chars, svalid = tp.arrow_strings(strings, rng.random(n) > 0.15)
    return [
        (int(jt.TypeId.INT64), 0, rng.integers(0, 37, n).astype(np.int64),
         rng.random(n) > 0.1),
        (int(jt.TypeId.INT32), 0,
         rng.integers(-1000, 1000, n).astype(np.int32), rng.random(n) > 0.1),
        (int(jt.TypeId.STRING), 0, (offsets, chars), svalid),
        (int(jt.TypeId.DECIMAL128), -2,
         rng.integers(-2**62, 2**62, (n, 2), dtype=np.int64), None),
        (int(jt.TypeId.FLOAT64), 0, rng.standard_normal(n) * 1e3,
         rng.random(n) > 0.1),
    ]


def _both(columns):
    jtab = tp.jax_table(columns)
    return tp.to_port(jtab), jtab


@pytest.fixture(scope="module")
def tables():
    return _both(_host_columns(ROWS, 7))


@pytest.fixture(scope="module")
def fixed_tables():
    """The same rows without the STRING column, for the operators that
    aggregate or order by the fixed-width columns alone (each string
    lane the reference shuffles is compiled anew)."""
    return _both([c for i, c in enumerate(_host_columns(ROWS, 7)) if i != 2])


def _global(pmesh, tables_) -> Table:
    return dist.global_table(pmesh, tables_)


def _flags(xs) -> np.ndarray:
    return np.array([bool(x) for x in xs])


def _ref(step, jmesh, n_in: int, n_out: int):
    """A jitted ``shard_map`` of ``step`` over the reference mesh, every
    argument and result sharded along the executor axis."""
    return jax.jit(jax.shard_map(
        step, mesh=jmesh, in_specs=(P(JAXIS),) * n_in,
        out_specs=(P(JAXIS),) * n_out))


# ---- mesh ------------------------------------------------------------------


def test_mesh_layout_and_errors():
    m = executor_mesh(3, ["cpu"] * 4)
    assert m.size == 3 and m.devices == (torch.device("cpu"),) * 3
    assert m.executors == (0, 1, 2)
    with pytest.raises(ValueError, match="only 2 devices"):
        executor_mesh(3, ["cpu", "cpu"])
    with pytest.raises(ValueError, match="only 2 devices"):
        jexecutor_mesh(3, jax.devices()[:2])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            executor_mesh(2)


def test_local_collectives(pmesh):
    # executor s sends block r of its buffer to executor r; receivers lay
    # the blocks out by source
    xs = [torch.arange(8) + 100 * s for s in range(D)]
    got = pmesh.all_to_all(xs)
    for r in range(D):
        want = torch.cat([xs[s][2 * r:2 * r + 2] for s in range(D)])
        assert torch.equal(got[r], want)
    masks = pmesh.all_to_all([torch.arange(8) % (s + 2) == 0
                              for s in range(D)])
    assert masks[0].dtype == torch.bool
    ints = [torch.tensor([s, -s, 7]) for s in range(D)]
    assert pmesh.psum(ints)[0].tolist() == [6, -6, 28]
    assert pmesh.pmin(ints)[2].tolist() == [0, -3, 7]
    u = [torch.tensor([2**63 + s, s], dtype=torch.uint64) for s in range(D)]
    assert pmesh.pmax(u)[0].view(torch.int64).tolist() == [
        torch.tensor(2**63 + 3, dtype=torch.uint64).view(torch.int64).item(),
        3]
    gathered = pmesh.all_gather([torch.tensor([s]) for s in range(D)])
    assert gathered[3].reshape(-1).tolist() == [0, 1, 2, 3]


# ---- wire ------------------------------------------------------------------


@pytest.mark.parametrize("bits,reference", [(1, 0), (7, -3), (12, 8400),
                                            (31, 0), (32, 5)])
def test_pack_bits_matches_reference_and_round_trips(bits, reference):
    rng = np.random.default_rng(bits)
    values = rng.integers(0, 1 << bits, (3, 45), dtype=np.int64) + reference
    values[1, 5] = reference - 1  # one value below the frame
    spec, jspec = wire.BitPack(bits, reference), jwire.BitPack(bits, reference)
    packed, ovf = wire.pack_bits(torch.from_numpy(values), spec)
    # the reference traced whole: op by op it compiles each primitive
    jpacked, jovf = jax.jit(lambda v: jwire.pack_bits(v, jspec))(values)
    tp.assert_same_array(packed.numpy(), np.asarray(jpacked), "words")
    assert bool(ovf) and bool(jovf)
    values[1, 5] = reference
    packed, ovf = wire.pack_bits(torch.from_numpy(values), spec)
    assert not bool(ovf)
    back = wire.unpack_bits(packed, 45, spec, torch.int64)
    assert torch.equal(back, torch.from_numpy(values))
    jback = jax.jit(lambda p: jwire.unpack_bits(p, 45, jspec,
                                                jax.numpy.int64))(
        packed.numpy())
    tp.assert_same_array(back.numpy(), np.asarray(jback), "unpacked")


def test_shuffle_wire_bytes_matches_reference(tables):
    ptab, jtab = tables
    specs = [wire.BitPack(6, 0), t.INT16, None, None, None]
    jspecs = [jwire.BitPack(6, 0), jt.INT16, None, None, None]
    assert wire.shuffle_wire_bytes(ptab, specs, 64, D) == \
        jwire.shuffle_wire_bytes(jtab, jspecs, 64, D)


# ---- the shuffle -----------------------------------------------------------


def _ref_shuffle(jmesh, jtab, keys, capacity=None, wire_dtypes=None,
                 part_mod=None):
    sharded, rv = jdist.shard_table(jtab, jmesh, return_row_valid=True)

    def step(local, lrv):
        if part_mod is None:
            r = jshuffle.hash_shuffle(local, keys, JAXIS, capacity=capacity,
                                      row_valid=lrv, wire_dtypes=wire_dtypes)
        else:
            part = (local.column(0).data % part_mod).astype(np.int32)
            r = jshuffle.shuffle_by_partition(
                local, part, JAXIS, capacity=capacity, row_valid=lrv)
        return (r.table, r.row_valid, r.overflowed.reshape(1),
                r.narrowing_overflow.reshape(1))

    return _ref(step, jmesh, 2, 4)(sharded, rv)


def _port_shuffle(pmesh, ptab, keys, capacity=None, wire_dtypes=None,
                  part_mod=None):
    shards, rv = dist.shard_table(ptab, pmesh, return_row_valid=True)
    if part_mod is None:
        return hash_shuffle(pmesh, shards, keys, capacity=capacity,
                            row_valid=rv, wire_dtypes=wire_dtypes)
    parts = [(s.column(0).data % part_mod).to(torch.int32) for s in shards]
    return shuffle_by_partition(pmesh, shards, parts, capacity=capacity,
                                row_valid=rv)


def _same_shuffle(pmesh, got, want):
    wtab, wrv, wovf, wnarrow = want
    tp.assert_same_valid_table(_global(pmesh, [r.table for r in got]), wtab)
    tp.assert_same_array(torch.cat([r.row_valid for r in got]).numpy(),
                         np.asarray(wrv), "row_valid")
    tp.assert_same_array(_flags(r.overflowed for r in got),
                         np.asarray(wovf), "overflowed")
    tp.assert_same_array(_flags(r.narrowing_overflow for r in got),
                         np.asarray(wnarrow), "narrowing_overflow")


@pytest.mark.parametrize("keys,capacity", [([0], None), ([2, 0], None),
                                           ([0], 6)],
                         ids=["int_key", "string_and_int_keys",
                              "overflowing"])
def test_hash_shuffle_slots_match_reference(jmesh, pmesh, tables, keys,
                                            capacity):
    ptab, jtab = tables
    got = _port_shuffle(pmesh, ptab, keys, capacity)
    want = _ref_shuffle(jmesh, jtab, keys, capacity)
    _same_shuffle(pmesh, got, want)
    # padding rows never travel: the real rows arrive once each
    if capacity is None:
        assert int(sum(r.row_valid.sum() for r in got)) == ROWS
    else:
        assert _flags(r.overflowed for r in got).any()


def test_shuffle_by_partition_and_wire_specs_match_reference(
        jmesh, pmesh, tables):
    ptab, jtab = tables
    _same_shuffle(pmesh, _port_shuffle(pmesh, ptab, None, part_mod=3),
                  _ref_shuffle(jmesh, jtab, None, part_mod=3))
    narrow = [t.INT8, t.INT8, None, None, None]
    jnarrow = [jt.INT8, jt.INT8, None, None, None]
    got = _port_shuffle(pmesh, ptab, [0], wire_dtypes=narrow)
    _same_shuffle(pmesh, got, _ref_shuffle(jmesh, jtab, [0],
                                           wire_dtypes=jnarrow))
    # the int32 values (|v| < 1000) do not survive int8: flagged
    assert _flags(r.narrowing_overflow for r in got).any()
    packed = [wire.BitPack(6, 0), wire.BitPack(11, -1000), None, None,
              None]
    jpacked = [jwire.BitPack(6, 0), jwire.BitPack(11, -1000), None, None,
               None]
    got = _port_shuffle(pmesh, ptab, [0], wire_dtypes=packed)
    _same_shuffle(pmesh, got, _ref_shuffle(jmesh, jtab, [0],
                                           wire_dtypes=jpacked))
    assert not _flags(r.narrowing_overflow for r in got).any()
    with pytest.raises(ValueError, match="string"):
        _port_shuffle(pmesh, ptab, [0], wire_dtypes=[None, None, t.INT8,
                                                     None, None])


def test_overflow_is_classified_and_recorded(pmesh, tables):
    ptab, _ = tables
    telemetry.reset()
    got = _port_shuffle(pmesh, ptab, [0], capacity=6)
    with pytest.raises(resilience.CapacityOverflow,
                       match="6 send-buffer slots") as err:
        report_shuffle_telemetry(got, rows=ROWS, capacity=6,
                                 raise_on_overflow=True)
    assert resilience.classify(err.value) is resilience.CapacityOverflow
    assert any(op == "hash_shuffle" for op, _ in telemetry.fallbacks())
    exc = classify_overflow(capacity=8, rows=9, partition=2, required=12)
    assert "hot partition 2" in str(exc) and "12 slots" in str(exc)
    assert resilience.is_transient(exc)


# ---- distributed operators -------------------------------------------------


def _groupby_pair(jmesh, pmesh, tables, keys, aggs, capacity=None):
    ptab, jtab = tables
    want = jdist.distributed_groupby_aggregate(
        jdist.shard_table(jtab, jmesh), keys, aggs, jmesh, capacity)
    got = dist.distributed_groupby_aggregate(
        dist.shard_table(ptab, pmesh), keys, aggs, pmesh, capacity)
    return got, want


def _same_groupby(pmesh, got, want, tol=None):
    wcounts = np.asarray(want.num_groups).reshape(-1)
    tp.assert_same_array(
        np.array([int(n) for n in got.num_groups], np.int64),
        wcounts.astype(np.int64), "num_groups")
    tp.assert_same_array(_flags(got.overflowed),
                         np.asarray(want.overflowed).reshape(-1),
                         "overflowed")
    per = want.table.num_rows // D
    for e in range(D):
        k = int(wcounts[e])
        wslice = _jslice(want.table, e * per, e * per + k)
        _same_rows(dist.head_table(got.table[e], k), wslice, tol)


def _jslice(jtab, lo, hi):
    from spark_rapids_jni_tpu.columnar import Column as JColumn
    from spark_rapids_jni_tpu.columnar import Table as JTable

    return JTable([JColumn(c.dtype, c.data[lo:hi],
                           None if c.validity is None else c.validity[lo:hi],
                           chars=None if c.chars is None else c.chars[lo:hi],
                           children=c.children)
                   for c in jtab.columns])


def _same_rows(got: Table, want, tol=None):
    """Valid cells equal; the float columns in ``tol`` held to
    ``1e-12 * sum|x|`` style bounds (relative to the column's scale)."""
    tol = tol or {}
    gcols, wcols = table_to_numpy(got), tp.host_columns(want)
    for i, (g, w) in enumerate(zip(gcols, wcols)):
        if i not in tol:
            tp.assert_same_valid_table(Table([got.column(i)]),
                                       _jtable([want.columns[i]]))
            continue
        gv = np.ones(len(g[2]), bool) if g[3] is None else g[3]
        wv = np.ones(len(w[2]), bool) if w[3] is None else w[3]
        tp.assert_same_array(gv, wv, f"column {i} validity")
        np.testing.assert_allclose(g[2][gv], w[2][wv], rtol=0,
                                   atol=tol[i], err_msg=f"column {i}")


def _jtable(cols):
    from spark_rapids_jni_tpu.columnar import Table as JTable

    return JTable(cols)


def test_distributed_groupby_aggregate_matches_reference(jmesh, pmesh,
                                                         fixed_tables):
    aggs = [(1, "sum"), (1, "count"), (1, "min"), (1, "max"), (2, "sum"),
            (3, "sum"), (3, "mean")]
    got, want = _groupby_pair(jmesh, pmesh, fixed_tables, [0], aggs)
    x = fixed_tables[0].column(3).data.abs().sum().item()
    _same_groupby(pmesh, got, want, tol={6: 1e-12 * x, 7: 1e-12 * x})


def test_distributed_groupby_retries_overflow(pmesh, tables):
    """A capacity of 4 overflows; the retry ladder grows it (seam
    ``shuffle.transport``) until no executor drops a row, and the groups
    are those of the derived capacity's run."""
    ptab, _ = tables
    shards = dist.shard_table(ptab, pmesh)
    aggs = [(1, "sum"), (1, "count")]
    telemetry.reset()
    got = dist.distributed_groupby_aggregate(shards, [2], aggs, pmesh,
                                             capacity=4)
    assert not _flags(got.overflowed).any()
    events = telemetry.events("resilience")
    assert [e["event"] for e in events][-1] == "recovered"
    assert {e["event"] for e in events[:-1]} == {"escalate"}
    assert {e["seam"] for e in events} == {"shuffle.transport"}
    plain = dist.distributed_groupby_aggregate(shards, [2], aggs, pmesh)
    key = [0, 1, 2]
    from spark_rapids_jni_tpu_torch.ops.sort import sort_table

    a = sort_table(dist.collect(got.table, got.num_groups, pmesh), key)
    b = sort_table(dist.collect(plain.table, plain.num_groups, pmesh), key)
    tp.assert_same_array(table_to_numpy(a)[1][2], table_to_numpy(b)[1][2])
    assert dist._shuffle_retry_capacity(
        [Table([Column(t.INT64, torch.zeros(300, dtype=torch.int64))])],
        pmesh, None) == jdist._shuffle_retry_capacity(
        tp.jax_table([(int(jt.TypeId.INT64), 0,
                       np.zeros(1200, np.int64), None)]), jexecutor_mesh(D),
        None)


def test_distributed_groupby_ladder_runs_with_resilience_off(pmesh,
                                                             tables):
    """``resilience.enabled=false`` turns off the replay of transient
    faults, not the capacity ladder: an overflowing capacity still grows
    until no executor drops a row (the reference retries once and
    returns the flags set; ROADMAP.md Queue 3)."""
    from spark_rapids_jni_tpu_torch.utils import config

    ptab, _ = tables
    shards = dist.shard_table(ptab, pmesh)
    aggs = [(1, "sum"), (1, "count")]
    want = dist.distributed_groupby_aggregate(shards, [2], aggs, pmesh)
    config.set_option("resilience.enabled", False)
    try:
        telemetry.reset()
        got = dist.distributed_groupby_aggregate(shards, [2], aggs, pmesh,
                                                 capacity=2)
    finally:
        config.reset_option("resilience.enabled")
    assert not _flags(got.overflowed).any()
    events = [e["event"] for e in telemetry.events("resilience")]
    assert events.count("escalate") >= 2 and events[-1] == "recovered"
    for g, w in zip(got.num_groups, want.num_groups):
        assert int(g) == int(w)


def test_distributed_groupby_percentile_matches_reference(jmesh, pmesh,
                                                          fixed_tables):
    ptab, jtab = fixed_tables
    qs = [0.0, 0.25, 0.5, 1.0]
    want = jdist.distributed_groupby_percentile(
        jdist.shard_table(jtab, jmesh), [0], 1, qs, jmesh)
    got = dist.distributed_groupby_percentile(
        dist.shard_table(ptab, pmesh), [0], 1, qs, pmesh)
    _same_groupby(pmesh, got, want)


def _bounded_host(n: int, seed: int) -> list:
    """A bounded key (domain 1..5, some out of domain never), int64 and
    float64 lanes with NaN and -0.0 planted."""
    rng = np.random.default_rng(seed)
    f = rng.standard_normal(n)
    f[::11] = np.nan
    f[3::13] = -0.0
    f[5::13] = 0.0
    return [
        (int(jt.TypeId.INT32), 0, rng.integers(1, 6, n).astype(np.int32),
         rng.random(n) > 0.1),
        (int(jt.TypeId.INT64), 0, rng.integers(-10**6, 10**6, n),
         rng.random(n) > 0.1),
        (int(jt.TypeId.FLOAT64), 0, f, rng.random(n) > 0.05),
    ]


def test_distributed_groupby_bounded_matches_reference(jmesh, pmesh):
    """Against the reference and the single-device bounded plan over the
    whole table. Float min/max merge as the single-device plan's lanes
    reduce (NaN wins, -0.0 below 0.0); the reference's ``pmin``/``pmax``
    give what XLA's reduction gives where a group holds NaN, so there
    the port is held to the single-device plan alone (ROADMAP.md Queue
    3)."""
    from spark_rapids_jni_tpu.ops import planner as jplanner

    host = _bounded_host(ROWS, 3)
    ptab, jtab = _both(host)
    aggs = [(1, "sum"), (1, "count"), (1, "min"), (1, "max"), (2, "sum"),
            (2, "min"), (2, "max")]
    jsh, jrv = jdist.shard_table(jtab, jmesh, return_row_valid=True)
    want = jdist.distributed_groupby_bounded(
        jsh, [0], aggs, [jplanner.scalar_domain(range(1, 6))], jmesh,
        row_valid=jrv)
    psh, prv = dist.shard_table(ptab, pmesh, return_row_valid=True)
    got = dist.distributed_groupby_bounded(
        psh, [0], aggs, [planner.scalar_domain(range(1, 6))], pmesh,
        row_valid=prv)
    single = planner.plan_groupby(ptab, [0], aggs,
                                  [planner.scalar_domain(range(1, 6))])
    tp.assert_same_array(got.present.numpy(), np.asarray(want.present))
    tp.assert_same_array(got.present.numpy(), single.present.numpy())
    assert bool(got.domain_miss) == bool(want.domain_miss) is False
    x = ptab.column(2).data.nan_to_num().abs().sum().item()
    gcols, wcols = table_to_numpy(got.table), tp.host_columns(want.table)
    scols = table_to_numpy(single.table)
    # the slots whose group holds a NaN: there the reference's float
    # min/max take XLA's NaN handling
    kdata, kvalid = host[0][2], host[0][3]
    f, fvalid = host[2][2], host[2][3]
    nan_slot = np.array([
        bool(np.isnan(f[fvalid & ((kvalid & (kdata == k)) if kv
                                  else ~kvalid)]).any())
        for k, kv in zip(gcols[0][2], gcols[0][3])])
    assert nan_slot.any()
    for i, (g, w, sgl) in enumerate(zip(gcols, wcols, scols)):
        tp.assert_same_array(g[3], w[3], f"column {i} validity")
        v = g[3]
        if i == 5:  # the float sum, folded in another order
            np.testing.assert_allclose(g[2][v], w[2][v], rtol=0,
                                       atol=1e-12 * x, equal_nan=True)
            np.testing.assert_allclose(g[2][v], sgl[2][v], rtol=0,
                                       atol=1e-12 * x, equal_nan=True)
            continue
        tp.assert_same_array(g[2][v], sgl[2][v], f"column {i} vs single")
        same = v & ~nan_slot if i in (6, 7) else v
        tp.assert_same_array(g[2][same], w[2][same], f"column {i}")
    with pytest.raises(ValueError, match="Domain"):
        dist.distributed_groupby_bounded(psh, [0], aggs, [None], pmesh)
    with pytest.raises(ValueError, match="sum/count/min/max"):
        dist.distributed_groupby_bounded(
            psh, [0], [(1, "mean")], [planner.scalar_domain(range(1, 6))],
            pmesh)


def test_distributed_window_matches_reference(jmesh, pmesh, fixed_tables):
    ptab, jtab = fixed_tables
    specs = [("row_number",), ("rank",), ("lag", 1, 1),
             ("running_sum", 1), ("rolling_sum", 1, 2, 0),
             ("rolling_max_range", 1, 100, 0)]
    jsh, jrv = jdist.shard_table(jtab, jmesh, return_row_valid=True)
    want = jdist.distributed_window(jsh, [0], [1], specs, jmesh, jrv)
    psh, prv = dist.shard_table(ptab, pmesh, return_row_valid=True)
    got = dist.distributed_window(psh, [0], [1], specs, pmesh, prv)
    tp.assert_same_valid_table(_global(pmesh, got.table), want.table)
    rv = np.asarray(want.row_valid)
    tp.assert_same_array(torch.cat(got.row_valid).numpy(), rv)
    results = table_to_numpy(_global(pmesh, got.results))
    for i, (g, w) in enumerate(zip(results, tp.host_columns(want.results))):
        gv = np.ones(len(rv), bool) if g[3] is None else g[3]
        wv = np.ones(len(rv), bool) if w[3] is None else w[3]
        # the real rows' results (phantom slots hold their own partition)
        tp.assert_same_array(gv[rv], wv[rv], f"spec {i} validity")
        tp.assert_same_array(g[2][rv & gv], w[2][rv & wv], f"spec {i}")


@pytest.mark.parametrize("how", ["inner", "left"])
def test_distributed_join_matches_reference(jmesh, pmesh, how):
    lhost = _host_columns(ROWS, 11)[:3]
    rhost = _host_columns(61, 12)[:2]
    (pl, jl), (pr, jr) = _both(lhost), _both(rhost)
    jls, jlrv = jdist.shard_table(jl, jmesh, return_row_valid=True)
    jrs, jrrv = jdist.shard_table(jr, jmesh, return_row_valid=True)
    want = jdist.distributed_join(jls, jrs, 0, 0, jmesh, 400, how=how,
                                  left_row_valid=jlrv, right_row_valid=jrrv)
    pls, plrv = dist.shard_table(pl, pmesh, return_row_valid=True)
    prs, prrv = dist.shard_table(pr, pmesh, return_row_valid=True)
    got = dist.distributed_join(pls, prs, 0, 0, pmesh, 400, how=how,
                                left_row_valid=plrv, right_row_valid=prrv)
    tp.assert_same_array(np.array([int(x) for x in got.total], np.int64),
                         np.asarray(want.total).astype(np.int64), "total")
    assert not _flags(got.overflowed).any()
    tp.assert_same_valid_table(_global(pmesh, got.table), want.table)
    # no phantom rows: the match counts of the real rows alone (a left
    # join emits each unmatched real probe row once, padding never)
    lk, lv = lhost[0][2], lhost[0][3]
    rk, rv = rhost[0][2], rhost[0][3]
    matches = np.array([(rv & (rk == k)).sum() if v else 0
                        for k, v in zip(lk, lv)])
    want_total = (np.maximum(matches, 1) if how == "left" else matches).sum()
    assert sum(int(x) for x in got.total) == want_total


def test_distributed_groupby_collect_matches_reference(jmesh, pmesh,
                                                       fixed_tables):
    ptab, jtab = fixed_tables
    want = jdist.distributed_groupby_collect(
        jdist.shard_table(jtab, jmesh), [0], 1, jmesh, capacity=128,
        distinct=True)
    got = dist.distributed_groupby_collect(
        dist.shard_table(ptab, pmesh), [0], 1, pmesh, capacity=128,
        distinct=True)
    tp.assert_same_valid_table(Table([got.table.column(0)]),
                               _jtable([want.table.column(0)]))
    tp.assert_same_list_column(got.table.column(1), want.table.column(1))


@pytest.mark.parametrize("keys", [[0, 1], [2], [4]],
                         ids=["int_keys", "string_key", "float_key"])
def test_distributed_sort_matches_reference(jmesh, pmesh, tables, keys):
    ptab, jtab = tables
    jsh, jrv = jdist.shard_table(jtab, jmesh, return_row_valid=True)
    psh, prv = dist.shard_table(ptab, pmesh, return_row_valid=True)
    spl = psort.plan_splitters(_global(pmesh, psh), keys[0], D)
    tp.assert_same_array(spl, jsort.plan_splitters(jsh, keys[0], D))
    # the reference's step traced once (its shard_map runs op by op
    # otherwise), with the same splitters
    want = jax.jit(lambda tb, rv: jsort.distributed_sort(
        tb, keys, jmesh, row_valid=rv, splitters=spl))(jsh, jrv)
    got = psort.distributed_sort(psh, keys, pmesh, row_valid=prv)
    tp.assert_same_array(np.array([int(x) for x in got.num_rows], np.int64),
                         np.asarray(want.num_rows), "num_rows")
    tp.assert_same_valid_table(_global(pmesh, got.table), want.table)
    collected = dist.collect(got.table, got.num_rows, pmesh)
    tp.assert_same_valid_table(collected, jdist.collect(
        want.table, want.num_rows, jmesh))


# ---- the shuffle.transport seam --------------------------------------------


@pytest.mark.parametrize("make,retried", [
    (lambda: ConnectionError("reset"), True),
    (lambda: TimeoutError("slow peer"), True),
    (lambda: OSError("broken pipe"), False),
    (lambda: resilience.CorruptDataError("bad frame"), True)],
    ids=["connection", "timeout", "oserror", "corrupt"])
def test_transport_seam_classifies_as_the_reference(make, retried):
    from spark_rapids_jni_tpu.runtime import resilience as jres

    exc = make()
    jexc = jres.CorruptDataError("bad frame") \
        if isinstance(exc, resilience.CorruptDataError) else exc
    for seam in ("shuffle.transport", "outofcore.chunk"):
        assert resilience.classify(exc, seam=seam).__name__ == \
            jres.classify(jexc, seam=seam).__name__
        assert resilience.is_transient(exc, seam=seam) == \
            jres.is_transient(jexc, seam=seam)
    assert resilience.is_transient(exc, seam="shuffle.transport") is retried


def test_join_replays_a_transient_transport_fault(pmesh, tables):
    from spark_rapids_jni_tpu_torch.runtime import faults

    ptab, _ = tables
    shards, rv = dist.shard_table(ptab, pmesh, return_row_valid=True)
    right = dist.shard_table(Table([ptab.column(0), ptab.column(1)]),
                             pmesh)
    want = dist.distributed_join(shards, right, 0, 0, pmesh, 4096,
                                 left_row_valid=rv)
    script = faults.FaultScript([faults.FaultSpec(
        "shuffle.transport", ConnectionError("peer reset"))])
    telemetry.reset()
    with faults.inject(script):
        got = dist.distributed_join(shards, right, 0, 0, pmesh, 4096,
                                    left_row_valid=rv)
    assert [e["event"] for e in telemetry.events("resilience")] == [
        "retry", "recovered"]
    assert telemetry.counter("faults.injected.shuffle.transport") == 1
    for g, w in zip(got.table, want.table):
        assert g.equals(w)
