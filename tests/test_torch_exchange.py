"""The port's exchange (``runtime/exchange.py``), its plan node in
``fusion.execute``, and the cluster's distributed exchange, against the
JAX package's.

1. ``exchange_local`` at the bucket edges (1, 255, 256, 257 rows, null
   tails, padded strings) delivers the reference's destinations in the
   reference's order; ``partitioned_groupby`` and ``partitioned_join``
   equal the reference's; the ``Exchange`` root carries plain wire meta
   and ``split_wire`` refuses malformed counts, classified.
2. The interior ``Exchange`` runs as region -> exchange -> region,
   bit-identical to the hand-split pair, to the ``exchange_local``
   oracle and to the reference's ``execute``; ``parts=0`` is sized
   from the learned density.
3. The skew ladder: escalation, chunked flights, the spill merge, the
   limiter back at 0; the flights' counts and capacities are the
   reference's.
4. A flight corrupted on ``exchange.wire`` is NAKed and refetched
   bit-identical; exhaustion dies classified; ``bytes_wire`` counts each
   flight once.
5. Over a 2-host cluster of CPU workers: q13's exchange (direct, routed,
   the single-plan form) equals ``tpch_q13_local`` and the reference's;
   a skewed exchange takes the router's spill merge; the peer gateway
   refuses unsigned dials; the fallback ladder holds rung by rung. (The
   exchange's SIGKILL drills are in ``test_torch_cluster.py``.)

The cluster tests share one module-scoped cluster. Inputs are made from
seeds with numpy. Tolerance: exact everywhere (every column here is an
integer)."""

from __future__ import annotations

import socket
import threading

import numpy as np
import pytest

from spark_rapids_jni_tpu.models import tpch as jtpch
from spark_rapids_jni_tpu.ops import strings as jstrings
from spark_rapids_jni_tpu.runtime import exchange as jxch
from spark_rapids_jni_tpu.runtime import fusion as jfusion
from spark_rapids_jni_tpu.utils import config as jconfig
from spark_rapids_jni_tpu_torch import telemetry
from spark_rapids_jni_tpu_torch import types as t
from spark_rapids_jni_tpu_torch.columnar import Column, Table
from spark_rapids_jni_tpu_torch.models import tpch
from spark_rapids_jni_tpu_torch.ops.groupby import groupby_aggregate
from spark_rapids_jni_tpu_torch.ops.hash import partition_hash
from spark_rapids_jni_tpu_torch.ops.strings import pad_strings
from spark_rapids_jni_tpu_torch.ops.table_ops import (
    concatenate,
    trim_table,
)
from spark_rapids_jni_tpu_torch.parallel import dcn
from spark_rapids_jni_tpu_torch.runtime import (
    cluster,
    faults,
    fleet,
    fusion,
    resilience,
    resultcache,
    rtfilter,
)
from spark_rapids_jni_tpu_torch.runtime import exchange as xch
from spark_rapids_jni_tpu_torch.runtime.memory import (
    MemoryLimiter,
    SpillStore,
    table_nbytes,
)
from spark_rapids_jni_tpu_torch.telemetry import REGISTRY
from spark_rapids_jni_tpu_torch.utils.config import reset_option, set_option
from torch_parity import (
    assert_same_table_rows,
    assert_same_valid_table,
    jax_table,
    null_tail,
    quick_reference_compiles,
    to_port,
)

SERVE_DELAY = fleet._ENV_SERVE_DELAY
WAIT_S = 120


@pytest.fixture(autouse=True, scope="module")
def _quick_compiles():
    """The reference's programs at XLA's lowest optimisation level:
    every value here is an integer, the same either way."""
    with quick_reference_compiles():
        yield


@pytest.fixture(autouse=True)
def _isolated():
    telemetry.reset()
    set_option("fleet.heartbeat_interval_s", 0.1)
    set_option("fleet.restart_backoff_s", 0.1)
    yield
    for k in ("fleet.heartbeat_interval_s", "fleet.restart_backoff_s",
              "exchange.max_capacity_rows", "exchange.merge_budget_bytes",
              "exchange.target_rows_per_part", "resilience.max_attempts",
              "fleet.result_memo_entries"):
        reset_option(k)


def _fp(table):
    return resultcache.table_fingerprint(table)


def _rows(tbl):
    """The row multiset of a port table (sorted), nulls as None."""
    if tbl.num_rows == 0:
        return []
    cols = []
    for c in tbl.columns:
        valid = c.valid_mask().tolist()
        if c.dtype.is_string:
            lens, chars = c.data.tolist(), c.chars.numpy()
            vals = [bytes(chars[i, :lens[i]]).decode()
                    for i in range(tbl.num_rows)]
        else:
            vals = c.data.tolist()
        cols.append([v if ok else None for v, ok in zip(vals, valid)])
    return sorted(zip(*cols), key=repr)


def _mixed(n, seed=11, nkeys=37):
    """Key + int payload with a null tail + padded string payload, in
    both packages."""
    rng = np.random.default_rng(seed)
    key = rng.integers(0, nkeys, n).astype(np.int64)
    val = rng.integers(-50, 50, n).astype(np.int64)
    strs = [f"s{int(k)}-{i % 5}".encode() for i, k in enumerate(key)]
    offsets = np.zeros(n + 1, np.int32)
    np.cumsum([len(s) for s in strs], out=offsets[1:])
    chars = np.frombuffer(b"".join(strs), np.uint8).copy()
    jtab = jax_table([
        (int(t.TypeId.INT64), 0, key, None),
        (int(t.TypeId.INT64), 0, val, null_tail(n, seed)),
        (int(t.TypeId.STRING), 0, (offsets, chars), None)])
    tab = to_port(jtab)
    tab = Table(tab.columns[:2] + [pad_strings(tab.columns[2])])
    jtab = type(jtab)(jtab.columns[:2]
                      + [jstrings.pad_strings(jtab.columns[2])])
    return tab, jtab


def _skewed(n=2000, hot_frac=0.9, seed=3):
    """One hot key owning ``hot_frac`` of the rows + a ones column."""
    rng = np.random.default_rng(seed)
    key = rng.integers(1, 16, n).astype(np.int64)
    key[rng.random(n) < hot_frac] = 0
    return Table([Column.from_numpy(key, device="cpu"),
                  Column.from_numpy(np.ones(n, np.int64), device="cpu")])


def _events(event):
    return [r for r in telemetry.events("exchange") if r.get("event") == event]


# ---------------------------------------------------------------------------
# 1. the pack at the bucket edges, the local partitioned operators
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rows", [1, 255, 256, 257])
def test_exchange_local_equals_the_reference_at_bucket_edges(rows):
    tab, jtab = _mixed(rows)
    dests = xch.exchange_local(tab, [0], 3)
    jdests = jxch.exchange_local(jtab, [0], 3)
    assert len(dests) == 3
    for p, (d, jd) in enumerate(zip(dests, jdests)):
        # the same rows in the same order, nulls and strings included
        assert_same_table_rows(d, jd, f"destination {p}")
        if d.num_rows:
            assert partition_hash(d, [0], 3).tolist() == [p] * d.num_rows
    assert sum(d.num_rows for d in dests) == rows
    assert _rows(concatenate([d for d in dests if d.num_rows])) == \
        _rows(tab)
    assert telemetry.counter("exchange.overflow_escalations") == 0


@pytest.mark.parametrize("rows", [256, 257])
def test_partitioned_groupby_equals_the_reference(rows):
    tab, jtab = _mixed(rows)
    aggs = [(1, "count"), (1, "sum")]
    got = xch.partitioned_groupby(tab, [0], aggs, parts=3)
    want = jxch.partitioned_groupby(jtab, [0], aggs, parts=3)
    assert_same_table_rows(got, want)
    g = groupby_aggregate(tab, [0], aggs, max_groups=None)
    assert _rows(got) == _rows(trim_table(g.table, int(g.num_groups)))


def test_partitioned_join_equals_the_reference():
    rng = np.random.default_rng(5)
    lhost = [(int(t.TypeId.INT64), 0,
              rng.integers(0, 20, 300).astype(np.int64), None),
             (int(t.TypeId.INT64), 0, np.arange(300, dtype=np.int64), None)]
    rhost = [(int(t.TypeId.INT64), 0,
              rng.integers(0, 20, 80).astype(np.int64), None),
             (int(t.TypeId.INT64), 0, np.arange(80, dtype=np.int64) * 10,
              None)]
    jl, jr = jax_table(lhost), jax_table(rhost)
    got = xch.partitioned_join(to_port(jl), to_port(jr), 0, 0, parts=2)
    assert_same_valid_table(got, jxch.partitioned_join(jl, jr, 0, 0,
                                                       parts=2))
    want = sorted((int(k), int(v), int(k2), int(w))
                  for k, v in zip(lhost[0][2], lhost[1][2])
                  for k2, w in zip(rhost[0][2], rhost[1][2]) if k == k2)
    assert sorted(_rows(got)) == want


def test_exchange_root_carries_wire_meta_and_split_inverts():
    tab, _ = _mixed(500)
    plan = fusion.Plan("xroot", fusion.Exchange(
        fusion.Scan("rows"), keys=(0,), parts=3, label="ex"))
    fused = fusion.execute(plan, {"rows": tab})
    assert (fused.meta["ex.parts"], fused.meta["ex.rows"],
            fused.meta["ex.flights"]) == (3, 500, 1)
    rc = fused.meta["ex.row_counts"]
    assert isinstance(rc, list) and all(isinstance(c, int) for c in rc)
    per_dest = xch.split_wire(fused.table, rc, 3)
    assert _rows(concatenate([f for fls in per_dest for f in fls])) == \
        _rows(tab)
    with pytest.raises(resilience.MalformedInputError, match="row_counts"):
        xch.split_wire(fused.table, rc[:-1], 3)
    with pytest.raises(resilience.MalformedInputError, match="sum"):
        xch.split_wire(fused.table, [c + 1 for c in rc[:1]] + rc[1:], 3)


# ---------------------------------------------------------------------------
# 2. the interior Exchange
# ---------------------------------------------------------------------------


def _midplan(fz, name, parts, label="ex"):
    return fz.Plan(name, fz.GroupBy(
        fz.Exchange(
            fz.GroupBy(fz.Scan("rows"), (0,), ((1, "sum"),),
                       max_groups=None, label="partial"),
            keys=(0,), parts=parts, valid_meta="partial.num_groups",
            label=label),
        (0,), ((1, "sum"),), max_groups=None, label="merge"))


@pytest.mark.parametrize("rows", [1, 255, 256, 257])
def test_midplan_exchange_equals_the_pair_and_the_reference(rows):
    tab, jtab = _mixed(rows)
    parts = 3
    got = fusion.execute(_midplan(fusion, "edge_mid", parts), {"rows": tab})
    assert got.meta["ex.parts"] == parts
    assert telemetry.counter("fusion.midplan_exchanges") == 1
    pack, merge, binding, _ = fusion.split_at_exchange(
        _midplan(fusion, "edge_mid", parts))
    fused = fusion.execute(pack, {"rows": tab})
    outs = []
    for fls in xch.split_wire(fused.table, fused.meta["ex.row_counts"],
                              parts):
        if fls:
            r = fusion.execute(merge, {binding: concatenate(fls)
                                       if len(fls) > 1 else fls[0]})
            outs.append(trim_table(r.table,
                                   int(r.meta["merge.num_groups"])))
    assert _fp(got.table) == _fp(concatenate(outs) if len(outs) > 1
                                 else outs[0])
    assert got.meta["merge.num_groups"] == got.table.num_rows
    if rows == 257:  # the reference compiles per shape: one edge
        want = jfusion.execute(_midplan(jfusion, "edge_mid", parts),
                               {"rows": jtab})
        assert_same_valid_table(got.table, want.table)


@pytest.mark.parametrize("rows", [255, 257])
def test_raw_midplan_exchange_equals_exchange_local(rows):
    tab, _ = _mixed(rows)
    mid = fusion.Plan("raw_mid", fusion.GroupBy(
        fusion.Exchange(fusion.Scan("rows"), keys=(0,), parts=3,
                        label="ex"),
        (0,), ((1, "sum"),), max_groups=None, label="merge"))
    got = fusion.execute(mid, {"rows": tab})
    outs = []
    for d in xch.exchange_local(tab, [0], 3):
        if d.num_rows:
            g = groupby_aggregate(d, [0], [(1, "sum")], max_groups=None)
            outs.append(trim_table(g.table, int(g.num_groups)))
    assert _fp(got.table) == _fp(concatenate(outs))


def test_auto_parts_from_the_learned_density():
    rtfilter.reset()
    set_option("exchange.target_rows_per_part", 64)
    try:
        tab, _ = _mixed(600, nkeys=300)
        r1 = fusion.execute(_midplan(fusion, "auto_mid", 0), {"rows": tab})
        assert r1.meta["ex.parts"] == 1  # no history
        r2 = fusion.execute(_midplan(fusion, "auto_mid", 0), {"rows": tab})
        assert r2.meta["ex.parts"] > 1
        assert _rows(r2.table) == _rows(r1.table)
        reasons = {r.get("reason") for r in _events("parts_decision")}
        assert {"no_history", "learned_density"} <= reasons
    finally:
        rtfilter.reset()


def test_q13_plans_equal_the_reference():
    jorders = jtpch.orders_table(900, 120, seed=5)
    orders = to_port(jorders)
    for parts in (1, 2, 3):
        local = tpch.tpch_q13_local(orders, parts)
        mid = fusion.execute(tpch.q13_midplan_plan(parts),
                             {"orders": orders})
        # each destination's merge sorts its keys: the one-plan form is
        # bit-identical to the sharded oracle
        assert _fp(mid.table) == _fp(local)
        assert _rows(mid.table) == _rows(tpch.tpch_q13_reference(orders))
    # the reference compiles its local q13 per part count: one count
    assert_same_valid_table(tpch.tpch_q13_local(orders, 2),
                            _reference_q13(5))
    pack, _ = tpch.q13_exchange_plans(2)
    jpack, _ = jtpch.q13_exchange_plans(2)
    got = fusion.execute(pack, {"orders": orders})
    want = jfusion.execute(jpack, {"orders": jorders})
    assert got.meta["exchange.row_counts"] == \
        want.meta["exchange.row_counts"]
    assert_same_valid_table(got.table, want.table)


# ---------------------------------------------------------------------------
# 3. the skew ladder
# ---------------------------------------------------------------------------


def test_skewed_hot_key_rides_the_full_spill_ladder_zero_leaks():
    set_option("exchange.max_capacity_rows", 256)
    jconfig.set_option("exchange.max_capacity_rows", 256)
    try:
        tab = _skewed(1200)
        flights = xch.pack_flights(tab, [0], 4)
        jflights = jxch.pack_flights(jax_table([
            (int(t.TypeId.INT64), 0, c.data.numpy(), None)
            for c in tab.columns]), [0], 4)
    finally:
        jconfig.reset_option("exchange.max_capacity_rows")
    assert [(f.counts.tolist(), f.capacity) for f in flights] == \
        [(np.asarray(f.counts).tolist(), f.capacity) for f in jflights]
    assert len(flights) > 1 and all(f.capacity <= 256 for f in flights)
    assert telemetry.counter("exchange.overflow_escalations") >= 1
    assert telemetry.counter("exchange.chunked_flights") == 1
    assert _events("overflow_escalate") and _events("chunked_flights")
    per_dest = [[] for _ in range(4)]
    for res in flights:
        for p, s in enumerate(xch.flight_slices(res)):
            if s.num_rows:
                per_dest[p].append(s)
    hot = max(per_dest, key=lambda fl: sum(s.num_rows for s in fl))
    assert len(hot) > 1 and sum(s.num_rows for s in hot) >= 1080

    def merge_step(chunk):
        g = groupby_aggregate(chunk, [0], [(1, "sum")], max_groups=None)
        return trim_table(g.table, int(g.num_groups))

    budget = sum(table_nbytes(f) for f in hot) * 4
    limiter = MemoryLimiter(budget)
    spill = SpillStore(max(table_nbytes(merge_step(f)) for f in hot) + 1)
    res = xch.merge_flights(hot, merge_step, merge_step,
                            budget_bytes=budget, limiter=limiter,
                            spill=spill)
    assert res.spill_stats["spills"] > 0
    assert telemetry.counter("exchange.spill_demotions") > 0
    assert _events("spill_demote")
    assert limiter.used == 0, "leaked reservations"
    assert _rows(res.table) == _rows(merge_step(concatenate(hot)))


def test_rung1_escalation_keeps_moderate_skew_in_one_flight():
    tab = _skewed(1000, hot_frac=0.6)
    flights = xch.pack_flights(tab, [0], 4, capacity=64)
    assert len(flights) == 1
    assert int(flights[0].counts.max()) <= flights[0].capacity
    assert int(flights[0].counts.sum()) == 1000
    assert telemetry.counter("exchange.overflow_escalations") >= 1
    assert telemetry.counter("exchange.chunked_flights") == 0


def test_total_skew_demotes_to_chunked_flights_and_pack_faults_retry():
    set_option("exchange.max_capacity_rows", 8)
    flights = xch.pack_flights(_skewed(64, hot_frac=1.0), [0], 2)
    assert len(flights) >= 2
    assert sum(int(f.counts.sum()) for f in flights) == 64
    assert all(int(f.counts.max()) <= f.capacity for f in flights)
    assert telemetry.counter("exchange.chunked_flights") == 1
    # a transient fault at the exchange.pack seam replays the attempt
    script = faults.FaultScript([faults.FaultSpec(
        "exchange.pack", resilience.TransientDeviceError("injected"),
        seq=1)])
    reset_option("exchange.max_capacity_rows")
    with faults.inject(script):
        again = xch.pack_flights(_skewed(64, hot_frac=0.5), [0], 2)
    assert script.fired and int(again[0].counts.sum()) == 64


# ---------------------------------------------------------------------------
# 4. wire corruption
# ---------------------------------------------------------------------------


def _flight_roundtrip(tbl, script=None):
    a, b = socket.socketpair()
    a.settimeout(WAIT_S)
    b.settimeout(WAIT_S)
    out, err = {}, {}

    def _rx():
        try:
            out["tbl"] = xch.recv_flight(b, 7, device="cpu")
        except BaseException as exc:  # surfaced below
            err["rx"] = exc

    th = threading.Thread(target=_rx)
    try:
        with faults.inject(script or faults.FaultScript()):
            th.start()
            try:
                xch.send_flight(a, tbl, 7, dest=1)
            except BaseException as exc:  # surfaced below
                err["tx"] = exc
            th.join(WAIT_S)
        assert not th.is_alive(), "receiver hung"
    finally:
        a.close()
        b.close()
    return out.get("tbl"), err


def test_clean_flight_counts_wire_bytes_once():
    tbl = _skewed(300)
    got, err = _flight_roundtrip(tbl)
    assert not err and _fp(got) == _fp(tbl)
    assert telemetry.counter("exchange.flights") == 1
    assert telemetry.counter("exchange.bytes_raw") > 0
    wire = telemetry.counter("exchange.bytes_wire")
    assert wire > 0 and telemetry.counter("exchange.bytes_direct") == wire
    assert telemetry.counter("integrity.refetch") == 0
    # the routed rung re-sends the same blob: only the lane counts
    blob = dcn.serialize_table(tbl)
    a, b = socket.socketpair()
    a.settimeout(WAIT_S)
    b.settimeout(WAIT_S)
    out = {}
    th = threading.Thread(target=lambda: out.update(
        t=xch.recv_flight(b, 9, device="cpu")))
    try:
        th.start()
        xch.send_flight_blob(a, blob, 9, lane="routed")
        th.join(WAIT_S)
    finally:
        a.close()
        b.close()
    assert _fp(out["t"]) == _fp(tbl)
    assert telemetry.counter("exchange.bytes_wire") == wire
    assert telemetry.counter("exchange.bytes_routed") == len(blob)
    with pytest.raises(ValueError, match="lane"):
        xch.send_flight_blob(None, b"", 0, lane="sideways")


@pytest.mark.parametrize("mode", ["flip", "truncate"])
def test_exchange_wire_corruption_refetches_bit_identical(mode):
    tbl = _skewed(300)
    script = faults.FaultScript(corruptions=[
        faults.CorruptionSpec("exchange.wire", mode=mode, seed=19)])
    got, err = _flight_roundtrip(tbl, script)
    assert not err, err
    assert script.fired == [("exchange.wire", 7)]
    assert _fp(got) == _fp(tbl)
    assert telemetry.counter("integrity.refetch") == 1


def test_exchange_wire_exhaustion_dies_classified():
    set_option("resilience.max_attempts", 2)
    script = faults.FaultScript(corruptions=[
        faults.CorruptionSpec("exchange.wire", mode="flip", times=10,
                              seed=5)])
    got, err = _flight_roundtrip(_skewed(100), script)
    assert got is None
    assert isinstance(err.get("tx"), resilience.FatalExecutionError)
    assert isinstance(err.get("rx"), resilience.FatalExecutionError)
    assert telemetry.counter("integrity.refetch") == 2


# ---------------------------------------------------------------------------
# 5. the distributed exchange over a cluster of CPU workers
# ---------------------------------------------------------------------------


def _orders(rows=900, customers=120, seed=5):
    jorders = jtpch.orders_table(rows, customers, seed=seed)
    return to_port(jorders), jorders


_REF_Q13: dict = {}


def _reference_q13(seed):
    """The reference's ``tpch_q13_local(orders, 2)`` of ``_orders(seed)``
    (computed once a seed)."""
    if seed not in _REF_Q13:
        _REF_Q13[seed] = jtpch.tpch_q13_local(_orders(seed=seed)[1], 2)
    return _REF_Q13[seed]


@pytest.fixture(scope="module")
def mesh():
    """One 2-host cluster for the tests that kill no host."""
    set_option("fleet.heartbeat_interval_s", 0.1)
    with cluster.QueryCluster(2, device="cpu") as c:
        assert c.wait_live(timeout=WAIT_S) == 2
        yield c


def _q13(c, sid, table, direct=None):
    pack, merge = tpch.q13_exchange_plans(2)
    xt = c.submit_exchange(
        sid, pack, merge, table=table, binding="orders",
        merge_binding="partials", merge_valid_meta="merge.num_groups",
        direct=direct)
    return xt, xt.result(timeout=WAIT_S)


def test_distributed_q13_equals_the_oracle_and_the_reference(mesh):
    orders, _ = _orders()
    oracle = tpch.tpch_q13_local(orders, 2)
    assert_same_valid_table(oracle, _reference_q13(5))
    assert _rows(oracle) == _rows(tpch.tpch_q13_reference(orders))
    mesh.register_table("orders", orders, keys=(tpch.O_ORDERKEY,))
    xt, got = _q13(mesh, "s0", "orders")
    assert _fp(got) == _fp(oracle) == xt.fingerprint
    assert telemetry.counter("cluster.exchanges") == 1
    assert telemetry.counter("cluster.exchanges_direct") == 1
    assert telemetry.counter("cluster.exchange_direct_fallbacks") == 0
    assert telemetry.counter("exchange.bytes_direct") > 0
    assert telemetry.counter("exchange.bytes_routed") == 0
    # routed, and a repeat: bit-identical, memo-checked
    _, routed = _q13(mesh, "s1", "orders", direct=False)
    assert _fp(routed) == _fp(oracle)
    _, again = _q13(mesh, "s2", "orders")
    assert _fp(again) == _fp(oracle)
    assert telemetry.counter("fleet.identity_mismatch") == 0
    mesh.fresh_loads()
    assert mesh.leaked_bytes() == 0


def test_single_plan_form_over_the_mesh(mesh):
    orders, _ = _orders(seed=13)
    mesh.register_table("morders", orders, keys=(tpch.O_ORDERKEY,))
    xt = mesh.submit_exchange("m2", tpch.q13_midplan_plan(0),
                              table="morders", binding="orders")
    got = xt.result(timeout=WAIT_S)
    assert _fp(got) == _fp(tpch.tpch_q13_local(orders, 2))
    assert_same_valid_table(got, _reference_q13(13))


def test_direct_moves_fewer_supervisor_link_bytes_than_routed(mesh):
    orders, _ = _orders(seed=7)
    ref_fp = _fp(tpch.tpch_q13_local(orders, 2))
    mesh.register_table("xorders", orders, keys=(tpch.O_ORDERKEY,))
    set_option("fleet.result_memo_entries", 0)
    link = REGISTRY.counter("fleet.link_bytes")
    sizes = {}
    for direct in (True, False):
        _q13(mesh, "w", "xorders", direct=direct)  # warm
        base = link.value
        _, got = _q13(mesh, "m", "xorders", direct=direct)
        sizes[direct] = link.value - base
        assert _fp(got) == ref_fp
    assert sizes[True] < sizes[False], sizes


def test_skewed_exchange_under_a_tight_budget_takes_the_spill_merge(mesh):
    tbl = _skewed(2400)
    tbl = Table(list(tbl.columns) + [Column.from_numpy(
        np.arange(2400, dtype=np.int64), device="cpu")])
    oracle = xch.partitioned_groupby(tbl, [0], [(1, "sum")], parts=2)
    pack = fusion.Plan("skew_pack", fusion.Exchange(
        fusion.Scan("rows"), keys=(0,), parts=2, label="exchange"))
    merge = fusion.Plan("skew_merge", fusion.GroupBy(
        fusion.Scan("partials"), (0,), ((1, "sum"),),
        max_groups=None, label="merge"))
    flight = max(table_nbytes(d)
                 for shard in dcn.partition_for_slices(tbl, [2], 2)
                 for d in xch.exchange_local(shard, [0], 2) if d.num_rows)
    mesh.register_table("rows", tbl, keys=(2,))
    xt = mesh.submit_exchange(
        "s2", pack, merge, table="rows", binding="rows",
        merge_binding="partials", merge_valid_meta="merge.num_groups",
        merge_budget_bytes=int(flight * 1.5), direct=False)
    assert _rows(xt.result(timeout=WAIT_S)) == _rows(oracle)
    assert telemetry.counter("cluster.exchange_spill_merges") >= 1
    mesh.fresh_loads()
    assert mesh.leaked_bytes() == 0


def test_peer_dial_failure_falls_back_rung_by_rung(mesh):
    orders, _ = _orders(seed=11)
    ref_fp = _fp(tpch.tpch_q13_local(orders, 2))
    mesh.register_table("forders", orders, keys=(tpch.O_ORDERKEY,))
    saved = dict(mesh._peer_addrs)
    assert len(saved) == 2
    try:
        dead = socket.socket()
        dead.bind(("127.0.0.1", 0))
        port = dead.getsockname()[1]
        dead.close()
        # rung 1: no one listens at the peers' addresses: each flight to
        # another host routes through the supervisor inside the protocol
        mesh._peer_addrs.update({k: ("127.0.0.1", port) for k in saved})
        assert _fp(_q13(mesh, "f0", "forders")[1]) == ref_fp
        assert telemetry.counter("exchange.bytes_routed") > 0
        assert telemetry.counter("exchange.bytes_direct") > 0
        assert telemetry.counter("cluster.exchange_direct_fallbacks") == 0
        # rung 2: no gateway known: the whole exchange takes the routed
        # path
        mesh._peer_addrs.clear()
        assert _fp(_q13(mesh, "f1", "forders")[1]) == ref_fp
        assert telemetry.counter("cluster.exchange_direct_fallbacks") == 1
        assert [r for r in telemetry.events("fleet")
                if r.get("event") == "direct_fallback"]
    finally:
        mesh._peer_addrs.clear()
        mesh._peer_addrs.update(saved)


def test_peer_flight_server_refuses_unsigned_dials():
    key = dcn.grant_key("boot-secret")
    srv = dcn.PeerFlightServer(key, dest="h1")
    try:
        blob = xch.serialize_flight(_skewed(64), op="test.peer")
        fp = dcn.flight_fingerprint(blob)

        def _dial(grant):
            dcn.send_peer_flight(
                (srv.host, srv.port), {"xid": "x1", "src": "p0", "part": 0,
                                       "grant": grant, "fp": fp},
                blob, retries=2, delay_s=0.01)

        forged = dcn.sign_grant(dcn.grant_key("wrong"), xid="x1", src="p0",
                                dest="h1", part=0)
        with pytest.raises((resilience.ResilienceError, OSError)):
            _dial(forged)
        assert telemetry.counter("cluster.rejected_dials") == 1
        with pytest.raises((resilience.ResilienceError, OSError)):
            _dial(dcn.sign_grant(key, xid="x1", src="p0", dest="h1",
                                 part=5))
        assert telemetry.counter("cluster.rejected_dials") == 2
        assert srv._mail == {}
        _dial(dcn.sign_grant(key, xid="x1", src="p0", dest="h1", part=0))
        got = srv.wait_flights("x1", 0, ["p0"], timeout=WAIT_S)
        assert dcn.flight_fingerprint(got["p0"]) == fp
        srv.discard("x1")
        assert srv._mail == {}
    finally:
        srv.close()
