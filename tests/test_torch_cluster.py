"""The port's serving mesh across processes (``runtime/cluster.py``)
with its host workers on the CPU (``device="cpu"``), held against the
JAX package.

The chaos families of the reference's cluster tests:

1. **Bit-identity** -- a partitioned q1 fan-out over two hosts merges to
   the bits of the single-host partial -> merge algebra in process and
   of the reference's; a repeat is served from the memos. TPC-DS q72
   over the cluster (runtime filter off and on) equals the reference's
   ``tpcds_q72``, compacted.
2. **SIGKILL the hot shard's host** -- the shard is re-homed from the
   supervisor's retained blob (fingerprint checked) and the query
   completes bit-identical on the survivor; the death is a host death.
3. **Routing** -- shard queries land on the owner; ``shard_for_key``
   agrees with the map; a mis-keyed lookup and an unregistered table
   are refused, classified.
4. **Late duplicates across hosts** -- fingerprint-checked and dropped.
   The exchange's drills: a host SIGKILLed mid-exchange, routed and
   direct, fails over bit-identical to ``tpch_q13_local``.
5. **Host-stamped telemetry** -- supervisor events and worker records
   carry ``host=``; the cluster's summary section and ``top`` view.

The tests that kill no host share one module-scoped cluster. Inputs are
made from seeds with numpy. Tolerance: exact everywhere (q1's float
averages compared by their bits)."""

from __future__ import annotations

import json
import signal
import threading
import time

import pytest

from spark_rapids_jni_tpu.models import tpcds as jtpcds
from spark_rapids_jni_tpu.models import tpch as jtpch
from spark_rapids_jni_tpu.ops.table_ops import trim_table as jtrim
from spark_rapids_jni_tpu.runtime import fusion as jfusion
from spark_rapids_jni_tpu_torch import telemetry
from spark_rapids_jni_tpu_torch.columnar import Table
from spark_rapids_jni_tpu_torch.models import tpcds, tpch
from spark_rapids_jni_tpu_torch.ops.table_ops import concatenate, trim_table
from spark_rapids_jni_tpu_torch.parallel import dcn
from spark_rapids_jni_tpu_torch.runtime import (
    cluster,
    fleet,
    fusion,
    resultcache,
)
from spark_rapids_jni_tpu_torch.telemetry import top as tele_top
from spark_rapids_jni_tpu_torch.utils.config import reset_option, set_option
from torch_parity import (
    assert_same_valid_table,
    quick_reference_compiles,
    to_port,
)

SERVE_DELAY = fleet._ENV_SERVE_DELAY
WAIT_S = 120
LI_KEYS = (4, 5)  # l_returnflag, l_linestatus: q1's group keys


@pytest.fixture(autouse=True, scope="module")
def _quick_compiles():
    with quick_reference_compiles():
        yield


@pytest.fixture(autouse=True)
def _isolated_cluster():
    telemetry.reset()
    set_option("fleet.heartbeat_interval_s", 0.1)
    set_option("fleet.restart_backoff_s", 0.1)
    yield
    for k in ("fleet.heartbeat_interval_s", "fleet.restart_backoff_s",
              "rtfilter.enabled", "telemetry.enabled", "telemetry.path"):
        reset_option(k)


@pytest.fixture(scope="module")
def mesh():
    set_option("fleet.heartbeat_interval_s", 0.1)
    with cluster.QueryCluster(2, device="cpu") as c:
        assert c.wait_live(timeout=WAIT_S) == 2
        yield c


def _li(rows=300, seed=7):
    jli = jtpch.lineitem_table(rows, seed=seed)
    return to_port(jli), jli


def _fp(table):
    return resultcache.table_fingerprint(table)


def _merge_partials(results):
    """The router's q1 merge: trim each partial, concatenate, merge."""
    parts = [trim_table(r.table, int(r.meta["partial.num_groups"]))
             for r in results]
    res = fusion.execute(tpch._q1_merge_plan(),
                         {"partials": concatenate(parts)})
    return trim_table(res.table, int(res.meta["merge.num_groups"]))


def _single_host_q1(li):
    return _merge_partials([fusion.execute(tpch._q1_partial_plan(),
                                           {"chunk": li})])


def _reference_q1(jli):
    """The same algebra in the reference, over its own shards."""
    from spark_rapids_jni_tpu.ops.table_ops import concatenate as jconcat

    pres = jfusion.execute(jtpch._q1_partial_plan(), {"chunk": jli})
    part = jtrim(pres.table, int(pres.meta["partial.num_groups"]))
    res = jfusion.execute(jtpch._q1_merge_plan(),
                          {"partials": jconcat([part])})
    return jtrim(res.table, int(res.meta["merge.num_groups"]))


def _orders(rows=900, customers=120, seed=5):
    return to_port(jtpch.orders_table(rows, customers, seed=seed))


def _q13(c, sid, table, direct=None):
    pack, merge = tpch.q13_exchange_plans(2)
    xt = c.submit_exchange(
        sid, pack, merge, table=table, binding="orders",
        merge_binding="partials", merge_valid_meta="merge.num_groups",
        direct=direct)
    return xt, xt.result(timeout=WAIT_S)


def _cluster_events(event):
    return [r for r in telemetry.events("fleet")
            if str(r.get("op", "")).startswith("cluster.")
            and r.get("event") == event]


# ---------------------------------------------------------------------------
# 1. bit-identity
# ---------------------------------------------------------------------------


def test_partitioned_q1_bit_identical_and_memo_hits(mesh):
    li, jli = _li()
    ref = _single_host_q1(li)
    assert_same_valid_table(ref, _reference_q1(jli))
    c = mesh
    info = c.register_table("lineitem", li, keys=LI_KEYS)
    assert info["parts"] == 2 and info["rows"] == li.num_rows
    mt = c.submit_merge("s0", tpch._q1_partial_plan(), _merge_partials,
                        table="lineitem", binding="chunk")
    got = mt.result(timeout=WAIT_S)
    assert _fp(got) == _fp(ref) == mt.fingerprint
    assert telemetry.counter("cluster.route_local") == 2
    assert telemetry.counter("cluster.merges") == 1
    served = telemetry.counter("fleet.served")
    mt2 = c.submit_merge("s1", tpch._q1_partial_plan(), _merge_partials,
                         table="lineitem", binding="chunk")
    assert _fp(mt2.result(timeout=WAIT_S)) == _fp(ref)
    assert telemetry.counter("fleet.served") == served
    assert telemetry.counter("fleet.memo_hits") >= 2
    c.fresh_loads()
    assert c.leaked_bytes() == 0


@pytest.mark.parametrize("rtf", [False, True])
def test_q72_cluster_equals_the_reference(mesh, rtf):
    port, ref = [], []
    for name, args, kw in (
            ("catalog_sales_table", (2000,), {"num_items": 40, "seed": 1}),
            ("date_dim_table", (), {}), ("item_table", (40,), {}),
            ("inventory_table", (), {"num_items": 40})):
        port.append(getattr(tpcds, name)(*args, device="cpu", **kw))
        ref.append(getattr(jtpcds, name)(*args, **kw))
    mesh.register_table("catalog_sales", port[0], keys=(0,))
    set_option("rtfilter.enabled", rtf)
    got = tpcds.tpcds_q72_cluster(mesh, f"q72-{rtf}", *port[1:])
    assert telemetry.counter("rtfilter.decision.apply") == int(rtf)
    want = jtpcds.tpcds_q72(*ref)
    want = jtpcds._compact_valid_keys(
        jtrim(want.table, int(want.num_groups)), 2, [2, 0], [False, True])
    assert_same_valid_table(got, want)
    local = tpcds.tpcds_q72(*port)
    assert _fp(got) == _fp(tpcds._compact_valid_keys(
        trim_table(local.table, int(local.num_groups)), 2, [2, 0],
        [False, True]))


# ---------------------------------------------------------------------------
# 2. kill the hot shard's host
# ---------------------------------------------------------------------------


def test_sigkill_hot_shard_host_fails_over_bit_identical():
    li, _ = _li()
    shard0 = dcn.partition_for_slices(li, list(LI_KEYS), 2)[0]
    ref_fp = _fp(fusion.execute(tpch._q1_partial_plan(),
                                {"chunk": shard0}).table)
    with cluster.QueryCluster(2, device="cpu", per_replica_env={
            "h0": {SERVE_DELAY: "1500"}}) as c:
        assert c.wait_live(timeout=WAIT_S) == 2
        assert c.register_table("lineitem", li,
                                keys=LI_KEYS)["owners"][0] == "h0"
        t = c.submit_to_shard("s0", tpch._q1_partial_plan(),
                              table="lineitem", binding="chunk", part=0)
        deadline = time.monotonic() + 15
        while time.monotonic() < deadline and t.replica != "h0":
            time.sleep(0.01)
        assert t.replica == "h0"
        time.sleep(0.2)  # inside h0's hold
        c._host("h0").proc.send_signal(signal.SIGKILL)
        res = t.result(timeout=WAIT_S)
        assert t.status == "served" and t.dispatches == 2
        assert t.replica == "h1"
        assert _fp(res.table) == ref_fp
        assert c._tables["lineitem"].owners[0] == "h1"
        assert telemetry.counter("cluster.host_deaths") == 1
        assert telemetry.counter("cluster.route_rehomed") == 1
        deaths = _cluster_events("host_death")
        assert deaths and deaths[0]["host"] == "h0"
        assert deaths[0]["error_kind"] == "ReplicaDeadError"
        rehomes = _cluster_events("rehomed")
        assert rehomes and rehomes[0]["host"] == "h1"
        assert rehomes[0]["from_host"] == "h0"
        c.fresh_loads()
        assert c.leaked_bytes() == 0


# ---------------------------------------------------------------------------
# 3. routing
# ---------------------------------------------------------------------------


def test_partition_map_routes_to_the_owner(mesh):
    li, _ = _li(280, seed=8)
    c = mesh
    c.register_table("lineitem_r", li, keys=LI_KEYS)
    for part in range(2):
        t = c.submit_to_shard(f"s{part}", tpch._q1_partial_plan(),
                              table="lineitem_r", binding="chunk", part=part)
        t.result(timeout=WAIT_S)
        assert t.replica == c._tables["lineitem_r"].owners[part]
    assert telemetry.counter("cluster.route_local") == 2
    assert telemetry.counter("cluster.route_rehomed") == 0
    key = Table([type(li.columns[k])(li.columns[k].dtype,
                                     li.columns[k].data[:1])
                 for k in LI_KEYS])
    part = c.shard_for_key("lineitem_r", key)
    assert part in (0, 1)
    t = c.submit_to_shard("sk", tpch._q1_partial_plan(), table="lineitem_r",
                          binding="chunk", key_table=key)
    t.result(timeout=WAIT_S)
    assert t.replica in ("supervisor",
                         c._tables["lineitem_r"].owners[part])
    with pytest.raises(ValueError, match="key column"):
        c.shard_for_key("lineitem_r", Table([li.columns[4]]))
    with pytest.raises(KeyError, match="not registered"):
        c.submit_to_shard("s0", tpch._q1_partial_plan(), table="nope",
                          binding="chunk", part=0)


# ---------------------------------------------------------------------------
# 4. late duplicates across hosts
# ---------------------------------------------------------------------------


def test_late_duplicate_across_hosts_is_checked_and_dropped(mesh):
    li, _ = _li(290, seed=9)
    c = mesh
    c.register_table("lineitem_d", li, keys=LI_KEYS)
    t = c.submit_to_shard("s0", tpch._q1_partial_plan(),
                          table="lineitem_d", binding="chunk", part=0)
    res = t.result(timeout=WAIT_S)
    owner = c._host(t.replica)
    dup = {"t": "result", "qid": t.qid, "status": "served",
           "table": fleet._encode_table(res.table), "meta": {},
           "wall_ms": 1.0}
    c._on_result(owner, owner.generation, dup)
    assert telemetry.counter("fleet.duplicate_drops") == 1
    assert telemetry.counter("fleet.identity_mismatch") == 0
    other = c._host("h1" if t.replica == "h0" else "h0")
    shard1 = dcn.partition_for_slices(li, list(LI_KEYS), 2)[1]
    wrong = fusion.execute(tpch._q1_partial_plan(), {"chunk": shard1})
    c._on_result(other, other.generation,
                 dict(dup, table=fleet._encode_table(wrong.table)))
    assert telemetry.counter("fleet.duplicate_drops") == 2
    assert telemetry.counter("fleet.identity_mismatch") == 1


# ---------------------------------------------------------------------------
# 5. host-stamped telemetry and the cluster views
# ---------------------------------------------------------------------------


def test_events_and_records_host_stamped_and_views_render(tmp_path):
    li, _ = _li(200)
    path = tmp_path / "tele.jsonl"
    set_option("telemetry.enabled", True)
    set_option("telemetry.path", str(path))
    with cluster.QueryCluster(2, device="cpu") as c:
        assert c.wait_live(timeout=WAIT_S) == 2
        c.register_table("lineitem", li, keys=LI_KEYS)
        c.submit_merge("s0", tpch._q1_partial_plan(), _merge_partials,
                       table="lineitem", binding="chunk").result(
                           timeout=WAIT_S)
        dialed = _cluster_events("host_dialed_in")
        assert {r["host"] for r in dialed} == {"h0", "h1"}
        for r in _cluster_events("local"):
            assert r["host"] in ("h0", "h1")
        s = telemetry.summary()
        assert s["cluster"].get("local") == 2
        assert s["cluster"].get("merged") == 1
        assert s["cluster"].get("host_dialed_in") == 2
        snap = c.inspect()
        assert snap["cluster"] is True
        assert snap["tables"]["lineitem"]["owners"] == ["h0", "h1"]
        assert snap["counters"]["cluster.route_local"] == 2
        text = tele_top.render_cluster(tele_top.collect_cluster())
        assert "lineitem" in text and "routing:" in text
    assert c not in cluster.live_clusters()
    recs = [json.loads(line) for line in path.read_text().splitlines()]
    assert {r.get("host") for r in recs} >= {"h0", "h1"}
    # the workers' own records (their registrations) carry host= too
    assert [r for r in recs if r.get("kind") == "server"
            and r.get("host") in ("h0", "h1")]


# ---------------------------------------------------------------------------
# the exchange's SIGKILL drills
# ---------------------------------------------------------------------------


def test_sigkill_host_mid_exchange_fails_over_bit_identical():
    orders = _orders()
    ref_fp = _fp(tpch.tpch_q13_local(orders, 2))
    pack, merge = tpch.q13_exchange_plans(2)
    with cluster.QueryCluster(2, device="cpu", per_replica_env={
            "h0": {SERVE_DELAY: "1500"}}) as c:
        assert c.wait_live(timeout=WAIT_S) == 2
        assert c.register_table("orders", orders,
                                keys=(tpch.O_ORDERKEY,))["owners"][0] == "h0"
        xt = c.submit_exchange(
            "s0", pack, merge, table="orders", binding="orders",
            merge_binding="partials", merge_valid_meta="merge.num_groups",
            direct=False)
        t0 = xt.tickets[0]
        deadline = time.monotonic() + 15
        while time.monotonic() < deadline and t0.replica != "h0":
            time.sleep(0.01)
        time.sleep(0.2)  # inside h0's hold: the pack is in flight
        c._host("h0").proc.send_signal(signal.SIGKILL)
        assert _fp(xt.result(timeout=WAIT_S)) == ref_fp
        assert t0.dispatches == 2
        assert telemetry.counter("cluster.host_deaths") == 1
        c.fresh_loads()
        assert c.leaked_bytes() == 0


def test_sigkill_host_mid_direct_flight_falls_back_bit_identical():
    orders = _orders()
    ref_fp = _fp(tpch.tpch_q13_local(orders, 2))
    with cluster.QueryCluster(2, device="cpu", per_replica_env={
            "h0": {SERVE_DELAY: "1500"}}) as c:
        assert c.wait_live(timeout=WAIT_S) == 2
        c.register_table("orders", orders, keys=(tpch.O_ORDERKEY,))
        out, done = {}, threading.Event()

        def _run():
            try:
                out["fp"] = _fp(_q13(c, "s0", "orders")[1])
            except BaseException as exc:  # surfaced below
                out["err"] = exc
            finally:
                done.set()

        th = threading.Thread(target=_run)
        th.start()
        time.sleep(0.5)  # inside h0's xpack hold
        c._host("h0").proc.send_signal(signal.SIGKILL)
        assert done.wait(WAIT_S)
        th.join(10)
        assert out.get("err") is None, repr(out.get("err"))
        assert out["fp"] == ref_fp
        assert telemetry.counter("cluster.exchange_direct_fallbacks") >= 1
        assert telemetry.counter("cluster.host_deaths") == 1
        c.fresh_loads()
        assert c.leaked_bytes() == 0
