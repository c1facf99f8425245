"""The port's runtime bloom-join filters (``runtime/rtfilter.py`` and
``fusion.inject_runtime_filters``) against the JAX package's.

- ``decide``/``observe`` over one scripted sequence give the reference's
  decisions (apply or not, reason, bits, hashes), EMAs and counters.
- ``inject_runtime_filters`` on q3's general plan inserts the
  reference's node kinds, labels, ``num_bits`` and ``num_hashes``
  (structure compared, not callables).
- ``tpch_q3`` with the filter on equals it off and the reference's
  unfiltered q3; the harvest feeds the gate one read per probe.
- The pruned out-of-core q3, serial (device chunks pruned on the device)
  and pipelined (host chunks pruned before staging), equals the port's
  unpruned q3 and the numpy oracle, and decides
  ``no_history_optimistic`` then ``selective``. (The reference's own
  pruned path fails its test in every run, so it is no oracle here.)
- ``prune_chunk`` keeps null keys, order and ``min_rows``, keeps the
  reference's rows where the reference keeps every passing row, and
  prunes a host chunk as it prunes the same rows on the device.
- The learned state persists, merges and discards a corrupt file.

Inputs are made from seeds with numpy. Tolerance: exact everywhere."""

from __future__ import annotations

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu.models import tpch as jtpch
from spark_rapids_jni_tpu.runtime import fusion as jfusion
from spark_rapids_jni_tpu.runtime import rtfilter as jrtfilter
from spark_rapids_jni_tpu.telemetry import REGISTRY as JREGISTRY
from spark_rapids_jni_tpu.utils import config as jconfig
from spark_rapids_jni_tpu_torch import telemetry
from spark_rapids_jni_tpu_torch import types as t
from spark_rapids_jni_tpu_torch.columnar import Column, Table
from spark_rapids_jni_tpu_torch.models import tpch
from spark_rapids_jni_tpu_torch.ops.bloom_filter import BloomFilter
from spark_rapids_jni_tpu_torch.runtime import fusion, rtfilter
from spark_rapids_jni_tpu_torch.runtime.memory import host_table_chunk
from spark_rapids_jni_tpu_torch.utils import config
from torch_ooc import write_q3_file
from torch_parity import (
    assert_same_valid_table,
    jax_table,
    ref_execute,
    with_null_tails,
)

OPTIONS = ("rtfilter.enabled", "rtfilter.max_build_rows", "rtfilter.path",
           "rtfilter.save_interval_s")


@pytest.fixture(autouse=True)
def _reset():
    telemetry.reset()
    JREGISTRY.reset()
    rtfilter.reset()
    jrtfilter.reset()
    yield
    for name in OPTIONS:
        config.reset_option(name)
        jconfig.reset_option(name)
    rtfilter.reset()
    jrtfilter.reset()


def _both(name, value):
    config.set_option(name, value)
    jconfig.set_option(name, value)


def test_decide_and_observe_follow_the_reference():
    rng = np.random.default_rng(5)
    script = [("decide", "p", "j1", 100)]
    for frac in rng.uniform(0.05, 0.3, 3):
        script.append(("observe", "p", "rtf_j1", 10_000,
                       int(10_000 * frac)))
        script.append(("decide", "p", "j1", 100))
    for _ in range(6):
        script.append(("observe", "p", "j1", 10_000, 9_700))
    script += [("decide", "p", "j1", 100), ("decide", "p", "j2", 1 << 20),
               ("decide", "q", "j1", 0), ("observe", "q", "j1", 0, 0)]
    for enabled in (False, True):
        _both("rtfilter.enabled", enabled)
        rtfilter.reset()
        jrtfilter.reset()
        got, want = [], []
        for step in script:
            if step[0] == "decide":
                got.append(tuple(rtfilter.decide(*step[1:])))
                want.append(tuple(jrtfilter.decide(*step[1:])))
            else:
                rtfilter.observe(*step[1:])
                jrtfilter.observe(*step[1:])
                got.append(rtfilter.learned_pass_frac("p", "j1"))
                want.append(jrtfilter.learned_pass_frac("p", "j1"))
        assert got == want
    assert [g[1] for g in got if isinstance(g, tuple)] == [
        "no_history_optimistic", "selective", "selective", "selective",
        "learned_nonselective", "build_too_large", "no_history_optimistic"]
    assert telemetry.REGISTRY.counters("rtfilter.") == \
        JREGISTRY.counters("rtfilter.")
    assert rtfilter.stats()["decisions_skip"] == \
        jrtfilter.stats()["decisions_skip"]


def _q3_tables(n, seed):
    port, ref = [], []
    for tab, cols in ((jtpch.customer_table(24, seed=seed), ()),
                      (jtpch.orders_table(240, 24, seed=seed + 1), (2,)),
                      (jtpch.lineitem_q3_table(n, 240, seed=seed + 2),
                       (0, 1))):
        p, r = with_null_tails(tab, cols, seed=seed)
        port.append(p)
        ref.append(r)
    names = ("customer", "orders", "lineitem")
    return dict(zip(names, port)), dict(zip(names, ref))


def _structure(nodes, bloom) -> list:
    return [(type(n).__name__, getattr(n, "label", None),
             getattr(n, "num_bits", None), getattr(n, "num_hashes", None))
            for n in nodes if isinstance(n, bloom)]


@pytest.mark.parametrize("max_build", [1 << 16, 20])
def test_inject_matches_the_reference(max_build):
    b, jb = _q3_tables(700, 3)
    _both("rtfilter.enabled", True)
    _both("rtfilter.max_build_rows", max_build)
    got = fusion.inject_runtime_filters(
        tpch._q3_plan(0, tpch._Q3_CUTOFF_DAYS, 2), b)
    want = jfusion.inject_runtime_filters(
        jtpch._q3_plan(0, jtpch._Q3_CUTOFF_DAYS, 2), jb)
    kinds = [type(n).__name__ for n in fusion._topo(got.root)]
    assert kinds == [type(n).__name__ for n in jfusion._topo(want.root)]
    assert _structure(fusion._topo(got.root),
                      (fusion.BloomBuild, fusion.BloomProbe)) == \
        _structure(jfusion._topo(want.root),
                   (jfusion.BloomBuild, jfusion.BloomProbe))
    applied = max_build > 20
    assert kinds.count("BloomProbe") == (2 if applied else 0)
    assert [e["reason"] for e in telemetry.events("rtfilter")] == (
        ["no_history_optimistic" if applied else "build_too_large"] * 2)


def test_q3_with_the_filter_equals_without_and_the_reference():
    b, jb = _q3_tables(2049, 7)
    plan = tpch._q3_plan(0, tpch._Q3_CUTOFF_DAYS, 2)
    want = ref_execute(jtpch._q3_plan(0, jtpch._Q3_CUTOFF_DAYS, 2), jb, 2049)
    off = fusion.execute(plan, b)
    config.set_option("rtfilter.enabled", True)
    for reason in ("no_history_optimistic", "selective"):
        telemetry.reset()
        on = fusion.execute(plan, b)
        for table in (off.table, on.table):
            assert_same_valid_table(table, want.table)
        decisions = [e["reason"] for e in telemetry.events("rtfilter")
                     if e["event"] == "apply"]
        assert decisions == [reason] * 2
        # one host read per probe feeds the gate
        assert telemetry.counter("fusion.host_reads") == 2
        assert telemetry.counter("rtfilter.observations") == 2
        assert 0 < telemetry.counter("rtfilter.rows_pruned") \
            < telemetry.counter("rtfilter.rows_in")
    res = tpch.tpch_q3(b["customer"], b["orders"], b["lineitem"])
    assert int(res.join_total) == int(off.meta["join2.total"])


@pytest.mark.parametrize("pipelined", [False, True])
def test_pruned_outofcore_q3_equals_unpruned_and_oracle(tmp_path, pipelined):
    c = tpch.customer_table(48, device="cpu")
    o = tpch.orders_table(200, 48, device="cpu")
    li = tpch.lineitem_q3_table(8000, 200, device="cpu")
    path = str(tmp_path / "li_q3.parquet")
    write_q3_file(path, li, 2000)

    def run():
        return tpch.tpch_q3_outofcore(path, c, o, budget_bytes=1 << 20,
                                      chunk_read_limit=1,
                                      pipeline=pipelined)

    base = run()
    assert telemetry.events("rtfilter")[0]["reason"] == "disabled"
    config.set_option("rtfilter.enabled", True)
    oracle = tpch.tpch_q3_oracle(c, o, li)
    for reason in ("no_history_optimistic", "selective"):
        telemetry.reset()
        res = run()
        # (each chunk's partial plan is filtered in-plan as well, as the
        # reference's is: its own signature)
        assert [e["reason"] for e in telemetry.events("rtfilter")
                if e["op"] == "tpch_q3_outofcore/pk2"
                and e["event"] == "apply"] == [reason]
        assert res.chunks == 4 and res.peak_bytes < base.peak_bytes
        seen = [(e["rows_in"], e["rows_pass"])
                 for e in telemetry.events("rtfilter")
                 if e["op"] == "tpch_q3_outofcore/pk2"
                 and e["event"] == "observed"]
        assert len(seen) == 4 and sum(r for r, _ in seen) == 8000
        assert 0 < sum(p for _, p in seen) < 8000
        assert res.table.equals(base.table)
        got = [x.data.numpy() for x in res.table.columns]
        for i, name in enumerate(("orderkey", "orderdate", "shippriority",
                                  "revenue")):
            assert np.array_equal(got[i], oracle[name]), name


def _chunk(n, seed):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 400, n).astype(np.int64)
    valid = rng.random(n) > 0.2
    return (Table([Column(t.INT64, torch.from_numpy(keys),
                          torch.from_numpy(valid)),
                   Column(t.INT32, torch.arange(n, dtype=torch.int32))]),
            keys, valid)


@pytest.mark.parametrize("n,min_rows", [(2049, 1), (257, 300), (300, 40)])
def test_prune_chunk_keeps_nulls_order_and_min_rows(n, min_rows):
    chunk, keys, valid = _chunk(n, n)
    build = np.arange(0, 400, 7, dtype=np.int64)
    bf = rtfilter.build_filter(torch.from_numpy(build),
                               expected_items=len(build))
    out = rtfilter.prune_chunk(chunk, bf, 0, min_rows=min_rows)
    pos = out.column(1).data.numpy()
    assert np.all(np.diff(pos) > 0)                      # order kept
    member = np.isin(keys, build) & valid
    assert set(np.flatnonzero(member | ~valid)) <= set(pos)
    assert len(pos) >= min(min_rows, n)
    # a host chunk gives the same rows, compacted before staging
    snaps = [(c.dtype, c.data, c.validity, None, None)
             for c in chunk.columns]
    host = rtfilter.prune_chunk(host_table_chunk(snaps, n, "cpu"), bf, 0,
                                min_rows=min_rows)
    assert host.num_rows == out.num_rows and host.stage().equals(out)
    if min_rows == 1:
        # the reference's rows (it keeps every passing row at min_rows 1)
        jbf = jrtfilter.build_filter(jnp.asarray(build),
                                     expected_items=len(build))
        assert np.array_equal(np.asarray(jbf.bits), bf.bits.numpy())
        jout = jrtfilter.prune_chunk(jax_table(
            [(int(t.INT64.type_id), 0, keys, valid),
             (int(t.INT32.type_id), 0, np.arange(n, dtype=np.int32),
              None)]), jbf, 0)
        assert np.array_equal(np.asarray(jout.column(1).data), pos)


def test_learned_state_persists_merges_and_discards_corruption(tmp_path):
    path = tmp_path / "sel.json"
    _both("rtfilter.enabled", True)
    config.set_option("rtfilter.path", str(path))
    config.set_option("rtfilter.save_interval_s", 0.0)
    rtfilter.observe("p", "j", 1000, 100)
    assert json.loads(path.read_text()) == {"p/j": 0.1}
    path.write_text(json.dumps({"p/j": 0.5, "p/k": 0.25}))
    rtfilter.reset()
    assert rtfilter.learned_pass_frac("p", "k") == 0.25
    rtfilter.observe("p", "j", 1000, 300)   # 0.6*0.5 + 0.4*0.3 = 0.42
    assert json.loads(path.read_text()) == pytest.approx(
        {"p/j": 0.5 * 0.42 + 0.5 * 0.5, "p/k": 0.25}, abs=0)
    path.write_text("{torn")
    rtfilter.reset()
    assert rtfilter.decide("p", "j", 10).reason == "no_history_optimistic"
    assert telemetry.counter("rtfilter.state_discarded") == 1
    assert [e["reason"] for e in telemetry.events("rtfilter")
            if e["event"] == "state_discarded"] == ["corrupt"]
    packed = rtfilter.packed_table(BloomFilter.empty(64, 2, device="cpu"))
    assert packed.column(0).data.shape == (8,)
