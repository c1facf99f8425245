"""The port's result and subplan cache (``runtime/resultcache.py``) and
the limiter's cache hooks, with results held to the JAX package's.

- A repeated submission is a hit (no wait, no execution) whose table is
  the first result's bits, after that result was dropped, and equals
  the reference's ``execute`` of the same plan.
- Keys: content changes miss, an in-place write to a bound tensor
  invalidates the memoized fingerprint, both halves are mandatory, the
  plan's name is not part of the signature, a source fingerprint tracks
  its file.
- LRU by resident bytes, every charge released on eviction and clear.
- A corrupt cached payload is a classified ``cache.corrupt_discard`` and
  a bit-identical recompute, with nothing left reserved.
- Two plans sharing a Filter + Project prefix run it once (a subplan
  hit), equal to the reference's unrewritten plan.
- Pressure sheds cache entries before a live working set spills; a
  parked drain wait discounts evictable cache bytes, and
  ``reclaim_cache`` makes the discount real.

Inputs are made from seeds with numpy; integer aggregates, so every
comparison is exact."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu.runtime import fusion as jfusion
from spark_rapids_jni_tpu_torch import telemetry
from spark_rapids_jni_tpu_torch import types as t
from spark_rapids_jni_tpu_torch.columnar import Column, Table
from spark_rapids_jni_tpu_torch.runtime import (
    faults,
    fusion,
    resultcache,
    server,
)
from spark_rapids_jni_tpu_torch.runtime.memory import (
    MemoryLimiter,
    SpillStore,
    table_nbytes,
)
from spark_rapids_jni_tpu_torch.utils import config
from torch_parity import assert_same_table, jax_table

WAIT_S = 60  # seconds a ticket may take


@pytest.fixture(autouse=True)
def _reset():
    telemetry.reset()
    yield
    for name in ("cache.enabled", "cache.max_bytes", "degrade.enabled"):
        config.reset_option(name)


# ---- plans: module-level callables (the signature names them) -------------


def _host(n, seed, null_tail=0):
    rng = np.random.default_rng(seed)
    valid = np.ones(n, bool)
    if null_tail:
        valid[n - null_tail:] = False
    return [(int(t.INT32.type_id), 0,
             rng.integers(0, 100, n).astype(np.int32), None),
            (int(t.INT64.type_id), 0,
             rng.integers(-1000, 1000, n).astype(np.int64), valid)]


def _port(host):
    return Table([Column(t.DType(t.TypeId(tid)), torch.from_numpy(d.copy()),
                         None if v is None else torch.from_numpy(v.copy()))
                  for tid, _, d, v in host])


def _pred(tab, cut):
    return tab.columns[0].data < cut


def _derive(tab):
    c = tab.columns[1]
    return Table(list(tab.columns) + [Column(c.dtype, c.data * 2,
                                             c.validity)])


def _sum_agg(tab, row_valid):
    c = tab.columns[2]
    v = torch.where(c.valid_mask(), c.data, torch.zeros_like(c.data))
    return Table([Column(c.dtype, v.sum().reshape(1))])


def _max_agg(tab, row_valid):
    c = tab.columns[2]
    v = torch.where(c.valid_mask(), c.data, torch.full_like(c.data, -10**9))
    return Table([Column(c.dtype, v.max().reshape(1))])


def _jpred(tab, cut):
    return tab.columns[0].data < cut


def _jderive(tab):
    c = tab.columns[1]
    return type(tab)(list(tab.columns) + [type(c)(c.dtype, c.data * 2,
                                                  c.validity)])


def _jsum_agg(tab, row_valid):
    c = tab.columns[2]
    m = c.valid_mask() if row_valid is None else c.valid_mask() & row_valid
    return type(tab)([type(c)(c.dtype, jnp.sum(jnp.where(m, c.data, 0))[None])])


def _jmax_agg(tab, row_valid):
    c = tab.columns[2]
    m = c.valid_mask() if row_valid is None else c.valid_mask() & row_valid
    return type(tab)([type(c)(c.dtype,
                              jnp.max(jnp.where(m, c.data, -10**9))[None])])


def _plans(fz, pred, derive, agg_sum, agg_max):
    prefix = fz.Project(fz.Filter(fz.Scan("t"), pred, (50,)), derive)
    return (fz.Plan("rc_mask", prefix),
            fz.Plan("rc_sum", fz.Project(prefix, agg_sum, rowwise=False)),
            fz.Plan("rc_max", fz.Project(prefix, agg_max, rowwise=False)))


def _port_plans():
    return _plans(fusion, _pred, _derive, _sum_agg, _max_agg)


def _ref_plans():
    return _plans(jfusion, _jpred, _jderive, _jsum_agg, _jmax_agg)


def _host_copy(table):
    return [(c.data.clone(), c.valid_mask().clone()) for c in table.columns]


def _same(table, copy):
    assert len(copy) == table.num_columns
    for c, (d, v) in zip(table.columns, copy):
        assert torch.equal(c.data, d) and torch.equal(c.valid_mask(), v)


# ---- hits -------------------------------------------------------------------


@pytest.mark.parametrize("n,null_tail", [(257, 0), (2049, 33)])
def test_hit_returns_the_first_bits_after_they_were_dropped(n, null_tail):
    host = _host(n, n, null_tail)
    mask = _port_plans()[0]
    want = jfusion.execute(_ref_plans()[0], {"t": jax_table(host)},
                           force_staged=True)
    with server.QueryServer(budget_bytes=1 << 26) as srv:
        first = srv.session("s").submit(mask, {"t": _port(host)})
        r1 = first.result(timeout=WAIT_S)
        assert_same_table(r1.table, want.table)
        copy = _host_copy(r1.table)
        del r1, first
        again = srv.session("s").submit(mask, {"t": _port(host)})
        r2 = again.result(timeout=WAIT_S)
        assert again.queue_wait_s == 0.0 and again.status == "served"
        _same(r2.table, copy)
        assert telemetry.counter("cache.hit") == 1
        assert telemetry.counter("fusion.regions") == 1
    assert srv.limiter.used == 0


def test_content_changes_and_in_place_writes_miss():
    host = _host(600, 1)
    tab = _port(host)
    sum_plan = _port_plans()[1]
    fp = resultcache.table_fingerprint(tab)
    assert resultcache.table_fingerprint(tab) == fp
    assert tab._resultcache_fp[1] == fp      # memoized on the table
    with server.QueryServer(budget_bytes=1 << 26) as srv:
        s = srv.session("s")
        a = s.submit(sum_plan, {"t": tab}).result(timeout=WAIT_S)
        assert s.submit(sum_plan, {"t": tab}).result(
            timeout=WAIT_S).table.equals(a.table)
        assert telemetry.counter("cache.hit") == 1
        # an in-place write to a bound tensor invalidates the memo, and
        # the entries that share its buffer (the prefix passes column 1
        # through) are discarded, not served
        tab.columns[1].data[0] += 7
        assert resultcache.table_fingerprint(tab) != fp
        b = s.submit(sum_plan, {"t": tab}).result(timeout=WAIT_S)
        assert telemetry.counter("cache.hit") == 1
        prefix = fusion.Plan("prefix", sum_plan.root.child)
        old_key = resultcache.cache_key(prefix, {"t": _port(host)})
        assert srv.result_cache.get(old_key) is None
        assert telemetry.counter("cache.stale_discard") == 1
        got = b.table.column(0).data.item() - a.table.column(0).data.item()
        assert got == (14 if host[0][2][0] < 50 else 0)
        # new content misses, an explicit fingerprint overrides it
        other = _port(_host(600, 2))
        s.submit(sum_plan, {"t": other}).result(timeout=WAIT_S)
        s.submit(sum_plan, {"t": other}, cache_fingerprint="v1").result(
            timeout=WAIT_S)
        hit = s.submit(sum_plan, {"t": tab}, cache_fingerprint="v1")
        assert hit.result(timeout=WAIT_S).table.column(0).data.item() == \
            s.submit(sum_plan, {"t": other}).result(
                timeout=WAIT_S).table.column(0).data.item()
        # three whole-query hits and the "v1" run's prefix over ``other``
        assert telemetry.counter("cache.hit") == 4
        assert telemetry.counter("cache.subplan_hit") == 1
    assert srv.limiter.used == 0


def test_keys_need_both_halves_and_ignore_the_plan_name(tmp_path):
    tab = _port(_host(100, 3))
    mask = _port_plans()[0]
    key = resultcache.cache_key(mask, {"t": tab})
    renamed = fusion.Plan("other", mask.root)
    assert resultcache.cache_key(renamed, {"t": tab}) == key
    cache = resultcache.ResultCache(SpillStore(1 << 20),
                                    MemoryLimiter(1 << 20))
    res = fusion.execute(mask, {"t": tab})
    for bad in (("sig", ""), ("", "fp"), "sig@fp"):
        with pytest.raises(ValueError):
            cache.put(resultcache.CacheKey(*bad) if isinstance(bad, tuple)
                      else bad, res)
    path = tmp_path / "f.bin"
    path.write_bytes(b"a")
    fp = resultcache.source_fingerprint(str(path))
    path.write_bytes(b"bb")
    assert resultcache.source_fingerprint(str(path)) != fp


# ---- capacity and accounting ------------------------------------------------


def _result(n, seed):
    tab = _port(_host(n, seed))
    return fusion.FusedResult(tab, {"x.total": torch.tensor(n)})


def _key(i):
    return resultcache.CacheKey(f"sig{i}", f"fp{i}")


def test_lru_by_resident_bytes_releases_every_charge():
    per = table_nbytes(_result(1000, 0).table)
    limiter = MemoryLimiter(1 << 24)
    store = SpillStore(1 << 24)
    cache = resultcache.ResultCache(store, limiter, max_bytes=2 * per)
    for i in range(2):
        assert cache.put(_key(i), _result(1000, i))
    assert limiter.used == 2 * per == cache.evictable_bytes
    assert cache.get(_key(0)).meta["x.total"].item() == 1000  # 0 is newest
    cache.put(_key(2), _result(1000, 2))                        # evicts 1
    assert cache.get(_key(1)) is None and cache.get(_key(0)) is not None
    assert cache.stats()["evictions"] == 1 and limiter.used == 2 * per
    assert not cache.put(_key(9), _result(5000, 9))             # too big
    cache.shed(1)                                               # one entry
    st = cache.stats()
    assert st["entries"] == 2 and limiter.used == per
    assert cache.get(_key(0)) is not None and cache.get(_key(2)) is not None
    cache.clear()
    assert limiter.used == 0 and cache.evictable_bytes == 0
    assert cache.stats()["entries"] == 0


def test_corrupt_cached_entry_is_discarded_and_recomputed():
    host = _host(2048, 4)
    mask = _port_plans()[0]
    with server.QueryServer(budget_bytes=1 << 26) as srv:
        r1 = srv.session("x").submit(mask, {"t": _port(host)}).result(
            timeout=WAIT_S)
        copy = _host_copy(r1.table)
        script = faults.FaultScript(corruptions=[
            faults.CorruptionSpec("integrity.cache", mode="flip")])
        with faults.inject(script):
            srv.result_cache.shed(1 << 30)   # spilled: the copy corrupted
        assert script.fired
        r2 = srv.session("x").submit(mask, {"t": _port(host)}).result(
            timeout=WAIT_S)
        assert telemetry.counter("cache.corrupt_discard") == 1
        assert telemetry.counter("integrity.mismatch.integrity.cache") == 1
        assert telemetry.counter("cache.hit") == 0
        _same(r2.table, copy)
        r3 = srv.session("x").submit(mask, {"t": _port(host)}).result(
            timeout=WAIT_S)
        assert telemetry.counter("cache.hit") == 1
        _same(r3.table, copy)
    assert srv.limiter.used == 0


def test_shared_prefix_runs_once_as_the_reference_plan():
    host = _host(3000, 11, null_tail=100)
    _, sum_plan, max_plan = _port_plans()
    _, jsum, jmax = _ref_plans()
    with server.QueryServer(budget_bytes=1 << 26) as srv:
        ra = srv.session("s").submit(sum_plan, {"t": _port(host)}).result(
            timeout=WAIT_S)
        assert telemetry.counter("cache.subplan_materialize") == 1
        rb = srv.session("s").submit(max_plan, {"t": _port(host)}).result(
            timeout=WAIT_S)
        assert telemetry.counter("cache.subplan_materialize") == 1
        assert telemetry.counter("cache.subplan_hit") == 1
        assert srv.result_cache.stats()["subplan_hits"] == 1
    for got, jplan in ((ra, jsum), (rb, jmax)):
        want = jfusion.execute(jplan, {"t": jax_table(host)},
                               force_staged=True)
        assert_same_table(got.table, want.table)
        assert got.table.equals(fusion.execute(
            sum_plan if jplan is jsum else max_plan,
            {"t": _port(host)}).table)
    assert srv.limiter.used == 0


def test_pressure_sheds_cache_first_and_drain_discounts_it():
    config.set_option("degrade.enabled", True)
    budget = 1 << 20
    limiter = MemoryLimiter(budget, high_watermark=0.6, low_watermark=0.55)
    store = SpillStore(1 << 24)
    limiter.attach_spill_store(store)
    cache = resultcache.ResultCache(store, limiter, max_bytes=1 << 24)
    limiter.attach_result_cache(cache)
    live = store.put(_port(_host(2048, 1)))
    cache.put(_key(0), _result(20000, 2))
    handle = next(iter(cache._entries.values()))["handle"]
    cached = limiter.used
    limiter.reserve(budget // 2)          # crosses the high watermark
    assert limiter.pressure_crossings == 1
    assert store.state(handle) == "host" and store.state(live) == "device"
    assert telemetry.counter("cache.shed_bytes") == cached
    assert cache.evictable_bytes == 0
    limiter.release(budget // 2)

    limiter2 = MemoryLimiter(budget, high_watermark=0.9, low_watermark=0.5)
    cache2 = resultcache.ResultCache(SpillStore(1 << 24), limiter2,
                                     max_bytes=1 << 24)
    limiter2.attach_result_cache(cache2)
    cache2.put(_key(0), _result(4096, 3))
    cache2.put(_key(1), _result(4096, 4))
    evictable = cache2.evictable_bytes
    limiter2.reserve(int(budget * 0.5) - evictable // 2)
    assert limiter2.used > int(budget * 0.5)
    assert limiter2.wait_below_low(timeout=0.05)
    assert limiter2.reclaim_cache() > 0
    assert limiter2.used <= int(budget * 0.5)
