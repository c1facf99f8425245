"""The port's memory layer (``runtime/memory.py``) against the JAX
package's: the MemoryLimiter's accounting, blocking FIFO admission,
cancellation and watermarks, and the SpillStore's LRU spill across the
host, compressed and disk tiers with its integrity checks, driven by the
same operations on the same table (nulls, Arrow strings, DECIMAL128) in
both packages. Stats, states, errors and round-tripped bytes are equal;
corruption is a ``CorruptDataError`` in both. Every wait carries its
own time limit. Tolerance: exact everywhere."""

from __future__ import annotations

import threading

import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu import telemetry as jtelemetry
from spark_rapids_jni_tpu.runtime import faults as jfaults
from spark_rapids_jni_tpu.runtime import memory as jmemory
from spark_rapids_jni_tpu.runtime.resilience import (
    CorruptDataError as JCorruptDataError,
)
from spark_rapids_jni_tpu.utils import config as jconfig
from spark_rapids_jni_tpu_torch import telemetry
from spark_rapids_jni_tpu_torch.runtime import faults, memory
from spark_rapids_jni_tpu_torch.runtime.resilience import CorruptDataError
from spark_rapids_jni_tpu_torch.utils import config
from torch_parity import assert_same_table, jax_table, to_port
from torch_ooc import port_events, reference_events

JOIN_S = 10  # seconds any test thread may take


@pytest.fixture(autouse=True)
def _reset():
    telemetry.reset()
    jtelemetry.drain()
    jconfig.set_option("telemetry.enabled", True)
    yield
    jtelemetry.drain()
    for name in ("telemetry.enabled", "integrity.enabled", "compress.spill",
                 "degrade.enabled"):
        jconfig.reset_option(name)
    for name in ("integrity.enabled", "compress.spill", "degrade.enabled"):
        config.reset_option(name)


def _tables(seed: int, n: int = 600):
    """The same table in both packages: INT64 with nulls, an Arrow
    STRING column with nulls, DECIMAL128 limbs and a bool column."""
    from spark_rapids_jni_tpu import types as jt

    rng = np.random.default_rng(seed)
    valid = rng.random(n) > 0.2
    lens = rng.integers(0, 9, n)
    offs = np.zeros(n + 1, np.int32)
    offs[1:] = np.cumsum(lens)
    chars = rng.integers(97, 123, int(offs[-1])).astype(np.uint8)
    limbs = np.stack([rng.integers(-2**62, 2**62, n),
                      rng.integers(-3, 3, n)], axis=1).astype(np.int64)
    cols = [
        (int(jt.TypeId.INT64), 0, rng.integers(0, 5, n).astype(np.int64),
         valid),
        (int(jt.TypeId.STRING), 0, (offs, chars), ~valid),
        (int(jt.TypeId.DECIMAL128), -3, limbs, None),
        (int(jt.TypeId.BOOL8), 0, (rng.random(n) > 0.5).astype(np.uint8),
         valid),
    ]
    jtab = jax_table(cols)
    return to_port(jtab), jtab


def _stores(budget, **kw):
    return memory.SpillStore(budget, **kw), jmemory.SpillStore(budget, **kw)


STAT_KEYS = ("device_bytes", "host_bytes", "host_stored_bytes",
             "disk_bytes", "budget_bytes", "spills", "unspills",
             "spilled_bytes", "unspilled_bytes", "tables")


def _same_stats(store, jstore):
    got, want = store.stats(), jstore.stats()
    assert {k: got[k] for k in STAT_KEYS} == {k: want[k] for k in STAT_KEYS}


# ---- the limiter ----------------------------------------------------------


def test_limiter_accounting_equals_the_reference():
    lim, jlim = memory.MemoryLimiter(1000), jmemory.MemoryLimiter(1000)
    for op, nb in (("r", 400), ("r", 500), ("x", 200), ("f", 300),
                   ("r", 350), ("f", 1000), ("r", 10)):
        outs = []
        for limiter, exc in ((lim, memory.MemoryLimitExceeded),
                             (jlim, jmemory.MemoryLimitExceeded)):
            try:
                if op == "f":
                    limiter.release(nb)
                else:
                    limiter.reserve(nb)
                outs.append("ok")
            except exc as e:
                outs.append(str(e))
        assert outs[0] == outs[1]
        assert (lim.used, lim.peak) == (jlim.used, jlim.peak)
    with lim:
        lim.reserve(5)
    assert lim.used == 0
    with pytest.raises(ValueError):
        memory.MemoryLimiter(0)


def test_reserve_fault_leaves_the_accounting_untouched():
    lim = memory.MemoryLimiter(100)
    with faults.inject(faults.FaultScript([faults.FaultSpec(
            "memory.reserve", RuntimeError, seq=40)])):
        with pytest.raises(RuntimeError):
            lim.reserve(40)
        lim.reserve(40)
    assert lim.used == 40


def test_reserve_blocking_is_fifo_cancellable_and_bounded():
    lim = memory.MemoryLimiter(100)
    lim.reserve(90)
    with pytest.raises(memory.MemoryLimitExceeded, match="can never fit"):
        lim.reserve_blocking(101)
    assert lim.reserve_blocking(50, timeout=0.05) is False
    cancel = threading.Event()
    cancel.set()
    assert lim.reserve_blocking(50, cancel=cancel) is False
    order = []

    def waiter(nb, tag):
        assert lim.reserve_blocking(nb, timeout=JOIN_S)
        order.append(tag)

    first = threading.Thread(target=waiter, args=(60, "big"))
    first.start()
    while lim.watermarks()["waiters"] < 1:
        threading.Event().wait(0.005)
    second = threading.Thread(target=waiter, args=(5, "small"))
    second.start()
    while lim.watermarks()["waiters"] < 2:
        threading.Event().wait(0.005)
    # the small request fits now but may not pass the earlier big one
    threading.Event().wait(0.1)
    assert order == []
    lim.release(90)
    for th in (first, second):
        th.join(JOIN_S)
        assert not th.is_alive()
    assert order == ["big", "small"] and lim.used == 65


def test_watermarks_spill_the_coldest_and_park_admission():
    def drive(mem, tabs):
        lim = mem.MemoryLimiter(1000, high_watermark=0.8, low_watermark=0.5)
        store = mem.SpillStore(1 << 20)
        lim.attach_spill_store(store)
        handles = [store.put(t) for t in tabs]
        lim.reserve(700)
        lim.reserve(150)  # crosses 800: spills the coldest entries
        marks = lim.watermarks()
        parked = lim.reserve_blocking(10, timeout=0.05, admission=True)
        plain = lim.reserve_blocking(10, timeout=0.05)
        lim.release(400)  # drains below 500: pressure clears
        states = [store.state(h) for h in handles]
        return marks, parked, plain, lim.watermarks(), states

    (tab, jtab) = _tables(1, 200)
    got = drive(memory, [tab, tab])
    want = drive(jmemory, [jtab, jtab])
    assert got == want
    assert got[0]["pressure"] and not got[3]["pressure"]
    assert got[1] is False and got[2] is True
    assert got[4] == ["host", "device"]
    assert port_events("degrade") == reference_events("degrade")


def test_watermarks_are_inert_without_a_store_or_when_disabled():
    lim = memory.MemoryLimiter(100, high_watermark=0.5)
    lim.reserve(90)
    assert not lim.pressure
    config.set_option("degrade.enabled", False)
    lim2 = memory.MemoryLimiter(100, high_watermark=0.5)
    lim2.attach_spill_store(memory.SpillStore(1000))
    lim2.reserve(90)
    assert not lim2.pressure and lim2.pressure_crossings == 0


def test_wait_below_low_drains_or_times_out():
    lim = memory.MemoryLimiter(100, low_watermark=0.5)
    lim.reserve(80)
    assert lim.wait_below_low(timeout=0.05) is False
    assert lim.wait_below_low(timeout=0.05, own_held=40) is True
    th = threading.Timer(0.05, lim.release, (50,))
    th.start()
    assert lim.wait_below_low(timeout=JOIN_S)
    th.join(JOIN_S)


# ---- the spill store ------------------------------------------------------


TIERS = [
    ("host", {}, {}),
    ("host_raw", {}, {"compress.spill": False}),
    ("zstd", {"compress_spill": True}, {"compress.spill": False}),
    ("codec", {"compress_spill": True}, {}),
    ("unsealed", {}, {"integrity.enabled": False}),
]


@pytest.mark.parametrize("name,kw,options", TIERS,
                         ids=[t[0] for t in TIERS])
def test_spill_tiers_round_trip_as_the_reference(name, kw, options):
    if kw.get("compress_spill"):
        pytest.importorskip("zstandard")
    for k, v in options.items():
        config.set_option(k, v)
        jconfig.set_option(k, v)
    (a, ja), (b, jb), (c, jc) = _tables(2), _tables(3), _tables(4)
    nb = memory.table_nbytes(a)
    assert nb == jmemory._table_nbytes(ja)
    store, jstore = _stores(2 * nb + 10, **kw)
    hs = [store.put(t) for t in (a, b)]
    jhs = [jstore.put(t) for t in (ja, jb)]
    store.get(hs[0])  # b is now the coldest
    jstore.get(jhs[0])
    hs.append(store.put(c))
    jhs.append(jstore.put(jc))
    assert [store.state(h) for h in hs] == [jstore.state(h) for h in jhs] \
        == ["device", "host", "device"]
    _same_stats(store, jstore)
    if name == "host_raw":
        assert all(isinstance(x, torch.Tensor)
                   for x in store._entries[hs[1]]["host_cols"][0][1:3])
    assert_same_table(store.get(hs[1]), jb)
    jstore.get(jhs[1])
    _same_stats(store, jstore)
    assert store.stats()["unspills"] == 1
    store.close()
    assert store.stats()["tables"] == 0


def test_disk_tier_round_trips_and_cleans_up(tmp_path):
    (a, ja), (b, jb) = _tables(5), _tables(6)
    nb = max(memory.table_nbytes(a), memory.table_nbytes(b))
    store = memory.SpillStore(nb + 10, spill_dir=str(tmp_path / "p"))
    jstore = jmemory.SpillStore(nb + 10, spill_dir=str(tmp_path / "j"))
    h, jh = store.put(a), jstore.put(ja)
    store.put(b)
    jstore.put(jb)
    assert store.state(h) == jstore.state(jh) == "disk"
    got, want = store.stats(), jstore.stats()
    assert (got["disk_bytes"], got["spills"]) == (want["disk_bytes"],
                                                  want["spills"])
    assert len(list((tmp_path / "p").glob("spill-*.bin"))) == 1
    assert_same_table(store.get(h), ja)
    # the unspill made room by spilling the other table to disk
    assert store.state(h) == "device" and store.stats()["disk_bytes"] \
        == memory.table_nbytes(b)
    assert len(list((tmp_path / "p").glob("spill-*.bin"))) == 1
    store.close()
    assert not list((tmp_path / "p").iterdir())


@pytest.mark.parametrize("tier", ["host", "disk"])
def test_corrupt_spill_is_caught_as_in_the_reference(tier, tmp_path):
    (a, ja), (b, jb) = _tables(7), _tables(8)
    nb = max(memory.table_nbytes(a), memory.table_nbytes(b))
    outcomes = []
    for mem, fl, tab, tab2, exc in (
            (memory, faults, a, b, CorruptDataError),
            (jmemory, jfaults, ja, jb, JCorruptDataError)):
        store = mem.SpillStore(
            nb + 10, spill_dir=str(tmp_path / mem.__name__)
            if tier == "disk" else None)
        script = fl.FaultScript(corruptions=[
            fl.CorruptionSpec("integrity.spill", "flip", seed=1)])
        h = store.put(tab)
        with fl.inject(script):
            store.put(tab2)
        with pytest.raises(exc) as ei:
            store.get(h)
        outcomes.append((str(ei.value).split(" [")[0], store.state(h),
                         script.fired))
        store.close()
    assert outcomes[0] == outcomes[1]
    assert outcomes[0][1] == tier
    assert telemetry.counter("integrity.mismatch.integrity.spill") == 1


def test_spill_fault_leaves_the_victim_resident():
    (a, _), (b, _) = _tables(9), _tables(10)
    store = memory.SpillStore(
        max(memory.table_nbytes(a), memory.table_nbytes(b)) + 10)
    h = store.put(a)
    with faults.inject(faults.FaultScript(
            [faults.FaultSpec("spill.spill", RuntimeError)])):
        with pytest.raises(RuntimeError):
            store.put(b)
    assert store.state(h) == "device" and store.stats()["tables"] == 1
    with pytest.raises(memory.MemoryLimitExceeded, match="spill budget"):
        store.put(Table_of(2 * memory.table_nbytes(a)))


def Table_of(nbytes: int):
    from spark_rapids_jni_tpu_torch.columnar import Column, Table

    return Table([Column.from_numpy(np.zeros(nbytes // 8, np.int64),
                                    device="cpu")])


def test_get_reserved_reserves_before_staging():
    (a, _), (b, _) = _tables(11), _tables(12)
    nb = memory.table_nbytes(a)
    store = memory.SpillStore(max(nb, memory.table_nbytes(b)) + 10)
    h = store.put(a)
    store.put(b)
    lim = memory.MemoryLimiter(nb - 1)
    with pytest.raises(memory.MemoryLimitExceeded):
        store.get_reserved(h, lim)
    assert store.state(h) == "host" and lim.used == 0
    lim = memory.MemoryLimiter(nb)
    with faults.inject(faults.FaultScript(
            [faults.FaultSpec("spill.unspill", RuntimeError)])):
        with pytest.raises(RuntimeError):
            store.get_reserved(h, lim)
    assert lim.used == 0 and store.state(h) == "host"
    tab, got_nb = store.get_reserved(h, lim)
    assert got_nb == nb and lim.used == nb
    assert tab.equals(a)


def test_staging_pool_and_device_stats():
    pool = memory.HostStagingPool(max_buffers_per_class=1, pinned=False)
    buf = pool.take(100)
    assert buf.numel() == 128 and buf.dtype == torch.uint8
    pool.give(buf)
    pool.give(torch.empty(128, dtype=torch.uint8))  # class full
    assert pool.take(65) is buf and (pool.hits, pool.misses) == (1, 1)
    pool.give(torch.empty(100, dtype=torch.uint8))  # not a class size
    assert pool.take(100) is not buf
    stats = memory.device_memory_stats("cpu")
    assert (stats.bytes_in_use, stats.bytes_limit, stats.bytes_cached) \
        == (0, 0, 0)
