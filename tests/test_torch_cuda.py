"""The port's CUDA kernels against their plain PyTorch versions, on the
card, at the reference's edge row counts.

A CUDA kernel has no CPU mode, so every test here needs a CUDA device and
skips without one. The readers' tests hold a read to the card equal to
the same read on the CPU, with the host-staged buffers pinned. This file
imports no JAX, so it also runs where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu_torch import types as t
from spark_rapids_jni_tpu_torch.columnar import Column, Table
from spark_rapids_jni_tpu_torch.columnar.column import string_column
from spark_rapids_jni_tpu_torch.models import tpcds, tpch
from spark_rapids_jni_tpu_torch.ops import kernels
from spark_rapids_jni_tpu_torch.ops.groupby import (
    groupby_aggregate,
    groupby_aggregate_bounded,
)
from spark_rapids_jni_tpu_torch.ops.join import apply_join_maps, join
from spark_rapids_jni_tpu_torch.ops.kernels import (
    groupby_accumulate as kga,
    hash_probe as khp,
    q1 as kq1,
    row_transpose as krt,
)
from spark_rapids_jni_tpu_torch.ops.sort import sort_order
from spark_rapids_jni_tpu_torch.ops.strings import like
from spark_rapids_jni_tpu_torch.ops.row_conversion import (
    compute_fixed_width_layout,
    convert_from_rows,
    convert_to_rows,
)
from spark_rapids_jni_tpu_torch.ops import bloom_filter as pbf
from spark_rapids_jni_tpu_torch.ops import cast_strings as pcs
from spark_rapids_jni_tpu_torch.ops import datetime as pdt
from spark_rapids_jni_tpu_torch.ops import hash as phash
from spark_rapids_jni_tpu_torch.ops import json_device as pjd
from spark_rapids_jni_tpu_torch.ops import regex_capture_device as prc
from spark_rapids_jni_tpu_torch.ops import strings as pstr
from spark_rapids_jni_tpu_torch.ops import strings_fns as pfn
from spark_rapids_jni_tpu_torch.ops.get_json_object import get_json_object
from spark_rapids_jni_tpu_torch import telemetry
from spark_rapids_jni_tpu_torch.interop import table_from_numpy
from torch_parity import (
    EDGE_ROWS,
    LEVEL_CASES,
    TIMESTAMP_DIVS,
    arrow_strings,
    bench_strings,
    bench_json_docs,
    bloom_values,
    hash_host_columns,
    log_lines,
    mixed_script_rows,
    level_case,
    mixed_float_strings,
    null_tail,
    seeded_cast_strings,
    seeded_days,
    seeded_timestamps,
    writer_module,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _null_tail(n, frac, rng):
    valid = rng.random(n) > 0.1
    valid[-max(1, int(n * frac)):] = False
    return valid


@pytest.mark.parametrize("n", EDGE_ROWS)
def test_accumulate_kernel_matches_plain(dev, n):
    rng = np.random.default_rng(n)
    m = 7
    gid = torch.from_numpy(rng.integers(0, m + 1, n).astype(np.int32)).to(dev)
    vals = {
        np.int8: rng.integers(-128, 128, n),
        np.int16: rng.integers(-2**15, 2**15, n),
        np.int32: rng.integers(-2**31, 2**31, n),
        np.int64: rng.integers(-2**62, 2**62, n),
        np.uint8: rng.integers(0, 256, n),
        np.uint16: rng.integers(0, 2**16, n),
        np.uint32: rng.integers(0, 2**32, n),
    }
    lanes = [kga.Lane("sum", None, None, 0)]
    for np_dt, v in vals.items():
        data = torch.from_numpy(v.astype(np_dt)).to(dev)
        valid = torch.from_numpy(_null_tail(n, 0.25, rng)).to(dev)
        info = np.iinfo(np_dt)
        lanes += [kga.Lane("sum", None, valid, 0),
                  kga.Lane("sum", data, valid, 0),
                  kga.Lane("sum", data, None, 0),
                  kga.Lane("min", data, valid, int(info.max)),
                  kga.Lane("max", data, valid, int(info.min))]
    got = kga._accumulate_cuda(gid, lanes, m)
    want = kga.accumulate_plain(gid, lanes, m)
    assert torch.equal(got, want)


def _cycled_lanes(count, n, dev, rng):
    """``count`` lanes cycling through counts, sums, mins and maxs of
    every integer kind the kernel takes, with and without validity."""
    cols = {np_dt: torch.from_numpy(v.astype(np_dt)).to(dev) for np_dt, v in (
        (np.int8, rng.integers(-128, 128, n)),
        (np.int16, rng.integers(-2**15, 2**15, n)),
        (np.int32, rng.integers(-2**31, 2**31, n)),
        (np.int64, rng.integers(-2**62, 2**62, n)),
        (np.uint8, rng.integers(0, 256, n)),
        (np.uint32, rng.integers(0, 2**32, n)),
        (np.uint64, rng.integers(0, 2**63, n)))}
    valid = torch.from_numpy(_null_tail(n, 0.25, rng)).to(dev)
    kinds = list(cols)
    lanes = []
    for i in range(count):
        np_dt = kinds[i % len(kinds)]
        info = np.iinfo(np_dt)
        pick = [kga.Lane("sum", None, None, 0),
                kga.Lane("sum", None, valid, 0),
                kga.Lane("sum", cols[np_dt], valid, 0),
                kga.Lane("sum", cols[np_dt], None, 0),
                kga.Lane("min", cols[np_dt], valid, int(info.max)),
                kga.Lane("max", cols[np_dt], None, int(info.min))][i % 6]
        lanes.append(pick)
    return lanes


@pytest.mark.parametrize("m,num_lanes,one_group", [
    (1, 6, False), (12, 11, False), (16, 12, False), (17, 12, False),
    (16, 128, False), (64, 32, False), (2048, 1, False),
    (12, 11, True), (17, 12, True), (2048, 1, True)])
def test_accumulate_kernel_domains(dev, m, num_lanes, one_group):
    # m <= 16 takes the per-thread kernel, above it the warp-aggregated
    # one; more than 64 lanes split over launches; one group is the worst
    # contention. Three 8192-row tiles and a ragged tail.
    n = 3 * 8192 + 77
    rng = np.random.default_rng(m + num_lanes)
    g = np.full(n, m - 1) if one_group else rng.integers(0, m + 1, n)
    gid = torch.from_numpy(g.astype(np.int32)).to(dev)
    lanes = _cycled_lanes(num_lanes, n, dev, rng)
    assert kga.unsupported_reason(lanes, m) is None
    got = kga._accumulate_cuda(gid, lanes, m)
    want = kga.accumulate_plain(gid, lanes, m)
    assert torch.equal(got, want)


@pytest.mark.parametrize("m", [32, 2048])
def test_accumulate_kernel_distinct_warps(dev, m):
    # every warp's 32 rows in 32 different groups (the large-domain
    # kernel's path without shuffles), then each group on two neighbouring
    # rows (its exact path, one shuffle step); m * L within the cap
    n = 3 * 8192 + 77
    rng = np.random.default_rng(m)
    lanes = _cycled_lanes(6, n, dev, rng) if m == 32 \
        else _cycled_lanes(3, n, dev, rng)[2:]  # one int32 sum lane
    assert kga.unsupported_reason(lanes, m) is None
    for pair in (1, 2):
        g = np.arange(n) // pair % m
        gid = torch.from_numpy(g.astype(np.int32)).to(dev)
        got = kga._accumulate_cuda(gid, lanes, m)
        want = kga.accumulate_plain(gid, lanes, m)
        assert torch.equal(got, want)


@pytest.mark.parametrize("n", EDGE_ROWS)
def test_q1_kernel_matches_plain(dev, n):
    li = tpch.lineitem_table(n, seed=n, device=dev)
    cols = [li.column(i).data.clone() for i in kq1._COLUMNS]
    cols[4][::7] = ord("X")  # returnflag outside its domain: slot 7
    got = kq1._q1_partials_cuda(*cols)
    want = kq1.q1_partials_plain(*cols)
    assert torch.equal(got, want)


_Q1_CHUNK = 128 * 4  # the kernel's rows per block step (csrc/q1.cu)


def _q1_case_columns(case, n, dev):
    """The seven q1 columns of a lineitem, changed as ``case`` says."""
    li = tpch.lineitem_table(n, seed=n, device=dev)
    cols = [li.column(i).data.clone() for i in kq1._COLUMNS]
    qty, price, disc, tax, rf, ls, ship = cols
    if case == "one_slot":
        rf[:] = tpch._Q1_RF_DOMAIN[2]
        ls[:] = tpch._Q1_LS_DOMAIN[0]
        ship[:] = tpch._Q1_CUTOFF_DAYS
    elif case == "all_filtered":
        ship[:] = tpch._Q1_CUTOFF_DAYS + 1
    elif case == "all_missed":
        rf[:] = ord("X")
        ship[:] = tpch._Q1_CUTOFF_DAYS
    elif case == "int64_limits":
        # products and sums wrap: values within 1000 of either int64 limit
        rng = np.random.default_rng(n)
        for c in (qty, price, disc, tax):
            near = rng.integers(0, 1000, n)
            v = np.where(rng.random(n) < 0.5, np.iinfo(np.int64).max - near,
                         np.iinfo(np.int64).min + near)
            c.copy_(torch.from_numpy(v.astype(np.int64)))
    return cols


@pytest.mark.parametrize("case,n", [
    ("chunks", 3 * _Q1_CHUNK + 77),
    ("chunks", 1_000_003),      # more chunks than the grid has blocks
    ("one_slot", 3 * _Q1_CHUNK + 5),
    ("all_filtered", 3 * _Q1_CHUNK + 5),
    ("all_missed", 3 * _Q1_CHUNK + 5),
    ("int64_limits", 5 * _Q1_CHUNK + 333),
    ("offset_views", 3 * _Q1_CHUNK + 77),
])
def test_q1_kernel_cases(dev, case, n):
    cols = _q1_case_columns(case, n, dev)
    if case == "offset_views":
        # every column a view at its own element offset, so no two start
        # on the same alignment
        cols = [c[k:] for k, c in enumerate(cols)]
        m = min(c.shape[0] for c in cols)
        cols = [c[:m] for c in cols]
    got = kq1._q1_partials_cuda(*cols)
    want = kq1.q1_partials_plain(*cols)
    assert torch.equal(got, want)
    if case == "one_slot":  # returnflag code 2, linestatus code 0
        assert int(got[4, 0]) == n and int(got[:, 0].sum()) == n
    elif case == "all_filtered":
        assert int(got[6, 0]) == n
    elif case == "all_missed":
        assert int(got[7, 0]) == n


def test_q1_kernel_empty_input(dev):
    cols = _q1_case_columns("chunks", 0, dev)
    kernels.reset_counts()
    got = kq1._q1_partials_cuda(*cols)
    assert kernels.launches() == {}
    assert got.is_cuda and torch.equal(
        got.cpu(), torch.zeros((8, 6), dtype=torch.int64))


def _mixed_table(n, dev, rng):
    limbs = rng.integers(-2**62, 2**62, (n, 2)).astype(np.int64)
    cols = [
        (rng.integers(-2**60, 2**60, n).astype(np.int64), t.INT64),
        (rng.integers(-100, 100, n).astype(np.int8), t.INT8),
        (rng.random(n), t.FLOAT64),
        (rng.integers(0, 2, n).astype(np.uint8), t.BOOL8),
        (rng.integers(-1000, 1000, n).astype(np.int16), t.INT16),
        (limbs, t.decimal128(-3)),
        (rng.integers(-2**31, 2**31, n).astype(np.int32), t.TIMESTAMP_DAYS),
        (rng.random(n).astype(np.float32), t.FLOAT32),
        (rng.integers(0, 2**16, n).astype(np.uint16), t.UINT16),
    ]
    return Table([
        Column.from_numpy(v, dt, _null_tail(n, 0.25, rng) if i % 2 else None,
                          device=dev)
        for i, (v, dt) in enumerate(cols)
    ])


@pytest.mark.parametrize("n", EDGE_ROWS)
def test_row_transpose_kernel_matches_plain(dev, n):
    tbl = _mixed_table(n, dev, np.random.default_rng(n))
    schema = tbl.schema()
    starts, _, spr = compute_fixed_width_layout(schema)
    datas = [c.data for c in tbl.columns]
    valids = [c.validity for c in tbl.columns]
    got = krt._assemble_rows_cuda(datas, valids, schema, starts, spr)
    want = krt.assemble_rows_plain(datas, valids, schema, starts, spr)
    assert torch.equal(got, want)
    back = convert_from_rows(convert_to_rows(tbl)[0], schema)
    assert back.equals(tbl)


def test_paths_launch_their_kernels(dev):
    li = tpch.lineitem_table(5000, seed=3, device=dev)
    kernels.reset_counts()
    planned = tpch.tpch_q1_planned(li)
    fused = kq1.tpch_q1_pallas(li)
    convert_to_rows(li)
    assert kernels.launches() == {kga.NAME: 1, kq1.NAME: 1, krt.NAME: 1}
    assert kernels.fallbacks() == {}
    for a, b in zip(fused.columns, planned.columns):
        assert torch.equal(a.data, b.data[:6])
        assert torch.equal(a.validity, b.validity[:6])


def test_wide_rows_fall_back_with_reason(dev):
    # rows wider than the 128-row staging (1,536 bytes) once fell back as
    # row_too_wide and raised on the card; the kernel now takes them:
    # one launch, no fallback, equal to the plain version
    n = 300
    rng = np.random.default_rng(0)
    tbl = Table([
        Column.from_numpy(rng.integers(0, 100, n).astype(np.int64),
                          device=dev)
        for _ in range(200)  # 200 x 8 + 25 validity bytes > 1536
    ])
    kernels.reset_counts()
    got = convert_to_rows(tbl, enforce_row_limit=False)
    assert kernels.fallbacks() == {}
    assert kernels.launches(krt.NAME) == 1
    schema = tbl.schema()
    starts, _, spr = compute_fixed_width_layout(schema)
    want = krt.assemble_rows_plain([c.data for c in tbl.columns],
                                   [c.validity for c in tbl.columns], schema,
                                   starts, spr)
    assert got[0].row_size == spr == 1632
    assert torch.equal(got[0].data.view(n, spr), want)


def _wide_table(ncols, n, dev, seed, layout="mixed"):
    """``ncols`` columns of ~10 % nulls. "mixed": cycling through every
    fixed width (1, 2, 4, 8 and 16 bytes: alignment gaps before each
    wider one), an all-valid column every seventh; "decimal128": DECIMAL128
    columns only, so every segment of the tiled kernel starts and ends on
    a 16-byte column; "int64 views": INT64 columns and bools that are the
    rows ``data[i]``, ``valid[i]`` of ``[ncols, n]`` tensors, so with n
    odd every other column's address is off 16 bytes and the bools' off
    4."""
    rng = np.random.default_rng(seed)
    if layout == "int64 views":
        data = torch.from_numpy(rng.integers(-2**62, 2**62, (ncols, n)))
        valid = torch.from_numpy(rng.random((ncols, n)) > 0.1)
        data, valid = data.to(dev), valid.to(dev)
        return Table([Column(t.INT64, data[i], valid[i])
                      for i in range(ncols)])
    kinds = [(t.INT8, np.int8), (t.INT64, np.int64), (t.INT16, np.int16),
             (t.FLOAT64, np.float64), (t.INT32, np.int32),
             (t.decimal128(-3), None), (t.UINT8, np.uint8)]
    if layout == "decimal128":
        kinds = [(t.decimal128(-3), None)]
    cols = []
    for i in range(ncols):
        dt, np_dt = kinds[i % len(kinds)]
        valid = None if i % 7 == 3 else rng.random(n) > 0.1
        if np_dt is None:
            data = rng.integers(-2**62, 2**62, (n, 2))
        elif np_dt == np.float64:
            data = rng.standard_normal(n)
        else:
            info = np.iinfo(np_dt)
            data = rng.integers(info.min, info.max, n, dtype=np_dt)
        cols.append(Column(dt, torch.from_numpy(data).to(dev),
                           None if valid is None
                           else torch.from_numpy(valid).to(dev)))
    return Table(cols)


@pytest.mark.parametrize("ncols,n,layout", [
    (7, 2049, "mixed"),     # 72-byte rows: the 128-row kernel
    (200, 257, "mixed"),    # 1,856 bytes: tiles of 32 rows, the last 1
    (1401, 33, "mixed"),    # 12,984 bytes: 10 segments
    (8000, 7, "mixed"),     # 74,152 bytes: one partial tile
    (33_000, 3, "mixed"),   # 305,840 bytes: wider than shared memory
    (150, 97, "decimal128"),  # 2,424 bytes: 16-byte columns at each edge
    (200, 257, "int64 views")])  # 1,632 bytes: columns off 16 bytes
def test_rows_of_any_width_equal_the_plain_version(dev, ncols, n, layout):
    tbl = _wide_table(ncols, n, dev, ncols, layout)
    schema = tbl.schema()
    starts, sizes, spr = compute_fixed_width_layout(schema)
    if spr > krt.MAX_ROW:
        plan = krt.tile_plan(starts, sizes, spr)
        assert n % plan.rows != 0  # a partial tile
        if layout == "decimal128":
            assert len(plan.segments) > 2 and all(
                s.begin in starts for s in plan.segments[1:]
                if not len(s.vbytes))
        if layout == "int64 views":
            assert tbl.column(1).data.data_ptr() % 16 == 8
    datas = [c.data for c in tbl.columns]
    valids = [c.validity for c in tbl.columns]
    kernels.reset_counts()
    got = krt._assemble_rows_cuda(datas, valids, schema, starts, spr)
    assert kernels.launches(krt.NAME) == 1
    want = krt.assemble_rows_plain(datas, valids, schema, starts, spr)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    back = convert_from_rows(convert_to_rows(
        tbl, enforce_row_limit=False)[0], schema)
    for a, b in zip(back.columns, tbl.columns):
        assert torch.equal(a.valid_mask(), b.valid_mask())
        v = b.valid_mask()
        assert torch.equal(a.data[v].view(torch.uint8),
                           b.data[v].view(torch.uint8))


def test_ineligible_groupby_raises(dev):
    """The bounded inputs the kernel once refused (a float sum, a float
    max) now launch it, with no fallback, and equal the CPU run."""
    n = 500
    rng = np.random.default_rng(1)
    f = rng.standard_normal(n)
    k = rng.integers(1, 3, n).astype(np.int8)
    for op in ("sum", "max"):
        got = []
        for d in (dev, "cpu"):
            tbl = Table([Column.from_numpy(k, device=d),
                         Column.from_numpy(f, device=d)])
            kernels.reset_counts()
            got.append(groupby_aggregate_bounded(tbl, [0], [(1, op)],
                                                 [(1, 2)]).table)
            assert kernels.fallbacks() == {}
        assert kernels.launches() == {} and torch.allclose(
            got[0].column(1).data.cpu(), got[1].column(1).data,
            rtol=1e-12, atol=0)


def test_empty_inputs_run_on_the_card(dev):
    li = tpch.lineitem_table(0, device=dev)
    ref = tpch.lineitem_table(0, device="cpu")
    kernels.reset_counts()
    got = tpch.tpch_q1_planned_result(li)
    fused = kq1.tpch_q1_pallas(li)
    rows = convert_to_rows(li)
    # no rows: no launch, and no fallback either
    assert kernels.launches() == {} and kernels.fallbacks() == {}
    want = tpch.tpch_q1_planned_result(ref)
    assert got.table.equals(want.table)
    assert torch.equal(got.present.cpu(), want.present)
    assert fused.equals(kq1.tpch_q1_pallas(ref))
    assert [(b.num_rows, b.data.numel()) for b in rows] == [(0, 0)]
    assert rows[0].data.is_cuda


_PROBE_TYPES = {torch.int32: np.int32, torch.int64: np.int64,
                torch.uint64: np.uint64}


def _probe_case(n, m, np_dt, rng, sentinel_tail=0.2):
    """Sorted build keys with duplicates and a dtype-max sentinel tail;
    probes that hit, miss, and sit at the dtype's min and max."""
    info = np.iinfo(np_dt)
    build = np.sort(rng.integers(-20, 20, m).astype(np_dt))
    if m:
        build[m - int(m * sentinel_tail):] = info.max
    probe = rng.integers(-25, 25, n).astype(np_dt)
    probe[:min(n, 3)] = np.asarray([info.min, info.max, 0],
                                   dtype=np_dt)[:min(n, 3)]
    return build, probe


def _probe_equal(dev, build, probe):
    b, p = khp.kernel_keys(torch.from_numpy(build).to(dev),
                           torch.from_numpy(probe).to(dev))
    got = khp._probe_cuda(b, p)
    want = khp.probe_lo_hi_plain(b, p)
    torch.cuda.synchronize()
    assert got[0].dtype == got[1].dtype == torch.int64
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    np.testing.assert_array_equal(got[0].cpu().numpy(),
                                  np.searchsorted(build, probe, "left"))
    np.testing.assert_array_equal(got[1].cpu().numpy(),
                                  np.searchsorted(build, probe, "right"))


@pytest.mark.parametrize("n", EDGE_ROWS)
@pytest.mark.parametrize("dtype", list(_PROBE_TYPES), ids=str)
def test_probe_kernel_matches_plain(dev, dtype, n):
    rng = np.random.default_rng(n)
    _probe_equal(dev, *_probe_case(n, max(n // 2, 1), _PROBE_TYPES[dtype],
                                   rng))


@pytest.mark.parametrize("case", ["empty_build", "all_sentinel",
                                  "duplicates", "large_build"])
def test_probe_kernel_edges(dev, case):
    rng = np.random.default_rng(3)
    if case == "empty_build":
        build, probe = _probe_case(257, 0, np.int64, rng)
    elif case == "all_sentinel":
        build, probe = _probe_case(2049, 300, np.int64, rng, 1.0)
    elif case == "duplicates":
        build = np.full(1000, 7, np.int32)
        probe = np.asarray([6, 7, 8] * 100, np.int32)
    else:
        build, probe = _probe_case(100_000, 70_000, np.int64, rng)
    _probe_equal(dev, build, probe)


@pytest.mark.parametrize("dtype", list(_PROBE_TYPES), ids=str)
@pytest.mark.parametrize("case", LEVEL_CASES)
def test_probe_kernel_index_levels(dev, case, dtype):
    # builds around the top level's capacity, a line, duplicate runs
    # across lines, a valid key at the max, all-sentinel and empty
    _probe_equal(dev, *level_case(case, _PROBE_TYPES[dtype], khp.TOP_KEYS))


@pytest.mark.parametrize("case", ["below_top", "past_line",
                                  "runs_across_lines"])
def test_probe_kernel_unaligned_build(dev, case):
    # a build view that starts 8 bytes into its storage is copied to a
    # 16-byte boundary for the kernel's vector loads
    build, probe = level_case(case, np.int64, khp.TOP_KEYS)
    storage = torch.from_numpy(np.concatenate([build[:1], build])).to(dev)
    b, p = storage[1:], torch.from_numpy(probe).to(dev)
    assert b.data_ptr() % 16 == 8
    got = khp._probe_cuda(b, p)
    want = khp.probe_lo_hi_plain(b, p)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_probe_kernel_empty_probe(dev):
    b = torch.arange(10, dtype=torch.int64, device=dev)
    kernels.reset_counts()
    lo, hi = khp.probe_lo_hi(b, b[:0])
    assert lo.shape == hi.shape == (0,) and lo.is_cuda
    assert kernels.launches() == {}


def test_q3_launches_the_probe_twice(dev):
    sizes = (300, 3000, 12000)

    def tables(device):
        return (tpch.customer_table(sizes[0], device=device),
                tpch.orders_table(sizes[1], sizes[0], device=device),
                tpch.lineitem_q3_table(sizes[2], sizes[1], device=device))

    card, cpu = tables(dev), tables("cpu")
    kernels.reset_counts()
    got = tpch.tpch_q3(*card)
    torch.cuda.synchronize()
    assert kernels.launches() == {khp.NAME: 2}
    assert kernels.fallbacks() == {}
    want = tpch.tpch_q3(*cpu)
    assert int(got.join_total) == int(want.join_total)
    assert int(got.result.num_groups) == int(want.result.num_groups)
    assert got.result.compact().equals(want.result.compact())
    kernels.reset_counts()
    planned = tpch.tpch_q3_planned(*card)
    assert kernels.launches() == {} and not bool(planned.pk_violation)
    assert planned.result.compact().equals(want.result.compact())


def test_sort_groupby_join_on_the_card_match_cpu(dev):
    # every fixed-width family through the sort, the general groupby and
    # the rank-encoded join on CUDA tensors, against the CPU run
    n = 2049
    card = _mixed_table(n, dev, np.random.default_rng(5))
    cpu = _mixed_table(n, "cpu", np.random.default_rng(5))
    keys = [1, 3, 6, 8, 7]
    assert torch.equal(sort_order(card, keys, [True, False, True, False,
                                               True]).cpu(),
                       sort_order(cpu, keys, [True, False, True, False,
                                              True]))
    aggs = [(0, "sum"), (4, "mean"), (0, "min"), (4, "max"), (8, "min"),
            (3, "max"), (6, "count"), (7, "min"), (7, "max")]
    got = groupby_aggregate(card, [1, 3], aggs)
    want = groupby_aggregate(cpu, [1, 3], aggs)
    assert int(got.num_groups) == int(want.num_groups)
    assert got.compact().equals(want.compact())
    kernels.reset_counts()
    maps = join(card, card, [1, 5, 2], [1, 5, 2], 4 * n, how="full")
    torch.cuda.synchronize()
    assert kernels.launches() == {khp.NAME: 2}
    ref = join(cpu, cpu, [1, 5, 2], [1, 5, 2], 4 * n, how="full")
    assert int(maps.total) == int(ref.total)
    for f in ("row_valid", "left_valid", "right_valid"):
        assert torch.equal(getattr(maps, f).cpu(), getattr(ref, f))


def _tpcds_tables(device):
    """Small TPC-DS tables: q72's four, q64's store_sales, q3's three."""
    return dict(
        q72=(tpcds.catalog_sales_table(20000, num_items=300, device=device),
             tpcds.date_dim_table(device=device),
             tpcds.item_table(300, device=device),
             tpcds.inventory_table(num_items=300, device=device)),
        q64=(tpcds.store_sales_table(30000, num_items=200,
                                     num_customers=400, device=device),),
        q3=(tpcds.date_dim_table(device=device),
            tpcds.store_sales_q3_table(30000, num_items=300, device=device),
            tpcds.item_q3_table(300, device=device)))


def _plan_result(res):
    """The plan's output table (compacted for the general plans) and its
    scalar results, on the CPU."""
    if hasattr(res, "result"):  # q64, planned q64
        scalars = [int(res.join_total), int(res.result.num_groups)]
        return res.result.compact(), scalars
    if hasattr(res, "num_groups"):  # q72
        return res.compact(), [int(res.num_groups)]
    scalars = [bool(res.pk_violation), int(res.present.sum())]
    if hasattr(res, "brand_domain_miss"):
        scalars.append(bool(res.brand_domain_miss))
    return res.table, scalars


@pytest.mark.parametrize("plan,tables,probes", [
    ("tpcds_q72", "q72", 3), ("tpcds_q72_planned", "q72", 0),
    ("tpcds_q64", "q64", 1), ("tpcds_q64_planned", "q64", 0),
    ("tpcds_q3", "q3", 0)])
def test_tpcds_plans_launch_the_probe(dev, plan, tables, probes):
    # q72's three joins and q64's self-join launch the probe kernel once
    # each, the planned plans and q3 never; the card equals the CPU
    card = _tpcds_tables(dev)[tables]
    cpu = _tpcds_tables("cpu")[tables]
    kernels.reset_counts()
    got = getattr(tpcds, plan)(*card)
    torch.cuda.synchronize()
    assert kernels.launches() == ({khp.NAME: probes} if probes else {})
    assert kernels.fallbacks() == {}
    got_table, got_scalars = _plan_result(got)
    want_table, want_scalars = _plan_result(getattr(tpcds, plan)(*cpu))
    assert got_scalars == want_scalars
    assert got_table.equals(want_table)


def _probe_kernel_equal(build, probe):
    got = khp._probe_cuda(*khp.kernel_keys(build, probe))
    want = khp.probe_lo_hi_plain(*khp.kernel_keys(build, probe))
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.equal(got[0], torch.searchsorted(build, probe))
    assert torch.equal(got[1], torch.searchsorted(build, probe, right=True))


def test_probe_kernel_at_q72_joins(dev):
    # join 1: a 730-key date build, 365 keys valid (the rest the
    # sentinel), all in the top level, against a 1M-row probe; joins 2 and
    # 3: the item build and the packed (item, week) inventory build
    joins = tpcds.q72_probe_inputs(
        tpcds.catalog_sales_table(1_000_000, num_items=1000, device=dev),
        tpcds.date_dim_table(device=dev), tpcds.item_table(1000, device=dev),
        tpcds.inventory_table(num_items=1000, device=dev))
    (build, n_valid, probe) = joins[0]
    assert build.shape[0] == 730 and int(n_valid) == 365
    assert probe.shape[0] == 1_000_000
    for build, _, probe in joins:
        _probe_kernel_equal(build, probe)


def test_probe_kernel_at_q64_self_join(dev):
    # a year's slice of the fact rows: duplicate (item, customer) keys in
    # the valid prefix and about half the build in the sentinel tail
    build, n_valid, probe = tpcds.q64_probe_inputs(tpcds.store_sales_table(
        400_000, num_items=50, num_customers=40, device=dev))
    s = int(n_valid)
    assert 0.4 < s / build.shape[0] < 0.6
    assert int(build[:s].unique().numel()) < s // 10
    _probe_kernel_equal(build, probe)


_VOCAB = ["", "a", "ab", "MAIL", "MAIL\x00", "SHIP", "\u00e9", "\u65e5\u672c",
          "PROMO PLATED BRASS", "a\x00b", "\U0001F600x", "zzzzzzzzzzzz"]


def _string_table(n, device, seed):
    """[a STRING key with nulls, an int32 key, an int64 value]."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, len(_VOCAB), n)
    valid = rng.random(n) > 0.2
    return Table([
        string_column([_VOCAB[i] if v else None for i, v in zip(idx, valid)],
                      device=device),
        Column.from_numpy(rng.integers(0, 3, n).astype(np.int32),
                          device=device),
        Column.from_numpy(rng.integers(-10**6, 10**6, n), device=device)])


def test_strings_on_the_card_match_cpu(dev):
    # LIKE, the string sort, the string-key groupby and a join on string
    # keys on CUDA tensors, against the same calls on the CPU
    n = 2049
    card, cpu = _string_table(n, dev, 3), _string_table(n, "cpu", 3)
    for pattern in ("%", "MAIL", "MAIL%", "_", "%\u00e9%", "a_b", "%_%b",
                    "PROMO%", "\U0001F600_"):
        assert like(card.column(0), pattern).equals(
            like(cpu.column(0), pattern)), pattern
    for asc in (True, False):
        assert torch.equal(
            sort_order(card, [0, 1], [asc, True], [False, True]).cpu(),
            sort_order(cpu, [0, 1], [asc, True], [False, True]))
    aggs = [(2, "sum"), (2, "count"), (0, "count")]
    got = groupby_aggregate(card, [0, 1], aggs)
    want = groupby_aggregate(cpu, [0, 1], aggs)
    assert int(got.num_groups) == int(want.num_groups)
    assert got.compact().equals(want.compact())
    small = _string_table(300, dev, 4)
    kernels.reset_counts()
    maps = join(card, small, [0], [0], 64 * n, how="inner")
    torch.cuda.synchronize()
    assert kernels.launches() == {khp.NAME: 1}
    small_cpu = _string_table(300, "cpu", 4)
    ref = join(cpu, small_cpu, [0], [0], 64 * n, how="inner")
    assert int(maps.total) == int(ref.total) <= 64 * n
    assert apply_join_maps(card, small, maps).equals(
        apply_join_maps(cpu, small_cpu, ref))


def _tpch_string_tables(device):
    """Small tables of the string TPC-H plans and q6."""
    li12 = tpch.lineitem_q12_table(40000, 3000, device=device)
    part = tpch.part_table(1000, device=device)
    return dict(
        q12=(tpch.orders_q12_table(3000, device=device), li12),
        q4=(tpch.orders_q4_table(3000, device=device), li12),
        q14=(part, tpch.lineitem_q14_table(40000, 1000, device=device)),
        q5=(tpch.customer_q5_table(300, device=device),
            tpch.orders_table(3000, 300, device=device),
            tpch.lineitem_q5_table(40000, 3000, 100, device=device),
            tpch.supplier_table(100, device=device),
            tpch.nation_table(device=device)),
        q6=(tpch.lineitem_table(40000, device=device),))


def _tpch_result(res):
    """A plan's result as (tables, scalars), tables on their device."""
    if isinstance(res, Column):  # q6
        return [Table([res])], []
    if hasattr(res, "result"):  # general q12, q4
        return [res.result.compact()], [int(res.join_total),
                                        int(res.result.num_groups)]
    if hasattr(res, "promo_revenue"):  # q14, planned q14
        return [], [int(v) if v.dtype != torch.bool else bool(v)
                    for v in res]
    # planned q12, q4 and q5
    return [res.table], [res.present.tolist(), bool(res.domain_miss)] + (
        [bool(res.pk_violation)] if hasattr(res, "pk_violation") else [])


@pytest.mark.parametrize("plan,tables,want", [
    ("tpch_q12", "q12", {khp.NAME: 1}),
    ("tpch_q12_planned_result", "q12", {khp.NAME: 1, kga.NAME: 1}),
    ("tpch_q4", "q4", {khp.NAME: 1}),
    ("tpch_q4_planned_result", "q4", {khp.NAME: 1, kga.NAME: 1}),
    ("tpch_q14", "q14", {khp.NAME: 1}),
    ("tpch_q14_planned", "q14", {}),
    ("tpch_q5", "q5", {kga.NAME: 1}),
    ("tpch_q6", "q6", {})])
def test_string_tpch_plans_launch_their_kernels(dev, plan, tables, want):
    # D once per general join, A once per bounded groupby, nothing else;
    # the card's result equals the CPU's
    card = _tpch_string_tables(dev)[tables]
    cpu = _tpch_string_tables("cpu")[tables]
    kernels.reset_counts()
    got = getattr(tpch, plan)(*card)
    torch.cuda.synchronize()
    assert kernels.launches() == want
    assert kernels.fallbacks() == {}
    got_tables, got_scalars = _tpch_result(got)
    want_tables, want_scalars = _tpch_result(getattr(tpch, plan)(*cpu))
    assert got_scalars == want_scalars
    for a, b in zip(got_tables, want_tables):
        assert a.equals(b)


def test_accumulate_kernel_at_q5_ids(dev):
    # the m > 16 side (m = 26) on q5's real nation ids
    gid, lanes, m = tpch.q5_accumulate_inputs(*_tpch_string_tables(dev)["q5"])
    assert m == 26 and int(gid.max()) <= m
    got = kga._accumulate_cuda(gid, lanes, m)
    want = kga.accumulate_plain(gid, lanes, m)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_probe_kernel_at_q4_semi_join(dev):
    # q4's LEFT-SEMI build: every lineitem slot, about 2/3 of them late
    # (valid), each order key on about 13 lineitem rows
    build, n_valid, probe = tpch.q4_probe_inputs(
        *_tpch_string_tables(dev)["q4"])
    s = int(n_valid)
    assert 0.55 < s / build.shape[0] < 0.75
    assert int(build[:s].unique().numel()) < s // 4
    _probe_kernel_equal(build, probe)


# ---- CastStrings and TPC-H q19, q17, q10 --------------------------------------

def _same_bytes(a: Column, b: Column) -> None:
    """Two columns of one cast on two devices: the same type, every data
    byte (under nulls too), the validity tri-state and, for STRING, the
    offsets and chars."""
    assert a.dtype == b.dtype
    assert a.data.dtype == b.data.dtype and a.data.shape == b.data.shape
    assert a.data.cpu().numpy().tobytes() == b.data.cpu().numpy().tobytes()
    assert (a.validity is None) == (b.validity is None)
    if a.validity is not None:
        assert torch.equal(a.validity.cpu(), b.validity.cpu())
    assert (a.chars is None) == (b.chars is None)
    if a.chars is not None:
        assert torch.equal(a.chars.cpu(), b.chars.cpu())


_CAST_TARGETS = [("string_to_integer", t.INT64), ("string_to_integer", t.INT8),
                 ("string_to_integer", t.UINT64),
                 ("string_to_integer", t.UINT32),
                 ("string_to_decimal", t.decimal64(-2)),
                 ("string_to_decimal", t.decimal32(-3)),
                 ("string_to_decimal", t.decimal64(2)),
                 ("string_to_float", t.FLOAT64), ("string_to_float", t.FLOAT32),
                 ("string_to_boolean", None), ("string_to_date", None),
                 ("string_to_timestamp", None)]


def _cast_string_columns(values, valid, device):
    offsets, chars, vmask = arrow_strings(values, valid)
    return Column.from_numpy(offsets, t.STRING, vmask, device=device,
                             chars=chars)


@pytest.mark.parametrize("n", EDGE_ROWS)
def test_parse_casts_on_the_card_match_cpu(dev, n):
    # every parse cast on CUDA tensors against the same function on the
    # CPU over the same bytes: exact, the float parses included
    vals = seeded_cast_strings(n, n)
    valid = null_tail(n, n)
    card = _cast_string_columns(vals, valid, dev)
    cpu = _cast_string_columns(vals, valid, "cpu")
    for fn, dtype in _CAST_TARGETS:
        args = () if dtype is None else (dtype,)
        _same_bytes(getattr(pcs, fn)(card, *args),
                    getattr(pcs, fn)(cpu, *args))


@pytest.mark.parametrize("which", ["mixed", "bench"])
def test_float_parse_on_the_card_is_bit_equal_to_cpu(dev, which):
    vals = mixed_float_strings(20_000, 17) if which == "mixed" \
        else bench_strings(20_000)
    card = _cast_string_columns(vals, None, dev)
    cpu = _cast_string_columns(vals, None, "cpu")
    for dtype in (t.FLOAT64, t.FLOAT32):
        _same_bytes(pcs.string_to_float(card, dtype),
                    pcs.string_to_float(cpu, dtype))


@pytest.mark.parametrize("n", EDGE_ROWS)
def test_number_to_string_on_the_card_matches_cpu(dev, n):
    rng = np.random.default_rng(n)
    valid = null_tail(n, n)
    cases = [
        ("integer_to_string", rng.integers(-2**63, 2**63 - 1, n,
                                           dtype=np.int64), t.INT64),
        ("integer_to_string", rng.integers(0, 2**64 - 1, n, dtype=np.uint64,
                                           endpoint=True), t.UINT64),
        ("integer_to_string", rng.integers(0, 2**32, n).astype(np.uint32),
         t.UINT32),
        ("integer_to_string", rng.integers(-128, 128, n).astype(np.int8),
         t.INT8),
        ("decimal_to_string", rng.integers(-10**12, 10**12, n),
         t.decimal64(-2)),
        ("decimal_to_string", rng.integers(-10**9 + 1, 10**9, n).astype(
            np.int32), t.decimal32(-9)),
        ("decimal_to_string", rng.integers(-10**6, 10**6, n),
         t.decimal64(3)),
        ("boolean_to_string", rng.integers(0, 2, n).astype(np.uint8),
         t.BOOL8),
        ("date_to_string", rng.integers(-2**31, 2**31, n,
                                        dtype=np.int64).astype(np.int32),
         t.TIMESTAMP_DAYS),
    ]
    for fn, data, dtype in cases:
        for vmask in (None, valid):
            card = Column.from_numpy(data, dtype, vmask, device=dev)
            cpu = Column.from_numpy(data, dtype, vmask, device="cpu")
            _same_bytes(getattr(pcs, fn)(card), getattr(pcs, fn)(cpu))


def _tpch_more_tables(device):
    """Small tables of q19, q17 and q10 (q10's lineitem is q3's with an
    INT8 l_returnflag drawn from b"ANR" appended)."""
    part = tpch.part_table(3000, device=device)
    li19 = tpch.lineitem_q19_table(40000, 3000, device=device)
    flags = np.random.default_rng(3).choice(np.frombuffer(b"ANR", np.int8),
                                            40000)
    li3 = tpch.lineitem_q3_table(40000, 3000, device=device)
    li10 = Table(list(li3.columns)
                 + [Column.from_numpy(flags, t.INT8, device=device)])
    return dict(q19=(part, li19), q17=(part, li19),
                q10=(tpch.customer_q5_table(300, device=device),
                     tpch.orders_table(3000, 300, device=device), li10))


@pytest.mark.parametrize("plan,tables,want", [
    ("tpch_q19", "q19", {khp.NAME: 1}),
    ("tpch_q19_planned", "q19", {}),
    ("tpch_q17", "q17", {khp.NAME: 2}),
    ("tpch_q10", "q10", {})])
def test_more_tpch_plans_launch_their_kernels(dev, plan, tables, want):
    # D once per general join, nothing else; the card's result equals
    # the CPU's
    card = _tpch_more_tables(dev)[tables]
    cpu = _tpch_more_tables("cpu")[tables]
    kernels.reset_counts()
    got = getattr(tpch, plan)(*card)
    torch.cuda.synchronize()
    assert kernels.launches() == want
    assert kernels.fallbacks() == {}
    ref = getattr(tpch, plan)(*cpu)
    if plan == "tpch_q10":
        assert got.result.compact().equals(ref.result.compact())
        assert int(got.join_total) == int(ref.join_total)
        assert not bool(got.pk_violation)
    else:
        assert [int(v) for v in got] == [int(v) for v in ref]


def test_probe_kernel_at_q19_and_q17_joins(dev):
    part, li = _tpch_more_tables(dev)["q19"]
    build, _, probe = tpch.q19_probe_inputs(part, li)
    _probe_kernel_equal(build, probe)
    for build, n_valid, probe in tpch.q17_probe_inputs(part, li):
        assert 0 < int(n_valid) < build.shape[0]
        _probe_kernel_equal(build, probe)


# ---- row hash, bloom filter, datetime, string q1 and q13 ---------------------

@pytest.mark.parametrize("n", EDGE_ROWS)
def test_row_hash_on_the_card_matches_cpu(dev, n):
    # every hashed type, chained and alone, and the partitions
    cols = hash_host_columns(n, n)
    card, cpu = (table_from_numpy(cols, device=d) for d in (dev, "cpu"))
    assert torch.equal(phash.table_xxhash64(card).cpu(),
                       phash.table_xxhash64(cpu))
    for i in range(card.num_columns):
        assert torch.equal(phash.table_xxhash64(card, [i], seed=7).cpu(),
                           phash.table_xxhash64(cpu, [i], seed=7)), cols[i][0]
    for parts in (1, 7, 200):
        assert torch.equal(phash.partition_hash(card, [4, 16], parts).cpu(),
                           phash.partition_hash(cpu, [4, 16], parts))


@pytest.mark.parametrize("n", EDGE_ROWS)
def test_bloom_filter_on_the_card_matches_cpu(dev, n):
    v, valid = bloom_values(n, n)
    m, k = pbf.optimal_params(max(n // 2, 1), 0.03)
    built = {}
    for d in (dev, "cpu"):
        f = pbf.bloom_put_spark(pbf.BloomFilter.empty(m, k, device=d),
                                torch.from_numpy(v).to(d),
                                torch.from_numpy(valid).to(d))
        hit = pbf.bloom_might_contain_spark(f, torch.from_numpy(v).to(d))
        built[str(d)] = (f.bits.cpu(), f.to_packed().cpu(), hit.cpu())
    for a, b in zip(built[str(dev)], built["cpu"]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("n", EDGE_ROWS)
def test_datetime_on_the_card_matches_cpu(dev, n):
    def cols(d):
        days = Column.from_numpy(seeded_days(n, n), t.TIMESTAMP_DAYS,
                                 null_tail(n, n), device=d)
        other = Column.from_numpy(seeded_days(n, n + 1), t.TIMESTAMP_DAYS,
                                  device=d)
        ts = Column.from_numpy(
            seeded_timestamps(n, n, "TIMESTAMP_MICROSECONDS"),
            t.TIMESTAMP_MICROSECONDS, null_tail(n, n + 2), device=d)
        return days, other, ts

    (days, other, ts), (cdays, cother, cts) = cols(dev), cols("cpu")
    for name in ("year", "month", "day", "day_of_week", "day_of_week_spark",
                 "day_of_year", "quarter", "last_day", "weekofyear"):
        _same_bytes(getattr(pdt, name)(days), getattr(pdt, name)(cdays))
        _same_bytes(getattr(pdt, name)(ts), getattr(pdt, name)(cts))
    for name in ("hour", "minute", "second"):
        _same_bytes(getattr(pdt, name)(ts), getattr(pdt, name)(cts))
    for unit in ("year", "quarter", "month", "week"):
        _same_bytes(pdt.trunc(days, unit), pdt.trunc(cdays, unit))
    _same_bytes(pdt.next_day(days, "fri"), pdt.next_day(cdays, "fri"))
    _same_bytes(pdt.date_add(days, -45), pdt.date_add(cdays, -45))
    _same_bytes(pdt.add_months(days, 13), pdt.add_months(cdays, 13))
    _same_bytes(pdt.datediff(days, other), pdt.datediff(cdays, cother))
    _same_bytes(pdt.months_between(days, other),
                pdt.months_between(cdays, cother))
    _same_bytes(pdt.months_between(ts, other),
                pdt.months_between(cts, cother))
    for unit in TIMESTAMP_DIVS:
        x = seeded_timestamps(n, n, unit)
        a = Column.from_numpy(x, t.DType(t.TypeId[unit]), device=dev)
        b = Column.from_numpy(x, t.DType(t.TypeId[unit]), device="cpu")
        for name in ("year", "hour", "second", "weekofyear"):
            _same_bytes(getattr(pdt, name)(a), getattr(pdt, name)(b))


def test_string_q1_and_q13_on_the_card_match_cpu(dev):
    # no kernel launch: the general sort-based groupby
    got = {}
    for d in (dev, "cpu"):
        kernels.reset_counts()
        q1 = tpch.tpch_q1(tpch.lineitem_table_strings(5000, 1, device=d))
        q13 = tpch.tpch_q13_reference(tpch.orders_table(3000, 400, device=d))
        assert kernels.launches() == {} and kernels.fallbacks() == {}
        got[str(d)] = (q1, q13)
    (q1, q13), (cq1, cq13) = got[str(dev)], got["cpu"]
    assert q13.equals(cq13)
    for a, b in zip(q1.columns, cq1.columns):
        assert a.equals(b)


# ---- RLIKE, get_json_object, substring, upper and lower -----------------------

def _regex_columns(values, valid, device):
    col = _cast_string_columns(values, valid, device)
    return col, pstr.pad_strings(col, width=80)


@pytest.mark.parametrize("n", EDGE_ROWS)
def test_rlike_on_the_card_matches_cpu(dev, n):
    """Arrow-laid log lines (the widest row fills the matrix: the
    sentinel step) and padded with slack, a refused pattern (the host
    engine) and a row holding a NUL (the host engine); no kernel."""
    values, valid = log_lines(n, n), null_tail(n, n)
    kernels.reset_counts()
    for col, ccol in zip(_regex_columns(values, valid, dev),
                         _regex_columns(values, valid, "cpu")):
        for pattern in (r"status=[45]\d\d", r"^GET .*ok$", r"id=\d+7",
                        r"(a)\1|ERR(?=OR)"):
            _same_bytes(pstr.regexp_contains(col, pattern),
                        pstr.regexp_contains(ccol, pattern))
    assert kernels.launches() == {}
    nul = values[:-1] + ["status=404\x00"]
    _same_bytes(pstr.regexp_contains(_cast_string_columns(nul, None, dev),
                                     "404"),
                pstr.regexp_contains(_cast_string_columns(nul, None, "cpu"),
                                     "404"))


def _json_docs(n):
    docs = bench_json_docs(n)
    extra = ['{"a":[{"field":1},{"field":2}]}', '{ "sku" : "x y" }',
             '{"meta":{"w":null}}', '[1,[2,3]]', '"s"', '{}', '']
    for i in range(0, n, 61):
        docs[i] = extra[i % len(extra)]
    return docs


@pytest.mark.parametrize("n", EDGE_ROWS)
def test_get_json_object_on_the_card_matches_cpu(dev, n):
    docs, valid = _json_docs(n), null_tail(n, n)
    col = _cast_string_columns(docs, valid, dev)
    ccol = _cast_string_columns(docs, valid, "cpu")
    for path in ("$.meta.w", "$.sku", "$.price", "$.nope", "$", "$.a[1]",
                 "$[1][0]"):
        _same_bytes(get_json_object(col, path), get_json_object(ccol, path))
    # an escaped row sends the column to the native host engine, whose
    # result comes back to the card
    esc_docs = docs[:-1] + ['{"s": "a\\"b"}']
    esc = _cast_string_columns(esc_docs, None, dev)
    assert not bool(pjd.device_eligible(esc))
    got = get_json_object(esc, "$.s")
    assert got.data.device.type == got.chars.device.type == dev.type
    _same_bytes(got, get_json_object(
        _cast_string_columns(esc_docs, None, "cpu"), "$.s"))


@pytest.mark.parametrize("n", EDGE_ROWS)
def test_substring_and_case_on_the_card_match_cpu(dev, n):
    """Mixed scripts with special rows (ß, final sigma, an astral
    character) merged back from the host, and log lines."""
    values = [v if i % 2 else w for i, (v, w) in enumerate(
        zip(mixed_script_rows(n, n), log_lines(n, n)))]
    valid = null_tail(n, n)
    col = _cast_string_columns(values, valid, dev)
    ccol = _cast_string_columns(values, valid, "cpu")
    recorded = []
    for c in (col, ccol):
        telemetry.reset()
        recorded.append((pstr.upper(c), pstr.lower(c),
                         telemetry.fallbacks()))
    for a, b in zip(recorded[0][:2], recorded[1][:2]):
        _same_bytes(a, b)
    assert recorded[0][2] == recorded[1][2]  # the same rows to the host
    for args in ((0, None), (3, 5), (-4, None), (-6, 3), (-100, 2)):
        _same_bytes(pstr.substring(col, *args), pstr.substring(ccol, *args))
    log = _cast_string_columns(log_lines(n, n + 1), valid, dev)
    clog = _cast_string_columns(log_lines(n, n + 1), valid, "cpu")
    for fn in (pstr.upper, pstr.lower):
        _same_bytes(fn(log), fn(clog))


# ---- regexp_extract, regexp_replace and the string functions ------------------

def _same_list(a: Column, b: Column) -> None:
    """Two LIST<STRING> columns of one call on two devices: the same
    offsets and validity, and the same child bytes."""
    assert a.dtype == b.dtype
    assert torch.equal(a.data.cpu(), b.data.cpu())
    assert (a.validity is None) == (b.validity is None)
    if a.validity is not None:
        assert torch.equal(a.validity.cpu(), b.validity.cpu())
    _same_bytes(a.children[0], b.children[0])


@pytest.mark.parametrize("n", EDGE_ROWS)
def test_capture_engine_on_the_card_matches_cpu(dev, n):
    """regexp_extract and regexp_replace over log lines, Arrow-laid (the
    gate appends the sentinel column) and padded with slack: the device
    engines on both devices, and the overflow route (a digit a match);
    the engines' own outputs and overflow flags; no kernel."""
    values, valid = log_lines(n, n), null_tail(n, n)
    kernels.reset_counts()
    for col, ccol in zip(_regex_columns(values, valid, dev),
                         _regex_columns(values, valid, "cpu")):
        for pattern, group in ((r"status=(\d+)", 1), (r"id=(\d+)", 1),
                               (r"^(\w+) (\S+)", 2), (r"(\d+)-(\d+)", 0),
                               (r"T(.*?)o", 1), (r"([a-z]{2,3}?)s", 1)):
            _same_bytes(pstr.regexp_extract(col, pattern, group),
                        pstr.regexp_extract(ccol, pattern, group))
        for pattern, rep in ((r"status=\d+", "status=XXX"), (r"\d", "#"),
                             (r"[aeiou]", ""), (r"o?k", "OK!")):
            _same_bytes(pstr.regexp_replace(col, pattern, rep),
                        pstr.regexp_replace(ccol, pattern, rep))
    assert kernels.launches() == {}
    mat = pstr.pad_strings(_cast_string_columns(values, valid, "cpu"),
                           width=80)
    comp = prc.compile_linear(r"\d")
    for rounds in (8, 2):
        got = prc.replace_device(mat.chars.to(dev), mat.data.to(dev), comp,
                                 b"<>", rounds)
        want = prc.replace_device(mat.chars, mat.data, comp, b"<>", rounds)
        for a, b in zip(got, want):
            assert torch.equal(a.cpu(), b)
    got = prc.extract_device(mat.chars.to(dev), comp, 0)
    for a, b in zip(got, prc.extract_device(mat.chars, comp, 0)):
        assert torch.equal(a.cpu(), b)


@pytest.mark.parametrize("n", EDGE_ROWS)
def test_string_functions_on_the_card_match_cpu(dev, n):
    """Every function of strings_fns over log lines (ASCII: the device
    paths) and over mixed-script rows (length, instr, reverse and split
    stay on the device there), Arrow-laid and padded with slack; no host
    branch on the log lines."""
    mixed = [v if i % 2 else w for i, (v, w) in enumerate(
        zip(mixed_script_rows(n, n), log_lines(n, n)))]
    valid = null_tail(n, n)
    fns = [pfn.length, pfn.trim, lambda c: pfn.ltrim(c, " G"), pfn.rtrim,
           lambda c: pfn.instr(c, "status"), lambda c: pfn.instr(c, "é"),
           lambda c: pfn.instr(c, ""), lambda c: pfn.repeat(c, 2),
           pfn.reverse, lambda c: pfn.concat(c, c),
           lambda c: pfn.concat_ws("|", [c, c]),
           lambda c: pfn.concat_ws("", [c])]
    ascii_fns = [lambda c: pfn.lpad(c, 80, "*"),
                 lambda c: pfn.rpad(c, 20, "+-"),
                 lambda c: pfn.translate(c, "0123456789", "abcdefghij"),
                 lambda c: pfn.translate(c, "aeiou", ""), pfn.initcap]
    telemetry.reset()
    for values, extra in ((log_lines(n, n + 2), ascii_fns), (mixed, [])):
        for col, ccol in zip(_regex_columns(values, valid, dev),
                             _regex_columns(values, valid, "cpu")):
            for fn in fns + extra:
                _same_bytes(fn(col), fn(ccol))
            for args in ((" ", -1, 5), (" ", 2, None), ("s=", -1, 3)):
                got, want = pfn.split(col, *args), pfn.split(ccol, *args)
                _same_list(got.column, want.column)
                assert bool(got.overflowed) == bool(want.overflowed)
    assert telemetry.fallbacks() == {}


# ---- kernel A's new inputs; the general groupby, DECIMAL128 and the table
# operations on the card ------------------------------------------------------


def _float_sum_close(got, want, gid, lane, m):
    """A float sum lane of the kernel within FLOAT_SUM_REL * sum(|x|) of
    the plain version's, NaN where it is NaN."""
    g, w = got.view(torch.float64), want.view(torch.float64)
    nan = torch.isnan(w)
    near = (g - w).abs() <= kga.float_sum_bound(gid, lane, m)
    return bool(((torch.isnan(g) == nan) & (nan | near)).all())


def _check_lanes(gid, lanes, m):
    got = kga._accumulate_cuda(gid, lanes, m)
    want = kga.accumulate_plain(gid, lanes, m)
    for i, lane in enumerate(lanes):
        if lane.op == "sum" and lane.values is not None \
                and lane.values.is_floating_point():
            assert _float_sum_close(got[:, i], want[:, i], gid, lane, m), i
        else:
            assert torch.equal(got[:, i], want[:, i]), i


@pytest.mark.parametrize("m", [5, 1032])
def test_accumulate_kernel_uint64_and_float_lanes(dev, m):
    # uint64 min/max around 2^63; float min/max with NaN and +-0 (ties
    # give -0.0 for min, +0.0 for max, NaN wins); float sums in float64
    n = 3 * 8192 + 77
    rng = np.random.default_rng(m)
    gid = torch.from_numpy(rng.integers(0, m + 1, n).astype(np.int32)).to(dev)
    u = rng.integers(2**63 - 1000, 2**63 + 1000, n, dtype=np.uint64)
    u[::7] = rng.integers(0, 2**64 - 1, len(u[::7]), dtype=np.uint64)
    f = rng.standard_normal(n) * 1e3
    f[rng.random(n) < 0.3] = 0.0
    f[rng.random(n) < 0.3] *= -0.0
    f[rng.random(n) < 0.002] = np.nan
    u64 = torch.from_numpy(u).to(dev)
    f64 = torch.from_numpy(f).to(dev)
    f32 = f64.to(torch.float32)
    valid = torch.from_numpy(_null_tail(n, 0.25, rng)).to(dev)
    lanes = [kga.Lane("min", u64, valid, 2**64 - 1),
             kga.Lane("max", u64, None, 0),
             kga.Lane("sum", u64, valid, 0)]
    for x in (f64, f32):
        lanes += [kga.Lane("min", x, valid, float("inf")),
                  kga.Lane("max", x, None, float("-inf")),
                  kga.Lane("sum", x, valid, 0.0),
                  kga.Lane("sum", x, None, 0.0)]
    _check_lanes(gid, lanes, m)
    # a float sum repeats bit for bit run to run (a fixed order)
    first = kga._accumulate_cuda(gid, lanes, m)
    assert torch.equal(first, kga._accumulate_cuda(gid, lanes, m))


@pytest.mark.parametrize("m,num_lanes,with_float", [
    (101, 22, False), (1032, 16, False), (1032, 40, False), (4096, 9, False),
    (20_000, 1, False), (1032, 16, True), (17, 9, True), (3, 13, True),
    (40_000, 3, False), (100_001, 5, True), (23_300, 1, False)])
def test_accumulate_kernel_past_the_old_cap(dev, m, num_lanes, with_float):
    # m*L above the TPU kernel's 2048 cells; lanes past what one block's
    # shared memory holds split over launches, each reading gid again,
    # and domains past one lane's shared memory take the one-pass kernel.
    # With a float lane, every integer kind goes through the kernels that
    # hold the float paths.
    n = 3 * 8192 + 77
    rng = np.random.default_rng(m + num_lanes)
    gid = torch.from_numpy(rng.integers(0, m + 1, n).astype(np.int32)).to(dev)
    lanes = _cycled_lanes(num_lanes, n, dev, rng)
    if with_float:
        f = torch.from_numpy(rng.standard_normal(n)).to(dev)
        lanes.append(kga.Lane("max", f.to(torch.float32), None,
                              float("-inf")))
        num_lanes += 1
    assert kga.unsupported_reason(lanes, m) is None
    kernels.reset_counts()
    _check_lanes(gid, lanes, m)
    assert kernels.launches(kga.NAME) == kga.launches(m, num_lanes)
    # past ~23,000 slots the domain takes one pass: no reason left
    assert kga.unsupported_reason(lanes, 40_000) is None


@pytest.mark.parametrize("ids", ["one_group", "hot_half", "hot_then_spread"])
def test_accumulate_one_pass_hot_groups(dev, ids):
    # m = 100,001 (the one-pass kernel): every row in one group, half the
    # rows in one hot group, and a hot first half then spread rows (a
    # warp's run of the hot group flushed when it stops appearing); the
    # float min/max and uint64 lanes through the kernel with float paths
    m = 100_001
    n = 5 * 8192 + 77
    rng = np.random.default_rng(len(ids))
    spread = rng.integers(0, m + 1, n)
    g = {"one_group": np.full(n, 4242),
         "hot_half": np.where(rng.random(n) < 0.5, 4242, spread),
         "hot_then_spread": np.where(np.arange(n) < n // 2, 77, spread)}[ids]
    gid = torch.from_numpy(g.astype(np.int32)).to(dev)
    lanes = _cycled_lanes(9, n, dev, rng)
    f = torch.from_numpy(rng.standard_normal(n)).to(dev)
    lanes += [kga.Lane("min", f, None, float("inf")),
              kga.Lane("max", f.to(torch.float32), None, float("-inf"))]
    kernels.reset_counts()
    got = kga._accumulate_cuda(gid, lanes, m)
    assert kernels.launches(kga.NAME) == kga.launches(m, len(lanes)) == 1
    assert torch.equal(got, kga.accumulate_plain(gid, lanes, m))


@pytest.mark.parametrize("m", [17, 1032, 100_001])
def test_accumulate_sum_carries(dev, m):
    # int64 and uint64 sums whose low words sit just below 2^32 (every add
    # carries into the high word), with negative values and the uint64
    # top range: the shared kernel's 32-bit halves (m = 17 and 1,032,
    # 256- and 1,024-thread blocks) and the one-pass kernel's 64-bit adds
    n = 3 * 8192 + 77
    rng = np.random.default_rng(m)
    gid = torch.from_numpy(rng.integers(0, m + 1, n).astype(np.int32)).to(dev)
    lo = (2**32 - 1 - rng.integers(0, 64, n)).astype(np.int64)
    hi = rng.integers(-2**20, 2**20, n).astype(np.int64)
    i64 = hi * 2**32 + lo
    i64[::3] = -i64[::3]
    u64 = (rng.integers(2**64 - 2**40, 2**64 - 1, n, dtype=np.uint64)
           | np.uint64(0xFFFFFF00))
    valid = torch.from_numpy(rng.random(n) > 0.1).to(dev)
    a = torch.from_numpy(i64).to(dev)
    b = torch.from_numpy(u64).to(dev)
    lanes = [kga.Lane("sum", a, None, 0), kga.Lane("sum", a, valid, 0),
             kga.Lane("sum", b, None, 0), kga.Lane("sum", b, valid, 0),
             kga.Lane("sum", a.to(torch.int32), None, 0)]
    for one_group in (False, True):
        g = torch.full_like(gid, m - 1) if one_group else gid
        assert torch.equal(kga._accumulate_cuda(g, lanes, m),
                           kga.accumulate_plain(g, lanes, m))


@pytest.mark.parametrize("m", [1032, 100_001])
def test_accumulate_identical_lanes_run_once(dev, m):
    # the planner repeats a count lane for each aggregate that needs one:
    # past shared memory identical lanes run once and fill every column
    # they stand for; below it they share the one launch
    n = 3 * 8192 + 77
    rng = np.random.default_rng(m + 1)
    gid = torch.from_numpy(rng.integers(0, m + 1, n).astype(np.int32)).to(dev)
    v = torch.from_numpy(rng.integers(-99, 99, n)).to(dev)
    valid = torch.from_numpy(rng.random(n) > 0.1).to(dev)
    count = kga.Lane("sum", None, None, 0)
    lanes = [count, kga.Lane("sum", v, valid, 0), count,
             kga.Lane("max", v, valid, -2**63), count,
             kga.Lane("sum", v, valid, 0)]
    kernels.reset_counts()
    got = kga._accumulate_cuda(gid, lanes, m)
    assert kernels.launches(kga.NAME) == kga.launches(m, 3) == 1
    assert torch.equal(got, kga.accumulate_plain(gid, lanes, m))


def test_accumulate_float_sum_wide_domain_repeats(dev):
    # a float-sum lane at m = 100,001 takes windows of the large kernel
    # (a fixed order) beside the one pass of the others: the same bits in
    # three runs, within FLOAT_SUM_REL * sum|x| of the plain version
    m = 100_001
    n = 5 * 8192 + 77
    rng = np.random.default_rng(5)
    gid = torch.from_numpy(rng.integers(0, m + 1, n).astype(np.int32)).to(dev)
    x = rng.standard_normal(n) * 1e3
    x[rng.random(n) < 0.002] = np.nan
    f = torch.from_numpy(x).to(dev)
    valid = torch.from_numpy(rng.random(n) > 0.1).to(dev)
    lanes = [kga.Lane("sum", None, valid, 0), kga.Lane("sum", f, valid, 0.0),
             kga.Lane("max", f, None, float("-inf"))]
    kernels.reset_counts()
    runs = [kga._accumulate_cuda(gid, lanes, m) for _ in range(3)]
    assert kernels.launches(kga.NAME) == 3 * kga.launches(m, 3, 1) == 3 * 6
    assert torch.equal(runs[0], runs[1]) and torch.equal(runs[0], runs[2])
    _check_lanes(gid, lanes, m)


def _refused_inputs(n, device, rng):
    """Columns the old bounded plan refused on the card: FLOAT64 and
    FLOAT32 values (sums, means, min/max), UINT64 keys and values, and a
    100-value key (m * L past 2048)."""
    f = rng.standard_normal(n)
    f[rng.random(n) < 0.01] = np.nan
    keys = np.array([1, 2**63 - 1, 2**63, 2**64 - 1], np.uint64)
    return Table([
        Column.from_numpy(rng.integers(0, 100, n).astype(np.int32),
                          device=device),
        Column.from_numpy(rng.choice(keys, n), device=device),
        Column.from_numpy(f, validity=rng.random(n) > 0.1, device=device),
        Column.from_numpy(f.astype(np.float32), device=device),
        Column.from_numpy(rng.integers(0, 2**64 - 1, n, dtype=np.uint64),
                          device=device),
    ]), keys


@pytest.mark.parametrize("n", [257, 2049])
def test_plan_groupby_takes_the_refused_inputs_on_the_card(dev, n):
    from spark_rapids_jni_tpu_torch.ops.planner import (
        plan_groupby,
        scalar_domain,
    )

    aggs = [(2, "sum"), (2, "mean"), (2, "min"), (2, "max"), (3, "sum"),
            (3, "max"), (4, "min"), (4, "max"), (4, "sum"), (2, "count")]
    out = []
    for d in (dev, "cpu"):
        tbl, keys = _refused_inputs(n, d, np.random.default_rng(n))
        doms = [scalar_domain(range(100)), scalar_domain(keys.tolist())]
        kernels.reset_counts()
        res = plan_groupby(tbl, [0, 1], aggs, doms)
        assert res.lowered == "bounded" and kernels.fallbacks() == {}
        out.append(res)
    assert kernels.launches() == {}  # the CPU run: the plain version
    card, cpu = out
    assert torch.equal(card.present.cpu(), cpu.present)
    for i, (a, b) in enumerate(zip(card.table.columns, cpu.table.columns)):
        assert torch.equal(a.valid_mask().cpu(), b.valid_mask()), i
        x, y = a.data.cpu(), b.data
        if i in (2, 3, 6):  # float sums and means: another order
            rtol = 1e-6 if x.dtype == torch.float32 else 1e-12
            assert torch.allclose(x, y, rtol=rtol, atol=0, equal_nan=True), i
        elif x.is_floating_point():
            assert bool(((x == y) | (torch.isnan(x) & torch.isnan(y))).all())
        else:
            assert torch.equal(x.view(torch.int64) if x.dtype == torch.uint64
                               else x, y.view(torch.int64)
                               if y.dtype == torch.uint64 else y), i


def _wide_columns(n, device, rng):
    """An INT8 key and a DECIMAL128 column of up to 110-bit values of
    either sign, with a null tail."""
    v = [int(x) << int(s) for x, s in zip(rng.integers(0, 2**62, n),
                                           rng.integers(0, 48, n))]
    v = [x if rng.random() < 0.5 else -x for x in v]
    lo = [x & (2**64 - 1) for x in v]
    limbs = np.array([[a - 2**64 if a >= 2**63 else a, x >> 64]
                      for a, x in zip(lo, v)], np.int64)
    return Table([
        Column.from_numpy(rng.integers(0, 5, n).astype(np.int8),
                          device=device),
        Column.from_numpy(limbs, t.decimal128(-3),
                          _null_tail(n, 0.2, rng), device=device)])


@pytest.mark.parametrize("n", EDGE_ROWS)
def test_decimal128_mean_and_var_on_the_card_match_cpu(dev, n):
    from spark_rapids_jni_tpu_torch.ops import reduce

    aggs = [(1, "sum"), (1, "mean"), (1, "var"), (1, "std_pop"),
            (1, "min"), (1, "max"), (1, ("corr", 0))]
    card = _wide_columns(n, dev, np.random.default_rng(n))
    cpu = _wide_columns(n, "cpu", np.random.default_rng(n))
    got = groupby_aggregate(card, [0], aggs)
    want = groupby_aggregate(cpu, [0], aggs)
    assert int(got.num_groups) == int(want.num_groups)
    k = int(want.num_groups)
    for a, b in zip(got.table.columns, want.table.columns):
        # bit for bit: integer limbs, then the same float steps
        assert torch.equal(a.valid_mask()[:k].cpu(), b.valid_mask()[:k])
        x, y = a.data[:k].cpu(), b.data[:k]
        if x.is_floating_point():
            x, y = x.view(torch.int64), y.view(torch.int64)
        assert torch.equal(x, y)
    for fn in ("sum_", "mean", "min_", "max_"):
        (a, ok_a), (b, ok_b) = (getattr(reduce, fn)(c.column(1))
                                for c in (card, cpu))
        a, b = (x.data if isinstance(x, Column) else x for x in (a, b))
        assert bool(ok_a) == bool(ok_b) and torch.equal(a.cpu(), b), fn


@pytest.mark.parametrize("n", [257, 2049])
def test_general_aggregates_and_table_ops_on_the_card_match_cpu(dev, n):
    from spark_rapids_jni_tpu_torch.ops import table_ops
    from spark_rapids_jni_tpu_torch.ops.groupby import groupby_percentile

    def build(device):
        tbl = _mixed_table(n, device, np.random.default_rng(n + 1))
        words = string_column([["a", "bb", "", None][i % 4]
                               for i in range(n)], device=device)
        return Table(list(tbl.columns) + [words])

    card, cpu = build(dev), build("cpu")
    s = card.num_columns - 1
    aggs = [(0, "var"), (4, "std"), (0, ("covar_samp", 4)),
            (0, ("corr", 4)), (6, "nunique"), (4, "first"), (4, "last"),
            (0, "first_include_nulls"), (s, "min"), (s, "max"),
            (s, "last_include_nulls")]
    got = groupby_aggregate(card, [1, 3], aggs)
    want = groupby_aggregate(cpu, [1, 3], aggs)
    k = int(want.num_groups)
    assert int(got.num_groups) == k
    for i, (a, b) in enumerate(zip(got.compact().columns,
                                   want.compact().columns)):
        if i in (2, 3, 4, 5):  # float64 two-pass moments: another order
            assert torch.equal(a.valid_mask().cpu(), b.valid_mask())
            scale = float(torch.nan_to_num(b.data).abs().max())
            assert torch.allclose(a.data.cpu(), b.data, rtol=1e-9,
                                  atol=1e-9 * scale, equal_nan=True), i
        else:
            assert a.equals(b), i
    p_card = groupby_percentile(card, [1], 4, [0.1, 0.5, 0.99])
    p_cpu = groupby_percentile(cpu, [1], 4, [0.1, 0.5, 0.99])
    assert p_card.compact().equals(p_cpu.compact())
    mask = torch.arange(n) % 3 != 1
    kernels.reset_counts()
    for fn in (lambda tb, m: table_ops.apply_boolean_mask(tb, m),
               lambda tb, m: table_ops.distinct(tb, [1, 3, s]),
               lambda tb, m: table_ops.intersect_rows(
                   Table(tb.columns[1:2]), Table(tb.columns[1:2])),
               lambda tb, m: table_ops.except_rows(
                   Table(tb.columns[1:2]), Table([tb.columns[1]]))):
        a = fn(card, mask.to(dev))
        b = fn(cpu, mask)
        assert int(a.num_rows) == int(b.num_rows)
        assert a.table.equals(b.table)
    cat = table_ops.concatenate([card, card])
    assert cat.num_rows == 2 * n and cat.equals(table_ops.concatenate(
        [cpu, cpu]))
    assert kernels.launches() == {}  # no kernel of A-D on these paths


# ---- the readers: native decode staged through pinned memory --------------


def _reader_parquet(n: int) -> bytes:
    """A Parquet file of every type the reader maps (FLBA decimals at 7
    and 12 bytes, negatives), a null tail, v1 snappy pages."""
    pq = writer_module("parquet_util")
    rng = np.random.default_rng(n)
    tail = max(1, n // 3)

    def col(name, phys, vals, **kw):
        vals = list(vals)[:n - tail] + [None] * tail
        return pq.ColumnSpec(name, phys, vals, **kw)

    ints = rng.integers(-2**40, 2**40, n)
    cols = [
        col("b", pq.BOOLEAN, (bool(v & 1) for v in ints)),
        col("i8", pq.INT32, (int(v) % 256 - 128 for v in ints),
            converted=15),
        col("u16", pq.INT32, (int(v) % 65536 for v in ints), converted=12),
        col("date", pq.INT32, (int(v) % 40000 for v in ints), converted=6),
        col("i64", pq.INT64, (int(v) for v in ints)),
        col("f64", pq.DOUBLE, (float(v) / 7 for v in ints)),
        col("s", pq.BYTE_ARRAY, (f"r{int(v)}" for v in ints), converted=0),
        col("d7", pq.FLBA, (int(v) for v in ints), converted=5, scale=2,
            precision=16, type_length=7),
        col("d12", pq.FLBA, (int(v) * 10**9 for v in ints), converted=5,
            scale=2, precision=28, type_length=12),
        col("dict", pq.INT64, (int(v) % 13 for v in ints),
            use_dictionary=True),
    ]
    return pq.write_parquet(cols, row_group_size=1024, codec=pq.SNAPPY,
                            page_rows=256)


@pytest.mark.parametrize("n", EDGE_ROWS)
def test_parquet_read_on_the_card_matches_cpu(dev, n):
    from spark_rapids_jni_tpu_torch.parquet import reader as preader

    data = _reader_parquet(n)
    want = preader.read_table(data, device="cpu")
    got = preader.read_table(data, device=dev)
    assert all(c.data.device.type == dev.type for c in got.columns)
    for a, b in zip(got.columns, want.columns, strict=True):
        _same_bytes(a, b)
    host = preader.read_table(data, stage="host", device=dev)
    for dtype, values, validity, chars, _ in host.cols:
        for x in (values, validity, chars):
            assert x is None or x.is_pinned(), dtype
    for a, b in zip(host.stage().columns, want.columns, strict=True):
        assert a.data.device.type == dev.type
        _same_bytes(a, b)
    chunks = list(preader.ParquetChunkedReader(data, 1, device=dev))
    from spark_rapids_jni_tpu_torch.ops.table_ops import concatenate

    for a, b in zip(concatenate(chunks).columns, want.columns, strict=True):
        _same_bytes(a, b)


@pytest.mark.parametrize("width", [1, 4, 7, 8, 9, 12, 15, 16])
def test_flba_widening_on_the_card_matches_cpu(dev, width):
    from spark_rapids_jni_tpu_torch.parquet import reader as preader

    raw = torch.from_numpy(np.random.default_rng(width).integers(
        0, 256, 4096 * width).astype(np.uint8))
    raw[:width] = 0x80
    fn = preader._flba_to_int64 if width <= 8 else preader._flba_to_int128
    assert torch.equal(fn(raw.to(dev), width).cpu(), fn(raw, width))


@pytest.mark.parametrize("n", EDGE_ROWS)
def test_orc_read_on_the_card_matches_cpu(dev, n):
    from spark_rapids_jni_tpu_torch.orc import reader as oreader

    ou = writer_module("orc_util")

    rng = np.random.default_rng(n)
    ints = [int(v) for v in rng.integers(-2**40, 2**40, n)]
    nul = [v if i % 5 else None for i, v in enumerate(ints)]
    data = ou.write_orc([
        ou.ColumnSpec("b", ou.BOOLEAN, [v & 1 == 1 for v in ints]),
        ou.ColumnSpec("i8", ou.BYTE, [v % 256 - 128 for v in ints]),
        ou.ColumnSpec("i16", ou.SHORT, [v % 65536 - 32768 for v in ints]),
        ou.ColumnSpec("i64", ou.LONG, nul),
        ou.ColumnSpec("f32", ou.FLOAT, [float(np.float32(v / 3))
                                        for v in ints]),
        ou.ColumnSpec("s", ou.STRING, [f"o{v}" for v in ints]),
        ou.ColumnSpec("d", ou.DATE, [v % 40000 for v in ints]),
        ou.ColumnSpec("dec", ou.DECIMAL, [v * 10**9 for v in ints],
                      precision=30, scale=3),
    ], stripe_size=1000, codec=ou.ZLIB)
    want = oreader.read_table(data, device="cpu")
    got = oreader.read_table(data, device=dev)
    for a, b in zip(got.columns, want.columns, strict=True):
        assert a.data.device.type == dev.type
        _same_bytes(a, b)
    host = oreader.read_table(data, stage="host", device=dev)
    for dtype, values, validity, chars, _ in host.cols:
        for x in (values, validity, chars):
            assert x is None or x.is_pinned(), dtype
    for a, b in zip(host.stage().columns, want.columns, strict=True):
        _same_bytes(a, b)


# ---- the executor and the bridge (runtime/fusion.py, runtime/bridge.py) ----


@pytest.mark.parametrize("n", EDGE_ROWS)
def test_execute_equals_hand_composed_nodes_on_the_card(dev, n):
    from spark_rapids_jni_tpu_torch.ops.planner import (
        plan_groupby,
        scalar_domain,
    )

    li = tpch.lineitem_table(n, seed=n, device=dev)
    kernels.reset_counts()
    got = tpch.tpch_q1_planned_result(li)
    torch.cuda.synchronize()
    assert kernels.launches() == {kga.NAME: 1} and not kernels.fallbacks()
    want = plan_groupby(
        tpch._q1_work_table(li), (0, 1), tpch._Q1_AGGS,
        (scalar_domain(tpch._Q1_RF_DOMAIN),
         scalar_domain(tpch._Q1_LS_DOMAIN)))
    assert got.table.equals(want.table)
    assert torch.equal(got.present, want.present)
    assert torch.equal(got.domain_miss, want.domain_miss)
    assert got.overflowed.device.type == "cuda" and not bool(got.overflowed)
    q6 = tpch.tpch_q6(li)
    assert q6.device.type == "cuda"
    assert Table([q6]).equals(tpch._q6_reduce(li, None))


def test_bridge_round_trip_on_the_card(dev):
    from pathlib import Path

    from spark_rapids_jni_tpu_torch.runtime import native
    from torch_parity import (
        RT_TABLE,
        RT_VALID,
        rt_check,
        rt_column,
        rt_column_host,
        rt_from_rows,
        rt_rows_bytes,
        rt_rows_info,
        rt_table,
        rt_to_rows,
    )

    lib = native.load_rt_bridge()
    rt_check(lib, lib.tpudf_rt_init(
        str(Path(__file__).resolve().parents[1]).encode(), b"") == 0,
        "init")
    li = tpch.lineitem_table(2049, seed=3, device="cpu")
    host = [(int(c.dtype.type_id), c.dtype.scale, c.data.numpy(),
             np.arange(2049) % 7 != 0) for c in li.columns]
    host += [(tid, s, np.resize(d, 2049), np.resize(RT_VALID, 2049))
             for tid, s, d in RT_TABLE]
    cols = [rt_column(lib, *h) for h in host]
    tbl = rt_table(lib, cols)
    (rows,) = rt_to_rows(lib, tbl)
    image = rt_rows_bytes(lib, rows)
    direct = convert_to_rows(table_from_numpy(
        [(tid, s, d, v) for tid, s, d, v in host], device=dev))
    assert np.array_equal(image, direct[0].data.cpu().numpy())
    n, size = rt_rows_info(lib, rows)
    again = lib.tpudf_rt_rows_from_host(n, size, image.tobytes())
    back = rt_from_rows(lib, again, [(tid, s) for tid, s, _, _ in host])
    for i, (tid, s, d, v) in enumerate(host):
        info, raw, valid = rt_column_host(lib, back, i, d.itemsize)
        assert info == (tid, s, 2049)
        assert np.array_equal(valid.astype(bool), v)
        assert np.array_equal(raw.view(d.dtype)[v], d[v])
    for h in cols + [tbl, rows, again, back]:
        assert lib.tpudf_rt_free(h) == 0


# ---- the remaining operators: elementwise, lists, structs, window ---------


def _on_both(spec, dev):
    from torch_parity import spec_to_port

    return spec_to_port(spec, "cpu"), spec_to_port(spec, dev)


def _same_rows(got, want, what=""):
    from torch_parity import canon

    assert canon(got) == canon(want), what


@pytest.mark.parametrize("n", EDGE_ROWS)
def test_elementwise_on_the_card_match_cpu(dev, n):
    from spark_rapids_jni_tpu_torch.ops import elementwise as pe

    rng = np.random.default_rng(n)
    f = rng.standard_normal(n) * 10.0 ** rng.integers(-3, 25, n)
    f[rng.random(n) < 0.1] = np.nan
    f[rng.random(n) < 0.05] = np.inf
    specs = {
        "a": (4, 0, rng.integers(-2**62, 2**62, n), null_tail(n, n)),
        "b": (4, 0, rng.integers(-9, 9, n), null_tail(n, n + 1)),
        "f": (10, 0, f, null_tail(n, n + 2)),
        "g": (10, 0, rng.standard_normal(n) * 3, None),
        "d": (26, -4, rng.integers(-10**12, 10**12, n), null_tail(n, n + 3)),
        "u": (8, 0, rng.integers(0, 2**63, n, dtype=np.uint64) * 2 + 1,
              None),
        "v": (8, 0, rng.integers(0, 50, n, dtype=np.uint64), None),
        "s": (23, 0, arrow_strings([f"w{i % 7}" for i in range(n)])[:2],
              null_tail(n, n + 4)),
    }
    cols = {k: _on_both(s, dev) for k, s in specs.items()}
    calls = {
        "coalesce": lambda c: pe.coalesce([c["a"], c["b"]]),
        "coalesce_s": lambda c: pe.coalesce([c["s"], c["s"]]),
        "nullif": lambda c: pe.nullif(c["a"], c["b"]),
        "nullif_s": lambda c: pe.nullif(c["s"], c["s"]),
        "greatest": lambda c: pe.greatest([c["f"], c["g"]]),
        "least_u": lambda c: pe.least([c["u"], c["v"]]),
        "abs": lambda c: pe.abs_(c["f"]),
        "ceil": lambda c: pe.ceil(c["f"]),
        "floor": lambda c: pe.floor(c["f"]),
        "ceil_d": lambda c: pe.ceil(c["d"]),
        "round": lambda c: pe.round_decimal(c["d"], 1),
        "pmod": lambda c: pe.pmod(c["a"], c["b"]),
        "pmod_f": lambda c: pe.pmod(c["f"], c["g"]),
        "pmod_u": lambda c: pe.pmod(c["u"], c["v"]),
    }
    cpu = {k: v[0] for k, v in cols.items()}
    card = {k: v[1] for k, v in cols.items()}
    for name, fn in calls.items():
        got = fn(card)
        assert got.data.device.type == "cuda", name
        _same_rows(got, fn(cpu), name)


def test_float_to_bigint_and_pmod_edges_on_the_card(dev):
    from spark_rapids_jni_tpu_torch.ops import elementwise as pe

    f = Column.from_numpy(np.array([np.nan, np.inf, -np.inf, 1e30, -1e30,
                                    2.5, -2.5, 2.0 ** 63]), device=dev)
    mx, mn = (1 << 63) - 1, -(1 << 63)
    assert pe.ceil(f).data.tolist() == [0, mx, mn, mx, mn, 3, -2, mx]
    assert pe.floor(f).data.tolist() == [0, mx, mn, mx, mn, 2, -3, mx]
    a = Column.from_numpy(np.array([mn, mn, mx, -7, 7], np.int64), device=dev)
    b = Column.from_numpy(np.array([-1, 1, -1, 3, -3], np.int64), device=dev)
    assert pe.pmod(a, b).data.tolist() == [0, 0, 0, 2, 1]
    rng = np.random.default_rng(1)
    x = rng.standard_normal(1_000_000) * 10.0 ** rng.integers(-5, 5, 1_000_000)
    y = rng.standard_normal(1_000_000) * 10.0 ** rng.integers(-5, 5, 1_000_000)
    fx, fy = (Column.from_numpy(v, device=dev) for v in (x, y))
    cx, cy = (Column.from_numpy(v, device="cpu") for v in (x, y))
    _same_rows(pe.pmod(fx, fy), pe.pmod(cx, cy), "float pmod")


@pytest.mark.parametrize("n", EDGE_ROWS)
def test_lists_on_the_card_match_cpu(dev, n):
    from spark_rapids_jni_tpu_torch.ops import lists as pl
    from torch_parity import LIST_SCALAR, child_spec, list_spec

    for elem in ("i64", "f64", "str", "d128"):
        (lc, lg), (oc, og) = (_on_both(list_spec(n, n + k, elem), dev)
                              for k in (0, 7))
        calls = {
            "size": lambda c, o: pl.array_size(c),
            "contains": lambda c, o: pl.array_contains(c, LIST_SCALAR[elem]),
            "element_at": lambda c, o: pl.element_at(c, -2),
            "sort": lambda c, o: pl.sort_array(c, ascending=False),
            "position": lambda c, o: pl.array_position(c, LIST_SCALAR[elem]),
            "distinct": lambda c, o: pl.array_distinct(c),
            "slice": lambda c, o: pl.array_slice(c, -3, 2),
            "overlap": lambda c, o: pl.arrays_overlap(c, o),
        }
        if elem in ("i64", "f64"):
            calls.update(
                sum=lambda c, o: pl.array_sum(c),
                min=lambda c, o: pl.array_min(c),
                max=lambda c, o: pl.array_max(c),
                pad=lambda c, o: pl.pad_lists(c, 7),
                unpad=lambda c, o: pl.unpad_lists(pl.pad_lists(c, 7)))
        if elem == "str":
            calls.update(join=lambda c, o: pl.array_join(c, "|", "?"))
        for name, fn in calls.items():
            _same_rows(fn(lg, og), fn(lc, oc), f"{elem} {name}")
        ic, ig = _on_both((3, 0, np.arange(n, dtype=np.int32),
                           null_tail(n, n)), dev)
        for outer in (False, True):
            got = pl.explode(Table([ig, lg]), 1, outer=outer, position=True)
            want = pl.explode(Table([ic, lc]), 1, outer=outer, position=True)
            assert int(got.num_rows) == int(want.num_rows)
            for g, w in zip(got.table.columns, want.table.columns):
                _same_rows(g, w, f"explode {elem}")
        key = (3, 0, np.random.default_rng(n).integers(
            0, max(2, n // 8), n).astype(np.int32), null_tail(n, n + 5))
        (kc, kg), (vc, vg) = _on_both(key, dev), _on_both(
            child_spec(n, n + 6, elem), dev)
        for distinct in (False, True):
            got = pl.groupby_collect(Table([kg, vg]), [0], 1,
                                     distinct=distinct)
            want = pl.groupby_collect(Table([kc, vc]), [0], 1,
                                      distinct=distinct)
            assert int(got.num_groups) == int(want.num_groups)
            for g, w in zip(got.table.columns, want.table.columns):
                _same_rows(g, w, f"collect {elem} {distinct}")
    r = np.random.default_rng(n).integers(1, 8, n)
    (oc, og), (rc, rg) = (_on_both((4, 0, v, None), dev)
                          for v in (np.ones(n, np.int64), r))
    got = pl.sequence(og, rg)
    assert got.data.device.type == "cuda"
    _same_rows(got, pl.sequence(oc, rc), "sequence")


@pytest.mark.parametrize("n", [1, 256, 257, 2049])
def test_window_on_the_card_matches_cpu(dev, n):
    from spark_rapids_jni_tpu_torch.ops.window import Window
    from torch_parity import (
        WINDOW_CALLS,
        WINDOW_ORDER,
        WINDOW_PART,
        window_columns,
    )

    cols = window_columns(n, n)
    wc = Window(table_from_numpy(cols, device="cpu"), [WINDOW_PART],
                [WINDOW_ORDER])
    wg = Window(table_from_numpy(cols, device=dev), [WINDOW_PART],
                [WINDOW_ORDER])
    for name, (fn, args) in WINDOW_CALLS.items():
        got = getattr(wg, fn)(*args)
        assert got.data.device.type == "cuda", name
        # float running and rolling sums bit-equal to the CPU's
        _same_rows(got, getattr(wc, fn)(*args), name)


@pytest.mark.parametrize("n", [1, 257, 2049])
def test_structs_on_the_card_match_cpu(dev, n):
    from spark_rapids_jni_tpu_torch.ops import structs as ps
    from spark_rapids_jni_tpu_torch.ops import table_ops as pops

    rng = np.random.default_rng(n)
    spec = ("struct", n, np.arange(n) % 13 != 0, [
        (26, -2, rng.integers(0, 10**6, n), null_tail(n, n)),
        (23, 0, arrow_strings([f"s{i % 5}" for i in range(n)])[:2], None)])
    sc, sg = _on_both(spec, dev)
    _same_rows(ps.struct_field(sg, 0), ps.struct_field(sc, 0), "field")
    tc, tg = Table([sc]), Table([sg])
    for g, w in zip(ps.unpack_struct(tg, 0).columns,
                    ps.unpack_struct(tc, 0).columns):
        _same_rows(g, w, "unpack")
    _same_rows(pops.concatenate([tg, tg]).column(0),
               pops.concatenate([tc, tc]).column(0), "concatenate")
    for g, w in zip(pops.contiguous_split(tg, [n // 3]),
                    pops.contiguous_split(tc, [n // 3])):
        _same_rows(g.column(0), w.column(0), "split")


def test_struct_parquet_read_on_the_card(dev, tmp_path):
    import chip_smoke_writers as w

    from spark_rapids_jni_tpu_torch.parquet import reader as preader

    n = 5000
    rng = np.random.default_rng(2)
    fields = [w.ParquetColumn(f"f{i}", rng.integers(0, 10**6, n), w.INT64,
                              w.CONV_DECIMAL, scale=2, precision=18,
                              valid=rng.random(n) > 0.05) for i in range(4)]
    path = tmp_path / "s.parquet"
    w.write_parquet(path, [w.ParquetColumn("k", np.arange(n), w.INT64),
                           w.ParquetGroup("s", fields,
                                          np.arange(n) % 13 != 0)],
                    2048, 512)
    got = preader.read_table(str(path), device=dev)
    want = preader.read_table(str(path), device="cpu")
    assert got.column(1).children[0].data.device.type == "cuda"
    for g, c in zip(got.columns, want.columns):
        _same_rows(g, c, "struct read")
    assert want.column(1).to_pylist()[:2] == [
        None, tuple(int(f.values[1]) if f.valid[1] else None
                    for f in fields)]


# ---- memory and out-of-core (runtime/memory.py, pipeline.py, resilience.py)


def _pinned_sources(chunks, dev):
    """Decode thunks of ``chunks`` (CPU tables) as a reader's
    ``chunk_sources()`` gives them for the card: pinned snapshots staged
    to ``dev``."""
    from spark_rapids_jni_tpu_torch.runtime.memory import host_table_chunk

    def snap(c):
        return (c.dtype, c.data.pin_memory(),
                None if c.validity is None else c.validity.pin_memory(),
                None, None)

    return [(lambda ch=ch: host_table_chunk(
        [snap(c) for c in ch.columns], ch.num_rows, dev)) for ch in chunks]


@pytest.mark.parametrize("tier", ["host", "codec_off", "disk"])
def test_spill_round_trip_on_the_card(dev, tier, tmp_path):
    from spark_rapids_jni_tpu_torch.runtime.memory import (
        SpillStore,
        table_nbytes,
    )
    from spark_rapids_jni_tpu_torch.utils import config

    n = 100_000
    rng = np.random.default_rng(5)
    vals = [None if rng.random() < 0.2 else "s" * int(rng.integers(0, 12))
            for _ in range(n)]
    data = rng.integers(0, 50, n).astype(np.int64)
    valid = torch.from_numpy(rng.random(n) > 0.3)
    cpu = Table([Column(t.INT64, torch.from_numpy(data), valid),
                 string_column(vals, device="cpu")])
    if tier == "codec_off":
        config.set_option("compress.spill", False)
    try:
        gpu = Table([Column(c.dtype, c.data.to(dev),
                            None if c.validity is None
                            else c.validity.to(dev),
                            chars=None if c.chars is None
                            else c.chars.to(dev)) for c in cpu.columns])
        nb = table_nbytes(gpu)
        store = SpillStore(nb, spill_dir=str(tmp_path)
                           if tier == "disk" else None)
        h = store.put(gpu)
        del gpu
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated(dev)
        assert store.spill(h) == nb
        torch.cuda.synchronize()
        assert torch.cuda.memory_allocated(dev) <= before - nb
        assert store.state(h) == ("disk" if tier == "disk" else "host")
        back = store.get(h)
        torch.cuda.synchronize()
        assert back.columns[0].data.device.type == "cuda"
        assert Table([Column(c.dtype, c.data.cpu(),
                             None if c.validity is None
                             else c.validity.cpu(),
                             chars=None if c.chars is None
                             else c.chars.cpu())
                      for c in back.columns]).equals(cpu)
        store.close()
    finally:
        config.reset_option("compress.spill")


def test_pipeline_on_the_card_equals_serial(dev):
    from torch_ooc import port_merge, port_partial
    from spark_rapids_jni_tpu_torch.runtime.memory import (
        MemoryLimiter,
        table_nbytes,
    )
    from spark_rapids_jni_tpu_torch.runtime.outofcore import (
        run_chunked_aggregate,
    )

    li = tpch.lineitem_table(400_000, seed=11, device="cpu")
    rows = 100_000
    chunks = [Table([Column(c.dtype, c.data[a:a + rows],
                            None if c.validity is None
                            else c.validity[a:a + rows])
                     for c in li.columns]) for a in range(0, 400_000, rows)]
    budget = max(table_nbytes(c) for c in chunks) * 8
    serial = run_chunked_aggregate(
        iter([Table([Column(c.dtype, c.data.to(dev),
                            None if c.validity is None
                            else c.validity.to(dev)) for c in ch.columns])
              for ch in chunks]),
        port_partial, port_merge, limiter=MemoryLimiter(budget))
    limiter = MemoryLimiter(budget)
    piped = run_chunked_aggregate(_pinned_sources(chunks, dev), port_partial,
                                  port_merge, limiter=limiter,
                                  prefetch_depth=2, pipeline=True)
    torch.cuda.synchronize()
    assert limiter.used == 0 and piped.chunks == 4
    for a, b in zip(piped.table.columns, serial.table.columns):
        assert torch.equal(a.data, b.data)
        assert torch.equal(a.valid_mask(), b.valid_mask())
    assert piped.table.columns[0].data.device.type == "cuda"


def test_card_out_of_memory_is_resource_exhausted(dev):
    from spark_rapids_jni_tpu_torch.runtime import resilience

    total = torch.cuda.get_device_properties(dev).total_memory
    with pytest.raises(torch.OutOfMemoryError) as ei:
        torch.empty(2 * total, dtype=torch.uint8, device=dev)
    assert resilience.classify(ei.value) is resilience.ResourceExhausted
    assert not resilience.is_transient(ei.value)
    torch.cuda.empty_cache()


def test_served_planned_q1_launches_accumulate_once_then_hits(dev):
    from spark_rapids_jni_tpu_torch.runtime import fusion, server

    li = tpch.lineitem_table(20_000, seed=21)
    plan = tpch._q1_planned_plan()
    want = fusion.execute(plan, {"lineitem": li}).table
    with server.QueryServer(budget_bytes=1 << 28, max_inflight=2) as srv:
        kernels.reset_counts()
        first = srv.session("dash").submit(plan, {"lineitem": li})
        got = first.result(timeout=120)
        torch.cuda.synchronize()
        assert kernels.launches(kga.NAME) == 1
        again = srv.session("dash").submit(plan, {"lineitem": li})
        hit = again.result(timeout=120)
        assert kernels.launches(kga.NAME) == 1 and again.queue_wait_s == 0.0
        assert kernels.launches(khp.NAME) == 0
        for table in (got.table, hit.table):
            assert table.equals(want)
    assert srv.limiter.used == 0


def test_server_stages_a_host_chunk_binding_as_directly(dev):
    from spark_rapids_jni_tpu_torch.runtime import fusion, server

    li = tpch.lineitem_table(50_000, seed=22, device="cpu")
    source = _pinned_sources([li], dev)[0]
    direct = source().stage()
    torch.cuda.synchronize()
    plan = fusion.Plan("tpch_q6", fusion.Project(
        fusion.Scan("lineitem"), tpch._q6_reduce, rowwise=False))
    with server.QueryServer(budget_bytes=1 << 28) as srv:
        staged = srv._stage_bindings({"lineitem": source()})["lineitem"]
        assert staged.equals(direct)
        res = srv.session("etl").submit(plan, {"lineitem": source()}).result(
            timeout=120)
        assert res.table.equals(fusion.execute(plan,
                                               {"lineitem": direct}).table)
    assert srv.limiter.used == 0


# ---- the multiple-executor layer (parallel/) ------------------------------


def _mesh_table(n: int, seed: int) -> Table:
    """int64 keys with nulls, int32 values, a STRING column (CPU)."""
    rng = np.random.default_rng(seed)
    words = ["", "a", "executor", "mesh", "SF10"]
    strings = [words[i] for i in rng.integers(0, len(words), n)]
    offsets, chars, svalid = arrow_strings(strings, rng.random(n) > 0.2)
    return table_from_numpy([
        (int(t.TypeId.INT64), 0, rng.integers(0, 53, n).astype(np.int64),
         rng.random(n) > 0.1),
        (int(t.TypeId.INT32), 0, rng.integers(-99, 99, n).astype(np.int32),
         None),
        (int(t.TypeId.STRING), 0, (offsets, chars), svalid),
    ], device="cpu")


def _same_tables_cpu(got: Table, want: Table) -> None:
    from spark_rapids_jni_tpu_torch.parallel.distributed import table_to

    assert table_to(got, "cpu").equals(want)


@pytest.mark.parametrize("n", [1, 257, 2049])
def test_four_executor_shuffle_on_the_card_matches_cpu(dev, n):
    from spark_rapids_jni_tpu_torch.parallel import executor_mesh, hash_shuffle
    from spark_rapids_jni_tpu_torch.parallel import distributed as pdist

    tab = _mesh_table(n, n)
    out = {}
    for where, devices in (("cpu", ["cpu"] * 4), ("card", [dev] * 4)):
        mesh = executor_mesh(4, devices)
        shards, rv = pdist.shard_table(pdist.table_to(tab, devices[0]),
                                       mesh, return_row_valid=True)
        out[where] = hash_shuffle(mesh, shards, [0, 2], row_valid=rv)
    for g, w in zip(out["card"], out["cpu"]):
        _same_tables_cpu(g.table, w.table)
        assert torch.equal(g.row_valid.cpu(), w.row_valid)
        assert bool(g.overflowed) == bool(w.overflowed)


def test_distributed_join_launches_probe_once_per_executor(dev):
    from spark_rapids_jni_tpu_torch.parallel import executor_mesh
    from spark_rapids_jni_tpu_torch.parallel import distributed as pdist

    left, right = _mesh_table(2049, 5), _mesh_table(300, 6)
    out = {}
    for where, devices in (("cpu", ["cpu"] * 4), ("card", [dev] * 4)):
        mesh = executor_mesh(4, devices)
        ls, lrv = pdist.shard_table(pdist.table_to(left, devices[0]), mesh,
                                    return_row_valid=True)
        rs, rrv = pdist.shard_table(pdist.table_to(right, devices[0]), mesh,
                                    return_row_valid=True)
        kernels.reset_counts()
        out[where] = pdist.distributed_join(
            ls, rs, 0, 0, mesh, 4096, how="left", left_row_valid=lrv,
            right_row_valid=rrv)
        torch.cuda.synchronize()
        assert kernels.launches(khp.NAME) == (4 if where == "card" else 0)
    assert not kernels.fallbacks()
    for g, w in zip(out["card"].table, out["cpu"].table):
        _same_tables_cpu(g, w)
    assert [int(x) for x in out["card"].total] == [
        int(x) for x in out["cpu"].total]


def test_one_rank_nccl_collectives_equal_local(dev, tmp_path):
    import datetime

    import torch.distributed as tdist

    from spark_rapids_jni_tpu_torch.parallel import executor_mesh

    tdist.init_process_group(
        "nccl", init_method=f"file://{tmp_path}/pg", rank=0, world_size=1,
        timeout=datetime.timedelta(seconds=60))
    try:
        nccl = executor_mesh(devices=[dev], group=tdist.group.WORLD)
        local = executor_mesh(1, [dev])
        assert nccl.executors == (0,)
        rng = np.random.default_rng(3)
        x = torch.from_numpy(rng.integers(-9, 9, (64, 3))).to(dev)
        mask = torch.from_numpy(rng.random(64) > 0.5).to(dev)
        u = torch.from_numpy(rng.integers(0, 2**63, 16, dtype=np.int64)
                             ).to(dev).view(torch.uint64)
        f = torch.from_numpy(rng.standard_normal(16)).to(dev)
        for a, b in ((nccl.all_to_all([x]), local.all_to_all([x])),
                     (nccl.all_to_all([mask]), local.all_to_all([mask])),
                     (nccl.all_gather([x]), local.all_gather([x])),
                     (nccl.psum([x]), local.psum([x])),
                     (nccl.pmin([x]), local.pmin([x])),
                     (nccl.pmax([u]), local.pmax([u])),
                     (nccl.pmax([f]), local.pmax([f]))):
            assert a[0].dtype == b[0].dtype and torch.equal(a[0], b[0])
    finally:
        tdist.destroy_process_group()


def test_cuda_table_round_trips_the_wire_onto_the_card(dev):
    from spark_rapids_jni_tpu_torch.parallel import dcn

    li = tpch.lineitem_table(30_000, seed=23, device=dev)
    back = dcn.deserialize_table(dcn.serialize_table(li), device=dev)
    assert all(c.data.device.type == "cuda" for c in back.columns)
    assert back.equals(li)
    # the frame of the card's table is the frame of its host copy
    host = tpch.lineitem_table(30_000, seed=23, device="cpu")
    assert dcn.serialize_table(li) == dcn.serialize_table(host)


def test_fleet_on_the_card_serves_planned_q1_bit_identical(dev):
    from spark_rapids_jni_tpu_torch.runtime import fleet, fusion

    li = tpch.lineitem_table(20_000, seed=24)
    plan = tpch._q1_planned_plan()
    want = fusion.execute(plan, {"lineitem": li}).table
    with fleet.QueryFleet(1, device=dev) as f:
        assert f.wait_live(timeout=120) == 1
        r0 = f._find("r0")
        # the worker booted on a CUDA device of its own process
        assert r0.boot_info["device"].startswith("cuda")
        assert r0.boot_info["device_name"] == torch.cuda.get_device_name(0)
        res = f.submit("s0", plan, {"lineitem": li}).result(timeout=120)
        assert res.table.columns[0].data.device.type == "cuda"
        assert res.table.equals(want)
        # the worker counted its own launches of kernel A: one query
        assert f.fresh_loads()["r0"]["launches"] == {kga.NAME: 1}
        assert f.leaked_bytes() == 0


def test_general_float_groupby_sum_varies_only_in_rounding(
        dev, record_property):
    """The general groupby's float64 sums go through the segment-sum
    kernel, whose order the group bounds fix (its first version added
    with ``index_add_``, atomics in an order the card picks: 8 bit
    patterns in 8 runs on the H100). Eight runs: the counts are
    bit-identical, each sum lies within float64's reordering bound of
    the exact sum, and the sums repeat bit for bit: one pattern
    (``distinct_sum_bits``, printed with ``-s``)."""
    import math

    rng = np.random.default_rng(31)
    n = 4_000_000
    keys = rng.integers(0, 4, n).astype(np.int64)
    vals = rng.normal(size=n) * 1e6
    tab = Table([Column.from_numpy(keys, device=dev),
                 Column.from_numpy(vals, device=dev)])
    exact = [math.fsum(vals[keys == k]) for k in range(4)]
    # |sum in any order - exact| <= (m - 1) * eps * sum |x| for m rows
    bound = [(np.count_nonzero(keys == k) - 1) * np.finfo(np.float64).eps
             * float(np.abs(vals[keys == k]).sum()) for k in range(4)]
    bits, counts = set(), set()
    for _ in range(8):
        g = groupby_aggregate(tab, [0], [(1, "sum"), (1, "count")],
                              max_groups=None)
        order = g.table.column(0).data[:4].cpu().numpy()
        assert sorted(order.tolist()) == [0, 1, 2, 3]
        sums = g.table.column(1).data[:4]
        bits.add(sums.view(torch.int64).cpu().numpy().tobytes())
        counts.add(g.table.column(2).data[:4].cpu().numpy().tobytes())
        for k, s in zip(order, sums.cpu().numpy()):
            assert abs(float(s) - exact[k]) <= bound[k]
    assert len(counts) == 1
    record_property("distinct_sum_bits", len(bits))
    print(f"distinct_sum_bits {len(bits)} of 8 runs")
    assert len(bits) == 1


def _sorted_groups(sizes, dev, seed, past=0):
    """Sorted group ids of groups of ``sizes`` rows (0 = an empty group),
    ``past`` more rows in a group past m, and float64 values with
    signed zeros, a NaN group and an inf group: (values, gid, g_lo,
    g_hi)."""
    rng = np.random.default_rng(seed)
    m = len(sizes)
    gid = np.repeat(np.arange(m + 1), list(sizes) + [past])
    vals = rng.standard_normal(gid.shape[0]) * 10.0 ** rng.integers(
        -3, 9, gid.shape[0])
    vals[rng.random(gid.shape[0]) < 0.05] = -0.0
    if m > 3:
        vals[gid == 1] = np.where(vals[gid == 1] > 0, np.inf, 1.0)
        vals[np.flatnonzero(gid == 2)[:1]] = np.nan
    gid_t = torch.from_numpy(gid).to(dev)
    ar = torch.arange(m, device=dev)
    return (torch.from_numpy(vals).to(dev), gid_t,
            torch.searchsorted(gid_t, ar), torch.searchsorted(gid_t, ar,
                                                              right=True))


@pytest.mark.parametrize("case", ["small", "one_large", "mixed", "tail",
                                  "empty_rows", "near_chunk"])
def test_segment_sum_kernel_equals_its_plain_version(dev, case):
    """The segment-sum kernel against ``index_add_``: within 1e-12 of
    sum|x| a group, within (count - 1) * eps * sum|x| of the exact
    (``math.fsum``) sum, NaN and inf where the plain version has them,
    bit for bit the same in a second run and on a grid of one block; one
    launch a call, none for no rows."""
    import math

    from spark_rapids_jni_tpu_torch.ops.kernels import segment_sum as kss

    rng = np.random.default_rng(5)
    c = kss.CHUNK
    sizes = {"small": rng.integers(0, 4, 3000),
             "one_large": [c * 300 + 17],
             "mixed": np.concatenate([rng.integers(0, 3, 500), [0, 5000],
                                      rng.integers(1, 2 * c, 40),
                                      [c, c + 1, 1]]),
             "tail": rng.integers(1, 300, 77),
             "empty_rows": [0, 0, 0],
             # groups just under and just over one and two chunks
             "near_chunk": rng.choice([c - 1, c, c + 1, 2 * c - 1, 2 * c,
                                       2 * c + 1, 1], 300)}[case]
    vals, gid, lo, hi = _sorted_groups(sizes, dev, len(sizes),
                                       past=999 if case == "tail" else 0)
    m = lo.shape[0]
    kernels.reset_counts()
    got = kss._segment_sum_cuda(vals, gid, lo, hi)
    again = kss._segment_sum_cuda(vals, gid, lo, hi)
    one_block = kss._segment_sum_cuda(vals, gid, lo, hi, blocks=1)
    assert kernels.launches(kss.NAME) == (0 if vals.shape[0] == 0 else 3)
    want = kss.segment_sum_plain(vals, gid, m)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int64), again.view(torch.int64))
    assert torch.equal(got.view(torch.int64), one_block.view(torch.int64))
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    fin = torch.isfinite(want)
    assert torch.equal(got[~fin & ~nan], want[~fin & ~nan])
    near = (got - want).abs() <= kss.sum_bound(vals, gid, m)
    assert bool(near[fin].all())
    h_vals, h_gid = vals.cpu().numpy(), gid.cpu().numpy()
    h_got = got.cpu().numpy()
    for g in np.flatnonzero(fin.cpu().numpy())[:400]:
        x = h_vals[h_gid == g]
        tol = max(len(x) - 1, 0) * np.finfo(np.float64).eps * np.abs(x).sum()
        assert abs(h_got[g] - math.fsum(x)) <= tol
    # the empty groups' sums are +0.0, as index_add_ into zeros gives
    empty = (hi == lo).cpu().numpy()
    assert not np.signbit(h_got[empty]).any() and not h_got[empty].any()


def test_bounded_plan_over_supplier_keys_on_the_card(dev):
    """A domain of 100,000 keys (m = 100,001): plan_groupby_auto grows
    from 4,096 to the bounded plan, kernel A takes it in one pass (its
    launches = ``launches(m, L)``), equal to the same call on the CPU
    and to the general plan's groups."""
    from spark_rapids_jni_tpu_torch.ops.groupby import bounded_lanes
    from spark_rapids_jni_tpu_torch.ops.planner import (
        plan_groupby_auto,
        scalar_domain,
    )

    n = 200_000
    rng = np.random.default_rng(41)
    keys = rng.integers(1, 100_001, n).astype(np.int32)
    q = rng.integers(100, 5000, n)
    qv = rng.random(n) > 0.01
    p = rng.integers(90_000, 10_000_000, n)
    aggs = [(1, "sum"), (1, "count"), (2, "sum"), (2, "count"), (1, "min"),
            (1, "max"), (2, "min"), (2, "max")]
    out = {}
    for d in (dev, "cpu"):
        tbl = Table([Column.from_numpy(keys, device=d),
                     Column.from_numpy(q, validity=qv, device=d),
                     Column.from_numpy(p, device=d)])
        kernels.reset_counts()
        res = plan_groupby_auto(tbl, [0], aggs,
                                [scalar_domain(range(1, 100_001))],
                                budget=4096)
        assert res.lowered == "bounded" and kernels.fallbacks() == {}
        out[str(d)] = (res, kernels.launches(kga.NAME))
        if d == dev:
            lanes = bounded_lanes(tbl, aggs).lanes
            assert out[str(d)][1] == kga.launches(100_001, len(lanes)) == 1
    card, cpu = out[str(dev)][0], out["cpu"][0]
    assert torch.equal(card.present.cpu(), cpu.present)
    for a, b in zip(card.table.columns, cpu.table.columns):
        assert torch.equal(a.valid_mask().cpu(), b.valid_mask())
        assert torch.equal(a.data.cpu(), b.data)
