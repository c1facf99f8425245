"""The port's CUDA kernels against their plain PyTorch versions, on the
card, at the reference's edge row counts.

A CUDA kernel has no CPU mode, so every test here needs a CUDA device and
skips without one. This file imports no JAX, so it also runs where JAX is
absent:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu_torch import types as t
from spark_rapids_jni_tpu_torch.columnar import Column, Table
from spark_rapids_jni_tpu_torch.models import tpch
from spark_rapids_jni_tpu_torch.ops import kernels
from spark_rapids_jni_tpu_torch.ops.groupby import groupby_aggregate_bounded
from spark_rapids_jni_tpu_torch.ops.kernels import (
    groupby_accumulate as kga,
    q1 as kq1,
    row_transpose as krt,
)
from spark_rapids_jni_tpu_torch.ops.row_conversion import (
    compute_fixed_width_layout,
    convert_from_rows,
    convert_to_rows,
)

pytestmark = pytest.mark.cuda

EDGE_ROWS = [1, 255, 256, 257, 2047, 2048, 2049]


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


@pytest.mark.parametrize("n", EDGE_ROWS)
def test_q1_kernel_matches_plain(dev, n):
    li = tpch.lineitem_table(n, seed=n, device=dev)
    cols = [li.column(i).data.clone() for i in kq1._COLUMNS]
    cols[4][::7] = ord("X")  # returnflag outside its domain: slot 7
    got = kq1._q1_partials_cuda(*cols)
    want = kq1.q1_partials_plain(*cols)
    assert torch.equal(got, want)


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
    # a CUDA table never runs the plain version: rows wider than the
    # kernel's cap are counted under their reason, then refused
    n = 300
    rng = np.random.default_rng(0)
    tbl = Table([
        Column.from_numpy(rng.integers(0, 100, n).astype(np.int64),
                          device=dev)
        for _ in range(200)  # 200 x 8 + 25 validity bytes > 1536
    ])
    kernels.reset_counts()
    with pytest.raises(NotImplementedError, match="row_too_wide"):
        convert_to_rows(tbl, enforce_row_limit=False)
    assert kernels.fallbacks() == {(krt.NAME, "row_too_wide"): 1}
    assert kernels.launches(krt.NAME) == 0


def test_ineligible_groupby_raises(dev):
    n = 500
    rng = np.random.default_rng(1)
    tbl = Table([
        Column.from_numpy(rng.integers(1, 3, n).astype(np.int8), device=dev),
        Column.from_numpy(rng.standard_normal(n), device=dev),
    ])
    for op, reason in (("sum", "float_agg"), ("max", "minmax_width")):
        kernels.reset_counts()
        with pytest.raises(NotImplementedError, match=reason):
            groupby_aggregate_bounded(tbl, [0], [(1, op)], [(1, 2)])
        assert kernels.fallbacks() == {(kga.NAME, reason): 1}
        assert kernels.launches() == {}


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
