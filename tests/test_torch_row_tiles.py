"""The tile plan of the row kernel's wide path (rows past 1,536 bytes),
on the CPU: a pure function of the row layout, so its promises hold here
without the card.

For the layouts of the schemas the row tests use, the plan's segments
cover every byte of the row once; each column and each validity byte lies
in one segment; every data segment starts on 16 bytes; and each block's
staged columns, staged bools, packed validity bytes and descriptors fit,
apart, in its shared memory, within the budget that lets four blocks
share a SM.
"""

from __future__ import annotations

import numpy as np
import pytest

from spark_rapids_jni_tpu_torch import types as t
from spark_rapids_jni_tpu_torch.ops.kernels import row_transpose as krt
from spark_rapids_jni_tpu_torch.ops.row_conversion import (
    compute_fixed_width_layout,
)

# ``_wide_table``'s cycle in tests/test_torch_cuda.py: every fixed width,
# with an alignment gap before each wider column
_CYCLE = [t.INT8, t.INT64, t.INT16, t.FLOAT64, t.INT32, t.decimal128(-3),
          t.UINT8]

LAYOUTS = {
    "7 mixed": [_CYCLE[i % 7] for i in range(7)],
    "200 INT64": [t.INT64] * 200,
    "1401 mixed": [_CYCLE[i % 7] for i in range(1401)],
    "8000 mixed": [_CYCLE[i % 7] for i in range(8000)],
    "8000 INT64": [t.INT64] * 8000,
    "33000 mixed": [_CYCLE[i % 7] for i in range(33_000)],
}


def _plan(name):
    starts, sizes, row_size = compute_fixed_width_layout(LAYOUTS[name])
    return starts, sizes, row_size, krt.tile_plan(starts, sizes, row_size)


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_tile_plan_covers_the_row_once(name):
    starts, sizes, row_size, plan = _plan(name)
    ncols = len(starts)
    vld_base = starts[-1] + sizes[-1]
    nvb = (ncols + 7) // 8
    seen = np.zeros(row_size, dtype=np.int64)
    col_seg = np.full(ncols, -1)
    vb_seg = np.full(nvb, -1)
    st = np.asarray(starts)
    end = st + np.asarray(sizes)
    for k, s in enumerate(plan.segments):
        assert s.begin % 8 == 0 and s.end % 8 == 0 and s.begin < s.end
        seen[s.begin:s.end] += 1
        if len(s.vbytes) == 0:  # a data segment
            assert s.begin % 16 == 0 and s.end <= vld_base
        # the columns listed are exactly those inside its bytes
        inside = np.flatnonzero((st >= s.begin) & (st < s.end))
        assert list(s.cols) == inside.tolist()
        assert (end[inside] <= s.end).all()
        assert (col_seg[inside] == -1).all()
        col_seg[inside] = k
        vb = np.arange(nvb)
        inside_vb = vb[(vld_base + vb >= s.begin) & (vld_base + vb < s.end)]
        assert list(s.vbytes) == inside_vb.tolist()
        assert (vb_seg[inside_vb] == -1).all()
        vb_seg[inside_vb] = k
    assert (seen == 1).all()
    assert (col_seg >= 0).all() and (vb_seg >= 0).all()
    assert [s.begin for s in plan.segments] == sorted(
        s.begin for s in plan.segments)


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_tile_plan_fits_each_block_in_its_shared_memory(name):
    """Each segment's staged fields (16-byte aligned, at the bank of
    their 16-byte block of the row), staged bools, packed validity bytes
    and descriptors lie apart inside its shared memory, at most
    ``TILE_SMEM`` bytes: four blocks a SM."""
    starts, sizes, row_size, plan = _plan(name)
    ncols, rows = len(starts), plan.rows
    assert plan.smem == max(s.smem for s in plan.segments) <= krt.TILE_SMEM
    assert 4 * (krt.TILE_SMEM + 1024) <= 228 * 1024  # the SM's 228 KB
    for s in plan.segments:
        spans = []
        for c in s.cols:
            off = plan.data_off[c]
            assert off % 16 == 0
            assert off % 128 == 16 * (starts[c] // 16 % 8)
            spans.append((off, off + rows * sizes[c]))
        vcols = range(8 * s.vbytes.start, min(8 * s.vbytes.stop, ncols))
        for c in vcols:
            off = plan.valid_off[c]
            assert off % 16 == 0
            spans.append((off, off + rows))
        if len(s.vbytes):
            spans.append((s.packed_off, s.packed_off + rows
                          * krt.packed_stride(len(s.vbytes))))
        assert s.info_off % 16 == 0
        spans.append((s.info_off, s.info_off + 32 * len(s.cols)
                      + 16 * len(vcols) + 4 * (s.end - s.begin) // 8))
        spans.sort()
        assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
        assert spans[-1][1] == s.smem


@pytest.mark.parametrize("name,want", [("200 INT64", 3), ("8000 INT64", 59)])
def test_tile_plan_at_the_wide_rows_of_the_card_phase(name, want):
    """1,632- and 65,000-byte rows (chip_smoke phase 22): data segments
    of one width but the last, the validity bytes apart, the grid tiles x
    segments."""
    starts, sizes, row_size, plan = _plan(name)
    assert len(plan.segments) == want and plan.rows == krt.TILE_ROWS
    data = [s for s in plan.segments if not len(s.vbytes)]
    assert len({s.end - s.begin for s in data[:-1]}) == 1
    assert plan.grid(2_000_000) == -(-2_000_000 // plan.rows) * want


def test_descriptors_hold_the_plan():
    """The int32 descriptors the kernel reads: a TileCol (pointers 0,
    start, size, staging offsets) a column, then a Segment a segment."""
    starts, sizes, row_size, plan = _plan("1401 mixed")
    d = krt.descriptors(plan, starts, sizes)
    ncols = len(starts)
    assert d.dtype == np.int32 and d.shape == (8 * (ncols + len(
        plan.segments)),)
    cols = d[:8 * ncols].reshape(ncols, 8)
    assert not cols[:, :4].any()
    assert cols[:, 4].tolist() == starts and cols[:, 5].tolist() == sizes
    assert cols[:, 6].tolist() == list(plan.data_off)
    assert cols[:, 7].tolist() == list(plan.valid_off)
    segs = d[8 * ncols:].reshape(-1, 8)
    assert segs.tolist() == [
        [s.begin // 8, s.end // 8, s.cols.start, s.cols.stop,
         s.vbytes.start, s.vbytes.stop, s.packed_off, s.info_off]
        for s in plan.segments]
