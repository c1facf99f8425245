"""The port's row conversion against the JAX package: the row image
bytes, the way back, the layout and size errors, the batch split, and the
plain row-transpose kernel against the reference Pallas kernel in
interpret mode. Exact."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu import types as jt
from spark_rapids_jni_tpu.columnar.bitmask import pack_bits_last_axis as j_pack
from spark_rapids_jni_tpu.models import tpch as jtpch
from spark_rapids_jni_tpu.ops import row_conversion as jrc
from spark_rapids_jni_tpu.ops.bytecast import to_bytes as j_to_bytes
from spark_rapids_jni_tpu.ops.pallas import row_transpose as jrt
from spark_rapids_jni_tpu_torch.models import tpch
from spark_rapids_jni_tpu_torch.ops import kernels
from spark_rapids_jni_tpu_torch.ops import row_conversion as rc
from spark_rapids_jni_tpu_torch.ops.kernels import row_transpose as krt
from torch_parity import (
    EDGE_ROWS,
    assert_same_array,
    assert_same_table,
    jax_table,
    random_host_columns,
    to_port,
)


def _batches(batches):
    return [(b.num_rows, b.row_size, np.asarray(b.data).tobytes())
            for b in batches]


def _port_batches(batches):
    return [(b.num_rows, b.row_size, b.data.numpy().tobytes())
            for b in batches]


def _mixed(n):
    # every fixed-width family, with bool8 and uint16 added, null tails
    host = random_host_columns(n, seed=n)
    rng = np.random.default_rng(n + 100)
    valid = np.ones(n, bool)
    valid[-max(1, n // 3):] = False
    host.append((int(jt.TypeId.BOOL8), 0,
                 (rng.random(n) > 0.5).astype(np.uint8), valid))
    host.append((int(jt.TypeId.UINT16), 0,
                 rng.integers(0, 2**16, n).astype(np.uint16), None))
    return jax_table(host)


@pytest.mark.parametrize("n", EDGE_ROWS)
def test_to_rows_and_back_match_reference_mixed(n):
    jtab = _mixed(n)
    ptab = to_port(jtab)
    got = rc.convert_to_rows(ptab)
    want = jrc.convert_to_rows(jtab)
    assert _port_batches(got) == _batches(want)
    schema = ptab.schema()
    back = rc.convert_from_rows(got[0], schema)
    assert_same_table(back, jrc.convert_from_rows(want[0], jtab.schema()))
    assert back.equals(ptab)


@pytest.mark.parametrize("n", EDGE_ROWS)
def test_to_rows_and_back_match_reference_lineitem(n):
    jtab = jtpch.lineitem_table(n, seed=n)
    ptab = tpch.lineitem_table(n, seed=n, device="cpu")
    got = rc.convert_to_rows(ptab)
    want = jrc.convert_to_rows(jtab)
    assert _port_batches(got) == _batches(want)
    assert got[0].row_size == 48
    back = rc.convert_from_rows(got[0], tpch.LINEITEM_SCHEMA)
    assert_same_table(back, jrc.convert_from_rows(want[0], jtab.schema()))


def test_layout_matches_reference():
    for n_cols in (1, 7, 8, 9, 17):
        host = (random_host_columns(4, seed=n_cols) * 2)[:n_cols]
        schema = to_port(jax_table(host)).schema()
        jschema = jax_table(host).schema()
        assert rc.compute_fixed_width_layout(schema) == \
            jrc.compute_fixed_width_layout(jschema)


def test_layout_length_error():
    ptab = tpch.lineitem_table(64, device="cpu")
    batch = rc.convert_to_rows(ptab)[0]
    short = rc.RowsColumn(batch.num_rows - 1, batch.row_size, batch.data)
    with pytest.raises(ValueError, match="layout of the data"):
        rc.convert_from_rows(short, tpch.LINEITEM_SCHEMA)
    with pytest.raises(ValueError, match="layout of the data"):
        rc.convert_from_rows(batch, tpch.LINEITEM_SCHEMA[:-1])
    jbatch = jrc.convert_to_rows(jtpch.lineitem_table(64))[0]
    with pytest.raises(ValueError, match="layout of the data"):
        jrc.convert_from_rows(
            jrc.RowsColumn(jbatch.num_rows - 1, jbatch.row_size, jbatch.data),
            jtpch.LINEITEM_SCHEMA)


def test_row_size_limit_and_wide_rows():
    # 200 int64 columns: 1600 + 25 validity bytes -> 1632-byte rows
    rng = np.random.default_rng(5)
    host = [(int(jt.TypeId.INT64), 0, rng.integers(-9, 9, 40), None)
            for _ in range(200)]
    jtab, ptab = jax_table(host), to_port(jax_table(host))
    for convert, tab in ((rc.convert_to_rows, ptab),
                         (jrc.convert_to_rows, jtab)):
        with pytest.raises(ValueError, match="too large"):
            convert(tab)
    kernels.reset_counts()
    got = rc.convert_to_rows(ptab, enforce_row_limit=False)
    # the kernel takes rows of any width: nothing falls back
    assert kernels.fallbacks() == {}
    assert _port_batches(got) == _batches(
        jrc.convert_to_rows(jtab, enforce_row_limit=False))


def test_empty_table_falls_back_and_matches():
    jtab = jtpch.lineitem_table(0)
    kernels.reset_counts()
    got = rc.convert_to_rows(tpch.lineitem_table(0, device="cpu"))
    # an empty input is no fallback: the transpose takes n == 0
    assert kernels.launches() == {} and kernels.fallbacks() == {}
    assert _port_batches(got) == _batches(jrc.convert_to_rows(jtab))


@pytest.mark.parametrize("n", [257, 1000])
def test_batch_split_at_32_row_multiples(monkeypatch, n):
    # 48-byte rows under a 48*100-byte cap: (100 // 32) * 32 = 96 rows
    monkeypatch.setattr(rc, "INT32_MAX", 48 * 100)
    monkeypatch.setattr(jrc, "INT32_MAX", 48 * 100)
    got = rc.convert_to_rows(tpch.lineitem_table(n, device="cpu"))
    want = jrc.convert_to_rows(jtpch.lineitem_table(n))
    expect = [96] * (n // 96) + ([n % 96] if n % 96 else [])
    assert [b.num_rows for b in got] == expect
    assert _port_batches(got) == _batches(want)
    assert all(b.num_rows % 32 == 0 for b in got[:-1])


def test_plain_kernel_matches_pallas_interpret():
    n = 257
    jtab = _mixed(n)
    ptab = to_port(jtab)
    schema = ptab.schema()
    starts, sizes, spr = rc.compute_fixed_width_layout(schema)
    pieces = [j_to_bytes(c.data, c.dtype) for c in jtab.columns]
    pieces.append(j_pack(jnp.stack([c.valid_mask() for c in jtab.columns],
                                   axis=1)))
    want = jrt.assemble_rows(pieces, starts + [starts[-1] + sizes[-1]], spr,
                             interpret=True)
    got = krt.assemble_rows_plain([c.data for c in ptab.columns],
                                  [c.validity for c in ptab.columns],
                                  schema, starts, spr)
    assert_same_array(got.numpy(), want)


def test_cpu_wrapper_takes_plain_path():
    kernels.reset_counts()
    ptab = tpch.lineitem_table(100, device="cpu")
    rows = rc.convert_to_rows(ptab)
    assert kernels.launches() == {} and kernels.fallbacks() == {}
    assert rows[0].data.device == torch.device("cpu")
    assert rows[0].offsets[-1] == rows[0].size_bytes == 100 * 48
