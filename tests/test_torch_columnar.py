"""The port's columnar substrate against the JAX package: types, Column /
Table, bit packing, byte casts and the interop round trip. Exact."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu import types as jt
from spark_rapids_jni_tpu.columnar import Column as JColumn
from spark_rapids_jni_tpu.columnar.bitmask import (
    pack_bits_last_axis as j_pack_bits,
)
from spark_rapids_jni_tpu.ops.bytecast import (
    from_bytes as j_from_bytes,
    to_bytes as j_to_bytes,
)
from spark_rapids_jni_tpu_torch import types as tt
from spark_rapids_jni_tpu_torch.columnar import Column, Table
from spark_rapids_jni_tpu_torch.columnar.bitmask import pack_bits_last_axis
from spark_rapids_jni_tpu_torch.interop import table_from_numpy, table_to_numpy
from spark_rapids_jni_tpu_torch.ops.bytecast import from_bytes, to_bytes
from torch_parity import (
    EDGE_ROWS,
    assert_same_array,
    assert_same_table,
    jax_table,
    random_host_columns,
)

# ---------------------------------------------------------------------------
# types
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tid", list(jt.TypeId))
def test_dtype_properties_match_reference(tid):
    assert tt.TypeId(int(tid)).name == tid.name
    scale = -2 if tid in (jt.TypeId.DECIMAL32, jt.TypeId.DECIMAL64,
                          jt.TypeId.DECIMAL128) else 0
    j, p = jt.DType(tid, scale), tt.DType(tt.TypeId(int(tid)), scale)
    assert (p.is_fixed_width, p.is_decimal, p.is_string, p.is_decimal128) == \
        (j.is_fixed_width, j.is_decimal, j.is_string, j.is_decimal128)
    assert repr(p) == repr(j)
    try:
        want = j.storage_dtype
    except TypeError:
        with pytest.raises(TypeError):
            p.storage_dtype
        return
    assert p.storage_dtype == want
    assert p.size_bytes == j.size_bytes
    assert p.torch_dtype == torch.from_numpy(np.zeros(1, want)).dtype


def test_dtype_constructors_and_errors():
    assert tt.decimal64(-2) == tt.DType(tt.TypeId.DECIMAL64, -2)
    assert tt.decimal128(-3).size_bytes == jt.decimal128(-3).size_bytes == 16
    assert tt.decimal128(-3).torch_dtype == torch.int64
    with pytest.raises(ValueError):
        tt.DType(tt.TypeId.INT32, -1)
    for np_dt in (np.int8, np.uint16, np.float32, np.bool_):
        assert int(tt.DType.from_numpy(np_dt).type_id) == \
            int(jt.DType.from_numpy(np_dt).type_id)
    with pytest.raises(TypeError):
        tt.DType.from_numpy(np.complex64)


# ---------------------------------------------------------------------------
# Column / Table
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", EDGE_ROWS)
def test_columns_match_reference(n):
    host = random_host_columns(n, seed=n)
    jtab = jax_table(host)
    ptab = table_from_numpy(host, device="cpu")
    assert ptab.num_rows == jtab.num_rows == n
    assert [int(d.type_id) for d in ptab.schema()] == \
        [int(d.type_id) for d in jtab.schema()]
    for p, j in zip(ptab.columns, jtab.columns):
        assert p.null_count == j.null_count
        assert p.has_nulls == j.has_nulls
        assert_same_array(p.valid_mask().numpy(), np.asarray(j.valid_mask()))
        assert p.to_pylist() == j.to_pylist()
    assert ptab.equals(table_from_numpy(table_to_numpy(ptab), device="cpu"))


def test_column_validation_and_equality():
    with pytest.raises(TypeError):
        Column(tt.INT32, torch.zeros(3, dtype=torch.int64))
    with pytest.raises(TypeError):
        Column(tt.INT32, torch.zeros(3, dtype=torch.int32),
               torch.ones(3, dtype=torch.uint8))
    with pytest.raises(TypeError):
        Column(tt.decimal128(0), torch.zeros(3, dtype=torch.int64))
    with pytest.raises(ValueError):  # a STRUCT column needs its fields
        Column(tt.DType(tt.TypeId.STRUCT), torch.zeros(3, dtype=torch.uint8))
    with pytest.raises(ValueError):  # of the struct's row count
        Column(tt.DType(tt.TypeId.STRUCT), torch.zeros(3, dtype=torch.uint8),
               children=[Column.from_numpy(np.zeros(2, np.int32),
                                           device="cpu")])
    with pytest.raises(NotImplementedError):  # no column layout
        Column(tt.DType(tt.TypeId.DICTIONARY32),
               torch.zeros(3, dtype=torch.int32))
    with pytest.raises(ValueError):  # a LIST column needs its one child
        Column(tt.DType(tt.TypeId.LIST), torch.zeros(3, dtype=torch.int32))
    with pytest.raises(ValueError):  # a STRING column needs its chars
        Column(tt.DType(tt.TypeId.STRING), torch.zeros(3, dtype=torch.int32))
    with pytest.raises(ValueError):
        Table([Column.from_numpy(np.zeros(3, np.int32), device="cpu"),
               Column.from_numpy(np.zeros(4, np.int32), device="cpu")])
    a = Column.from_pylist([1, None, 3], tt.INT32, device="cpu")
    b = Column.from_pylist([1, None, 3], tt.INT32, device="cpu")
    b.data[1] = 99  # null slots hold unspecified values
    assert a.equals(b)
    assert not a.equals(Column.from_pylist([1, 2, 3], tt.INT32,
                                           device="cpu"))
    nan = Column.from_numpy(np.array([np.nan, 1.0]), device="cpu")
    assert nan.equals(nan)


def test_from_pylist_matches_reference():
    big = [2**100 + 7, None, -(2**90), 0, -1]
    for vals, pdt, jdt in [
        (big, tt.decimal128(-2), jt.decimal128(-2)),
        ([True, None, False], tt.BOOL8, jt.BOOL8),
        ([1, None, -5, 127], tt.INT8, jt.INT8),
    ]:
        p = Column.from_pylist(vals, pdt, device="cpu")
        j = JColumn.from_pylist(vals, jdt)
        assert p.to_pylist() == j.to_pylist() == [
            (bool(v) if pdt == tt.BOOL8 and v is not None else v)
            for v in vals]
        assert_same_array(p.data.numpy(), np.asarray(j.data))


# ---------------------------------------------------------------------------
# bit packing and byte casts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k", [1, 7, 8, 9, 16, 17])
def test_pack_bits_last_axis_matches_reference(k):
    bits = np.random.default_rng(k).random((257, k)) > 0.5
    got = pack_bits_last_axis(torch.from_numpy(bits)).numpy()
    assert_same_array(got, j_pack_bits(jnp.asarray(bits)))


@pytest.mark.parametrize("n", EDGE_ROWS)
def test_bytecast_matches_reference(n):
    for tid, scale, data, _ in random_host_columns(n, seed=n + 1):
        pdt = tt.DType(tt.TypeId(tid), scale)
        jdt = jt.DType(jt.TypeId(tid), scale)
        got = to_bytes(torch.from_numpy(data), pdt)
        want = j_to_bytes(jnp.asarray(data), jdt)
        assert_same_array(got.numpy(), want, pdt)
        back = from_bytes(got, pdt)
        assert_same_array(back.numpy(), j_from_bytes(want, jdt), pdt)
        assert_same_array(back.numpy(), data, pdt)


def test_decimal128_byte_image_is_little_endian_int128():
    v = -(2**100) + 12345
    col = Column.from_pylist([v], tt.decimal128(0), device="cpu")
    raw = bytes(to_bytes(col.data, col.dtype).numpy()[0])
    assert int.from_bytes(raw, "little", signed=True) == v


# ---------------------------------------------------------------------------
# interop
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [0, 1, 257, 2049])
def test_interop_round_trip(n):
    host = random_host_columns(n, seed=3 + n)
    ptab = table_from_numpy(host, device="cpu")
    assert_same_table(ptab, jax_table(host))
    again = table_to_numpy(ptab)
    for (tid, scale, data, valid), (t2, s2, d2, v2) in zip(host, again):
        assert (tid, scale) == (t2, s2)
        assert_same_array(d2, data)
        assert (valid is None) == (v2 is None)
        if valid is not None:
            assert_same_array(v2, valid)
