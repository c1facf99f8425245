"""The port's sort against the JAX package: ``sort_order`` permutations for
every fixed-width key type, ascending and descending, nulls either side,
NaN, -0.0/0.0 and +-inf, multi-key sorts and phantom rows
(``row_valid``), and ``sort_table``. Exact."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu import types as jt
from spark_rapids_jni_tpu.ops import sort as jsort
from spark_rapids_jni_tpu_torch.ops import sort
from torch_parity import (
    EDGE_ROWS,
    assert_same_array,
    assert_same_table,
    jax_table,
    to_port,
)

FLOAT_SPECIALS = [np.nan, -np.nan, 0.0, -0.0, np.inf, -np.inf, 1.5, -1.5]


def key_column(type_id, n, rng, nulls=True, scale=0):
    """One host column of ``type_id`` with many ties (and, for floats,
    NaN of both signs, +-0.0 and +-inf), nulls on a random fifth of the
    rows plus a tail."""
    tid = jt.TypeId(type_id)
    if tid == jt.TypeId.DECIMAL128:
        data = rng.integers(-3, 3, (n, 2)).astype(np.int64)
    elif tid in (jt.TypeId.FLOAT32, jt.TypeId.FLOAT64):
        dt = np.float32 if tid == jt.TypeId.FLOAT32 else np.float64
        data = rng.choice(np.asarray(FLOAT_SPECIALS + [2.0, -3.0]), n).astype(dt)
    else:
        np_dt = jt.DType(tid, scale).storage_dtype
        info = np.iinfo(np_dt)
        picks = np.asarray([info.min, info.max, 0, 1, info.min + 1,
                            info.max - 1, 7, 100], dtype=np_dt)
        data = rng.choice(picks, n)
    valid = None
    if nulls:
        valid = rng.random(n) > 0.2
        valid[-max(1, n // 8):] = False
    return (int(tid), scale, data, valid)


KEY_TYPES = [
    (jt.TypeId.INT8, 0), (jt.TypeId.INT16, 0), (jt.TypeId.INT32, 0),
    (jt.TypeId.INT64, 0), (jt.TypeId.UINT8, 0), (jt.TypeId.UINT16, 0),
    (jt.TypeId.UINT32, 0), (jt.TypeId.UINT64, 0), (jt.TypeId.BOOL8, 0),
    (jt.TypeId.TIMESTAMP_DAYS, 0), (jt.TypeId.DECIMAL64, -2),
    (jt.TypeId.DECIMAL128, -3), (jt.TypeId.FLOAT32, 0),
    (jt.TypeId.FLOAT64, 0),
]


def _orders(host, keys, asc, nf, row_valid=None):
    jtab = jax_table(host)
    want = jsort.sort_order(
        jtab, keys, asc, nf,
        row_valid=None if row_valid is None else jnp.asarray(row_valid))
    got = sort.sort_order(
        to_port(jtab), keys, asc, nf,
        row_valid=None if row_valid is None else torch.from_numpy(row_valid))
    return got, want


@pytest.mark.parametrize("type_id,scale", KEY_TYPES,
                         ids=[t.name for t, _ in KEY_TYPES])
def test_key_type_order_matches_reference(type_id, scale):
    # four tie-heavy keys of one type, one per (ascending, nulls_first)
    # pair: each key orders the ties of the keys above it
    rng = np.random.default_rng(int(type_id))
    host = [key_column(type_id, 257, rng, scale=scale) for _ in range(4)]
    got, want = _orders(host, [0, 1, 2, 3], [True, False, True, False],
                        [True, True, False, False])
    assert_same_array(got.numpy(), np.asarray(want).astype(np.int64))
    got, want = _orders(host[:1], [0], [False], [False])
    assert_same_array(got.numpy(), np.asarray(want).astype(np.int64))


@pytest.mark.parametrize("n", EDGE_ROWS)
def test_multi_key_with_phantoms_matches_reference(n):
    rng = np.random.default_rng(n)
    host = [key_column(jt.TypeId.INT8, n, rng),
            key_column(jt.TypeId.FLOAT64, n, rng),
            key_column(jt.TypeId.DECIMAL64, n, rng, scale=-2),
            key_column(jt.TypeId.FLOAT32, n, rng, nulls=False)]
    row_valid = rng.random(n) > 0.1
    got, want = _orders(host, [0, 1, 3, 2], [True, False, True, False],
                        [False, True, True, False], row_valid)
    # the real rows come first, in the same order; the reference's
    # phantom tail can hold its own bucket-padding rows (indices >= n),
    # so only its real prefix is compared
    real = int(row_valid.sum())
    assert_same_array(got.numpy()[:real],
                      np.asarray(want).astype(np.int64)[:real])
    assert sorted(got.numpy()[real:].tolist()) \
        == np.flatnonzero(~row_valid).tolist()


def test_float_order_is_spark_order():
    # NaN greatest, float64 ties -0.0 with 0.0, float32 orders them
    vals = np.asarray([np.nan, 0.0, -0.0, -np.inf, np.inf, -np.nan, 1.0])
    for tid, dt in ((jt.TypeId.FLOAT64, np.float64),
                    (jt.TypeId.FLOAT32, np.float32)):
        host = [(int(tid), 0, vals.astype(dt), None)]
        got, want = _orders(host, [0], [True], [True])
        assert_same_array(got.numpy(), np.asarray(want).astype(np.int64))
    assert sort.sort_order(to_port(jax_table(
        [(int(jt.TypeId.FLOAT64), 0, vals, None)])), [0]).tolist() \
        == [3, 1, 2, 6, 4, 0, 5]


@pytest.mark.parametrize("n", [257, 2049])
def test_sort_table_matches_reference(n):
    rng = np.random.default_rng(n + 7)
    host = [key_column(t, n, rng, scale=s) for t, s in KEY_TYPES]
    jtab = jax_table(host)
    keys = [5, 3, 13]
    assert_same_table(sort.sort_table(to_port(jtab), keys, [False, True, True]),
                      jsort.sort_table(jtab, keys, [False, True, True]))


def test_empty_table_and_no_keys():
    host = [key_column(jt.TypeId.INT32, 0, np.random.default_rng(0))]
    got = sort.sort_order(to_port(jax_table(host)), [0])
    assert got.dtype == torch.int64 and got.numel() == 0
    port = to_port(jax_table([key_column(jt.TypeId.INT32, 5,
                                         np.random.default_rng(1))]))
    assert sort.sort_order(port, []).tolist() == [0, 1, 2, 3, 4]
