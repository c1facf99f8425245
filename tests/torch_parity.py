"""Helpers that hold the PyTorch port against the JAX package: tables
cross between the two as numpy arrays (``interop``), and results compare
byte for byte."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from spark_rapids_jni_tpu import types as jt
from spark_rapids_jni_tpu.columnar import Column as JColumn, Table as JTable
from spark_rapids_jni_tpu_torch.interop import table_from_numpy, table_to_numpy

EDGE_ROWS = [1, 255, 256, 257, 2047, 2048, 2049]


def host_columns(jtable: JTable) -> list:
    """A JAX table as ``[(type_id, scale, data, validity), ...]``."""
    return [
        (int(c.dtype.type_id), int(c.dtype.scale), np.asarray(c.data),
         None if c.validity is None else np.asarray(c.validity))
        for c in jtable.columns
    ]


def to_port(jtable: JTable, device="cpu"):
    return table_from_numpy(host_columns(jtable), device=device)


def jax_table(columns) -> JTable:
    """``[(type_id, scale, data, validity), ...]`` -> JAX table."""
    return JTable([
        JColumn(jt.DType(jt.TypeId(tid), scale), jnp.asarray(data),
                None if valid is None else jnp.asarray(valid))
        for tid, scale, data, valid in columns
    ])


def assert_same_array(got, want, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype, f"{what}: dtype {got.dtype} != {want.dtype}"
    assert got.shape == want.shape, f"{what}: shape {got.shape} != {want.shape}"
    assert got.tobytes() == want.tobytes(), f"{what}: bytes differ"


def assert_same_table(port_table, jtable: JTable) -> None:
    """Bit-identical: types, every data byte (under nulls too) and the
    validity tri-state."""
    got = table_to_numpy(port_table)
    want = host_columns(jtable)
    assert len(got) == len(want), "column count"
    for i, (g, w) in enumerate(zip(got, want)):
        assert g[:2] == w[:2], f"column {i}: type {g[:2]} != {w[:2]}"
        assert_same_array(g[2], w[2], f"column {i} data")
        assert (g[3] is None) == (w[3] is None), f"column {i}: tri-state"
        if g[3] is not None:
            assert_same_array(g[3], w[3], f"column {i} validity")


def random_host_columns(n: int, seed: int) -> list:
    """Every fixed-width family the slice ports, with null tails on every
    other column: int8/16/32/64, float32/64, TIMESTAMP_DAYS, DECIMAL64,
    DECIMAL128."""
    rng = np.random.default_rng(seed)

    def tail():
        valid = rng.random(n) > 0.2
        valid[-max(1, n // 4):] = False
        return valid

    specs = [
        (jt.TypeId.INT8, 0, rng.integers(-128, 128, n).astype(np.int8)),
        (jt.TypeId.INT16, 0, rng.integers(-2**15, 2**15, n).astype(np.int16)),
        (jt.TypeId.INT32, 0, rng.integers(-2**31, 2**31, n).astype(np.int32)),
        (jt.TypeId.INT64, 0, rng.integers(-2**63, 2**63 - 1, n,
                                          dtype=np.int64)),
        (jt.TypeId.FLOAT32, 0, rng.standard_normal(n).astype(np.float32)),
        (jt.TypeId.FLOAT64, 0, rng.standard_normal(n) * 1e10),
        (jt.TypeId.TIMESTAMP_DAYS, 0,
         rng.integers(-30000, 30000, n).astype(np.int32)),
        (jt.TypeId.DECIMAL64, -2, rng.integers(-10**15, 10**15, n)),
        (jt.TypeId.DECIMAL128, -3,
         rng.integers(-2**63, 2**63 - 1, (n, 2), dtype=np.int64)),
    ]
    return [(int(tid), scale, data, tail() if i % 2 else None)
            for i, (tid, scale, data) in enumerate(specs)]
