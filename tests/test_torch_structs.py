"""The port's STRUCT column and ``ops/structs.py`` against the JAX
package: building, field access and ``col.*`` star-expansion, then the
table operations (slice, concatenate, contiguous_split) and the general
groupby over the unpacked fields, at every row count of ``EDGE_ROWS``
with null tails in the fields and in the struct. Equal row for row under
validity (``canon``: bytes of every valid value)."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu.columnar import Table as JTable
from spark_rapids_jni_tpu.ops import structs as js
from spark_rapids_jni_tpu.ops import table_ops as jops
from spark_rapids_jni_tpu.ops.groupby import _groupby_aggregate_impl
from spark_rapids_jni_tpu_torch import types as tt
from spark_rapids_jni_tpu_torch.columnar import Column, Table
from spark_rapids_jni_tpu_torch.ops import structs as ps
from spark_rapids_jni_tpu_torch.ops import table_ops as pops
from spark_rapids_jni_tpu_torch.ops.groupby import groupby_aggregate
from torch_parity import (
    EDGE_ROWS,
    arrow_strings,
    assert_same_groups,
    assert_same_rows,
    assert_same_table_rows,
    both_spec,
    error_of,
    null_tail,
    traced_reference,
)


def struct_spec(n: int, seed: int, nested: bool = True):
    """A STRUCT of (INT64, STRING, DECIMAL128[, STRUCT(FLOAT64, INT8)])
    with null tails in the fields and every 13th struct null."""
    rng = np.random.default_rng(seed)
    words = ["", "x", "yy", "zzz", "wwww"]
    off, chars, _ = arrow_strings([words[i] for i in
                                   rng.integers(0, len(words), n)])
    fields = [
        (4, 0, rng.integers(-10**12, 10**12, n), null_tail(n, seed)),
        (23, 0, (off, chars), null_tail(n, seed + 1)),
        (27, -3, rng.integers(-2**62, 2**62, (n, 2), dtype=np.int64), None),
    ]
    if nested:
        inner = [(10, 0, rng.standard_normal(n), null_tail(n, seed + 2)),
                 (1, 0, rng.integers(-128, 128, n).astype(np.int8), None)]
        fields.append(("struct", n, rng.random(n) > 0.1, inner))
    return ("struct", n, np.arange(n) % 13 != 5, fields)


@pytest.mark.parametrize("n", EDGE_ROWS)
def test_make_struct_and_fields(n):
    spec = struct_spec(n, n)
    pcol, jcol = both_spec(spec)
    fields = [both_spec(f) for f in spec[3]]
    pm = ps.make_struct_column([p for p, _ in fields],
                               torch.from_numpy(spec[2]))
    jm = js.make_struct_column([j for _, j in fields], jcol.validity)
    assert_same_rows(pm, jm, "make_struct_column")
    assert_same_rows(pm, jcol, "spec")
    assert pm.size == jm.size == n
    assert pm.null_count == jm.null_count
    assert pm.to_pylist() == jm.to_pylist()
    assert pm.equals(pcol)
    for i in range(len(fields)):
        assert_same_rows(ps.struct_field(pcol, i), js.struct_field(jcol, i),
                         f"field {i}")
    # no struct validity: the field comes back as it is
    bare = ps.make_struct_column([p for p, _ in fields])
    assert ps.struct_field(bare, 0) is fields[0][0]


@pytest.mark.parametrize("n", EDGE_ROWS)
def test_unpack_struct(n):
    spec = struct_spec(n, n + 1)
    pcol, jcol = both_spec(spec)
    pk, jk = both_spec((3, 0, np.arange(n, dtype=np.int32), None))
    got = ps.unpack_struct(Table([pk, pcol, pk]), 1)
    want = js.unpack_struct(JTable([jk, jcol, jk]), 1)
    assert_same_table_rows(got, want, "unpack_struct")
    # one level a call: the nested struct unpacks on a second call
    got2 = ps.unpack_struct(got, 4)
    want2 = js.unpack_struct(want, 4)
    assert_same_table_rows(got2, want2, "unpack nested")


@pytest.mark.parametrize("n", EDGE_ROWS)
def test_table_ops_with_struct(n):
    specs = [struct_spec(n, n + 2), (4, 0, np.arange(n, dtype=np.int64),
                                     null_tail(n, n))]
    p1 = Table([both_spec(s)[0] for s in specs])
    j1 = JTable([both_spec(s)[1] for s in specs])
    specs2 = [struct_spec(n // 2 + 1, n + 3),
              (4, 0, np.arange(n // 2 + 1, dtype=np.int64), None)]
    p2 = Table([both_spec(s)[0] for s in specs2])
    j2 = JTable([both_spec(s)[1] for s in specs2])
    assert_same_table_rows(pops.concatenate([p1, p2, p1]),
                           jops.concatenate([j1, j2, j1]), "concatenate")
    splits = [n // 3, n // 2]
    got = pops.contiguous_split(p1, splits)
    want = jops.contiguous_split(j1, splits)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert_same_table_rows(g, w, "contiguous_split")
    assert_same_table_rows(pops.trim_table(p1, n // 2),
                           jops.trim_table(j1, n // 2), "trim")


@pytest.mark.parametrize("n", [1, 256, 2049])
def test_groupby_over_unpacked_fields(n):
    rng = np.random.default_rng(n)
    key = (1, 0, rng.integers(0, 3, n).astype(np.int8), null_tail(n, 9))
    qty = (26, -2, rng.integers(0, 5000, n), null_tail(n, 10))
    price = (26, -2, rng.integers(0, 10**7, n), None)
    spec = ("struct", n, np.arange(n) % 13 != 0, [qty, price])
    pk, jk = both_spec(key)
    pc, jc = both_spec(spec)
    pt = ps.unpack_struct(Table([pk, pc]), 1)
    jt = js.unpack_struct(JTable([jk, jc]), 1)
    aggs = [(1, "sum"), (1, "count"), (2, "min"), (2, "max"), (2, "sum")]
    got = groupby_aggregate(pt, [0], aggs)
    want = traced_reference(lambda t: _groupby_aggregate_impl(
        ((t, None),), None, None, keys=(0,), aggs=tuple(aggs),
        max_groups=n), jt)
    assert_same_groups(got, want)


def test_struct_validation_and_equality():
    a = Column.from_numpy(np.arange(4, dtype=np.int32), device="cpu")
    b = Column.from_numpy(np.arange(5, dtype=np.int32), device="cpu")
    st = tt.DType(tt.TypeId.STRUCT)
    with pytest.raises(ValueError):  # a STRUCT needs fields
        Column(st, torch.zeros(4, dtype=torch.uint8))
    with pytest.raises(ValueError):  # of its row count
        Column(st, torch.zeros(4, dtype=torch.uint8), children=[a, b])
    assert error_of(lambda: ps.make_struct_column([a, b])) == "ValueError"
    assert error_of(lambda: ps.make_struct_column([])) == "ValueError"
    assert error_of(lambda: ps.struct_field(a, 0)) == "TypeError"
    assert error_of(lambda: ps.unpack_struct(Table([a]), 0)) == "TypeError"
    s1 = ps.make_struct_column([a], torch.tensor([True, False, True, True]))
    a2 = a.data.clone()
    a2[1] = 99  # under the null struct: not compared
    s2 = ps.make_struct_column([Column(a.dtype, a2)], s1.validity)
    assert s1.equals(s2) and s1.to_pylist() == [(0,), None, (2,), (3,)]
    a2[2] = 99
    assert not s1.equals(ps.make_struct_column([Column(a.dtype, a2)],
                                               s1.validity))
