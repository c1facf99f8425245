"""The port's table operations against the JAX package: concatenate
(fixed-width, DECIMAL128, both STRING layouts, LIST<STRING>),
apply_boolean_mask and distinct (padded outputs with a null tail),
contiguous_split, except_rows and intersect_rows, at the reference's
edge row counts with null tails. Every result matches exactly: the row
order, the validity and every data byte (a padded tail too), or, for a
LIST column, every row's list."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu import types as jt
from spark_rapids_jni_tpu.columnar import Table as JTable
from spark_rapids_jni_tpu.ops import strings_fns as jfn
from spark_rapids_jni_tpu.ops import table_ops as jops
from spark_rapids_jni_tpu.ops.strings import pad_strings as jpad
from spark_rapids_jni_tpu_torch.columnar import Table
from spark_rapids_jni_tpu_torch.ops import strings_fns as pfn
from spark_rapids_jni_tpu_torch.ops import table_ops as ops
from spark_rapids_jni_tpu_torch.ops.strings import pad_strings
from torch_parity import (
    EDGE_ROWS,
    arrow_strings,
    assert_same_array,
    assert_same_table,
    both_strings,
    jax_table,
    random_host_columns,
    to_port,
    traced_reference,
)

T = jt.TypeId
WORDS = ["", "a", "bb", "a b", "zeta", "é"]


def host_table(n: int, seed: int, distinct_keys: int = 4) -> list:
    """Every fixed-width family (``random_host_columns``) after two
    low-cardinality keys (INT32 with a null tail, STRING) so that
    duplicates occur."""
    rng = np.random.default_rng(seed)
    kvalid = rng.random(n) > 0.1
    kvalid[-max(1, n // 8):] = False
    words = [WORDS[i] for i in rng.integers(0, len(WORDS), n)]
    svalid = rng.random(n) > 0.1
    keys = [(int(T.INT32), 0,
             rng.integers(0, distinct_keys, n).astype(np.int32), kvalid),
            (int(T.STRING), 0, arrow_strings(words)[:2], svalid)]
    return keys + random_host_columns(n, seed)


def _split(host, at):
    """The host columns cut at row ``at``: two tables' worth."""
    def cut(data, lo, hi):
        if isinstance(data, tuple):  # Arrow offsets + chars
            offs, chars = data
            return (offs[lo:hi + 1] - offs[lo], chars[offs[lo]:offs[hi]])
        return data[lo:hi]

    def part(lo, hi):
        return [(tid, s, cut(d, lo, hi), None if v is None else v[lo:hi])
                for tid, s, d, v in host]

    n = len(host[0][2])
    return part(0, at), part(at, n)


@pytest.mark.parametrize("n", EDGE_ROWS)
def test_concatenate_matches_reference(n):
    host = host_table(n, n)
    a, b = _split(host, n // 3)
    ja, jb = jax_table(a), jax_table(b)
    got = ops.concatenate([to_port(ja), to_port(jb)])
    assert_same_table(got, jops.concatenate([ja, jb]))
    # concatenating the two halves gives the whole table back
    assert_same_table(got, jax_table(host))
    # a padded STRING beside an Arrow one: both widened to the widest
    pa = Table([pad_strings(to_port(ja).column(1))])
    want = jops.concatenate([JTable([jpad(ja.column(1))]),
                             JTable([jb.column(1)])])
    assert_same_table(ops.concatenate([pa, Table([to_port(jb).column(1)])]),
                      want)


def test_concatenate_lists_and_type_mismatch():
    rows = ["a b  c", None, "", "x", "p q r s t"]
    cols = [both_strings(rows[:3]), both_strings(rows[3:])]
    ports = [pfn.split(p, " ", 3).column for p, _ in cols]
    refs = [jfn.split(r, " ", 3).column for _, r in cols]
    got = ops.concatenate([Table([c]) for c in ports]).column(0)
    want = jops.concatenate([JTable([c]) for c in refs]).column(0)
    assert got.to_pylist() == want.to_pylist()
    assert got.data.tolist() == np.asarray(want.data).tolist()
    host = host_table(10, 1)
    with pytest.raises(TypeError):
        ops.concatenate([to_port(jax_table(host[2:3])),
                         to_port(jax_table(host[3:4]))])


@pytest.mark.parametrize("n", EDGE_ROWS)
def test_apply_boolean_mask_and_distinct_match_reference(n):
    host = host_table(n, n + 1)
    jtab = jax_table(host)
    mask = np.random.default_rng(n).random(n) > 0.4
    want = traced_reference(jops.apply_boolean_mask, jtab, jnp.asarray(mask))
    got = ops.apply_boolean_mask(to_port(jtab), torch.from_numpy(mask))
    assert int(got.num_rows) == int(want.num_rows) == int(mask.sum())
    assert_same_table(got.table, want.table)
    for keys in ([0], [0, 1], None):
        want = traced_reference(lambda tb: jops.distinct(tb, keys), jtab)
        got = ops.distinct(to_port(jtab), keys)
        assert int(got.num_rows) == int(want.num_rows)
        assert_same_table(got.table, want.table)
        assert got.compact().num_rows == int(want.num_rows)


def test_contiguous_split_matches_reference():
    n = 2049
    host = host_table(n, 3)
    jtab = jax_table(host)
    splits = [0, 1, 255, 256, 256, 1000, 2048, 2049]
    got = ops.contiguous_split(to_port(jtab), splits)
    want = jops.contiguous_split(jtab, splits)
    assert len(got) == len(want) == len(splits) + 1
    for g, w in zip(got, want):
        assert_same_table(g, w)
    with pytest.raises(ValueError):
        ops.contiguous_split(to_port(jtab), [5, 3])


@pytest.mark.parametrize("n", [1, 256, 2049])
def test_set_ops_match_reference(n):
    # overlapping key tuples (nulls included) on two columns
    left = host_table(n, n, distinct_keys=6)[:2]
    right = host_table(max(1, n // 2), n + 7, distinct_keys=9)[:2]
    jl, jr = jax_table(left), jax_table(right)
    for name in ("except_rows", "intersect_rows"):
        want = getattr(jops, name)(jl, jr)
        got = getattr(ops, name)(to_port(jl), to_port(jr))
        assert int(got.num_rows) == int(want.num_rows), name
        assert_same_table(got.table, want.table)
    with pytest.raises(TypeError):
        ops.except_rows(to_port(jl), to_port(jax_table(left[1:] + left[:1])))


def test_compact_result_trims():
    host = host_table(300, 5)
    res = ops.apply_boolean_mask(to_port(jax_table(host)),
                                 torch.arange(300) % 3 == 0)
    out = res.compact()
    assert out.num_rows == 100
    assert_same_array(out.column(0).data.numpy(),
                      host[0][2][::3])
