"""The port's array functions (``ops/lists.py``: size, contains,
element_at, sort_array, array_position, array_distinct, array_slice,
array_min/max, arrays_overlap, array_join) against the JAX package's on
the same lists: every function at every row count of ``EDGE_ROWS`` over
INT64 and STRING elements, the FLOAT64 (NaN) and DECIMAL128 element
paths at 1, 257 and 2049 rows; null rows, empty rows and null elements
throughout. Equal row for row under validity (``canon``). The reference
runs traced (``jref``) except where it reads the host (array_min/max,
array_join)."""

from __future__ import annotations

import pytest

from spark_rapids_jni_tpu.ops import lists as jl
from spark_rapids_jni_tpu_torch.ops import lists as pl
from torch_parity import (
    EDGE_ROWS,
    LIST_SCALAR,
    assert_same_rows,
    both_spec,
    jref,
    list_spec,
)

SCALAR = LIST_SCALAR


def _both_list(n, elem, seed=0):
    return both_spec(list_spec(n, n + seed, elem))


CASES = {
    "array_size": lambda m, c, e: m.array_size(c),
    "array_contains": lambda m, c, e: m.array_contains(c, SCALAR[e]),
    "element_at_1": lambda m, c, e: m.element_at(c, 1),
    "element_at_3": lambda m, c, e: m.element_at(c, 3),
    "element_at_-1": lambda m, c, e: m.element_at(c, -1),
    "element_at_-4": lambda m, c, e: m.element_at(c, -4),
    "sort_array": lambda m, c, e: m.sort_array(c),
    "sort_array_desc": lambda m, c, e: m.sort_array(c, ascending=False),
    "array_position": lambda m, c, e: m.array_position(c, SCALAR[e]),
    "array_distinct": lambda m, c, e: m.array_distinct(c),
    "slice_1_2": lambda m, c, e: m.array_slice(c, 1, 2),
    "slice_2_9": lambda m, c, e: m.array_slice(c, 2, 9),
    "slice_-2_1": lambda m, c, e: m.array_slice(c, -2, 1),
    "slice_-9_3": lambda m, c, e: m.array_slice(c, -9, 3),
    "slice_4_0": lambda m, c, e: m.array_slice(c, 4, 0),
}
NUMERIC = {"array_min": lambda m, c, e: m.array_min(c),
           "array_max": lambda m, c, e: m.array_max(c)}


# every function at every row count over INT64 and STRING elements; the
# FLOAT64 and DECIMAL128 element paths at three of them
ELEM_ROWS = [(n, e) for n in EDGE_ROWS for e in ("i64", "str")] + [
    (n, e) for n in (1, 257, 2049) for e in ("f64", "d128")]


@pytest.mark.parametrize("n,elem", ELEM_ROWS)
def test_array_functions(n, elem):
    pc, jc = _both_list(n, elem)
    wants = jref(lambda c: {k: fn(jl, c, elem) for k, fn in CASES.items()},
                 jc)
    for name, fn in CASES.items():
        assert_same_rows(fn(pl, pc, elem), wants[name], name)
    if elem in ("i64", "f64"):
        # these read the longest list on the host: the reference eager
        for name, fn in NUMERIC.items():
            assert_same_rows(fn(pl, pc, elem), fn(jl, jc, elem), name)


@pytest.mark.parametrize("n,elem", ELEM_ROWS)
def test_arrays_overlap(n, elem):
    pa_, ja = _both_list(n, elem, 0)
    pb, jb = _both_list(n, elem, 11)
    assert_same_rows(pl.arrays_overlap(pa_, pb),
                     jref(jl.arrays_overlap, ja, jb), "arrays_overlap")


@pytest.mark.parametrize("n", EDGE_ROWS)
@pytest.mark.parametrize("rep", [None, "NULL"])
def test_array_join(n, rep):
    pc, jc = _both_list(n, "str", 5)
    got = pl.array_join(pc, ", ", rep)
    want = jl.array_join(jc, ", ", rep)
    assert got.to_pylist() == want.to_pylist()
    assert_same_rows(got, want, "array_join")


