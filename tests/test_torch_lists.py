"""The port's LIST operators (``ops/lists.py``) against the JAX package's
on the same inputs: explode (inner, outer, position), collect_list and
collect_set, the array functions, ``sequence`` and the padded wire
layout, at every row count of ``EDGE_ROWS``, over lists with null rows,
empty rows and null elements of INT64, FLOAT64 (NaN), STRING and
DECIMAL128, and over both list layouts. Results equal row for row under
validity (``canon``: the bytes of every valid value, every list's
elements in order). The array functions are in
``test_torch_list_functions.py``. Two functions differ on purpose
(ROADMAP.md Queue 3): ``array_sum`` of floats sums each list on its
own, held to ``1e-12 * sum(|x|)`` over the reference's cumsum prefix
through the list's end; ``sequence`` sizes its child to its elements
(compared as rows). The reference runs traced (``jref``) where it reads
no host value, eagerly elsewhere."""

from __future__ import annotations

import functools

import numpy as np
import pytest

from spark_rapids_jni_tpu.columnar import Table as JTable
from spark_rapids_jni_tpu.ops import lists as jl
from spark_rapids_jni_tpu_torch import types as tt
from spark_rapids_jni_tpu_torch.columnar import Column, Table
from spark_rapids_jni_tpu_torch.ops import lists as pl
from torch_parity import (
    EDGE_ROWS,
    arrow_strings,
    assert_same_rows,
    assert_same_table_rows,
    both_spec,
    canon,
    child_spec,
    error_of,
    jref,
    list_spec,
    null_tail,
)

I32, I64, STR = 3, 4, 23


# ---- explode -------------------------------------------------------------------

MODES = {"inner": (False, False), "outer": (True, False),
         "pos": (False, True), "posouter": (True, True)}


@functools.lru_cache(maxsize=None)
def _explode_case(n, elem):
    lst = list_spec(n, n, elem)
    ids = (I32, 0, np.arange(n, dtype=np.int32), null_tail(n, n))
    off, chars, _ = arrow_strings([f"r{i}" for i in range(n)])
    tag = (STR, 0, (off, chars), None)
    cols = [both_spec(s) for s in (ids, lst, tag)]
    jt = JTable([j for _, j in cols])
    want = jref(lambda t: {m: jl.explode(t, 1, outer=o, position=p)
                           for m, (o, p) in MODES.items()}, jt)
    return Table([p for p, _ in cols]), want


@pytest.mark.parametrize("n", EDGE_ROWS)
@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("elem", ["i64", "str"])
def test_explode(n, mode, elem):
    pt, wants = _explode_case(n, elem)
    outer, position = MODES[mode]
    got = pl.explode(pt, 1, outer=outer, position=position)
    want = wants[mode]
    assert int(got.num_rows) == int(want.num_rows)
    assert got.row_valid.tolist() == np.asarray(want.row_valid).tolist()
    assert_same_table_rows(got.table, want.table, "explode")


# ---- collect_list / collect_set --------------------------------------------------

@pytest.mark.parametrize("n", EDGE_ROWS)
@pytest.mark.parametrize("distinct", [False, True])
@pytest.mark.parametrize("elem", ["i64", "f64", "str"])
def test_groupby_collect(n, distinct, elem):
    rng = np.random.default_rng(n)
    key = (I32, 0, rng.integers(0, max(2, n // 8), n).astype(np.int32),
           null_tail(n, n + 1))
    val = child_spec(n, n + 2, elem)
    (pk, jk), (pv, jv) = both_spec(key), both_spec(val)
    got = pl.groupby_collect(Table([pk, pv]), [0], 1, distinct=distinct)
    want = jref(lambda t: jl.groupby_collect(t, [0], 1, distinct=distinct),
                JTable([jk, jv]))
    assert int(got.num_groups) == int(want.num_groups)
    assert_same_table_rows(got.table, want.table, "collect")


# ---- the array functions -----------------------------------------------------------

def _both_list(n, elem, seed=0):
    return both_spec(list_spec(n, n + seed, elem))


@pytest.mark.parametrize("n", EDGE_ROWS)
@pytest.mark.parametrize("elem", ["i64", "f64"])
def test_array_sum(n, elem):
    spec = list_spec(n, n + 3, elem)
    if elem == "f64":  # finite values: a NaN case follows
        tid, scale, x, xv = spec[3]
        rng = np.random.default_rng(n)
        x = rng.standard_normal(len(x)) * 10.0 ** rng.integers(-3, 9, len(x))
        spec = spec[:3] + ((tid, scale, x, xv),)
    pc, jc = both_spec(spec)
    got, want = pl.array_sum(pc), jref(jl.array_sum, jc)
    if elem == "i64":
        assert_same_rows(got, want, "array_sum")
        return
    # the reference differences global cumsum prefixes, the port sums
    # each list alone: held to 1e-12 * sum(|x|) through the list's end
    gv, wv = got.validity.numpy(), np.asarray(want.validity)
    assert (gv == wv).all()
    g, w = got.data.numpy()[gv], np.asarray(want.data)[wv]
    _, off, _, (tid, scale, x, xv) = spec
    absx = np.where(xv, np.abs(x), 0.0)
    bound = 1e-12 * np.concatenate([[0.0], np.cumsum(absx)])[off[1:]][gv]
    ok = np.abs(g - w) <= bound
    assert ok.all(), (g[~ok][:3], w[~ok][:3])


def test_array_sum_nan_stays_in_its_list():
    """A NaN element makes its own list's sum NaN. The reference's global
    prefix difference carries it into every later list (ROADMAP.md Queue
    3): rows 3.. below."""
    vals = [[1.0, 2.0], [0.5], [np.nan, 1.0], [4.0], None, [], [2.5, 0.5]]
    p = pl.make_list_column(vals, tt.FLOAT64, device="cpu")
    from spark_rapids_jni_tpu import types as jt

    j = jl.make_list_column(vals, jt.FLOAT64)
    got, want = pl.array_sum(p), jl.array_sum(j)
    assert got.to_pylist()[:2] == [3.0, 0.5]
    assert np.isnan(got.to_pylist()[2])
    assert got.to_pylist()[3:] == [4.0, None, None, 3.0]
    assert np.isnan(np.asarray(want.data)[3])  # the reference's fault


@pytest.mark.parametrize("n", EDGE_ROWS)
def test_sequence(n):
    rng = np.random.default_rng(n)
    a = rng.integers(-20, 20, n)
    step = rng.choice([-3, -1, 1, 2, 5], n)
    b = a + step * rng.integers(0, 9, n)
    eq = rng.random(n) < 0.1
    step[eq], b[eq] = 0, a[eq]  # a zero step with start == stop
    specs = [(I64, 0, a, null_tail(n, n)), (I64, 0, b, None),
             (I64, 0, step, None)]
    (ps_, js_), (pe, je), (pst, jst) = (both_spec(s) for s in specs)
    # the reference's child holds n * max_length slots: keep it small
    got = pl.sequence(ps_, pe, pst, max_length=16)
    assert_same_rows(got, jl.sequence(js_, je, jst, max_length=16),
                     "sequence")
    assert got.children[0].size == int(got.data[-1])  # sized to its rows
    if n == 2049:  # sequence(1, r) over INT32 operands
        pu, ju = both_spec((I32, 0, np.abs(a).astype(np.int32) % 7 + 1,
                            None))
        pone, jone = both_spec((I32, 0, np.ones(n, np.int32), None))
        assert_same_rows(pl.sequence(pone, pu, max_length=8),
                         jl.sequence(jone, ju, max_length=8),
                         "sequence(1, r)")


def test_sequence_errors():
    def cols(a, b):
        return [both_spec((I64, 0, np.array(v, np.int64), None))
                for v in (a, b)]

    (pa_, ja), (pb, jb) = cols([0, 5], [3, 1])
    assert error_of(lambda: pl.sequence(pa_, pb)) == \
        error_of(lambda: jl.sequence(ja, jb)) == "ValueError"
    (pa_, ja), (pb, jb) = cols([0], [2000])
    assert error_of(lambda: pl.sequence(pa_, pb)) == \
        error_of(lambda: jl.sequence(ja, jb)) == "ValueError"
    (pa_, ja), (pb, jb) = cols([1, 2], [1, 3])
    assert error_of(lambda: pl.sequence(pa_, pb, 0)) == \
        error_of(lambda: jl.sequence(ja, jb, 0)) == "ValueError"
    # past int32 offsets: the reference's cast wraps, the port raises
    n = 3000
    big = Column.from_numpy(np.full(n, 10**6, np.int64), device="cpu")
    one = Column.from_numpy(np.ones(n, np.int64), device="cpu")
    with pytest.raises(ValueError, match="int32 offset"):
        pl.sequence(one, big, max_length=10**6)


# ---- the padded wire layout ---------------------------------------------------------

@pytest.mark.parametrize("n", EDGE_ROWS)
@pytest.mark.parametrize("elem", ["i64", "f64"])
def test_pad_unpad_lists(n, elem):
    pc, jc = _both_list(n, elem, 2)
    L = pl.max_list_length(pc)
    assert L == jl.max_list_length(jc)
    pp = pl.pad_lists(pc)
    jp, ju, jw = jref(lambda c: (jl.pad_lists(c, L), jl.unpad_lists(
        jl.pad_lists(c, L)), jl.pad_lists(c, 9)), jc)
    assert pp.is_padded_list and jp.is_padded_list
    assert pl.is_padded_list(pp) and not pl.is_padded_list(pc)
    assert pp.size == jp.size == n
    assert_same_rows(pp, jp, "pad_lists")
    for a, b in ((pp.data, jp.data), (pp.children[0].data,
                                      jp.children[0].data),
                 (pp.children[0].validity, jp.children[0].validity)):
        assert a.numpy().tobytes() == np.asarray(b).tobytes()
    pu = pl.unpad_lists(pp)
    assert_same_rows(pu, ju, "unpad_lists")
    assert_same_rows(pu, jc, "round trip")
    assert pl.unpad_lists(pc) is pc and pl.pad_lists(pp) is pp
    assert pp.equals(pc) and canon(pp) == canon(pc)
    wide = pl.pad_lists(pc, 9)
    assert wide.children[0].data.shape == (n, 9)
    assert_same_rows(wide, jw, "pad_lists(9)")


# ---- make_list_column and errors --------------------------------------------------------------

def test_make_list_column_and_errors():
    vals = [[1, None, 3], None, [], [7]]
    p = pl.make_list_column(vals, tt.INT64, device="cpu")
    from spark_rapids_jni_tpu import types as jt

    j = jl.make_list_column(vals, jt.INT64)
    assert p.to_pylist() == j.to_pylist() == vals
    assert canon(p) == canon(j)
    flat = Column.from_numpy(np.arange(4, dtype=np.int64), device="cpu")
    jflat = both_spec((I64, 0, np.arange(4, dtype=np.int64), None))[1]
    cases = [
        ("array_size", lambda m, c: m.array_size(c)),
        ("element_at", lambda m, c: m.element_at(c, 1)),
        ("sort_array", lambda m, c: m.sort_array(c)),
        ("array_sum", lambda m, c: m.array_sum(c)),
        ("array_min", lambda m, c: m.array_min(c)),
        ("array_slice", lambda m, c: m.array_slice(c, 1, 1)),
        ("pad_lists", lambda m, c: m.pad_lists(c)),
        ("array_join", lambda m, c: m.array_join(c, ",")),
    ]
    for what, fn in cases:
        assert error_of(lambda: fn(pl, flat)) == \
            error_of(lambda: fn(jl, jflat)) == "TypeError", what
    (pc, jc) = _both_list(16, "i64")
    (ps_, js_) = _both_list(16, "str")
    (pd, jd) = _both_list(16, "d128")
    for what, fn in [
            ("element_at 0", lambda m, c, s, d: m.element_at(c, 0)),
            ("slice 0", lambda m, c, s, d: m.array_slice(c, 0, 1)),
            ("slice len", lambda m, c, s, d: m.array_slice(c, 1, -1)),
            ("join ints", lambda m, c, s, d: m.array_join(c, ",")),
            ("sum strings", lambda m, c, s, d: m.array_sum(s)),
            ("min strings", lambda m, c, s, d: m.array_min(s)),
            ("max d128", lambda m, c, s, d: m.array_max(d)),
            ("pad strings", lambda m, c, s, d: m.pad_lists(s)),
            ("pad d128", lambda m, c, s, d: m.pad_lists(d)),
            ("overlap types", lambda m, c, s, d: m.arrays_overlap(c, s)),
            ("explode flat", lambda m, c, s, d: m.explode(
                _table(m, [c.children[0]]), 0)),
            ("collect nested", lambda m, c, s, d: m.groupby_collect(
                _table(m, [c, c]), [0], 1))]:
        got = error_of(lambda: fn(pl, pc, ps_, pd))
        want = error_of(lambda: fn(jl, jc, js_, jd))
        assert got == want and got is not None, (what, got, want)
    (p7, j7) = _both_list(7, "i64")
    assert error_of(lambda: pl.arrays_overlap(pc, p7)) == \
        error_of(lambda: jl.arrays_overlap(jc, j7)) == "ValueError"


def _table(module, cols):
    return (Table if module is pl else JTable)(cols)
