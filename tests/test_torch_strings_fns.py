"""The port's string functions (``ops/strings_fns.py``) and its LIST
column against the JAX package: every function on the reference's rows
(ASCII, multi-byte UTF-8, a NUL, nulls) in both string layouts, the same
columns at the reference's edge row counts with null tails, split's
LIST<STRING> under its offsets (the ``limit > 0`` rest-of-row rule, the
``max_pieces`` overflow, multi-byte separators), the same refusals, and
each host branch recorded. The reference runs eagerly, once per case."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu.ops import strings as jstr
from spark_rapids_jni_tpu.ops import strings_fns as jf
from spark_rapids_jni_tpu_torch import telemetry
from spark_rapids_jni_tpu_torch import types as t
from spark_rapids_jni_tpu_torch.columnar import Column
from spark_rapids_jni_tpu_torch.columnar.column import string_column
from spark_rapids_jni_tpu_torch.ops import strings
from spark_rapids_jni_tpu_torch.ops import strings_fns as f
from torch_parity import (
    EDGE_ROWS,
    assert_same_array,
    assert_same_column,
    assert_same_head,
    both_fixed,
    both_strings,
    log_lines,
    null_tail,
)

MIX = ["hello", "", "  padded  ", "a", None, "日本語", "naïve", "aXbXc",
       " x ", "tail   ", "   lead", "ab", "a,b,,c", "aabaab", "x\x00y",
       "héllo wörld", "foo\tbar baz", ",lead", "trail,", "aaa"]
OTHER = ["1", None, "x", "", "zz"] * 4

CASES = {
    "length": lambda m, c: m.length(c),
    "trim": lambda m, c: m.trim(c),
    "ltrim_charset": lambda m, c: m.ltrim(c, " ah"),
    "rtrim": lambda m, c: m.rtrim(c),
    "trim_empty_charset": lambda m, c: m.trim(c, ""),
    "lpad": lambda m, c: m.lpad(c, 6, "*"),
    "rpad_multi": lambda m, c: m.rpad(c, 7, "ab"),
    "lpad_non_ascii_pad": lambda m, c: m.lpad(c, 4, "é"),
    "rpad_empty_pad": lambda m, c: m.rpad(c, 4, ""),
    "lpad_zero": lambda m, c: m.lpad(c, 0),
    "rpad_negative": lambda m, c: m.rpad(c, -1, "x"),
    "instr": lambda m, c: m.instr(c, "l"),
    "instr_multi": lambda m, c: m.instr(c, "ab"),
    "instr_utf8": lambda m, c: m.instr(c, "本"),
    "instr_empty": lambda m, c: m.instr(c, ""),
    "instr_long": lambda m, c: m.instr(c, "x" * 40),
    "repeat": lambda m, c: m.repeat(c, 3),
    "repeat_zero": lambda m, c: m.repeat(c, 0),
    "reverse": lambda m, c: m.reverse(c),
    "translate_delete": lambda m, c: m.translate(c, "bc", "1"),
    "translate_swap": lambda m, c: m.translate(c, "abb", "ba"),
    "translate_utf8": lambda m, c: m.translate(c, "é", "e"),
    "initcap": lambda m, c: m.initcap(c),
    "concat_self": lambda m, c: m.concat(c, c),
}
SPLITS = [(",", -1, 8), (",", 2, None), ("aa", -1, 6), (",", -1, 2),
          (" ", 0, 3), ("ab", 3, None), (",", 1, None), ("xyz", -1, 1)]


def _layouts(values, valid=None):
    """The same column Arrow-laid and padded to its longest row (the
    width the reference pads to), with the reference's copy."""
    pc, jc = both_strings(values, valid)
    return (pc, strings.pad_strings(pc)), jc


def _same(got, want):
    assert_same_column(got, want)


def assert_same_list(got, want, n=None, width=None):
    """Two LIST<STRING> columns (the first n rows of ``want``): the same
    offsets and validity, and the same child rows under the offsets (the
    reference keeps dead pieces past them)."""
    wo = np.asarray(want.data)[:None if n is None else n + 1]
    assert_same_array(got.data.numpy(), wo, "offsets")
    wv = None if want.validity is None else np.asarray(want.validity)[:len(wo) - 1]
    if got.validity is None:
        assert wv is None or wv.all()
    else:
        assert_same_array(got.validity.numpy(), wv, "validity")
    total = int(wo[-1])
    gc, wc = got.children[0], want.children[0]
    assert gc.validity is None and wc.validity is None
    assert int(gc.chars.shape[1]) == (width or int(wc.chars.shape[1]))
    assert_same_array(gc.data.numpy()[:total], np.asarray(wc.data)[:total],
                      "child lengths")
    assert_same_array(gc.chars.numpy()[:total],
                      np.asarray(wc.chars)[:total, :gc.chars.shape[1]],
                      "child chars")


@pytest.fixture(autouse=True)
def _reset():
    telemetry.reset()


@pytest.mark.parametrize("case", sorted(CASES))
def test_function_matches_reference(case):
    fn = CASES[case]
    cols, jc = _layouts(MIX)
    want = fn(jf, jc)
    for col in cols:
        _same(fn(f, col), want)


def test_concat_and_concat_ws_match_reference():
    """concat: null when either side is; concat_ws: nulls skipped,
    never null, empty strings kept; an empty separator."""
    (a, ap), ja = _layouts(MIX)
    (b, bp), jb = _layouts(OTHER)
    _same(f.concat(a, b), jf.concat(ja, jb))
    _same(f.concat(ap, b), jf.concat(ja, jb))
    for sep in ("-", "", "<>"):
        want = jf.concat_ws(sep, [ja, jb, ja])
        _same(f.concat_ws(sep, [a, b, ap]), want)
        _same(f.concat_ws(sep, [ap, bp, a]), want)
    all_valid = both_strings(["q", "r"] * 10)
    _same(f.concat(all_valid[0], all_valid[0]),
          jf.concat(all_valid[1], all_valid[1]))


@pytest.mark.parametrize("sep,limit,max_pieces", SPLITS)
def test_split_matches_reference(sep, limit, max_pieces):
    cols, jc = _layouts(MIX)
    want = jf.split(jc, sep, limit, max_pieces)
    for col in cols:
        got = f.split(col, sep, limit, max_pieces)
        assert_same_list(got.column, want.column)
        assert bool(got.overflowed) == bool(want.overflowed)
        assert got.column.to_pylist() == want.column.to_pylist()


def test_split_limit_keeps_rest_and_cap_overflows():
    """limit > 0: the last piece keeps the rest of the row; max_pieces:
    excess pieces dropped and the overflow flag set."""
    col = string_column(["a,b,c,d", "x", None], device="cpu")
    assert f.split(col, ",", limit=2).column.to_pylist() == [
        ["a", "b,c,d"], ["x"], None]
    res = f.split(col, ",", max_pieces=3)
    assert bool(res.overflowed)
    assert res.column.to_pylist() == [["a", "b", "c"], ["x"], None]
    assert not bool(f.split(col, ",", max_pieces=4).overflowed)
    assert f.split(string_column(["aaa", "aabaab"], device="cpu"), "aa",
                   max_pieces=6).column.to_pylist() == [["", "a"],
                                                        ["", "b", "b"]]


def test_split_overflow_counts_null_rows_as_reference():
    """The reference counts a null row's delimiters into ``overflowed``
    (a reference fault, filed in ROADMAP.md Queue 3); the port gives the
    same flag."""
    pc, jc = both_strings(["a,b,c", "x"], np.array([False, True]))
    want = jf.split(jc, ",", max_pieces=2)
    got = f.split(pc, ",", max_pieces=2)
    assert bool(want.overflowed) and bool(got.overflowed)
    assert got.column.to_pylist() == want.column.to_pylist() == [None, ["x"]]
    assert_same_list(got.column, want.column)


@pytest.mark.parametrize("fn,exc", [
    (lambda m, c: m.split(c, ""), ValueError),
    (lambda m, c: m.split(c, ","), ValueError),
    (lambda m, c: m.split(c, ",", max_pieces=0), ValueError),
    (lambda m, c: m.concat_ws("-", []), ValueError),
    (lambda m, c: m.trim(c, "é"), NotImplementedError),
], ids=["empty_sep", "no_budget", "zero_budget", "no_operands",
        "non_ascii_charset"])
def test_refusals_alike(fn, exc):
    (col, _), jc = _layouts(["a,b"])
    with pytest.raises(exc) as want:
        fn(jf, jc)
    with pytest.raises(exc) as got:
        fn(f, col)
    assert str(got.value) == str(want.value)


def test_non_string_input_is_refused():
    pc, jc = both_fixed(np.ones(2, np.int64), t.TypeId.INT64)
    with pytest.raises(TypeError, match="STRING") as want:
        jf.length(jc)
    with pytest.raises(TypeError) as got:
        f.length(pc)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("fn,op", [
    (lambda c: f.lpad(c, 5, "-"), "string_lpad"),
    (lambda c: f.rpad(c, 5, "-"), "string_rpad"),
    (lambda c: f.translate(c, "l", "L"), "string_translate"),
    (lambda c: f.initcap(c), "string_initcap"),
])
def test_host_branches_are_recorded(fn, op):
    """Non-ASCII rows take the host branch, recorded with the rows;
    ASCII rows stay on the device, recording nothing."""
    fn(string_column(["ascii", None, "bb"], device="cpu"))
    assert telemetry.fallbacks() == {}
    fn(string_column(["héllo", None, "bb"], device="cpu"))
    ((got_op, reason), v), = telemetry.fallbacks().items()
    assert got_op == op and reason and v == {"calls": 1, "rows": 3}


EDGE_WIDTH = 80  # slack past the widest log line
EDGE_CASES = {
    "length": lambda m, c: m.length(c),
    "trim": lambda m, c: m.trim(c, " GT"),
    "lpad": lambda m, c: m.lpad(c, 80, "*"),
    "rpad": lambda m, c: m.rpad(c, 20, "+-"),
    "reverse": lambda m, c: m.reverse(c),
    "instr": lambda m, c: m.instr(c, "status"),
    "translate": lambda m, c: m.translate(c, "0123456789", "abcdefghij"),
    "initcap": lambda m, c: m.initcap(c),
    "repeat": lambda m, c: m.repeat(c, 2),
}


@pytest.fixture(scope="module")
def edge_reference():
    """Each function of the reference once, at the largest edge count
    over log lines with a null tail padded to a fixed width; rows are
    independent, so its first n rows are its result at n rows."""
    n = max(EDGE_ROWS)
    _, jc = both_strings(log_lines(n, 31), null_tail(n, 31))
    jc = jstr.pad_strings(jc, width=EDGE_WIDTH)
    out = {name: fn(jf, jc) for name, fn in EDGE_CASES.items()}
    _, jo = both_strings(log_lines(n, 32))
    out["concat_ws"] = jf.concat_ws("|", [jstr.pad_strings(
        jo, width=EDGE_WIDTH), jc])
    out["split"] = jf.split(jc, " ", max_pieces=5)
    return out


def _out_width(name, w):
    """The padded width of a result over a W-wide input."""
    return {"lpad": 80, "rpad": 20, "repeat": 2 * w}.get(name, w)


@pytest.mark.parametrize("n", EDGE_ROWS)
def test_edge_rows_match_reference(edge_reference, monkeypatch, n):
    """Log lines with a null tail, Arrow-laid and padded with slack, in
    blocks of 100 rows; every result on the device (no host branch)."""
    monkeypatch.setattr(strings, "ROW_CHUNK_CELLS", 100 * EDGE_WIDTH)
    big = max(EDGE_ROWS)
    values, valid = log_lines(big, 31)[:n], null_tail(big, 31)[:n]
    other = log_lines(big, 32)[:n]
    pc = both_strings(values, valid)[0]
    po = both_strings(other)[0]
    widest = max(len(v) for v in values)
    for col, o, w in ((pc, po, widest),
                      (strings.pad_strings(pc, width=EDGE_WIDTH),
                       strings.pad_strings(po, width=EDGE_WIDTH), EDGE_WIDTH)):
        for name, fn in EDGE_CASES.items():
            got = fn(f, col)
            width = None if got.chars is None else _out_width(name, w)
            if width is not None:
                assert int(got.chars.shape[1]) == width, name
            assert_same_head(got, edge_reference[name], n, width=width)
        got = f.concat_ws("|", [o, col])
        w_o = max(len(v) for v in other) if o is po else EDGE_WIDTH
        assert int(got.chars.shape[1]) == w_o + w + 1
        assert_same_head(got, edge_reference["concat_ws"], n,
                         width=w_o + w + 1)
        res = f.split(col, " ", max_pieces=5)
        assert not bool(res.overflowed)
        assert_same_list(res.column, edge_reference["split"].column, n, w)
    assert telemetry.fallbacks() == {}


def test_list_column_substrate():
    child = string_column(["a", "b", "", "c"], device="cpu")
    offsets = torch.tensor([0, 2, 2, 3, 4], dtype=torch.int32)
    valid = torch.tensor([True, False, True, True])
    col = Column(t.LIST, offsets, valid, children=[child])
    assert col.size == 4 and col.null_count == 1
    assert col.valid_mask().tolist() == [True, False, True, True]
    assert col.to_pylist() == [["a", "b"], None, [""], ["c"]]
    # equal under validity: a null row's span and dead child rows differ
    other = Column(t.LIST, torch.tensor([0, 2, 3, 4, 5], dtype=torch.int32),
                   valid, children=[string_column(
                       ["a", "b", "zz", "", "c", "dead"], device="cpu")])
    assert col.equals(other) and other.equals(col)
    changed = Column(t.LIST, other.data, valid, children=[string_column(
        ["a", "b", "zz", "", "d", "dead"], device="cpu")])
    assert not col.equals(changed)
    assert not col.equals(Column(t.LIST, offsets, None, children=[child]))
    with pytest.raises(ValueError, match="one child"):
        Column(t.LIST, offsets, None)
    with pytest.raises(TypeError, match="int32"):
        Column(t.LIST, offsets.to(torch.int64), None, children=[child])
    with pytest.raises(ValueError, match="children"):
        Column(t.STRING, offsets, None, chars=torch.zeros(4, dtype=torch.uint8),
               children=[child])
