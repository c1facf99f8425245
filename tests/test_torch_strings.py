"""The port's STRING substrate against the JAX package: both layouts and
the conversions between them (the padded width equal to the
reference's), the row gather, sort keys, the string sort, the
string-key groupby, ``trim_table``, joins carrying string payload and
joins on string keys, the search predicates and SQL ``like`` (UTF-8
characters, escapes, NUL bytes, invalid UTF-8), the planner's string
domains, and ``ops/reduce.py``. Inputs come from a seed through numpy,
at the reference's edge row counts with null tails.

Exact everywhere (types, validity, every byte, under nulls too), with
two stated exceptions: results the reference computes over its
bucket-padded dispatch compare under validity, and float64 ``sum_`` and
``mean`` compare to a relative 1e-12, since the summation order
differs. The reference's layout functions, string-key groupby and
joins run traced into one XLA program (``traced_reference``), which
compiles each once per shape; their results are bytes and integers, so
the trace changes none."""

from __future__ import annotations

from functools import partial

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu import types as jt
from spark_rapids_jni_tpu.columnar import Column as JColumn, Table as JTable
from spark_rapids_jni_tpu.ops import groupby as jgroupby
from spark_rapids_jni_tpu.ops import join as jjoin
from spark_rapids_jni_tpu.ops import planner as jplanner
from spark_rapids_jni_tpu.ops import reduce as jreduce
from spark_rapids_jni_tpu.ops import sort as jsort
from spark_rapids_jni_tpu.ops import strings as jstr
from spark_rapids_jni_tpu.ops import table_ops as jtable_ops
from spark_rapids_jni_tpu_torch import types as t
from spark_rapids_jni_tpu_torch.columnar import Table
from spark_rapids_jni_tpu_torch.columnar.column import Column, string_column
from spark_rapids_jni_tpu_torch.interop import table_from_numpy, table_to_numpy
from spark_rapids_jni_tpu_torch.ops import (
    groupby,
    join,
    planner,
    reduce,
    sort,
    strings,
    table_ops,
)
from torch_parity import (
    EDGE_ROWS,
    assert_same_array,
    assert_same_table,
    assert_same_valid_table,
    jax_table,
    random_host_columns,
    to_port,
    traced_reference,
)

T = jt.TypeId

# ASCII, the empty string, NUL bytes, 2-, 3- and 4-byte UTF-8, and rows
# that differ only past a shared prefix or in trailing NULs
VOCAB = [b"", b"a", b"ab", b"abc", b"MAIL", b"MAIL\x00", b"SHIP", b"REG AIR",
         "é".encode(), "日本".encode(), "\U0001F600x".encode(),
         b"a\x00b", b"zzzzzzzzzzzz", b"PROMO BURNISHED COPPER", b"PROMO",
         b"promo"]
# rows for the predicates: the above plus invalid UTF-8
LIKE_ROWS = VOCAB + [b"\x80\x80", b"\xff", b"a\xc3", b"a%b", b"a_b",
                     b"a\\b", "aéc".encode(), "a€c".encode(),
                     "x\U0001F600y".encode(), b"abcabc", b"%", b"_"]


def string_host(rows, valid=None) -> tuple:
    """An Arrow STRING host column of ``rows`` (bytes)."""
    offsets = np.zeros(len(rows) + 1, np.int32)
    np.cumsum([len(r) for r in rows], out=offsets[1:])
    chars = np.frombuffer(b"".join(rows), np.uint8).copy()
    return (int(T.STRING), 0, (offsets, chars), valid)


def random_strings(n: int, seed: int, vocab=VOCAB, nulls=True) -> tuple:
    """``n`` rows drawn from ``vocab`` with a null tail (null rows keep
    their bytes)."""
    rng = np.random.default_rng(seed)
    rows = [vocab[i] for i in rng.integers(0, len(vocab), n)]
    valid = None
    if nulls:
        valid = rng.random(n) > 0.2
        valid[-max(1, n // 4):] = False
    return string_host(rows, valid)


def _one(host):
    """(JAX column, port column) of one host column."""
    jt_ = jax_table([host])
    return jt_.column(0), to_port(jt_).column(0)


def _same_column(got: Column, want: JColumn):
    assert_same_table(Table([got]), JTable([want]))



# ---- the column and the interchange ---------------------------------------

def test_string_column_round_trips():
    vals = ["a", None, "", "é日", "MAIL"]
    col = string_column(vals, device="cpu")
    assert col.size == 5 and not col.is_padded_string
    assert col.to_pylist() == vals
    ref = JColumn.from_pylist(vals, jt.STRING)
    _same_column(col, ref)
    back = table_from_numpy(table_to_numpy(Table([col])), device="cpu")
    assert back.column(0).to_pylist() == vals
    padded = strings.pad_strings(col)
    assert padded.is_padded_string and padded.size == 5
    assert padded.to_pylist() == vals and padded.equals(col)
    assert not padded.equals(string_column(["a", None, "", "x", "MAIL"],
                                           device="cpu"))
    with pytest.raises(ValueError, match="chars"):
        Column(t.STRING, torch.zeros(3, dtype=torch.int32))


# ---- layout, gather, keys --------------------------------------------------

@pytest.mark.parametrize("n", EDGE_ROWS)
def test_layouts_gather_and_keys_match_reference(n):
    jc, pc = _one(random_strings(n, n))
    width = jstr.max_string_width(jc)
    assert strings.max_string_width(pc) == width
    idx = np.random.default_rng(n).integers(0, n, 3 * n + 1)

    def reference(jc, idx):
        # pad_strings without width= takes the longest row, ``width``
        padded = jstr.pad_strings(jc, width=width)
        return (padded, jstr.unpad_strings(padded),
                jstr.pad_strings(jc, width=29),
                jstr.gather_strings(padded, idx),
                jstr.packed_sort_keys(padded),
                jstr.strings_equal_prev(padded),
                jstr.pad_to_common_width(
                    [padded, jstr.pad_strings(jc, width=31)])[0])

    want, unpadded, wide, gathered, keys, eq_prev, common = \
        traced_reference(reference, jc, jnp.asarray(idx))
    got = strings.pad_strings(pc)
    _same_column(got, want)
    _same_column(strings.unpad_strings(got), unpadded)
    _same_column(strings.pad_strings(pc, width=29), wide)
    _same_column(strings.gather_strings(pc, torch.from_numpy(idx)),
                 gathered)
    for g, w in zip(strings.packed_sort_keys(pc), keys):
        assert_same_array(g.numpy(), np.asarray(w).astype(np.int64))
    assert_same_array(strings.strings_equal_prev(pc).numpy(),
                      np.asarray(eq_prev))
    _same_column(strings.pad_to_common_width([got, strings.pad_strings(
        pc, width=31)])[0], common)


def test_empty_columns_match_reference():
    jc, pc = _one(string_host([]))
    _same_column(strings.pad_strings(pc), jstr.pad_strings(jc))
    _same_column(strings.unpad_strings(strings.pad_strings(pc)),
                 jstr.unpad_strings(jstr.pad_strings(jc)))
    jc, pc = _one(string_host([b"", b""]))
    _same_column(strings.pad_strings(pc), jstr.pad_strings(jc))


# ---- sort, groupby, trim ---------------------------------------------------

def _keyed_host(n, seed):
    rng = np.random.default_rng(seed + 1)
    return [random_strings(n, seed),
            (int(T.INT32), 0, rng.integers(-3, 3, n).astype(np.int32),
             None),
            (int(T.INT64), 0, rng.integers(-10**6, 10**6, n), None)]


@pytest.mark.parametrize("ascending,nulls_first", [
    (True, True), (True, False), (False, True), (False, False)])
@pytest.mark.parametrize("n", EDGE_ROWS)
def test_string_sort_matches_reference(n, ascending, nulls_first):
    jtab = jax_table(_keyed_host(n, n))
    want = jsort.sort_table(jtab, [0, 1], [ascending, True],
                            [nulls_first, True])
    got = sort.sort_table(to_port(jtab), [0, 1], [ascending, True],
                          [nulls_first, True])
    assert_same_valid_table(got, want)
    # the permutation of the real rows is the reference's
    order = sort.sort_order(to_port(jtab), [0], [ascending], [nulls_first])
    assert_same_array(order.numpy(), np.asarray(jsort.sort_order(
        jtab, [0], [ascending], [nulls_first]))[:n].astype(np.int64))


@pytest.mark.parametrize("n,keys", [(n, [1, 0] if n == 257 else [0])
                                    for n in EDGE_ROWS])
def test_string_key_groupby_matches_reference(n, keys):
    jtab = jax_table(_keyed_host(n, n + 3))
    aggs = [(2, "sum"), (2, "count"), (0, "count"), (1, "min")]
    want = traced_reference(partial(jgroupby.groupby_aggregate, keys=keys,
                                    aggs=aggs), jtab)
    got = groupby.groupby_aggregate(to_port(jtab), keys, aggs)
    assert int(got.num_groups) == int(want.num_groups)
    assert_same_valid_table(got.compact(), want.compact())


def test_string_min_max_aggregates_are_not_ported():
    tab = to_port(jax_table(_keyed_host(20, 1)))
    with pytest.raises(NotImplementedError, match="Queue 1 entry 3"):
        groupby.groupby_aggregate(tab, [1], [(0, "min")])


@pytest.mark.parametrize("n", EDGE_ROWS)
def test_trim_table_both_layouts_matches_reference(n):
    jtab = jax_table(_keyed_host(n, 4))
    jpad = JTable([jstr.pad_strings(jtab.column(0))] + jtab.columns[1:])
    for jt_ in (jtab, jpad):
        for k in (0, 1, n // 2, n):
            assert_same_table(table_ops.trim_table(to_port(jt_), k),
                              jtable_ops.trim_table(jt_, k))


# ---- joins ------------------------------------------------------------------

def _joined(lhost, rhost, lkeys, rkeys, how, out_size):
    jl, jr = jax_table(lhost), jax_table(rhost)

    def reference(jl, jr):
        want = jjoin.join(jl, jr, lkeys, rkeys, out_size, how=how)
        return want, jjoin.apply_join_maps(jl, jr, want)

    want, joined = traced_reference(reference, jl, jr)
    pl, pr = to_port(jl), to_port(jr)
    got = join.join(pl, pr, lkeys, rkeys, out_size, how=how)
    assert int(got.total) == int(want.total)
    for f in ("row_valid", "left_valid", "right_valid"):
        assert_same_array(getattr(got, f).numpy(),
                          np.asarray(getattr(want, f)), f)
    assert_same_valid_table(join.apply_join_maps(pl, pr, got), joined)


@pytest.mark.parametrize("how", ["inner", "left", "left_semi", "full"])
def test_join_carrying_strings_matches_reference(how):
    rng = np.random.default_rng(9)
    lhost = [(int(T.INT64), 0, rng.integers(0, 40, 300), None),
             random_strings(300, 1)]
    rhost = [(int(T.INT64), 0, rng.integers(0, 60, 90), None),
             random_strings(90, 2, vocab=VOCAB[:5])]
    _joined(lhost, rhost, [0], [0], how, 4096)


@pytest.mark.parametrize("how", ["inner", "left", "left_anti", "right"])
def test_join_on_string_keys_matches_reference(how):
    rng = np.random.default_rng(5)
    lhost = [random_strings(257, 3),
             (int(T.INT32), 0, np.arange(257, dtype=np.int32), None)]
    # the right side narrower, so both sides pad to a common width
    rhost = [random_strings(64, 4, vocab=VOCAB[:9]),
             (int(T.INT32), 0, rng.integers(0, 2, 64).astype(np.int32),
              None)]
    _joined(lhost, rhost, [0], [0], how, 8192)
    _joined(lhost, rhost, [0, 1], [0, 1], how, 8192)


def test_join_with_an_empty_string_build():
    """The reference's gather cannot index an empty build; the port
    gives (n, W) zero bytes, W the empty column's padded width (1)."""
    pl = table_from_numpy([(int(T.INT64), 0, np.arange(5, dtype=np.int64),
                            None)], device="cpu")
    pr = table_from_numpy([(int(T.INT64), 0, np.zeros(0, np.int64), None),
                           string_host([])], device="cpu")
    maps = join.join(pl, pr, [0], [0], 8, how="left")
    assert int(maps.total) == 5
    out = join.apply_join_maps(pl, pr, maps).column(2)
    assert out.is_padded_string and tuple(out.chars.shape) == (8, 1)
    assert not bool(out.chars.any()) and not bool(out.data.any())
    assert not bool(out.valid_mask().any())


# ---- predicates ------------------------------------------------------------

PATTERNS = [
    "%", "", "a%", "%b", "%b%", "_", "__", "a_", "_b", "a_c", "a__c",
    "_€_", "\U0001F600%", "x_y", "%\\%%", "\\_%", "a\\_b", "%\\\\%",
    "a\x00b", "MAIL", "MAIL%", "PROMO%", "%%", "_%_", "%_", "é",
    "é_", "abcdefghijklmnopqrstuvwxyz%", "%abc", "abc%abc",
]


@pytest.fixture(scope="module")
def like_columns():
    rng = np.random.default_rng(17)
    valid = rng.random(len(LIKE_ROWS)) > 0.15
    host = string_host(LIKE_ROWS, valid)
    return _one(host)


@pytest.mark.parametrize("pattern", PATTERNS)
def test_like_matches_reference(like_columns, pattern):
    jc, pc = like_columns
    _same_column(strings.like(pc, pattern), jstr.like(jc, pattern))
    _same_column(strings.like(strings.pad_strings(pc), pattern),
                 jstr.like(jstr.pad_strings(jc), pattern))


def test_like_other_escape_matches_reference(like_columns):
    jc, pc = like_columns
    for pattern in ("a!%b", "!_", "%!!%", "a!__"):
        _same_column(strings.like(pc, pattern, escape="!"),
                     jstr.like(jc, pattern, escape="!"))


@pytest.mark.parametrize("pattern,escape", [
    ("abc\\", "\\"), ("\\a", "\\"), ("a!b", "!"), ("%", "!!")])
def test_invalid_like_patterns_raise_in_both(like_columns, pattern, escape):
    jc, pc = like_columns
    with pytest.raises(ValueError):
        jstr.like(jc, pattern, escape=escape)
    with pytest.raises(ValueError):
        strings.like(pc, pattern, escape=escape)


@pytest.mark.parametrize("needle", [
    "", "a", "b", "é", "\x00", "\U0001F600", "MAIL", "abc",
    "a much longer needle than every row"])
def test_search_predicates_match_reference(like_columns, needle):
    jc, pc = like_columns
    for name in ("contains", "starts_with", "ends_with"):
        _same_column(getattr(strings, name)(pc, needle),
                     getattr(jstr, name)(jc, needle))


# ---- planner ---------------------------------------------------------------

def test_string_domains_match_reference():
    vals = ["b", "é", "B", "a", "b", ""]
    assert planner.string_domain(vals) == tuple(jplanner.string_domain(vals))
    jc, pc = _one(random_strings(300, 8, vocab=VOCAB[:6]))
    want = jplanner.observed_domain(jc)
    assert planner.observed_domain(pc) == tuple(want)
    assert planner.observed_domain(pc, max_size=2) is None
    assert jplanner.observed_domain(jc, max_size=2) is None
    ic, ip = _one((int(T.INT32), 0, np.asarray([3, 1, 3, 7], np.int32),
                   np.asarray([True, True, True, False])))
    assert planner.observed_domain(ip) == tuple(jplanner.observed_domain(ic))


def test_encode_string_key_ignores_lengths_as_the_reference_does():
    """Both packages compare the whole zero-padded row, not its length:
    b"MAIL\\x00" takes MAIL's code (a reference fault, kept)."""
    rows = [b"MAIL", b"MAIL\x00", b"SHIP", b"", b"\x00", b"RAIL", b"MAI"]
    jc, pc = _one(string_host(rows, np.asarray([1, 1, 1, 1, 1, 1, 0], bool)))
    dom = ("", "MAIL", "SHIP")
    got = planner.encode_string_key(pc, planner.string_domain(dom))
    want = jplanner.encode_string_key(jc, jplanner.string_domain(dom))
    _same_column(got, want)
    assert got.data.tolist() == [1, 1, 2, 0, 0, 3, 3]


@pytest.mark.parametrize("n", [1, 256, 2049])
def test_plan_groupby_on_a_string_domain_matches_reference(n):
    jtab = jax_table(_keyed_host(n, n + 5))
    aggs = [(2, "sum"), (2, "count"), (1, "max")]
    # a domain missing some values: those rows raise domain_miss
    for dom in (("", "MAIL", "SHIP", "a", "ab"),
                tuple(v.decode("utf-8") for v in VOCAB)):
        want = jplanner.plan_groupby(jtab, [0, 1], aggs, [
            jplanner.string_domain(dom), jplanner.scalar_domain(range(-3, 3))])
        got = planner.plan_groupby(to_port(jtab), [0, 1], aggs, [
            planner.string_domain(dom), planner.scalar_domain(range(-3, 3))])
        assert got.lowered == want.lowered == "bounded"
        assert bool(got.domain_miss) == bool(want.domain_miss)
        assert_same_array(got.present.numpy(), np.asarray(want.present))
        assert_same_valid_table(got.table, want.table)


# ---- reductions ------------------------------------------------------------

def _scalar(x):
    return np.asarray(x).reshape(-1)[0]


@pytest.mark.parametrize("n", [1, 2049])
def test_reductions_match_reference(n):
    cols = random_host_columns(n, n)[:-1]  # DECIMAL128 below
    rng = np.random.default_rng(n)
    cols += [(int(T.UINT64), 0, rng.integers(0, 2**64, n, dtype=np.uint64),
              None),
             (int(T.UINT16), 0, rng.integers(0, 2**16, n).astype(np.uint16),
              rng.random(n) > 0.5),
             (int(T.INT32), 0, np.zeros(n, np.int32), np.zeros(n, bool))]
    jtab = jax_table(cols)
    ptab = to_port(jtab)
    for jc, pc in zip(jtab.columns, ptab.columns):
        assert int(reduce.count(pc)) == int(jreduce.count(jc))
        is_float = pc.data.is_floating_point()
        for name in ("sum_", "mean", "min_", "max_"):
            if is_float and pc.data.dtype == torch.float32 \
                    and name in ("sum_", "mean"):
                continue  # float32 sums: the order differs
            gv, gok = getattr(reduce, name)(pc)
            wv, wok = getattr(jreduce, name)(jc)
            assert bool(gok) == bool(wok), (pc.dtype, name)
            if not bool(wok):
                continue
            g, w = _scalar(gv.numpy()), _scalar(wv)
            if is_float and name in ("sum_", "mean"):
                # float64: a relative 1e-12, the summation order differs
                np.testing.assert_allclose(g, w, rtol=1e-12)
            else:
                assert g.dtype == w.dtype and g == w, (pc.dtype, name)


@pytest.mark.parametrize("n", [1, 255, 2048])
def test_string_min_max_match_reference(n):
    jc, pc = _one(random_strings(n, n + 1))
    for name in ("min_", "max_"):
        got, gok = getattr(reduce, name)(pc)
        want, wok = getattr(jreduce, name)(jc)
        assert bool(gok) == bool(wok)
        if bool(wok):
            assert got.size == 1 and got.row_bytes() == [
                bytes(np.asarray(want.chars)[0, :int(want.data[0])])]
    assert int(reduce.count(pc)) == int(jreduce.count(jc))


def test_decimal128_reductions_are_not_ported():
    col = to_port(jax_table(random_host_columns(8, 1)[-1:])).column(0)
    for name in ("sum_", "mean", "min_", "max_"):
        with pytest.raises(NotImplementedError, match="Queue 1 entry 3"):
            getattr(reduce, name)(col)
