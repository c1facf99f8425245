"""The port's regexp_extract and regexp_replace (``ops/regex_capture_device.py``
and ``ops/strings.py``) against the JAX package: the linear parser and
the suffix-DFA tables byte for byte, the same refusals with the same
messages, the device engines' bytes over seeded rows (across row-block
edges), the same columns at the reference's edge row counts with null
tails in both string layouts, Java's replacement syntax, and every host
route with the reference's recorded reason. The reference's device
engine runs eagerly here, once per pattern; its string-level functions
compile once per pattern and row bucket."""

from __future__ import annotations

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu.ops import regex_capture_device as jrc
from spark_rapids_jni_tpu.ops import strings as jstr
from spark_rapids_jni_tpu.utils import config as jconfig
from spark_rapids_jni_tpu_torch import telemetry
from spark_rapids_jni_tpu_torch.ops import regex_capture_device as rc
from spark_rapids_jni_tpu_torch.ops import strings
from spark_rapids_jni_tpu_torch.utils import config
from torch_parity import (
    EDGE_ROWS,
    assert_same_array,
    assert_same_column,
    assert_same_head,
    both_strings,
    log_lines,
    null_tail,
)

# the reference's corpora (tests/test_regex_capture.py) and more shapes:
# anchors, lazy bounded repeats, an empty group, classes and escapes
EXTRACT_CORPUS = [
    (r"(\d+)", 1), (r"(\d+)", 0), (r"id=(\w+);", 1), (r"([a-z]+)-(\d+)", 2),
    (r"([a-z]+)-(\d+)", 1), (r"^(\w+) (\w+)$", 2), (r"(\d+)(\d)", 1),
    (r"(a*)(a)", 1), (r"x(.*?)y", 1), (r"(\d{2,4})", 1), (r"v(\d+)\.(\d+)", 2),
    (r"(\s+)", 1), (r"a()b", 1), (r"(x?)y{1,2}?", 1), (r"^([^ ]*)", 1),
    (r"([ab]{2,3}?)1", 1), (r"(\S+)$", 1), (r"status=(\d+)", 1),
]
REPLACE_CORPUS = [
    (r"\d+", "#"), (r"a+", "<>"), (r"\s+", "_"), (r"[aeiou]", ""),
    (r"(\w+)@(\w+)", "X"), (r"x?y", "Q"), (r"b*?a", "@@@"),
    (r"^a", "START"), (r"1$", "!"),
]
REFUSED = [r"a|b", r"(a(b))", r"(a)+", r"a(?=b)", r"(ab)\1", "a\x00b", "\x00",
           "a\\\x00", "[\x00a]", "[\x00-\x05]+", "", r"a{300}", r"[b-a]",
           r"a**", r"é", r"\p{L}", r"(?i)a", r"a{2,1}", r"a$b", r"(a"]


@pytest.fixture(autouse=True)
def _auto_engines():
    telemetry.reset()
    yield
    config.reset_option("regex.force_engine")
    jconfig.set_option("regex.force_engine", "")


def _pin(value):
    config.set_option("regex.force_engine", value)
    jconfig.set_option("regex.force_engine", value or "")


@pytest.fixture
def ref_fallbacks(monkeypatch):
    """The reference's recorded host fallbacks, (op, reason, rows)."""
    seen = []
    monkeypatch.setattr(jstr.telemetry, "record_fallback",
                        lambda op, reason, rows=None:
                        seen.append((op, reason, rows)))
    return seen


def _port_fallbacks():
    return [(op, reason, v["rows"]) for (op, reason), v in
            telemetry.fallbacks().items() for _ in range(v["calls"])]


def _both(fn, values, valid=None):
    pc, jc = both_strings(values, valid)
    return fn(pc, strings), fn(jc, jstr)


@pytest.mark.parametrize("pattern", sorted(
    {p for p, _ in EXTRACT_CORPUS} | {p for p, _ in REPLACE_CORPUS}))
def test_suffix_dfa_tables_are_identical(pattern):
    got, want = rc.compile_linear(pattern), jrc.compile_linear(pattern)
    assert got.pattern == want.pattern
    assert len(got.suffix_dfas) == len(want.suffix_dfas) \
        == len(want.pattern.elements) + 1
    for (gt, ga), (wt, wa) in zip(got.suffix_dfas, want.suffix_dfas):
        assert gt.dtype == wt.dtype == np.int32
        assert gt.tobytes() == wt.tobytes()
        assert ga.tobytes() == wa.tobytes()


@pytest.mark.parametrize("pattern", REFUSED)
def test_refused_patterns_alike(pattern):
    with pytest.raises(jrc.RegexUnsupported) as want:
        jrc.compile_linear(pattern)
    with pytest.raises(rc.RegexUnsupported) as got:
        rc.compile_linear(pattern)
    assert str(got.value) == str(want.value)


def _seeded_rows(n: int, seed: int) -> list:
    rng = np.random.default_rng(seed)
    alphabet = list("ab1 2-xy=;\tvc.@ei")
    return ["".join(rng.choice(alphabet, size=rng.integers(0, 20)))
            for _ in range(n)] + ["status=200 id=5", "v12.34", "aaa",
                                  "xabcy y", "a@b c@d", "1 2 3 4 5 6 7 8 9"]


@pytest.fixture(scope="module")
def seeded_matrix():
    """(n, W) rows of a small alphabet, padded with a zero column past
    the widest (the gate's sentinel)."""
    rows = _seeded_rows(240, 3)
    w = max(len(r) for r in rows) + 1
    mat = np.zeros((len(rows), w), np.uint8)
    for i, r in enumerate(rows):
        mat[i, :len(r)] = np.frombuffer(r.encode(), np.uint8)
    return mat, np.asarray([len(r) for r in rows], np.int32)


@pytest.mark.parametrize("pattern,group", EXTRACT_CORPUS)
def test_extract_device_matches_reference(seeded_matrix, monkeypatch,
                                          pattern, group):
    """The reference's eager device engine and the port's, in blocks of
    7 rows and in one block: the same lengths and bytes."""
    mat, _ = seeded_matrix
    want_len, want = jrc.extract_device(
        jnp.asarray(mat), jrc.compile_linear(pattern), group)
    comp = rc.compile_linear(pattern)
    for cells in (7 * (mat.shape[1] + 1), strings.ROW_CHUNK_CELLS):
        monkeypatch.setattr(strings, "ROW_CHUNK_CELLS", cells)
        got_len, got = rc.extract_device(torch.from_numpy(mat), comp, group)
        assert_same_array(got_len.numpy(), want_len, "lengths")
        assert_same_array(got.numpy(), want, "chars")


@pytest.mark.parametrize("pattern,rep", REPLACE_CORPUS)
def test_replace_device_matches_reference(seeded_matrix, monkeypatch,
                                          pattern, rep):
    mat, lens = seeded_matrix
    want_len, want, want_over = jrc.replace_device(
        jnp.asarray(mat), jnp.asarray(lens), jrc.compile_linear(pattern),
        rep.encode())
    comp = rc.compile_linear(pattern)
    for cells in (7 * (mat.shape[1] + 1), strings.ROW_CHUNK_CELLS):
        monkeypatch.setattr(strings, "ROW_CHUNK_CELLS", cells)
        got_len, got, over = rc.replace_device(
            torch.from_numpy(mat), torch.from_numpy(lens), comp, rep.encode())
        assert_same_array(got_len.numpy(), want_len, "lengths")
        assert_same_array(got.numpy(), want, "chars")
        assert bool(over) == bool(want_over)


def test_replace_overflow_boundary():
    """Eight matches in a row fit the 8 rounds; nine overflow (the
    reference's overflow route itself is held below, among the host
    routes)."""
    rows = ["1 2 3 4 5 6 7 8", "1 2 3 4 5 6 7 8 9"]
    mat = np.zeros((1, 20), np.uint8)
    comp = rc.compile_linear(r"\d")
    for r, want in zip(rows, (False, True)):
        mat[0, :len(r)] = np.frombuffer(r.encode(), np.uint8)
        _, _, got = rc.replace_device(
            torch.from_numpy(mat), torch.tensor([len(r)], dtype=torch.int32),
            comp, b"#")
        assert bool(got) == want


EDGE_WIDTH = 80  # slack past the widest log line


@pytest.fixture(scope="module")
def edge_reference():
    """The reference's regexp_extract and regexp_replace once each, at
    the largest edge count and a fixed padded width; rows are
    independent, so the first n rows are its result at n rows."""
    n = max(EDGE_ROWS)
    _, jc = both_strings(log_lines(n, 21), null_tail(n, 21))
    jc = jstr.pad_strings(jc, width=EDGE_WIDTH)
    return {"extract": jstr.regexp_extract(jc, r"id=(\d+)", 1),
            "replace": jstr.regexp_replace(jc, r"status=\d+", "status=XXX")}


@pytest.mark.parametrize("n", EDGE_ROWS)
def test_edge_rows_match_reference(edge_reference, monkeypatch, n):
    """bench.py's log lines with a null tail: Arrow-laid (the widest row
    fills W, so the gate adds the sentinel column), padded with slack,
    and padded full (the sentinel appended to the matrix), in blocks of
    100 rows; the device path throughout."""
    monkeypatch.setattr(strings, "ROW_CHUNK_CELLS", 100 * (EDGE_WIDTH + 1))
    values = log_lines(max(EDGE_ROWS), 21)[:n]
    valid = null_tail(max(EDGE_ROWS), 21)[:n]
    pc = both_strings(values, valid)[0]
    widest = max(len(v) for v in values)
    for col, w in ((pc, widest + 1),
                   (strings.pad_strings(pc, width=EDGE_WIDTH), EDGE_WIDTH),
                   (strings.pad_strings(pc), widest + 1)):
        got = strings.regexp_extract(col, r"id=(\d+)", 1)
        assert int(got.chars.shape[1]) == w
        assert_same_head(got, edge_reference["extract"], n, width=w)
        got = strings.regexp_replace(col, r"status=\d+", "status=XXX")
        assert int(got.chars.shape[1]) == w + 8 * 10 + 1
        assert_same_head(got, edge_reference["replace"], n,
                         width=w + 8 * 10 + 1)
    assert telemetry.fallbacks() == {}
    rx = re.compile(r"id=(\d+)", re.ASCII)
    assert strings.regexp_extract(pc, r"id=(\d+)", 1).to_pylist() == [
        (m.group(1) if (m := rx.search(v)) else "") if ok else None
        for v, ok in zip(values, valid)]


def test_string_level_corpus_matches_reference():
    """The reference's own corpus through both packages' regexp_extract
    and regexp_replace (device engines), with nulls."""
    rows = ["abc123def45", "", None, "foo-123 bar-9", "x1", "a@b c@d",
            "hello world", "xabcy y"]
    _pin("device")
    got, want = _both(lambda c, m: m.regexp_extract(c, r"([a-z]+)-(\d+)",
                                                    2), rows)
    assert_same_column(got, want)
    got, want = _both(lambda c, m: m.regexp_replace(c, r"[aeiou]", ""),
                      rows)
    assert_same_column(got, want)
    assert telemetry.fallbacks() == {}


ROWS = ["abab 12", "GET /a", None, "POST /b 7", ""]


@pytest.mark.parametrize("fn,values", [
    # a pattern outside the linear subset (alternation)
    (lambda c, m: m.regexp_extract(c, r"(GET|POST) (\S+)", 2), ROWS),
    (lambda c, m: m.regexp_extract(c, r"(ab)\1", 0), ROWS),
    (lambda c, m: m.regexp_replace(c, r"(GET|POST)", "VERB"), ROWS),
    # rows with a NUL or a non-ASCII byte
    (lambda c, m: m.regexp_extract(c, r"(\d+)", 1), ["a\x00b1", "x9"]),
    (lambda c, m: m.regexp_extract(c, r"(\d+)", 1), ["héllo 123", "x9"]),
    (lambda c, m: m.regexp_replace(c, r"\d", "#"), ["é1", None, "2"]),
    # an empty-matching pattern
    (lambda c, m: m.regexp_replace(c, r"x*", "-"), ["abc", "", "xa", None]),
    # more than 8 matches in a row: the device run, then the host
    (lambda c, m: m.regexp_replace(c, r"\d+", "#"),
     [" ".join(str(i) for i in range(12)), "1 2", None]),
    # group references and escapes in the replacement
    (lambda c, m: m.regexp_replace(c, r"(\w+)@(\w+)", "$2@$1"),
     ["a@b c@d", "no at", None]),
    (lambda c, m: m.regexp_replace(c, r"(\d)(\d)", "$10"), ["12 34", "5"]),
    (lambda c, m: m.regexp_replace(c, r"a", "\\$\\\\"), ["banana", "x"]),
    # no rows
    (lambda c, m: m.regexp_extract(c, r"(\d+)", 1), []),
], ids=["alternation", "backreference", "replace_alternation", "nul",
        "non_ascii", "replace_non_ascii", "empty_match", "overflow",
        "group_ref", "group_ref_greedy", "escapes", "empty_column"])
def test_host_routes_match_reference(ref_fallbacks, fn, values):
    """Each host route gives the reference's column and records the
    reference's reason with the row count."""
    got, want = _both(fn, values)
    assert_same_column(got, want)
    assert _port_fallbacks() == ref_fallbacks
    assert ref_fallbacks


@pytest.mark.parametrize("fn", [
    lambda c, m: m.regexp_extract(c, r"(\d+)", 1),
    lambda c, m: m.regexp_replace(c, r"\d", "#"),
], ids=["extract", "replace"])
def test_force_host_pin(ref_fallbacks, fn):
    _pin("host")
    got, want = _both(fn, ["a1", None, "22 3"])
    assert_same_column(got, want)
    assert _port_fallbacks() == ref_fallbacks == [
        (ref_fallbacks[0][0], "regex.force_engine=host pin", 3)]


def test_force_device_pin_raises_where_the_device_cannot_run():
    _pin("device")
    pc, jc = both_strings(["x"])
    for mod, col in ((strings, pc), (jstr, jc)):
        with pytest.raises(ValueError, match="alternation"):
            mod.regexp_extract(col, r"(a|b)", 1)
    pc, jc = both_strings(["é1"])
    for mod, col in ((strings, pc), (jstr, jc)):
        with pytest.raises(ValueError, match="non-ASCII"):
            mod.regexp_replace(col, r"\d", "#")


@pytest.mark.parametrize("rep,groups", [
    ("$10", 2), ("$10", 10), ("$1$2", 2), ("a\\nb", 0), ("\\$5", 0),
    ("\\\\", 0), ("x\\", 1), ("$", 1), ("$x", 1), ("$3", 2), ("", 0),
    ("$0", 0), ("100$", 0),
])
def test_java_replacement_syntax(rep, groups):
    """Java's greedy $N (with two groups, '$10' is group 1 then '0'),
    backslash as a literal escape, and the same refusals."""
    try:
        want = jstr._java_replacement_to_python(rep, groups)
    except ValueError as exc:
        with pytest.raises(ValueError) as got:
            strings._java_replacement_to_python(rep, groups)
        assert str(got.value) == str(exc)
        return
    assert strings._java_replacement_to_python(rep, groups) == want


def test_group_index_is_validated_up_front():
    pc, jc = both_strings(["a1"])
    for mod, col in ((strings, pc), (jstr, jc)):
        with pytest.raises(ValueError, match="out of range"):
            mod.regexp_extract(col, r"(\d)", 2)


def test_compile_cache_is_counted():
    pattern = r"cache-probe-(\d+)"
    rc.compile_linear(pattern)
    telemetry.reset()
    rc.compile_linear(pattern)
    rc.compile_linear(pattern + "x")
    assert telemetry.counter("compile_cache.regex_linear.hit") == 1
    assert telemetry.counter("compile_cache.regex_linear.miss") == 1
