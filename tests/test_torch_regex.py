"""The port's RLIKE (``ops/regex_device.py``, ``strings.regexp_contains``)
against the JAX package: the DFA tables byte for byte for every pattern
of the reference's list and of its grammar fuzz, the same refusals with
the same messages, and the same BOOL8 columns (verdicts and validity,
null rows included) from both engines, at the reference's edge row
counts with null tails. Every host run is recorded with the reference's
reason. The reference's compiler and host engine are pure Python; its
device engine runs eagerly, once per row count."""

from __future__ import annotations

import random
import re

import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu.ops import regex_device as jrd
from spark_rapids_jni_tpu.ops import strings as jstr
from spark_rapids_jni_tpu.utils import config as jconfig
from spark_rapids_jni_tpu_torch import telemetry
from spark_rapids_jni_tpu_torch.ops import regex_device as rd
from spark_rapids_jni_tpu_torch.ops import strings
from spark_rapids_jni_tpu_torch.utils import config
from torch_parity import (
    EDGE_ROWS,
    assert_same_column,
    assert_same_head,
    both_strings,
    log_lines,
    null_tail,
)

# the reference's pattern list (tests/test_regex_device.py)
DEVICE_PATTERNS = [
    r"abc", r"a.c", r"^abc", r"abc$", r"^abc$", r"a*b", r"a+b", r"ab?c",
    r"[abc]+", r"[^abc]", r"[a-f0-9]{2}", r"a{2,4}", r"a{3}", r"a{2,}",
    r"(ab|cd)+e", r"\d+", r"\w+@\w+", r"\s", r"\S+", r"[A-Z][a-z]*",
    r"foo|bar|baz", r"^$", r"(?:ab)*c", r"a\.b", r"[.*+]", r"colou?r",
    r"\d{1,3}\.\d{1,3}", r"a.*z", r"^\w+$", r".", r"x{0,2}y", r"[\w-]+",
    r"status=[45]\d\d", r"^.$", r"[^a]",
]
STRINGS = [
    "", "a", "abc", "xabcx", "aab", "aaab", "b", "ABC", "a.c", "axc",
    "a\nc", "123", "ab12", "foo", "barbaz", "colour", "color", "aaaa",
    "192.168.1.1", "hello world", "Hello", "abababe", "user@host", " ",
    "azzz", "é", "aéc", "日本語", "naïve", "xxy", "xy", "y", "a-b",
    None, "zzz",
]
UNSUPPORTED = [r"(a)\1", r"a(?=b)", r"\bword\b", r"a|b$", r"a*?b", r"^a|b",
               r"a{2}{3}", r"a**", r"a?*", "a\x00", "[\x00a]",
               r"(a|b)*a(a|b){14}", r"a{1000}", r"[a-\d]", r"x{2,1}"]


@pytest.fixture(autouse=True)
def _auto_engines():
    telemetry.reset()
    yield
    config.reset_option("regex.force_engine")
    jconfig.set_option("regex.force_engine", "")


def _pin(value):
    config.set_option("regex.force_engine", value)
    jconfig.set_option("regex.force_engine", value or "")


def _both(fn, values, valid=None):
    """fn on the port's and the reference's copy of one column."""
    pc, jc = both_strings(values, valid)
    return fn(pc, strings), fn(jc, jstr)


@pytest.mark.parametrize("pattern", DEVICE_PATTERNS)
def test_dfa_tables_are_identical(pattern):
    got, want = rd.compile_pattern(pattern), jrd.compile_pattern(pattern)
    assert got.num_states == want.num_states
    assert got.table.dtype == want.table.dtype == np.int32
    assert got.table.tobytes() == want.table.tobytes()
    assert got.accept.tobytes() == want.accept.tobytes()


@pytest.mark.parametrize("pattern", UNSUPPORTED)
def test_unsupported_patterns_are_refused_alike(pattern):
    with pytest.raises(jrd.RegexUnsupported) as want:
        jrd.compile_pattern(pattern)
    with pytest.raises(rd.RegexUnsupported) as got:
        rd.compile_pattern(pattern)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("pattern", DEVICE_PATTERNS)
def test_device_engine_matches_host_engines(pattern):
    """The port's host engine = the reference's, byte for byte; the
    port's device engine gives the same verdicts over the reference's
    strings (a null row's flag is the engine's own: the host writes 0,
    the DFA runs over the row's bytes, in both packages)."""
    _pin("device")
    dev, _ = _both(lambda c, m: m.regexp_contains(c, pattern)
                   if m is strings else None, STRINGS)
    _pin("host")
    host, want = _both(lambda c, m: m.regexp_contains(c, pattern), STRINGS)
    assert_same_column(host, want)
    assert dev.to_pylist() == want.to_pylist()
    assert torch.equal(dev.validity, host.validity)
    assert telemetry.fallbacks() == {
        ("regexp_contains", "regex.force_engine=host pin"):
            {"calls": 1, "rows": len(STRINGS)}}


EDGE_WIDTH = 80  # slack past the widest log line: no sentinel step


@pytest.fixture(scope="module")
def edge_reference():
    """The reference's device engine once, at the largest edge count and
    a fixed padded width; it runs row by row, so its first n flags are
    its result at n rows."""
    n = max(EDGE_ROWS)
    _, jc = both_strings(log_lines(n, 9), null_tail(n, 9))
    return jstr.regexp_contains(jstr.pad_strings(jc, width=EDGE_WIDTH),
                                r"status=[45]\d\d")


@pytest.mark.parametrize("n", EDGE_ROWS)
def test_rlike_matches_reference_at_edge_rows(edge_reference, n):
    """bench.py's log lines with a null tail, Arrow-laid (the widest row
    fills the matrix, so the sentinel step runs) and padded with slack."""
    values = log_lines(max(EDGE_ROWS), 9)[:n]
    pc = both_strings(values, null_tail(max(EDGE_ROWS), 9)[:n])[0]
    for col in (pc, strings.pad_strings(pc, width=EDGE_WIDTH)):
        assert_same_head(strings.regexp_contains(col, r"status=[45]\d\d"),
                         edge_reference, n)
    assert telemetry.fallbacks() == {}
    assert strings.regexp_contains(pc, r"status=[45]\d\d").to_pylist() == [
        ("status=404" in v) if ok else None for v, ok in
        zip(values, null_tail(max(EDGE_ROWS), 9)[:n])]


@pytest.mark.parametrize("pattern", [r"(a)\1", r"^a|b", r"a*?b"])
def test_unsupported_pattern_takes_the_host_engine(pattern):
    vals = ["aa", "ab", None, "xb", "b", "aab"]
    got, want = _both(lambda c, m: m.regexp_contains(c, pattern), vals)
    assert_same_column(got, want)
    with pytest.raises(jrd.RegexUnsupported) as exc:
        jrd.compile_pattern(pattern)
    assert telemetry.fallbacks() == {
        ("regexp_contains", f"unsupported regex atom: {exc.value}"):
            {"calls": 1, "rows": len(vals)}}
    _pin("device")
    with pytest.raises(rd.RegexUnsupported):
        strings.regexp_contains(both_strings(vals)[0], pattern)


@pytest.mark.parametrize("pattern,values,want", [
    (r"^.$", ["é", "ab", "日", "x", ""], [True, False, True, True, False]),
    (r"[^a]", ["é", "a", "\n"], [True, False, True]),
    (r"abc$", ["abc", "abc\n", "abc\nx", "abc\n\n", "ab"],
     [True, True, False, False, False]),
])
def test_pinned_device_verdicts(pattern, values, want):
    """UTF-8 ``.`` counts characters, a negated class matches a
    multi-byte character, ``$`` matches before one final newline."""
    _pin("device")
    got, ref = _both(lambda c, m: m.regexp_contains(c, pattern), values)
    assert_same_column(got, ref)
    assert got.to_pylist() == want


def test_embedded_nul_routes_to_host():
    """A NUL inside a row aliases the sentinel: auto mode gives the host
    engine's answer, recorded; device-pinned mode refuses."""
    vals = ["a\x00b", "ab"]
    got, want = _both(lambda c, m: m.regexp_contains(c, r"b"), vals)
    assert_same_column(got, want)
    assert got.to_pylist() == [True, True]
    assert telemetry.fallbacks() == {
        ("regexp_contains",
         "embedded NUL bytes alias the 0x00 padding sentinel"):
            {"calls": 1, "rows": 2}}
    _pin("device")
    for mod, col in zip((strings, jstr), both_strings(vals)):
        with pytest.raises(ValueError, match="NUL"):
            mod.regexp_contains(col, r"b")


@pytest.mark.parametrize("width", [3, 4])
def test_padded_input_with_and_without_slack(width):
    """A padded column whose widest row fills W takes the sentinel step;
    one with slack does not need it; both give the reference's flags."""
    vals = ["foo", "bar", "fo", None]
    got, want = _both(lambda c, m: m.regexp_contains(
        m.pad_strings(c, width=width), r"o$"), vals)
    assert_same_column(got, want)
    assert got.to_pylist() == [True, False, True, None]


def test_run_dfa_matches_reference_run_dfa():
    pc, jc = both_strings(log_lines(300, 5))
    comp = rd.compile_pattern(r"id=\d+ ")
    for sentinel in (True, False):
        got = rd.run_dfa(strings.pad_strings(pc, width=80).chars, comp,
                         ensure_sentinel=sentinel)
        want = jrd.run_dfa(jstr.pad_strings(jc, width=80).chars,
                           jrd.compile_pattern(r"id=\d+ "),
                           ensure_sentinel=sentinel)
        assert got.numpy().tolist() == np.asarray(want).tolist()


def test_random_pattern_fuzz_vs_reference():
    """The reference's grammar fuzz: every compilable pattern has the
    reference's DFA table and the port's device verdicts equal re.ASCII;
    the others are refused by both."""
    rng = random.Random(1234)
    alpha = "abc"

    def atom(depth):
        r = rng.random()
        if r < 0.35 or depth > 2:
            return rng.choice(alpha)
        if r < 0.5:
            return "."
        if r < 0.65:
            body = "".join(sorted(set(
                rng.choice(alpha) for _ in range(rng.randint(1, 3)))))
            neg = "^" if rng.random() < 0.3 else ""
            return f"[{neg}{body}]"
        if r < 0.8:
            return r"\d" if rng.random() < 0.5 else r"\w"
        return "(" + alt(depth + 1) + ")"

    def piece(depth):
        a = atom(depth)
        r = rng.random()
        if r < 0.2:
            return a + "*"
        if r < 0.3:
            return a + "+"
        if r < 0.4:
            return a + "?"
        if r < 0.45:
            lo = rng.randint(0, 2)
            return a + f"{{{lo},{lo + rng.randint(0, 2)}}}"
        return a

    def concat(depth):
        return "".join(piece(depth) for _ in range(rng.randint(1, 4)))

    def alt(depth):
        return "|".join(concat(depth) for _ in range(rng.randint(1, 2)))

    values = ["", "a", "b", "abc", "aab", "cabab", "abcabc", "1a", "a1b2",
              "ccc", "ab", "ba", "aaa", "x", "a b"]
    col = both_strings(values)[0]
    _pin("device")
    tested = 0
    for _ in range(120):
        pat = alt(0)
        if rng.random() < 0.2:
            pat = "^" + pat
        try:
            want = jrd.compile_pattern(pat)
        except jrd.RegexUnsupported:
            with pytest.raises(rd.RegexUnsupported):
                rd.compile_pattern(pat)
            continue
        got = rd.compile_pattern(pat)
        assert got.table.tobytes() == want.table.tobytes(), pat
        assert got.accept.tobytes() == want.accept.tobytes(), pat
        rx = re.compile(pat, re.ASCII)
        assert strings.regexp_contains(col, pat).to_pylist() == [
            rx.search(v) is not None for v in values], pat
        tested += 1
    assert tested > 60


def test_compile_cache_is_counted():
    pattern = r"cache-probe-[xyz]+"
    rd.compile_pattern(pattern)
    telemetry.reset()
    rd.compile_pattern(pattern)
    rd.compile_pattern(pattern + "!")
    assert telemetry.counter("compile_cache.regex_dfa.hit") == 1
    assert telemetry.counter("compile_cache.regex_dfa.miss") == 1


def test_force_engine_option():
    assert config.get_option("regex.force_engine") is None
    config.set_option("regex.force_engine", "host")
    assert config.get_option("regex.force_engine") == "host"
    config.set_option("regex.force_engine", "")
    assert config.get_option("regex.force_engine") is None
    with pytest.raises(ValueError):
        config.set_option("regex.force_engine", "gpu")
    with pytest.raises(KeyError):
        config.get_option("regex.nope")


def test_empty_column():
    got, want = _both(lambda c, m: m.regexp_contains(c, "a"), [])
    assert_same_column(got, want)
    assert got.data.dtype == torch.uint8
