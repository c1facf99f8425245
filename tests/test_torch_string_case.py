"""The port's ``substring``, ``upper`` and ``lower`` (``ops/strings.py``,
``ops/unicode_case_device.py``) against the JAX package: the device case
map's bytes and special-row flags, the whole upper/lower columns (device
rows, host-mapped special rows merged back, the widened matrix), and
Spark's substr with negative starts, each at the edge row counts with
null tails; and the reference's own cases against Python's str methods
(the oracle its tests use), with every host-mapped row recorded.

Both packages work row by row here, so the reference runs once at the
largest edge count and a fixed padded width, and its first n rows are
its result at n rows. The case tables come from the interpreter's
Unicode database, shared by both packages in one process."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu.columnar import Table as JTable
from spark_rapids_jni_tpu.ops import strings as jstr
from spark_rapids_jni_tpu.ops import unicode_case_device as jucd
from spark_rapids_jni_tpu_torch import telemetry
from spark_rapids_jni_tpu_torch import types as t
from spark_rapids_jni_tpu_torch.columnar import Column
from spark_rapids_jni_tpu_torch.columnar.column import string_column
from spark_rapids_jni_tpu_torch.ops import strings
from spark_rapids_jni_tpu_torch.ops import unicode_case_device as ucd
from torch_parity import (
    EDGE_ROWS,
    arrow_strings,
    assert_same_array,
    assert_same_column,
    assert_same_head,
    both_strings,
    log_lines,
    mixed_script_rows,
    null_tail,
    traced_reference,
)

N = max(EDGE_ROWS)
WIDTH = 80  # wider than every generated row


def _rows(n):
    """Mixed-script rows (special characters in some) and log lines,
    with a null tail."""
    values = [v if i % 3 else w for i, (v, w) in enumerate(
        zip(mixed_script_rows(N, 4), log_lines(N, 4)))][:n]
    return values, null_tail(N, 4)[:n]


def _port_column(n):
    offsets, chars, valid = arrow_strings(*_rows(n))
    return strings.pad_strings(Column.from_numpy(
        offsets, t.STRING, valid, device="cpu", chars=chars), width=WIDTH)


def _reference_column():
    return jstr.pad_strings(both_strings(*_rows(N))[1], width=WIDTH)


@pytest.fixture(autouse=True)
def _fresh_telemetry():
    telemetry.reset()


@pytest.fixture(scope="module")
def case_reference():
    """The reference's device case map (traced) and its whole upper and
    lower (eager: they fetch the special rows to the host)."""
    jc = _reference_column()
    maps = traced_reference(
        lambda m: (jucd.case_map_device(m, True),
                   jucd.case_map_device(m, False)), jc.chars)
    return maps, jstr.upper(jc), jstr.lower(jc)


@pytest.mark.parametrize("n", EDGE_ROWS)
def test_case_map_device_matches_reference(case_reference, n):
    pc = _port_column(n)
    for to_upper, (want_out, want_special) in zip(
            (True, False), case_reference[0]):
        out, special = ucd.case_map_device(pc.chars, to_upper)
        assert_same_array(out.numpy(), np.asarray(want_out)[:n])
        assert_same_array(special.numpy(), np.asarray(want_special)[:n])


@pytest.mark.parametrize("n", EDGE_ROWS)
def test_upper_lower_match_reference(case_reference, n):
    """The merged result: the port's width is the input's or the longest
    host-mapped row's; the reference's extra columns are zero there."""
    pc = _port_column(n)
    for fn, want in ((strings.upper, case_reference[1]),
                     (strings.lower, case_reference[2])):
        got = fn(pc)
        w = int(got.chars.shape[1])
        assert w == max(WIDTH, int(got.data.max()))
        assert not np.asarray(want.chars)[:n, w:].any()
        assert_same_head(got, want, n, w)
    values, valid = _rows(n)
    assert strings.upper(pc).to_pylist() == [
        v.upper() if ok else None for v, ok in zip(values, valid)]


def test_row_blocks_give_the_same_bytes(case_reference, monkeypatch):
    """Blocks of 30 rows (the card's are ~1.9M) in the padding, the case
    map and the ASCII path."""
    monkeypatch.setattr(strings, "ROW_CHUNK_CELLS", 30 * WIDTH)
    values, valid = _rows(N)
    arrow = both_strings(values, valid)[0]
    assert strings.pad_strings(arrow, width=WIDTH).chars.equal(
        _port_column(N).chars)
    pc = _port_column(N)
    assert_same_head(strings.upper(pc), case_reference[1], N,
                     int(strings.upper(pc).chars.shape[1]))
    out, special = ucd.case_map_device(pc.chars, False)
    assert_same_array(out.numpy(), np.asarray(case_reference[0][1][0]))
    assert_same_array(special.numpy(), np.asarray(case_reference[0][1][1]))


CASES = [(0, None), (2, None), (0, 3), (3, 4), (70, 5), (5, 0), (4, -2),
         (-3, None), (-3, 2), (-5, 2), (-100, 3), (-100, None), (-1, 1)]


@pytest.fixture(scope="module")
def substring_reference():
    jc = _reference_column()
    return traced_reference(
        lambda t: [jstr.substring(t.column(0), s, n) for s, n in CASES],
        JTable([jc]))


@pytest.mark.parametrize("case", range(len(CASES)),
                         ids=[f"{s},{n}" for s, n in CASES])
def test_substring_matches_reference(substring_reference, case):
    """Spark's substr (a negative start's end from the unclamped
    position) on every edge count, Arrow-laid and padded."""
    for n in EDGE_ROWS:
        pc = _port_column(n)
        assert_same_head(strings.substring(pc, *CASES[case]),
                         substring_reference[case], n)


@pytest.mark.parametrize("values", [
    ["abc", "hello world", None, "", "é日本", "x"], ["", ""], []],
    ids=["mixed", "all_empty", "no_rows"])
def test_substring_of_arrow_columns_matches_reference(values):
    """Straight from the Arrow bytes, at the reference's padded width."""
    pc, jc = both_strings(values)
    want = traced_reference(
        lambda t: [jstr.substring(t.column(0), s, n) for s, n in CASES],
        JTable([jc]))
    for case, w in zip(CASES, want):
        assert_same_column(strings.substring(pc, *case), w)


@pytest.mark.parametrize("start,length,want", [
    (-5, 2, ["", "wo", None]), (-2, None, ["bc", "ld", None]),
    (1, 3, ["bc", "ell", None]), (-1, 5, ["c", "d", None])])
def test_substring_pinned(start, length, want):
    col = string_column(["abc", "hello world", None], device="cpu")
    assert strings.substring(col, start, length).to_pylist() == want


def _check(vals, to_upper):
    col = string_column(vals, device="cpu")
    got = (strings.upper(col) if to_upper else strings.lower(col)).to_pylist()
    assert got == [None if v is None else
                   (v.upper() if to_upper else v.lower()) for v in vals]


def _host_case_forbidden(monkeypatch):
    monkeypatch.setattr(strings, "_host_case", lambda *a, **k: (
        _ for _ in ()).throw(AssertionError("whole-column host path")))


@pytest.mark.parametrize("to_upper", [True, False])
def test_common_scripts_stay_on_device(to_upper, monkeypatch):
    """The reference's corpora, special-free per direction (ß is special
    for upper, capital sigma for lower): no row goes to the host."""
    _host_case_forbidden(monkeypatch)
    corpora = [
        ["Café au lait", "ñoño", "ÜBER den Wolken"],
        ["Ελληνικά Κείμενο" if to_upper else "ελληνικά κείμενο",
         "αβγδε" if not to_upper else "αβγδε ΑΒΓΔΕ"],
        ["Привет МИР", "жёлтый ЖЁЛТЫЙ", "Українська"],
        ["ＡＢＣｄｅｆ", "ｆｕｌｌｗｉｄｔｈ", "１２３"],
        ["mixed ASCII and é è ü Ö", "", None, "łódź ŁÓDŹ"],
    ]
    for vals in corpora:
        _check(vals, to_upper)
    assert telemetry.fallbacks() == {}


@pytest.mark.parametrize("vals,to_upper", [
    (["ΤΕΛΟΣ", "ΟΔΟΣ ΟΔΟΣ", "ΣΙΓΜΑ"], False),   # final sigma
    (["straße"], True),                          # ß -> SS (1:2)
    (["ısı"], True),                             # ı -> I (2 bytes -> 1)
    (["İstanbul"], False),                       # İ -> i̇ (1:2)
    (["\U00010400ab", "plain"], False),          # astral (Deseret)
    (["Café", "straße", None, "ñoño", "ÜBER"], True),
])
def test_special_rows_are_mapped_on_the_host(vals, to_upper, monkeypatch):
    """Only the special rows cross to the host (never the whole column),
    each call recorded with the rows it mapped."""
    _host_case_forbidden(monkeypatch)
    _check(vals, to_upper)
    col = string_column(vals, device="cpu")
    special = ucd.case_map_device(strings.pad_strings(col).chars,
                                  to_upper)[1] & col.valid_mask()
    op = "string_upper" if to_upper else "string_lower"
    assert telemetry.fallbacks() == {(op, strings._SPECIAL_CASE_REASON): {
        "calls": 1, "rows": int(special.sum())}}
    assert int(special.sum()) >= 1


def test_final_sigma_rule_really_fires():
    got = strings.lower(string_column(["ΤΕΛΟΣ"], device="cpu")).to_pylist()
    assert got == ["τελος"] and got[0].endswith("ς")


def test_ascii_only_stays_ascii(monkeypatch):
    monkeypatch.setattr(ucd, "case_map_device", lambda *a: (
        _ for _ in ()).throw(AssertionError("Unicode engine on ASCII")))
    col = string_column(["Hello", "WORLD", None, "mIxEd"], device="cpu")
    assert strings.upper(col).to_pylist() == ["HELLO", "WORLD", None, "MIXED"]
    assert strings.lower(col).to_pylist() == ["hello", "world", None, "mixed"]
    assert telemetry.fallbacks() == {}


def test_fuzz_mixed_scripts_vs_oracle():
    rng = np.random.default_rng(0)
    alphabet = list("aZ9 éÜñ") + list("αΩж") + list("Ｆｗ") + ["ß", "ı"]
    for _ in range(6):
        vals = ["".join(rng.choice(alphabet, size=rng.integers(0, 12)))
                for _ in range(40)]
        for to_upper in (True, False):
            _check(vals, to_upper)


def test_host_case_matches_reference():
    vals = ["straße", None, "ΟΔΟΣ", "Café"]
    pc, jc = both_strings(vals)
    for to_upper in (True, False):
        assert_same_column(strings._host_case(pc, to_upper),
                           jstr._host_case(jc, to_upper))


def test_invalid_utf8_row_is_special():
    mat = torch.tensor([[0xC3, 0x28, 0], [0x61, 0x80, 0], [0xE2, 0x82, 0xAC]],
                       dtype=torch.uint8)
    want = jucd.case_map_device(jnp.asarray(mat.numpy()), True)
    out, special = ucd.case_map_device(mat, True)
    assert special.tolist() == [True, True, False]
    assert_same_array(out.numpy(), np.asarray(want[0]))
    assert_same_array(special.numpy(), np.asarray(want[1]))
