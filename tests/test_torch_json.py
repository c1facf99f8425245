"""The port's get_json_object (``ops/json_device.py``,
``ops/get_json_object.py``) against the JAX package: the device engine's
lengths, chars (the padded matrix, every byte) and validity equal to the
reference's device engine over the reference's randomized documents and
its adversarial structural cases, and at the edge row counts with null
tails over ``bench.py``'s documents (and in blocks of 100 rows); the
same eligibility verdicts; path errors raised before an engine is
chosen; and, where the reference calls its native host engine (escaped
or malformed documents), the port's call of the same engine (the
library it builds) with the same bytes and a recorded fallback. The
reference's device engine runs traced (``traced_reference``): one
compile per path and shape, its largest edge count serving the smaller
ones (it works row by row)."""

from __future__ import annotations

import json
import random

import pytest

from spark_rapids_jni_tpu.columnar import Table as JTable
from spark_rapids_jni_tpu.ops import get_json_object as jgoj
from spark_rapids_jni_tpu.ops import json_device as jjd
from spark_rapids_jni_tpu.ops import strings as jstr
from spark_rapids_jni_tpu_torch import telemetry
from spark_rapids_jni_tpu_torch.ops import json_device as jd
from spark_rapids_jni_tpu_torch.ops import strings
from spark_rapids_jni_tpu_torch.ops.get_json_object import (
    get_json_object,
    get_json_object_host,
    json_tuple,
)
from torch_parity import (
    EDGE_ROWS,
    assert_same_column,
    assert_same_head,
    bench_json_docs,
    both_strings,
    null_tail,
    reference_native,
    traced_reference,
)


def _rand_value(rng, depth):
    r = rng.random()
    if depth >= 3 or r < 0.35:
        return rng.choice([17, -3, 2.5, 1e3, True, False, None, "plain", "",
                           "x y", "été"])
    if r < 0.6:
        return {k: _rand_value(rng, depth + 1)
                for k in rng.sample(["a", "b", "field", "nm", "z9"],
                                    rng.randint(0, 4))}
    return [_rand_value(rng, depth + 1) for _ in range(rng.randint(0, 4))]


def _dumps(rng, obj):
    style = rng.random()
    if style < 0.4:
        return json.dumps(obj, separators=(",", ":"), ensure_ascii=False)
    if style < 0.8:
        return json.dumps(obj, ensure_ascii=False)
    return json.dumps(obj, indent=1, ensure_ascii=False)


def _random_docs():
    """The reference's randomized documents (seed 1234), with a null, an
    empty and a blank row."""
    rng = random.Random(1234)
    docs = [_dumps(rng, {k: _rand_value(rng, 1) for k in rng.sample(
        ["a", "b", "field", "nm", "z9"], rng.randint(0, 5))})
        for _ in range(300)]
    return docs + [None, "", "   "]


ADVERSARIAL = [
    '{"x":"field","field":1}',          # a value string shadows a key
    '{"x":"field"}',                    # only the shadow, no real key
    '{"a":{"field":0},"field":2}',      # a deeper same-name key first
    '{"field":{"field":3}}',            # the same name chained
    '{"a":[{"field":1},{"field":2}]}',  # keys inside array elements
    '{"field":[]}', '{"field":{}}', '{"field":""}',
    '{"field":null}',                   # JSON null -> SQL NULL
    '{ "field" : 42 }',
    '{"field":[1,[2,3],{"a":4}]}',
    '{"fiel":1,"fielded":2,"field":3}',  # prefix/suffix confusion
    '[1,2,3]', '"rootstr"', '17', 'null', '{}',
    # the key window at the very end of the char matrix
    '{"k":1}', '{"kk":22}', '{"a":1,"k":9}',
]
TUPLE_DOCS = ['{"a": 1, "b": "x"}', '{"b": "y"}', None, '{"a": null}']
# the reference's paths but three of the same step shapes as others
# ("$.z9", "$.b.field", "$.a[2].a": parsed alike below), and "$.b"
PATHS = ["$", "$.a", "$.field", "$.nm.a", "$.a.b", "$.a[0]", "$.a[1]",
         "$.b", "$.a[2].b", "$.field[1]", "$.a[1].field", "$.field.field",
         "$[1]", "$.k"]


@pytest.fixture(scope="module")
def mixed():
    """One column of the randomized and adversarial documents, and the
    reference's result for every path (one traced program)."""
    docs = _random_docs() + ADVERSARIAL + TUPLE_DOCS
    pc, jc = both_strings(docs)
    outs = traced_reference(
        lambda t: ([jjd.get_json_object_device(t.column(0), p)
                    for p in PATHS], jjd.device_eligible(t.column(0))),
        JTable([jc]))
    return pc, dict(zip(PATHS, outs[0])), bool(outs[1])


@pytest.mark.parametrize("path", PATHS)
def test_device_engine_matches_reference(mixed, path):
    pc, want, _ = mixed
    assert_same_column(jd.get_json_object_device(pc, path), want[path])


def test_eligibility_and_dispatcher_match_reference(mixed):
    pc, want, eligible = mixed
    assert eligible and bool(jd.device_eligible(pc))
    telemetry.reset()
    assert_same_column(get_json_object(pc, "$.a[1]"), want["$.a[1]"])
    assert telemetry.fallbacks() == {}


EDGE_WIDTH = 64  # a common padded width: one reference program serves all n
EDGE_PATHS = ["$", "$.sku", "$.meta.w"]


def _edge_docs(n):
    """bench.py's documents with a null tail, one adversarial document
    every 97 rows, padded to EDGE_WIDTH."""
    docs = bench_json_docs(n)
    for i in range(0, n, 97):
        docs[i] = ADVERSARIAL[i % len(ADVERSARIAL)]
    pc, jc = both_strings(docs, null_tail(max(EDGE_ROWS), 3)[:n])
    return strings.pad_strings(pc, width=EDGE_WIDTH), jc


@pytest.fixture(scope="module")
def edge_reference():
    """The reference at the largest edge count. Its device engine works
    row by row, so its first n rows are its result at n rows (the padded
    width is fixed, so the bytes are too)."""
    _, jc = _edge_docs(max(EDGE_ROWS))
    return traced_reference(
        lambda t: [jjd.extract_with_eligibility(t.column(0), p)
                   for p in EDGE_PATHS],
        JTable([jstr.pad_strings(jc, width=EDGE_WIDTH)]))


@pytest.mark.parametrize("n", EDGE_ROWS)
def test_edge_rows_match_reference(edge_reference, n):
    pc, _ = _edge_docs(n)
    for path, (want, elig) in zip(EDGE_PATHS, edge_reference):
        got, got_elig = jd.extract_with_eligibility(pc, path)
        assert_same_head(got, want, n)
        assert bool(got_elig) and bool(elig)


def test_row_blocks_give_the_same_bytes(edge_reference, monkeypatch):
    """Blocks of 100 rows (the card's are ~1.2M) give the same column."""
    n = max(EDGE_ROWS)
    pc, _ = _edge_docs(n)
    monkeypatch.setattr(strings, "ROW_CHUNK_CELLS", 100 * EDGE_WIDTH)
    for path, (want, _) in zip(EDGE_PATHS, edge_reference):
        assert_same_column(jd.get_json_object_device(pc, path), want)
    assert bool(jd.device_eligible(pc))


@pytest.mark.parametrize("docs", [
    ['{"a":1}garbage', '17 garbage', '"s" x', '{"a":2}'],
    ['{"s": "es\\"caped"}', '{"s": 1}'],
    ['{"a":1', '{"a":2}'],
    ['{"a":1}}', '{"a":2}'],
], ids=["trailing", "escaped", "open", "extra_close"])
def test_ineligible_columns_go_to_the_host_engine(docs, monkeypatch):
    """Both packages call the native host engine here (the port's build
    of it): the same bytes, and the port records the fallback."""
    reference_native(monkeypatch)
    pc, jc = both_strings(docs)
    ref = traced_reference(lambda t: jjd.device_eligible(t.column(0)),
                           JTable([jc]))
    assert not bool(ref)
    assert not bool(jd.device_eligible(pc))
    telemetry.reset()
    assert_same_column(get_json_object(pc, "$.a"),
                       jgoj.get_json_object_host(jc, "$.a"))
    assert telemetry.fallbacks() == {
        ("get_json_object",
         "escaped or malformed documents: escape decoding and full "
         "grammar validation live in the native host engine"):
            {"calls": 1, "rows": len(docs)}}


HOST_PATHS = ["$", "$.sku", "$.meta.w", "$.meta", "$.price", "$['sku']",
              "$.nope", "$[0]"]


@pytest.mark.parametrize("n", EDGE_ROWS)
def test_host_engine_matches_reference(n, monkeypatch):
    """The native engine over bench.py's documents with escapes, the
    malformed shapes and a null tail, from both string layouts."""
    reference_native(monkeypatch)
    docs = bench_json_docs(n)
    bad = ['{"sku":"a\\"b\\u00e9\\n","price":1}', '{"sku":"s1"',
           '{"sku":"s2"}}', '{"sku":"s3"} x', '[1, {"sku": 2}]', '"s"']
    docs = [bad[i % len(bad)] if i % 5 == 0 else d
            for i, d in enumerate(docs)]
    valid = null_tail(n, n)
    pc, jc = both_strings(docs, valid)
    padded = strings.pad_strings(pc)
    for path in HOST_PATHS:
        want = jgoj.get_json_object_host(jc, path)
        assert_same_column(get_json_object_host(pc, path), want)
        assert_same_column(get_json_object_host(padded, path), want)


@pytest.mark.parametrize("path", ["$.a[*]", "no-dollar", "$.*", "$..a",
                                  "$[x]", "$['a'"])
def test_bad_paths_raise_before_engine_choice(path):
    pc, jc = both_strings(['{"a": 1}'])
    with pytest.raises(ValueError):
        jjd.parse_json_path(path)
    with pytest.raises(ValueError):
        get_json_object(pc, path)
    # even where the host engine would be taken
    esc = both_strings(['{"s": "es\\"caped"}'])[0]
    with pytest.raises(ValueError):
        get_json_object(esc, path)
    with pytest.raises(ValueError):
        get_json_object_host(esc, path)


@pytest.mark.parametrize("path", PATHS + [
    "$.z9", "$.b.field", "$.a[2].a", "$['field']", "$['a.b']", "$[12]",
    "$.]x", "$.é"])
def test_parse_json_path_matches_reference(path):
    assert [tuple(s) for s in jd.parse_json_path(path)] == \
        [tuple(s) for s in jjd.parse_json_path(path)]


def test_json_tuple_fields(mixed):
    pc, want, _ = mixed
    a, b = json_tuple(pc, "a", "b")
    assert_same_column(a, want["$.a"])
    assert_same_column(b, want["$.b"])
    small = both_strings(TUPLE_DOCS)[0]
    a, b = json_tuple(small, "a", "b")
    assert a.to_pylist() == ["1", None, None, None]
    assert b.to_pylist() == ["x", "y", None, None]
    with pytest.raises(ValueError, match="at least one"):
        json_tuple(pc)
    for bad in ("a.b", "*", ""):
        with pytest.raises(ValueError, match="plain top-level"):
            json_tuple(pc, bad)


def test_non_string_column_is_refused():
    from spark_rapids_jni_tpu_torch import types as t
    from spark_rapids_jni_tpu_torch.columnar import Column

    col = Column.from_pylist([1, 2], t.INT32, device="cpu")
    with pytest.raises(TypeError):
        get_json_object(col, "$.a")
