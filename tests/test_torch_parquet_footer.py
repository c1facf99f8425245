"""The port's ParquetFooter (``parquet/footer.py``) against the JAX
package's over footers synthesized with the tests' thrift codec
(``tests/thrift_util.py``): the same row and column counts after each
prune and row-group filter, byte-identical ``serialize_thrift_file``
output, and the same classified error (class and ``op``) for malformed
footers. Both run the library the port builds."""

from __future__ import annotations

import pytest

import tests.thrift_util as tu
from spark_rapids_jni_tpu.parquet import ParquetFooter as JFooter
from spark_rapids_jni_tpu_torch import telemetry
from spark_rapids_jni_tpu_torch.parquet import ParquetFooter
from spark_rapids_jni_tpu_torch.parquet.footer import (
    MalformedFileError,
    NativeError,
)
from spark_rapids_jni_tpu_torch.errors import MalformedInputError
from spark_rapids_jni_tpu_torch.runtime.native import load_native
from torch_parity import read_outcome, reference_native


@pytest.fixture(autouse=True)
def _reference_loader(monkeypatch):
    reference_native(monkeypatch)


def _flat_footer(names=("a", "b", "c"), groups=2, rows_per_group=50):
    schema = [tu.schema_element("root", num_children=len(names))]
    for n in names:
        schema.append(tu.schema_element(n, type_=1))
    rgs = []
    off = 4
    for _ in range(groups):
        chunks = []
        for n in names:
            chunks.append(tu.column_chunk(off, 1000, path=(n,)))
            off += 1000
        rgs.append(tu.row_group(chunks, rows_per_group,
                                total_compressed=1000 * len(names)))
    return tu.file_metadata(schema, rgs,
                            column_orders=[{} for _ in names])


def _nested_footer():
    schema = [
        tu.schema_element("root", num_children=2),
        tu.schema_element("s", num_children=2),
        tu.schema_element("x", type_=1),
        tu.schema_element("y", type_=1),
        tu.schema_element("z", type_=1),
    ]
    chunks = [tu.column_chunk(4, 1000, path=("s", "x")),
              tu.column_chunk(1004, 1000, path=("s", "y")),
              tu.column_chunk(2004, 1000, path=("z",))]
    return tu.file_metadata(
        schema, [tu.row_group(chunks, 10, total_compressed=3000)])


def _fallback_footer():
    schema = [tu.schema_element("root", num_children=1),
              tu.schema_element("a", type_=1)]
    return tu.file_metadata(schema, [
        tu.row_group([tu.column_chunk(4, 1000)], 10, file_offset=999,
                     total_compressed=1000, with_meta=False),
        tu.row_group([tu.column_chunk(1004, 1000)], 20, file_offset=100,
                     total_compressed=1000, with_meta=False)])


def _dictionary_footer():
    schema = [tu.schema_element("root", num_children=1),
              tu.schema_element("a", type_=1)]
    return tu.file_metadata(schema, [tu.row_group(
        [tu.column_chunk(1000, 2000, dict_page_offset=4)], 10,
        total_compressed=2000)])


def _unknown_fields_footer():
    schema = [tu.schema_element("root", num_children=1),
              tu.schema_element("a", type_=1)]
    return tu.file_metadata(
        schema, [tu.row_group([tu.column_chunk(4, 100)], 5,
                              total_compressed=100)],
        extra={9: (tu.BINARY, b"\x01\x02\x03"), 6: (tu.BINARY, "keep-me")})


FOOTERS = {
    "flat": _flat_footer,
    "flat_unicode": lambda: _flat_footer(names=("MiXeD", "Straße", "ΣΊΓΜΑ")),
    "nested": _nested_footer,
    "fallback_2078": _fallback_footer,
    "dictionary_offset": _dictionary_footer,
    "unknown_fields": _unknown_fields_footer,
}

# (footer, part_offset, part_length, names, num_children, parent, ignore)
CASES = [
    ("flat", 0, -1, ["c", "a"], [0, 0], 2, False),
    ("flat", 0, -1, ["a", "nope", "b"], [0, 0, 0], 3, False),
    ("flat", 0, 3000, ["a"], [0], 1, False),
    ("flat", 3000, 5000, ["a"], [0], 1, False),
    ("flat", 0, 10_000, ["a", "b", "c"], [0, 0, 0], 3, False),
    ("flat", 9000, 100, ["a"], [0], 1, False),
    ("flat", 0, 3000, ["c"], [0], 1, False),
    ("flat", 3000, 3000, ["c"], [0], 1, False),
    ("flat_unicode", 0, -1, ["mixed", "straße", "σίγμα"], [0, 0, 0], 3,
     True),
    ("flat_unicode", 0, -1, ["mixed"], [0], 1, False),
    ("flat_unicode", 0, -1, ["ΣΊΓΜΑ"], [0], 1, True),
    ("nested", 0, -1, ["s", "y", "z"], [1, 0, 0], 2, False),
    ("nested", 0, -1, ["s", "x", "y"], [2, 0, 0], 1, False),
    ("fallback_2078", 0, 1000, ["a"], [0], 1, False),
    ("fallback_2078", 1000, 1000, ["a"], [0], 1, False),
    ("dictionary_offset", 0, 1500, ["a"], [0], 1, False),
    ("dictionary_offset", 1500, 1000, ["a"], [0], 1, False),
    ("unknown_fields", 0, -1, ["a"], [0], 1, False),
]


def _run(cls, buf, *args, ignore=False):
    with cls.read_and_filter(buf, *args, ignore_case=ignore) as f:
        return f.num_rows, f.num_columns, f.serialize_thrift_file()


@pytest.mark.parametrize("case", CASES,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(CASES)])
def test_prune_and_filter_match_reference(case):
    name, off, length, names, kids, parent, ignore = case
    buf = FOOTERS[name]()
    got = _run(ParquetFooter, buf, off, length, names, kids, parent,
               ignore=ignore)
    want = _run(JFooter, buf, off, length, names, kids, parent,
                ignore=ignore)
    assert got[:2] == want[:2]
    assert got[2] == want[2]  # serialized bytes, byte for byte
    framed = got[2]
    assert framed[:4] == b"PAR1" and framed[-4:] == b"PAR1"
    assert int.from_bytes(framed[-8:-4], "little") == len(framed) - 12
    # the serialized footer re-parses to the same counts
    with ParquetFooter.read_and_filter(framed[4:-8], 0, -1, names, kids,
                                       parent, ignore_case=ignore) as again:
        assert again.num_columns == got[1]


@pytest.mark.parametrize("buf,args", [
    (b"\x19\x19\x19\x19", (0, -1, ["a"], [0], 1)),
    (bytes([0x18]) + b"\xc0\x9a\x8c\x60", (0, -1, ["a"], [0], 1)),
    (b"", (0, -1, ["a"], [0], 1)),
    (b"\x00", (-5, -1, ["a"], [0], 1)),
    (b"\x15\x02", (0, -1, ["a"], [0], 1)),
], ids=["garbage", "string_bomb", "empty", "negative_offset", "truncated"])
def test_malformed_footers_raise_the_reference_error(buf, args):
    got = read_outcome(lambda: ParquetFooter.read_and_filter(buf, *args))
    want = read_outcome(lambda: JFooter.read_and_filter(buf, *args))
    assert got[0] == "error" and got == want
    telemetry.reset()
    with pytest.raises(MalformedFileError) as err:
        ParquetFooter.read_and_filter(buf, *args)
    # classified input fault and the engine's error at once
    assert isinstance(err.value, MalformedInputError)
    assert isinstance(err.value, NativeError)
    assert telemetry.counter(
        f"integrity.malformed.{err.value.context['op']}") == 1


def test_argument_errors_and_closed_footer():
    with pytest.raises(ValueError, match="equal length"):
        ParquetFooter.read_and_filter(_flat_footer(), 0, -1, ["a"], [], 1)
    f = ParquetFooter.read_and_filter(_flat_footer(), 0, -1, ["a"], [0], 1)
    f.close()
    with pytest.raises(ValueError, match="closed"):
        _ = f.num_rows
    with pytest.raises(ValueError, match="closed"):
        f.serialize_thrift_file()
    f.close()  # a second close is fine


def test_no_handle_leaks():
    lib = load_native()
    before = lib.tpudf_open_handles()
    for _ in range(10):
        with ParquetFooter.read_and_filter(_flat_footer(), 0, -1, ["a"],
                                           [0], 1) as f:
            _ = f.num_rows
    assert lib.tpudf_open_handles() == before
    assert lib.tpudf_footer_num_rows(987654321) == -1
    assert "invalid footer handle" in lib.last_error()
