"""The port's Parquet reader (``parquet/reader.py``, ``parquet/nested.py``)
against the JAX package's, on the same file bytes: the files come from
the tests' pure-Python writer (``tests/parquet_util.py``) and, where
pyarrow is installed, from pyarrow; both packages decode them through
one native library, the one the port builds (``reference_native``
points the reference's loader at it for each test). Tables compare byte
for byte: types, data under nulls too, validity, string offsets and
chars, DECIMAL128 limbs, LIST offsets and children. Malformed and
fuzzed files raise the same classified error with the same ``op``, or
decode to the same table."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu.parquet import reader as jreader
from spark_rapids_jni_tpu.runtime import faults as jfaults
from spark_rapids_jni_tpu.utils import config as jconfig
from spark_rapids_jni_tpu_torch import telemetry
from spark_rapids_jni_tpu_torch.parquet import reader as preader
from spark_rapids_jni_tpu_torch.parquet.footer import MalformedFileError
from spark_rapids_jni_tpu_torch.runtime import faults as pfaults
from spark_rapids_jni_tpu_torch.runtime.native import load_native
from spark_rapids_jni_tpu_torch.utils import config as pconfig
from tests import parquet_util as pq
from torch_parity import (
    EDGE_ROWS,
    assert_same_array,
    assert_same_read,
    assert_same_table,
    read_outcome,
    reference_native,
)

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _reference_loader(monkeypatch):
    reference_native(monkeypatch)


def both(data, **kw):
    """(port outcome, reference outcome) of one read of ``data``."""
    return (read_outcome(lambda: preader.read_table(data, device="cpu",
                                                     **kw)),
            read_outcome(lambda: jreader.read_table(data, **kw)))


def check_same(data, **kw):
    got, want = both(data, **kw)
    assert got[0] == "table", got
    assert_same_read(got, want)
    return got[1]


def _nulls(rng, vals, share=0.2):
    return [None if rng.random() < share else v for v in vals]


def all_type_columns(n: int, seed: int, nulls: bool = True,
                     dictionary: bool = False) -> list:
    """One column of every physical and converted type ``_map_dtype``
    maps, negatives included; DECIMAL FLBA at 4 to 16 bytes."""
    rng = np.random.default_rng(seed)

    def nz(vals):
        return _nulls(rng, vals) if nulls else list(vals)

    def ints(lo, hi):
        return nz([int(x) for x in rng.integers(lo, hi, n)])

    spec = pq.ColumnSpec
    cols = [
        spec("b", pq.BOOLEAN, nz([bool(x) for x in rng.integers(0, 2, n)])),
        spec("i32", pq.INT32, ints(-2**31, 2**31 - 1)),
        spec("i8", pq.INT32, ints(-128, 128), converted=15),
        spec("i16", pq.INT32, ints(-2**15, 2**15), converted=16),
        spec("u8", pq.INT32, ints(0, 256), converted=11),
        spec("u16", pq.INT32, ints(0, 2**16), converted=12),
        spec("u32", pq.INT32, ints(-2**31, 2**31 - 1), converted=13),
        spec("i32c", pq.INT32, ints(-2**31, 2**31 - 1), converted=17),
        spec("date", pq.INT32, ints(-30000, 30000), converted=6),
        spec("d32", pq.INT32, ints(-10**9, 10**9), converted=5, scale=2,
             precision=9),
        spec("i64", pq.INT64, ints(-2**62, 2**62)),
        spec("u64", pq.INT64, ints(-2**62, 2**62), converted=14),
        spec("i64c", pq.INT64, ints(-2**62, 2**62), converted=18),
        spec("ts_ms", pq.INT64, ints(-10**13, 10**13), converted=9),
        spec("ts_us", pq.INT64, ints(-10**16, 10**16), converted=10),
        spec("d64", pq.INT64, ints(-10**17, 10**17), converted=5, scale=4,
             precision=18),
        spec("f32", pq.FLOAT, nz([float(np.float32(x))
                                  for x in rng.normal(size=n)])),
        spec("f64", pq.DOUBLE, nz([float(x) for x in rng.normal(size=n)])),
        spec("s", pq.BYTE_ARRAY, nz([f"row-{i}-{'x' * (i % 9)}"
                                     for i in range(n)]), converted=0),
    ]
    for width in (4, 7, 8, 9, 12, 15, 16):
        bound = 2 ** (8 * width - 1)
        vals = [int(v) for v in rng.integers(-2**62, 2**62, n)]
        vals = [v * (bound >> 62) if width > 8 else v % bound - bound // 2
                for v in vals]
        vals[0] = -bound  # the most negative value of the width
        if n > 1:
            vals[1] = bound - 1
        cols.append(spec(f"flba{width}", pq.FLBA, nz(vals), converted=5,
                         scale=3, precision=min(38, 2 * width + 1),
                         type_length=width))
    for c in cols:
        c.use_dictionary = dictionary and c.physical != pq.BOOLEAN
    return cols


@pytest.mark.parametrize("codec", [pq.UNCOMPRESSED, pq.SNAPPY, pq.GZIP],
                         ids=["uncompressed", "snappy", "gzip"])
@pytest.mark.parametrize("v2", [False, True], ids=["v1", "v2"])
@pytest.mark.parametrize("dictionary", [False, True],
                         ids=["plain", "dictionary"])
def test_every_type_matches_reference(codec, v2, dictionary):
    cols = all_type_columns(300, seed=codec * 4 + v2 * 2 + dictionary,
                            dictionary=dictionary)
    data = pq.write_parquet(cols, row_group_size=128, codec=codec,
                            page_rows=50, data_page_v2=v2)
    table = check_same(data)
    assert table.num_columns == len(cols)


@pytest.mark.parametrize("n", EDGE_ROWS)
def test_edge_row_counts_with_null_tails(n):
    cols = all_type_columns(n, seed=n)
    tail = max(1, n // 3)
    for c in cols:  # a null tail: the last third of every column
        c.values = c.values[:n - tail] + [None] * tail
    data = pq.write_parquet(cols, row_group_size=1024, codec=pq.SNAPPY,
                            page_rows=256)
    check_same(data)


def test_required_columns_carry_no_validity():
    cols = all_type_columns(200, seed=5, nulls=False)
    for c in cols:
        c.optional = False
    table = check_same(pq.write_parquet(cols))
    assert all(c.validity is None for c in table.columns)


def test_map_dtype_matches_reference():
    from spark_rapids_jni_tpu.parquet.reader import _map_dtype as jmap

    for phys in (0, 1, 2, 4, 5, 6, 7):
        for conv in (-1, 0, 5, 6, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18):
            for tlen in (0, 4, 8, 9, 16, 17):
                got = read_outcome(
                    lambda: preader._map_dtype(phys, conv, 3, tlen))
                want = read_outcome(lambda: jmap(phys, conv, 3, tlen))
                assert got[0] == want[0], (phys, conv, tlen)
                if got[0] == "table":
                    assert (int(got[1].type_id), got[1].scale) == \
                        (int(want[1].type_id), want[1].scale)
                else:
                    assert got == want


@pytest.mark.parametrize("width", range(1, 17))
def test_flba_widening_is_bit_identical(width):
    rng = np.random.default_rng(width)
    raw = rng.integers(0, 256, 1000 * width).astype(np.uint8)
    raw[:width] = 0x80  # the most negative value
    raw[width:2 * width] = 0xFF  # -1
    raw[2 * width:3 * width] = 0x7F
    t = torch.from_numpy(raw)
    if width <= 8:
        assert_same_array(preader._flba_to_int64(t, width).numpy(),
                          jreader._flba_to_int64(raw, width), "int64")
    if width >= 9:
        assert_same_array(preader._flba_to_int128(t, width).numpy(),
                          jreader._flba_to_int128(raw, width), "int128")


def test_column_and_row_group_selection():
    cols = all_type_columns(400, seed=9)
    data = pq.write_parquet(cols, row_group_size=64, codec=pq.SNAPPY)
    assert preader.row_group_info(data) == jreader.row_group_info(data)
    for sel in ([1, 18], [0], [20, 3, 10]):
        check_same(data, columns=sel, row_groups=[1, 2, 6])
    check_same(data, row_groups=[5])
    empty_rgs = check_same(data, row_groups=[])
    assert empty_rgs.num_rows == 0
    assert check_same(data, columns=[]).num_columns == 0


def test_stage_host_then_stage_matches_reference():
    cols = all_type_columns(500, seed=11)
    data = pq.write_parquet(cols, row_group_size=200, codec=pq.GZIP)
    chunk = preader.read_table(data, stage="host", device="cpu")
    ref = jreader.read_table(data, stage="host")
    assert (chunk.nbytes, chunk.num_rows) == (ref.nbytes, ref.num_rows)
    assert_same_table(chunk.stage(), ref.stage())


@pytest.mark.parametrize("budget_groups", [0, 1, 2, 3, 100])
def test_chunk_plans_and_chunks_match_reference(budget_groups):
    cols = all_type_columns(700, seed=13)
    data = pq.write_parquet(cols, row_group_size=100, codec=pq.SNAPPY)
    infos = jreader.row_group_info(data)
    budget = sum(b for _, b in infos[:budget_groups]) or 1
    prd = preader.ParquetChunkedReader(data, budget, columns=[1, 18, 2],
                                       device="cpu")
    jrd = jreader.ParquetChunkedReader(data, budget, columns=[1, 18, 2])
    assert prd.chunk_plan() == jrd.chunk_plan()
    pchunks, jchunks = list(prd), list(jrd)
    assert len(pchunks) == len(jchunks)
    for p, j in zip(pchunks, jchunks):
        assert_same_table(p, j)
    # host-staged thunks: the same chunks after stage()
    srcs = preader.ParquetChunkedReader(data, budget, device="cpu") \
        .chunk_sources()
    jsrcs = jreader.ParquetChunkedReader(data, budget).chunk_sources()
    assert len(srcs) == len(jsrcs)
    for p, j in zip(srcs, jsrcs):
        assert_same_table(p().stage(), j().stage())


def test_path_reads_match_bytes_reads(tmp_path):
    cols = all_type_columns(333, seed=17)
    data = pq.write_parquet(cols, row_group_size=100, codec=pq.SNAPPY)
    f = tmp_path / "t.parquet"
    f.write_bytes(data)
    assert preader.row_group_info(str(f)) == jreader.row_group_info(data)
    check_same(str(f))
    check_same(f, columns=[4, 18], row_groups=[0, 3])
    got, want = both(str(tmp_path / "missing.parquet"))
    assert got == want and got[1] == "MalformedFileError"


def test_domain_from_parquet_matches_reference(tmp_path):
    from spark_rapids_jni_tpu.ops.planner import (
        domain_from_parquet as jdomain,
    )
    from spark_rapids_jni_tpu_torch.ops.planner import domain_from_parquet

    rng = np.random.default_rng(19)
    cols = [pq.ColumnSpec("flag", pq.INT32, _nulls(rng, [
                int(v) for v in rng.choice([65, 78, 82], 600)]),
                converted=15),
            pq.ColumnSpec("wide", pq.INT64, [
                int(v) for v in rng.integers(0, 10**6, 600)]),
            pq.ColumnSpec("s", pq.BYTE_ARRAY, _nulls(rng, [
                f"k{int(v)}" for v in rng.integers(0, 7, 600)]),
                converted=0)]
    f = tmp_path / "d.parquet"
    f.write_bytes(pq.write_parquet(cols, row_group_size=200))
    for column, cap, groups in ((0, 1024, 1), (1, 1024, 1), (1, 10**6, 3),
                                (2, 1024, 2), (2, 3, 1)):
        got = domain_from_parquet(str(f), column, max_size=cap,
                                  sample_row_groups=groups, device="cpu")
        want = jdomain(str(f), column, max_size=cap,
                       sample_row_groups=groups)
        assert (got is None) == (want is None)
        if got is not None:
            assert (tuple(got.values), got.kind, got.source) == \
                (tuple(want.values), want.kind, want.source)


def _valid_file():
    return pq.write_parquet(all_type_columns(64, seed=23),
                            row_group_size=32)


@pytest.mark.parametrize("mutate", [
    lambda b: b[:5], lambda b: b"XXXX" + b[4:], lambda b: b[:-4] + b"XXXX",
    lambda b: b[:-8] + (10**6).to_bytes(4, "little") + b[-4:],
    lambda b: b[:-8] + (0).to_bytes(4, "little") + b[-4:],
    lambda b: b[: len(b) // 2] + b[-8:],
    lambda b: b[:200] + bytes(len(b) - 208) + b[-8:],
    lambda b: b"",
], ids=["short", "lead_magic", "tail_magic", "footer_len_big",
        "footer_len_zero", "truncated_body", "zeroed_body", "empty"])
def test_malformed_files_raise_the_reference_error(mutate):
    data = mutate(_valid_file())
    got, want = both(data)
    assert got == want
    assert got[0] == "error" and got[1] == "MalformedFileError", got
    with pytest.raises(MalformedFileError):
        preader.read_table(data, device="cpu")


def test_malformed_counts_and_integrity_off():
    data = _valid_file()[:-4] + b"XXXX"
    telemetry.reset()
    with pytest.raises(MalformedFileError) as err:
        preader.read_table(data, device="cpu")
    assert err.value.context["op"] == "parquet.envelope"
    assert telemetry.counter("integrity.malformed") == 1
    assert telemetry.counter("integrity.malformed.parquet.envelope") == 1
    # with validation off the preflight is skipped: the native parse
    # rejects the bytes in both packages alike
    pconfig.set_option("integrity.enabled", False)
    jconfig.set_option("integrity.enabled", False)
    try:
        got, want = both(data)
        assert got == want
    finally:
        pconfig.reset_option("integrity.enabled")
        jconfig.reset_option("integrity.enabled")


MODES = ("flip", "truncate", "trailer")


@pytest.mark.parametrize("case", range(20))
def test_fuzzed_files_match_reference(case):
    """The reference's ingest fuzz cases (seed 400 + case) as parity: a
    seeded mutation of the file is classified, refused or decoded alike
    by both packages."""
    data = pq.write_parquet([
        pq.ColumnSpec("a", pq.INT64, list(range(48))),
        pq.ColumnSpec("b", pq.DOUBLE, [i / 7 for i in range(48)])])
    mode, seed = MODES[case % 3], 400 + case

    def script():
        return jfaults.FaultScript(corruptions=[jfaults.CorruptionSpec(
            "integrity.ingest", mode=mode, seed=seed)])

    with pfaults.inject(script()):
        got = read_outcome(lambda: preader.read_table(data, device="cpu"))
    with jfaults.inject(script()):
        want = read_outcome(lambda: jreader.read_table(data))
    assert_same_read(got, want)


def test_no_handle_leaks():
    lib = load_native()
    before = lib.tpudf_open_handles()
    data = _valid_file()
    preader.read_table(data, device="cpu")
    preader.read_table(data, stage="host", device="cpu")
    with pytest.raises(MalformedFileError):
        preader.read_table(data[:-4] + b"XXXX", device="cpu")
    assert lib.tpudf_open_handles() == before


def test_device_none_refuses_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None selects it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        preader.read_table(_valid_file())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        preader.ParquetChunkedReader(_valid_file(), 1)


def test_tpch_q1_from_parquet_equals_in_memory():
    from spark_rapids_jni_tpu_torch import types as t
    from spark_rapids_jni_tpu_torch.columnar import Column, Table
    from spark_rapids_jni_tpu_torch.models import tpch

    li = tpch.lineitem_table(1500, seed=21, device="cpu")
    host = [c.data.numpy() for c in li.columns]
    cols = [pq.ColumnSpec(nm, pq.INT64, [int(v) for v in host[i]])
            for i, nm in enumerate(("q", "p", "d", "t"))]
    cols += [pq.ColumnSpec(nm, pq.INT32, [int(v) for v in host[i]],
                           converted=15, use_dictionary=True)
             for i, nm in ((4, "rf"), (5, "ls"))]
    cols.append(pq.ColumnSpec("ship", pq.INT32, [int(v) for v in host[6]],
                              converted=6, use_dictionary=True))
    data = pq.write_parquet(cols, row_group_size=512, codec=pq.SNAPPY)
    read = check_same(data)
    money = t.decimal64(-2)
    retyped = Table([Column(money, c.data, c.validity) if i < 4 else c
                     for i, c in enumerate(read.columns)])
    assert retyped.schema() == li.schema()
    got = tpch.tpch_q1_planned_result(retyped)
    want = tpch.tpch_q1_planned_result(li)
    assert torch.equal(got.present, want.present)
    assert got.table.equals(want.table)


# ---- pyarrow-written files: ZSTD, DELTA encodings, DECIMAL128, LIST --------


def _arrow_bytes(table, **kwargs):
    import io

    import pyarrow.parquet as apq

    buf = io.BytesIO()
    apq.write_table(table, buf, **kwargs)
    return buf.getvalue()


@pytest.fixture
def pa():
    return pytest.importorskip("pyarrow")


def test_zstd_pages(pa):
    rng = np.random.default_rng(31)
    n = 2000
    data = _arrow_bytes(pa.table({
        "a": pa.array(rng.integers(-10**9, 10**9, n)),
        "b": pa.array([f"row_{i}" if i % 7 else None for i in range(n)])}),
        compression="zstd")
    check_same(data)


@pytest.mark.parametrize("encoding,kind", [
    ("DELTA_BINARY_PACKED", "int32"), ("DELTA_BINARY_PACKED", "int64"),
    ("DELTA_LENGTH_BYTE_ARRAY", "string"), ("DELTA_BYTE_ARRAY", "string")])
def test_delta_encodings(pa, encoding, kind):
    rng = np.random.default_rng(37)
    if kind == "string":
        vals = [f"prefix/shared/{int(k):05d}" + "x" * int(k % 5)
                if k % 11 else None for k in np.sort(
                    rng.integers(0, 10**5, 900))]
        arr = pa.array(vals)
    else:
        vals = np.sort(rng.integers(-50_000, 50_000, 3000))
        vals[::97] = rng.integers(-50_000, 50_000, len(vals[::97]))
        arr = pa.array([int(v) if i % 13 else None
                        for i, v in enumerate(vals)], type=getattr(pa, kind)())
    data = _arrow_bytes(pa.table({"v": arr}), use_dictionary=False,
                        column_encoding={"v": encoding})
    check_same(data)


def test_wide_decimals(pa):
    import decimal

    vals = [decimal.Decimal(v).scaleb(-4) for v in [
        0, 1, -1, 10**25, -(10**25), 2**64, -(2**64) - 7, 1 << 100,
        -(1 << 100)]] + [None]
    nine = [decimal.Decimal(v) for v in
            [1 << 66, -(1 << 66), 0, -1, 12345678901234567890]] \
        + [None] * 5
    data = _arrow_bytes(pa.table({
        "d38": pa.array(vals, type=pa.decimal128(38, 4)),
        "d20": pa.array(nine, type=pa.decimal128(20, 0)),
        "d10": pa.array([decimal.Decimal("12.34")] * 9 + [None],
                        type=pa.decimal128(10, 2))}))
    table = check_same(data)
    assert table.column(0).dtype.is_decimal128


@pytest.mark.parametrize("case", ["ints", "strings", "multi_row_group"])
def test_list_columns(pa, case):
    rng = np.random.default_rng(41)
    if case == "ints":
        arr = pa.array([[1, 2, 3], [], None, [4], [None, 5],
                        list(range(50))], type=pa.list_(pa.int64()))
        kw = {}
    elif case == "strings":
        arr = pa.array([["a", "bb"], None, [], ["", None, "xyz"]],
                       type=pa.list_(pa.string()))
        kw = {}
    else:
        arr = pa.array([None if i % 17 == 0 else
                        [int(v) for v in rng.integers(
                            0, 100, int(rng.integers(0, 6)))]
                        for i in range(3000)], type=pa.list_(pa.int32()))
        kw = {"row_group_size": 512}
    n = len(arr)
    data = _arrow_bytes(pa.table({"l": arr, "flat": pa.array(range(n))}),
                        **kw)
    table = check_same(data)
    assert table.column(0).dtype.is_list
    assert table.column(0).to_pylist() == arr.to_pylist()


def test_struct_columns_wait_for_their_column(pa):
    """STRUCT files read alike in both packages: the reference's nested
    STRUCT cases (``tests/test_parquet_breadth.py``), written by pyarrow
    as that file writes them."""
    rng = np.random.default_rng(7)
    n = 500
    a = [int(v) if i % 6 else None
         for i, v in enumerate(rng.integers(0, 1000, n))]
    structs = [None if i % 11 == 0 else {"a": a[i], "b": f"s{i}"}
               for i in range(n)]
    flat = _arrow_bytes(pa.table({
        "s": pa.array(structs, type=pa.struct([("a", pa.int64()),
                                               ("b", pa.string())])),
        "flat": pa.array(range(n))}))
    table = check_same(flat)
    assert table.column(0).to_pylist() == [
        None if s is None else (s["a"], s["b"]) for s in structs]
    assert table.column(1).to_pylist() == list(range(n))
    vals = [{"inner": {"x": 1}, "y": 10}, {"inner": None, "y": 20}, None,
            {"inner": {"x": None}, "y": None}]
    typ = pa.struct([("inner", pa.struct([("x", pa.int32())])),
                     ("y", pa.int64())])
    nested = _arrow_bytes(pa.table({"s": pa.array(vals, type=typ)}))
    table = check_same(nested)
    assert table.column(0).to_pylist() == [((1,), 10), (None, 20), None,
                                           ((None,), None)]
    # a STRUCT holding a LIST raises in both
    with_list = _arrow_bytes(pa.table({"s": pa.array(
        [{"l": [1, 2]}, None], type=pa.struct([("l", pa.list_(
            pa.int64()))]))}))
    got, want = both(with_list)
    assert got == want and got[1] == "NotImplementedError"


def test_unsupported_nested_shapes_raise_alike(pa):
    data = _arrow_bytes(pa.table({"l": pa.array(
        [[{"x": 1}], None], type=pa.list_(pa.struct([("x", pa.int32())])))}))
    got, want = both(data)
    assert got == want and got[1] == "NotImplementedError"
    lists = _arrow_bytes(pa.table({"l": pa.array([[1], None]),
                                   "f": pa.array([1, 2])}))
    for kw in ({"stage": "host"}, {"columns": [1]}):
        got, want = both(lists, **kw)
        assert got == want and got[1] == "NotImplementedError"
