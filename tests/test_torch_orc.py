"""The port's ORC reader (``orc/reader.py``) against the JAX package's on
the same file bytes (the tests' pure-Python writer ``tests/orc_util.py``,
and pyarrow where it is installed), both decoding through the library
the port builds: tables byte for byte, the same chunk plans, and the
same classified error (class and ``op``) for malformed and fuzzed
files."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu.orc import reader as jreader
from spark_rapids_jni_tpu.runtime import faults as jfaults
from spark_rapids_jni_tpu_torch.orc import reader as preader
from spark_rapids_jni_tpu_torch.parquet.footer import MalformedFileError
from spark_rapids_jni_tpu_torch.runtime import faults as pfaults
from spark_rapids_jni_tpu_torch.runtime.native import load_native
from tests import orc_util as ou
from torch_parity import (
    EDGE_ROWS,
    assert_same_read,
    assert_same_table,
    read_outcome,
    reference_native,
)


@pytest.fixture(autouse=True)
def _reference_loader(monkeypatch):
    reference_native(monkeypatch)


def both(data, **kw):
    return (read_outcome(lambda: preader.read_table(data, device="cpu",
                                                     **kw)),
            read_outcome(lambda: jreader.read_table(data, **kw)))


def check_same(data, **kw):
    got, want = both(data, **kw)
    assert got[0] == "table", got
    assert_same_read(got, want)
    return got[1]


def all_kind_columns(n: int, seed: int, nulls: bool = True) -> list:
    """One column of every ORC kind the reader maps, negatives
    included: DECIMAL at precision 18 (decimal64) and 30 (decimal128),
    TIMESTAMP before and after the epoch."""
    rng = np.random.default_rng(seed)

    def nz(vals):
        return [None if nulls and rng.random() < 0.2 else v for v in vals]

    def ints(lo, hi):
        return nz([int(x) for x in rng.integers(lo, hi, n)])

    spec = ou.ColumnSpec
    return [
        spec("b", ou.BOOLEAN, nz([bool(x) for x in rng.integers(0, 2, n)])),
        spec("i8", ou.BYTE, ints(-128, 128)),
        spec("i16", ou.SHORT, ints(-2**15, 2**15)),
        spec("i32", ou.INT, ints(-2**31, 2**31)),
        spec("i64", ou.LONG, ints(-2**62, 2**62)),
        spec("f32", ou.FLOAT, nz([float(np.float32(x))
                                  for x in rng.normal(size=n)])),
        spec("f64", ou.DOUBLE, nz([float(x) for x in rng.normal(size=n)])),
        spec("s", ou.STRING, nz([f"orc-{i}-{'y' * (i % 5)}"
                                 for i in range(n)])),
        spec("d", ou.DATE, ints(-20000, 20000)),
        spec("dec", ou.DECIMAL, ints(-10**12, 10**12), precision=18,
             scale=2),
        spec("dec128", ou.DECIMAL, nz([int(v) * 10**12 for v in
                                       rng.integers(-10**12, 10**12, n)]),
             precision=30, scale=4),
        spec("ts", ou.TIMESTAMP, ints(-10**15, 10**15)),
    ]


@pytest.mark.parametrize("codec", [ou.NONE, ou.ZLIB, ou.SNAPPY],
                         ids=["none", "zlib", "snappy"])
@pytest.mark.parametrize("row_index", [False, True],
                         ids=["plain", "row_index"])
def test_every_kind_matches_reference(codec, row_index):
    cols = all_kind_columns(300, seed=codec * 2 + row_index)
    data = ou.write_orc(cols, stripe_size=128, codec=codec,
                        with_row_index=row_index)
    table = check_same(data)
    assert table.num_columns == len(cols)
    assert table.column(10).dtype.is_decimal128


@pytest.mark.parametrize("n", EDGE_ROWS)
def test_edge_row_counts_with_null_tails(n):
    cols = all_kind_columns(n, seed=n)
    tail = max(1, n // 3)
    for c in cols:
        c.values = c.values[:n - tail] + [None] * tail
    check_same(ou.write_orc(cols, stripe_size=1024, codec=ou.ZLIB))


def test_no_nulls_carry_no_validity():
    table = check_same(ou.write_orc(all_kind_columns(200, 3, nulls=False)))
    assert all(c.validity is None for c in table.columns)


def test_map_dtype_matches_reference():
    for kind in (0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 14, 15, 16, 17):
        for prec, scale in ((0, 0), (18, 2), (19, 3), (38, 10)):
            got = preader._map_dtype(kind, scale, prec)
            want = jreader._map_dtype(kind, scale, prec)
            assert (int(got.type_id), got.scale) == \
                (int(want.type_id), want.scale)


def test_stripe_and_column_selection():
    cols = all_kind_columns(400, seed=7)
    data = ou.write_orc(cols, stripe_size=64, codec=ou.SNAPPY)
    assert preader.stripe_info(data) == jreader.stripe_info(data)
    for sel in ([4, 7], [10], [11, 0, 5]):
        check_same(data, columns=sel, stripes=[1, 2, 5])
    assert check_same(data, stripes=[]).num_rows == 0
    assert check_same(data, columns=[]).num_columns == 0


def test_stage_host_then_stage_matches_reference():
    data = ou.write_orc(all_kind_columns(500, seed=9), stripe_size=200,
                        codec=ou.ZLIB)
    chunk = preader.read_table(data, stage="host", device="cpu")
    ref = jreader.read_table(data, stage="host")
    assert (chunk.nbytes, chunk.num_rows) == (ref.nbytes, ref.num_rows)
    assert_same_table(chunk.stage(), ref.stage())


@pytest.mark.parametrize("budget_stripes", [0, 1, 2, 100])
def test_chunk_plans_and_chunks_match_reference(budget_stripes, tmp_path):
    data = ou.write_orc(all_kind_columns(700, seed=11), stripe_size=100,
                        codec=ou.ZLIB)
    f = tmp_path / "t.orc"
    f.write_bytes(data)
    infos = jreader.stripe_info(data)
    budget = sum(b for _, b in infos[:budget_stripes]) or 1
    for src in (data, str(f)):
        prd = preader.OrcChunkedReader(src, budget, columns=[4, 7],
                                       device="cpu")
        jrd = jreader.OrcChunkedReader(data, budget, columns=[4, 7])
        assert prd.chunk_plan() == jrd.chunk_plan()
        for p, j in zip(list(prd), list(jrd), strict=True):
            assert_same_table(p, j)
    srcs = preader.OrcChunkedReader(data, budget, device="cpu") \
        .chunk_sources()
    jsrcs = jreader.OrcChunkedReader(data, budget).chunk_sources()
    for p, j in zip(srcs, jsrcs, strict=True):
        assert_same_table(p().stage(), j().stage())


def test_writer_time_zones_match_reference():
    """Stripes that agree on a non-UTC zone convert through pyarrow's tz
    database in both packages; stripes that disagree, and an unknown
    zone, fail alike."""
    pytest.importorskip("pyarrow")
    vals = [0, 1_000_000, -86_400_000_123, 1_626_350_400_500_000]
    for tz in ("America/New_York", ["UTC", "UTC"], "Etc/UTC",
               ["America/New_York", "Europe/Berlin"],
               [None, "Europe/Berlin"]):
        data = ou.write_orc([ou.ColumnSpec("ts", ou.TIMESTAMP, vals)],
                            stripe_size=2, writer_timezone=tz)
        assert_same_read(*both(data))
    data = ou.write_orc([ou.ColumnSpec("ts", ou.TIMESTAMP, vals)],
                        writer_timezone="Not/A_Zone")
    got, want = both(data)
    assert got == want and got[0] == "error"
    conflict = ou.write_orc([ou.ColumnSpec("ts", ou.TIMESTAMP, vals)],
                            stripe_size=2,
                            writer_timezone=[None, "Europe/Berlin"])
    with pytest.raises(MalformedFileError, match="disagree"):
        preader.OrcChunkedReader(conflict, 1, device="cpu")


def _valid_file():
    return ou.write_orc(all_kind_columns(64, seed=13), stripe_size=32)


@pytest.mark.parametrize("mutate", [
    lambda b: b[:5], lambda b: b"XXX" + b[3:], lambda b: b[:-4] + b"XXX"
    + b[-1:], lambda b: b[:-1] + b"\x00", lambda b: b[:-1] + b"\xff",
    lambda b: b[: len(b) // 2], lambda b: b[:100] + bytes(len(b) - 100),
    lambda b: b""],
    ids=["short", "lead_magic", "tail_magic", "ps_len_zero", "ps_len_big",
         "truncated", "zeroed_tail", "empty"])
def test_malformed_files_raise_the_reference_error(mutate):
    data = mutate(_valid_file())
    got, want = both(data)
    assert got == want
    assert got[0] == "error" and got[1] == "MalformedFileError", got


MODES = ("flip", "truncate", "trailer")


@pytest.mark.parametrize("case", range(20))
def test_fuzzed_files_match_reference(case):
    """The reference's ingest fuzz cases (seed 500 + case) as parity."""
    data = ou.write_orc([ou.ColumnSpec("a", ou.LONG, list(range(48)))])
    mode, seed = MODES[case % 3], 500 + case

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
    preader.read_table(_valid_file(), device="cpu")
    preader.OrcChunkedReader(_valid_file(), 1, device="cpu")
    with pytest.raises(MalformedFileError):
        preader.read_table(_valid_file()[: 300], device="cpu")
    assert lib.tpudf_open_handles() == before


def test_device_none_refuses_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None selects it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        preader.read_table(_valid_file())


def _arrow_orc(table):
    import io

    import pyarrow.orc as po

    buf = io.BytesIO()
    po.write_table(table, buf)
    return buf.getvalue()


def _arrow_columns(pa, n: int) -> dict:
    import decimal

    rng = np.random.default_rng(17)
    return {
        "i": pa.array([int(v) if v % 7 else None
                       for v in rng.integers(-10**12, 10**12, n)]),
        "s": pa.array([f"v{i}" * (i % 4) if i % 5 else None
                       for i in range(n)]),
        "bin": pa.array([bytes([i % 256, 0, 255]) for i in range(n)]),
        "ts": pa.array(rng.integers(-10**15, 10**15, n).astype(
            "datetime64[us]")),
        "d128": pa.array([decimal.Decimal(int(v)).scaleb(-3) * 10**15
                          for v in rng.integers(-10**6, 10**6, n)],
                         type=pa.decimal128(30, 3)),
        "d64": pa.array([decimal.Decimal(int(v)).scaleb(-2)
                         for v in rng.integers(-10**6, 10**6, n)],
                        type=pa.decimal128(10, 2))}


@pytest.mark.parametrize("name", ["i", "s", "bin", "ts", "d128", "d64"])
def test_pyarrow_written_files(name):
    """One pyarrow-written column a file (RLEv2 runs, dictionary strings,
    BINARY, TIMESTAMP, both decimal widths); the same table in both
    packages."""
    pa = pytest.importorskip("pyarrow")
    check_same(_arrow_orc(pa.table({name: _arrow_columns(pa, 3000)[name]})))


def test_pyarrow_multi_column_file_alike():
    """pyarrow's file of all six columns together: both packages give
    the same outcome (the native engine refuses its layout: recorded in
    ROADMAP.md Queue 3)."""
    pa = pytest.importorskip("pyarrow")
    assert_same_read(*both(_arrow_orc(pa.table(_arrow_columns(pa, 3000)))))
