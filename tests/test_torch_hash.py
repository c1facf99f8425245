"""The port's Spark row hash (``ops/hash.py``) and string byte hash
(``ops/strings.py``) against the JAX package on the CPU, bit for bit:
hashInt and hashLong over the int64 extremes; ``table_xxhash64`` over
every type the hash takes (-0.0, NaN payloads, the INT64/UINT64
extremes, DECIMAL128 at its byte-image edges, strings of 0 to 70 bytes)
chained with null tails at the reference's edge row counts; every type
alone; ``partition_hash`` with 1, 7 and 200 partitions. The string hash
is also held to the independent pure-Python XXH64 of ``xxh64_ref``."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from spark_rapids_jni_tpu.ops import hash as jhash
from spark_rapids_jni_tpu.ops import strings as jstrings
from spark_rapids_jni_tpu_torch import types as t
from spark_rapids_jni_tpu_torch.columnar import Column, Table
from spark_rapids_jni_tpu_torch.interop import table_from_numpy
from spark_rapids_jni_tpu_torch.ops import hash as phash
from spark_rapids_jni_tpu_torch.ops import strings as pstrings
from torch_parity import (
    DEC128_EDGES,
    EDGE_ROWS,
    assert_same_array,
    dec128_limbs,
    hash_host_columns,
    jax_table,
    seeded_bytes,
)
from xxh64_ref import xxh64


def _bits(x) -> np.ndarray:
    """A reference uint64 (or int64) hash as its int64 bits."""
    return np.asarray(x).view(np.int64)


def _both(columns):
    return table_from_numpy(columns, device="cpu"), jax_table(columns)


@pytest.mark.parametrize("n", EDGE_ROWS)
def test_xxhash64_long_and_int_match_reference(n):
    rng = np.random.default_rng(n)
    v = rng.integers(-2**63, 2**63 - 1, n, dtype=np.int64, endpoint=True)
    v[:2] = np.array([-2**63, 2**63 - 1], np.int64)[:n]
    seeds = rng.integers(-2**63, 2**63 - 1, n, dtype=np.int64)
    got = phash.xxhash64_long(torch.from_numpy(v), torch.from_numpy(seeds))
    want = jhash.xxhash64_long(jnp.asarray(v), jnp.asarray(seeds))
    assert_same_array(got.numpy(), _bits(want), "hashLong")
    v32 = v.astype(np.int32)
    got = phash.xxhash64_int(torch.from_numpy(v32), torch.from_numpy(seeds))
    want = jhash.xxhash64_int(jnp.asarray(v32), jnp.asarray(seeds))
    assert_same_array(got.numpy(), _bits(want), "hashInt")


@pytest.mark.parametrize("n", EDGE_ROWS)
def test_table_hash_every_type_chained_matches_reference(n):
    # strings up to 40 bytes (a stripe, the words, the 4-byte lane and
    # the tail) keep the reference's compile per row count short; the
    # tests below take them to 70
    port, ref = _both(hash_host_columns(n, seed=n, max_len=40))
    assert_same_array(phash.table_xxhash64(port).numpy(),
                      _bits(jhash.table_xxhash64(ref)), "chained hash")


@pytest.mark.parametrize("i", range(18))
def test_table_hash_each_type_matches_reference(i):
    columns = hash_host_columns(2049, seed=5)
    port, ref = _both(columns)
    got = phash.table_xxhash64(port, [i], seed=7)
    want = jhash.table_xxhash64(ref, [i], seed=7)
    assert_same_array(got.numpy(), _bits(want), f"type {columns[i][0]}")


def test_decimal128_byte_image_edges():
    """Each DEC128_EDGES value alone: the minimal big-endian bytes (Java's
    BigInteger.toByteArray) hashed with XXH64, against the reference and
    the pure-Python hash of the same bytes."""
    limbs = dec128_limbs(DEC128_EDGES)
    col = [(int(t.TypeId.DECIMAL128), -3, limbs, None)]
    port, ref = _both(col)
    got = phash.table_xxhash64(port).numpy()
    assert_same_array(got, _bits(jhash.table_xxhash64(ref)), "decimal128")
    for v, h in zip(DEC128_EDGES, got.tolist()):
        nbytes = (v if v >= 0 else ~v).bit_length() // 8 + 1  # + sign bit
        raw = v.to_bytes(nbytes, "big", signed=True)
        assert h == int(np.uint64(xxh64(raw, 42)).view(np.int64)), v


@pytest.mark.parametrize("layout", ["arrow", "padded"])
def test_string_hash_lengths_0_to_70(layout):
    strings = seeded_bytes(300, seed=3)
    seeds = np.random.default_rng(4).integers(-2**63, 2**63 - 1, 300,
                                              dtype=np.int64)
    col = Column.from_pylist(strings, t.STRING, device="cpu")
    if layout == "padded":
        col = pstrings.pad_strings(col)
    got = pstrings.hash_string_column(col, torch.from_numpy(seeds)).numpy()
    for b, s, h in zip(strings, seeds.tolist(), got.tolist()):
        assert h == int(np.uint64(xxh64(b, s & (2**64 - 1))).view(np.int64))
    # the reference's matrix entry point, on the padded matrix
    p = pstrings.pad_strings(col)
    want = jstrings.xxhash64_bytes(jnp.asarray(p.chars.numpy()),
                                   jnp.asarray(p.data.numpy()),
                                   jnp.asarray(seeds.view(np.uint64)))
    assert_same_array(pstrings.xxhash64_bytes(
        p.chars, p.data, torch.from_numpy(seeds)).numpy(), _bits(want),
        "xxhash64_bytes")


@pytest.mark.parametrize("parts", [1, 7, 200])
def test_partition_hash_matches_reference(parts):
    columns = hash_host_columns(2049, seed=9)
    port, ref = _both(columns)
    keys = [4, 11, 16]  # INT32, INT64, STRING
    got = phash.partition_hash(port, keys, parts)
    want = np.asarray(jhash.partition_hash(ref, keys, parts))
    assert_same_array(got.numpy(), want, "partitions")
    assert got.min() >= 0 and got.max() < parts


def test_nan_payloads_keep_the_reference_bits():
    """The reference hashes a float's raw bits: NaNs with other payloads
    hash apart (Spark's doubleToLongBits would fold them to one pattern;
    ROADMAP Queue 3). The port keeps the reference's bits."""
    nans = np.array([0x7FF8000000000000, 0x7FF0000000000001],
                    np.int64).view(np.float64)
    port, ref = _both([(int(t.TypeId.FLOAT64), 0, nans, None)])
    got = phash.table_xxhash64(port).numpy()
    assert_same_array(got, _bits(jhash.table_xxhash64(ref)), "NaN")
    assert got[0] != got[1]


def test_table_hash_on_an_empty_selection_is_the_seed():
    col = Column.from_numpy(np.arange(5, dtype=np.int64), device="cpu")
    got = phash.table_xxhash64(Table([col]), [], seed=42)
    assert torch.equal(got, torch.full((5,), 42, dtype=torch.int64))
