"""Spark's row hash and the join probe seam (counterpart of
``spark_rapids_jni_tpu/ops/hash.py``).

XXH64's short-input paths, hashInt (4 bytes) and hashLong (8 bytes),
as Spark's ``XXH64`` applies them per column value, chained across
columns with the running hash as seed and null rows skipped (Spark's
HashExpression). STRING and DECIMAL128 values go through the
variable-length byte hash (``ops/strings.py``).

Every 64-bit lane is an int64 tensor holding the uint64 bits
(``ops/_xxh64.py``).

Spark's value widening: bool/byte/short/int and the day types ->
hashInt of the int32 value; float -> hashInt of its IEEE bits, double
-> hashLong of its bits (-0.0 made 0.0 first, NaN payloads kept as the
bits are); long, decimal32/64 and the other 64-bit types -> hashLong.
"""

from __future__ import annotations

from typing import Sequence

import torch

from spark_rapids_jni_tpu_torch.columnar import Column, Table
from spark_rapids_jni_tpu_torch.ops._xxh64 import (
    P1, P2, P3, P4, P5, avalanche, rotl, s64,
)
from spark_rapids_jni_tpu_torch.ops import strings
from spark_rapids_jni_tpu_torch.ops.kernels import hash_probe
from spark_rapids_jni_tpu_torch.types import TypeId

SPARK_DEFAULT_SEED = 42
_M32 = 0xFFFFFFFF

# BOOL8 to UINT32 and the day types: hashInt of the (sign- or zero-
# extended) int32 value
_HASH_INT = (TypeId.BOOL8, TypeId.INT8, TypeId.UINT8, TypeId.INT16,
             TypeId.UINT16, TypeId.INT32, TypeId.UINT32,
             TypeId.TIMESTAMP_DAYS, TypeId.DURATION_DAYS)
_SIGNED = {torch.uint32: torch.int32, torch.uint64: torch.int64}


def _as_int64(x: torch.Tensor) -> torch.Tensor:
    """``x`` widened to int64 (unsigned 32/64-bit lanes through their
    signed view, so the bits are kept)."""
    view = _SIGNED.get(x.dtype)
    return (x if view is None else x.view(view)).to(torch.int64)


def xxhash64_long(value: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    """XXH64 of one 8-byte little-endian value per row (Spark hashLong).
    Returns int64 lanes holding the uint64 hash bits."""
    h = _as_int64(seed) + P5 + 8
    h = h ^ (rotl(_as_int64(value) * P2, 31) * P1)
    return avalanche(rotl(h, 27) * P1 + P4)


def xxhash64_int(value: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    """XXH64 of one 4-byte value per row (Spark hashInt): the low 32 bits
    of ``value``. Returns int64 lanes holding the uint64 hash bits."""
    h = _as_int64(seed) + P5 + 4
    h = h ^ ((_as_int64(value) & _M32) * P1)
    return avalanche(rotl(h, 23) * P2 + P3)


def _decimal128_image(limbs: torch.Tensor):
    """The minimal big-endian two's-complement bytes of each DECIMAL128
    value (Java's ``BigInteger.toByteArray``): a position-major (16, n)
    uint8 image, left-aligned, and the int64 byte counts. Built one byte
    lane at a time: the 16-byte big-endian image, the first byte that is
    not sign filler (16 when every byte is), one filler byte kept when
    that byte's top bit would flip the sign."""
    lo, hi = limbs[:, 0], limbs[:, 1]
    n = limbs.shape[0]
    neg = hi < 0
    filler = torch.where(neg, 0xFF, 0)
    be = torch.empty((16, n), dtype=torch.uint8, device=limbs.device)
    for j in range(16):
        src = hi if j < 8 else lo
        be[j] = ((src >> (56 - 8 * (j % 8))) & 0xFF).to(torch.uint8)
    first = torch.full((n,), 16, dtype=torch.int64, device=limbs.device)
    for j in range(15, -1, -1):
        first = torch.where(be[j].to(torch.int64) != filler, j, first)
    # all filler (0 or -1): the last byte alone, whose sign agrees
    first = first.clamp_(max=15)
    fb = be.gather(0, first[None, :])[0]
    start = torch.where((fb >= 0x80) != neg, first - 1, first)
    img = torch.empty_like(be)
    for k in range(16):
        img[k] = be.gather(0, (start + k).clamp(0, 15)[None, :])[0]
    return img, 16 - start


def _column_hash(col: Column, seeds: torch.Tensor) -> torch.Tensor:
    """Hash one column's values with per-row seeds; null rows pass the
    seed through unchanged (Spark's chaining)."""
    tid = col.dtype.type_id
    v = col.data
    if tid == TypeId.STRING:
        return strings.hash_string_column(col, seeds)
    if tid in _HASH_INT:
        hashed = xxhash64_int(v, seeds)
    elif tid == TypeId.FLOAT32:
        hashed = xxhash64_int(
            torch.where(v == 0, 0.0, v).view(torch.int32), seeds)
    elif tid == TypeId.FLOAT64:
        hashed = xxhash64_long(
            torch.where(v == 0, 0.0, v).view(torch.int64), seeds)
    elif col.dtype.is_decimal128:
        # Spark hashes Decimal(precision > 18) as XXH64 over the minimal
        # big-endian byte array of the unscaled value
        img, lengths = _decimal128_image(v)
        hashed = strings.xxhash64_image(img, lengths, seeds)
    else:
        hashed = xxhash64_long(v, seeds)
    if col.validity is None:
        return hashed
    return torch.where(col.validity, hashed, seeds)


def table_xxhash64(table: Table, columns: Sequence[int] | None = None,
                   seed: int = SPARK_DEFAULT_SEED) -> torch.Tensor:
    """Row hash: per-column xxhash64 chained left to right with the
    running hash as seed (Spark's HashExpression). Returns int64[n]."""
    cols = range(table.num_columns) if columns is None else columns
    h = torch.full((table.num_rows,), s64(seed), dtype=torch.int64,
                   device=table.column(0).device)
    for c in cols:
        h = _column_hash(table.column(c), h)
    return h


def partition_hash(table: Table, columns: Sequence[int],
                   num_partitions: int) -> torch.Tensor:
    """Spark's hash partitioning: pmod(hash, n) as int32[n] (torch's
    ``remainder`` takes the divisor's sign, which is pmod)."""
    h = table_xxhash64(table, columns)
    return torch.remainder(h, num_partitions).to(torch.int32)


def probe_sorted_lo_hi(sorted_key: torch.Tensor, probe_key: torch.Tensor):
    """Per probe key, the [lo, hi) match-run bounds (int64) in the
    sentinel-padded sorted build keys: the ``join.hash_probe`` kernel for
    CUDA tensors, its plain version for CPU ones. Unlike the reference's
    Pallas tier there is no build-size or key-width fallback."""
    return hash_probe.probe_lo_hi(sorted_key, probe_key)
