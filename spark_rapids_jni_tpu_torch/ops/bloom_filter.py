"""Bloom filter build and probe (counterpart of
``spark_rapids_jni_tpu/ops/bloom_filter.py``): Spark's runtime join
filter.

The filter lives on the device as one byte per bit (uint8[m]), as in the
reference, so ``bits`` compares byte for byte with it: the build is one
scatter of ones per hash (duplicates write the same byte), the probe one
gather per hash. ``to_packed``/``from_packed`` convert to the
little-endian packed form that Spark's serialized BloomFilterImpl uses.

Bit placement is Spark's ``BloomFilterImpl.putLong``:
h1 = Murmur3_x86_32.hashLong(item, 0), h2 = Murmur3_x86_32.hashLong(item,
h1), then for i in 1..k: combined = int32(h1 + i*h2), bitwise-NOT if
negative, bit = combined % m. The 32-bit arithmetic runs in int64 lanes
masked to 32 bits. Spark SQL's runtime filter (BloomFilterAggregate,
might_contain) first hashes the value with xxhash64(seed 42):
``spark_prehash`` and the ``*_spark`` functions.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from spark_rapids_jni_tpu_torch import telemetry
from spark_rapids_jni_tpu_torch.columnar.bitmask import (
    pack_bits_last_axis,
    unpack_bits,
)
from spark_rapids_jni_tpu_torch.errors import MalformedInputError
from spark_rapids_jni_tpu_torch.ops.hash import (
    SPARK_DEFAULT_SEED,
    _as_int64,
    xxhash64_long,
)
from spark_rapids_jni_tpu_torch.utils.platform import resolve_device

_M32 = 0xFFFFFFFF
_MM3_C1 = 0xCC9E2D51
_MM3_C2 = 0x1B873593


def _rotl32(x: torch.Tensor, r: int) -> torch.Tensor:
    """Rotate 32-bit values held in int64 lanes (in [0, 2^32))."""
    return ((x << r) | (x >> (32 - r))) & _M32


def murmur3_hash_long(value: torch.Tensor, seed) -> torch.Tensor:
    """Murmur3_x86_32.hashLong: two 4-byte little-endian blocks (low word
    then high word), finalized with length 8. ``seed`` is an int or a
    per-row tensor. Returns int64 lanes holding the uint32 hash."""
    v = _as_int64(value)
    if isinstance(seed, torch.Tensor):
        h1 = _as_int64(seed) & _M32
    else:
        h1 = torch.full_like(v, int(seed) & _M32)
    for word in (v & _M32, (v >> 32) & _M32):
        k1 = (_rotl32((word * _MM3_C1) & _M32, 15) * _MM3_C2) & _M32
        h1 = (_rotl32(h1 ^ k1, 13) * 5 + 0xE6546B64) & _M32
    h1 = h1 ^ 8
    h1 = ((h1 ^ (h1 >> 16)) * 0x85EBCA6B) & _M32
    h1 = ((h1 ^ (h1 >> 13)) * 0xC2B2AE35) & _M32
    return h1 ^ (h1 >> 16)


def spark_prehash(values: torch.Tensor) -> torch.Tensor:
    """BloomFilterAggregate's value hash: xxhash64(long value, seed 42),
    int64."""
    v = _as_int64(values)
    return xxhash64_long(v, torch.full_like(v, SPARK_DEFAULT_SEED))


@dataclass
class BloomFilter:
    bits: torch.Tensor  # uint8[num_bits], one byte per bit (0/1)
    num_hashes: int

    @property
    def num_bits(self) -> int:
        return int(self.bits.shape[0])

    @classmethod
    def empty(cls, num_bits: int, num_hashes: int = 3,
              device=None) -> "BloomFilter":
        """An empty filter on ``device`` (None: the CUDA device)."""
        if num_bits <= 0:
            raise ValueError("num_bits must be positive")
        return cls(torch.zeros((num_bits,), dtype=torch.uint8,
                               device=resolve_device(device)), num_hashes)

    @classmethod
    def optimal(cls, expected_items: int, fpp: float = 0.03,
                device=None) -> "BloomFilter":
        """Sized like Spark's BloomFilter.create (``optimal_params``)."""
        m, k = optimal_params(expected_items, fpp)
        return cls.empty(m, k, device)

    def to_packed(self) -> torch.Tensor:
        """Little-endian packed uint8[ceil(m/8)] for interchange."""
        return pack_bits_last_axis(self.bits.bool())

    @classmethod
    def from_packed(cls, packed: torch.Tensor, num_bits: int,
                    num_hashes: int) -> "BloomFilter":
        return cls(unpack_bits(packed, num_bits).to(torch.uint8),
                   num_hashes)


def optimal_params(expected_items: int, fpp: float = 0.03
                   ) -> tuple[int, int]:
    """(num_bits, num_hashes) of Spark's BloomFilter.create sizing:
    m = -n ln p / (ln 2)^2 (at least 64), k = max(1, round(m/n ln 2))."""
    n = max(int(expected_items), 1)
    m = max(int(-n * np.log(fpp) / (np.log(2) ** 2)), 64)
    k = max(1, int(round(m / n * np.log(2))))
    return m, k


def _hash_pair(values: torch.Tensor):
    h1 = murmur3_hash_long(values, 0)
    return h1, murmur3_hash_long(values, h1)


def _bit_position(h1: torch.Tensor, h2: torch.Tensor, i: int,
                  num_bits: int) -> torch.Tensor:
    """putLong's i-th bit index (int64): int32(h1 + i*h2), NOT-ed when
    negative (~x of the negative int32 x = c - 2^32 is 2^32 - 1 - c)."""
    c = (h1 + i * h2) & _M32
    c = torch.where(c >= 1 << 31, _M32 - c, c)
    return c % num_bits


def _bit_positions(values: torch.Tensor, num_bits: int,
                   num_hashes: int) -> torch.Tensor:
    """(n, k) bit indexes: BloomFilterImpl.putLong's double hashing."""
    h1, h2 = _hash_pair(values)
    return torch.stack([_bit_position(h1, h2, i, num_bits)
                        for i in range(1, num_hashes + 1)], dim=1)


def _put_bits(bits: torch.Tensor, values: torch.Tensor,
              valid: Optional[torch.Tensor], num_bits: int,
              num_hashes: int) -> torch.Tensor:
    """``bits`` with every valid value's k bits set (a new tensor). Null
    rows are dropped before the scatters (one count read to the host),
    not sent to a discard slot that every one of them would write."""
    if valid is not None:
        values = values[valid]
    bits = bits.clone()
    h1, h2 = _hash_pair(values)
    for i in range(1, num_hashes + 1):
        bits[_bit_position(h1, h2, i, num_bits)] = 1
    return bits


def bloom_put(bf: BloomFilter, values: torch.Tensor,
              valid: Optional[torch.Tensor] = None) -> BloomFilter:
    """Insert int64 values (rows where ``valid`` is False skipped).
    Functional: returns a new filter."""
    return BloomFilter(_put_bits(bf.bits, values, valid, bf.num_bits,
                                 bf.num_hashes), bf.num_hashes)


def bloom_might_contain(bf: BloomFilter, values: torch.Tensor
                        ) -> torch.Tensor:
    """bool[n]: False for the values certainly absent."""
    h1, h2 = _hash_pair(values)
    hit = torch.ones(values.shape, dtype=torch.bool, device=values.device)
    for i in range(1, bf.num_hashes + 1):
        hit &= bf.bits[_bit_position(h1, h2, i, bf.num_bits)] == 1
    return hit


def bloom_merge(a: BloomFilter, b: BloomFilter) -> BloomFilter:
    """Union: how Spark combines per-task filters. Both must agree on
    num_bits AND num_hashes (otherwise their bits are placed
    incompatibly, and an OR would drop rows either keeps): disagreement
    raises :class:`MalformedInputError` and counts
    ``rtfilter.merge_mismatch``."""
    if a.num_bits != b.num_bits or a.num_hashes != b.num_hashes:
        telemetry.count("rtfilter.merge_mismatch")
        raise MalformedInputError(
            f"bloom merge geometry mismatch: "
            f"(num_bits={a.num_bits}, num_hashes={a.num_hashes}) vs "
            f"(num_bits={b.num_bits}, num_hashes={b.num_hashes})")
    return BloomFilter(torch.maximum(a.bits, b.bits), a.num_hashes)


def bloom_put_spark(bf: BloomFilter, values: torch.Tensor,
                    valid: Optional[torch.Tensor] = None) -> BloomFilter:
    """BloomFilterAggregate: xxhash64(value, 42), then putLong."""
    return bloom_put(bf, spark_prehash(values), valid)


def bloom_might_contain_spark(bf: BloomFilter, values: torch.Tensor
                              ) -> torch.Tensor:
    """Spark SQL's might_contain: the pre-hash, then mightContainLong."""
    return bloom_might_contain(bf, spark_prehash(values))
