"""The port's bloom filter (``ops/bloom_filter.py``) against the JAX
package on the CPU, byte for byte: Murmur3's hashLong and putLong's bit
positions, the one-byte-per-bit ``bits`` and the packed form after a
build with null tails (plain and Spark's pre-hashed build), the packed
round trip, ``might_contain`` over built, null and absent values, the
merge and its geometry mismatch, and ``optimal_params``; at the
reference's edge row counts."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from spark_rapids_jni_tpu.ops import bloom_filter as jbf
from spark_rapids_jni_tpu.runtime.resilience import (
    MalformedInputError as JMalformedInputError,
)
from spark_rapids_jni_tpu.telemetry.events import REGISTRY
from spark_rapids_jni_tpu_torch import telemetry
from spark_rapids_jni_tpu_torch.errors import MalformedInputError
from spark_rapids_jni_tpu_torch.ops import bloom_filter as pbf
from torch_parity import EDGE_ROWS, assert_same_array, bloom_values


def _pair(v: np.ndarray):
    return torch.from_numpy(v), jnp.asarray(v)


def _same_filter(got: pbf.BloomFilter, want) -> None:
    assert got.num_hashes == want.num_hashes
    assert_same_array(got.bits.numpy(), np.asarray(want.bits), "bits")
    assert_same_array(got.to_packed().numpy(), np.asarray(want.to_packed()),
                      "packed")


@pytest.mark.parametrize("n", EDGE_ROWS)
def test_hashes_and_bit_positions_match_reference(n):
    v, _ = bloom_values(n, seed=n)
    pv, jv = _pair(v)
    for seed in (0, 7, 0xFFFFFFFF):
        assert_same_array(
            pbf.murmur3_hash_long(pv, seed).numpy(),
            np.asarray(jbf.murmur3_hash_long(jv, np.uint32(seed))).astype(
                np.int64), f"murmur3 seed {seed}")
    m, k = pbf.optimal_params(n, 0.03)
    assert_same_array(pbf._bit_positions(pv, m, k).numpy(),
                      np.asarray(jbf._bit_positions(jv, m, k)).astype(
                          np.int64), "bit positions")
    assert_same_array(pbf.spark_prehash(pv).numpy(),
                      np.asarray(jbf.spark_prehash(jv)), "prehash")


@pytest.mark.parametrize("spark", [False, True], ids=["plain", "spark"])
@pytest.mark.parametrize("n", EDGE_ROWS)
def test_build_and_probe_match_reference(n, spark):
    v, valid = bloom_values(n, seed=n + 1)
    pv, jv = _pair(v)
    m, k = pbf.optimal_params(max(n // 2, 1), 0.03)
    put = pbf.bloom_put_spark if spark else pbf.bloom_put
    jput = jbf.bloom_put_spark if spark else jbf.bloom_put
    got = put(pbf.BloomFilter.empty(m, k, device="cpu"), pv,
              torch.from_numpy(valid))
    want = jput(jbf.BloomFilter.empty(m, k), jv, jnp.asarray(valid))
    _same_filter(got, want)
    # the probe: the built values, the null rows' values, absent values
    probe = np.concatenate([v, np.random.default_rng(n).integers(
        -2**63, 2**63 - 1, 300, dtype=np.int64)])
    pp, jp = _pair(probe)
    contain = pbf.bloom_might_contain_spark if spark \
        else pbf.bloom_might_contain
    jcontain = jbf.bloom_might_contain_spark if spark \
        else jbf.bloom_might_contain
    hit = contain(got, pp)
    assert_same_array(hit.numpy(), np.asarray(jcontain(want, jp)), "probe")
    assert bool(hit[:n][torch.from_numpy(valid)].all())  # no false negative
    # the packed round trip
    back = pbf.BloomFilter.from_packed(got.to_packed(), m, k)
    assert torch.equal(back.bits, got.bits) and back.num_hashes == k
    wback = jbf.BloomFilter.from_packed(want.to_packed(), m, k)
    _same_filter(back, wback)


@pytest.mark.parametrize("n", [257, 2049])
def test_merge_of_halves_is_the_whole_build(n):
    v, valid = bloom_values(n, seed=3)
    pv, jv = _pair(v)
    pvalid = torch.from_numpy(valid)
    m, k = pbf.optimal_params(n, 0.03)
    empty = pbf.BloomFilter.empty(m, k, device="cpu")
    half = n // 2
    a = pbf.bloom_put(empty, pv[:half], pvalid[:half])
    b = pbf.bloom_put(empty, pv[half:], pvalid[half:])
    merged = pbf.bloom_merge(a, b)
    assert torch.equal(merged.bits, pbf.bloom_put(empty, pv, pvalid).bits)
    jempty = jbf.BloomFilter.empty(m, k)
    jvalid = jnp.asarray(valid)
    want = jbf.bloom_merge(jbf.bloom_put(jempty, jv[:half], jvalid[:half]),
                           jbf.bloom_put(jempty, jv[half:], jvalid[half:]))
    _same_filter(merged, want)


@pytest.mark.parametrize("other", [(512, 3), (256, 4)],
                         ids=["num_bits", "num_hashes"])
def test_merge_geometry_mismatch_raises_and_counts(other):
    a = pbf.BloomFilter.empty(256, 3, device="cpu")
    b = pbf.BloomFilter.empty(*other, device="cpu")
    before = telemetry.counter("rtfilter.merge_mismatch")
    with pytest.raises(MalformedInputError, match="geometry mismatch"):
        pbf.bloom_merge(a, b)
    assert telemetry.counter("rtfilter.merge_mismatch") == before + 1
    jbefore = REGISTRY.counter("rtfilter.merge_mismatch").value
    with pytest.raises(JMalformedInputError, match="geometry mismatch"):
        jbf.bloom_merge(jbf.BloomFilter.empty(256, 3),
                        jbf.BloomFilter.empty(*other))
    assert REGISTRY.counter("rtfilter.merge_mismatch").value == jbefore + 1


@pytest.mark.parametrize("items", [0, 1, 10, 1000, 4_700_000, 10**9])
@pytest.mark.parametrize("fpp", [0.5, 0.03, 0.001])
def test_optimal_params_match_reference(items, fpp):
    assert pbf.optimal_params(items, fpp) == jbf.optimal_params(items, fpp)
    f = pbf.BloomFilter.optimal(min(items, 1000), fpp, device="cpu")
    assert (f.num_bits, f.num_hashes) == pbf.optimal_params(
        min(items, 1000), fpp)


def test_empty_filter_needs_bits():
    with pytest.raises(ValueError, match="positive"):
        pbf.BloomFilter.empty(0, device="cpu")
