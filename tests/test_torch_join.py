"""The port's equi-join against the JAX package: all six join types over
int32, int64 and unsigned keys, multi-column keys (rank encoded), a
DECIMAL128 key, null keys, phantom rows and ``out_size`` below the true
total; ``total`` and the three validity masks compare exactly, and the
indices and joined data wherever they are valid (the reference leaves
them unspecified elsewhere). The plain join probe (kernel D's plain
version, which walks the kernel's index step for step) against the
Pallas kernel in interpret mode and against ``jnp.searchsorted``, on
builds around each part of the index; ``join_auto``'s grow-and-retry; and the
planner's dense primary-key join in both modes, broken declarations
included."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu import types as jt
from spark_rapids_jni_tpu.ops import join as jjoin
from spark_rapids_jni_tpu.ops.pallas import hash_probe as jhp
from spark_rapids_jni_tpu_torch.interop import table_to_numpy
from spark_rapids_jni_tpu_torch.ops import join, kernels
from spark_rapids_jni_tpu_torch.ops.kernels import hash_probe as khp
from torch_parity import (
    EDGE_ROWS,
    LEVEL_CASES,
    host_columns,
    jax_table,
    level_case,
    to_port,
)

T = jt.TypeId
HOWS = ["inner", "left", "left_semi", "left_anti", "right", "full"]


def key_host(kind: str, n: int, rng) -> list:
    """Key columns of ``kind`` with duplicates and a null tail (values
    from a small range, so runs match many to many)."""
    def nulls():
        valid = rng.random(n) > 0.15
        valid[-max(1, n // 8):] = False
        return valid

    if kind == "multi":
        return [
            (int(T.INT16), 0, rng.integers(0, 3, n).astype(np.int16), nulls()),
            (int(T.DECIMAL64), -2, rng.integers(0, 3, n), None),
            (int(T.FLOAT64), 0, rng.choice(np.asarray(
                [np.nan, 0.0, -0.0, 1.5]), n), nulls()),
        ]
    if kind == "decimal128":
        return [(int(T.DECIMAL128), -3,
                 rng.integers(-2, 2, (n, 2)).astype(np.int64), nulls())]
    np_dt, tid = {"int32": (np.int32, T.INT32), "int64": (np.int64, T.INT64),
                  "uint32": (np.uint32, T.UINT32),
                  "uint64": (np.uint64, T.UINT64)}[kind]
    info = np.iinfo(np_dt)
    # the dtype max is the build side's null sentinel: keys equal to it
    # must still match exactly
    picks = np.asarray([info.min, info.max, 0, 5, 9], dtype=np_dt)
    return [(int(tid), 0, rng.choice(picks, n), nulls())]


def side(kind: str, n: int, seed: int) -> list:
    rng = np.random.default_rng(seed)
    keys = key_host(kind, n, rng)
    payload = (int(T.INT32), 0, np.arange(n, dtype=np.int32), None)
    return keys + [payload]


def assert_maps_match(got, want):
    """Exact counts and masks; indices only where the reference defines
    them."""
    w = {f: np.asarray(getattr(want, f)) for f in want._fields}
    g = {f: getattr(got, f).numpy() for f in got._fields}
    assert int(g["total"]) == int(w["total"])
    for f in ("row_valid", "left_valid", "right_valid"):
        np.testing.assert_array_equal(g[f], w[f], err_msg=f)
    lv = w["left_valid"] & w["row_valid"]
    np.testing.assert_array_equal(g["left_index"][lv], w["left_index"][lv])
    rv = w["right_valid"]
    np.testing.assert_array_equal(g["right_index"][rv], w["right_index"][rv])


def assert_joined_match(got_tbl, want_tbl):
    for i, (g, w) in enumerate(zip(table_to_numpy(got_tbl),
                                   host_columns(want_tbl))):
        assert g[:2] == w[:2], f"column {i}: type"
        np.testing.assert_array_equal(g[3], w[3], err_msg=f"validity {i}")
        v = w[3]
        np.testing.assert_array_equal(g[2][v], w[2][v], err_msg=f"data {i}")


def _both(lhost, rhost, lkeys, rkeys, out_size, how, lrv=None, rrv=None):
    jl, jr = jax_table(lhost), jax_table(rhost)
    want = jjoin.join(jl, jr, lkeys, rkeys, out_size, how=how,
                      left_row_valid=None if lrv is None else jnp.asarray(lrv),
                      right_row_valid=None if rrv is None
                      else jnp.asarray(rrv))
    pl, pr = to_port(jl), to_port(jr)
    got = join.join(pl, pr, lkeys, rkeys, out_size, how=how,
                    left_row_valid=None if lrv is None
                    else torch.from_numpy(lrv),
                    right_row_valid=None if rrv is None
                    else torch.from_numpy(rrv))
    assert_maps_match(got, want)
    assert_joined_match(join.apply_join_maps(pl, pr, got),
                        jjoin.apply_join_maps(jl, jr, want))
    return got


@pytest.mark.parametrize("kind,how", [
    (kind, how) for kind in ("int64", "uint64", "multi", "decimal128")
    for how in HOWS] + [("int32", "left_anti"), ("uint32", "right")])
def test_join_matches_reference(kind, how):
    lhost, rhost = side(kind, 300, 1), side(kind, 200, 2)
    keys = list(range(len(lhost) - 1))
    _both(lhost, rhost, keys, keys, 4096, how)


@pytest.mark.parametrize("n", EDGE_ROWS)
def test_join_edge_rows_with_phantoms_match_reference(n):
    lhost, rhost = side("int64", n, n), side("int64", max(n // 2, 1), n + 1)
    rng = np.random.default_rng(n)
    lrv = rng.random(n) > 0.1
    rrv = rng.random(len(rhost[0][2])) > 0.1
    for how in ("inner", "full"):
        _both(lhost, rhost, [0], [0], 3 * n + 8, how, lrv, rrv)


@pytest.mark.parametrize("how", ["inner", "left", "full"])
def test_out_size_below_total_matches_reference(how):
    lhost, rhost = side("int32", 257, 3), side("int32", 256, 4)
    got = _both(lhost, rhost, [0], [0], 64, how)
    assert int(got.total) > 64


def test_join_auto_grows_to_the_exact_total():
    lhost, rhost = side("int64", 500, 5), side("int64", 400, 6)
    pl, pr = to_port(jax_table(lhost)), to_port(jax_table(rhost))
    exact = join.join(pl, pr, 0, 0, 10**6)
    maps, tbl = join.join_auto(pl, pr, 0, 0, initial_out_size=16)
    total = int(exact.total)
    assert int(maps.total) == total and total > 16 * 4
    assert maps.row_valid.shape[0] >= total
    assert int(maps.row_valid.sum()) == total
    assert tbl.num_rows == maps.row_valid.shape[0]


def _probe_inputs(dtype, m, n, seed):
    """Sorted, sentinel-padded build keys (with duplicates) and probes
    that hit, miss, and equal the dtype's min and max."""
    rng = np.random.default_rng(seed)
    info = np.iinfo(dtype)
    # negative draws wrap for unsigned types: sort after the cast
    build = np.sort(rng.integers(-50, 50, m).astype(dtype))
    build[m - m // 5:] = info.max  # the null sentinel tail
    probe = rng.integers(-60, 60, n).astype(dtype)
    probe[:4] = [info.min, info.max, info.max - 1, 0][:min(4, n)]
    return build, probe


@pytest.mark.parametrize("m", [1, 255, 2048])
def test_plain_probe_matches_pallas_interpret(m):
    build, probe = _probe_inputs(np.int32, m, 2049, m)
    lo, hi = jhp.probe_lo_hi(jnp.asarray(build), jnp.asarray(probe),
                             interpret=True)
    kernels.reset_counts()
    got_lo, got_hi = khp.probe_lo_hi(torch.from_numpy(build),
                                     torch.from_numpy(probe))
    assert kernels.launches() == {}
    assert got_lo.dtype == got_hi.dtype == torch.int64
    np.testing.assert_array_equal(got_lo.numpy(), np.asarray(lo))
    np.testing.assert_array_equal(got_hi.numpy(), np.asarray(hi))


@pytest.mark.parametrize("dtype", [np.int64, np.uint64, np.int8, np.uint32])
@pytest.mark.parametrize("m", [0, 3000])
def test_plain_probe_matches_searchsorted(dtype, m):
    build, probe = _probe_inputs(dtype, m, 2049, 7)
    got_lo, got_hi = khp.probe_lo_hi(torch.from_numpy(build),
                                     torch.from_numpy(probe))
    for side_, got in (("left", got_lo), ("right", got_hi)):
        want = jnp.searchsorted(jnp.asarray(build), jnp.asarray(probe),
                                side=side_)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(
            got.numpy(), np.searchsorted(build, probe, side=side_))


@pytest.mark.parametrize("case", [c for c in LEVEL_CASES if c != "empty"])
def test_plain_probe_levels_match_pallas_interpret(case):
    # a top level of 16 keys puts two or three index levels under these
    # builds of at most 2048 keys, the Pallas kernel's limit
    build, probe = level_case(case, np.int32, 16)
    assert build.shape[0] <= jhp.MAX_BUILD
    lo, hi = jhp.probe_lo_hi(jnp.asarray(build), jnp.asarray(probe),
                             interpret=True)
    got_lo, got_hi = khp.probe_lo_hi_plain(torch.from_numpy(build),
                                           torch.from_numpy(probe),
                                           top_keys=16)
    np.testing.assert_array_equal(got_lo.numpy(), np.asarray(lo))
    np.testing.assert_array_equal(got_hi.numpy(), np.asarray(hi))


@pytest.mark.parametrize("dtype", [np.int32, np.int64, np.uint64])
@pytest.mark.parametrize("case", LEVEL_CASES)
def test_plain_probe_levels_match_searchsorted(case, dtype):
    # the kernel's own top-level capacity (khp.TOP_KEYS keys)
    build, probe = level_case(case, dtype, khp.TOP_KEYS)
    got_lo, got_hi = khp.probe_lo_hi(torch.from_numpy(build),
                                     torch.from_numpy(probe))
    for side_, got in (("left", got_lo), ("right", got_hi)):
        want = jnp.searchsorted(jnp.asarray(build), jnp.asarray(probe),
                                side=side_)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(
            got.numpy(), np.searchsorted(build, probe, side=side_))


def test_probe_refuses_mixed_or_float_keys():
    with pytest.raises(TypeError, match="differ"):
        khp.probe_lo_hi(torch.zeros(3, dtype=torch.int32),
                        torch.zeros(3, dtype=torch.int64))
    with pytest.raises(TypeError, match="integers"):
        khp.probe_lo_hi(torch.zeros(3), torch.zeros(3))


def _pk_tables(n_probe, n_build, seed, shuffle=False, dup=False, oor=False,
               clash=False):
    """A probe table and a dense-PK build table (keys 1..n_build, nulls
    on a fifth of both sides), optionally broken: shuffled build rows,
    a duplicate key, an out-of-range key, a clustered slot holding
    another key."""
    rng = np.random.default_rng(seed)
    keys = np.arange(1, n_build + 1, dtype=np.int64)
    if shuffle:
        keys = rng.permutation(keys)
    if dup:
        keys[1] = keys[0]
    if oor:
        keys[2] = n_build + 7
    if clash:
        keys[3] = keys[4]
    probe = [(int(T.INT64), 0, rng.integers(-1, n_build + 3, n_probe),
              rng.random(n_probe) > 0.2),
             (int(T.INT32), 0, np.arange(n_probe, dtype=np.int32), None)]
    bvalid = rng.random(n_build) > 0.2
    bvalid[:5] = True  # the broken keys stay valid
    build = [(int(T.INT64), 0, keys, bvalid),
             (int(T.FLOAT64), 0, rng.random(n_build), None)]
    return probe, build


@pytest.mark.parametrize("clustered,broken", [
    (True, {}), (True, {"clash": True}), (False, {"shuffle": True}),
    (False, {"shuffle": True, "dup": True}),
    (False, {"shuffle": True, "oor": True})])
def test_dense_pk_join_matches_reference(clustered, broken):
    from spark_rapids_jni_tpu.ops import planner as jplanner
    from spark_rapids_jni_tpu_torch.ops import planner

    probe, build = _pk_tables(2049, 300, 7, **broken)
    jp, jb = jax_table(probe), jax_table(build)
    want = jplanner.dense_pk_join(jp, jb, 0, 0, 1, 300, clustered=clustered)
    got = planner.dense_pk_join(to_port(jp), to_port(jb), 0, 0, 1, 300,
                                clustered=clustered)
    assert bool(got.pk_violation) == bool(want.pk_violation) \
        == bool(broken.keys() - {"shuffle"})
    assert int(got.total) == int(want.total)
    np.testing.assert_array_equal(got.matched.numpy(),
                                  np.asarray(want.matched))
    assert_joined_match(got.table, want.table)


@pytest.mark.parametrize("key_hi,matched,violation", [
    (2**63 + 100, [True, True, False, False, False], True),  # 2^64-3 oor
    (2**64 - 2, [True, True, False, True, False], False)])
def test_uint64_dense_pk_join_past_2_63_matches_reference(key_hi, matched,
                                                          violation):
    """Sorted mode with UINT64 keys and ranges past 2^63: the keys compare
    in their order image, so they match by value, as in the reference."""
    from spark_rapids_jni_tpu.ops import planner as jplanner
    from spark_rapids_jni_tpu_torch.ops import planner

    u = int(T.UINT64)
    build = [(u, 0, np.asarray([5, 2**63 + 7, 2**64 - 3, 2**63], np.uint64),
              np.asarray([True, True, True, False])),
             (u, 0, np.arange(4, dtype=np.uint64), None)]
    probe = [(u, 0, np.asarray([2**63 + 7, 5, 2**63, 2**64 - 3, 6],
                               np.uint64), None)]
    jp, jb = jax_table(probe), jax_table(build)
    want = jplanner.dense_pk_join(jp, jb, 0, 0, 0, key_hi)
    got = planner.dense_pk_join(to_port(jp), to_port(jb), 0, 0, 0, key_hi)
    np.testing.assert_array_equal(got.matched.numpy(),
                                  np.asarray(want.matched))
    assert got.matched.tolist() == matched
    assert bool(got.pk_violation) == bool(want.pk_violation) == violation
    assert int(got.total) == int(want.total)
    assert_joined_match(got.table, want.table)


def test_dense_pk_join_bounds_outside_the_key_dtype_raise_as_reference():
    from spark_rapids_jni_tpu.ops import planner as jplanner
    from spark_rapids_jni_tpu_torch.ops import planner

    u = int(T.UINT64)
    keys = [(u, 0, np.asarray([2**63, 2**63 + 1], np.uint64), None)]
    jt_ = jax_table(keys)
    for lo, hi, clustered in ((-1, 2**63 + 100, False),
                              (2**63, 2**63 + 1, True)):
        with pytest.raises(OverflowError):
            jplanner.dense_pk_join(jt_, jt_, 0, 0, lo, hi,
                                   clustered=clustered)
        with pytest.raises(OverflowError):
            planner.dense_pk_join(to_port(jt_), to_port(jt_), 0, 0, lo, hi,
                                  clustered=clustered)


@pytest.mark.parametrize("clustered", [False, True])
@pytest.mark.parametrize("build_tid,probe_tid", [
    (T.INT64, T.UINT64), (T.UINT64, T.INT64), (T.INT32, T.UINT64)])
def test_dense_pk_join_uint64_against_signed_keys_raises(clustered,
                                                         build_tid,
                                                         probe_tid):
    """UINT64 against a signed key dtype has no common exact 64-bit
    order, so the port refuses the pair. The reference promotes both
    sides to float64 and matches by value, exactly only below 2^53
    (ROADMAP Queue 3); on these small keys it matches [3, 1, 0]."""
    from spark_rapids_jni_tpu.ops import planner as jplanner
    from spark_rapids_jni_tpu_torch.ops import planner

    def keys(tid, vals):
        np_dt = jt.DType(tid).storage_dtype
        return (int(tid), 0, np.asarray(vals).astype(np_dt), None)

    build = [keys(build_tid, [0, 1, 2, 3]),
             (int(T.INT64), 0, np.arange(4, dtype=np.int64), None)]
    probe = [keys(probe_tid, [3, 1, 0])]
    jp, jb = jax_table(probe), jax_table(build)
    want = jplanner.dense_pk_join(jp, jb, 0, 0, 0, 3, clustered=clustered)
    assert np.asarray(want.matched).tolist() == [True, True, True]
    with pytest.raises(TypeError, match="no common exact order"):
        planner.dense_pk_join(to_port(jp), to_port(jb), 0, 0, 0, 3,
                              clustered=clustered)
