"""Helpers that hold the PyTorch port against the JAX package: tables
cross between the two as numpy arrays (``interop``), and results compare
byte for byte; and input builders that the CPU tests and the card tests
share. JAX is imported only inside the helpers that need it, so the card
tests, which run where JAX is absent, can import this module."""

from __future__ import annotations

import contextlib
from functools import partial

import numpy as np
import torch

from spark_rapids_jni_tpu_torch.interop import table_from_numpy, table_to_numpy
from spark_rapids_jni_tpu_torch.ops.kernels import hash_probe as khp

EDGE_ROWS = [1, 255, 256, 257, 2047, 2048, 2049]


def host_columns(jtable) -> list:
    """A JAX table as ``[(type_id, scale, data, validity), ...]``; a
    STRING column's data is the pair (offsets or lengths, chars)."""
    return [
        (int(c.dtype.type_id), int(c.dtype.scale),
         (np.asarray(c.data), np.asarray(c.chars)) if c.dtype.is_string
         else np.asarray(c.data),
         None if c.validity is None else np.asarray(c.validity))
        for c in jtable.columns
    ]


def to_port(jtable, device="cpu"):
    return table_from_numpy(host_columns(jtable), device=device)


def jax_table(columns):
    """``[(type_id, scale, data, validity), ...]`` -> JAX table."""
    import jax.numpy as jnp

    from spark_rapids_jni_tpu import types as jt
    from spark_rapids_jni_tpu.columnar import Column as JColumn, Table as JTable

    def column(tid, scale, data, valid):
        dtype = jt.DType(jt.TypeId(tid), scale)
        validity = None if valid is None else jnp.asarray(valid)
        if dtype.is_string:
            return JColumn(dtype, jnp.asarray(data[0]), validity,
                           chars=jnp.asarray(data[1]))
        return JColumn(dtype, jnp.asarray(data), validity)

    return JTable([column(*c) for c in columns])


@contextlib.contextmanager
def quick_reference_compiles():
    """Compile the JAX package's programs at XLA's lowest optimisation
    level inside the block, and drop every compiled program at its end,
    so that nothing compiled here runs in a later test module. For tests
    whose reference compiles some hundreds of small programs (eager
    ``shard_map`` steps), each run once on a few hundred rows: there the
    compiles take most of the time. The values are the same; the tests
    that use this hold them to the port exactly, or float lanes to their
    stated tolerance."""
    import jax

    before = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    try:
        yield
    finally:
        jax.config.update("jax_disable_most_optimizations", before)
        jax.clear_caches()


def traced_reference(fn, *args):
    """``fn(*args)`` of the JAX package traced into one XLA program: the
    same code as its eager call, compiled once per shape rather than once
    per operation. The STRING columns of table arguments enter padded
    (jit needs a static width); the reference pads a string column first
    wherever it reads one, so the results are those of the Arrow input.
    Exact for integers and bytes; XLA may fuse float arithmetic
    differently, so float results stay on the eager path."""
    import jax

    from spark_rapids_jni_tpu.columnar import Table as JTable
    from spark_rapids_jni_tpu.ops.strings import pad_strings

    def padded(a):
        if not isinstance(a, JTable):
            return a
        return JTable([pad_strings(c) if c.dtype.is_string else c
                       for c in a.columns])

    return jax.jit(fn)(*[padded(a) for a in args])


def _string_rows(data) -> list:
    """Each row's bytes of a host STRING column (either layout)."""
    values, chars = data
    if chars.ndim == 2:
        return [chars[i, :values[i]].tobytes() for i in range(len(values))]
    blob = chars.tobytes()
    return [blob[values[i]:values[i + 1]] for i in range(len(values) - 1)]


def assert_same_array(got, want, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype, f"{what}: dtype {got.dtype} != {want.dtype}"
    assert got.shape == want.shape, f"{what}: shape {got.shape} != {want.shape}"
    assert got.tobytes() == want.tobytes(), f"{what}: bytes differ"


def assert_same_table(port_table, jtable) -> None:
    """Bit-identical: types, every data byte (under nulls too) and the
    validity tri-state."""
    got = table_to_numpy(port_table)
    want = host_columns(jtable)
    assert len(got) == len(want), "column count"
    for i, (g, w) in enumerate(zip(got, want)):
        assert g[:2] == w[:2], f"column {i}: type {g[:2]} != {w[:2]}"
        if isinstance(w[2], tuple):
            assert_same_array(g[2][0], w[2][0], f"column {i} offsets")
            assert_same_array(g[2][1], w[2][1], f"column {i} chars")
        else:
            assert_same_array(g[2], w[2], f"column {i} data")
        assert (g[3] is None) == (w[3] is None), f"column {i}: tri-state"
        if g[3] is not None:
            assert_same_array(g[3], w[3], f"column {i} validity")


def assert_same_valid_table(port_table, jtable) -> None:
    """Identical types and validity masks, and identical data bytes
    wherever a value is valid. For results of the reference's fused,
    bucket-padded plans, whose null slots hold bytes of padding rows."""
    got = table_to_numpy(port_table)
    want = host_columns(jtable)
    assert len(got) == len(want), "column count"
    for i, (g, w) in enumerate(zip(got, want)):
        assert g[:2] == w[:2], f"column {i}: type {g[:2]} != {w[:2]}"
        if isinstance(w[2], tuple):
            # the same layout (and padded width), the same bytes per
            # valid row
            assert g[2][1].ndim == w[2][1].ndim, f"column {i}: layout"
            assert g[2][1].shape[1:] == w[2][1].shape[1:], \
                f"column {i}: padded width"
            grows, wrows = _string_rows(g[2]), _string_rows(w[2])
            n = len(wrows)
            assert len(grows) == n, f"column {i}: rows"
        else:
            n = len(w[2])
        gv = np.ones(n, bool) if g[3] is None else g[3]
        wv = np.ones(n, bool) if w[3] is None else w[3]
        assert_same_array(gv, wv, f"column {i} validity")
        if isinstance(w[2], tuple):
            assert [r for r, v in zip(grows, gv) if v] \
                == [r for r, v in zip(wrows, wv) if v], \
                f"column {i} valid strings"
        else:
            assert_same_array(g[2][gv], w[2][wv], f"column {i} valid data")


def random_host_columns(n: int, seed: int) -> list:
    """Every fixed-width family the slice ports, with null tails on every
    other column: int8/16/32/64, float32/64, TIMESTAMP_DAYS, DECIMAL64,
    DECIMAL128."""
    from spark_rapids_jni_tpu import types as jt

    rng = np.random.default_rng(seed)

    def tail():
        valid = rng.random(n) > 0.2
        valid[-max(1, n // 4):] = False
        return valid

    specs = [
        (jt.TypeId.INT8, 0, rng.integers(-128, 128, n).astype(np.int8)),
        (jt.TypeId.INT16, 0, rng.integers(-2**15, 2**15, n).astype(np.int16)),
        (jt.TypeId.INT32, 0, rng.integers(-2**31, 2**31, n).astype(np.int32)),
        (jt.TypeId.INT64, 0, rng.integers(-2**63, 2**63 - 1, n,
                                          dtype=np.int64)),
        (jt.TypeId.FLOAT32, 0, rng.standard_normal(n).astype(np.float32)),
        (jt.TypeId.FLOAT64, 0, rng.standard_normal(n) * 1e10),
        (jt.TypeId.TIMESTAMP_DAYS, 0,
         rng.integers(-30000, 30000, n).astype(np.int32)),
        (jt.TypeId.DECIMAL64, -2, rng.integers(-10**15, 10**15, n)),
        (jt.TypeId.DECIMAL128, -3,
         rng.integers(-2**63, 2**63 - 1, (n, 2), dtype=np.int64)),
    ]
    return [(int(tid), scale, data, tail() if i % 2 else None)
            for i, (tid, scale, data) in enumerate(specs)]


LEVEL_CASES = ["empty", "all_sentinel", "below_top", "at_top", "past_top",
               "past_line", "runs_across_lines", "max_key_valid"]


def level_case(case, dtype, top_keys, seed=11):
    """Build keys that reach one part of the kernel's index (sizes around
    the top level's capacity ``top_keys`` and one key past a full level
    of lines, duplicate runs across line boundaries, a valid key at the
    dtype max, the all-sentinel and empty builds), sorted and
    sentinel-padded, and probes that hit every build key, miss between
    them, and sit at the dtype's min and max."""
    rng = np.random.default_rng(seed)
    info = np.iinfo(dtype)
    # the kernel's line in keys: int32 keys stay, the rest widen to int64
    line = khp.line_keys(torch.int32 if dtype == np.int32 else torch.int64)
    if case == "empty":
        build = np.zeros(0, dtype)
    elif case == "all_sentinel":
        build = np.full(300, info.max, dtype)
    else:
        s = {"below_top": top_keys - 1, "at_top": top_keys,
             "past_top": top_keys + 1, "past_line": top_keys * line + 1,
             "runs_across_lines": top_keys * 2 * line,
             "max_key_valid": top_keys * 4}[case]
        if case == "runs_across_lines":
            # runs of 5..40 equal keys, most longer than a line
            runs = rng.integers(5, 41, s)
            keys = np.repeat(np.arange(len(runs)) * 3 - 50, runs)[:s]
        else:
            keys = np.sort(rng.choice(np.arange(-s, 3 * s), s)) \
                - min(s, 100)
        # negative keys wrap for unsigned types: sort after the cast
        build = np.concatenate([np.sort(keys.astype(np.int64).astype(dtype)),
                                np.full(s // 3, info.max, dtype)])
        if case == "max_key_valid":
            build[s - 3:s] = info.max  # valid keys equal to the sentinel
    keys = np.unique(build)
    probe = np.concatenate([
        np.asarray([info.min, info.max, info.max - 1, 0], dtype), keys,
        keys + np.asarray(1, dtype),  # the max wraps to the min
        rng.integers(-200, 200, 513).astype(dtype)])
    return build, probe


# ---- CastStrings: inputs shared by the CPU and card tests, and the parity
# helpers of the CPU tests -----------------------------------------------------

def arrow_strings(values, valid=None):
    """(offsets, chars, validity) of a list of str/bytes (None: an empty
    null row); ``valid`` overrides the validity, keeping every row's
    bytes."""
    chunks = [b"" if v is None else v.encode() if isinstance(v, str) else v
              for v in values]
    offsets = np.zeros(len(chunks) + 1, np.int32)
    np.cumsum([len(c) for c in chunks], out=offsets[1:])
    chars = np.frombuffer(b"".join(chunks), np.uint8).copy()
    if valid is None:
        valid = np.array([v is not None for v in values], bool)
    return offsets, chars, None if valid.all() else valid


def seeded_cast_strings(n: int, seed: int) -> list:
    """Mixed numeric, date, boolean and garbage strings, with whitespace
    and overlong rows."""
    rng = np.random.default_rng(seed)
    out = []
    for k in rng.integers(0, 10, n):
        if k == 0:
            out.append(str(int(rng.integers(-2**63, 2**63 - 1))))
        elif k == 1:
            out.append(f"{int(rng.integers(-10**7, 10**7))}."
                       f"{int(rng.integers(0, 100)):02d}")
        elif k == 2:
            out.append(repr(float(rng.standard_normal()
                                  * 10.0 ** rng.integers(-30, 30))))
        elif k == 3:
            y, m, d = (int(rng.integers(1, 10000)), int(rng.integers(0, 14)),
                       int(rng.integers(0, 33)))
            out.append(f"{y:04d}-{m}-{d:02d}")
        elif k == 4:
            out.append(["true", "F", "yes", "0", "no", "maybe"][
                int(rng.integers(0, 6))])
        elif k == 5:
            out.append(" " * int(rng.integers(0, 4))
                       + str(int(rng.integers(-999, 999)))
                       + "\t" * int(rng.integers(0, 3)))
        elif k == 6:
            out.append(f"{rng.uniform(-1e6, 1e6):.6f}e"
                       f"{int(rng.integers(-40, 40))}")
        elif k == 7:
            out.append("9" * int(rng.integers(17, 36)))
        elif k == 8:
            out.append(f"2020-0{int(rng.integers(1, 10))}-1"
                       f"{int(rng.integers(0, 10))} "
                       f"{int(rng.integers(0, 25))}:0{int(rng.integers(0, 10))}"
                       f":3{int(rng.integers(0, 10))}."
                       f"{int(rng.integers(0, 10**7))}")
        else:
            out.append(bytes(rng.integers(0, 256, int(rng.integers(0, 12)))
                             .astype(np.uint8)))
    return out


def null_tail(n: int, seed: int) -> np.ndarray:
    """Validity with random nulls and the last quarter null."""
    rng = np.random.default_rng(seed + 1)
    valid = rng.random(n) > 0.2
    valid[-max(1, n // 4):] = False
    return valid


def mixed_float_strings(n: int, seed: int) -> list:
    """m.ff, repr of floats across 1e+-20, 17-digit fractions, and
    integers with exponents out to +-330."""
    rng = np.random.default_rng(seed)
    out = []
    for k in rng.integers(0, 5, n):
        if k == 0:
            out.append(f"{int(rng.integers(-10**7, 10**7))}."
                       f"{int(rng.integers(0, 100)):02d}")
        elif k == 1:
            out.append(repr(float((-1) ** int(rng.integers(0, 2))
                                  * 10.0 ** rng.uniform(-20, 20))))
        elif k == 2:
            out.append(f"{int(rng.integers(0, 1000))}."
                       + "".join(str(d) for d in rng.integers(0, 10, 17)))
        elif k == 3:
            out.append(f"{int(rng.integers(1, 10**6))}e"
                       f"{int(rng.integers(-330, 331))}")
        else:
            out.append(f"{int(rng.integers(1, 10**15))}e"
                       f"{int(rng.integers(-40, 41))}")
    return out


def bench_strings(n: int) -> list:
    """``bench.py``'s CastStrings column: 4,096 ``"{m}.{ff}"`` templates
    (|m| < 1e7) from seed 0, tiled to n rows."""
    rng = np.random.default_rng(0)
    pool = []
    for _ in range(min(n, 4096)):
        mant = rng.integers(-10_000_000, 10_000_000)
        frac = rng.integers(0, 100)
        pool.append(f"{mant}.{frac:02d}")
    return (pool * (n // len(pool) + 1))[:n]


def both_strings(values, valid=None):
    """The same Arrow STRING column in the port (CPU) and the reference."""
    from spark_rapids_jni_tpu_torch import types as t
    from spark_rapids_jni_tpu_torch.columnar import Column

    offsets, chars, vmask = arrow_strings(values, valid)
    port = Column.from_numpy(offsets, t.STRING, vmask, device="cpu",
                             chars=chars)
    ref = jax_table([(int(t.TypeId.STRING), 0, (offsets, chars),
                      vmask)]).column(0)
    return port, ref


def both_fixed(data: np.ndarray, tid, scale=0, valid=None):
    """The same fixed-width column in the port (CPU) and the reference."""
    from spark_rapids_jni_tpu_torch import types as t
    from spark_rapids_jni_tpu_torch.columnar import Column

    port = Column.from_numpy(data, t.DType(t.TypeId(int(tid)), scale),
                             valid, device="cpu")
    return port, jax_table([(int(tid), scale, data, valid)]).column(0)


def assert_same_column(got, want) -> None:
    """``assert_same_table`` of one port column and one JAX column."""
    from spark_rapids_jni_tpu.columnar import Table as JTable
    from spark_rapids_jni_tpu_torch.columnar import Table

    assert_same_table(Table([got]), JTable([want]))


def assert_same_head(got, want, n: int, width=None) -> None:
    """The port column ``got`` equals the first ``n`` rows of the JAX
    column ``want`` (a padded STRING's first ``width`` byte columns),
    sliced on the host. The reference given only those rows would carry
    no validity where they are all valid, so an all-valid head compares
    equal to None."""
    from spark_rapids_jni_tpu.columnar import Table as JTable
    from spark_rapids_jni_tpu_torch.columnar import Table

    (tid, scale, data, valid), = host_columns(JTable([want]))
    data = (data[0][:n], data[1][:n, :width]) if isinstance(data, tuple) \
        else data[:n]
    if valid is not None:
        valid = valid[:n]
    (gtid, gscale, gdata, gvalid), = table_to_numpy(Table([got]))
    assert (gtid, gscale) == (tid, scale), "type"
    if isinstance(data, tuple):
        assert_same_array(gdata[0], data[0], "lengths")
        assert_same_array(gdata[1], data[1], "chars")
    else:
        assert_same_array(gdata, data, "data")
    if gvalid is None:
        assert valid is None or valid.all(), "tri-state"
    else:
        assert valid is not None, "tri-state"
        assert_same_array(gvalid, valid, "validity")


# the parse casts by kind: (function name, takes a dtype)
CASTS = {"integer": ("string_to_integer", True),
         "decimal": ("string_to_decimal", True),
         "float": ("string_to_float", True),
         "boolean": ("string_to_boolean", False),
         "date": ("string_to_date", False),
         "timestamp": ("string_to_timestamp", False)}
_cast_references: dict = {}


def cast_dtypes(name):
    """(port dtype, reference dtype) by name: "INT64", "decimal64:-2"."""
    from spark_rapids_jni_tpu import types as jt
    from spark_rapids_jni_tpu_torch import types as t

    if name.startswith("decimal"):
        kind, scale = name.split(":")
        return getattr(t, kind)(int(scale)), getattr(jt, kind)(int(scale))
    return getattr(t, name), getattr(jt, name)


def cast_port(kind, dtype_name, col):
    """The port's parse cast ``kind`` (to ``dtype_name``) of ``col``."""
    from spark_rapids_jni_tpu_torch.ops import cast_strings as pcs

    fn, typed = CASTS[kind]
    if typed:
        return getattr(pcs, fn)(col, cast_dtypes(dtype_name)[0])
    return getattr(pcs, fn)(col)


def cast_reference(kind, dtype_name):
    """The reference's parse cast, one callable per (kind, dtype) so that
    its compiles are shared between tests: traced into one XLA program
    for the exact casts (one compile per shape, not one per operation),
    eager for the float parse, which the trace could fuse differently."""
    import jax

    from spark_rapids_jni_tpu.ops import cast_strings as jcs

    key = (kind, dtype_name)
    if key not in _cast_references:
        fn, typed = CASTS[kind]
        fn = getattr(jcs, fn)
        if typed:
            fn = partial(fn, dtype=cast_dtypes(dtype_name)[1])
        _cast_references[key] = fn if kind == "float" else jax.jit(fn)
    return _cast_references[key]


def check_parse(kind, dtype_name, values, valid=None):
    """The port's and the reference's cast of the same strings are the
    same column; returns the port's."""
    port, ref = both_strings(values, valid)
    got = cast_port(kind, dtype_name, port)
    assert_same_column(got, cast_reference(kind, dtype_name)(ref))
    return got


# ---- row hash, bloom filter and datetime: inputs shared by the CPU and
# card tests -------------------------------------------------------------------

# DECIMAL128 values at the byte-image edges: zero and -1 (one byte), the
# 64- and 128-bit limits, and values whose first kept byte would flip the
# sign without one more filler byte (0x80, -0x81, 0x8000, ...)
DEC128_EDGES = [0, -1, 1, 2**63, -2**63, 2**63 - 1, -2**63 - 1, 2**64 - 1,
                2**64, -2**64, 2**127 - 1, -2**127, 0x80, 0x7F, -0x80,
                -0x81, 0xFF, 0x8000, -0x8001, 2**71, -2**71 - 1,
                (0x7F << 120) | 0x80, -(0x80 << 112)]


def dec128_limbs(values) -> np.ndarray:
    """int64[n, 2] (lo, hi) limbs of Python integers."""
    lo = [v & (2**64 - 1) for v in values]
    return np.array([[x - 2**64 if x >= 2**63 else x, v >> 64]
                     for x, v in zip(lo, values)], np.int64).reshape(-1, 2)


def _float_specials(dtype) -> np.ndarray:
    """-0.0, 0.0, the infinities, the canonical NaN and NaNs with other
    payloads and signs."""
    ibits = np.int32 if dtype == np.float32 else np.int64
    nans = ([0x7FC00000, 0x7F800001, -0x400000, 0x7FFFFFFF]
            if dtype == np.float32 else
            [0x7FF8000000000000, 0x7FF0000000000001, -0x8000000000000,
             0x7FFFFFFFFFFFFFFF])
    return np.concatenate([np.array([-0.0, 0.0, np.inf, -np.inf], dtype),
                           np.array(nans, ibits).view(dtype)])


def seeded_bytes(n: int, seed: int, max_len: int = 70) -> list:
    """``n`` random byte strings of 0..max_len bytes (every length up to
    ``max_len`` first, for the stripes, words, 4-byte lane and tails)."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, max_len + 1, n)
    lens[:min(n, max_len + 1)] = np.arange(min(n, max_len + 1))
    return [rng.integers(0, 256, k).astype(np.uint8).tobytes() for k in lens]


def hash_host_columns(n: int, seed: int, max_len: int = 70) -> list:
    """``[(type_id, scale, data, validity), ...]`` of every type the row
    hash takes (BOOL8 to UINT32, the day types, FLOAT32/64 with -0.0 and
    NaN payloads, INT64/UINT64 with their extremes, DECIMAL32/64/128 with
    DEC128_EDGES, STRING of 0 to ``max_len`` bytes as Arrow, a microsecond
    timestamp), every other column with a null tail; null rows keep
    their bytes."""
    from spark_rapids_jni_tpu_torch.types import TypeId as T

    rng = np.random.default_rng(seed)

    def ints(dtype):
        info = np.iinfo(dtype)
        v = rng.integers(info.min, info.max, n, dtype=dtype, endpoint=True)
        v[:2] = np.array([info.min, info.max], dtype)[:n]
        return v

    def floats(dtype):
        v = (rng.standard_normal(n) * 10.0 ** rng.integers(-5, 6, n)
             ).astype(dtype)
        sp = _float_specials(dtype)
        v[:len(sp)] = sp[:n]
        return v

    d128 = rng.integers(-2**63, 2**63 - 1, (n, 2), dtype=np.int64,
                        endpoint=True)
    edges = dec128_limbs(DEC128_EDGES)
    d128[:len(edges)] = edges[:n]
    strings = seeded_bytes(n, seed + 7, max_len)
    offsets = np.zeros(n + 1, np.int32)
    np.cumsum([len(b) for b in strings], out=offsets[1:])
    chars = np.frombuffer(b"".join(strings), np.uint8).copy()
    specs = [
        (T.BOOL8, 0, rng.integers(0, 2, n).astype(np.uint8)),
        (T.INT8, 0, ints(np.int8)), (T.UINT8, 0, ints(np.uint8)),
        (T.INT16, 0, ints(np.int16)), (T.UINT16, 0, ints(np.uint16)),
        (T.INT32, 0, ints(np.int32)), (T.UINT32, 0, ints(np.uint32)),
        (T.TIMESTAMP_DAYS, 0, ints(np.int32)),
        (T.DURATION_DAYS, 0, ints(np.int32)),
        (T.FLOAT32, 0, floats(np.float32)), (T.FLOAT64, 0, floats(np.float64)),
        (T.INT64, 0, ints(np.int64)), (T.UINT64, 0, ints(np.uint64)),
        (T.DECIMAL32, -2, ints(np.int32)), (T.DECIMAL64, -2, ints(np.int64)),
        (T.DECIMAL128, -3, d128), (T.STRING, 0, (offsets, chars)),
        (T.TIMESTAMP_MICROSECONDS, 0, ints(np.int64)),
    ]
    return [(int(tid), scale, data, null_tail(n, seed + i) if i % 2 else None)
            for i, (tid, scale, data) in enumerate(specs)]


def bloom_values(n: int, seed: int):
    """(int64 values with repeats and the int64 extremes, validity with a
    null tail)."""
    rng = np.random.default_rng(seed)
    v = rng.integers(-2**63, 2**63 - 1, n, dtype=np.int64, endpoint=True)
    v[:2] = np.array([-2**63, 2**63 - 1], np.int64)[:n]
    v[n // 2:] = v[:n - n // 2]  # repeats
    return v, null_tail(n, seed)


def seeded_days(n: int, seed: int) -> np.ndarray:
    """int32 days since 1970-01-01 from 1600 to 2400, with the century
    and leap-year edges first."""
    rng = np.random.default_rng(seed)
    d = rng.integers(-135_140, 157_000, n).astype(np.int32)
    edges = np.array([-135_140, -1, 0, 59, 60, 365, 10_956, 11_016,
                      -25_508, 157_000, 4_017, 47_541], np.int32)
    d[:len(edges)] = edges[:n]
    return d


TIMESTAMP_DIVS = {"TIMESTAMP_SECONDS": 86_400,
                  "TIMESTAMP_MILLISECONDS": 86_400_000,
                  "TIMESTAMP_MICROSECONDS": 86_400_000_000,
                  "TIMESTAMP_NANOSECONDS": 86_400_000_000_000}


def seeded_timestamps(n: int, seed: int, unit: str) -> np.ndarray:
    """int64 instants in ``unit``: the seeded days (nanoseconds: 1680 to
    2260, within int64) plus a seeded intra-day part, the first rows
    before 1970 and within a day of the epoch."""
    rng = np.random.default_rng(seed + 3)
    div = TIMESTAMP_DIVS[unit]
    days = seeded_days(n, seed).astype(np.int64)
    if unit == "TIMESTAMP_NANOSECONDS":
        days = np.clip(days, -106_000, 106_000)
    ts = days * div + rng.integers(0, div, n)
    ts[:8] = np.array([-1, -div, -div - 1, 0, div - 1, -div * 365 + 1,
                       div * 400 + 7, -3 * div // 2], np.int64)[:n]
    return ts


# ---- regex, JSON and case mapping: inputs shared by the CPU and card tests

from spark_rapids_jni_tpu_torch.models.bench_strings import (  # noqa: E402
    LOG_WORDS,
    json_templates,
    mixed_script_rows,
)


def log_lines(n: int, seed: int) -> list:
    """``bench.py``'s RLIKE column as host strings: 2-5 of its nine words
    joined by spaces, the word ``id=`` carrying the row number."""
    rng = np.random.default_rng(seed)
    return [" ".join(LOG_WORDS[j] + (str(i) if j == 5 else "")
                     for j in rng.integers(0, len(LOG_WORDS),
                                           int(rng.integers(2, 6))))
            for i in range(n)]


def bench_json_docs(n: int) -> list:
    """``bench.py``'s get_json_object column: its 4,096 templates from
    seed 0, tiled to n rows."""
    pool = json_templates(min(n, 4096))
    return (pool * (n // len(pool) + 1))[:n]


def assert_same_groups(got, want, tol=None) -> None:
    """A port groupby result against the reference's: ``num_groups`` and
    ``overflowed`` equal, and every column over the real groups equal in
    type, validity and data bytes (under nulls too), except the columns
    in ``tol`` ({column: relative bound}), FLOAT64 results of float sums
    taken in another order, held where valid to ``|got - want| <= rel *
    max(|want|, max_g |want_g|)`` with NaN equal to NaN."""
    assert int(got.num_groups) == int(want.num_groups), "num_groups"
    assert bool(got.overflowed) == bool(want.overflowed), "overflowed"
    k = min(int(want.num_groups), want.table.num_rows)
    got_cols = table_to_numpy(got.table)
    want_cols = host_columns(want.table)
    assert len(got_cols) == len(want_cols), "column count"
    tol = tol or {}
    for i, (g, w) in enumerate(zip(got_cols, want_cols)):
        assert g[:2] == w[:2], f"column {i}: type {g[:2]} != {w[:2]}"
        wv = np.ones(k, bool) if w[3] is None else w[3][:k]
        gv = np.ones(k, bool) if g[3] is None else g[3][:k]
        assert_same_array(gv, wv, f"column {i} validity")
        if isinstance(w[2], tuple):
            grows = [r for r, v in zip(_string_rows(g[2])[:k], gv) if v]
            wrows = [r for r, v in zip(_string_rows(w[2])[:k], wv) if v]
            assert grows == wrows, f"column {i} strings"
        elif i in tol:
            gd, wd = g[2][:k][wv], w[2][:k][wv]
            assert gd.dtype == wd.dtype, f"column {i} dtype"
            nan = np.isnan(wd)
            assert_same_array(np.isnan(gd), nan, f"column {i} NaNs")
            scale = np.abs(wd[~nan]).max(initial=0.0)
            np.testing.assert_allclose(
                gd[~nan], wd[~nan], rtol=tol[i], atol=tol[i] * scale,
                err_msg=f"column {i}")
        else:
            assert_same_array(g[2][:k], w[2][:k], f"column {i} data")


def reference_native(monkeypatch) -> None:
    """Point the JAX package's native loader at the library the port
    built (``build/torch_native/``) for one test: ``monkeypatch`` puts
    the loader back as it was, so the reference's own tests see it
    unchanged and nothing writes ``build/native/``."""
    import ctypes

    from spark_rapids_jni_tpu.runtime import native as jnative
    from spark_rapids_jni_tpu_torch.runtime.native import load_native

    lib = load_native()
    monkeypatch.setattr(jnative, "_loaded", jnative.NativeLib(
        ctypes.CDLL(str(lib.path)), lib.path))


def read_outcome(fn):
    """``("table", result)``, or ``("error", class name, op)`` when
    ``fn()`` raises: the op is the classified error's ``context["op"]``
    (None for an unclassified one)."""
    try:
        return ("table", fn())
    except Exception as exc:  # compared across the two packages
        ctx = getattr(exc, "context", None) or {}
        return ("error", type(exc).__name__, ctx.get("op"))


def assert_same_list_column(got, want) -> None:
    """A port LIST column equals a JAX one: offsets, validity and the
    child (``assert_same_column``) byte for byte."""
    assert int(got.dtype.type_id) == int(want.dtype.type_id), "type"
    assert_same_array(got.data.cpu().numpy(), np.asarray(want.data),
                      "offsets")
    assert (got.validity is None) == (want.validity is None), "tri-state"
    if got.validity is not None:
        assert_same_array(got.validity.cpu().numpy(),
                          np.asarray(want.validity), "validity")
    assert_same_column(got.children[0], want.children[0])


def assert_same_read(got, want) -> None:
    """Reader results across the packages: the same outcome; tables
    byte for byte (LIST columns by ``assert_same_list_column``, STRUCT
    columns field by field)."""
    assert got[0] == want[0], f"outcome {got} vs {want}"
    if got[0] == "error":
        assert got == want
        return
    pt, jt = got[1], want[1]
    assert pt.num_columns == jt.num_columns
    for pc, jc in zip(pt.columns, jt.columns):
        _assert_same_read_column(pc, jc)


def _assert_same_read_column(pc, jc) -> None:
    if pc.dtype.is_list:
        assert_same_list_column(pc, jc)
    elif int(pc.dtype.type_id) == 28:  # STRUCT
        assert int(jc.dtype.type_id) == 28, "type"
        assert_same_column(pc, jc)  # placeholder bytes and validity
        assert len(pc.children) == len(jc.children), "field count"
        for pf, jf in zip(pc.children, jc.children):
            _assert_same_read_column(pf, jf)
    else:
        assert_same_column(pc, jc)


def writer_module(name: str):
    """The tests' file writer ``tests/<name>.py`` (``thrift_util``,
    ``parquet_util`` or ``orc_util``), loaded from this directory under
    its ``tests.<name>`` name with the writers it imports: another
    package named ``tests`` on the path (the card's machine has one)
    must not shadow them."""
    import importlib.util
    import sys
    from pathlib import Path

    here = Path(__file__).resolve().parent
    chain = ("thrift_util", "parquet_util", "orc_util")
    for dep in chain[:chain.index(name) + 1]:
        key = f"tests.{dep}"
        mod = sys.modules.get(key)
        if mod is not None and Path(mod.__file__).resolve().parent == here:
            continue
        spec = importlib.util.spec_from_file_location(key, here / f"{dep}.py")
        mod = importlib.util.module_from_spec(spec)
        sys.modules[key] = mod
        spec.loader.exec_module(mod)
    return sys.modules[f"tests.{name}"]


# the reference's fusion.execute runs its fused (bucket-padded, traced)
# region at these row counts in the executor tests, its force_staged
# walk at the other edge counts: its contract makes the two bit-identical
FUSED_ROWS = (256, 2049)


def with_null_tails(jtab, cols, seed):
    """A JAX table with ``null_tail`` validity (random nulls, the last
    quarter null) in ``cols``, and the same table for the port."""
    host = host_columns(jtab)
    for i in cols:
        tid, scale, data, _ = host[i]
        host[i] = (tid, scale, data, null_tail(len(data), seed + i))
    ref = jax_table(host)
    return to_port(ref), ref


def ref_execute(plan, bindings, n):
    """The reference's ``fusion.execute``: fused at ``FUSED_ROWS``,
    staged otherwise."""
    from spark_rapids_jni_tpu.runtime import fusion as jfusion

    return jfusion.execute(plan, bindings, force_staged=n not in FUSED_ROWS)


def same_meta(got: dict, want: dict) -> None:
    """The port's plan meta equals the reference's as values: the same
    keys, each value a device tensor (a string for ``lowered``)."""
    assert set(got) == set(want), (sorted(got), sorted(want))
    for key, w in want.items():
        g = got[key]
        if isinstance(w, str):
            assert g == w, key
            continue
        assert isinstance(g, torch.Tensor), f"{key}: not a device tensor"
        assert np.asarray(g).tolist() == np.asarray(w).tolist(), key


def mapped_fingerprint(fingerprint):
    """A reference plan fingerprint with the JAX package's module prefix
    mapped to the port's (callables are keyed by qualified name), and a
    test file's ``*_ref`` callables to their ``*_port`` twins."""
    def walk(x):
        if isinstance(x, tuple):
            return tuple(walk(v) for v in x)
        if isinstance(x, str) and x.startswith("spark_rapids_jni_tpu."):
            return "spark_rapids_jni_tpu_torch." + x[len(
                "spark_rapids_jni_tpu."):]
        if isinstance(x, str) and x.endswith("_ref"):
            return x[:-len("_ref")] + "_port"
        return x
    return walk(fingerprint)


# ---- the bridge's C ABI, driven through ctypes -----------------------------

# the reference's 8-column table (RowConversionTest.java:30-39; the C self
# test's): (type_id, scale, values), the last row null in every column
RT_TABLE = [
    (4, 0, np.array([3, 9, 4, 2, 20, 0], np.int64)),
    (10, 0, np.array([5.0, 9.5, 0.9, 7.23, 2.8, 0.0], np.float64)),
    (3, 0, np.array([5, 1, 0, 2, 7, 0], np.int32)),
    (11, 0, np.array([1, 0, 0, 1, 0, 0], np.uint8)),
    (9, 0, np.array([1.0, 3.5, 5.9, 7.1, 9.8, 0.0], np.float32)),
    (1, 0, np.array([2, 3, 4, 5, 9, 0], np.int8)),
    (25, -3, np.array([5000, 9500, 900, 7230, 2800, 0], np.int32)),
    (26, -8, np.array([300000000, 900000000, 400000000, 200000000,
                       2000000000, 0], np.int64)),
]
RT_VALID = np.array([1, 1, 1, 1, 1, 0], bool)


def rt_check(lib, ok: bool, what: str) -> None:
    assert ok, f"{what}: {lib.tpudf_rt_last_error()!r}"


def rt_column(lib, type_id: int, scale: int, data: np.ndarray,
              valid=None) -> int:
    """``tpudf_rt_column_from_host`` of a host array (DECIMAL128: int64
    limb pairs); ``valid`` bool[n] or None."""
    data = np.ascontiguousarray(data)
    vbytes = None if valid is None else np.asarray(valid, np.uint8).tobytes()
    h = lib.tpudf_rt_column_from_host(type_id, scale, data.shape[0],
                                      data.tobytes(), data.nbytes, vbytes)
    rt_check(lib, h > 0, "column_from_host")
    return h


def rt_table(lib, handles) -> int:
    import ctypes

    arr = (ctypes.c_int64 * len(handles))(*handles)
    h = lib.tpudf_rt_table_create(arr, len(handles))
    rt_check(lib, h > 0, "table_create")
    return h


def rt_to_rows(lib, table: int, cap: int = 8) -> list:
    import ctypes

    out = (ctypes.c_int64 * cap)()
    n = ctypes.c_int32(0)
    rt_check(lib, lib.tpudf_rt_convert_to_rows(table, out, cap,
                                               ctypes.byref(n)) == 0,
             "convert_to_rows")
    return list(out[:n.value])


def rt_rows_info(lib, rows: int) -> tuple:
    import ctypes

    n, size = ctypes.c_int64(0), ctypes.c_int64(0)
    rt_check(lib, lib.tpudf_rt_rows_info(rows, ctypes.byref(n),
                                         ctypes.byref(size)) == 0,
             "rows_info")
    return n.value, size.value


def rt_rows_bytes(lib, rows: int) -> np.ndarray:
    n, size = rt_rows_info(lib, rows)
    buf = np.empty(n * size, np.uint8)
    rt_check(lib, lib.tpudf_rt_rows_to_host(rows, buf.ctypes.data,
                                            buf.nbytes) == 0, "rows_to_host")
    return buf


def rt_from_rows(lib, rows: int, schema) -> int:
    """``tpudf_rt_convert_from_rows`` with ``[(type_id, scale), ...]``."""
    import ctypes

    k = len(schema)
    tids = (ctypes.c_int32 * k)(*[tid for tid, _ in schema])
    scales = (ctypes.c_int32 * k)(*[s for _, s in schema])
    h = lib.tpudf_rt_convert_from_rows(rows, tids, scales, k)
    rt_check(lib, h > 0, "convert_from_rows")
    return h


def rt_column_host(lib, table: int, i: int, width: int) -> tuple:
    """Column ``i`` of a table handle: ((type_id, scale, rows), data
    bytes, one byte of validity a row)."""
    import ctypes

    col = lib.tpudf_rt_table_column(table, i)
    rt_check(lib, col > 0, "table_column")
    tid, scale, n = ctypes.c_int32(0), ctypes.c_int32(0), ctypes.c_int64(0)
    rt_check(lib, lib.tpudf_rt_column_info(
        col, ctypes.byref(tid), ctypes.byref(scale), ctypes.byref(n)) == 0,
        "column_info")
    data = np.empty(n.value * width, np.uint8)
    valid = np.empty(n.value, np.uint8)
    rt_check(lib, lib.tpudf_rt_column_to_host(
        col, data.ctypes.data, data.nbytes, valid.ctypes.data,
        valid.nbytes) == 0, "column_to_host")
    lib.tpudf_rt_free(col)
    return (tid.value, scale.value, n.value), data, valid


# ---- nested columns (LIST, STRUCT) across the two packages ----------------
#
# A host spec of one column: a leaf ``(type_id, scale, data, validity)``
# (a STRING's data the pair (offsets or lengths, chars)), a LIST
# ``("list", offsets, validity, child_spec)`` or a STRUCT ``("struct",
# n, validity, [field_spec, ...])``.


def spec_to_port(spec, device="cpu"):
    from spark_rapids_jni_tpu_torch import types as t
    from spark_rapids_jni_tpu_torch.columnar import Column

    def dev(x):
        return None if x is None else torch.from_numpy(x).to(device)

    if spec[0] == "list":
        _, offsets, valid, child = spec
        return Column(t.LIST, dev(offsets.astype(np.int32)), dev(valid),
                      children=[spec_to_port(child, device)])
    if spec[0] == "struct":
        _, n, valid, fields = spec
        return Column(t.DType(t.TypeId.STRUCT),
                      torch.zeros(n, dtype=torch.uint8, device=device),
                      dev(valid),
                      children=[spec_to_port(f, device) for f in fields])
    return table_from_numpy([spec], device=device).column(0)


def spec_to_jax(spec):
    import jax.numpy as jnp

    from spark_rapids_jni_tpu import types as jt
    from spark_rapids_jni_tpu.columnar import Column as JColumn

    if spec[0] == "list":
        _, offsets, valid, child = spec
        return JColumn(jt.DType(jt.TypeId.LIST),
                       jnp.asarray(offsets.astype(np.int32)),
                       None if valid is None else jnp.asarray(valid),
                       children=[spec_to_jax(child)])
    if spec[0] == "struct":
        _, n, valid, fields = spec
        return JColumn(jt.DType(jt.TypeId.STRUCT), jnp.zeros(n, jnp.uint8),
                       None if valid is None else jnp.asarray(valid),
                       children=[spec_to_jax(f) for f in fields])
    return jax_table([spec]).column(0)


def both_spec(spec):
    """The same column in the port (CPU) and the reference."""
    return spec_to_port(spec), spec_to_jax(spec)


def _host(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def canon(col) -> list:
    """One column of either package as a list of rows: None for a null
    row, else the value's bytes (a fixed-width value's storage bytes, a
    string's bytes), a LIST row's tuple of its elements, a STRUCT row's
    tuple of its fields. Data under nulls and layouts (padded or Arrow,
    padded child tails) do not show; every valid bit does, except a NaN's
    sign and payload (IEEE and Spark leave them open): every float NaN
    reads as ``"NaN"``."""
    tid = int(col.dtype.type_id)
    n = col.size
    valid = np.ones(n, bool) if col.validity is None else _host(col.validity)
    if tid == 24:  # LIST
        child = col.children[0]
        if child.validity is not None and child.validity.ndim == 2:
            lens = _host(col.data)
            mat, ev = _host(child.data), _host(child.validity)
            rows = [tuple(_value(mat[i, j]) if ev[i, j] else None
                          for j in range(lens[i])) for i in range(n)]
        else:
            off = _host(col.data)
            kids = canon(child)
            rows = [tuple(kids[off[i]:off[i + 1]]) for i in range(n)]
    elif tid == 28:  # STRUCT
        fields = [canon(f) for f in col.children]
        rows = [tuple(f[i] for f in fields) for i in range(n)]
    elif tid == 23:  # STRING
        rows = _string_rows((_host(col.data), _host(col.chars)))
    else:
        data = _host(col.data)
        rows = [_value(data[i]) for i in range(n)]
    return [r if v else None for r, v in zip(rows, valid)]


def _value(x) -> object:
    """One fixed-width value's bytes; every float NaN reads as "NaN"."""
    if x.dtype.kind == "f" and np.isnan(x):
        return "NaN"
    return x.tobytes()


def _type_tree(col):
    return (int(col.dtype.type_id), int(col.dtype.scale),
            tuple(_type_tree(c) for c in (col.children or [])))


def assert_same_rows(got, want, what="") -> None:
    """A port column equals a reference column row for row under
    validity (``canon``), with the same type tree."""
    assert _type_tree(got) == _type_tree(want), \
        f"{what}: type {_type_tree(got)} != {_type_tree(want)}"
    g, w = canon(got), canon(want)
    assert len(g) == len(w), f"{what}: {len(g)} rows != {len(w)}"
    bad = [i for i, (a, b) in enumerate(zip(g, w)) if a != b]
    assert not bad, f"{what}: first of {len(bad)} differing rows {bad[0]}: " \
        f"{g[bad[0]]!r} != {w[bad[0]]!r}"


def assert_same_table_rows(got, want, what="") -> None:
    assert got.num_columns == want.num_columns, f"{what}: column count"
    for i, (g, w) in enumerate(zip(got.columns, want.columns)):
        assert_same_rows(g, w, f"{what} column {i}")


def error_of(fn):
    """The class name of the error ``fn()`` raises (None if none)."""
    try:
        fn()
    except Exception as exc:  # compared across the two packages
        return type(exc).__name__
    return None


# ---- LIST inputs, and the reference traced -------------------------------

LIST_WORDS = ["", "a", "bb", "a", "ccc", "dd", "é"]


def child_spec(m: int, seed: int, elem: str):
    """m list elements of one type ("i64", "f64" with NaN, "str",
    "d128"), ~15 % null, small domains so lists
    hold duplicates."""
    rng = np.random.default_rng(seed)
    valid = rng.random(m) > 0.15
    if elem == "i64":
        return (4, 0, rng.integers(-6, 7, m).astype(np.int64), valid)
    if elem == "f64":
        v = rng.integers(-4, 5, m) * 0.5
        v[rng.random(m) < 0.1] = np.nan
        return (10, 0, v.astype(np.float64), valid)
    if elem == "str":
        off, chars, _ = arrow_strings([LIST_WORDS[i] for i in
                                       rng.integers(0, len(LIST_WORDS), m)])
        return (23, 0, (off, chars), valid)
    lo = rng.integers(-3, 4, m)
    return (27, -2, np.stack([lo, lo >> 63], axis=1).astype(np.int64),
            valid)


def list_spec(n: int, seed: int, elem: str, max_len: int = 6):
    """n lists of 0..max_len elements, every 9th row null."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, max_len + 1, n)
    valid = np.arange(n) % 9 != 4
    lens[~valid] = 0
    off = np.zeros(n + 1, np.int32)
    off[1:] = np.cumsum(lens)
    return ("list", off, valid, child_spec(int(off[-1]), seed + 1, elem))


LIST_SCALAR = {"i64": 3, "f64": 1.5, "str": "bb", "d128": 2}


def _padded(x):
    """A reference column or table with every STRING, nested ones too,
    in the padded layout (jit needs static widths)."""
    from spark_rapids_jni_tpu.columnar import Column as JColumn
    from spark_rapids_jni_tpu.columnar import Table as JTable
    from spark_rapids_jni_tpu.ops.strings import pad_strings

    if isinstance(x, JTable):
        return JTable([_padded(c) for c in x.columns])
    if not isinstance(x, JColumn):
        return x
    if x.dtype.is_string:
        return pad_strings(x)
    if x.children:
        return JColumn(x.dtype, x.data, x.validity,
                       children=[_padded(c) for c in x.children])
    return x


def jref(fn, *args):
    """``fn(*args)`` of the JAX package traced into one program (compiled
    once, not op by op), strings padded first. Exact: these functions'
    results are integers, bytes and selected floats, no float
    arithmetic."""
    import jax

    return jax.jit(fn)(*[_padded(a) for a in args])


# ---- the window tests' table -----------------------------------------------

WINDOW_PART, WINDOW_ORDER, _F64, _I64, _D128, _PRICE = range(6)

# the window functions the CPU and card tests run: name -> (method, args)
WINDOW_CALLS = {
    "row_number": ("row_number", ()),
    "rank": ("rank", ()),
    "dense_rank": ("dense_rank", ()),
    "percent_rank": ("percent_rank", ()),
    "cume_dist": ("cume_dist", ()),
    "ntile_4": ("ntile", (4,)),
    "ntile_7": ("ntile", (7,)),
    "lag_f64": ("lag", (_F64,)),
    "lag_2_d128": ("lag", (_D128, 2)),
    "lead_3_i64": ("lead", (_I64, 3)),
    "lead_0": ("lead", (_F64, 0)),
    "running_sum_f64": ("running_sum", (_F64,)),
    "running_sum_i64": ("running_sum", (_I64,)),
    "running_sum_dec": ("running_sum", (_PRICE,)),
    "running_min_f64": ("running_min", (_F64,)),
    "running_max_i64": ("running_max", (_I64,)),
    "rolling_sum_f64": ("rolling_sum", (_F64, 6)),
    "rolling_sum_i64": ("rolling_sum", (_I64, 2, 1)),
    "rolling_sum_dec": ("rolling_sum", (_PRICE, 3, 3)),
    "rolling_sum_d128": ("rolling_sum", (_D128, 6)),
    "rolling_count": ("rolling_count", (_D128, 4, 2)),
    "rolling_mean_f64": ("rolling_mean", (_F64, 6)),
    "rolling_mean_dec": ("rolling_mean", (_PRICE, 2, 2)),
    "rolling_min_f64": ("rolling_min", (_F64, 6)),
    "rolling_max_i64": ("rolling_max", (_I64, 2, 3)),
    "rolling_var_f64": ("rolling_var", (_F64, 6)),
    "rolling_var_pop": ("rolling_var", (_I64, 3, 1, 0)),
    "rolling_std_i64": ("rolling_std", (_I64, 3, 1, 0)),
    "rolling_std_dec": ("rolling_std", (_PRICE, 5)),
    "range_sum_i64": ("rolling_sum", (_I64, 5, 0, "range")),
    "range_max_f64": ("rolling_max", (_F64, 5, 0, "range")),
    "range_min_i64": ("rolling_min", (_I64, 10, 3, "range")),
    "range_mean_f64": ("rolling_mean", (_F64, 3, 3, "range")),
    "range_sum_d128": ("rolling_sum", (_D128, 4, 0, "range")),
    "range_count": ("rolling_count", (_F64, 8, 8, "range")),
    "first_value": ("first_value", (_F64,)),
    "last_value": ("last_value", (_D128,)),
    "nth_value_2": ("nth_value", (_I64, 2)),
    "nth_value_5": ("nth_value", (_PRICE, 5)),
}


def window_columns(n: int, seed: int) -> list:
    """[partition INT32 (~20 rows each), order INT64 (ties, ~10 % null),
    FLOAT64 (NaN, null tail), INT64 (null tail), DECIMAL128 (null tail),
    DECIMAL64 price]."""
    rng = np.random.default_rng(seed)
    f = rng.standard_normal(n) * 10.0 ** rng.integers(-2, 6, n)
    f[rng.random(n) < 0.05] = np.nan
    order_valid = rng.random(n) > 0.1
    return [
        (3, 0, rng.integers(0, max(1, n // 20), n).astype(np.int32), None),
        (4, 0, rng.integers(0, 50, n), order_valid),
        (10, 0, f, null_tail(n, seed)),
        (4, 0, rng.integers(-10**12, 10**12, n), null_tail(n, seed + 1)),
        (27, -2, rng.integers(-2**62, 2**62, (n, 2), dtype=np.int64),
         null_tail(n, seed + 2)),
        (26, -2, rng.integers(-10**9, 10**9, n), None),
    ]
