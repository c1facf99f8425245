"""The port's ``Window`` (``ops/window.py``) against the JAX package's, on
the same table: PARTITION BY an INT32 key ORDER BY an INT64 key with
nulls, and every window function over INT64, FLOAT64 (NaN, nulls) and
DECIMAL128 columns with null tails, at 1, 256, 257 and 2049 rows.

The reference runs traced, all its calls for one table in one program
(eagerly it costs ~2 s a call on this CPU; traced, its float adds
round as eagerly: each is one IEEE operation in the segmented scan),
but for the decimal variance, whose rescale XLA fuses differently when
traced: those run eagerly.
Every result is equal row for row under validity: integers, decimals
and float bits alike (the port's float running and rolling sums take
the reference's ``associative_scan`` pairing). RANGE frames over float,
decimal and edge keys, strings and multi-key specs are in
``test_torch_window_frames.py``."""

from __future__ import annotations

import functools

import numpy as np
import pytest

from spark_rapids_jni_tpu.ops.window import Window as JWindow
from spark_rapids_jni_tpu_torch.ops.window import Window, sqrt_rn
from torch_parity import (
    WINDOW_CALLS,
    WINDOW_ORDER,
    WINDOW_PART,
    assert_same_rows,
    jax_table,
    to_port,
    window_columns,
)

WINDOW_ROWS = [1, 256, 257, 2049]
CALLS = WINDOW_CALLS


# traced, XLA fuses the decimal rescale into the variance's arithmetic
# and moves its last bits: these calls run eagerly (~20 s a row count),
# at 257 rows
EAGER = ("rolling_std_dec",)
EAGER_ROWS = (257,)


@functools.lru_cache(maxsize=None)
def _case(n: int):
    import jax

    jt = jax_table(window_columns(n, n))

    def every_call(t):
        w = JWindow(t, [WINDOW_PART], [WINDOW_ORDER])
        return {k: getattr(w, name)(*args)
                for k, (name, args) in CALLS.items() if k not in EAGER}

    want = jax.jit(every_call)(jt)
    if n in EAGER_ROWS:
        eager = JWindow(jt, [WINDOW_PART], [WINDOW_ORDER])
        for k in EAGER:
            name, args = CALLS[k]
            want[k] = getattr(eager, name)(*args)
    return Window(to_port(jt), [WINDOW_PART], [WINDOW_ORDER]), want


@pytest.mark.parametrize("n,call", [
    (n, c) for c in CALLS for n in WINDOW_ROWS
    if c not in EAGER or n in EAGER_ROWS])
def test_window_function(n, call):
    port, want = _case(n)
    name, args = CALLS[call]
    assert_same_rows(getattr(port, name)(*args), want[call], call)


def test_correctly_rounded_sqrt():
    """torch's CPU sqrt is one ulp off on some inputs; rolling_std's root
    is the correctly rounded one (numpy's), on every device."""
    import torch

    rng = np.random.default_rng(5)
    x = np.abs(rng.standard_normal(100_000)) * 10.0 ** rng.integers(
        -300, 300, 100_000)
    x = np.concatenate([x, [2.78896475e+11, 0.0, np.inf, np.nan, 5e-324]])
    got = sqrt_rn(torch.from_numpy(x)).numpy()
    want = np.sqrt(x)
    assert np.array_equal(got, want, equal_nan=True)
