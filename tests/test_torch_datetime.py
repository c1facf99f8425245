"""The port's datetime ops (``ops/datetime.py``) against the JAX package
on the CPU, bit for bit (types, validity and every data byte): every
function over days from 1600 to 2400 with null tails at the reference's
edge row counts; the time-of-day, calendar and ``months_between``
functions over pre-1970 instants of each timestamp unit; ``trunc`` for
every unit the reference accepts, ``next_day``'s names, and the inputs
both sides refuse."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu.ops import datetime as jdt
from spark_rapids_jni_tpu_torch import types as t
from spark_rapids_jni_tpu_torch.ops import datetime as pdt
from torch_parity import (
    EDGE_ROWS,
    TIMESTAMP_DIVS,
    assert_same_column,
    both_fixed,
    null_tail,
    seeded_days,
    seeded_timestamps,
)

DATE_FUNCTIONS = ["year", "month", "day", "day_of_week",
                  "day_of_week_spark", "day_of_year", "quarter", "last_day",
                  "weekofyear"]
TRUNC_UNITS = ["year", "quarter", "month", "week", "YEAR", "Week"]
DAY_NAMES = ["mo", "TUE", "wednesday", "th", "Fri", "saturday", " su "]


def _dates(n, seed, nulls=True):
    return both_fixed(seeded_days(n, seed), t.TypeId.TIMESTAMP_DAYS, 0,
                      null_tail(n, seed) if nulls else None)


def _check(name, *args, **kw):
    got = getattr(pdt, name)(*[a[0] for a in args], **kw)
    want = getattr(jdt, name)(*[a[1] for a in args], **kw)
    assert_same_column(got, want)


@pytest.mark.parametrize("n", EDGE_ROWS)
def test_date_functions_match_reference(n):
    d, d2 = _dates(n, n), _dates(n, n + 1, nulls=False)
    for name in DATE_FUNCTIONS:
        _check(name, d)
    for unit in TRUNC_UNITS:
        _check("trunc", d, unit=unit)
    for name in DAY_NAMES:
        _check("next_day", d, day_name=name)
    for k in (-45, 0, 400):
        _check("date_add", d, days=k)
    for k in (-25, -1, 1, 13):
        _check("add_months", d, n=k)
    _check("datediff", d, d2)
    _check("datediff", d2, d)
    _check("months_between", d, d2)
    _check("months_between", d2, d, round_off=False)


def test_date_add_takes_a_day_column():
    d = _dates(257, 3)
    days = np.random.default_rng(4).integers(-10_000, 10_000, 257)
    got = pdt.date_add(d[0], torch.from_numpy(days))
    import jax.numpy as jnp

    assert_same_column(got, jdt.date_add(d[1], jnp.asarray(days)))


@pytest.mark.parametrize("n", [257, 2049])
@pytest.mark.parametrize("unit", list(TIMESTAMP_DIVS))
def test_timestamp_functions_match_reference(unit, n):
    ts = both_fixed(seeded_timestamps(n, n, unit), t.TypeId[unit], 0,
                    null_tail(n, n))
    dates = _dates(n, n + 2, nulls=False)
    for name in DATE_FUNCTIONS + ["hour", "minute", "second"]:
        _check(name, ts)
    _check("trunc", ts, unit="week")
    _check("trunc", ts, unit="quarter")
    _check("next_day", ts, day_name="sun")
    _check("datediff", ts, dates)
    _check("months_between", ts, dates)
    _check("months_between", dates, ts, round_off=False)
    micro = both_fixed(seeded_timestamps(n, n + 5, "TIMESTAMP_MICROSECONDS"),
                       t.TypeId.TIMESTAMP_MICROSECONDS)
    _check("months_between", ts, micro)


def test_bad_inputs_raise_as_the_reference_does():
    d = _dates(8, 1)
    days_i32 = both_fixed(np.arange(8, dtype=np.int32), t.TypeId.INT32)
    ts = both_fixed(np.arange(8, dtype=np.int64) * 10**6,
                    t.TypeId.TIMESTAMP_MICROSECONDS)
    cases = [
        ("trunc", (d,), {"unit": "day"}, ValueError),
        ("next_day", (d,), {"day_name": "xyz"}, ValueError),
        ("next_day", (d,), {"day_name": "m"}, ValueError),
        ("year", (days_i32,), {}, NotImplementedError),
        ("hour", (d,), {}, NotImplementedError),
        ("date_add", (ts,), {"days": 1}, NotImplementedError),
        ("add_months", (ts,), {"n": 1}, NotImplementedError),
    ]
    for name, args, kw, err in cases:
        with pytest.raises(err):
            getattr(pdt, name)(*[a[0] for a in args], **kw)
        with pytest.raises(err):
            getattr(jdt, name)(*[a[1] for a in args], **kw)
