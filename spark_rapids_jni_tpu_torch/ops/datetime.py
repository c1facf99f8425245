"""Datetime extraction and arithmetic over DATE/TIMESTAMP columns
(counterpart of ``spark_rapids_jni_tpu/ops/datetime.py``): Spark's
year()/month()/dayofmonth()/date_add()/datediff()/last_day()/trunc() and
friends.

The civil calendar is ``ops/_calendar.py``'s branch-free integer
arithmetic. Timestamps reduce to days and an intra-day remainder by
FLOOR division (``torch.div(..., rounding_mode="floor")`` and
``torch.remainder``), so pre-1970 instants land on the right earlier day
with a non-negative remainder.

Null semantics: null in, null out, per row (Spark). Every result carries
a materialized validity mask, as in the reference.
"""

from __future__ import annotations

import torch

from spark_rapids_jni_tpu_torch.columnar import Column
from spark_rapids_jni_tpu_torch.ops._calendar import (
    civil_from_days,
    days_from_civil,
)
from spark_rapids_jni_tpu_torch.types import DType, TypeId

_DAY_US = 86_400_000_000

_TS_TO_DAY_DIV = {
    TypeId.TIMESTAMP_DAYS: 1,
    TypeId.TIMESTAMP_SECONDS: 86_400,
    TypeId.TIMESTAMP_MILLISECONDS: 86_400_000,
    TypeId.TIMESTAMP_MICROSECONDS: _DAY_US,
    TypeId.TIMESTAMP_NANOSECONDS: 86_400_000_000_000,
}
_INT32 = DType(TypeId.INT32)
_DAYS = DType(TypeId.TIMESTAMP_DAYS)


def _fdiv(a: torch.Tensor, b) -> torch.Tensor:
    return torch.div(a, b, rounding_mode="floor")


def _days_since_epoch(col: Column) -> torch.Tensor:
    """int64 civil days since 1970-01-01 (floor division)."""
    div = _TS_TO_DAY_DIV.get(col.dtype.type_id)
    if div is None:
        raise NotImplementedError(
            f"datetime op needs a DATE/TIMESTAMP column, got {col.dtype}")
    d = col.data.to(torch.int64)
    return d if div == 1 else _fdiv(d, div)


def _int_out(col: Column, vals: torch.Tensor, dtype: DType = _INT32
             ) -> Column:
    return Column(dtype, vals.to(dtype.torch_dtype), col.valid_mask())


def _ones(x: torch.Tensor) -> torch.Tensor:
    return torch.ones_like(x)


def year(col: Column) -> Column:
    """Civil year (Spark year())."""
    y, _, _ = civil_from_days(_days_since_epoch(col))
    return _int_out(col, y)


def month(col: Column) -> Column:
    """Civil month 1-12 (Spark month())."""
    _, m, _ = civil_from_days(_days_since_epoch(col))
    return _int_out(col, m)


def day(col: Column) -> Column:
    """Day of month 1-31 (Spark dayofmonth())."""
    _, _, d = civil_from_days(_days_since_epoch(col))
    return _int_out(col, d)


def day_of_week(col: Column) -> Column:
    """ISO day of week, Monday=1..Sunday=7 (1970-01-01 was a Thursday)."""
    z = _days_since_epoch(col)
    return _int_out(col, torch.remainder(z + 3, 7) + 1)


def day_of_week_spark(col: Column) -> Column:
    """Spark dayofweek(): Sunday=1..Saturday=7."""
    z = _days_since_epoch(col)
    return _int_out(col, torch.remainder(z + 4, 7) + 1)


def day_of_year(col: Column) -> Column:
    """1-based ordinal day within the year (Spark dayofyear())."""
    z = _days_since_epoch(col)
    y, _, _ = civil_from_days(z)
    return _int_out(col, z - days_from_civil(y, _ones(y), _ones(y)) + 1)


def quarter(col: Column) -> Column:
    _, m, _ = civil_from_days(_days_since_epoch(col))
    return _int_out(col, _fdiv(m - 1, 3) + 1)


def last_day(col: Column) -> Column:
    """Last day of the instant's month, as TIMESTAMP_DAYS (Spark
    last_day())."""
    y, m, _ = civil_from_days(_days_since_epoch(col))
    ny = y + (m == 12).to(torch.int64)
    nm = torch.where(m == 12, 1, m + 1)
    return _int_out(col, days_from_civil(ny, nm, _ones(nm)) - 1, _DAYS)


def date_add(col: Column, days) -> Column:
    """DATE +/- integer days (an int or a per-row tensor; Spark date_add,
    and date_sub through a negative count)."""
    if col.dtype.type_id != TypeId.TIMESTAMP_DAYS:
        raise NotImplementedError("date_add needs a TIMESTAMP_DAYS column")
    return _int_out(col, col.data.to(torch.int64) + days, _DAYS)


def datediff(end: Column, start: Column) -> Column:
    """end - start in whole civil days (Spark datediff)."""
    d = _days_since_epoch(end) - _days_since_epoch(start)
    return Column(_INT32, d.to(torch.int32),
                  end.valid_mask() & start.valid_mask())


def add_months(col: Column, n: int) -> Column:
    """Calendar-aware month shift; the day of month clamps to the target
    month's length (Spark add_months: Jan 31 + 1 month = Feb 28/29)."""
    if col.dtype.type_id != TypeId.TIMESTAMP_DAYS:
        raise NotImplementedError(
            "add_months needs a TIMESTAMP_DAYS column")
    y, m, d = civil_from_days(_days_since_epoch(col))
    tot = y * 12 + (m - 1) + n
    ny = _fdiv(tot, 12)
    nm = tot - ny * 12 + 1
    ny2 = ny + (nm == 12).to(torch.int64)
    nm2 = torch.where(nm == 12, 1, nm + 1)
    month_len = (days_from_civil(ny2, nm2, _ones(nm))
                 - days_from_civil(ny, nm, _ones(nm)))
    out = days_from_civil(ny, nm, torch.minimum(d, month_len))
    return _int_out(col, out, _DAYS)


_TRUNC_UNITS = ("year", "quarter", "month", "week")


def trunc(col: Column, unit: str) -> Column:
    """Truncate to the start of the year, quarter, month or ISO week
    (Spark trunc())."""
    unit = unit.lower()
    if unit not in _TRUNC_UNITS:
        raise ValueError(f"trunc unit must be one of {_TRUNC_UNITS}")
    z = _days_since_epoch(col)
    if unit == "week":  # back to Monday
        out = z - torch.remainder(z + 3, 7)
    else:
        y, m, _ = civil_from_days(z)
        if unit == "year":
            m = _ones(m)
        elif unit == "quarter":
            m = _fdiv(m - 1, 3) * 3 + 1
        out = days_from_civil(y, m, _ones(m))
    return _int_out(col, out, _DAYS)


def _intraday(col: Column, unit_per_day: int) -> torch.Tensor:
    """Units into the civil day, floor semantics (pre-epoch instants get
    the non-negative intra-day remainder)."""
    div = _TS_TO_DAY_DIV.get(col.dtype.type_id)
    if div is None or div == 1:
        raise NotImplementedError(
            f"time-of-day op needs a sub-day TIMESTAMP column, got "
            f"{col.dtype}")
    d = col.data.to(torch.int64)
    rem = d - _fdiv(d, div) * div  # [0, div)
    return _fdiv(rem * unit_per_day, div)


def hour(col: Column) -> Column:
    """Spark hour(): 0-23 within the instant's civil day."""
    return _int_out(col, _intraday(col, 24))


def minute(col: Column) -> Column:
    return _int_out(col, torch.remainder(_intraday(col, 24 * 60), 60))


def second(col: Column) -> Column:
    return _int_out(col, torch.remainder(_intraday(col, 86_400), 60))


def weekofyear(col: Column) -> Column:
    """Spark weekofyear(): the ISO-8601 week number (1-53), branch-free.

    w = (doy - isodow + 10) / 7; w == 0 rolls into the previous year's
    last week, and w past the year's own last ISO week (the week of Dec
    28) into week 1 of the next year."""
    z = _days_since_epoch(col)
    y, m, d = civil_from_days(z)
    jan1 = days_from_civil(y, _ones(m), _ones(d))
    doy = z - jan1 + 1
    isodow = torch.remainder(z + 3, 7) + 1
    w = _fdiv(doy - isodow + 10, 7)
    prev_len = jan1 - days_from_civil(y - 1, _ones(m), _ones(d))
    w_prev = _fdiv(doy + prev_len - isodow + 10, 7)
    dec28 = days_from_civil(y, torch.full_like(m, 12), torch.full_like(d, 28))
    dec28_dow = torch.remainder(dec28 + 3, 7) + 1
    w_dec28 = _fdiv(dec28 - jan1 + 1 - dec28_dow + 10, 7)
    out = torch.where(w < 1, w_prev, torch.where(w > w_dec28, 1, w))
    return _int_out(col, out)


def months_between(end: Column, start: Column,
                   round_off: bool = True) -> Column:
    """Spark months_between(date1, date2): whole months plus a 31-day
    fractional remainder; a whole number when the days of month match or
    both are month ends; rounded to 8 digits when ``round_off``
    (``torch.round`` is half to even, as the reference's). FLOAT64.
    Sub-day TIMESTAMP operands follow Spark: the day-of-month test uses
    the civil date, and the fraction is (domDiff*86400 + secs1 - secs2) /
    (31*86400) with the seconds truncated from the sub-second precision.
    The float operations run in the reference's order."""
    def day_secs(c: Column):
        z = _days_since_epoch(c)
        if c.dtype.type_id == TypeId.TIMESTAMP_DAYS:
            return z, torch.zeros_like(z)
        return z, _intraday(c, 86_400)

    def is_month_end(y, m, d, z):
        nxt = days_from_civil(y + _fdiv(m, 12), torch.remainder(m, 12) + 1,
                              _ones(d))
        return z == nxt - 1

    z1, s1 = day_secs(end)
    z2, s2 = day_secs(start)
    y1, m1, d1 = civil_from_days(z1)
    y2, m2, d2 = civil_from_days(z2)
    months = ((y1 - y2) * 12 + (m1 - m2)).to(torch.float64)
    both_end = is_month_end(y1, m1, d1, z1) & is_month_end(y2, m2, d2, z2)
    secs_diff = ((d1 - d2) * 86_400 + s1 - s2).to(torch.float64)
    # divisors as device tensors: CUDA turns a division by a Python
    # scalar into a multiplication by its reciprocal, which is not
    # correctly rounded (the CPU divides)
    frac = secs_diff / secs_diff.new_tensor(31.0 * 86_400.0)
    out = torch.where((d1 == d2) | both_end, months, months + frac)
    if round_off:
        out = torch.round(out * 1e8) / out.new_tensor(1e8)
    return Column(DType(TypeId.FLOAT64), out,
                  end.valid_mask() & start.valid_mask())


_NEXT_DAY_NAMES = {
    # Spark's DateTimeUtils.getDayOfWeekFromString takes 2-letter,
    # 3-letter and full names
    "mo": 1, "mon": 1, "monday": 1, "tu": 2, "tue": 2, "tuesday": 2,
    "we": 3, "wed": 3, "wednesday": 3, "th": 4, "thu": 4, "thursday": 4,
    "fr": 5, "fri": 5, "friday": 5, "sa": 6, "sat": 6, "saturday": 6,
    "su": 7, "sun": 7, "sunday": 7,
}


def next_day(col: Column, day_name: str) -> Column:
    """Spark next_day(date, dayOfWeek): the first date LATER than the
    input that falls on the given weekday."""
    key = day_name.strip().lower()
    if key not in _NEXT_DAY_NAMES:
        raise ValueError(f"unknown day-of-week name {day_name!r}")
    z = _days_since_epoch(col)
    isodow = torch.remainder(z + 3, 7) + 1
    ahead = torch.remainder(_NEXT_DAY_NAMES[key] - isodow + 6, 7) + 1
    return _int_out(col, z + ahead, _DAYS)
