"""Proleptic-Gregorian civil-calendar arithmetic, days since 1970-01-01
<-> year/month/day (counterpart of ``spark_rapids_jni_tpu/ops/_calendar.py``),
shared by the string date casts so the two directions never disagree.

The era decomposition: shift to 0000-03-01 so leap days land at the end
of each 400-year cycle, split into eras and years of era with the leap
corrections as integer divisions, and read month and day off the
5-month cycle polynomial (153m+2)/5. Every division is int64 FLOOR
division (``torch.div(..., rounding_mode="floor")``): inputs reach
negative day counts and years, where truncation would be off by one.
"""

from __future__ import annotations

import torch


def _fdiv(a: torch.Tensor, b: int) -> torch.Tensor:
    return torch.div(a, b, rounding_mode="floor")


def civil_from_days(z: torch.Tensor):
    """days since 1970-01-01 -> (year, month, day), int64 each."""
    z = z.to(torch.int64) + 719_468  # days since 0000-03-01
    era = _fdiv(z, 146_097)
    doe = z - era * 146_097  # [0, 146096]
    yoe = _fdiv(doe - _fdiv(doe, 1460) + _fdiv(doe, 36_524)
                - _fdiv(doe, 146_096), 365)  # [0, 399]
    y = yoe + era * 400
    doy = doe - (365 * yoe + _fdiv(yoe, 4) - _fdiv(yoe, 100))  # [0, 365]
    mp = _fdiv(5 * doy + 2, 153)  # March-based month [0, 11]
    d = doy - _fdiv(153 * mp + 2, 5) + 1  # [1, 31]
    m = mp + torch.where(mp < 10, 3, -9)  # civil month [1, 12]
    return y + (mp >= 10).to(torch.int64), m, d


def days_from_civil(y: torch.Tensor, m: torch.Tensor,
                    d: torch.Tensor) -> torch.Tensor:
    """(year, month, day) -> int64 days since 1970-01-01; the inverse of
    ``civil_from_days``."""
    y = y.to(torch.int64)
    m = m.to(torch.int64)
    d = d.to(torch.int64)
    y = y - (m <= 2).to(torch.int64)
    era = _fdiv(y, 400)
    yoe = y - era * 400
    mp = m + torch.where(m > 2, -3, 9)
    doy = _fdiv(153 * mp + 2, 5) + d - 1
    doe = 365 * yoe + _fdiv(yoe, 4) - _fdiv(yoe, 100) + doy
    return era * 146_097 + doe - 719_468
