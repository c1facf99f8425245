"""Host fallbacks of the port (counterpart of the reference's
``telemetry.record_fallback``): an operator that hands its work to the
host says so here, with its reason and row count, so that a run can show
it and no host step is silent. Kernel fallbacks are counted apart, by
``ops.kernels.fall_back``."""

from __future__ import annotations

from collections import Counter
from typing import Optional

_calls: Counter = Counter()
_rows: Counter = Counter()


def record_fallback(op: str, reason: str, *, rows: Optional[int] = None
                    ) -> None:
    """``op`` ran on the host because ``reason`` (which must be given)."""
    if not reason or not str(reason).strip():
        raise ValueError(f"record_fallback({op!r}): reason must be non-empty")
    _calls[(op, str(reason))] += 1
    _rows[(op, str(reason))] += int(rows or 0)


def fallbacks() -> dict:
    """``{(op, reason): {"calls": n, "rows": r}}`` since the last
    :func:`reset`."""
    return {k: {"calls": n, "rows": _rows[k]} for k, n in _calls.items()}


def reset() -> None:
    _calls.clear()
    _rows.clear()
