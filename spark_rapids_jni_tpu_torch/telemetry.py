"""Host fallbacks and named counters of the port (counterpart of the
reference's ``telemetry.record_fallback`` and ``REGISTRY.counter``): an
operator that hands its work to the host says so here, with its reason
and row count, so that a run can show it and no host step is silent; a
classified event (``rtfilter.merge_mismatch``) adds one to its counter,
and a pattern-compile cache counts its hits and misses. Kernel fallbacks
are counted apart, by ``ops.kernels.fall_back``."""

from __future__ import annotations

from collections import Counter
from typing import Optional

_calls: Counter = Counter()
_rows: Counter = Counter()
_counters: Counter = Counter()


def record_fallback(op: str, reason: str, *, rows: Optional[int] = None
                    ) -> None:
    """``op`` ran on the host because ``reason`` (which must be given)."""
    if not reason or not str(reason).strip():
        raise ValueError(f"record_fallback({op!r}): reason must be non-empty")
    _calls[(op, str(reason))] += 1
    _rows[(op, str(reason))] += int(rows or 0)


def record_compile_cache(name: str, *, hit: bool) -> None:
    """The compile cache ``name`` (``regex_dfa``) was consulted: one more
    ``compile_cache.<name>.hit`` or ``.miss``."""
    _counters[f"compile_cache.{name}.{'hit' if hit else 'miss'}"] += 1


def fallbacks() -> dict:
    """``{(op, reason): {"calls": n, "rows": r}}`` since the last
    :func:`reset`."""
    return {k: {"calls": n, "rows": _rows[k]} for k, n in _calls.items()}


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``."""
    _counters[name] += n


def counter(name: str) -> int:
    """The counter ``name`` since the last :func:`reset` (0 if never
    counted)."""
    return _counters[name]


def reset() -> None:
    _calls.clear()
    _rows.clear()
    _counters.clear()
