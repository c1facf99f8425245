"""Host fallbacks and named counters of the port (counterpart of the
reference's ``telemetry.record_fallback`` and ``REGISTRY.counter``): an
operator that hands its work to the host says so here, with its reason
and row count, so that a run can show it and no host step is silent; a
classified event (``rtfilter.merge_mismatch``) adds one to its counter,
a pattern-compile cache counts its hits and misses, and the memory and
out-of-core runtime records its retries, integrity events, degradation
steps and spills (with their counters and the pipeline's gauges).
Kernel fallbacks are counted apart, by ``ops.kernels.fall_back``."""

from __future__ import annotations

import threading
from collections import Counter, deque
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
    """Add ``n`` to the counter ``name`` (safe from any thread)."""
    with _lock:
        _counters[name] += n


def counter(name: str) -> int:
    """The counter ``name`` since the last :func:`reset` (0 if never
    counted)."""
    return _counters[name]


def reset() -> None:
    _calls.clear()
    _rows.clear()
    _counters.clear()
    with _lock:
        _events.clear()
        _gauges.clear()


# ---- classified runtime events (resilience, integrity, degradation, spill)
#
# The reference emits these as telemetry records when ``telemetry.enabled``
# is on; the port keeps the last ``_EVENT_RING`` of them in process, always,
# with the counters the reference's records bump. Mandatory fields raise
# when empty, as there: an unaccountable recovery, corruption or step is a
# bug.

_EVENT_RING = 4096
_events: deque = deque(maxlen=_EVENT_RING)
_gauges: dict = {}
_lock = threading.Lock()


def _emit(kind: str, op: str, fields: dict) -> None:
    for reserved in ("kind", "op"):
        if reserved in fields:
            raise ValueError(f"record_{kind}({op!r}): {reserved!r} is a "
                             "reserved record field")
    with _lock:
        _events.append({"kind": kind, "op": op, **fields})


def _required(kind: str, op: str, **named) -> None:
    for name, value in named.items():
        if not value or not str(value).strip():
            raise ValueError(f"record_{kind}({op!r}): {name} must be "
                             "non-empty")


def record_resilience(op: str, event: str, *, seam: str, attempt: int,
                      rung: str, **extra) -> None:
    """A resilience-policy decision: ``event`` is retry / recovered /
    escalate / fatal at ``seam``, on ladder ``rung``; counts
    ``resilience.<event>`` and ``resilience.rung.<rung>``."""
    _required("resilience", op, seam=seam, rung=rung)
    _emit("resilience", op, {"event": str(event), "seam": str(seam),
                             "attempt": int(attempt), "rung": str(rung),
                             **extra})
    count(f"resilience.{event}")
    count(f"resilience.rung.{rung}")


def record_integrity(op: str, event: str, *, seam: str,
                     nbytes: Optional[int] = None, **extra) -> None:
    """An integrity event (mismatch, replay, recovered, malformed) at
    the verification boundary ``seam``. The counters belong to
    ``runtime/integrity.py``, which counts whether or not this runs."""
    _required("integrity", op, seam=seam)
    fields = {"event": str(event), "seam": str(seam), **extra}
    if nbytes is not None:
        fields["nbytes"] = int(nbytes)
    _emit("integrity", op, fields)


def record_degrade(op: str, event: str, *, tier: str, trigger: str,
                   rung: int, **extra) -> None:
    """A degradation decision: ``event`` is step / completed / parked /
    resumed / exhausted / pressure / tier_unavailable, ``tier`` where the
    ladder goes, ``trigger`` what forced it; counts ``degrade.<event>``
    and ``degrade.tier.<tier>``."""
    _required("degrade", op, tier=tier, trigger=trigger)
    _emit("degrade", op, {"event": str(event), "tier": str(tier),
                          "trigger": str(trigger), "rung": int(rung),
                          **extra})
    count(f"degrade.{event}")
    count(f"degrade.tier.{tier}")


def record_spill(op: str, reason: str, *, bytes_moved: int = 0,
                 **extra) -> None:
    """A spill or unspill between device and host, with its reason;
    counts ``spill.<op>`` and ``spill_bytes_total``."""
    _required("spill", op, reason=reason)
    _emit("spill", op, {"reason": str(reason),
                        "bytes_moved": int(bytes_moved), **extra})
    count(f"spill.{op}")
    count("spill_bytes_total", max(0, int(bytes_moved)))


def events(kind: Optional[str] = None) -> list:
    """The recorded events (oldest first), of one ``kind`` if given."""
    with _lock:
        return [dict(e) for e in _events if kind is None or e["kind"] == kind]


def gauge_add(name: str, n: float) -> None:
    with _lock:
        _gauges[name] = _gauges.get(name, 0) + n


def gauge_set(name: str, value: float) -> None:
    with _lock:
        _gauges[name] = value


def gauge(name: str) -> float:
    """The gauge ``name`` (0 if never set)."""
    return _gauges.get(name, 0)
