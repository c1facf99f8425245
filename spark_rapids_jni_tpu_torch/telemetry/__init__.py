"""Execution telemetry of the port (counterpart of the reference's
``telemetry/`` package): where each op ran and why, counters, gauges and
histograms, the runtime's classified events, per-query span trees, the
flight recorder, Chrome-trace export and the live ``top`` view.

- ``registry.py``: ``REGISTRY``, the one store of counters, gauges and
  histograms, with its Prometheus-style ``exposition()``.
- ``events.py``: the ``record_*`` functions, the in-process ring
  (``events``, ``drain``), ``summary``, ``session_scope`` and the JSONL
  sink under ``telemetry.path``.
- ``spans.py``: ``span`` / ``child``, the flight recorder, ``validate``,
  ``chrome_trace``, ``phase_breakdown``.
- ``report.py``, ``top.py`` and ``__main__.py``: ``python -m
  spark_rapids_jni_tpu_torch.telemetry report|trace|top``.

Kernel fallbacks are counted apart, by ``ops.kernels.fall_back``. The
port's counters and classified events are recorded whatever the options
(the reference's only with ``telemetry.enabled``); the JSONL sink, the
spans and the flight recorder follow ``telemetry.enabled`` as there.
``count``/``counter`` and ``gauge*`` are the registry's instruments
under the names the port's modules have always used, and ``reset()``
clears the registry, the ring, the fallback table and the recorder.
"""

from spark_rapids_jni_tpu_torch.telemetry import spans
from spark_rapids_jni_tpu_torch.telemetry.events import (
    current_session,
    drain,
    enabled,
    events,
    fallbacks,
    record_cache,
    record_compile_cache,
    record_degrade,
    record_dispatch,
    record_exchange,
    record_fallback,
    record_fleet,
    record_integrity,
    record_resilience,
    record_rtfilter,
    record_server,
    record_spill,
    session_scope,
    summary,
)
from spark_rapids_jni_tpu_torch.telemetry.events import clear as _clear
from spark_rapids_jni_tpu_torch.telemetry.registry import REGISTRY, Registry
from spark_rapids_jni_tpu_torch.telemetry.spans import (
    chrome_trace,
    current_span,
    dump_flight_record,
    flight_records,
    span,
)

__all__ = [
    "REGISTRY",
    "Registry",
    "chrome_trace",
    "count",
    "counter",
    "current_session",
    "current_span",
    "drain",
    "dump_flight_record",
    "enabled",
    "events",
    "fallbacks",
    "flight_records",
    "gauge",
    "gauge_add",
    "gauge_set",
    "record_cache",
    "record_compile_cache",
    "record_degrade",
    "record_dispatch",
    "record_exchange",
    "record_fallback",
    "record_fleet",
    "record_integrity",
    "record_resilience",
    "record_rtfilter",
    "record_server",
    "record_spill",
    "reset",
    "session_scope",
    "span",
    "spans",
    "summary",
]


def count(name: str, n: int = 1) -> None:
    """Add ``n`` (>= 0) to the counter ``name`` (safe from any thread)."""
    REGISTRY.counter(name).inc(n)


def counter(name: str) -> int:
    """The counter ``name`` since the last :func:`reset` (0 if never
    counted)."""
    return REGISTRY.counter_value(name)


def gauge_add(name: str, n: float) -> None:
    REGISTRY.gauge(name).add(n)


def gauge_set(name: str, value: float) -> None:
    REGISTRY.gauge(name).set(value)


def gauge(name: str) -> float:
    """The gauge ``name`` (0 if never set)."""
    return REGISTRY.gauge_value(name)


def reset() -> None:
    """Clear every counter, gauge and histogram, the record ring, the
    fallback table and the flight recorder."""
    REGISTRY.reset()
    _clear()
    spans.reset()
