"""Profiler ranges and query spans of the port (counterpart of the
reference's ``utils/tracing.py``).

The reference opens a named range around each nontrivial entry point,
as cuDF opens an NVTX range (``CUDF_FUNC_RANGE()``), and hangs the
telemetry dispatch record and the query span tree off the same seam.
Here:

- with ``telemetry.enabled`` on and a query span open on this thread,
  the range is a child span of that query's tree
  (``telemetry/spans.py``), which also opens an NVTX range of its name;
- otherwise the range is a ``torch.cuda.nvtx.range`` once CUDA is
  initialised in the process, and a plain call before that and on a
  CPU-only build;
- ``record=True`` (and ``telemetry.enabled``) also times the body and
  records a ``dispatch`` record carrying ``wall_ms``, with
  ``status="error"`` and the exception class when the body raises.

Every time here is the host's clock around the block: nothing
synchronizes the device, so an asynchronous launch is timed by what it
costs the host to queue it.
"""

from __future__ import annotations

import contextlib
import functools
import time
from typing import Callable, Iterator, TypeVar

import torch

from spark_rapids_jni_tpu_torch import telemetry
from spark_rapids_jni_tpu_torch.telemetry import spans

F = TypeVar("F", bound=Callable)


@contextlib.contextmanager
def _range(name: str) -> Iterator[None]:
    with spans.child(name) as sp:
        if not sp and torch.cuda.is_initialized():
            # no span to carry the NVTX range: open it here
            with torch.cuda.nvtx.range(name):
                yield
        else:
            yield


@contextlib.contextmanager
def trace_range(name: str, record: bool = False) -> Iterator[None]:
    """The with-block inside the range ``name`` (a child span of the
    current query, or an NVTX range); ``record=True`` also records its
    host wall time as a ``dispatch`` record when telemetry is on."""
    record = record and telemetry.enabled()
    t0 = time.perf_counter() if record else 0.0
    try:
        with _range(name):
            yield
    except BaseException as exc:
        if record:
            telemetry.record_dispatch(
                name, wall_ms=(time.perf_counter() - t0) * 1e3,
                status="error", error=type(exc).__name__)
        raise
    if record:
        telemetry.record_dispatch(
            name, wall_ms=(time.perf_counter() - t0) * 1e3)


def func_range(name: str, record: bool = False) -> Callable[[F], F]:
    """Decorator form of :func:`trace_range` (``CUDF_FUNC_RANGE()``)."""

    def deco(fn: F) -> F:
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with trace_range(name, record=record):
                return fn(*args, **kwargs)

        return wrapper  # type: ignore[return-value]

    return deco
