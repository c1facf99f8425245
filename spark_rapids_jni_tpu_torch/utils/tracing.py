"""Profiler ranges of the port (the ``func_range`` and ``trace_range``
part of the reference's ``utils/tracing.py``; the rest of tracing, and
the span trees of the reference's ``telemetry/``, wait for ROADMAP.md
Queue 1 entry 12).

The reference opens a named range around each reader entry point, as
cuDF opens an NVTX range (``CUDF_FUNC_RANGE()``). Here the range is a
``torch.cuda.nvtx.range``, which ``torch.profiler`` and Nsight show on
the host timeline, opened only once CUDA is initialised in the process;
before that, and on a CPU-only build, the decorated function runs as a
plain call.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Callable, Iterator, TypeVar

import torch

F = TypeVar("F", bound=Callable)


def func_range(name: str) -> Callable[[F], F]:
    """Decorator: run the function inside the NVTX range ``name``."""

    def deco(fn: F) -> F:
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if torch.cuda.is_initialized():
                with torch.cuda.nvtx.range(name):
                    return fn(*args, **kwargs)
            return fn(*args, **kwargs)

        return wrapper  # type: ignore[return-value]

    return deco


@contextlib.contextmanager
def trace_range(name: str) -> Iterator[None]:
    """The with-block inside the NVTX range ``name`` (the reference's
    spans and trace ranges: the pipeline's stages, a spill, a chunk)."""
    if torch.cuda.is_initialized():
        with torch.cuda.nvtx.range(name):
            yield
    else:
        yield
