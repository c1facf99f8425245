"""Classified errors of the port. ``MalformedInputError`` is the
resilience taxonomy's (``runtime/resilience.py``), re-exported here for
the modules that raise it, so that ``except ResilienceError`` catches it
as in the reference."""

from __future__ import annotations

from spark_rapids_jni_tpu_torch.runtime.resilience import (  # noqa: F401
    MalformedInputError,
)
