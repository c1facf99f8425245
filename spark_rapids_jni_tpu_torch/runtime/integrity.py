"""Untrusted-input validation switch and its classified rejection (the
``enabled``/``reject_malformed`` part of the reference's
``runtime/integrity.py``; checksummed payloads wait for ROADMAP.md Queue
1 entry 10)."""

from __future__ import annotations

import os
from typing import Any, Optional

from spark_rapids_jni_tpu_torch import telemetry
from spark_rapids_jni_tpu_torch.errors import MalformedInputError

_ENV = "SPARK_RAPIDS_TPU_INTEGRITY"


def enabled() -> bool:
    """Is validation on? ``SPARK_RAPIDS_TPU_INTEGRITY`` first, then the
    ``integrity.enabled`` option (default True)."""
    env = os.environ.get(_ENV)
    if env is not None:
        return env.strip().lower() in ("1", "true", "yes", "on")
    from spark_rapids_jni_tpu_torch.utils.config import get_option

    return bool(get_option("integrity.enabled"))


def reject_malformed(op: str, message: str, *,
                     exc_type: Optional[type] = None,
                     **context: Any) -> MalformedInputError:
    """Count one malformed-input rejection (``integrity.malformed`` and
    ``integrity.malformed.<op>``) and return the classified exception
    for the caller to raise; ``exc_type`` lets the file readers give
    their ``NativeError``-compatible subclass."""
    telemetry.count("integrity.malformed")
    telemetry.count(f"integrity.malformed.{op}")
    cls = exc_type or MalformedInputError
    return cls(message, op=op, **context)
