"""Classified errors of the port (counterpart of the part of
``spark_rapids_jni_tpu/runtime/resilience.py`` that the ported operators
raise)."""

from __future__ import annotations

from typing import Any


class MalformedInputError(RuntimeError):
    """Input from outside the engine failed structural validation (a
    file, or filters that disagree on their geometry). Never retried: the
    input is wrong, not the engine.

    Keyword context (the reader passes ``op`` and sizes) is kept in
    ``context`` and appended to the message as ``[k=v, ...]``, as the
    reference's classified errors do."""

    transient = False

    def __init__(self, message: str, **context: Any) -> None:
        if context:
            detail = ", ".join(f"{k}={v}" for k, v in sorted(context.items()))
            message = f"{message} [{detail}]"
        super().__init__(message)
        self.context = context
