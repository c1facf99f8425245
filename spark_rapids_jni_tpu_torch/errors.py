"""Classified errors of the port (counterpart of the part of
``spark_rapids_jni_tpu/runtime/resilience.py`` that the ported operators
raise)."""

from __future__ import annotations


class MalformedInputError(RuntimeError):
    """Input from outside the engine failed structural validation (a
    file, or filters that disagree on their geometry). Never retried: the
    input is wrong, not the engine."""

    transient = False
