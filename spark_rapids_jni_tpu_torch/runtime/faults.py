"""The corruption seam of untrusted ingest (the ``fire_corrupt``/``inject``
part of the reference's ``runtime/faults.py``; fault scripts and the other
seams wait for ROADMAP.md Queue 1 entry 10).

With no injector installed, ``fire_corrupt`` is one ``is None`` check. An
injector installed by ``inject`` takes part by having a
``corrupt_payload(seam, seq, payload, ctx)`` method; what it returns
replaces the payload (None leaves it alone), and each mutation counts
``faults.corrupted`` and ``faults.corrupted.<seam>``.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Any, Iterator, Optional

from spark_rapids_jni_tpu_torch import telemetry

SEAMS = ("integrity.ingest",)

_active: Optional[Any] = None
_lock = threading.Lock()


def fire_corrupt(seam: str, seq: int, payload: bytes, **ctx: Any) -> bytes:
    """Let the installed injector mutate ``payload`` at ``seam``."""
    hook = _active
    if hook is None:
        return payload
    if seam not in SEAMS:
        raise ValueError(f"unknown fault seam {seam!r}; registered: "
                         f"{sorted(SEAMS)}")
    corrupt = getattr(hook, "corrupt_payload", None)
    if corrupt is None:
        return payload
    mutated = corrupt(seam, int(seq), payload, ctx)
    if mutated is None or mutated is payload:
        return payload
    telemetry.count("faults.corrupted")
    telemetry.count(f"faults.corrupted.{seam}")
    return mutated


@contextlib.contextmanager
def inject(injector: Any) -> Iterator[None]:
    """Install ``injector`` for the with-block (nested installs stack)."""
    global _active
    with _lock:
        prev = _active
        _active = injector
    try:
        yield
    finally:
        with _lock:
            _active = prev
