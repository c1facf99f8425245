"""Crash-safe small-state persistence (counterpart of the reference's
``utils/atomic_io.py``): the whole payload goes to a temporary file in
the target's directory, is fsynced, renamed over the target with
``os.replace`` and the directory fsynced, so after a crash either the
old complete file or the new one is on disk. Readers treat a file that
does not parse as absent: the caller discards it and records why. The
serving runtime's learned admission estimates and the runtime filter's
learned selectivities persist this way."""

from __future__ import annotations

import json
import os
import tempfile
from typing import Any, Optional, Tuple

from spark_rapids_jni_tpu_torch.utils.log import get_logger

__all__ = ["atomic_write_json", "load_json"]

_log = get_logger(__name__)


def atomic_write_json(path: str, obj: Any) -> None:
    """Durably replace ``path`` with ``obj`` as JSON (temp file in the
    same directory, fsync, ``os.replace``, directory fsync)."""
    directory = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(directory, exist_ok=True)
    fd, tmp = tempfile.mkstemp(
        dir=directory, prefix=os.path.basename(path) + ".", suffix=".tmp")
    try:
        with os.fdopen(fd, "w", encoding="utf-8") as f:
            json.dump(obj, f, sort_keys=True, separators=(",", ":"))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        # a filesystem that refuses a directory fsync only risks reading
        # the previous complete file, never a torn one
        try:
            dfd = os.open(directory, os.O_RDONLY)
            try:
                os.fsync(dfd)
            finally:
                os.close(dfd)
        except OSError:
            pass
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def load_json(path: str) -> Tuple[Optional[Any], Optional[str]]:
    """``(obj, None)`` for a readable file, ``(None, None)`` for a
    missing one, ``(None, reason)`` for one that exists but does not
    parse (the caller discards it: a corrupt warm-start file costs a
    cold start, not a crash)."""
    try:
        with open(path, "r", encoding="utf-8") as f:
            return json.load(f), None
    except FileNotFoundError:
        return None, None
    except (OSError, ValueError, UnicodeDecodeError) as exc:
        reason = f"{type(exc).__name__}: {exc}"
        _log.warning("discarding corrupt state file %s (%s)", path, reason)
        return None, reason
