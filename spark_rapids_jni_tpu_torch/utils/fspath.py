"""Bytes-or-path dispatch shared by the file readers (counterpart of the
reference's ``utils/fspath.py``): both readers take in-memory bytes or a
filesystem path, and a path goes to the native mmap route."""

from __future__ import annotations

import os


def as_fs_path(data) -> bytes | None:
    """The fsencode'd path when ``data`` names a file, else None
    (in-memory bytes)."""
    if isinstance(data, (str, os.PathLike)):
        return os.fsencode(data)
    return None
