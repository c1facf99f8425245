"""Checksum trailers on every managed byte boundary, and the classified
rejection of untrusted input (counterpart of the reference's
``runtime/integrity.py``; the bytes it writes equal the reference's).

- ``seal``/``verify`` wrap a payload in a 16-byte trailer (magic
  ``TPIC`` + u64 length + masked crc32), so truncation, bit flips and
  length lies are caught before any byte is decoded.
- ``write_payload_file``/``read_payload_file``: crash-safe payload files
  (temporary file, fsync, ``os.replace``, directory fsync, read-back
  compare).
- ``snaps_checksum``/``verify_snaps`` checksum host column snapshots
  (the SpillStore's, whose buffers are pinned CPU tensors, numpy arrays
  or codec packs) without serializing them.
- A mismatch raises the classified :class:`CorruptDataError`; malformed
  untrusted input raises :class:`MalformedInputError`
  (``reject_malformed``).

The checksum is ``zlib.crc32`` rotated and offset by LevelDB's mask, so
a payload that embeds its own crc32 never verifies by accident. The
order at every seam is compress, then seal, on write; verify, then
decompress, on read. ``integrity.enabled=false`` (or
``SPARK_RAPIDS_TPU_INTEGRITY=0``) turns off every trailer and check.
"""

from __future__ import annotations

import os
import struct
import tempfile
import zlib
from typing import Any, Optional, Sequence

import numpy as np
import torch

from spark_rapids_jni_tpu_torch import telemetry
from spark_rapids_jni_tpu_torch.runtime.resilience import (
    CorruptDataError,
    MalformedInputError,
)

__all__ = [
    "TRAILER_MAGIC",
    "TRAILER_SIZE",
    "checksum",
    "enabled",
    "read_payload_file",
    "reject_malformed",
    "seal",
    "snaps_checksum",
    "verify",
    "verify_snaps",
    "write_payload_file",
]

# Trailer layout: 4-byte magic + u64 payload length + u32 masked crc.
TRAILER_MAGIC = b"TPIC"
_TRAILER_FMT = "<4sQI"
TRAILER_SIZE = struct.calcsize(_TRAILER_FMT)

# LevelDB's crc32c mask constant.
_MASK_DELTA = 0xA282EAD8
_ENV = "SPARK_RAPIDS_TPU_INTEGRITY"


def enabled() -> bool:
    """Is validation on? ``SPARK_RAPIDS_TPU_INTEGRITY`` first, then the
    ``integrity.enabled`` option (default True)."""
    env = os.environ.get(_ENV)
    if env is not None:
        return env.strip().lower() in ("1", "true", "yes", "on")
    from spark_rapids_jni_tpu_torch.utils.config import get_option

    return bool(get_option("integrity.enabled"))


def _mask(crc: int) -> int:
    crc &= 0xFFFFFFFF
    return (((crc >> 15) | (crc << 17)) + _MASK_DELTA) & 0xFFFFFFFF


def checksum(data: Any) -> int:
    """Masked crc32 of ``data`` (anything with the buffer protocol);
    callers gate on :func:`enabled`, the primitive does not."""
    return _mask(zlib.crc32(data))


def seal(payload: bytes) -> bytes:
    """``payload`` with the length and checksum trailer appended."""
    return payload + struct.pack(_TRAILER_FMT, TRAILER_MAGIC, len(payload),
                                 checksum(payload))


def _mismatch(reason: str, *, seam: str, op: str,
              **context: Any) -> CorruptDataError:
    telemetry.count("integrity.mismatch")
    telemetry.count(f"integrity.mismatch.{seam}")
    telemetry.record_integrity(op, "mismatch", seam=seam, reason=reason,
                               **context)
    return CorruptDataError(reason, seam=seam, op=op, **context)


def verify(blob: bytes, *, seam: str, op: str = "verify",
           **context: Any) -> bytes:
    """The payload of a sealed ``blob``, its trailer checked; raises the
    classified :class:`CorruptDataError` on truncation, a clobbered
    magic, a length lie or a checksum mismatch."""
    n = len(blob)
    if n < TRAILER_SIZE:
        raise _mismatch("payload shorter than integrity trailer", seam=seam,
                        op=op, size=n, **context)
    magic, length, crc = struct.unpack(_TRAILER_FMT, blob[n - TRAILER_SIZE:])
    if magic != TRAILER_MAGIC:
        raise _mismatch("integrity trailer magic clobbered", seam=seam,
                        op=op, size=n, **context)
    if length != n - TRAILER_SIZE:
        raise _mismatch("payload length disagrees with trailer", seam=seam,
                        op=op, declared=length, actual=n - TRAILER_SIZE,
                        **context)
    payload = blob[: n - TRAILER_SIZE]
    actual = checksum(payload)
    if actual != crc:
        raise _mismatch("payload checksum mismatch", seam=seam, op=op,
                        declared=crc, actual=actual, **context)
    telemetry.count("integrity.bytes_verified", len(payload))
    telemetry.count(f"integrity.verified.{seam}")
    return payload


def _buffer_view(buf: Any) -> memoryview:
    """The bytes of one snapshot buffer: a CPU tensor (pinned or not) or
    a numpy array, read in place."""
    if isinstance(buf, torch.Tensor):
        buf = buf.numpy()
    return memoryview(np.ascontiguousarray(buf)).cast("B")


def snaps_checksum(snaps: Sequence[Any]) -> int:
    """One masked crc over every buffer of a list of host column
    snapshots ``(dtype, data, validity, chars, children)``, each buffer a
    host array, a codec pack ``(tag, dtype, shape, blob)`` (its blob
    folded) or None."""
    crc = 0

    def fold(buf: Any) -> None:
        nonlocal crc
        if buf is None:
            return
        if isinstance(buf, tuple):
            crc = zlib.crc32(buf[3], crc)
            return
        crc = zlib.crc32(_buffer_view(buf), crc)

    def walk(snap: Any) -> None:
        _dtype, data, validity, chars, children = snap
        fold(data)
        fold(validity)
        fold(chars)
        for child in children or ():
            walk(child)

    for snap in snaps:
        walk(snap)
    return _mask(crc)


def verify_snaps(snaps: Sequence[Any], expected: int, *, seam: str,
                 op: str = "verify_snaps", **context: Any) -> None:
    """Check host snapshots against the checksum taken when they were
    spilled; raise the classified :class:`CorruptDataError` on drift."""
    nbytes = 0
    for snap in snaps:
        for buf in (snap[1], snap[2], snap[3]):
            if isinstance(buf, tuple):
                nbytes += len(buf[3])
            elif buf is not None:
                nbytes += _buffer_view(buf).nbytes
    actual = snaps_checksum(snaps)
    if actual != expected:
        raise _mismatch("host snapshot checksum mismatch", seam=seam, op=op,
                        declared=expected, actual=actual, **context)
    telemetry.count("integrity.bytes_verified", nbytes)
    telemetry.count(f"integrity.verified.{seam}")


def write_payload_file(path: str, blob: bytes) -> int:
    """Crash-safe payload write: a temporary file in the same directory,
    flush, fsync, ``os.replace``, directory fsync, then a read-back
    compare of length and crc with the bytes given. ``blob`` is written
    as it is (callers seal first)."""
    directory = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(dir=directory, prefix=".integrity-",
                               suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as fh:
            fh.write(blob)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    try:
        dfd = os.open(directory, os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)
    except OSError:
        pass  # a platform without directory fsync
    with open(path, "rb") as fh:
        landed = fh.read()
    if len(landed) != len(blob) or zlib.crc32(landed) != zlib.crc32(blob):
        raise _mismatch(
            "write-verify failed: bytes on disk differ from bytes written",
            seam="integrity.spill", op="write_payload_file", path=path,
            written=len(blob), landed=len(landed))
    return len(blob)


def read_payload_file(path: str, *, seam: str, sealed: bool,
                      op: str = "read_payload_file",
                      **context: Any) -> bytes:
    """A payload file read back, its trailer verified when it was
    written sealed."""
    with open(path, "rb") as fh:
        blob = fh.read()
    if not sealed:
        return blob
    return verify(blob, seam=seam, op=op, path=path, **context)


def reject_malformed(op: str, message: str, *,
                     exc_type: Optional[type] = None,
                     **context: Any) -> MalformedInputError:
    """Count one malformed-input rejection (``integrity.malformed`` and
    ``integrity.malformed.<op>``), record it, and return the classified
    exception for the caller to raise; ``exc_type`` lets the file
    readers give their ``NativeError``-compatible subclass."""
    telemetry.count("integrity.malformed")
    telemetry.count(f"integrity.malformed.{op}")
    telemetry.record_integrity(op, "malformed", seam="integrity.ingest",
                               reason=message, **context)
    cls = exc_type or MalformedInputError
    return cls(message, op=op, **context)
