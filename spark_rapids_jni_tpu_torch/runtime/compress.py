"""Columnar compression under the integrity seal (counterpart of the
reference's ``runtime/compress.py``; host-side numpy, and its frames are
byte-identical to the reference's for the same array and zstd
availability).

Schemes, chosen per buffer from a sampled estimate: **DICT**
(low-cardinality columns as a value dictionary plus sub-byte indices),
**RLE** (run lengths and values), **BITPACK** (boolean validity, 8 flags
a byte) and **RAW** (passthrough when a re-encode does not pay).
``zstandard``, when importable and ``compress.zstd_level`` is positive,
runs as a final stage over the winning payload when it shrinks it; a
frame that needs it raises ``ModuleNotFoundError`` on a machine without
the package, never decodes silently otherwise.

Every buffer is a self-describing frame (magic ``TPCZ`` | version |
scheme | zstd flag | dtype | shape | payload length | payload). The
order at every seam is compress, then seal, on write; verify, then
decompress, then a length and shape check, on read: an inconsistent
frame behind a valid seal raises the classified
:class:`CorruptDataError`. ``compress.enabled`` gates everything,
``compress.spill`` / ``compress.checkpoint`` one seam each; any other
seam stays uncompressed.
"""

from __future__ import annotations

import struct
import time
from typing import Any, Optional, Tuple

from spark_rapids_jni_tpu_torch import telemetry
from spark_rapids_jni_tpu_torch.runtime.resilience import CorruptDataError
from spark_rapids_jni_tpu_torch.utils.config import get_option

import numpy as np

__all__ = [
    "FRAME_MAGIC",
    "FRAME_VERSION",
    "PACK_TAG",
    "SCHEME_RAW",
    "SCHEME_RLE",
    "SCHEME_DICT",
    "SCHEME_BITPACK",
    "SEAM_OPTIONS",
    "decode_array",
    "enabled",
    "encode_array",
    "is_codec_pack",
    "pack_array",
    "seam_enabled",
    "seam_key",
    "unpack_array",
    "zstd_available",
    "zstd_codec",
]

FRAME_MAGIC = b"TPCZ"
FRAME_VERSION = 1

SCHEME_RAW = 0
SCHEME_RLE = 1
SCHEME_DICT = 2
SCHEME_BITPACK = 3
_SCHEME_NAMES = {
    SCHEME_RAW: "raw",
    SCHEME_RLE: "rle",
    SCHEME_DICT: "dict",
    SCHEME_BITPACK: "bitpack",
}

# Snapshot-pack tag: codec-framed buffers travel through SpillStore
# snapshots as ("tpcc", dtype_str, shape, frame_bytes) — the same
# 4-tuple shape as the legacy ("zstd", ...) pack, deliberately, so
# snaps_checksum / corruption injection / fingerprint hashing all fold
# the blob at index 3 without knowing which codec produced it.
PACK_TAG = "tpcc"

# integrity seam -> the per-seam config option that gates the codec there
SEAM_OPTIONS = {
    "integrity.spill": "compress.spill",
    "integrity.checkpoint": "compress.checkpoint",
}

# encode below this size cannot pay for its own header
_MIN_ENCODE_BYTES = 64
# a re-encode must beat raw by at least this factor to be worth the
# decode work on the read side (raw passthrough otherwise)
_PAY_FRACTION = 0.9
# strided sample size for the scheme estimate
_SAMPLE = 1024

# ---------------------------------------------------------------------------
# the shared zstandard guard
# ---------------------------------------------------------------------------


def zstd_codec(level: int):
    """The one optional-``zstandard`` import in the tree: returns
    ``(ZstdCompressor(level), ZstdDecompressor())`` or raises
    ``ModuleNotFoundError`` when the package is absent.
    ``runtime/memory.py`` re-uses this, so spill and codec never
    disagree on availability."""
    import zstandard as zstd

    return zstd.ZstdCompressor(level=level), zstd.ZstdDecompressor()


def zstd_available() -> bool:
    """True when the optional final stage can run (cached)."""
    global _ZSTD_OK
    if _ZSTD_OK is None:
        try:
            zstd_codec(1)
            _ZSTD_OK = True
        except ModuleNotFoundError:
            _ZSTD_OK = False
    return _ZSTD_OK


_ZSTD_OK: Optional[bool] = None


# ---------------------------------------------------------------------------
# config gates
# ---------------------------------------------------------------------------


def enabled() -> bool:
    """Master gate: ``compress.enabled`` (env
    ``SPARK_RAPIDS_TPU_COMPRESS_ENABLED``)."""
    return bool(get_option("compress.enabled"))


def seam_key(seam: str) -> str:
    """Short seam label for telemetry ("integrity.spill" -> "spill")."""
    return str(seam).rsplit(".", 1)[-1]


def seam_enabled(seam: str) -> bool:
    """Is the codec on for one integrity seam? False for the master
    gate off, the per-seam gate off, or an unknown seam (unknown byte
    paths stay legacy until they are explicitly given a gate)."""
    if not enabled():
        return False
    option = SEAM_OPTIONS.get(str(seam))
    if option is None:
        return False
    return bool(get_option(option))


# ---------------------------------------------------------------------------
# classified decode failures
# ---------------------------------------------------------------------------


def _corrupt(reason: str, *, seam: str, op: str, **context: Any) -> CorruptDataError:
    """Count + record one codec-frame mismatch and return the classified
    exception — same accounting shape as integrity's ``_mismatch`` so a
    corrupt-after-decompress frame shows up beside trailer mismatches in
    every report."""
    telemetry.count("integrity.mismatch")
    telemetry.count(f"integrity.mismatch.{seam}")
    telemetry.count("compress.mismatch")
    telemetry.record_integrity(op, "mismatch", seam=seam, reason=reason, **context)
    return CorruptDataError(reason, seam=seam, op=op, **context)


# ---------------------------------------------------------------------------
# scheme encoders — each returns the raw scheme payload bytes
# ---------------------------------------------------------------------------


def _rle_split(flat: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(run_values, run_lengths) of a 1-D array."""
    if flat.size == 0:
        return flat[:0], np.zeros(0, dtype=np.uint32)
    boundaries = np.flatnonzero(flat[1:] != flat[:-1]) + 1
    starts = np.concatenate(([0], boundaries))
    ends = np.concatenate((boundaries, [flat.size]))
    return flat[starts], (ends - starts).astype(np.uint32)


def _encode_rle(flat: np.ndarray) -> bytes:
    values, lengths = _rle_split(flat)
    return b"".join((
        struct.pack("<I", values.size),
        lengths.tobytes(),
        np.ascontiguousarray(values).tobytes(),
    ))


def _index_bits(k: int) -> int:
    """Bits per dictionary index for cardinality ``k`` — sub-byte for the
    low-cardinality columns that motivate the scheme (TPC-H flags at 2-3
    distinct values pack 4-8 indices per byte)."""
    for bits in (1, 2, 4, 8, 16):
        if k <= (1 << bits):
            return bits
    return 32


def _index_nbytes(n: int, bits: int) -> int:
    if bits >= 8:
        return n * (bits // 8)
    return (n * bits + 7) // 8


def _pack_indices(idx: np.ndarray, bits: int) -> bytes:
    if bits >= 8:
        return idx.astype(np.dtype(f"<u{bits // 8}")).tobytes()
    per = 8 // bits
    pad = (-idx.size) % per
    if pad:
        idx = np.concatenate([idx, np.zeros(pad, dtype=idx.dtype)])
    m = idx.reshape(-1, per).astype(np.uint8)
    shifts = np.arange(per, dtype=np.uint8) * np.uint8(bits)
    return np.bitwise_or.reduce(m << shifts, axis=1).astype(np.uint8).tobytes()


def _unpack_indices(buf: bytes, bits: int, n: int) -> np.ndarray:
    if bits >= 8:
        return np.frombuffer(buf, dtype=np.dtype(f"<u{bits // 8}"), count=n)
    per = 8 // bits
    b = np.frombuffer(buf, dtype=np.uint8)
    shifts = np.arange(per, dtype=np.uint8) * np.uint8(bits)
    mask = np.uint8((1 << bits) - 1)
    return ((b[:, None] >> shifts) & mask).reshape(-1)[:n]


def _encode_dict(flat: np.ndarray, values: np.ndarray,
                 indices: np.ndarray) -> bytes:
    bits = _index_bits(values.size)
    return b"".join((
        struct.pack("<IB", values.size, bits),
        np.ascontiguousarray(values).tobytes(),
        _pack_indices(indices, bits),
    ))


def _encode_bitpack(flat: np.ndarray) -> bytes:
    return np.packbits(flat.astype(np.uint8, copy=False)).tobytes()


# ---------------------------------------------------------------------------
# encode
# ---------------------------------------------------------------------------


def _choose_scheme(flat: np.ndarray) -> Tuple[int, bytes]:
    """Pick the cheapest scheme for one flattened buffer. The decision
    runs on a strided ~1k-element sample (one cheap scan); only schemes
    the sample says are promising pay for a full-column encode, and the
    winner must beat raw by ``_PAY_FRACTION`` to displace passthrough."""
    raw_nbytes = flat.nbytes
    if flat.dtype == np.bool_:
        # validity masks: 8 flags per byte always pays past header size
        return SCHEME_BITPACK, _encode_bitpack(flat)
    if (raw_nbytes < _MIN_ENCODE_BYTES or flat.dtype.kind not in "iufb"
            or flat.dtype.itemsize == 0):
        return SCHEME_RAW, flat.tobytes()

    step = max(1, flat.size // _SAMPLE)
    sample = flat[::step]
    item = flat.dtype.itemsize

    best_scheme = SCHEME_RAW
    best_payload = None
    best_size = int(raw_nbytes * _PAY_FRACTION)

    # dictionary: promising when the strided sample's cardinality is
    # small both absolutely and relative to the sample
    uniq = np.unique(sample)
    if uniq.size <= 0xFFFF and uniq.size <= max(2, sample.size // 4):
        if item == 1 and flat.dtype.kind in "iu":
            # 1-byte columns (the TPC-H flag/status targets) skip the
            # O(n log n) unique sort: 256-bucket bincount + LUT gather
            u8 = flat.view(np.uint8)
            present = np.flatnonzero(np.bincount(u8, minlength=256))
            values = present.astype(np.uint8).view(flat.dtype)
            lut = np.zeros(256, dtype=np.uint16)
            lut[present] = np.arange(present.size, dtype=np.uint16)
            indices = lut[u8]
        else:
            values, indices = np.unique(flat, return_inverse=True)
        if values.size <= 0xFFFF:
            bits = _index_bits(values.size)
            est = (values.size * item
                   + _index_nbytes(flat.size, bits) + 5)
            if est < best_size:
                payload = _encode_dict(flat, values, indices)
                if len(payload) < best_size:
                    best_scheme, best_payload = SCHEME_DICT, payload
                    best_size = len(payload)

    # run length: run DENSITY must come from contiguous windows — a
    # strided sample of a sorted column transitions at nearly every
    # sampled step even when real runs span hundreds of rows
    win = 256
    if flat.size <= 4 * win:
        est_runs = _rle_split(flat)[1].size
    else:
        transitions = 0
        seen = 0
        for start in np.linspace(0, flat.size - win, 4).astype(np.int64):
            w = flat[start:start + win]
            transitions += int(np.count_nonzero(w[1:] != w[:-1]))
            seen += w.size
        est_runs = max(int(flat.size * (transitions / max(seen, 1))), 1)
    est = est_runs * (4 + item) + 4
    if est < best_size:
        payload = _encode_rle(flat)
        if len(payload) < best_size:
            best_scheme, best_payload = SCHEME_RLE, payload
            best_size = len(payload)

    if best_payload is None:
        return SCHEME_RAW, flat.tobytes()
    return best_scheme, best_payload


def encode_array(arr: np.ndarray, *, seam: str = "integrity.spill",
                 level: Optional[int] = None) -> bytes:
    """One host buffer -> one self-describing codec frame.

    Scheme is chosen per buffer (see :func:`_choose_scheme`); when
    ``zstandard`` is importable and ``level`` (default
    ``compress.zstd_level``) is positive, the winning payload is
    additionally zstd-compressed iff that shrinks it. The frame header
    records dtype and shape so :func:`decode_array` needs no side
    channel."""
    t0 = time.perf_counter()
    a = np.ascontiguousarray(arr)
    flat = a.reshape(-1)
    scheme, payload = _choose_scheme(flat)
    zflag = 0
    if level is None:
        level = int(get_option("compress.zstd_level"))
    if level > 0 and len(payload) >= _MIN_ENCODE_BYTES and zstd_available():
        cctx, _ = zstd_codec(level)
        z = cctx.compress(payload)
        if len(z) < len(payload):
            payload, zflag = z, 1
    dts = a.dtype.str.encode()
    frame = b"".join((
        FRAME_MAGIC,
        struct.pack("<BBBB", FRAME_VERSION, scheme, zflag, len(dts)),
        dts,
        struct.pack("<B", a.ndim),
        struct.pack(f"<{a.ndim}Q", *a.shape),
        struct.pack("<Q", len(payload)),
        payload,
    ))
    key = seam_key(seam)
    telemetry.count("compress.bytes_in", a.nbytes)
    telemetry.count("compress.bytes_out", len(frame))
    telemetry.count(f"compress.{key}.bytes_in", a.nbytes)
    telemetry.count(f"compress.{key}.bytes_out", len(frame))
    telemetry.count(f"compress.scheme.{_SCHEME_NAMES[scheme]}")
    telemetry.count("compress.encode_us",
                    int((time.perf_counter() - t0) * 1e6))
    return frame


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------


def _decode_payload(scheme: int, payload: bytes, dtype: np.dtype,
                    n: int, *, seam: str, op: str) -> np.ndarray:
    if scheme == SCHEME_RAW:
        if len(payload) != n * dtype.itemsize:
            raise _corrupt("raw payload length disagrees with frame shape",
                           seam=seam, op=op, declared=n * dtype.itemsize,
                           actual=len(payload))
        return np.frombuffer(payload, dtype=dtype)
    if scheme == SCHEME_BITPACK:
        if dtype != np.bool_:
            raise _corrupt("bitpack frame with non-bool dtype",
                           seam=seam, op=op, dtype=dtype.str)
        if len(payload) * 8 < n:
            raise _corrupt("bitpack payload shorter than frame shape",
                           seam=seam, op=op, size=len(payload), count=n)
        return np.unpackbits(
            np.frombuffer(payload, dtype=np.uint8), count=n).astype(np.bool_)
    if scheme == SCHEME_RLE:
        if len(payload) < 4:
            raise _corrupt("rle frame truncated before run count",
                           seam=seam, op=op, size=len(payload))
        (nruns,) = struct.unpack_from("<I", payload)
        need = 4 + nruns * (4 + dtype.itemsize)
        if len(payload) != need:
            raise _corrupt("rle payload length disagrees with run count",
                           seam=seam, op=op, declared=need,
                           actual=len(payload))
        lengths = np.frombuffer(payload, dtype=np.uint32, count=nruns,
                                offset=4)
        values = np.frombuffer(payload, dtype=dtype, count=nruns,
                               offset=4 + nruns * 4)
        if int(lengths.sum()) != n:
            raise _corrupt("rle run lengths disagree with frame shape",
                           seam=seam, op=op, declared=n,
                           actual=int(lengths.sum()))
        return np.repeat(values, lengths)
    if scheme == SCHEME_DICT:
        if len(payload) < 5:
            raise _corrupt("dict frame truncated before header",
                           seam=seam, op=op, size=len(payload))
        k, bits = struct.unpack_from("<IB", payload)
        if bits not in (1, 2, 4, 8, 16, 32):
            raise _corrupt("dict index width clobbered", seam=seam, op=op,
                           width=bits)
        need = 5 + k * dtype.itemsize + _index_nbytes(n, bits)
        if len(payload) != need:
            raise _corrupt("dict payload length disagrees with header",
                           seam=seam, op=op, declared=need,
                           actual=len(payload))
        values = np.frombuffer(payload, dtype=dtype, count=k, offset=5)
        idx = _unpack_indices(payload[5 + k * dtype.itemsize:], bits, n)
        if n and (k == 0 or int(idx.max()) >= k):
            raise _corrupt("dict index out of range", seam=seam, op=op,
                           cardinality=k)
        return values[idx]
    raise _corrupt("unknown codec scheme", seam=seam, op=op, scheme=scheme)


def decode_array(frame: bytes, *, seam: str = "integrity.spill",
                 op: str = "compress.decode") -> np.ndarray:
    """One codec frame -> the original numpy buffer, bit-identical.

    Runs strictly AFTER the integrity trailer verified (the seam's
    ordering contract), but trusts nothing: magic, version, scheme,
    header arithmetic, payload length, run/dict consistency and the
    decoded element count are all checked, and every inconsistency — the
    corrupt-after-decompress shape a valid seal cannot rule out — raises
    the classified :class:`CorruptDataError` instead of decoding
    garbage."""
    t0 = time.perf_counter()
    try:
        if len(frame) < 8 or frame[:4] != FRAME_MAGIC:
            raise _corrupt("codec frame magic clobbered", seam=seam, op=op,
                           size=len(frame))
        version, scheme, zflag, dlen = struct.unpack_from("<BBBB", frame, 4)
        if version != FRAME_VERSION:
            raise _corrupt("codec frame version unknown", seam=seam, op=op,
                           version=version)
        i = 8
        if len(frame) < i + dlen + 1:
            raise _corrupt("codec frame truncated in dtype", seam=seam,
                           op=op, size=len(frame))
        try:
            dtype = np.dtype(frame[i:i + dlen].decode())
        except (TypeError, UnicodeDecodeError) as exc:
            raise _corrupt(f"codec frame dtype clobbered: {exc}", seam=seam,
                           op=op) from exc
        i += dlen
        ndim = frame[i]
        i += 1
        if ndim > 8 or len(frame) < i + 8 * ndim + 8:
            raise _corrupt("codec frame truncated in shape", seam=seam,
                           op=op, size=len(frame), ndim=ndim)
        shape = struct.unpack_from(f"<{ndim}Q", frame, i)
        i += 8 * ndim
        (plen,) = struct.unpack_from("<Q", frame, i)
        i += 8
        if len(frame) != i + plen:
            raise _corrupt("codec payload length disagrees with frame",
                           seam=seam, op=op, declared=plen,
                           actual=len(frame) - i)
        payload = frame[i:]
        n = 1
        for d in shape:
            n *= int(d)
        if n > (1 << 40):
            raise _corrupt("codec frame shape implausibly large",
                           seam=seam, op=op, count=n)
        if zflag:
            if not zstd_available():
                raise ModuleNotFoundError(
                    "zstandard is required to decode a zstd-compressed "
                    "codec frame")
            _, dctx = zstd_codec(1)
            try:
                payload = dctx.decompress(payload)
            except Exception as exc:
                raise _corrupt(f"zstd stage failed to decompress: {exc}",
                               seam=seam, op=op) from exc
        flat = _decode_payload(scheme, payload, dtype, n, seam=seam, op=op)
        if flat.size != n:  # pragma: no cover - scheme decoders check first
            raise _corrupt("decoded element count disagrees with frame "
                           "shape", seam=seam, op=op, declared=n,
                           actual=flat.size)
        out = flat.reshape(shape)
    except (CorruptDataError, ModuleNotFoundError):
        raise
    except Exception as exc:
        # untrusted bytes: any decoder failure is corruption, classified
        raise _corrupt(f"codec frame failed to decode: "
                       f"{type(exc).__name__}: {exc}", seam=seam,
                       op=op) from exc
    telemetry.count("compress.decode_us",
                    int((time.perf_counter() - t0) * 1e6))
    telemetry.count("compress.bytes_decoded", out.nbytes)
    return out


# ---------------------------------------------------------------------------
# snapshot packs — the SpillStore's host and disk tiers
# ---------------------------------------------------------------------------


def is_codec_pack(obj: Any) -> bool:
    return isinstance(obj, tuple) and len(obj) == 4 and obj[0] == PACK_TAG


def pack_array(arr: Optional[np.ndarray], seam: str):
    """Host buffer -> ``("tpcc", dtype_str, shape, frame)`` snapshot
    pack (None passes through). The tuple mirrors the legacy
    ``("zstd", ...)`` pack layout so checksum folding, corruption
    injection and fingerprint hashing stay codec-agnostic; the frame at
    index 3 is fully self-describing, the tuple's dtype/shape are the
    redundant copies those generic consumers read."""
    if arr is None:
        return None
    a = np.ascontiguousarray(arr)
    return (PACK_TAG, a.dtype.str, a.shape, encode_array(a, seam=seam))


def unpack_array(obj: Any, *, seam: str = "integrity.spill",
                 op: str = "compress.unpack") -> np.ndarray:
    """Snapshot pack -> numpy buffer, with the post-decode shape check
    against the pack's redundant header."""
    out = decode_array(obj[3], seam=seam, op=op)
    if out.dtype.str != obj[1] or tuple(out.shape) != tuple(obj[2]):
        raise _corrupt(
            "decoded buffer disagrees with snapshot pack header",
            seam=seam, op=op, declared=f"{obj[1]}{tuple(obj[2])}",
            actual=f"{out.dtype.str}{tuple(out.shape)}")
    return out
