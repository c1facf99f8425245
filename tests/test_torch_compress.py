"""The port's columnar codec (``runtime/compress.py``) and integrity
trailers (``runtime/integrity.py``) against the JAX package's: the same
array gives the same frame bytes, for each scheme and dtype, with the
zstd final stage on and off; each package decodes the other's frames
bit for bit; a mutated frame classifies the same way in both; seals,
checksums and corruption mutations are byte-equal. Tolerance: exact
everywhere (bytes)."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu.runtime import compress as jcompress
from spark_rapids_jni_tpu.runtime import faults as jfaults
from spark_rapids_jni_tpu.runtime import integrity as jintegrity
from spark_rapids_jni_tpu.utils import config as jconfig
from spark_rapids_jni_tpu_torch import telemetry
from spark_rapids_jni_tpu_torch.runtime import compress, faults, integrity
from spark_rapids_jni_tpu_torch.runtime.resilience import CorruptDataError
from spark_rapids_jni_tpu_torch.utils import config

_CASES = [
    ("lowcard_int8", lambda rng: rng.integers(0, 3, 20_000).astype(np.int8),
     compress.SCHEME_DICT),
    ("lowcard_uint8", lambda rng: rng.integers(0, 16, 20_000).astype(
        np.uint8), compress.SCHEME_DICT),
    ("lowcard_int32", lambda rng: rng.integers(0, 9, 20_000).astype(np.int32),
     compress.SCHEME_DICT),
    ("lowcard_int64", lambda rng: rng.integers(-5, 5, 9_000), compress.SCHEME_DICT),
    ("sorted_int32", lambda rng: np.sort(
        rng.integers(0, 60, 20_000)).astype(np.int32), compress.SCHEME_RLE),
    ("const_int64", lambda rng: np.full(20_000, 7, dtype=np.int64),
     compress.SCHEME_RLE),
    ("runs_f64", lambda rng: np.repeat(rng.random(40), 500),
     compress.SCHEME_RLE),
    ("random_f64", lambda rng: rng.random(20_000), compress.SCHEME_RAW),
    ("random_f32", lambda rng: rng.random(20_000).astype(np.float32),
     compress.SCHEME_RAW),
    ("random_uint64", lambda rng: rng.integers(0, 2**63, 5_000).astype(
        np.uint64), compress.SCHEME_RAW),
    ("bool_validity", lambda rng: rng.random(20_000) > 0.1,
     compress.SCHEME_BITPACK),
    ("chars_2d", lambda rng: rng.integers(65, 70, (4096, 8)).astype(
        np.uint8), None),
    ("decimal_limbs", lambda rng: np.stack(
        [rng.integers(0, 5, 8192), np.zeros(8192, dtype=np.int64)],
        axis=1).astype(np.int64), None),
    ("string_offsets", lambda rng: np.arange(0, 8192 * 4, 4).astype(
        np.int32), None),
    ("tiny", lambda rng: np.arange(3, dtype=np.int64), compress.SCHEME_RAW),
    ("empty", lambda rng: np.empty(0, dtype=np.float32),
     compress.SCHEME_RAW),
]


@pytest.fixture(autouse=True)
def _options():
    telemetry.reset()
    yield
    for name in ("compress.zstd_level", "compress.enabled", "compress.spill"):
        config.reset_option(name)
        jconfig.reset_option(name)


@pytest.mark.parametrize("level", [0, 3])
@pytest.mark.parametrize("name,mk,scheme", _CASES,
                         ids=[c[0] for c in _CASES])
def test_frames_equal_the_reference(name, mk, scheme, level):
    arr = mk(np.random.default_rng(len(name)))
    frame = compress.encode_array(arr, level=level)
    want = jcompress.encode_array(arr, level=level)
    assert frame == want
    if scheme is not None:
        assert frame[5] == scheme
    for f in (frame, want):
        got = compress.decode_array(f)
        assert got.dtype == arr.dtype and got.shape == arr.shape
        assert got.tobytes() == arr.tobytes()
    assert telemetry.counter("compress.bytes_in") == arr.nbytes


@pytest.mark.parametrize("name,mk", [(c[0], c[1]) for c in _CASES[::3]],
                         ids=[c[0] for c in _CASES[::3]])
def test_packs_equal_the_reference(name, mk):
    arr = mk(np.random.default_rng(7))
    pack = compress.pack_array(arr, "integrity.checkpoint")
    want = jcompress.pack_array(arr, "integrity.checkpoint")
    assert pack == want
    assert compress.unpack_array(want).tobytes() == arr.tobytes()
    assert telemetry.counter("compress.checkpoint.bytes_in") == arr.nbytes


def _mutate(frame: bytes, seed: int) -> bytes:
    """The reference's test mutations: a header bit flip, a truncation or
    a header byte clobber (the zstd flag byte excluded)."""
    positions = tuple(range(0, 6)) + tuple(range(7, 16))
    rng = np.random.default_rng(seed)
    if seed % 3 == 1:
        return frame[: int(rng.integers(1, len(frame)))]
    pos = positions[int(rng.integers(0, len(positions)))]
    mask = 1 << int(rng.integers(0, 8)) if seed % 3 == 0 else 0xFF
    return frame[:pos] + bytes([frame[pos] ^ mask]) + frame[pos + 1:]


def _outcome(decode, frame):
    try:
        return ("ok", decode(frame).tobytes())
    except Exception as exc:  # compared across the packages
        return ("error", type(exc).__name__, str(exc).split(" [")[0])


@pytest.mark.parametrize("seed", range(24))
def test_mutated_frames_classify_as_the_reference(seed):
    arr = np.sort(np.random.default_rng(seed).integers(0, 20, 4096)).astype(
        np.int32)
    mutated = _mutate(compress.encode_array(arr, level=0), seed)
    got = _outcome(compress.decode_array, mutated)
    assert got == _outcome(jcompress.decode_array, mutated)
    if got[0] == "error":
        assert got[1] == "CorruptDataError"
        assert telemetry.counter("compress.mismatch") == 1
        assert telemetry.counter("integrity.mismatch.integrity.spill") == 1
    else:
        assert got[1] == arr.tobytes()


def test_zstd_stage_is_optional_and_never_skipped_silently(monkeypatch):
    arr = np.sort(np.random.default_rng(0).integers(0, 9, 10_000))
    if compress.zstd_available():
        frame = compress.encode_array(arr, level=3)
        assert frame == jcompress.encode_array(arr, level=3)
        assert compress.decode_array(frame).tobytes() == arr.tobytes()
    # without the package: asking for it raises, and a frame whose zstd
    # flag is set refuses to decode instead of passing bytes through
    flagged = bytearray(compress.encode_array(arr, level=0))
    flagged[6] = 1
    monkeypatch.setattr(compress, "_ZSTD_OK", False)

    def absent(level):
        raise ModuleNotFoundError("No module named 'zstandard'")

    monkeypatch.setattr(compress, "zstd_codec", absent)
    with pytest.raises(ModuleNotFoundError):
        compress.decode_array(bytes(flagged))
    plain = compress.encode_array(arr, level=19)
    assert plain[6] == 0 and plain == jcompress.encode_array(arr, level=0)
    from spark_rapids_jni_tpu_torch.runtime.memory import SpillStore

    with pytest.raises(ModuleNotFoundError):
        SpillStore(1 << 20, compress_spill=True)


def test_seam_gates_follow_the_options():
    assert compress.seam_enabled("integrity.spill")
    assert not compress.seam_enabled("integrity.nope")
    config.set_option("compress.spill", False)
    assert not compress.seam_enabled("integrity.spill")
    assert compress.seam_enabled("integrity.checkpoint")
    config.set_option("compress.enabled", "off")
    assert not compress.seam_enabled("integrity.checkpoint")


@pytest.mark.parametrize("size", [0, 1, 15, 16, 17, 4099])
def test_seals_and_checksums_equal_the_reference(size):
    payload = np.random.default_rng(size).integers(
        0, 256, size).astype(np.uint8).tobytes()
    assert integrity.checksum(payload) == jintegrity.checksum(payload)
    sealed = integrity.seal(payload)
    assert sealed == jintegrity.seal(payload)
    assert integrity.verify(sealed, seam="integrity.spill") == payload
    assert jintegrity.verify(sealed, seam="integrity.spill") == payload


@pytest.mark.parametrize("mode", ["flip", "truncate", "trailer"])
def test_corruptions_equal_the_reference_and_are_caught(mode):
    sealed = integrity.seal(b"spilled partial bytes" * 40)
    spec = faults.CorruptionSpec("integrity.checkpoint", mode, seed=3)
    jspec = jfaults.CorruptionSpec("integrity.checkpoint", mode, seed=3)
    bad = spec.apply(sealed, 5)
    assert bad == jspec.apply(sealed, 5) and bad != sealed
    with pytest.raises(CorruptDataError) as ei:
        integrity.verify(bad, seam="integrity.checkpoint", op="t", chunk=5)
    with pytest.raises(Exception) as ej:
        jintegrity.verify(bad, seam="integrity.checkpoint", op="t", chunk=5)
    assert str(ei.value) == str(ej.value)
    assert telemetry.counter("integrity.mismatch.integrity.checkpoint") == 1


def test_snapshot_checksums_equal_the_reference():
    rng = np.random.default_rng(1)
    data = rng.integers(0, 1000, 777)
    valid = rng.random(777) > 0.2
    chars = rng.integers(0, 256, 3000).astype(np.uint8)
    offs = np.sort(rng.integers(0, 3000, 778)).astype(np.int32)
    pack = jcompress.pack_array(data, "integrity.spill")
    snaps = [(None, data, valid, None, None),
             (None, offs, None, chars, None),
             (None, pack, valid, None, [(None, offs, None, None, None)])]
    port = [(None, torch.from_numpy(data), torch.from_numpy(valid), None,
             None),
            (None, torch.from_numpy(offs), None, torch.from_numpy(chars),
             None),
            (None, pack, torch.from_numpy(valid), None,
             [(None, torch.from_numpy(offs), None, None, None)])]
    crc = jintegrity.snaps_checksum(snaps)
    assert integrity.snaps_checksum(port) == crc
    assert integrity.snaps_checksum(snaps) == crc
    integrity.verify_snaps(port, crc, seam="integrity.spill")
    with pytest.raises(CorruptDataError):
        integrity.verify_snaps(port, crc ^ 1, seam="integrity.spill")


def test_payload_files_round_trip_and_verify(tmp_path):
    blob = integrity.seal(b"x" * 1000)
    path = str(tmp_path / "p.bin")
    assert integrity.write_payload_file(path, blob) == len(blob)
    assert integrity.read_payload_file(path, seam="integrity.spill",
                                       sealed=True) == b"x" * 1000
    assert jintegrity.read_payload_file(path, seam="integrity.spill",
                                        sealed=True) == b"x" * 1000
    with open(path, "r+b") as fh:
        fh.seek(10)
        fh.write(b"y")
    with pytest.raises(CorruptDataError, match="checksum mismatch"):
        integrity.read_payload_file(path, seam="integrity.spill",
                                    sealed=True)
    assert not list(tmp_path.glob(".integrity-*"))
