"""The port's device-runtime bridge: ``runtime/bridge.py`` behind the C
ABI of ``runtime/native_src/rt_bridge.cpp`` (``libtpudf_rt.so``, built
into ``build/torch_native/``), driven over ctypes on the CPU.

- The reference's 8-column table and a DECIMAL128 table round-trip
  through the ABI; the row bytes equal the reference's C++ host codec
  (``ops/row_conversion_host.py``, run on the port's build of
  ``src/native``) and the reference's device ``convert_to_rows``, and
  the columns come back as they went in.
- SF-shaped lineitem rows at the edge row counts with null tails cross
  in both directions, equal to the port's direct ``convert_to_rows``.
- Errors come back as -1 and ``tpudf_rt_last_error``; a handle made on
  one thread reads right on another.
- The exported ``tpudf_rt_*`` symbols equal the reference source's.
- The embedded-interpreter self test (a C program that owns
  ``Py_Initialize``) passes, and ``init_platform("")`` refuses to run
  without a CUDA device, through the ABI and in Python."""

from __future__ import annotations

import ctypes
import os
import re
import site
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest

from spark_rapids_jni_tpu.models import tpch as jtpch
from spark_rapids_jni_tpu.ops import row_conversion as jrc
from spark_rapids_jni_tpu.ops import row_conversion_host as jhost
from spark_rapids_jni_tpu_torch.ops.row_conversion import convert_to_rows
from spark_rapids_jni_tpu_torch.runtime import bridge, native
from torch_parity import (
    EDGE_ROWS,
    RT_TABLE,
    RT_VALID,
    assert_same_table,
    host_columns,
    jax_table,
    reference_native,
    rt_check,
    rt_column,
    rt_column_host,
    rt_from_rows,
    rt_rows_bytes,
    rt_rows_info,
    rt_table,
    rt_to_rows,
    to_port,
    with_null_tails,
)

ROOT = Path(__file__).resolve().parents[1]


def _sys_path() -> str:
    """sys.path entries an embedded interpreter needs: the repo and the
    site-packages that hold torch and numpy."""
    return ":".join([str(ROOT), *site.getsitepackages()])


@pytest.fixture(scope="module")
def rt():
    lib = native.load_rt_bridge()
    rt_check(lib, lib.tpudf_rt_init(str(ROOT).encode(), b"cpu") == 0,
             "init")
    return lib


def _limbs(values) -> np.ndarray:
    """DECIMAL128 storage: int64[n, 2] (lo, hi) little-endian limbs."""
    lo = np.array([v & (2**64 - 1) for v in values], np.uint64)
    hi = np.array([v >> 64 for v in values], np.int64)
    return np.stack([lo.view(np.int64), hi], axis=1)


def _round_trip(lib, host):
    """``host`` ([(type_id, scale, data, valid)]) through the ABI: the
    row image's bytes of each batch, and the columns read back."""
    cols = [rt_column(lib, tid, s, d, v) for tid, s, d, v in host]
    tbl = rt_table(lib, cols)
    assert lib.tpudf_rt_table_num_columns(tbl) == len(host)
    assert lib.tpudf_rt_table_num_rows(tbl) == len(host[0][2])
    batches = rt_to_rows(lib, tbl)
    images, back = [], []
    for b in batches:
        images.append(rt_rows_bytes(lib, b))
        # the batch back through rows_from_host, as a JVM would send it
        n, size = rt_rows_info(lib, b)
        again = lib.tpudf_rt_rows_from_host(n, size, images[-1].tobytes())
        rt_check(lib, again > 0, "rows_from_host")
        t = rt_from_rows(lib, again, [(tid, s) for tid, s, _, _ in host])
        back.append([rt_column_host(lib, t, i, d.itemsize * (
            2 if d.ndim == 2 else 1)) for i, (_, _, d, _) in
            enumerate(host)])
        for h in (t, again, b):
            assert lib.tpudf_rt_free(h) == 0
    for h in cols + [tbl]:
        assert lib.tpudf_rt_free(h) == 0
    return images, back


def _assert_columns_back(host, back) -> None:
    """The batches' columns, concatenated, equal the input bytes under
    validity and its validity exactly."""
    for i, (tid, scale, data, valid) in enumerate(host):
        info = [b[i][0] for b in back]
        assert all(x[:2] == (tid, scale) for x in info)
        assert sum(x[2] for x in info) == len(data)
        got = np.concatenate([b[i][1] for b in back]).view(data.dtype)
        got = got.reshape(data.shape)
        gv = np.concatenate([b[i][2] for b in back]).astype(bool)
        want_v = np.ones(len(data), bool) if valid is None else valid
        np.testing.assert_array_equal(gv, want_v)
        np.testing.assert_array_equal(got[gv], data[want_v])


def test_reference_table_round_trip_matches_host_codec(rt, monkeypatch):
    reference_native(monkeypatch)
    host = [(tid, s, d, RT_VALID) for tid, s, d in RT_TABLE]
    images, back = _round_trip(rt, host)
    assert len(images) == 1 and len(back) == 1  # one batch
    jtab = jax_table(host)
    want = np.asarray(jhost.host_to_rows(jtab)).reshape(-1)
    np.testing.assert_array_equal(images[0], want)
    device = np.asarray(jrc.convert_to_rows(jtab)[0].data)
    np.testing.assert_array_equal(images[0], device)
    _assert_columns_back(host, back)
    # the reference's host codec reads the ABI's image back to the table
    schema = jtab.schema()
    row_size = len(want) // 6
    assert_same_table(
        to_port(jhost.host_from_rows(images[0].reshape(6, row_size),
                                     schema)),
        jhost.host_from_rows(want.reshape(6, row_size), schema))


def test_decimal128_round_trip_matches_host_codec(rt, monkeypatch):
    reference_native(monkeypatch)
    vals = [1, -(1 << 100), (1 << 120) + 7, 0, -1, 2**127 - 1, -2**127]
    valid = np.array([1, 1, 1, 0, 1, 1, 1], bool)
    host = [(27, -2, _limbs(vals), valid),
            (4, 0, np.arange(7, dtype=np.int64) - 3, None)]
    images, back = _round_trip(rt, host)
    jtab = jax_table(host)
    np.testing.assert_array_equal(
        images[0], np.asarray(jhost.host_to_rows(jtab)).reshape(-1))
    assert images[0].size == 7 * 32  # 16 + 8 + 1 validity byte, padded
    _assert_columns_back(host, back)


@pytest.mark.parametrize("n", EDGE_ROWS)
def test_lineitem_rows_cross_the_abi(rt, n):
    port, ref = with_null_tails(jtpch.lineitem_table(n, seed=n),
                                (0, 3, 6), seed=n)
    host = [(tid, s, d, v) for tid, s, d, v in host_columns(ref)]
    images, back = _round_trip(rt, host)
    direct = convert_to_rows(port)
    assert len(images) == len(direct) == 1
    np.testing.assert_array_equal(images[0], direct[0].data.numpy())
    np.testing.assert_array_equal(
        images[0], np.asarray(jrc.convert_to_rows(ref)[0].data))
    _assert_columns_back(host, back)


def test_errors_come_back_through_last_error(rt):
    assert rt.tpudf_rt_table_num_rows(999_999) == -1
    assert b"handle" in rt.tpudf_rt_last_error()
    assert rt.tpudf_rt_column_from_host(99, 0, 1, b"\0" * 8, 8, None) == -1
    assert rt.tpudf_rt_last_error() != b""
    # a STRING column does not cross as fixed-width bytes
    assert rt.tpudf_rt_column_from_host(23, 0, 1, b"\0" * 8, 8, None) == -1
    assert b"fixed-width" in rt.tpudf_rt_last_error()
    # fewer bytes than the row count needs
    assert rt.tpudf_rt_column_from_host(4, 0, 4, b"\0" * 8, 8, None) == -1
    assert b"32 bytes expected" in rt.tpudf_rt_last_error()
    col = rt_column(rt, 4, 0, np.arange(5, dtype=np.int64))
    small = ctypes.create_string_buffer(8)
    assert rt.tpudf_rt_column_to_host(col, small, 8, None, 0) == -1
    assert b"too small" in rt.tpudf_rt_last_error()
    tbl = rt_table(rt, [col])
    out = (ctypes.c_int64 * 1)()
    n = ctypes.c_int32(0)
    # cap 0: the batch count is reported, the array is too small
    assert rt.tpudf_rt_convert_to_rows(tbl, out, 0, ctypes.byref(n)) == -1
    assert n.value == 1 and b"too small" in rt.tpudf_rt_last_error()
    (rows,) = rt_to_rows(rt, tbl)
    assert rt.tpudf_rt_rows_to_host(rows, small, 8) == -1
    assert b"too small" in rt.tpudf_rt_last_error()
    tids = (ctypes.c_int32 * 2)(4, 4)
    scales = (ctypes.c_int32 * 2)(0, 0)
    assert rt.tpudf_rt_convert_from_rows(rows, tids, scales, 2) == -1
    assert b"layout" in rt.tpudf_rt_last_error()
    for h in (rows, tbl, col):
        assert rt.tpudf_rt_free(h) == 0
    assert rt.tpudf_rt_free(col) == -1  # freed already


def test_handles_cross_threads(rt):
    data = np.arange(1000, dtype=np.int64) * 7
    valid = np.arange(1000) % 5 != 0
    made, got, errors = [], [], []

    def make():
        made.append(rt_column(rt, 4, 0, data, valid))

    def read():
        try:
            tbl = rt_table(rt, made)
            got.append(rt_column_host(rt, tbl, 0, 8))
            rt.tpudf_rt_free(tbl)
        except AssertionError as exc:  # re-raised on the main thread
            errors.append(exc)

    for target in (make, read):
        th = threading.Thread(target=target)
        th.start()
        th.join(timeout=120)
        assert not th.is_alive()
    assert not errors
    (info, raw, v) = got[0]
    assert info == (4, 0, 1000)
    np.testing.assert_array_equal(v.astype(bool), valid)
    np.testing.assert_array_equal(raw.view(np.int64)[valid], data[valid])
    rt.tpudf_rt_free(made[0])

    # more threads than cores round-tripping at once, switching often:
    # every handle and every byte stays each thread's own
    def work(seed):
        rng = np.random.default_rng(seed)
        host = [(4, 0, rng.integers(-9, 9, 3000).astype(np.int64),
                 rng.random(3000) > 0.2),
                (9, 0, rng.random(3000).astype(np.float32), None)]
        try:
            for _ in range(3):
                _assert_columns_back(host, _round_trip(rt, host)[1])
        except AssertionError as exc:
            errors.append(exc)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=work, args=(s,))
                   for s in range((os.cpu_count() or 4) + 2)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in threads)
    assert not errors


def _defined_symbols(source: str) -> set:
    return set(re.findall(r"^\w[\w\s\*]*?\b(tpudf_rt_\w+)\(", source,
                          re.MULTILINE))


def test_symbol_set_equals_the_reference_bridge():
    want = _defined_symbols((ROOT / "src/native/src/rt_bridge.cpp")
                            .read_text())
    assert len(want) == 15
    port_src = (native.RT_SRC_DIR / "rt_bridge.cpp").read_text()
    assert _defined_symbols(port_src) == want
    lib = native.load_rt_bridge()
    out = subprocess.run(["nm", "-D", "--defined-only",
                          str(native.BUILD_DIR / native.RT_LIB_NAME)],
                         capture_output=True, text=True, check=True).stdout
    exported = {line.split()[-1] for line in out.splitlines()
                if " T " in line and "tpudf_rt_" in line}
    assert exported == want
    assert all(hasattr(lib, name) for name in want)


def test_library_builds_into_the_port_directory_only():
    native.load_rt_bridge()
    assert (native.BUILD_DIR / native.RT_LIB_NAME).exists()
    assert native.BUILD_DIR == ROOT / "build" / "torch_native"
    assert "build/native/" not in (native.BUILD_DIR
                                   / "rt_build.log").read_text()


def test_embedded_interpreter_self_test():
    exe = native.rt_selftest_path()
    assert exe is not None, native.python_embed()
    env = dict(os.environ, TPUDF_PY_PATH=_sys_path(),
               TPUDF_RT_PLATFORM="cpu")
    proc = subprocess.run([str(exe)], env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "all checks passed" in proc.stdout


def test_init_refuses_without_cuda_and_retries():
    code = (
        "import ctypes, sys; "
        "from spark_rapids_jni_tpu_torch.runtime import native; "
        "lib = native.load_rt_bridge(); "
        "rc = lib.tpudf_rt_init(b'', b''); err = lib.tpudf_rt_last_error(); "
        "rc2 = lib.tpudf_rt_init(b'', b'cpu'); "
        "print(rc, rc2, err.decode())")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    rc, rc2, err = proc.stdout.strip().split(" ", 2)
    assert (rc, rc2) == ("-1", "0")
    assert "no CUDA device" in err


def test_init_platform_in_python():
    with pytest.raises(ValueError, match="unknown platform"):
        bridge.init_platform("tpu")
    if not bridge.torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            bridge.init_platform("")
    bridge.init_platform("cpu")
    col = bridge.column_from_host(4, 0, 3, np.arange(3, dtype=np.int64)
                                  .tobytes(), None)
    assert col.device.type == "cpu" and col.validity is None
    assert bridge.column_to_host(col) == (
        np.arange(3, dtype=np.int64).tobytes(), b"\x01\x01\x01")
