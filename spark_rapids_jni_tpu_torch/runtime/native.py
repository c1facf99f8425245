"""Load, and build at first use, the readers' native host engine
(counterpart of the reference's ``runtime/native.py``).

The engine is the reference's C++ library, ``libtpudf``, built unchanged
from ``src/native/``: Parquet footer prune/filter, Parquet and ORC page
decode, and the get_json_object byte machine. It is host code, not a
kernel. The search order is the reference's, except for the port's own
build directory:

  1. ``SPARK_RAPIDS_TPU_NATIVE_LIB`` (an explicit path);
  2. a packaged ``_lib/libtpudf.so`` next to this module;
  3. ``build/torch_native/libtpudf.so`` under the repo root, when its
     stamp (the SHA-256 of the sources and the build line) matches;
  4. a build of ``src/native`` into ``build/torch_native/``.

The build never writes ``build/native/``, where the JAX package looks.
It takes an ``fcntl`` lock on ``build/torch_native/.lock`` (test workers
build at once) and renames the finished library into place, so a reader
never sees a half-written file. There is one route, on every machine:
one ``g++ -c`` per source of ``CMakeLists.txt``'s library, all started
together, with the flags of that file's Release build (``-O3 -DNDEBUG``,
``-fPIC``, ``-Wall -Wextra -Werror``), then ``g++ -shared ... -lz
-lzstd``. Where the system carries zstd's runtime library
(``libzstd.so.1``) but not its development header and link name, the
build links the runtime library by its soname and compiles against
``native_include/zstd.h``, which declares the two functions of zstd's
stable API that the sources call.

A library that cannot be found or built raises ``OSError`` with the whole
search trail and the build's output: there is no stand-in decoder.

The bridge library (``load_rt_bridge``) is the port's own: the C ABI of
``native_src/rt_bridge.cpp`` over ``runtime/bridge.py``, built at first
use into ``build/torch_native/libtpudf_rt.so`` (never ``build/native/``)
with the same flags and lock, against this interpreter's headers
(``sysconfig.get_paths()['include']``; a missing ``Python.h`` is a
build error that names it). The library leaves the Python symbols
undefined, so a Python process loads it with ctypes as it is. Where the
interpreter's shared library (``libpython3.12.so``) exists, the same
build links the embedded-interpreter self test
``build/torch_native/tpudf_rt_selftest`` against it
(``rt_selftest_path``).
"""

from __future__ import annotations

import ctypes
import ctypes.util
import fcntl
import hashlib
import os
import pathlib
import shutil
import subprocess
import sysconfig
import tempfile
import threading
import time
from typing import Optional

_REPO_ROOT = pathlib.Path(__file__).resolve().parents[2]
_LIB_NAME = "libtpudf.so"
SRC_DIR = _REPO_ROOT / "src" / "native"
BUILD_DIR = _REPO_ROOT / "build" / "torch_native"
SHIM_INCLUDE = pathlib.Path(__file__).resolve().parent / "native_include"
# the library's sources, as src/native/CMakeLists.txt lists them
SOURCES = ("thrift_compact.cpp", "parquet_footer.cpp", "parquet_reader.cpp",
           "protobuf_wire.cpp", "orc_reader.cpp", "row_conversion.cpp",
           "get_json_object.cpp", "c_api.cpp")
# CMakeLists.txt's Release build: CMAKE_CXX_FLAGS_RELEASE, position-
# independent code, and the library's warning options
_CXX_FLAGS = ["-std=c++17", "-O3", "-DNDEBUG", "-fPIC", "-Wall", "-Wextra",
              "-Werror"]
_TIMEOUT_S = 600

_lock = threading.Lock()
_loaded: Optional["NativeLib"] = None
build_seconds: Optional[float] = None  # None: no build in this process


class NativeLib:
    """ctypes surface of libtpudf with argtypes pinned (the reference's)."""

    def __init__(self, cdll: ctypes.CDLL, path: pathlib.Path):
        self.path = path
        self._c = cdll
        c = cdll
        i32, i64, u64 = ctypes.c_int32, ctypes.c_int64, ctypes.c_uint64
        p_i32, p_i64 = ctypes.POINTER(i32), ctypes.POINTER(i64)
        vp, cp = ctypes.c_void_p, ctypes.c_char_p
        p_u8 = ctypes.POINTER(ctypes.c_uint8)
        sigs = {
            "tpudf_last_error": (cp, None),
            "tpudf_footer_read_and_filter": (
                i64, [cp, u64, i64, i64, ctypes.POINTER(cp), p_i32,
                      i32, i32, i32]),
            "tpudf_footer_num_rows": (i64, [i64]),
            "tpudf_footer_num_columns": (i32, [i64]),
            "tpudf_footer_serialize": (
                i32, [i64, ctypes.POINTER(p_u8), ctypes.POINTER(u64)]),
            "tpudf_free_buffer": (None, [p_u8]),
            "tpudf_footer_close": (i32, [i64]),
            "tpudf_open_handles": (i64, None),
            # Parquet data reader
            "tpudf_parquet_read": (i64, [cp, u64, p_i32, i32, p_i32, i32]),
            "tpudf_parquet_row_groups": (i32, [cp, u64, p_i64, p_i64, i32]),
            "tpudf_read_num_rows": (i64, [i64]),
            "tpudf_read_num_columns": (i32, [i64]),
            "tpudf_read_col_meta": (i32, [i64, i32, p_i32, p_i64]),
            "tpudf_parquet_read_path": (i64, [cp, p_i32, i32, p_i32, i32]),
            "tpudf_parquet_row_groups_path": (i32, [cp, p_i64, p_i64, i32]),
            "tpudf_read_col_meta2": (i32, [i64, i32, p_i32, p_i64]),
            "tpudf_read_col_levels": (i32, [i64, i32, vp, vp]),
            "tpudf_read_schema_desc": (cp, [i64]),
            "tpudf_read_col_name": (cp, [i64, i32]),
            "tpudf_read_col_copy": (i32, [i64, i32, vp, vp, vp, vp]),
            "tpudf_read_close": (i32, [i64]),
            # ORC reader
            "tpudf_orc_read": (i64, [cp, u64, p_i32, i32, p_i32, i32]),
            "tpudf_orc_stripes": (i32, [cp, u64, p_i64, p_i64, i32]),
            "tpudf_orc_num_columns": (i32, [i64]),
            "tpudf_orc_num_rows": (i64, [i64]),
            "tpudf_orc_col_meta": (i32, [i64, i32, p_i32, p_i64]),
            "tpudf_orc_col_name": (cp, [i64, i32]),
            "tpudf_orc_writer_timezone": (cp, [i64]),
            "tpudf_orc_read_path": (i64, [cp, p_i32, i32, p_i32, i32]),
            "tpudf_orc_stripes_path": (i32, [cp, p_i64, p_i64, i32]),
            "tpudf_orc_col_copy": (i32, [i64, i32, vp, vp, vp, vp]),
            "tpudf_orc_close": (i32, [i64]),
            "tpudf_orc_decode_rle2": (i32, [cp, u64, i64, i32, vp]),
            # host packed-row codec
            "tpudf_rows_layout": (i32, [p_i32, i32, p_i32]),
            "tpudf_to_rows": (i32, [ctypes.POINTER(vp), ctypes.POINTER(vp),
                                    p_i32, i32, i64, vp]),
            "tpudf_from_rows": (i32, [vp, i64, p_i32, i32,
                                      ctypes.POINTER(vp),
                                      ctypes.POINTER(vp)]),
            # get_json_object: chars, offsets, valid (nullable), n_rows,
            # path, out chars, out length, out offsets, out valid
            "tpudf_get_json_object": (
                i32, [vp, vp, vp, i64, cp, ctypes.POINTER(p_u8), p_i64,
                      vp, vp]),
        }
        for name, (restype, argtypes) in sigs.items():
            fn = getattr(c, name)
            fn.restype = restype
            if argtypes is not None:
                fn.argtypes = argtypes

    def __getattr__(self, name):
        return getattr(self._c, name)

    def last_error(self) -> str:
        return self._c.tpudf_last_error().decode(errors="replace")


def _lib_path() -> pathlib.Path:
    return BUILD_DIR / _LIB_NAME


def _stamp_path() -> pathlib.Path:
    return BUILD_DIR / (_LIB_NAME + ".sha256")


def _digest() -> str:
    h = hashlib.sha256()
    for flag in _CXX_FLAGS:
        h.update(flag.encode() + b"\0")
    for name in SOURCES:
        h.update(name.encode() + b"\0"
                 + (SRC_DIR / "src" / name).read_bytes() + b"\0")
    for hdr in sorted((SRC_DIR / "include").rglob("*.hpp")) \
            + sorted(SHIM_INCLUDE.glob("*.h")):
        h.update(hdr.name.encode() + b"\0" + hdr.read_bytes() + b"\0")
    return h.hexdigest()


def _stamp_matches() -> bool:
    try:
        return _stamp_path().read_text().strip() == _digest() \
            and _lib_path().exists()
    except OSError:
        return False


def _candidate_paths() -> list[pathlib.Path]:
    out = []
    env = os.environ.get("SPARK_RAPIDS_TPU_NATIVE_LIB")
    if env:
        out.append(pathlib.Path(env))
    out.append(pathlib.Path(__file__).parent / "_lib" / _LIB_NAME)
    return out


def _run(cmd: list, log: list, cwd=None) -> subprocess.CompletedProcess:
    proc = subprocess.run(cmd, capture_output=True, text=True, cwd=cwd,
                          timeout=_TIMEOUT_S)
    log.append("$ " + " ".join(str(c) for c in cmd) + "\n" + proc.stdout
               + proc.stderr)
    return proc


def _compiles(cxx: str, snippet: str, args: list, log: list) -> bool:
    """Does ``snippet`` compile and link into a shared object with
    ``args``? The toolchain probe."""
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        src = pathlib.Path(tmp) / "probe.cpp"
        src.write_text(snippet)
        return _run([cxx, "-std=c++17", "-fPIC", "-shared", str(src), "-o",
                     str(pathlib.Path(tmp) / "probe.so"), *args],
                    log).returncode == 0


def probe_toolchain(log: list) -> dict:
    """What this machine offers for the build: the compiler, and for
    zlib and zstd whether the header and the link library are found
    (``-lz``/``-lzstd``) or only the runtime library's soname."""
    cxx = shutil.which("g++") or shutil.which("c++")
    out = {"cxx": cxx}
    if cxx is None:
        return out
    for lib, header, call in (
            ("z", "zlib.h", "return (int)zlibVersion()[0];"),
            ("zstd", "zstd.h", "return (int)ZSTD_isError(0);")):
        body = f"#include <{header}>\nint probe() {{ {call} }}\n"
        out[f"{lib}_header"] = _compiles(cxx, body, ["-c"], log)
        out[f"{lib}_link"] = _compiles(cxx, "int x;\n", [f"-l{lib}"], log)
        out[f"{lib}_soname"] = ctypes.util.find_library(lib)
    return out


def _link_flag(tc: dict, lib: str) -> Optional[str]:
    if tc.get(f"{lib}_link"):
        return f"-l{lib}"
    soname = tc.get(f"{lib}_soname")
    return f"-l:{soname}" if soname else None


def _build_gxx(tc: dict, out_dir: pathlib.Path, log: list) -> pathlib.Path:
    includes = ["-I", str(SRC_DIR / "include")]
    if not tc["zstd_header"]:
        includes += ["-I", str(SHIM_INCLUDE)]
    procs = []
    for name in SOURCES:
        obj = out_dir / (name + ".o")
        cmd = [tc["cxx"], *_CXX_FLAGS, *includes, "-c",
               str(SRC_DIR / "src" / name), "-o", str(obj)]
        procs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = False
    for cmd, _, proc in procs:
        text, _ = proc.communicate(timeout=_TIMEOUT_S)
        log.append("$ " + " ".join(cmd) + "\n" + text)
        failed |= proc.returncode != 0
    if failed:
        raise OSError("compiling src/native failed")
    lib = out_dir / _LIB_NAME
    cmd = [tc["cxx"], "-shared", "-o", str(lib),
           *[str(obj) for _, obj, _ in procs],
           _link_flag(tc, "z"), _link_flag(tc, "zstd")]
    if _run(cmd, log).returncode != 0:
        raise OSError("linking libtpudf.so failed")
    return lib


def _build_native(tried: list) -> pathlib.Path:
    """Build into ``build/torch_native/`` under the file lock; returns
    the library's path or raises ``OSError`` with the trail."""
    global build_seconds
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    log: list = []
    with open(BUILD_DIR / ".lock", "w") as lock_fh:
        fcntl.flock(lock_fh, fcntl.LOCK_EX)
        if _stamp_matches():  # another process built it while we waited
            return _lib_path()
        t0 = time.perf_counter()
        tc = probe_toolchain(log)
        missing = [what for what, ok in (
            ("a C++ compiler (g++)", tc["cxx"]),
            ("zlib.h", tc.get("z_header")),
            ("libz", _link_flag(tc, "z")),
            ("libzstd", _link_flag(tc, "zstd"))) if not ok]
        stage = pathlib.Path(tempfile.mkdtemp(dir=BUILD_DIR, prefix="stage-"))
        try:
            if missing:
                raise OSError("the toolchain lacks " + ", ".join(missing))
            built = _build_gxx(tc, stage, log)
            os.replace(built, _lib_path())
            tmp_stamp = stage / "stamp"
            tmp_stamp.write_text(_digest() + "\n")
            os.replace(tmp_stamp, _stamp_path())
        except (OSError, subprocess.SubprocessError) as exc:
            (BUILD_DIR / "build.log").write_text("\n".join(log))
            raise OSError(
                f"could not locate or build {_LIB_NAME}; searched: {tried}; "
                f"toolchain {tc}; build of src/native into {BUILD_DIR} "
                f"failed: {exc}\n" + "\n".join(log)[-8000:]) from exc
        finally:
            shutil.rmtree(stage, ignore_errors=True)
        (BUILD_DIR / "build.log").write_text(
            f"toolchain {tc}\n" + "\n".join(log))
        build_seconds = time.perf_counter() - t0
        return _lib_path()


def load_native() -> NativeLib:
    """The loaded library (memoized); builds it on first use."""
    global _loaded
    with _lock:
        if _loaded is not None:
            return _loaded
        tried = []
        for path in _candidate_paths():
            if path.exists():
                _loaded = NativeLib(ctypes.CDLL(str(path)), path)
                return _loaded
            tried.append(str(path))
        if _stamp_matches():
            path = _lib_path()
        else:
            tried.append(f"{_lib_path()} (absent or stale)")
            path = _build_native(tried)
        _loaded = NativeLib(ctypes.CDLL(str(path)), path)
        return _loaded


# ---------------------------------------------------------------------------
# the bridge library: the C ABI over runtime/bridge.py
# ---------------------------------------------------------------------------

RT_SRC_DIR = pathlib.Path(__file__).resolve().parent / "native_src"
RT_LIB_NAME = "libtpudf_rt.so"
RT_SELFTEST_NAME = "tpudf_rt_selftest"
BRIDGE_MODULE = "spark_rapids_jni_tpu_torch.runtime.bridge"
_rt_loaded: Optional[ctypes.CDLL] = None
rt_build_seconds: Optional[float] = None  # None: no build in this process


def python_embed() -> dict:
    """This interpreter's build facts the bridge needs: the include
    directory, whether it holds ``Python.h``, and the shared library
    (None where the interpreter has none)."""
    inc = sysconfig.get_paths()["include"]
    libdir = pathlib.Path(sysconfig.get_config_var("LIBDIR") or "")
    # the link name, else the soname alone (no -dev symlink installed)
    libs = [libdir / name for name in (
        sysconfig.get_config_var("LDLIBRARY"),
        sysconfig.get_config_var("INSTSONAME")) if name and ".so" in name]
    found = [lib for lib in libs if lib.exists()]
    return {"include": inc,
            "python_h": (pathlib.Path(inc) / "Python.h").exists(),
            "libpython": str(found[0]) if found else None}


def _rt_cmds(cxx: str, py: dict, out_dir: pathlib.Path) -> list:
    lib = out_dir / RT_LIB_NAME
    cmds = [[cxx, *_CXX_FLAGS, "-isystem", py["include"],
             f'-DTPUDF_RT_BRIDGE_MODULE="{BRIDGE_MODULE}"', "-shared",
             "-Wl,-soname," + RT_LIB_NAME,
             str(RT_SRC_DIR / "rt_bridge.cpp"), "-o", str(lib)]]
    if py["libpython"]:
        libdir = str(pathlib.Path(py["libpython"]).parent)
        cmds.append([cxx, *_CXX_FLAGS, str(RT_SRC_DIR / "rt_selftest.cpp"),
                     "-o", str(out_dir / RT_SELFTEST_NAME), str(lib),
                     "-L", libdir, "-l:" + pathlib.Path(py["libpython"]).name,
                     "-Wl,-rpath," + str(BUILD_DIR), "-Wl,-rpath," + libdir])
    return cmds


def _rt_digest(cmds: list) -> str:
    h = hashlib.sha256()
    for cmd in cmds:
        h.update("\0".join(cmd).encode() + b"\0")
    for name in ("rt_bridge.cpp", "rt_selftest.cpp"):
        h.update(name.encode() + b"\0" + (RT_SRC_DIR / name).read_bytes())
    return h.hexdigest()


def _rt_stamp() -> pathlib.Path:
    return BUILD_DIR / (RT_LIB_NAME + ".sha256")


def _build_rt() -> pathlib.Path:
    """Build (or find current) ``libtpudf_rt.so`` and, where libpython
    exists, the self test, under the build directory's lock."""
    global rt_build_seconds
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cxx = shutil.which("g++") or shutil.which("c++")
    py = python_embed()
    if cxx is None:
        raise OSError(f"building {RT_LIB_NAME} needs a C++ compiler (g++)")
    if not py["python_h"]:
        raise OSError(f"building {RT_LIB_NAME} needs Python.h, which is "
                      f"not in {py['include']} (this interpreter's "
                      "sysconfig include directory)")
    digest = _rt_digest(_rt_cmds(cxx, py, BUILD_DIR))
    lib = BUILD_DIR / RT_LIB_NAME
    with open(BUILD_DIR / ".lock", "w") as lock_fh:
        fcntl.flock(lock_fh, fcntl.LOCK_EX)
        try:
            if _rt_stamp().read_text().strip() == digest and lib.exists():
                return lib
        except OSError:
            pass
        t0 = time.perf_counter()
        log: list = [f"python {py}"]
        stage = pathlib.Path(tempfile.mkdtemp(dir=BUILD_DIR, prefix="stage-"))
        try:
            for cmd in _rt_cmds(cxx, py, stage):
                # the self test links the staged library; its rpath is
                # the build directory, where the library is renamed to
                if _run(cmd, log).returncode != 0:
                    raise OSError(f"building {RT_LIB_NAME} failed:\n"
                                  + "\n".join(log)[-8000:])
            for name in (RT_LIB_NAME, RT_SELFTEST_NAME):
                if (stage / name).exists():
                    os.replace(stage / name, BUILD_DIR / name)
            (stage / "stamp").write_text(digest + "\n")
            os.replace(stage / "stamp", _rt_stamp())
        finally:
            shutil.rmtree(stage, ignore_errors=True)
            (BUILD_DIR / "rt_build.log").write_text("\n".join(log))
        rt_build_seconds = time.perf_counter() - t0
        return lib


def load_rt_bridge() -> ctypes.CDLL:
    """The bridge library loaded into this process (memoized), built on
    first use, with the reference's ``tpudf_rt_*`` signatures pinned.
    ``tpudf_rt_init`` has not been called."""
    global _rt_loaded
    with _lock:
        if _rt_loaded is not None:
            return _rt_loaded
        lib = ctypes.CDLL(str(_build_rt()))
        i32, i64, vp, cp = (ctypes.c_int32, ctypes.c_int64, ctypes.c_void_p,
                            ctypes.c_char_p)
        p_i32, p_i64 = ctypes.POINTER(i32), ctypes.POINTER(i64)
        sigs = {
            "tpudf_rt_last_error": (cp, []),
            "tpudf_rt_init": (i32, [cp, cp]),
            "tpudf_rt_column_from_host": (i64, [i32, i32, i64, vp, i64, vp]),
            "tpudf_rt_table_create": (i64, [p_i64, i32]),
            "tpudf_rt_table_num_columns": (i32, [i64]),
            "tpudf_rt_table_num_rows": (i64, [i64]),
            "tpudf_rt_table_column": (i64, [i64, i32]),
            "tpudf_rt_column_info": (i32, [i64, p_i32, p_i32, p_i64]),
            "tpudf_rt_column_to_host": (i32, [i64, vp, i64, vp, i64]),
            "tpudf_rt_convert_to_rows": (i32, [i64, p_i64, i32, p_i32]),
            "tpudf_rt_convert_from_rows": (i64, [i64, p_i32, p_i32, i32]),
            "tpudf_rt_rows_info": (i32, [i64, p_i64, p_i64]),
            "tpudf_rt_rows_to_host": (i32, [i64, vp, i64]),
            "tpudf_rt_rows_from_host": (i64, [i64, i64, vp]),
            "tpudf_rt_free": (i32, [i64]),
        }
        for name, (restype, argtypes) in sigs.items():
            fn = getattr(lib, name)
            fn.restype, fn.argtypes = restype, argtypes
        _rt_loaded = lib
        return lib


def rt_selftest_path() -> Optional[pathlib.Path]:
    """The embedded-interpreter self test, built beside the bridge
    library; None where this interpreter has no shared libpython."""
    _build_rt()
    exe = BUILD_DIR / RT_SELFTEST_NAME
    return exe if python_embed()["libpython"] and exe.exists() else None
