"""Build and load the CUDA kernels at first use.

Every ``csrc/*.cu`` of the package is compiled for ``sm_90a`` by its own
``nvcc`` process (all started together), then linked into one shared
library with a plain C interface::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \\
         -Xcompiler -fPIC -Xptxas -v -c csrc/<name>.cu -o <name>.o
    nvcc -gencode arch=compute_90a,code=sm_90a -shared -o \\
         build/torch_kernels/libsrjt_kernels.so *.o

The library lands in ``build/torch_kernels/`` beside the package, next to
``build.log`` (nvcc's output, the ``-Xptxas -v`` register and shared
memory report included) and a stamp holding the SHA-256 of the sources
and flags; a matching stamp skips the build. Only sources in the package
are used. A failed build raises with nvcc's output: there is no degraded
mode.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
LIB_NAME = "libsrjt_kernels.so"
_ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
_COMPILE_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
_TIMEOUT_S = 600

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_functions: dict[str, ctypes._CFuncPtr] = {}
build_seconds: float | None = None  # None: loaded from a matching stamp


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest(srcs: list[Path]) -> str:
    h = hashlib.sha256()
    for flag in _ARCH + _COMPILE_FLAGS:
        h.update(flag.encode() + b"\0")
    for src in srcs:
        h.update(src.name.encode() + b"\0" + src.read_bytes() + b"\0")
    return h.hexdigest()


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    found = shutil.which("nvcc")
    if found:
        return found
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError(
        "nvcc not found (neither on PATH nor under CUDA_HOME): the CUDA "
        "kernels cannot be built")


def _build(srcs: list[Path], lib_path: Path) -> None:
    global build_seconds
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for src in srcs:
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *_ARCH, *_COMPILE_FLAGS, "-c", str(src), "-o",
                   str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs, failed = [], []
        for src, _, proc in procs:
            try:
                output, _ = proc.communicate(timeout=_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                proc.kill()
                output, _ = proc.communicate()
                output += f"\n(nvcc timed out after {_TIMEOUT_S} s)"
            logs.append(f"== {src.name}\n{output}")
            if proc.returncode != 0:
                failed.append(src.name)
        build_log = "\n".join(logs)
        if failed:
            raise RuntimeError(
                f"nvcc failed on {', '.join(failed)}:\n{build_log}")
        tmp_lib = Path(tmp) / LIB_NAME
        link = subprocess.run(
            [nvcc, *_ARCH, "-shared", "-o", str(tmp_lib),
             *[str(obj) for _, obj, _ in procs]],
            capture_output=True, text=True, timeout=_TIMEOUT_S)
        build_log += f"\n== link\n{link.stdout}{link.stderr}"
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{build_log}")
        os.replace(tmp_lib, lib_path)  # atomic: concurrent builds agree
    build_seconds = time.perf_counter() - t0
    (BUILD_DIR / "build.log").write_text(build_log)


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if the stamp is stale."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        srcs = sources()
        if not srcs:
            raise RuntimeError(f"no CUDA sources under {CSRC}")
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        lib_path = BUILD_DIR / LIB_NAME
        stamp = BUILD_DIR / (LIB_NAME + ".sha256")
        digest = _digest(srcs)
        fresh = (lib_path.exists() and stamp.exists()
                 and stamp.read_text().strip() == digest)
        if not fresh:
            _build(srcs, lib_path)
            stamp.write_text(digest + "\n")
        lib = ctypes.CDLL(str(lib_path))
        lib.srjt_error_string.argtypes = [ctypes.c_int]
        lib.srjt_error_string.restype = ctypes.c_char_p
        _lib = lib
        return lib


def function(name: str, argtypes: list,
             restype=ctypes.c_int) -> ctypes._CFuncPtr:
    """Entry point ``name`` of the library, with its argument types set
    (``c_void_p`` for every pointer and the stream) and its result type
    (an int status unless the caller says otherwise)."""
    fn = _functions.get(name)
    if fn is None:
        fn = getattr(library(), name)
        fn.argtypes = argtypes
        fn.restype = restype
        _functions[name] = fn
    return fn


def check(status: int, what: str) -> None:
    """Raise if a launch returned a CUDA error status."""
    if status != 0:
        text = library().srjt_error_string(status).decode()
        raise RuntimeError(f"{what} failed: CUDA error {status} ({text})")


def stream_handle(device) -> ctypes.c_void_p:
    """PyTorch's current stream on ``device`` as a C pointer."""
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count
