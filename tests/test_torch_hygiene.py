"""Boundaries of the PyTorch port: it imports neither JAX nor the JAX
package, its entry points refuse to run quietly on the CPU, every kernel
declares its plain oracle and a CUDA source, and a CPU tensor takes the
plain path without counting a launch."""

from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from spark_rapids_jni_tpu_torch.models import tpcds, tpch
from spark_rapids_jni_tpu_torch.ops import kernels
from spark_rapids_jni_tpu_torch.ops.kernels import (
    groupby_accumulate as kga,
    hash_probe as khp,
    q1 as kq1,
    row_transpose as krt,
)

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "spark_rapids_jni_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "spark_rapids_jni_tpu")


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            yield node.module


SCRIPTS = [ROOT / "chip_smoke.py", ROOT / "chip_smoke_writers.py"]


@pytest.mark.parametrize(
    "path", sorted(PKG.rglob("*.py")) + SCRIPTS,
    ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in FORBIDDEN, f"{path.name} imports {mod}"


def test_import_leaves_jax_unloaded():
    code = ("import sys, spark_rapids_jni_tpu_torch.models.tpch, "
            "spark_rapids_jni_tpu_torch.models.tpcds, "
            "spark_rapids_jni_tpu_torch.ops.kernels.q1, "
            "spark_rapids_jni_tpu_torch.ops.row_conversion, "
            "spark_rapids_jni_tpu_torch.ops.join, "
            "spark_rapids_jni_tpu_torch.ops.cast_strings, "
            "spark_rapids_jni_tpu_torch.ops.hash, "
            "spark_rapids_jni_tpu_torch.ops.bloom_filter, "
            "spark_rapids_jni_tpu_torch.ops.datetime, "
            "spark_rapids_jni_tpu_torch.ops.regex_device, "
            "spark_rapids_jni_tpu_torch.ops.json_device, "
            "spark_rapids_jni_tpu_torch.ops.get_json_object, "
            "spark_rapids_jni_tpu_torch.ops.unicode_case_device, "
            "spark_rapids_jni_tpu_torch.ops.regex_capture_device, "
            "spark_rapids_jni_tpu_torch.ops.strings_fns, "
            "spark_rapids_jni_tpu_torch.ops.table_ops, "
            "spark_rapids_jni_tpu_torch.ops.reduce, "
            "spark_rapids_jni_tpu_torch.models.bench_strings, "
            "spark_rapids_jni_tpu_torch.utils.config, "
            "spark_rapids_jni_tpu_torch.columnar.arrow, "
            "spark_rapids_jni_tpu_torch.telemetry, "
            "spark_rapids_jni_tpu_torch.profile_paths, "
            "spark_rapids_jni_tpu_torch.interop, "
            "spark_rapids_jni_tpu_torch.parquet, "
            "spark_rapids_jni_tpu_torch.parquet.nested, "
            "spark_rapids_jni_tpu_torch.orc, "
            "spark_rapids_jni_tpu_torch.runtime.native, "
            "spark_rapids_jni_tpu_torch.runtime.memory, "
            "spark_rapids_jni_tpu_torch.runtime.faults, "
            "spark_rapids_jni_tpu_torch.runtime.integrity, "
            "spark_rapids_jni_tpu_torch.utils.fspath, "
            "spark_rapids_jni_tpu_torch.utils.tracing, "
            "spark_rapids_jni_tpu_torch.ops.planner, "
            "spark_rapids_jni_tpu_torch.runtime.dispatch, "
            "spark_rapids_jni_tpu_torch.runtime.fusion, "
            "spark_rapids_jni_tpu_torch.runtime.bridge, "
            "spark_rapids_jni_tpu_torch.ops.elementwise, "
            "spark_rapids_jni_tpu_torch.ops.lists, "
            "spark_rapids_jni_tpu_torch.ops.structs, "
            "spark_rapids_jni_tpu_torch.ops.window, "
            "spark_rapids_jni_tpu_torch.runtime.resilience, "
            "spark_rapids_jni_tpu_torch.runtime.compress, "
            "spark_rapids_jni_tpu_torch.runtime.outofcore, "
            "spark_rapids_jni_tpu_torch.runtime.pipeline, "
            "spark_rapids_jni_tpu_torch.runtime.degrade, "
            "spark_rapids_jni_tpu_torch.parallel, "
            "spark_rapids_jni_tpu_torch.parallel.mesh, "
            "spark_rapids_jni_tpu_torch.parallel.wire, "
            "spark_rapids_jni_tpu_torch.parallel.shuffle, "
            "spark_rapids_jni_tpu_torch.parallel.distributed, "
            "spark_rapids_jni_tpu_torch.parallel.sort, "
            "spark_rapids_jni_tpu_torch.errors, "
            "chip_smoke_writers; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'spark_rapids_jni_tpu', 'pyarrow')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


# the modules whose functions may import pyarrow: the Arrow interchange,
# and the ORC reader's wall-clock -> UTC conversion (the tz database)
PYARROW_USERS = {"columnar/arrow.py", "orc/reader.py"}


NATIVE_SRC = PKG / "runtime" / "native_src"


@pytest.mark.parametrize("path", sorted(NATIVE_SRC.glob("*.cpp")),
                         ids=lambda p: p.name)
def test_bridge_sources_name_no_jax_module(path):
    # the bridge's C++ twin names the port's module once, as the default
    # of TPUDF_RT_BRIDGE_MODULE, and never JAX or the JAX package
    text = path.read_text()
    assert "jax" not in text.lower(), path.name
    assert "spark_rapids_jni_tpu." not in text, path.name
    port = text.count("spark_rapids_jni_tpu_torch")
    if path.name == "rt_bridge.cpp":
        assert port == 1
        assert '#define TPUDF_RT_BRIDGE_MODULE ' \
            '"spark_rapids_jni_tpu_torch.runtime.bridge"' in text
        assert "PyImport_ImportModule(TPUDF_RT_BRIDGE_MODULE)" in text
    else:
        assert port == 0


def test_pyarrow_is_imported_only_inside_the_arrow_functions():
    # no module of the port may need pyarrow to import, and only the
    # functions of PYARROW_USERS use it
    for path in sorted(PKG.rglob("*.py")) + SCRIPTS:
        tree = ast.parse(path.read_text(), filename=str(path))
        top = [n for n in tree.body
               if isinstance(n, (ast.Import, ast.ImportFrom))]
        names = {m.split(".")[0] for m in _imported_modules(path)}
        top_names = {a.name.split(".")[0] for n in top
                     if isinstance(n, ast.Import) for a in n.names} | {
            n.module.split(".")[0] for n in top
            if isinstance(n, ast.ImportFrom) and n.module}
        assert "pyarrow" not in top_names, path.name
        rel = path.relative_to(PKG).as_posix() \
            if path.is_relative_to(PKG) else path.name
        if rel not in PYARROW_USERS:
            assert "pyarrow" not in names, path.name


def test_entry_point_refuses_quiet_cpu_fallback():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None selects it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpch.lineitem_table(8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpcds.store_sales_table(8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpch.lineitem_q19_table(8, 4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpch.lineitem_table_strings(8)
    from spark_rapids_jni_tpu_torch.ops.bloom_filter import BloomFilter
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BloomFilter.empty(64)
    from spark_rapids_jni_tpu_torch import types as t
    from spark_rapids_jni_tpu_torch.ops.lists import make_list_column
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_list_column([[1], None], t.INT64)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpch.tpch_q1_outofcore("lineitem.parquet", budget_bytes=1 << 20,
                               chunk_read_limit=1)


def test_registered_kernels_declare_oracle_and_source():
    specs = kernels.registered()
    # every Pallas kernel of the reference has its counterpart
    assert set(specs) == {kga.NAME, kq1.NAME, krt.NAME, khp.NAME}
    for spec in specs.values():
        module, _, fn = spec.oracle.rpartition(".")
        assert callable(getattr(sys.modules[module], fn)), spec.oracle
        src = PKG / spec.source
        assert src.suffix == ".cu" and src.exists(), spec.source
        assert "spark_rapids_jni_tpu/ops/pallas/" in spec.replaces
        assert Path(spec.replaces.split(":")[0]).name in src.read_text()


def test_cpu_wrappers_take_the_plain_path():
    li = tpch.lineitem_table(300, device="cpu")
    kernels.reset_counts()
    tpch.tpch_q1_planned(li)
    kq1.tpch_q1_pallas(li)
    from spark_rapids_jni_tpu_torch.ops.row_conversion import convert_to_rows
    convert_to_rows(li)
    tpch.tpch_q3(tpch.customer_table(20, device="cpu"),
                 tpch.orders_table(200, 20, device="cpu"),
                 tpch.lineitem_q3_table(300, 200, device="cpu"))
    tpcds.tpcds_q72(tpcds.catalog_sales_table(300, 20, device="cpu"),
                    tpcds.date_dim_table(device="cpu"),
                    tpcds.item_table(20, device="cpu"),
                    tpcds.inventory_table(20, device="cpu"))
    tpcds.tpcds_q64(tpcds.store_sales_table(300, 20, 30, device="cpu"))
    assert kernels.launches() == {}
    assert kernels.fallbacks() == {}


def test_register_kernel_requires_an_oracle():
    with pytest.raises(ValueError, match="oracle"):
        kernels.register_kernel("x", oracle=" ", source="csrc/x.cu",
                                replaces="y")


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    import torch.utils.cpp_extension as cpp_ext

    from spark_rapids_jni_tpu_torch.ops.kernels import _build

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "torch_kernels")
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(cpp_ext, "CUDA_HOME", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.library()


def test_build_failure_raises_with_nvcc_output(monkeypatch, tmp_path):
    from spark_rapids_jni_tpu_torch.ops.kernels import _build

    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho \"error: no sm_90a here\"\nexit 2\n")
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "torch_kernels")
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build.shutil, "which", lambda name: str(fake))
    with pytest.raises(RuntimeError, match="no sm_90a here") as err:
        _build.library()
    # every source was compiled, each by its own nvcc process
    for src in _build.sources():
        assert src.name in str(err.value)
    assert not (tmp_path / "torch_kernels" / _build.LIB_NAME).exists()


def test_native_library_builds_in_its_own_directory():
    """The readers' library loads from build/torch_native/ (built there
    when absent), never from the JAX package's build/native/, and the
    port's loader imports nothing of the JAX package."""
    code = ("import sys; from spark_rapids_jni_tpu_torch.runtime import "
            "native; lib = native.load_native(); "
            "print(lib.path); bad = [m for m in sys.modules if "
            "m.split('.')[0] in ('jax', 'spark_rapids_jni_tpu')]; "
            "sys.exit(1 if bad else 0)")
    env = {k: v for k, v in __import__("os").environ.items()
           if k != "SPARK_RAPIDS_TPU_NATIVE_LIB"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert Path(proc.stdout.strip()) == \
        ROOT / "build" / "torch_native" / "libtpudf.so"


def test_native_build_without_a_compiler_raises_with_the_trail(
        monkeypatch, tmp_path):
    from spark_rapids_jni_tpu_torch.runtime import native

    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "torch_native")
    monkeypatch.setattr(native, "_loaded", None)
    monkeypatch.delenv("SPARK_RAPIDS_TPU_NATIVE_LIB", raising=False)
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    with pytest.raises(OSError, match="searched") as err:
        native.load_native()
    assert "a C++ compiler" in str(err.value)
    assert not (tmp_path / "torch_native" / "libtpudf.so").exists()


def test_gxx_route_with_declared_zstd_builds_a_working_library(tmp_path):
    """The route of a machine with zstd's runtime library but neither its
    header nor its link name: one g++ a source, the port's declaration
    header, the runtime library by soname. The library decodes a ZSTD
    page."""
    import ctypes

    from spark_rapids_jni_tpu_torch.runtime import native

    log: list = []
    native.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tc = native.probe_toolchain(log)
    if not (tc["cxx"] and tc.get("zstd_soname") and tc.get("z_header")):
        pytest.skip("no C++ compiler, zlib.h or zstd runtime library")
    tc.update(zstd_header=False, zstd_link=False)
    lib_path = native._build_gxx(tc, tmp_path, log)
    assert any("native_include" in entry for entry in log)
    # one compile a source, with the flags of CMakeLists.txt's Release build
    compiles = [entry for entry in log if " -c " in entry]
    assert len(compiles) == len(native.SOURCES)
    assert all("-O3 -DNDEBUG" in entry for entry in compiles)
    assert any("-l:" in entry for entry in log)
    lib = native.NativeLib(ctypes.CDLL(str(lib_path)), lib_path)
    pq = pytest.importorskip("pyarrow.parquet")
    import io

    import pyarrow as pa

    buf = io.BytesIO()
    pq.write_table(pa.table({"a": list(range(1000))}), buf,
                   compression="zstd")
    data = buf.getvalue()
    handle = lib.tpudf_parquet_read(data, len(data), None, 0, None, 0)
    assert handle != 0, lib.last_error()
    assert lib.tpudf_read_num_rows(handle) == 1000
    lib.tpudf_read_close(handle)
