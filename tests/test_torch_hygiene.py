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


@pytest.mark.parametrize(
    "path", sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"],
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
            "spark_rapids_jni_tpu_torch.interop; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'spark_rapids_jni_tpu', 'pyarrow')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_pyarrow_is_imported_only_inside_the_arrow_functions():
    # the card's machine has no pyarrow: no module of the port may need
    # it to import, and only columnar/arrow.py's functions use it
    for path in sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]:
        tree = ast.parse(path.read_text(), filename=str(path))
        top = [n for n in tree.body
               if isinstance(n, (ast.Import, ast.ImportFrom))]
        names = {m.split(".")[0] for m in _imported_modules(path)}
        top_names = {a.name.split(".")[0] for n in top
                     if isinstance(n, ast.Import) for a in n.names} | {
            n.module.split(".")[0] for n in top
            if isinstance(n, ast.ImportFrom) and n.module}
        assert "pyarrow" not in top_names, path.name
        if path.name != "arrow.py":
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
