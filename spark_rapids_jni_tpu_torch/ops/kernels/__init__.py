"""Hand-written Hopper kernels (counterpart of
``spark_rapids_jni_tpu/ops/pallas/``).

Each module here replaces one Pallas kernel of the JAX package:

- ``groupby_accumulate.py`` replaces ``ops/pallas/groupby_accumulate.py``
  (``accumulate``): the bounded-groupby per-(group, lane) reduction;
- ``q1.py`` replaces ``ops/pallas/q1.py`` (``_q1_partials_fn`` behind
  ``tpch_q1_pallas``): the whole of TPC-H q1 in one pass;
- ``row_transpose.py`` replaces ``ops/pallas/row_transpose.py``
  (``assemble_rows``): the column->row byte interleave;
- ``hash_probe.py`` replaces ``ops/pallas/hash_probe.py``
  (``probe_lo_hi``): the join probe's match-run bounds.

One more has no Pallas twin: ``segment_sum.py``, the general groupby's
float64 group sums in a fixed order, the counterpart of the reference's
XLA scan ``_segmented_sum_scan`` (``ops/groupby.py``).

The kernels are CUDA C++ under ``spark_rapids_jni_tpu_torch/csrc/``, built
for ``sm_90a`` by ``_build.py`` at first use and bound through a plain C
interface loaded with ``ctypes``.

Contract:

- every kernel registers here with its **oracle**, the plain PyTorch
  version of the same function in the same module;
- a wrapper given CUDA tensors launches its kernel or raises — there is
  no configuration switch and no ``try`` that falls back; given CPU
  tensors it runs the plain version (that is how the CPU tests run);
- an input the kernel does not take (reason names shared with the
  reference: ``float_agg``, ``minmax_width``; the port's kernels take
  what the reference refused as ``too_many_lanes`` and
  ``row_too_wide``) is counted through :func:`fall_back`, which never
  hides it; then a CUDA input raises ``NotImplementedError`` and a CPU
  input runs the plain version. An empty input is no such case: each
  kernel takes n == 0, and its wrapper returns the neutral output
  without a launch;
- each wrapper counts its launches (:func:`count_launch`), so a run can
  show that it went through the kernel.
"""

from __future__ import annotations

from collections import Counter
from typing import NamedTuple

__all__ = [
    "KernelSpec",
    "register_kernel",
    "registered",
    "fall_back",
    "fallbacks",
    "count_launch",
    "launches",
    "reset_counts",
]


class KernelSpec(NamedTuple):
    """One registered kernel: the op name its wrapper counts under, the
    dotted path of its plain PyTorch oracle, the CUDA source (relative to
    the package), the Pallas function it replaces, and a description."""

    name: str
    oracle: str
    source: str
    replaces: str
    doc: str


_registry: dict[str, KernelSpec] = {}
_launches: Counter = Counter()
_fallbacks: Counter = Counter()


def register_kernel(name: str, *, oracle: str, source: str, replaces: str,
                    doc: str = "") -> KernelSpec:
    """Register a kernel with its declared plain-PyTorch oracle."""
    if not oracle or not str(oracle).strip():
        raise ValueError(
            f"register_kernel({name!r}): every kernel must declare its "
            f"plain PyTorch oracle")
    spec = KernelSpec(str(name), str(oracle), str(source), str(replaces),
                      str(doc))
    _registry[spec.name] = spec
    return spec


def registered() -> dict[str, KernelSpec]:
    """Snapshot of registered kernels (name -> spec)."""
    return dict(_registry)


def fall_back(op: str, reason: str) -> None:
    """``op`` cannot run its kernel on this input: the reason is counted,
    then the caller raises for a CUDA input or runs the plain version for
    a CPU one."""
    _fallbacks[(op, reason)] += 1


def fallbacks() -> dict[tuple[str, str], int]:
    """``{(op, reason): count}`` since the last :func:`reset_counts`."""
    return dict(_fallbacks)


def count_launch(op: str) -> None:
    """Called by a wrapper right where it launches its kernel."""
    _launches[op] += 1


def launches(op: str | None = None):
    """Launch count of ``op``, or ``{op: count}`` for all ops."""
    if op is None:
        return dict(_launches)
    return _launches[op]


def reset_counts() -> None:
    """Zero every launch and fallback count."""
    _launches.clear()
    _fallbacks.clear()


# kernel modules register on import; q1 (which pulls in the TPC-H model
# constants) registers when ops.kernels.q1 loads, as in the reference
from spark_rapids_jni_tpu_torch.ops.kernels import (  # noqa: E402
    groupby_accumulate as groupby_accumulate,
    hash_probe as hash_probe,
    row_transpose as row_transpose,
    segment_sum as segment_sum,
)
