"""The join probe seam (counterpart of ``probe_sorted_lo_hi`` in
``spark_rapids_jni_tpu/ops/hash.py``). The Spark-exact row hashes
(``table_xxhash64``, ``partition_hash``) are not ported yet (ROADMAP.md
Queue 1 item 7)."""

from __future__ import annotations

import torch

from spark_rapids_jni_tpu_torch.ops.kernels import hash_probe


def probe_sorted_lo_hi(sorted_key: torch.Tensor, probe_key: torch.Tensor):
    """Per probe key, the [lo, hi) match-run bounds (int64) in the
    sentinel-padded sorted build keys: the ``join.hash_probe`` kernel for
    CUDA tensors, its plain version for CPU ones. Unlike the reference's
    Pallas tier there is no build-size or key-width fallback."""
    return hash_probe.probe_lo_hi(sorted_key, probe_key)
