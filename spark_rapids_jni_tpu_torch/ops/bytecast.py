"""Byte views of fixed-width device tensors (counterpart of
``spark_rapids_jni_tpu/ops/bytecast.py``).

The packed-row format needs the little-endian byte image of every
fixed-width type. ``Tensor.view(torch.uint8)`` gives it directly for
every width on CUDA and the CPU, so the reference's 32-bit-word and
arithmetic IEEE-754 workarounds for a backend without 64-bit bitcasts
have no counterpart here.

DECIMAL128 input is the int64[n, 2] limb pair (lo, hi): its byte image is
the 16-byte little-endian two's-complement integer, lo limb bytes then hi
limb bytes — the ``__int128_t`` layout of the reference's row format.
"""

from __future__ import annotations

import torch

from spark_rapids_jni_tpu_torch.types import DType


def to_bytes(data: torch.Tensor, dtype: DType) -> torch.Tensor:
    """(n,) fixed-width tensor (int64[n, 2] for DECIMAL128) -> (n, size)
    little-endian uint8 bytes. A view where ``data`` is contiguous."""
    n = data.shape[0]
    if n == 0:  # an empty tensor may carry strides a byte view refuses
        return torch.empty((0, dtype.size_bytes), dtype=torch.uint8,
                           device=data.device)
    return data.contiguous().view(torch.uint8).reshape(n, dtype.size_bytes)


def from_bytes(b: torch.Tensor, dtype: DType) -> torch.Tensor:
    """(n, size) little-endian uint8 bytes -> (n,) of the storage dtype
    (int64[n, 2] limb pairs for DECIMAL128)."""
    n = b.shape[0]
    if n == 0:
        shape = (0, 2) if dtype.is_decimal128 else (0,)
        return torch.empty(shape, dtype=dtype.torch_dtype, device=b.device)
    out = b.contiguous().view(dtype.torch_dtype)
    if dtype.is_decimal128:
        return out.reshape(n, 2)
    return out.reshape(n)
