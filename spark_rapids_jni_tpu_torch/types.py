"""Spark/cuDF-compatible column type system (counterpart of
``spark_rapids_jni_tpu/types.py``).

Type ids follow the cuDF ``type_id`` enum order, so the ``(type id,
scale)`` pairs the reference marshals across JNI round-trip unchanged.
Decimals are stored as their integer backing type plus a ``scale``
(value = unscaled * 10**scale). DECIMAL128 is stored as int64[n, 2] limb
pairs (lo, hi; little-endian limb order), the same layout as the JAX
package, so row images and interop arrays agree byte for byte.

Every storage dtype is given both as a numpy dtype (host arrays, data
generators) and as a torch dtype (device tensors).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass

import numpy as np
import torch


class TypeId(enum.IntEnum):
    """Native type ids (cuDF type_id enum order, branch-22.06 era)."""

    EMPTY = 0
    INT8 = 1
    INT16 = 2
    INT32 = 3
    INT64 = 4
    UINT8 = 5
    UINT16 = 6
    UINT32 = 7
    UINT64 = 8
    FLOAT32 = 9
    FLOAT64 = 10
    BOOL8 = 11
    TIMESTAMP_DAYS = 12
    TIMESTAMP_SECONDS = 13
    TIMESTAMP_MILLISECONDS = 14
    TIMESTAMP_MICROSECONDS = 15
    TIMESTAMP_NANOSECONDS = 16
    DURATION_DAYS = 17
    DURATION_SECONDS = 18
    DURATION_MILLISECONDS = 19
    DURATION_MICROSECONDS = 20
    DURATION_NANOSECONDS = 21
    DICTIONARY32 = 22
    STRING = 23
    LIST = 24
    DECIMAL32 = 25
    DECIMAL64 = 26
    DECIMAL128 = 27
    STRUCT = 28


# Storage dtype (numpy) for each fixed-width type id.
_STORAGE: dict[TypeId, np.dtype] = {
    TypeId.INT8: np.dtype(np.int8),
    TypeId.INT16: np.dtype(np.int16),
    TypeId.INT32: np.dtype(np.int32),
    TypeId.INT64: np.dtype(np.int64),
    TypeId.UINT8: np.dtype(np.uint8),
    TypeId.UINT16: np.dtype(np.uint16),
    TypeId.UINT32: np.dtype(np.uint32),
    TypeId.UINT64: np.dtype(np.uint64),
    TypeId.FLOAT32: np.dtype(np.float32),
    TypeId.FLOAT64: np.dtype(np.float64),
    TypeId.BOOL8: np.dtype(np.uint8),
    TypeId.TIMESTAMP_DAYS: np.dtype(np.int32),
    TypeId.TIMESTAMP_SECONDS: np.dtype(np.int64),
    TypeId.TIMESTAMP_MILLISECONDS: np.dtype(np.int64),
    TypeId.TIMESTAMP_MICROSECONDS: np.dtype(np.int64),
    TypeId.TIMESTAMP_NANOSECONDS: np.dtype(np.int64),
    TypeId.DURATION_DAYS: np.dtype(np.int32),
    TypeId.DURATION_SECONDS: np.dtype(np.int64),
    TypeId.DURATION_MILLISECONDS: np.dtype(np.int64),
    TypeId.DURATION_MICROSECONDS: np.dtype(np.int64),
    TypeId.DURATION_NANOSECONDS: np.dtype(np.int64),
    TypeId.DECIMAL32: np.dtype(np.int32),
    TypeId.DECIMAL64: np.dtype(np.int64),
}

_FROM_NUMPY: dict[np.dtype, TypeId] = {
    np.dtype(np.int8): TypeId.INT8,
    np.dtype(np.int16): TypeId.INT16,
    np.dtype(np.int32): TypeId.INT32,
    np.dtype(np.int64): TypeId.INT64,
    np.dtype(np.uint8): TypeId.UINT8,
    np.dtype(np.uint16): TypeId.UINT16,
    np.dtype(np.uint32): TypeId.UINT32,
    np.dtype(np.uint64): TypeId.UINT64,
    np.dtype(np.float32): TypeId.FLOAT32,
    np.dtype(np.float64): TypeId.FLOAT64,
    np.dtype(np.bool_): TypeId.BOOL8,
}

# numpy storage dtype -> torch dtype (torch is natively 64-bit: no x64
# switch is needed for int64/float64 columns)
_TORCH: dict[np.dtype, torch.dtype] = {
    np.dtype(np.int8): torch.int8,
    np.dtype(np.int16): torch.int16,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64,
    np.dtype(np.uint8): torch.uint8,
    np.dtype(np.uint16): torch.uint16,
    np.dtype(np.uint32): torch.uint32,
    np.dtype(np.uint64): torch.uint64,
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
    np.dtype(np.bool_): torch.bool,
}


@dataclass(frozen=True)
class DType:
    """A column data type: native type id + decimal scale (cuDF
    convention: value = unscaled * 10**scale, so scale is usually
    negative)."""

    type_id: TypeId
    scale: int = 0

    def __post_init__(self) -> None:
        if self.scale != 0 and self.type_id not in (
            TypeId.DECIMAL32,
            TypeId.DECIMAL64,
            TypeId.DECIMAL128,
        ):
            raise ValueError(f"scale only valid for decimal types, got {self.type_id}")

    @property
    def is_fixed_width(self) -> bool:
        return self.type_id in _STORAGE

    @property
    def is_decimal(self) -> bool:
        return self.type_id in (TypeId.DECIMAL32, TypeId.DECIMAL64, TypeId.DECIMAL128)

    @property
    def is_string(self) -> bool:
        return self.type_id == TypeId.STRING

    @property
    def is_list(self) -> bool:
        return self.type_id == TypeId.LIST

    @property
    def is_decimal128(self) -> bool:
        """128-bit decimal: stored as int64[n, 2] limb pairs (lo unsigned,
        hi signed, little-endian limb order)."""
        return self.type_id == TypeId.DECIMAL128

    @property
    def storage_dtype(self) -> np.dtype:
        """Physical element dtype (numpy) backing this type. DECIMAL128
        has none: its storage is the int64[n, 2] limb pair."""
        try:
            return _STORAGE[self.type_id]
        except KeyError:
            raise TypeError(f"{self.type_id.name} is not fixed-width") from None

    @property
    def torch_dtype(self) -> torch.dtype:
        """Physical element dtype (torch) backing this type on device
        (int64 for the DECIMAL128 limb pairs)."""
        if self.is_decimal128:
            return torch.int64
        return _TORCH[self.storage_dtype]

    @property
    def size_bytes(self) -> int:
        """Fixed-width element size; also its alignment in a packed row.
        DECIMAL128 is 16 (sizeof(__int128_t))."""
        if self.is_decimal128:
            return 16
        return self.storage_dtype.itemsize

    @classmethod
    def from_numpy(cls, dt: np.dtype) -> "DType":
        try:
            return cls(_FROM_NUMPY[np.dtype(dt)])
        except KeyError:
            raise TypeError(f"no column type for numpy dtype {dt}") from None

    def __repr__(self) -> str:
        if self.is_decimal:
            return f"DType({self.type_id.name}, scale={self.scale})"
        return f"DType({self.type_id.name})"


# Convenience singletons mirroring ai.rapids.cudf.DType statics.
INT8 = DType(TypeId.INT8)
INT16 = DType(TypeId.INT16)
INT32 = DType(TypeId.INT32)
INT64 = DType(TypeId.INT64)
UINT8 = DType(TypeId.UINT8)
UINT16 = DType(TypeId.UINT16)
UINT32 = DType(TypeId.UINT32)
UINT64 = DType(TypeId.UINT64)
FLOAT32 = DType(TypeId.FLOAT32)
FLOAT64 = DType(TypeId.FLOAT64)
BOOL8 = DType(TypeId.BOOL8)
TIMESTAMP_DAYS = DType(TypeId.TIMESTAMP_DAYS)
TIMESTAMP_MICROSECONDS = DType(TypeId.TIMESTAMP_MICROSECONDS)
DURATION_DAYS = DType(TypeId.DURATION_DAYS)
STRING = DType(TypeId.STRING)
LIST = DType(TypeId.LIST)


def decimal32(scale: int) -> DType:
    return DType(TypeId.DECIMAL32, scale)


def decimal64(scale: int) -> DType:
    return DType(TypeId.DECIMAL64, scale)


def decimal128(scale: int) -> DType:
    return DType(TypeId.DECIMAL128, scale)
