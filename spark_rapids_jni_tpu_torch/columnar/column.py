"""Device-resident column (counterpart of
``spark_rapids_jni_tpu/columnar/column.py``).

A fixed-width column is (data: tensor[n], validity: bool tensor[n] |
None); a DECIMAL128 column stores int64[n, 2] limb pairs. String, list
and struct layouts are not ported yet.

``validity is None`` means "no null mask allocated — all rows valid",
the tri-state cuDF uses (null_mask() == nullptr). Null slots in ``data``
hold unspecified values; comparisons and host materialization always
consult validity.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from spark_rapids_jni_tpu_torch.types import DType, TypeId
from spark_rapids_jni_tpu_torch.utils.platform import resolve_device


# torch has no gather kernels for these unsigned types on every device;
# equality only needs their bits, so they compare as signed views
_SIGNED_VIEW = {torch.uint16: torch.int16, torch.uint32: torch.int32,
                torch.uint64: torch.int64}


def _indexable(x: torch.Tensor) -> torch.Tensor:
    view = _SIGNED_VIEW.get(x.dtype)
    return x if view is None else x.view(view)


@dataclass
class Column:
    dtype: DType
    data: torch.Tensor
    validity: Optional[torch.Tensor] = None  # bool[n], True = valid

    def __post_init__(self) -> None:
        if self.validity is not None:
            if self.validity.dtype != torch.bool:
                raise TypeError("validity must be bool")
            if self.validity.device != self.data.device:
                raise ValueError("validity must live on the data's device")
        if self.dtype.is_decimal128:
            if self.data.dtype != torch.int64 or self.data.ndim != 2 \
                    or self.data.shape[-1] != 2:
                raise TypeError(
                    "DECIMAL128 columns store int64[n, 2] limb pairs "
                    "(lo, hi little-endian)"
                )
        elif self.dtype.is_fixed_width:
            expect = self.dtype.torch_dtype
            if self.data.dtype != expect:
                raise TypeError(
                    f"column data dtype {self.data.dtype} != storage dtype "
                    f"{expect} for {self.dtype}"
                )
        else:
            raise NotImplementedError(
                f"{self.dtype} columns are not ported yet (fixed-width and "
                "DECIMAL128 only)")

    @property
    def size(self) -> int:
        return int(self.data.shape[0])

    @property
    def device(self) -> torch.device:
        return self.data.device

    @property
    def null_count(self) -> int:
        if self.validity is None:
            return 0
        return int(self.size - int(self.validity.sum()))

    @property
    def has_nulls(self) -> bool:
        return self.null_count > 0

    def valid_mask(self) -> torch.Tensor:
        """Validity as a concrete bool[n] (materializes all-true if absent)."""
        if self.validity is not None:
            return self.validity
        return torch.ones((self.size,), dtype=torch.bool, device=self.device)

    # ---- host interop -------------------------------------------------

    @classmethod
    def from_numpy(
        cls,
        values: np.ndarray,
        dtype: Optional[DType] = None,
        validity: Optional[np.ndarray] = None,
        device=None,
    ) -> "Column":
        """Host arrays -> column on ``device`` (None: the CUDA device)."""
        device = resolve_device(device)
        values = np.asarray(values)
        if dtype is None:
            dtype = DType.from_numpy(values.dtype)
        store = np.int64 if dtype.is_decimal128 else dtype.storage_dtype
        # fresh host copies: the column never aliases the caller's arrays
        data = torch.from_numpy(values.astype(store)).to(device)
        vmask = None if validity is None else torch.from_numpy(
            np.asarray(validity).astype(bool)).to(device)
        return cls(dtype, data, vmask)

    @classmethod
    def from_pylist(cls, values: Sequence, dtype: DType,
                    device=None) -> "Column":
        """Build from a python list where ``None`` marks nulls."""
        valid = np.array([v is not None for v in values], dtype=bool)
        vmask = None if valid.all() else valid
        if dtype.is_decimal128:
            limbs = np.zeros((len(values), 2), dtype=np.int64)
            for i, v in enumerate(values):
                if v is None:
                    continue
                limbs[i, 0] = np.int64(np.uint64(int(v) & 0xFFFFFFFFFFFFFFFF))
                limbs[i, 1] = int(v) >> 64
            return cls.from_numpy(limbs, dtype, vmask, device)
        filled = np.zeros(len(values), dtype=dtype.storage_dtype)
        for i, v in enumerate(values):
            if v is None:
                continue
            if dtype.type_id == TypeId.BOOL8:
                filled[i] = 1 if v else 0
            else:
                filled[i] = v
        return cls.from_numpy(filled, dtype, vmask, device)

    def to_numpy(self) -> tuple[np.ndarray, Optional[np.ndarray]]:
        """Return (data, validity) as host arrays; validity None = all valid."""
        data = self.data.cpu().numpy()
        mask = None if self.validity is None else self.validity.cpu().numpy()
        return data, mask

    def to_pylist(self) -> list:
        data, mask = self.to_numpy()
        out = []
        for i in range(self.size):
            if mask is not None and not mask[i]:
                out.append(None)
            elif self.dtype.type_id == TypeId.BOOL8:
                out.append(bool(data[i]))
            elif self.dtype.is_decimal128:
                lo = int(np.uint64(data[i, 0]))
                out.append((int(data[i, 1]) << 64) | lo)
            else:
                out.append(data[i].item())
        return out

    # ---- comparison (test oracle) -------------------------------------

    def equals(self, other: "Column") -> bool:
        """Null-aware equality: same type, size and validity, and equal
        data under validity (NaN equals NaN for floats)."""
        if self.dtype != other.dtype or self.size != other.size:
            return False
        a_valid = self.valid_mask()
        b_valid = other.valid_mask().to(a_valid.device)
        if not torch.equal(a_valid, b_valid):
            return False
        a = _indexable(self.data)[a_valid]
        b = _indexable(other.data.to(self.data.device))[a_valid]
        if a.is_floating_point():
            both_nan = torch.isnan(a) & torch.isnan(b)
            return bool(((a == b) | both_nan).all())
        return torch.equal(a, b)

    def __repr__(self) -> str:
        return (f"Column({self.dtype}, size={self.size}, "
                f"device={self.device})")
