"""Device-resident column (counterpart of
``spark_rapids_jni_tpu/columnar/column.py``).

A fixed-width column is (data: tensor[n], validity: bool tensor[n] |
None); a DECIMAL128 column stores int64[n, 2] limb pairs. A STRING
column has one of two layouts, as in the reference:

- Arrow: ``data`` holds int32 offsets[n+1], ``chars`` the uint8 bytes;
- padded: ``data`` holds int32 lengths[n], ``chars`` a uint8 (n, W)
  matrix whose bytes past a row's length are zero
  (``ops/strings.py`` converts between them).

A LIST column holds int32 offsets[n+1] into its one child in ``data``
and the child in ``children``, as in the reference; in the padded wire
layout (``ops/lists.py::pad_lists``) ``data`` holds int32 lengths[n]
and the child is an (n, L) element matrix whose (n, L) validity is
mandatory: that 2-D validity marks the layout. A STRUCT column holds a
uint8[n] placeholder in ``data`` and its fields, of equal row counts,
in ``children``.

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

from spark_rapids_jni_tpu_torch.types import STRING, DType, TypeId
from spark_rapids_jni_tpu_torch.utils.platform import resolve_device


# torch has no gather kernels for these unsigned types on every device;
# equality only needs their bits, so they compare as signed views
_SIGNED_VIEW = {torch.uint16: torch.int16, torch.uint32: torch.int32,
                torch.uint64: torch.int64}


def _indexable(x: torch.Tensor) -> torch.Tensor:
    view = _SIGNED_VIEW.get(x.dtype)
    return x if view is None else x.view(view)


def take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[idx]`` for every storage dtype: unsigned types gather through
    a same-width signed view and come back in their own dtype."""
    return _indexable(x)[idx].view(x.dtype)


def zeros(shape, dtype: torch.dtype, device) -> torch.Tensor:
    """``torch.zeros`` for every storage dtype (through the signed view)."""
    return torch.zeros(shape, dtype=_SIGNED_VIEW.get(dtype, dtype),
                       device=device).view(dtype)


def cat(xs) -> torch.Tensor:
    """``torch.cat`` for every storage dtype (through the signed view)."""
    return torch.cat([_indexable(x) for x in xs]).view(xs[0].dtype)


@dataclass
class Column:
    dtype: DType
    data: torch.Tensor
    validity: Optional[torch.Tensor] = None  # bool[n], True = valid
    # STRING columns only: the uint8 bytes (Arrow) or (n, W) matrix (padded)
    chars: Optional[torch.Tensor] = None
    # LIST: [element column], data = int32 offsets[n+1] (or lengths[n]
    # in the padded layout); STRUCT: the fields, data = uint8[n]
    children: Optional[list] = None

    def __post_init__(self) -> None:
        if self.validity is not None:
            if self.validity.dtype != torch.bool:
                raise TypeError("validity must be bool")
            if self.validity.device != self.data.device:
                raise ValueError("validity must live on the data's device")
        if self.dtype.is_list:
            if not self.children or len(self.children) != 1:
                raise ValueError("LIST column requires exactly one child")
            if self.data.dtype != torch.int32:
                raise TypeError("LIST offsets must be int32")
            if self.chars is not None:
                raise ValueError("only STRING columns carry chars")
            return
        if self.dtype.type_id == TypeId.STRUCT:
            if not self.children:
                raise ValueError("STRUCT column requires children")
            if self.chars is not None:
                raise ValueError("only STRING columns carry chars")
            n = int(self.data.shape[0])
            if any(f.size != n for f in self.children):
                raise ValueError("STRUCT fields must have equal row counts")
            return
        if self.children is not None:
            raise ValueError("only LIST and STRUCT columns carry children")
        if self.dtype.is_string:
            if self.chars is None:
                raise ValueError("string column requires chars buffer")
            if self.data.dtype != torch.int32:
                raise TypeError("string offsets/lengths must be int32")
            if self.chars.dtype != torch.uint8:
                raise TypeError("string chars must be uint8")
            if self.chars.device != self.data.device:
                raise ValueError("chars must live on the data's device")
        elif self.chars is not None:
            raise ValueError("only STRING columns carry chars")
        elif self.dtype.is_decimal128:
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
                f"{self.dtype} columns are not ported (fixed-width, "
                "DECIMAL128, STRING, LIST and STRUCT only)")

    @property
    def is_padded_string(self) -> bool:
        """String column in the padded device layout: data = int32
        lengths, chars = uint8 (n, W) matrix."""
        return self.dtype.is_string and self.chars.ndim == 2

    @property
    def is_padded_list(self) -> bool:
        """LIST column in the padded wire layout: data = int32 lengths,
        children[0] an (n, L) element matrix with mandatory (n, L)
        element validity, the layout's marker."""
        return (self.dtype.is_list
                and self.children[0].validity is not None
                and self.children[0].validity.ndim == 2)

    @property
    def is_struct(self) -> bool:
        return self.dtype.type_id == TypeId.STRUCT

    @property
    def size(self) -> int:
        if (self.dtype.is_list and not self.is_padded_list) or (
                self.dtype.is_string and not self.is_padded_string):
            return int(self.data.shape[0]) - 1
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
        chars: Optional[np.ndarray] = None,
    ) -> "Column":
        """Host arrays -> column on ``device`` (None: the CUDA device). A
        STRING column takes its int32 offsets or lengths as ``values`` and
        its bytes (1-D, or the (n, W) matrix) as ``chars``."""
        device = resolve_device(device)
        values = np.asarray(values)
        vmask = None if validity is None else torch.from_numpy(
            np.asarray(validity).astype(bool)).to(device)
        if dtype is not None and dtype.is_string:
            return cls(dtype, torch.from_numpy(values.astype(np.int32)).to(
                device), vmask, chars=torch.from_numpy(
                    np.asarray(chars).astype(np.uint8)).to(device))
        if dtype is None:
            dtype = DType.from_numpy(values.dtype)
        store = np.int64 if dtype.is_decimal128 else dtype.storage_dtype
        # fresh host copies: the column never aliases the caller's arrays
        data = torch.from_numpy(values.astype(store)).to(device)
        return cls(dtype, data, vmask)

    @classmethod
    def from_pylist(cls, values: Sequence, dtype: DType,
                    device=None) -> "Column":
        """Build from a python list where ``None`` marks nulls (STRING
        values are ``str`` or ``bytes``; the column is Arrow-laid)."""
        valid = np.array([v is not None for v in values], dtype=bool)
        vmask = None if valid.all() else valid
        if dtype.is_string:
            chunks = [v.encode() if isinstance(v, str) else (v or b"")
                      for v in values]
            offsets = np.zeros(len(values) + 1, dtype=np.int32)
            np.cumsum([len(c) for c in chunks], out=offsets[1:])
            chars = np.frombuffer(b"".join(chunks), dtype=np.uint8)
            return cls.from_numpy(offsets, dtype, vmask, device, chars=chars)
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

    def row_bytes(self) -> list:
        """Each row's bytes (``bytes``; null rows too), host side."""
        data, _ = self.to_numpy()
        chars = self.chars.cpu().numpy()
        if self.is_padded_string:
            return [chars[i, :data[i]].tobytes() for i in range(self.size)]
        blob = chars.tobytes()
        return [blob[data[i]:data[i + 1]] for i in range(self.size)]

    def to_pylist(self) -> list:
        data, mask = self.to_numpy()
        if self.is_padded_list:
            elem = self.children[0]
            mat, ev = elem.data.cpu().numpy(), elem.validity.cpu().numpy()
            return [None if mask is not None and not mask[i]
                    else [_host_value(elem.dtype, mat[i, j]) if ev[i, j]
                          else None for j in range(data[i])]
                    for i in range(self.size)]
        if self.dtype.is_list:
            child = self.children[0].to_pylist()
            return [None if mask is not None and not mask[i]
                    else child[data[i]:data[i + 1]]
                    for i in range(self.size)]
        if self.is_struct:
            fields = [f.to_pylist() for f in self.children]
            return [None if mask is not None and not mask[i]
                    else tuple(f[i] for f in fields)
                    for i in range(self.size)]
        if self.dtype.is_string:
            return [None if mask is not None and not mask[i] else b.decode()
                    for i, b in enumerate(self.row_bytes())]
        return [None if mask is not None and not mask[i]
                else _host_value(self.dtype, data[i])
                for i in range(self.size)]

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
        if self.is_padded_list or other.is_padded_list:
            from spark_rapids_jni_tpu_torch.ops.lists import unpad_lists

            return unpad_lists(self).equals(unpad_lists(other))
        if self.dtype.is_list:
            return self._list_rows_equal(other, a_valid)
        if self.is_struct:
            # the fields must agree on the rows where the struct is valid
            rows = torch.nonzero(a_valid).flatten()
            return len(self.children) == len(other.children) and all(
                _take_rows(a, rows).equals(_take_rows(b, rows.to(b.device)))
                for a, b in zip(self.children, other.children))
        if self.dtype.is_string:
            from spark_rapids_jni_tpu_torch.ops.strings import (
                pad_to_common_width,
            )

            a, b = pad_to_common_width([self, other])
            same = (a.data == b.data.to(a.device)) \
                & (a.chars == b.chars.to(a.device)).all(1)
            return bool((same | ~a_valid).all())
        a = _indexable(self.data)[a_valid]
        b = _indexable(other.data.to(self.data.device))[a_valid]
        if a.is_floating_point():
            both_nan = torch.isnan(a) & torch.isnan(b)
            return bool(((a == b) | both_nan).all())
        return torch.equal(a, b)

    def _valid_elements(self, valid: torch.Tensor) -> torch.Tensor:
        """Child row indices of the valid rows' elements, row by row."""
        offsets = self.data.to(torch.int64)
        starts = offsets[:-1][valid]
        counts = (offsets[1:] - offsets[:-1])[valid]
        first = torch.cumsum(counts, 0) - counts
        total = int(counts.sum()) if counts.numel() else 0
        q = torch.arange(total, dtype=torch.int64, device=offsets.device)
        row = torch.repeat_interleave(
            torch.arange(counts.numel(), device=offsets.device), counts)
        return starts[row] + q - first[row]

    def _list_rows_equal(self, other: "Column", valid: torch.Tensor) -> bool:
        """The valid rows hold equal lists: equal lengths, and equal
        elements under the elements' own validity."""
        b_off = other.data.to(self.device)
        if not torch.equal((self.data[1:] - self.data[:-1])[valid],
                           (b_off[1:] - b_off[:-1])[valid]):
            return False
        a_child, b_child = self.children[0], other.children[0]
        a_idx = self._valid_elements(valid)
        b_idx = Column(other.dtype, b_off, None, children=[b_child]) \
            ._valid_elements(valid).to(b_child.device)
        return _take_rows(a_child, a_idx).equals(
            _take_rows(b_child, b_idx))

    def __repr__(self) -> str:
        return (f"Column({self.dtype}, size={self.size}, "
                f"device={self.device})")


def _host_value(dtype: DType, v):
    """One fixed-width or DECIMAL128 host value as a Python object."""
    if dtype.type_id == TypeId.BOOL8:
        return bool(v)
    if dtype.is_decimal128:
        return (int(v[1]) << 64) | int(np.uint64(v[0]))
    return v.item()


def _take_rows(col: Column, idx: torch.Tensor) -> Column:
    """The rows ``idx`` of a fixed-width, STRING or STRUCT column."""
    if col.dtype.is_string:
        from spark_rapids_jni_tpu_torch.ops.strings import gather_strings

        return gather_strings(col, idx)
    validity = None if col.validity is None else col.validity[idx]
    if col.is_struct:
        return Column(col.dtype, col.data[idx], validity,
                      children=[_take_rows(f, idx) for f in col.children])
    return Column(col.dtype, take(col.data, idx), validity)


def string_column(values: Sequence[Optional[str]], device=None) -> Column:
    """An Arrow-laid STRING column from a python list (None = null)."""
    return Column.from_pylist(values, STRING, device)
