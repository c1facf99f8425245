"""STRUCT-column utilities (counterpart of
``spark_rapids_jni_tpu/ops/structs.py``): build, field access and
Spark's ``col.*`` star-expansion.

``unpack_struct`` replaces a STRUCT column with its fields, the struct's
nulls ANDed into each field (``null_struct.field`` is null), after which
the sort, groupby and join machinery applies as it is: a null struct
sorts and groups like a row whose every field is null.
"""

from __future__ import annotations

from typing import Sequence

import torch

from spark_rapids_jni_tpu_torch.columnar import Column, Table
from spark_rapids_jni_tpu_torch.types import DType, TypeId
from spark_rapids_jni_tpu_torch.utils.tracing import func_range


def make_struct_column(fields: Sequence[Column], validity=None) -> Column:
    """A STRUCT over equal-length field columns (on their device)."""
    if not fields:
        raise ValueError("STRUCT needs at least one field")
    n = fields[0].size
    for f in fields:
        if f.size != n:
            raise ValueError("STRUCT fields must have equal row counts")
    device = fields[0].device
    if validity is not None:
        validity = torch.as_tensor(validity, dtype=torch.bool, device=device)
    return Column(DType(TypeId.STRUCT),
                  torch.zeros((n,), dtype=torch.uint8, device=device),
                  validity, children=list(fields))


def struct_field(col: Column, idx: int) -> Column:
    """``struct.field``: the field with the struct's nulls ANDed in."""
    if col.dtype.type_id != TypeId.STRUCT:
        raise TypeError(f"struct_field needs a STRUCT column, got "
                        f"{col.dtype}")
    f = col.children[idx]
    if col.validity is None:
        return f
    return Column(f.dtype, f.data, f.valid_mask() & col.validity,
                  chars=f.chars, children=f.children)


@func_range("unpack_struct")
def unpack_struct(table: Table, col_idx: int) -> Table:
    """Spark ``col.*``: the STRUCT column replaced in place by its fields
    (struct nulls ANDed into each); one level a call."""
    c = table.column(col_idx)
    if c.dtype.type_id != TypeId.STRUCT:
        raise TypeError(f"unpack_struct needs a STRUCT column, got "
                        f"{c.dtype}")
    fields = [struct_field(c, i) for i in range(len(c.children))]
    return Table(list(table.columns[:col_idx]) + fields
                 + list(table.columns[col_idx + 1:]))
