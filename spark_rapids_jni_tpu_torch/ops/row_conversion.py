"""Row-major <-> column-major table conversion (counterpart of
``spark_rapids_jni_tpu/ops/row_conversion.py``; the reference's
``row_conversion.cu``).

The byte-level row format is the reference's (RowConversion.java:40-99):

  * columns packed in schema order, each aligned to its own element size;
  * one validity byte per 8 columns directly after the last column, bit
    ``col % 8`` of byte ``col // 8`` set <=> valid;
  * each row zero-padded to a 64-bit boundary;
  * output split into batches of < 2**31 bytes whose row counts are
    multiples of 32 (except the last);
  * fixed-width types only;
  * rows larger than MAX_ROW_SIZE (1536 bytes) rejected unless
    ``enforce_row_limit=False``; the kernel takes rows of any width.

Padding bytes are 0, where the original CUDA left whatever shared memory
held: deterministic output makes rows byte-comparable.

To rows runs the ``row_conversion.to_rows`` kernel on the card
(ops/kernels/row_transpose.py). From rows was never a kernel in the
reference: it is a strided byte slice and view per column here.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import torch

from spark_rapids_jni_tpu_torch.columnar import Column, Table
from spark_rapids_jni_tpu_torch.ops.bytecast import from_bytes
from spark_rapids_jni_tpu_torch.ops.kernels import row_transpose as krt
from spark_rapids_jni_tpu_torch.types import DType

INT32_MAX = 2**31 - 1
# (48KB shared mem / 32-thread minimum block) in the reference sets the max
# row size; the same documented contract is enforced here.
MAX_ROW_SIZE = 1536


def _align(offset: int, alignment: int) -> int:
    return (offset + alignment - 1) & ~(alignment - 1)


def compute_fixed_width_layout(
    schema: Sequence[DType],
) -> tuple[list[int], list[int], int]:
    """Return (column_start, column_size, size_per_row) for the packed row:
    each column aligned to its own size, validity bytes ((ncols+7)//8)
    after the last column unaligned, the row padded to 8 bytes."""
    column_start: list[int] = []
    column_size: list[int] = []
    at_offset = 0
    for dt in schema:
        if not (dt.is_fixed_width or dt.is_decimal128):
            raise TypeError("Only fixed width types are currently supported")
        s = dt.size_bytes
        at_offset = _align(at_offset, s)
        column_start.append(at_offset)
        column_size.append(s)
        at_offset += s
    validity_bytes = (len(schema) + 7) // 8
    at_offset += validity_bytes
    return column_start, column_size, _align(at_offset, 8)


@dataclass
class RowsColumn:
    """One output batch: the LIST<INT8> column of the reference — ``data``
    is the flat byte child, offsets are the implicit arithmetic sequence
    ``i * row_size``."""

    num_rows: int
    row_size: int
    data: torch.Tensor  # uint8[num_rows * row_size]

    @property
    def offsets(self) -> torch.Tensor:
        return torch.arange(self.num_rows + 1, dtype=torch.int32,
                            device=self.data.device) * self.row_size

    @property
    def size_bytes(self) -> int:
        return self.num_rows * self.row_size


def _to_rows_impl(table: Table) -> torch.Tensor:
    """Full-table row image as uint8[n, size_per_row]."""
    schema = table.schema()
    column_start, _, size_per_row = compute_fixed_width_layout(schema)
    datas = [c.data for c in table.columns]
    valids = [c.validity for c in table.columns]
    return krt.assemble_rows(datas, valids, schema, column_start,
                             size_per_row)


def convert_to_rows(
    table: Table, *, enforce_row_limit: bool = True
) -> list[RowsColumn]:
    """Columnar -> packed rows. Returns one or more RowsColumn batches, each
    under 2**31 bytes with a 32-row-multiple row count (except the last).
    The batches are views of one row image on the table's device."""
    if table.num_columns == 0:
        raise ValueError("table must have at least one column")
    _, _, size_per_row = compute_fixed_width_layout(table.schema())
    if enforce_row_limit and size_per_row > MAX_ROW_SIZE:
        raise ValueError("Row size is too large to fit in shared memory")

    rows = _to_rows_impl(table)  # (n, size_per_row)
    num_rows = table.num_rows
    max_rows_per_batch = (INT32_MAX // size_per_row) // 32 * 32
    out: list[RowsColumn] = []
    for row_start in range(0, max(num_rows, 1), max_rows_per_batch):
        count = min(num_rows - row_start, max_rows_per_batch)
        batch = rows[row_start : row_start + count].reshape(-1)
        out.append(RowsColumn(count, size_per_row, batch))
    return out


def _from_rows_impl(rows: torch.Tensor, schema: tuple[DType, ...]):
    """Columns and validity from the 2-D row image uint8[n, size_per_row]."""
    column_start, column_size, _ = compute_fixed_width_layout(schema)
    datas, valids = [], []
    vld_base = column_start[-1] + column_size[-1] if schema else 0
    for i, dt in enumerate(schema):
        start, size = column_start[i], column_size[i]
        datas.append(from_bytes(rows[:, start : start + size], dt))
        vbyte = rows[:, vld_base + i // 8]
        valids.append(((vbyte >> (i % 8)) & 1).to(torch.bool))
    return datas, valids


def convert_from_rows(rows: RowsColumn, schema: Sequence[DType]) -> Table:
    """Packed rows -> columnar. Validates the byte length against the
    layout, and returns columns that always carry a validity mask (the
    reference allocates masks unconditionally)."""
    schema_t = tuple(schema)
    for dt in schema_t:
        if not (dt.is_fixed_width or dt.is_decimal128):
            raise TypeError("Only fixed width types are currently supported")
    _, _, size_per_row = compute_fixed_width_layout(schema_t)
    if size_per_row != rows.row_size or rows.data.shape[0] != rows.num_rows * size_per_row:
        raise ValueError("The layout of the data appears to be off")
    rows2d = rows.data.reshape(rows.num_rows, size_per_row)
    datas, valids = _from_rows_impl(rows2d, schema_t)
    return Table(
        [Column(dt, d, v) for dt, d, v in zip(schema_t, datas, valids)]
    )
