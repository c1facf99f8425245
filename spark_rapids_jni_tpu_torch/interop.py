"""Host-array interchange for port tables (no counterpart in the JAX
package).

A table crosses between the JAX package and this one as plain numpy
arrays: one ``(type_id, scale, data, validity)`` tuple per column, where
``data`` is the column's storage array (int64[n, 2] limb pairs for
DECIMAL128) and ``validity`` a bool[n] array or None (all rows valid).
The tests build these tuples from a JAX ``Table`` and compare results
the same way, so neither package needs to import the other.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from spark_rapids_jni_tpu_torch.columnar import Column, Table
from spark_rapids_jni_tpu_torch.types import DType, TypeId

HostColumn = tuple[int, int, np.ndarray, Optional[np.ndarray]]


def table_from_numpy(columns: Sequence[HostColumn], device=None) -> Table:
    """``[(type_id, scale, data, validity), ...]`` -> Table on ``device``
    (None: the CUDA device)."""
    return Table([
        Column.from_numpy(data, DType(TypeId(int(type_id)), int(scale)),
                          validity, device)
        for type_id, scale, data, validity in columns
    ])


def table_to_numpy(table: Table) -> list[HostColumn]:
    """Table -> ``[(type_id, scale, data, validity), ...]`` host arrays;
    the tri-state survives (validity None stays None)."""
    out = []
    for c in table.columns:
        data, valid = c.to_numpy()
        out.append((int(c.dtype.type_id), int(c.dtype.scale), data, valid))
    return out
