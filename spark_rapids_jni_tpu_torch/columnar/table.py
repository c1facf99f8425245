"""Device-resident table (counterpart of
``spark_rapids_jni_tpu/columnar/table.py``): an ordered set of
equal-length columns."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

from spark_rapids_jni_tpu_torch.columnar.column import Column


@dataclass
class Table:
    columns: list[Column]

    def __post_init__(self) -> None:
        if self.columns:
            n = self.columns[0].size
            for c in self.columns:
                if c.size != n:
                    raise ValueError("all columns in a table must have equal size")

    @property
    def num_columns(self) -> int:
        return len(self.columns)

    @property
    def num_rows(self) -> int:
        return self.columns[0].size if self.columns else 0

    @classmethod
    def from_pylists(cls, columns: Sequence[tuple[Sequence, object]],
                     device=None) -> "Table":
        """Build from [(values, dtype), ...], ``None`` marking nulls (see
        :meth:`Column.from_pylist`; ``device=None`` is the card)."""
        return cls([Column.from_pylist(v, d, device) for v, d in columns])

    def column(self, i: int) -> Column:
        return self.columns[i]

    def schema(self) -> list:
        return [c.dtype for c in self.columns]

    def equals(self, other: "Table") -> bool:
        return self.num_columns == other.num_columns and all(
            a.equals(b) for a, b in zip(self.columns, other.columns)
        )

    def __repr__(self) -> str:
        return f"Table(rows={self.num_rows}, columns={[c.dtype for c in self.columns]})"
