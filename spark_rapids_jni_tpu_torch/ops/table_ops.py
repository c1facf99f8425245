"""Table-level helpers (counterpart of part of
``spark_rapids_jni_tpu/ops/table_ops.py``): the host-side trim of a
padded-plus-count result. Concatenate, compaction and distinct are not
ported yet (ROADMAP.md Queue 1 item 6)."""

from __future__ import annotations

from spark_rapids_jni_tpu_torch.columnar import Column, Table


def trim_table(table: Table, k: int) -> Table:
    """The first ``k`` rows of a padded result (every fixed-width and
    limb-pair column), as views."""
    return Table([
        Column(c.dtype, c.data[:k],
               None if c.validity is None else c.validity[:k])
        for c in table.columns
    ])
