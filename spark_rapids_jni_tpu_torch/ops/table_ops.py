"""Table-level helpers (counterpart of part of
``spark_rapids_jni_tpu/ops/table_ops.py``): the host-side trim of a
padded-plus-count result. Concatenate, compaction and distinct are not
ported yet (ROADMAP.md Queue 1 entry 3)."""

from __future__ import annotations

from spark_rapids_jni_tpu_torch.columnar import Column, Table


def _slice_column(c: Column, lo: int, hi: int) -> Column:
    """Rows [lo, hi) of one column, every layout: fixed-width, limb pair,
    padded string, and Arrow string (whose offsets are re-based to the
    slice's first byte, one host read of the two bounds)."""
    validity = None if c.validity is None else c.validity[lo:hi]
    if c.dtype.is_string and not c.is_padded_string:
        base_lo, base_hi = (int(v) for v in c.data[[lo, hi]].tolist())
        return Column(c.dtype, c.data[lo:hi + 1] - base_lo, validity,
                      chars=c.chars[base_lo:base_hi])
    return Column(c.dtype, c.data[lo:hi], validity,
                  None if c.chars is None else c.chars[lo:hi])


def trim_table(table: Table, k: int) -> Table:
    """The first ``k`` rows of a padded result (views, except an Arrow
    string column's re-based offsets)."""
    return Table([_slice_column(c, 0, k) for c in table.columns])
