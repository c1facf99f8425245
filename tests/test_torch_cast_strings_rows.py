"""The port's CastStrings against the JAX package on the CPU at the
reference's edge row counts (1/255/256/257/2047/2048/2049), with null
tails whose rows keep their bytes (the reference's numeric parses read
them): every parse cast over seeded mixed strings. Exact, as in
``tests/test_torch_cast_strings.py``: types, validity and every data
byte (the number -> string casts at these counts are there)."""

from __future__ import annotations

import pytest

from torch_parity import (
    EDGE_ROWS,
    check_parse,
    null_tail,
    seeded_cast_strings,
)

# every parse cast at every edge row count
SEEDED = [("integer", "INT64"), ("decimal", "decimal64:-2"),
          ("float", "FLOAT64"), ("float", "FLOAT32"), ("boolean", None),
          ("date", None), ("timestamp", None)]
# more target types, at the largest edge count
SEEDED_WIDE = [("integer", "INT16"), ("integer", "UINT64"),
               ("decimal", "decimal32:-3")]


@pytest.mark.parametrize("n", EDGE_ROWS)
def test_parses_at_edge_row_counts(n):
    vals = seeded_cast_strings(n, n)
    valid = null_tail(n, n)
    for kind, name in SEEDED + (SEEDED_WIDE if n == EDGE_ROWS[-1] else []):
        check_parse(kind, name, vals, valid)
