"""Multi-key table sort (counterpart of ``spark_rapids_jni_tpu/ops/sort.py``,
fixed-width keys).

Each key column is encoded into order-preserving integer keys, and the
sort is a chain of stable ``torch.sort`` passes from the minor key to the
major one — the lexsort the reference gets from ``jnp.lexsort``. A
stable sort gives the same permutation however the keys are grouped, so
the keys are packed into as few int64 words as fit (a 64-bit key is a
word of its own). The orders match the reference exactly:

- signed ints by value, unsigned ints by value, BOOL8 as uint8;
- float32 bitwise (sign-magnitude flip): -0.0 sorts before 0.0, every
  NaN is one value above +inf;
- float64 by value: -0.0 and 0.0 tie (input order kept), NaN is one
  value above +inf;
- DECIMAL128 as the signed 128-bit integer of its (lo, hi) limbs;
- STRING by memcmp of the bytes, then length (embedded NUL bytes
  included): the length and one 32-bit big-endian word per 4 bytes of
  the padded layout (``ops/strings.py::packed_sort_keys``);
- a null's value key is a constant, and its null rank is the column's
  most significant key (``nulls_first`` picks the side);
- rows with ``row_valid`` False sort after every real row.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from spark_rapids_jni_tpu_torch.columnar import Column, Table
from spark_rapids_jni_tpu_torch.columnar.column import take
from spark_rapids_jni_tpu_torch.ops.strings import (
    gather_strings,
    packed_sort_keys,
)

INT64_MIN = -(1 << 63)
_LOW63 = (1 << 63) - 1
_PACK_BITS = 63  # packed words stay non-negative, so signed order holds

# (int64 key, bit width): a width below 64 is a value in [0, 2^width);
# width 64 is a key ordered as a signed int64
Field = tuple[torch.Tensor, int]


def order_key(x: torch.Tensor) -> torch.Tensor:
    """An integer tensor as int64 with the same order (uint64 through a
    sign-bit flip of its bits): a sort or binary search over the result
    orders the values as the original dtype does."""
    if x.dtype == torch.uint64:
        return x.view(torch.int64) ^ INT64_MIN
    if x.dtype in (torch.uint16, torch.uint32):
        bits = x.dtype.itemsize * 8
        signed = {16: torch.int16, 32: torch.int32}[bits]
        return x.view(signed).to(torch.int64) & ((1 << bits) - 1)
    return x.to(torch.int64)


def int64_value(x: torch.Tensor) -> torch.Tensor:
    """An integer tensor's values as int64: exact for every dtype but
    uint64, whose bit pattern is kept (exact below 2^63; sums of it wrap
    like the reference's)."""
    if x.dtype == torch.uint64:
        return x.view(torch.int64)
    return order_key(x)


def _int_field(x: torch.Tensor) -> Field:
    """The reference's unsigned key of an integer column: signed values
    shifted by 2^(w-1), unsigned values as they are; 64-bit keys keep
    their (unsigned-order) int64 form."""
    bits, k = x.dtype.itemsize * 8, order_key(x)
    if bits < 64 and x.dtype.is_signed:
        k = k + (1 << (bits - 1))
    return k, bits


def _float32_field(x: torch.Tensor) -> Field:
    u = x.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    enc = torch.where(u >> 31 == 1, u ^ 0xFFFFFFFF, u ^ 0x80000000)
    # every NaN (either sign) is one value above +inf
    return torch.where(torch.isnan(x), 0xFFFFFFFF, enc), 32


def _float64_value_key(x: torch.Tensor, ascending: bool) -> torch.Tensor:
    """float64 by value as an ordered int64: NaN takes +inf's place (its
    rank key decides), -0.0 folds into 0.0 (the two tie)."""
    v = torch.where(torch.isnan(x), torch.inf, x)
    if not ascending:
        v = -v
    bits = (v + 0.0).view(torch.int64)  # -0.0 + 0.0 == +0.0
    return torch.where(bits < 0, bits ^ _LOW63, bits)


def _flip(field: Field) -> Field:
    k, w = field
    return (~k, 64) if w == 64 else (k ^ ((1 << w) - 1), w)


def _key_fields(col: Column, ascending: bool, nulls_first: bool) -> list[Field]:
    """The sort keys of one column, minor to major: its value key(s),
    forced to 0 on null rows so nulls tie on the value, then its null
    rank."""
    dtype = col.dtype
    valid = col.valid_mask()
    if dtype.is_decimal128:
        value = [(col.data[:, 0] ^ INT64_MIN, 64), (col.data[:, 1], 64)]
    elif dtype.is_string:
        value = [(k, 32) for k in packed_sort_keys(col)]
    elif col.data.dtype == torch.float64:
        nan = torch.isnan(col.data)
        value = [(_float64_value_key(col.data, ascending), 64),
                 ((nan if ascending else ~nan).to(torch.int64), 1)]
    elif col.data.dtype == torch.float32:
        value = [_float32_field(col.data)]
    else:
        value = [_int_field(col.data)]
    if not ascending and col.data.dtype != torch.float64:
        value = [_flip(f) for f in value]
    value = [(torch.where(valid, k, 0), w) for k, w in value]
    rank = valid if nulls_first else ~valid
    return value + [(rank.to(torch.int64), 1)]


def _pack(fields: Sequence[Field]) -> list[torch.Tensor]:
    """Minor-to-major fields folded into as few int64 words as hold them
    (minor field in the low bits); a 64-bit field is a word alone."""
    words: list[torch.Tensor] = []
    acc, used = None, 0
    for k, w in fields:
        if acc is not None and (w == 64 or used + w > _PACK_BITS):
            words.append(acc)
            acc, used = None, 0
        if w == 64:
            words.append(k)
            continue
        acc = k if acc is None else acc | (k << used)
        used += w
    if acc is not None:
        words.append(acc)
    return words


def lexsort(words: Sequence[torch.Tensor], n: int, device) -> torch.Tensor:
    """Stable permutation ordering rows by ``words`` (minor to major),
    one stable sort pass per word."""
    perm = None
    for w in words:
        k = w if perm is None else w[perm]
        idx = torch.sort(k, stable=True).indices
        perm = idx if perm is None else perm[idx]
    if perm is None:
        return torch.arange(n, dtype=torch.int64, device=device)
    return perm


def sort_order(
    table: Table,
    keys: Sequence[int],
    ascending: Optional[Sequence[bool]] = None,
    nulls_first: Optional[Sequence[bool]] = None,
    row_valid: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Stable sort permutation (int64) ordering rows by the key columns.
    Rows where ``row_valid`` is False sort after every real row."""
    if ascending is None:
        ascending = [True] * len(keys)
    if nulls_first is None:
        nulls_first = [True] * len(keys)
    fields: list[Field] = []
    for k, asc, nf in zip(reversed(list(keys)), reversed(list(ascending)),
                          reversed(list(nulls_first))):
        fields.extend(_key_fields(table.column(k), bool(asc), bool(nf)))
    if row_valid is not None:
        fields.append(((~row_valid).to(torch.int64), 1))
    device = table.columns[0].device if table.columns else None
    return lexsort(_pack(fields), table.num_rows, device)


def gather(table: Table, indices: torch.Tensor) -> Table:
    """Row gather (the cuDF gather primitive); ``indices`` must be in
    range. String columns come back padded."""
    return Table([
        gather_strings(c, indices) if c.dtype.is_string else
        Column(c.dtype, take(c.data, indices),
               None if c.validity is None else c.validity[indices])
        for c in table.columns
    ])


def sort_table(
    table: Table,
    keys: Sequence[int],
    ascending: Optional[Sequence[bool]] = None,
    nulls_first: Optional[Sequence[bool]] = None,
) -> Table:
    return gather(table, sort_order(table, keys, ascending, nulls_first))
