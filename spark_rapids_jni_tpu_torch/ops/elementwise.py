"""Elementwise SQL functions (counterpart of
``spark_rapids_jni_tpu/ops/elementwise.py``): coalesce, nullif,
greatest/least, abs, ceil/floor, round (decimal-exact HALF_UP) and pmod.

Each is a few ``torch.where`` passes over the rows; no kernel of this
port is involved. The reference's host checks and error types come over
as they are; its ``_*_impl`` bodies, which it routes through its
shape-bucketed dispatch, are plain functions here.

Null semantics are Spark's per function: coalesce takes the first
non-null; nullif(a, b) nulls where equal; greatest/least skip nulls
(null only when every operand is null); unary math propagates nulls;
pmod is null when the divisor is 0 (non-ANSI) or either side is null.

Two places differ from a literal translation, so that the results equal
the reference's on either device:

- a float -> BIGINT cast (ceil/floor of FLOAT32/64) saturates as Java's
  ``(long)`` cast and XLA's convert do: NaN -> 0, values at or past
  +-2^63 -> INT64_MAX / INT64_MIN. torch's ``.to(torch.int64)`` gives
  INT64_MIN for all of them (and C leaves them undefined on the card);
- unsigned 16/32/64-bit storage compares and divides through int64
  images, which torch's kernels need.
"""

from __future__ import annotations

from typing import Sequence

import torch

from spark_rapids_jni_tpu_torch.columnar import Column
from spark_rapids_jni_tpu_torch.columnar.column import _SIGNED_VIEW, _indexable
from spark_rapids_jni_tpu_torch.ops.sort import INT64_MIN, int64_value, order_key
from spark_rapids_jni_tpu_torch.types import DType, TypeId, decimal32, decimal64
from spark_rapids_jni_tpu_torch.utils.tracing import func_range

INT64_MAX = (1 << 63) - 1
_WIDE_UNSIGNED = (torch.uint16, torch.uint32, torch.uint64)


def _check_numeric(c: Column, op: str) -> None:
    if c.dtype.is_string or c.dtype.is_decimal128 or \
            c.dtype.type_id in (TypeId.LIST, TypeId.STRUCT):
        raise TypeError(f"{op} needs a fixed-width numeric column, "
                        f"got {c.dtype}")


def _same_dtypes(cols: Sequence[Column], op: str) -> None:
    for c in cols[1:]:
        if c.dtype != cols[0].dtype:
            raise TypeError(
                f"{op} needs matching dtypes, got {c.dtype} vs "
                f"{cols[0].dtype}")


def _coalesce_impl(cols: Sequence[Column]) -> Column:
    first = cols[0]
    if first.dtype.is_string:
        from spark_rapids_jni_tpu_torch.ops.strings import pad_to_common_width

        ps = pad_to_common_width(cols)
        data, chars = ps[0].data, ps[0].chars
        taken = ps[0].valid_mask()
        for p in ps[1:]:
            use = ~taken & p.valid_mask()
            data = torch.where(use, p.data, data)
            chars = torch.where(use[:, None], p.chars, chars)
            taken = taken | p.valid_mask()
        return Column(first.dtype, data, taken, chars=chars)
    data = first.data
    taken = first.valid_mask()
    for c in cols[1:]:
        use = ~taken & c.valid_mask()
        if first.dtype.is_decimal128:
            use = use[:, None]
        data = torch.where(use, c.data, data)
        taken = taken | c.valid_mask()
    return Column(first.dtype, data, taken)


@func_range("coalesce")
def coalesce(cols: Sequence[Column]) -> Column:
    """Spark ``coalesce``: per row, the first non-null operand."""
    if not cols:
        raise ValueError("coalesce needs at least one column")
    _same_dtypes(cols, "coalesce")
    return _coalesce_impl(list(cols))


@func_range("nullif")
def nullif(a: Column, b: Column) -> Column:
    """Spark ``nullif(a, b)``: a, nulled where a == b (a null pair does
    not null: null == null is unknown, and a stays null anyway). Strings
    compare by padded bytes, DECIMAL128 by limb pairs."""
    _same_dtypes([a, b], "nullif")
    if a.dtype.is_string:
        from spark_rapids_jni_tpu_torch.ops.strings import pad_to_common_width

        pa, pb = pad_to_common_width([a, b])
        eq_val = (pa.data == pb.data) & (pa.chars == pb.chars).all(dim=1)
        eq = eq_val & pa.valid_mask() & pb.valid_mask()
        return Column(pa.dtype, pa.data, pa.valid_mask() & ~eq,
                      chars=pa.chars)
    if a.dtype.is_decimal128:
        eq_val = (a.data == b.data).all(dim=-1)
    else:
        eq_val = order_key(a.data) == order_key(b.data) \
            if a.data.dtype in _WIDE_UNSIGNED else a.data == b.data
    eq = eq_val & a.valid_mask() & b.valid_mask()
    return Column(a.dtype, a.data, a.valid_mask() & ~eq)


def _extremum_impl(cols: Sequence[Column], pick_max: bool) -> Column:
    is_float = cols[0].data.is_floating_point()

    def key(x):
        # Spark orders NaN above every value for greatest/least
        if is_float:
            return torch.where(torch.isnan(x), torch.inf, x)
        return order_key(x) if x.dtype in _WIDE_UNSIGNED else x

    acc = cols[0].data
    have = cols[0].valid_mask()
    for c in cols[1:]:
        v = c.valid_mask()
        better = key(c.data) > key(acc) if pick_max \
            else key(c.data) < key(acc)
        use = v & (~have | better)
        acc = _where(use, c.data, acc)
        have = have | v
    return Column(cols[0].dtype, acc, have)


def _where(cond: torch.Tensor, a: torch.Tensor, b: torch.Tensor):
    """``torch.where`` for every storage dtype (unsigned through a signed
    view of the same width)."""
    return torch.where(cond, _indexable(a), _indexable(b)).view(a.dtype)


def _nary_extremum(cols: Sequence[Column], op: str) -> Column:
    if len(cols) < 2:
        raise ValueError(f"{op} needs at least two columns")
    _same_dtypes(cols, op)
    for c in cols:
        _check_numeric(c, op)
    return _extremum_impl(list(cols), op == "greatest")


@func_range("greatest")
def greatest(cols: Sequence[Column]) -> Column:
    """Spark ``greatest``: row-wise max, skipping nulls (null only when
    all operands are null)."""
    return _nary_extremum(cols, "greatest")


@func_range("least")
def least(cols: Sequence[Column]) -> Column:
    return _nary_extremum(cols, "least")


@func_range("abs_")
def abs_(col: Column) -> Column:
    _check_numeric(col, "abs")
    data = col.data
    if not (data.dtype in _WIDE_UNSIGNED or data.dtype == torch.uint8):
        data = torch.abs(data)  # unsigned values are their own abs
    return Column(col.dtype, data, col.validity)


@func_range("ceil")
def ceil(col: Column) -> Column:
    """Spark ``ceil``: BIGINT for floats (a saturating cast); decimals
    round toward +inf in integer arithmetic (scale 0, as INT64)."""
    return _round_directed(col, up=True)


@func_range("floor")
def floor(col: Column) -> Column:
    return _round_directed(col, up=False)


def float_to_int64(v: torch.Tensor) -> torch.Tensor:
    """Java's ``(long)`` cast of integral float values, as XLA converts:
    NaN -> 0; at or past +-2^63 -> INT64_MAX / INT64_MIN; the rest
    exactly (every float at or past 2^53 is already an integer)."""
    nan = torch.isnan(v)
    high = v >= 2.0 ** 63
    safe = torch.where(nan | high, 0.0, v).clamp(min=-2.0 ** 63)
    out = safe.to(torch.int64)
    return torch.where(high, INT64_MAX, torch.where(nan, 0, out))


def _round_directed(col: Column, up: bool) -> Column:
    _check_numeric(col, "ceil/floor")
    dt = col.dtype
    i64 = DType(TypeId.INT64)
    if dt.is_decimal:
        s = -dt.scale
        if s <= 0:
            # already integral: the BIGINT value is unscaled * 10^scale
            return Column(i64, col.data.to(torch.int64) * 10 ** dt.scale,
                          col.validity)
        pow10 = 10 ** s
        q = torch.div(col.data, pow10, rounding_mode="floor")
        if up:
            q = q + (torch.remainder(col.data, pow10) != 0).to(q.dtype)
        return Column(i64, q.to(torch.int64), col.validity)
    if col.data.is_floating_point():
        v = torch.ceil(col.data) if up else torch.floor(col.data)
        return Column(i64, float_to_int64(v), col.validity)
    return Column(i64, int64_value(col.data), col.validity)


@func_range("round_decimal")
def round_decimal(col: Column, d: int = 0) -> Column:
    """Spark ``round(decimal, d)`` with HALF_UP in exact integer
    arithmetic: the unscaled value divided by 10^(frac-d), ties away
    from zero; the result has scale -d. Non-decimal inputs are refused."""
    dt = col.dtype
    if not dt.is_decimal or dt.is_decimal128:
        raise TypeError(
            f"round_decimal needs a DECIMAL32/64 column, got {dt}")
    if d >= -dt.scale:
        return col  # nothing to drop
    pow10 = 10 ** (-dt.scale - d)
    v = col.data
    q = torch.div(v, pow10, rounding_mode="floor")
    r = v - q * pow10                     # in [0, pow10)
    # HALF_UP is away from zero: a negative value's floor division already
    # moved down, so only a remainder strictly above half rounds it up
    neg = v < 0
    up = (~neg & (r * 2 >= pow10)) | (neg & (r * 2 > pow10))
    q = q + up.to(q.dtype)
    out_dt = decimal64(-d) if dt.type_id == TypeId.DECIMAL64 \
        else decimal32(-d)
    return Column(out_dt, q.to(dt.torch_dtype), col.validity)


def _urem64(x: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Unsigned 64-bit ``x % n`` (n != 0) on int64 bit patterns, as
    Java's ``Long.remainderUnsigned``."""
    def ult(a, b):
        return (a ^ INT64_MIN) < (b ^ INT64_MIN)

    q = torch.div((x >> 1) & INT64_MAX, n.clamp(min=1),
                  rounding_mode="floor") << 1
    r = torch.where(n < 0, x, x - q * n)  # n >= 2^63: at most one step
    return torch.where(~ult(r, n), r - n, r)


def _trunc_mod(x: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Java's truncated ``%`` from the floor ``%``: t = m - n where m != 0
    and the operand signs differ (no abs(), so INT64_MIN is safe)."""
    fm = torch.remainder(x, n)
    flip = (fm != 0) & ((x < 0) != (n < 0))
    return fm - torch.where(flip, n, torch.zeros_like(n))


@func_range("pmod")
def pmod(a: Column, b: Column) -> Column:
    """Spark ``pmod(a, b)``: Java's ``r = a % n; if (r < 0) (r + n) % n
    else r`` with the truncated ``%`` (dividend sign); a negative divisor
    keeps Spark's dividend-sign quirk. Division by zero gives null."""
    _same_dtypes([a, b], "pmod")
    _check_numeric(a, "pmod")
    zero = b.data == 0 if b.data.dtype not in _WIDE_UNSIGNED \
        else order_key(b.data) == order_key(torch.zeros_like(b.data))
    validity = a.valid_mask() & b.valid_mask() & ~zero
    x, n = a.data, b.data
    if x.dtype == torch.uint64:
        m = _urem64(x.view(torch.int64),
                    torch.where(zero, 1, n.view(torch.int64)))
        return Column(a.dtype, m.view(torch.uint64), validity)
    if x.dtype in (torch.uint16, torch.uint32):
        m = torch.remainder(order_key(x), torch.where(zero, 1, order_key(n)))
        return Column(a.dtype, m.to(_SIGNED_VIEW[x.dtype]).view(x.dtype),
                      validity)
    if x.is_floating_point():
        safe_n = torch.where(zero, torch.ones_like(n), n)
        jt = _trunc_mod(x, safe_n)
        m = torch.where(jt < 0, _trunc_mod(jt + safe_n, safe_n), jt)
        # one NaN (torch's CPU remainder returns a NaN of its own bits)
        return Column(a.dtype, torch.where(torch.isnan(m), float("nan"), m),
                      validity)
    # x % -1 is 0 for every x, as is x % 1: taking 1 keeps the card clear
    # of INT64_MIN / -1
    safe_n = torch.where(zero | (n == -1), torch.ones_like(n), n)
    jt = _trunc_mod(x, safe_n)
    adj = _trunc_mod(jt + safe_n, safe_n)  # |jt| < |n|: no overflow
    m = torch.where(jt < 0, adj, jt)
    return Column(a.dtype, m.to(a.dtype.torch_dtype), validity)
