"""String <-> number and date casts (counterpart of
``spark_rapids_jni_tpu/ops/cast_strings.py``; CastStrings, BASELINE.json
config 1).

Parse direction (string -> integer, decimal, float, boolean, date,
timestamp): the reference gathers an Arrow column into an (n, max_len)
character matrix and parses every row in lockstep. Here the matrix is
laid out position-major, (w, n), and every accumulation walks the
positions one at a time over 1-D lanes, so no (n, max_len) int64 or
float64 temporary exists (at 60M rows each would take 15 GB) and the sums
run in a fixed order. The numeric casts read the longest row to the host
once and keep ``w = min(max_len, longest + 1)`` positions: every cell
past the longest row is a space in both layouts, and every clipped read
of the reference lands on such a space, so the results are the
reference's bytes.

Spark CAST semantics (non-ANSI): whitespace trimmed, an optional sign,
invalid input -> null, integer overflow -> null, decimals round HALF_UP
to the target scale and null on precision overflow.

The FLOAT parse reproduces the reference's bits, not a correctly rounded
parse (the reference is not correctly rounded either):

- each mantissa digit is multiplied by its power of ten and added, one
  position at a time, most significant first (the order of the
  reference's reduction), as two separate operations (no fused
  multiply-add, which would round once where the reference rounds twice);
- the powers of ten come from one float64 table built on the host from
  Python's ``10.0 ** k``, which equals XLA's ``pow(10.0, k)`` for every
  k in [-400, 400] except where XLA flushes a subnormal power to zero,
  which the table does as well;
- the reference runs with subnormals flushed to zero (XLA on the CPU):
  a result whose rounding with an unbounded exponent falls below the
  smallest normal float64 (or, for FLOAT32, float32) becomes a zero of
  its sign. The port tests the float64 product 2^200 higher, where it is
  normal and rounds the same way, and the float64 value against the
  float32 threshold before the conversion.

Number -> string (integer, decimal, boolean, date): the reference builds
the Arrow bytes in a per-row Python loop on the host; here the same bytes
are built on the device (digits, then lengths, offsets by ``cumsum``,
then the chars by one scatter per output position). ``float_to_string``
stays on the host, as in the reference (shortest round-trip digits from
numpy), and records each call through ``telemetry.record_fallback``.
A padded STRING column goes through ``unpad_strings`` first.
"""

from __future__ import annotations

import numpy as np
import torch

from spark_rapids_jni_tpu_torch import telemetry
from spark_rapids_jni_tpu_torch import types as t
from spark_rapids_jni_tpu_torch.columnar import Column
from spark_rapids_jni_tpu_torch.ops._calendar import (
    civil_from_days,
    days_from_civil,
)
from spark_rapids_jni_tpu_torch.ops.strings import unpad_strings
from spark_rapids_jni_tpu_torch.types import DType, TypeId

DEFAULT_MAX_LEN = 32

_SPACE = 0x20
_INT64_MIN = -(1 << 63)
_INT64_MAX = (1 << 63) - 1
# float64 powers of ten for exponents [-_POW_SPAN, _POW_SPAN]
_POW_SPAN = 400
# a product is tested for the flush 2^_LIFT higher, where it is normal
_LIFT = 2.0 ** 200
_DBL_MIN_LIFTED = 2.0 ** -1022 * _LIFT
# below this a float64 rounds (unbounded exponent) under FLT_MIN
_F32_FLUSH = 2.0 ** -126 - 2.0 ** -151
_DAYS_IN_MONTH = (0, 31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31)
# the output position past which a row's scattered bytes are discarded
_DUMP = 1024


# ---- device constant tables (built once per device) -------------------------

_tables: dict = {}


def _table(name: str, device, build) -> torch.Tensor:
    key = (name, torch.device(device))
    out = _tables.get(key)
    if out is None:
        out = torch.from_numpy(build()).to(device)
        _tables[key] = out
    return out


def _pow10_f64_host() -> np.ndarray:
    def p(k: int) -> float:
        if k < -307:   # 10^k is subnormal or zero: XLA's pow gives 0.0
            return 0.0
        if k > 308:
            return float("inf")
        return 10.0 ** k
    return np.array([p(k) for k in range(-_POW_SPAN, _POW_SPAN + 1)],
                    np.float64)


def _pow10_f64(device) -> torch.Tensor:
    """float64[801]: entry k + 400 is the reference's 10^k."""
    return _table("pow10_f64", device, _pow10_f64_host)


def _pow10_i64(device) -> torch.Tensor:
    """int64[64]: 10^k wrapped to 64 bits (exact for k <= 18), as the
    reference's integer ``power`` wraps."""
    return _table("pow10_i64", device, lambda: np.array(
        [((10 ** k + (1 << 63)) % (1 << 64)) - (1 << 63) for k in range(64)],
        np.int64))


def _ule(a: torch.Tensor, b: int) -> torch.Tensor:
    """``a <= b`` with ``a`` int64 bits read as uint64 and ``b`` in
    [0, 2^64): both compare with their sign bit flipped (``order_key``'s
    image)."""
    return (a ^ _INT64_MIN) <= (b + _INT64_MIN)


_SIGNED_OF = {torch.uint16: torch.int16, torch.uint32: torch.int32,
              torch.uint64: torch.int64}


def _narrow(x: torch.Tensor, dtype: DType) -> torch.Tensor:
    """int64 values to the storage dtype, integers wrapping (unsigned
    through the signed type of the same width)."""
    td = dtype.torch_dtype
    signed = _SIGNED_OF.get(td)
    return x.to(td) if signed is None else x.to(signed).view(td)


def _as_int64_bits(x: torch.Tensor) -> torch.Tensor:
    """An integer tensor's values as int64 (unsigned ones zero-extended;
    uint64 keeps its bits)."""
    if x.dtype == torch.uint64:
        return x.view(torch.int64)
    signed = _SIGNED_OF.get(x.dtype)
    if signed is not None:
        bits = 8 * x.element_size()
        return x.view(signed).to(torch.int64) & ((1 << bits) - 1)
    return x.to(torch.int64)


def _arrow(col: Column) -> Column:
    if not col.dtype.is_string:
        raise TypeError("input must be a string column")
    return unpad_strings(col) if col.is_padded_string else col


def _first_where(masks, n: int, default, device) -> torch.Tensor:
    """int32[n]: the first j with ``masks[j]`` true, else ``default`` (an
    int or a tensor)."""
    out = torch.full((n,), -1, dtype=torch.int32, device=device)
    for j in range(len(masks) - 1, -1, -1):
        out = torch.where(masks[j], j, out)
    return torch.where(out < 0, default, out).to(torch.int32)


# ---- string -> number ---------------------------------------------------------

def _char_matrix(col: Column, max_len: int):
    """(mat, lengths, too_long): ``mat`` is uint8 (w, n) with byte j of
    every row in ``mat[j]``, a space past the row's end, for w =
    min(max_len, longest row + 1). One host read (the longest row)."""
    col = _arrow(col)
    offsets, chars = col.data, col.chars
    n = col.size
    dev = offsets.device
    starts = offsets[:-1]
    lengths = offsets[1:] - starts
    longest = int(lengths.max()) if n else 0
    w = max(min(max_len, longest + 1), 1)
    total = int(chars.shape[0])
    mat = torch.full((w, n), _SPACE, dtype=torch.uint8, device=dev)
    if total:
        for j in range(w):
            byte = chars[(starts + j).clamp(0, total - 1)]
            mat[j] = byte.masked_fill_(lengths <= j, _SPACE)
    return mat, lengths, lengths > max_len


def _strip_and_sign(mat: torch.Tensor, big: int):
    """(is_neg, start, end): the payload [start, end) of each row after
    whitespace trim and an optional sign; ``start`` is ``big`` (the
    reference's max_len) for a row with no payload."""
    w, n = mat.shape
    dev = mat.device
    nonspace = [~((c == 0x20) | (c == 0x09) | (c == 0x0A) | (c == 0x0D))
                for c in mat]
    first = _first_where(nonspace, n, big, dev)
    last = torch.full((n,), -1, dtype=torch.int32, device=dev)
    for j in range(w):
        last = torch.where(nonspace[j], j, last)
    first_c = mat.gather(0, first.clamp(0, w - 1).to(torch.int64)[None])[0]
    has_sign = (first_c == ord("-")) | (first_c == ord("+"))
    is_neg = first_c == ord("-")
    start = first + has_sign.to(torch.int32)
    return is_neg, start, last + 1


def string_to_integer(col: Column, dtype: DType,
                      max_len: int = DEFAULT_MAX_LEN) -> Column:
    """Parse to an integral column; invalid input or overflow -> null.
    The magnitude accumulates in int64 with wrapping arithmetic, the bits
    of the reference's uint64 sum, and compares unsigned."""
    mat, _, too_long = _char_matrix(col, max_len)
    is_neg, start, end = _strip_and_sign(mat, max_len)
    w, n = mat.shape
    dev = mat.device
    p10 = _pow10_i64(dev)
    ok = (end > start) & ~too_long
    value = torch.zeros((n,), dtype=torch.int64, device=dev)
    sig = []
    for j in range(w):
        in_payload = (start <= j) & (end > j)
        digit = mat[j] - ord("0")  # uint8, wraps below '0'
        is_digit = digit <= 9
        ok &= is_digit | ~in_payload
        weight = end - 1 - j  # 0 for the last digit
        pw = torch.where((weight >= 0) & (weight < 19),
                         p10[weight.clamp(0, 18)], 0)
        value += torch.where(in_payload, digit.to(torch.int64), 0) * pw
        sig.append(in_payload & (digit != 0) & is_digit)
    # leading zeros don't count: more than 19 significant digits would
    # fall outside the power window and wrap, so they are rejected
    sig_start = _first_where(sig, n, max_len, dev)
    ok &= (end - sig_start).clamp(min=0) <= 19
    np_dt = dtype.storage_dtype
    info = np.iinfo(np_dt if np_dt.kind in "iu" else np.int64)
    ok &= torch.where(is_neg, _ule(value, -int(info.min)),
                      _ule(value, int(info.max)))
    signed = torch.where(is_neg, value.neg(), value)
    return Column(dtype, _narrow(signed, dtype), ok)


def string_to_decimal(col: Column, dtype: DType,
                      max_len: int = DEFAULT_MAX_LEN) -> Column:
    """Parse to decimal32/64 at the target scale, HALF_UP rounding;
    invalid input or precision overflow -> null."""
    if not dtype.is_decimal:
        raise TypeError("target must be a decimal type")
    if dtype.is_decimal128:
        raise TypeError("DECIMAL128 is not fixed-width")
    mat, _, too_long = _char_matrix(col, max_len)
    is_neg, start, end = _strip_and_sign(mat, max_len)
    w, n = mat.shape
    dev = mat.device
    p10 = _pow10_i64(dev)
    in_payload = [(start <= j) & (end > j) for j in range(w)]
    is_dot = [(mat[j] == ord(".")) & in_payload[j] for j in range(w)]
    dot_count = torch.zeros((n,), dtype=torch.int32, device=dev)
    ok = ~too_long
    for j in range(w):
        dot_count += is_dot[j].to(torch.int32)
        ok &= ((mat[j] - ord("0")) <= 9) | (mat[j] == ord(".")) \
            | ~in_payload[j]
    ok &= (dot_count <= 1) & ((end - start) > dot_count)
    dot_pos = _first_where(is_dot, n, max_len, dev)
    dot_pos = torch.where(dot_count == 0, end, dot_pos)
    shift = -dtype.scale  # fraction digits kept
    value = torch.zeros((n,), dtype=torch.int64, device=dev)
    round_digit = torch.zeros((n,), dtype=torch.int64, device=dev)
    sig = []
    for j in range(w):
        digit = mat[j] - ord("0")
        is_digit = digit <= 9
        d64 = torch.where(in_payload[j] & is_digit, digit.to(torch.int64), 0)
        # 10^exp: digits left of the dot weigh (dot_pos - 1 - j) + shift,
        # right of it shift - (j - dot_pos)
        exp = torch.where(dot_pos > j, dot_pos - 1 - j + shift,
                          shift - (j - dot_pos))
        value += torch.where((exp >= 0) & (exp < 19),
                             d64 * p10[exp.clamp(0, 18)], 0)
        # HALF_UP: the first dropped fraction digit
        round_digit += torch.where(exp == -1, d64, 0)
        sig.append(in_payload[j] & is_digit & (digit != 0))
    value += (round_digit >= 5).to(torch.int64)
    # precision overflow on the post-rounding unscaled magnitude; leading
    # zeros don't count toward the accumulator's exactness bound
    sig_start = _first_where(sig, n, max_len, dev)
    sig_int = (dot_pos - torch.minimum(sig_start, dot_pos)).clamp(min=0)
    ok &= (sig_int + shift) <= 18
    max_digits = 18 if dtype.type_id == TypeId.DECIMAL64 else 9
    ok &= value <= 10 ** max_digits - 1
    signed = torch.where(is_neg, value.neg(), value)
    return Column(dtype, _narrow(signed, dtype), ok)


def _lower(c: torch.Tensor) -> torch.Tensor:
    return torch.where((c >= ord("A")) & (c <= ord("Z")), c + 32, c)


def string_to_float(col: Column, dtype: DType,
                    max_len: int = DEFAULT_MAX_LEN) -> Column:
    """Parse to float32/64: [+-]digits[.digits][eE[+-]digits], plus the
    Infinity/NaN spellings; invalid -> null. The reference's bits (see
    the module docstring)."""
    mat, _, too_long = _char_matrix(col, max_len)
    is_neg, start, end = _strip_and_sign(mat, max_len)
    w, n = mat.shape
    dev = mat.device
    lower = _lower(mat)

    def matches(word: bytes) -> torch.Tensor:
        m = (end - start) == len(word)
        for i, ch in enumerate(word):
            at = (start + i).clamp(0, w - 1).to(torch.int64)
            m &= lower.gather(0, at[None])[0] == ch
        return m

    is_inf = matches(b"infinity") | matches(b"inf")
    is_nan = matches(b"nan")

    in_payload = [(start <= j) & (end > j) for j in range(w)]
    is_e = [(lower[j] == ord("e")) & in_payload[j] for j in range(w)]
    e_count = torch.zeros((n,), dtype=torch.int32, device=dev)
    for j in range(w):
        e_count += is_e[j].to(torch.int32)
    e_pos = _first_where(is_e, n, max_len, dev)
    mant_end = torch.minimum(e_pos, end)

    in_mant = [(start <= j) & (mant_end > j) for j in range(w)]
    is_dot = [(mat[j] == ord(".")) & in_mant[j] for j in range(w)]
    dot_count = torch.zeros((n,), dtype=torch.int32, device=dev)
    ok = torch.ones((n,), dtype=torch.bool, device=dev)
    for j in range(w):
        dot_count += is_dot[j].to(torch.int32)
        ok &= ((mat[j] - ord("0")) <= 9) | (mat[j] == ord(".")) | ~in_mant[j]
    dot_pos = _first_where(is_dot, n, max_len, dev)
    dot_pos = torch.where(dot_count == 0, mant_end, dot_pos)
    ok &= (dot_count <= 1) & ((mant_end - start) > dot_count)

    # the mantissa: one multiply and one add per position, most
    # significant first
    p10 = _pow10_f64(dev)
    mant = torch.zeros((n,), dtype=torch.float64, device=dev)
    for j in range(w):
        digit = mat[j] - ord("0")
        use = in_mant[j] & (digit <= 9)
        expw = torch.where(dot_pos > j, dot_pos - 1 - j, dot_pos - j)
        expw = torch.where(use, expw, 0)
        d = torch.where(use, digit.to(torch.float64), 0.0)
        term = d * p10[(expw + _POW_SPAN).to(torch.int64)]
        mant = mant + term

    # the exponent: an exact int64 sum, saturated at +-400
    exp_start = torch.minimum(e_pos + 1, end)
    ec = mat.gather(0, exp_start.clamp(0, w - 1).to(torch.int64)[None])[0]
    e_neg = ec == ord("-")
    e_digits_start = torch.where(e_neg | (ec == ord("+")), exp_start + 1,
                                 exp_start)
    pi = _pow10_i64(dev)
    e_val = torch.zeros((n,), dtype=torch.int64, device=dev)
    e_ok = end > e_digits_start
    for j in range(w):
        digit = mat[j] - ord("0")
        is_digit = digit <= 9
        in_exp = (e_digits_start <= j) & (end > j)
        e_ok &= is_digit | ~in_exp
        e_weight = end - 1 - j
        e_val += torch.where(in_exp & is_digit & (e_weight >= 0),
                             digit.to(torch.int64) * pi[e_weight.clamp(0, 9)],
                             0)
    ok &= torch.where(e_count == 1, e_ok, e_count == 0)
    e_val = torch.where(e_neg, e_val.neg(), e_val).clamp(-_POW_SPAN,
                                                         _POW_SPAN)
    scale10 = p10[e_val + _POW_SPAN]
    value = mant * scale10
    # subnormal results flush to zero, as in the reference; 0e400 is
    # zero, not 0 * inf
    tiny = mant * (scale10 * _LIFT) < _DBL_MIN_LIFTED
    value = torch.where((mant == 0.0) | tiny, 0.0, value)
    value = torch.where(is_inf, float("inf"), value)
    value = torch.where(is_nan, float("nan"), value)
    # an overlong row is null even if its truncation spells inf or nan
    ok = (ok | is_inf | is_nan) & ~too_long
    signed = torch.where(is_neg, value.neg(), value)
    if dtype.type_id == TypeId.FLOAT32:
        f32 = signed.to(torch.float32)
        flush = signed.abs() < _F32_FLUSH
        return Column(dtype, torch.where(
            flush, torch.zeros_like(f32).copysign(f32), f32), ok)
    return Column(dtype, signed.to(dtype.torch_dtype), ok)


# ---- number -> string ---------------------------------------------------------

_MAX_I64_DIGITS = 20  # 19 digits + sign headroom


def _digits_lsb(mag: torch.Tensor, count: int):
    """(digits, nd): the ``count`` low decimal digits of ``mag`` (int64
    bits read as uint64), uint8 (count, n) with the units digit first,
    and each row's significant digit count (0 for zero). Unsigned
    division by ten: a logical shift right by one, then a division by
    five, which floors the same way."""
    x = mag
    nd = torch.zeros(mag.shape, dtype=torch.int32, device=mag.device)
    digits = torch.empty((count, mag.shape[0]), dtype=torch.uint8,
                         device=mag.device)
    for k in range(count):
        q = torch.div((x >> 1) & _INT64_MAX, 5, rounding_mode="floor")
        d = x - q * 10
        digits[k] = d.to(torch.uint8)
        nd = torch.where(d != 0, k + 1, nd)
        x = q
    return digits, nd


def _digit_count(mag: torch.Tensor) -> int:
    """Decimal digits of the largest uint64 magnitude (one host read)."""
    if mag.shape[0] == 0:
        return 1
    top, wide = torch.stack([mag.max(), (mag < 0).any().to(torch.int64)]
                            ).tolist()
    return _MAX_I64_DIGITS if wide else len(str(top))


def _digit_matrix_u64(mag: torch.Tensor) -> torch.Tensor:
    """uint64 bits in int64[n] -> uint8[n, 20] decimal digits, most
    significant first."""
    digits, _ = _digits_lsb(mag, _MAX_I64_DIGITS)
    return digits.flip(0).t().contiguous()


def _signed_magnitude(v: torch.Tensor):
    """(neg, magnitude as uint64 bits): INT64_MIN's magnitude is 2^63."""
    v = v.to(torch.int64)
    neg = v < 0
    return neg, torch.where(neg, v.neg(), v)


def _validity_out(valid: torch.Tensor, col: Column):
    """The reference's tri-state for a built string column: no mask when
    every row is valid."""
    if col.validity is None or bool(valid.all()):
        return None
    return valid


def _assemble(width: int, lengths: torch.Tensor, byte_at, validity
              ) -> Column:
    """An Arrow STRING column from per-row ``lengths`` (int32, 0 for a
    null row) and ``byte_at(p)``, uint8[n] holding byte p of every row
    whose length passes p. One host read (the total bytes)."""
    n = lengths.shape[0]
    dev = lengths.device
    offsets = torch.zeros((n + 1,), dtype=torch.int32, device=dev)
    offsets[1:] = torch.cumsum(lengths, 0)
    total = int(offsets[-1])
    buf = torch.empty((total + _DUMP,), dtype=torch.uint8, device=dev)
    starts = offsets[:-1].to(torch.int64)
    # a byte past its row's length goes to one of _DUMP spare slots
    dump = total + torch.remainder(
        torch.arange(n, dtype=torch.int64, device=dev), _DUMP)
    for p in range(width):
        idx = torch.where(lengths > p, starts + p, dump)
        buf.scatter_(0, idx, byte_at(p))
    return Column(t.STRING, offsets, validity, chars=buf[:total])


def _render_decimal(neg, mag, valid, col: Column, frac: int = 0,
                    trailing_zeros: int = 0) -> Column:
    """The reference's ``_assemble_decimal_strings`` on the device:
    ``frac`` fraction digits after a dot (at least one digit before it),
    or ``trailing_zeros`` zeros after a non-zero integer; '-' for
    negatives; an empty string for a null row."""
    count = _digit_count(mag)
    digits, nd = _digits_lsb(mag, count)
    sign = neg.to(torch.int32)
    if frac > 0:
        body = torch.clamp(nd, min=frac + 1)  # digits, the dot apart
        length = sign + body + 1
        width = 1 + max(count, frac + 1) + 1
    elif trailing_zeros:
        length = sign + torch.where(nd == 0, 1, nd + trailing_zeros)
        width = 1 + count + trailing_zeros
    else:
        body = torch.clamp(nd, min=1)
        length = sign + body
        width = 1 + count
    length = torch.where(valid, length, 0)

    def byte_at(p: int) -> torch.Tensor:
        q = p - sign  # position in the body
        if frac > 0:
            dot = body - frac
            lsb = torch.where(q < dot, body - 1 - q, body - q)
        elif trailing_zeros:
            lsb = nd - 1 - q
        else:
            lsb = body - 1 - q
        d = digits.gather(0, lsb.clamp(0, count - 1).to(torch.int64)[None])[0]
        out = torch.where((lsb >= 0) & (lsb < count), d, 0) + ord("0")
        if frac > 0:
            out = torch.where(q == body - frac, ord("."), out)
        return torch.where(q < 0, ord("-"), out).to(torch.uint8)

    return _assemble(width, length, byte_at, _validity_out(valid, col))


def integer_to_string(col: Column) -> Column:
    """Integral column -> STRING as Java's Long.toString (no leading
    zeros, '-' for negatives); unsigned columns stay unsigned (UINT64 past
    2^63 too). Booleans go through ``boolean_to_string``."""
    kind = col.dtype.storage_dtype.kind
    if kind not in ("i", "u") or col.dtype.is_decimal \
            or col.dtype.type_id == TypeId.BOOL8:
        raise TypeError(
            "integer_to_string requires an integral column (booleans cast "
            "via boolean_to_string)")
    if kind == "u":
        mag = _as_int64_bits(col.data)
        neg = torch.zeros(mag.shape, dtype=torch.bool, device=mag.device)
    else:
        neg, mag = _signed_magnitude(col.data)
    return _render_decimal(neg, mag, col.valid_mask(), col)


def decimal_to_string(col: Column) -> Column:
    """Decimal column -> STRING in Spark's plain form: scale -2, unscaled
    5 -> "0.05"; scale 0 as an integer; a positive scale appends its
    zeros to a non-zero integer."""
    if not col.dtype.is_decimal:
        raise TypeError("decimal_to_string requires a decimal column")
    if col.dtype.is_decimal128:
        raise NotImplementedError(
            "DECIMAL128 to string is not ported: the reference cannot "
            "render DECIMAL128 either (ROADMAP.md Queue 3)")
    neg, mag = _signed_magnitude(col.data)
    valid = col.valid_mask()
    if col.dtype.scale > 0:
        return _render_decimal(neg, mag, valid, col,
                               trailing_zeros=col.dtype.scale)
    return _render_decimal(neg, mag, valid, col, frac=-col.dtype.scale)


def boolean_to_string(col: Column) -> Column:
    """BOOL8 -> STRING: 'true' / 'false' (Spark cast semantics)."""
    if col.dtype.type_id != TypeId.BOOL8:
        raise TypeError("boolean_to_string requires a BOOL8 column")
    dev = col.data.device
    v = (col.data != 0).to(torch.int64)
    valid = col.valid_mask()
    words = torch.from_numpy(np.frombuffer(b"falsetrue\x00", np.uint8)
                             .reshape(2, 5).copy()).to(dev)
    length = torch.where(valid, (5 - v).to(torch.int32), 0)
    return _assemble(5, length, lambda p: words[:, p][v],
                     _validity_out(valid, col))


def date_to_string(col: Column) -> Column:
    """TIMESTAMP_DAYS -> STRING 'yyyy-MM-dd', zero-padded. Years outside
    [0, 9999] carry a sign ('-0044-03-15', '+10000-01-01'): a valid date
    always formats."""
    if col.dtype.type_id != TypeId.TIMESTAMP_DAYS:
        raise TypeError("date_to_string requires a TIMESTAMP_DAYS column")
    y, m, d = civil_from_days(col.data)
    valid = col.valid_mask()
    count = 7  # int32 days reach |year| < 5.9 million
    digits, nd = _digits_lsb(y.abs(), count)
    sign = ((y < 0) | (y > 9999)).to(torch.int32)
    yw = torch.clamp(nd, min=4)
    length = torch.where(valid, sign + yw + 6, 0)
    sign_ch = torch.where(y < 0, ord("-"), ord("+"))
    # the month and day digits after the year, at q = yw + 1 .. yw + 5
    tail = [None, m // 10, m % 10, None, d // 10, d % 10]

    def byte_at(p: int) -> torch.Tensor:
        q = p - sign
        lsb = yw - 1 - q
        yd = digits.gather(0, lsb.clamp(0, count - 1).to(torch.int64)[None])[0]
        out = torch.where(lsb >= 0, yd.to(torch.int64), 0) + ord("0")
        k = q - yw
        for i, part in enumerate(tail):
            ch = ord("-") if part is None else part + ord("0")
            out = torch.where(k == i, ch, out)
        return torch.where(q < 0, sign_ch, out).to(torch.uint8)

    return _assemble(1 + count + 6, length.to(torch.int32), byte_at,
                     _validity_out(valid, col))


def _java_float_repr(v, float32: bool) -> bytes:
    """One float as Java Double.toString / Float.toString renders it:
    shortest digits that round-trip at the column's width, plain decimal
    for 1e-3 <= |v| < 1e7 (always one fractional digit), otherwise
    d.dddE[-]ee."""
    if np.isnan(v):
        return b"NaN"
    if np.isinf(v):
        return b"Infinity" if v > 0 else b"-Infinity"
    v = np.float32(v) if float32 else np.float64(v)
    s = np.format_float_scientific(v, unique=True)
    sign = b""
    if s.startswith("-"):
        sign = b"-"
        s = s[1:]
    mant, exp = s.split("e")
    digits = mant.replace(".", "").rstrip("0")
    if not digits:  # +/- zero
        return sign + b"0.0"
    p = int(exp) + 1  # value = 0.<digits> * 10**p
    if -2 <= p <= 7:
        if p <= 0:
            out = "0." + "0" * (-p) + digits
        elif p >= len(digits):
            out = digits + "0" * (p - len(digits)) + ".0"
        else:
            out = digits[:p] + "." + digits[p:]
    else:
        frac = digits[1:] or "0"
        out = digits[0] + "." + frac + "E" + str(p - 1)
    return sign + out.encode()


def float_to_string(col: Column) -> Column:
    """FLOAT32/FLOAT64 -> STRING with Java's Double.toString semantics.
    Runs on the host (numpy's shortest round-trip digits), as in the
    reference, and records the fallback with its row count."""
    if col.dtype.storage_dtype.kind != "f":
        raise TypeError("float_to_string requires a float column")
    float32 = col.dtype.type_id == TypeId.FLOAT32
    vals = col.data.cpu().numpy()
    valid = col.valid_mask().cpu().numpy()
    telemetry.record_fallback(
        "float_to_string", "host-side shortest round-trip float digits "
        "(numpy); no device path", rows=len(vals))
    pieces = [_java_float_repr(v, float32) if ok else b""
              for v, ok in zip(vals, valid)]
    offsets = np.zeros(len(pieces) + 1, dtype=np.int32)
    np.cumsum([len(p) for p in pieces], out=offsets[1:])
    chars = np.frombuffer(b"".join(pieces), dtype=np.uint8)
    return Column.from_numpy(offsets, t.STRING,
                             None if valid.all() else valid,
                             device=col.data.device, chars=chars)


# ---- string -> date, timestamp, boolean ---------------------------------------

def _trimmed_matrix(col: Column, max_len: int):
    """(mat, lengths, judgeable): the bytes of each row from its first
    byte > 0x20, uint8 (max_len, n) position-major, spaces past the
    trimmed length, which excludes trailing bytes <= 0x20 (Spark's
    UTF8String.trim). The trim reads the whole chars buffer, so any
    amount of padding cannot push a short value out of the window;
    ``judgeable`` is False only when the trimmed row overruns max_len.

    The reference finds the next and previous non-whitespace byte with
    whole-buffer min/max scans; here the same indices come from the
    positions of the non-whitespace bytes (``nonzero``) and their running
    count (``cumsum``). Its clipped reads are kept: an empty row at the
    very end of the buffer reads the buffer's last byte."""
    col = _arrow(col)
    offsets, chars = col.data, col.chars
    n = col.size
    dev = offsets.device
    total = int(chars.shape[0])
    mat = torch.full((max_len, n), _SPACE, dtype=torch.uint8, device=dev)
    if total == 0:
        lengths = torch.zeros((n,), dtype=torch.int32, device=dev)
        return mat, lengths, torch.ones((n,), dtype=torch.bool, device=dev)
    starts, ends = offsets[:-1], offsets[1:]
    nonws = chars > 0x20
    where_nonws = torch.nonzero(nonws).flatten().to(torch.int32)
    k = int(where_nonws.shape[0])
    seen = torch.cumsum(nonws, 0, dtype=torch.int32)  # non-ws at <= i
    si = starts.clamp(0, total - 1).to(torch.int64)
    ei = (ends - 1).clamp(0, total - 1).to(torch.int64)
    before = seen[si] - nonws[si].to(torch.int32)  # non-ws at < start
    if k:
        nxt = torch.where(before < k,
                          where_nonws[before.clamp(max=k - 1)], total)
        upto = seen[ei]
        prv = torch.where(upto > 0, where_nonws[(upto - 1).clamp(min=0)], -1)
    else:
        nxt = torch.full((n,), total, dtype=torch.int32, device=dev)
        prv = torch.full((n,), -1, dtype=torch.int32, device=dev)
    s_eff = torch.minimum(nxt, ends)
    e_eff = torch.where(ends > starts, torch.minimum(prv + 1, ends), starts)
    lengths = (e_eff - s_eff).clamp(min=0).to(torch.int32)
    for j in range(max_len):
        byte = chars[(s_eff + j).clamp(0, total - 1)]
        mat[j] = byte.masked_fill_(lengths <= j, _SPACE)
    return mat, lengths, lengths <= max_len


class _DigitField:
    """Per-position digit classification of rows restricted to ``mask``
    positions, and a parser of the digits in [lo, hi)."""

    def __init__(self, mat: torch.Tensor, in_mask):
        self.is_digit = [in_mask[j] & (mat[j] >= ord("0"))
                         & (mat[j] <= ord("9")) for j in range(len(mat))]
        self.digit = [torch.where(self.is_digit[j], mat[j] - ord("0"), 0)
                      .to(torch.int64) for j in range(len(mat))]
        self.p10 = _pow10_i64(mat.device)

    def field(self, lo: torch.Tensor, hi: torch.Tensor):
        """(int32 value of the digits in [lo, hi), all of them digits and
        at least one position)."""
        n = lo.shape[0]
        dev = lo.device
        ok = torch.ones((n,), dtype=torch.bool, device=dev)
        seen = torch.zeros((n,), dtype=torch.bool, device=dev)
        val = torch.zeros((n,), dtype=torch.int64, device=dev)
        for j in range(len(self.digit)):
            sel = (lo <= j) & (hi > j)
            ok &= ~sel | self.is_digit[j]
            seen |= sel
            p = (hi - 1 - j).clamp(0, 63).to(torch.int64)
            val += torch.where(sel, self.digit[j] * self.p10[p], 0)
        return val.to(torch.int32), ok & seen


def _parse_civil_date(mat: torch.Tensor, lengths: torch.Tensor,
                      date_len: torch.Tensor):
    """'yyyy-[M]M-[d]d' in [0, date_len) of each row -> (int32 days,
    ok): a 4-digit year, 1-2 digit month and day, calendar-checked."""
    w, n = mat.shape
    dev = mat.device
    in_date = [(lengths > j) & (date_len > j) for j in range(w)]
    fields = _DigitField(mat, in_date)
    is_dash = [in_date[j] & (mat[j] == ord("-")) for j in range(w)]
    n_dash = torch.zeros((n,), dtype=torch.int32, device=dev)
    for j in range(w):
        n_dash += is_dash[j].to(torch.int32)
    # the first dash past position 4, else 0 (an argmax of all False)
    dash2 = _first_where([m if j > 4 else torch.zeros_like(m)
                          for j, m in enumerate(is_dash)], n, 0, dev)
    zeros = torch.zeros_like(date_len)
    year, y_ok = fields.field(zeros, zeros + 4)
    month, m_ok = fields.field(zeros + 5, dash2)
    day, d_ok = fields.field(dash2 + 1, date_len)
    gap = date_len - dash2
    dash_ok = ((n_dash == 2) & is_dash[4] & (dash2 > 5) & (dash2 <= 7)
               & (gap >= 2) & (gap <= 3) & (date_len >= 8)
               & (date_len <= 10))
    month_ok = (month >= 1) & (month <= 12)
    leap = ((year % 4 == 0) & (year % 100 != 0)) | (year % 400 == 0)
    dim_table = _table("days_in_month", dev, lambda: np.array(
        _DAYS_IN_MONTH, np.int32))
    dim = dim_table[month.clamp(0, 12).to(torch.int64)]
    dim = torch.where((month == 2) & leap, 29, dim)
    day_ok = (day >= 1) & (day <= dim)
    ok = dash_ok & y_ok & m_ok & d_ok & month_ok & day_ok
    return days_from_civil(year, month, day).to(torch.int32), ok


def string_to_date(col: Column) -> Column:
    """STRING 'yyyy-[M]M-[d]d' -> TIMESTAMP_DAYS (Spark date cast):
    trimmed, then a 4-digit year and 1-2 digit month and day with real
    calendar checks; anything else is null."""
    if not col.dtype.is_string:
        raise TypeError("string_to_date requires a STRING column")
    mat, lengths, judgeable = _trimmed_matrix(col, 16)
    days, ok = _parse_civil_date(mat, lengths, lengths)
    ok = ok & col.valid_mask() & judgeable & (lengths <= 10)
    return Column(t.TIMESTAMP_DAYS, torch.where(ok, days, 0), ok)


def string_to_timestamp(col: Column) -> Column:
    """STRING 'yyyy-[M]M-[d]d[ |T][H]H:[m]m:[s]s[.fraction]' ->
    TIMESTAMP_MICROSECONDS (UTC, no zone suffix). A bare date is
    midnight; a fraction carries 1-6 digits (more is null, not
    truncated)."""
    if not col.dtype.is_string:
        raise TypeError("string_to_timestamp requires a STRING column")
    mat, lengths, judgeable = _trimmed_matrix(col, 32)
    w, n = mat.shape
    dev = mat.device
    present = [lengths > j for j in range(w)]
    # the date/time separator: the first ' ' or 'T' of the trimmed row
    sep_mask = [present[j] & ((mat[j] == ord(" ")) | (mat[j] == ord("T")))
                for j in range(w)]
    has_sep = torch.stack(sep_mask).any(0)
    sep = _first_where(sep_mask, n, lengths, dev)
    days, date_ok = _parse_civil_date(mat, lengths, sep)

    in_time = [present[j] & (sep < j) for j in range(w)]
    fields = _DigitField(mat, in_time)
    is_colon = [in_time[j] & (mat[j] == ord(":")) for j in range(w)]
    n_colon = torch.zeros((n,), dtype=torch.int32, device=dev)
    for j in range(w):
        n_colon += is_colon[j].to(torch.int32)
    c1 = _first_where(is_colon, n, w, dev)
    c2 = _first_where([is_colon[j] & (c1 < j) for j in range(w)], n, w, dev)
    dot_mask = [in_time[j] & (mat[j] == ord(".")) for j in range(w)]
    has_dot = torch.stack(dot_mask).any(0)
    dot = _first_where(dot_mask, n, lengths, dev)

    sec_end = torch.minimum(dot, lengths)
    hh, h_ok = fields.field(sep + 1, c1)
    mm, mi_ok = fields.field(c1 + 1, c2)
    ss, s_ok = fields.field(c2 + 1, sec_end)
    frac_digits = lengths - dot - 1
    fr, f_ok = fields.field(dot + 1, lengths)
    # the fraction scaled to microseconds by its digit count
    fscale = _pow10_i64(dev)[(6 - frac_digits).clamp(0, 6).to(torch.int64)]
    micros_frac = torch.where(has_dot, fr.to(torch.int64) * fscale, 0)
    f_ok = torch.where(has_dot, f_ok & (frac_digits >= 1)
                       & (frac_digits <= 6), True)

    def width_ok(lo, hi, wmin, wmax):
        width = hi - lo
        return (width >= wmin) & (width <= wmax)

    time_shape_ok = (
        (n_colon == 2)
        & width_ok(sep + 1, c1, 1, 2)
        & width_ok(c1 + 1, c2, 1, 2)
        & width_ok(c2 + 1, sec_end, 1, 2)
        & h_ok & mi_ok & s_ok & f_ok
        & (hh >= 0) & (hh <= 23) & (mm >= 0) & (mm <= 59)
        & (ss >= 0) & (ss <= 59))
    time_micros = ((hh.to(torch.int64) * 3600 + mm.to(torch.int64) * 60
                    + ss.to(torch.int64)) * 1_000_000 + micros_frac)
    time_value = torch.where(has_sep, time_micros, 0)
    time_valid = torch.where(has_sep, time_shape_ok, True)
    ok = col.valid_mask() & judgeable & date_ok & time_valid
    micros = days.to(torch.int64) * 86_400_000_000 + time_value
    return Column(t.TIMESTAMP_MICROSECONDS, torch.where(ok, micros, 0), ok)


def string_to_boolean(col: Column) -> Column:
    """STRING -> BOOL8 (Spark cast): case-insensitive t/true/y/yes/1 and
    f/false/n/no/0 after the trim; anything else is null."""
    if not col.dtype.is_string:
        raise TypeError("string_to_boolean requires a STRING column")
    mat, lengths, judgeable = _trimmed_matrix(col, 8)
    lower = [torch.where(lengths > j, _lower(mat[j]), mat[j])
             for j in range(len(mat))]

    def is_word(word: bytes) -> torch.Tensor:
        ok = lengths == len(word)
        for i, b in enumerate(word):
            ok = ok & (lower[i] == b)
        return ok

    truthy = (is_word(b"t") | is_word(b"true") | is_word(b"y")
              | is_word(b"yes") | is_word(b"1"))
    falsy = (is_word(b"f") | is_word(b"false") | is_word(b"n")
             | is_word(b"no") | is_word(b"0"))
    ok = col.valid_mask() & judgeable & (truthy | falsy)
    return Column(t.BOOL8, truthy.to(torch.uint8), ok)
