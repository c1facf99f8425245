"""Exact DECIMAL128 arithmetic for the aggregates (counterpart of the
limb helpers in ``spark_rapids_jni_tpu/ops/groupby.py``): the 128-bit
sum's 32-bit limb lanes and their carry recombination, the exact mean by
long division, and the base-2^16 limb arithmetic of the exact variance
and covariance numerators.

A value is a two's-complement (lo, hi) int64 pair. Everything here is
int64 arithmetic: torch has no uint64 kernels on CUDA, so where the
reference computes in uint64 the limbs here are masked int64 fields
(an arithmetic shift followed by a mask gives the same field as a
logical one), and the long division runs on 32-bit limbs whose
intermediates stay below 2^63 (see :func:`_mean128_exact`).
"""

from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF
_M16 = 0xFFFF
# the long division's count bound: (r << 32) | limb stays below 2^63
# while r < count <= 2^31 - 1
_MAX_COUNT = (1 << 31) - 1


def split_sum128_lanes(lo: torch.Tensor, hi: torch.Tensor) -> list:
    """Four 32-bit limb lanes of a masked (lo, hi) int64 pair: int64
    lane sums over up to 2^31 rows cannot overflow. Shared by the groupby
    and the reduction exact-SUM paths."""
    return [sum128_lane(lo, hi, k) for k in range(4)]


def sum128_lane(lo: torch.Tensor, hi: torch.Tensor, k: int) -> torch.Tensor:
    """Lane ``k`` of :func:`split_sum128_lanes` alone (the groupby builds
    and reduces one lane at a time)."""
    if k == 0:
        return lo & _M32
    if k == 1:
        return (lo >> 32) & _M32
    if k == 2:
        return hi & _M32
    return hi >> 32


def recombine_sum128(s0, s1, s2, s3):
    """(lo, hi, overflow) from four limb-lane sums: carry recombination
    with the signed-128-bit overflow check (``top`` must be the sign
    extension of its own low 32 bits)."""
    c0 = s0 & _M32
    t = s1 + (s0 >> 32)
    lo = c0 | ((t & _M32) << 32)
    u = s2 + (t >> 32)
    top = s3 + (u >> 32)
    hi = (u & _M32) + (top << 32)
    ovf = top != ((top << 32) >> 32)
    return lo, hi, ovf


def _magnitude(lo: torch.Tensor, hi: torch.Tensor):
    """(|v| lo, |v| hi, negative): the two's-complement negation where
    negative, in wrapping int64 (the magnitude of -2^127 is 2^127, whose
    hi word reads as INT64_MIN and is used only through masked fields)."""
    neg = hi < 0
    nlo = ~lo + 1
    nhi = ~hi + (lo == 0).to(torch.int64)
    return torch.where(neg, nlo, lo), torch.where(neg, nhi, hi), neg


def _mean128_exact(lo: torch.Tensor, hi: torch.Tensor, count: torch.Tensor):
    """Exact DECIMAL128 mean: (S * 10^4) / count with HALF_UP rounding,
    in integer limb arithmetic only. ``lo``/``hi`` are the exact 128-bit
    group sums, ``count`` the per-group non-null counts.

    The reference divides 32-bit limbs in uint64, which holds counts up
    to 2^32 - 1. In int64, ``(r << 32) | t`` stays below 2^63 only while
    the remainder r < count <= 2^31 - 1, so a count past that is guarded
    explicitly: its mean is null and flagged, never wrapped. No group of
    an input below 2^31 rows has such a count.

    Returns (limbs (m, 2) int64, overflow bool[m]): overflow when the
    widened value exceeds signed 128 bits (Spark ANSI: null + flag)."""
    mlo, mhi, neg = _magnitude(lo, hi)
    m = [mlo & _M32, (mlo >> 32) & _M32, mhi & _M32, (mhi >> 32) & _M32]

    # |S| * 10^4 with carry propagation (limb * 1e4 < 2^46)
    t, carry = [], torch.zeros_like(mlo)
    for limb in m:
        cur = limb * 10_000 + carry
        t.append(cur & _M32)
        carry = cur >> 32
    t.append(carry)  # 5th limb

    count_too_big = count > _MAX_COUNT
    c = torch.where(count_too_big, 1, count).clamp(min=1)
    # + c//2: HALF_UP (away from zero on the magnitude)
    add = c >> 1
    for i in range(5):
        cur = t[i] + add
        t[i] = cur & _M32
        add = cur >> 32

    # long division top -> bottom
    q = [None] * 5
    r = torch.zeros_like(mlo)
    for i in range(4, -1, -1):
        cur = (r << 32) | t[i]
        q[i] = torch.div(cur, c, rounding_mode="floor")
        r = cur - q[i] * c
    overflow = (q[4] != 0) | ((q[3] >> 31) != 0) | count_too_big

    qlo = q[0] | (q[1] << 32)
    qhi = q[2] | (q[3] << 32)
    rlo = torch.where(neg, ~qlo + 1, qlo)
    rhi = torch.where(neg, ~qhi + (qlo == 0).to(torch.int64), qhi)
    return torch.stack([rlo, rhi], dim=-1), overflow


# ---- exact variance / covariance: base-2^16 limb arithmetic ---------------
#
# var_samp over unscaled 128-bit integers U is
#     (n * ΣU² − (ΣU)²) / (n(n−1)) * 10^(2·scale)
# with the numerator computed EXACTLY in 16-bit limbs (up to 2^316) and
# rounded to float64 once at the end. 16-bit limbs keep every
# intermediate inside int64: per-row squared limbs are < 2^16, so
# per-group lane sums are < 2^16·n ≤ 2^47; convolution partial sums are
# < 24·2^32 < 2^37; limb×count products are < 2^47.


def _i128_mag_limbs16(lo: torch.Tensor, hi: torch.Tensor):
    """(8 magnitude limbs base 2^16, int64 each in [0, 2^16)) plus the
    negative mask of a two's-complement (lo, hi) int64 pair."""
    mlo, mhi, neg = _magnitude(lo, hi)
    limbs = [(mlo >> (16 * k)) & _M16 for k in range(4)]
    limbs += [(mhi >> (16 * k)) & _M16 for k in range(4)]
    return limbs, neg


def _carry_norm16(vals: list, width: int):
    """Carry-normalize base-2^16 limbs (possibly signed / un-normalized
    int64) into ``width`` limbs in [0, 2^16) + the final arithmetic carry
    (0 when the value is non-negative and fits; -1 when negative)."""
    carry = 0
    out = []
    for k in range(width):
        v = (vals[k] + carry) if k < len(vals) else carry
        out.append(v & _M16)
        carry = v >> 16  # arithmetic shift == floor division
    return out, carry


def _negate_limbs16_if(limbs: list, neg: torch.Tensor) -> list:
    """Two's-complement negate a normalized limb vector where ``neg``."""
    out = []
    carry = 1
    for limb in limbs:
        v = (_M16 - limb) + carry
        out.append(torch.where(neg, v & _M16, limb))
        carry = v >> 16
    return out


def _conv_limbs16(a: list, b: list) -> list:
    """Un-normalized convolution c_p = Σ_{i+j=p} a_i·b_j (schoolbook
    multiply of two normalized limb vectors)."""
    c = [None] * (len(a) + len(b) - 1)
    for i, ai in enumerate(a):
        for j, bj in enumerate(b):
            t = ai * bj
            c[i + j] = t if c[i + j] is None else c[i + j] + t
    return c


def conv_norm16_stream(a: list, b: list, width: int):
    """The normalized limbs of a·b, ``_carry_norm16(_conv_limbs16(a, b),
    width)``, yielded one at a time: per-row limb vectors of n rows each
    are reduced and freed before the next is built."""
    carry = None
    for p in range(width):
        v = None
        for i in range(len(a)):
            if 0 <= p - i < len(b):
                t = a[i] * b[p - i]
                v = t if v is None else v + t
        if v is None:
            v = torch.zeros_like(a[0])
        if carry is not None:
            v = v + carry
        yield v & _M16
        carry = v >> 16


def _sub_limbs16(a: list, b: list) -> list:
    """Exact a − b over normalized limb vectors, a ≥ b."""
    out = []
    borrow = 0
    for x, y in zip(a, b):
        v = x - y - borrow
        out.append(v & _M16)
        borrow = (v < 0).to(torch.int64)
    return out


def _limbs16_to_f64(limbs: list) -> torch.Tensor:
    """Round a normalized limb vector to float64 (top-down fold: one
    rounding per limb)."""
    acc = torch.zeros_like(limbs[-1], dtype=torch.float64)
    for limb in reversed(limbs):
        acc = acc * 65536.0 + limb.to(torch.float64)
    return acc


def _cmp_limbs16(a: list, b: list) -> torch.Tensor:
    """int32 sign of (a - b) over equal-length normalized limb vectors."""
    cmp = torch.zeros_like(a[0], dtype=torch.int32)
    for x, y in zip(reversed(a), reversed(b)):
        here = torch.sign(x - y).to(torch.int32)
        cmp = torch.where(cmp != 0, cmp, here)
    return cmp


def _add_limbs16(a: list, b: list) -> list:
    """Exact a + b over normalized limb vectors (same length; the caller
    sizes them so the sum cannot carry out of the top limb)."""
    out = []
    carry = 0
    for x, y in zip(a, b):
        v = x + y + carry
        out.append(v & _M16)
        carry = v >> 16
    return out


def _signed_sub_limbs16(a_mag: list, a_neg: torch.Tensor,
                        b_mag: list, b_neg: torch.Tensor):
    """Sign-magnitude a − b over normalized limb vectors: returns
    (magnitude limbs, negative mask)."""
    same_sign = a_neg == b_neg
    a_ge = _cmp_limbs16(a_mag, b_mag) >= 0  # |a| >= |b|
    big = [torch.where(a_ge, x, y) for x, y in zip(a_mag, b_mag)]
    small = [torch.where(a_ge, y, x) for x, y in zip(a_mag, b_mag)]
    diff = _sub_limbs16(big, small)
    added = _add_limbs16(a_mag, b_mag)
    mag = [torch.where(same_sign, d, s) for d, s in zip(diff, added)]
    # same signs: the dominant operand's sign (a's, or -b's); opposite
    # signs: the magnitudes add under a's sign
    neg = torch.where(same_sign, torch.where(a_ge, a_neg, ~b_neg), a_neg)
    is_zero = torch.ones_like(a_neg)
    for limb in mag:
        is_zero = is_zero & (limb == 0)
    return mag, neg & ~is_zero


def var128_numerator(s_lanes: list, q_lanes: list,
                     count: torch.Tensor) -> torch.Tensor:
    """n·ΣU² − (ΣU)² rounded to float64 once, from the 8 signed limb-lane
    sums of ΣU and the 16 limb-lane sums of ΣU²."""
    # exact ΣU: 12 normalized limbs + sign (|ΣU| < 2^159)
    sl, s_carry = _carry_norm16(s_lanes, 12)
    sl = _negate_limbs16_if(sl, s_carry < 0)
    bsq, _ = _carry_norm16(_conv_limbs16(sl, sl), 24)
    ql, _ = _carry_norm16(q_lanes, 20)
    nq, _ = _carry_norm16([q * count for q in ql], 24)
    # ≥ 0 by Cauchy–Schwarz: exact subtraction
    return _limbs16_to_f64(_sub_limbs16(nq, bsq))
