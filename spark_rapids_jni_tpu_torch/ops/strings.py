"""String columns in the relational core (counterpart of part of
``spark_rapids_jni_tpu/ops/strings.py``): the two layouts and the
conversions between them, sort keys and row equality, the row gather,
and the search predicates (``contains``, ``starts_with``,
``ends_with``, SQL ``like``).

- Arrow layout (offsets int32[n+1], chars uint8[m]) at rest;
- padded layout (lengths int32[n], chars uint8[n, W]) for relational
  ops. W is the column's longest row unless the caller passes a width.
  Every op here is a dense pass over the (n, W) matrix.

``pad_strings`` without ``width=`` reads the offsets to the host for the
longest row: on the card that is a device sync. The reference took it
outside jit; the plans that pad inside a timed run keep it, since the
padded width decides the null-slot bytes and the sort-key word count.

The string xxhash (Spark's hashUnsafeBytes) hashes a position-major
(W, n) byte image, one 1-D lane per byte position. Substring, case
mapping and the regex functions are not ported yet (ROADMAP.md Queue 1
entry 7).
"""

from __future__ import annotations

import numpy as np
import torch

from spark_rapids_jni_tpu_torch.columnar import Column
from spark_rapids_jni_tpu_torch.ops._xxh64 import (
    P1, P2, P3, P4, P5, avalanche, rotl,
)
from spark_rapids_jni_tpu_torch.types import BOOL8, STRING


# ---- layout -----------------------------------------------------------------

def is_padded(col: Column) -> bool:
    """True when a string column carries the padded (n, W) layout."""
    return col.is_padded_string


def max_string_width(col: Column) -> int:
    """The longest row's byte length (0 for an all-empty column); for an
    Arrow column a device-to-host read of the offsets."""
    if is_padded(col):
        return int(col.chars.shape[1])
    offsets = col.data
    if offsets.shape[0] <= 1:
        return 0
    return int((offsets[1:] - offsets[:-1]).max())


def pad_strings(col: Column, width: int | None = None) -> Column:
    """Arrow -> padded layout. ``width`` must be >= every row length
    (default: the longest row, read on the host); it is at least 1.
    Bytes past a row's length are zero."""
    if is_padded(col):
        return col
    if width is None:
        width = max_string_width(col)
    width = max(int(width), 1)
    offsets, chars = col.data, col.chars
    n = int(offsets.shape[0]) - 1
    dev = offsets.device
    if n == 0 or int(chars.shape[0]) == 0:
        return Column(STRING, torch.zeros((n,), dtype=torch.int32, device=dev),
                      col.validity,
                      chars=torch.zeros((n, width), dtype=torch.uint8,
                                        device=dev))
    starts = offsets[:-1]
    lengths = offsets[1:] - starts
    jdx = torch.arange(width, dtype=torch.int32, device=dev)
    idx = (starts[:, None] + jdx[None, :]).clamp_(0, int(chars.shape[0]) - 1)
    mat = chars[idx]
    mat.masked_fill_(jdx[None, :] >= lengths[:, None], 0)
    return Column(STRING, lengths, col.validity, chars=mat)


def unpad_strings(col: Column) -> Column:
    """Padded -> Arrow layout. The chars buffer has the static bound n*W
    bytes; offsets[-1] is the true total and the slack bytes are zero."""
    if not is_padded(col):
        return col
    lengths, mat = col.data, col.chars
    n, width = int(mat.shape[0]), int(mat.shape[1])
    dev = lengths.device
    if n == 0:
        return Column(STRING, torch.zeros((1,), dtype=torch.int32, device=dev),
                      col.validity,
                      chars=torch.zeros((0,), dtype=torch.uint8, device=dev))
    offsets = torch.cat([torch.zeros((1,), dtype=torch.int32, device=dev),
                         torch.cumsum(lengths, 0).to(torch.int32)])
    # output byte c belongs to the row r with offsets[r] <= c <
    # offsets[r+1]; its source is mat[r, c - offsets[r]]
    c = torch.arange(max(n * width, 1), dtype=torch.int64, device=dev)
    row = torch.searchsorted(offsets[1:].to(torch.int64), c, right=True)
    row = row.clamp(0, n - 1)
    src = (row * width + c - offsets[row]).clamp(0, n * width - 1)
    chars = mat.reshape(-1)[src]
    chars.masked_fill_(c >= offsets[-1], 0)
    return Column(STRING, offsets, col.validity, chars=chars)


def static_strings(values, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(int32 lengths, uint8 (m, W) bytes) of a padded layout built on the
    host from python strings (None: an empty row), W the longest row's
    bytes (at least 1)."""
    enc = [b"" if v is None else v.encode() for v in values]
    mat = np.zeros((len(enc), max([len(b) for b in enc] + [1])), np.uint8)
    for i, b in enumerate(enc):
        mat[i, :len(b)] = np.frombuffer(b, np.uint8)
    lens = np.asarray([len(b) for b in enc], np.int32)
    return torch.from_numpy(lens).to(device), torch.from_numpy(mat).to(device)


def pad_to_common_width(cols) -> list[Column]:
    """Several string columns padded to one shared (the widest) width."""
    ps = [pad_strings(c) for c in cols]
    w = max(int(p.chars.shape[1]) for p in ps)
    return [p if int(p.chars.shape[1]) == w else Column(
        p.dtype, p.data, p.validity,
        chars=torch.nn.functional.pad(p.chars, (0, w - p.chars.shape[1])))
        for p in ps]


def gather_strings(col: Column, indices: torch.Tensor) -> Column:
    """Row gather of a string column (padded first), as the two-array
    gather of a fixed-width column; ``indices`` must be in range."""
    col = pad_strings(col)
    validity = None if col.validity is None else col.validity[indices]
    return Column(STRING, col.data[indices], validity,
                  chars=col.chars[indices])


# ---- sort keys and equality -------------------------------------------------

def packed_sort_keys(col: Column) -> list[torch.Tensor]:
    """Order-preserving keys of a string column, minor to major, each an
    int64 tensor holding a 32-bit unsigned value: [length, word_k-1, ...,
    word_0]. Word i packs bytes 4i..4i+3 big-endian, so comparing words
    is memcmp on those bytes; zero padding ties equal prefixes and the
    length breaks the tie (shorter first). That is memcmp-then-length
    order, embedded NUL bytes included."""
    col = pad_strings(col)
    mat = col.chars
    n_words = (int(mat.shape[1]) + 3) // 4
    pad = n_words * 4 - int(mat.shape[1])
    if pad:
        mat = torch.nn.functional.pad(mat, (0, pad))
    words = []
    for i in range(n_words):
        u = mat[:, 4 * i:4 * i + 4].to(torch.int64)
        words.append((u[:, 0] << 24) | (u[:, 1] << 16) | (u[:, 2] << 8)
                     | u[:, 3])
    return [col.data.to(torch.int64)] + words[::-1]


def strings_equal_prev(col: Column) -> torch.Tensor:
    """bool[n-1]: row i+1's bytes equal row i's."""
    col = pad_strings(col)
    mat, lengths = col.chars, col.data
    return (lengths[1:] == lengths[:-1]) & (mat[1:] == mat[:-1]).all(1)


# ---- variable-length xxhash64 (Spark hashUnsafeBytes) ----------------------

def position_major(col: Column) -> torch.Tensor:
    """The (W, n) uint8 image of a string column, row i's byte j at
    [j, i], zero past each row's length: one contiguous lane per byte
    position. An Arrow column is read a position at a time (W from the
    host, one read of the offsets), never through an (n, W) matrix."""
    if is_padded(col):
        return col.chars.t().contiguous()
    width = max(max_string_width(col), 1)
    offsets, chars = col.data, col.chars
    n = int(offsets.shape[0]) - 1
    img = torch.zeros((width, n), dtype=torch.uint8, device=chars.device)
    if n == 0 or int(chars.shape[0]) == 0:
        return img
    starts = offsets[:-1].to(torch.int64)
    lengths = offsets[1:] - offsets[:-1]
    last = int(chars.shape[0]) - 1
    for j in range(width):
        img[j] = chars[(starts + j).clamp_(max=last)].masked_fill_(
            lengths <= j, 0)
    return img


def _le_word(img: torch.Tensor, first: int, nbytes: int) -> torch.Tensor:
    """Each row's little-endian word of the bytes at positions
    first..first+nbytes-1 of the image, widened a byte lane at a time
    and OR-ed together (positions past the image read as 0)."""
    word = torch.zeros(img.shape[1], dtype=torch.int64, device=img.device)
    for i in range(min(nbytes, int(img.shape[0]) - first)):
        word |= img[first + i].to(torch.int64) << (8 * i)
    return word


def _byte_at(img: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Each row's byte at its own position ``pos`` (clamped into the
    image), widened to int64."""
    idx = pos.clamp(0, int(img.shape[0]) - 1)[None, :]
    return img.gather(0, idx)[0].to(torch.int64)


def xxhash64_image(img: torch.Tensor, lengths: torch.Tensor,
                   seeds: torch.Tensor) -> torch.Tensor:
    """Full XXH64 of each row's first ``lengths[i]`` bytes of the
    position-major (W, n) uint8 image, with per-row int64 seeds: the
    32-byte stripes, the 8-byte words, one 4-byte lane and the byte tail
    as masked 1-D passes (W/8 word updates, at most 3 tail bytes). Returns
    int64 lanes holding the uint64 hash bits."""
    width = int(img.shape[0])
    lengths = lengths.to(torch.int64)
    full_stripes = torch.where(lengths >= 32, lengths // 32, 0)
    h = seeds + P5
    if width >= 32:
        v = [seeds + P1 + P2, seeds + P2, seeds, seeds - P1]
        for s in range(width // 32):
            active = s < full_stripes
            for i in range(4):
                lane = _le_word(img, 32 * s + 8 * i, 8)
                v[i] = torch.where(
                    active, rotl(v[i] + lane * P2, 31) * P1, v[i])
        h_long = rotl(v[0], 1) + rotl(v[1], 7) + rotl(v[2], 12) \
            + rotl(v[3], 18)
        for vi in v:
            h_long = (h_long ^ (rotl(vi * P2, 31) * P1)) * P1 + P4
        h = torch.where(lengths >= 32, h_long, h)
    h = h + lengths

    # the 8-byte words after the stripes (a row's words lie below W/8)
    full_words = lengths // 8
    consumed = full_stripes * 4
    for w in range(width // 8):
        active = (w >= consumed) & (w < full_words)
        upd = h ^ (rotl(_le_word(img, 8 * w, 8) * P2, 31) * P1)
        h = torch.where(active, rotl(upd, 27) * P1 + P4, h)

    # one optional 4-byte lane, at the row's own offset
    has4 = (lengths % 8) >= 4
    p0 = full_words * 8
    if width >= 4:
        lane4 = _byte_at(img, p0)
        for i in range(1, 4):
            lane4 |= _byte_at(img, p0 + i) << (8 * i)
        upd = rotl(h ^ (lane4 * P1), 23) * P2 + P3
        h = torch.where(has4, upd, h)

    # the byte tail: at most 3 bytes after the words and the 4-byte lane
    tail = p0 + torch.where(has4, 4, 0)
    for b in range(min(3, width)):
        upd = rotl(h ^ (_byte_at(img, tail + b) * P5), 11) * P1
        h = torch.where(tail + b < lengths, upd, h)
    return avalanche(h)


def xxhash64_bytes(mat: torch.Tensor, lengths: torch.Tensor,
                   seeds: torch.Tensor) -> torch.Tensor:
    """XXH64 of each row's first ``lengths[i]`` bytes of the (n, W) byte
    matrix (the reference's signature; bytes past a row's length are
    never read into the hash)."""
    return xxhash64_image(mat.t().contiguous(), lengths, seeds)


def hash_string_column(col: Column, seeds: torch.Tensor) -> torch.Tensor:
    """Chainable per-row hash of a string column: XXH64 over each row's
    UTF-8 bytes with the running hash as seed; null rows pass the seed
    through (Spark's HashExpression chaining)."""
    if is_padded(col):
        lengths = col.data
    else:
        lengths = col.data[1:] - col.data[:-1]
    hashed = xxhash64_image(position_major(col), lengths, seeds)
    if col.validity is None:
        return hashed
    return torch.where(col.validity, hashed, seeds)


# ---- search predicates ------------------------------------------------------

def _needle_windows(col: Column, needle: bytes) -> torch.Tensor:
    """bool (n, W): position j starts a full match of ``needle``
    (non-empty). A shifted byte that wrapped around the row is masked by
    ``j + len(needle) <= length``."""
    assert needle, "empty needles are the caller's fast path"
    p = pad_strings(col)
    mat, lengths = p.chars, p.data
    w = int(mat.shape[1])
    f = len(needle)
    if f > w:
        return torch.zeros((p.size, w), dtype=torch.bool, device=mat.device)
    jdx = torch.arange(w, dtype=torch.int32, device=mat.device)
    win = mat == needle[0]
    for off in range(1, f):
        win &= torch.roll(mat, -off, 1) == needle[off]
    return win & (jdx[None, :] + f <= lengths[:, None])


def _bool8_result(hit: torch.Tensor, col: Column) -> Column:
    """BOOL8 predicate result; validity passes through (None stays
    None)."""
    return Column(BOOL8, hit.to(torch.uint8), col.validity)


def _all_rows(col: Column) -> torch.Tensor:
    return torch.ones((col.size,), dtype=torch.bool, device=col.data.device)


def contains(col: Column, needle: str) -> Column:
    """BOOL8: the row contains ``needle`` (an empty needle matches every
    row). Null rows stay null."""
    nb = needle.encode("utf-8")
    hit = _needle_windows(col, nb).any(1) if nb else _all_rows(col)
    return _bool8_result(hit, col)


def starts_with(col: Column, prefix: str) -> Column:
    nb = prefix.encode("utf-8")
    hit = _needle_windows(col, nb)[:, 0] if nb else _all_rows(col)
    return _bool8_result(hit, col)


def ends_with(col: Column, suffix: str) -> Column:
    nb = suffix.encode("utf-8")
    p = pad_strings(col)
    if not nb:
        hit = _all_rows(col)
    else:
        win = _needle_windows(p, nb)
        pos = (p.data - len(nb)).clamp(0, max(int(p.chars.shape[1]) - 1, 0))
        hit = torch.gather(win, 1, pos[:, None].to(torch.int64))[:, 0]
        hit = hit & (p.data >= len(nb))
    return _bool8_result(hit, col)


def _compile_like(pattern: str, escape: str):
    """A LIKE pattern as literal segments, each with the gap before it
    ((single-character count, saw '%')), and the gap after the last."""
    esc = escape.encode("utf-8")
    if len(esc) != 1:
        raise ValueError("LIKE escape must be one byte")
    segs: list[bytes] = []
    gaps: list[tuple[int, bool]] = []
    cur = bytearray()
    pend_gap = [0, False]
    pb = pattern.encode("utf-8")
    i = 0
    while i < len(pb):
        c = pb[i:i + 1]
        if c == esc:
            # the escape must be followed by %, _ or itself (Spark's
            # checkLikePattern); anything else is an invalid pattern
            nxt = pb[i + 1:i + 2]
            if not nxt or nxt not in (b"%", b"_", esc):
                raise ValueError(
                    f"invalid LIKE pattern {pattern!r}: the escape "
                    f"character must be followed by '%', '_', or the "
                    f"escape character itself")
            cur += nxt
            i += 2
            continue
        if c in (b"%", b"_"):
            if cur:
                segs.append(bytes(cur))
                gaps.append(tuple(pend_gap))
                cur = bytearray()
                pend_gap = [0, False]
            if c == b"%":
                pend_gap[1] = True
            else:
                pend_gap[0] += 1
            i += 1
            continue
        cur += c
        i += 1
    segs.append(bytes(cur))
    gaps.append(tuple(pend_gap))
    tail_gap = (0, False)
    if not segs[-1] and len(segs) > 1:
        tail_gap = gaps.pop()
        segs.pop()
    return segs, gaps, tail_gap


def like(col: Column, pattern: str, escape: str = "\\") -> Column:
    """SQL LIKE: '%' matches any run, '_' one CHARACTER, and the escape
    character makes the next '%', '_' or escape literal. The pattern
    compiles to literal segments, matched by window compares, with a
    reachability scan per gap; no per-row loop.

    '_' advances one UTF-8 character through character boundaries; '%'
    and literals are byte-exact (a valid UTF-8 literal cannot start at a
    continuation byte). In invalid UTF-8, continuation bytes (0x80-0xBF)
    always extend the character before them, as in the reference."""
    segs, gaps, tail_gap = _compile_like(pattern, escape)
    p = pad_strings(col)
    n = p.size
    w = int(p.chars.shape[1])
    dev = p.chars.device
    lengths = p.data
    jdx = torch.arange(w + 1, dtype=torch.int32, device=dev)

    if any(g[0] for g in gaps) or tail_gap[0]:
        # position j in [0, w] is a boundary iff j == 0, j == w or the
        # byte at j is not a continuation byte; one '_' moves each
        # reachable boundary to the next one (a gather of the previous
        # boundary, whose running max is torch.cummax)
        cont = (p.chars & 0xC0) == 0x80
        ones = torch.ones((n, 1), dtype=torch.bool, device=dev)
        is_b = torch.cat([ones, ~cont[:, 1:], ones], 1)
        pos_if_b = torch.where(is_b, jdx[None, :], -1)
        pb_incl = torch.cummax(pos_if_b, 1).values
        prev_b = torch.cat([torch.full((n, 1), -1, dtype=torch.int32,
                                       device=dev), pb_incl[:, :-1]], 1)
        prev_ok = is_b & (prev_b >= 0)
        prev_idx = prev_b.clamp(0, w).to(torch.int64)

        def advance_chars(r, k):
            for _ in range(k):
                r = prev_ok & torch.gather(r, 1, prev_idx)
            return r
    else:
        def advance_chars(r, k):
            return r

    def or_scan(r):
        return torch.cummax(r.to(torch.uint8), 1).values.bool()

    within = jdx[None, :] <= lengths[:, None]
    # reach[:, j]: the pattern consumed so far can end exactly at byte j
    reach = torch.zeros((n, w + 1), dtype=torch.bool, device=dev)
    reach[:, 0] = True
    for seg, (mincnt, floating) in zip(segs, gaps):
        if mincnt:
            reach = advance_chars(reach, mincnt)
        reach = reach & within
        if floating:
            reach = or_scan(reach)
        if seg:
            win = _needle_windows(p, seg)  # (n, w): a match starts at j
            ok_start = torch.cat(
                [win, torch.zeros((n, 1), dtype=torch.bool, device=dev)], 1)
            # the roll's wrap-around lands below len(seg), masked here
            moved = torch.roll(reach & ok_start, len(seg), 1)
            reach = moved & (jdx[None, :] >= len(seg))
    mincnt, floating = tail_gap
    if mincnt:
        reach = advance_chars(reach, mincnt)
    reach = reach & within
    if floating:
        hit = reach.any(1)
    else:
        hit = torch.gather(reach, 1,
                           lengths.clamp(0, w)[:, None].to(torch.int64))[:, 0]
    return _bool8_result(hit, col)
