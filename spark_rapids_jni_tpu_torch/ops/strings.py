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
(W, n) byte image, one 1-D lane per byte position, and so does RLIKE
(``regexp_contains``: the device DFA of ``ops/regex_device.py``, or the
host engine for what the DFA does not take). ``regexp_extract`` and
``regexp_replace`` run the linear capture engine of
``ops/regex_capture_device.py`` (or the host engine) over the padded
layout. ``substring``, ``upper`` and ``lower`` return padded columns; case mapping runs on the device
(ASCII, and ``ops/unicode_case_device.py`` for 1:1 Unicode mappings) but
for the rows with special characters, which the host maps.

Wide temporaries (an index or an int32 cell per byte) are built a block
of rows at a time (``row_chunks``): at 60M rows of 69 bytes one int32
(n, W) array would be 16.6 GB. Rows are independent, so the blocks give
the same bytes.
"""

from __future__ import annotations

import numpy as np
import torch

from spark_rapids_jni_tpu_torch import telemetry
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


ROW_CHUNK_CELLS = 1 << 27  # cells of one block of rows (see row_chunks)


def row_chunks(n: int, width: int):
    """(r0, r1) blocks of rows of about ``ROW_CHUNK_CELLS`` cells of
    ``width`` each, covering 0..n: a pass whose temporaries are per cell
    runs a block at a time, so they stay a few hundred MB at any n."""
    step = max(1, ROW_CHUNK_CELLS // max(int(width), 1))
    for r0 in range(0, n, step):
        yield r0, min(n, r0 + step)


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
    mat = torch.empty((n, width), dtype=torch.uint8, device=dev)
    for r0, r1 in row_chunks(n, width):
        _gather_rows(chars, starts[r0:r1], lengths[r0:r1], jdx,
                     mat[r0:r1])
    return Column(STRING, lengths, col.validity, chars=mat)


def _gather_rows(chars: torch.Tensor, starts: torch.Tensor,
                 lengths: torch.Tensor, jdx: torch.Tensor,
                 out: torch.Tensor) -> None:
    """out[i, j] = chars[starts[i] + j] for j < lengths[i], else 0: one
    int32-indexed gather from the Arrow bytes into the (c, W) block
    ``out`` (rows of a row-major matrix, so contiguous)."""
    idx = (starts[:, None] + jdx[None, :]).clamp_(0, int(chars.shape[0]) - 1)
    torch.index_select(chars, 0, idx.view(-1), out=out.view(-1))
    out.masked_fill_(jdx[None, :] >= lengths[:, None], 0)


def shift_block(chars: torch.Tensor, start: torch.Tensor,
                new_len: torch.Tensor, out: torch.Tensor) -> None:
    """out[i, j] = chars[i, start[i] + j] (clipped into the row) for
    j < new_len[i], else 0: one int32-indexed gather of the contiguous
    (c, W) block ``chars`` (c * W < 2^31) into the contiguous (c, W_out)
    ``out``."""
    jdx = torch.arange(out.shape[1], dtype=torch.int32, device=chars.device)
    take_cols(chars, start.to(torch.int32)[:, None] + jdx, out=out)
    out.masked_fill_(jdx >= new_len.to(torch.int32)[:, None], 0)


def take_cols(block: torch.Tensor, src: torch.Tensor,
              out: torch.Tensor | None = None) -> torch.Tensor:
    """block[i, src[i, j]] with ``src`` clipped into the row: one
    int32-indexed gather of the contiguous (c, W) ``block`` (c * W <
    2^31), any dtype; ``src`` is (c, W_out) or broadcasts to it."""
    c, w = block.shape
    rows = torch.arange(c, dtype=torch.int32, device=block.device)[:, None]
    idx = src.to(torch.int32).clamp(0, w - 1) + rows * w
    if out is None:
        return torch.index_select(block.reshape(-1), 0,
                                  idx.reshape(-1)).view(idx.shape)
    torch.index_select(block.reshape(-1), 0, idx.reshape(-1),
                       out=out.view(-1))
    return out


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
    host, one int32 gather of n bytes a position), never through an
    (n, W) matrix (a transposed copy of one was slower on the card)."""
    if is_padded(col):
        return col.chars.t().contiguous()
    width = max(max_string_width(col), 1)
    offsets, chars = col.data, col.chars
    n = int(offsets.shape[0]) - 1
    img = torch.zeros((width, n), dtype=torch.uint8, device=chars.device)
    if n == 0 or int(chars.shape[0]) == 0:
        return img
    starts = offsets[:-1]
    lengths = offsets[1:] - offsets[:-1]
    last = int(chars.shape[0]) - 1
    for j in range(width):
        torch.index_select(chars, 0, (starts + j).clamp_(max=last),
                           out=img[j])
        img[j].masked_fill_(lengths <= j, 0)
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


# ---- transforms -------------------------------------------------------------

def substring(col: Column, start: int, length: int | None = None) -> Column:
    """Byte-range substring with fixed bounds: 0-based ``start``, optional
    ``length`` (None = to the end). A negative ``start`` counts from the
    row end, Spark's substr: the end comes from the UNCLAMPED position,
    so substr('abc', -5, 2) is '' (end = -2 + 2 = 0), not 'ab'. Byte-based:
    callers keep the bounds on character boundaries of multi-byte UTF-8.
    Returns a padded column of the input's padded width."""
    if is_padded(col):
        lengths = col.data
        w = int(col.chars.shape[1])
    else:
        lengths = col.data[1:] - col.data[:-1]
        w = max(max_string_width(col), 1)
    n = int(lengths.shape[0])
    zero = torch.zeros_like(lengths)
    if start < 0:
        raw = lengths + start
        begin = torch.minimum(raw.clamp(min=0), lengths)
        if length is None:
            out_len = lengths - begin
        else:
            end = torch.minimum((raw + length).clamp(min=0), lengths)
            out_len = torch.maximum(end - begin, zero)
    else:
        begin = torch.minimum(torch.full_like(lengths, start), lengths)
        if length is None:
            out_len = lengths - begin
        else:
            out_len = torch.minimum(
                torch.full_like(lengths, max(length, 0)), lengths - begin)
    dev = lengths.device
    out = torch.zeros((n, w), dtype=torch.uint8, device=dev)
    if is_padded(col):
        jdx = torch.arange(w, dtype=torch.int64, device=dev)
        for r0, r1 in row_chunks(n, w):
            src = (begin[r0:r1, None] + jdx[None, :]).clamp_(0, w - 1)
            torch.gather(col.chars[r0:r1], 1, src, out=out[r0:r1])
            out[r0:r1].masked_fill_(jdx[None, :] >= out_len[r0:r1, None], 0)
    elif col.chars.numel():
        # straight from the Arrow bytes: row i's output starts at byte
        # offsets[i] + begin[i]
        jdx = torch.arange(w, dtype=torch.int32, device=dev)
        starts = col.data[:-1] + begin
        for r0, r1 in row_chunks(n, w):
            _gather_rows(col.chars, starts[r0:r1], out_len[r0:r1], jdx,
                         out[r0:r1])
    return Column(STRING, out_len.to(torch.int32), col.validity, chars=out)


def _host_case(col: Column, to_upper: bool) -> Column:
    """Full Unicode case mapping of the whole column on the host (Python's
    str.upper/lower: the Unicode full case mapping Java applies under
    Locale.ROOT, one-to-many expansions like ß -> SS included)."""
    vals = col.to_pylist()
    out = [None if v is None else (v.upper() if to_upper else v.lower())
           for v in vals]
    return pad_strings(Column.from_pylist(out, STRING, device=col.device))


_SPECIAL_CASE_REASON = ("special characters (one-to-many or length-changing "
                        "mappings, final sigma, astral characters, invalid "
                        "UTF-8) are mapped on the host")


def _ascii_case(col: Column, to_upper: bool) -> Column:
    p = pad_strings(col)
    mat = p.chars
    n, w = int(mat.shape[0]), int(mat.shape[1])
    if mat.numel() and int(mat.max()) >= 0x80:
        # non-ASCII: the Unicode device engine maps every row whose
        # characters have 1:1 length-preserving mappings; only rows with
        # SPECIAL characters cross to the host, and are merged back
        from spark_rapids_jni_tpu_torch.ops.unicode_case_device import (
            case_map_device,
        )

        out, row_special = case_map_device(mat, to_upper)
        if col.validity is not None:
            # null rows' bytes are don't-care: never decode them
            row_special = row_special & col.validity
        spec_idx = torch.nonzero(row_special).flatten()
        if spec_idx.numel() == 0:
            return Column(STRING, p.data, col.validity, chars=out)
        telemetry.record_fallback(
            "string_upper" if to_upper else "string_lower",
            _SPECIAL_CASE_REASON, rows=int(spec_idx.numel()))
        lens_np = p.data[spec_idx].cpu().numpy()
        spec_rows = mat[spec_idx].cpu().numpy()
        mapped_bytes = []
        for row_i in range(len(lens_np)):
            raw = spec_rows[row_i, :lens_np[row_i]].tobytes().decode()
            mapped_bytes.append(
                (raw.upper() if to_upper else raw.lower()).encode())
        w_out = max(w, max(len(b) for b in mapped_bytes))
        if w_out > w:
            out = torch.nn.functional.pad(out, (0, w_out - w))
        host_mat = np.zeros((len(mapped_bytes), w_out), np.uint8)
        host_lens = np.zeros(len(mapped_bytes), np.int32)
        for row_i, b in enumerate(mapped_bytes):
            host_mat[row_i, :len(b)] = np.frombuffer(b, np.uint8)
            host_lens[row_i] = len(b)
        out[spec_idx] = torch.from_numpy(host_mat).to(out.device)
        lengths = p.data.clone()
        lengths[spec_idx] = torch.from_numpy(host_lens).to(out.device)
        return Column(STRING, lengths, col.validity, chars=out)
    lo = ord("a") if to_upper else ord("A")
    out = torch.empty_like(mat)
    for r0, r1 in row_chunks(n, w):
        m = mat[r0:r1]
        # a letter of the other case differs in bit 5 (0x20); the uint8
        # difference wraps, so one compare finds the 26 letters
        torch.where((m - lo) < 26, m ^ 0x20, m, out=out[r0:r1])
    return Column(STRING, p.data, col.validity, chars=out)


def upper(col: Column) -> Column:
    """Spark upper: ASCII and 1:1 length-preserving Unicode mappings on
    the device; rows with special characters on the host."""
    return _ascii_case(col, True)


def lower(col: Column) -> Column:
    """Spark lower: ASCII and 1:1 length-preserving Unicode mappings on
    the device; rows with special characters on the host."""
    return _ascii_case(col, False)


# ---- regexp -----------------------------------------------------------------
#
# Two engines, as get_json_object has: patterns inside the DFA-compilable
# subset run on the device (ops/regex_device.py); the rest, and columns
# whose rows hold a NUL byte, run the host engine (Python ``re`` with
# re.ASCII, so \d/\w/\s/\b are the ASCII classes java.util.regex uses by
# default). Each host run is recorded in ``telemetry`` with its reason.


def _compile_java_regex(pattern: str):
    """Compile with re.ASCII so \\d/\\w/\\s/\\b mean what java.util.regex
    means by default ([0-9] etc.). Java-only character-class syntax that
    Python would silently mis-parse (``[a-z&&[b]]`` intersection, nested
    classes) is rejected up front."""
    import re as _re

    depth = 0
    i = 0
    while i < len(pattern):
        c = pattern[i]
        if c == "\\":
            i += 2
            continue
        if c == "[":
            if depth > 0:
                raise ValueError(
                    f"unsupported java.util.regex syntax in {pattern!r}: "
                    f"nested character class (Python re would silently "
                    f"parse it differently)")
            depth = 1
        elif c == "]" and depth:
            depth = 0
        elif depth and pattern.startswith("&&", i):
            raise ValueError(
                f"unsupported java.util.regex syntax in {pattern!r}: "
                f"character-class intersection '&&' (Python re would "
                f"silently parse it differently)")
        i += 1
    return _re.compile(pattern, _re.ASCII)


def _host_regexp(col: Column, rx, fn):
    vals = col.to_pylist()
    return [None if v is None else fn(rx, v) for v in vals]


def _nonzero_bytes(img: torch.Tensor) -> torch.Tensor:
    """int32[n]: each row's count of nonzero bytes in the (W, n) image,
    summed 8 positions at a time (no (W, n) temporary)."""
    nz = torch.zeros(img.shape[1], dtype=torch.int32, device=img.device)
    for j in range(0, int(img.shape[0]), 8):
        nz += (img[j:j + 8] != 0).sum(0, dtype=torch.int32)
    return nz


def regexp_contains(col: Column, pattern: str) -> Column:
    """RLIKE / regexp-find: BOOL8, True when the pattern matches anywhere
    in the row; null rows stay null.

    A pattern the DFA compiler takes runs on the device over the
    position-major image. The host engine runs (and is recorded) for a
    pattern outside the DFA subset, for a column with a NUL byte inside a
    row (it would alias the 0x00 sentinel; one device reduction finds
    it), and under ``regex.force_engine="host"``. With
    ``regex.force_engine="device"`` the first two raise instead."""
    from spark_rapids_jni_tpu_torch.ops import regex_device as rd
    from spark_rapids_jni_tpu_torch.utils.config import get_option

    force = get_option("regex.force_engine")
    if force == "host":
        telemetry.record_fallback(
            "regexp_contains", "regex.force_engine=host pin", rows=col.size)
    else:
        try:
            comp = rd.compile_pattern(pattern)
        except rd.RegexUnsupported as exc:
            if force == "device":
                raise
            telemetry.record_fallback(
                "regexp_contains", f"unsupported regex atom: {exc}",
                rows=col.size)
            comp = None
        if comp is not None:
            img = position_major(col)
            if is_padded(col):
                # clean: each row's nonzero bytes are exactly its length,
                # so no NUL lies inside the content (the padding is zero)
                lengths = col.data
                clean = bool((_nonzero_bytes(img) == lengths).all())
            else:
                # the rows' content is the bytes between the first and the
                # last offset: clean when none of them is zero
                lengths = col.data[1:] - col.data[:-1]
                lo, hi = col.data[[0, -1]].tolist()
                clean = hi <= lo or int(col.chars[lo:hi].min()) > 0
            if clean:
                # the widest row filling the image leaves it no sentinel
                n, w = col.size, int(img.shape[0])
                needs_pad = bool(n and int(lengths.max()) >= w)
                flags = rd.run_dfa_image(img, comp, ensure_sentinel=needs_pad)
                return Column(BOOL8, flags.to(torch.uint8), col.validity)
            if force == "device":
                raise ValueError(
                    "regex.force_engine=device but the column has "
                    "embedded NUL bytes (sentinel alias)")
            telemetry.record_fallback(
                "regexp_contains",
                "embedded NUL bytes alias the 0x00 padding sentinel",
                rows=col.size)
    rx = _compile_java_regex(pattern)
    out = _host_regexp(col, rx, lambda r, v: r.search(v) is not None)
    flags = torch.tensor([bool(v) for v in out], dtype=torch.uint8,
                         device=col.device)
    return Column(BOOL8, flags, col.validity)


# ---- regexp_extract and regexp_replace --------------------------------------
#
# Two engines, as RLIKE has: linear patterns over all-ASCII rows without
# NUL run on the device (ops/regex_capture_device.py); the rest take the
# host engine, recorded in ``telemetry`` with the reason.


def _java_replacement_to_python(rep: str, n_groups: int) -> str:
    """Java Matcher.appendReplacement syntax -> Python sub template.
    ``\\x`` in Java means LITERAL x (so ``\\n`` is the letter n, not a
    newline); ``$digits`` binds greedily to the longest prefix that is a
    valid group number <= ``n_groups`` (Java's rule — '$10' with two
    groups is group 1 then literal '0')."""
    out = []
    i = 0
    while i < len(rep):
        c = rep[i]
        if c == "\\":
            if i + 1 >= len(rep):
                raise ValueError(
                    "invalid regexp replacement: trailing backslash")
            nxt = rep[i + 1]
            out.append("\\\\" if nxt == "\\" else nxt)
            i += 2
            continue
        if c == "$":
            j = i + 1
            if j >= len(rep) or not rep[j].isdigit():
                raise ValueError(
                    f"invalid regexp replacement {rep!r}: '$' must be "
                    f"followed by a group number (escape literal '$' "
                    f"with a backslash)")
            # greedy: extend while the accumulated number stays a valid
            # group reference
            g = int(rep[j])
            j += 1
            while j < len(rep) and rep[j].isdigit() \
                    and g * 10 + int(rep[j]) <= n_groups:
                g = g * 10 + int(rep[j])
                j += 1
            if g > n_groups:
                raise ValueError(
                    f"invalid regexp replacement {rep!r}: group {g} "
                    f"exceeds the pattern's {n_groups} group(s)")
            out.append(f"\\g<{g}>")
            i = j
            continue
        out.append(c)  # backslashes were consumed by the branch above
        i += 1
    return "".join(out)


def _clean_and_widest(col: Column) -> tuple[bool, int]:
    """(every row's content bytes lie in 1..127, the longest row) with
    one host read: a padded row is clean when its zero bytes are exactly
    its padding and no byte has the high bit; an Arrow column when the
    bytes between its first and last offset are all in 1..127."""
    if is_padded(col):
        w = int(col.chars.shape[1])
        clean = torch.ones((), dtype=torch.bool, device=col.device)
        for r0, r1 in row_chunks(col.size, w):
            blk = col.chars[r0:r1]
            zeros = (blk == 0).sum(1, dtype=torch.int32)
            clean &= (zeros == w - col.data[r0:r1]).all() \
                & (blk.max() < 0x80)
        flag, widest = torch.stack(
            [clean.to(torch.int64), col.data.max().to(torch.int64)]).tolist()
        return bool(flag), widest
    offsets = col.data
    widest, lo, hi = torch.stack([(offsets[1:] - offsets[:-1]).max(),
                                  offsets[0], offsets[-1]]).tolist()
    # uint8 wraps: 0 - 1 = 255 fails the test, so NUL is refused too
    return hi <= lo or bool(((col.chars[lo:hi] - 1) < 127).all()), widest


def _device_capture_eligible(col: Column, pattern: str, op: str):
    """Shared extract/replace device-path gate: the pattern parses into
    the linear capture subset AND the column is all-ASCII with no
    embedded NULs (byte-level ``.``/negated classes equal char-level
    exactly on ASCII data; NULs alias the padding sentinel). Returns
    (compiled, padded_col) or (None, None) for host fallback; respects
    ``regex.force_engine`` like regexp_contains. Every (None, None)
    return records a telemetry fallback under ``op``. The padded column
    gets a zero column past its width when the widest row fills it (the
    walk reads positions up to W inclusive); two host reads (the width
    and the cleanliness check; one for a padded column)."""
    from spark_rapids_jni_tpu_torch.ops import regex_capture_device as rc
    from spark_rapids_jni_tpu_torch.utils.config import get_option

    force = get_option("regex.force_engine")
    if force == "host":
        telemetry.record_fallback(
            op, "regex.force_engine=host pin", rows=col.size)
        return None, None
    try:
        comp = rc.compile_linear(pattern)
    except rc.RegexUnsupported as exc:
        if force == "device":
            raise
        telemetry.record_fallback(
            op, f"unsupported linear-capture atom: {exc}", rows=col.size)
        return None, None
    if col.size == 0:
        telemetry.record_fallback(
            op, "empty column: no rows to run on device", rows=0)
        return None, None
    clean, widest = _clean_and_widest(col)
    if not clean:
        if force == "device":
            raise ValueError(
                "regex.force_engine=device but the column has embedded "
                "NULs or non-ASCII bytes (outside the capture engine's "
                "correctness scope)")
        telemetry.record_fallback(
            op,
            "embedded NULs or non-ASCII bytes (sentinel alias / outside "
            "the byte-level capture engine's correctness scope)",
            rows=col.size)
        return None, None
    w = int(col.chars.shape[1]) if is_padded(col) else max(widest, 1)
    w_eff = w + 1 if widest >= w else w
    if not is_padded(col):
        return comp, pad_strings(col, width=w_eff)
    if w_eff > w:
        col = Column(STRING, col.data, col.validity,
                     chars=torch.nn.functional.pad(col.chars, (0, 1)))
    return comp, col


def regexp_extract(col: Column, pattern: str, group: int = 1) -> Column:
    """Spark regexp_extract: the group'th capture of the first match,
    '' when the pattern does not match (Spark returns empty string, not
    null). Linear patterns over ASCII rows run on the device
    (``ops/regex_capture_device.py``); the rest take the host engine.
    Returns a padded column."""
    rx = _compile_java_regex(pattern)
    if not 0 <= group <= rx.groups:
        # validate up front like regexp_replace — otherwise an invalid
        # index only crashes on rows that happen to match (Spark raises)
        raise ValueError(
            f"regexp_extract group {group} out of range: pattern has "
            f"{rx.groups} group(s)")
    comp, pc = _device_capture_eligible(col, pattern, "regexp_extract")
    if comp is not None:
        from spark_rapids_jni_tpu_torch.ops import regex_capture_device as rc

        lengths, chars = rc.extract_device(pc.chars, comp, group)
        return Column(STRING, lengths, pc.validity, chars=chars)

    def ext(r, v):
        m = r.search(v)
        if m is None:
            return ""
        g = m.group(group)
        return "" if g is None else g

    out = _host_regexp(col, rx, ext)
    return pad_strings(Column.from_pylist(out, STRING, device=col.device))


def regexp_replace(col: Column, pattern: str, replacement: str) -> Column:
    """Spark regexp_replace: every match replaced; Java $N group refs
    (greedy multi-digit) and \\x literal escapes supported.

    Literal replacements of linear patterns over ASCII rows run on the
    device in at most 8 match rounds; a row with more matches sends the
    whole column to the host engine (one host read of the overflow
    flag). Group-ref replacements, patterns that match the empty string
    at every position, and the rest take the host engine. Returns a
    padded column."""
    rx = _compile_java_regex(pattern)
    rep = _java_replacement_to_python(replacement, rx.groups)
    literal_rep = "$" not in replacement and "\\" not in replacement
    if literal_rep:
        comp, pc = _device_capture_eligible(col, pattern, "regexp_replace")
        if comp is not None and all(
                el.lo == 0 for el in comp.pattern.elements):
            # a pattern that can match empty matches at EVERY position:
            # any row longer than the round budget is guaranteed to
            # overflow, so the device pass would be dead work
            telemetry.record_fallback(
                "regexp_replace",
                "empty-matching pattern: every position matches, device "
                "round budget would always overflow", rows=col.size)
            comp = None
        if comp is not None:
            from spark_rapids_jni_tpu_torch.ops import (
                regex_capture_device as rc,
            )

            out_len, out_chars, overflowed = rc.replace_device(
                pc.chars, pc.data, comp, replacement.encode())
            if not bool(overflowed):
                return Column(STRING, out_len, pc.validity,
                              chars=out_chars)
            telemetry.record_fallback(
                "regexp_replace",
                "match-round budget overflow: a row exceeded the device "
                "replace rounds; rerouting whole column to host",
                rows=col.size)
    else:
        telemetry.record_fallback(
            "regexp_replace",
            "group-ref/escape replacement: device engine handles literal "
            "replacements only", rows=col.size)
    out = _host_regexp(col, rx, lambda r, v: r.sub(rep, v))
    return pad_strings(Column.from_pylist(out, STRING, device=col.device))
