"""String functions (counterpart of the reference's
``ops/strings_fns.py``): length, the trims, the pads, concat and
concat_ws, instr, repeat, reverse, translate, split (to LIST<STRING>, the
split+explode shape) and initcap.

Results are the reference's: padded columns of the widths it gives, the
same bytes and the same validity. Null semantics are Spark's: unary
functions keep the input's nulls; concat is null if either side is null;
concat_ws skips null operands and is never null; split of a null row is
a null list.

Either string layout is read directly: a block of rows at a time
(``strings.row_chunks``) is laid out as a (c, W) matrix, from the padded
matrix or gathered from the Arrow bytes, so no (n, W) copy of the input
is made. Per-row scans (reverse's character bounds, translate's
compaction, split's delimiter ranks) run position-major, over the
positions of a (W, c) block, never along the innermost axis. Character
semantics are exact on the device for length, instr and reverse; lpad,
rpad, translate and initcap map ASCII on the device and hand non-ASCII
data to the host, recorded in ``telemetry``.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from spark_rapids_jni_tpu_torch import telemetry
from spark_rapids_jni_tpu_torch.columnar import Column
from spark_rapids_jni_tpu_torch.ops.strings import (
    _gather_rows,
    is_padded,
    pad_strings,
    row_chunks,
    shift_block,
    take_cols,
)
from spark_rapids_jni_tpu_torch.types import INT32, LIST, STRING


def _layout(col: Column) -> tuple[torch.Tensor, int]:
    """(int32 lengths, W): the padded width the reference pads to (the
    longest row, at least 1; a host read for an Arrow column)."""
    if not col.dtype.is_string:
        raise TypeError(f"string op needs a STRING column, got {col.dtype}")
    if is_padded(col):
        return col.data, int(col.chars.shape[1])
    offsets = col.data
    if int(offsets.shape[0]) <= 1 or int(col.chars.shape[0]) == 0:
        return torch.zeros((col.size,), dtype=torch.int32,
                           device=col.device), 1
    lengths = offsets[1:] - offsets[:-1]
    return lengths, max(int(lengths.max()), 1)


def _block(col: Column, lengths: torch.Tensor, w: int, r0: int,
           r1: int) -> torch.Tensor:
    """Rows r0..r1 as a contiguous (c, w) matrix, zero past each row."""
    if is_padded(col):
        return col.chars[r0:r1]
    out = torch.zeros((r1 - r0, w), dtype=torch.uint8, device=col.device)
    if int(col.chars.shape[0]):
        jdx = torch.arange(w, dtype=torch.int32, device=col.device)
        _gather_rows(col.chars, col.data[r0:r1], lengths[r0:r1], jdx, out)
    return out


def _jdx(w: int, dev) -> torch.Tensor:
    return torch.arange(w, dtype=torch.int32, device=dev)[None, :]


def _is_cont(chars: torch.Tensor) -> torch.Tensor:
    return (chars & 0xC0) == 0x80


def _string_col(lens: torch.Tensor, chars: torch.Tensor, validity) -> Column:
    return Column(STRING, lens.to(torch.int32), validity, chars=chars)


def _empty_rows(col: Column) -> Column:
    """Every row '' (width 1), the input's nulls kept."""
    n = col.size
    return _string_col(torch.zeros((n,), dtype=torch.int32, device=col.device),
                       torch.zeros((n, 1), dtype=torch.uint8,
                                   device=col.device), col.validity)


def _host_result(col: Column, values: list) -> Column:
    return pad_strings(Column.from_pylist(values, STRING, device=col.device))


def length(col: Column) -> Column:
    """Spark ``length``: CHARACTER count (UTF-8 aware)."""
    lens, w = _layout(col)
    n = col.size
    out = torch.empty((n,), dtype=torch.int32, device=col.device)
    jdx = _jdx(w, col.device)
    for r0, r1 in row_chunks(n, w):
        blk = _block(col, lens, w, r0, r1)
        ok = (jdx < lens[r0:r1, None]) & ~_is_cont(blk)
        out[r0:r1] = ok.sum(1, dtype=torch.int32)
    return Column(INT32, out, col.validity)


def _trim_impl(col: Column, charset: str, left: bool,
               right: bool) -> Column:
    cs = charset.encode()
    if any(b >= 0x80 for b in cs):
        raise NotImplementedError(
            "trim charset must be ASCII (multi-byte trim chars need the "
            "host path)")
    lens, w = _layout(col)
    n = col.size
    out_len = torch.empty((n,), dtype=torch.int32, device=col.device)
    out = torch.empty((n, w), dtype=torch.uint8, device=col.device)
    jdx = _jdx(w, col.device)
    for r0, r1 in row_chunks(n, w):
        blk = _block(col, lens, w, r0, r1)
        ln = lens[r0:r1]
        member = torch.zeros_like(blk, dtype=torch.bool)
        for b in cs:
            member |= blk == b
        keep = ~member & (jdx < ln[:, None])
        any_keep = keep.any(1)
        if left:
            first = torch.where(keep, jdx, w).amin(1)
            start = torch.where(any_keep, first, ln)
        else:
            start = torch.zeros_like(ln)
        if right:
            last = torch.where(keep, jdx, -1).amax(1)
            end = torch.where(any_keep, last + 1, start)
        else:
            end = ln
        end = torch.maximum(end, start)
        out_len[r0:r1] = end - start
        shift_block(blk, start, end - start, out[r0:r1])
    return _string_col(out_len, out, col.validity)


def trim(col: Column, charset: str = " ") -> Column:
    """Spark ``trim``/``btrim``: strip leading+trailing charset chars."""
    return _trim_impl(col, charset, True, True)


def ltrim(col: Column, charset: str = " ") -> Column:
    return _trim_impl(col, charset, True, False)


def rtrim(col: Column, charset: str = " ") -> Column:
    return _trim_impl(col, charset, False, True)


def _ascii_only(col: Column) -> bool:
    """Host-synced check: every content byte < 0x80."""
    if not is_padded(col):
        lo, hi = col.data[[0, -1]].tolist()
        return hi <= lo or int(col.chars[lo:hi].max()) < 0x80
    lens, w = col.data, int(col.chars.shape[1])
    jdx = _jdx(w, col.device)
    ok = torch.ones((), dtype=torch.bool, device=col.device)
    for r0, r1 in row_chunks(col.size, w):
        blk = col.chars[r0:r1]
        ok &= ((jdx >= lens[r0:r1, None]) | (blk < 0x80)).all()
    return bool(ok)


_PAD_HOST_REASON = ("non-ASCII data or pad string: characters are counted "
                    "on the host")


def _pad_impl(col: Column, width: int, pad: str, left: bool) -> Column:
    """lpad/rpad, CHARACTER-counted. ASCII data + ASCII pad rides the
    device path; anything else is padded on the host (recorded)."""
    pb = pad.encode()
    lens, w = _layout(col)
    if width <= 0:
        # Spark UTF8String.lpad/rpad with len <= 0 is always ''
        return _empty_rows(col)
    if not pb:
        # Spark with an empty pad string truncates but never extends
        pb = b"\x00"  # placeholder, never used when npad clamps to 0
        can_pad = False
    else:
        can_pad = True
    if any(b >= 0x80 for b in pb) or (col.size and not _ascii_only(col)):
        telemetry.record_fallback("string_lpad" if left else "string_rpad",
                                  _PAD_HOST_REASON, rows=col.size)
        out = []
        for v in col.to_pylist():
            if v is None:
                out.append(None)
            elif len(v) >= width:
                out.append(v[:width])
            elif not pad:
                out.append(v)
            else:
                need = width - len(v)
                fill = (pad * (need // len(pad) + 1))[:need]
                out.append(fill + v if left else v + fill)
        return _host_result(col, out)
    # ASCII device path: chars == bytes
    n = col.size
    dev = col.device
    out_w = max(width, 1)
    pad_arr = torch.from_numpy(np.frombuffer(pb, np.uint8).copy()).to(dev)
    plen = len(pb)
    out_len = torch.empty((n,), dtype=torch.int32, device=dev)
    out = torch.empty((n, out_w), dtype=torch.uint8, device=dev)
    j = _jdx(out_w, dev)
    for r0, r1 in row_chunks(n, max(w, out_w)):
        blk = _block(col, lens, w, r0, r1)
        ln = lens[r0:r1]
        trunc = torch.clamp(ln, max=width)
        npad = torch.clamp(width - ln, min=0) if can_pad \
            else torch.zeros_like(ln)
        olen = torch.where(ln >= width, trunc, trunc + npad)
        if left:
            in_pad = j < npad[:, None]
            src = j - npad[:, None]
            padj = j % plen
        else:
            in_pad = (j >= trunc[:, None]) & (j < olen[:, None])
            src = j
            padj = (j - trunc[:, None]) % plen
        data = take_cols(blk, src.expand(r1 - r0, out_w))
        pad_bytes = pad_arr[padj.to(torch.int64)]
        res = torch.where(in_pad, pad_bytes, data)
        res.masked_fill_(j >= olen[:, None], 0)
        out[r0:r1] = res
        out_len[r0:r1] = olen
    return _string_col(out_len, out, col.validity)


def lpad(col: Column, width: int, pad: str = " ") -> Column:
    return _pad_impl(col, width, pad, left=True)


def rpad(col: Column, width: int, pad: str = " ") -> Column:
    return _pad_impl(col, width, pad, left=False)


def concat(a: Column, b: Column) -> Column:
    """Spark ``concat(a, b)``: null if EITHER side is null."""
    la, wa = _layout(a)
    lb, wb = _layout(b)
    n = a.size
    out_w = wa + wb
    out = torch.empty((n, out_w), dtype=torch.uint8, device=a.device)
    j = _jdx(out_w, a.device)
    for r0, r1 in row_chunks(n, out_w):
        c = r1 - r0
        ra, rb = la[r0:r1, None], lb[r0:r1, None]
        av = take_cols(_block(a, la, wa, r0, r1), j.expand(c, out_w))
        bv = take_cols(_block(b, lb, wb, r0, r1), j - ra)
        res = torch.where(j < ra, av, bv)
        res.masked_fill_(j >= ra + rb, 0)
        out[r0:r1] = res
    validity = a.valid_mask() & b.valid_mask()
    if a.validity is None and b.validity is None:
        validity = None
    return _string_col(la + lb, out, validity)


def concat_ws(sep: str, cols: Sequence[Column]) -> Column:
    """Spark ``concat_ws``: join NON-NULL operands with ``sep`` (null
    operands are skipped; the result is never null — '' when all
    operands are null)."""
    sb = sep.encode()
    slen = len(sb)
    if not cols:
        raise ValueError(
            "concat_ws needs at least one column (a zero-operand "
            "concat_ws is a planner constant, not a columnar kernel)")
    layouts = [_layout(c) for c in cols]
    n = cols[0].size
    dev = cols[0].device
    out_w = max(sum(w for _, w in layouts) + slen * max(len(cols) - 1, 0),
                1)
    sep_arr = torch.from_numpy(np.frombuffer(sb, np.uint8).copy()).to(dev) \
        if slen else None
    out_len = torch.empty((n,), dtype=torch.int32, device=dev)
    out = torch.empty((n, out_w), dtype=torch.uint8, device=dev)
    for r0, r1 in row_chunks(n, out_w):
        # each separator and piece is written at its place in the row
        # (one scatter each) into a buffer with an extra column, where
        # the masked lanes write
        c = r1 - r0
        buf = torch.zeros((c, out_w + 1), dtype=torch.uint8, device=dev)
        flat = buf.view(-1)
        base = torch.arange(c, dtype=torch.int64, device=dev)[:, None] \
            * (out_w + 1)
        dump = base + out_w
        cur = torch.zeros((c, 1), dtype=torch.int64, device=dev)
        started = torch.zeros((c, 1), dtype=torch.bool, device=dev)
        for col, (lens, w) in zip(cols, layouts):
            ok = col.valid_mask()[r0:r1, None]
            if slen:
                sep_here = started & ok
                q = torch.arange(slen, dtype=torch.int64, device=dev)[None, :]
                flat[torch.where(sep_here, base + cur + q, dump).view(-1)] = \
                    sep_arr.repeat(c)
                cur = cur + sep_here * slen
            piece_len = torch.where(ok, lens[r0:r1, None], 0)
            j = torch.arange(w, dtype=torch.int64, device=dev)[None, :]
            flat[torch.where(j < piece_len, base + cur + j, dump).view(-1)] = \
                _block(col, lens, w, r0, r1).reshape(-1)
            cur = cur + piece_len
            started = started | ok
        out[r0:r1] = buf[:, :out_w]
        out_len[r0:r1] = cur[:, 0]
    return _string_col(out_len, out, None)


def instr(col: Column, sub: str) -> Column:
    """Spark ``instr``: 1-based CHARACTER position of the first
    occurrence, 0 when absent, null for null input. Empty needle -> 1
    (Java indexOf convention)."""
    lens, w = _layout(col)
    n = col.size
    dev = col.device
    nb = sub.encode()
    if not nb:
        return Column(INT32, torch.ones((n,), dtype=torch.int32, device=dev),
                      col.validity)
    f = len(nb)
    out = torch.zeros((n,), dtype=torch.int32, device=dev)
    if f > w:
        return Column(INT32, out, col.validity)
    span = w - f + 1  # positions where the needle fits in the matrix
    jdx = _jdx(w, dev)
    for r0, r1 in row_chunks(n, w):
        blk = _block(col, lens, w, r0, r1)
        ln = lens[r0:r1, None]
        win = jdx[:, :span] + f <= ln
        for off, byte in enumerate(nb):
            win &= blk[:, off:off + span] == byte
        first = torch.where(win, jdx[:, :span], w).amin(1)
        # the character index of that byte: the non-continuation bytes
        # before it
        pre = (~_is_cont(blk) & (jdx < first[:, None])).sum(
            1, dtype=torch.int32)
        out[r0:r1] = torch.where(first < w, pre + 1, 0)
    return Column(INT32, out, col.validity)


def repeat(col: Column, k: int) -> Column:
    """Spark ``repeat(str, k)``; k <= 0 gives ''."""
    lens, w = _layout(col)
    if k <= 0:
        return _empty_rows(col)
    n = col.size
    out_w = w * k
    out = torch.empty((n, out_w), dtype=torch.uint8, device=col.device)
    j = _jdx(out_w, col.device)
    for r0, r1 in row_chunks(n, out_w):
        ln = lens[r0:r1, None]
        res = take_cols(_block(col, lens, w, r0, r1),
                        j % torch.clamp(ln, min=1))
        res.masked_fill_(j >= ln * k, 0)
        out[r0:r1] = res
    return _string_col(lens * k, out, col.validity)


def reverse(col: Column) -> Column:
    """Spark ``reverse``: CHARACTER-level reversal (multi-byte UTF-8
    sequences keep their byte order). Output byte j mirrors to e =
    len-1-j, whose character [start s, final f] gives the byte s + (f -
    e); s and f of every position come from a forward and a reverse loop
    over the positions of the (W, c) block."""
    lens, w = _layout(col)
    n = col.size
    dev = col.device
    out = torch.empty((n, w), dtype=torch.uint8, device=dev)
    jdx = _jdx(w, dev)
    pos = torch.arange(w, dtype=torch.int16, device=dev)
    for r0, r1 in row_chunks(n, w):
        blk = _block(col, lens, w, r0, r1)
        c = r1 - r0
        starts = ~_is_cont(blk.t())  # (w, c); zero padding is a start too
        s_per = torch.empty((w, c), dtype=torch.int16, device=dev)
        s_per[0] = torch.where(starts[0], 0, -1)
        for t in range(1, w):
            torch.where(starts[t], pos[t], s_per[t - 1], out=s_per[t])
        # a byte is final iff the NEXT byte starts a character (the pad
        # after the last byte is a start)
        f_per = torch.empty((w, c), dtype=torch.int16, device=dev)
        f_per[w - 1] = w - 1
        for t in range(w - 2, -1, -1):
            torch.where(starts[t + 1], pos[t], f_per[t + 1], out=f_per[t])
        mirror = (s_per + f_per - pos[:, None]).clamp_(0, w - 1).t() \
            .contiguous()
        ln = lens[r0:r1, None]
        e = (ln - 1 - jdx).clamp(0, w - 1)
        res = take_cols(blk, take_cols(mirror, e))
        res.masked_fill_(jdx >= ln, 0)
        out[r0:r1] = res
    return _string_col(lens, out, col.validity)


_TRANSLATE_HOST_REASON = ("multi-byte characters in the mapping or the "
                          "data are translated on the host")


def translate(col: Column, from_str: str, to_str: str) -> Column:
    """Spark ``translate``: per-character substitution; chars in
    ``from_str`` beyond ``to_str``'s length are DELETED. Single-byte
    (ASCII) mappings ride a device 256-entry table and a compaction of
    the kept bytes; any multi-byte character in the mapping or the data
    is translated on the host (recorded)."""
    fb, tb = from_str.encode(), to_str.encode()
    lens, w = _layout(col)
    if (any(b >= 0x80 for b in fb) or any(b >= 0x80 for b in tb)
            or (col.size and not _ascii_only(col))):
        telemetry.record_fallback("string_translate", _TRANSLATE_HOST_REASON,
                                  rows=col.size)
        table = {}
        for i, ch in enumerate(from_str):
            if ch not in table:
                table[ch] = to_str[i] if i < len(to_str) else None
        out = [None if v is None else
               "".join((table[ch] if table[ch] is not None else "")
                       if ch in table else ch for ch in v)
               for v in col.to_pylist()]
        return _host_result(col, out)
    m = np.arange(256, dtype=np.int16)
    seen = set()
    for i, b in enumerate(fb):
        if b in seen:
            continue
        seen.add(b)
        m[b] = tb[i] if i < len(tb) else -1
    n = col.size
    dev = col.device
    out = torch.empty((n, w), dtype=torch.uint8, device=dev)
    if (m >= 0).all():
        # nothing is deleted: a byte map, the lengths kept
        lut = torch.from_numpy(m.astype(np.uint8)).to(dev)
        jdx = _jdx(w, dev)
        for r0, r1 in row_chunks(n, w):
            blk = _block(col, lens, w, r0, r1)
            res = out[r0:r1]
            torch.index_select(lut, 0, blk.reshape(-1).to(torch.int32),
                               out=res.view(-1))
            res.masked_fill_(jdx >= lens[r0:r1, None], 0)
        return _string_col(lens, out, col.validity)
    tbl = torch.from_numpy(m).to(dev)
    out_len = torch.empty((n,), dtype=torch.int32, device=dev)
    pos = torch.arange(w, dtype=torch.int32, device=dev)[:, None]
    for r0, r1 in row_chunks(n, w):
        c = r1 - r0
        img = _block(col, lens, w, r0, r1).t()
        mapped = tbl[img.to(torch.int64)]
        keep = (mapped >= 0) & (pos < lens[None, r0:r1])
        # kept bytes move to the front of their row, in order: each to
        # the count of kept bytes before it (a scan over the positions);
        # the others write to an extra column
        dest = torch.cumsum(keep, 0, dtype=torch.int32) - keep.to(torch.int32)
        rows = torch.arange(c, dtype=torch.int64, device=dev)[None, :] \
            * (w + 1)
        buf = torch.zeros((c, w + 1), dtype=torch.uint8, device=dev)
        buf.view(-1)[torch.where(keep, rows + dest, rows + w).reshape(-1)] = \
            mapped.to(torch.uint8).reshape(-1)
        out[r0:r1] = buf[:, :w]
        out_len[r0:r1] = keep.sum(0, dtype=torch.int32)
    return _string_col(out_len, out, col.validity)


class SplitResult(NamedTuple):
    column: Column              # LIST<STRING>, one list per input row
    overflowed: torch.Tensor    # bool: a row had more pieces than cap


def split(col: Column, sep: str, limit: int = -1,
          max_pieces: int | None = None) -> SplitResult:
    """Spark ``split(str, sep[, limit])`` for LITERAL separators:
    LIST<STRING> with the split+explode contract.

    ``limit > 0``: at most ``limit`` pieces, the last keeps the rest
    (Java semantics) — the static piece budget is ``limit``.
    ``limit <= 0``: unbounded; the caller must pass ``max_pieces`` as
    the static budget, and rows exceeding it set ``overflowed`` (the
    shuffle-capacity posture) with their excess pieces dropped.

    The child holds the live pieces only, row by row (a null row has
    none), padded to the input's width; its size is read to the host
    once."""
    sb = sep.encode()
    if not sb:
        raise ValueError("split separator must be non-empty")
    cap = limit if limit > 0 else max_pieces
    if cap is None:
        raise ValueError(
            "split with limit <= 0 needs max_pieces (static piece budget)")
    if cap < 1:
        raise ValueError("split piece budget must be >= 1")
    lens, w = _layout(col)
    n = col.size
    dev = col.device
    f = len(sb)
    valid = col.valid_mask()
    p_start = torch.zeros((n, cap), dtype=torch.int32, device=dev)
    p_len = torch.zeros((n, cap), dtype=torch.int32, device=dev)
    npieces = torch.zeros((n,), dtype=torch.int32, device=dev)
    overflowed = torch.zeros((), dtype=torch.bool, device=dev)
    pos = torch.arange(w, dtype=torch.int32, device=dev)[:, None]
    kdx = torch.arange(cap, dtype=torch.int32, device=dev)[None, :]
    ranks = min(cap, w)  # rank k > w never exists: its position is w
    for r0, r1 in row_chunks(n, w):
        c = r1 - r0
        img = _block(col, lens, w, r0, r1).t().contiguous()
        ln = lens[r0:r1]
        hits = torch.zeros((w, c), dtype=torch.bool, device=dev)
        if f <= w:
            span = w - f + 1
            win = pos[:span] + f <= ln[None, :]
            for off, byte in enumerate(sb):
                win &= img[off:off + span] == byte
            hits[:span] = win
        if f > 1:
            # leftmost non-overlapping matches: a hit inside an earlier
            # match is dropped (a loop over the positions)
            allowed = torch.zeros((c,), dtype=torch.int32, device=dev)
            for t in range(w):
                ok = hits[t] & (allowed <= t)
                allowed = torch.where(ok, t + f, allowed)
                hits[t] = ok
        ndelim = hits.sum(0, dtype=torch.int32)
        # the position of the delimiter of rank k+1: the count of
        # positions whose running hit count is at most k (searchsorted
        # 'left' over the inclusive count)
        incl = torch.cumsum(hits, 0, dtype=torch.int32)
        dpos = torch.full((c, cap), w, dtype=torch.int32, device=dev)
        for k in range(ranks):
            dpos[:, k] = (incl <= k).sum(0, dtype=torch.int32)
        use = torch.clamp(ndelim, max=cap - 1)
        npc = torch.where(valid[r0:r1], use + 1, 0)
        if limit <= 0:
            overflowed |= (ndelim > cap - 1).any()
        starts = torch.cat([torch.zeros((c, 1), dtype=torch.int32,
                                        device=dev), dpos[:, :cap - 1] + f],
                           1)
        live = kdx < npc[:, None]
        if limit > 0:
            # Java limit semantics: the last kept piece keeps the REST
            extend = kdx == (npc - 1)[:, None]
        else:
            # cap mode: only a row's NATURAL last piece runs to the end
            extend = kdx == ndelim[:, None]
        st = torch.where(live, starts, 0)
        end = torch.where(extend, ln[:, None], torch.where(live, dpos, 0))
        p_start[r0:r1] = st
        p_len[r0:r1] = torch.clamp(end - st, min=0)
        npieces[r0:r1] = npc
    offsets = torch.cat([torch.zeros((1,), dtype=torch.int64, device=dev),
                         torch.cumsum(npieces, 0, dtype=torch.int64)])
    total = int(offsets[-1])
    child_len = torch.empty((total,), dtype=torch.int32, device=dev)
    child = torch.empty((total, w), dtype=torch.uint8, device=dev)
    jdx = torch.arange(w, dtype=torch.int32, device=dev)
    for q0, q1 in row_chunks(total, w):
        q = torch.arange(q0, q1, dtype=torch.int64, device=dev)
        row = torch.searchsorted(offsets[1:], q, right=True)
        flat = row * cap + (q - offsets[row])
        st = p_start.view(-1)[flat]
        ln = p_len.view(-1)[flat]
        child_len[q0:q1] = ln
        if is_padded(col):
            shift_block(col.chars.index_select(0, row), st, ln,
                        child[q0:q1])
        elif int(col.chars.shape[0]):
            _gather_rows(col.chars, col.data[row] + st, ln, jdx,
                         child[q0:q1])
        else:
            child[q0:q1] = 0
    lc = Column(LIST, offsets.to(torch.int32), col.validity,
                children=[_string_col(child_len, child, None)])
    return SplitResult(lc, overflowed)


_INITCAP_HOST_REASON = "non-ASCII data: words are title-cased on the host"


def initcap(col: Column) -> Column:
    """Spark ``initcap``: first letter of each SPACE-delimited word
    uppercased, every other letter lowercased — Spark's
    UTF8String.toTitleCase treats only ' ' (0x20) as a delimiter, so
    tabs/newlines do NOT start words. ASCII rides the device path;
    non-ASCII data is title-cased on the host (recorded)."""
    lens, w = _layout(col)
    if col.size and not _ascii_only(col):
        telemetry.record_fallback("string_initcap", _INITCAP_HOST_REASON,
                                  rows=col.size)
        out = []
        for v in col.to_pylist():
            if v is None:
                out.append(None)
                continue
            chars = []
            prev_sp = True
            for ch in v:
                if ch == " ":
                    chars.append(ch)
                    prev_sp = True
                else:
                    chars.append(ch.upper() if prev_sp else ch.lower())
                    prev_sp = False
            out.append("".join(chars))
        return _host_result(col, out)
    n = col.size
    out = torch.empty((n, w), dtype=torch.uint8, device=col.device)
    jdx = _jdx(w, col.device)
    for r0, r1 in row_chunks(n, w):
        blk = _block(col, lens, w, r0, r1)
        prev_ws = torch.ones_like(blk, dtype=torch.bool)
        prev_ws[:, 1:] = blk[:, :-1] == 0x20
        up = torch.where((blk >= 0x61) & (blk <= 0x7A), blk - 0x20, blk)
        low = torch.where((blk >= 0x41) & (blk <= 0x5A), blk + 0x20, blk)
        res = torch.where(prev_ws, up, low)
        res.masked_fill_(jdx >= lens[r0:r1, None], 0)
        out[r0:r1] = res
    return _string_col(lens, out, col.validity)
