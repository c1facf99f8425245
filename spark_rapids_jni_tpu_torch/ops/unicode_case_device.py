"""Device Unicode case mapping over the padded char matrix (counterpart
of the reference's ``ops/unicode_case_device.py``).

The common case, BMP characters whose case mapping is 1:1 and keeps its
UTF-8 length (Latin-1 and Extended, Greek, Cyrillic, full-width forms,
...), runs on the device as byte-parallel table lookups. A row holding a
SPECIAL character (a 1:N expansion like ß -> SS, a length-changing map
like ı -> I, a supplementary-plane character, capital sigma for lower,
or invalid UTF-8) is flagged, and ``ops.strings`` maps those rows on the
host and merges them back.

Per position: classify by lead byte (ASCII, 2-byte lead 0xC2-0xDF,
3-byte lead 0xE0-0xEF, continuation, 4-byte lead, always special);
decode the codepoint at lead positions from the lead and its shifted
continuations; look it up in a 64Ki-entry map built on the host from
Python's str.upper / str.lower (the Unicode tables Java applies under
Locale.ROOT) and in a parallel SPECIAL table; re-encode in place, each
continuation byte taking its lead's re-encoded byte. The tables come
from the interpreter's Unicode database (``unicodedata.unidata_version``),
so two machines agree only when their versions do.

The reference's int32 (n, W) arrays are built a block of rows at a time
(``strings.row_chunks``); rows are independent, so the bytes are the
same.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

_BMP = 0x10000


def _utf8_len(cp: int) -> int:
    if cp < 0x80:
        return 1
    if cp < 0x800:
        return 2
    if cp < _BMP:
        return 3
    return 4


@functools.lru_cache(maxsize=2)
def _tables(to_upper: bool):
    """(mapped int32[65536], special bool[65536]), built once on the host.

    ``special`` marks codepoints whose case mapping cannot be applied in
    place: multi-character results (ß -> SS), results outside the BMP, or
    results whose UTF-8 length differs from the input's.
    """
    mapped = np.arange(_BMP, dtype=np.int32)
    special = np.zeros(_BMP, dtype=bool)
    for cp in range(_BMP):
        ch = chr(cp)
        out = ch.upper() if to_upper else ch.lower()
        if out == ch:
            continue
        if len(out) != 1:
            special[cp] = True
            continue
        ocp = ord(out)
        if ocp >= _BMP or _utf8_len(ocp) != _utf8_len(cp):
            special[cp] = True
            continue
        mapped[cp] = ocp
    # surrogates are invalid in UTF-8: special, so the host decides
    special[0xD800:0xE000] = True
    if not to_upper:
        # U+03A3 GREEK CAPITAL SIGMA: word-final Σ -> ς, else σ (the one
        # context-dependent default mapping); a positionless table cannot
        # apply it, so its rows go to the host
        special[0x03A3] = True
    return mapped, special


def _shift_right(x: torch.Tensor, k: int) -> torch.Tensor:
    """x[:, j - k] at column j, zero (False) in the first k columns."""
    return F.pad(x[:, :x.shape[1] - k], (k, 0))


def _case_map_block(b: torch.Tensor, mapped: torch.Tensor,
                    special: torch.Tensor):
    """One block of rows of :func:`case_map_device`, ``b`` int32."""
    b1 = F.pad(b[:, 1:], (0, 1))   # byte at j + 1
    b2 = F.pad(b[:, 2:], (0, 2))   # byte at j + 2

    ascii_ = b < 0x80
    cont = (b >= 0x80) & (b < 0xC0)
    lead2 = (b >= 0xC2) & (b < 0xE0)
    lead3 = (b >= 0xE0) & (b < 0xF0)
    bad_lead = ((b >= 0xC0) & (b < 0xC2)) | (b >= 0xF0)

    cont1_ok = (b1 >= 0x80) & (b1 < 0xC0)
    cont2_ok = (b2 >= 0x80) & (b2 < 0xC0)
    # structural validity: every lead has its continuations, every
    # continuation has a lead at the right offset
    prev_lead2 = _shift_right(lead2, 1)
    prev_lead3 = _shift_right(lead3, 1)
    prev2_lead3 = _shift_right(lead3, 2)
    prev_cont = _shift_right(cont, 1)
    cont_claimed = prev_lead2 | prev_lead3 | (prev_cont & prev2_lead3)
    malformed = ((lead2 & ~cont1_ok)
                 | (lead3 & ~(cont1_ok & cont2_ok))
                 | (cont & ~cont_claimed)
                 | bad_lead)

    cp2 = ((b & 0x1F) << 6) | (b1 & 0x3F)
    cp3 = ((b & 0x0F) << 12) | ((b1 & 0x3F) << 6) | (b2 & 0x3F)
    # overlong encodings (cp3 < 0x800 in 3 bytes) are invalid
    overlong3 = lead3 & (cp3 < 0x800)
    cp = torch.where(lead2, cp2, torch.where(lead3, cp3, b))
    cp = cp.clamp_(0, _BMP - 1).long()

    is_special = (ascii_ | lead2 | lead3) & special[cp]
    row_special = (is_special | malformed | overlong3).any(1)

    m = mapped[cp]
    # re-encoded bytes at LEAD positions
    l2_b0 = 0xC0 | (m >> 6)
    l2_b1 = 0x80 | (m & 0x3F)
    l3_b0 = 0xE0 | (m >> 12)
    l3_b1 = 0x80 | ((m >> 6) & 0x3F)
    l3_b2 = 0x80 | (m & 0x3F)

    out = torch.where(ascii_, m, b)
    out = torch.where(lead2, l2_b0, out)
    out = torch.where(lead3, l3_b0, out)
    out = torch.where(cont & prev_lead2, _shift_right(l2_b1, 1), out)
    out = torch.where(cont & prev_lead3, _shift_right(l3_b1, 1), out)
    out = torch.where(cont & prev_cont & prev2_lead3,
                      _shift_right(l3_b2, 2), out)
    return out.to(torch.uint8), row_special


def case_map_device(chars: torch.Tensor, to_upper: bool):
    """(out_chars uint8[n, W], row_special bool[n]): the mapped bytes and
    a per-row flag for rows the device path cannot map faithfully (the
    caller maps those on the host)."""
    from spark_rapids_jni_tpu_torch.ops.strings import row_chunks

    mapped_np, special_np = _tables(to_upper)
    dev = chars.device
    mapped = torch.from_numpy(mapped_np).to(dev)
    special = torch.from_numpy(special_np).to(dev)
    n, w = int(chars.shape[0]), int(chars.shape[1])
    out = torch.empty_like(chars)
    row_special = torch.empty(n, dtype=torch.bool, device=dev)
    for r0, r1 in row_chunks(n, w):
        out[r0:r1], row_special[r0:r1] = _case_map_block(
            chars[r0:r1].to(torch.int32), mapped, special)
    return out, row_special
