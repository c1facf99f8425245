"""Device JSONPath extraction, the fast path of ``get_json_object``
(counterpart of the reference's ``ops/json_device.py``).

The column lies padded, (n, W) uint8. Parsing state is per-position masks
with scans along each row only: quote parity marks string interiors, a
cumsum over brackets outside strings gives the nesting depth, and each
JSONPath component narrows a per-row (start, end) span. A field step
matches the literal ``"name"`` window at the component's depth inside the
span (followed, after white space, by a colon) and hops to the value
after the colon; an index step counts commas at its depth. No scatter,
no data-dependent control flow, no host round trip.

Grammar (the native engine's, minus wildcards): ``$``, ``.field``,
``['field']``, ``[index]``. Output: string values unquoted, objects,
arrays, numbers and booleans as raw text, JSON null and missing paths as
SQL NULL, in a padded STRING column of the input's width.

Eligibility (one scalar on the device): no backslash (escape decoding is
host work), and per row balanced quotes and brackets, a depth never
negative, nothing past the root value and a bare scalar root of one
token. An ineligible column goes to the host engine.

Memory plan. The reference builds many (n, W) int32 arrays and a full
"next index with property P" matrix per query; at 59,986,052 rows of
54-55 bytes one such array is 13 GB. Here rows run in blocks
(``strings.row_chunks``; rows are independent, so the result is the
same), each block laid out position-major, (W, c), so that the scans run
along the outer axis (torch's scans along a short inner axis were half
of the time on the card). The one index matrix kept per block is the
next non-white-space position (one reverse pass over the positions);
every other "first j >= pos[i] with P" is a byte max reduction over the
positions. The reference's ``jnp.roll`` windows become in-place ANDs of
two shifted slices, with the same wrap-around.
"""

from __future__ import annotations

import re
from typing import NamedTuple

import torch

from spark_rapids_jni_tpu_torch.columnar import Column
from spark_rapids_jni_tpu_torch.ops.strings import pad_strings, row_chunks
from spark_rapids_jni_tpu_torch.types import STRING


class PathStep(NamedTuple):
    field: str | None   # object member name, or None for an array index
    index: int | None


# dotted names run to the next '.' or '[' (the native engine's rule: ']'
# and '*' are legal name bytes; only the exact name "*" is a wildcard)
_FIELD_RE = re.compile(r"\.([^.\[]+)|\['([^']*)'\]|\[(\d+)\]")


def parse_json_path(path: str) -> list[PathStep]:
    """``$``-rooted JSONPath -> steps. ValueError on wildcards and garbage
    (Spark fails paths it cannot compile)."""
    if not path.startswith("$"):
        raise ValueError(f"JSONPath: must start with '$': {path!r}")
    rest = path[1:]
    steps: list[PathStep] = []
    pos = 0
    while pos < len(rest):
        m = _FIELD_RE.match(rest, pos)
        if m is None:
            raise ValueError(f"JSONPath: cannot compile {path!r} at {pos+1}")
        if m.group(3) is not None:
            steps.append(PathStep(None, int(m.group(3))))
        else:
            name = m.group(1) if m.group(1) is not None else m.group(2)
            if name == "*":
                raise ValueError(f"JSONPath: wildcards unsupported: {path!r}")
            steps.append(PathStep(name, None))
        pos = m.end()
    return steps


class _Doc(NamedTuple):
    """One block of c rows, classified, position-major: (W, c) masks
    (position j of row i at [j, i]) unless noted."""
    ch: torch.Tensor          # uint8, zeroed past the row length
    jdx: torch.Tensor         # (W, 1) int32 positions
    outside: torch.Tensor     # structural: not a string interior or the
    #                           closing quote of a string
    depth: torch.Tensor       # nesting depth AFTER char j
    nonws: torch.Tensor       # non-white-space, in the row
    quote: torch.Tensor       # '"'
    closeb: torch.Tensor      # '}' or ']' outside strings
    comma: torch.Tensor       # ',' outside strings
    nxt: torch.Tensor         # first non-ws position >= j (W: none)
    colon_next: torch.Tensor  # the first non-ws char >= j is ':'
    row_len: torch.Tensor     # (c,) int32
    sane: torch.Tensor        # (c,) structural sanity
    has_escape: torch.Tensor  # (c,)


def _first_from(mask: torch.Tensor, jdx: torch.Tensor,
                lo: torch.Tensor) -> torch.Tensor:
    """(c,) int32: the smallest j >= lo[i] with mask[j, i], W if none
    (a byte max over positions, which returns the first maximal index)."""
    w = int(mask.shape[0])
    found, idx = (mask & (jdx >= lo[None, :])).view(torch.uint8).max(0)
    return torch.where(found != 0, idx.to(torch.int32), w)


def _last(hit: torch.Tensor, jdx: torch.Tensor) -> torch.Tensor:
    """(c,) int32: the largest j with hit[j, i], -1 if none."""
    return (torch.where(hit, jdx + 1, 0).amax(0) - 1).to(torch.int32)


def _at(x: torch.Tensor, pos: torch.Tensor, fill) -> torch.Tensor:
    """x[pos[i], i], with pos >= W (out of the document) giving ``fill``
    and pos < 0 reading position 0, as the reference's clip does."""
    w = int(x.shape[0])
    got = x.gather(0, pos.clamp(0, w - 1).long()[None, :])[0]
    return torch.where(pos < w, got, fill)


def _and_rolled(acc: torch.Tensor, cond: torch.Tensor, k: int) -> None:
    """acc[j] &= cond[(j + k) % W] in place: the reference's
    ``jnp.roll(cond, -k, axis=1)`` read through two slices."""
    w = int(acc.shape[0])
    k %= w
    acc[:w - k] &= cond[k:]
    if k:
        acc[w - k:] &= cond[:k]


def _and_rolled_eq(acc: torch.Tensor, ch: torch.Tensor, k: int,
                   byte: int) -> None:
    """acc[j] &= ch[(j + k) % W] == byte, in place."""
    w = int(acc.shape[0])
    k %= w
    acc[:w - k] &= ch[k:] == byte
    if k:
        acc[w - k:] &= ch[:k] == byte


def _classify(mat: torch.Tensor, lengths: torch.Tensor) -> _Doc:
    """Classify a (c, W) block of padded rows."""
    w = int(mat.shape[1])
    jdx = torch.arange(w, dtype=torch.int32, device=mat.device)[:, None]
    ch = mat.t().contiguous()
    ch.masked_fill_(jdx >= lengths[None, :], 0)
    quote = ch == 34  # "
    # a char is string interior (or the closing quote) iff an odd number
    # of quotes strictly precede it (the opening quote is structural); a
    # uint8 running count wraps but keeps its parity
    qcum = torch.cumsum(quote.view(torch.uint8), 0, dtype=torch.uint8)
    outside = (qcum & 1) == quote
    brace = ch | 0x20  # '[' and '{' -> 0x7B, ']' and '}' -> 0x7D
    openb = (brace == 123) & outside
    closeb = (brace == 125) & outside
    depth_dtype = torch.int16 if w < 2 ** 15 else torch.int32
    depth = torch.cumsum(openb.view(torch.int8) - closeb.view(torch.int8),
                         0, dtype=depth_dtype)
    ws = (ch == 32) | (ch == 9) | (ch == 10) | (ch == 13)
    nonws = ~ws & (ch != 0)  # ch is 0 past the row
    sane = (((qcum[-1] & 1) == 0) & (depth[-1] == 0)
            & (depth.amin(0) >= 0))
    has_escape = (ch == 92).any(0)
    # the next non-ws position and whether its char is ':', by one
    # reverse pass over the positions (1-D lanes of c rows)
    nxt = torch.empty((w, int(mat.shape[0])), dtype=torch.int32,
                      device=mat.device)
    colon_next = torch.empty_like(nonws)
    nxt[w - 1].fill_(w).masked_fill_(nonws[w - 1], w - 1)
    torch.logical_and(nonws[w - 1], ch[w - 1] == 58, out=colon_next[w - 1])
    for j in range(w - 2, -1, -1):
        torch.where(nonws[j], jdx[j], nxt[j + 1], out=nxt[j])
        torch.where(nonws[j], ch[j] == 58, colon_next[j + 1],
                    out=colon_next[j])
    return _Doc(ch, jdx, outside, depth, nonws, quote, closeb,
                (ch == 44) & outside, nxt, colon_next,
                lengths.to(torch.int32), sane, has_escape)


def _value_span(doc: _Doc, vstart: torch.Tensor, level: int,
                ok: torch.Tensor):
    """Given per-row value-start positions at container depth ``level``,
    return (start, end_exclusive, is_string, ok). Strings keep their
    quotes here; the extraction strips them."""
    w = int(doc.ch.shape[0])
    first = _at(doc.ch, vstart, 0)
    inside = vstart < w
    after = vstart + 1
    at_level = doc.depth == level
    # string value: the closing quote is the next quote after the opener
    e_string = torch.where(inside, _first_from(doc.quote, doc.jdx, after),
                           w - 1)
    # nested value: the matching close returns depth to `level`
    e_nested = torch.where(
        inside, _first_from(doc.closeb & at_level, doc.jdx, after), w - 1)
    # scalar: ended by a level comma, the container's own close, or the
    # end of the document
    term = (doc.comma & at_level) | (doc.closeb & (doc.depth == level - 1))
    e_scalar = torch.minimum(
        torch.where(inside, _first_from(term, doc.jdx, after), w),
        doc.row_len)

    is_string = first == 34
    is_nested = (first == 123) | (first == 91)
    end = torch.where(is_string, e_string + 1,
                      torch.where(is_nested, e_nested + 1, e_scalar))
    # trim trailing white space off scalar spans
    last_tok = _last(doc.nonws & (doc.jdx >= vstart[None, :])
                     & (doc.jdx < end[None, :]), doc.jdx)
    end = torch.where(is_string | is_nested, end, last_tok + 1)
    ok = ok & inside & (end > vstart)
    return vstart, end, is_string, ok


def _root(doc: _Doc, valid: torch.Tensor):
    """The root value's span and the block's eligibility: every row
    escape-free, structurally sane, no content past the root value, and
    a bare scalar root one contiguous token (or the row null or blank).
    Returns (s, e, is_string, ok, eligible)."""
    w = int(doc.ch.shape[0])
    s0 = doc.nxt[0]  # first token
    ok = valid & doc.sane & (s0 < w)
    # the root document is itself a value span at depth 0: this (not the
    # last non-ws) bounds the result, so a root object followed by
    # trailing bytes ends at its matching close, as in the host engine
    s, e, is_string, ok = _value_span(doc, s0, 0, ok)
    no_trailing = _last(doc.nonws, doc.jdx) < e
    first = _at(doc.ch, s0, 0)
    is_nested = (first == 123) | (first == 91)
    in_span = (doc.jdx >= s[None, :]) & (doc.jdx < e[None, :])
    contiguous = (~in_span | doc.nonws).all(0)
    scalar_ok = (first == 34) | is_nested | contiguous
    row_ok = ((~doc.has_escape & doc.sane & no_trailing & scalar_ok)
              | ~valid | (s0 == w))
    return s, e, is_string, ok, row_ok.all()


def _extract_block(mat, lengths, valid, steps, out):
    """One block of rows: the result's bytes go to ``out`` (c, W); returns
    (lengths, validity, eligible)."""
    doc = _classify(mat, lengths)
    w = int(mat.shape[1])
    jdx = doc.jdx
    s, e, is_string, ok, eligible = _root(doc, valid)

    level = 0
    for step in steps:
        level += 1
        in_span = (jdx > s[None, :]) & (jdx < e[None, :])
        if step.field is not None:
            ok = ok & (_at(doc.ch, s, 0) == 123)  # must be an object
            pat = step.field.encode("utf-8")
            f = len(pat)
            # literal window '"field"' at this level, structurally a key,
            # its closing quote inside the row, and the next non-ws char
            # after it a colon: so a VALUE string equal to '"field"'
            # cannot shadow a later real key
            win = doc.quote & doc.outside & (doc.depth == level)
            for off, byte in enumerate(pat):
                _and_rolled_eq(win, doc.ch, off + 1, byte)
            _and_rolled(win, doc.quote, f + 1)
            win &= jdx < (doc.row_len - (f + 1))[None, :]
            _and_rolled(win, doc.colon_next, f + 2)
            win &= in_span
            kpos = _first_from(win, jdx, s + 1)  # first real key match
            ok = ok & (kpos < w)
            # the colon: the first non-ws position after the window
            cpos = torch.where(kpos < w,
                               _at(doc.nxt, (kpos + (f + 2)) % w, w), w)
            vstart = _at(doc.nxt, cpos + 1, w)
        else:
            ok = ok & (_at(doc.ch, s, 0) == 91)  # must be an array
            k = step.index
            if k == 0:
                vstart = _at(doc.nxt, s + 1, w)
                # empty array: the first token would be the closing bracket
                ok = ok & (_at(doc.ch, vstart, 0) != 93)
            else:
                commas = doc.comma & (doc.depth == level) & in_span
                ccum = torch.cumsum(commas, 0, dtype=doc.depth.dtype)
                cpos = _first_from(commas & (ccum == k), jdx, s + 1)
                ok = ok & (cpos < w)
                vstart = _at(doc.nxt, cpos + 1, w)
        s, e, is_string, ok = _value_span(doc, vstart, level, ok)

    # the result strings: quotes stripped from strings; 'null' -> SQL NULL
    out_s = torch.where(is_string, s + 1, s)
    out_e = torch.where(is_string, e - 1, e)
    out_len = (out_e - out_s).clamp(min=0)
    is_null_lit = ~is_string & (out_len == 4)
    for i, byte in enumerate(b"null"):
        is_null_lit &= _at(doc.ch, out_s + i, 0) == byte
    ok = ok & ~is_null_lit
    out_len = torch.where(ok, out_len, 0)
    src = (out_s[None, :] + jdx).clamp_(0, w - 1).long()
    res = doc.ch.gather(0, src).masked_fill_(jdx >= out_len[None, :], 0)
    out.copy_(res.t())
    return out_len, ok, eligible


def _device_extract(mat: torch.Tensor, lengths: torch.Tensor,
                    valid: torch.Tensor, steps: tuple[PathStep, ...]):
    """(n, W) padded docs -> (lengths, validity, out_mat, eligible), a
    block of rows at a time; eligibility rides the same classification,
    so the dispatcher pays one device pass."""
    n, w = int(mat.shape[0]), int(mat.shape[1])
    dev = mat.device
    out_len = torch.zeros(n, dtype=torch.int32, device=dev)
    ok = torch.zeros(n, dtype=torch.bool, device=dev)
    out_mat = torch.empty_like(mat)
    eligible = torch.ones((), dtype=torch.bool, device=dev)
    for r0, r1 in row_chunks(n, w):
        ln, o, el = _extract_block(mat[r0:r1], lengths[r0:r1],
                                   valid[r0:r1], steps, out_mat[r0:r1])
        out_len[r0:r1], ok[r0:r1] = ln, o
        eligible &= el
    return out_len, ok, out_mat, eligible


def device_eligible(col: Column) -> torch.Tensor:
    """Scalar bool on the device: every row escape-free, structurally
    sane and free of content past the root value (trailing garbage is a
    grammar error only the host state machine adjudicates). The
    dispatcher fetches this one byte to pick the engine."""
    p = pad_strings(col)
    mat, lengths, valid = p.chars, p.data, p.valid_mask()
    eligible = torch.ones((), dtype=torch.bool, device=mat.device)
    for r0, r1 in row_chunks(int(mat.shape[0]), int(mat.shape[1])):
        doc = _classify(mat[r0:r1], lengths[r0:r1])
        eligible &= _root(doc, valid[r0:r1])[4]
    return eligible


def get_json_object_device(col: Column, path: str) -> Column:
    """JSONPath extraction on the device over a STRING column, as a padded
    STRING column; the caller checks eligibility (``device_eligible``):
    the public ``get_json_object`` dispatcher does both."""
    return extract_with_eligibility(col, path)[0]


def extract_with_eligibility(col: Column, path: str):
    """One device pass for the dispatcher: (result Column, eligible
    scalar). The result holds only when ``eligible`` is True."""
    steps = tuple(parse_json_path(path))
    p = pad_strings(col)
    out_len, ok, out_mat, elig = _device_extract(
        p.chars, p.data, p.valid_mask(), steps)
    return Column(STRING, out_len, ok, chars=out_mat), elig
