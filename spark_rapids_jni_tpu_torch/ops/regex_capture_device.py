"""Device regexp_extract / regexp_replace (counterpart of the
reference's ``ops/regex_capture_device.py``): capture tracking over the
byte-DFA machinery of ``ops/regex_device.py``.

RLIKE needs one DFA verdict per row; EXTRACT needs the capture-group
boundaries of the first match, which one DFA cannot produce. The engine
is the reference's two-pass scheme for LINEAR patterns (a concatenation
of literals and quantified byte classes, with flat capture groups:
``(\\d+)``, ``id=(\\w+);``, ``([a-z]+)-(\\d+)``, ...):

1. **Suffix feasibility (reverse DFA passes).** For each element index
   k, a DFA for the reversed suffix ``rev(E_m)..rev(E_k)`` runs over the
   reversed row, giving ``feas_k[t]`` = "elements k..m can match starting
   at byte t" for every t.
2. **Greedy boundary walk.** The match starts at the smallest feasible
   t (Java's leftmost rule); element k ends at the largest (smallest for
   a lazy ``?``) t in its quantifier range whose bytes all lie in the
   class and where ``feas_{k+1}[t]`` holds: Java's backtracking priority
   without backtracking.

The host side (parser, suffix-DFA compiler) is the reference's, line for
line, so the tables are equal byte for byte. On the device the rows run
a block at a time (``strings.row_chunks``), each block laid out
position-major, (W, c):

- the suffix DFAs step together: their tables are stacked into one,
  and each position is one add and two gathers (the next state and its
  accept bit). Only the suffixes that start with a quantified element,
  and the empty suffix, need a DFA: a suffix that starts with a literal
  byte is feasible at t exactly when byte t is in its class and the
  next suffix is feasible at t+1 (for ``status=(\\d+)``, 2 DFAs of 9);
- the walk's "smallest feasible t >= x", "largest feasible t <= x" and
  "next byte outside the class" queries read pointer arrays built once a
  block by loops of 1-D lanes (forward or reverse over the positions),
  so a query is one gather of c lanes, and ``regexp_replace``'s eight
  match rounds share them;
- ``regexp_replace`` writes each kept input byte and each replacement
  byte straight to its output position (one scatter a block) instead of
  the reference's piece-table gathers: the same bytes.

Rows are independent, so the blocks give the reference's bytes. Scope
(enforced by ``ops.strings``): linear patterns, ASCII classes and
literals, all-ASCII rows without NUL; everything else takes the host
engine.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from spark_rapids_jni_tpu_torch.ops.regex_device import (
    MAX_DFA_STATES,
    MAX_EXPANSION,
    RegexUnsupported,
    _closure,
    _Nfa,
)

_MAX_ELEMENTS = 24
_ANY_NO_NUL = frozenset(range(1, 256))

_D = frozenset(range(0x30, 0x3A))
_W_SET = (frozenset(range(0x30, 0x3A)) | frozenset(range(0x41, 0x5B))
          | frozenset(range(0x61, 0x7B)) | {0x5F})
_S = frozenset(b" \t\n\x0b\f\r")
_ASCII = frozenset(range(1, 128))
_ASCII_NO_NL = _ASCII - {0x0A}


class LinearElement(NamedTuple):
    byteset: frozenset  # candidate bytes (single-byte steps)
    lo: int             # min repetitions
    hi: Optional[int]   # max repetitions, None = unbounded
    lazy: bool


class LinearPattern(NamedTuple):
    elements: tuple            # of LinearElement
    groups: tuple              # group g (1-based) -> (first_el, last_el+1)
    anchored_start: bool
    anchored_end: bool


class _LinParser:
    """Linear-subset parser: concatenation of quantified single-byte
    atoms and flat capture groups. Anything outside the subset raises
    RegexUnsupported (the dispatcher's host-fallback signal)."""

    def __init__(self, pattern: str):
        self.p = pattern
        self.i = 0

    def _peek(self):
        return self.p[self.i] if self.i < len(self.p) else None

    def _take(self):
        c = self._peek()
        if c is None:
            raise RegexUnsupported("unexpected end of pattern")
        self.i += 1
        return c

    def parse(self) -> LinearPattern:
        anchored_start = anchored_end = False
        if self._peek() == "^":
            self._take()
            anchored_start = True
        elements: list[LinearElement] = []
        groups: list[tuple[int, int]] = []
        while self._peek() is not None:
            c = self._peek()
            if c == "$":
                self._take()
                if self._peek() is not None:
                    raise RegexUnsupported("mid-pattern $")
                anchored_end = True
                break
            if c == "|":
                raise RegexUnsupported("alternation")
            if c == ")":
                raise RegexUnsupported("unbalanced )")
            if c == "(":
                self._take()
                capturing = True
                if self._peek() == "?":
                    self._take()
                    if self._peek() != ":":
                        raise RegexUnsupported("(?...) construct")
                    self._take()
                    capturing = False
                first = len(elements)
                while self._peek() not in (")", None):
                    if self._peek() in ("(",):
                        raise RegexUnsupported("nested group")
                    if self._peek() == "|":
                        raise RegexUnsupported("alternation")
                    elements.append(self._quantified_atom())
                if self._take() != ")":
                    raise RegexUnsupported("unbalanced (")
                if self._peek() in ("*", "+", "?", "{"):
                    raise RegexUnsupported("quantified group")
                if capturing:
                    groups.append((first, len(elements)))
                continue
            elements.append(self._quantified_atom())
        if not elements:
            raise RegexUnsupported("empty pattern")
        if len(elements) > _MAX_ELEMENTS:
            raise RegexUnsupported(f"more than {_MAX_ELEMENTS} elements")
        return LinearPattern(tuple(elements), tuple(groups),
                             anchored_start, anchored_end)

    def _quantified_atom(self) -> LinearElement:
        byteset = self._atom()
        lo, hi = 1, 1
        c = self._peek()
        if c == "*":
            self._take()
            lo, hi = 0, None
        elif c == "+":
            self._take()
            lo, hi = 1, None
        elif c == "?":
            self._take()
            lo, hi = 0, 1
        elif c == "{":
            self._take()
            digs = ""
            while self._peek() and self._peek().isdigit():
                digs += self._take()
            if not digs:
                raise RegexUnsupported("bad {} quantifier")
            lo = int(digs)
            if self._peek() == ",":
                self._take()
                digs2 = ""
                while self._peek() and self._peek().isdigit():
                    digs2 += self._take()
                hi = int(digs2) if digs2 else None
            else:
                hi = lo
            if self._take() != "}":
                raise RegexUnsupported("bad {} quantifier")
            if hi is not None and hi < lo:
                raise RegexUnsupported("bad {} range")
            if lo > MAX_EXPANSION or (hi or 0) > MAX_EXPANSION:
                raise RegexUnsupported("quantifier too large")
        lazy = False
        if self._peek() == "?" and (lo, hi) != (1, 1):
            self._take()
            lazy = True
        if self._peek() in ("*", "+", "?", "{") and (lo, hi) != (1, 1):
            raise RegexUnsupported("double quantifier")
        return LinearElement(byteset, lo, hi, lazy)

    def _atom(self) -> frozenset:
        c = self._take()
        if c == ".":
            byteset = _ASCII_NO_NL
        elif c == "[":
            byteset = self._char_class()
        elif c == "\\":
            byteset = self._escape()
        elif c in "*+?{":
            raise RegexUnsupported("dangling quantifier")
        elif ord(c) > 0x7F:
            raise RegexUnsupported("non-ASCII literal")
        else:
            byteset = frozenset([ord(c)])
        if 0 in byteset:
            # byte 0 is the row padding byte of the padded char matrix:
            # an atom that can match NUL would match padding and run
            # across row boundaries — host engine territory
            raise RegexUnsupported("NUL byte in pattern")
        return byteset

    def _escape(self) -> frozenset:
        c = self._take()
        table = {"d": _D, "D": _ASCII - _D, "w": _W_SET,
                 "W": _ASCII - _W_SET, "s": _S, "S": _ASCII - _S,
                 "n": frozenset(b"\n"), "t": frozenset(b"\t"),
                 "r": frozenset(b"\r")}
        if c in table:
            return table[c]
        # ord(c) == 0 (an escaped literal NUL) is excluded with the
        # non-ASCII range: its byteset would contain the padding byte
        if not c.isalnum() and 0 < ord(c) <= 0x7F:
            return frozenset([ord(c)])
        # alnum escapes are Java metasyntax; >0x7F would index past the
        # 256-entry byte transition rows — both are host-engine territory
        raise RegexUnsupported(f"escape \\{c}")

    def _char_class(self) -> frozenset:
        negated = False
        if self._peek() == "^":
            self._take()
            negated = True
        members: set[int] = set()
        first = True
        while True:
            c = self._peek()
            if c is None:
                raise RegexUnsupported("unterminated class")
            if c == "]" and not first:
                self._take()
                break
            first = False
            if c == "\\":
                self._take()
                members |= self._escape()
                continue
            self._take()
            if ord(c) > 0x7F:
                raise RegexUnsupported("non-ASCII class member")
            if self._peek() == "-" and self.i + 1 < len(self.p) \
                    and self.p[self.i + 1] != "]":
                self._take()
                d = self._take()
                if d == "\\" or ord(d) > 0x7F or ord(d) < ord(c):
                    raise RegexUnsupported("complex class range")
                members |= set(range(ord(c), ord(d) + 1))
            else:
                members.add(ord(c))
        if negated:
            return _ASCII - frozenset(members)
        if not members:
            raise RegexUnsupported("empty class")
        return frozenset(members)


def parse_linear(pattern: str) -> LinearPattern:
    return _LinParser(pattern).parse()


# ---------------------------------------------------------------------------
# suffix feasibility DFAs
# ---------------------------------------------------------------------------


def _append_element_rev(nfa: _Nfa, cur: int, el: LinearElement) -> int:
    """Chain one element (class semantics are order-free, so the reversed
    element is itself) onto ``cur``; returns the new chain end."""
    for _ in range(el.lo):
        s = nfa.new_state()
        nfa.add(cur, el.byteset, s)
        cur = s
    if el.hi is None:
        s = nfa.new_state()
        nfa.add(cur, None, s)
        nfa.add(s, el.byteset, s)
        cur = s
    else:
        end = nfa.new_state()
        nfa.add(cur, None, end)
        for _ in range(el.hi - el.lo):
            s = nfa.new_state()
            nfa.add(cur, el.byteset, s)
            nfa.add(s, None, end)
            cur = s
        cur = end
    return cur


def _subset_construct(nfa: _Nfa, start: int, final: int):
    """NFA -> DFA transition table + accept vector (the regexp_contains
    construction, parameterized for reuse)."""
    d0 = _closure(nfa, frozenset([start]))
    ids = {d0: 0}
    order = [d0]
    trans: list[np.ndarray] = []
    qi = 0
    while qi < len(order):
        cur = order[qi]
        qi += 1
        row = np.full(256, -1, dtype=np.int32)
        move: dict[int, set] = {}
        for s in cur:
            for byteset, tgt in nfa.edges[s]:
                if byteset is None:
                    continue
                for b in byteset:
                    move.setdefault(b, set()).add(tgt)
        cache: dict[frozenset, int] = {}
        for b, tgts in move.items():
            key = frozenset(tgts)
            if key in cache:
                row[b] = cache[key]
                continue
            nxt = _closure(nfa, key)
            if nxt not in ids:
                if len(ids) >= MAX_DFA_STATES:
                    raise RegexUnsupported(
                        f"DFA exceeds {MAX_DFA_STATES} states")
                ids[nxt] = len(ids)
                order.append(nxt)
            row[b] = ids[nxt]
            cache[key] = ids[nxt]
        trans.append(row)
    dead = len(order)
    table = np.concatenate(trans).astype(np.int32)
    table[table < 0] = dead
    table = np.concatenate([table, np.full(256, dead, dtype=np.int32)])
    accept = np.array([final in st for st in order] + [False], dtype=bool)
    return table, accept


class CompiledLinear(NamedTuple):
    pattern: LinearPattern
    # per suffix k in 0..m: (table, accept) of the reversed-suffix DFA
    suffix_dfas: tuple


def compile_linear(pattern: str) -> CompiledLinear:
    """Host compile: the linear pattern + one reversed-suffix DFA per
    element boundary. LRU-cached per pattern string; each lookup counts a
    hit or a miss in ``telemetry.record_compile_cache("regex_linear")``
    (a rejected pattern raises out of the cache before it is counted)."""
    from spark_rapids_jni_tpu_torch import telemetry

    before = _compile_linear_cached.cache_info().hits
    out = _compile_linear_cached(pattern)
    hit = _compile_linear_cached.cache_info().hits > before
    telemetry.record_compile_cache("regex_linear", hit=hit)
    return out


@functools.lru_cache(maxsize=256)
def _compile_linear_cached(pattern: str) -> CompiledLinear:
    lin = parse_linear(pattern)
    m = len(lin.elements)
    dfas = []
    for k in range(m + 1):
        nfa = _Nfa()
        q0 = nfa.new_state()
        # reversed padding prefix: the reverse scan consumes the row's
        # 0x00 tail first, by design
        nfa.add(q0, frozenset([0]), q0)
        cur = nfa.new_state()
        nfa.add(q0, None, cur)
        if not lin.anchored_end:
            # bytes AFTER the match end (reversed: consumed first)
            nfa.add(cur, _ANY_NO_NUL, cur)
        for el in reversed(lin.elements[k:]):
            cur = _append_element_rev(nfa, cur, el)
        dfas.append(_subset_construct(nfa, q0, cur))
    return CompiledLinear(lin, tuple(dfas))




# ---------------------------------------------------------------------------
# device passes
# ---------------------------------------------------------------------------


def _is_literal(el: LinearElement) -> bool:
    """One byte of the class, exactly once: the walk reads the class bit
    of one byte and the feasibility at one position."""
    return el.lo == 1 and el.hi == 1


class _Tables(NamedTuple):
    """The compiled pattern's device arrays (see ``_device_tables``)."""
    step: torch.Tensor      # int32[S*256]: (base + next state) * 256
    accept: torch.Tensor    # bool[S*256]: accept bit of that next state
    init: torch.Tensor      # int32[d, 1]: each stepped DFA's start lane
    init_accept: torch.Tensor  # bool[d, 1]: its start state's accept
    classes: torch.Tensor   # bool[B*256]: membership of the walk's classes
    dfa_rows: tuple         # suffixes whose DFAs are stepped
    class_of: tuple         # element -> row of ``classes``
    nf_rows: tuple          # suffixes that need "next feasible"
    pf_rows: tuple          # suffixes that need "previous feasible"


def _host_tables(comp: CompiledLinear):
    """Numpy side of ``_Tables``. Only the suffixes that start with a
    non-literal element, and the empty suffix, run their DFAs (stacked
    into one table whose state ids are offset by each DFA's base): a
    literal element k's suffix is feasible at t exactly when byte t is
    in its class and suffix k+1 is feasible at t+1."""
    lin = comp.pattern
    m = len(lin.elements)
    dfa_rows = tuple(k for k in range(m + 1)
                     if k == m or not _is_literal(lin.elements[k]))
    steps, accepts, init, init_acc = [], [], [], []
    base = 0
    for k in dfa_rows:
        table, accept = comp.suffix_dfas[k]
        steps.append((table + base) * 256)
        accepts.append(accept[table])
        init.append(base * 256)
        init_acc.append(accept[0])
        base += len(accept)
    sets: list = []
    class_of = []
    for el in lin.elements:
        if el.byteset not in sets:
            sets.append(el.byteset)
        class_of.append(sets.index(el.byteset))
    lut = np.zeros((len(sets), 256), bool)
    for i, s in enumerate(sets):
        lut[i, sorted(s)] = True
    nf_rows = (0,) + tuple(k + 1 for k, el in enumerate(lin.elements)
                           if el.lazy)
    pf_rows = tuple(k + 1 for k, el in enumerate(lin.elements)
                    if not el.lazy and not _is_literal(el))
    return (np.concatenate(steps).astype(np.int32),
            np.concatenate(accepts), np.asarray(init, np.int32)[:, None],
            np.asarray(init_acc, bool)[:, None], lut.reshape(-1), dfa_rows,
            tuple(class_of), nf_rows, pf_rows)


def _device_tables(comp: CompiledLinear, dev) -> _Tables:
    host = _host_tables(comp)
    return _Tables(*(torch.from_numpy(a).to(dev) for a in host[:5]),
                   *host[5:])


def _pos_dtype(w: int) -> torch.dtype:
    """Pointer arrays hold positions -1..w+1."""
    return torch.int16 if w + 2 < 2 ** 15 else torch.int32


class _Block(NamedTuple):
    """One block of rows, laid out position-major, with the walk's
    pointer arrays. Positions run 0..w (w = the padded width)."""
    img: torch.Tensor    # uint8 (w, c): byte t of row i at [t, i]
    feas: list           # suffix k -> bool (w+1, c): feas_k[t]
    nf: dict             # suffix k -> (w+1, c): smallest t' >= t with feas_k, else w+1
    pf: dict             # suffix k -> (w+1, c): largest t' <= t with feas_k, else -1
    nxt: dict            # class row -> (w+1, c): smallest t' >= t outside the class (w at the pad)


def _class_lut(tabs: _Tables, cls: int) -> torch.Tensor:
    return tabs.classes[cls * 256:(cls + 1) * 256]


def _prepare_block(chars: torch.Tensor, comp: CompiledLinear,
                   tabs: _Tables) -> _Block:
    """The feasibility of every suffix at every position of the padded
    (c, w) block ``chars``, and the pointer arrays the walk reads."""
    c, w = chars.shape
    dev = chars.device
    img = chars.t().contiguous()
    img32 = img.to(torch.int32)
    d = len(tabs.dfa_rows)
    stepped = torch.empty((w + 1, d, c), dtype=torch.bool, device=dev)
    stepped[w] = tabs.init_accept
    state = tabs.init.expand(d, c).contiguous()
    # position t consumed the reversed row down to t: one add and two
    # gathers a position, the stepped DFAs together
    for t in range(w - 1, -1, -1):
        idx = torch.add(state, img32[t]).view(-1)
        torch.index_select(tabs.accept, 0, idx, out=stepped[t].view(-1))
        state = torch.index_select(tabs.step, 0, idx).view(d, c)

    def inclass(k: int) -> torch.Tensor:
        """bool (w, c): byte t of row i is in element k's class."""
        members = comp.pattern.elements[k].byteset
        if len(members) == 1:
            return img == next(iter(members))
        return torch.index_select(_class_lut(tabs, tabs.class_of[k]), 0,
                                  img32.view(-1)).view(w, c)

    feas: list = [None] * len(comp.suffix_dfas)
    for j, k in enumerate(tabs.dfa_rows):
        feas[k] = stepped[:, j]
    for k in range(len(feas) - 2, -1, -1):
        if feas[k] is None:  # a literal element: one byte, then suffix k+1
            arr = torch.zeros((w + 1, c), dtype=torch.bool, device=dev)
            torch.logical_and(inclass(k), feas[k + 1][1:], out=arr[:w])
            feas[k] = arr
    pdt = _pos_dtype(w)
    pos = torch.arange(w + 2, dtype=pdt, device=dev)  # 0-d lanes of t
    nf, pf, nxt = {}, {}, {}
    for row in tabs.nf_rows:
        arr = torch.empty((w + 1, c), dtype=pdt, device=dev)
        arr[w] = torch.where(feas[row][w], w, w + 1)
        for t in range(w - 1, -1, -1):
            torch.where(feas[row][t], pos[t], arr[t + 1], out=arr[t])
        nf[row] = arr
    for row in tabs.pf_rows:
        arr = torch.empty((w + 1, c), dtype=pdt, device=dev)
        arr[0] = torch.where(feas[row][0], 0, -1)
        for t in range(1, w + 1):
            torch.where(feas[row][t], pos[t], arr[t - 1], out=arr[t])
        pf[row] = arr
    for k, el in enumerate(comp.pattern.elements):
        cls = tabs.class_of[k]
        if _is_literal(el) or cls in nxt:
            continue
        member = inclass(k)
        arr = torch.empty((w + 1, c), dtype=pdt, device=dev)
        arr[w] = w
        for t in range(w - 1, -1, -1):
            torch.where(member[t], arr[t + 1], pos[t], out=arr[t])
        nxt[cls] = arr
    return _Block(img, feas, nf, pf, nxt)


def _at(arr: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """arr[pos[i], i] for each lane i of a (positions, c) array, as
    int64 (``pos`` in range)."""
    return arr.gather(0, pos[None, :])[0].to(torch.int64)


class MatchBounds(NamedTuple):
    matched: torch.Tensor       # bool[c]
    starts: list                # per element: int64[c] start
    ends: list                  # per element: int64[c] end


def _first_match(blk: _Block, comp: CompiledLinear, tabs: _Tables,
                 cursor: torch.Tensor) -> MatchBounds:
    """Boundaries of the leftmost match starting at or after ``cursor``
    (int64[c], 0..w+1), by the greedy walk: one gather a query.
    Unmatched rows carry the reference's clipped positions."""
    lin = comp.pattern
    w = int(blk.img.shape[0])
    # leftmost feasible start (none: the reference's argmax fallback w)
    s_raw = _at(blk.nf[0], cursor.clamp(max=w))
    matched = (cursor <= w) & (s_raw <= w)
    if lin.anchored_start:
        matched &= s_raw == 0
    p = torch.where(matched, s_raw, w)

    starts, ends = [], []
    for k, el in enumerate(lin.elements):
        if _is_literal(el):
            # the range [p+1, min(p+1, run end)] holds p+1 when byte p is
            # in the class; greedy and lazy agree on one candidate
            lut = _class_lut(tabs, tabs.class_of[k])
            byte = _at(blk.img, p.clamp(max=w - 1))
            inb = (p < w) & lut[byte]
            cand = p + 1
            ok = inb & _at(blk.feas[k + 1], cand.clamp(max=w)).bool()
            j = torch.where(ok, cand, 0)
        else:
            run_end = _at(blk.nxt[tabs.class_of[k]], p)
            hi_eff = w if el.hi is None else el.hi
            upper = torch.minimum(p + hi_eff, run_end)
            lower = p + el.lo
            if el.lazy:
                nfv = _at(blk.nf[k + 1], lower.clamp(max=w))
                j = torch.where((lower <= w) & (nfv <= upper), nfv, w)
            else:
                pfv = _at(blk.pf[k + 1], upper)
                j = torch.where(pfv >= lower, pfv, 0)
        starts.append(p)
        ends.append(j)
        p = j
    return MatchBounds(matched, starts, ends)


def _extract_impl(chars: torch.Tensor, lengths_out: torch.Tensor,
                  out: torch.Tensor, comp: CompiledLinear, tabs: _Tables,
                  group: int) -> None:
    """One block: the group'th capture (0 = the whole match) of the
    first match into ``lengths_out`` and ``out``; '' where none."""
    from spark_rapids_jni_tpu_torch.ops.strings import shift_block

    lin = comp.pattern
    c = int(chars.shape[0])
    blk = _prepare_block(chars, comp, tabs)
    mb = _first_match(blk, comp, tabs, torch.zeros(
        (c,), dtype=torch.int64, device=chars.device))
    if group == 0:
        b, e = mb.starts[0], mb.ends[-1]
    else:
        first_el, end_el = lin.groups[group - 1]
        if first_el == end_el:  # empty group body: zero-width capture
            b = e = (mb.starts[first_el] if first_el < len(lin.elements)
                     else mb.ends[-1])
        else:
            b, e = mb.starts[first_el], mb.ends[end_el - 1]
    b = torch.where(mb.matched, b, 0)
    e = torch.where(mb.matched, e, 0)
    lengths_out.copy_(e - b)
    shift_block(chars, b, e - b, out)


def extract_device(chars: torch.Tensor, comp: CompiledLinear,
                   group: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(lengths int32[n], out_chars uint8[n, W]) for Spark regexp_extract
    semantics over the padded (n, W) ``chars``: the group'th capture of
    the first match, '' on no match; ``group`` 0 is the whole match.
    Every row must end in a 0x00 byte (``strings`` adds the sentinel
    column when the widest row fills W)."""
    from spark_rapids_jni_tpu_torch.ops.strings import row_chunks

    n, w = chars.shape
    dev = chars.device
    lengths = torch.zeros((n,), dtype=torch.int32, device=dev)
    out = torch.zeros((n, w), dtype=torch.uint8, device=dev)
    if n == 0 or w == 0:
        return lengths, out
    tabs = _device_tables(comp, dev)
    for r0, r1 in row_chunks(n, w + 1):
        _extract_impl(chars[r0:r1], lengths[r0:r1], out[r0:r1], comp, tabs,
                      group)
    return lengths, out


def _replace_impl(chars: torch.Tensor, lengths: torch.Tensor,
                  len_out: torch.Tensor, out: torch.Tensor,
                  comp: CompiledLinear, tabs: _Tables, rep: torch.Tensor,
                  max_matches: int) -> torch.Tensor:
    """One block of ``replace_device``; returns its overflow flag (a
    bool tensor, not read here)."""
    c, w = chars.shape
    dev = chars.device
    rl = int(rep.shape[0])
    lengths = lengths.to(torch.int64)
    blk = _prepare_block(chars, comp, tabs)
    spans = []
    cursor = torch.zeros((c,), dtype=torch.int64, device=dev)
    active = torch.ones((c,), dtype=torch.bool, device=dev)
    for _ in range(max_matches):
        mb = _first_match(blk, comp, tabs, cursor)
        hit = active & mb.matched & (mb.starts[0] <= lengths)
        b = torch.where(hit, mb.starts[0], lengths)
        e = torch.where(hit, mb.ends[-1], lengths)
        spans.append((b, e, hit))
        # Java's empty-match rule: advance at least one byte
        cursor = torch.where(hit, torch.maximum(e, b + 1), w + 1)
        active = hit
    # a row overflows when another match still starts inside the row
    # after the final cursor
    more = (cursor <= w) & (_at(blk.nf[0], cursor.clamp(max=w)) <= lengths)
    overflowed = (more & active).any()
    img = blk.img
    del blk

    # the spans are ordered and disjoint (each starts at or after the
    # previous cursor). Over the positions of the block's image: a span
    # marks +1 at its start and -1 at its end (a byte is dropped where
    # the running mark is positive) and its growth at its end (a kept
    # byte moves right by the running growth); round r's replacement
    # starts at b_r plus the growth of the rounds before it
    w_out = int(out.shape[1])
    lane = torch.arange(c, dtype=torch.int64, device=dev)
    marks = torch.zeros(((w + 1) * c,), dtype=torch.int32, device=dev)
    growth = torch.zeros(((w + 1) * c,), dtype=torch.int32, device=dev)
    grown = torch.zeros((c,), dtype=torch.int64, device=dev)
    rep_at = []
    for b, e, hit in spans:
        rep_at.append(b + grown)
        grow = torch.where(hit, rl - (e - b), 0)
        one = hit.to(torch.int32)
        marks.index_add_(0, b * c + lane, one)
        marks.index_add_(0, e * c + lane, -one)
        growth.index_add_(0, e * c + lane, grow.to(torch.int32))
        grown += grow
    len_out.copy_(lengths + grown)
    inside = torch.cumsum(marks.view(w + 1, c), 0, dtype=torch.int32)
    shift = torch.cumsum(growth.view(w + 1, c), 0, dtype=torch.int32)
    del marks, growth
    pos = torch.arange(w, dtype=torch.int64, device=dev)[:, None]
    keep = (pos < lengths[None, :]) & (inside[:w] == 0)
    # one scatter a block into a buffer with an extra column, where the
    # masked lanes write
    buf = torch.zeros((c, w_out + 1), dtype=torch.uint8, device=dev)
    base = lane * (w_out + 1)
    flat = buf.view(-1)
    flat[torch.where(keep, base + pos + shift[:w], base + w_out).view(-1)] = \
        img.reshape(-1)
    if rl:
        q = torch.arange(rl, dtype=torch.int64, device=dev)[None, :]
        for at, (_, _, hit) in zip(rep_at, spans):
            dest = torch.where(hit[:, None], (base + at)[:, None] + q,
                               (base + w_out)[:, None])
            flat[dest.view(-1)] = rep.repeat(c)
    out.copy_(buf[:, :w_out])
    return overflowed


def replace_device(chars: torch.Tensor, lengths: torch.Tensor,
                   comp: CompiledLinear, replacement: bytes,
                   max_matches: int = 8):
    """Replace ALL matches with a literal replacement, Java semantics
    (left-to-right non-overlapping; an empty match advances the cursor
    by one), over the padded (n, W) ``chars`` whose rows end in a 0x00
    byte. Returns (out_lengths int32[n], out_chars uint8[n, W + max_matches
    * len(replacement) + 1], overflowed): ``overflowed`` (a bool tensor)
    is True when a row has matches beyond ``max_matches`` rounds (the
    caller's host-recompute signal)."""
    from spark_rapids_jni_tpu_torch.ops.strings import row_chunks

    n, w = chars.shape
    dev = chars.device
    rep = torch.from_numpy(np.frombuffer(replacement, np.uint8).copy()).to(
        dev)
    w_out = w + max_matches * len(replacement) + 1
    out_len = torch.zeros((n,), dtype=torch.int32, device=dev)
    out = torch.zeros((n, w_out), dtype=torch.uint8, device=dev)
    overflowed = torch.zeros((), dtype=torch.bool, device=dev)
    if n == 0 or w == 0:
        return out_len, out, overflowed
    tabs = _device_tables(comp, dev)
    for r0, r1 in row_chunks(n, w + 1):
        overflowed |= _replace_impl(
            chars[r0:r1], lengths[r0:r1], out_len[r0:r1], out[r0:r1], comp,
            tabs, rep, max_matches)
    return out_len, out, overflowed
