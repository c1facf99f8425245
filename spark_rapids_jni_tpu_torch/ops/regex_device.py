"""Device regex engine (counterpart of the reference's
``ops/regex_device.py``): a host-compiled byte DFA, run on the device as
one table gather per byte position.

The compiler is the reference's, line for line (pure Python and numpy):
the pattern parses into a Thompson NFA over byte classes, and subset
construction turns it into a DFA of at most ``MAX_DFA_STATES`` states,
whose flattened int32 transition table and accept vector come out
identical to the reference's. Matching is encoded in the language: the
DFA recognizes ``.* P .*? SENTINEL any*`` (unanchored), where SENTINEL is
the 0x00 byte that ends every row, so ``$`` anchoring falls out and the
state after the last position is the verdict. A row that fills the
width gets one extra sentinel step (``ensure_sentinel``).

UTF-8 is desugared at compile time: ``.`` and negated classes expand to
byte-level alternations, so a multi-byte character counts as one.
Supported syntax: literals, ``.``, ``[...]`` classes with ranges,
negation and escapes, ``\\d \\D \\w \\W \\s \\S``, ``* + ? {m} {m,} {m,n}``,
``|``, ``(...)`` / ``(?:...)``, ``^`` at the pattern start and ``$`` at
its end. Anything else raises ``RegexUnsupported``, and
``ops.strings.regexp_contains`` hands the pattern to the host engine.

On the device the rows lie position-major, (W, n) (``ops.strings.
position_major``): step j is one 1-D gather of n lanes from a table of at
most 1025 x 256 int32 (1 MB, which stays in the L2). The state lanes are
int32 and hold ``state * 256``, so a step is one add and one
``index_select``.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

# compile-time guards
MAX_DFA_STATES = 1024
MAX_EXPANSION = 256  # {m,n} repetition budget


class RegexUnsupported(ValueError):
    """Pattern uses syntax outside the device subset (host fallback)."""


_SENTINEL = 0  # the padded layout's zero byte, doubles as end-of-string

# deliberately contains 0x00: only ever used as `_ANY_BYTE - {_SENTINEL}`
# or on the post-sentinel state
_ANY_BYTE = frozenset(range(256))
_ASCII_NO_NL = frozenset(range(1, 128)) - {0x0A}
_LEAD2 = frozenset(range(0xC2, 0xE0))
_LEAD3 = frozenset(range(0xE0, 0xF0))
_LEAD4 = frozenset(range(0xF0, 0xF5))
_CONT = frozenset(range(0x80, 0xC0))

_D = frozenset(range(0x30, 0x3A))
_W = (frozenset(range(0x30, 0x3A)) | frozenset(range(0x41, 0x5B))
      | frozenset(range(0x61, 0x7B)) | {0x5F})
_S = frozenset(b" \t\n\x0b\f\r")


# ---------------------------------------------------------------------------
# NFA (Thompson construction over byte classes)
# ---------------------------------------------------------------------------


class _Nfa:
    """States are ints; transitions either (byteset, target) consuming
    edges or epsilon edges."""

    def __init__(self):
        self.edges: list[list] = []      # state -> [(byteset|None, target)]

    def new_state(self) -> int:
        self.edges.append([])
        return len(self.edges) - 1

    def add(self, s: int, byteset, t: int) -> None:
        self.edges[s].append((byteset, t))


class _Frag(NamedTuple):
    start: int
    end: int  # single dangling accept per fragment (epsilon-joined)


def _char_frag(nfa: _Nfa, byteset: frozenset) -> _Frag:
    if _SENTINEL in byteset:
        # a pattern atom matching 0x00 would alias the end-of-row
        # sentinel and match across row boundaries
        raise RegexUnsupported("NUL byte in pattern")
    s, e = nfa.new_state(), nfa.new_state()
    nfa.add(s, byteset, e)
    return _Frag(s, e)


def _multibyte_char_frag(nfa: _Nfa) -> _Frag:
    """One full non-ASCII UTF-8 character (2-4 bytes)."""
    s, e = nfa.new_state(), nfa.new_state()
    # 2-byte
    m = nfa.new_state()
    nfa.add(s, _LEAD2, m)
    nfa.add(m, _CONT, e)
    # 3-byte
    m1, m2 = nfa.new_state(), nfa.new_state()
    nfa.add(s, _LEAD3, m1)
    nfa.add(m1, _CONT, m2)
    nfa.add(m2, _CONT, e)
    # 4-byte
    k1, k2, k3 = nfa.new_state(), nfa.new_state(), nfa.new_state()
    nfa.add(s, _LEAD4, k1)
    nfa.add(k1, _CONT, k2)
    nfa.add(k2, _CONT, k3)
    nfa.add(k3, _CONT, e)
    return _Frag(s, e)


def _any_char_frag(nfa: _Nfa) -> _Frag:
    """``.``: any character but newline (Java default)."""
    f = _multibyte_char_frag(nfa)
    nfa.add(f.start, _ASCII_NO_NL, f.end)
    return f


def _ascii_class_frag(nfa: _Nfa, byteset: frozenset,
                      negated: bool) -> _Frag:
    """A [...] class. Negated classes also match any multi-byte char
    (Java semantics: [^a] matches 'é')."""
    if not negated:
        return _char_frag(nfa, byteset)
    pos = frozenset(range(1, 128)) - byteset
    f = _multibyte_char_frag(nfa)
    if pos:
        nfa.add(f.start, pos, f.end)
    return f


# ---------------------------------------------------------------------------
# Parser (recursive descent over the supported subset)
# ---------------------------------------------------------------------------


class _Parser:
    def __init__(self, pattern: str, nfa: _Nfa):
        self.p = pattern
        self.i = 0
        self.nfa = nfa
        self.anchored_start = False
        self.anchored_end = False

    def peek(self):
        return self.p[self.i] if self.i < len(self.p) else None

    def take(self):
        c = self.peek()
        if c is None:
            raise RegexUnsupported("unexpected end of pattern")
        self.i += 1
        return c

    # -- grammar -----------------------------------------------------------
    def parse(self) -> _Frag:
        if self.peek() == "^":
            self.i += 1
            self.anchored_start = True
        frag = self.alt(top=True)
        if self.i < len(self.p):
            raise RegexUnsupported(
                f"unsupported syntax at offset {self.i}: {self.p[self.i:]!r}")
        return frag

    def alt(self, top: bool = False) -> _Frag:
        frags = [self.concat(top)]
        while self.peek() == "|":
            self.i += 1
            frags.append(self.concat(top))
        if top and len(frags) > 1 and (self.anchored_end
                                       or self.anchored_start):
            # `a|b$` / `^a|b` anchor only one branch in Java — the
            # global-anchor compile model can't express that; the host
            # engine handles them
            raise RegexUnsupported("anchor on one alternation branch")
        if len(frags) == 1:
            return frags[0]
        s, e = self.nfa.new_state(), self.nfa.new_state()
        for f in frags:
            self.nfa.add(s, None, f.start)
            self.nfa.add(f.end, None, e)
        return _Frag(s, e)

    def concat(self, top: bool = False) -> _Frag:
        frags: list[_Frag] = []
        while True:
            c = self.peek()
            if c is None or c in "|)":
                break
            if c == "$":
                # only valid as the very last pattern char (top level)
                if top and self.i == len(self.p) - 1:
                    self.i += 1
                    self.anchored_end = True
                    break
                raise RegexUnsupported("mid-pattern '$'")
            if c == "^":
                raise RegexUnsupported("mid-pattern '^'")
            frags.append(self.repeat())
        if not frags:
            s = self.nfa.new_state()
            return _Frag(s, s)
        for a, b in zip(frags, frags[1:]):
            self.nfa.add(a.end, None, b.start)
        return _Frag(frags[0].start, frags[-1].end)

    def repeat(self) -> _Frag:
        atom_start = self.i
        frag = self.atom()
        while True:
            c = self.peek()
            if c == "*":
                self.i += 1
                frag = self._star(frag)
            elif c == "+":
                self.i += 1
                # X+ = X X*  (rebuild X rather than aliasing the frag)
                again = self._reparse(atom_start)
                star = self._star(again)
                self.nfa.add(frag.end, None, star.start)
                frag = _Frag(frag.start, star.end)
            elif c == "?":
                self.i += 1
                self.nfa.add(frag.start, None, frag.end)
            elif c == "{":
                frag = self._bounded(frag, atom_start)
            else:
                return frag
            # reluctant/possessive quantifiers (X*?, X{2}?, X++) and
            # stacked repetitions (X{2}{3}, X**) — Java rejects most and
            # the naive re-application parse would change the language
            # for the rest (e.g. (X{2})? matches empty). Reject them all.
            if self.peek() in ("?", "+", "*", "{"):
                raise RegexUnsupported("stacked/reluctant quantifier")

    def _star(self, frag: _Frag) -> _Frag:
        s, e = self.nfa.new_state(), self.nfa.new_state()
        self.nfa.add(s, None, frag.start)
        self.nfa.add(s, None, e)
        self.nfa.add(frag.end, None, frag.start)
        self.nfa.add(frag.end, None, e)
        return _Frag(s, e)

    def _reparse(self, start: int) -> _Frag:
        """Re-run the parser over one atom's source to get a fresh copy
        (Thompson fragments are single-use)."""
        save = self.i
        self.i = start
        frag = self.atom()
        # the atom ends exactly where it ended the first time
        assert self.i <= save
        self.i = save
        return frag

    def _bounded(self, frag: _Frag, atom_start: int) -> _Frag:
        """{m} {m,} {m,n} by expansion (X{2,4} = XX X? X?)."""
        j = self.p.index("}", self.i) if "}" in self.p[self.i:] else -1
        if j < 0:
            raise RegexUnsupported("unterminated {")
        body = self.p[self.i + 1: j]
        self.i = j + 1
        # strict ASCII-digit grammar: {m} {m,} {m,n} and nothing else —
        # int()'s permissive parsing (whitespace, signs, fullwidth
        # digits, extra fields) would silently compile a language the
        # host engine treats as literal text
        import re as _re

        if not _re.fullmatch(r"[0-9]+(,[0-9]*)?", body):
            raise RegexUnsupported(f"bad repetition {{{body}}}")
        parts = body.split(",")
        lo = int(parts[0])
        hi = (lo if len(parts) == 1
              else (int(parts[1]) if parts[1] else None))
        if hi is not None and (hi < lo or lo < 0):
            raise RegexUnsupported(f"bad repetition {{{body}}}")
        if (hi or lo) > MAX_EXPANSION:
            raise RegexUnsupported("repetition too large for expansion")
        pieces: list[_Frag] = []
        for k in range(max(lo, 1) if lo else 0):
            pieces.append(self._reparse(atom_start) if (pieces or k)
                          else frag)
        if lo == 0 and hi is None:
            return self._star(frag)
        if hi is None:  # {m,}: last copy loops
            star = self._star(self._reparse(atom_start))
            pieces.append(star)
        else:
            for _ in range(hi - lo):
                opt = self._reparse(atom_start)
                self.nfa.add(opt.start, None, opt.end)  # optional
                pieces.append(opt)
            if lo == 0 and not pieces:
                s = self.nfa.new_state()
                return _Frag(s, s)
            if lo == 0:
                # all copies optional already
                pass
        for a, b in zip(pieces, pieces[1:]):
            self.nfa.add(a.end, None, b.start)
        return _Frag(pieces[0].start, pieces[-1].end)

    def atom(self) -> _Frag:
        c = self.take()
        if c == "(":
            if self.peek() == "?":
                self.i += 1
                nxt = self.take()
                if nxt != ":":
                    raise RegexUnsupported(f"(?{nxt} groups")
            frag = self.alt()
            if self.take() != ")":
                raise RegexUnsupported("unbalanced parenthesis")
            return frag
        if c == "[":
            return self._char_class()
        if c == ".":
            return _any_char_frag(self.nfa)
        if c == "\\":
            return self._escape()
        if c in "*+?{":
            raise RegexUnsupported(f"dangling quantifier {c!r}")
        b = c.encode()
        if len(b) == 1:
            return _char_frag(self.nfa, frozenset(b))
        # multi-byte literal: exact byte sequence
        frags = [_char_frag(self.nfa, frozenset([x])) for x in b]
        for a, bb in zip(frags, frags[1:]):
            self.nfa.add(a.end, None, bb.start)
        return _Frag(frags[0].start, frags[-1].end)

    def _escape(self) -> _Frag:
        c = self.take()
        if c in ("d", "w", "s"):
            return _char_frag(self.nfa, {"d": _D, "w": _W, "s": _S}[c])
        if c in ("D", "W", "S"):
            pos = {"D": _D, "W": _W, "S": _S}[c]
            return _ascii_class_frag(self.nfa, pos, negated=True)
        if c in "\\.[]()^$*+?{}|/":
            return _char_frag(self.nfa, frozenset(c.encode()))
        if c == "n":
            return _char_frag(self.nfa, frozenset(b"\n"))
        if c == "t":
            return _char_frag(self.nfa, frozenset(b"\t"))
        if c == "r":
            return _char_frag(self.nfa, frozenset(b"\r"))
        raise RegexUnsupported(f"escape \\{c}")

    def _class_escape(self) -> frozenset:
        c = self.take()
        if c == "d":
            return _D
        if c == "w":
            return _W
        if c == "s":
            return _S
        if c in "\\.[]()^$*+?{}|/-":
            return frozenset(c.encode())
        if c == "n":
            return frozenset(b"\n")
        if c == "t":
            return frozenset(b"\t")
        if c == "r":
            return frozenset(b"\r")
        raise RegexUnsupported(f"class escape \\{c}")

    def _char_class(self) -> _Frag:
        negated = False
        if self.peek() == "^":
            self.i += 1
            negated = True
        byteset: set = set()
        first = True
        while True:
            c = self.peek()
            if c is None:
                raise RegexUnsupported("unterminated character class")
            if c == "]" and not first:
                self.i += 1
                break
            first = False
            if c == "\\":
                self.i += 1
                byteset |= self._class_escape()
                continue
            if c == "[":
                # Java nested class — Python-style literal '[' would
                # silently change the language
                raise RegexUnsupported("nested character class")
            if c == "&" and self.i + 1 < len(self.p) \
                    and self.p[self.i + 1] == "&":
                raise RegexUnsupported("character class intersection")
            self.i += 1
            b = c.encode()
            if len(b) > 1:
                raise RegexUnsupported(
                    "non-ASCII character class member")
            lo = b[0]
            if self.peek() == "-" and self.i + 1 < len(self.p) \
                    and self.p[self.i + 1] != "]":
                self.i += 1
                hi_c = self.take()
                hb = hi_c.encode()
                if hb == b"\\" or len(hb) > 1:
                    raise RegexUnsupported("complex class range")
                if hb[0] < lo:
                    raise RegexUnsupported("inverted class range")
                byteset |= set(range(lo, hb[0] + 1))
            else:
                byteset.add(lo)
        return _ascii_class_frag(self.nfa, frozenset(byteset), negated)


# ---------------------------------------------------------------------------
# DFA (subset construction) + device table
# ---------------------------------------------------------------------------


class CompiledRegex(NamedTuple):
    table: np.ndarray    # int32[num_states * 256] flattened transitions
    accept: np.ndarray   # bool[num_states]
    num_states: int


def _closure(nfa: _Nfa, states: frozenset) -> frozenset:
    seen = set(states)
    stack = list(states)
    while stack:
        s = stack.pop()
        for byteset, t in nfa.edges[s]:
            if byteset is None and t not in seen:
                seen.add(t)
                stack.append(t)
    return frozenset(seen)


def compile_pattern(pattern: str) -> CompiledRegex:
    """Host compile: pattern -> byte DFA recognizing
    ``search(P) and end-of-row`` over zero-terminated padded rows.
    LRU-cached per pattern (immutable result); each lookup counts a hit
    or a miss in ``telemetry.record_compile_cache("regex_dfa")`` (an
    unsupported pattern raises out of the cache before it is counted)."""
    from spark_rapids_jni_tpu_torch import telemetry

    before = _compile_pattern_cached.cache_info().hits
    out = _compile_pattern_cached(pattern)
    hit = _compile_pattern_cached.cache_info().hits > before
    telemetry.record_compile_cache("regex_dfa", hit=hit)
    return out


@functools.lru_cache(maxsize=256)
def _compile_pattern_cached(pattern: str) -> CompiledRegex:
    nfa = _Nfa()
    parser = _Parser(pattern, nfa)
    frag = parser.parse()

    start = nfa.new_state()
    if not parser.anchored_start:
        # unanchored search: any-byte self-loop before the pattern
        nfa.add(start, _ANY_BYTE - {_SENTINEL}, start)
    nfa.add(start, None, frag.start)

    # after the pattern body: consume the rest (unless $-anchored), then
    # the 0x00 sentinel, then anything (the remaining padding)
    tail = nfa.new_state()
    nfa.add(frag.end, None, tail)
    if not parser.anchored_end:
        nfa.add(tail, _ANY_BYTE - {_SENTINEL}, tail)
    final = nfa.new_state()
    nfa.add(tail, frozenset([_SENTINEL]), final)
    if parser.anchored_end:
        # Java/Python '$' also matches just before a single trailing
        # line terminator: allow one optional '\n' before the sentinel
        nl = nfa.new_state()
        nfa.add(tail, frozenset(b"\n"), nl)
        nfa.add(nl, frozenset([_SENTINEL]), final)
    nfa.add(final, _ANY_BYTE, final)

    # subset construction
    d0 = _closure(nfa, frozenset([start]))
    ids = {d0: 0}
    order = [d0]
    trans: list[np.ndarray] = []
    qi = 0
    while qi < len(order):
        cur = order[qi]
        qi += 1
        # bytes with no live NFA move go to the DEAD state (id assigned
        # after construction) — defaulting to 0 would silently restart
        # an anchored search
        row = np.full(256, -1, dtype=np.int32)
        # per-byte move: union of consuming edges
        move: dict[int, set] = {}
        for s in cur:
            for byteset, t in nfa.edges[s]:
                if byteset is None:
                    continue
                for b in byteset:
                    move.setdefault(b, set()).add(t)
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
    table = np.concatenate(
        [table, np.full(256, dead, dtype=np.int32)])
    accept = np.array([final in st for st in order] + [False], dtype=bool)
    return CompiledRegex(table, accept, dead + 1)


# ---------------------------------------------------------------------------
# Device execution
# ---------------------------------------------------------------------------


def run_dfa_image(img: torch.Tensor, compiled: CompiledRegex,
                  ensure_sentinel: bool = True) -> torch.Tensor:
    """bool[n]: the DFA verdict per row of the position-major (W, n)
    uint8 image (row i's byte j at [j, i], zero past its length), on the
    image's device. One add and one gather of n lanes per position;
    ``ensure_sentinel`` adds a last step on the 0x00 byte, as the
    reference's extra zero column does (rows that fill W have no
    sentinel of their own)."""
    dev = img.device
    # scaled table: a lane holds state * 256, so state * 256 + byte is
    # one add (at most 1025 * 256, well inside int32)
    table = torch.from_numpy(compiled.table * 256).to(dev)
    state = torch.zeros(img.shape[1], dtype=torch.int32, device=dev)
    for j in range(int(img.shape[0])):
        state = torch.index_select(table, 0, torch.add(state, img[j]))
    if ensure_sentinel:
        state = torch.index_select(table, 0, state)
    accept = torch.from_numpy(compiled.accept).to(dev)
    return torch.index_select(accept, 0, state >> 8)


def run_dfa(chars: torch.Tensor, compiled: CompiledRegex,
            ensure_sentinel: bool = True) -> torch.Tensor:
    """bool[n]: the DFA verdict per row of the padded (n, W) char matrix
    (the reference's signature; see :func:`run_dfa_image`). Every row
    must end in a 0x00 sentinel: a caller that knows the widest row
    leaves padding slack passes ``ensure_sentinel=False``."""
    return run_dfa_image(chars.t().contiguous(), compiled, ensure_sentinel)
