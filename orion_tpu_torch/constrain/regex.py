"""Regex frontend: a full-match-anchored regex subset compiled to a
character-level DFA over the byte alphabet.

Supported syntax (the subset structured-output schemas actually need):
literals (non-ASCII encoded as their UTF-8 byte sequence), escapes
(``\\d \\D \\w \\W \\s \\S \\n \\t \\r \\f \\v \\0 \\xHH`` and
escaped metacharacters), character classes ``[...]`` with ranges and
``^`` negation, ``.`` (any byte except newline), alternation ``|``,
groups ``(...)``, and quantifiers ``* + ? {m} {m,} {m,n}``.

Patterns are implicitly anchored at both ends — constrained decoding
matches the WHOLE emission, so ``a+`` means "the output is one or more
'a' bytes", not "contains". Bounded repeats are expanded (Thompson
construction has no counters); the expansion is capped so a hostile
``{1,100000}`` fails fast instead of building a million states.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Set, Tuple

__all__ = ["ConstraintError", "compile_regex", "CharDFA"]

# One bounded repeat may expand to at most this many copies of its body;
# the DFA state cap (inference.constraint_max_states) bounds the rest.
_MAX_REPEAT = 1024

_ALL_BYTES = frozenset(range(256))
_DOT = frozenset(b for b in range(256) if b != 0x0A)
_DIGIT = frozenset(range(0x30, 0x3A))
_WORD = frozenset(
    list(range(0x30, 0x3A)) + list(range(0x41, 0x5B))
    + list(range(0x61, 0x7B)) + [0x5F]
)
_SPACE = frozenset(b" \t\n\r\f\v")

_CLASS_ESCAPES = {
    "d": _DIGIT, "D": _ALL_BYTES - _DIGIT,
    "w": _WORD, "W": _ALL_BYTES - _WORD,
    "s": _SPACE, "S": _ALL_BYTES - _SPACE,
}
_CHAR_ESCAPES = {
    "n": 0x0A, "t": 0x09, "r": 0x0D, "f": 0x0C, "v": 0x0B, "0": 0x00,
    "a": 0x07, "b": 0x08, "e": 0x1B,
}


class ConstraintError(ValueError):
    """Typed compile/validation error for the constraint subsystem —
    malformed pattern, unsupported schema, state-cap blowout, or a
    constraint no token in the vocab can ever satisfy."""


# --------------------------------------------------------------------------
# AST
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class _Lit:
    bytes_: frozenset  # set of legal byte values for ONE position


@dataclass(frozen=True)
class _Concat:
    parts: tuple


@dataclass(frozen=True)
class _Alt:
    options: tuple


@dataclass(frozen=True)
class _Star:
    inner: object


@dataclass(frozen=True)
class _Repeat:
    inner: object
    lo: int
    hi: Optional[int]  # None = unbounded


class _Parser:
    """Recursive-descent parser for the subset above."""

    def __init__(self, pattern: str):
        self.p = pattern
        self.i = 0

    def _err(self, msg: str) -> ConstraintError:
        return ConstraintError(
            f"regex parse error at offset {self.i}: {msg} "
            f"(pattern {self.p!r})"
        )

    def _peek(self) -> Optional[str]:
        return self.p[self.i] if self.i < len(self.p) else None

    def _next(self) -> str:
        if self.i >= len(self.p):
            raise self._err("unexpected end of pattern")
        c = self.p[self.i]
        self.i += 1
        return c

    def parse(self):
        node = self._alternation()
        if self.i != len(self.p):
            raise self._err(f"unexpected {self.p[self.i]!r}")
        return node

    def _alternation(self):
        options = [self._concat()]
        while self._peek() == "|":
            self._next()
            options.append(self._concat())
        if len(options) == 1:
            return options[0]
        return _Alt(tuple(options))

    def _concat(self):
        parts = []
        while self._peek() is not None and self._peek() not in "|)":
            parts.append(self._repeat())
        if len(parts) == 1:
            return parts[0]
        return _Concat(tuple(parts))

    def _repeat(self):
        node = self._atom()
        while True:
            c = self._peek()
            if c == "*":
                self._next()
                node = _Star(node)
            elif c == "+":
                self._next()
                node = _Concat((node, _Star(node)))
            elif c == "?":
                self._next()
                node = _Repeat(node, 0, 1)
            elif c == "{":
                node = self._braces(node)
            else:
                return node

    def _braces(self, node):
        save = self.i
        self._next()  # '{'
        digits = ""
        while self._peek() is not None and self._peek().isdigit():
            digits += self._next()
        if not digits:
            # A literal '{' (e.g. in a JSON pattern) — backtrack.
            self.i = save
            self._next()
            return _Concat((node, _Lit(frozenset([0x7B]))))
        lo = int(digits)
        hi: Optional[int] = lo
        if self._peek() == ",":
            self._next()
            digits = ""
            while self._peek() is not None and self._peek().isdigit():
                digits += self._next()
            hi = int(digits) if digits else None
        if self._next() != "}":
            raise self._err("unterminated {m,n} quantifier")
        if hi is not None and hi < lo:
            raise self._err(f"bad repeat bounds {{{lo},{hi}}}")
        if max(lo, hi or 0) > _MAX_REPEAT:
            raise self._err(
                f"repeat bound exceeds cap {_MAX_REPEAT} (expanded "
                f"construction; tighten the pattern)"
            )
        return _Repeat(node, lo, hi)

    def _atom(self):
        c = self._next()
        if c == "(":
            node = self._alternation()
            if self._peek() != ")":
                raise self._err("unterminated group")
            self._next()
            return node
        if c == "[":
            return _Lit(self._char_class())
        if c == ".":
            return _Lit(_DOT)
        if c == "\\":
            return _Lit(self._escape(in_class=False))
        if c in "*+?)":
            raise self._err(f"dangling {c!r}")
        # Multi-byte UTF-8 literals become a byte-sequence concat.
        enc = c.encode("utf-8")
        if len(enc) == 1:
            return _Lit(frozenset([enc[0]]))
        return _Concat(tuple(_Lit(frozenset([b])) for b in enc))

    def _escape(self, in_class: bool) -> frozenset:
        c = self._next()
        if c in _CLASS_ESCAPES:
            return _CLASS_ESCAPES[c]
        if c in _CHAR_ESCAPES and not (in_class and c == "b"):
            return frozenset([_CHAR_ESCAPES[c]])
        if c == "x":
            hex_ = self._next() + self._next()
            try:
                return frozenset([int(hex_, 16)])
            except ValueError:
                raise self._err(f"bad \\x escape {hex_!r}")
        enc = c.encode("utf-8")
        if len(enc) != 1:
            raise self._err(f"cannot escape multi-byte char {c!r}")
        return frozenset([enc[0]])

    def _char_class(self) -> frozenset:
        negate = False
        if self._peek() == "^":
            self._next()
            negate = True
        members: Set[int] = set()
        first = True
        while True:
            c = self._peek()
            if c is None:
                raise self._err("unterminated character class")
            if c == "]" and not first:
                self._next()
                break
            first = False
            self._next()
            if c == "\\":
                got = self._escape(in_class=True)
                if len(got) > 1:
                    members |= got  # \d-style class escape: no ranges
                    continue
                lo = next(iter(got))
            else:
                enc = c.encode("utf-8")
                if len(enc) != 1:
                    raise self._err(
                        f"multi-byte char {c!r} in class (use \\xHH "
                        f"byte ranges for non-ASCII)"
                    )
                lo = enc[0]
            if self._peek() == "-" and self.i + 1 < len(self.p) \
                    and self.p[self.i + 1] != "]":
                self._next()  # '-'
                hc = self._next()
                if hc == "\\":
                    got = self._escape(in_class=True)
                    if len(got) != 1:
                        raise self._err("class escape cannot end a range")
                    hi = next(iter(got))
                else:
                    enc = hc.encode("utf-8")
                    if len(enc) != 1:
                        raise self._err("multi-byte char ends a range")
                    hi = enc[0]
                if hi < lo:
                    raise self._err(f"reversed range {chr(lo)}-{chr(hi)}")
                members |= set(range(lo, hi + 1))
            else:
                members.add(lo)
        out = frozenset(members)
        return frozenset(_ALL_BYTES - out) if negate else out


# --------------------------------------------------------------------------
# Thompson NFA + subset construction
# --------------------------------------------------------------------------


class _NFA:
    def __init__(self):
        self.edges: List[List[Tuple[frozenset, int]]] = []
        self.eps: List[List[int]] = []

    def state(self) -> int:
        self.edges.append([])
        self.eps.append([])
        return len(self.edges) - 1


def _build(nfa: _NFA, node) -> Tuple[int, int]:
    """Thompson fragment: returns (start, accept) state ids."""
    if isinstance(node, _Lit):
        s, e = nfa.state(), nfa.state()
        if node.bytes_:
            nfa.edges[s].append((node.bytes_, e))
        else:
            raise ConstraintError("empty character class matches nothing")
        return s, e
    if isinstance(node, _Concat):
        if not node.parts:
            s = nfa.state()
            return s, s
        s, e = _build(nfa, node.parts[0])
        for part in node.parts[1:]:
            s2, e2 = _build(nfa, part)
            nfa.eps[e].append(s2)
            e = e2
        return s, e
    if isinstance(node, _Alt):
        s, e = nfa.state(), nfa.state()
        for opt in node.options:
            os_, oe = _build(nfa, opt)
            nfa.eps[s].append(os_)
            nfa.eps[oe].append(e)
        return s, e
    if isinstance(node, _Star):
        s, e = nfa.state(), nfa.state()
        is_, ie = _build(nfa, node.inner)
        nfa.eps[s] += [is_, e]
        nfa.eps[ie] += [is_, e]
        return s, e
    if isinstance(node, _Repeat):
        lo, hi = node.lo, node.hi
        if lo == 0 and hi == 1:
            s, e = nfa.state(), nfa.state()
            is_, ie = _build(nfa, node.inner)
            nfa.eps[s] += [is_, e]
            nfa.eps[ie].append(e)
            return s, e
        parts: List[object] = [node.inner] * lo
        if hi is None:
            parts.append(_Star(node.inner))
        else:
            parts += [_Repeat(node.inner, 0, 1)] * (hi - lo)
        if not parts:  # {0,0}
            s = nfa.state()
            return s, s
        return _build(nfa, _Concat(tuple(parts)))
    raise ConstraintError(f"unknown AST node {node!r}")


@dataclass
class CharDFA:
    """Character-level DFA over the byte alphabet: ``trans[s]`` maps a
    byte value to the next state (absent = illegal), state 0 is the
    start."""

    trans: List[dict]
    accepting: List[bool]

    @property
    def n_states(self) -> int:
        return len(self.trans)


def _eps_closure(nfa: _NFA, states: frozenset) -> frozenset:
    seen = set(states)
    stack = list(states)
    while stack:
        s = stack.pop()
        for t in nfa.eps[s]:
            if t not in seen:
                seen.add(t)
                stack.append(t)
    return frozenset(seen)


def compile_regex(pattern: str, max_states: int = 4096) -> CharDFA:
    """Parse ``pattern`` and subset-construct its byte-level DFA. Raises
    :class:`ConstraintError` on syntax errors or when the DFA exceeds
    ``max_states`` (the inference.constraint_max_states knob)."""
    ast = _Parser(pattern).parse()
    nfa = _NFA()
    start, accept = _build(nfa, ast)

    d0 = _eps_closure(nfa, frozenset([start]))
    ids = {d0: 0}
    order = [d0]
    trans: List[dict] = [{}]
    accepting = [accept in d0]
    i = 0
    while i < len(order):
        cur = order[i]
        move: dict = {}
        for s in cur:
            for byteset, tgt in nfa.edges[s]:
                for b in byteset:
                    move.setdefault(b, set()).add(tgt)
        for b, tgts in move.items():
            nxt = _eps_closure(nfa, frozenset(tgts))
            if nxt not in ids:
                if len(ids) >= max_states:
                    raise ConstraintError(
                        f"constraint DFA exceeds max_states="
                        f"{max_states}; raise inference."
                        f"constraint_max_states or simplify the pattern"
                    )
                ids[nxt] = len(order)
                order.append(nxt)
                trans.append({})
                accepting.append(accept in nxt)
            trans[i][b] = ids[nxt]
        i += 1
    return CharDFA(trans=trans, accepting=accepting)
