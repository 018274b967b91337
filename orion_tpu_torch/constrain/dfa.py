"""Token-level DFA: lift the character DFA to the tokenizer vocab.

The tokenizer here is the stack's byte-level one (token id == byte
value, ``model.vocab_size <= 256``), so a token is one byte and the
lift is a direct table read; ``token_bytes`` generalizes to multi-byte
vocabularies (walk each token's bytes through the char DFA; any token
whose walk falls off the DFA is illegal in that state).

Compiled artifacts are memoized by constraint hash + vocab size in a
module-level LRU, so N requests carrying the same JSON schema share one
compile (the compile is the expensive part: subset construction plus an
S x V table build).
"""

from __future__ import annotations

import hashlib
from collections import OrderedDict
from dataclasses import dataclass, field
from threading import Lock
from typing import Callable, List, Optional, Tuple

import numpy as np

from orion_tpu_torch.constrain.regex import CharDFA, ConstraintError, \
    compile_regex

__all__ = ["TokenDFA", "ConstraintState", "compile_token_dfa",
           "cache_clear"]


def _byte_token(t: int) -> Optional[bytes]:
    """Default token->bytes map for the byte tokenizer."""
    return bytes([t]) if t < 256 else None


@dataclass
class TokenDFA:
    """Per-state legal-token tables. ``next_state[s, t] < 0`` means
    token ``t`` is illegal in state ``s``; ``legal`` is the bitmask the
    sampler consumes; ``only_token[s]`` is the forced continuation when
    ``legal_count[s] == 1`` (the free-draft states)."""

    next_state: np.ndarray   # int32 [S, V]
    accepting: np.ndarray    # bool  [S]
    start: int
    pattern_sha: str
    legal: np.ndarray = field(init=False)        # bool  [S, V]
    legal_count: np.ndarray = field(init=False)  # int32 [S]
    only_token: np.ndarray = field(init=False)   # int32 [S]

    def __post_init__(self):
        self.legal = self.next_state >= 0
        self.legal_count = self.legal.sum(axis=1).astype(np.int32)
        self.only_token = self.legal.argmax(axis=1).astype(np.int32)

    @property
    def n_states(self) -> int:
        return int(self.next_state.shape[0])

    @property
    def vocab_size(self) -> int:
        return int(self.next_state.shape[1])


def _lift(cdfa: CharDFA, vocab_size: int,
          token_bytes: Optional[Callable[[int], Optional[bytes]]],
          pattern_sha: str) -> TokenDFA:
    token_bytes = token_bytes or _byte_token
    S = cdfa.n_states
    next_state = np.full((S, vocab_size), -1, np.int32)
    walks: List[Optional[Tuple[int, ...]]] = []
    for t in range(vocab_size):
        bs = token_bytes(t)
        walks.append(tuple(bs) if bs else None)
    for s in range(S):
        for t, bs in enumerate(walks):
            if bs is None:
                continue
            cur: Optional[int] = s
            for b in bs:
                cur = cdfa.trans[cur].get(b)
                if cur is None:
                    break
            if cur is not None:
                next_state[s, t] = cur
    return TokenDFA(
        next_state=next_state,
        accepting=np.asarray(cdfa.accepting, bool),
        start=0,
        pattern_sha=pattern_sha,
    )


# --------------------------------------------------------------------------
# Memoized compile
# --------------------------------------------------------------------------

_CACHE: "OrderedDict[tuple, TokenDFA]" = OrderedDict()
_CACHE_LOCK = Lock()


def cache_clear() -> None:
    with _CACHE_LOCK:
        _CACHE.clear()


def compile_token_dfa(
    pattern: str,
    vocab_size: int,
    *,
    max_states: int = 4096,
    cache_size: int = 32,
    token_bytes: Optional[Callable[[int], Optional[bytes]]] = None,
) -> Tuple[TokenDFA, bool]:
    """Compile ``pattern`` to a token DFA; returns ``(dfa, cache_hit)``.

    Memoized by sha256(pattern) + vocab size so repeated schemas across
    requests share one artifact. A ``token_bytes`` override bypasses the
    cache (the key has no way to identify the callable's behavior).
    """
    sha = hashlib.sha256(pattern.encode("utf-8")).hexdigest()
    key = (sha, vocab_size, max_states)
    if token_bytes is None:
        with _CACHE_LOCK:
            hit = _CACHE.get(key)
            if hit is not None:
                _CACHE.move_to_end(key)
                return hit, True
    cdfa = compile_regex(pattern, max_states=max_states)
    dfa = _lift(cdfa, vocab_size, token_bytes, sha)
    if token_bytes is None:
        with _CACHE_LOCK:
            _CACHE[key] = dfa
            while len(_CACHE) > max(1, cache_size):
                _CACHE.popitem(last=False)
    return dfa, False


# --------------------------------------------------------------------------
# Per-request runtime state
# --------------------------------------------------------------------------


class ConstraintState:
    """One request's walk through the token DFA. Pure host state riding
    the Request, so it survives preemption/rollback (the re-prefill
    replays prompt + generated; ``sync`` re-walks ``generated`` if the
    advance count ever disagrees, e.g. after a router resubmission)."""

    __slots__ = ("dfa", "eos_id", "state", "n_advanced")

    def __init__(self, dfa: TokenDFA, eos_id: Optional[int] = None):
        self.dfa = dfa
        self.eos_id = eos_id if eos_id is not None and \
            eos_id < dfa.vocab_size else None
        self.state = dfa.start
        self.n_advanced = 0

    # -- masks -------------------------------------------------------------

    def mask_row(self, state: Optional[int] = None) -> np.ndarray:
        """Legal-token bitmask at ``state`` (default: current), with eos
        added once the constraint is satisfiable-complete (accepting
        states may either continue the pattern or stop)."""
        s = self.state if state is None else state
        row = self.dfa.legal[s].copy()
        if self.eos_id is not None and self.dfa.accepting[s]:
            row[self.eos_id] = True
        return row

    def mask_choices(self, state: Optional[int] = None) -> int:
        """How many tokens the mask at ``state`` admits (legal
        continuations plus the eos alternative in accepting states)."""
        s = self.state if state is None else state
        c = int(self.dfa.legal_count[s])
        if self.eos_id is not None and self.dfa.accepting[s] \
                and not (self.dfa.legal[s, self.eos_id]):
            c += 1
        return c

    # -- walking -----------------------------------------------------------

    def peek(self, tok: int, state: Optional[int] = None) -> int:
        """Next DFA state after ``tok`` (or -1 illegal) without moving."""
        s = self.state if state is None else state
        if tok == self.eos_id and self.dfa.accepting[s]:
            return s  # eos closes an accepting walk in place
        if 0 <= tok < self.dfa.vocab_size:
            return int(self.dfa.next_state[s, tok])
        return -1

    def advance(self, tok: int) -> bool:
        """Consume one emitted token; returns False if it was illegal
        (the caller quarantines — this only happens when something
        upstream bypassed the mask)."""
        nxt = self.peek(tok)
        if nxt < 0:
            return False
        self.state = nxt
        self.n_advanced += 1
        return True

    def walk(self, toks, state: Optional[int] = None) -> int:
        """End state after consuming ``toks`` from ``state`` (default:
        current) without moving the cursor; -1 once any step is illegal."""
        s = self.state if state is None else state
        for tok in toks:
            if s < 0:
                return -1
            s = self.peek(int(tok), s)
        return s

    def sync(self, generated) -> bool:
        """Re-walk ``generated`` from the start state when the advance
        count disagrees (failover/replay safety). Returns False if the
        replay hits an illegal token."""
        if self.n_advanced == len(generated):
            return True
        self.state = self.dfa.start
        self.n_advanced = 0
        for tok in generated:
            if not self.advance(int(tok)):
                return False
        return True

    # -- terminal classification -------------------------------------------

    def is_complete(self) -> bool:
        """Accepting with no legal continuation: the only move is to
        stop — the engine finishes the request without burning a step."""
        return bool(self.dfa.accepting[self.state]) and \
            int(self.dfa.legal_count[self.state]) == 0

    def is_dead(self) -> bool:
        """Non-accepting with no legal continuation: no emission can
        ever satisfy the constraint (vocab can't spell the pattern)."""
        return not self.dfa.accepting[self.state] and \
            int(self.dfa.legal_count[self.state]) == 0

    # -- speculation hooks -------------------------------------------------

    def forced_run(self, limit: int,
                   state: Optional[int] = None) -> List[int]:
        """The run of single-choice continuations from ``state``
        (default: current): states whose mask admits exactly one token
        emit that token for free (guaranteed acceptance — the masked
        target probability is exactly 1.0). Does not move the state."""
        out: List[int] = []
        s = self.state if state is None else state
        while len(out) < limit and self.mask_choices(s) == 1:
            if int(self.dfa.legal_count[s]) == 1:
                tok = int(self.dfa.only_token[s])
                out.append(tok)
                s = int(self.dfa.next_state[s, tok])
            else:
                # Accepting dead end whose single choice is eos.
                out.append(self.eos_id)  # type: ignore[arg-type]
                break
        return out

    def branch_tokens(self, width: int,
                      state: Optional[int] = None) -> List[int]:
        """Up to ``width`` legal tokens at an ambiguous state — the FSM
        branch points that feed ``spec_decode.build_tree``."""
        s = self.state if state is None else state
        toks = np.flatnonzero(self.dfa.legal[s])[:width]
        return [int(t) for t in toks]
