"""Grammar-constrained decoding.

A token-level constraint subsystem: regex / JSON-schema frontends
compile to a character-level DFA, lifted to a token-level DFA over the
tokenizer vocab (per-state legal-token bitmasks, memoized by constraint
hash). Per-request :class:`ConstraintState` walks the DFA as tokens are
emitted; the mask is composed into ``sampling.filter_logits`` — the one
filter shared by greedy, sampled, and spec-decode verify paths — so
constrained speculation needs no new acceptance math, and FSM states
with a single legal continuation become free multi-token drafts.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Optional, Tuple

from orion_tpu_torch.constrain.dfa import ConstraintState, TokenDFA, \
    cache_clear, compile_token_dfa
from orion_tpu_torch.constrain.regex import CharDFA, ConstraintError, \
    compile_regex
from orion_tpu_torch.constrain.schema import schema_to_regex

__all__ = [
    "CharDFA", "ConstraintError", "ConstraintSpec", "ConstraintState",
    "TokenDFA", "cache_clear", "compile_constraint", "compile_regex",
    "compile_token_dfa", "schema_to_regex",
]


@dataclass(frozen=True)
class ConstraintSpec:
    """What a request asks to be constrained BY: exactly one frontend.

    ``regex`` is a pattern in the anchored subset ``constrain.regex``
    documents; ``json_schema`` is JSON text (kept as text so the spec
    stays hashable — it is parsed and canonicalized at compile time).
    """

    regex: Optional[str] = None
    json_schema: Optional[str] = None

    def __post_init__(self):
        have = [n for n, v in (("regex", self.regex),
                               ("json_schema", self.json_schema))
                if v is not None]
        if len(have) != 1:
            raise ConstraintError(
                f"ConstraintSpec needs exactly one of regex/json_schema,"
                f" got {have or 'neither'}"
            )
        picked = self.regex if self.regex is not None else \
            self.json_schema
        if not isinstance(picked, str) or not picked:
            raise ConstraintError(
                f"constraint {have[0]} must be a non-empty string, "
                f"got {picked!r}"
            )

    def pattern(self) -> str:
        """The anchored regex this spec denotes (schema frontends lower
        through :func:`schema_to_regex`)."""
        if self.regex is not None:
            return self.regex
        return schema_to_regex(self.json_schema)

    def canonical(self) -> str:
        if self.regex is not None:
            return f"regex:{self.regex}"
        parsed = json.loads(self.json_schema)
        return "schema:" + json.dumps(parsed, sort_keys=True,
                                      separators=(",", ":"))


def compile_constraint(
    spec: ConstraintSpec,
    vocab_size: int,
    *,
    max_states: int = 4096,
    cache_size: int = 32,
) -> Tuple[TokenDFA, bool]:
    """Compile a spec to its token DFA; ``(dfa, cache_hit)``. Raises
    :class:`ConstraintError` when the pattern is malformed or when no
    token in the vocab can begin a conforming emission (start-state dead
    end — the constraint is unserveable for this tokenizer)."""
    dfa, hit = compile_token_dfa(
        spec.pattern(), vocab_size,
        max_states=max_states, cache_size=cache_size,
    )
    if int(dfa.legal_count[dfa.start]) == 0 and \
            not bool(dfa.accepting[dfa.start]):
        raise ConstraintError(
            f"constraint {spec.canonical()[:80]!r} has no legal first "
            f"token in a vocab of {vocab_size} — unserveable here"
        )
    return dfa, hit
