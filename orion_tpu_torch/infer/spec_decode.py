"""Draft-model-free speculative decoding: prompt-lookup n-gram proposer.

A copy of ``orion_tpu/infer/spec_decode.py`` (pure Python, no framework),
kept in the port so that it imports nothing of the JAX package; the two
must stay equal (``tests/test_torch_spec_decode.py`` holds them so).

Decode is memory-bandwidth-bound — one full pass over the weights per
emitted token. Speculative decoding amortizes that
pass: propose K likely continuation tokens per request on the HOST, verify
all of them (plus the pending last token) in ONE device dispatch
(runner.verify_step — structurally the multi-token machinery decode_window
and mixed_step already proved out), and accept the matched prefix. On
self-repetitive text (code, structured output, a model whose greedy
continuation loops) one weight pass emits up to K+1 tokens.

This module is the drafting half, deliberately model-free (prompt lookup,
a.k.a. n-gram speculation): the last ``n`` tokens of a request's context
are matched against earlier positions of the request's own prompt+output —
and, when the prefix cache is on, against the radix tree's cached token
paths (cross-request reuse: a cached system-prompt + answer path predicts
the next request's continuation) — and the continuation of the most recent
match is the draft. No draft model, no extra weights, no device work:
drafting costs O(n_slots * ngram * context) python per step, which is
noise next to a dispatch.

Acceptance is computed by the engine from the verify logits: greedy
acceptance is exact argmax match (spec-on output byte-identical to
spec-off); sampled acceptance is rejection sampling against the filtered
target distribution (sampling.spec_verify_sample), so the served
distribution is provably unchanged.

The per-request draft length adapts (``SpecState``): halve on a
low-acceptance verify (wasted KV writes + rollback churn), double back on
full acceptance, always within [1, speculate_tokens]. A request whose
context has no n-gram match simply drafts nothing that step — and if NO
slot drafts, the engine falls back to the plain decode window (speculation
never costs a non-repetitive workload more than the proposal scan).

Token TREES (``inference.spec_tree_width`` > 1): the same lookup collects
up to ``tree_width`` DISTINCT continuations (``propose_ngram_candidates``)
and merges them into a trie (``build_tree`` -> ``DraftTree``) flattened
parent-before-child onto the static verify width. One dispatch verifies
every branch under a packed ancestor mask; the engine accepts the longest
verified root-path and compacts its KV if it was not the primary chain.
Depth rides the SAME adaptive controller — on traffic where the single
path keeps missing, the halved depth frees verify-width for siblings,
which is the regime where breadth beats depth.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterable, Optional, Sequence


def propose_ngram(
    context: Sequence[int],
    k: int,
    *,
    max_n: int = 3,
    min_n: int = 1,
    extra_sources: Iterable[Sequence[int]] = (),
) -> list[int]:
    """Up to ``k`` draft tokens continuing ``context`` by prompt lookup.

    For ``n`` from ``max_n`` down to ``min_n``: find the MOST RECENT
    earlier occurrence of the context's last ``n`` tokens — first inside
    ``context`` itself, then in each of ``extra_sources`` (e.g. the prefix
    cache's token paths) — and return the tokens that followed it. Longer
    n-grams are tried first (a longer match is a stronger continuation
    signal); the in-context match wins over external sources at equal n
    (the request's own history is the better predictor of its own loop).
    """
    if k <= 0:
        return []
    L = len(context)
    max_n = min(max_n, L - 1)
    for n in range(max_n, min_n - 1, -1):
        suffix = list(context[L - n:])
        first = suffix[0]
        # Most recent occurrence strictly before the suffix itself, so a
        # continuation exists: context[i : i+n] == suffix with i+n < L.
        # The hot loop is a first-token compare per position (no slice
        # allocation); the full n-gram compare runs only on candidates —
        # this scan sits on the ITL-critical host path every decode step.
        for i in range(L - n - 1, -1, -1):
            if context[i] == first and list(context[i:i + n]) == suffix:
                return list(context[i + n:i + n + k])
        for src in extra_sources:
            S = len(src)
            for i in range(S - n - 1, -1, -1):
                if src[i] == first and list(src[i:i + n]) == suffix:
                    return list(src[i + n:i + n + k])
    return []


def propose_ngram_candidates(
    context: Sequence[int],
    k: int,
    *,
    max_n: int = 3,
    min_n: int = 1,
    extra_sources: Iterable[Sequence[int]] = (),
    max_candidates: int = 4,
) -> list[list[int]]:
    """Up to ``max_candidates`` DISTINCT continuations of ``context`` by
    prompt lookup, best-first.

    Same search order as ``propose_ngram`` — longer n-grams before
    shorter, in-context matches before external sources, most recent
    occurrence first — but instead of stopping at the first hit it keeps
    collecting distinct continuations, so the FIRST candidate is exactly
    the chain proposal and later candidates are the alternatives a
    single-path draft had to bet against. A continuation that is a
    prefix of an already-collected one adds nothing (its nodes are
    already in the tree) and is skipped.
    """
    if k <= 0:
        return []
    L = len(context)
    max_n = min(max_n, L - 1)
    cands: list[list[int]] = []

    def add(cont: list[int]) -> bool:
        """True once the candidate budget is exhausted."""
        if cont and not any(
            cand[: len(cont)] == cont for cand in cands
        ):
            cands.append(cont)
        return len(cands) >= max_candidates

    for n in range(max_n, min_n - 1, -1):
        suffix = list(context[L - n:])
        first = suffix[0]
        for i in range(L - n - 1, -1, -1):
            if context[i] == first and list(context[i:i + n]) == suffix:
                if add(list(context[i + n:i + n + k])):
                    return cands
        for src in extra_sources:
            S = len(src)
            for i in range(S - n - 1, -1, -1):
                if src[i] == first and list(src[i:i + n]) == suffix:
                    if add(list(src[i + n:i + n + k])):
                        return cands
    return cands


@dataclass
class DraftTree:
    """A token tree flattened to the static verify layout.

    Column 0 of the verify row is the slot's pending last token (the
    tree's root — it is NOT in ``tokens``); node i of the tree occupies
    column i + 1 and ``parents[i]`` is the COLUMN of its parent (0 for
    the root's children). Nodes are stored parent-before-child, and the
    FIRST inserted candidate chain occupies contiguous columns 1..d —
    so when the primary chain is the accepted path, acceptance needs no
    KV compaction (columns already equal depths), exactly the
    single-path layout.
    """

    tokens: list[int] = field(default_factory=list)
    parents: list[int] = field(default_factory=list)

    def __len__(self) -> int:
        return len(self.tokens)

    def depths(self) -> list[int]:
        """Depth per COLUMN (0..len), root column included (depth 0)."""
        d = [0]
        for p in self.parents:
            d.append(d[p] + 1)
        return d

    @property
    def max_depth(self) -> int:
        return max(self.depths())

    def mask_words(self) -> list[int]:
        """Packed ancestor mask per COLUMN: bit i of word j is set iff
        column j may attend the KV written at column i — its ancestors,
        the root, and itself. Chain-degenerate trees produce the causal
        words ``(1 << (j+1)) - 1``, the mask today's W-query verify
        applies implicitly. Columns must fit an int32 word
        (``len(tokens) + 1 <= 31``; the engine validates at init)."""
        words = [1]
        for j, p in enumerate(self.parents):
            words.append(words[p] | (1 << (j + 1)))
        return words

    def children(self) -> list[list[int]]:
        """Child COLUMNS per column, in insertion (priority) order —
        the order the engine's acceptance walk tries siblings in."""
        ch: list[list[int]] = [[] for _ in range(len(self.tokens) + 1)]
        for i, p in enumerate(self.parents):
            ch[p].append(i + 1)
        return ch

    @staticmethod
    def chain(tokens: Sequence[int]) -> "DraftTree":
        return DraftTree(list(tokens), list(range(len(tokens))))


def build_tree(candidates: list[list[int]], budget: int) -> DraftTree:
    """Merge candidate chains into a token trie of at most ``budget``
    nodes. Chains insert in priority order, sharing common prefixes and
    branching where they diverge; a chain that hits the node budget is
    truncated (its prefix may still have merged). Duplicate sibling
    tokens are merged by construction, so the acceptance walk never has
    two children matching the same verified token."""
    tree = DraftTree()
    child_of: dict[tuple[int, int], int] = {}
    for chain in candidates:
        col = 0
        for t in chain:
            nxt = child_of.get((col, t))
            if nxt is None:
                if len(tree.tokens) >= budget:
                    break
                tree.tokens.append(t)
                tree.parents.append(col)
                nxt = len(tree.tokens)
                child_of[(col, t)] = nxt
            col = nxt
    return tree


@dataclass
class SpecState:
    """Per-request adaptive draft length + lifetime acceptance counters.

    ``miss_streak``/``cooldown`` back the proposal-scan throttle: the
    n-gram scan is O(context) host work, and the workload that never
    matches is exactly the one that gains nothing from paying it every
    step. The first three misses rescan every step — right after prefill
    is when a repetition first establishes, so early throttling would
    delay real draft onset — then consecutive misses back off linearly
    (skip ``min(miss_streak - 3, 8)`` steps before rescanning), bounding
    steady-state non-repetitive traffic at ~1/8th of the scan cost; a
    hit resets the streak. The throttle never changes emitted tokens
    (speculation is output-invariant by construction)."""

    draft_len: int
    drafted: int = 0
    accepted: int = 0
    miss_streak: int = 0
    cooldown: int = 0

    def update(self, drafted: int, accepted: int, cap: int) -> None:
        """Adapt after one verify: halve on low acceptance (< half the
        drafts landed — the rejected tail is pure rollback churn), double
        back on full acceptance, clamp to [1, cap]. No-draft steps leave
        the length untouched (nothing was learned)."""
        if drafted <= 0:
            return
        self.drafted += drafted
        self.accepted += accepted
        if accepted >= drafted:
            self.draft_len = min(self.draft_len * 2, cap)
        elif accepted * 2 < drafted:
            self.draft_len = max(self.draft_len // 2, 1)


class NgramProposer:
    """Engine-facing proposer: owns the n-gram parameters and the
    per-request SpecState table (keyed by rid; dropped when the request
    leaves — a preempted request that re-enters restarts its adaptation
    from the configured cap, matching its re-prefilled cold start)."""

    def __init__(
        self,
        *,
        speculate_tokens: int,
        max_n: int,
        min_n: int,
        tree_width: int = 1,
    ):
        if speculate_tokens < 1:
            raise ValueError(
                f"speculate_tokens must be >= 1, got {speculate_tokens}"
            )
        if not 1 <= min_n <= max_n:
            raise ValueError(
                f"need 1 <= spec_ngram_min <= spec_ngram_max, got "
                f"[{min_n}, {max_n}]"
            )
        if tree_width < 1:
            raise ValueError(
                f"spec_tree_width must be >= 1, got {tree_width}"
            )
        self.cap = speculate_tokens
        self.max_n = max_n
        self.min_n = min_n
        self.tree_width = tree_width
        self._states: dict[int, SpecState] = {}

    def state(self, rid: int) -> SpecState:
        st = self._states.get(rid)
        if st is None:
            st = self._states[rid] = SpecState(draft_len=self.cap)
        return st

    def drop(self, rid: int) -> None:
        self._states.pop(rid, None)

    def propose(
        self,
        rid: int,
        context: Sequence[int],
        limit: int,
        extra_sources: Iterable[Sequence[int]] = (),
    ) -> list[int]:
        """Draft for one request: n-gram lookup capped by the adaptive
        per-request length AND the caller's ``limit`` (context-window /
        budget headroom), throttled after consecutive misses (see
        SpecState)."""
        st = self.state(rid)
        if st.cooldown > 0:
            st.cooldown -= 1
            return []
        k = min(st.draft_len, limit)
        d = propose_ngram(
            context, k, max_n=self.max_n, min_n=self.min_n,
            extra_sources=extra_sources,
        )
        if d:
            st.miss_streak = 0
        else:
            st.miss_streak += 1
            st.cooldown = max(0, min(st.miss_streak - 3, 8))
        return d

    def propose_tree(
        self,
        rid: int,
        context: Sequence[int],
        limit: int,
        extra_sources: Iterable[Sequence[int]] = (),
    ) -> Optional[DraftTree]:
        """Tree drafting (inference.spec_tree_width > 1): up to
        ``tree_width`` distinct n-gram continuations merged into a token
        trie of at most ``min(speculate_tokens, limit)`` nodes.

        The per-candidate DEPTH rides the same acceptance-driven
        adaptive length as the chain proposer (``SpecState.draft_len``):
        on traffic where the single path keeps being rejected, the
        controller halves the depth — and the freed verify-width budget
        turns into sibling branches, which is exactly the regime where
        breadth beats depth. On fully-accepting (looping) traffic the
        depth grows back to the cap and the tree degenerates to the
        chain. The miss-streak scan throttle is shared with ``propose``.
        Returns None on a no-draft step."""
        st = self.state(rid)
        if st.cooldown > 0:
            st.cooldown -= 1
            return None
        k = min(st.draft_len, limit)
        cands = propose_ngram_candidates(
            context, k, max_n=self.max_n, min_n=self.min_n,
            extra_sources=extra_sources, max_candidates=self.tree_width,
        )
        if not cands:
            st.miss_streak += 1
            st.cooldown = max(0, min(st.miss_streak - 3, 8))
            return None
        st.miss_streak = 0
        budget = min(self.cap, limit)
        if len(cands) > 1:
            # Real ambiguity must materialize as branches even when the
            # adaptive depth fills the node budget: reserve one node per
            # alternative candidate by trimming the primary chain's tail
            # — the bet breadth makes is exactly that the trimmed tail's
            # expected yield is lower than a sibling's when the n-gram
            # evidence is split. Alternatives that share their prefix
            # with the primary merge in the trie and give the room back.
            head = max(1, budget - (len(cands) - 1))
            cands = [cands[0][:head]] + cands[1:]
        tree = build_tree(cands, budget)
        return tree if len(tree) else None
