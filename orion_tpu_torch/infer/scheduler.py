"""Scheduler face of the serving engine: the ``Request`` record.

Counterpart of ``orion_tpu/infer/scheduler.py`` for the engine core with
the prefix-cache and chunked-prefill state; priorities, deadlines,
overload shedding and host-tier state are not ported yet (the engine
admits in arrival order from a plain deque and preempts the youngest
request).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional


@dataclass
class Request:
    rid: int
    prompt: list[int]
    max_new_tokens: int
    generated: list[int] = field(default_factory=list)
    # Per-request sampling overrides; None = inference.* config defaults.
    temperature: Optional[float] = None
    top_k: Optional[int] = None
    top_p: Optional[float] = None
    # "" while live, then "completed".
    outcome: str = ""
    # Host clock (time.perf_counter) at submit and at the first token.
    t_submit: float = 0.0
    t_first: Optional[float] = None
    # scheduler state
    slot: Optional[int] = None
    pages: list[int] = field(default_factory=list)
    done: bool = False
    admit_seq: int = -1   # admission order; preemption evicts the youngest
    freed_until: int = 0  # logical pages below this are freed (SWA rolling)
    # Prefix-cache state: the first n_prefix entries of ``pages`` are
    # SHARED (refcounted, immutable) cache pages; prefix_node pins their
    # radix-tree path against eviction until release.
    n_prefix: int = 0
    prefix_node: Optional[Any] = None
    # Chunked-prefill cursor (inference.chunked_prefill): context tokens
    # whose KV is already in the pool (cached prefix + completed chunks,
    # page-aligned until the final chunk). While prefill_pending, the slot
    # rides mixed steps as a prompt-chunk row, never a decode row.
    prefill_done: int = 0
    prefill_pending: bool = False

    @property
    def context(self) -> list[int]:
        """Tokens whose KV must be in cache: prompt + everything generated
        (what a re-prefill after preemption runs on)."""
        return self.prompt + self.generated
