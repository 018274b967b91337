"""Scheduler face of the serving engine: the ``Request`` record.

Counterpart of ``orion_tpu/infer/scheduler.py`` for the engine core:
priorities, deadlines, overload shedding, prefix-cache, chunked-prefill
and host-tier state are not ported yet (the engine admits in arrival
order from a plain deque and preempts the youngest request).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional


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

    @property
    def context(self) -> list[int]:
        """Tokens whose KV must be in cache: prompt + everything generated
        (what a re-prefill after preemption runs on)."""
        return self.prompt + self.generated
