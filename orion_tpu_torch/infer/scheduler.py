"""Scheduler face of the serving engine: the ``Request`` record and the
admission queue's policy.

Counterpart of ``orion_tpu/infer/scheduler.py`` for the engine core with
the prefix-cache and chunked-prefill state, the long-context host paging
state, request priorities and deadlines, the typed outcomes, the grammar
constraint's walk, and ``AdmissionQueue`` (which request an over-limit
submit sheds; the step-boundary deadline sweep of the queue). The
router's trace context is not ported.
"""

from __future__ import annotations

import time
from collections import deque
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
    # SLO class (higher = more important): admission and page-pressure
    # preemption prefer high-priority requests; overload shedding evicts
    # the lowest class first.
    priority: int = 0
    # Absolute time.monotonic() deadline (None = none). Expired requests
    # are reaped at step boundaries with a typed "expired" outcome.
    deadline: Optional[float] = None
    # Typed terminal outcome: "" while live, then exactly one of
    # "completed" | "expired" | "cancelled" | "shed" | "shed:<kind>" |
    # "error:<kind>" ("error:nan": the NaN quarantine). Every submitted
    # request surfaces from step() with an outcome.
    outcome: str = ""
    # Host clock (time.perf_counter) at submit and at the first token.
    t_submit: float = 0.0
    t_first: Optional[float] = None
    # scheduler state
    slot: Optional[int] = None
    # Pool pages by logical page; None for a page behind the sliding
    # window (rolled) or resident in the host tier (``host_pages``).
    pages: list = field(default_factory=list)
    done: bool = False
    admit_seq: int = -1   # admission order; -1 until first admitted
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
    # Long-context host paging (inference.long_context): logical page
    # index -> HostPagePool slot holding that page's KV, one engine-owned
    # ref per slot (the prefix tree never sees these). Filled by residency
    # demotion (inference.request_resident_pages) and preempt-to-host;
    # drained by the engine's page-in before the dispatch that reads them,
    # or dropped when the window rolls past a page or the request ends.
    host_pages: dict[int, int] = field(default_factory=dict)
    # Preempt-to-host snapshot: KV is valid in [0, host_cursor) over
    # device and host pages, and host_last_token is the token in flight;
    # re-admission restores and resumes there instead of re-prefilling.
    host_cursor: int = 0
    host_last_token: int = 0
    # Grammar constraint (orion_tpu_torch.constrain.ConstraintState): the
    # request's walk through its token DFA. Pure host state: it survives
    # preemption (re-prefill replays prompt + generated; the state re-syncs
    # off ``generated`` if the advance count disagrees).
    constraint: Optional[Any] = None

    @property
    def context(self) -> list[int]:
        """Tokens whose KV must be in cache: prompt + everything generated
        (what a re-prefill after preemption runs on)."""
        return self.prompt + self.generated


def in_flight(req: Request) -> bool:
    """A queued request that has RUN: admitted at least once and not since
    un-claimed (admit_seq >= 0; preemption and prefill-fault unwinds keep
    it), or carrying generated tokens from an earlier residency. In-flight
    requests are exempt from overload shedding and are finished, not shed,
    by drain()."""
    return req.admit_seq >= 0 or bool(req.generated)


class AdmissionQueue(deque):
    """The engine's wait queue plus its admission-side policy: a deque
    (appendleft, index deletion and iteration work as on any deque) with
    the two decisions the scheduler face owns, ``shed_victim`` and
    ``sweep_expired``."""

    def shed_victim(self, incoming: Request) -> Request:
        """The least defensible overload-shed candidate among the queued
        never-run requests plus ``incoming``: lowest priority first, then
        the nearest deadline, then the newest arrival (possibly
        ``incoming`` itself). In-flight requests are never victims."""
        return min(
            [r for r in self if not in_flight(r)] + [incoming],
            key=lambda r: (
                r.priority,
                r.deadline if r.deadline is not None else float("inf"),
                -r.rid,
            ),
        )

    def sweep_expired(self, now: Optional[float] = None) -> list[Request]:
        """Remove and return every queued request whose deadline has
        passed (the engine marks them "expired")."""
        if now is None:
            now = time.monotonic()
        if not any(r.deadline is not None and now >= r.deadline for r in self):
            return []
        expired = [r for r in self if r.deadline is not None and now >= r.deadline]
        keep = [r for r in self if not (r.deadline is not None and now >= r.deadline)]
        self.clear()
        self.extend(keep)
        return expired
