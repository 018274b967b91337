"""Step metrics, throughput and MFU for the training loop; prefix-cache,
speculative-decoding, grammar-constraint and robustness counters for
serving.

The parts of ``orion_tpu/metrics.py`` that the step loop uses:
``StepMetrics``, ``MetricsLogger`` (console line, optional JSONL, history)
and ``Stopwatch``; and the serving engine's ``PrefixCacheStats``,
``SpecDecodeStats``, ``ConstraintStats`` and ``RobustnessStats``; and the
trainer's ``TrainRobustnessStats``. MFU = model FLOPs per token
(``ModelConfig.flops_per_token``: 6 N plus the attention term) x tokens /
(step time x devices x the card's peak bf16 rate), the rate from
``peak_flops_per_device``.
"""

from __future__ import annotations

import json
import math
import time
from dataclasses import dataclass, field
from typing import Any, Optional

import torch

# Dense bf16 tensor-core peak per card (NVIDIA data sheets, SXM parts).
PEAK_FLOPS_BF16: dict[str, float] = {
    "H100": 989e12,
    "H200": 989e12,
}


def peak_flops_per_device(device) -> Optional[float]:
    """The card's peak bf16 FLOP/s, read from its name; None for the CPU
    (a CPU run has no MFU). Raises for a card the table does not know."""
    device = torch.device(device)
    if device.type == "cpu":
        return None
    name = torch.cuda.get_device_name(device)
    for key, val in PEAK_FLOPS_BF16.items():
        if key.lower() in name.lower():
            return val
    raise ValueError(
        f"no peak bf16 rate known for {name!r} (known: {sorted(PEAK_FLOPS_BF16)}); "
        f"set train.peak_flops_per_device"
    )


@dataclass
class StepMetrics:
    step: int
    loss: float
    grad_norm: float = 0.0
    learning_rate: float = 0.0
    step_time_s: float = 0.0
    tokens: int = 0
    tokens_per_sec: float = 0.0
    tokens_per_sec_per_device: float = 0.0
    model_flops: float = 0.0
    mfu: float = 0.0
    extras: dict[str, float] = field(default_factory=dict)

    def to_dict(self) -> dict[str, Any]:
        d = {
            "step": self.step,
            "loss": self.loss,
            "grad_norm": self.grad_norm,
            "lr": self.learning_rate,
            "step_time_s": self.step_time_s,
            "tokens": self.tokens,
            "tokens_per_sec": self.tokens_per_sec,
            "tokens_per_sec_per_device": self.tokens_per_sec_per_device,
            "mfu": self.mfu,
        }
        d.update(self.extras)
        return d


class MetricsLogger:
    """Accumulates per-step metrics; writes console lines every
    ``log_interval`` steps and, with ``jsonl_path``, one JSON row per step.
    ``peak_flops`` None leaves MFU NaN (a CPU run)."""

    def __init__(
        self,
        flops_per_token: float,
        num_devices: int,
        peak_flops: Optional[float],
        jsonl_path: Optional[str] = None,
        log_interval: int = 10,
    ):
        self.flops_per_token = flops_per_token
        self.num_devices = max(num_devices, 1)
        self.peak_flops = peak_flops
        self.log_interval = max(log_interval, 1)
        self.history: list[StepMetrics] = []
        self._jsonl_file = open(jsonl_path, "a") if jsonl_path else None

    def record(
        self,
        step: int,
        loss: float,
        tokens: int,
        step_time_s: float,
        grad_norm: float = 0.0,
        learning_rate: float = 0.0,
        **extras: float,
    ) -> StepMetrics:
        tps = tokens / step_time_s if step_time_s > 0 else 0.0
        model_flops = self.flops_per_token * tokens
        achieved = model_flops / step_time_s if step_time_s > 0 else 0.0
        mfu = (achieved / (self.num_devices * self.peak_flops)
               if self.peak_flops else math.nan)
        m = StepMetrics(
            step=step,
            loss=float(loss),
            grad_norm=float(grad_norm),
            learning_rate=float(learning_rate),
            step_time_s=step_time_s,
            tokens=tokens,
            tokens_per_sec=tps,
            tokens_per_sec_per_device=tps / self.num_devices,
            model_flops=model_flops,
            mfu=mfu,
            extras=dict(extras),
        )
        self.history.append(m)
        if self._jsonl_file is not None:
            self._jsonl_file.write(json.dumps(m.to_dict()) + "\n")
            self._jsonl_file.flush()
        if step % self.log_interval == 0:
            print(
                f"step {step:>6d}  loss {m.loss:8.4f}  "
                f"gnorm {m.grad_norm:7.3f}  lr {m.learning_rate:.2e}  "
                f"{m.step_time_s * 1e3:7.1f} ms/step  "
                f"{m.tokens_per_sec_per_device:9.0f} tok/s/dev  "
                f"MFU {m.mfu * 100:5.2f}%"
            )
        return m

    def close(self) -> None:
        if self._jsonl_file is not None:
            self._jsonl_file.close()
            self._jsonl_file = None


@dataclass
class PrefixCacheStats:
    """Serving-side prefix-cache counters, a copy of
    ``orion_tpu/metrics.py``'s: hits/misses count admissions,
    cached_tokens the prompt tokens served from shared pages instead of
    prefill, inserted/evicted/cow pages the pool churn the cache causes.

    Host tier (inference.host_tier_bytes > 0): ``evicted_to_host`` pages
    demoted to host memory instead of discarded (a subset of
    ``evicted_pages``), ``host_hits`` admissions that restored a
    host-resident path, ``host_restored_pages`` the pages those restores
    copied back, ``host_recompute_skips`` host-resident matches the
    break-even gate (or a tight pool) sent to recompute instead.
    Per-request paging (inference.long_context): ``request_paged_out``
    pages a live request demoted to host slots (residency cap,
    preempt-to-host) and ``request_paged_in`` those restored ahead of the
    dispatch that reads them; they never pass through the tree."""

    hits: int = 0
    misses: int = 0
    cached_tokens: int = 0
    inserted_pages: int = 0
    evicted_pages: int = 0
    cow_pages: int = 0
    evicted_to_host: int = 0
    host_hits: int = 0
    host_restored_pages: int = 0
    host_recompute_skips: int = 0
    request_paged_out: int = 0
    request_paged_in: int = 0

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def as_timing(self) -> dict[str, float]:
        """Flatten into the engine's reset_timing dict (the JAX keys)."""
        return {
            "prefix_hits": self.hits,
            "prefix_misses": self.misses,
            "prefix_hit_rate": self.hit_rate,
            "cached_tokens": self.cached_tokens,
            "inserted_pages": self.inserted_pages,
            "evicted_pages": self.evicted_pages,
            "cow_pages": self.cow_pages,
            "evicted_to_host": self.evicted_to_host,
            "host_hits": self.host_hits,
            "host_restored_pages": self.host_restored_pages,
            "host_recompute_skips": self.host_recompute_skips,
            "request_paged_out": self.request_paged_out,
            "request_paged_in": self.request_paged_in,
        }


@dataclass
class SpecDecodeStats:
    """Speculative-decoding counters (inference.speculative), owned by
    InferenceEngine and drained through ``reset_timing``; a copy of
    ``orion_tpu/metrics.py``'s.

    ``drafted``/``accepted``/``rolled_back`` count DRAFT tokens (proposed /
    matched-and-emitted / rejected-and-rewound; rolled_back == drafted -
    accepted by construction). ``verify_steps`` counts verify dispatches,
    ``verify_slot_steps`` (verify dispatches x live decode slots) the
    per-slot dispatch opportunities, and ``emitted`` every token a verify
    step emitted (accepted drafts + the per-slot bonus/correction token) —
    so ``emitted / verify_slot_steps`` is the decode tokens-per-dispatch
    the speculation bought (1.0 means it bought nothing). ``gated_steps``
    counts steps where SOMETHING drafted but fewer slots than
    ``inference.spec_min_draft_slots``, so the engine ran the plain
    decode window instead of a whole-batch verify step (drafts discarded
    there are not in ``drafted``). Token trees: ``tree_nodes`` drafted
    tree nodes (a subset of ``drafted``), ``tree_branch_nodes`` those
    outside the primary chain, ``compactions``/``compacted_tokens`` the
    KV-compaction dispatches and moved tokens when an accepted path was not
    the primary chain. ``disabled_reason`` is kept for the JAX package's
    key set; the port has no auto-disable, so it stays None."""

    drafted: int = 0
    accepted: int = 0
    rolled_back: int = 0
    emitted: int = 0
    verify_steps: int = 0
    verify_slot_steps: int = 0
    gated_steps: int = 0
    tree_nodes: int = 0
    tree_branch_nodes: int = 0
    compactions: int = 0
    compacted_tokens: int = 0
    disabled_reason: Optional[str] = None

    @property
    def acceptance_rate(self) -> float:
        return self.accepted / self.drafted if self.drafted else 0.0

    @property
    def tokens_per_verify(self) -> float:
        if not self.verify_slot_steps:
            return 0.0
        return self.emitted / self.verify_slot_steps

    def as_timing(self) -> dict[str, float]:
        """Flatten into the engine's reset_timing dict."""
        return {
            "spec_drafted": self.drafted,
            "spec_accepted": self.accepted,
            "spec_rolled_back": self.rolled_back,
            "spec_emitted": self.emitted,
            "spec_acceptance_rate": self.acceptance_rate,
            "verify_steps": self.verify_steps,
            "verify_slot_steps": self.verify_slot_steps,
            "spec_tokens_per_verify": self.tokens_per_verify,
            "spec_gated_steps": self.gated_steps,
            "spec_tree_nodes": self.tree_nodes,
            "spec_tree_branch_nodes": self.tree_branch_nodes,
            "spec_compactions": self.compactions,
            "spec_compacted_tokens": self.compacted_tokens,
            "spec_disabled_reason": self.disabled_reason or "",
        }


@dataclass
class ConstraintStats:
    """Grammar-constrained-decoding counters (inference.constrained), owned
    by InferenceEngine and drained through ``reset_timing``; a copy of
    ``orion_tpu/metrics.py``'s, with the same fields and keys.

    Compile side: ``compiles``/``compile_hits`` count constraint-DFA
    compilations requested at submit and the memo-cache hits among them
    (``compile_s`` is the cumulative miss cost). Runtime side:
    ``masked_rows`` counts logits rows a legal-token mask was applied to
    (per slot per dispatch position), ``masked_steps`` the engine steps
    that carried at least one constrained row, ``advance_s`` the cumulative
    host-side FSM-advance time. Speculation: ``forced_drafted``/
    ``forced_accepted`` count draft tokens from single-legal-continuation
    FSM states (the free drafts), ``branch_points`` tree branch-outs taken
    at ambiguous FSM states. Terminals: ``completed`` constraints satisfied
    to acceptance, ``dead_ends`` walks into a state no vocab token leaves.
    """

    requests: int = 0
    compiles: int = 0
    compile_hits: int = 0
    compile_s: float = 0.0
    advance_s: float = 0.0
    masked_steps: int = 0
    masked_rows: int = 0
    forced_drafted: int = 0
    forced_accepted: int = 0
    branch_points: int = 0
    completed: int = 0
    dead_ends: int = 0

    @property
    def forced_acceptance_rate(self) -> float:
        if not self.forced_drafted:
            return 0.0
        return self.forced_accepted / self.forced_drafted

    def as_timing(self) -> dict[str, float]:
        """Flatten into the engine's reset_timing dict."""
        return {
            "constrain_requests": self.requests,
            "constrain_compiles": self.compiles,
            "constrain_compile_hits": self.compile_hits,
            "constrain_compile_s": self.compile_s,
            "constrain_advance_s": self.advance_s,
            "constrain_masked_steps": self.masked_steps,
            "constrain_masked_rows": self.masked_rows,
            "constrain_forced_drafted": self.forced_drafted,
            "constrain_forced_accepted": self.forced_accepted,
            "constrain_forced_acceptance_rate":
                self.forced_acceptance_rate,
            "constrain_branch_points": self.branch_points,
            "constrain_completed": self.completed,
            "constrain_dead_ends": self.dead_ends,
        }


@dataclass
class RobustnessStats:
    """Fault-tolerance counters, owned by InferenceEngine and drained
    through ``reset_timing``; a copy of ``orion_tpu/metrics.py``'s, with
    the same fields and keys.

    Request outcomes: ``shed`` (bounded-queue overload or drain: never
    admitted), ``expired`` (deadline passed; reaped at a step boundary),
    ``cancelled`` (cancel(rid)), ``quarantined`` (non-finite logits; the
    request errored, neighbours unaffected). Every terminal request
    carries exactly one typed outcome.

    Fault episodes: ``dispatch_faults`` counts dispatch attempts that
    raised (injected or real), ``failed_steps`` engine steps abandoned
    after a dispatch or page allocation failed (the engine continues),
    ``stalled_steps`` steps the watchdog flagged, ``pool_faults`` page-
    allocation failures absorbed at admit or grow. ``dispatch_retries``,
    ``dispatch_fallbacks`` and ``shed_context`` keep the JAX package's key
    set: the port has no fallback path (a failing kernel raises) and no
    long-context feasibility shed, so they stay 0.
    """

    shed: int = 0
    shed_context: int = 0
    expired: int = 0
    cancelled: int = 0
    quarantined: int = 0
    dispatch_faults: int = 0
    dispatch_retries: int = 0
    dispatch_fallbacks: int = 0
    failed_steps: int = 0
    stalled_steps: int = 0
    pool_faults: int = 0

    def as_timing(self) -> dict[str, float]:
        """Flatten into the engine's reset_timing dict."""
        return {
            "shed_requests": self.shed,
            "shed_context_requests": self.shed_context,
            "expired_requests": self.expired,
            "cancelled_requests": self.cancelled,
            "quarantined_requests": self.quarantined,
            "dispatch_faults": self.dispatch_faults,
            "dispatch_retries": self.dispatch_retries,
            "dispatch_fallbacks": self.dispatch_fallbacks,
            "failed_steps": self.failed_steps,
            "stalled_steps": self.stalled_steps,
            "pool_faults": self.pool_faults,
        }


@dataclass
class TrainRobustnessStats:
    """Training-side fault-tolerance counters, owned by the Trainer; a copy
    of ``orion_tpu/metrics.py``'s, with the same fields and keys.

    ``anomalous_steps`` counts steps skipped by the gradient anomaly guard
    (``train.anomaly_guard``), split into ``nonfinite_steps`` (NaN/Inf in
    the loss or any grad leaf) and ``spike_steps`` (finite, but the global
    grad norm exceeded ``train.anomaly_spike_factor`` x the running EMA); a
    skipped step leaves params and optimizer state bit-identical.
    ``rollbacks`` counts auto-rollback episodes (``train.anomaly_limit``
    consecutive anomalies -> restore the newest intact checkpoint and skip
    the poisoned batch window), ``skipped_batches`` the data-cursor
    fast-forward those episodes applied. ``emergency_saves`` counts
    preemption/crash force-saves, ``corrupt_checkpoints`` the checkpoints
    restore quarantined with a typed reason before finding an intact one,
    ``restarts`` the supervisor attempt this fit runs under
    (``run_with_restarts``), and ``last_fault_reason`` why the previous
    attempt died.
    """

    anomalous_steps: int = 0
    nonfinite_steps: int = 0
    spike_steps: int = 0
    rollbacks: int = 0
    skipped_batches: int = 0
    emergency_saves: int = 0
    corrupt_checkpoints: int = 0
    restarts: int = 0
    last_fault_reason: Optional[str] = None

    def as_extras(self) -> dict[str, float]:
        """Flatten into MetricsLogger extras (floats only; the reason
        string rides the log line, not the JSONL row)."""
        return {
            "anomalous_steps": float(self.anomalous_steps),
            "rollbacks": float(self.rollbacks),
            "restarts": float(self.restarts),
        }

    def as_timing(self) -> dict[str, Any]:
        """The full counter set (``as_extras`` keeps the step log's
        subset)."""
        return {
            "anomalous_steps": self.anomalous_steps,
            "nonfinite_steps": self.nonfinite_steps,
            "spike_steps": self.spike_steps,
            "rollbacks": self.rollbacks,
            "skipped_batches": self.skipped_batches,
            "emergency_saves": self.emergency_saves,
            "corrupt_checkpoints": self.corrupt_checkpoints,
            "restarts": self.restarts,
            "last_fault_reason": self.last_fault_reason or "",
        }


class Stopwatch:
    """Wall-clock timer for step timing; ``lap(sync_on=device)`` first
    waits for the device's queued work, so a lap covers the step's device
    time and not only its enqueue."""

    def __init__(self):
        self._t = time.perf_counter()

    def lap(self, sync_on: Any = None) -> float:
        if sync_on is not None and torch.device(sync_on).type == "cuda":
            torch.cuda.synchronize(sync_on)
        now = time.perf_counter()
        dt = now - self._t
        self._t = now
        return dt
