"""Continuous-batching inference engine over the paged KV pool.

Counterpart of ``orion_tpu/infer/engine.py``'s scheduler: requests queue
in ``submit``; each ``step`` reaps finished slots, admits waiting requests
into free slots while the page pool can hold them, and then either
prefills the admitted burst in one dispatch and runs one fused decode
window (W token steps, one host fetch of the [W, B] token block) over
every live slot, or — with inference.chunked_prefill, while prompt chunks
are pending — runs ONE mixed step: up to ``prefill_chunk_tokens`` of
prompt chunks plus one decode token for every live slot. Admission takes
the highest priority class first, arrival order within a class. Page
pressure preempts the lowest class's youngest request, which re-enters
the queue head and recomputes its context on re-admission.

With inference.prefix_cache a radix tree (``infer/prefix_cache.py``)
keeps the full pages of finished and preempted requests; an admission maps
the longest cached prefix (shared, refcounted) and prefills only the
tail, and a fully cached context copies its last page on write. Cached
pages are reclaimable headroom, evicted LRU under pressure. With
inference.kv_quant='int8' the pool is int8 with float32 scales.

With inference.speculative a host-side n-gram proposer
(``infer/spec_decode.py``, drafting also from the prefix cache's token
paths) drafts up to ``speculate_tokens`` tokens per live slot; one verify
dispatch (``runner.verify_step``, or ``mixed_verify_step`` beside prompt
chunks) scores every slot's pending token and drafts through K10, the host
walks the verdicts, emits the accepted prefix plus one bonus/correction
token, and releases the pages that held only rejected drafts. Token trees
(``spec_tree_width`` > 1) verify several branches under an ancestor mask
and compact an accepted off-primary path's KV. Greedy output is token for
token that of the engine without speculation.

With inference.constrained a request may carry a grammar
(``submit(..., constraint=ConstraintSpec(regex=... | json_schema=...))``,
``orion_tpu_torch.constrain``): the spec compiles at submit to a token DFA
(memoized by pattern hash), and the request's slots decode through the
verify dispatch, never the fused window, because the next mask depends on
the sampled token while along a known draft every position's mask is
known on the host. The FSM's forced runs (states with one legal token)
ride as drafts that are always accepted; with spec_tree_width > 1 an
ambiguous state becomes a tree branch point. The [B, W, V] masks are built
on the host and copied to the device once per step, inside the dispatch's
envelope; a prefill's first token is masked the same way. A walk into a
dead end ends the request with outcome "error:constraint_dead_end";
completion is an accepting state with no continuation, or eos in an
accepting state.

Lifecycle and fault containment (README "Robustness"; the serving half of
``runtime/fault.py``): ``submit`` takes a ``deadline_s`` (default
inference.default_deadline_s) and a ``priority``; with
inference.queue_limit an over-limit submit sheds the least defensible
never-run request (``AdmissionQueue.shed_victim``); expired requests are
reaped at step boundaries; ``cancel``, ``drain`` (the SIGTERM path: shed
the queue, finish live requests) and ``close`` end requests with typed
outcomes. Every dispatch runs inside the executor's envelope
(``infer/executor.py``): a failed dispatch or page allocation fails the
STEP (counted in ``RobustnessStats``), a prefill fault unwinds its
admissions, and inference.max_step_faults consecutive failures re-raise.
Past inference.spec_fault_limit verify faults speculation switches off
for the engine's life. With inference.nan_guard a slot whose logits go
non-finite is quarantined: outcome "error:nan", its private pages scrubbed
and released with no prefix-cache donation. inference.watchdog_timeout_s
counts stalled steps. A ``FaultInjector`` drives all of it in tests.

``inference.dispatch_fallback`` is inert here: the JAX engine retries a
failed Pallas dispatch on its XLA reference, but the port's rule is that
a failing kernel raises and never gives way to its plain version, so the
port behaves as the JAX engine does with dispatch_fallback=false.
``dispatch_retries`` other than 1 and ``dispatch_retry_backoff_s`` other
than 0 shape only that fallback leg and raise at construction.

On the card every decode window, verify and mixed dispatch is one
CUDA-graph replay (``infer/executor.py``: the counterpart of the JAX
executor's jitted programs), captured the first time its path and static
shapes come up; whole-prompt prefill stays eager, its few hundred
launches small beside its GEMMs. With inference.decode_window_autotune
the window doubles while the host's share of a decode step is above
inference.decode_host_share_target and halves below a quarter of it,
between inference.decode_window and decode_window_max
(``_autotune_window``, the JAX engine's rule); admission budgets for
decode_window_max. ``timing`` splits each step's wall into device_s
(decode_device_s + mixed_device_s), prefill_s and host_s.

The host tier (inference.host_tier_bytes, behind the prefix cache): LRU
eviction demotes cached pages to a ``HostPagePool`` in pinned host memory
(one batched device-to-host copy per sweep, ``non_blocking`` on the
engine's stream) and a later match restores them (one batched
host-to-device copy) when the host span passes the break-even gate
(inference.host_tier_min_tokens, or the crossing of the three
host_tier_* constants); below it the match is recomputed. A failed
restore is a typed ``DispatchFault`` that unwinds both tiers and fails
the step. ``offload_prefix_cache`` demotes the whole idle tree. Page
copies run between dispatches, eagerly, never inside a captured graph.

Long context (inference.long_context, with chunked prefill and the
tier): a request whose eager footprint exceeds the pool is admitted on its
sliding-window working set, chunks provision their own pages, and
``_roll_window`` frees pages behind the window (a window on every layer);
inference.request_resident_pages demotes a long request's oldest live
pages between its chunks, pool pressure preempts a long request to the
host (resuming at its cursor), and an infeasible request (full attention
over the pool) ends "shed:context_too_long". A slot whose pages are not
all resident does not draft. With inference.paged_prefill=false rows that
resume over cached pages run the gather body (K3 with explicit
positions) in place of K9.

Observability (``orion_tpu_torch/obs``, the JAX engine's wiring): a
metrics registry always (sections engine, robust, pool, hbm and, with their
features, prefix, spec and constrain; lazy reads of live state); with
inference.trace, ``trace_path`` or ``flight_dir`` a span ring recording one
``dispatch/<path>`` span per dispatch (the host span of ``Executor.run``,
capture or replay included, never an annotation inside a capture), one
``step`` span per step and the lifecycle instants (submit, admit,
first_token, outcome, page_out, page_in, preempt_to_host); with
``flight_dir`` postmortem dumps at the fault sites (failed steps,
max_step_faults, watchdog stalls, speculation switching off, quarantines);
``metrics_jsonl``/``metrics_prom`` rows at every ``reset_timing`` and at
``close``, which also exports the Chrome trace. With all of it off the
tracer is ``NULL_TRACER``: no tag is built and no span object made.

Not ported yet (each raises at construction when configured): int8
weights and MoE. Live migration
(the JAX engine's ``export_migration_state``) is not ported either; when it
is, its state carries each request's ``constraint`` as the JAX engine's
does.

The engine runs on ``cuda`` unless the caller passes ``device="cpu"``;
with no device given and no GPU present it raises. ``model.kernels`` is
not read: on the card every op on the path runs its hand-written kernel,
on the CPU its plain PyTorch version.
"""

from __future__ import annotations

import contextlib
import itertools
import logging
import time
from typing import Any, Optional, Sequence

import numpy as np
import torch

from orion_tpu_torch.config import Config
from orion_tpu_torch.constrain import ConstraintSpec, ConstraintState, compile_constraint
from orion_tpu_torch.infer.executor import DispatchExecutor
from orion_tpu_torch.infer.kv_cache import (
    HostPagePool,
    PageAllocator,
    compact_draft_kv,
    copy_page,
    gather_pages,
    host_page_bytes,
    host_tier_break_even_tokens,
    init_cache,
    pages_per_seq,
    poison_page,
    rollback_pages,
    scatter_pages,
    scrub_pages,
)
from orion_tpu_torch.infer.prefix_cache import HostPage, PrefixCache
from orion_tpu_torch.infer.runner import (
    decode_window,
    mixed_step,
    mixed_verify_step,
    prefill_step,
    verify_step,
)
from orion_tpu_torch.infer.sampling import sample
from orion_tpu_torch.infer.scheduler import AdmissionQueue, Request, in_flight
from orion_tpu_torch.infer.spec_decode import NgramProposer, build_tree
from orion_tpu_torch.metrics import (
    ConstraintStats,
    PrefixCacheStats,
    RobustnessStats,
    SpecDecodeStats,
)
from orion_tpu_torch.models.convert import to_device
from orion_tpu_torch.models.transformer import torch_dtype
from orion_tpu_torch.obs import MetricsRegistry, export_chrome_safe, init_obs, live_hbm_metrics
from orion_tpu_torch.ops import check_prefill_fit, check_verify_fit
from orion_tpu_torch.ops.common import round_up
from orion_tpu_torch.runtime.fault import (
    SERVING_KINDS,
    DispatchFault,
    InjectedFault,
    Watchdog,
)

log = logging.getLogger("orion_tpu_torch.infer")


def resolve_device(device) -> torch.device:
    """``device`` as given, or ``cuda`` by default; raises when there is no
    GPU and the caller did not ask for the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: orion_tpu_torch runs on the GPU by default; "
                "pass device='cpu' to run the plain PyTorch versions"
            )
        device = "cuda"
    return torch.device(device)


def _check_supported(cfg: Config) -> None:
    m, i = cfg.model, cfg.inference
    unsupported = {
        "model.weight_quant": m.weight_quant is not None,
        "model.n_experts > 0 (MoE)": m.is_moe,
    }
    # The knobs that only shape the XLA-fallback leg, which the port does
    # not have (a failing kernel raises): their defaults only.
    ladder = type(i)()
    for knob in ("dispatch_retries", "dispatch_retry_backoff_s"):
        default = getattr(ladder, knob)
        unsupported[f"inference.{knob} != {default} (the fallback leg)"] = (
            getattr(i, knob) != default)
    bad = [name for name, on in unsupported.items() if on]
    if bad:
        raise NotImplementedError(
            f"not ported to orion_tpu_torch yet: {', '.join(bad)}"
        )


def _check_injector(injector) -> None:
    """Refuse a fault schedule holding kinds the port's engine does not
    consume (the migration, checkpoint and replica faults)."""
    if injector is None:
        return
    bad = sorted({s.kind for s in injector.specs if s.kind not in SERVING_KINDS})
    if bad:
        raise NotImplementedError(
            f"not ported to orion_tpu_torch yet: fault kinds {', '.join(bad)} "
            f"(the serving engine consumes {', '.join(SERVING_KINDS)})"
        )


def _pow2(n: int) -> int:
    """The next power of two >= n (n >= 1): padded batch and walk widths."""
    return 1 << (n - 1).bit_length()


class InferenceEngine:
    """Paged-KV continuous-batching engine over one model replica."""

    def __init__(
        self,
        cfg: Config,
        params: Any,
        *,
        eos_id: Optional[int] = None,
        seed: int = 0,
        device=None,
        fault_injector=None,
        cuda_graphs: bool = True,
    ):
        """``cuda_graphs=False`` runs the card's dispatches eagerly, op by
        op, as the CPU always does: the yardstick the graphs are held
        against, not a serving mode."""
        _check_supported(cfg)
        _check_injector(fault_injector)
        self.device = resolve_device(device)
        self.cfg = cfg
        self.mcfg = cfg.model
        self.icfg = cfg.inference
        self.eos_id = eos_id
        self.psz = self.icfg.page_size
        self.pages_per_seq = pages_per_seq(self.icfg)
        self.max_batch = self.icfg.max_batch_size
        if self.icfg.prefill_chunk % self.psz:
            raise ValueError(
                f"prefill_chunk={self.icfg.prefill_chunk} must be a "
                f"multiple of page_size={self.psz}"
            )
        self.chunked = self.icfg.chunked_prefill
        if self.chunked and (
            self.icfg.prefill_chunk_tokens < self.psz
            or self.icfg.prefill_chunk_tokens % self.psz
        ):
            raise ValueError(
                f"prefill_chunk_tokens={self.icfg.prefill_chunk_tokens} "
                f"must be a positive multiple of page_size={self.psz} "
                f"(chunks split at page granularity)"
            )
        # Long context (inference.long_context): per-request paging to the
        # host tier and lazy page provisioning under chunked prefill.
        self._long = self.icfg.long_context
        if self._long:
            if not self.chunked:
                raise ValueError(
                    "inference.long_context=true requires "
                    "inference.chunked_prefill=true (over-pool contexts "
                    "prefill through page-aligned chunks)"
                )
            if self.icfg.host_tier_bytes <= 0:
                raise ValueError(
                    "inference.long_context=true requires "
                    "inference.host_tier_bytes > 0 (per-request paging "
                    "needs somewhere to page to)"
                )
        if (self.chunked or self.icfg.prefix_cache) and self.icfg.paged_prefill:
            # Rows resuming over cached pages run K9: a page size its
            # blocks cannot hold fails here, not mid-serve.
            check_prefill_fit(
                n_heads=self.mcfg.n_heads, n_kv_heads=self.mcfg.n_kv_heads,
                head_dim=self.mcfg.resolved_head_dim, page_size=self.psz,
                dtype=torch_dtype(self.mcfg.dtype),
            )
        self._init_speculation()
        self.cache = init_cache(self.mcfg, self.icfg, self.device)
        self.params = to_device(params, self.device)
        self.alloc = PageAllocator(self.icfg.num_pages)
        self.prefix_stats = PrefixCacheStats()
        self._init_host_tier()
        self._pcache = (
            PrefixCache(self.psz, self.alloc, host_pool=self._host_pool,
                        spill=self._spill_pages if self._host_pool is not None else None)
            if self.icfg.prefix_cache else None
        )
        # Page management's window: with interleaved local/global layers
        # the global layers read the whole history, so pages never die;
        # only a window on every layer rolls pages (_roll_window).
        self.page_window = (
            self.mcfg.sliding_window if self.mcfg.sliding_window_pattern is None else None
        )
        # Lazy chunk provisioning (the over-pool admission path) needs a
        # window: a full-attention chunk reads its whole history.
        self._lazy = self._long and self.page_window is not None
        self.page_table = np.zeros((self.max_batch, self.pages_per_seq), np.int32)
        self.seq_lens = np.zeros(self.max_batch, np.int32)
        self.last_token = np.zeros(self.max_batch, np.int32)
        self.slots: list[Optional[Request]] = [None] * self.max_batch
        self.waiting: AdmissionQueue = AdmissionQueue()
        self._just_finished: list[Request] = []
        self._rid = itertools.count()
        self._admit_seq = itertools.count()
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed)
        self.preemptions = 0
        # Decode window: engine state (inference.decode_window is where the
        # autotune starts and its floor); admission budgets for
        # _provision_window, so growth never strands an admitted request.
        self.decode_window = self.icfg.decode_window
        if self.icfg.decode_window_autotune and (
            self.icfg.decode_window_max < self.icfg.decode_window
        ):
            raise ValueError(
                f"decode_window_max={self.icfg.decode_window_max} < "
                f"decode_window={self.icfg.decode_window}"
            )
        self._autotune_skip = False   # first decode step after a resize
        self._spec_step = False       # this step verified instead of decoding
        # The step's dispatch spans (host clock, each through its fetch) and
        # the host tier's copy spans.
        self._dev_span = self._mixed_span = self._prefill_span = 0.0
        self._spill_span = self._restore_span = self._pagein_span = 0.0
        self.slot_temp = np.full(self.max_batch, self.icfg.temperature, np.float32)
        self.slot_top_k = np.full(self.max_batch, self.icfg.top_k, np.int32)
        self.slot_top_p = np.full(self.max_batch, self.icfg.top_p, np.float32)
        self.timing = self._zero_timing()

        # -- Fault tolerance (runtime/fault.py; README "Robustness") -------
        self._injector = fault_injector
        self.robust = RobustnessStats()
        self.step_no = 0            # completed step() calls; FaultSpec.step
        self._consec_failed = 0     # consecutive failed steps
        self._spec_faults = 0       # verify-path dispatch faults (lifetime)
        self._spec_disabled = False
        self._guard = self.icfg.nan_guard
        self.draining = False       # drain() or close(): admission stopped
        self._executor = DispatchExecutor(
            self, graphs=cuda_graphs and self.device.type == "cuda")
        # The serving watchdog flags stalls (counted as stalled_steps) and
        # never aborts: a stalled step fails nothing by itself.
        self._watchdog: Optional[Watchdog] = None
        if self.icfg.watchdog_timeout_s is not None:
            self._watchdog = Watchdog(
                self.icfg.watchdog_timeout_s,
                on_stall=lambda elapsed: log.error(
                    "serving watchdog: step stalled for %.1fs", elapsed),
            ).start()

        # -- Observability (orion_tpu_torch/obs) ---------------------------
        # The registry always (lazy reads of live state); the tracer and
        # the flight recorder only when asked for, so the untraced host path
        # is the plain one.
        self.registry = MetricsRegistry()
        self._register_metrics()
        self._tracer, self._flight = init_obs(
            trace=self.icfg.trace, trace_ring=self.icfg.trace_ring,
            flight_dir=self.icfg.flight_dir, trace_path=self.icfg.trace_path,
            snapshot=self.registry.snapshot, injector=self._injector, device=self.device,
        )
        self._register_trace_metrics()
        self._ttft_seen: set[int] = set()   # rids with a first_token instant
        self._closed = False

    def _init_host_tier(self) -> None:
        """inference.host_tier_bytes > 0: the HostPagePool (capacity in
        whole pages over every cache tensor) and the break-even threshold
        in tokens: inference.host_tier_min_tokens, or else the crossing of
        the host_tier_* constants (inf when restore never wins: the tier
        still absorbs evictions, every local hit recomputes)."""
        self._host_pool: Optional[HostPagePool] = None
        self._host_min_tokens = 0.0
        icfg = self.icfg
        if icfg.host_tier_bytes <= 0:
            return
        if not (icfg.prefix_cache or self._long):
            raise ValueError(
                "inference.host_tier_bytes > 0 requires "
                "inference.prefix_cache=true (the tier lives behind the "
                "radix tree) or inference.long_context=true (per-request "
                "paging owns its slots directly)"
            )
        pb = host_page_bytes(self.cache, self.mcfg.n_layers)
        cap = icfg.host_tier_bytes // pb
        if cap < 1:
            raise ValueError(
                f"inference.host_tier_bytes={icfg.host_tier_bytes} is smaller "
                f"than one page's KV footprint ({pb} bytes); raise it or "
                f"disable the tier with 0"
            )
        self._host_pool = HostPagePool(cap, page_bytes=pb)
        if icfg.host_tier_min_tokens is not None:
            self._host_min_tokens = float(icfg.host_tier_min_tokens)
        else:
            auto = host_tier_break_even_tokens(
                pb, self.psz, icfg.host_tier_h2d_gbps,
                icfg.host_tier_restore_overhead_s, icfg.host_tier_prefill_tok_s)
            self._host_min_tokens = float(auto) if auto is not None else float("inf")

    # -- observability (orion_tpu_torch/obs) ------------------------------

    def _register_metrics(self) -> None:
        """The engine's live state in the registry: the window counters
        (the objects reset_timing drains, read lazily, so the registry
        reports the current window) and the gauges: pool and prefix-tree
        occupancy, device memory."""
        reg = self.registry
        reg.register("engine", lambda: {
            **self.timing,
            "decode_window": self.decode_window,
            "step_no": self.step_no,
            "waiting": len(self.waiting),
            "active": sum(1 for r in self.slots if r is not None and not r.done),
            "preemptions": self.preemptions,
        })
        reg.register("robust", lambda: self.robust.as_timing())
        if self.icfg.prefix_cache:
            reg.register("prefix", lambda: self.prefix_stats.as_timing())
        if self.icfg.speculative:
            reg.register("spec", lambda: self.spec_stats.as_timing())
        if self.icfg.constrained:
            reg.register("constrain", lambda: self.constraint_stats.as_timing())
        reg.register("pool", self._pool_metrics)
        reg.register("hbm", lambda: live_hbm_metrics(self.device))

    def _register_trace_metrics(self) -> None:
        """The ring's gauges ("trace": events, capacity, dropped), only when
        tracing is on, so the untraced snapshot's keys are the plain ones. A
        nonzero ``dropped`` means an export is a truncated timeline."""
        if self._tracer.enabled:
            self.registry.register("trace", self._tracer.metrics)

    @staticmethod
    def _trace_ctx(req: Request) -> dict:
        """Correlation tags of a lifecycle instant: ``tid`` (a router's
        trace id, else the rid) and, on a failover re-placement,
        ``retried=attempt``."""
        tid = req.trace_id if req.trace_id is not None else req.rid
        if req.attempt:
            return {"tid": tid, "retried": req.attempt}
        return {"tid": tid}

    def _trace_step(self, m0: float, decoded: bool) -> None:
        """The step's lifecycle instants, swept at its end where every
        token-emitting path has run: first_token once per request (the
        wait queue included: a request preempted in the step that gave its
        first token sits there), outcome once at the end; then the step
        span from ``m0``."""
        tr = self._tracer
        for r in itertools.chain(self.slots, self.waiting, self._just_finished):
            if r is not None and r.generated and r.rid not in self._ttft_seen:
                self._ttft_seen.add(r.rid)
                tr.instant("first_token", rid=r.rid, step=self.step_no, **self._trace_ctx(r))
        for r in self._just_finished:
            self._ttft_seen.discard(r.rid)
            tr.instant("outcome", rid=r.rid, outcome=r.outcome, tokens=len(r.generated),
                       step=self.step_no, **self._trace_ctx(r))
        tr.record_span("step", m0, time.monotonic(), step=self.step_no, decoded=bool(decoded))

    def _pool_metrics(self) -> dict:
        """Page-pool and radix-tree occupancy gauges (``occupancy`` over the
        usable pool: page 0 is the scratch page; cached pages are
        reclaimable but occupied), and the host tier's and, with long
        context, the requests' host residency."""
        n = self.icfg.num_pages
        usable = max(n - 1, 1)
        free = self.alloc.free_pages
        out = {"num_pages": n, "free_pages": free, "occupancy": (usable - free) / usable}
        if self._pcache is not None:
            out["cached_pages"] = self._pcache.total_pages
            out["evictable_pages"] = self._pcache.evictable_pages()
        hp = self._host_pool
        if hp is not None:
            out["host_capacity"] = hp.capacity
            out["host_free_slots"] = hp.free_slots
            if self._pcache is not None:
                out["host_pages"] = self._pcache.host_pages
            out["host_occupancy"] = (hp.capacity - hp.free_slots) / hp.capacity
            if self._long:
                # Host slots held by live requests (not tree markers).
                held = sum(len(r.host_pages)
                           for r in itertools.chain(self.slots, self.waiting) if r is not None)
                out["request_host_pages"] = held
                out["residency_occupancy"] = held / hp.capacity
        return out

    def _flight_dump(self, reason: str, **context) -> None:
        """A flight-recorder postmortem (a no-op without
        inference.flight_dir); best-effort: a failed write is logged and
        the engine goes on (``FlightRecorder.try_dump``)."""
        if self._flight is not None:
            self._flight.try_dump(reason, step=self.step_no, **context)

    def _flight_note(self, kind: str, **fields) -> None:
        """One event in the postmortem ring (a no-op without
        inference.flight_dir)."""
        if self._flight is not None:
            self._flight.note(kind, step=self.step_no, **fields)

    def export_trace(self, path: str) -> int:
        """Export the span ring as Chrome trace-event JSON; returns the
        events written (0 with tracing off)."""
        return self._tracer.export_chrome(path)

    @property
    def tracer(self):
        """The engine's span tracer (``NULL_TRACER`` with obs off)."""
        return self._tracer

    @staticmethod
    def _zero_timing() -> dict:
        """Host-clock spans (each ends in the dispatch's host fetch, which
        waits for the device): prefill, decode (decode windows and pure
        verify dispatches) and mixed-step time, and verify_s, the verify
        share of decode_s; the JAX engine's step split: device_s =
        decode_device_s (decode windows, verify dispatches and the tree
        compaction) + mixed_device_s (mixed dispatches), and host_s, the
        rest of each step's wall after those and prefill_s; prefill tokens
        computed (cached prefixes excluded); the chunked-prefill tally
        (mixed dispatches, chunk rows, real and padded-out chunk
        positions); verify dispatches, pure and mixed together, and the
        mixed ones among them; the host tier's copy spans: spill_s (each
        demotion's batched device-to-host copy, enqueued), restore_s (each
        prefix restore's host-to-device copy through its event) and
        page_in_s (long-context page-ins, likewise)."""
        return {"device_s": 0.0, "decode_device_s": 0.0, "mixed_device_s": 0.0,
                "host_s": 0.0,
                "prefill_s": 0.0, "decode_s": 0.0, "mixed_s": 0.0, "verify_s": 0.0,
                "prefill_tokens": 0, "decode_slot_steps": 0, "steps": 0,
                "windows": 0, "mixed_steps": 0, "prefill_chunks": 0,
                "chunk_tokens": 0, "chunk_pad_tokens": 0, "verify_steps": 0,
                "mixed_verify_steps": 0, "spill_s": 0.0, "restore_s": 0.0,
                "page_in_s": 0.0}

    def _init_speculation(self) -> None:
        """The verify path's state: with inference.speculative validate the
        knobs and build the n-gram proposer; with speculation or
        inference.constrained (constrained slots decode through the verify
        dispatch) check that K10's block fits the verify width."""
        icfg, mcfg = self.icfg, self.mcfg
        self.spec_stats = SpecDecodeStats()
        self._spec: Optional[NgramProposer] = None
        self._tree = False
        self.constrained = icfg.constrained
        self.constraint_stats = ConstraintStats()
        # The current verify step's forced-run bookkeeping: slot -> the
        # number of leading drafts the FSM forced (consumed by acceptance).
        self._constraint_forced: dict[int, int] = {}
        if icfg.speculative:
            self._build_proposer()
        if icfg.speculative or self.constrained:
            # K10's float32 kernel holds every query row of a kv head in
            # one block: a verify width it cannot hold fails here, naming
            # the knob (the bf16 kernel takes any width).
            check_verify_fit(
                icfg.speculate_tokens + 1, n_heads=mcfg.n_heads,
                n_kv_heads=mcfg.n_kv_heads, head_dim=mcfg.resolved_head_dim,
                page_size=self.psz, dtype=torch_dtype(mcfg.dtype),
            )

    def _build_proposer(self) -> None:
        """inference.speculative: validate the knobs and build the n-gram
        proposer."""
        icfg = self.icfg
        if icfg.spec_min_draft_slots < 1:
            raise ValueError(
                f"inference.spec_min_draft_slots={icfg.spec_min_draft_slots} must be >= 1"
            )
        if icfg.spec_tree_width > icfg.speculate_tokens:
            raise ValueError(
                f"inference.spec_tree_width={icfg.spec_tree_width} exceeds "
                f"speculate_tokens={icfg.speculate_tokens}: a tree of w branches "
                f"needs at least w nodes"
            )
        if icfg.spec_tree_width > 1 and icfg.speculate_tokens + 1 > 31:
            raise ValueError(
                f"tree speculation packs the per-column ancestor mask into int32 "
                f"words: speculate_tokens={icfg.speculate_tokens} needs "
                f"{icfg.speculate_tokens + 1} columns > the 31-bit budget; lower "
                f"inference.speculate_tokens or set spec_tree_width=1"
            )
        self._spec = NgramProposer(
            speculate_tokens=icfg.speculate_tokens, max_n=icfg.spec_ngram_max,
            min_n=icfg.spec_ngram_min, tree_width=icfg.spec_tree_width,
        )
        self._tree = icfg.spec_tree_width > 1

    # -- public API --------------------------------------------------------

    def submit(
        self,
        prompt: Sequence[int],
        max_new_tokens: Optional[int] = None,
        *,
        temperature: Optional[float] = None,
        top_k: Optional[int] = None,
        top_p: Optional[float] = None,
        deadline_s: Optional[float] = None,
        priority: int = 0,
        constraint: Optional[Any] = None,
    ) -> int:
        """Queue a request; returns its id.

        ``deadline_s`` (seconds from now; default
        inference.default_deadline_s) bounds the request's life: past it,
        the request is reaped at the next step boundary with outcome
        "expired". ``priority`` (higher = more important) orders admission,
        page-pressure preemption (low classes evict first) and overload
        shedding. With inference.queue_limit an over-limit submit SHEDS the
        lowest-priority / nearest-deadline / newest never-run candidate,
        possibly this very request, with outcome "shed"; the shed request
        still surfaces from the next step(). After drain() or close() a
        submit is shed on arrival.

        ``constraint`` (an ``orion_tpu_torch.constrain.ConstraintSpec``)
        asks for grammar-constrained output: every emitted token keeps the
        output a legal prefix of the spec's regex or JSON schema. It needs
        inference.constrained=true; the spec compiles here (memoized by
        pattern hash), and a pattern this vocab can never satisfy raises
        ``ConstraintError`` here."""
        return self.submit_request(
            prompt, max_new_tokens, temperature=temperature, top_k=top_k,
            top_p=top_p, deadline_s=deadline_s, priority=priority,
            constraint=constraint,
        ).rid

    def submit_request(
        self,
        prompt: Sequence[int],
        max_new_tokens: Optional[int] = None,
        *,
        temperature: Optional[float] = None,
        top_k: Optional[int] = None,
        top_p: Optional[float] = None,
        deadline_s: Optional[float] = None,
        priority: int = 0,
        trace_id: Optional[int] = None,
        attempt: int = 0,
        constraint: Optional[Any] = None,
    ) -> Request:
        """submit() returning the live Request (``.generated`` grows as
        tokens are accepted; the typed ``.outcome`` is set at the end).
        ``trace_id`` / ``attempt`` are a router's trace context (its request
        id and failover attempt), which the lifecycle instants tag; a bare
        engine's caller leaves them (``tid`` is then the rid)."""
        if not len(prompt):
            raise ValueError("empty prompt")
        if temperature is not None and temperature < 0.0:
            raise ValueError(f"temperature must be >= 0, got {temperature}")
        if top_k is not None and not 0 <= top_k <= self.mcfg.vocab_size:
            raise ValueError(
                f"top_k must be in [0, vocab_size={self.mcfg.vocab_size}], "
                f"got {top_k} (0 disables the top-k filter)"
            )
        if top_p is not None and not 0.0 < top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {top_p}")
        cstate = None if constraint is None else self._compile_constraint(constraint)
        # Overrides equal to the defaults are the defaults: they must not
        # push the batch off the greedy (sort-free) sampling path.
        if temperature is not None and temperature == self.icfg.temperature:
            temperature = None
        if top_k is not None and top_k == self.icfg.top_k:
            top_k = None
        if top_p is not None and top_p == self.icfg.top_p:
            top_p = None
        limit = self.icfg.max_seq_len
        if len(prompt) >= limit:
            raise ValueError(f"prompt length {len(prompt)} >= max_seq_len {limit}")
        max_new = (
            max_new_tokens if max_new_tokens is not None
            else self.icfg.max_new_tokens
        )
        # The pool must hold this request ALONE at its largest footprint
        # plus one spare page, so mid-decode pool exhaustion is unreachable.
        max_context = min(len(prompt) + max(max_new, 0), limit)
        needed = self._worst_admission_need(len(prompt), max_context)
        usable = self.icfg.num_pages - 1
        shed_kind = None
        if needed > usable:
            if self._lazy and self._long_admission_need() <= usable:
                # Over-pool long context: the lazy working set fits (pages
                # materialize per chunk and die behind the window).
                pass
            elif self._long:
                # Infeasible long work is a typed outcome, not a raise.
                shed_kind = "context_too_long"
            else:
                raise ValueError(
                    f"request needs up to {needed} KV pages but the pool only "
                    f"has {usable}; raise inference.num_pages or lower "
                    f"max_new_tokens"
                )
        if deadline_s is None:
            deadline_s = self.icfg.default_deadline_s
        if deadline_s is not None and deadline_s <= 0:
            raise ValueError(f"deadline_s must be > 0, got {deadline_s}")
        req = Request(
            rid=next(self._rid), prompt=list(map(int, prompt)),
            max_new_tokens=max_new, temperature=temperature, top_k=top_k,
            top_p=top_p, priority=int(priority),
            deadline=time.monotonic() + deadline_s if deadline_s is not None else None,
            t_submit=time.perf_counter(), trace_id=trace_id, attempt=int(attempt),
            constraint=cstate,
        )
        if self._tracer.enabled:
            self._tracer.instant(
                "submit", rid=req.rid, priority=req.priority, prompt_tokens=len(req.prompt),
                max_new_tokens=req.max_new_tokens, deadline_s=deadline_s,
                **self._trace_ctx(req),
            )
        if shed_kind is not None:
            self._shed(req, f"context needs up to {needed} KV pages, pool has "
                            f"{usable} and the lazy working set does not fit",
                       kind=shed_kind)
            return req
        if self.draining:
            # Admission is stopped: a typed shed, never queued.
            self._shed(req, "draining")
            return req
        qlim = self.icfg.queue_limit
        if qlim is not None and len(self.waiting) >= qlim:
            victim = self.waiting.shed_victim(req)
            self._shed(victim, f"queue full ({qlim})")
            if victim is not req:
                self.waiting.remove(victim)
                self.waiting.append(req)
            return req
        self.waiting.append(req)
        return req

    def _compile_constraint(self, constraint) -> ConstraintState:
        """A submitted ConstraintSpec compiled to its token DFA (memoized
        across requests, LRU of inference.constraint_cache) and a fresh
        walk over it; the compile counters count it."""
        if not self.constrained:
            raise ValueError(
                "constraint= needs inference.constrained=true (the flag builds "
                "the verify path constrained slots decode through)"
            )
        if not isinstance(constraint, ConstraintSpec):
            raise ValueError(
                f"constraint must be a ConstraintSpec, got {type(constraint).__name__}"
            )
        t0 = time.perf_counter()
        dfa, hit = compile_constraint(
            constraint, self.mcfg.vocab_size,
            max_states=self.icfg.constraint_max_states,
            cache_size=self.icfg.constraint_cache,
        )
        cs = self.constraint_stats
        cs.requests += 1
        cs.compiles += 1
        if hit:
            cs.compile_hits += 1
        else:
            cs.compile_s += time.perf_counter() - t0
        return ConstraintState(dfa, self.eos_id)

    def _shed(self, req: Request, why: str, kind: Optional[str] = None) -> None:
        """End a request with outcome "shed" (or "shed:<kind>"; the
        context_too_long kind also counts in ``robust.shed_context``)."""
        log.warning("shedding request %d (priority %d): %s", req.rid, req.priority, why)
        req.done = True
        req.outcome = "shed" if kind is None else f"shed:{kind}"
        self.robust.shed += 1
        if kind == "context_too_long":
            self.robust.shed_context += 1
        self._drop_host_pages(req)
        self._just_finished.append(req)

    def cancel(self, rid: int) -> bool:
        """Cancel a request by id; False when it is unknown or already
        terminal. A waiting request ends at once; an active one is reaped
        at the next step boundary (pages released, full pages donated to
        the prefix cache) exactly like a finished request."""
        for i, r in enumerate(self.waiting):
            if r.rid == rid:
                del self.waiting[i]
                r.done = True
                r.outcome = "cancelled"
                self.robust.cancelled += 1
                self._drop_host_pages(r)
                self._just_finished.append(r)
                return True
        for r in self.slots:
            if r is not None and r.rid == rid and not r.done:
                r.done = True
                r.outcome = "cancelled"
                self.robust.cancelled += 1
                return True
        return False

    def step(self) -> list[Request]:
        """Reap expired and finished requests, admit new ones, then run one
        mixed step (while prompt chunks are pending) or a prefill of the
        admitted burst and one decode window over every live slot; returns
        the requests that reached a typed outcome. The step's wall splits
        into ``timing`` (device_s, prefill_s, host_s), and with
        inference.decode_window_autotune a plain decode step's split
        resizes the window.

        A DispatchFault or MemoryError fails the STEP, not the process:
        injected dispatch faults fire before the device call, a prefill
        fault unwinds its admissions, a grow fault leaves its pages owned,
        so the state stays consistent and the next step retries. After
        inference.max_step_faults consecutive failed steps the fault is
        not transient and is re-raised."""
        t0 = time.perf_counter()
        m0 = time.monotonic() if self._tracer.enabled else 0.0
        if self._watchdog is not None and self._watchdog.armed:
            # Refreshed at step START, so idle time between steps never
            # reads as a stall; arming stays with the step-end heartbeat.
            self._watchdog.heartbeat()
        self._dev_span = self._mixed_span = self._prefill_span = 0.0
        self._spill_span = self._restore_span = self._pagein_span = 0.0
        self._spec_step = False
        self._reap_expired()
        # Expired and cancelled slots go before admission budgets.
        self._reap()
        decoded = mixed = False
        try:
            self._admit()
            self._maybe_inject_nan()
            mixed = self.chunked and any(
                r is not None and r.prefill_pending and not r.done for r in self.slots
            )
            decoded = self._mixed_decode() if mixed else self._decode_all()
            self._consec_failed = 0
        except (DispatchFault, MemoryError) as e:
            if isinstance(e, MemoryError):
                self.robust.pool_faults += 1
            self.robust.failed_steps += 1
            self._consec_failed += 1
            log.error("engine step %d failed (%s); continuing (%d/%d consecutive)",
                      self.step_no, e, self._consec_failed, self.icfg.max_step_faults)
            self._flight_note("failed_step", consecutive=self._consec_failed,
                              error=f"{type(e).__name__}: {e}")
            if self._consec_failed >= self.icfg.max_step_faults:
                self._flight_dump("max_step_faults", consecutive=self._consec_failed,
                                  error=str(e))
                raise
        total = time.perf_counter() - t0
        tm = self.timing
        tm["device_s"] += self._dev_span + self._mixed_span
        tm["decode_device_s"] += self._dev_span
        tm["mixed_device_s"] += self._mixed_span
        # The host tier's copies have buckets of their own: neither decode
        # device time nor scheduler host time.
        tm["spill_s"] += self._spill_span
        tm["restore_s"] += self._restore_span
        tm["page_in_s"] += self._pagein_span
        tm["host_s"] += (total - self._dev_span - self._mixed_span - self._prefill_span
                         - self._tier_span())
        if decoded:
            tm["windows"] += 1
            # Only plain decode windows steer the window: a mixed step's or
            # a verify step's split says nothing about it.
            if self.icfg.decode_window_autotune and not mixed and not self._spec_step:
                if self._autotune_skip:
                    # The first step at a new W carries its graph's capture
                    # (the JAX engine's recompile): not steady state.
                    self._autotune_skip = False
                else:
                    self._autotune_window(total)
        tm["steps"] += 1
        if self._watchdog is not None:
            if self._watchdog.stalled:
                # The watchdog fired during this step: counted, not fatal.
                self.robust.stalled_steps += 1
                self._flight_dump("watchdog_stall", step_wall_s=total)
            self._watchdog.heartbeat()
        if self._tracer.enabled:
            self._trace_step(m0, decoded)
        self.step_no += 1
        done, self._just_finished = self._just_finished, []
        return done

    def _tier_span(self) -> float:
        """The step's host-tier copy time so far (spill, restore, page-in)."""
        return self._spill_span + self._restore_span + self._pagein_span

    def has_work(self) -> bool:
        return (
            bool(self.waiting) or bool(self._just_finished)
            or any(r is not None for r in self.slots)
        )

    def generate(
        self,
        prompts: Sequence[Sequence[int]],
        max_new_tokens: Optional[int] = None,
    ) -> list[list[int]]:
        """Drain loop: generated tokens per prompt, in submission order."""
        rids = [self.submit(p, max_new_tokens) for p in prompts]
        results: dict[int, list[int]] = {}
        while self.has_work():
            for req in self.step():
                results[req.rid] = req.generated
        return [results[rid] for rid in rids]

    def stream(
        self,
        prompts: Sequence[Sequence[int]],
        max_new_tokens: Optional[int] = None,
    ):
        """Incremental drain loop: yields ``(rid, new_tokens)`` per advanced
        request per engine step; a request that finishes with no token is
        announced once with ``[]``."""
        reqs = [self.submit_request(p, max_new_tokens) for p in prompts]
        emitted = [0] * len(reqs)
        pending = set(range(len(reqs)))
        while pending:
            self.step()
            for i in sorted(pending):
                req = reqs[i]
                if len(req.generated) > emitted[i]:
                    yield req.rid, req.generated[emitted[i]:]
                    emitted[i] = len(req.generated)
                if req.done and emitted[i] == len(req.generated):
                    if emitted[i] == 0:
                        yield req.rid, []
                    pending.discard(i)

    def clear_prefix_cache(self) -> int:
        """Drop every cached prefix (idle cached pages return to the free
        list); returns the pages released. Live requests keep their shared
        pages through their own refs. 0 with the prefix cache off."""
        if self._pcache is None:
            return 0
        return self._pcache.clear()

    def prefix_match_tokens(self, context: Sequence[int]) -> int:
        """Tokens of ``context`` the prefix cache could serve right now
        (read only: no locks, no LRU stamps, no splits), with
        ``_match_prefix``'s gates: 0 below prefix_cache_min_pages, below
        the window's dead-page boundary, or with the cache off. A
        host-resident span counts only when the break-even gate would
        restore it."""
        if self._pcache is None:
            return 0
        cap = len(context) // self.psz
        if self.page_window is not None:
            cap = (len(context) - 1) // self.psz   # no full match under a window
        pages, host, first_host = self._pcache.peek_tiered(context, cap)
        if host and (self._host_pool is None or host * self.psz < self._host_min_tokens):
            pages = first_host
        if pages < max(self.icfg.prefix_cache_min_pages, 1):
            return 0
        if self.page_window is not None and pages < self._first_live_page(len(context)):
            return 0
        return pages * self.psz

    def _autotune_window(self, step_total: float) -> None:
        """Resize the decode window from the step's measured split (the JAX
        engine's rule): double while the host share of the step exceeds
        inference.decode_host_share_target, halve when it falls below a
        quarter of the target; floor inference.decode_window, cap
        decode_window_max. A resize arms ``_autotune_skip``: the next
        decode step captures the new W's graph, which would skew the very
        split this reads."""
        host = step_total - self._dev_span - self._prefill_span - self._tier_span()
        share = host / (step_total if step_total > 0 else 1.0)
        target = self.icfg.decode_host_share_target
        if share > target and self.decode_window * 2 <= self.icfg.decode_window_max:
            self.decode_window *= 2
        elif share < target / 4 and self.decode_window // 2 >= self.icfg.decode_window:
            self.decode_window //= 2
        else:
            return
        self._autotune_skip = True
        log.info("decode_window autotune: host share %.2f, window -> %d",
                 share, self.decode_window)

    @contextlib.contextmanager
    def _device_span(self, path: str, span: str = "_dev_span", *keys: str):
        """Time the ``path`` dispatch through its host fetch into the step's
        ``span`` (and ``timing[k]`` for each of ``keys``), and record a
        ``dispatch/<path>`` tracer span over the same window, tagged with
        the step and, when tracing, the trace ids of the live slots. A
        dispatch that raises credits nothing, while its tracer span still
        records (the JAX engine's ``_device_span``)."""
        tags = {"step": self.step_no}
        if self._tracer.enabled:
            # Built only when tracing: the untraced host path is unchanged.
            tags["tids"] = [r.trace_id if r.trace_id is not None else r.rid
                            for r in self.slots if r is not None and not r.done]
        t0 = time.perf_counter()
        with self._tracer.span("dispatch/" + path, **tags):
            yield
        dt = time.perf_counter() - t0
        setattr(self, span, getattr(self, span) + dt)
        for k in keys:
            self.timing[k] += dt

    def reset_timing(self) -> dict:
        """Return and zero ``timing``, with the current decode_window; with
        the prefix cache or long context the counters of ``prefix_stats``
        (prefix_hits/misses/hit_rate, cached_tokens, inserted/evicted/cow
        pages, the host tier's and per-request paging's); with
        inference.speculative the speculation counters of ``spec_stats``
        (spec_drafted/accepted/rolled_back/emitted, spec_acceptance_rate,
        verify_steps, verify_slot_steps, spec_tokens_per_verify,
        spec_gated_steps, the tree counters and spec_disabled_reason,
        which survives the drain); and always the robustness counters of
        ``robust`` (shed/expired/cancelled/quarantined requests, dispatch
        faults, failed, stalled steps, pool faults); with
        inference.constrained the grammar counters of ``constraint_stats``
        (constrain_*). Counters are zeroed."""
        out, self.timing = self.timing, self._zero_timing()
        out["decode_window"] = self.decode_window
        # prefix_stats also carries the per-request paging counters, which
        # exist without a prefix tree.
        if self._pcache is not None or self._long:
            out.update(self.prefix_stats.as_timing())
            self.prefix_stats = PrefixCacheStats()
        if self._spec is not None:
            out.update(self.spec_stats.as_timing())
            # Disablement is engine-lifetime state, not a window counter.
            self.spec_stats = SpecDecodeStats(
                disabled_reason=self.spec_stats.disabled_reason)
        if self.constrained:
            out.update(self.constraint_stats.as_timing())
            self.constraint_stats = ConstraintStats()
        out.update(self.robust.as_timing())
        self.robust = RobustnessStats()
        if self.icfg.metrics_jsonl or self.icfg.metrics_prom:
            # The exporters ride the drain point: one JSONL row and one
            # Prometheus rewrite a window, the drained counters beside the
            # live gauges.
            row = {f"serve.{k}": v for k, v in out.items()}
            row.update(self.registry.snapshot(sections=("pool", "hbm")))
            try:
                if self.icfg.metrics_jsonl:
                    self.registry.export_jsonl(self.icfg.metrics_jsonl, snapshot=row)
                if self.icfg.metrics_prom:
                    self.registry.export_prometheus(self.icfg.metrics_prom, snapshot=row)
            except OSError as e:
                log.error("metrics export failed: %s", e)
        return out

    def drain(self) -> list[Request]:
        """Graceful shutdown (the SIGTERM path of ``generate``): stop
        admission, shed the never-run queue with typed outcomes, finish
        every live or in-flight request (their pages donated to the prefix
        cache as on normal completion), and return every request that
        ended during the drain. Ends with the pool fully accounted
        (assert_page_accounting). Idempotent."""
        self.draining = True
        keep = AdmissionQueue()
        while self.waiting:
            r = self.waiting.popleft()
            if in_flight(r):
                keep.append(r)   # preempted or unwound after running: finish it
            else:
                self._shed(r, "draining")
        self.waiting = keep
        drained: list[Request] = []
        while self.has_work():
            drained.extend(self.step())
        self.assert_page_accounting()
        return drained

    def close(self) -> None:
        """Stop admission for good (a later submit is a typed shed) and the
        watchdog's thread; flush the metrics exporters (a final drain) and
        export the Chrome trace to inference.trace_path. Idempotent: the
        flush and export run once, so a second close appends no all-zero
        row."""
        self.draining = True
        if not self._closed:
            self._closed = True
            if self.icfg.metrics_jsonl or self.icfg.metrics_prom:
                # A short-lived serve (the CLI, which never drains itself)
                # still flushes its tail window.
                self.reset_timing()
            export_chrome_safe(self._tracer, self.icfg.trace_path)
        if self._watchdog is not None:
            self._watchdog.stop()

    def assert_page_accounting(self) -> None:
        """The pool invariant: every page's allocator refcount equals its
        owners — one per page a request maps plus one per prefix-cache
        node holding it — and the free list holds exactly the rest; with
        the host tier, the same of its slots. A double release or a leak
        in any teardown path trips it."""
        n = self.icfg.num_pages
        refs = [0] * n
        owners = [r for r in self.slots if r is not None]
        owners += list(self.waiting) + list(self._just_finished)
        for req in owners:
            for p in req.pages:
                if p is not None:
                    refs[p] += 1
        if self._pcache is not None:
            for p in self._pcache.held_pages():
                refs[p] += 1
        bad = [(p, refs[p], self.alloc.refcount(p))
               for p in range(1, n) if refs[p] != self.alloc.refcount(p)]
        assert not bad, f"page refcount mismatch (page, owners, refcount): {bad[:8]}"
        live = sum(1 for p in range(1, n) if refs[p] > 0)
        assert self.alloc.free_pages == n - 1 - live, (
            f"free-list size {self.alloc.free_pages} != {n - 1 - live} "
            f"(pool {n}, live {live})"
        )
        if self._host_pool is not None:
            self._assert_host_accounting(owners)

    def _assert_host_accounting(self, owners: list[Request]) -> None:
        """The host half of the invariant: each held host slot's refcount
        is its owners (one per tree HostPage marker, one per entry of a
        request's host_pages), the free list holds the rest, and the
        tree's host_pages counter equals its markers."""
        hp = self._host_pool
        hrefs = [0] * hp.capacity
        tlive = 0
        if self._pcache is not None:
            for h in self._pcache.held_host_pages():
                hrefs[h] += 1
            tlive = sum(1 for h in range(hp.capacity) if hrefs[h] > 0)
        for req in owners:
            for h in req.host_pages.values():
                hrefs[h] += 1
        hbad = [(h, hrefs[h], hp.refcount(h))
                for h in range(hp.capacity) if hrefs[h] != hp.refcount(h)]
        assert not hbad, f"host slot refcount mismatch (slot, owners, refcount): {hbad[:8]}"
        hlive = sum(1 for h in range(hp.capacity) if hrefs[h] > 0)
        assert hp.free_slots == hp.capacity - hlive, (
            f"host free-list size {hp.free_slots} != {hp.capacity - hlive} "
            f"(capacity {hp.capacity}, live {hlive})"
        )
        if self._pcache is not None:
            assert self._pcache.host_pages == tlive, (
                f"host_pages counter {self._pcache.host_pages} != marker count {tlive}")

    # -- fault containment -------------------------------------------------

    def _note_spec_fault(self, e: Exception) -> None:
        """Count a verify-path dispatch fault; past inference.spec_fault_limit
        speculation switches off for the engine's life
        (SpecDecodeStats.disabled_reason) and decoding goes on through the
        plain window (K4)."""
        self._spec_faults += 1
        log.warning("speculative verify dispatch fault %d/%d: %s",
                    self._spec_faults, self.icfg.spec_fault_limit, e)
        if self._spec_faults >= self.icfg.spec_fault_limit and not self._spec_disabled:
            self._spec_disabled = True
            self.spec_stats.disabled_reason = (
                f"auto-disabled after {self._spec_faults} verify dispatch faults")
            log.error("speculative decoding %s", self.spec_stats.disabled_reason)
            self._flight_dump("spec_auto_disable", spec_faults=self._spec_faults)

    def _maybe_inject_nan(self) -> None:
        """FaultSpec kind="nan": poison the victim's newest attended PRIVATE
        page with NaN. The poison flows through the real attention into
        that slot's logits only (no other slot reads its pages)."""
        inj = self._injector
        if inj is None:
            return
        spec = inj.take("nan", self.step_no)
        if spec is None:
            return
        cands = [r for r in self.slots
                 if r is not None and not r.done and (spec.rid is None or r.rid == spec.rid)]
        if not cands:
            log.warning("nan injection at step %d found no victim", self.step_no)
            return
        req = min(cands, key=lambda r: r.admit_seq)
        # Walk back from the cursor's page: the newest written position is
        # always attended, and shared (refcount > 1) prefix pages are other
        # requests' data.
        pos = max(int(self.seq_lens[req.slot]) - 1, 0)
        for i in range(min(pos // self.psz, len(req.pages) - 1), -1, -1):
            p = req.pages[i]
            if p is not None and self.alloc.refcount(p) == 1:
                log.warning("injecting NaN into page %d of request %d (step %d)",
                            p, req.rid, self.step_no)
                poison_page(self.cache, p, n_layers=self.mcfg.n_layers,
                            num_pages=self.icfg.num_pages)
                return
        log.warning("nan injection: request %d has no private page", req.rid)

    def _quarantine(self, req: Request, reason: str) -> None:
        """Contain a poisoned slot: typed outcome ``error:<reason>``, its
        private pages SCRUBBED (every page it owns alone, those provisioned
        ahead for the window included, padded with scratch page 0 as the
        JAX engine pads) and released with NO prefix-cache donation.
        Neighbours never read its pages, so their streams are unchanged."""
        log.error("quarantining request %d (%s)", req.rid, reason)
        priv = [p for p in req.pages if p is not None and self.alloc.refcount(p) == 1]
        if priv:
            scrub_pages(self.cache, priv + [0] * (self.pages_per_seq - len(priv)),
                        n_layers=self.mcfg.n_layers, num_pages=self.icfg.num_pages)
        req.done = True
        req.outcome = f"error:{reason}"
        self.robust.quarantined += 1
        self._teardown_slot(req, 0)   # n_cached=0: donate nothing
        self._just_finished.append(req)
        self._flight_dump(f"{reason}_quarantine", rid=req.rid)

    def _quarantine_failed(self, reqs: list[Request], ok: Optional[np.ndarray]) -> list[Request]:
        """Quarantine the slots whose guard flag is False; the rest."""
        if ok is None:
            return reqs
        for r in reqs:
            if not ok[r.slot]:
                self._quarantine(r, "nan")
        return [r for r in reqs if r.slot is not None]

    def _reap_expired(self) -> None:
        """Step-boundary deadline sweep: expired requests, waiting or active
        (mid-prefill or mid-decode), end with outcome "expired"; active
        ones are reaped with prefix-cache donation as on completion."""
        now = time.monotonic()
        for r in self.waiting.sweep_expired(now):
            r.done = True
            r.outcome = "expired"
            self.robust.expired += 1
            self._drop_host_pages(r)
            self._just_finished.append(r)
        for r in self.slots:
            if (r is not None and not r.done and r.deadline is not None
                    and now >= r.deadline):
                r.done = True
                r.outcome = "expired"
                self.robust.expired += 1

    # -- scheduler internals ----------------------------------------------

    def _bucket_len(self, n: int) -> int:
        return min(round_up(n, self.icfg.prefill_chunk), self.icfg.max_seq_len)

    @property
    def _provision_window(self) -> int:
        """Positions a step may write past a slot's cursor, which admission
        budgets for: the decode window (with the autotune, the largest it
        may grow to), or with speculation at least speculate_tokens + 1 (a
        verify step writes draft KV that far)."""
        base = (self.icfg.decode_window_max if self.icfg.decode_window_autotune
                else self.decode_window)
        if self.icfg.speculative:
            return max(base, self.icfg.speculate_tokens + 1)
        return base

    def _first_window(self, last_written: int) -> int:
        """Pages a slot needs through the first decode window after its
        context (``last_written`` = the last context position)."""
        last = min(last_written + self._provision_window, self.icfg.max_seq_len - 1)
        return min(last // self.psz + 1, self.pages_per_seq)

    def _admission_need(self, context_len: int) -> tuple[int, int, int]:
        """(n_pages, first_live, need): the prefill's pages, the first page
        a windowed sequence still reads (pages below it are dead on
        arrival: never allocated), and the pool demand of admitting a
        request whose context is ``context_len`` tokens — the live prefill
        pages or the first decode window's, plus one spare. Chunked
        prefill allocates every logical page (a later chunk reads
        window-distant positions from the pool; _roll_window frees them
        as the chunk cursor advances)."""
        n_pages = self._bucket_len(context_len) // self.psz
        first_live = 0 if self.chunked else self._first_live_page(context_len)
        first_window = self._first_window(context_len - 1)
        return n_pages, first_live, max(n_pages - first_live + 1,
                                        first_window - first_live + 1)

    def _admission_need_warm(
        self, context_len: int, n_match: int, full: bool
    ) -> tuple[int, int, int, int]:
        """(n_pages, first_live, n_alloc, need) of a prefix-matched
        admission: ``n_alloc`` fresh pages (the uncached tail, no bucket
        padding, or the one copy-on-write page of a full match), the
        matched pages behind the window left unmapped, and ``need`` the
        same prefill + first-window demand as a cold admission's. Never
        above the cold need submit() checked."""
        if full:
            # Decode restarts at position len-1, rewriting the final
            # token's KV slot in a private copy of the last matched page.
            n_pages, n_alloc = n_match, 1
            first_window = self._first_window(context_len - 2)
        else:
            n_pages = -(-context_len // self.psz)
            n_alloc = n_pages - n_match
            first_window = self._first_window(context_len - 1)
        first_live = 0 if full else self._first_live_page(n_match * self.psz)
        return (n_pages, first_live, n_alloc,
                max(n_alloc + 1, n_alloc + first_window - n_pages + 1))

    def _worst_admission_need(self, min_ctx: int, max_ctx: int) -> int:
        """Max admission need over every context in [min_ctx, max_ctx]
        (under a window the peak sits at a prefill bucket's bottom, not
        at max_ctx)."""
        ctxs = np.arange(min_ctx, max_ctx + 1, dtype=np.int64)
        msl, W, psz = self.icfg.max_seq_len, self.page_window, self.psz
        bucket = np.minimum(round_up(ctxs, self.icfg.prefill_chunk), msl)
        first_live = (np.maximum(ctxs - W + 1, 0) // psz if W is not None and not self.chunked
                      else np.zeros_like(ctxs))
        last = np.minimum(ctxs + self._provision_window - 1, msl - 1)
        first_window = np.minimum(last // psz + 1, self.pages_per_seq)
        return int(np.maximum(bucket // psz - first_live + 1,
                              first_window - first_live + 1).max())

    def _available(self) -> int:
        """Pool headroom: free pages plus every cached page no live request
        has pinned (the cache is reclaimable headroom, not a tenant)."""
        ev = self._pcache.evictable_pages() if self._pcache is not None else 0
        return self.alloc.free_pages + ev

    def _alloc_pages(self, n: int) -> list[int]:
        """Allocate n pages, evicting LRU prefix-cache pages as needed. Every
        page allocation of the engine comes here: the injection point of
        FaultSpec kind="pool", which admission absorbs by deferring the
        request and page growth by failing the step."""
        if self._injector is not None and self._injector.take("pool", self.step_no) is not None:
            raise MemoryError(f"injected pool exhaustion (step {self.step_no})")
        short = n - self.alloc.free_pages
        if short > 0 and self._pcache is not None:
            self.prefix_stats.evicted_pages += self._pcache.evict(short)
        return self.alloc.alloc(n)

    # -- host tier (inference.host_tier_bytes): the two batched copy
    #    envelopes and the break-even gate ------------------------------

    def _copies_done(self) -> None:
        """Wait for the copies just enqueued on the engine's stream (an
        event, not the whole device), so a failed copy surfaces inside
        its envelope."""
        if self.device.type == "cuda":
            ev = torch.cuda.Event()
            ev.record()
            ev.synchronize()

    def _spill_pages(self, pages: list[int], *, tree: bool = True) -> Optional[list[int]]:
        """The prefix cache's spill callback (and per-request paging's):
        copy the pages' KV (every cache tensor, scale rows included) into
        host slots with ONE batched gather and device-to-host copy,
        enqueued on the engine's stream (the pool's events guard the
        slots). Returns the slot ids (one engine ref each), or None when
        the tier cannot take them: the caller discards or stays resident,
        so a failed spill degrades the cache, never the step."""
        hp = self._host_pool
        try:
            hids = hp.alloc(len(pages))
        except MemoryError:
            return None
        idx = torch.as_tensor(pages, dtype=torch.long)

        def copy():
            blocks = gather_pages(self.cache, idx.to(self.device), n_layers=self.mcfg.n_layers,
                                  num_pages=self.icfg.num_pages)
            hp.store(hids, blocks)

        try:
            with self._device_span("spill", "_spill_span"), \
                    self._tracer.annotation("orion/spill"):
                self._executor.contain("spill", copy)
        except DispatchFault as e:
            hp.free(hids)
            log.error("host-tier spill failed (%s); discarding instead", e)
            return None
        if tree:
            # Per-request paging's pages never pass through the tree: they
            # count as request_paged_out.
            self.prefix_stats.evicted_to_host += len(pages)
        return hids

    def _scatter_from_host(self, hids: list[int], pages: list[int]) -> None:
        """One batched host-to-device copy of ``hids`` into pool ``pages``,
        through its event (raises inside the caller's envelope); a
        "restore" fault of this step fires here."""
        if (self._injector is not None
                and self._injector.take("restore", self.step_no) is not None):
            raise InjectedFault(f"injected restore fault (step {self.step_no})")
        blocks = self._host_pool.load_to(hids, self.device)
        scatter_pages(self.cache, torch.as_tensor(pages, dtype=torch.long).to(self.device),
                      blocks, n_layers=self.mcfg.n_layers, num_pages=self.icfg.num_pages)
        self._copies_done()

    def _restore_pages(self, pages: list, node, host_idx: list[int]) -> None:
        """Restore a matched path's host-resident entries into fresh pool
        pages (one batched copy), then promote the tree's markers to them;
        the caller maps the match as a warm device hit. Runs under the
        match's lock, with one engine ref per slot in flight. Pool
        exhaustion raises MemoryError; a failed copy (or an injected
        "restore" fault) frees the fresh pages, drops the in-flight refs,
        leaves the markers as they were and raises DispatchFault."""
        hp = self._host_pool
        hids = [pages[i].hid for i in host_idx]
        for h in hids:
            hp.retain(h)
        try:
            fresh = self._alloc_pages(len(hids))
        except MemoryError:
            hp.free(hids)
            raise
        try:
            with self._device_span("restore", "_restore_span"), \
                    self._tracer.annotation("orion/restore"):
                self._executor.contain("restore", self._scatter_from_host, hids, fresh)
        except DispatchFault:
            self.alloc.free(fresh)
            hp.free(hids)
            raise
        self._pcache.promote_path(node, dict(zip(host_idx, fresh)))
        hp.free(hids)
        for i, p in zip(host_idx, fresh):
            pages[i] = p
        self.prefix_stats.host_hits += 1
        self.prefix_stats.host_restored_pages += len(hids)

    def _resolve_host_match(self, context, pages: list, node):
        """A match holding host-resident entries: restore them all when
        the host span passes the break-even gate, else re-match cut at the
        first host entry (prefill needs a contiguous device prefix).
        Returns the mappable (pages, node)."""
        host_idx = [i for i, p in enumerate(pages) if isinstance(p, HostPage)]
        if self._host_pool is not None and len(host_idx) * self.psz >= self._host_min_tokens:
            try:
                self._restore_pages(pages, node, host_idx)
                return pages, node
            except MemoryError as e:
                # Too tight for the restore now: recompute always works.
                log.warning("host-tier restore deferred to recompute (%s)", e)
            except DispatchFault:
                self._pcache.unlock(node)   # the step fails; retry re-matches
                raise
        self.prefix_stats.host_recompute_skips += 1
        self._pcache.unlock(node)
        if host_idx[0] == 0:
            return [], None
        return self._pcache.match(context, host_idx[0])

    def offload_prefix_cache(self) -> int:
        """Demote every evictable device-resident cached page to the host
        tier (one batched copy): a replica handing off its traffic parks
        its working set in host memory, and later hits restore it. Returns
        the pages demoted; 0 with the tier or the cache off. Runs outside
        step(), so its spill time goes straight into timing["spill_s"]."""
        if self._pcache is None or self._host_pool is None:
            return 0
        self._spill_span = 0.0
        n = self._pcache.demote(self._pcache.evictable_pages())
        self.prefix_stats.evicted_pages += n
        self.timing["spill_s"] += self._spill_span
        self._spill_span = 0.0
        return n

    # -- sliding-window page rolling and per-request paging
    #    (inference.long_context) -------------------------------------------

    def _first_live_page(self, context_len: int) -> int:
        """First logical page a sequence at ``context_len`` still reads:
        the next query (position ``context_len``) attends positions above
        context_len - window, so pages wholly before that are dead. 0
        without a window on every layer."""
        W = self.page_window
        if W is None:
            return 0
        return max(context_len - W + 1, 0) // self.psz

    def _roll_window(self) -> None:
        """Return the pages behind the sliding window to the pool (the
        kernels' masks exclude them), so a windowed sequence holds
        O(window) pages. Freed logical pages keep a None entry so indices
        stay position-aligned; their table entries point at scratch page
        0. A host-resident page the window passed is dropped from the
        tier, never restored just to die."""
        if self.page_window is None:
            return
        for req in self.slots:
            if req is None or req.slot is None:
                continue
            first = min(self._first_live_page(int(self.seq_lens[req.slot])), len(req.pages))
            if first <= req.freed_until:
                continue
            dead = [p for p in req.pages[req.freed_until:first] if p is not None]
            for j in range(req.freed_until, first):
                req.pages[j] = None
            self.page_table[req.slot, req.freed_until:first] = 0
            req.freed_until = first
            if dead:
                self.alloc.free(dead)
            if req.host_pages:
                rolled = [j for j in req.host_pages if j < first]
                if rolled:
                    self._host_pool.free([req.host_pages.pop(j) for j in rolled])

    def _long_admission_need(self) -> int:
        """Worst-instant pool demand of the lazy chunked path: the pages
        spanned by [cursor - W + 1, cursor + X - 1] for any page-aligned
        cursor (X the larger of a chunk and the provisioning window), one
        page of misalignment and the spare. O(window), whatever the
        context's length."""
        X = max(self.icfg.prefill_chunk_tokens, self._provision_window)
        return (self.page_window + X - 2) // self.psz + 3

    def _drop_host_pages(self, req: Request) -> None:
        """Release every host slot a request holds (terminal paths and a
        recompute-from-scratch preemption: stale KV leaves the tier)."""
        if req.host_pages:
            self._host_pool.free(list(req.host_pages.values()))
            req.host_pages.clear()
        req.host_cursor = 0

    def _page_out(self, req: Request) -> None:
        """Residency cap (inference.request_resident_pages): after a long
        request's chunk, demote its oldest live private pages beyond the
        cap to host slots in one batched copy, freeing device pages for
        co-tenants between its turns. They page back in before the chunk
        that reads them. A failed spill leaves them resident."""
        cap = self.icfg.request_resident_pages
        if not cap or not self._long or req.slot is None:
            return
        live = [j for j in range(req.freed_until, len(req.pages))
                if req.pages[j] is not None and j >= req.n_prefix]
        excess = len(live) - cap
        if excess <= 0:
            return
        victims = live[:excess]
        pages = [req.pages[j] for j in victims]
        hids = self._spill_pages(pages, tree=False)
        if hids is None:
            return
        for j, h in zip(victims, hids):
            req.host_pages[j] = h
            req.pages[j] = None
        self.page_table[req.slot, victims] = 0
        self.alloc.free(pages)
        self.prefix_stats.request_paged_out += len(pages)
        if self._tracer.enabled:
            self._tracer.instant("page_out", rid=req.rid, pages=len(pages), step=self.step_no,
                                 **self._trace_ctx(req))

    def _page_in_request(self, req: Request) -> None:
        """Restore a live request's host-resident pages into fresh pool
        pages with one batched copy, ahead of the dispatch that reads
        them. Pool exhaustion raises MemoryError (the request keeps its
        host refs); a failed copy (or an injected "restore" fault) frees
        the fresh pages, keeps every host ref and raises DispatchFault, so
        the step fails and a retry pages in from scratch."""
        if not req.host_pages:
            return
        due = sorted(req.host_pages)
        hids = [req.host_pages[j] for j in due]
        fresh = self._alloc_pages(len(hids))
        try:
            with self._device_span("page_in", "_pagein_span"), \
                    self._tracer.annotation("orion/page_in"):
                self._executor.contain("page_in", self._scatter_from_host, hids, fresh)
        except DispatchFault:
            self.alloc.free(fresh)
            raise
        for j, p in zip(due, fresh):
            req.pages[j] = p
            del req.host_pages[j]
        self._host_pool.free(hids)
        self.page_table[req.slot, due] = fresh
        self.prefix_stats.request_paged_in += len(hids)
        if self._tracer.enabled:
            self._tracer.instant("page_in", rid=req.rid, pages=len(hids), step=self.step_no,
                                 **self._trace_ctx(req))

    def _provision_chunk_pages(self, req: Request, k: int) -> None:
        """Lazy pages for the next chunk (the over-pool admission path
        allocates none up front): extend the request's pages to cover
        [cursor, cursor + k). Pool exhaustion raises MemoryError."""
        n_need = -(-(req.prefill_done + k) // self.psz)
        while len(req.pages) < n_need:
            page = self._alloc_pages(1)[0]
            self.page_table[req.slot, len(req.pages)] = page
            req.pages.append(page)

    def _preempt_to_host(self, req: Request, cursor: int) -> bool:
        """Preempt-to-host (inference.long_context): spill the victim's
        live private pages to host slots and resume at ``cursor`` on
        re-admission, in place of the O(context) re-prefill, when the span
        passes the break-even gate. Returns True when the request left its
        slot host-resident; False runs the plain preemption."""
        if not self._long or self._host_pool is None or req.n_prefix:
            # Shared prefix pages belong to the tree, which tiers them.
            return False
        live = [j for j in range(req.freed_until, len(req.pages)) if req.pages[j] is not None]
        if (len(live) + len(req.host_pages)) * self.psz < self._host_min_tokens:
            return False
        if live:
            hids = self._spill_pages([req.pages[j] for j in live], tree=False)
            if hids is None:
                return False   # tier full or a failed copy: plain preemption
            req.host_pages.update(zip(live, hids))
            self.prefix_stats.request_paged_out += len(live)
        slot = req.slot
        req.host_cursor = cursor
        req.host_last_token = int(self.last_token[slot])
        self.alloc.free([req.pages[j] for j in live])
        req.pages = []
        if self._spec is not None:
            self._spec.drop(req.rid)
        req.slot = None
        self.slots[slot] = None
        self.page_table[slot] = 0
        self.seq_lens[slot] = 0
        self.last_token[slot] = 0
        self.waiting.appendleft(req)
        if self._tracer.enabled:
            self._tracer.instant("preempt_to_host", rid=req.rid, pages=len(live), cursor=cursor,
                                 step=self.step_no, **self._trace_ctx(req))
        return True

    def _readmit_host(self, req: Request, slot: int, reserved: int) -> Optional[int]:
        """Re-admit a host-resident request: fresh pages for every spilled
        logical page, one batched restore, and decode or chunking resumes
        at the spill-time cursor with no re-prefill. Returns the claimed
        but unallocated pages (the caller's ``reserved`` delta), or None
        (head-of-line block) when the pool lacks the headroom; a failed
        restore re-queues the request at the head, still host-resident,
        and raises."""
        n = len(req.host_pages)
        first_window = self._first_window(req.host_cursor - 1)
        n_logical = max(max(req.host_pages) + 1 if req.host_pages else 0,
                        -(-req.host_cursor // self.psz))
        need = max(n + 1, n + first_window - n_logical + 1)
        if self._available() - reserved < need:
            return None
        req.slot = slot
        req.admit_seq = next(self._admit_seq)
        req.pages = [None] * n_logical
        self.slots[slot] = req
        self.page_table[slot] = 0
        try:
            self._page_in_request(req)
        except (MemoryError, DispatchFault):
            req.pages = []
            req.slot = None
            self.slots[slot] = None
            self.waiting.appendleft(req)
            raise
        self._set_sampling(req)
        self.seq_lens[slot] = req.host_cursor
        self.last_token[slot] = req.host_last_token
        req.prefill_done = req.host_cursor
        req.prefill_pending = req.host_cursor < len(req.context)
        req.host_cursor = 0
        if self._tracer.enabled:
            self._tracer.instant("admit", rid=req.rid, slot=slot, step=self.step_no,
                                 priority=req.priority, host_restored=n, **self._trace_ctx(req))
        return need - n

    def _match_prefix(self, context: list[int]):
        """(n_match, pages, node): the longest usable cached prefix of
        ``context``, page-granular, LOCKED against eviction (the caller
        owns the unlock). A full match of a page-multiple context is
        allowed (the copy-on-write admission recomputes its last token
        through decode), except under a window, where a match must also
        reach the dead-page boundary of a cold admission. Host-resident
        entries are restored or cut off first (``_resolve_host_match``)."""
        if self._pcache is None:
            return 0, [], None
        cap = len(context) // self.psz
        if self.page_window is not None:
            cap = (len(context) - 1) // self.psz
        pages, node = self._pcache.match(context, cap)
        if node is not None and any(isinstance(p, HostPage) for p in pages):
            pages, node = self._resolve_host_match(context, pages, node)
        ok = len(pages) >= max(self.icfg.prefix_cache_min_pages, 1)
        if ok and self.page_window is not None:
            ok = len(pages) >= self._first_live_page(len(context))
        if not ok:
            if node is not None:
                self._pcache.unlock(node)
            return 0, [], None
        return len(pages), pages, node

    def _set_sampling(self, req: Request) -> None:
        """The slot's sampling parameters: the request's, else the defaults."""
        icfg, slot = self.icfg, req.slot
        self.slot_temp[slot] = icfg.temperature if req.temperature is None else req.temperature
        self.slot_top_k[slot] = icfg.top_k if req.top_k is None else req.top_k
        self.slot_top_p[slot] = icfg.top_p if req.top_p is None else req.top_p

    def _admit(self) -> None:
        # Pass 1 (host): claim slots + pages, highest priority class first,
        # arrival order within a class (all-default priorities: arrival
        # order), head-of-line blocking on resources. ``reserved`` carries
        # the headroom earlier admissions of this burst claimed but have not
        # allocated yet, so the burst cannot over-commit the pool. No drain
        # gate: while draining, the queue holds only in-flight work, which
        # must re-admit to finish.
        psz = self.psz
        admitted: list[tuple[Request, int]] = []
        reserved = 0
        while self.waiting:
            idx = max(range(len(self.waiting)),
                      key=lambda i: (self.waiting[i].priority, -i))
            req = self.waiting[idx]
            slot = next((i for i, r in enumerate(self.slots) if r is None), None)
            if slot is None:
                break
            if req.host_pages:
                # A request preempted to the host resumes at its cursor; a
                # failed restore has re-queued it already and fails the step.
                del self.waiting[idx]
                delta = self._readmit_host(req, slot, reserved)
                if delta is None:
                    self.waiting.insert(idx, req)
                    break
                reserved += delta
                continue
            context = req.context
            n_match, m_pages, m_node = self._match_prefix(context)
            full = bool(n_match) and n_match * psz >= len(context)
            if full and (self.icfg.temperature if req.temperature is None
                         else req.temperature) != 0.0:
                # A sampled request would draw its first token from the
                # decode stream, not the prefill's: re-prefill one page
                # of tail instead (greedy argmax needs no stream).
                full = False
                n_match = (len(context) - 1) // psz
                if n_match < max(self.icfg.prefix_cache_min_pages, 1):
                    self._pcache.unlock(m_node)
                    n_match, m_pages, m_node = 0, [], None
                else:
                    m_pages = m_pages[:n_match]
            if n_match and self._lazy and self._admission_need_warm(
                    len(context), n_match, full)[3] > self.icfg.num_pages - 1:
                # An over-pool request's eager tail can never fit: drop the
                # match and take the lazy cold branch.
                self._pcache.unlock(m_node)
                n_match, m_pages, m_node = 0, [], None
                full = False
            if n_match:
                n_pages, first_live, n_alloc, need = self._admission_need_warm(
                    len(context), n_match, full)
                s_pad = self._bucket_len(len(context) - n_match * psz)
            else:
                # Pages wholly behind the window are dead on arrival: no
                # pool page, table entries on scratch page 0.
                n_pages, first_live, need = self._admission_need(len(context))
                n_alloc = n_pages - first_live
                s_pad = self._bucket_len(len(context))
                if self._lazy and need > self.icfg.num_pages - 1:
                    # Over-pool long context: admit on the O(window) lazy
                    # working set; chunks provision their own pages.
                    first_live = n_alloc = 0
                    need = self._long_admission_need()
            if self._available() - reserved < need:
                if m_node is not None:
                    self._pcache.unlock(m_node)
                break
            reserved += need - n_alloc
            del self.waiting[idx]
            req.slot = slot
            req.admit_seq = next(self._admit_seq)
            req.prefix_node = m_node
            stats = self.prefix_stats
            # Fresh pages allocate FIRST in every branch: _alloc_pages is
            # the only fallible op, so a MemoryError leaves nothing to
            # unwind beyond the claim.
            try:
                if full:
                    # Whole context cached: no prefill. Copy the last matched
                    # page (the first decode step rewrites its final slot, and
                    # shared pages are immutable) and restart decode at len-1.
                    cow = self._alloc_pages(1)[0]
                    copy_page(self.cache, m_pages[-1], cow, n_layers=self.mcfg.n_layers,
                              num_pages=self.icfg.num_pages)
                    for p in m_pages[:-1]:
                        self.alloc.retain(p)
                    req.pages = list(m_pages[:-1]) + [cow]
                    req.n_prefix = n_match - 1
                    req.freed_until = 0
                    stats.hits += 1
                    stats.cached_tokens += len(context) - 1
                    stats.cow_pages += 1
                elif n_match:
                    fresh = self._alloc_pages(n_alloc)
                    live = m_pages[first_live:]
                    for p in live:
                        self.alloc.retain(p)
                    req.pages = [None] * first_live + list(live) + fresh
                    req.n_prefix = n_match
                    req.freed_until = first_live
                    stats.hits += 1
                    stats.cached_tokens += n_match * psz
                else:
                    req.pages = [None] * first_live + self._alloc_pages(n_alloc)
                    req.n_prefix = 0
                    req.freed_until = first_live
                    if self._pcache is not None:
                        stats.misses += 1
            except MemoryError as e:
                # Pool exhaustion at admit: un-claim completely (admit_seq
                # -1: it never ran, so it stays sheddable) and retry at the
                # next step.
                self.robust.pool_faults += 1
                log.warning("admission of request %d hit pool exhaustion (%s); deferred",
                            req.rid, e)
                if m_node is not None:
                    self._pcache.unlock(m_node)
                req.prefix_node = None
                req.slot = None
                req.admit_seq = -1
                self.waiting.appendleft(req)
                break
            self.slots[slot] = req
            if self._tracer.enabled:
                self._tracer.instant(
                    "admit", rid=req.rid, slot=slot, step=self.step_no, priority=req.priority,
                    cached_tokens=len(context) - 1 if full else n_match * psz,
                    **self._trace_ctx(req))
            self._set_sampling(req)
            # The lazy branch admitted with no pages (they come per chunk).
            self.page_table[slot, :len(req.pages)] = [0 if p is None else p for p in req.pages]
            if full:
                self.seq_lens[slot] = len(context) - 1
                self.last_token[slot] = context[-1]
                if req.max_new_tokens <= 0:
                    req.done = True   # scoring request, nothing to compute
            else:
                self.seq_lens[slot] = len(context)
                admitted.append((req, s_pad))
        if admitted and self.chunked:
            # Chunked prefill: no prefill dispatch here; admitted prompts
            # set their chunk cursor (past any cached prefix) and ride the
            # next mixed steps.
            for req, _ in admitted:
                req.prefill_done = req.n_prefix * psz
                req.prefill_pending = True
                self.seq_lens[req.slot] = req.prefill_done
            return
        # Pass 2 (device): ONE prefill dispatch for the whole burst, padded
        # to its largest bucket; K3 skips the all-padding tiles of shorter
        # rows, so each row's attention pays about its own length.
        if admitted:
            self._prefill_bucket(
                [r for r, _ in admitted], max(s for _, s in admitted)
            )

    def _chunk_arrays(self, rows: list[tuple[Request, int, int, list[int]]],
                      s_pad: int):
        """Host arrays of one prefill dispatch. Each row is (request, start,
        n, pages): the request's context[start:start+n] resumes at the
        page-aligned ``start`` over its first start/psz pages and writes
        ``pages``. Rows pad to a power of two and the prefix walk to a
        power-of-two width (so a mixed step's graphs are few); pad rows
        have length 1 and write scratch page 0, as do positions past a
        row's own pages and pages rolled behind the window (never read).
        Keyed as the runner's chunk arguments."""
        psz = self.psz
        nb = _pow2(max(len(rows), 1))
        tokens = np.zeros((nb, s_pad), np.int64)
        lengths = np.ones(nb, np.int32)
        pages = np.zeros((nb, s_pad // psz), np.int64)
        max_pre = max((start // psz for _, start, _, _ in rows), default=0)
        p_pre = _pow2(max_pre) if max_pre else 0
        pre_lens = np.zeros(nb, np.int32)
        pre_pages = np.zeros((nb, p_pre), np.int64)
        for i, (req, start, n, pg) in enumerate(rows):
            npre = start // psz
            tokens[i, :n] = req.context[start:start + n]
            lengths[i] = n
            pre_lens[i] = start
            pre_pages[i, :npre] = [0 if p is None else p for p in req.pages[:npre]]
            pages[i, :len(pg)] = [0 if p is None else p for p in pg]
        return dict(p_tokens=tokens, p_lengths=lengths, p_pages=pages,
                    p_prefix_lens=pre_lens, p_prefix_pages=pre_pages)

    def _prefill_bucket(self, reqs: list[Request], s_pad: int) -> None:
        """Prefill admitted requests in one dispatch; prefix-matched rows
        carry only their uncached tail, resuming over their shared pages."""
        psz = self.psz
        rows = [(r, r.n_prefix * psz, len(r.context) - r.n_prefix * psz,
                 r.pages[r.n_prefix:]) for r in reqs]
        a = {k: torch.from_numpy(v).to(self.device)
             for k, v in self._chunk_arrays(rows, s_pad).items()}

        def run():
            # Eager on the card too: a prefill's launches (a few per layer)
            # are small beside its GEMMs over every prompt token, and each
            # bucket length would need a graph of its own.
            logits, _ = prefill_step(
                self.params, self.cache, a["p_tokens"], a["p_lengths"], a["p_pages"],
                a["p_prefix_lens"],
                a["p_prefix_pages"] if a["p_prefix_pages"].shape[1] else None,
                cfg=self.mcfg, paged_prefill=self.icfg.paged_prefill,
            )
            return self._sample(logits, reqs)   # the one host fetch

        try:
            with self._device_span("prefill", "_prefill_span", "prefill_s"):
                firsts = self._executor.run("prefill", run)
        except DispatchFault:
            # Unwind the burst's admissions: pages released with nothing
            # donated (n_cached=0: no KV is trusted) and the requests back
            # at the queue head in their order, for the next step.
            for r in reversed(reqs):
                self._teardown_slot(r, 0)
                r.freed_until = 0
                self.waiting.appendleft(r)
            raise
        t1 = time.perf_counter()
        self.timing["prefill_tokens"] += sum(n for _, _, n, _ in rows)
        for i, req in enumerate(reqs):
            self._first_token(req, int(firsts[i]), t1)

    def _first_token(self, req: Request, first: int, t: float) -> None:
        """Accept a prefill's sampled token (nothing for a scoring request
        or one quarantined while its mask was built)."""
        if req.done:
            return
        if req.max_new_tokens <= 0:
            req.done = True   # prefill-only (scoring) request
            return
        self.last_token[req.slot] = first
        req.generated.append(first)
        if req.t_first is None:
            req.t_first = t
        self._maybe_finish(req, first)

    def _sample_masks(self, reqs: list[Request], nb: int) -> Optional[np.ndarray]:
        """Legal-token masks [nb, V] of one single-token sampling dispatch:
        row i holds reqs[i]'s FSM legal set (all-True for unconstrained
        rows); None when no live request is constrained, so unconstrained
        dispatches run the unmasked code. A row that admits nothing (not
        reachable through the engine: dead and complete states finish at
        advance, dead start states are refused at submit) quarantines its
        request and stays permissive, so its neighbours sample as they
        would have."""
        if not any(r.constraint is not None and not r.done for r in reqs):
            return None
        rows = np.ones((nb, self.mcfg.vocab_size), bool)
        masked = 0
        for i, r in enumerate(reqs):
            if r.constraint is None or r.done:
                continue
            row = r.constraint.mask_row()
            if not row.any():
                self.constraint_stats.dead_ends += 1
                self._quarantine(r, "constraint_all_masked")
                continue
            rows[i] = row
            masked += 1
        if not masked:
            return None
        self.constraint_stats.masked_steps += 1
        self.constraint_stats.masked_rows += masked
        return rows

    def _sample(self, logits: torch.Tensor, reqs: list[Request]) -> np.ndarray:
        """The first tokens of a prefill's rows (with inference.constrained
        masked by their FSMs: one host-to-device copy of the masks); the
        host fetch of the dispatch that produced ``logits``."""
        icfg = self.icfg
        legal = self._device_mask(
            self._sample_masks(reqs, logits.shape[0]) if self.constrained else None)
        if not any(
            r.temperature is not None or r.top_k is not None or r.top_p is not None
            for r in reqs
        ):
            toks = sample(logits, self._gen, temperature=icfg.temperature,
                          top_k=icfg.top_k, top_p=icfg.top_p, legal_mask=legal)
            return toks.cpu().numpy()
        nb = logits.shape[0]
        temp = np.full(nb, icfg.temperature, np.float32)
        top_k = np.full(nb, icfg.top_k, np.int32)
        top_p = np.full(nb, icfg.top_p, np.float32)
        for i, req in enumerate(reqs):
            temp[i] = self.slot_temp[req.slot]
            top_k[i] = self.slot_top_k[req.slot]
            top_p[i] = self.slot_top_p[req.slot]
        dev = logits.device
        toks = sample(
            logits, self._gen,
            temperature=torch.from_numpy(temp).to(dev),
            top_k=torch.from_numpy(top_k).to(dev),
            top_p=torch.from_numpy(top_p).to(dev),
            legal_mask=legal,
        )
        return toks.cpu().numpy()

    def _sampling_args(self, reqs: list[Request]) -> tuple[dict, dict]:
        """Decode sampling parameters as (per-slot host arrays, static
        scalars): python scalars when every request takes the defaults
        (greedy stays a bare argmax), else the [B] per-slot arrays. The
        two are two variants of a dispatch program."""
        if all(r.temperature is None and r.top_k is None and r.top_p is None
               for r in reqs):
            return {}, dict(temperature=self.icfg.temperature, top_k=self.icfg.top_k,
                            top_p=self.icfg.top_p)
        return dict(temperature=self.slot_temp, top_k=self.slot_top_k,
                    top_p=self.slot_top_p), {}

    def _release_request(self, req: Request, n_cached: int) -> None:
        """Release a leaving request's pages. With the prefix cache, the
        full pages of its first ``n_cached`` tokens (whose KV is in the
        pool) are donated to the tree first — on reap AND preempt, so a
        preempted request re-matches its own pages. insert() retains what
        it keeps; the request then drops its own refs uniformly."""
        if self._pcache is not None and req.pages:
            # Only the contiguous resident run from page 0 can be cached.
            n_full = min(n_cached // self.psz, len(req.pages))
            k = 0
            while k < n_full and req.pages[k] is not None:
                k += 1
            if k:
                self.prefix_stats.inserted_pages += self._pcache.insert(
                    req.context[: k * self.psz], req.pages[:k]
                )
        if req.prefix_node is not None:
            self._pcache.unlock(req.prefix_node)
            req.prefix_node = None
        self.alloc.free([p for p in req.pages if p is not None])
        req.pages = []
        req.n_prefix = 0
        # Host-resident pages are stale once the device side is gone (the
        # preempt-to-host path never comes here).
        self._drop_host_pages(req)

    def _teardown_slot(self, req: Request, n_cached: int) -> None:
        """The one slot-teardown path (reap and preemption). A preempted
        request restarts its draft-length adaptation cold."""
        slot = req.slot
        self._release_request(req, n_cached)
        if self._spec is not None:
            self._spec.drop(req.rid)
        req.slot = None
        self.slots[slot] = None
        self.page_table[slot] = 0
        self.seq_lens[slot] = 0
        self.last_token[slot] = 0

    def _preempt(self, req: Request) -> None:
        """Evict an active request, returning its pages; it re-enters at the
        head of the queue and recomputes its context on re-admission (from
        whatever the prefix cache kept: the completed chunks of a mid-
        prefill request are donated, seq_lens being its chunk cursor). A
        long request past the break-even goes to the host instead and
        resumes at its cursor (``_preempt_to_host``)."""
        self.preemptions += 1
        cursor = int(self.seq_lens[req.slot])
        if self._preempt_to_host(req, cursor):
            return
        self._teardown_slot(req, cursor)
        req.freed_until = 0
        req.prefill_pending = False
        req.prefill_done = 0
        self.waiting.appendleft(req)

    def _grow_pages(self, window: Optional[int] = None) -> None:
        """Pre-provision every live slot with pages for the whole upcoming
        decode window (the device writes up to W positions ahead of the
        host's view; ``window`` is the verify width on a verify step).
        Provisioning rank: high priority classes first, oldest admission
        first within a class (all-default priorities: oldest first).
        Cached pages are reclaimed first; then the last-ranked request of
        equal or lower priority is preempted. A request whose only other
        tenants rank in a higher class preempts itself (it never grows at
        their expense), as the JAX engine does; alone, it raises
        MemoryError."""
        W = self.decode_window if window is None else window
        by_rank = sorted(
            (r for r in self.slots if r is not None and not r.done),
            key=lambda r: (-r.priority, r.admit_seq),
        )

        def n_need(req):
            last = min(int(self.seq_lens[req.slot]) + W - 1, self.icfg.max_seq_len - 1)
            return min(last // self.psz + 1, self.pages_per_seq)

        if self._pcache is not None:
            # The pass's whole shortfall reclaimed in one eviction sweep.
            short = sum(max(n_need(r) - len(r.pages), 0) for r in by_rank)
            short -= self.alloc.free_pages
            if short > 0:
                self.prefix_stats.evicted_pages += self._pcache.evict(short)
        for req in by_rank:
            if req.slot is None:
                continue  # preempted earlier in this pass
            while req.slot is not None and len(req.pages) < n_need(req):
                while self.alloc.free_pages < 1:
                    # Cached pages go before live requests (a preemption
                    # may donate pages, reclaimed on the next turn).
                    if self._pcache is not None and self._pcache.evict(1):
                        self.prefix_stats.evicted_pages += 1
                        continue
                    victims = [r for r in by_rank if r.slot is not None and r is not req
                               and r.priority <= req.priority]
                    if not victims:
                        if not any(r.slot is not None and r is not req for r in by_rank):
                            raise MemoryError(
                                "KV pool too small for a single request; "
                                "raise inference.num_pages"
                            )
                        self._preempt(req)
                        break
                    self._preempt(victims[-1])
                if req.slot is None:
                    break   # preempted itself above
                page = self._alloc_pages(1)[0]
                self.page_table[req.slot, len(req.pages)] = page
                req.pages.append(page)

    def _decode_all(self) -> bool:
        """A verify step when a live slot is constrained (its masks ride the
        verify rows, its forced runs as drafts; unconstrained co-tenants
        draft as usual) or some slot drafted (inference.speculative), else
        the plain decode window. First the window rolls and a long
        request's host-resident residue (a page-in that failed) pages in."""
        self._roll_window()
        live = [r for r in self.slots if r is not None and not r.done]
        if self._long:
            for r in live:
                if r.host_pages:
                    self._page_in_request(r)
        if self.constrained and any(r.constraint is not None for r in live):
            self._spec_step = True
            return self._verify_all(self._propose_constrained_drafts(live))
        if self._spec is not None and not self._spec_disabled:
            drafts = self._propose_drafts(live)
            if drafts is not None:
                self._spec_step = True
                return self._verify_all(drafts)
        return self._decode_window_all()

    def _propose_drafts(self, cands: list[Request]) -> Optional[dict[int, Any]]:
        """Drafts by slot for the candidates (a token list, or a DraftTree
        under spec_tree_width > 1), or None when nothing was drafted — the
        caller then runs the plain step. A draft is capped by the request's
        adaptive length, the context window (write positions stay below
        max_seq_len) and its remaining token budget. Draft-density gate:
        when fewer than ``spec_min_draft_slots`` slots drafted (clamped to
        the candidates, so a fully drafting batch always verifies), the
        step goes to the plain path and counts as gated."""
        if not cands:
            return None
        self._constraint_forced = {}   # no forced prefixes on this path
        extra = self._pcache.token_paths() if self._pcache is not None else ()
        drafts: dict[int, Any] = {}
        n_drafted = 0
        for r in cands:
            if r.host_pages:
                # Part of this slot's KV is host-resident (a page-in fault
                # left residue): a multi-token verify would read pages not
                # restored yet. A plain one-token row this step.
                drafts[r.slot] = None if self._tree else []
                continue
            pos = int(self.seq_lens[r.slot])
            limit = min(self.icfg.max_seq_len - 1 - pos,
                        r.max_new_tokens - len(r.generated) - 1)
            if limit <= 0:
                d = None if self._tree else []
            elif self._tree:
                d = self._spec.propose_tree(r.rid, r.context, limit, extra)
            else:
                d = self._spec.propose(r.rid, r.context, limit, extra)
            drafts[r.slot] = d
            n_drafted += bool(d)
        if not n_drafted:
            return None
        if n_drafted < min(self.icfg.spec_min_draft_slots, len(cands)):
            self.spec_stats.gated_steps += 1
            return None
        return drafts

    def _propose_constrained_drafts(self, cands: list[Request]) -> dict[int, Any]:
        """Drafts by slot for a decode batch holding constrained slots;
        never None: a constrained slot with no draft still verifies at
        lens 1 (a masked single-token decode).

        A constrained slot drafts its FSM forced run: a state with one
        legal token emits it, and its masked target probability is exactly
        1.0, so it is accepted under the unchanged acceptance rule. With
        inference.speculative the run extends with the n-gram continuation
        cut to its FSM-legal prefix; with a tree, an ambiguous state after
        the run is a branch point, up to spec_tree_width legal tokens, each
        with its own forced tail, merged by ``spec_decode.build_tree``.
        Unconstrained co-tenants draft as ``_propose_drafts`` would, or not
        at all without speculation (their lens-1 rows ride the same
        dispatch)."""
        spec_on = self._spec is not None and not self._spec_disabled
        extra = self._pcache.token_paths() if spec_on and self._pcache is not None else ()
        tree = self._tree
        drafts: dict[int, Any] = {}
        cs = self.constraint_stats
        self._constraint_forced = {}
        for r in cands:
            pos = int(self.seq_lens[r.slot])
            limit = min(self.icfg.max_seq_len - 1 - pos,
                        r.max_new_tokens - len(r.generated) - 1,
                        self.icfg.speculate_tokens)
            c = r.constraint
            if c is None:
                if spec_on and limit > 0:
                    propose = self._spec.propose_tree if tree else self._spec.propose
                    drafts[r.slot] = propose(r.rid, r.context, limit, extra)
                else:
                    drafts[r.slot] = None if tree else []
                continue
            if limit <= 0:
                drafts[r.slot] = None if tree else []
                continue
            forced = c.forced_run(limit)
            cs.forced_drafted += len(forced)
            self._constraint_forced[r.slot] = len(forced)
            end = c.walk(forced)
            if tree:
                chains = [forced] if forced else []
                if end >= 0 and len(forced) < limit and c.mask_choices(end) > 1:
                    # An FSM branch point: the grammar names the children.
                    branches = c.branch_tokens(self.icfg.spec_tree_width, end)
                    if len(branches) > 1:
                        cs.branch_points += 1
                    bc = []
                    for b in branches:
                        nxt = c.peek(int(b), end)
                        tail = c.forced_run(limit - len(forced) - 1, nxt) if nxt >= 0 else []
                        bc.append(forced + [int(b)] + tail)
                    chains = bc or chains
                t = build_tree(chains, limit) if chains else None
                drafts[r.slot] = t if t is not None and len(t) else None
            else:
                d = list(forced)
                if spec_on and end >= 0 and len(d) < limit:
                    cont = self._spec.propose(r.rid, r.context + d, limit - len(d), extra) or []
                    for tok in cont:
                        nxt = c.peek(int(tok), end)
                        if nxt < 0:
                            break   # only the FSM-legal prefix
                        d.append(int(tok))
                        end = nxt
                drafts[r.slot] = d
        return drafts

    def _verify_masks(self, active: list[Request], tokens: np.ndarray, lens: np.ndarray,
                      parents: Optional[np.ndarray] = None) -> Optional[np.ndarray]:
        """Legal-token masks [B, W, V] of one verify dispatch: column j of
        a constrained slot holds the FSM mask after its draft path (chain
        prefix, or tree ancestors; column 0 the current state). Padding
        columns, unconstrained slots and columns past an FSM-illegal draft
        (always rejected: the masked parent gives it probability 0) stay
        all-True. None when no active slot is constrained, so the dispatch
        runs the unmasked code."""
        if not any(r.constraint is not None for r in active):
            return None
        B, W = tokens.shape
        m = np.ones((B, W, self.mcfg.vocab_size), bool)
        masked = 0
        for r in active:
            c = r.constraint
            if c is None:
                continue
            s = r.slot
            states = np.full(W, -1, np.int64)
            states[0] = c.state
            m[s, 0] = c.mask_row()
            for j in range(1, int(lens[s])):
                p = int(parents[s, j]) if parents is not None else j - 1
                ps = int(states[p])
                nxt = c.peek(int(tokens[s, j]), ps) if ps >= 0 else -1
                states[j] = nxt
                if nxt >= 0:
                    m[s, j] = c.mask_row(nxt)
            masked += 1
        self.constraint_stats.masked_steps += 1
        self.constraint_stats.masked_rows += masked
        return m

    def _build_verify_rows(self, reqs: list[Request], drafts: dict[int, Any]):
        """The [B, speculate_tokens + 1] verify rows: column 0 the pending
        last token, then the drafts; ``lens`` the real width (rows without
        a request stay zeros of length 1, on scratch page 0)."""
        W = self.icfg.speculate_tokens + 1
        tokens = np.zeros((self.max_batch, W), np.int32)
        lens = np.ones(self.max_batch, np.int32)
        for r in reqs:
            d = drafts.get(r.slot) or []
            tokens[r.slot, 0] = self.last_token[r.slot]
            tokens[r.slot, 1:1 + len(d)] = d
            lens[r.slot] = 1 + len(d)
        return tokens, lens

    def _build_verify_tree_rows(self, reqs: list[Request], drafts: dict[int, Any]):
        """Tree verify rows: the chain layout plus per-column depths, parent
        columns and packed ancestor words of each row's DraftTree. Columns
        without a node carry chain-shaped defaults (depth j, parent j - 1,
        causal words), so a chain-shaped tree feeds K10 a chain's arrays."""
        W = self.icfg.speculate_tokens + 1
        B = self.max_batch
        steps = np.arange(W, dtype=np.int64)
        tokens = np.zeros((B, W), np.int32)
        lens = np.ones(B, np.int32)
        depths = np.tile(steps.astype(np.int32), (B, 1))
        parents = np.tile(np.maximum(steps - 1, 0).astype(np.int32), (B, 1))
        words = np.tile(((np.int64(1) << (steps + 1)) - 1).astype(np.int32), (B, 1))
        for r in reqs:
            s, t = r.slot, drafts.get(r.slot)
            tokens[s, 0] = self.last_token[s]
            if t:
                n = len(t)
                tokens[s, 1:1 + n] = t.tokens
                lens[s] = 1 + n
                depths[s, :1 + n] = t.depths()
                parents[s, 1:1 + n] = t.parents
                words[s, :1 + n] = np.asarray(t.mask_words(), np.int64).astype(np.int32)
        return tokens, lens, depths, parents, words

    def _verify_rows(self, reqs: list[Request], drafts: dict[int, Any]):
        """(tokens, lens, the runner's tree arrays, host legal masks or
        None) of a verify dispatch."""
        if not self._tree:
            tokens, lens = self._build_verify_rows(reqs, drafts)
            return tokens, lens, {}, self._verify_masks(reqs, tokens, lens)
        tokens, lens, depths, parents, words = self._build_verify_tree_rows(reqs, drafts)
        tree = dict(depths=depths, parents=parents, tree_mask=words)
        return tokens, lens, tree, self._verify_masks(reqs, tokens, lens, parents)

    def _device_mask(self, vmask: Optional[np.ndarray]) -> Optional[torch.Tensor]:
        """A step's host legal masks on the device, in one copy."""
        return None if vmask is None else torch.from_numpy(vmask).to(self.device)

    @staticmethod
    def _pack_verdicts(acc: torch.Tensor, alt: torch.Tensor, ok: Optional[torch.Tensor]):
        """A verify program's verdicts as one int32 tensor [2 or 3, B, W]
        (accept, alt, and the guard's ok broadcast over W), for the step's
        one host fetch."""
        rows = [acc.to(torch.int32), alt.to(torch.int32)]
        if ok is not None:
            rows.append(ok[:, None].expand_as(acc).to(torch.int32))
        return torch.stack(rows)

    def _fetch_verdicts(self, packed: torch.Tensor):
        """The verify step's one host fetch: (accept bool [B, W], alt, and
        the guard's ok [B] bool or None)."""
        both = packed.cpu().numpy()
        return both[0].astype(bool), both[1], both[2, :, 0].astype(bool) if self._guard else None

    def _live_mask(self, reqs: list[Request]) -> np.ndarray:
        """[B] bool: the slots of ``reqs``."""
        mask = np.zeros(self.max_batch, bool)
        for r in reqs:
            mask[r.slot] = True
        return mask

    def _program_kw(self) -> dict:
        """What every decode-facing runner call takes besides its inputs:
        the bound params and pool, the generator, the model and the
        context limit."""
        return dict(params=self.params, cache=self.cache, generator=self._gen,
                    cfg=self.mcfg, max_seq_len=self.icfg.max_seq_len)

    def _decode_program(self, **kw) -> torch.Tensor:
        """The decode window as a dispatch program: the [W, B] token block,
        the guard's flags as one more row."""
        out = decode_window(**self._program_kw(), **kw)
        if not self._guard:
            return out[0]
        return torch.cat([out[0], out[1][None].to(out[0].dtype)])

    def _verify_program(self, **kw) -> torch.Tensor:
        out = verify_step(**self._program_kw(), **kw)
        return self._pack_verdicts(out[0], out[1], out[2] if self._guard else None)

    def _mixed_program(self, *, draw: bool, **kw):
        """The mixed step as a dispatch program: (the decode tokens [B],
        the guard's flags stacked under them, or None without a live
        decode row; the chunk rows' logits). Without a live decode row
        (``draw`` False) the engine's stream is not drawn from."""
        pk = self._program_kw()
        if not draw:
            pk["generator"] = None
        out = mixed_step(**pk, paged_prefill=self.icfg.paged_prefill, **kw)
        toks, p_logits = out[0], out[-2]
        if toks is None or not self._guard:
            return toks, p_logits
        return torch.stack([toks, out[1].to(toks.dtype)]), p_logits

    def _mixed_verify_program(self, **kw):
        out = mixed_verify_step(**self._program_kw(), paged_prefill=self.icfg.paged_prefill,
                                **kw)
        return self._pack_verdicts(out[0], out[1], out[2] if self._guard else None), out[-2]

    def _verify_all(self, drafts: dict[int, Any]) -> bool:
        """One verify dispatch for every live slot (runner.verify_step):
        its pending token and drafts scored in one pass over the weights;
        emit the accepted prefix and one bonus/correction token per slot,
        then release the pages of the rejected tail."""
        self._grow_pages(self.icfg.speculate_tokens + 1)
        # After provisioning: pool pressure may have preempted a drafter.
        active = [r for r in self.slots if r is not None and not r.done]
        if not active:
            self._reap()
            return False
        if (not any(drafts.get(r.slot) for r in active)
                and not any(r.constraint is not None for r in active)):
            # Every drafter was preempted by provisioning. Constrained slots
            # verify draftless all the same: their masks need the verify rows.
            self._spec_step = False
            return self._decode_window_all()
        tokens, lens, tree, vmask = self._verify_rows(active, drafts)
        samp, samp_static = self._sampling_args(active)
        inputs = dict(tokens=tokens, seq_lens=self.seq_lens, lens=lens,
                      page_table=self.page_table, legal_mask=vmask, **tree, **samp)
        if self._guard:
            inputs["active"] = self._live_mask(active)

        def run():
            return self._fetch_verdicts(self._executor.launch(
                "verify", self._verify_program, inputs,
                dict(nan_guard=self._guard, **samp_static)))

        with self._device_span("verify", "_dev_span", "decode_s", "verify_s"):
            acc, alt, ok = self._executor.run("verify", run)
        tm = self.timing
        tm["verify_steps"] += 1
        tm["decode_slot_steps"] += len(active)
        active = self._quarantine_failed(active, ok)
        self._accept_verified(active, tokens, lens, drafts, acc, alt)
        self._reap()
        return True

    def _accept_verified(self, active, tokens, lens, drafts, acc, alt) -> None:
        if self._tree:
            self._accept_and_rollback_tree(active, tokens, lens, drafts, acc, alt)
        else:
            self._accept_and_rollback(active, tokens, lens, acc, alt)

    def _emit(self, req: Request, emit: list[int]) -> int:
        """Accept ``emit``'s tokens in order until the request finishes;
        returns how many were accepted."""
        n = 0
        for tok in emit:
            if req.done:
                break
            self._accept(req, tok)
            n += 1
        return n

    def _accept_and_rollback(self, active, tokens, lens, acc, alt) -> None:
        """Walk each slot's verdicts: emit the accepted draft prefix and
        ``alt`` at the first rejection (the correction) or at the row's end
        (the bonus), then release the pages past the new cursor
        (kv_cache.rollback_pages), leaving the footprint a window=1 step
        would. Rejected KV past the cursor is dead, masked by seq_lens."""
        st = self.spec_stats
        st.verify_steps += 1
        st.verify_slot_steps += len(active)
        for r in active:
            s = r.slot
            k = int(lens[s]) - 1
            a = 0
            while a < k and acc[s, a]:
                a += 1
            n_emit = self._emit(r, [int(t) for t in tokens[s, 1:1 + a]] + [int(alt[s, a])])
            kept = min(n_emit, a)       # draft tokens that reached the stream
            st.drafted += k
            st.accepted += kept
            st.rolled_back += k - kept
            st.emitted += n_emit
            self._count_forced(s, kept)
            if self._spec is not None:   # a constrained-only engine has none
                self._spec.state(r.rid).update(k, kept, self.icfg.speculate_tokens)
            if not r.done:
                # A finished slot is reaped whole, donating only the full
                # pages below its (rewound) cursor.
                self._rollback_slot(r)

    def _count_forced(self, slot: int, kept: int) -> None:
        """Tally the accepted drafts of a slot's forced run."""
        fr = self._constraint_forced.get(slot, 0)
        if fr:
            self.constraint_stats.forced_accepted += min(kept, fr)

    def _rollback_slot(self, req: Request) -> None:
        """Release the pages a verify step provisioned past the accepted
        cursor."""
        n_keep = (int(self.seq_lens[req.slot]) - 1) // self.psz + 1
        if len(req.pages) > n_keep:
            rollback_pages(self.alloc, req.pages, n_keep)
            self.page_table[req.slot, n_keep:] = 0

    def _plan_emission(self, req: Request, emit: list[int]) -> int:
        """How many of ``emit``'s tokens the request will accept (the stop
        conditions of ``_maybe_finish``, without side effects), so tree
        acceptance can size the KV compaction before any state changes."""
        n = 0
        gen = len(req.generated)
        pos = int(self.seq_lens[req.slot])
        for tok in emit:
            n += 1
            gen += 1
            pos += 1
            if ((self.eos_id is not None and tok == self.eos_id)
                    or pos >= self.icfg.max_seq_len or gen >= req.max_new_tokens):
                break
        return n

    def _accept_and_rollback_tree(self, active, tokens, lens, drafts, acc, alt) -> None:
        """Tree acceptance: walk each slot's DraftTree from the root into
        the first accepted child in sibling order, and emit the verified
        path plus the last node's ``alt``. A path off the primary chain
        lies at non-contiguous verify columns: one compaction over all
        slots (kv_cache.compact_draft_kv) moves its KV to cursor-contiguous
        positions before anything is emitted; a failure is a dispatch fault
        of path "compact" (counted toward the speculation-fault limit) and
        fails the step with nothing emitted. Then the emission and rollback
        of the chain walk."""
        st = self.spec_stats
        st.verify_steps += 1
        st.verify_slot_steps += len(active)
        W = self.icfg.speculate_tokens + 1
        src = np.tile(np.arange(W, dtype=np.int32), (self.max_batch, 1))
        plans = []
        moves = 0
        for r in active:
            s = r.slot
            t = drafts.get(s) or None
            path: list[int] = []
            cur = 0
            if t is not None:
                children = t.children()
                while True:
                    nxt = next((c for c in children[cur] if acc[s, c]), None)
                    if nxt is None:
                        break
                    path.append(nxt)
                    cur = nxt
            emit = [int(tokens[s, c]) for c in path] + [int(alt[s, cur])]
            plans.append((r, t, path, emit))
            kept = min(self._plan_emission(r, emit), len(path))
            off = [i for i in range(kept) if path[i] != i + 1]
            if off:
                src[s, 1:1 + kept] = path[:kept]
                moves += len(off)
        if moves:
            dev = self.device
            with self._device_span("compact"), self._tracer.annotation("orion/compact"):
                self._executor.contain(
                    "compact", compact_draft_kv,
                    self.cache, torch.from_numpy(self.page_table).to(dev),
                    torch.from_numpy(self.seq_lens).to(dev), torch.from_numpy(src).to(dev),
                    n_layers=self.mcfg.n_layers, num_pages=self.icfg.num_pages,
                )
            st.compactions += 1
            st.compacted_tokens += moves
        for r, t, path, emit in plans:
            s = r.slot
            n_emit = self._emit(r, emit)
            kept = min(n_emit, len(path))
            k = int(lens[s]) - 1
            depth = t.max_depth if t is not None else 0
            st.drafted += k
            st.accepted += kept
            st.rolled_back += k - kept
            st.emitted += n_emit
            st.tree_nodes += k
            st.tree_branch_nodes += max(k - depth, 0)
            self._count_forced(s, kept)
            # The adaptive controller steers the depth (the chain-equivalent
            # draft length): drafted = the tree's depth, accepted = the path.
            if self._spec is not None:
                self._spec.state(r.rid).update(depth, kept, self.icfg.speculate_tokens)
            if not r.done:
                self._rollback_slot(r)

    def _decode_window_all(self) -> bool:
        """The fused decode window over all live slots."""
        self._grow_pages()
        active = [r for r in self.slots if r is not None and not r.done]
        if not active:
            self._reap()
            return False
        W = self.decode_window
        samp, samp_static = self._sampling_args(active)
        inputs = dict(tokens=self.last_token, seq_lens=self.seq_lens,
                      page_table=self.page_table, active=self._live_mask(active), **samp)

        def run():
            # [W, B], the guard's flags as a last row: the window's one fetch.
            rows = self._executor.launch(
                "decode", self._decode_program, inputs,
                dict(n_steps=W, nan_guard=self._guard, **samp_static)).cpu().numpy()
            if not self._guard:
                return rows, None
            return rows[:-1], rows[-1].astype(bool)

        with self._device_span("decode", "_dev_span", "decode_s"):
            tokens, ok = self._executor.run("decode", run)
        self.timing["decode_slot_steps"] += W * len(active)
        # A poisoned slot's whole window is suspect: quarantined, its
        # tokens dropped (no other slot reads its pages).
        active = self._quarantine_failed(active, ok)
        for j in range(W):
            for req in active:
                if req.done:
                    continue   # finished mid-window: the overshoot is discarded
                self._accept(req, int(tokens[j, req.slot]))
        self._reap()
        return True

    def _mixed_decode(self) -> bool:
        """One mixed step (inference.chunked_prefill, runner.mixed_step):
        one decode token for every live slot plus up to
        prefill_chunk_tokens of prompt chunks, in ONE dispatch — a decode
        waits at most one chunk budget behind a prompt burst. With
        speculation, decode-phase slots draft and the decode rows become
        verify rows (runner.mixed_verify_step); prompt-phase slots never
        draft. Returns True iff a decode slot advanced.

        Long context: host-resident pages a chunk or decode row reads page
        in first (after drafting, which held such slots to one token), the
        lazy path provisions each chunk's pages (a chunk the pool cannot
        hold parks its request), and after the step a long request past
        inference.request_resident_pages demotes its oldest pages."""
        self._roll_window()
        drafts = None
        dec_cands = [r for r in self.slots
                     if r is not None and not r.done and not r.prefill_pending]
        if self.constrained and any(r.constraint is not None for r in dec_cands):
            # Constrained decode slots take the mixed verify rows, as in
            # _decode_all.
            drafts = self._propose_constrained_drafts(dec_cands)
        elif self._spec is not None and not self._spec_disabled:
            drafts = self._propose_drafts(dec_cands)
        if self._long:
            for r in dec_cands:
                if r.host_pages:
                    self._page_in_request(r)
        self._grow_pages(self.icfg.speculate_tokens + 1 if drafts is not None else None)
        psz, S = self.psz, self.icfg.prefill_chunk_tokens
        # Pending prompts in admission order, each contributing its next
        # chunk until the budget is spent. Mid-prompt chunks end page-
        # aligned so the next one resumes page-aligned; the final chunk of
        # a prompt may end mid-page.
        pending = sorted(
            (r for r in self.slots if r is not None and not r.done and r.prefill_pending),
            key=lambda r: r.admit_seq,
        )
        budget = S
        chunks: list[tuple[Request, int]] = []
        for r in pending:
            if budget < 1:
                break
            rem = len(r.context) - r.prefill_done
            k = min(rem, budget)
            if k < rem:
                k = k // psz * psz
                if k == 0:
                    break
            budget -= k
            chunks.append((r, k))
        if self._long:
            for r, k in chunks:
                if r.host_pages:
                    self._page_in_request(r)
                try:
                    self._provision_chunk_pages(r, k)
                except MemoryError:
                    # Chunk provisioning has no preemption valve of its own:
                    # park this request (to the host past the break-even)
                    # and let its co-tenants drain the pressure.
                    self.robust.pool_faults += 1
                    self._preempt(r)
            chunks = [(r, k) for r, k in chunks if r.slot is not None]
        arrays = self._chunk_arrays(
            [(r, r.prefill_done, k,
              r.pages[r.prefill_done // psz:(r.prefill_done - (-k // psz * psz)) // psz])
             for r, k in chunks], S)
        # Mid-prefill slots' decode rows park on scratch page 0, so the
        # decode write (which K4 makes for every slot) cannot clobber a
        # page their chunks fill in this very step.
        d_pt = self.page_table.copy()
        for r in pending:
            if r.slot is not None:   # provisioning may have preempted it
                d_pt[r.slot] = 0
        dec = [r for r in self.slots
               if r is not None and not r.done and not r.prefill_pending]
        if (drafts is not None and not any(drafts.get(r.slot) for r in dec)
                and not any(r.constraint is not None for r in dec)):
            drafts = None   # provisioning preempted every drafter
        tm = self.timing
        samp, samp_static = self._sampling_args(dec)
        inputs = dict(seq_lens=self.seq_lens, page_table=d_pt, **arrays, **samp)
        static = dict(nan_guard=self._guard, **samp_static)
        if self._guard:
            inputs["active"] = self._live_mask(dec)
        if drafts is not None:
            vtok, vlens, tree, vmask = self._verify_rows(dec, drafts)
            inputs.update(tokens=vtok, lens=vlens, legal_mask=vmask, **tree)
        else:
            inputs["tokens"] = self.last_token
            # No live decode row: draw nothing from the engine's stream, so
            # a sampled lone request is the same chunked and unchunked.
            static["draw"] = bool(dec)
        with self._device_span("mixed" if drafts is None else "mixed_verify",
                               "_mixed_span", "mixed_s"):
            if drafts is not None:
                def run():
                    packed, p_logits = self._executor.launch(
                        "mixed_verify", self._mixed_verify_program, inputs, static)
                    return (*self._fetch_verdicts(packed), p_logits)   # the one fetch

                acc, alt, ok, p_logits = self._executor.run("mixed_verify", run)
                tm["verify_steps"] += 1
                tm["mixed_verify_steps"] += 1
            else:
                def run():
                    toks, p_logits = self._executor.launch("mixed", self._mixed_program,
                                                           inputs, static)
                    if toks is None:
                        return None, None, p_logits
                    rows = toks.cpu().numpy()   # the one fetch
                    if not self._guard:
                        return rows, None, p_logits
                    return rows[0], rows[1].astype(bool), p_logits

                d_out, ok, p_logits = self._executor.run("mixed", run)
            real = sum(k for _, k in chunks)
            tm["mixed_steps"] += 1
            tm["prefill_chunks"] += len(chunks)
            tm["chunk_tokens"] += real
            tm["chunk_pad_tokens"] += arrays["p_tokens"].shape[0] * S - real
            tm["prefill_tokens"] += real
            tm["decode_slot_steps"] += len(dec)
            # Advance the chunk cursors (seq_lens tracks them, so a preemption
            # donates exactly the completed pages); prompts that just
            # completed sample their first token — their logits are fetched
            # only now (before the next replay overwrites them), so other
            # steps never pay that transfer.
            finishing = []
            for i, (r, k) in enumerate(chunks):
                r.prefill_done += k
                self.seq_lens[r.slot] = r.prefill_done
                if r.prefill_done >= len(r.context):
                    finishing.append((i, r))
            if finishing:
                rows = torch.tensor([i for i, _ in finishing], device=self.device)
                firsts = self._sample(p_logits[rows], [r for _, r in finishing])
                t1 = time.perf_counter()
                for (_, r), first in zip(finishing, firsts):
                    r.prefill_pending = False
                    self._first_token(r, int(first), t1)
        if self._long and self.icfg.request_resident_pages:
            # Roll first (never demote a page the window already passed),
            # then demote the still-prefilling chunk rows past the cap; a
            # failed demotion leaves pages resident, never fails the step.
            self._roll_window()
            for r, _ in chunks:
                if r.prefill_pending and not r.done:
                    self._page_out(r)

        # The guard covers decode rows only; a prompt-phase slot is caught
        # at its first guarded decode step.
        dec = self._quarantine_failed(dec, ok)
        if drafts is not None:
            self._accept_verified(dec, vtok, vlens, drafts, acc, alt)
        else:
            for r in dec:
                self._accept(r, int(d_out[r.slot]))
        self._reap()
        return bool(dec)

    def _accept(self, req: Request, tok: int) -> None:
        """A decoded token: its predecessor's KV is now in the pool."""
        self.seq_lens[req.slot] += 1
        self.last_token[req.slot] = tok
        req.generated.append(tok)
        if req.t_first is None:   # a whole-context cache hit decodes its first token
            req.t_first = time.perf_counter()
        self._maybe_finish(req, tok)

    def _maybe_finish(self, req: Request, tok: int) -> None:
        """Every emission ends here, so this is where a constrained
        request's FSM consumes the token: an illegal token (only if
        something bypassed the mask) or a dead end quarantines it, an
        accepting state with no continuation completes it."""
        if req.constraint is not None and not req.done:
            c = req.constraint
            t0 = time.perf_counter()
            # Re-sync first if the advance count disagrees with generated.
            ok = c.sync(req.generated[:-1]) and c.advance(int(tok))
            self.constraint_stats.advance_s += time.perf_counter() - t0
            if not ok:
                self.constraint_stats.dead_ends += 1
                self._quarantine(req, "constraint_illegal_token")
                return
            if c.is_dead():
                self.constraint_stats.dead_ends += 1
                self._quarantine(req, "constraint_dead_end")
                return
            if c.is_complete():
                # Stop now rather than spend a step sampling the forced eos.
                self.constraint_stats.completed += 1
                req.done = True
                return
            if self.eos_id is not None and tok == self.eos_id:
                # eos passes the mask only in accepting states.
                self.constraint_stats.completed += 1
        hit_eos = self.eos_id is not None and tok == self.eos_id
        # seq_lens counts tokens whose KV is cached; the just-sampled token's
        # write position (== seq_lens) must stay inside the context window.
        ctx_full = int(self.seq_lens[req.slot]) >= self.icfg.max_seq_len
        if hit_eos or ctx_full or len(req.generated) >= req.max_new_tokens:
            req.done = True

    def _reap(self) -> None:
        for i, req in enumerate(self.slots):
            if req is not None and req.done:
                if not req.outcome:
                    req.outcome = "completed"
                # seq_lens counts tokens whose KV is in the pool (window
                # overshoot lands beyond it): the full pages below it are
                # what the prefix cache keeps.
                self._teardown_slot(req, int(self.seq_lens[i]))
                self._just_finished.append(req)
