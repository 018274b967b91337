"""Continuous-batching inference engine over the paged KV pool (core).

Counterpart of ``orion_tpu/infer/engine.py``'s core scheduler: requests
queue in ``submit``; each ``step`` reaps finished slots, admits waiting
requests into free slots while the page pool can hold them, prefills the
admitted burst in one dispatch, and runs one fused decode window (W token
steps, one host fetch of the [W, B] token block) over every live slot.
Admission is in arrival order. Page pressure preempts the youngest
request, which re-enters the queue head and recomputes its context on
re-admission.

Not ported yet (each raises at construction when configured): prefix
cache, chunked/mixed prefill, speculative decoding, constrained decoding,
int8 KV and weights, the host tier and long-context paging, decode-window
autotune, NaN guard, sliding-window page rolling (a window on every
layer; interleaved local/global windows are served). Also absent:
request priorities, the deadline/shedding policy, fault injection,
watchdog and tracer, and the XLA-fallback degradation ladder (a failing
kernel raises).

The engine runs on ``cuda`` unless the caller passes ``device="cpu"``;
with no device given and no GPU present it raises. ``model.kernels`` is
not read: on the card every op on the path runs its hand-written kernel,
on the CPU its plain PyTorch version.
"""

from __future__ import annotations

import itertools
import time
from collections import deque
from typing import Any, Optional, Sequence

import numpy as np
import torch

from orion_tpu_torch.config import Config
from orion_tpu_torch.infer.kv_cache import PageAllocator, init_cache, pages_per_seq
from orion_tpu_torch.infer.runner import decode_window, prefill_step
from orion_tpu_torch.infer.sampling import sample
from orion_tpu_torch.infer.scheduler import Request
from orion_tpu_torch.models.convert import to_device
from orion_tpu_torch.ops.common import round_up


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
        "inference.kv_quant": i.kv_quant is not None,
        "inference.prefix_cache": i.prefix_cache,
        "inference.chunked_prefill": i.chunked_prefill,
        "inference.speculative": i.speculative,
        "inference.constrained": i.constrained,
        "inference.host_tier_bytes > 0": i.host_tier_bytes > 0,
        "inference.long_context": i.long_context,
        "inference.decode_window_autotune": i.decode_window_autotune,
        "inference.nan_guard": i.nan_guard,
        "a sliding window on every layer (page rolling)": (
            m.sliding_window is not None and m.sliding_window_pattern is None
        ),
    }
    bad = [name for name, on in unsupported.items() if on]
    if bad:
        raise NotImplementedError(
            f"not ported to orion_tpu_torch yet: {', '.join(bad)}"
        )


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
    ):
        _check_supported(cfg)
        self.device = resolve_device(device)
        self.cfg = cfg
        self.mcfg = cfg.model
        self.icfg = cfg.inference
        self.params = to_device(params, self.device)
        self.eos_id = eos_id
        self.psz = self.icfg.page_size
        self.pages_per_seq = pages_per_seq(self.icfg)
        self.max_batch = self.icfg.max_batch_size
        if self.icfg.prefill_chunk % self.psz:
            raise ValueError(
                f"prefill_chunk={self.icfg.prefill_chunk} must be a "
                f"multiple of page_size={self.psz}"
            )
        self.cache = init_cache(self.mcfg, self.icfg, self.device)
        self.alloc = PageAllocator(self.icfg.num_pages)
        self.page_table = np.zeros((self.max_batch, self.pages_per_seq), np.int32)
        self.seq_lens = np.zeros(self.max_batch, np.int32)
        self.last_token = np.zeros(self.max_batch, np.int32)
        self.slots: list[Optional[Request]] = [None] * self.max_batch
        self.waiting: deque[Request] = deque()
        self._just_finished: list[Request] = []
        self._rid = itertools.count()
        self._admit_seq = itertools.count()
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed)
        self.preemptions = 0
        self.decode_window = self.icfg.decode_window
        self.slot_temp = np.full(self.max_batch, self.icfg.temperature, np.float32)
        self.slot_top_k = np.full(self.max_batch, self.icfg.top_k, np.int32)
        self.slot_top_p = np.full(self.max_batch, self.icfg.top_p, np.float32)
        # Host-clock spans (each ends in the dispatch's token fetch, which
        # waits for the device): prefill and decode time, prefill tokens.
        self.timing = {"prefill_s": 0.0, "decode_s": 0.0, "prefill_tokens": 0,
                       "decode_slot_steps": 0, "steps": 0, "windows": 0}

    # -- public API --------------------------------------------------------

    def submit(
        self,
        prompt: Sequence[int],
        max_new_tokens: Optional[int] = None,
        *,
        temperature: Optional[float] = None,
        top_k: Optional[int] = None,
        top_p: Optional[float] = None,
    ) -> int:
        """Queue a request; returns its id."""
        return self.submit_request(
            prompt, max_new_tokens, temperature=temperature, top_k=top_k,
            top_p=top_p,
        ).rid

    def submit_request(
        self,
        prompt: Sequence[int],
        max_new_tokens: Optional[int] = None,
        *,
        temperature: Optional[float] = None,
        top_k: Optional[int] = None,
        top_p: Optional[float] = None,
    ) -> Request:
        """submit() returning the live Request (``.generated`` grows as
        tokens are accepted; ``.outcome`` is set at the end)."""
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
        if needed > usable:
            raise ValueError(
                f"request needs up to {needed} KV pages but the pool only "
                f"has {usable}; raise inference.num_pages or lower "
                f"max_new_tokens"
            )
        req = Request(
            rid=next(self._rid), prompt=list(map(int, prompt)),
            max_new_tokens=max_new, temperature=temperature, top_k=top_k,
            top_p=top_p, t_submit=time.perf_counter(),
        )
        self.waiting.append(req)
        return req

    def step(self) -> list[Request]:
        """Admit + prefill new requests, then run one decode window over
        every live slot; returns the requests that finished."""
        self._reap()
        self._admit()
        if self._decode_window_all():
            self.timing["windows"] += 1
        self.timing["steps"] += 1
        done, self._just_finished = self._just_finished, []
        return done

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

    # -- scheduler internals ----------------------------------------------

    def _bucket_len(self, n: int) -> int:
        return min(round_up(n, self.icfg.prefill_chunk), self.icfg.max_seq_len)

    def _admission_need(self, context_len: int) -> tuple[int, int]:
        """(n_pages, need): the prefill's pages and the pool demand of
        admitting a request whose context is ``context_len`` tokens — the
        prefill's pages or the first decode window's, plus one spare."""
        n_pages = self._bucket_len(context_len) // self.psz
        last = min(context_len + self.decode_window - 1, self.icfg.max_seq_len - 1)
        first_window = min(last // self.psz + 1, self.pages_per_seq)
        return n_pages, max(n_pages + 1, first_window + 1)

    def _worst_admission_need(self, min_ctx: int, max_ctx: int) -> int:
        """Max admission need over every context in [min_ctx, max_ctx]."""
        ctxs = np.arange(min_ctx, max_ctx + 1, dtype=np.int64)
        msl = self.icfg.max_seq_len
        bucket = np.minimum(round_up(ctxs, self.icfg.prefill_chunk), msl)
        last = np.minimum(ctxs + self.decode_window - 1, msl - 1)
        first_window = np.minimum(last // self.psz + 1, self.pages_per_seq)
        return int(np.maximum(bucket // self.psz + 1, first_window + 1).max())

    def _admit(self) -> None:
        # Pass 1 (host): claim slots + pages in arrival order, head-of-line
        # blocking on resources. ``reserved`` carries the headroom earlier
        # admissions of this burst claimed but have not allocated yet, so
        # the burst cannot over-commit the pool.
        admitted: list[tuple[Request, int]] = []
        reserved = 0
        while self.waiting:
            req = self.waiting[0]
            slot = next((i for i, r in enumerate(self.slots) if r is None), None)
            if slot is None:
                break
            context = req.context
            n_pages, need = self._admission_need(len(context))
            if self.alloc.free_pages - reserved < need:
                break
            reserved += need - n_pages
            self.waiting.popleft()
            req.slot = slot
            req.admit_seq = next(self._admit_seq)
            req.pages = self.alloc.alloc(n_pages)
            self.slots[slot] = req
            icfg = self.icfg
            self.slot_temp[slot] = (
                icfg.temperature if req.temperature is None else req.temperature
            )
            self.slot_top_k[slot] = icfg.top_k if req.top_k is None else req.top_k
            self.slot_top_p[slot] = icfg.top_p if req.top_p is None else req.top_p
            self.page_table[slot, :len(req.pages)] = req.pages
            self.seq_lens[slot] = len(context)
            admitted.append((req, self._bucket_len(len(context))))
        # Pass 2 (device): ONE prefill dispatch for the whole burst, padded
        # to its largest bucket; K3 skips the all-padding tiles of shorter
        # rows, so each row's attention pays about its own length.
        if admitted:
            self._prefill_bucket(
                [r for r, _ in admitted], max(s for _, s in admitted)
            )

    def _prefill_bucket(self, reqs: list[Request], s_pad: int) -> None:
        """Prefill admitted requests in one dispatch. Rows pad to a power
        of two; pad rows have length 1 and write scratch page 0, as do
        positions past a row's own bucket."""
        n_pages = s_pad // self.psz
        nb = 1 << (len(reqs) - 1).bit_length()
        tokens = np.zeros((nb, s_pad), np.int64)
        lengths = np.ones(nb, np.int32)
        pages = np.zeros((nb, n_pages), np.int64)
        for i, req in enumerate(reqs):
            ctx = req.context
            tokens[i, :len(ctx)] = ctx
            lengths[i] = len(ctx)
            pages[i, :len(req.pages)] = req.pages
        dev = self.device
        t0 = time.perf_counter()
        logits, self.cache = prefill_step(
            self.params, self.cache,
            torch.from_numpy(tokens).to(dev),
            torch.from_numpy(lengths).to(dev),
            torch.from_numpy(pages).to(dev),
            cfg=self.mcfg,
        )
        firsts = self._sample(logits, reqs)   # the one host fetch
        t1 = time.perf_counter()
        self.timing["prefill_s"] += t1 - t0
        self.timing["prefill_tokens"] += int(sum(len(r.context) for r in reqs))
        for i, req in enumerate(reqs):
            if req.max_new_tokens <= 0:
                req.done = True   # prefill-only (scoring) request
                continue
            first = int(firsts[i])
            self.last_token[req.slot] = first
            req.generated.append(first)
            if req.t_first is None:
                req.t_first = t1
            self._maybe_finish(req, first)

    def _sample(self, logits: torch.Tensor, reqs: list[Request]) -> np.ndarray:
        icfg = self.icfg
        if not any(
            r.temperature is not None or r.top_k is not None or r.top_p is not None
            for r in reqs
        ):
            toks = sample(logits, self._gen, temperature=icfg.temperature,
                          top_k=icfg.top_k, top_p=icfg.top_p)
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
        )
        return toks.cpu().numpy()

    def _teardown_slot(self, req: Request) -> None:
        """The one slot-teardown path (reap and preemption)."""
        slot = req.slot
        self.alloc.free(req.pages)
        req.pages = []
        req.slot = None
        self.slots[slot] = None
        self.page_table[slot] = 0
        self.seq_lens[slot] = 0
        self.last_token[slot] = 0

    def _preempt(self, req: Request) -> None:
        """Evict an active request, returning its pages; it re-enters at the
        head of the queue and recomputes its whole context on re-admission."""
        self.preemptions += 1
        self._teardown_slot(req)
        self.waiting.appendleft(req)

    def _grow_pages(self) -> None:
        """Pre-provision every live slot with pages for the whole upcoming
        decode window (the device writes up to W positions ahead of the
        host's view), oldest request first, preempting the youngest other
        request under pool pressure."""
        W = self.decode_window
        by_age = sorted(
            (r for r in self.slots if r is not None and not r.done),
            key=lambda r: r.admit_seq,
        )
        for req in by_age:
            if req.slot is None:
                continue  # preempted earlier in this pass
            pos = int(self.seq_lens[req.slot])
            last = min(pos + W - 1, self.icfg.max_seq_len - 1)
            n_need = min(last // self.psz + 1, self.pages_per_seq)
            while len(req.pages) < n_need:
                if self.alloc.free_pages < 1:
                    victim = next(
                        (r for r in reversed(by_age)
                         if r.slot is not None and r is not req), None,
                    )
                    if victim is None:
                        raise MemoryError(
                            "KV pool too small for a single request; "
                            "raise inference.num_pages"
                        )
                    self._preempt(victim)
                    continue
                page = self.alloc.alloc(1)[0]
                self.page_table[req.slot, len(req.pages)] = page
                req.pages.append(page)

    def _decode_window_all(self) -> bool:
        """The fused decode window over all live slots."""
        self._grow_pages()
        active = [r for r in self.slots if r is not None and not r.done]
        if not active:
            self._reap()
            return False
        W = self.decode_window
        mask = np.array([r is not None and not r.done for r in self.slots], bool)
        dev = self.device
        args = (
            self.params, self.cache,
            torch.from_numpy(self.last_token).to(dev),
            torch.from_numpy(self.seq_lens).to(dev),
            torch.from_numpy(self.page_table).to(dev),
            torch.from_numpy(mask).to(dev),
            self._gen,
        )
        kw = dict(n_steps=W, cfg=self.mcfg, max_seq_len=self.icfg.max_seq_len)
        if all(
            r.temperature is None and r.top_k is None and r.top_p is None
            for r in active
        ):
            kw.update(temperature=self.icfg.temperature, top_k=self.icfg.top_k,
                      top_p=self.icfg.top_p)
        else:
            kw.update(
                temperature=torch.from_numpy(self.slot_temp).to(dev),
                top_k=torch.from_numpy(self.slot_top_k).to(dev),
                top_p=torch.from_numpy(self.slot_top_p).to(dev),
            )
        t0 = time.perf_counter()
        toks, self.cache = decode_window(*args, **kw)
        tokens = toks.cpu().numpy()   # [W, B]: the window's one host fetch
        self.timing["decode_s"] += time.perf_counter() - t0
        self.timing["decode_slot_steps"] += W * len(active)
        for j in range(W):
            for req in active:
                if req.done:
                    continue   # finished mid-window: the overshoot is discarded
                tok = int(tokens[j, req.slot])
                self.seq_lens[req.slot] += 1
                self.last_token[req.slot] = tok
                req.generated.append(tok)
                self._maybe_finish(req, tok)
        self._reap()
        return True

    def _maybe_finish(self, req: Request, tok: int) -> None:
        hit_eos = self.eos_id is not None and tok == self.eos_id
        # seq_lens counts tokens whose KV is cached; the just-sampled token's
        # write position (== seq_lens) must stay inside the context window.
        ctx_full = int(self.seq_lens[req.slot]) >= self.icfg.max_seq_len
        if hit_eos or ctx_full or len(req.generated) >= req.max_new_tokens:
            req.done = True

    def _reap(self) -> None:
        for req in self.slots:
            if req is not None and req.done:
                if not req.outcome:
                    req.outcome = "completed"
                self._teardown_slot(req)
                self._just_finished.append(req)
