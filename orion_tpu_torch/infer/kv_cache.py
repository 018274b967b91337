"""Paged KV-cache pool + host-side page allocator.

Counterpart of ``orion_tpu/infer/kv_cache.py``: one global pool of
fixed-size pages per layer, with sequences owning pages through an
integer page table and the allocator — the only dynamic piece — on the
host as a refcounted free list.

Layout (the JAX package's, so pools compare byte for byte):
    k_pool, v_pool: [n_layers * num_pages, n_kv_heads, page_size, head_dim]
    k_scale, v_scale (int8 pools only): [n_layers * num_pages, n_kv_heads,
        SCALE_LANES] float32; column t holds token t's scale on that page,
        columns at or past page_size are dead but kept.

The layer dim is flattened into the page dim (layer l's pages are rows
[l*num_pages, (l+1)*num_pages)); page ids in page tables are
per-layer-relative and device code adds ``l * num_pages``. Page 0 of each
layer region is a scratch page: every inactive slot points at it. The
cache is a plain dict of tensors, updated in place by the runner; the
presence of ``k_scale`` is what marks an int8 pool.

Speculative decoding adds ``rollback_pages`` (release the pages a verify
step provisioned past the accepted cursor) and ``compact_draft_kv`` (move
an accepted off-primary tree path's KV to cursor-contiguous positions);
the NaN quarantine adds ``poison_page`` (its fault injection) and
``scrub_pages`` (zero a quarantined request's pages before reuse).

Under tensor parallelism every rank's pool holds its ``n_kv_heads / tp``
heads of every page (``init_cache``'s ``tp``), and every page helper here
(``copy_page``, ``scrub_pages``, ``poison_page``, ``compact_draft_kv``,
``gather_pages``/``scatter_pages`` and the host pool) acts on whatever
rank's slice it is handed: the page ids are the same on every rank.

The host tier (inference.host_tier_bytes) adds ``HostPagePool``, a
refcounted store of whole pages in host memory (pinned when the pool is on
the card), ``gather_pages``/``scatter_pages`` (all layers of a page set,
every cache tensor, the int8 pools' scale rows included), and the sizing
arithmetic ``host_page_bytes`` and ``host_tier_break_even_tokens``. The
copies are plain tensor indexing and copies, as the JAX package leaves
them to XLA outside any kernel.
"""

from __future__ import annotations

import itertools
import math
from typing import Optional

import torch

from orion_tpu_torch.config import InferenceConfig, ModelConfig
from orion_tpu_torch.models.transformer import torch_dtype

Cache = dict[str, torch.Tensor]

SCALE_LANES = 128  # the JAX package pads a page's scales to one lane tile


def pages_per_seq(icfg: InferenceConfig) -> int:
    if icfg.max_seq_len % icfg.page_size:
        raise ValueError(
            f"inference.max_seq_len={icfg.max_seq_len} must be a multiple "
            f"of inference.page_size={icfg.page_size}"
        )
    return icfg.max_seq_len // icfg.page_size


def scale_width(psz: int) -> int:
    if psz > SCALE_LANES:
        raise ValueError(
            f"kv_quant='int8' requires page_size <= {SCALE_LANES}, "
            f"got {psz} (one lane tile holds one page's scales)"
        )
    return SCALE_LANES


def init_cache(mcfg: ModelConfig, icfg: InferenceConfig, device, tp: int = 1) -> Cache:
    """Allocate the paged KV pool (zeros) on ``device``: pools in the
    model's dtype, or with ``inference.kv_quant='int8'`` int8 pools plus
    float32 scale pools ``k_scale``/``v_scale`` [rows, K, SCALE_LANES].
    Under tensor parallelism a rank's pool holds its ``K = n_kv_heads /
    tp`` heads of every page (the JAX engine's ``P(None, "tp", None,
    None)`` pool, its scale pools ``P(None, "tp", None)``)."""
    rows = mcfg.n_layers * icfg.num_pages
    K, psz = mcfg.n_kv_heads // tp, icfg.page_size
    shape = (rows, K, psz, mcfg.resolved_head_dim)
    if icfg.kv_quant == "int8":
        sw = scale_width(psz)
        return {
            "k": torch.zeros(shape, dtype=torch.int8, device=device),
            "v": torch.zeros(shape, dtype=torch.int8, device=device),
            "k_scale": torch.zeros((rows, K, sw), dtype=torch.float32, device=device),
            "v_scale": torch.zeros((rows, K, sw), dtype=torch.float32, device=device),
        }
    if icfg.kv_quant is not None:
        raise ValueError(f"unknown inference.kv_quant={icfg.kv_quant!r}")
    dtype = torch_dtype(mcfg.dtype)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
    }


def copy_page(cache: Cache, src: int, dst: int, *, n_layers: int, num_pages: int) -> None:
    """Copy one pool page's rows (all layers, every cache tensor — scale
    pools included) from ``src`` to ``dst``, in place: the copy-on-write
    step of a full prefix match, which must rewrite the final token's KV
    slot without touching the shared page. A plain tensor copy, as XLA
    does it in the JAX package."""
    base = torch.arange(n_layers, device=cache["k"].device) * num_pages
    for arr in cache.values():
        arr[base + dst] = arr[base + src]


def poison_page(cache: Cache, page: int, *, n_layers: int, num_pages: int) -> None:
    """Overwrite one pool page's K rows (all layers) with NaN, in place: the
    fault-injection primitive behind the NaN quarantine (FaultSpec
    kind="nan"). Real NaNs then flow through the real attention into the
    one slot that owns the page. An int8 pool cannot hold a NaN, so its
    float32 ``k_scale`` rows are poisoned instead (the dequantized K goes
    NaN, with the same reach)."""
    target = "k_scale" if "k_scale" in cache else "k"
    arr = cache[target]
    rows = torch.arange(n_layers, device=arr.device) * num_pages + int(page)
    arr[rows] = float("nan")


def scrub_pages(cache: Cache, pages, *, n_layers: int, num_pages: int) -> None:
    """Zero the given pool pages' rows in every cache tensor (all layers),
    in place: the quarantine scrubs a poisoned request's private pages
    before they return to the free list, so no stale NaN reaches a later
    tenant (a masked column's zero probability times a NaN value is NaN).
    ``pages`` may repeat and hold scratch page 0 (padding); zeroing scratch
    is harmless."""
    dev = cache["k"].device
    p = torch.as_tensor(list(pages), dtype=torch.long).to(dev)
    rows = (torch.arange(n_layers, device=dev)[:, None] * num_pages + p[None, :]).reshape(-1)
    for arr in cache.values():
        arr[rows] = 0


class PageAllocator:
    """Host-side refcounted free list over the page pool (page 0 = scratch).

    The prefix cache and live requests SHARE immutable pages: ``alloc``
    hands out pages at refcount 1, ``retain`` adds an owner, ``release``
    drops one, and a page returns to the free list when its last owner
    lets go. Invariant: free_pages + live pages == num_pages - 1, where a
    page is live iff its refcount > 0. ``free`` is the bulk release for
    owners holding one ref per page.
    """

    def __init__(self, num_pages: int):
        if num_pages < 2:
            raise ValueError("need at least 2 pages (page 0 is scratch)")
        self.num_pages = num_pages
        self._free: list[int] = list(range(num_pages - 1, 0, -1))
        self._refs: list[int] = [0] * num_pages

    @property
    def free_pages(self) -> int:
        return len(self._free)

    def refcount(self, page: int) -> int:
        return self._refs[page]

    def alloc(self, n: int) -> list[int]:
        if n > len(self._free):
            raise MemoryError(
                f"KV cache pool exhausted: want {n} pages, have "
                f"{len(self._free)}"
            )
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            self._refs[p] = 1
        return pages

    def _check_live(self, page: int, what: str) -> None:
        if not 0 < page < self.num_pages or self._refs[page] <= 0:
            raise ValueError(f"{what} of page {page}, which is not allocated")

    def retain(self, page: int) -> None:
        """Add an owner to a live (shared) page."""
        self._check_live(page, "retain")
        self._refs[page] += 1

    def release(self, page: int) -> bool:
        """Drop one ownership ref; returns True iff the page was freed."""
        self._check_live(page, "release")
        self._refs[page] -= 1
        if self._refs[page] == 0:
            self._free.append(page)
            return True
        return False

    def free(self, pages: list[int]) -> None:
        """Bulk release for owners holding one ref per page."""
        for p in pages:
            self.release(p)


def rollback_pages(alloc: PageAllocator, pages: list, n_keep: int) -> list[int]:
    """Speculative-decode rollback: truncate a request's page list to its
    first ``n_keep`` entries and release the tail to the pool.

    A verify step provisions pages for its whole draft window (write
    positions run up to speculate_tokens past the accepted cursor); after
    acceptance, pages holding only rejected positions are dead. Releasing
    them restores the footprint a non-speculative window=1 engine holds
    after its step. The tail is always private (refcount 1): shared prefix
    pages lie strictly below any live cursor, hence below ``n_keep``.
    Returns the released pages (the caller zeroes their page-table
    columns)."""
    if n_keep < 0:
        raise ValueError(f"n_keep={n_keep} must be >= 0")
    dead = list(pages[n_keep:])
    del pages[n_keep:]
    alloc.free(dead)
    return dead


@torch.no_grad()
def compact_draft_kv(
    cache: Cache,
    page_table: torch.Tensor,   # [B, P] per-layer-relative page ids
    seq_lens: torch.Tensor,     # [B] the verify-time cursor (start)
    src: torch.Tensor,          # [B, W] column whose KV moves to start + i
    *,
    n_layers: int,
    num_pages: int,
) -> None:
    """Tree-speculation KV compaction, in place: position ``start + i``
    receives the KV that the verify step wrote at ``start + src[b, i]``,
    in every layer and every cache tensor (int8 pools move with their
    scale columns).

    An accepted root path that is not the tree's primary chain lies at
    non-contiguous verify columns; this moves it to cursor-contiguous
    positions before the next step reads them. Every source column is
    gathered before any is scattered: destinations are never past their
    sources (depth <= column), so overlapping moves read pre-move bytes.
    Identity entries copy onto themselves. The bytes move verbatim, so the
    pool is bitwise what a sequential decode of the accepted tokens would
    have written. Plain advanced indexing, as the JAX package leaves this
    to XLA outside any kernel."""
    B, W = src.shape
    psz = cache["k"].shape[2]
    P = page_table.shape[1]
    dev = cache["k"].device
    pt = page_table.to(dev).long()
    start = seq_lens.to(dev).long()[:, None]
    max_pos = P * psz - 1
    bidx = torch.arange(B, device=dev)[:, None]
    steps = torch.arange(W, device=dev)[None, :]
    src_pos = (start + src.to(dev).long()).clamp(max=max_pos)
    dst_pos = (start + steps).clamp(max=max_pos)
    layer = torch.arange(n_layers, device=dev)[:, None, None] * num_pages
    rows_src = layer + pt[bidx, src_pos // psz][None]          # [L, B, W]
    rows_dst = layer + pt[bidx, dst_pos // psz][None]
    off_src = (src_pos % psz).expand(n_layers, B, W)
    off_dst = (dst_pos % psz).expand(n_layers, B, W)
    # Pools are [rows, K, psz, H] and scale pools [rows, K, SW]: either way
    # the token column is axis 2 of a row.
    vals = {name: arr[rows_src, :, off_src] for name, arr in cache.items()}
    for name, arr in cache.items():
        arr[rows_dst, :, off_dst] = vals[name]


class HostPagePool:
    """Host-memory page store: the second tier behind the radix tree and
    the per-request paging of long-context serving.

    ``PageAllocator``'s counterpart for host memory: the same refcounted
    free list (``alloc`` hands slots out at refcount 1, ``retain`` adds an
    owner, ``release`` drops one), its own LRU clock (``touch``,
    ``evict_lru``, which never takes a slot with a second owner), and the
    bytes: per cache tensor one buffer ``[capacity, n_layers, ...]``,
    allocated on the first store. A pool serving a card keeps its buffers
    in pinned memory and copies with ``non_blocking`` on the current
    stream: ``store`` enqueues the device-to-host copies and records an
    event per slot, and nothing reads or rewrites those bytes before the
    event: ``load`` waits for it on the host, ``load_to`` on the stream,
    and ``alloc`` before it hands the slot out again. Nothing here knows
    what the bytes mean.
    """

    def __init__(self, capacity: int, page_bytes: int = 0):
        if capacity < 1:
            raise ValueError(f"HostPagePool needs capacity >= 1, got {capacity}")
        self.capacity = capacity
        self.page_bytes = page_bytes
        self._free: list[int] = list(range(capacity - 1, -1, -1))
        self._refs: list[int] = [0] * capacity
        self._stamps: list[int] = [0] * capacity
        self._clock = itertools.count(1)
        self._store: dict[str, torch.Tensor] = {}
        # Slot -> the CUDA event after the last async copy touching it.
        self._pending: dict[int, torch.cuda.Event] = {}

    @property
    def free_slots(self) -> int:
        return len(self._free)

    def refcount(self, hid: int) -> int:
        return self._refs[hid]

    def _settle(self, hids) -> None:
        """Wait on the host for the copies still in flight on ``hids``."""
        for ev in {id(e): e for e in (self._pending.pop(h, None) for h in hids)
                   if e is not None}.values():
            ev.synchronize()

    def alloc(self, n: int) -> list[int]:
        if n > len(self._free):
            raise MemoryError(
                f"host page pool exhausted: want {n} slots, have {len(self._free)}"
            )
        hids = [self._free.pop() for _ in range(n)]
        self._settle(hids)   # a slot's old copy ends before it is reused
        now = next(self._clock)
        for h in hids:
            self._refs[h] = 1
            self._stamps[h] = now
        return hids

    def retain(self, hid: int) -> None:
        assert 0 <= hid < self.capacity, hid
        assert self._refs[hid] > 0, f"retain of free host slot {hid}"
        self._refs[hid] += 1

    def release(self, hid: int) -> bool:
        """Drop one ownership ref; returns True iff the slot was freed."""
        assert 0 <= hid < self.capacity, hid
        assert self._refs[hid] > 0, f"release of free host slot {hid}"
        self._refs[hid] -= 1
        if self._refs[hid] == 0:
            self._free.append(hid)
            return True
        return False

    def free(self, hids: list[int]) -> None:
        """Bulk release for owners holding one ref per slot."""
        for h in hids:
            self.release(h)

    def touch(self, hid: int) -> None:
        self._stamps[hid] = next(self._clock)

    def evict_lru(self, n: int) -> list[int]:
        """Free up to ``n`` of the coldest single-owner slots (a slot with
        a second owner is skipped, never stolen); returns them. The caller
        drops its own entries for them."""
        if n <= 0:
            return []
        victims = sorted(
            (h for h in range(self.capacity) if self._refs[h] == 1),
            key=lambda h: self._stamps[h],
        )[:n]
        for h in victims:
            self.release(h)
        return victims

    @staticmethod
    def _runs(hids):
        """(i, h, n): runs of consecutive slot ids, so one copy serves a
        run (slots hand out in ascending order)."""
        i = 0
        while i < len(hids):
            j = i + 1
            while j < len(hids) and hids[j] == hids[j - 1] + 1:
                j += 1
            yield i, hids[i], j - i
            i = j

    def store(self, hids: list[int], blocks: dict[str, torch.Tensor],
              n: Optional[int] = None) -> None:
        """Copy the first ``n`` rows of each page block (``gather_pages``'
        shape; row i -> ``hids[i]``) into the slots: asynchronously from a
        card, with one event recorded for the whole store."""
        n = len(hids) if n is None else n
        assert n <= len(hids), (n, len(hids))
        rows = list(hids[:n])
        cuda = False
        for name, blk in blocks.items():
            buf = self._store.get(name)
            if buf is None:
                buf = torch.empty((self.capacity,) + tuple(blk.shape[1:]), dtype=blk.dtype,
                                  pin_memory=blk.is_cuda)
                self._store[name] = buf
            cuda = cuda or blk.is_cuda
            for i, h, m in self._runs(rows):
                buf[h:h + m].copy_(blk[i:i + m], non_blocking=blk.is_cuda)
        now = next(self._clock)
        if cuda:
            ev = torch.cuda.Event()
            ev.record()
        for h in rows:
            self._stamps[h] = now
            if cuda:
                self._pending[h] = ev

    def load(self, hids: list[int]) -> dict[str, torch.Tensor]:
        """The slots' bytes as host page blocks (row i = ``hids[i]``),
        once their copies have landed."""
        rows = list(hids)
        self._settle(rows)
        now = next(self._clock)
        for h in rows:
            self._stamps[h] = now
        idx = torch.as_tensor(rows, dtype=torch.long)
        return {name: buf[idx] for name, buf in self._store.items()}

    def load_to(self, hids: list[int], device) -> dict[str, torch.Tensor]:
        """The slots' bytes as page blocks on ``device`` (``scatter_pages``'
        shape): host-to-device copies from the pinned slots, ``non_blocking``
        on the current stream, ordered after the slots' earlier copies by
        a wait on the stream, not the host. An event marks the slots until
        the copies have read them."""
        rows = list(hids)
        device = torch.device(device)
        now = next(self._clock)
        for h in rows:
            self._stamps[h] = now
        if device.type != "cuda":
            return self.load(rows)
        stream = torch.cuda.current_stream(device)
        for ev in {id(e): e for e in (self._pending.get(h) for h in rows)
                   if e is not None}.values():
            stream.wait_event(ev)
        out = {}
        for name, buf in self._store.items():
            dst = torch.empty((len(rows),) + tuple(buf.shape[1:]), dtype=buf.dtype,
                              device=device)
            for i, h, m in self._runs(rows):
                dst[i:i + m].copy_(buf[h:h + m], non_blocking=True)
            out[name] = dst
        ev = torch.cuda.Event()
        ev.record(stream)
        for h in rows:
            self._pending[h] = ev
        return out


def _page_rows(pages: torch.Tensor, n_layers: int, num_pages: int) -> torch.Tensor:
    """[n, n_layers] pool rows of ``pages`` in every layer."""
    pages = pages.long()
    return pages[:, None] + torch.arange(n_layers, device=pages.device)[None, :] * num_pages


def gather_pages(cache: Cache, pages: torch.Tensor, *, n_layers: int,
                 num_pages: int) -> Cache:
    """Whole pool pages (all layers, every cache tensor: the int8 pools'
    scale rows ride along) as dense blocks ``[n, n_layers, ...]``: the
    device half of a demotion's one batched device-to-host copy. The pool
    is read, not changed."""
    rows = _page_rows(pages.to(cache["k"].device), n_layers, num_pages)
    return {name: arr[rows] for name, arr in cache.items()}


def scatter_pages(cache: Cache, pages: torch.Tensor, blocks: Cache, *, n_layers: int,
                  num_pages: int) -> None:
    """Write dense page blocks (``gather_pages``' shape) into the pool
    pages, in place: the device half of a restore's one batched
    host-to-device copy."""
    rows = _page_rows(pages.to(cache["k"].device), n_layers, num_pages)
    for name, arr in cache.items():
        arr[rows] = blocks[name].to(device=arr.device, dtype=arr.dtype)


def host_page_bytes(cache: Cache, n_layers: int) -> int:
    """Host bytes one pool page takes over every cache tensor (all layers;
    the scale rows of an int8 pool included): the unit
    inference.host_tier_bytes is divided by."""
    return sum(n_layers * math.prod(arr.shape[1:]) * arr.element_size()
               for arr in cache.values())


def host_tier_break_even_tokens(
    page_bytes: int,
    page_size: int,
    h2d_gbps: float,
    restore_overhead_s: float,
    prefill_tok_s: float,
) -> Optional[int]:
    """The match length above which restoring a host-resident prefix beats
    recomputing it:

        restore(t)   = overhead + t * bytes_per_token / (bw * 1e9)
        recompute(t) = t / prefill_tok_s

    so t* = overhead / (1/prefill_tok_s - bytes_per_token/bw). None when
    the restore slope is not below the recompute slope (restore never
    wins); else the crossing, floored at one page."""
    per_tok_restore = (page_bytes / page_size) / (h2d_gbps * 1e9)
    per_tok_compute = 1.0 / prefill_tok_s
    if per_tok_restore >= per_tok_compute:
        return None
    gain = per_tok_compute - per_tok_restore
    return max(page_size, math.ceil(restore_overhead_s / gain))
