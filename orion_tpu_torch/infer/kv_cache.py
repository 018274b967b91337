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
"""

from __future__ import annotations

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


def init_cache(mcfg: ModelConfig, icfg: InferenceConfig, device) -> Cache:
    """Allocate the paged KV pool (zeros) on ``device``: pools in the
    model's dtype, or with ``inference.kv_quant='int8'`` int8 pools plus
    float32 scale pools ``k_scale``/``v_scale`` [rows, K, SCALE_LANES]."""
    rows = mcfg.n_layers * icfg.num_pages
    K, psz = mcfg.n_kv_heads, icfg.page_size
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
