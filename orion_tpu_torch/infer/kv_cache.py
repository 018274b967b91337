"""Paged KV-cache pool + host-side page allocator.

Counterpart of ``orion_tpu/infer/kv_cache.py`` (bf16/f32 pools): one
global pool of fixed-size pages per layer, with sequences owning pages
through an integer page table and the allocator — the only dynamic
piece — on the host as a free list.

Layout (the JAX package's, so pools compare byte for byte):
    k_pool, v_pool: [n_layers * num_pages, n_kv_heads, page_size, head_dim]

The layer dim is flattened into the page dim (layer l's pages are rows
[l*num_pages, (l+1)*num_pages)); page ids in page tables are
per-layer-relative and device code adds ``l * num_pages``. Page 0 of each
layer region is a scratch page: every inactive slot points at it. The
cache is a plain dict of tensors, updated in place by the runner.
"""

from __future__ import annotations

import torch

from orion_tpu_torch.config import InferenceConfig, ModelConfig
from orion_tpu_torch.models.transformer import torch_dtype

Cache = dict[str, torch.Tensor]


def pages_per_seq(icfg: InferenceConfig) -> int:
    if icfg.max_seq_len % icfg.page_size:
        raise ValueError(
            f"inference.max_seq_len={icfg.max_seq_len} must be a multiple "
            f"of inference.page_size={icfg.page_size}"
        )
    return icfg.max_seq_len // icfg.page_size


def init_cache(mcfg: ModelConfig, icfg: InferenceConfig, device) -> Cache:
    """Allocate the paged KV pool (zeros) on ``device``."""
    if icfg.kv_quant is not None:
        raise NotImplementedError(
            f"inference.kv_quant={icfg.kv_quant!r} is not ported yet"
        )
    rows = mcfg.n_layers * icfg.num_pages
    shape = (rows, mcfg.n_kv_heads, icfg.page_size, mcfg.resolved_head_dim)
    dtype = torch_dtype(mcfg.dtype)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
    }


class PageAllocator:
    """Host-side free list over the page pool (page 0 = scratch).

    Invariant: free_pages + live pages == num_pages - 1. Pages are owned
    once (sharing arrives with the prefix cache); the per-page count
    catches a double release.
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

    def free(self, pages: list[int]) -> None:
        for p in pages:
            if not 0 < p < self.num_pages or self._refs[p] != 1:
                raise ValueError(f"free of page {p}, which is not allocated")
            self._refs[p] = 0
            self._free.append(p)
