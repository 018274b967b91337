"""Paged-flash prefill: a prefill chunk's queries attend the row's paged KV
history plus the chunk itself, with the chunk's pages written into the
pool whole, as a CUDA kernel (K9).

Row b resumes at the page-aligned ``start[b]`` (tokens already in the
pool): query j, at absolute position ``start[b] + j``, attends the row's
history pages (walk steps below ``n_prefix_pages``, dequantized under
int8) and the chunk's own earlier positions, read RAW from the dense
``k_new``/``v_new`` and never from the pool, under the optional sliding
window and logit softcap. Walk step ``n_prefix_pages + cb`` names the
pool page that chunk page ``cb`` is written to: the raw page, or under
int8 its ``quantize_kv`` bits with the scales in columns ``[:psz]`` of the
scale pool rows (later columns untouched). Padding columns are written
too; decode masks them by length.

K9 (``csrc/paged_prefill.cu``) replaces the TPU kernel
``orion_tpu/ops/pallas/paged_flash_prefill.py::_kernel``; its source note
says what bounds it and how the design answers. The two pool branches
count their launches apart (``paged_flash_prefill_cuda`` and
``paged_flash_prefill_int8_cuda``).

``paged_flash_prefill_plain`` is the JAX runner's xla body
(``infer/runner.py`` ``_prefill_layer`` with ``P_pre > 0``): gather the
prefix pages (dequantized to the chunk's dtype), concatenate the raw
chunk K/V, attend with explicit positions and segments, then scatter the
chunk's pages (quantized under int8). Padding query rows (past ``lens``)
hold garbage the caller discards, as in the JAX package. Both versions
update the pools IN PLACE and return ``(out, k_pool, v_pool[, k_scale,
v_scale])`` with the tensors they were given.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from orion_tpu_torch.ops import _build
from orion_tpu_torch.ops.attention import FLASH_HEAD_DIMS, attention_plain
from orion_tpu_torch.ops.common import (
    check_dtype,
    check_pools,
    counted,
    on_cuda,
    quantize_kv,
)
from orion_tpu_torch.ops.paged_attention import dequantize_pages

SMEM_BUDGET_BYTES = 232448   # dynamic shared memory a Hopper block may use
THREADS = 256                # threads per K9 block


def prefill_smem_bytes(head_dim: int, page_size: int) -> int:
    """Shared memory of one K9 block: the q block and one K page (float32,
    rows padded by one), one V page, the page's logits and its scales."""
    H, psz = head_dim, page_size
    return 4 * (2 * psz * (H + 1) + psz * H + psz * (psz + 1) + 2 * psz)


def check_prefill_fit(
    *,
    n_heads: int,
    n_kv_heads: int,
    head_dim: int,
    page_size: int,
) -> None:
    """Reject a page size or head_dim K9 cannot run at — the engine calls it
    at construction, so a bad ``inference.page_size`` is a config error and
    not a failed launch mid-serve. The block holds a page of queries and a
    page of keys and values in shared memory and H * psz / 256 output
    accumulators per thread; page sizes are powers of two in [16, 128]
    (a query row's 256 / psz threads reduce with warp shuffles). Shared
    memory is float32 in every pool branch, so the pool dtype does not
    enter."""
    H, psz = head_dim, page_size
    if n_heads % n_kv_heads:
        raise ValueError(f"n_heads={n_heads} not a multiple of n_kv_heads={n_kv_heads}")
    if H not in FLASH_HEAD_DIMS:
        raise ValueError(f"paged-flash prefill needs head_dim in {FLASH_HEAD_DIMS}, got {H}")
    if psz < 16 or psz > 128 or psz & (psz - 1):
        raise ValueError(
            f"paged-flash prefill needs inference.page_size a power of two in "
            f"[16, 128], got {psz}"
        )
    need = prefill_smem_bytes(H, psz)
    max_acc = H // 4 if H >= 128 else H // 2
    if need > SMEM_BUDGET_BYTES or H * psz // THREADS > max_acc:
        raise ValueError(
            f"paged-flash prefill at page_size={psz}, head_dim={H} needs "
            f"{need} bytes of shared memory and {H * psz // THREADS} "
            f"accumulators per thread (budget {SMEM_BUDGET_BYTES} bytes, "
            f"{max_acc}); lower inference.page_size"
        )


def paged_flash_prefill_plain(
    q: torch.Tensor,            # [B, S, N, H] the chunk's queries
    k_pool: torch.Tensor,       # [rows, K, psz, H]
    v_pool: torch.Tensor,
    walk: torch.Tensor,         # [B, P_pre + S // psz] prefix pages ++ chunk pages
    start: torch.Tensor,        # [B] page-aligned prefix length
    lens: torch.Tensor,         # [B] real chunk tokens
    k_new: torch.Tensor,        # [B, S, K, H] the chunk's K/V (raw)
    v_new: torch.Tensor,
    *,
    n_prefix_pages: int,
    layer_base: int = 0,
    logit_softcap: Optional[float] = None,
    window: Optional[int] = None,
    k_scale: Optional[torch.Tensor] = None,   # [rows, K, SW] float32 (int8 pools)
    v_scale: Optional[torch.Tensor] = None,
):
    B, S, N, H = q.shape
    K, psz = k_pool.shape[1], k_pool.shape[2]
    P_pre, NC = n_prefix_pages, S // psz
    dev = q.device
    quant = k_scale is not None
    walk = walk.long()
    start = start.long()
    rows_pre = layer_base + walk[:, :P_pre]                  # [B, P_pre]
    k_pre, v_pre = k_pool[rows_pre], v_pool[rows_pre]        # [B, P_pre, K, psz, H]
    if quant:
        k_pre = dequantize_pages(k_pre, k_scale[rows_pre], k_new.dtype)
        v_pre = dequantize_pages(v_pre, v_scale[rows_pre], v_new.dtype)
    k_pre = k_pre.permute(0, 1, 3, 2, 4).reshape(B, P_pre * psz, K, H).to(k_new.dtype)
    v_pre = v_pre.permute(0, 1, 3, 2, 4).reshape(B, P_pre * psz, K, H).to(v_new.dtype)
    positions = start[:, None] + torch.arange(S, device=dev)
    pre_idx = torch.arange(P_pre * psz, device=dev)
    kv_pos = torch.cat([pre_idx.expand(B, -1), positions], dim=1)
    seg = (torch.arange(S, device=dev)[None] < lens.long()[:, None]).long()
    kv_seg = torch.cat([(pre_idx[None] < start[:, None]).long(), seg], dim=1)
    dist = positions[:, :, None] - kv_pos[:, None, :]
    mask = (dist >= 0) & (seg[:, :, None] == kv_seg[:, None, :])
    if window is not None:
        if window < 1:
            raise ValueError(f"window={window} must be >= 1")
        mask = mask & (dist < window)
    out = attention_plain(
        q, torch.cat([k_pre, k_new], dim=1), torch.cat([v_pre, v_new], dim=1),
        causal=False, mask=mask, logit_softcap=logit_softcap,
    )
    # The chunk's pages, written whole: [B, NC, K, psz, H] at its walk rows.
    rows = layer_base + walk[:, P_pre:P_pre + NC]
    if quant:
        kq, ks = quantize_kv(k_new)
        vq, vs = quantize_kv(v_new)
        k_scale[rows, :, :psz] = ks.reshape(B, NC, psz, K).transpose(2, 3)
        v_scale[rows, :, :psz] = vs.reshape(B, NC, psz, K).transpose(2, 3)
    else:
        kq, vq = k_new.to(k_pool.dtype), v_new.to(v_pool.dtype)
    k_pool[rows] = kq.reshape(B, NC, psz, K, H).transpose(2, 3)
    v_pool[rows] = vq.reshape(B, NC, psz, K, H).transpose(2, 3)
    if quant:
        return out, k_pool, v_pool, k_scale, v_scale
    return out, k_pool, v_pool


def _launch(q, k_pool, v_pool, walk, start, lens, k_new, v_new, *, n_prefix_pages,
            layer_base, logit_softcap, window, k_scale, v_scale):
    """Validate and launch K9 (either branch); returns the output."""
    check_dtype("q", q)
    B, S, N, H = q.shape
    K, psz = k_pool.shape[1], k_pool.shape[2]
    quant = k_scale is not None
    P_pre = int(n_prefix_pages)
    check_pools(q, k_pool, v_pool, k_scale, v_scale)
    check_prefill_fit(n_heads=N, n_kv_heads=K, head_dim=H, page_size=psz)
    if S % psz:
        raise ValueError(f"chunk length {S} is not a multiple of page_size {psz}")
    NC = S // psz
    if k_new.shape != (B, S, K, H) or v_new.shape != (B, S, K, H):
        raise ValueError("k_new/v_new must be [B, S, K, H]")
    if walk.shape != (B, P_pre + NC) or start.shape != (B,) or lens.shape != (B,):
        raise ValueError("walk must be [B, n_prefix_pages + S // psz], start and lens [B]")
    if window is not None and window < 1:
        raise ValueError(f"window={window} must be >= 1")
    q = q.contiguous()
    k_new = k_new.to(q.dtype).contiguous()
    v_new = v_new.to(q.dtype).contiguous()
    walk = walk.to(torch.int32).contiguous()
    start = start.to(torch.int32).contiguous()
    lens = lens.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    ptr = lambda t: t.data_ptr() if t is not None else None  # noqa: E731
    rc = _build.entry(
        "paged_prefill", "paged_prefill",
        [ctypes.c_void_p] * 11 + [ctypes.c_int] * 9
        + [ctypes.c_longlong, ctypes.c_int, ctypes.c_float, ctypes.c_float,
           ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
    )(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), ptr(k_scale), ptr(v_scale),
        k_new.data_ptr(), v_new.data_ptr(), walk.data_ptr(), start.data_ptr(),
        lens.data_ptr(), out.data_ptr(),
        B, S, N, K, H, psz, P_pre, NC, k_scale.shape[2] if quant else 0,
        int(layer_base), int(window or 0), float(logit_softcap or 0.0), float(H ** -0.5),
        1 if q.dtype == torch.bfloat16 else 0, int(quant),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(rc, "paged_prefill")
    return out


@counted
def paged_flash_prefill_cuda(
    q, k_pool, v_pool, walk, start, lens, k_new, v_new, *, n_prefix_pages,
    layer_base=0, logit_softcap=None, window=None,
):
    """Launch K9 on CUDA tensors over bf16/f32 pools; arguments as
    paged_flash_prefill_plain."""
    out = _launch(q, k_pool, v_pool, walk, start, lens, k_new, v_new,
                  n_prefix_pages=n_prefix_pages, layer_base=layer_base,
                  logit_softcap=logit_softcap, window=window, k_scale=None,
                  v_scale=None)
    paged_flash_prefill_cuda.launches += 1
    return out, k_pool, v_pool


@counted
def paged_flash_prefill_int8_cuda(
    q, k_pool, v_pool, walk, start, lens, k_new, v_new, *, n_prefix_pages,
    k_scale, v_scale, layer_base=0, logit_softcap=None, window=None,
):
    """Launch K9's int8 branch on CUDA tensors: int8 pools with float32
    scale pools; arguments and returns as paged_flash_prefill_plain's."""
    out = _launch(q, k_pool, v_pool, walk, start, lens, k_new, v_new,
                  n_prefix_pages=n_prefix_pages, layer_base=layer_base,
                  logit_softcap=logit_softcap, window=window, k_scale=k_scale,
                  v_scale=v_scale)
    paged_flash_prefill_int8_cuda.launches += 1
    return out, k_pool, v_pool, k_scale, v_scale


def paged_flash_prefill(
    q: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    walk: torch.Tensor,
    start: torch.Tensor,
    lens: torch.Tensor,
    k_new: torch.Tensor,
    v_new: torch.Tensor,
    *,
    n_prefix_pages: int,
    layer_base: int = 0,
    logit_softcap: Optional[float] = None,
    window: Optional[int] = None,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
):
    """Chunk prefill attention over the paged pool with the chunk's pages
    written in place; returns ``(out [B, S, N, H], k_pool, v_pool)`` —
    plus ``(k_scale, v_scale)`` for int8 pools. CUDA tensors go to K9, CPU
    tensors to the plain version."""
    if (k_scale is None) != (v_scale is None):
        raise ValueError("k_scale and v_scale go together")
    kw = dict(n_prefix_pages=n_prefix_pages, layer_base=layer_base,
              logit_softcap=logit_softcap, window=window)
    args = (q, k_pool, v_pool, walk, start, lens, k_new, v_new)
    if on_cuda(*args):
        if k_scale is not None:
            return paged_flash_prefill_int8_cuda(*args, k_scale=k_scale,
                                                 v_scale=v_scale, **kw)
        return paged_flash_prefill_cuda(*args, **kw)
    return paged_flash_prefill_plain(*args, k_scale=k_scale, v_scale=v_scale, **kw)
