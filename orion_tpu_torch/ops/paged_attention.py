"""Paged decode attention, KV write fused in, as a CUDA kernel (K4).

One query token per slot attends that slot's pages of the flat
[L*num_pages, K, psz, H] pool (rows ``layer_base + page_table[b, :]``),
after the token's own K/V is written at row ``layer_base +
page_table[b, last_pos // psz]``, column ``last_pos % psz``.

K4 (``csrc/paged_decode.cu``) replaces the TPU kernel
``orion_tpu/ops/pallas/paged_attention.py::_kernel`` in both its pool
branches; its source note says what bounds it and how the design
answers. With ``k_scale``/``v_scale`` the pools are int8 (inference.
kv_quant): the new token is quantized with ``quantize_kv``'s bits and its
scale lands in column ``last_pos % psz`` of the scale pool; the K scale
multiplies the logit columns after q.k and the V scale folds into the
probabilities before p.v. The two branches count their launches apart
(``paged_attention_cuda`` and ``paged_attention_int8_cuda``).

``paged_attention_plain`` mirrors the JAX runner's xla decode branch
(``infer/runner.py`` ``_decode_layer``): scatter the new token's K/V
(quantized under int8) into the pool, gather every page of the slot's
table into a padded [B, P*psz, K, H] context (dequantized to q's dtype
under int8), and run masked attention. Both versions update the pools IN
PLACE (the JAX package returns fresh arrays; the port saves the pool
copy) and return ``(out, k_pool, v_pool[, k_scale, v_scale])`` with the
tensors they were given.
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


def dequantize_pages(pages: torch.Tensor, scales: torch.Tensor, dtype) -> torch.Tensor:
    """int8 pool rows [..., K, psz, H] times their scale rows [..., K, SW]
    (first psz columns) -> ``dtype``, through float32 as the JAX runner."""
    psz = pages.shape[-2]
    return (pages.float() * scales[..., :psz, None]).to(dtype)


def paged_attention_plain(
    q: torch.Tensor,            # [B, N, H]
    k_pool: torch.Tensor,       # [rows, K, psz, H]
    v_pool: torch.Tensor,
    page_table: torch.Tensor,   # [B, P] int32, per-layer-relative page ids
    last_pos: torch.Tensor,     # [B] int32, highest valid position
    *,
    layer_base: int = 0,
    k_new: Optional[torch.Tensor] = None,  # [B, K, H]
    v_new: Optional[torch.Tensor] = None,
    logit_softcap: Optional[float] = None,
    window: Optional[int] = None,
    k_scale: Optional[torch.Tensor] = None,  # [rows, K, SW] float32 (int8 pools)
    v_scale: Optional[torch.Tensor] = None,
):
    B = q.shape[0]
    K, psz, H = k_pool.shape[1], k_pool.shape[2], k_pool.shape[3]
    P = page_table.shape[1]
    pt = page_table.long()
    lp = last_pos.long()
    quant = k_scale is not None
    if k_new is not None:
        rows = layer_base + pt[torch.arange(B, device=q.device), lp // psz]
        off = lp % psz
        if quant:
            kq, ks = quantize_kv(k_new)
            vq, vs = quantize_kv(v_new)
            k_pool[rows, :, off] = kq
            v_pool[rows, :, off] = vq
            k_scale[rows, :, off] = ks
            v_scale[rows, :, off] = vs
        else:
            k_pool[rows, :, off] = k_new.to(k_pool.dtype)
            v_pool[rows, :, off] = v_new.to(v_pool.dtype)
    # [B, P, K, psz, H] -> [B, P*psz, K, H] padded-context gather.
    k_pg, v_pg = k_pool[layer_base + pt], v_pool[layer_base + pt]
    if quant:
        k_pg = dequantize_pages(k_pg, k_scale[layer_base + pt], q.dtype)
        v_pg = dequantize_pages(v_pg, v_scale[layer_base + pt], q.dtype)
    k_ctx = k_pg.permute(0, 1, 3, 2, 4).reshape(B, P * psz, K, H)
    v_ctx = v_pg.permute(0, 1, 3, 2, 4).reshape(B, P * psz, K, H)
    kv_arange = torch.arange(P * psz, device=q.device)[None, None, :]
    mask = kv_arange <= lp[:, None, None]
    if window is not None:
        mask = mask & (kv_arange >= (lp - window + 1)[:, None, None])
    out = attention_plain(
        q[:, None], k_ctx.to(q.dtype), v_ctx.to(q.dtype), causal=False,
        mask=mask, logit_softcap=logit_softcap,
    )[:, 0]
    if k_new is None:
        return out
    if quant:
        return out, k_pool, v_pool, k_scale, v_scale
    return out, k_pool, v_pool


def _launch(q, k_pool, v_pool, page_table, last_pos, *, layer_base, k_new, v_new,
            logit_softcap, window, k_scale, v_scale):
    """Validate and launch K4 (either branch); returns the output."""
    check_dtype("q", q)
    B, N, H = q.shape
    K, psz = k_pool.shape[1], k_pool.shape[2]
    quant = k_scale is not None
    check_pools(q, k_pool, v_pool, k_scale, v_scale)
    if N % K or H not in FLASH_HEAD_DIMS or (N // K) * H > 2048:
        raise ValueError(f"unsupported heads: N={N} K={K} H={H}")
    if page_table.dim() != 2 or page_table.shape[0] != B or last_pos.shape != (B,):
        raise ValueError("page_table must be [B, P] and last_pos [B]")
    if window is not None and window < 1:
        raise ValueError(f"window={window} must be >= 1")
    if (k_new is None) != (v_new is None):
        raise ValueError("k_new and v_new go together")
    if k_new is not None:
        if k_new.shape != (B, K, H) or v_new.shape != (B, K, H):
            raise ValueError("k_new/v_new must be [B, K, H]")
        k_new = k_new.to(q.dtype).contiguous()
        v_new = v_new.to(q.dtype).contiguous()
    q = q.contiguous()
    pt = page_table.to(torch.int32).contiguous()
    lp = last_pos.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    ptr = lambda t: t.data_ptr() if t is not None else None  # noqa: E731
    rc = _build.entry(
        "paged_decode", "paged_decode",
        [ctypes.c_void_p] * 10 + [ctypes.c_int] * 7
        + [ctypes.c_longlong, ctypes.c_int, ctypes.c_float, ctypes.c_float,
           ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
    )(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), ptr(k_scale), ptr(v_scale),
        ptr(k_new), ptr(v_new), pt.data_ptr(), lp.data_ptr(), out.data_ptr(),
        B, N, K, H, psz, pt.shape[1], k_scale.shape[2] if quant else 0,
        int(layer_base), int(window or 0), float(logit_softcap or 0.0), float(H ** -0.5),
        1 if q.dtype == torch.bfloat16 else 0, int(quant),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(rc, "paged_decode")
    return out


@counted
def paged_attention_cuda(
    q, k_pool, v_pool, page_table, last_pos, *, layer_base=0, k_new=None,
    v_new=None, logit_softcap=None, window=None,
):
    """Launch K4 on CUDA tensors over bf16/f32 pools; arguments as
    paged_attention_plain."""
    out = _launch(q, k_pool, v_pool, page_table, last_pos, layer_base=layer_base,
                  k_new=k_new, v_new=v_new, logit_softcap=logit_softcap,
                  window=window, k_scale=None, v_scale=None)
    paged_attention_cuda.launches += 1
    if k_new is None:
        return out
    return out, k_pool, v_pool


@counted
def paged_attention_int8_cuda(
    q, k_pool, v_pool, page_table, last_pos, *, k_scale, v_scale, layer_base=0,
    k_new=None, v_new=None, logit_softcap=None, window=None,
):
    """Launch K4's int8 branch on CUDA tensors: int8 pools with float32
    scale pools; arguments and returns as paged_attention_plain's."""
    out = _launch(q, k_pool, v_pool, page_table, last_pos, layer_base=layer_base,
                  k_new=k_new, v_new=v_new, logit_softcap=logit_softcap,
                  window=window, k_scale=k_scale, v_scale=v_scale)
    paged_attention_int8_cuda.launches += 1
    if k_new is None:
        return out
    return out, k_pool, v_pool, k_scale, v_scale


def paged_attention(
    q: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    page_table: torch.Tensor,
    last_pos: torch.Tensor,
    *,
    layer_base: int = 0,
    k_new: Optional[torch.Tensor] = None,
    v_new: Optional[torch.Tensor] = None,
    logit_softcap: Optional[float] = None,
    window: Optional[int] = None,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
):
    """Decode attention over the paged pool. Returns [B, N, H] when
    ``k_new``/``v_new`` are None, else ``(out, k_pool, v_pool)`` — plus
    ``(k_scale, v_scale)`` for int8 pools — with the new token's K/V
    written in place. CUDA tensors go to K4, CPU tensors to the plain
    version."""
    kw = dict(layer_base=layer_base, k_new=k_new, v_new=v_new,
              logit_softcap=logit_softcap, window=window)
    if (k_scale is None) != (v_scale is None):
        raise ValueError("k_scale and v_scale go together")
    if on_cuda(q, k_pool, v_pool, page_table, last_pos):
        if k_scale is not None:
            return paged_attention_int8_cuda(q, k_pool, v_pool, page_table, last_pos,
                                             k_scale=k_scale, v_scale=v_scale, **kw)
        return paged_attention_cuda(q, k_pool, v_pool, page_table, last_pos, **kw)
    return paged_attention_plain(q, k_pool, v_pool, page_table, last_pos,
                                 k_scale=k_scale, v_scale=v_scale, **kw)
