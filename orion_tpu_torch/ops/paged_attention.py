"""Paged decode attention, KV write fused in, as a CUDA kernel (K4).

One query token per slot attends that slot's pages of the flat
[L*num_pages, K, psz, H] pool (rows ``layer_base + page_table[b, :]``),
after the token's own K/V is written at row ``layer_base +
page_table[b, last_pos // psz]``, column ``last_pos % psz``.

K4 (``csrc/paged_decode.cu``) replaces the TPU kernel
``orion_tpu/ops/pallas/paged_attention.py::_kernel`` for bf16/f32 pools;
its source note says what bounds it and how the design answers. The int8
pool branch of the TPU kernel waits for the KV-quantization slice.

``paged_attention_plain`` mirrors the JAX runner's xla decode branch
(``infer/runner.py`` ``_decode_layer``): scatter the new token's K/V into
the pool, gather every page of the slot's table into a padded
[B, P*psz, K, H] context, and run masked attention. Both versions update
the pools IN PLACE (the JAX package returns fresh arrays; the port saves
the pool copy) and return ``(out, k_pool, v_pool)`` with the same pool
tensors they were given.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from orion_tpu_torch.ops import _build
from orion_tpu_torch.ops.attention import FLASH_HEAD_DIMS, attention_plain
from orion_tpu_torch.ops.common import check_dtype, counted, on_cuda


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
):
    B = q.shape[0]
    K, psz, H = k_pool.shape[1], k_pool.shape[2], k_pool.shape[3]
    P = page_table.shape[1]
    pt = page_table.long()
    lp = last_pos.long()
    if k_new is not None:
        rows = layer_base + pt[torch.arange(B, device=q.device), lp // psz]
        off = lp % psz
        k_pool[rows, :, off] = k_new.to(k_pool.dtype)
        v_pool[rows, :, off] = v_new.to(v_pool.dtype)
    # [B, P, K, psz, H] -> [B, P*psz, K, H] padded-context gather.
    k_ctx = k_pool[layer_base + pt].permute(0, 1, 3, 2, 4).reshape(B, P * psz, K, H)
    v_ctx = v_pool[layer_base + pt].permute(0, 1, 3, 2, 4).reshape(B, P * psz, K, H)
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
    return out, k_pool, v_pool


@counted
def paged_attention_cuda(
    q, k_pool, v_pool, page_table, last_pos, *, layer_base=0, k_new=None,
    v_new=None, logit_softcap=None, window=None,
):
    """Launch K4 on CUDA tensors; arguments as paged_attention_plain."""
    check_dtype("q", q)
    B, N, H = q.shape
    rows, K, psz, Hp = k_pool.shape
    if Hp != H or v_pool.shape != k_pool.shape:
        raise ValueError(f"pool shapes {tuple(k_pool.shape)}, "
                         f"{tuple(v_pool.shape)} do not match q {tuple(q.shape)}")
    if k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
        raise TypeError("pools must share q's dtype (int8 pools are not ported)")
    if not (k_pool.is_contiguous() and v_pool.is_contiguous()):
        raise ValueError("pools must be contiguous (they are updated in place)")
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
    rc = _build.entry(
        "paged_decode", "paged_decode",
        [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
        + [ctypes.c_longlong, ctypes.c_int, ctypes.c_float, ctypes.c_float,
           ctypes.c_int, ctypes.c_void_p],
    )(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        k_new.data_ptr() if k_new is not None else None,
        v_new.data_ptr() if v_new is not None else None,
        pt.data_ptr(), lp.data_ptr(), out.data_ptr(),
        B, N, K, H, psz, pt.shape[1], int(layer_base), int(window or 0),
        float(logit_softcap or 0.0), float(H ** -0.5),
        1 if q.dtype == torch.bfloat16 else 0,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(rc, "paged_decode")
    paged_attention_cuda.launches += 1
    if k_new is None:
        return out
    return out, k_pool, v_pool


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
):
    """Decode attention over the paged pool. Returns [B, N, H] when
    ``k_new``/``v_new`` are None, else ``(out, k_pool, v_pool)`` with the
    new token's K/V written in place. CUDA tensors go to K4, CPU tensors to
    the plain version."""
    kw = dict(layer_base=layer_base, k_new=k_new, v_new=v_new,
              logit_softcap=logit_softcap, window=window)
    if on_cuda(q, k_pool, v_pool, page_table, last_pos):
        return paged_attention_cuda(q, k_pool, v_pool, page_table, last_pos, **kw)
    return paged_attention_plain(q, k_pool, v_pool, page_table, last_pos, **kw)
