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

The dispatch is fixed by q's dtype: bfloat16 q (bf16 or int8 pools) runs
the tensor-core kernel, float32 q the first version's CUDA-core kernel
(the tensor cores would take f32 as TF32, and the f32 parity drives hold
K4 to 1e-4). The tensor-core kernel splits a slot's page walk into blocks
of ``DECODE_SPLIT_PAGES`` pages across the grid, as many as the page
table's width needs (``decode_n_splits``: shapes only, the host never
reads ``last_pos``); a slot whose walk spans more than one split
(``decode_active_splits``) leaves a float32 partial per split, which the
merge kernel (``paged_decode_merge_cuda``, its own launch counter, and
its plain version ``paged_decode_merge_plain``) combines in split order.

``paged_attention_plain`` mirrors the JAX runner's xla decode branch
(``infer/runner.py`` ``_decode_layer``): scatter the new token's K/V
(quantized under int8) into the pool, gather every page of the slot's
table into a padded [B, P*psz, K, H] context (dequantized to q's dtype
under int8), and run masked attention. Both versions update the pools IN
PLACE (the JAX package returns fresh arrays; the port saves the pool
copy) and return ``(out, k_pool, v_pool[, k_scale, v_scale])`` with the
tensors they were given.

The JAX op's tensor-parallel form (K4 per head shard under
``shard_map``) needs no op of its own here: a serving rank holds only its
``n_heads / tp`` query heads and its ``n_kv_heads / tp`` heads of every
pool page, so its runner calls ``paged_attention`` on them (the page walk
and the GQA group are the same on every rank).
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


# Pages per split of the tensor-core kernel's walk: csrc/paged_decode.cu's
# SPLIT_PAGES, which refuses a grid of any other width.
DECODE_SPLIT_PAGES = 8


def decode_n_splits(n_pages: int, split_pages: int = DECODE_SPLIT_PAGES) -> int:
    """Splits in the tensor-core kernel's grid for a page table of
    ``n_pages`` columns (at least one): from the shape alone."""
    return max(1, -(-int(n_pages) // split_pages))


def decode_active_splits(last_pos: int, *, page_size: int, window: Optional[int] = None,
                         split_pages: int = DECODE_SPLIT_PAGES) -> range:
    """The splits of a slot at ``last_pos`` that hold work, as the kernel
    computes them: from the split of the window's first kept position
    (0 without a window) to the split of ``last_pos``, which owns page
    ``last_pos // page_size`` and writes the new token. With one, the
    kernel writes the slot's output itself; with more, the merge combines
    their partials."""
    keys = split_pages * page_size
    lo = max(0, last_pos - window + 1) if window else 0
    return range(lo // keys, last_pos // keys + 1)


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


def paged_decode_merge_plain(o_part, ml_part, last_pos, out, *, page_size, window=None,
                             split_pages=DECODE_SPLIT_PAGES):
    """The plain version of the merge: for every slot whose walk spans
    more than one split (``decode_active_splits``), out[b] = sum_s w_s O_s
    / sum_s w_s l_s with w_s = exp(m_s - max_s m_s), over the slot's
    active splits, in split order, of the float32 partials ``o_part``
    [n_splits, B, N, H] and ``ml_part`` [n_splits, B, N, 2] (m, l); 0
    where the sum of l is 0. Other slots of ``out`` [B, N, H] are left as
    they are. Updates and returns ``out``."""
    for b, lp in enumerate(last_pos.tolist()):
        sp = decode_active_splits(lp, page_size=page_size, window=window,
                                  split_pages=split_pages)
        if len(sp) == 1:
            continue
        m, l = ml_part[sp.start:sp.stop, b, :, 0], ml_part[sp.start:sp.stop, b, :, 1]
        w = torch.exp(m - m.amax(dim=0))
        den = (l * w).sum(dim=0)
        num = (o_part[sp.start:sp.stop, b] * w[..., None]).sum(dim=0)   # 0 where den is 0
        out[b] = (num / torch.where(den > 0, den, 1.0)[..., None]).to(out.dtype)
    return out


@counted
def paged_decode_merge_cuda(o_part, ml_part, last_pos, out, *, page_size, window=None):
    """Launch the merge kernel on CUDA tensors; arguments and result as
    paged_decode_merge_plain's at the kernel's split size (``out``
    bfloat16)."""
    n_sp, B, N, H = o_part.shape
    if (ml_part.shape != (n_sp, B, N, 2) or out.shape != (B, N, H)
            or out.dtype != torch.bfloat16 or last_pos.dtype != torch.int32
            or not all(t.is_contiguous() for t in (o_part, ml_part, out, last_pos))):
        raise ValueError("merge: o_part [n, B, N, H] and ml_part [n, B, N, 2] float32, "
                         "last_pos int32 [B], out bfloat16 [B, N, H], contiguous")
    rc = _build.entry(
        "paged_decode", "paged_decode_merge",
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p],
    )(o_part.data_ptr(), ml_part.data_ptr(), last_pos.data_ptr(), out.data_ptr(),
      B, N, H, page_size, int(window or 0),
      torch.cuda.current_stream(out.device).cuda_stream)
    _build.check(rc, "paged_decode_merge")
    paged_decode_merge_cuda.launches += 1
    return out


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
    P = pt.shape[1]
    bf16 = q.dtype == torch.bfloat16
    n_sp = decode_n_splits(P) if bf16 else 1
    o_part = ml_part = None
    if n_sp > 1:   # float32 partials of slots whose walk spans several splits
        o_part = torch.empty(n_sp, B, N, H, dtype=torch.float32, device=q.device)
        ml_part = torch.empty(n_sp, B, N, 2, dtype=torch.float32, device=q.device)
    ptr = lambda t: t.data_ptr() if t is not None else None  # noqa: E731
    rc = _build.entry(
        "paged_decode", "paged_decode",
        [ctypes.c_void_p] * 12 + [ctypes.c_int] * 7
        + [ctypes.c_longlong, ctypes.c_int, ctypes.c_float, ctypes.c_float]
        + [ctypes.c_int] * 3 + [ctypes.c_void_p],
    )(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), ptr(k_scale), ptr(v_scale),
        ptr(k_new), ptr(v_new), pt.data_ptr(), lp.data_ptr(), out.data_ptr(),
        ptr(o_part), ptr(ml_part), B, N, K, H, psz, P, k_scale.shape[2] if quant else 0,
        int(layer_base), int(window or 0), float(logit_softcap or 0.0), float(H ** -0.5),
        1 if bf16 else 0, int(quant), n_sp,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(rc, "paged_decode")
    if n_sp > 1:
        paged_decode_merge_cuda(o_part, ml_part, lp, out, page_size=psz, window=window)
    return out


@counted
def paged_attention_cuda(
    q, k_pool, v_pool, page_table, last_pos, *, layer_base=0, k_new=None,
    v_new=None, logit_softcap=None, window=None,
):
    """Launch K4 on CUDA tensors over bf16/f32 pools (bf16: the
    tensor-core kernel, then the merge where the table spans several
    splits; f32: the CUDA-core kernel); arguments as
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
    scale pools (bf16 q: the tensor-core kernel and the merge; f32 q: the
    CUDA-core kernel); arguments and returns as paged_attention_plain's."""
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
