"""Ragged paged attention for speculative verification, the W new tokens'
K/V written in place, as a CUDA kernel (K10).

Row b holds ``lens[b]`` real queries at write positions ``start[b] + j``
(j < W). First the real tokens' K/V go into the flat [L*num_pages, K, psz,
H] pool at row ``layer_base + page_table[b, pos // psz]``, column ``pos %
psz``, for ``pos <= last = min(start + lens - 1, P * psz - 1)``; under int8
pools (``k_scale``/``v_scale``) they are quantized with ``quantize_kv``'s
bits and their scales land in column ``pos % psz`` of the scale pools.
Then each query attends the pool, its own drafts included, read back from
the pool (dequantized under int8, exactly as a later decode reads them):

  - chain: query w attends ``kv_pos <= start + w`` (and ``>= start + w -
    window + 1`` under a window);
  - tree (``tree_mask``/``depths`` given, W <= 31): committed context
    ``kv_pos < start`` is visible to every query; new slot i is visible
    iff bit i of the query's word is set, or i == w. Under a window new
    slots are windowed by depth distance and the context by ``start +
    depth``. RoPE positions ``start + depths`` are the caller's business.

Padding queries (j >= lens) compute rows the caller discards; padding
tokens write nothing in the kernel, while the plain version parks them on
scratch page 0 (as the JAX runner's xla branch does). Both leave every
other page untouched.

K10 (``csrc/ragged_verify.cu``) replaces the TPU kernel
``orion_tpu/ops/pallas/ragged_paged_attention.py::_kernel`` in both pool
branches, chain and tree; its source note says what bounds it and how the
design answers. The branches count their launches apart
(``ragged_verify_cuda`` and ``ragged_verify_int8_cuda``).

The dispatch is fixed by q's dtype: bfloat16 q (bf16 or int8 pools) runs
the tensor-core kernel, float32 q the first version's CUDA-core kernel
(the f32 parity drives hold K10 to 1e-4). The tensor-core kernel splits a
slot's page walk into blocks of ``VERIFY_SPLIT_PAGES`` pages across the
grid, as many as the page table's width needs (``verify_n_splits``: shapes
only, the host never reads ``start`` or ``lens``); a slot whose walk spans
more than one split (``verify_active_splits``) leaves a float32 partial per
split for every query row, which the merge kernel
(``ragged_verify_merge_cuda``, its own launch counter, and its plain
version ``ragged_verify_merge_plain``) combines in split order. Each slot
needs ``lens >= 1`` (pad rows carry one query).

``ragged_paged_attention_plain`` is the JAX runner's xla verify body
(``infer/runner.py`` ``_verify_layer``): scatter all W tokens (quantized
under int8, padding onto page 0), gather the padded context (dequantized
into q's dtype under int8), mask per query, attend. Both versions update
the pools IN PLACE and return ``(out, k_pool, v_pool[, k_scale,
v_scale])`` with the tensors they were given.

The JAX op's tensor-parallel form (K10 per head shard under
``shard_map``) needs no op of its own here: a serving rank holds only its
``n_heads / tp`` query heads and its ``n_kv_heads / tp`` heads of every
pool page (``infer/kv_cache.py``), so its runner calls
``ragged_paged_attention`` on them.
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
MAX_TREE_WIDTH = 31          # ancestor words are int32
# Pages per split of the tensor-core kernel's walk: csrc/ragged_verify.cu's
# SPLIT_PAGES, which refuses a grid of any other width.
VERIFY_SPLIT_PAGES = 8


def verify_n_splits(n_pages: int, split_pages: int = VERIFY_SPLIT_PAGES) -> int:
    """Splits in the tensor-core kernel's grid for a page table of
    ``n_pages`` columns (at least one): from the shape alone."""
    return max(1, -(-int(n_pages) // split_pages))


def verify_active_splits(start: int, lens: int, *, page_size: int, n_pages: int,
                         window: Optional[int] = None,
                         split_pages: int = VERIFY_SPLIT_PAGES) -> range:
    """The splits of a slot that hold work, as the kernel computes them:
    from the split of the walk's first position ``max(0, start - window +
    1)`` (0 without a window: the earliest position any query may see,
    chain or tree) to the split of the last written position ``min(start
    + lens - 1, n_pages * page_size - 1)``. With one, the kernel writes
    the slot's output itself; with more, the merge combines their
    partials. The range is the slot's, never a query's: under a tree with
    a window, query w's context opens at ``start + depth(w) - window +
    1``, before ``start + w - window + 1``."""
    keys = split_pages * page_size
    last = min(start + lens - 1, n_pages * page_size - 1)
    lo = max(0, start - window + 1) if window else 0
    return range(lo // keys, last // keys + 1)


def verify_smem_bytes(W: int, *, n_heads: int, n_kv_heads: int, head_dim: int,
                      page_size: int) -> int:
    """Shared memory of one block of the float32 K10 kernel (one slot, one
    kv head): the W*G query rows and their output accumulators, one K page
    (rows padded by one) and one V page, the page's logits, the per-row
    softmax state, the page's scales and the tree words/depths. All
    float32 whatever the pool dtype, so the pool branch does not enter.
    (The bf16 kernel's shared memory does not grow with W; static_asserts
    in the source hold it.)"""
    R = W * (n_heads // n_kv_heads)
    H, psz = head_dim, page_size
    return 4 * (2 * R * H + psz * (2 * H + 1) + R * psz + 3 * R + 2 * psz + 2 * W)


def check_verify_fit(W: int, *, n_heads: int, n_kv_heads: int, head_dim: int,
                     page_size: int, dtype=torch.float32) -> None:
    """Reject a verify width K10 cannot run at, for a model of ``dtype``
    (a torch dtype or its name). float32 (the default, the stricter) and
    any dtype but bfloat16: the CUDA-core kernel's block holds all W*G
    query rows of a kv head and their accumulators in shared memory,
    within the 227 KB a Hopper block may use. bfloat16: the tensor-core
    kernel serves the rows in passes and its shared memory does not grow
    with W, so any W >= 1 runs (every W float32 admits included). The
    engine calls it at construction
    whenever inference.speculative is on, so a too-wide
    ``inference.speculate_tokens`` is a config error and not a failed
    launch mid-serve."""
    H, psz = head_dim, page_size
    bf16 = dtype in (torch.bfloat16, "bfloat16")
    if n_heads % n_kv_heads:
        raise ValueError(f"n_heads={n_heads} not a multiple of n_kv_heads={n_kv_heads}")
    if H not in FLASH_HEAD_DIMS:
        raise ValueError(f"ragged verify needs head_dim in {FLASH_HEAD_DIMS}, got {H}")
    need = verify_smem_bytes(W, n_heads=n_heads, n_kv_heads=n_kv_heads,
                             head_dim=H, page_size=psz)
    if W < 1 or (not bf16 and need > SMEM_BUDGET_BYTES):
        raise ValueError(
            f"speculative verify width W={W} (inference.speculate_tokens={W - 1}) "
            f"at head_dim={H}, page_size={psz} and {n_heads // n_kv_heads} query "
            f"heads per kv head needs {need} bytes of shared memory per K10 "
            f"block, over the {SMEM_BUDGET_BYTES} a Hopper block may use; lower "
            f"inference.speculate_tokens"
        )


def verify_mask(start: torch.Tensor, W: int, T: int, *, window: Optional[int] = None,
                tree_mask: Optional[torch.Tensor] = None,
                depths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Boolean [B, W, T] attend mask of W verify queries over pool
    positions 0..T-1: the chain mask, or the tree mask under
    ``tree_mask``/``depths`` (the JAX runner's ``_verify_ctx`` and
    ``_verify_layer`` masks)."""
    dev = start.device
    start = start.long()[:, None, None]                      # [B, 1, 1]
    kv = torch.arange(T, device=dev)[None, None, :]          # [1, 1, T]
    steps = torch.arange(W, device=dev)
    if tree_mask is None:
        q_pos = start + steps[None, :, None]                 # [B, W, 1]
        mask = kv <= q_pos
        if window is not None:
            mask = mask & (kv >= q_pos - window + 1)
        return mask
    B = start.shape[0]
    slot = kv - start                                        # [B, 1, T]
    in_new = (slot >= 0) & (slot < W)
    slot_c = slot.clamp(0, W - 1)
    anc = ((tree_mask.long()[:, :, None] >> steps[None, None, :]) & 1).bool()
    anc = anc | torch.eye(W, dtype=torch.bool, device=dev)[None]   # [B, W(q), W(kv)]
    vis = torch.gather(anc, 2, slot_c.expand(B, W, T))
    mask = torch.where(in_new, vis, kv < start)
    if window is not None:
        dep = depths.long()
        sdep = torch.gather(dep[:, None, :], 2, slot_c)      # [B, 1, T]
        qdep = dep[:, :, None]                               # [B, W, 1]
        mask = mask & torch.where(in_new, sdep >= qdep - window + 1,
                                  kv >= start + qdep - window + 1)
    return mask


def ragged_paged_attention_plain(
    q: torch.Tensor,            # [B, W, N, H] the W new positions' queries
    k_pool: torch.Tensor,       # [rows, K, psz, H]
    v_pool: torch.Tensor,
    page_table: torch.Tensor,   # [B, P] int32, per-layer-relative page ids
    start: torch.Tensor,        # [B] int32, first new position
    lens: torch.Tensor,         # [B] int32, real queries (1..W)
    *,
    layer_base: int = 0,
    k_new: Optional[torch.Tensor] = None,    # [B, W, K, H]
    v_new: Optional[torch.Tensor] = None,
    logit_softcap: Optional[float] = None,
    window: Optional[int] = None,
    k_scale: Optional[torch.Tensor] = None,  # [rows, K, SW] float32 (int8 pools)
    v_scale: Optional[torch.Tensor] = None,
    tree_mask: Optional[torch.Tensor] = None,  # [B, W] int32 ancestor words
    depths: Optional[torch.Tensor] = None,     # [B, W] int32 tree depths
):
    B, W, N, H = q.shape
    K, psz = k_pool.shape[1], k_pool.shape[2]
    P = page_table.shape[1]
    dev = q.device
    pt = page_table.long()
    start = start.long()
    quant = k_scale is not None
    if window is not None and window < 1:
        raise ValueError(f"window={window} must be >= 1")
    if k_new is not None:
        steps = torch.arange(W, device=dev)[None, :]
        pos = start[:, None] + steps                                   # [B, W]
        last = torch.clamp(start + lens.long() - 1, max=P * psz - 1)
        valid = (steps < lens.long()[:, None]) & (pos <= last[:, None])
        wp = pos.clamp(max=P * psz - 1)
        page = torch.where(valid, pt.gather(1, wp // psz), torch.zeros_like(wp))
        rows, off = layer_base + page, wp % psz
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
    # [B, P, K, psz, H] -> [B, P*psz, K, H] padded-context gather: the
    # drafts just written read back out of the pool (dequantized under int8).
    k_pg, v_pg = k_pool[layer_base + pt], v_pool[layer_base + pt]
    if quant:
        k_pg = dequantize_pages(k_pg, k_scale[layer_base + pt], q.dtype)
        v_pg = dequantize_pages(v_pg, v_scale[layer_base + pt], q.dtype)
    k_ctx = k_pg.permute(0, 1, 3, 2, 4).reshape(B, P * psz, K, H)
    v_ctx = v_pg.permute(0, 1, 3, 2, 4).reshape(B, P * psz, K, H)
    mask = verify_mask(start, W, P * psz, window=window, tree_mask=tree_mask,
                       depths=depths)
    out = attention_plain(q, k_ctx.to(q.dtype), v_ctx.to(q.dtype), causal=False,
                          mask=mask, logit_softcap=logit_softcap)
    if k_new is None:
        return out
    if quant:
        return out, k_pool, v_pool, k_scale, v_scale
    return out, k_pool, v_pool


def ragged_verify_merge_plain(o_part, ml_part, start, lens, out, *, page_size, n_pages,
                              window=None, split_pages=VERIFY_SPLIT_PAGES):
    """The plain version of the merge: for every slot whose walk spans
    more than one split (``verify_active_splits``), out[b] = sum_s w_s O_s
    / sum_s w_s l_s with w_s = exp(m_s - max_s m_s), over the slot's
    active splits, in split order, of the float32 partials ``o_part``
    [n_splits, B, W, N, H] and ``ml_part`` [n_splits, B, W, N, 2] (m, l);
    0 where the sum of l is 0. Other slots of ``out`` [B, W, N, H] are
    left as they are. Updates and returns ``out``."""
    for b, (st, n) in enumerate(zip(start.tolist(), lens.tolist())):
        sp = verify_active_splits(st, n, page_size=page_size, n_pages=n_pages, window=window,
                                  split_pages=split_pages)
        if len(sp) == 1:
            continue
        m, l = ml_part[sp.start:sp.stop, b, ..., 0], ml_part[sp.start:sp.stop, b, ..., 1]
        w = torch.exp(m - m.amax(dim=0))
        den = (l * w).sum(dim=0)
        num = (o_part[sp.start:sp.stop, b] * w[..., None]).sum(dim=0)   # 0 where den is 0
        out[b] = (num / torch.where(den > 0, den, 1.0)[..., None]).to(out.dtype)
    return out


@counted
def ragged_verify_merge_cuda(o_part, ml_part, start, lens, out, *, page_size, n_pages,
                             window=None):
    """Launch the merge kernel on CUDA tensors; arguments and result as
    ragged_verify_merge_plain's at the kernel's split size (``out``
    bfloat16)."""
    n_sp, B, W, N, H = o_part.shape
    if (ml_part.shape != (n_sp, B, W, N, 2) or out.shape != (B, W, N, H)
            or out.dtype != torch.bfloat16 or o_part.dtype != torch.float32
            or ml_part.dtype != torch.float32
            or start.shape != (B,) or lens.shape != (B,)
            or start.dtype != torch.int32 or lens.dtype != torch.int32
            or not all(t.is_contiguous() for t in (o_part, ml_part, out, start, lens))):
        raise ValueError("merge: o_part [n, B, W, N, H] and ml_part [n, B, W, N, 2] float32, "
                         "start and lens int32 [B], out bfloat16 [B, W, N, H], contiguous")
    rc = _build.entry(
        "ragged_verify", "ragged_verify_merge",
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p],
    )(o_part.data_ptr(), ml_part.data_ptr(), start.data_ptr(), lens.data_ptr(),
      out.data_ptr(), B, W, N, H, page_size, int(n_pages), int(window or 0),
      torch.cuda.current_stream(out.device).cuda_stream)
    _build.check(rc, "ragged_verify_merge")
    ragged_verify_merge_cuda.launches += 1
    return out


def _launch(q, k_pool, v_pool, page_table, start, lens, *, layer_base, k_new, v_new,
            logit_softcap, window, k_scale, v_scale, tree_mask, depths):
    """Validate and launch K10 (either branch) and, where the bf16 walk
    spans several splits, its merge; returns the output."""
    check_dtype("q", q)
    B, W, N, H = q.shape
    K, psz = k_pool.shape[1], k_pool.shape[2]
    quant = k_scale is not None
    check_pools(q, k_pool, v_pool, k_scale, v_scale)
    check_verify_fit(W, n_heads=N, n_kv_heads=K, head_dim=H, page_size=psz, dtype=q.dtype)
    if page_table.dim() != 2 or page_table.shape[0] != B:
        raise ValueError("page_table must be [B, P]")
    if start.shape != (B,) or lens.shape != (B,):
        raise ValueError("start and lens must be [B]")
    if window is not None and window < 1:
        raise ValueError(f"window={window} must be >= 1")
    if (k_new is None) != (v_new is None):
        raise ValueError("k_new and v_new go together")
    if k_new is not None:
        if k_new.shape != (B, W, K, H) or v_new.shape != (B, W, K, H):
            raise ValueError("k_new/v_new must be [B, W, K, H]")
        k_new = k_new.to(q.dtype).contiguous()
        v_new = v_new.to(q.dtype).contiguous()
    if tree_mask is not None:
        if W > MAX_TREE_WIDTH:
            raise ValueError(f"tree verification packs the ancestor mask into int32 "
                             f"words: W={W} columns exceed {MAX_TREE_WIDTH}")
        if tree_mask.shape != (B, W) or depths.shape != (B, W):
            raise ValueError("tree_mask and depths must be [B, W]")
        tree_mask = tree_mask.to(torch.int32).contiguous()
        depths = depths.to(torch.int32).contiguous()
    q = q.contiguous()
    pt = page_table.to(torch.int32).contiguous()
    st = start.to(torch.int32).contiguous()
    ln = lens.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    P = pt.shape[1]
    bf16 = q.dtype == torch.bfloat16
    n_sp = verify_n_splits(P) if bf16 else 1
    o_part = ml_part = None
    if n_sp > 1:   # float32 partials of slots whose walk spans several splits
        o_part = torch.empty(n_sp, B, W, N, H, dtype=torch.float32, device=q.device)
        ml_part = torch.empty(n_sp, B, W, N, 2, dtype=torch.float32, device=q.device)
    ptr = lambda t: t.data_ptr() if t is not None else None  # noqa: E731
    rc = _build.entry(
        "ragged_verify", "ragged_verify",
        [ctypes.c_void_p] * 15 + [ctypes.c_int] * 8
        + [ctypes.c_longlong, ctypes.c_int, ctypes.c_float, ctypes.c_float]
        + [ctypes.c_int] * 3 + [ctypes.c_void_p],
    )(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), ptr(k_scale), ptr(v_scale),
        ptr(k_new), ptr(v_new), pt.data_ptr(), st.data_ptr(), ln.data_ptr(),
        ptr(tree_mask), ptr(depths), out.data_ptr(), ptr(o_part), ptr(ml_part),
        B, W, N, K, H, psz, P, k_scale.shape[2] if quant else 0,
        int(layer_base), int(window or 0), float(logit_softcap or 0.0), float(H ** -0.5),
        1 if bf16 else 0, int(quant), n_sp,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(rc, "ragged_verify")
    if n_sp > 1:
        ragged_verify_merge_cuda(o_part, ml_part, st, ln, out, page_size=psz, n_pages=P,
                                 window=window)
    return out


@counted
def ragged_verify_cuda(
    q, k_pool, v_pool, page_table, start, lens, *, layer_base=0, k_new=None,
    v_new=None, logit_softcap=None, window=None, tree_mask=None, depths=None,
):
    """Launch K10 on CUDA tensors over bf16/f32 pools (bf16: the
    tensor-core kernel, then the merge where the table spans several
    splits; f32: the CUDA-core kernel); arguments as
    ragged_paged_attention_plain."""
    out = _launch(q, k_pool, v_pool, page_table, start, lens, layer_base=layer_base,
                  k_new=k_new, v_new=v_new, logit_softcap=logit_softcap, window=window,
                  k_scale=None, v_scale=None, tree_mask=tree_mask, depths=depths)
    ragged_verify_cuda.launches += 1
    if k_new is None:
        return out
    return out, k_pool, v_pool


@counted
def ragged_verify_int8_cuda(
    q, k_pool, v_pool, page_table, start, lens, *, k_scale, v_scale, layer_base=0,
    k_new=None, v_new=None, logit_softcap=None, window=None, tree_mask=None,
    depths=None,
):
    """Launch K10's int8 branch on CUDA tensors: int8 pools with float32
    scale pools (bf16 q: the tensor-core kernel and the merge; f32 q: the
    CUDA-core kernel); arguments and returns as
    ragged_paged_attention_plain's."""
    out = _launch(q, k_pool, v_pool, page_table, start, lens, layer_base=layer_base,
                  k_new=k_new, v_new=v_new, logit_softcap=logit_softcap, window=window,
                  k_scale=k_scale, v_scale=v_scale, tree_mask=tree_mask, depths=depths)
    ragged_verify_int8_cuda.launches += 1
    if k_new is None:
        return out
    return out, k_pool, v_pool, k_scale, v_scale


def ragged_paged_attention(
    q: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    page_table: torch.Tensor,
    start: torch.Tensor,
    lens: torch.Tensor,
    *,
    layer_base: int = 0,
    k_new: Optional[torch.Tensor] = None,
    v_new: Optional[torch.Tensor] = None,
    logit_softcap: Optional[float] = None,
    window: Optional[int] = None,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
    tree_mask: Optional[torch.Tensor] = None,
    depths: Optional[torch.Tensor] = None,
):
    """W-query verify attention over the paged pool. Returns [B, W, N, H]
    when ``k_new``/``v_new`` are None, else ``(out, k_pool, v_pool)`` —
    plus ``(k_scale, v_scale)`` for int8 pools — with the real tokens' K/V
    written in place. CUDA tensors go to K10, CPU tensors to the plain
    version."""
    if (k_scale is None) != (v_scale is None):
        raise ValueError("k_scale and v_scale go together")
    if (tree_mask is None) != (depths is None):
        raise ValueError("tree_mask and depths must be given together")
    if tree_mask is not None and q.shape[1] > MAX_TREE_WIDTH:
        raise ValueError(f"tree verification packs the ancestor mask into int32 words: "
                         f"W={q.shape[1]} columns exceed {MAX_TREE_WIDTH}; lower "
                         f"inference.speculate_tokens")
    kw = dict(layer_base=layer_base, k_new=k_new, v_new=v_new,
              logit_softcap=logit_softcap, window=window, tree_mask=tree_mask,
              depths=depths)
    if on_cuda(q, k_pool, v_pool, page_table, start, lens):
        if k_scale is not None:
            return ragged_verify_int8_cuda(q, k_pool, v_pool, page_table, start, lens,
                                           k_scale=k_scale, v_scale=v_scale, **kw)
        return ragged_verify_cuda(q, k_pool, v_pool, page_table, start, lens, **kw)
    return ragged_paged_attention_plain(q, k_pool, v_pool, page_table, start, lens,
                                        k_scale=k_scale, v_scale=v_scale, **kw)
