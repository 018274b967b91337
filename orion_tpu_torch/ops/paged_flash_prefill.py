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
says what bounds it and how the design answers. The dispatch is fixed by
q's dtype: bfloat16 q (bf16 or int8 pools) runs the tensor-core kernel,
float32 q the first version's CUDA-core kernel (the tensor cores would
take f32 as TF32, and the f32 parity drives hold K9 to 1e-4). The
tensor-core kernel splits a long history across blocks of ``SPLIT_PAGES``
pages; where a row's history spans more than one split, each split leaves
a float32 partial and the merge kernel (``paged_prefill_merge``, its own
launch counter and plain version ``paged_prefill_merge_plain``) combines
them in split order. ``walk_plan`` mirrors which keys a block walks. The
two pool branches count their launches apart (``paged_flash_prefill_cuda``
and ``paged_flash_prefill_int8_cuda``).

``paged_flash_prefill_plain`` is the JAX runner's xla body
(``infer/runner.py`` ``_prefill_layer`` with ``P_pre > 0``): gather the
prefix pages (dequantized to the chunk's dtype), concatenate the raw
chunk K/V, attend with explicit positions and segments, then scatter the
chunk's pages (quantized under int8). Padding query rows (past ``lens``)
hold garbage the caller discards, as in the JAX package. Both versions
update the pools IN PLACE and return ``(out, k_pool, v_pool[, k_scale,
v_scale])`` with the tensors they were given.

The JAX op's tensor-parallel form (K9 per head shard under
``shard_map``) needs no op of its own here: a serving rank holds only its
``n_heads / tp`` query heads and its ``n_kv_heads / tp`` heads of every
pool page, so its runner calls ``paged_flash_prefill`` on them.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from orion_tpu_torch.ops import _build
from orion_tpu_torch.ops.attention import FLASH_HEAD_DIMS, attention_plain
from orion_tpu_torch.ops.common import (
    TC_ROWS,
    check_dtype,
    check_pools,
    counted,
    on_cuda,
    q_tile,
    quantize_kv,
)
from orion_tpu_torch.ops.paged_attention import dequantize_pages

SMEM_BUDGET_BYTES = 232448   # dynamic shared memory a Hopper block may use
THREADS = 256                # threads per K9 block
SPLIT_PAGES = 16             # history pages per split of the tensor-core kernel
KEY_BLOCK = 32               # keys per step of the tensor-core kernel's walk


def prefill_smem_bytes(head_dim: int, page_size: int) -> int:
    """Shared memory of one block of the float32 kernel: the q block and
    one K page (float32, rows padded by one), one V page, the page's
    logits and its scales."""
    H, psz = head_dim, page_size
    return 4 * (2 * psz * (H + 1) + psz * H + psz * (psz + 1) + 2 * psz)


def prefill_tc_smem_bytes(head_dim: int, quant: bool) -> int:
    """Shared memory of one block of the tensor-core kernel: TC_ROWS query
    rows and two ring stages of a key block of K and V, bf16 rows of H + 8
    (int8 pools: two raw int8 stages of rows H + 16 with their float32
    scales, and one bf16 tile). The page size does not enter."""
    H, kb = head_dim, KEY_BLOCK
    ld = H + 8
    if quant:
        return 2 * TC_ROWS * ld + 2 * 2 * kb * ld + 2 * 2 * kb * (H + 16) + 4 * 2 * 2 * kb
    return 2 * TC_ROWS * ld + 2 * 2 * 2 * kb * ld


def n_splits(n_prefix_pages: int, split_pages: int = SPLIT_PAGES) -> int:
    """History splits in the tensor-core kernel's grid (at least one)."""
    return max(1, -(-int(n_prefix_pages) // split_pages))


def active_splits(start: int, *, page_size: int, n_prefix_pages: int,
                  split_pages: int = SPLIT_PAGES) -> int:
    """Splits of a row resuming at ``start`` that hold work: one per
    ``split_pages`` history pages, at least one (split 0 also attends the
    chunk). With one, the kernel writes the row's output itself; with
    more, the merge combines their partials. As the kernel computes it."""
    n_hist = min(int(n_prefix_pages), int(start) // page_size)
    return max(1, -(-n_hist // split_pages))


def walk_plan(start: int, qlen: int, q0: int, split: int, *, tq: int, page_size: int,
              n_prefix_pages: int, window: Optional[int] = None,
              split_pages: int = SPLIT_PAGES):
    """The key blocks one tensor-core block walks, as the kernel computes
    them: the block of queries [q0, q0 + tq) of a row resuming at
    ``start`` with ``qlen`` real chunk tokens, history split ``split``.
    Returns ((h0, h1), (c0, c1)): history key blocks h0 <= kb < h1 (keys
    kb * KEY_BLOCK + r, those >= n_hist * page_size masked and not read)
    and chunk key blocks c0 <= kb < c1 (chunk-local keys)."""
    kb = KEY_BLOCK
    n_hkeys = min(int(n_prefix_pages), start // page_size) * page_size
    hist = chunk = (0, 0)
    if split >= active_splits(start, page_size=page_size, n_prefix_pages=n_prefix_pages,
                              split_pages=split_pages) or q0 >= qlen:
        return hist, chunk
    lo = split * split_pages * page_size
    hi = min(n_hkeys, (split + 1) * split_pages * page_size)
    if window:
        lo = max(lo, start + q0 - window + 1)
    if lo < hi:
        hist = (lo // kb, -(-hi // kb))
    if split == 0:
        clo = max(0, q0 - window + 1) if window else 0
        chi = min(q0 + tq, qlen)
        if clo < chi:
            chunk = (clo // kb, -(-chi // kb))
    return hist, chunk


def check_prefill_fit(
    *,
    n_heads: int,
    n_kv_heads: int,
    head_dim: int,
    page_size: int,
    dtype: Optional[torch.dtype] = None,
) -> None:
    """Reject a shape K9 cannot run at — the engine calls it at
    construction with its activation dtype, so a bad
    ``inference.page_size`` is a config error and not a failed launch
    mid-serve. ``dtype`` None checks both kernels.

    bfloat16 (the tensor-core kernel): head_dim in FLASH_HEAD_DIMS, page
    sizes powers of two in [16, 128], at most TC_ROWS query heads per kv
    head, and ``prefill_tc_smem_bytes`` (both pool branches) within the
    budget; the page size does not enter the carve-up.
    float32 (the CUDA-core kernel): the block holds a page of queries and
    a page of keys and values in shared memory and H * psz / 256 output
    accumulators per thread (a query row's 256 / psz threads reduce with
    warp shuffles); shared memory is float32 in every pool branch."""
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
    if dtype in (None, torch.bfloat16):
        q_tile(n_heads // n_kv_heads)
        need = max(prefill_tc_smem_bytes(H, quant) for quant in (False, True))
        if need > SMEM_BUDGET_BYTES:
            raise ValueError(
                f"paged-flash prefill (bf16) at head_dim={H} needs {need} bytes of "
                f"shared memory (budget {SMEM_BUDGET_BYTES})"
            )
    if dtype in (None, torch.float32):
        need = prefill_smem_bytes(H, psz)
        max_acc = H // 4 if H >= 128 else H // 2
        if need > SMEM_BUDGET_BYTES or H * psz // THREADS > max_acc:
            raise ValueError(
                f"paged-flash prefill (float32) at page_size={psz}, head_dim={H} "
                f"needs {need} bytes of shared memory and {H * psz // THREADS} "
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


def paged_prefill_merge_plain(o_part, ml_part, start, out, *, n_prefix_pages, page_size,
                              split_pages=SPLIT_PAGES):
    """The plain version of the merge: for every row whose history spans
    more than one split (``active_splits``), out[b] = sum_s w_s O_s /
    sum_s w_s l_s with w_s = exp(m_s - max_s m_s), over the row's active
    splits of the float32 partials ``o_part`` [n_splits, B, S, N, H] and
    ``ml_part`` [n_splits, B, S, N, 2] (m, l); 0 where the sum of l is 0.
    Other rows of ``out`` [B, S, N, H] are left as they are. Updates and
    returns ``out``."""
    for b, st in enumerate(start.tolist()):
        n = active_splits(st, page_size=page_size, n_prefix_pages=n_prefix_pages,
                          split_pages=split_pages)
        if n == 1:
            continue
        m, l = ml_part[:n, b, ..., 0], ml_part[:n, b, ..., 1]
        w = torch.exp(m - m.amax(dim=0))
        den = (l * w).sum(dim=0)
        num = (o_part[:n, b] * w[..., None]).sum(dim=0)   # 0 where den is 0
        out[b] = (num / torch.where(den > 0, den, 1.0)[..., None]).to(out.dtype)
    return out


@counted
def paged_prefill_merge_cuda(o_part, ml_part, start, out, *, n_prefix_pages, page_size,
                             split_pages=SPLIT_PAGES):
    """Launch the merge kernel on CUDA tensors; arguments and result as
    paged_prefill_merge_plain's (``out`` bfloat16)."""
    n_sp, B, S, N, H = o_part.shape
    if (ml_part.shape != (n_sp, B, S, N, 2) or out.shape != (B, S, N, H)
            or out.dtype != torch.bfloat16 or start.dtype != torch.int32
            or not all(t.is_contiguous() for t in (o_part, ml_part, out, start))):
        raise ValueError("merge: o_part [n, B, S, N, H] and ml_part [n, B, S, N, 2] "
                         "float32, start int32 [B], out bfloat16 [B, S, N, H], contiguous")
    rc = _build.entry(
        "paged_prefill", "paged_prefill_merge",
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p],
    )(o_part.data_ptr(), ml_part.data_ptr(), start.data_ptr(), out.data_ptr(),
      B, S, N, H, page_size, int(n_prefix_pages), split_pages,
      torch.cuda.current_stream(out.device).cuda_stream)
    _build.check(rc, "paged_prefill_merge")
    paged_prefill_merge_cuda.launches += 1
    return out


def paged_prefill_merge(o_part, ml_part, start, out, **kw):
    """The merge of the tensor-core K9's split partials: CUDA tensors go to
    the kernel, CPU tensors to the plain version."""
    if on_cuda(o_part, ml_part, start, out):
        return paged_prefill_merge_cuda(o_part, ml_part, start, out, **kw)
    return paged_prefill_merge_plain(o_part, ml_part, start, out, **kw)


def _launch(q, k_pool, v_pool, walk, start, lens, k_new, v_new, *, n_prefix_pages,
            layer_base, logit_softcap, window, k_scale, v_scale):
    """Validate and launch K9 (either branch); returns the output."""
    check_dtype("q", q)
    B, S, N, H = q.shape
    K, psz = k_pool.shape[1], k_pool.shape[2]
    quant = k_scale is not None
    P_pre = int(n_prefix_pages)
    check_pools(q, k_pool, v_pool, k_scale, v_scale)
    check_prefill_fit(n_heads=N, n_kv_heads=K, head_dim=H, page_size=psz, dtype=q.dtype)
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
    bf16 = q.dtype == torch.bfloat16
    n_sp = n_splits(P_pre) if bf16 else 1
    o_part = ml_part = None
    if n_sp > 1:   # float32 partials of rows whose history spans several splits
        o_part = torch.empty(n_sp, B, S, N, H, dtype=torch.float32, device=q.device)
        ml_part = torch.empty(n_sp, B, S, N, 2, dtype=torch.float32, device=q.device)
    ptr = lambda t: t.data_ptr() if t is not None else None  # noqa: E731
    rc = _build.entry(
        "paged_prefill", "paged_prefill",
        [ctypes.c_void_p] * 13 + [ctypes.c_int] * 9
        + [ctypes.c_longlong, ctypes.c_int, ctypes.c_float, ctypes.c_float]
        + [ctypes.c_int] * 5 + [ctypes.c_void_p],
    )(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), ptr(k_scale), ptr(v_scale),
        k_new.data_ptr(), v_new.data_ptr(), walk.data_ptr(), start.data_ptr(),
        lens.data_ptr(), out.data_ptr(), ptr(o_part), ptr(ml_part),
        B, S, N, K, H, psz, P_pre, NC, k_scale.shape[2] if quant else 0,
        int(layer_base), int(window or 0), float(logit_softcap or 0.0), float(H ** -0.5),
        1 if bf16 else 0, int(quant), SPLIT_PAGES, n_sp, q_tile(N // K) if bf16 else 0,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(rc, "paged_prefill")
    if n_sp > 1:
        paged_prefill_merge(o_part, ml_part, start, out, n_prefix_pages=P_pre,
                            page_size=psz)
    return out


@counted
def paged_flash_prefill_cuda(
    q, k_pool, v_pool, walk, start, lens, k_new, v_new, *, n_prefix_pages,
    layer_base=0, logit_softcap=None, window=None,
):
    """Launch K9 on CUDA tensors over bf16/f32 pools (bf16: the
    tensor-core kernel, then the merge where a row's history spans
    several splits; f32: the CUDA-core kernel); arguments as
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
    scale pools (bf16 q: the tensor-core kernel and the merge; f32 q: the
    CUDA-core kernel); arguments and returns as
    paged_flash_prefill_plain's."""
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
