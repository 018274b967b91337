"""Multi-head attention, with the flash forward (K3) and its backward (K7
dq, K8 dk/dv) as CUDA kernels.

``attention_plain`` is the counterpart of ``attention_xla``: grouped-query
attention with a float32 softmax, causal / segment / sliding-window masks
(or an explicit boolean mask) and logit soft-capping. One difference, on
purpose: a query row that attends nothing returns zeros, as every flash
kernel does (the xla path would average v over the masked logits). It
runs for CPU tensors, where autograd differentiates it, and
``chip_smoke.py`` holds K3, K7 and K8 against it (and its autograd) on
the card.

K3 (``csrc/flash_fwd.cu``) replaces the TPU kernel
``orion_tpu/ops/pallas/flash_attention.py::_fwd_kernel``; K7 and K8
(``csrc/flash_bwd.cu``) replace ``_dq_kernel`` and ``_dkv_kernel``; their
source notes say what bounds them and how the design answers. The
wrappers keep the JAX package's [B, S, N, H] layout: the kernels read and
write it directly, so no transpose or padding copy is made. They cover
causal + segment ids (+ seg_pad_zero tile skip) + q_offset + window +
softcap, and explicit per-token positions (``q_positions`` [B, Sq],
``kv_positions`` [B, Skv]: the causal and window tests compare
positions, not indices; the gather prefill body's layout, and the ring
and striped layouts of sequence parallelism): K3's branch (in bf16 a
split walk with a merge, ``ops/flash_pos.py``) and K7's and K8's
(``flash_dq_pos_cuda``, ``flash_dkv_pos_cuda``, counted apart; in bf16 at
head_dim 64 and 128 warp-specialised wgmma/TMA kernels walking a plan that
a pass per call writes into a scratch tensor the wrapper allocates,
``ops/flash_pos_bwd.py``; they take no seg_pad_zero, so the gradient path
with positions runs K3 without it too: real rows are the same). ``flash_attention_with_lse`` is the
counterpart of the JAX package's: (out, lse), differentiable in both,
the lse cotangent folded into K7's and K8's delta; sequence parallelism
merges its blocks through it. Explicit masks raise on the card.

The tensor-parallel form of the JAX op (``orion_tpu/ops/attention.py``,
K3 per head shard under ``shard_map``) needs no op of its own here: a
serving rank holds only its ``n_heads / tp`` query heads and
``n_kv_heads / tp`` kv heads, so its runner calls ``attention`` on them
(the engine raises the JAX engine's ValueError when tp divides the heads
not).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from orion_tpu_torch.ops import _build
from orion_tpu_torch.ops.common import NEG_INF, check_dtype, counted, on_cuda, q_tile
from orion_tpu_torch.ops.flash_pos import SPLIT_STEPS, flash_pos_merge_cuda, grid_splits
from orion_tpu_torch.ops.flash_pos_bwd import WG_HEAD_DIMS, plan_scratch_ints

FLASH_HEAD_DIMS = (16, 32, 64, 128, 256)


def _gqa_expand(k: torch.Tensor, n_heads: int) -> torch.Tensor:
    """[B, S, K, H] -> [B, S, N, H] by repeating each kv head N/K times."""
    n_kv = k.shape[2]
    if n_kv == n_heads:
        return k
    assert n_heads % n_kv == 0, (n_heads, n_kv)
    return k.repeat_interleave(n_heads // n_kv, dim=2)


def attention_mask(
    q_len: int,
    kv_len: int,
    *,
    causal: bool = True,
    q_offset: int = 0,
    q_segment_ids: Optional[torch.Tensor] = None,
    kv_segment_ids: Optional[torch.Tensor] = None,
    window: Optional[int] = None,
    device=None,
    q_positions: Optional[torch.Tensor] = None,
    kv_positions: Optional[torch.Tensor] = None,
) -> Optional[torch.Tensor]:
    """Boolean [.., q_len, kv_len] mask; True = attend.

    ``window`` keeps only 0 <= q_pos - kv_pos < window (requires causal).
    Positions are the token indices (+ q_offset for q) unless explicit
    per-token ``q_positions`` [.., q_len] / ``kv_positions`` [.., kv_len]
    are given.
    """
    if window is not None and (not causal or window < 1):
        raise ValueError(
            f"window={window} requires causal attention and window >= 1"
        )
    if device is None and q_segment_ids is not None:
        device = q_segment_ids.device
    mask = None
    if causal:
        q_pos = (q_positions.long() if q_positions is not None
                 else torch.arange(q_len, device=device) + q_offset)
        kv_pos = (kv_positions.long() if kv_positions is not None
                  else torch.arange(kv_len, device=device))
        dist = q_pos[..., :, None] - kv_pos[..., None, :]
        mask = dist >= 0
        if window is not None:
            mask = mask & (dist < window)
    if q_segment_ids is not None:
        seg = q_segment_ids[..., :, None] == kv_segment_ids[..., None, :]
        mask = seg if mask is None else (mask & seg)
    return mask


def _masked_logits(
    q, k, *, causal, mask, q_segment_ids, kv_segment_ids, logit_softcap,
    q_offset, window, q_positions=None, kv_positions=None,
):
    """float32 [B, N, Sq, Skv] logits (softcapped, NEG_INF where masked)
    and the broadcast boolean mask (None when nothing is masked)."""
    n_heads, head_dim = q.shape[2], q.shape[3]
    k = _gqa_expand(k, n_heads)
    if mask is not None and window is not None:
        raise ValueError(
            "window cannot combine with an explicit mask; fold the window "
            "into the mask or drop it"
        )
    scale = head_dim ** -0.5
    # float32 products and sums, as preferred_element_type=f32 in the JAX op.
    logits = torch.einsum("bqnh,bknh->bnqk", q.float(), k.float()) * scale
    if logit_softcap is not None:
        logits = logit_softcap * torch.tanh(logits / logit_softcap)
    if mask is None:
        mask = attention_mask(
            q.shape[1], k.shape[1], causal=causal, q_offset=q_offset,
            q_segment_ids=q_segment_ids, kv_segment_ids=kv_segment_ids,
            window=window, device=q.device, q_positions=q_positions,
            kv_positions=kv_positions,
        )
    if mask is not None:
        if mask.dim() == 2:
            mask = mask[None, None]
        elif mask.dim() == 3:
            mask = mask[:, None]
        logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    return logits, mask


def attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    mask: Optional[torch.Tensor] = None,
    q_segment_ids: Optional[torch.Tensor] = None,
    kv_segment_ids: Optional[torch.Tensor] = None,
    logit_softcap: Optional[float] = None,
    q_offset: int = 0,
    window: Optional[int] = None,
    q_positions: Optional[torch.Tensor] = None,
    kv_positions: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """q: [B, Sq, N, H]; k, v: [B, Skv, K, H] with N % K == 0 -> [B, Sq, N, H].
    With ``q_positions`` [B, Sq] and ``kv_positions`` [B, Skv] the causal
    and window tests compare those positions."""
    logits, mask = _masked_logits(
        q, k, causal=causal, mask=mask, q_segment_ids=q_segment_ids,
        kv_segment_ids=kv_segment_ids, logit_softcap=logit_softcap,
        q_offset=q_offset, window=window, q_positions=q_positions,
        kv_positions=kv_positions,
    )
    probs = torch.softmax(logits, dim=-1)
    if mask is not None:
        # A row that attends nothing returns 0, as the kernels do.
        probs = probs * mask.any(dim=-1, keepdim=True)
    v = _gqa_expand(v, q.shape[2])
    return torch.einsum("bnqk,bknh->bqnh", probs.to(q.dtype), v)


def attention_lse_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    *,
    causal: bool = True,
    q_segment_ids: Optional[torch.Tensor] = None,
    kv_segment_ids: Optional[torch.Tensor] = None,
    logit_softcap: Optional[float] = None,
    q_offset: int = 0,
    window: Optional[int] = None,
    q_positions: Optional[torch.Tensor] = None,
    kv_positions: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The plain version of K3's lse output: float32 [B, N, Sq], each
    row's log-sum-exp over its attended logits, NEG_INF where the row
    attends nothing. Positions as attention_plain's."""
    logits, mask = _masked_logits(
        q, k, causal=causal, mask=None, q_segment_ids=q_segment_ids,
        kv_segment_ids=kv_segment_ids, logit_softcap=logit_softcap,
        q_offset=q_offset, window=window, q_positions=q_positions,
        kv_positions=kv_positions,
    )
    lse = torch.logsumexp(logits, dim=-1)
    if mask is not None:
        lse = torch.where(mask.any(dim=-1), lse, torch.full_like(lse, NEG_INF))
    return lse


def _check_positions(q_positions, kv_positions, B, Sq, Skv):
    """The int32 contiguous positions (or None, None)."""
    if (q_positions is None) != (kv_positions is None):
        raise ValueError("q_positions and kv_positions go together")
    if q_positions is None:
        return None, None
    qpos = q_positions.to(torch.int32).contiguous()
    kpos = kv_positions.to(torch.int32).contiguous()
    if qpos.shape != (B, Sq) or kpos.shape != (B, Skv):
        raise ValueError(f"positions must be [B, Sq] = [{B}, {Sq}] and [B, Skv] = "
                         f"[{B}, {Skv}], got {tuple(qpos.shape)}, {tuple(kpos.shape)}")
    return qpos, kpos


def _check_args(q, k, v, q_segment_ids, kv_segment_ids, causal, window):
    """Validate a kernel call (K3, K7 or K8); returns the contiguous
    operands, the int32 segment ids (or None) and the shape
    (B, Sq, Skv, N, K, H)."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        check_dtype(name, t)
        if t.dtype != q.dtype:
            raise TypeError(f"{name} dtype {t.dtype} != q dtype {q.dtype}")
    B, Sq, N, H = q.shape
    Skv, K = k.shape[1], k.shape[2]
    if k.shape != (B, Skv, K, H) or v.shape != k.shape:
        raise ValueError(f"k/v shapes {tuple(k.shape)}, {tuple(v.shape)} "
                         f"do not match q {tuple(q.shape)}")
    if N % K:
        raise ValueError(f"n_heads {N} not a multiple of n_kv_heads {K}")
    if H not in FLASH_HEAD_DIMS:
        raise ValueError(f"head_dim {H} not in {FLASH_HEAD_DIMS}")
    if (q_segment_ids is None) != (kv_segment_ids is None):
        raise ValueError("q_segment_ids and kv_segment_ids go together")
    if window is not None and (not causal or window < 1):
        raise ValueError(
            f"window={window} requires causal attention and window >= 1"
        )
    qseg = kseg = None
    if q_segment_ids is not None:
        qseg = q_segment_ids.to(torch.int32).contiguous()
        kseg = kv_segment_ids.to(torch.int32).contiguous()
        if qseg.shape != (B, Sq) or kseg.shape != (B, Skv):
            raise ValueError("segment ids must be [B, Sq] and [B, Skv]")
    return (q.contiguous(), k.contiguous(), v.contiguous(), qseg, kseg,
            (B, Sq, Skv, N, K, H))


def _c_tail(shape, causal, q_offset, window, seg_pad_zero, logit_softcap, dtype, device):
    """The C arguments after the pointers, in every entry point's order."""
    B, Sq, Skv, N, K, H = shape
    return (B, Sq, Skv, N, K, H, int(causal), int(q_offset), int(window or 0),
            int(bool(seg_pad_zero)), float(logit_softcap or 0.0), float(H ** -0.5),
            1 if dtype == torch.bfloat16 else 0,
            torch.cuda.current_stream(device).cuda_stream)


_TAIL_TYPES = [ctypes.c_int] * 10 + [ctypes.c_float, ctypes.c_float, ctypes.c_int,
                                      ctypes.c_void_p]


def _ptr(t: Optional[torch.Tensor]):
    return t.data_ptr() if t is not None else None


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself when its data starts on 16 bytes, else a copy."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _flash_fwd(q, k, v, *, causal, q_segment_ids, kv_segment_ids, logit_softcap, q_offset,
               window, seg_pad_zero, return_lse, q_positions=None, kv_positions=None):
    """One K3 launch (both wrappers' body)."""
    if not on_cuda(q, k, v):
        raise ValueError("K3 takes CUDA tensors; CPU tensors go to attention_plain")
    q, k, v, qseg, kseg, shape = _check_args(
        q, k, v, q_segment_ids, kv_segment_ids, causal, window)
    B, Sq, Skv, N, _, _ = shape
    qpos, kpos = _check_positions(q_positions, kv_positions, B, Sq, Skv)
    out = torch.empty_like(q)
    lse = (torch.empty(B, N, Sq, dtype=torch.float32, device=q.device)
           if return_lse else None)
    rc = _build.entry("flash_fwd", "flash_fwd", [ctypes.c_void_p] * 9 + _TAIL_TYPES)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), _ptr(lse),
        _ptr(qseg), _ptr(kseg), _ptr(qpos), _ptr(kpos),
        *_c_tail(shape, causal, q_offset, window, seg_pad_zero, logit_softcap,
                 q.dtype, q.device),
    )
    _build.check(rc, "flash_fwd")
    return (out, lse) if return_lse else out


@counted
def flash_attention_cuda(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    q_segment_ids: Optional[torch.Tensor] = None,
    kv_segment_ids: Optional[torch.Tensor] = None,
    logit_softcap: Optional[float] = None,
    q_offset: int = 0,
    window: Optional[int] = None,
    seg_pad_zero: bool = False,
    return_lse: bool = False,
):
    """Launch K3 on CUDA tensors; shapes and semantics as attention_plain.
    With ``return_lse`` also returns the float32 [B, N, Sq] log-sum-exp
    residual that K7/K8 take (NEG_INF on rows that attend nothing)."""
    res = _flash_fwd(q, k, v, causal=causal, q_segment_ids=q_segment_ids,
                     kv_segment_ids=kv_segment_ids, logit_softcap=logit_softcap,
                     q_offset=q_offset, window=window, seg_pad_zero=seg_pad_zero,
                     return_lse=return_lse)
    flash_attention_cuda.launches += 1
    return res


def _flash_fwd_pos_split(q, k, v, q_positions, kv_positions, *, causal, q_segment_ids,
                         kv_segment_ids, logit_softcap, window, seg_pad_zero, return_lse,
                         one_split):
    """bf16 with positions: the split kernel, then the merge where the grid
    has more than one split (flash_pos.py says how the walk splits)."""
    q, k, v, qseg, kseg, shape = _check_args(
        q, k, v, q_segment_ids, kv_segment_ids, causal, window)
    B, Sq, Skv, N, K, H = shape
    qpos, kpos = _check_positions(q_positions, kv_positions, B, Sq, Skv)
    tq = q_tile(N // K)
    n_sp = 1 if one_split else grid_splits(B, Sq, Skv, N, K)
    out = torch.empty_like(q)
    lse = (torch.empty(B, N, Sq, dtype=torch.float32, device=q.device)
           if return_lse else None)
    o_part = ml_part = n_act = None
    if n_sp > 1:
        o_part = torch.empty(n_sp, B, Sq, N, H, dtype=torch.float32, device=q.device)
        ml_part = torch.empty(n_sp, B, Sq, N, 2, dtype=torch.float32, device=q.device)
        n_act = torch.empty(B, -(-Sq // tq), dtype=torch.int32, device=q.device)
    rc = _build.entry("flash_fwd", "flash_fwd_pos",
                      [ctypes.c_void_p] * 12 + [ctypes.c_int] * 3 + _TAIL_TYPES)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), _ptr(lse),
        _ptr(qseg), _ptr(kseg), qpos.data_ptr(), kpos.data_ptr(), _ptr(o_part),
        _ptr(ml_part), _ptr(n_act), tq, n_sp, SPLIT_STEPS,
        *_c_tail(shape, causal, 0, window, seg_pad_zero, logit_softcap, q.dtype, q.device),
    )
    _build.check(rc, "flash_fwd_pos")
    if n_sp > 1:
        flash_pos_merge_cuda(o_part, ml_part, n_act, out, lse, tq=tq)
    return (out, lse) if return_lse else out


@counted
def flash_attention_pos_cuda(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_positions: torch.Tensor,
    kv_positions: torch.Tensor,
    *,
    causal: bool = True,
    q_segment_ids: Optional[torch.Tensor] = None,
    kv_segment_ids: Optional[torch.Tensor] = None,
    logit_softcap: Optional[float] = None,
    window: Optional[int] = None,
    seg_pad_zero: bool = False,
    return_lse: bool = False,
    _one_split: bool = False,
):
    """Launch K3's explicit-positions branch on CUDA tensors:
    ``q_positions`` [B, Sq] and ``kv_positions`` [B, Skv] (any order; they
    need not rise) take the place of the row indices in the causal and
    window tests. Each block lists its live key steps from the positions'
    extremes, then each warp (bf16) or tile (float32) skips a step whose
    largest q position precedes its smallest kv position, or, under a
    window, whose smallest q position less its largest kv position
    reaches the window. bfloat16 packs each kv head's query heads into a
    block and splits its list across blocks, with a merge
    (``flash_pos_merge_cuda``, counted apart) where a walk has more than
    one split; ``_one_split`` forces a single split (a check of the split
    against the unsplit walk, never the serving path's). float32 runs one
    block per q tile and head, unsplit. Counted apart from K3's index
    path."""
    if not on_cuda(q, k, v):
        raise ValueError("K3 takes CUDA tensors; CPU tensors go to attention_plain")
    kw = dict(causal=causal, q_segment_ids=q_segment_ids, kv_segment_ids=kv_segment_ids,
              logit_softcap=logit_softcap, window=window, seg_pad_zero=seg_pad_zero,
              return_lse=return_lse)
    if q.dtype == torch.bfloat16:
        res = _flash_fwd_pos_split(q, k, v, q_positions, kv_positions, one_split=_one_split,
                                   **kw)
    else:
        res = _flash_fwd(q, k, v, q_offset=0, q_positions=q_positions,
                         kv_positions=kv_positions, **kw)
    flash_attention_pos_cuda.launches += 1
    return res


def _bwd_operands(q, k, v, do, lse, delta, q_segment_ids, kv_segment_ids, causal,
                  window):
    q, k, v, qseg, kseg, shape = _check_args(
        q, k, v, q_segment_ids, kv_segment_ids, causal, window)
    B, Sq, _, N, _, _ = shape
    if do.shape != q.shape or do.dtype != q.dtype:
        raise ValueError(f"dO {tuple(do.shape)} {do.dtype} does not match q "
                         f"{tuple(q.shape)} {q.dtype}")
    for name, t in (("lse", lse), ("delta", delta)):
        if t.shape != (B, N, Sq) or t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 [{B}, {N}, {Sq}], got "
                             f"{t.dtype} {tuple(t.shape)}")
    return (q, k, v, do.contiguous(), lse.contiguous(), delta.contiguous(), qseg,
            kseg, shape)


def _flash_bwd(symbol, outs, q, k, v, do, lse, delta, *, causal, q_segment_ids,
               kv_segment_ids, logit_softcap, q_offset, window, seg_pad_zero,
               q_positions=None, kv_positions=None):
    """One K7 (``flash_dq``) or K8 (``flash_dkv``) launch writing ``outs``
    (dq, or dk and dv), with or without positions."""
    if not on_cuda(q, k, v, do, lse, delta):
        raise ValueError("K7 and K8 take CUDA tensors; CPU tensors go to autograd of "
                         "attention_plain")
    q, k, v, do, lse, delta, qseg, kseg, shape = _bwd_operands(
        q, k, v, do, lse, delta, q_segment_ids, kv_segment_ids, causal, window)
    B, Sq, Skv = shape[:3]
    qpos, kpos = _check_positions(q_positions, kv_positions, B, Sq, Skv)
    if qpos is not None and (seg_pad_zero or q_offset):
        raise ValueError("K7/K8 with positions take neither seg_pad_zero nor q_offset")
    res = outs(q, k)
    plan = None
    if qpos is not None and q.dtype == torch.bfloat16 and shape[-1] in WG_HEAD_DIMS:
        # The warpgroup kernels read q, k, v and dO through TMA, which takes
        # 16-byte aligned bases (any fresh allocation), and plan the walk
        # into this scratch (flash_pos_bwd.py).
        q, k, v, do = (_aligned(t) for t in (q, k, v, do))
        plan = torch.empty(plan_scratch_ints(B, Sq, Skv), dtype=torch.int32, device=q.device)
    rc = _build.entry("flash_bwd", symbol, [ctypes.c_void_p] * (11 + len(res)) + _TAIL_TYPES)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), *(t.data_ptr() for t in res), _ptr(qseg), _ptr(kseg),
        _ptr(qpos), _ptr(kpos), _ptr(plan),
        *_c_tail(shape, causal, q_offset, window, seg_pad_zero, logit_softcap,
                 q.dtype, q.device),
    )
    _build.check(rc, symbol)
    return res


def _dq_out(q, k):
    return (torch.empty_like(q),)


def _dkv_out(q, k):
    return torch.empty_like(k), torch.empty_like(k)


@counted
def flash_dq_cuda(
    q, k, v, do, lse, delta, *, causal=True, q_segment_ids=None,
    kv_segment_ids=None, logit_softcap=None, q_offset=0, window=None,
    seg_pad_zero=False,
) -> torch.Tensor:
    """Launch K7 on CUDA tensors: dq [B, Sq, N, H] from q, k, v, the
    output cotangent dO, K3's lse and delta = rowsum(dO * O) (both float32
    [B, N, Sq]). Mask arguments as flash_attention_cuda's."""
    (dq,) = _flash_bwd("flash_dq", _dq_out, q, k, v, do, lse, delta, causal=causal,
                       q_segment_ids=q_segment_ids, kv_segment_ids=kv_segment_ids,
                       logit_softcap=logit_softcap, q_offset=q_offset, window=window,
                       seg_pad_zero=seg_pad_zero)
    flash_dq_cuda.launches += 1
    return dq


@counted
def flash_dkv_cuda(
    q, k, v, do, lse, delta, *, causal=True, q_segment_ids=None,
    kv_segment_ids=None, logit_softcap=None, q_offset=0, window=None,
    seg_pad_zero=False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch K8 on CUDA tensors: (dk, dv) [B, Skv, K, H], each summed
    over the N/K query heads of its group. Arguments as flash_dq_cuda's."""
    dk, dv = _flash_bwd("flash_dkv", _dkv_out, q, k, v, do, lse, delta, causal=causal,
                        q_segment_ids=q_segment_ids, kv_segment_ids=kv_segment_ids,
                        logit_softcap=logit_softcap, q_offset=q_offset, window=window,
                        seg_pad_zero=seg_pad_zero)
    flash_dkv_cuda.launches += 1
    return dk, dv


@counted
def flash_dq_pos_cuda(
    q, k, v, do, lse, delta, q_positions, kv_positions, *, causal=True,
    q_segment_ids=None, kv_segment_ids=None, logit_softcap=None, window=None,
) -> torch.Tensor:
    """Launch K7's explicit-positions branch on CUDA tensors: dq as
    flash_dq_cuda's, the causal and window tests comparing ``q_positions``
    [B, Sq] and ``kv_positions`` [B, Skv] (any order). bf16 at head_dim 64
    and 128: a plan pass classes every (q tile, kv tile) pair from the
    tiles' position extremes and orders the blocks longest walk first
    (``ops/flash_pos_bwd.py``); a block of 128 rows walks the kv tiles
    either of its warpgroups attends. Other head dims and float32: each
    block walks the key steps K3's positions branch lists. No
    seg_pad_zero, no q_offset. Counted apart from K7's index path."""
    (dq,) = _flash_bwd("flash_dq", _dq_out, q, k, v, do, lse, delta, causal=causal,
                       q_segment_ids=q_segment_ids, kv_segment_ids=kv_segment_ids,
                       logit_softcap=logit_softcap, q_offset=0, window=window,
                       seg_pad_zero=False, q_positions=q_positions,
                       kv_positions=kv_positions)
    flash_dq_pos_cuda.launches += 1
    return dq


@counted
def flash_dkv_pos_cuda(
    q, k, v, do, lse, delta, q_positions, kv_positions, *, causal=True,
    q_segment_ids=None, kv_segment_ids=None, logit_softcap=None, window=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch K8's explicit-positions branch on CUDA tensors: (dk, dv) as
    flash_dkv_cuda's, positions as flash_dq_pos_cuda's. Each block (a kv
    tile of one kv head) walks the q tiles that can reach it over the
    group's heads: at bf16 head_dim 64 and 128 from the plan pass (blocks
    of 128 keys, longest walk first), else listed in the kernel from the
    positions' extremes. Counted apart from K8's index path."""
    dk, dv = _flash_bwd("flash_dkv", _dkv_out, q, k, v, do, lse, delta, causal=causal,
                        q_segment_ids=q_segment_ids, kv_segment_ids=kv_segment_ids,
                        logit_softcap=logit_softcap, q_offset=0, window=window,
                        seg_pad_zero=False, q_positions=q_positions,
                        kv_positions=kv_positions)
    flash_dkv_pos_cuda.launches += 1
    return dk, dv


def flash_attention_bwd_cuda(q, k, v, o, lse, do, *, g_lse=None, q_positions=None,
                             kv_positions=None, **mask_kw):
    """(dq, dk, dv) of K3 for the output cotangent ``do``: delta =
    rowsum(dO * O) in float32 from O as the forward stored it (in its
    dtype), as ``_bwd_call`` does outside its kernels; an lse cotangent
    ``g_lse`` [B, N, Sq] folds into delta (d lse / d z = P, so it enters
    dZ = P * (dP - delta) as -g_lse). Then K7 and K8, or with positions
    their positions branches (``mask_kw`` then without q_offset and
    seg_pad_zero)."""
    delta = (do.float() * o.float()).sum(dim=-1).transpose(1, 2)   # [B, N, Sq]
    if g_lse is not None:
        delta = delta - g_lse
    delta = delta.contiguous()
    if q_positions is not None:
        dq = flash_dq_pos_cuda(q, k, v, do, lse, delta, q_positions, kv_positions, **mask_kw)
        dk, dv = flash_dkv_pos_cuda(q, k, v, do, lse, delta, q_positions, kv_positions,
                                    **mask_kw)
        return dq, dk, dv
    dq = flash_dq_cuda(q, k, v, do, lse, delta, **mask_kw)
    dk, dv = flash_dkv_cuda(q, k, v, do, lse, delta, **mask_kw)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """K3 (with lse) forward, K7 + K8 backward; with positions, their
    positions branches. Returns (out, lse), differentiable in both: an lse
    cotangent folds into delta. The forward saves q, k, v, the segment ids,
    the positions, the output and lse, as ``_flash_lse_fwd`` does."""

    @staticmethod
    def forward(ctx, q, k, v, q_segment_ids, kv_segment_ids, q_positions, kv_positions,
                mask_kw):
        seg = dict(q_segment_ids=q_segment_ids, kv_segment_ids=kv_segment_ids)
        if q_positions is not None:
            out, lse = flash_attention_pos_cuda(q, k, v, q_positions, kv_positions,
                                                return_lse=True, **seg, **mask_kw)
        else:
            out, lse = flash_attention_cuda(q, k, v, return_lse=True, **seg, **mask_kw)
        ctx.mask_kw = mask_kw
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(q, k, v, q_segment_ids, kv_segment_ids, q_positions,
                              kv_positions, out, lse)
        return out, lse

    @staticmethod
    def backward(ctx, do, g_lse):
        q, k, v, qseg, kseg, qpos, kpos, out, lse = ctx.saved_tensors
        if do is None:
            do = torch.zeros_like(out)
        dq, dk, dv = flash_attention_bwd_cuda(
            q, k, v, out, lse, do, g_lse=g_lse, q_segment_ids=qseg, kv_segment_ids=kseg,
            q_positions=qpos, kv_positions=kpos, **ctx.mask_kw)
        return dq, dk, dv, None, None, None, None, None


def _kernel_mask_kw(causal, logit_softcap, q_offset, window, seg_pad_zero, positions):
    """The kernels' mask arguments; with positions no q_offset and, under a
    gradient, no seg_pad_zero (K7/K8's positions branches take none)."""
    kw = dict(causal=causal, logit_softcap=logit_softcap, window=window)
    if positions:
        if q_offset:
            raise ValueError("q_offset does not combine with explicit positions")
    else:
        kw.update(q_offset=q_offset, seg_pad_zero=seg_pad_zero)
    return kw


def flash_attention_with_lse(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    q_segment_ids: Optional[torch.Tensor] = None,
    kv_segment_ids: Optional[torch.Tensor] = None,
    logit_softcap: Optional[float] = None,
    q_offset: int = 0,
    window: Optional[int] = None,
    q_positions: Optional[torch.Tensor] = None,
    kv_positions: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Attention returning ``(out, lse)``, the blockwise unit of ring
    attention (``parallel/sequence.py`` merges partial outputs through
    their lse). out [B, Sq, N, H] in q's dtype; lse float32 [B, N, Sq],
    -inf on rows that attend nothing (the kernels' NEG_INF stand-in turned
    into the -inf the merge keys off, as the JAX package's wrapper does).
    Differentiable in both outputs. CUDA tensors run K3 and, for the
    gradient, K7 and K8 (their positions branches with positions); CPU
    tensors the plain versions under autograd."""
    if on_cuda(q, k, v):
        kw = _kernel_mask_kw(causal, logit_softcap, q_offset, window, False,
                             q_positions is not None)
        out, lse = _FlashAttention.apply(q, k, v, q_segment_ids, kv_segment_ids,
                                         q_positions, kv_positions, kw)
    else:
        kw = dict(causal=causal, q_segment_ids=q_segment_ids, kv_segment_ids=kv_segment_ids,
                  logit_softcap=logit_softcap, q_offset=q_offset, window=window,
                  q_positions=q_positions, kv_positions=kv_positions)
        out = attention_plain(q, k, v, **kw)
        lse = attention_lse_plain(q, k, **kw)
    return out, torch.where(lse <= NEG_INF / 2, -torch.inf, lse)


def attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    mask: Optional[torch.Tensor] = None,
    q_segment_ids: Optional[torch.Tensor] = None,
    kv_segment_ids: Optional[torch.Tensor] = None,
    logit_softcap: Optional[float] = None,
    q_offset: int = 0,
    window: Optional[int] = None,
    seg_pad_zero: bool = False,
    q_positions: Optional[torch.Tensor] = None,
    kv_positions: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Grouped-query scaled-dot-product attention. Shapes as attention_plain.

    CUDA tensors go to K3, which takes no explicit ``mask`` (express it
    through causal / segment ids / window / positions), and through K7/K8
    when a gradient is needed; CPU tensors to the plain version.
    ``seg_pad_zero`` declares segment id 0 as padding so the kernels may
    skip all-padding tiles (not with positions under a gradient); the
    plain version has no tiles and ignores it.
    """
    if on_cuda(q, k, v):
        if mask is not None:
            raise ValueError(
                "explicit `mask` is only taken by the plain version; express "
                "the mask through causal/segment ids/window for the kernel"
            )
        pos = q_positions is not None
        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                        or v.requires_grad):
            kw = _kernel_mask_kw(causal, logit_softcap, q_offset, window, seg_pad_zero, pos)
            return _FlashAttention.apply(q, k, v, q_segment_ids, kv_segment_ids,
                                         q_positions, kv_positions, kw)[0]
        kw = _kernel_mask_kw(causal, logit_softcap, q_offset, window, seg_pad_zero, False)
        seg = dict(q_segment_ids=q_segment_ids, kv_segment_ids=kv_segment_ids)
        if pos:
            del kw["q_offset"]
            return flash_attention_pos_cuda(q, k, v, q_positions, kv_positions, **seg, **kw)
        return flash_attention_cuda(q, k, v, **seg, **kw)
    return attention_plain(
        q, k, v, causal=causal, mask=mask, q_segment_ids=q_segment_ids,
        kv_segment_ids=kv_segment_ids, logit_softcap=logit_softcap,
        q_offset=q_offset, window=window, q_positions=q_positions,
        kv_positions=kv_positions,
    )
