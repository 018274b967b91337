"""Multi-head attention, with the prefill forward as a CUDA kernel (K3).

``attention_plain`` is the counterpart of ``attention_xla``: grouped-query
attention with a float32 softmax, causal / segment / sliding-window masks
(or an explicit boolean mask) and logit soft-capping. It runs for CPU
tensors, and ``chip_smoke.py`` holds K3 against it on the card.

K3 (``csrc/flash_fwd.cu``) replaces the TPU kernel
``orion_tpu/ops/pallas/flash_attention.py::_fwd_kernel``; its source note
says what bounds it and how the design answers. The wrapper keeps the JAX
package's [B, S, N, H] layout: the kernel reads q/k/v and writes the
output in that layout directly, so no transpose or padding copy is made.
It covers causal + segment ids (+ seg_pad_zero block skip) + q_offset +
window + softcap; explicit masks and explicit positions (the prefix-cache
and sequence-parallel callers) are not on this slice's path and raise.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from orion_tpu_torch.ops import _build
from orion_tpu_torch.ops.common import NEG_INF, check_dtype, counted, on_cuda

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
) -> Optional[torch.Tensor]:
    """Boolean [.., q_len, kv_len] mask; True = attend.

    ``window`` keeps only 0 <= q_pos - kv_pos < window (requires causal).
    """
    if window is not None and (not causal or window < 1):
        raise ValueError(
            f"window={window} requires causal attention and window >= 1"
        )
    if device is None and q_segment_ids is not None:
        device = q_segment_ids.device
    mask = None
    if causal:
        q_pos = torch.arange(q_len, device=device) + q_offset
        kv_pos = torch.arange(kv_len, device=device)
        dist = q_pos[:, None] - kv_pos[None, :]
        mask = dist >= 0
        if window is not None:
            mask = mask & (dist < window)
    if q_segment_ids is not None:
        seg = q_segment_ids[..., :, None] == kv_segment_ids[..., None, :]
        mask = seg if mask is None else (mask & seg)
    return mask


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
) -> torch.Tensor:
    """q: [B, Sq, N, H]; k, v: [B, Skv, K, H] with N % K == 0 -> [B, Sq, N, H]."""
    dtype = q.dtype
    n_heads, head_dim = q.shape[2], q.shape[3]
    k = _gqa_expand(k, n_heads)
    v = _gqa_expand(v, n_heads)
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
            window=window, device=q.device,
        )
    if mask is not None:
        if mask.dim() == 2:
            mask = mask[None, None]
        elif mask.dim() == 3:
            mask = mask[:, None]
        logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    probs = torch.softmax(logits, dim=-1).to(dtype)
    return torch.einsum("bnqk,bknh->bqnh", probs, v)


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
) -> torch.Tensor:
    """Launch K3 on CUDA tensors; shapes and semantics as attention_plain."""
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
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    qseg = kseg = None
    if q_segment_ids is not None:
        qseg = q_segment_ids.to(torch.int32).contiguous()
        kseg = kv_segment_ids.to(torch.int32).contiguous()
        if qseg.shape != (B, Sq) or kseg.shape != (B, Skv):
            raise ValueError("segment ids must be [B, Sq] and [B, Skv]")
    out = torch.empty_like(q)
    rc = _build.entry(
        "flash_fwd", "flash_fwd",
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 10
        + [ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p],
    )(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        qseg.data_ptr() if qseg is not None else None,
        kseg.data_ptr() if kseg is not None else None,
        B, Sq, Skv, N, K, H, int(causal), int(q_offset),
        int(window or 0), int(bool(seg_pad_zero)),
        float(logit_softcap or 0.0), float(H ** -0.5),
        1 if q.dtype == torch.bfloat16 else 0,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(rc, "flash_fwd")
    flash_attention_cuda.launches += 1
    return out


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
) -> torch.Tensor:
    """Grouped-query scaled-dot-product attention. Shapes as attention_plain.

    CUDA tensors go to K3, which takes no explicit ``mask`` (express it
    through causal / segment ids / window); CPU tensors to the plain
    version. ``seg_pad_zero`` declares segment id 0 as padding so K3 may
    skip all-padding tiles; the plain version has no tiles and ignores it.
    """
    if on_cuda(q, k, v):
        if mask is not None:
            raise ValueError(
                "explicit `mask` is only taken by the plain version; express "
                "the mask through causal/segment ids/window for the kernel"
            )
        return flash_attention_cuda(
            q, k, v, causal=causal, q_segment_ids=q_segment_ids,
            kv_segment_ids=kv_segment_ids, logit_softcap=logit_softcap,
            q_offset=q_offset, window=window, seg_pad_zero=seg_pad_zero,
        )
    return attention_plain(
        q, k, v, causal=causal, mask=mask, q_segment_ids=q_segment_ids,
        kv_segment_ids=kv_segment_ids, logit_softcap=logit_softcap,
        q_offset=q_offset, window=window,
    )
