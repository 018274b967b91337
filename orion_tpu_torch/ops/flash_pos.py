"""K3's explicit-positions branch in bfloat16 as a split key walk: the plan
the kernel follows, the plain version of its split-and-merge, and the
merge kernel's wrapper.

The bf16 kernel (``csrc/flash_fwd.cu`` ``flash_fwd_pos_tc_kernel``) packs
the G = N / K query heads of a kv head into one block of TC_ROWS product
rows (``q_tile(G)`` queries of each head), so each K/V step is loaded once
for the group. Each block lists the key steps of KEY_STEP keys its queries
may attend (``live_steps`` mirrors ``flash_tc.cuh``: the block's q position
extremes against each step's kv extremes, and under seg_pad_zero the
step's liveness) and takes an even share of that list: the (row, q tile,
kv head) walk runs on ``active_splits`` blocks of at most ``n_splits``
(``grid_splits``, from the shapes), about ``SPLIT_STEPS`` steps each. Where a
block's walk has one active split it writes the normalized output (and
lse) itself; otherwise each split writes float32 partials (O
unnormalized, m, l) and the merge kernel combines them in split order, so
the same inputs give the same bits. ``n_act`` [B, n_q_tiles] carries each
block's active splits from the kernel to the merge.

``flash_attention_pos_split_plain`` is that plan written out in PyTorch:
each split's partials over its own key steps, then the merge in the same
order. It equals ``attention_plain`` with positions on every real row
(padding query rows differ: the kernel counts padding pairs only where
live tiles meet, see ``flash_tc.cuh``); the CPU tests hold it against the
JAX package. Nothing on the serving path calls it: CPU tensors go to
``attention_plain``.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from orion_tpu_torch.ops import _build
from orion_tpu_torch.ops.common import NEG_INF, counted, on_cuda, q_tile

KEY_STEP = 32          # keys per step of the walk (flash_tc.cuh KB)
SUB = 64               # queries per tile of seg_pad_zero liveness (flash_tc.cuh SUB)
SPLIT_STEPS = 32       # live key steps per split
TARGET_BLOCKS = 1056   # splits stop at this many blocks: four waves of two on 132 SMs
POS_MAX, POS_MIN = 2 ** 31 - 1, -(2 ** 31)


def grid_splits(B: int, Sq: int, Skv: int, n_heads: int, n_kv_heads: int,
                split_steps: int = SPLIT_STEPS) -> int:
    """Splits in the kernel's grid: at most one per ``split_steps`` steps of
    the longest possible walk (every key step), and as many as keep the
    grid within TARGET_BLOCKS blocks (a prefill of many rows fills the card
    without them, and the partials stay small), but two where a walk can
    take more than one split: the last wave then ends within half a walk."""
    n_kt = -(-Skv // KEY_STEP)
    base = B * -(-Sq // q_tile(n_heads // n_kv_heads)) * n_kv_heads
    return max(1, min(-(-n_kt // split_steps), max(2, TARGET_BLOCKS // base)))


def active_splits(n_live: int, n_splits: int, split_steps: int = SPLIT_STEPS) -> int:
    """Splits that walk a block's ``n_live`` live steps: one per
    ``split_steps`` (at least one, at most ``n_splits``); as the kernel
    computes it."""
    return min(n_splits, max(1, -(-n_live // split_steps)))


def split_share(n_live: int, n_act: int, split: int) -> tuple[int, int]:
    """The live-step list's indices [lo, hi) that split ``split`` walks."""
    return split * n_live // n_act, (split + 1) * n_live // n_act


def live_steps(qpos: torch.Tensor, kpos: torch.Tensor, kseg: Optional[torch.Tensor],
               q0: int, nq: int, *, causal: bool, window: Optional[int],
               skip_pad: bool) -> list[int]:
    """The key steps a block whose queries are [q0, q0 + nq) of one row may
    attend, in order (``flash_tc.cuh`` ``live_steps``): ``qpos`` [Sq],
    ``kpos`` and ``kseg`` [Skv] of that row. A step is out when it is all
    padding under ``skip_pad``, when its least kv position exceeds the
    block's greatest q position, or, under a window, when its greatest kv
    position is at or below the block's least q position less the window."""
    Skv = kpos.shape[0]
    n_kt = -(-Skv // KEY_STEP)
    pad = n_kt * KEY_STEP - Skv
    kp = kpos.long()
    live = torch.ones(n_kt, dtype=torch.bool, device=kpos.device)
    if skip_pad:
        live &= F.pad(kseg > 0, (0, pad), value=False).view(n_kt, KEY_STEP).any(1)
    if causal:
        qp = qpos[q0:q0 + nq].long()
        kmin = F.pad(kp, (0, pad), value=POS_MAX).view(n_kt, KEY_STEP).amin(1)
        live &= kmin <= qp.max()
        if window is not None:
            kmax = F.pad(kp, (0, pad), value=POS_MIN).view(n_kt, KEY_STEP).amax(1)
            live &= kmax > qp.min() - window
    return torch.nonzero(live).flatten().tolist()


def block_live(qseg: Optional[torch.Tensor], q0: int, nq: int, skip_pad: bool) -> bool:
    """Whether a block whose queries are [q0, q0 + nq) of one row (segment
    ids ``qseg`` [Sq]) walks at all: under ``skip_pad`` some 64-query tile
    its queries lie in holds a real query (segment > 0)."""
    if not skip_pad:
        return True
    Sq = qseg.shape[0]
    lo, hi = q0 // SUB * SUB, -(-min(q0 + nq, Sq) // SUB) * SUB
    return bool((qseg[lo:min(hi, Sq)] > 0).any())


def split_plan(q_positions, kv_positions, q_segment_ids=None, kv_segment_ids=None, *,
               n_heads: int, n_kv_heads: int, causal: bool = True,
               window: Optional[int] = None, seg_pad_zero: bool = False,
               n_splits: int, split_steps: int = SPLIT_STEPS):
    """Each block's live steps and active splits: ({(b, q tile): steps},
    n_act int32 [B, n_q_tiles]), as the kernel computes them (the kv head
    does not enter)."""
    B, Sq = q_positions.shape
    tq = q_tile(n_heads // n_kv_heads)
    n_qt = -(-Sq // tq)
    skip_pad = seg_pad_zero and q_segment_ids is not None
    steps, n_act = {}, torch.ones(B, n_qt, dtype=torch.int32)
    for b in range(B):
        qseg = None if q_segment_ids is None else q_segment_ids[b]
        kseg = None if kv_segment_ids is None else kv_segment_ids[b]
        for qt in range(n_qt):
            q0 = qt * tq
            s = (live_steps(q_positions[b], kv_positions[b], kseg, q0, tq, causal=causal,
                            window=window, skip_pad=skip_pad)
                 if block_live(qseg, q0, tq, skip_pad) else [])
            steps[b, qt] = s
            n_act[b, qt] = active_splits(len(s), n_splits, split_steps)
    return steps, n_act


def flash_pos_partials_plain(
    q, k, v, q_positions, kv_positions, *, causal=True, q_segment_ids=None,
    kv_segment_ids=None, logit_softcap=None, window=None, seg_pad_zero=False,
    n_splits: Optional[int] = None, split_steps: int = SPLIT_STEPS,
):
    """Each split's float32 partials over its own key steps: (o_part
    [n_splits, B, Sq, N, H] with O unnormalized, ml_part [n_splits, B, Sq,
    N, 2] with (m, l), n_act). A row with no kept key in a split has m =
    NEG_INF, l = 0 and O = 0, and so have the splits at or past a block's
    n_act (the kernel leaves those unwritten: the merge reads none)."""
    B, Sq, N, H = q.shape
    Skv, K = k.shape[1], k.shape[2]
    G, tq = N // K, q_tile(N // K)
    if n_splits is None:
        n_splits = grid_splits(B, Sq, Skv, N, K, split_steps)
    steps, n_act = split_plan(
        q_positions, kv_positions, q_segment_ids, kv_segment_ids, n_heads=N,
        n_kv_heads=K, causal=causal, window=window, seg_pad_zero=seg_pad_zero,
        n_splits=n_splits, split_steps=split_steps)
    o_part = torch.zeros(n_splits, B, Sq, N, H, dtype=torch.float32, device=q.device)
    ml_part = torch.zeros(n_splits, B, Sq, N, 2, dtype=torch.float32, device=q.device)
    ml_part[..., 0] = NEG_INF
    scale = H ** -0.5
    for (b, qt), s_list in steps.items():
        rows = slice(qt * tq, min(qt * tq + tq, Sq))
        qb = q[b, rows].float()                                       # [tq, N, H]
        qp = q_positions[b, rows].long()
        for split in range(int(n_act[b, qt])):
            lo, hi = split_share(len(s_list), int(n_act[b, qt]), split)
            keys = [torch.arange(t * KEY_STEP, min(t * KEY_STEP + KEY_STEP, Skv),
                                 device=q.device) for t in s_list[lo:hi]]
            if not keys:
                continue
            keys = torch.cat(keys)
            kb = k[b, keys].float().repeat_interleave(G, dim=1)       # [nk, N, H]
            vb = v[b, keys].float().repeat_interleave(G, dim=1)
            z = torch.einsum("qnh,knh->nqk", qb, kb) * scale
            if logit_softcap is not None:
                z = logit_softcap * torch.tanh(z / logit_softcap)
            keep = torch.ones(qp.shape[0], keys.shape[0], dtype=torch.bool, device=q.device)
            if causal:
                d = qp[:, None] - kv_positions[b, keys].long()[None]
                keep = d >= 0
                if window is not None:
                    keep &= d < window
            if q_segment_ids is not None:
                keep &= q_segment_ids[b, rows][:, None] == kv_segment_ids[b, keys][None]
            z = torch.where(keep, z, torch.full_like(z, -torch.inf))
            m = z.amax(-1)
            m = torch.where(torch.isfinite(m), m, torch.full_like(m, NEG_INF))
            p = torch.exp(z - m[..., None])                            # 0 where masked
            o_part[split, b, rows] = torch.einsum("nqk,knh->qnh", p, vb)
            ml_part[split, b, rows, :, 0] = m.t()
            ml_part[split, b, rows, :, 1] = p.sum(-1).t()
    return o_part, ml_part, n_act


def flash_pos_merge_plain(o_part, ml_part, n_act, out, lse=None, *, tq: int):
    """The plain version of the merge: for every (row, q tile) block whose
    walk had more than one active split (``n_act`` [B, n_q_tiles]), its
    queries' out = sum_s w_s O_s / sum_s w_s l_s with w_s = exp(m_s -
    max_s m_s), summed over splits 0 .. n_act - 1 in that order, 0 where
    the sum of l is 0; and, given ``lse`` [B, N, Sq], lse = max_s m_s +
    log(sum_s w_s l_s), NEG_INF there. Other rows are left as they are.
    Updates and returns (out, lse)."""
    Sq = out.shape[1]
    for b, qt in torch.nonzero(n_act > 1).tolist():
        na = int(n_act[b, qt])
        rows = slice(qt * tq, min(qt * tq + tq, Sq))
        m, l = ml_part[:na, b, rows, :, 0], ml_part[:na, b, rows, :, 1]
        mx = m.amax(0)
        den = torch.zeros_like(mx)
        num = torch.zeros_like(o_part[0, b, rows])
        for s in range(na):
            w = torch.exp(m[s] - mx)
            den = den + l[s] * w
            num = num + o_part[s, b, rows] * w[..., None]
        out[b, rows] = torch.where(den[..., None] > 0, num / torch.where(
            den > 0, den, 1.0)[..., None], 0.0).to(out.dtype)
        if lse is not None:
            lse[b, :, rows] = torch.where(den > 0, mx + torch.log(torch.where(
                den > 0, den, 1.0)), NEG_INF).t()
    return out, lse


def flash_attention_pos_split_plain(
    q, k, v, q_positions, kv_positions, *, causal=True, q_segment_ids=None,
    kv_segment_ids=None, logit_softcap=None, window=None, seg_pad_zero=False,
    return_lse=False, n_splits: Optional[int] = None, split_steps: int = SPLIT_STEPS,
):
    """The split-and-merge in PyTorch: rows of a block with one active
    split normalized from split 0's partial, the rest merged in split
    order. Returns out [B, Sq, N, H] in q's dtype (and lse float32 [B, N,
    Sq], NEG_INF where a row attends nothing)."""
    o_part, ml_part, n_act = flash_pos_partials_plain(
        q, k, v, q_positions, kv_positions, causal=causal, q_segment_ids=q_segment_ids,
        kv_segment_ids=kv_segment_ids, logit_softcap=logit_softcap, window=window,
        seg_pad_zero=seg_pad_zero, n_splits=n_splits, split_steps=split_steps)
    m, l = ml_part[0, ..., 0], ml_part[0, ..., 1]                     # [B, Sq, N]
    safe = torch.where(l > 0, l, 1.0)
    out = (o_part[0] / safe[..., None]).to(q.dtype)
    lse = torch.where(l > 0, m + torch.log(safe), NEG_INF).transpose(1, 2).contiguous()
    flash_pos_merge_plain(o_part, ml_part, n_act, out, lse,
                          tq=q_tile(q.shape[2] // k.shape[2]))
    return (out, lse) if return_lse else out


@counted
def flash_pos_merge_cuda(o_part, ml_part, n_act, out, lse=None, *, tq: int):
    """Launch the merge kernel on CUDA tensors; arguments and result as
    flash_pos_merge_plain's (``out`` bfloat16)."""
    if not on_cuda(*(t for t in (o_part, ml_part, n_act, out, lse) if t is not None)):
        raise ValueError("the merge kernel takes CUDA tensors; CPU tensors go to "
                         "flash_pos_merge_plain")
    n_sp, B, Sq, N, H = o_part.shape
    n_qt = -(-Sq // tq)
    ok = (ml_part.shape == (n_sp, B, Sq, N, 2) and out.shape == (B, Sq, N, H)
          and out.dtype == torch.bfloat16 and n_act.shape == (B, n_qt)
          and n_act.dtype == torch.int32 and o_part.dtype == torch.float32
          and ml_part.dtype == torch.float32
          and (lse is None or (lse.shape == (B, N, Sq) and lse.dtype == torch.float32))
          and all(t.is_contiguous() for t in (o_part, ml_part, n_act, out))
          and (lse is None or lse.is_contiguous()))
    if not ok:
        raise ValueError("merge: o_part [n, B, Sq, N, H] and ml_part [n, B, Sq, N, 2] "
                         "float32, n_act int32 [B, ceil(Sq / tq)], out bfloat16 "
                         "[B, Sq, N, H], lse float32 [B, N, Sq] or None, contiguous")
    rc = _build.entry(
        "flash_fwd", "flash_pos_merge", [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
        + [ctypes.c_void_p],
    )(o_part.data_ptr(), ml_part.data_ptr(), n_act.data_ptr(), out.data_ptr(),
      lse.data_ptr() if lse is not None else None, B, Sq, N, H, tq, n_sp,
      torch.cuda.current_stream(out.device).cuda_stream)
    _build.check(rc, "flash_pos_merge")
    flash_pos_merge_cuda.launches += 1
    return out, lse

