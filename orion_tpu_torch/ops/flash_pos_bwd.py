"""K7's and K8's explicit-positions branches in bfloat16 at head_dim 64 and
128 (K7-pos, K8-pos): the plan the kernels walk, and a plain tiled
backward that walks it.

The kernels (``csrc/flash_bwd.cu`` ``flash_dq_wg_kernel`` and
``flash_dkv_wg_kernel``) split both sequences into tiles of TILE entries.
A pass per call (``bwd_plan_kernel``, into a scratch tensor the wrapper
allocates, ``plan_scratch_ints``) keeps each tile's least and greatest
position and segment id (``tile_facts``), and from them every (q tile,
kv tile) pair has a class (``tile_classes``):

- DEAD: no pair of the two tiles is admitted (causal: every key after
  every query, or every key at or behind the window of every query; or
  the segment ids' ranges are disjoint): neither loaded nor computed;
- FULL: every pair is admitted (both tiles whole, every key at or before
  every query and inside the window, one segment id): no mask;
- MASKED: the rest, masked pair by pair inside the exponential.

A K7 block takes BLOCK query rows of one head (two consumer warpgroups of
one q tile each) and walks the kv tiles where either tile's class is not
DEAD (``dq_walk``), each warpgroup skipping an entry DEAD for its own
tile. A K8 block takes BLOCK keys of one kv head (two kv tiles) and walks
the q tiles where either is not DEAD (``dkv_walk``), once per query head
of the group, for each of its kv tiles in turn, skipping (and not
loading) the entries DEAD for that tile. The pass also orders each batch
row's blocks by their work (``block_work``), most first (stable: equal
work keeps index order), and the grid runs them in that order, every head
of a block together (``block_order``).

``flash_pos_bwd_tiled_plain`` is the backward as that walk computes it:
dq from K7's blocks, dk and dv from K8's, tile by tile in float32, the
FULL tiles without a mask. The CPU tests hold the plan's classes against
``attention_mask`` and the walk against the JAX package's kernels;
nothing on the training path calls it (CPU tensors go to autograd of
``attention_plain``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from orion_tpu_torch.ops.common import NEG_INF

TILE = 64              # queries or keys of a tile (one warpgroup's rows)
BLOCK = 128            # query rows (K7) or keys (K8) of a block: two tiles
DEAD, MASKED, FULL = 0, 1, 2
WG_HEAD_DIMS = (64, 128)   # head dims the warpgroup kernels take (others: the mma.sync ones)
POS_MAX, POS_MIN = 2 ** 31 - 1, -(2 ** 31)


def n_tiles(S: int, size: int = TILE) -> int:
    return -(-S // size)


def plan_scratch_ints(B: int, Sq: int, Skv: int) -> int:
    """int32 entries of the plan pass's scratch, as ``flash_bwd.cu`` lays it
    out: the q tiles' facts [B, n_qt, 4], the kv tiles' [B, n_kt, 4], then
    one order [B, max(q blocks, kv blocks)]."""
    return B * (4 * n_tiles(Sq) + 4 * n_tiles(Skv)
                + max(n_tiles(Sq, BLOCK), n_tiles(Skv, BLOCK)))


def tile_facts(pos: torch.Tensor, seg: Optional[torch.Tensor] = None) -> torch.Tensor:
    """int64 [B, n_tiles, 4] of ``pos`` [B, S]: each tile's least and
    greatest position and least and greatest segment id (0 and 0 without
    ``seg``); entries past S count in neither."""
    B, S = pos.shape
    n = n_tiles(S)
    pad = n * TILE - S

    def ext(x):
        x = x.long()
        return (F.pad(x, (0, pad), value=POS_MAX).view(B, n, TILE).amin(-1),
                F.pad(x, (0, pad), value=POS_MIN).view(B, n, TILE).amax(-1))

    lo, hi = ext(pos)
    slo, shi = ext(seg) if seg is not None else (torch.zeros_like(lo), torch.zeros_like(lo))
    return torch.stack([lo, hi, slo, shi], dim=-1)


def tile_classes(qf: torch.Tensor, kf: torch.Tensor, Sq: int, Skv: int, *, causal: bool,
                 window: Optional[int], has_seg: bool) -> torch.Tensor:
    """int64 [B, n_qt, n_kt]: DEAD, MASKED or FULL for every (q tile, kv
    tile) pair, from the tiles' facts (``tile_facts``)."""
    q, k = qf[:, :, None, :], kf[:, None, :, :]
    dead = torch.zeros(q.shape[0], q.shape[1], k.shape[2], dtype=torch.bool, device=qf.device)
    q_whole = (torch.arange(qf.shape[1], device=qf.device) + 1) * TILE <= Sq
    k_whole = (torch.arange(kf.shape[1], device=kf.device) + 1) * TILE <= Skv
    full = (q_whole[:, None] & k_whole[None, :])[None].expand_as(dead).clone()
    if causal:
        dead |= k[..., 0] > q[..., 1]
        full &= k[..., 1] <= q[..., 0]
        if window is not None:
            dead |= k[..., 1] <= q[..., 0] - window
            full &= q[..., 1] - k[..., 0] < window
    if has_seg:
        dead |= (q[..., 3] < k[..., 2]) | (k[..., 3] < q[..., 2])
        full &= (q[..., 2] == q[..., 3]) & (k[..., 2] == k[..., 3]) & (q[..., 2] == k[..., 2])
    return torch.where(dead, DEAD, torch.where(full, FULL, MASKED))


def bwd_classes(q_positions, kv_positions, q_segment_ids=None, kv_segment_ids=None, *,
                causal: bool = True, window: Optional[int] = None) -> torch.Tensor:
    """The class of every (q tile, kv tile) pair of the call."""
    qf = tile_facts(q_positions, q_segment_ids)
    kf = tile_facts(kv_positions, kv_segment_ids)
    return tile_classes(qf, kf, q_positions.shape[1], kv_positions.shape[1], causal=causal,
                        window=window, has_seg=q_segment_ids is not None)


def _pairs(classes: torch.Tensor, dim: int) -> torch.Tensor:
    """[B, n_blocks, n_other, 2]: the classes of each block's two tiles
    (along ``dim`` of ``classes``: 1 for q tiles, 2 for kv tiles) against
    every tile of the other side; DEAD for a second tile past the end."""
    c = classes if dim == 1 else classes.transpose(1, 2)
    if c.shape[1] % 2:
        c = F.pad(c, (0, 0, 0, 1), value=DEAD)
    B, n2, n_other = c.shape
    return c.view(B, n2 // 2, 2, n_other).transpose(2, 3)


def dq_walk(classes: torch.Tensor, b: int, block: int) -> list:
    """K7's walk of ``block`` (q rows [BLOCK * block, BLOCK * (block + 1))
    of batch row b): (kv tile, class for the first q tile, class for the
    second) where either is not DEAD, kv tiles in order."""
    p = _pairs(classes, 1)[b, block]
    return [(s, int(c0), int(c1)) for s, (c0, c1) in enumerate(p.tolist()) if c0 or c1]


def dkv_walk(classes: torch.Tensor, b: int, block: int) -> list:
    """K8's walk of ``block`` (keys [BLOCK * block, BLOCK * (block + 1)) of
    batch row b) for one query head: (q tile, class for the first kv tile,
    class for the second) where either is not DEAD, q tiles in order."""
    p = _pairs(classes, 2)[b, block]
    return [(t, int(c0), int(c1)) for t, (c0, c1) in enumerate(p.tolist()) if c0 or c1]


def block_work(classes: torch.Tensor, dim: int) -> torch.Tensor:
    """int64 [B, n_blocks]: a K7 block's (``dim`` 1) steps, the kv tiles
    either of its q tiles attends (its two warpgroups take a step
    together), or a K8 block's (``dim`` 2) live pairs over both its kv
    tiles (it walks them in turn)."""
    live = _pairs(classes, dim) != DEAD                               # [B, n_blocks, n_other, 2]
    return live.any(-1).sum(-1) if dim == 1 else live.sum((-1, -2))


def block_order(classes: torch.Tensor, dim: int) -> torch.Tensor:
    """int64 [B, n_blocks]: each batch row's K7 (``dim`` 1) or K8 (``dim``
    2) blocks by their work (``block_work``), most first, equal work in
    index order: the order the grid runs them."""
    return torch.sort(-block_work(classes, dim), dim=-1, stable=True).indices


def _tile_grads(q, k, v, do, lse, delta, qpos, kpos, qseg, kseg, b, n, kvh, t, s, cls, *,
                causal, window, logit_softcap):
    """P and dS (float32 [rows, cols]) of q tile t of head n against kv
    tile s of kv head kvh, as a warpgroup of the kernels computes them:
    no mask on a FULL tile, the mask inside the exponential otherwise."""
    Sq, Skv, H = q.shape[1], k.shape[1], q.shape[3]
    rows = slice(t * TILE, min(t * TILE + TILE, Sq))
    cols = slice(s * TILE, min(s * TILE + TILE, Skv))
    z = q[b, rows, n].float() @ k[b, cols, kvh].float().t() * H ** -0.5
    th = None
    if logit_softcap is not None:
        th = torch.tanh(z / logit_softcap)
        z = logit_softcap * th
    arg = z - lse[b, n, rows, None]
    if cls != FULL:
        keep = torch.ones_like(z, dtype=torch.bool)
        if causal:
            d = qpos[b, rows].long()[:, None] - kpos[b, cols].long()[None, :]
            keep = d >= 0
            if window is not None:
                keep &= d < window
        if qseg is not None:
            keep &= qseg[b, rows][:, None] == kseg[b, cols][None, :]
        arg = torch.where(keep, arg, torch.full_like(arg, NEG_INF))
    p = torch.exp(arg)
    dp = do[b, rows, n].float() @ v[b, cols, kvh].float().t()
    ds = p * (dp - delta[b, n, rows, None])
    if th is not None:
        ds = ds * (1.0 - th * th)
    return p, ds, rows, cols


def flash_pos_bwd_tiled_plain(q, k, v, do, lse, delta, q_positions, kv_positions, *,
                              causal=True, q_segment_ids=None, kv_segment_ids=None,
                              logit_softcap=None, window=None):
    """(dq, dk, dv) of attention with explicit positions as K7-pos and
    K8-pos walk it: q [B, Sq, N, H], k/v [B, Skv, K, H], the output
    cotangent ``do``, K3's lse and delta = rowsum(dO * O) (lse cotangent
    folded in), both float32 [B, N, Sq]. dq sums over K7's walk of each
    block (``dq_walk``, blocks in ``block_order``), dk and dv over K8's
    (``dkv_walk``, each kv tile in turn over the group's query heads), in
    float32; outputs in the inputs' dtypes."""
    B, Sq, N, H = q.shape
    Skv, K = k.shape[1], k.shape[2]
    G = N // K
    classes = bwd_classes(q_positions, kv_positions, q_segment_ids, kv_segment_ids,
                          causal=causal, window=window)
    kw = dict(causal=causal, window=window, logit_softcap=logit_softcap)
    args = (q, k, v, do, lse, delta, q_positions, kv_positions, q_segment_ids, kv_segment_ids)
    dq = torch.zeros(B, Sq, N, H, dtype=torch.float32, device=q.device)
    dk = torch.zeros(B, Skv, K, H, dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    n_qt, n_kt = classes.shape[1], classes.shape[2]
    for b in range(B):
        for blk in block_order(classes, 1)[b].tolist():
            walk = dq_walk(classes, b, blk)
            for n in range(N):
                for s, *cls in walk:
                    for w, c in enumerate(cls):
                        t = 2 * blk + w
                        if c == DEAD or t >= n_qt:
                            continue
                        _, ds, rows, cols = _tile_grads(*args, b, n, n // G, t, s, c, **kw)
                        dq[b, rows, n] += ds @ k[b, cols, n // G].float()
        for blk in block_order(classes, 2)[b].tolist():
            walk = dkv_walk(classes, b, blk)
            for kvh in range(K):
                for w in range(2):                 # the block's kv tiles in turn
                    s = 2 * blk + w
                    if s >= n_kt:
                        continue
                    for g in range(G):
                        n = kvh * G + g
                        for t, *cls in walk:
                            if cls[w] == DEAD:
                                continue
                            p, ds, rows, cols = _tile_grads(*args, b, n, kvh, t, s, cls[w], **kw)
                            dv[b, cols, kvh] += p.t() @ do[b, rows, n].float()
                            dk[b, cols, kvh] += ds.t() @ q[b, rows, n].float()
    scale = H ** -0.5
    return (dq * scale).to(q.dtype), (dk * scale).to(k.dtype), dv.to(v.dtype)
