"""Sequence / context parallelism: ring attention, striped ring and Ulysses.

Counterpart of ``orion_tpu/parallel/sequence.py``. There is no
``shard_map``: every process of the mesh's ``sp`` axis holds its
contiguous shard of the sequence, q [B, S/sp, N, H] and k/v [B, S/sp, K,
H], and calls ``sequence_attention`` with its peers; the result is this
shard of plain attention over the whole sequence.

- **ring**: k/v blocks rotate around the ``sp`` ring (``comm.ppermute``,
  one ``batch_isend_irecv`` a block) while each process merges the
  blockwise softmax of its queries through the blocks' log-sum-exps.
  Blocks wholly in the causal future are skipped; under a sliding window
  the ring stops statically after the last step that can reach it
  (O(window) compute and communication), and past blocks carry their
  global positions so the window measures true distance.
- **ring_striped**: one tiled ``all_to_all`` reshards each contiguous
  shard into sp stripes spread over the sequence, so every process does
  the same causal work each step; blocks mask by explicit global
  positions; one inverse ``all_to_all`` restores the layout.
- **ulysses**: a head <-> sequence ``all_to_all`` gives every process the
  whole sequence for a 1/sp slice of heads, plain attention runs locally,
  the inverse ``all_to_all`` restores sequence sharding (grouped kv heads
  replicate up to a divisible count).

Everything is differentiable: the collectives are autograd Functions
whose backward is their transpose, the blockwise unit is
``ops.flash_attention_with_lse`` (on the card K3 with K7/K8, with
positions their positions branches; on the CPU the plain versions), and
the merge is PyTorch. Every process must run the same collectives in the
same order backward as forward, so a block a process skips stays in its
autograd graph (``_skipped_block``): its ring exchange's transpose then
runs on every process.
"""

from __future__ import annotations

from typing import Optional

import torch

from orion_tpu_torch.comm import collectives as comm
from orion_tpu_torch.ops.attention import _gqa_expand, flash_attention_with_lse
from orion_tpu_torch.runtime.asserts import device_assert
from orion_tpu_torch.runtime.mesh import axis_size as mesh_axis_size

METHODS = ("ring", "ring_striped", "ulysses")


# ---------------------------------------------------------------------------
# Blockwise attention with log-sum-exp state (the ring accumulation unit)
# ---------------------------------------------------------------------------


def _block_attend(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool,
    q_segment_ids: Optional[torch.Tensor],
    kv_segment_ids: Optional[torch.Tensor],
    logit_softcap: Optional[float],
    q_positions: Optional[torch.Tensor] = None,
    kv_positions: Optional[torch.Tensor] = None,
    window: Optional[int] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Attention of local queries against one KV block.

    q: [b, sq, n, h]; k, v: [b, skv, kv, h]. Returns (out [b, sq, n, h]
    float32, normalized within the block, and lse [b, n, sq] float32, the
    log-sum-exp of the block's logits; -inf rows mean "nothing attended
    here"). The causal mask compares explicit ``q_positions`` /
    ``kv_positions`` ([b, sq] / [b, skv]) when given, else the indices;
    ``window`` (requires causal) keeps 0 <= q_pos - kv_pos < window."""
    if window is not None and not causal:
        raise ValueError("window requires causal attention")
    out, lse = flash_attention_with_lse(
        q, k, v, causal=causal, q_segment_ids=q_segment_ids,
        kv_segment_ids=kv_segment_ids, logit_softcap=logit_softcap, window=window,
        q_positions=q_positions, kv_positions=kv_positions)
    return out.float(), lse


class _SkippedBlock(torch.autograd.Function):
    """A block that contributes nothing (out 0, lse -inf) but keeps k and v
    in the autograd graph, with zero gradients: the ring exchange that
    brought them then has its transpose run on this process too."""

    @staticmethod
    def forward(ctx, q, k, v):
        ctx.set_materialize_grads(False)
        ctx.kv = [(t.shape, t.dtype, t.device) for t in (k, v)]
        b, sq, n, h = q.shape
        return (torch.zeros(b, sq, n, h, dtype=torch.float32, device=q.device),
                torch.full((b, n, sq), -torch.inf, dtype=torch.float32, device=q.device))

    @staticmethod
    def backward(ctx, g_out, g_lse):
        return (None, *(torch.zeros(shape, dtype=dtype, device=device)
                        for shape, dtype, device in ctx.kv))


def _skipped_block(q, k, v):
    return _SkippedBlock.apply(q, k, v)


def _merge_blocks(o1, l1, o2, l2):
    """Combine two normalized partial attentions via their log-sum-exps.

    o*: [b, sq, n, h] float32; l*: [b, n, sq] float32 (-inf where a block
    attended nothing, the convention ``flash_attention_with_lse`` returns)."""
    m = torch.maximum(l1, l2)
    m_safe = torch.where(torch.isfinite(m), m, 0.0)
    w1 = torch.where(torch.isfinite(l1), torch.exp(l1 - m_safe), 0.0)
    w2 = torch.where(torch.isfinite(l2), torch.exp(l2 - m_safe), 0.0)
    denom = w1 + w2
    live = denom > 0
    safe = torch.clamp(denom, min=1e-37)
    lse = torch.where(live, m_safe + torch.log(safe), -torch.inf)
    scale1 = torch.where(live, w1 / safe, 0.0)
    scale2 = torch.where(live, w2 / safe, 0.0)
    # [b, n, sq] -> [b, sq, n, 1] against [b, sq, n, h].
    return (o1 * scale1.transpose(1, 2)[..., None]
            + o2 * scale2.transpose(1, 2)[..., None]), lse


# ---------------------------------------------------------------------------
# Ring attention
# ---------------------------------------------------------------------------


def _ring_rotate(group, sp):
    """One ring step's exchange: every process sends its k, v (and segment
    ids) to the next and receives the previous one's."""
    perm = [(i, (i + 1) % sp) for i in range(sp)]

    def rotate(k, v, seg):
        k, v = comm.ppermute(k, group, perm), comm.ppermute(v, group, perm)
        if seg is not None:
            seg = comm.ppermute(seg, group, perm)
        return k, v, seg

    return rotate


def _ring_scan(k, v, seg0, sp, idx, attend, rotate, n_steps=None):
    """Shared ring skeleton: attend the local block, then ``n_steps``
    (default sp - 1) rotate -> attend -> merge steps (no trailing rotation
    whose result is discarded). ``attend(k, v, seg, src, is_first)``
    returns (o float32, lse); ``is_first`` is True only for the local
    step-0 block (src == idx). ``seg0`` is None without segment ids.
    ``rotate(k, v, seg)`` brings the next block (``_ring_rotate``: from
    the previous process). Returns the merged (o, lse).

    ``n_steps < sp - 1`` truncates the ring: with a sliding window over
    contiguous blocks, every process's step-t source block sits t * s_loc
    positions back, so the steps wholly behind the window are dead for all
    processes at once, and dropping them drops their exchanges."""
    n_steps = sp - 1 if n_steps is None else n_steps
    o_acc, l_acc = attend(k, v, seg0, idx, True)
    k_cur, v_cur, seg_cur = k, v, seg0
    for t in range(1, n_steps + 1):
        k_cur, v_cur, seg_cur = rotate(k_cur, v_cur, seg_cur)
        o_blk, l_blk = attend(k_cur, v_cur, seg_cur, (idx - t) % sp, False)
        o_acc, l_acc = _merge_blocks(o_acc, l_acc, o_blk, l_blk)
    return o_acc, l_acc


def _positions(pos: torch.Tensor, b: int) -> torch.Tensor:
    return pos.to(torch.int32).expand(b, -1)


def _ring_attention_local(q, k, v, q_seg, kv_seg, *, group, causal, logit_softcap,
                          window=None, debug_asserts=False):
    """One process's ring attention body over its contiguous shard.

    Without a window every ring position needs a static mask: the local
    diagonal block is causal by index, fully-past blocks are unmasked,
    fully-future blocks are skipped. With ``window``, past blocks carry
    their global positions (idx / src * s_loc + iota) so the mask measures
    true distance, and the ring is truncated to the steps that can reach
    the window at all."""
    sp, idx = comm.axis_size(group), comm.axis_index(group)
    b, s_loc = q.shape[0], q.shape[1]
    windowed = causal and window is not None
    iota = torch.arange(s_loc, dtype=torch.int32, device=q.device)

    def block(k_, v_, seg_, src, diag):
        qpos = kvpos = None
        if windowed and not diag:
            qpos = _positions(idx * s_loc + iota, b)
            kvpos = _positions(src * s_loc + iota, b)
        return _block_attend(
            q, k_, v_, causal=causal and (diag or windowed), q_segment_ids=q_seg,
            kv_segment_ids=seg_, logit_softcap=logit_softcap, q_positions=qpos,
            kv_positions=kvpos, window=window if windowed else None)

    def attend(k_, v_, seg_, src, is_first):
        if windowed and not is_first:
            # Every process checks every step's source, the ones whose block
            # it skips too, so the vote meets on all of them.
            kvpos = src * s_loc + iota
            device_assert(debug_asserts,
                          (kvpos >= 0) & (kvpos < sp * s_loc) & (0 <= src < sp),
                          "ring_positions", "ring step source/global positions out of range",
                          group=group)
        if is_first or not causal:
            return block(k_, v_, seg_, src, is_first and causal)
        if src < idx:
            return block(k_, v_, seg_, src, False)
        return _skipped_block(q, k_, v_)   # wholly in the causal future

    n_steps = None
    if windowed:
        # Step t's source block ends at global position (idx - t + 1) * s_loc
        # - 1; its nearest pair distance to local q is (t - 1) * s_loc + 1.
        # Steps with (t - 1) * s_loc + 1 >= window are dead for every
        # process: truncate.
        n_steps = min(sp - 1, max(0, (window - 2) // s_loc + 1))
    o_acc, _ = _ring_scan(k, v, kv_seg, sp, idx, attend, _ring_rotate(group, sp), n_steps)
    return o_acc.to(q.dtype)


def striped_positions(idx: int, sp: int, s_loc: int, device=None) -> torch.Tensor:
    """Global positions [s_loc] of process ``idx``'s stripes: stripe a
    covers [a * s_loc + idx * c, a * s_loc + (idx + 1) * c), c = s_loc / sp."""
    c = s_loc // sp
    base = (torch.arange(sp, dtype=torch.int32, device=device) * s_loc)[:, None]
    off = torch.arange(c, dtype=torch.int32, device=device)[None, :]
    return (base + idx * c + off).reshape(-1)


def to_striped(t: torch.Tensor, group) -> torch.Tensor:
    """Contiguous shard <-> striped layout along the sequence axis (dim 1):
    one tiled all_to_all, its own inverse."""
    return comm.all_to_all(t, group, split_axis=1, concat_axis=1)


def _striped_ring(q, k, v, q_seg, kv_seg, *, idx, sp, rotate, causal, logit_softcap,
                  window=None, debug_asserts=False, group=None):
    """The striped ring of process ``idx`` on its striped q, k, v (and
    segment ids): every block masked by the stripes' explicit global
    positions (and skipped tile by tile inside the kernels), merged in ring
    order. ``rotate`` brings each next block (``_ring_rotate``, or a slice
    of a whole sequence where one device stands in for a ring). Returns the
    merged (o float32, lse), striped."""
    b, s_loc = q.shape[0], q.shape[1]
    qpos = _positions(striped_positions(idx, sp, s_loc, q.device), b)

    def attend(k_, v_, seg_, src, is_first):
        kvpos = _positions(striped_positions(src, sp, s_loc, q.device), b)
        device_assert(debug_asserts, (kvpos >= 0) & (kvpos < sp * s_loc) & (0 <= src < sp),
                      "ring_striped_positions",
                      "striped ring step source/global positions out of range", group=group)
        return _block_attend(
            q, k_, v_, causal=causal, q_segment_ids=q_seg, kv_segment_ids=seg_,
            logit_softcap=logit_softcap, q_positions=qpos if causal else None,
            kv_positions=kvpos if causal else None, window=window if causal else None)

    return _ring_scan(k, v, kv_seg, sp, idx, attend, rotate)


def _ring_striped_local(q, k, v, q_seg, kv_seg, *, group, causal, logit_softcap,
                        window=None, debug_asserts=False):
    """Load-balanced ("zigzag-class") ring attention body: one tiled
    all_to_all splits each contiguous shard into sp stripes and gives
    process d stripe d of every shard (sp evenly spaced slices of the
    sequence), so every process does the same causal work each step;
    ``_striped_ring`` over that layout; the inverse all_to_all (the same
    exchange) restores the contiguous layout. ``window`` passes straight
    to the blockwise unit: no ring step can be truncated, every step's
    stripes spanning the whole sequence. Needs S % sp^2 == 0."""
    sp, idx = comm.axis_size(group), comm.axis_index(group)
    s_loc = q.shape[1]
    if s_loc % sp:
        raise ValueError(f"striped ring needs local seq {s_loc} divisible by sp={sp} "
                         f"(global seq % sp^2 == 0)")
    q, k, v = to_striped(q, group), to_striped(k, group), to_striped(v, group)
    if q_seg is not None:
        q_seg, kv_seg = to_striped(q_seg, group), to_striped(kv_seg, group)
    o_acc, _ = _striped_ring(q, k, v, q_seg, kv_seg, idx=idx, sp=sp,
                             rotate=_ring_rotate(group, sp), causal=causal,
                             logit_softcap=logit_softcap, window=window,
                             debug_asserts=debug_asserts, group=group)
    return to_striped(o_acc.to(q.dtype), group)


# ---------------------------------------------------------------------------
# Ulysses attention
# ---------------------------------------------------------------------------


def _ulysses_local(q, k, v, q_seg, kv_seg, *, group, causal, logit_softcap, window=None,
                   debug_asserts=False):
    """One process's Ulysses body: all_to_all to the whole sequence and a
    slice of heads, attend, all_to_all back. ``window`` passes straight to
    the attention (the local view is the whole sequence); there are no
    positions to assert."""
    from orion_tpu_torch.ops.attention import attention

    # [b, s_loc, n, h] -> [b, S, n / sp, h]
    qg = comm.all_to_all(q, group, split_axis=2, concat_axis=1)
    kg = comm.all_to_all(k, group, split_axis=2, concat_axis=1)
    vg = comm.all_to_all(v, group, split_axis=2, concat_axis=1)
    if q_seg is not None:
        q_seg = comm.all_gather(q_seg, group, gather_axis=1)   # [b, S]
        kv_seg = comm.all_gather(kv_seg, group, gather_axis=1)
    out = attention(qg, kg, vg, causal=causal, q_segment_ids=q_seg, kv_segment_ids=kv_seg,
                    logit_softcap=logit_softcap, window=window)
    # [b, S, n / sp, h] -> [b, s_loc, n, h]
    return comm.all_to_all(out, group, split_axis=1, concat_axis=2)


# ---------------------------------------------------------------------------
# Public entry points
# ---------------------------------------------------------------------------


def sequence_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mesh,
    *,
    method: str = "ring",
    axis: str = "sp",
    causal: bool = True,
    q_segment_ids: Optional[torch.Tensor] = None,
    kv_segment_ids: Optional[torch.Tensor] = None,
    logit_softcap: Optional[float] = None,
    head_axis: Optional[str] = "tp",
    window: Optional[int] = None,
    debug_asserts: bool = False,
) -> torch.Tensor:
    """Sequence-parallel grouped-query attention over ``mesh``'s ``axis``.

    q: [B, S/sp, N, H]; k, v: [B, S/sp, K, H]; segment ids [B, S/sp]:
    this process's contiguous shard. Returns this shard of the attention
    output over the whole sequence; semantics match ``ops.attention``. The
    method picks the communication pattern:

      - "ring":         ppermute KV rotation, O(S/sp) per step.
      - "ring_striped": ring over the load-balanced striped layout (one
                        all_to_all each way). Needs S % sp^2 == 0.
      - "ulysses":      head <-> sequence all_to_all; N % (sp * tp) == 0.

    ``window`` (sliding window, requires causal) composes with every
    method; under "ring" it also truncates the ring to O(window).
    ``debug_asserts`` (``model.debug_asserts``) checks each ring step's
    source and global key positions (``runtime/asserts.py``)."""
    if method not in METHODS:
        raise ValueError(f"unknown sequence method {method!r}")
    if window is not None and (not causal or window < 1):
        raise ValueError(f"window={window} requires causal attention and window >= 1")
    group = mesh.get_group(axis)
    sp = mesh_axis_size(mesh, axis)
    if method == "ulysses":
        tp = mesh_axis_size(mesh, head_axis) if head_axis else 1
        n_heads, n_kv = q.shape[2], k.shape[2]
        if n_heads % (sp * tp):
            raise ValueError(f"ulysses needs n_heads ({n_heads}) divisible by sp*tp "
                             f"({sp}*{tp})")
        if n_kv % (sp * tp):
            # The all_to_all moves whole heads: replicate grouped kv heads up
            # to a divisible count (more volume, as every Ulysses under GQA).
            reps = (sp * tp) // n_kv
            if n_kv * reps != sp * tp or n_heads % (n_kv * reps):
                raise ValueError(
                    f"ulysses cannot expand kv_heads ({n_kv}) to a multiple of sp*tp "
                    f"({sp}*{tp}) compatible with n_heads {n_heads}")
            k = _gqa_expand(k, n_kv * reps)
            v = _gqa_expand(v, n_kv * reps)
    if (q_segment_ids is None) != (kv_segment_ids is None):
        raise ValueError("q_segment_ids and kv_segment_ids go together")
    body = {"ring": _ring_attention_local, "ring_striped": _ring_striped_local,
            "ulysses": _ulysses_local}[method]
    return body(q, k, v, q_segment_ids, kv_segment_ids, group=group, causal=causal,
                logit_softcap=logit_softcap, window=window, debug_asserts=debug_asserts)


def ring_attention(q, k, v, mesh, **kw) -> torch.Tensor:
    """Ring attention over the ``sp`` axis (see sequence_attention)."""
    return sequence_attention(q, k, v, mesh, method="ring", **kw)


def ulysses_attention(q, k, v, mesh, **kw) -> torch.Tensor:
    """Ulysses attention over the ``sp`` axis (see sequence_attention)."""
    return sequence_attention(q, k, v, mesh, method="ulysses", **kw)
