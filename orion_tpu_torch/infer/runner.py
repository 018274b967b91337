"""Cache-aware forward passes: prefill, decode, the mixed chunked step and
speculative verification over the paged KV pool.

Counterpart of ``orion_tpu/infer/runner.py``:

  - ``prefill_step`` runs a batch of same-bucket prompts padded to the
    bucket length. Rows with no cached prefix (``P_pre == 0``) go through
    causal attention with ragged segment ids (K3 on the card skips
    all-padding tiles) and their K/V pages are scattered into the pool.
    Rows that resume over cached pages (``prefix_pages`` with P_pre > 0:
    a prefix-cache hit or a prefill chunk) start at their page-aligned
    ``prefix_lens``: K9 (``ops.paged_flash_prefill``) attends the paged
    history plus the chunk and writes the chunk's pages in the same call,
    or with ``paged_prefill=False`` (inference.paged_prefill) the gather
    body: the prefix pages gathered from the pool (dequantized from an
    int8 pool), attention with explicit positions over prefix + chunk (K3's
    explicit-positions branch on the card) and the chunk's pages
    scattered, as the JAX package's gather body does;
  - ``decode_window`` advances every batch slot ``n_steps`` tokens with
    sampling on the device, and returns the [W, B] token block for ONE
    host fetch by the engine — nothing inside the window reads a value
    back to the host;
  - ``mixed_step`` (inference.chunked_prefill) runs prompt-chunk rows and
    one decode token per slot through one layer loop over one pool;
  - ``verify_step`` (inference.speculative) scores each slot's pending
    token and its drafts, W = speculate_tokens + 1 positions per slot, in
    one forward pass and returns the acceptance verdicts; K10
    (``ops.ragged_paged_attention``) writes the drafts' K/V in place.
    ``mixed_verify_step`` is ``mixed_step`` with verify rows for decode rows.

With ``nan_guard`` (inference.nan_guard) the decode, verify and mixed
programs also return a per-slot ``ok`` [B] bool, "the slot's live logits
were finite", which the engine fetches with the step's tokens (no second
host round trip) and uses to quarantine a poisoned slot. Guard off, the
programs are op for op what they are without it.

The pool is one flat [L*num_pages, K, psz, H] tensor per K and V (int8,
with float32 scale pools, under inference.kv_quant), updated in place:
whole-prompt prefill by indexed assignment at rows ``l*num_pages + page``
(the JAX package's scatter is outside any kernel too), chunk prefill
inside K9, decode inside K4, verify inside K10. Inactive slots point at
scratch page 0 and are masked by their lengths.

Tensor-parallel serving (``tp``, a ``parallel.tensor.TensorParallel``):
every program takes the rank's blocks of the parameters and its slice of
the pool, ``n_kv_heads / tp`` heads of every page; the layer bodies run
the same ops on the rank's ``n_heads / tp`` query heads (the head counts
follow the tensors), and the model functions they call sum the
row-parallel products and gather the logits over the ``tp`` group
(``models/transformer.py``). Every rank samples from the whole logits
with a generator seeded as its peers', so all ranks draw the same tokens.
"""

from __future__ import annotations

from typing import Optional

import torch

from orion_tpu_torch.config import ModelConfig
from orion_tpu_torch.models.transformer import (
    Params,
    _norm,
    embed,
    mlp_or_moe,
    out_proj,
    qkv_proj,
    unembed,
)
from orion_tpu_torch.ops import (
    attention,
    paged_attention,
    paged_flash_prefill,
    quantize_kv,
    ragged_paged_attention,
)

Cache = dict[str, torch.Tensor]


def _prefill_ctx(
    cache: Cache, tokens: torch.Tensor, lengths: torch.Tensor,
    pages: torch.Tensor, prefix_lens: Optional[torch.Tensor],
    prefix_pages: Optional[torch.Tensor], cfg: ModelConfig,
    paged_prefill: bool = True,
) -> dict:
    """Batch-level tensors the per-layer prefill body consumes. A prefill
    chunk is a mid-sequence tail prefill: it resumes at a page-aligned
    ``prefix_lens`` over pages already written, so its positions start
    there and K9 walks ``prefix_pages`` ++ ``pages``. For the gather body
    (``paged_prefill`` False) also the kv positions and segments over
    prefix + chunk: prefix columns sit at their absolute positions
    [0, P_pre*psz), and those past a row's own prefix are segment 0."""
    Nb, S_pad = tokens.shape
    psz = cache["k"].shape[2]
    P_pre = 0 if prefix_pages is None else prefix_pages.shape[1]
    arange = torch.arange(S_pad, dtype=torch.int32, device=tokens.device)
    # Ragged burst: each row's padding tail is segment 0, which K3 skips.
    seg = (arange[None] < lengths[:, None]).to(torch.int32)
    walk = kv_pos = kv_seg = None
    paged = bool(P_pre) and paged_prefill
    if P_pre:
        positions = prefix_lens.to(torch.int32)[:, None] + arange
        if paged:
            walk = torch.cat([prefix_pages, pages], dim=1)
        else:
            pre_idx = torch.arange(P_pre * psz, dtype=torch.int32, device=tokens.device)
            kv_pos = torch.cat([pre_idx.expand(Nb, -1), positions], dim=1)
            kv_seg = torch.cat(
                [(pre_idx[None] < prefix_lens[:, None]).to(torch.int32), seg], dim=1)
    else:
        positions = arange.expand(Nb, S_pad)
    return dict(
        Nb=Nb, S_pad=S_pad, psz=psz, NP=cache["k"].shape[0] // cfg.n_layers,
        n_pages=S_pad // psz, P_pre=P_pre, positions=positions, seg=seg,
        pages=pages.long(), walk=walk, prefix_lens=prefix_lens, lengths=lengths,
        quant="k_scale" in cache, paged=paged, kv_pos=kv_pos, kv_seg=kv_seg,
        prefix_pages=None if prefix_pages is None else prefix_pages.long(),
    )


def _gather_prefix(cache: Cache, ctx: dict, layer: int, dtype: torch.dtype):
    """This layer's cached prefix K and V as [Nb, P_pre*psz, K, H] in the
    model's dtype (an int8 pool dequantized through its scales in float32,
    as the JAX gather body does)."""
    Nb, psz, P_pre = ctx["Nb"], ctx["psz"], ctx["P_pre"]
    rows = layer * ctx["NP"] + ctx["prefix_pages"]            # [Nb, P_pre]
    out = []
    for name in ("k", "v"):
        pre = cache[name][rows].transpose(2, 3)                # [Nb, P, psz, K, H]
        if ctx["quant"]:
            sc = cache[f"{name}_scale"][rows][..., :psz].transpose(2, 3)   # [Nb, P, psz, K]
            pre = pre.float() * sc[..., None]
        out.append(pre.reshape(Nb, P_pre * psz, pre.shape[3], pre.shape[4]).to(dtype))
    return out


def _prefill_layer(
    x: torch.Tensor, cache: Cache, bp: Params, layer: int, ctx: dict,
    cfg: ModelConfig, tp=None,
) -> torch.Tensor:
    """One layer of (possibly mid-sequence) prefill, the pool updated in
    place: K9 over the paged history + the chunk when P_pre > 0 (paged
    prefill), else causal attention over the row's own K/V, or the
    gathered prefix + its own K/V by position, and a page scatter."""
    Nb, psz, n_pages = ctx["Nb"], ctx["psz"], ctx["n_pages"]
    seg, quant = ctx["seg"], ctx["quant"]
    window = cfg.layer_window(layer)
    h = _norm(x, bp["attn_norm"], cfg)
    q, k, v = qkv_proj(h, bp["attn"], cfg, ctx["positions"])
    if ctx["paged"]:
        out = paged_flash_prefill(
            q, cache["k"], cache["v"], ctx["walk"], ctx["prefix_lens"],
            ctx["lengths"], k, v, n_prefix_pages=ctx["P_pre"],
            layer_base=layer * ctx["NP"], logit_softcap=cfg.attn_logit_softcap,
            window=window, k_scale=cache.get("k_scale"),
            v_scale=cache.get("v_scale"),
        )[0]
    else:
        if ctx["P_pre"]:
            # The gather body: tail queries over prefix + tail, compared by
            # explicit positions.
            k_pre, v_pre = _gather_prefix(cache, ctx, layer, k.dtype)
            out = attention(
                q, torch.cat([k_pre, k], dim=1), torch.cat([v_pre, v], dim=1),
                causal=True, q_segment_ids=seg, kv_segment_ids=ctx["kv_seg"],
                seg_pad_zero=True, q_positions=ctx["positions"],
                kv_positions=ctx["kv_pos"], logit_softcap=cfg.attn_logit_softcap,
                window=window,
            )
        else:
            out = attention(
                q, k, v, causal=True, q_segment_ids=seg, kv_segment_ids=seg,
                seg_pad_zero=True, logit_softcap=cfg.attn_logit_softcap,
                window=window,
            )
        # Positions past a row's length hold padding garbage: decode masks
        # them by length and the next real token overwrites its slot.
        K, H = k.shape[2], k.shape[3]
        rows = layer * ctx["NP"] + ctx["pages"]                 # [Nb, n_pages]
        if quant:
            # Per (token, kv head) int8 + f32 scale; the scales land in
            # the first psz columns of the lane-padded scale rows.
            k, ks = quantize_kv(k)
            v, vs = quantize_kv(v)
            cache["k_scale"][rows, :, :psz] = ks.reshape(Nb, n_pages, psz, K).transpose(2, 3)
            cache["v_scale"][rows, :, :psz] = vs.reshape(Nb, n_pages, psz, K).transpose(2, 3)
        cache["k"][rows] = k.reshape(Nb, n_pages, psz, K, H).transpose(2, 3)
        cache["v"][rows] = v.reshape(Nb, n_pages, psz, K, H).transpose(2, 3)
    a = out_proj(out, bp["attn"], cfg, tp)
    if cfg.post_norms:
        a = _norm(a, bp["post_attn_norm"], cfg)
    x = x + a
    y, _ = mlp_or_moe(_norm(x, bp["mlp_norm"], cfg), bp, cfg, tp=tp)
    if cfg.post_norms:
        y = _norm(y, bp["post_mlp_norm"], cfg)
    return x + y


def _prefill_logits(
    params: Params, x: torch.Tensor, lengths: torch.Tensor, cfg: ModelConfig, tp=None,
) -> torch.Tensor:
    """Next-token logits [Nb, V] off each row's last real position
    (gathered before the LM head)."""
    idx = (lengths.long() - 1)[:, None, None].expand(x.shape[0], 1, x.shape[-1])
    return unembed(params, torch.gather(x, 1, idx), cfg, tp)[:, 0]


@torch.no_grad()
def prefill_step(
    params: Params,
    cache: Cache,
    tokens: torch.Tensor,     # [Nb, S_pad] padded prompts (tails), one bucket
    lengths: torch.Tensor,    # [Nb] true prompt (tail) lengths
    pages: torch.Tensor,      # [Nb, S_pad // page_size] page ids written
    prefix_lens: Optional[torch.Tensor] = None,   # [Nb] cached tokens
    prefix_pages: Optional[torch.Tensor] = None,  # [Nb, P_pre] their pages
    *,
    cfg: ModelConfig,
    paged_prefill: bool = True,
    tp=None,
) -> tuple[torch.Tensor, Cache]:
    """Prefill a batch of same-bucket prompts; returns (next-token logits
    [Nb, V], the cache updated in place). With ``prefix_pages`` (P_pre >
    0) rows hold only the uncached tail, resuming at page-aligned
    ``prefix_lens``, through K9 or, with ``paged_prefill`` False, the
    gather body. Padding rows carry all-zero page lists: their K/V lands
    on scratch page 0 and is never read."""
    ctx = _prefill_ctx(cache, tokens, lengths, pages, prefix_lens, prefix_pages, cfg,
                       paged_prefill)
    x = embed(params, tokens, ctx["positions"], cfg, tp)
    for layer, bp in enumerate(params["blocks"]):
        x = _prefill_layer(x, cache, bp, layer, ctx, cfg, tp)
    return _prefill_logits(params, x, lengths, cfg, tp), cache


def _decode_ctx(
    cache: Cache, write_pos: torch.Tensor, page_table: torch.Tensor,
    cfg: ModelConfig,
) -> dict:
    """Batch-level tensors the per-layer decode body consumes."""
    return dict(
        NP=cache["k"].shape[0] // cfg.n_layers,
        write_pos=write_pos, page_table=page_table,
        positions=write_pos[:, None],
    )


def _decode_layer(
    x: torch.Tensor, cache: Cache, bp: Params, layer: int, ctx: dict,
    cfg: ModelConfig, tp=None,
) -> torch.Tensor:
    """One layer of single-token decode: paged attention with the new
    token's K/V (quantized, for int8 pools) written into the pool in
    place."""
    h = _norm(x, bp["attn_norm"], cfg)
    q, k, v = qkv_proj(h, bp["attn"], cfg, ctx["positions"])
    out = paged_attention(
        q[:, 0], cache["k"], cache["v"], ctx["page_table"], ctx["write_pos"],
        layer_base=layer * ctx["NP"], k_new=k[:, 0], v_new=v[:, 0],
        logit_softcap=cfg.attn_logit_softcap, window=cfg.layer_window(layer),
        k_scale=cache.get("k_scale"), v_scale=cache.get("v_scale"),
    )[0]
    a = out_proj(out[:, None], bp["attn"], cfg, tp)
    if cfg.post_norms:
        a = _norm(a, bp["post_attn_norm"], cfg)
    x = x + a
    y, _ = mlp_or_moe(_norm(x, bp["mlp_norm"], cfg), bp, cfg, tp=tp)
    if cfg.post_norms:
        y = _norm(y, bp["post_mlp_norm"], cfg)
    return x + y


def _decode_core(
    params: Params,
    cache: Cache,
    tokens: torch.Tensor,       # [B] newest token per slot
    write_pos: torch.Tensor,    # [B] int32 position written/attended
    page_table: torch.Tensor,   # [B, pages_per_seq] int32
    cfg: ModelConfig,
    tp=None,
) -> torch.Tensor:
    """One decode forward for every slot -> logits [B, V]."""
    ctx = _decode_ctx(cache, write_pos, page_table, cfg)
    x = embed(params, tokens[:, None], ctx["positions"], cfg, tp)
    for layer, bp in enumerate(params["blocks"]):
        x = _decode_layer(x, cache, bp, layer, ctx, cfg, tp)
    return unembed(params, x, cfg, tp)[:, 0]


@torch.no_grad()
def decode_window(
    params: Params,
    cache: Cache,
    tokens: torch.Tensor,       # [B] newest token per slot
    seq_lens: torch.Tensor,     # [B] int32
    page_table: torch.Tensor,   # [B, pages_per_seq] int32
    active: torch.Tensor,       # [B] bool: slot holds a live request
    generator: torch.Generator,
    *,
    n_steps: int,
    cfg: ModelConfig,
    max_seq_len: int,
    tp=None,
    temperature=0.0,
    top_k=0,
    top_p=1.0,
    nan_guard: bool = False,
) -> tuple[torch.Tensor, ...]:
    """``n_steps`` fused decode+sample steps -> (tokens [W, B] int32, cache).

    Slots advance only while ``active`` and inside the context window;
    frozen slots clamp their write position to max_seq_len - 1 (their own
    last slot — the host has already finished them). Slots that finish
    mid-window keep decoding garbage the host discards.

    With ``nan_guard`` the return is ``(tokens, ok, cache)``: ``ok`` [B]
    bool is per slot "every live inner step's logits were finite"; the
    engine quarantines the slots that trip it. Guard off adds no op.
    """
    from orion_tpu_torch.infer.sampling import sample

    tok = tokens.to(torch.int32)
    sl = seq_lens.to(torch.int32)
    ok = torch.ones_like(active) if nan_guard else None
    out = []
    for _ in range(n_steps):
        act = active & (sl < max_seq_len)
        wp = torch.clamp(sl, max=max_seq_len - 1)
        logits = _decode_core(params, cache, tok, wp, page_table, cfg, tp)
        toks = sample(logits, generator, temperature=temperature,
                      top_k=top_k, top_p=top_p)
        tok = torch.where(act, toks, tok)
        sl = sl + act.to(sl.dtype)
        if nan_guard:
            ok = ok & (torch.isfinite(logits).all(-1) | ~act)
        out.append(toks)
    if nan_guard:
        return torch.stack(out), ok, cache
    return torch.stack(out), cache


@torch.no_grad()
def mixed_step(
    params: Params,
    cache: Cache,
    tokens: torch.Tensor,       # [B] newest token per decode slot
    seq_lens: torch.Tensor,     # [B] int32
    page_table: torch.Tensor,   # [B, pages_per_seq]; mid-prefill slots carry
    #                             all-zero rows (their write -> scratch)
    p_tokens: torch.Tensor,     # [Nc, S_chunk] prompt-chunk tail tokens
    p_lengths: torch.Tensor,    # [Nc] true chunk lengths
    p_pages: torch.Tensor,      # [Nc, S_chunk // psz] pages the chunk writes
    p_prefix_lens: torch.Tensor,  # [Nc] context tokens already in the pool
    p_prefix_pages: torch.Tensor,  # [Nc, P_pre] pages holding that context
    generator: Optional[torch.Generator],
    *,
    cfg: ModelConfig,
    max_seq_len: int,
    tp=None,
    temperature=0.0,
    top_k=0,
    top_p=1.0,
    active: Optional[torch.Tensor] = None,   # [B] bool: slot DECODING (guard)
    nan_guard: bool = False,
    paged_prefill: bool = True,
) -> tuple[Optional[torch.Tensor], ...]:
    """One unified prefill-chunk + decode step (inference.chunked_prefill)
    -> (decode tokens [B] or None, chunk logits [Nc, V], cache).

    Each layer runs the prefill body for the chunk rows and the decode
    body (one token for every slot, the math of ``decode_window`` with
    W = 1) over the same pool; the two touch disjoint pages, as the engine
    parks mid-prefill slots' decode rows on scratch page 0. Two unembeds,
    not one over a concat, so the decode half stays op for op
    ``decode_window``'s. The decode sample is drawn only when
    ``generator`` is given (the engine passes None when no decode row is
    live, so a step without one draws nothing from its stream).

    With ``nan_guard`` the return is ``(tokens, ok, chunk logits, cache)``:
    ``ok`` [B] is "the decode row's logits are finite, or the slot is not
    ``active``". As in the JAX package, only decode rows are guarded: a
    prompt-phase slot is caught at its first guarded decode step.
    """
    from orion_tpu_torch.infer.sampling import sample

    wp = torch.clamp(seq_lens.to(torch.int32), max=max_seq_len - 1)
    pctx = _prefill_ctx(cache, p_tokens, p_lengths, p_pages, p_prefix_lens,
                        p_prefix_pages if p_prefix_pages.shape[1] else None, cfg,
                        paged_prefill)
    dctx = _decode_ctx(cache, wp, page_table, cfg)
    xp = embed(params, p_tokens, pctx["positions"], cfg, tp)
    xd = embed(params, tokens.to(torch.int32)[:, None], dctx["positions"], cfg, tp)
    for layer, bp in enumerate(params["blocks"]):
        xp = _prefill_layer(xp, cache, bp, layer, pctx, cfg, tp)
        xd = _decode_layer(xd, cache, bp, layer, dctx, cfg, tp)
    toks = None
    ok = torch.ones_like(active) if nan_guard else None
    if generator is not None:
        d_logits = unembed(params, xd, cfg, tp)[:, 0]
        toks = sample(d_logits, generator, temperature=temperature, top_k=top_k,
                      top_p=top_p)
        if nan_guard:
            ok = torch.isfinite(d_logits).all(-1) | ~active
    p_logits = _prefill_logits(params, xp, p_lengths, cfg, tp)
    if nan_guard:
        return toks, ok, p_logits, cache
    return toks, p_logits, cache


def _verify_ctx(
    cache: Cache, seq_lens: torch.Tensor, lens: torch.Tensor,
    page_table: torch.Tensor, W: int, max_seq_len: int, cfg: ModelConfig,
    depths: Optional[torch.Tensor] = None, tree_mask: Optional[torch.Tensor] = None,
) -> dict:
    """Batch-level tensors of the verify body (speculative decoding). Row b
    holds ``lens[b]`` real tokens — the pending last token and its drafts —
    written at positions ``seq_lens[b] + j`` (slot-sequential, tree or
    chain). Their RoPE positions are the write positions on a chain and
    ``seq_lens + depths`` on a token tree, clamped inside the context.
    K10's view of the row: ``start = min(seq_lens, max_seq_len - 1)`` and
    ``k_lens = clip(min(lens, max_seq_len - start), 1, W)``, an identity
    for live rows (the engine caps drafts at max_seq_len - 1 - cursor).
    Rows without a live decode request carry all-zero page-table rows, so
    their writes land on scratch page 0."""
    dev = seq_lens.device
    sl = seq_lens.to(torch.int32)
    steps = torch.arange(W, dtype=torch.int32, device=dev)[None, :]
    if tree_mask is None:
        pos = sl[:, None] + steps
    else:
        pos = sl[:, None] + depths.to(torch.int32)
    start = torch.clamp(sl, max=max_seq_len - 1)
    k_lens = torch.clamp(torch.minimum(lens.to(torch.int32), max_seq_len - start), 1, W)
    return dict(
        NP=cache["k"].shape[0] // cfg.n_layers, page_table=page_table,
        positions=torch.clamp(pos, max=max_seq_len - 1), start=start, k_lens=k_lens,
        tree_mask=tree_mask, depths=depths,
    )


def _verify_layer(
    x: torch.Tensor, cache: Cache, bp: Params, layer: int, ctx: dict,
    cfg: ModelConfig, tp=None,
) -> torch.Tensor:
    """One layer of batched draft verification: the decode layer with W
    queries per slot. K10 (``ops.ragged_paged_attention``; its plain
    version on the CPU) writes every real draft's K/V into the pool in
    place (quantized under int8, as a sequential decode would write it) and
    attends each query to the context up to its own position, or its tree
    path. One pass over this layer's weights serves all W positions."""
    h = _norm(x, bp["attn_norm"], cfg)
    q, k, v = qkv_proj(h, bp["attn"], cfg, ctx["positions"])
    out = ragged_paged_attention(
        q, cache["k"], cache["v"], ctx["page_table"], ctx["start"], ctx["k_lens"],
        layer_base=layer * ctx["NP"], k_new=k, v_new=v,
        logit_softcap=cfg.attn_logit_softcap, window=cfg.layer_window(layer),
        k_scale=cache.get("k_scale"), v_scale=cache.get("v_scale"),
        tree_mask=ctx["tree_mask"], depths=ctx["depths"],
    )[0]
    a = out_proj(out, bp["attn"], cfg, tp)
    if cfg.post_norms:
        a = _norm(a, bp["post_attn_norm"], cfg)
    x = x + a
    y, _ = mlp_or_moe(_norm(x, bp["mlp_norm"], cfg), bp, cfg, tp=tp)
    if cfg.post_norms:
        y = _norm(y, bp["post_mlp_norm"], cfg)
    return x + y


def _draft_next(tokens: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """[B, W] draft under check per logits position: position j's logits
    predict the token at j+1, so they check ``tokens[:, j+1]``, or nothing
    (-1: the row's bonus position and all padding)."""
    B, W = tokens.shape
    shifted = torch.cat(
        [tokens[:, 1:], torch.full((B, 1), -1, dtype=tokens.dtype, device=tokens.device)],
        dim=1)
    steps = torch.arange(W, device=tokens.device)[None, :]
    return torch.where(steps + 1 < lens.to(tokens.device)[:, None], shifted,
                       torch.full_like(shifted, -1))


def _verify_ok(logits: torch.Tensor, lens: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
    """[B] bool: every real position of an active row has finite logits
    (the NaN guard of the verify programs; other rows pass)."""
    W = logits.shape[1]
    steps = torch.arange(W, device=logits.device)[None, :]
    valid = active[:, None] & (steps < lens.to(logits.device)[:, None])
    return torch.where(valid, torch.isfinite(logits).all(-1), True).all(-1)


def _verify_sample(logits, tokens, lens, generator, parents, sampling):
    """The verifiers on ``logits``; a ``legal_mask`` in ``sampling`` masks
    a copy, so the caller's ``logits`` stay raw for the NaN guard (a mask
    would turn a NaN at an illegal position into NEG_INF)."""
    from orion_tpu_torch.infer.sampling import spec_verify_sample, spec_verify_sample_tree

    if parents is None:
        return spec_verify_sample(logits, _draft_next(tokens, lens), generator, **sampling)
    return spec_verify_sample_tree(logits, tokens, parents, lens, generator, **sampling)


@torch.no_grad()
def verify_step(
    params: Params,
    cache: Cache,
    tokens: torch.Tensor,       # [B, W] pending last token + its drafts
    seq_lens: torch.Tensor,     # [B] int32 accepted-token cursor
    lens: torch.Tensor,         # [B] int32 real verify tokens (1..W)
    page_table: torch.Tensor,   # [B, pages_per_seq]; rows without a live
    #                             decode request all zero (scratch page 0)
    generator: torch.Generator,
    *,
    cfg: ModelConfig,
    max_seq_len: int,
    tp=None,
    temperature=0.0,
    top_k=0,
    top_p=1.0,
    depths: Optional[torch.Tensor] = None,     # [B, W] tree depth per column
    parents: Optional[torch.Tensor] = None,    # [B, W] parent column per column
    tree_mask: Optional[torch.Tensor] = None,  # [B, W] packed ancestor words
    active: Optional[torch.Tensor] = None,     # [B] bool: live decode slot (guard)
    nan_guard: bool = False,
    legal_mask: Optional[torch.Tensor] = None,  # [B, W, V] bool constraint masks
) -> tuple[torch.Tensor, ...]:
    """Score every live slot's drafts in ONE forward pass (speculative
    decoding's verify half) -> ``(accept [B, W] bool, alt [B, W] int32,
    cache)``, the verdicts of ``sampling.spec_verify_sample`` (chain) or
    ``spec_verify_sample_tree`` (token tree, ``depths``/``parents``/
    ``tree_mask`` given). The drafts' K/V is written into the pool as the
    layers go; the engine rewinds rejected positions afterwards. With
    ``nan_guard`` the return is ``(accept, alt, ok, cache)``, ``ok`` [B]
    "every real position of an ``active`` row has finite logits", computed
    on the logits before any mask. ``legal_mask`` (constrained decoding):
    position j's legal-token bitmask, walked by the host along the row's
    draft prefix (chain) or ancestor path (tree); ``None`` runs the
    unconstrained code. The counterpart of the JAX runner's
    ``verify_step``."""
    W = tokens.shape[1]
    ctx = _verify_ctx(cache, seq_lens, lens, page_table, W, max_seq_len, cfg,
                      depths=depths, tree_mask=tree_mask)
    x = embed(params, tokens, ctx["positions"], cfg, tp)
    for layer, bp in enumerate(params["blocks"]):
        x = _verify_layer(x, cache, bp, layer, ctx, cfg, tp)
    logits = unembed(params, x, cfg, tp)                                # [B, W, V]
    accept, alt = _verify_sample(logits, tokens, lens, generator, parents,
                                 dict(temperature=temperature, top_k=top_k, top_p=top_p,
                                      legal_mask=legal_mask))
    if nan_guard:
        return accept, alt, _verify_ok(logits, lens, active), cache
    return accept, alt, cache


@torch.no_grad()
def mixed_verify_step(
    params: Params,
    cache: Cache,
    tokens: torch.Tensor,       # [B, W] pending last token + drafts per slot
    seq_lens: torch.Tensor,     # [B] int32 accepted-token cursor
    lens: torch.Tensor,         # [B] int32 real verify tokens (1..W)
    page_table: torch.Tensor,   # [B, pages_per_seq]; mid-prefill and idle
    #                             slots carry all-zero rows
    p_tokens: torch.Tensor,     # [Nc, S_chunk] prompt-chunk tail tokens
    p_lengths: torch.Tensor,    # [Nc] true chunk lengths
    p_pages: torch.Tensor,      # [Nc, S_chunk // psz] pages the chunk writes
    p_prefix_lens: torch.Tensor,  # [Nc] context tokens already in the pool
    p_prefix_pages: torch.Tensor,  # [Nc, P_pre] pages holding that context
    generator: torch.Generator,
    *,
    cfg: ModelConfig,
    max_seq_len: int,
    tp=None,
    temperature=0.0,
    top_k=0,
    top_p=1.0,
    depths: Optional[torch.Tensor] = None,
    parents: Optional[torch.Tensor] = None,
    tree_mask: Optional[torch.Tensor] = None,
    active: Optional[torch.Tensor] = None,     # [B] bool: slot DECODING (guard)
    nan_guard: bool = False,
    legal_mask: Optional[torch.Tensor] = None,  # [B, W, V] bool constraint masks
    paged_prefill: bool = True,
) -> tuple[torch.Tensor, ...]:
    """``mixed_step`` with the decode half replaced by the verify body:
    speculative decoding composed with chunked prefill -> ``(accept,
    alt, chunk logits [Nc, V], cache)``, with ``nan_guard`` ``(accept,
    alt, ok, chunk logits, cache)`` (``ok`` as ``verify_step``'s, over
    the verify rows only; ``legal_mask`` as ``verify_step``'s). Each layer runs the chunk rows through the
    prefill body (K9 or K3) and the verify rows through ``_verify_layer``
    (K10) over the same pool; they touch disjoint pages, as mid-prefill
    slots' verify rows are parked on scratch page 0."""
    W = tokens.shape[1]
    pctx = _prefill_ctx(cache, p_tokens, p_lengths, p_pages, p_prefix_lens,
                        p_prefix_pages if p_prefix_pages.shape[1] else None, cfg,
                        paged_prefill)
    vctx = _verify_ctx(cache, seq_lens, lens, page_table, W, max_seq_len, cfg,
                       depths=depths, tree_mask=tree_mask)
    xp = embed(params, p_tokens, pctx["positions"], cfg, tp)
    xv = embed(params, tokens, vctx["positions"], cfg, tp)
    for layer, bp in enumerate(params["blocks"]):
        xp = _prefill_layer(xp, cache, bp, layer, pctx, cfg, tp)
        xv = _verify_layer(xv, cache, bp, layer, vctx, cfg, tp)
    logits = unembed(params, xv, cfg, tp)
    accept, alt = _verify_sample(logits, tokens, lens, generator, parents,
                                 dict(temperature=temperature, top_k=top_k, top_p=top_p,
                                      legal_mask=legal_mask))
    p_logits = _prefill_logits(params, xp, p_lengths, cfg, tp)
    if nan_guard:
        return accept, alt, _verify_ok(logits, lens, active), p_logits, cache
    return accept, alt, p_logits, cache
