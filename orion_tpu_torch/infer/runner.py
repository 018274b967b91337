"""Cache-aware forward passes: prefill and decode over the paged KV pool.

Counterpart of ``orion_tpu/infer/runner.py`` for whole-prompt prefill
(no cached prefix, ``P_pre == 0``) and the fused decode window:

  - ``prefill_step`` runs a batch of same-bucket prompts padded to the
    bucket length through causal attention with ragged segment ids (K3
    on the card skips all-padding tiles) and scatters each layer's K/V
    pages into the pool;
  - ``decode_window`` advances every batch slot ``n_steps`` tokens with
    sampling on the device, and returns the [W, B] token block for ONE
    host fetch by the engine — nothing inside the window reads a value
    back to the host.

The pool is one flat [L*num_pages, K, psz, H] tensor per K and V, updated
in place: prefill by indexed assignment at rows ``l*num_pages + page``
(the JAX package's scatter is outside any kernel too), decode inside K4.
Inactive slots point at scratch page 0 and are masked by their lengths.
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
from orion_tpu_torch.ops import attention, paged_attention

Cache = dict[str, torch.Tensor]


def _prefill_ctx(
    cache: Cache, tokens: torch.Tensor, lengths: torch.Tensor,
    pages: torch.Tensor, cfg: ModelConfig,
) -> dict:
    """Batch-level tensors the per-layer prefill body consumes."""
    Nb, S_pad = tokens.shape
    psz = cache["k"].shape[2]
    positions = torch.arange(S_pad, dtype=torch.int32, device=tokens.device)
    positions = positions.expand(Nb, S_pad)
    # Ragged burst: each row's padding tail is segment 0, which K3 skips.
    seg = (positions < lengths[:, None]).to(torch.int32)
    return dict(
        Nb=Nb, S_pad=S_pad, psz=psz, NP=cache["k"].shape[0] // cfg.n_layers,
        n_pages=S_pad // psz, positions=positions, seg=seg, pages=pages.long(),
    )


def _prefill_layer(
    x: torch.Tensor, cache: Cache, bp: Params, layer: int, ctx: dict,
    cfg: ModelConfig,
) -> torch.Tensor:
    """One layer of prefill: causal attention over the row's own K/V, then
    the K/V pages written into the pool (in place)."""
    Nb, psz, n_pages = ctx["Nb"], ctx["psz"], ctx["n_pages"]
    seg = ctx["seg"]
    h = _norm(x, bp["attn_norm"], cfg)
    q, k, v = qkv_proj(h, bp["attn"], cfg, ctx["positions"])
    out = attention(
        q, k, v, causal=True, q_segment_ids=seg, kv_segment_ids=seg,
        seg_pad_zero=True, logit_softcap=cfg.attn_logit_softcap,
        window=cfg.layer_window(layer),
    )
    a = out_proj(out, bp["attn"], cfg)
    if cfg.post_norms:
        a = _norm(a, bp["post_attn_norm"], cfg)
    x = x + a
    y = mlp_or_moe(_norm(x, bp["mlp_norm"], cfg), bp, cfg)
    if cfg.post_norms:
        y = _norm(y, bp["post_mlp_norm"], cfg)
    x = x + y
    # Positions past a row's length hold padding garbage: decode masks them
    # by length and the next real token overwrites its slot.
    K, H = k.shape[2], k.shape[3]
    rows = layer * ctx["NP"] + ctx["pages"]                 # [Nb, n_pages]
    cache["k"][rows] = k.reshape(Nb, n_pages, psz, K, H).transpose(2, 3)
    cache["v"][rows] = v.reshape(Nb, n_pages, psz, K, H).transpose(2, 3)
    return x


def _prefill_logits(
    params: Params, x: torch.Tensor, lengths: torch.Tensor, cfg: ModelConfig
) -> torch.Tensor:
    """Next-token logits [Nb, V] off each row's last real position
    (gathered before the LM head)."""
    idx = (lengths.long() - 1)[:, None, None].expand(x.shape[0], 1, x.shape[-1])
    return unembed(params, torch.gather(x, 1, idx), cfg)[:, 0]


@torch.no_grad()
def prefill_step(
    params: Params,
    cache: Cache,
    tokens: torch.Tensor,     # [Nb, S_pad] padded prompts, one bucket
    lengths: torch.Tensor,    # [Nb] true prompt lengths
    pages: torch.Tensor,      # [Nb, S_pad // page_size] page ids
    *,
    cfg: ModelConfig,
) -> tuple[torch.Tensor, Cache]:
    """Prefill a batch of same-bucket prompts; returns (next-token logits
    [Nb, V], the cache updated in place). Padding rows carry all-zero page
    lists: their K/V lands on scratch page 0 and is never read."""
    ctx = _prefill_ctx(cache, tokens, lengths, pages, cfg)
    x = embed(params, tokens, ctx["positions"], cfg)
    for layer, bp in enumerate(params["blocks"]):
        x = _prefill_layer(x, cache, bp, layer, ctx, cfg)
    return _prefill_logits(params, x, lengths, cfg), cache


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
    cfg: ModelConfig,
) -> torch.Tensor:
    """One layer of single-token decode: paged attention with the new
    token's K/V written into the pool in place."""
    h = _norm(x, bp["attn_norm"], cfg)
    q, k, v = qkv_proj(h, bp["attn"], cfg, ctx["positions"])
    out, cache["k"], cache["v"] = paged_attention(
        q[:, 0], cache["k"], cache["v"], ctx["page_table"], ctx["write_pos"],
        layer_base=layer * ctx["NP"], k_new=k[:, 0], v_new=v[:, 0],
        logit_softcap=cfg.attn_logit_softcap, window=cfg.layer_window(layer),
    )
    a = out_proj(out[:, None], bp["attn"], cfg)
    if cfg.post_norms:
        a = _norm(a, bp["post_attn_norm"], cfg)
    x = x + a
    y = mlp_or_moe(_norm(x, bp["mlp_norm"], cfg), bp, cfg)
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
) -> torch.Tensor:
    """One decode forward for every slot -> logits [B, V]."""
    ctx = _decode_ctx(cache, write_pos, page_table, cfg)
    x = embed(params, tokens[:, None], ctx["positions"], cfg)
    for layer, bp in enumerate(params["blocks"]):
        x = _decode_layer(x, cache, bp, layer, ctx, cfg)
    return unembed(params, x, cfg)[:, 0]


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
    temperature=0.0,
    top_k=0,
    top_p=1.0,
) -> tuple[torch.Tensor, Cache]:
    """``n_steps`` fused decode+sample steps -> (tokens [W, B] int32, cache).

    Slots advance only while ``active`` and inside the context window;
    frozen slots clamp their write position to max_seq_len - 1 (their own
    last slot — the host has already finished them). Slots that finish
    mid-window keep decoding garbage the host discards.
    """
    from orion_tpu_torch.infer.sampling import sample

    tok = tokens.to(torch.int32)
    sl = seq_lens.to(torch.int32)
    out = []
    for _ in range(n_steps):
        act = active & (sl < max_seq_len)
        wp = torch.clamp(sl, max=max_seq_len - 1)
        logits = _decode_core(params, cache, tok, wp, page_table, cfg)
        toks = sample(logits, generator, temperature=temperature,
                      top_k=top_k, top_p=top_p)
        tok = torch.where(act, toks, tok)
        sl = sl + act.to(sl.dtype)
        out.append(toks)
    return torch.stack(out), cache
