"""The decoder-only transformer: dense serving and training.

Counterpart of ``orion_tpu/models/transformer.py``: the same parameter
tree (a plain dict of tensors; ``blocks`` is a list with one dict per
layer) and the same functions — ``embed``, ``_norm``, ``qkv_proj``,
``out_proj``, ``_mlp_block``, ``unembed`` — shared by the cache-free
``forward``, the serving runner (``infer/runner.py``) and the training
loss (``_hidden_states``, ``loss_fn``). Covers the Llama-3 (RoPE,
RMSNorm, SwiGLU, GQA), GPT-2 (learned positions, LayerNorm, GELU) and
Gemma-2 (post-norms, (1 + w) norms, GeGLU, embedding scale, query scale,
local/global windows, logit softcaps) families, and Mixtral's
mixture-of-experts feed-forward (``models/moe.py``) in place of the MLP.

Sequence parallelism: with ``cfg.sequence_axis`` set and a ``mesh`` whose
axis of that name is above 1, the training path (``_hidden_states``,
``loss_fn``) takes this process's contiguous shard of the sequence, and
attention runs as ``parallel.sequence_attention`` (``cfg.sequence_method``)
with the segment ids, softcap and each layer's window; the positions the
caller passes are the shard's global ones. ``loss_fn`` then returns this
shard's share of the global token mean (the count summed over the axis).

FSDP: with a ``gather`` (``parallel.data_parallel.FsdpGather``) the
parameters are this rank's blocks, and each leaf is gathered where it is
used: a block's leaves at the start of the block, inside the remat
block's function (so a replay gathers again and no gathered layer is
saved), the embedding table where the tokens are embedded (in the
compute dtype: the lookup casts the table before it indexes it, as the
JAX package does, so its gradient sums in that dtype), the final norm
and the LM head (or the tied table, in the compute dtype) where the loss
reads them. The gather's
transpose hands each rank its block of the gradient, summed over ``fsdp``.
The token count of the loss is summed over every data axis of the mesh
(``dp``, ``fsdp`` and the sequence axis) before the divide.

Rematerialization (``model.remat``: none, full, dots, names, and names
with ``remat_offload``) is ``models/remat.py``'s: the block's products
go through ``product`` and its ``checkpoint_name`` points through
``named``, plain calls outside a remat replay.

Tensor parallelism (serving; ``parallel/tensor.py``): with a ``tp``
(``TensorParallel``) the parameters are this rank's blocks, as the JAX
package's ``param_shardings`` place them, and the functions do by hand
what XLA derives from those shardings. ``qkv_proj`` and the MLP's
``w_in``/``w_gate`` are column-parallel (the rank's heads and ``d_ff /
tp`` columns; the head counts come from the weights' widths);
``out_proj`` and ``w_out`` are row-parallel, their partial products
summed by one all-reduce each, the bias (``bo``, ``b_out``) added once
after it; ``embed`` looks tokens up in the rank's rows of the vocabulary
(ids outside them give zeros) and sums over the axis; ``unembed`` gathers
the rank's vocabulary columns of the logits before the final softcap, so
every rank holds the whole logits.

Weights are cast to the activation dtype at use, as the JAX package does;
when they are stored in that dtype already (the serving case) the cast is
free. Every matmul weight is read through ``quantize.load_weight``, which
dequantizes an int8 ``{"q", "s"}`` leaf (``model.weight_quant``, serving
only) and casts a plain one.
"""

from __future__ import annotations

from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from orion_tpu_torch import ops
from orion_tpu_torch.comm.collectives import all_gather, all_reduce
from orion_tpu_torch.config import ModelConfig
from orion_tpu_torch.models.moe import moe_dispatch
from orion_tpu_torch.models.quantize import load_weight
from orion_tpu_torch.models.remat import (
    Offload,
    RematLog,
    named,
    product,
    remat_block,
    remat_policy,
)
from orion_tpu_torch.parallel.sequence import sequence_attention
from orion_tpu_torch.runtime.mesh import axis_size, group_of

Params = dict[str, Any]

_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
}


def torch_dtype(name) -> torch.dtype:
    if isinstance(name, torch.dtype):
        return name
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"unsupported dtype {name!r}; have {sorted(_DTYPES)}")


def param_logical_axes(cfg: ModelConfig) -> Params:
    """A tree like the JAX package's parameters (stacked blocks under
    ``scan_layers``, else one dict per layer) whose leaves are logical-axis
    tuples: a copy of ``orion_tpu/models/transformer.py::param_logical_axes``.
    ``parallel.sharding``'s rules map them to mesh axes: vocab / heads /
    mlp -> tp, embed -> fsdp, expert -> ep, layers -> pp."""
    lead = ("layers",) if cfg.scan_layers else ()

    block = {
        "attn_norm": {"scale": lead + ("embed",)},
        "mlp_norm": {"scale": lead + ("embed",)},
        "attn": {
            "wq": lead + ("embed", "heads"),
            "wk": lead + ("embed", "kv_heads"),
            "wv": lead + ("embed", "kv_heads"),
            "wo": lead + ("heads", "embed"),
        },
    }
    if cfg.norm == "layernorm":
        block["attn_norm"]["bias"] = lead + ("embed",)
        block["mlp_norm"]["bias"] = lead + ("embed",)
    if cfg.post_norms:
        block["post_attn_norm"] = {"scale": lead + ("embed",)}
        block["post_mlp_norm"] = {"scale": lead + ("embed",)}
    if cfg.attn_bias:
        block["attn"]["bq"] = lead + ("heads",)
        block["attn"]["bk"] = lead + ("kv_heads",)
        block["attn"]["bv"] = lead + ("kv_heads",)
    if cfg.resolved_attn_out_bias:
        block["attn"]["bo"] = lead + ("embed",)
    if cfg.is_moe:
        block["moe"] = {
            "router": lead + ("embed", "expert"),
            "w_in": lead + ("expert", "embed", "mlp"),
            "w_out": lead + ("expert", "mlp", "embed"),
        }
        if cfg.is_gated_mlp:
            block["moe"]["w_gate"] = lead + ("expert", "embed", "mlp")
    else:
        block["mlp"] = {
            "w_in": lead + ("embed", "mlp"),
            "w_out": lead + ("mlp", "embed"),
        }
        if cfg.is_gated_mlp:
            block["mlp"]["w_gate"] = lead + ("embed", "mlp")
        if cfg.mlp_bias:
            block["mlp"]["b_in"] = lead + ("mlp",)
            block["mlp"]["b_out"] = lead + ("embed",)

    axes: Params = {
        "embed": {"tokens": ("vocab", "embed")},
        "final_norm": {"scale": ("embed",)},
        "blocks": block if cfg.scan_layers else [block] * cfg.n_layers,
    }
    if cfg.pos_embedding == "learned":
        axes["embed"]["positions"] = ("pos", "embed")
    if not cfg.tie_embeddings:
        axes["lm_head"] = ("embed", "vocab")
    if cfg.norm == "layernorm":
        axes["final_norm"]["bias"] = ("embed",)
    return axes


def _gate_act(cfg: ModelConfig):
    """SiLU (SwiGLU) or tanh-approximate GELU (GeGLU)."""
    if cfg.activation == "swiglu":
        return F.silu
    return lambda h: F.gelu(h, approximate="tanh")


def _norm(x: torch.Tensor, p: Params, cfg: ModelConfig) -> torch.Tensor:
    scale = p["scale"]
    if cfg.norm_scale_plus_one:
        # Gemma-family parameterization x_hat * (1 + w), outside the kernel.
        scale = scale + 1.0
    if cfg.norm == "rmsnorm":
        return ops.rmsnorm(x, scale, eps=cfg.norm_eps)
    return ops.layernorm(x, scale, p.get("bias"), eps=cfg.norm_eps)


def _rounded(c: float, dtype: torch.dtype) -> float:
    """``c`` rounded to ``dtype``, as a host float: multiplying by it is
    multiplying by the constant in the activation dtype (the JAX
    package's arithmetic) without a host-to-device copy, which a
    CUDA-graph capture refuses."""
    return float(torch.tensor(c, dtype=dtype))


def embed(
    params: Params, tokens: torch.Tensor, positions: torch.Tensor, cfg: ModelConfig,
    tp=None,
) -> torch.Tensor:
    """Token (+ learned position) embedding; vocab-parallel with a ``tp``."""
    dtype = torch_dtype(cfg.dtype)
    if tp is None:
        x = _lookup(params["embed"]["tokens"], tokens, dtype)
    else:
        x = _vocab_lookup(params["embed"]["tokens"], tokens, dtype, tp)
    if cfg.embed_scale:
        # Gemma-family: scaled by sqrt(d_model), rounded in the activation dtype.
        x = x * _rounded(cfg.d_model ** 0.5, dtype)
    if cfg.pos_embedding == "learned":
        x = x + _lookup(params["embed"]["positions"], positions, dtype)
    return x


def _lookup(table: torch.Tensor, idx: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Rows ``idx`` of ``table`` in ``dtype``. Where a gradient is taken the
    table is cast first, as the JAX package indexes it, so repeated rows'
    gradients sum in ``dtype``; otherwise only the rows are cast (the
    same values, without a cast of the whole table)."""
    if torch.is_grad_enabled() and table.requires_grad:
        return table.to(dtype)[idx.long()]
    return table[idx.long()].to(dtype)


def _vocab_lookup(table: torch.Tensor, idx: torch.Tensor, dtype: torch.dtype,
                  tp) -> torch.Tensor:
    """The vocab-parallel lookup: rows ``idx`` of the whole table, from the
    rank's block of its rows (rank r holds ids [r * V/tp, (r + 1) * V/tp));
    each id is found on one rank and gives zeros on the others, and the
    sum over the axis adds nothing but zeros to it."""
    rows = table.shape[0]
    local = idx.long() - tp.rank * rows
    mine = (local >= 0) & (local < rows)
    x = table[local.clamp(0, rows - 1)].to(dtype)
    x = torch.where(mine[..., None], x, torch.zeros((), dtype=dtype, device=x.device))
    return all_reduce(x, tp.group)


def unembed(params: Params, x: torch.Tensor, cfg: ModelConfig, tp=None) -> torch.Tensor:
    """Final norm + LM head -> float32 logits; with a ``tp`` the rank's
    vocabulary columns, gathered along the vocabulary before the softcap."""
    x = _norm(x, params["final_norm"], cfg)
    if cfg.tie_embeddings:
        logits = x @ params["embed"]["tokens"].to(x.dtype).T
    else:
        logits = x @ load_weight(params["lm_head"], x.dtype)
    logits = logits.float()
    if tp is not None:
        logits = all_gather(logits, tp.group, gather_axis=logits.dim() - 1)
    if cfg.final_logit_softcap is not None:
        cap = cfg.final_logit_softcap
        logits = cap * torch.tanh(logits / cap)
    return logits


def qkv_proj(
    x: torch.Tensor, p: Params, cfg: ModelConfig, positions: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """QKV projection + RoPE. x [B, S, D] -> q [B,S,N,H], k/v [B,S,K,H]
    (under tensor parallelism the rank's heads: N and K are read off the
    projections' widths)."""
    B, S, _ = x.shape
    H = cfg.resolved_head_dim
    dtype = x.dtype
    q = product(x, load_weight(p["wq"], dtype))
    k = product(x, load_weight(p["wk"], dtype))
    v = product(x, load_weight(p["wv"], dtype))
    N, K = q.shape[-1] // H, k.shape[-1] // H
    if cfg.attn_bias:
        q = q + p["bq"].to(dtype)
        k = k + p["bk"].to(dtype)
        v = v + p["bv"].to(dtype)
    q = q.view(B, S, N, H)
    k = k.view(B, S, K, H)
    v = v.view(B, S, K, H)
    if cfg.pos_embedding == "rope":
        q = ops.apply_rope(q, positions, theta=cfg.rope_theta)
        k = ops.apply_rope(k, positions, theta=cfg.rope_theta)
    if cfg.query_scale is not None:
        # Kernels divide by sqrt(head_dim); pre-multiply q by the ratio.
        q = q * _rounded(cfg.query_scale * (H ** 0.5), q.dtype)
    return q, k, v


def out_proj(out: torch.Tensor, p: Params, cfg: ModelConfig, tp=None) -> torch.Tensor:
    """Attention output projection. out [B, S, N, H] -> [B, S, D];
    row-parallel with a ``tp`` (the rank's heads, one all-reduce)."""
    B, S = out.shape[0], out.shape[1]
    y = product(out.reshape(B, S, -1), load_weight(p["wo"], out.dtype))
    if tp is not None:
        y = all_reduce(y, tp.group)
    if cfg.resolved_attn_out_bias:
        y = y + p["bo"].to(out.dtype)
    return y


def _mlp_block(x: torch.Tensor, p: Params, cfg: ModelConfig, tp=None) -> torch.Tensor:
    """The dense MLP; with a ``tp`` column-parallel in, row-parallel out."""
    dtype = x.dtype
    h_in = product(x, load_weight(p["w_in"], dtype))
    if cfg.mlp_bias:
        h_in = h_in + p["b_in"].to(dtype)
    if cfg.is_gated_mlp:
        h = _gate_act(cfg)(product(x, load_weight(p["w_gate"], dtype))) * h_in
    else:
        h = F.gelu(h_in, approximate="tanh")
    y = product(h, load_weight(p["w_out"], dtype))
    if tp is not None:
        y = all_reduce(y, tp.group)
    if cfg.mlp_bias:
        y = y + p["b_out"].to(dtype)
    return y


def mlp_or_moe(h: torch.Tensor, bp: Params, cfg: ModelConfig, mesh=None, tp=None
               ) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The post-attention half of a block: dense MLP or MoE. Returns (y,
    aux), aux the MoE load-balance loss (float32), or None for a dense MLP
    (so a dense block launches nothing more than it did). A ``tp``
    reaches the dense MLP only (the serving engine refuses MoE under it).
    Every MoE leaf but the router is cast to the activation dtype; the
    router stays in its own, as in the JAX package."""
    if cfg.is_moe:
        moe_params = {k: v if k == "router" else v.to(h.dtype)
                      for k, v in bp["moe"].items()}
        return moe_dispatch(h, moe_params, cfg, mesh)
    return _mlp_block(h, bp["mlp"], cfg, tp), None


def _sp_active(cfg: ModelConfig, mesh) -> bool:
    return (cfg.sequence_axis is not None and mesh is not None
            and axis_size(mesh, cfg.sequence_axis) > 1)


def _attend(h: torch.Tensor, p: Params, cfg: ModelConfig, positions, segment_ids,
            window: Optional[int], mesh=None) -> torch.Tensor:
    """QKV projection, RoPE and attention: the normed input h [B, S, D] ->
    the attention output [B, S, N, H] (``attn_out``)."""
    q, k, v = qkv_proj(h, p, cfg, positions)
    if _sp_active(cfg, mesh):
        return sequence_attention(
            q, k, v, mesh, method=cfg.sequence_method, axis=cfg.sequence_axis,
            causal=True, q_segment_ids=segment_ids, kv_segment_ids=segment_ids,
            logit_softcap=cfg.attn_logit_softcap, window=window,
            debug_asserts=cfg.debug_asserts,
        )
    return ops.attention(
        q, k, v, causal=True,
        q_segment_ids=segment_ids, kv_segment_ids=segment_ids,
        seg_pad_zero=True, logit_softcap=cfg.attn_logit_softcap,
        window=window,
    )


def _block(
    x: torch.Tensor,
    bp: Params,
    cfg: ModelConfig,
    positions: torch.Tensor,
    segment_ids: Optional[torch.Tensor],
    window: Optional[int],
    mesh=None,
) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One block: (x, its MoE aux loss or None). The ``named`` sites are
    the JAX package's ``checkpoint_name`` points (``models/remat.py``);
    outside a remat replay each is a plain call."""
    h = named("attn_norm_out", lambda x_, p: _norm(x_, p, cfg), x, bp["attn_norm"])
    out = named("attn_out",
                lambda h_, p: _attend(h_, p, cfg, positions, segment_ids, window, mesh),
                h, bp["attn"])
    a = out_proj(out, bp["attn"], cfg)
    if cfg.post_norms:
        a = _norm(a, bp["post_attn_norm"], cfg)
    x = x + a
    h = named("mlp_norm_out", lambda x_, p: _norm(x_, p, cfg), x, bp["mlp_norm"])
    ffn = {k: bp[k] for k in ("mlp", "moe") if k in bp}
    if cfg.is_moe:
        y, aux = named("ffn_out", lambda h_, p: mlp_or_moe(h_, p, cfg, mesh), h, ffn)
    else:
        y, aux = named("ffn_out", lambda h_, p: _mlp_block(h_, p["mlp"], cfg), h, ffn), None
    if cfg.post_norms:
        y = _norm(y, bp["post_mlp_norm"], cfg)
    return x + y, aux


@torch.no_grad()
def forward(
    params: Params,
    tokens: torch.Tensor,
    cfg: ModelConfig,
    *,
    positions: Optional[torch.Tensor] = None,
    segment_ids: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Cache-free forward: tokens [B, S] -> logits [B, S, V] float32."""
    B, S = tokens.shape
    if positions is None:
        positions = torch.arange(S, device=tokens.device).expand(B, S)
    x = embed(params, tokens, positions, cfg)
    for layer, bp in enumerate(params["blocks"]):
        x, _ = _block(x, bp, cfg, positions, segment_ids, cfg.layer_window(layer))
    return unembed(params, x, cfg)


def check_scan_unit(cfg: ModelConfig) -> None:
    """The JAX package's ValueError for a layer scan whose unit
    (``cfg.scan_unit``: ``scan_group`` x the window pattern) does not
    divide ``n_layers`` (``orion_tpu/models/transformer.py``
    ``layer_groups``; it scans only under ``scan_layers``). The port runs
    its layers in a Python loop, so the unit shapes nothing else here."""
    unit, L = cfg.scan_unit, cfg.n_layers
    if cfg.scan_layers and unit > 1 and L % unit:
        raise ValueError(
            f"n_layers={L} must be divisible by the layer-scan unit "
            f"{unit} (scan_group={cfg.scan_group}"
            + (f" x sliding_window_pattern={cfg.window_pattern}"
               if cfg.window_pattern else "")
            + ")"
        )


def _hidden_states(
    params: Params,
    tokens: torch.Tensor,
    cfg: ModelConfig,
    *,
    positions: Optional[torch.Tensor] = None,
    segment_ids: Optional[torch.Tensor] = None,
    mesh=None,
    remat_log: Optional[RematLog] = None,
    gather=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The block-stack output [B, S, D] before final norm / LM head, and
    the MoE aux loss summed over layers (zero for a dense model).
    Differentiable; the training path.
    Under sequence parallelism (``mesh``, see the module note) ``tokens``
    is this process's shard and ``positions`` its global positions; with a
    ``gather`` (FSDP) ``params`` are the rank's blocks.

    ``remat`` (``models/remat.py``): under ``full``, ``dots`` and
    ``names`` every block runs as one ``remat_block``, which keeps the
    block's input and the policy's saved set and replays the block in the
    backward; with ``remat_offload`` the named set waits in pinned host
    memory. ``remat=none`` saves everything autograd saves. Without
    gradients (evaluation) no block is rematerialized. ``remat_log``
    (a ``RematLog``) receives what the blocks kept and moved."""
    check_scan_unit(cfg)
    policy = remat_policy(cfg)
    B, S = tokens.shape
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32, device=tokens.device).expand(B, S)
    table = params
    if gather is not None:
        table = {"embed": {k: gather.leaf(t, ("embed", k))
                           for k, t in params["embed"].items()}}
    x = embed(table, tokens, positions, cfg)
    moe_aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if not torch.is_grad_enabled():
        policy = None
    offload = Offload(x.device, remat_log) if policy and cfg.remat_offload else None
    for layer, bp in enumerate(params["blocks"]):
        def fn(x_, bp_, window=cfg.layer_window(layer), layer=layer):
            if gather is not None:
                bp_ = gather.tree(bp_, ("blocks", layer))
            return _block(x_, bp_, cfg, positions, segment_ids, window, mesh)

        if policy is None:
            x, aux = fn(x, bp)
        else:
            x, aux = remat_block(policy, fn, x, bp, offload, remat_log)
        if aux is not None:
            moe_aux = moe_aux + aux
    return x, moe_aux


def _gather_target(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Per-token target logit [..., S] from logits [..., S, V]. The JAX
    package gives its gather a one-hot custom VJP to avoid a scatter on the
    TPU; ``torch.gather``'s own backward computes the same function."""
    return torch.gather(logits, -1, targets.long()[..., None])[..., 0]


def loss_fn(
    params: Params, batch: dict[str, torch.Tensor], cfg: ModelConfig, mesh=None,
    remat_log: Optional[RematLog] = None, gather=None,
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Next-token cross-entropy + weighted MoE aux loss.

    batch: inputs [B, S], targets [B, S], optional loss_mask [B, S]
    (1 = count) and segment_ids / positions for packed sequences. Returns
    (loss, {"ce_loss", "moe_aux", "tokens"}). With ``cfg.loss_chunk`` the
    LM head and log-sum-exp run per sequence chunk under checkpointing, so
    the backward recomputes one chunk's [B, chunk, V] logits at a time
    instead of keeping the full [B, S, V] float32 logits alive.

    On a mesh (``mesh``) the batch is this process's rows and, under
    sequence parallelism, its sequence shard, and the loss this share of
    the global token mean: its masked sum over the count summed across
    every data axis. The shares sum to the global loss; their gradients,
    summed across the mesh, to its gradient. With a ``gather`` (FSDP) the
    parameters are the rank's blocks (see the module note).
    """
    targets = batch["targets"]
    mask = batch.get("loss_mask")
    chunk = cfg.loss_chunk
    B, S = targets.shape
    if chunk and S % chunk:
        raise ValueError(f"model.loss_chunk={chunk} must divide seq_len={S}")
    x, moe_aux = _hidden_states(
        params, batch["inputs"], cfg, positions=batch.get("positions"),
        segment_ids=batch.get("segment_ids"), mesh=mesh, remat_log=remat_log,
        gather=gather,
    )
    if mask is None:
        mask = torch.ones((B, S), dtype=torch.float32, device=x.device)
    mask = mask.float()
    group = None
    if mesh is not None:
        group = group_of(mesh, ("dp", "fsdp") + ((cfg.sequence_axis,)
                                                  if _sp_active(cfg, mesh) else ()))
    head = params
    if gather is not None:
        head = {"final_norm": gather.tree(params["final_norm"], ("final_norm",))}
        if cfg.tie_embeddings:
            head["embed"] = {"tokens": gather.leaf(params["embed"]["tokens"],
                                                   ("embed", "tokens"))}
        else:
            head["lm_head"] = gather.leaf(params["lm_head"], ("lm_head",))

    def count(m):
        total = m.sum()
        return total if group is None else all_reduce(total.detach(), group)

    if not chunk or S == chunk:
        logp = torch.log_softmax(unembed(head, x, cfg), dim=-1)
        nll = -_gather_target(logp, targets)
        denom = torch.clamp(count(mask), min=1.0)
        ce = (nll * mask).sum() / denom
    else:
        def ce_chunk(xc, tc, mc):
            logits = unembed(head, xc, cfg)                # [B, chunk, V] float32
            logz = torch.logsumexp(logits, dim=-1)
            tgt = _gather_target(logits, tc)
            return ((logz - tgt) * mc).sum()

        nll_total = torch.zeros((), dtype=torch.float32, device=x.device)
        mask_total = torch.zeros((), dtype=torch.float32, device=x.device)
        for c in range(0, S, chunk):
            sl = slice(c, c + chunk)
            nll_total = nll_total + checkpoint(
                ce_chunk, x[:, sl], targets[:, sl], mask[:, sl], use_reentrant=False)
            mask_total = mask_total + mask[:, sl].sum()
        denom = torch.clamp(count(mask_total), min=1.0)
        ce = nll_total / denom
    loss = ce + cfg.router_aux_loss_weight * moe_aux
    return loss, {"ce_loss": ce, "moe_aux": moe_aux, "tokens": denom}
