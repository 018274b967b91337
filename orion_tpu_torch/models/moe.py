"""Mixture-of-experts layer with capacity-based top-k dispatch.

Counterpart of ``orion_tpu/models/moe.py`` (Mixtral family). Every shape
is static, so an MoE layer runs inside a captured CUDA graph: routing is
integer arithmetic on the device and nothing reads a value back to the
host. Assignments past an expert's capacity are dropped (Switch-style).
Two dispatch modes (``model.moe_dispatch``), with the same drop rule:

  - **einsum**: dispatch and combine are einsums against a one-hot
    [B, S, E, C] tensor (``route``, ``moe_mlp``);
  - **sorted**: integer routing (cumsum positions), tokens added into
    [E, C] capacity buckets by index, batched expert matmuls over the
    buckets, combine by gather (``route_indices``, ``moe_mlp_sorted``).

``sorted_a2a`` is ``sorted`` at ep = 1, as in the JAX package; its
explicit all-to-all over an ``ep`` axis waits for expert parallelism.

Capacity is ``C = max(int(capacity_factor * S * k / E), 1)`` per batch
row of whatever [rows, S, D] the caller hands the layer, padding
included, and every top-1 choice claims before any top-2 choice. The aux
load-balancing loss follows Switch / Mixtral: E * sum_e f_e * p_e.

An expert index outside [0, E) (a corrupted router) drops its
assignment in both dispatches, as ``jax.nn.one_hot`` makes the JAX
package's einsum dispatch do: its one-hot row is zeros (``_one_hot``, a
comparison with ``arange(E)``), so it claims no capacity, counts in no
expert's load and adds nothing to the output; the sorted dispatch keeps
it out of ``keep`` and indexes with a clamped copy. With
``model.debug_asserts`` the routing raises instead
(``runtime/asserts.py``: ``moe_route_idx``, ``moe_route_pos``).
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from orion_tpu_torch.config import ModelConfig
from orion_tpu_torch.models.remat import named, product
from orion_tpu_torch.runtime.asserts import device_assert
from orion_tpu_torch.runtime.mesh import axis_size

Params = dict[str, Any]


def moe_capacity(cfg: ModelConfig, tokens_per_group: int) -> int:
    cap = int(cfg.capacity_factor * tokens_per_group * cfg.n_experts_per_token
              / cfg.n_experts)
    return max(cap, 1)


def _router_topk(
    x: torch.Tensor, router_w: torch.Tensor, cfg: ModelConfig
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Shared router head: (probs [B,S,E] f32, gate [B,S,k] f32
    renormalized, idx [B,S,k] int64).

    The logits are float32 (the JAX package einsums the activations
    against the float32 router with a float32 result); the top k is a
    stable argsort of -probs, so ties keep the lower expert first as
    ``jnp.argsort`` does (``torch.topk`` may order them otherwise)."""
    logits = product(x.float(), router_w.float())
    probs = torch.softmax(logits, dim=-1)
    idx = torch.argsort(-probs, dim=-1, stable=True)[..., : cfg.n_experts_per_token]

    def gates(p):
        g = torch.gather(p, -1, idx)
        return g / torch.clamp(g.sum(-1, keepdim=True), min=1e-9)

    # remat="names" saves the gates (models/remat.py).
    return probs, named("moe_router_gate", gates, probs), idx


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """[..., n] bool: True where ``idx == j``; all False for an index
    outside [0, n), as ``jax.nn.one_hot`` gives zeros there
    (``F.one_hot`` raises, or asserts on the card)."""
    return idx[..., None] == torch.arange(n, device=idx.device)


def _assert_idx(idx: torch.Tensor, cfg: ModelConfig) -> None:
    E = cfg.n_experts
    device_assert(cfg.debug_asserts, (idx >= 0) & (idx < E), "moe_route_idx",
                  f"router expert index outside [0, {E})")


def _assert_pos(pos: torch.Tensor, bound: int, cfg: ModelConfig) -> None:
    """pos counts the assignments before each one in its [k*S] stream, so
    the invariant is 0 <= pos < k*S (pos < C is ``keep``'s definition)."""
    device_assert(cfg.debug_asserts, (pos >= 0) & (pos < bound), "moe_route_pos",
                  f"capacity position outside the assignment-stream bound [0, {bound})")


def _aux_stats(
    probs: torch.Tensor, idx: torch.Tensor, cfg: ModelConfig
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-expert (assignment fraction [E], mean router prob [E]): the two
    token means of the Switch load-balance loss."""
    E, k = cfg.n_experts, cfg.n_experts_per_token
    onehot = _one_hot(idx, E).float()                     # [B,S,k,E]
    frac = onehot.sum(dim=2).mean(dim=(0, 1)) / k
    mean_prob = probs.mean(dim=(0, 1))
    return frac, mean_prob


def _aux_loss(probs: torch.Tensor, idx: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Switch eq. 4 load-balance loss: E * sum_e fraction_e * mean-prob_e."""
    frac, mean_prob = _aux_stats(probs, idx, cfg)
    return cfg.n_experts * torch.sum(frac * mean_prob)


def route(
    x: torch.Tensor, router_w: torch.Tensor, cfg: ModelConfig
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Router: (dispatch [B,S,E,C], combine [B,S,E,C], aux_loss)."""
    B, S, _ = x.shape
    E, k = cfg.n_experts, cfg.n_experts_per_token
    C = moe_capacity(cfg, S)
    probs, gate, idx = _router_topk(x, router_w, cfg)
    _assert_idx(idx, cfg)
    # Slot-major priority: all slot-0 (top-1) choices claim capacity before
    # any slot-1 choice.
    onehot = _one_hot(idx, E).float()                     # [B,S,k,E]
    prio = onehot.transpose(1, 2).reshape(B, k * S, E)    # [B,kS,E]
    pos = torch.cumsum(prio, dim=1) - prio                # position within expert
    _assert_pos(pos, k * S, cfg)
    keep = (pos < C).float() * prio
    # One-hot of the position; a position >= C (never kept) is all zeros.
    pos_oh = (pos.long()[..., None] == torch.arange(C, device=x.device)).float()
    disp_flat = (keep[..., None] * pos_oh).reshape(B, k, S, E, C)
    disp = disp_flat.sum(dim=1)                           # [B,S,E,C]
    gate_slot = gate.transpose(1, 2)[..., None, None]     # [B,k,S,1,1]
    comb = (disp_flat * gate_slot).sum(dim=1)
    return disp, comb, _aux_loss(probs, idx, cfg)


def _expert_ffn(xin: torch.Tensor, params: Params, cfg: ModelConfig) -> torch.Tensor:
    """Batched expert feed-forward on capacity buckets: xin [E, B, C, D]
    -> [E, B, C, D], one batched product per weight over all E experts."""
    from orion_tpu_torch.models.transformer import _gate_act

    E, B, C, D = xin.shape
    xf = xin.reshape(E, B * C, D)
    h_in = torch.bmm(xf, params["w_in"])
    if cfg.is_gated_mlp:
        h = _gate_act(cfg)(torch.bmm(xf, params["w_gate"])) * h_in
    else:
        h = F.gelu(h_in, approximate="tanh")
    return torch.bmm(h, params["w_out"]).reshape(E, B, C, D)


def moe_mlp(x: torch.Tensor, params: Params, cfg: ModelConfig
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """The einsum dispatch. x [B,S,D] -> ([B,S,D], aux_loss float32).
    params: router [D,E]; w_in, w_gate [E,D,F]; w_out [E,F,D]."""
    dtype = x.dtype
    disp, comb, aux = route(x, params["router"], cfg)
    xin = torch.einsum("bsec,bsd->ebcd", disp.to(dtype), x)
    out = _expert_ffn(xin, params, cfg)
    y = torch.einsum("bsec,ebcd->bsd", comb.to(dtype), out)
    return y, aux.float()


def route_indices(x: torch.Tensor, router_w: torch.Tensor, cfg: ModelConfig):
    """Integer routing for the sorted dispatch: (idx [B,S,k] expert per
    assignment, gate [B,S,k] f32, pos [B,S,k] position within the expert's
    capacity, keep [B,S,k] bool, (frac, mean_prob) as ``_aux_stats``).
    The drop rule is ``route``'s: slot-major priority, first come within a
    slot, capacity C per expert per batch row. An index outside [0, E) is
    not kept, and the returned idx holds 0 in its place (the stats count
    it in no expert)."""
    B, S, _ = x.shape
    E, k = cfg.n_experts, cfg.n_experts_per_token
    C = moe_capacity(cfg, S)
    probs, gate, idx = _router_topk(x, router_w, cfg)
    _assert_idx(idx, cfg)
    stats = _aux_stats(probs, idx, cfg)
    valid = (idx >= 0) & (idx < E)
    idx = torch.where(valid, idx, 0)
    idx_km = idx.transpose(1, 2).reshape(B, k * S)         # slot-major stream
    onehot = _one_hot(idx_km, E).to(torch.int32)           # [B, kS, E]
    onehot = onehot * valid.transpose(1, 2).reshape(B, k * S, 1)
    pos_all = torch.cumsum(onehot, dim=1, dtype=torch.int32) - onehot
    pos_km = torch.gather(pos_all, -1, idx_km[..., None])[..., 0]
    pos = pos_km.reshape(B, k, S).transpose(1, 2)           # [B, S, k]
    _assert_pos(pos, k * S, cfg)
    keep = (pos < C) & valid
    return idx, gate, pos, keep, stats


def _scatter_dispatch(x, idx, pos, keep, E: int, C: int) -> torch.Tensor:
    """Tokens -> capacity buckets by index. x [B,S,D] -> [E, B, C, D].

    Dropped assignments land in a trash row (C) that is sliced off; kept
    (expert, pos) pairs are unique per batch row, so the accumulating
    index write adds each kept token onto zeros exactly once, and its
    gradient is the plain gather."""
    B, S, D = x.shape
    k = idx.shape[-1]
    b_ix = torch.arange(B, device=x.device)[:, None, None]
    pos_c = torch.where(keep, pos, C).long()
    flat = ((b_ix * E + idx) * (C + 1) + pos_c).reshape(-1)        # [B*S*k]
    src = x[:, :, None, :].expand(B, S, k, D).reshape(-1, D)
    xin = x.new_zeros(B * E * (C + 1), D).index_add(0, flat, src)
    return xin.view(B, E, C + 1, D)[:, :, :C].transpose(0, 1)      # [E, B, C, D]


def _gather_combine(out, idx, pos, keep, gate, dtype) -> torch.Tensor:
    """Inverse of ``_scatter_dispatch``: per-assignment gather and a
    gate-weighted sum over the k slots, accumulated in float32 and
    rounded once, as a dot in ``dtype`` does. out [E, B, C, D] -> [B, S, D]."""
    E, B, C, D = out.shape
    S, k = idx.shape[1], idx.shape[2]
    b_ix = torch.arange(B, device=out.device)[:, None, None]
    flat = ((b_ix * E + idx) * C + torch.clamp(pos, max=C - 1).long()).reshape(-1)
    got = out.transpose(0, 1).reshape(B * E * C, D).index_select(0, flat)
    got = got.view(B, S, k, D)
    w = (gate * keep.to(gate.dtype)).to(dtype)
    return (got.float() * w.float()[..., None]).sum(dim=2).to(dtype)


def moe_mlp_sorted(x: torch.Tensor, params: Params, cfg: ModelConfig
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """The sorted dispatch: no one-hot products, the drop rule of
    ``moe_mlp``. x [B,S,D] -> ([B,S,D], aux_loss float32)."""
    E, C = cfg.n_experts, moe_capacity(cfg, x.shape[1])
    idx, gate, pos, keep, (frac, mp) = route_indices(x, params["router"], cfg)
    xin = _scatter_dispatch(x, idx, pos, keep, E, C)
    out = _expert_ffn(xin, params, cfg)
    y = _gather_combine(out, idx, pos, keep, gate, x.dtype)
    aux = E * torch.sum(frac * mp)
    return y, aux.float()


def moe_mlp_sorted_a2a(x, params, cfg: ModelConfig, mesh=None):
    """The sorted dispatch with an explicit all-to-all over ``ep``: at
    ep = 1 it is ``moe_mlp_sorted``; above, it waits for expert
    parallelism."""
    ep = axis_size(mesh, "ep")
    if ep == 1:
        return moe_mlp_sorted(x, params, cfg)
    raise NotImplementedError(
        f"moe_dispatch=sorted_a2a at ep={ep}: expert parallelism (EP) is not "
        f"ported to orion_tpu_torch yet"
    )


def moe_dispatch(x: torch.Tensor, params: Params, cfg: ModelConfig, mesh=None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Entry point: the dispatch ``cfg.moe_dispatch`` names."""
    mode = cfg.moe_dispatch
    if mode == "einsum":
        return moe_mlp(x, params, cfg)
    if mode == "sorted":
        return moe_mlp_sorted(x, params, cfg)
    if mode == "sorted_a2a":
        return moe_mlp_sorted_a2a(x, params, cfg, mesh)
    raise ValueError(f"unknown model.moe_dispatch={mode!r}")
