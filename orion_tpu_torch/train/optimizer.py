"""AdamW / momentum SGD with explicit state, and the learning-rate schedules.

A copy of ``orion_tpu/train/optimizer.py``'s replicated path and of its
full-precision ZeRO-1 path (no manual quantized path): the state is a
plain tree ``{"mu": <like params>, "nu": <like params>, "count": int}``
with moments in ``optimizer.moment_dtype``; the per-leaf math runs in
float32 and casts back to each leaf's dtype. Unlike the JAX package's pure
functions, ``apply_updates`` writes the new parameters and moments into
the existing tensors in place (under ``torch.no_grad``), so a step holds
one extra float32 leaf at a time rather than a second copy of the state.

ZeRO-1 (``train.zero1``; a ``Zero1Plan``): the gradients arrive
reduce-scattered over ``dp`` onto each leaf's update dimension
(``parallel/data_parallel.py``), the moments hold the rank's 1/dp block of
each leaf, and so does the float32 ``master`` where
``zero1_master_split`` (``model.param_dtype`` != ``model.dtype``: the
parameters are then the working copy in ``model.dtype``). The update runs
on the rank's block and the updated blocks are all-gathered back into the
parameters in the working dtype, one flat buffer per dtype. A leaf with
no update dimension updates whole on every rank.

The schedules reproduce optax's ``linear_schedule``, ``join_schedules``
and ``warmup_cosine_decay_schedule`` arithmetic in float32 (numpy), as
optax evaluates them on an int32 step count under jit.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional

import numpy as np
import torch

from orion_tpu_torch.comm import collectives as C
from orion_tpu_torch.config import Config, OptimizerConfig
from orion_tpu_torch.models.convert import (
    jax_leaves_with_path,
    tree_leaves,
    tree_leaves_with_path,
    tree_unflatten,
)
from orion_tpu_torch.models.transformer import torch_dtype

OptState = dict[str, Any]

# Parameter leaves exempt from weight decay: norm scales and all biases.
_NO_DECAY_KEYS = frozenset(
    {"scale", "bias", "bq", "bk", "bv", "bo", "b_in", "b_out"}
)

_F32 = np.float32


def _linear(init: float, end: float, steps: int) -> Callable[[int], float]:
    """optax.linear_schedule (polynomial_schedule with power 1)."""
    if steps <= 0:
        return lambda count: _F32(init)

    def schedule(count):
        c = _F32(min(max(count, 0), steps))
        frac = _F32(1) - c / _F32(steps)
        return _F32(init - end) * frac + _F32(end)

    return schedule


def _cosine(init: float, decay_steps: int, alpha: float) -> Callable[[int], float]:
    """optax.cosine_decay_schedule with exponent 1."""
    if not decay_steps > 0:
        raise ValueError(f"cosine decay needs positive decay_steps, got {decay_steps}")

    def schedule(count):
        c = _F32(min(float(count), float(decay_steps)))
        cosine = _F32(0.5) * (_F32(1) + np.cos(_F32(math.pi) * c / _F32(decay_steps)))
        decayed = _F32(1 - alpha) * cosine + _F32(alpha)
        return _F32(init) * decayed

    return schedule


def _join(schedules, boundaries) -> Callable[[int], float]:
    """optax.join_schedules."""

    def schedule(step):
        out = schedules[0](step)
        for boundary, sched in zip(boundaries, schedules[1:]):
            if step >= boundary:
                out = sched(step - boundary)
        return out

    return schedule


def make_schedule(cfg: OptimizerConfig, num_steps: int) -> Callable[[int], float]:
    """step count (int) -> learning rate (a float32 value, as a float)."""
    decay_steps = cfg.decay_steps if cfg.decay_steps is not None else num_steps
    # Keep schedules well-formed when num_steps < warmup (smoke tests).
    decay_steps = max(decay_steps, cfg.warmup_steps + 1)
    peak, floor = cfg.learning_rate, cfg.learning_rate * cfg.min_lr_ratio
    warm = _linear(0.0, peak, cfg.warmup_steps)
    if cfg.schedule == "constant":
        rest = lambda count: _F32(peak)  # noqa: E731
    elif cfg.schedule == "linear":
        rest = _linear(peak, floor, max(decay_steps - cfg.warmup_steps, 1))
    else:
        alpha = 0.0 if peak == 0.0 else floor / peak
        rest = _cosine(peak, decay_steps - cfg.warmup_steps, alpha)
    joined = _join([warm, rest], [cfg.warmup_steps])
    return lambda count: float(joined(int(count)))


@dataclasses.dataclass(frozen=True)
class Zero1Plan:
    """How the weight update shards across ``dp``: the ``dp`` group, its
    size ``n``, this rank's ``index`` on it, and per parameter leaf (in
    ``tree_leaves`` order) the update dim, -1 for a replicated update."""

    group: Any
    n: int
    index: int
    dims: tuple

    def block(self, t: torch.Tensor, i: int) -> torch.Tensor:
        """This rank's block of leaf ``i`` (a view; the leaf itself at -1)."""
        return t if self.dims[i] < 0 else self.block_of(t, i, self.index)

    def gather_into(self, leaves: list, blocks: dict) -> None:
        """Write every rank's ``blocks[i]`` into ``leaves[i]`` (``i`` a leaf
        index of the plan) along its update dim: one all-gather per dtype
        of the blocks laid end to end."""
        for dtype in sorted({b.dtype for b in blocks.values()}, key=str):
            part = [i for i, b in blocks.items() if b.dtype == dtype]
            flat = C._all_gather(torch.cat([blocks[i].reshape(-1) for i in part]),
                                 self.group, 0, True).view(self.n, -1)
            sizes = [blocks[i].numel() for i in part]
            for r in range(self.n):
                for i, piece in zip(part, flat[r].split(sizes)):
                    self.block_of(leaves[i], i, r).copy_(piece.view_as(blocks[i]))

    def block_of(self, t: torch.Tensor, i: int, r: int) -> torch.Tensor:
        """Rank ``r``'s block of leaf ``i`` (a view)."""
        return t.chunk(self.n, self.dims[i])[r]


def zero1_master_split(cfg: Config) -> bool:
    """Whether ZeRO-1 carries a separate dp-sharded master copy: with
    ``model.param_dtype`` != ``model.dtype`` the parameters are the working
    copy the forward reads and ``opt["master"]`` the full-precision source
    of truth (the JAX package's rule, whose int8 wire legs are not
    ported)."""
    if not cfg.train.zero1:
        return False
    if torch_dtype(cfg.model.param_dtype) != torch_dtype(cfg.model.dtype):
        return True
    return cfg.train.zero1_quantize in ("int8", "ag_int8")


def init_opt_state(params: Any, cfg: OptimizerConfig, *, master: bool = False,
                   zero1: Optional[Zero1Plan] = None) -> OptState:
    """Fresh optimizer state for ``params`` (moments in moment_dtype, on
    each parameter's device). With ``zero1`` the moments are the rank's
    blocks; with ``master`` the state also holds a copy of ``params`` (the
    rank's blocks under ``zero1``), which must still be in param_dtype
    here: the caller casts the working copy down afterwards."""
    mdt = torch_dtype(cfg.moment_dtype)
    leaves = tree_leaves(params)
    blocks = (leaves if zero1 is None
              else [zero1.block(p, i) for i, p in enumerate(leaves)])
    state = {"mu": tree_unflatten(params, [torch.zeros(b.shape, dtype=mdt, device=b.device)
                                           for b in blocks]),
             "nu": tree_unflatten(params, [torch.zeros(b.shape, dtype=mdt, device=b.device)
                                           for b in blocks]),
             "count": 0}
    if master:
        state["master"] = tree_unflatten(params, [b.clone() for b in blocks])
    return state


def _decay_mask(path: tuple) -> bool:
    """Decay unless the leaf's last dict key names a norm scale or a bias."""
    keys = [k for k in path if isinstance(k, str)]
    return not keys or keys[-1] not in _NO_DECAY_KEYS


def global_norm(tree: Any) -> torch.Tensor:
    """The L2 norm over every leaf, summed in ``jax.tree_util``'s leaf order
    (as optax sums): the same bits whatever order the tree's dicts were
    built in, so a run resumed from a checkpoint clips as the run that
    wrote it."""
    return torch.sqrt(sum(torch.sum(torch.square(leaf.float()))
                          for _, leaf in jax_leaves_with_path(tree)))


def tree_all_finite(tree: Any) -> torch.Tensor:
    """0-d bool tensor: every element of every floating leaf is finite
    (integer leaves are skipped)."""
    ok = None
    for leaf in tree_leaves(tree):
        if torch.is_tensor(leaf) and leaf.is_floating_point():
            fin = torch.isfinite(leaf).all()
            ok = fin if ok is None else ok & fin
    return ok if ok is not None else torch.tensor(True)


def _clip_scale(cfg: OptimizerConfig, gnorm: torch.Tensor) -> torch.Tensor:
    if cfg.grad_clip_norm > 0:
        return torch.clamp(cfg.grad_clip_norm / (gnorm + 1e-9), max=1.0)
    return torch.ones((), dtype=torch.float32, device=gnorm.device)


def _make_leaf_update(
    cfg: OptimizerConfig, learning_rate: float, scale: torch.Tensor, count: int
):
    """The per-leaf AdamW/SGD math in float32; the new value keeps p's
    dtype, the moments take moment_dtype."""
    cf = torch.tensor(count, dtype=torch.float32)
    bc1 = float(1.0 - torch.tensor(cfg.b1, dtype=torch.float32) ** cf)
    bc2 = float(1.0 - torch.tensor(cfg.b2, dtype=torch.float32) ** cf)
    mdt = torch_dtype(cfg.moment_dtype)

    def upd(path, p, g, mu, nu):
        g = g.float() * scale
        if cfg.name == "sgd":
            # Momentum SGD: mu is the velocity; nu rides along unused so the
            # state tree has one shape for every optimizer.
            mu_f = cfg.b1 * mu.float() + g
            step = mu_f
            nu_f = nu.float()
        else:
            mu_f = cfg.b1 * mu.float() + (1 - cfg.b1) * g
            nu_f = cfg.b2 * nu.float() + (1 - cfg.b2) * torch.square(g)
            step = (mu_f / bc1) / (torch.sqrt(nu_f / bc2) + cfg.eps)
        if cfg.weight_decay > 0 and _decay_mask(path):
            step = step + cfg.weight_decay * p.float()
        new_p = p.float() - learning_rate * step
        return new_p.to(p.dtype), mu_f.to(mdt), nu_f.to(mdt)

    return upd


@torch.no_grad()
def apply_updates(
    params: Any,
    grads: Any,
    opt_state: OptState,
    cfg: OptimizerConfig,
    learning_rate: float,
    gnorm: Optional[torch.Tensor] = None,
    zero1: Optional[Zero1Plan] = None,
) -> tuple[Any, OptState, dict[str, torch.Tensor]]:
    """One optimizer update, written into ``params`` and ``opt_state`` in
    place. Returns (params, opt_state, {"grad_norm"}). ``gnorm`` lets a
    caller that computed the global grad norm already share it; it is
    required with ``zero1`` (the norm over the mesh,
    ``DataParallel.global_norm``), whose gradients are the rank's blocks."""
    if cfg.name not in ("adamw", "sgd"):
        raise ValueError(f"unknown optimizer {cfg.name!r}")
    if gnorm is None:
        if zero1 is not None:
            raise ValueError("apply_updates(zero1=...) needs the global gnorm")
        gnorm = global_norm(grads)
    scale = _clip_scale(cfg, gnorm)
    count = opt_state["count"] + 1
    upd = _make_leaf_update(cfg, float(learning_rate), scale, count)
    masters = tree_leaves(opt_state["master"]) if "master" in opt_state else None
    gathered = {}   # ZeRO-1: leaf index -> this rank's updated block
    for i, ((path, p), g, mu, nu) in enumerate(zip(
        tree_leaves_with_path(params), tree_leaves(grads),
        tree_leaves(opt_state["mu"]), tree_leaves(opt_state["nu"]),
    )):
        if zero1 is None:
            new_p, new_mu, new_nu = upd(path, p, g, mu, nu)
            p.copy_(new_p)
        else:
            # The update source is the master block, else this rank's block
            # of the parameters; the updated blocks come back whole below.
            src = masters[i] if masters is not None else zero1.block(p, i)
            new_p, new_mu, new_nu = upd(path, src, g, mu, nu)
            if masters is not None:
                src.copy_(new_p)
            if zero1.dims[i] < 0:
                p.copy_(new_p)
            else:
                gathered[i] = new_p.to(p.dtype)
        mu.copy_(new_mu)
        nu.copy_(new_nu)
    if gathered:
        zero1.gather_into(tree_leaves(params), gathered)
    opt_state["count"] = count
    return params, opt_state, {"grad_norm": gnorm}
