"""The trainer's data-parallel mesh: DDP, FSDP and ZeRO-1 over the
``dp`` x ``fsdp`` (x ``sp``) axes, one process a device.

Counterpart of what the JAX trainer leaves to XLA's partitioner once the
sharding rules are set (``orion_tpu/parallel/sharding.py``,
``orion_tpu/train/trainer.py``): here each collective is explicit.

- **Rows.** The global batch splits over ``dp`` x ``fsdp`` in the JAX
  device order (``batch_spec``: rank (dp, fsdp) holds rows block
  dp * fsdp_size + fsdp), then, at sp > 1, into the rank's contiguous
  sequence slice. The loader stays global on every rank, so every stream
  cursor agrees.
- **FSDP** (``parallel.fsdp``). Every leaf with an ``embed`` dimension lives
  as the rank's 1/fsdp block along it (``param_layout``). ``FsdpGather``
  gathers a leaf where it is used: each block's leaves inside the block
  (so inside ``models.remat``'s ``_RematBlock``: a replay gathers again and
  no gathered layer is saved), the embedding table and the LM head where
  the loss reads them. The gather casts the shard to the compute dtype
  first (the use would cast the whole leaf the same way; norm scales keep
  theirs); its transpose is the reduce-scatter over ``fsdp``, in the
  shard's own dtype, so each rank's gradient comes back as its block
  summed over the ``fsdp`` ranks.
- **Reduction** (``reduce``). A gradient is summed over the axes that hold
  replicas of it: ``sp`` always, ``fsdp`` where the leaf is not sharded
  along it; then over ``dp``: an all-reduce, or with ``train.zero1`` a
  reduce-scatter onto the leaf's ``zero1_update_dim`` (replicated update
  where it has none). Each stage is one flat buffer per dtype. The loss
  and its aux terms (each rank's share of the global token mean) are
  summed over every data axis, and with them this rank's preemption flag
  (``preempted``, as it stood when the step began): ``preempt_vote`` is
  then above 0 on every rank if any rank was preempted, at no collective
  of its own.
- **The clip norm** (``global_norm``). Each leaf's squared sum is taken in
  ``dp`` parts along its ZeRO-1 dimension (whole where it has none), with
  or without ZeRO-1, and summed over ``fsdp`` blocks, so the two layouts
  reduce the same numbers in the same order and ZeRO-1 reproduces the
  plain data-parallel run bit for bit.
- **The guard's vote** (``all_ranks``): a step is anomalous if any rank
  saw a non-finite value; every rank then skips it.

``FsdpGather``'s ``collect`` and ``scatter`` are the seam the collectives
ride: a caller may pass its own. ``DataParallel(cfg, None, sizes=...,
coords=..., collect=..., scatter=...)`` is one rank's share on one device
with no process group: every reduction over the mesh is left out (the
rank's own gradient blocks, its own part of the norm) and the gather
takes the peers' blocks from wherever ``collect`` holds them
(``chip_smoke.py``'s ``fsdp_rank``).
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import numpy as np
import torch

from orion_tpu_torch.comm import collectives as C
from orion_tpu_torch.models.convert import (
    jax_leaves_with_path,
    shard_params,
    tree_leaves_with_path,
    tree_unflatten,
)
from orion_tpu_torch.models.transformer import torch_dtype
from orion_tpu_torch.parallel.sharding import (
    batch_spec,
    block_index,
    layout_at,
    param_layout,
)
from orion_tpu_torch.runtime.distributed import _group_device
from orion_tpu_torch.runtime.mesh import coords as mesh_coords
from orion_tpu_torch.runtime.mesh import group_of
from orion_tpu_torch.runtime.mesh import sizes as mesh_sizes

DATA_AXES = ("dp", "fsdp", "sp")


def keeps_dtype(path: tuple) -> bool:
    """Leaves gathered in their own dtype: norm scales and biases, which
    the norms read as they are stored."""
    return any(isinstance(k, str) and k.endswith("norm") for k in path)


class _Gather(torch.autograd.Function):
    """One leaf gathered where used: forward ``collect``, backward
    ``scatter`` (the gather's transpose) in the shard's dtype."""

    @staticmethod
    def forward(ctx, shard, g, path, dim, dtype):
        ctx.g, ctx.path, ctx.dim, ctx.dtype = g, path, dim, shard.dtype
        return g.collect(shard.to(dtype), dim, path)

    @staticmethod
    def backward(ctx, grad):
        return ctx.g.scatter(grad.to(ctx.dtype), ctx.dim, ctx.path), None, None, None, None


class FsdpGather:
    """Gather-where-used of the fsdp-sharded leaves (see the module note).

    ``layout`` is ``param_layout``'s tree, ``group`` the ``fsdp`` group,
    ``dtype`` the compute dtype. ``collect(shard, dim, path)`` returns the
    whole leaf and ``scatter(grad, dim, path)`` the gradient of this rank's
    block; by default the all-gather over ``group`` and its reduce-scatter.
    ``CALLS["fsdp_gather"]`` counts the gathers (forward, replays
    included)."""

    def __init__(self, layout: Any, group, dtype, collect: Optional[Callable] = None,
                 scatter: Optional[Callable] = None):
        self.layout, self.group, self.dtype = layout, group, torch_dtype(dtype)
        self.collect = collect or self._all_gather
        self.scatter = scatter or self._reduce_scatter

    def _all_gather(self, t, dim, path):
        return C._all_gather(t, self.group, dim, True)

    def _reduce_scatter(self, g, dim, path):
        return C._reduce_scatter(g, self.group, dim)

    def leaf(self, t: torch.Tensor, path: tuple) -> torch.Tensor:
        """The whole leaf of the shard ``t`` at ``path`` (itself where the
        leaf is not fsdp-sharded), in the compute dtype (norm parameters in
        their own)."""
        dim = layout_at(self.layout, path).fsdp_dim
        if dim is None:
            return t
        C.CALLS["fsdp_gather"] += 1
        dtype = t.dtype if keeps_dtype(path) else self.dtype
        return _Gather.apply(t, self, path, dim, dtype)

    def tree(self, sub: Any, prefix: tuple) -> Any:
        """A subtree (``prefix`` its path in the parameters) with every
        leaf gathered."""
        return tree_unflatten(sub, [self.leaf(t, prefix + path)
                                    for path, t in tree_leaves_with_path(sub)])


class DataParallel:
    """The trainer's view of the mesh (see the module note): this rank's
    rows, the parameter layout, the gather, the gradient reduction, the
    clip norm and the votes."""

    def __init__(self, cfg, mesh, *, sizes: Optional[dict] = None,
                 coords: Optional[dict] = None, collect: Optional[Callable] = None,
                 scatter: Optional[Callable] = None):
        self.mesh = mesh
        self.sizes = dict(sizes) if sizes is not None else mesh_sizes(mesh)
        self.coords = dict(coords) if coords is not None else mesh_coords(mesh)
        self.dp, self.fsdp, self.sp = (self.sizes.get(a, 1) for a in DATA_AXES)
        self.zero1 = bool(cfg.train.zero1)
        self.layout = param_layout(cfg.model, self.sizes, self.zero1)
        self.gather = (FsdpGather(self.layout, self.group("fsdp"), cfg.model.dtype,
                                  collect, scatter)
                       if self.fsdp > 1 else None)
        # This rank's preemption flag, set before a step; the step's vote
        # on it (None where no scalar reduction ran).
        self.preempted = False
        self.preempt_vote: Optional[torch.Tensor] = None

    @property
    def rows(self) -> int:
        """Ranks the batch rows split over (dp x fsdp)."""
        return self.dp * self.fsdp

    def group(self, *axes):
        """The process group of ``axes`` (None on one device, or where none
        is above 1)."""
        return None if self.mesh is None else group_of(self.mesh, axes)

    def _sum(self, x: torch.Tensor, *axes) -> torch.Tensor:
        group = self.group(*axes)
        return x if group is None else C._all_reduce(x, group, "sum")

    # -- rows -------------------------------------------------------------

    def local_rows(self, host: dict, accum: int, seq_slice: bool = True) -> dict:
        """This rank's share of a host batch: its rows (of each microbatch
        under ``accum`` > 1: leaves [A, b, S]) and, at sp > 1 with
        ``seq_slice``, its sequence slice, with the slice's global
        positions where the batch has none."""
        host = dict(host)
        if self.sp > 1 and seq_slice and "positions" not in host:
            S = host["inputs"].shape[-1]
            host["positions"] = np.broadcast_to(np.arange(S, dtype=np.int32),
                                                host["inputs"].shape)
        if accum > 1:
            host = {k: v.reshape(accum, v.shape[0] // accum, *v.shape[1:])
                    for k, v in host.items()}
        spec = (None,) * (accum > 1) + batch_spec(
            self.sizes, shard_seq=seq_slice and self.sp > 1)
        out = {}
        for k, v in host.items():
            idx = block_index(v.shape, spec, self.sizes, self.coords)
            out[k] = v[tuple(slice(a, b) for a, b in idx)]
        return out

    # -- state ------------------------------------------------------------

    def shard(self, tree: Any, state: bool = False) -> Any:
        """This rank's blocks of a whole (per-layer) parameter tree
        (``models.convert.shard_params``)."""
        return shard_params(tree, self.layout, self.sizes, self.coords, state)

    # -- gradients ----------------------------------------------------------

    def _sum_flat(self, grads: list, idx: list, group) -> None:
        """All-reduce ``grads[i]`` for ``i`` in ``idx`` over ``group`` as one
        flat buffer per dtype, in place of the list's entries."""
        for dtype in sorted({grads[i].dtype for i in idx}, key=str):
            part = [i for i in idx if grads[i].dtype == dtype]
            flat = C._all_reduce(torch.cat([grads[i].reshape(-1) for i in part]), group, "sum")
            for i, piece in zip(part, flat.split([grads[i].numel() for i in part])):
                grads[i] = piece.view_as(grads[i])

    def _scatter_flat(self, grads: list, idx: list, dims: list) -> None:
        """ZeRO-1's reduce-scatter over ``dp``: each leaf's dp blocks along
        its update dim, rank-major in one flat buffer per dtype; this rank
        keeps its block of each."""
        group = self.group("dp")
        for dtype in sorted({grads[i].dtype for i in idx}, key=str):
            part = [(i, d) for i, d in zip(idx, dims) if grads[i].dtype == dtype]
            chunks = [[c.reshape(-1) for c in grads[i].chunk(self.dp, d)] for i, d in part]
            flat = torch.cat([c[r] for r in range(self.dp) for c in chunks])
            mine = C._reduce_scatter(flat, group, 0)
            sizes = [c[0].numel() for c in chunks]
            for (i, d), piece in zip(part, mine.split(sizes)):
                shape = list(grads[i].shape)
                shape[d] //= self.dp
                grads[i] = piece.view(shape)

    def reduce(self, loss, aux, grads: list, params: Any):
        """(loss, aux, grads as a tree): each rank's shares summed over the
        mesh (see the module note). ``grads`` is in ``tree_leaves`` order of
        ``params``."""
        paths = [p for p, _ in tree_leaves_with_path(params)]
        lays = [layout_at(self.layout, p) for p in paths]
        with torch.no_grad():
            by_group: dict = {}
            for i, lay in enumerate(lays):
                axes = ("sp",) + (("fsdp",) if lay.fsdp_dim is None else ())
                by_group.setdefault(axes, []).append(i)
            for axes, idx in by_group.items():
                group = self.group(*axes)
                if group is not None:
                    self._sum_flat(grads, idx, group)
            if self.group("dp") is not None:
                split = [i for i, lay in enumerate(lays) if self.zero1 and lay.zero1_dim >= 0]
                rest = [i for i in range(len(lays)) if i not in set(split)]
                if rest:
                    self._sum_flat(grads, rest, self.group("dp"))
                if split:
                    self._scatter_flat(grads, split, [lays[i].zero1_dim for i in split])
            if self.group(*DATA_AXES) is not None:
                flag = loss.new_full((), float(self.preempted), dtype=torch.float32)
                scalars = self._sum(torch.stack([loss.float(), aux["ce_loss"].float(),
                                                 aux["moe_aux"].float(), flag]), *DATA_AXES)
                loss = scalars[0]
                aux = dict(aux, ce_loss=scalars[1], moe_aux=scalars[2])
                self.preempt_vote = scalars[3]
        return loss, aux, tree_unflatten(params, grads)

    def global_norm(self, grads: Any) -> torch.Tensor:
        """The global L2 norm of the reduced gradients (the module note's
        order): squared sums [dp parts, leaves in ``jax.tree_util`` order],
        each part summed over the ranks that hold it."""
        leaves = jax_leaves_with_path(grads)
        dev = leaves[0][1].device
        parts = torch.zeros(self.dp, len(leaves), dtype=torch.float32, device=dev)
        me_dp, me_fsdp = self.coords["dp"], self.coords["fsdp"]

        def sq(t):
            # Contiguous, so a chunk sums in the layout of ZeRO-1's block
            # (the same bits); a chunk along a leading dim is not copied.
            return torch.sum(torch.square(t.contiguous().float()))

        for i, (path, g) in enumerate(leaves):
            lay = layout_at(self.layout, path)
            if lay.fsdp_dim is None and me_fsdp:
                continue   # one fsdp replica counts a leaf fsdp does not cut
            d = lay.zero1_dim
            if d < 0:
                if not (self.zero1 and me_dp):
                    parts[0, i] = sq(g)
            elif self.zero1:
                parts[me_dp, i] = sq(g)
            else:
                for r, c in enumerate(g.chunk(self.dp, d)):
                    parts[r, i] = sq(c)
        with torch.no_grad():
            if self.zero1:
                parts = self._sum(parts, "dp")
            parts = self._sum(parts, "fsdp")
        return torch.sqrt(parts.sum(0).sum())

    def all_ranks(self, ok: torch.Tensor) -> torch.Tensor:
        """``ok`` (a 0-d bool) held on every rank of the mesh: the vote
        (all-reduce of the minimum)."""
        group = self.group(*DATA_AXES)
        if group is None:
            return ok
        vote = ok.to(device=_group_device(), dtype=torch.int32).reshape(1)
        return C._all_reduce(vote, group, "min")[0] > 0

    def sum_all(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over every data axis (evaluation's CE shares)."""
        return self._sum(x, *DATA_AXES)
