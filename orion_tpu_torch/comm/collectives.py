"""Typed collectives over a mesh axis's process group.

Counterpart of ``orion_tpu/comm/collectives.py``. Where the JAX package
names a mesh axis inside ``shard_map``, the port passes that axis's
process group (``mesh.get_group("sp")``): every process holds its own
shard and calls the op with its peers.

    NCCL verb            | wrapper        | torch.distributed
    ---------------------|----------------|---------------------------
    ncclAllReduce        | all_reduce     | all_reduce
    ncclAllGather        | all_gather     | all_gather
    ncclReduceScatter    | reduce_scatter | reduce_scatter_tensor (gloo:
                         |                |   all_reduce, own chunk)
    ncclAllToAll         | all_to_all     | all_to_all (tiled)
    ncclSend/Recv        | ppermute       | batch_isend_irecv
    ncclBroadcast        | broadcast      | broadcast
    barrier              | barrier        | barrier

The ops that carry activations are ``torch.autograd.Function``s whose
backward is their transpose, as JAX's are: ``all_reduce`` (sum, mean) by
the same reduction, ``all_gather`` by ``reduce_scatter`` and back,
``all_to_all`` by the inverse ``all_to_all``, ``ppermute`` by the
inverse permutation, ``broadcast`` by a sum onto the root. Every rank
must run the same collectives in the same order, backward too: a rank
whose autograd graph lacks a collective's node would leave its peers
waiting (``parallel/sequence.py`` keeps skipped blocks in the graph for
that reason).

``CALLS`` counts the calls of each op (forward only; a transpose run by
the backward is not counted), so a test can count a ring's exchanges.

A gloo group serves CUDA tensors through host staging: the tensor is
copied into a pinned host buffer, the collective runs there, and the
result is copied back to the device. That is how gloo takes device
tensors at all (it computes on the host), so it is the op, not a
fallback; ``STAGED`` counts the bytes each op moved across the bus, both
ways. A CPU tensor on a gloo group is not staged (``STAGED`` stays 0) and
an NCCL group never stages. Every op works in the tensor's own dtype,
staged or not (gloo sums bfloat16 as it comes, and for two members that
is the correctly rounded sum of the two partials).

``broadcast_values`` hands a few host numbers from process 0 to the
others (the serving engine's host choices): a float64 tensor on the CPU
for gloo, on the current device for NCCL.
"""

from __future__ import annotations

import collections
from typing import Sequence

import torch
import torch.distributed as dist

CALLS: collections.Counter = collections.Counter()
STAGED: collections.Counter = collections.Counter()


def axis_size(group) -> int:
    """Number of processes along the axis."""
    return dist.get_world_size(group)


def axis_index(group) -> int:
    """This process's coordinate along the axis."""
    return dist.get_rank(group)


def _global(group, rank: int) -> int:
    return dist.get_global_rank(group, rank)


# -- host staging (gloo groups) -----------------------------------------------


def _gloo(group) -> bool:
    return dist.get_backend(group) == "gloo"


def _stage_in(x, op):
    """``x`` as a fresh host tensor: a pinned copy of a CUDA tensor,
    counted in ``STAGED``, or a CPU tensor's copy."""
    if not x.is_cuda:
        return x.contiguous().clone()
    h = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    h.copy_(x)
    STAGED[op] += x.numel() * x.element_size()
    return h


def _stage_out(h, like, op):
    """The host result ``h`` back on ``like``'s device."""
    if not like.is_cuda:
        return h
    out = torch.empty(h.shape, dtype=h.dtype, device=like.device)
    out.copy_(h)
    STAGED[op] += out.numel() * out.element_size()
    return out


# -- raw ops (no autograd, no count) ----------------------------------------


def _all_reduce(x, group, op):
    if op not in ("sum", "mean", "max", "min"):
        raise ValueError(f"unknown reduce op {op!r}")
    rop = {"sum": dist.ReduceOp.SUM, "mean": dist.ReduceOp.SUM,
           "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN}[op]
    if _gloo(group):
        h = _stage_in(x, "all_reduce")
        dist.all_reduce(h, op=rop, group=group)
        y = _stage_out(h, x, "all_reduce")
    else:
        y = x.contiguous().clone()
        dist.all_reduce(y, op=rop, group=group)
    return y / axis_size(group) if op == "mean" else y


def _all_gather(x, group, dim, tiled):
    n = axis_size(group)
    if _gloo(group) and x.is_cuda:
        h = _stage_in(x, "all_gather")
        parts = [torch.empty(h.shape, dtype=h.dtype, pin_memory=True) for _ in range(n)]
        dist.all_gather(parts, h, group=group)
        both = torch.cat(parts, dim) if tiled else torch.stack(parts, dim)
        return _stage_out(both, x, "all_gather")
    parts = [torch.empty_like(x, memory_format=torch.contiguous_format) for _ in range(n)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim) if tiled else torch.stack(parts, dim)


def _reduce_scatter(x, group, dim):
    n = axis_size(group)
    if x.shape[dim] % n:
        raise ValueError(f"reduce_scatter: dim {dim} of {tuple(x.shape)} not divisible "
                         f"by the axis size {n}")
    if dist.get_backend(group) == "gloo":
        # gloo has no reduce-scatter: the full sum, then this rank's chunk.
        return _all_reduce(x, group, "sum").chunk(n, dim)[axis_index(group)].contiguous()
    xm = x.movedim(dim, 0).contiguous()
    out = torch.empty((xm.shape[0] // n, *xm.shape[1:]), dtype=x.dtype, device=x.device)
    dist.reduce_scatter_tensor(out, xm, group=group)
    return out.movedim(0, dim).contiguous()


def _all_to_all(x, group, split_axis, concat_axis):
    n = axis_size(group)
    if x.shape[split_axis] % n:
        raise ValueError(f"all_to_all: split axis {split_axis} of {tuple(x.shape)} not "
                         f"divisible by the axis size {n}")
    ins = [c.contiguous() for c in x.chunk(n, split_axis)]
    outs = [torch.empty_like(c) for c in ins]
    dist.all_to_all(outs, ins, group=group)
    return torch.cat(outs, concat_axis)


def _ppermute(x, group, perm):
    me = axis_index(group)
    x = x.contiguous()
    out = torch.zeros_like(x)
    ops = []
    for src, dst in perm:
        if src == me:
            ops.append(dist.P2POp(dist.isend, x, _global(group, dst), group))
        if dst == me:
            ops.append(dist.P2POp(dist.irecv, out, _global(group, src), group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out


def _broadcast(x, group, root):
    if _gloo(group):
        h = _stage_in(x, "broadcast")
        dist.broadcast(h, src=_global(group, root), group=group)
        return _stage_out(h, x, "broadcast")
    y = x.contiguous().clone()
    dist.broadcast(y, src=_global(group, root), group=group)
    return y


# -- autograd -----------------------------------------------------------------


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, op):
        ctx.group, ctx.op = group, op
        return _all_reduce(x, group, op)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group, ctx.op), None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim, tiled):
        ctx.group, ctx.dim, ctx.tiled = group, dim, tiled
        return _all_gather(x, group, dim, tiled)

    @staticmethod
    def backward(ctx, g):
        if not ctx.tiled:   # the stacked axis, one slot a member
            return _reduce_scatter(g.movedim(ctx.dim, 0), ctx.group, 0)[0], None, None, None
        return _reduce_scatter(g, ctx.group, ctx.dim), None, None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _reduce_scatter(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.group, ctx.dim, True), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_axis, concat_axis):
        ctx.group, ctx.split, ctx.concat = group, split_axis, concat_axis
        return _all_to_all(x, group, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.group, ctx.concat, ctx.split), None, None, None


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, perm):
        ctx.group, ctx.perm = group, perm
        return _ppermute(x, group, perm)

    @staticmethod
    def backward(ctx, g):
        return _ppermute(g, ctx.group, [(d, s) for s, d in ctx.perm]), None, None


class _Broadcast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, root):
        ctx.group, ctx.root = group, root
        return _broadcast(x, group, root)

    @staticmethod
    def backward(ctx, g):
        total = _all_reduce(g, ctx.group, "sum")
        if axis_index(ctx.group) != ctx.root:
            total = torch.zeros_like(total)
        return total, None, None


# -- public ops ---------------------------------------------------------------


def all_reduce(x: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """Reduce ``x`` across the axis onto every member (sum, mean, max,
    min). Differentiable for sum and mean."""
    CALLS["all_reduce"] += 1
    if op in ("sum", "mean"):
        return _AllReduce.apply(x, group, op)
    return _all_reduce(x.detach(), group, op)


def all_gather(x: torch.Tensor, group, *, gather_axis: int = 0,
               tiled: bool = True) -> torch.Tensor:
    """Concatenate the members' shards along ``gather_axis`` (tiled) or
    stack them on a new axis there."""
    CALLS["all_gather"] += 1
    return _AllGather.apply(x, group, gather_axis, tiled)


def reduce_scatter(x: torch.Tensor, group, *, scatter_axis: int = 0) -> torch.Tensor:
    """Sum across the axis, then keep this member's chunk of ``scatter_axis``."""
    CALLS["reduce_scatter"] += 1
    return _ReduceScatter.apply(x, group, scatter_axis)


def all_to_all(x: torch.Tensor, group, *, split_axis: int, concat_axis: int) -> torch.Tensor:
    """Split ``split_axis`` into axis-size chunks, send chunk i to member i,
    concatenate what arrives along ``concat_axis`` (tiled, as JAX's
    ``lax.all_to_all(..., tiled=True)``)."""
    CALLS["all_to_all"] += 1
    return _AllToAll.apply(x, group, split_axis, concat_axis)


def ppermute(x: torch.Tensor, group, perm: Sequence[tuple[int, int]]) -> torch.Tensor:
    """Point-to-point permutation: ``perm`` lists (source, destination)
    member pairs; a member that receives nothing gets zeros."""
    CALLS["ppermute"] += 1
    return _PPermute.apply(x, group, tuple((int(s), int(d)) for s, d in perm))


def ring_shift(x: torch.Tensor, group, *, shift: int = 1) -> torch.Tensor:
    """Rotate shards around the axis ring (the ring-attention KV step)."""
    n = axis_size(group)
    return ppermute(x, group, [(i, (i + shift) % n) for i in range(n)])


def broadcast(x: torch.Tensor, group, *, root: int = 0) -> torch.Tensor:
    """Every member receives the root member's value."""
    CALLS["broadcast"] += 1
    return _Broadcast.apply(x, group, root)


def broadcast_values(values) -> list[float]:
    """Process 0's ``values`` (a list of numbers, the same length in every
    process of the default group) in every process, as floats: one
    broadcast of a float64 tensor (exact for integers up to 2**53)."""
    CALLS["broadcast_values"] += 1
    device = ("cpu" if dist.get_backend() == "gloo"
              else torch.device("cuda", torch.cuda.current_device()))
    t = torch.tensor([float(v) for v in values], dtype=torch.float64, device=device)
    dist.broadcast(t, src=0)
    return t.tolist()


def barrier(group) -> int:
    """Completes only when every member arrives; returns the axis size."""
    CALLS["barrier"] += 1
    dist.barrier(group=group)
    return axis_size(group)
