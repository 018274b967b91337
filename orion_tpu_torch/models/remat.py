"""Activation rematerialization of the training path (``model.remat``).

Counterpart of the JAX package's ``remat_policy``, its ``checkpoint_name``
sites and ``_remat`` (``orion_tpu/models/transformer.py``). Each block of
``models.transformer._hidden_states`` runs as one ``_RematBlock`` (an
autograd Function) under every policy but ``none``. Its forward runs the
block and keeps the policy's saved set; its backward replays the block
from its input and the saved set, and differentiates the replay.

The block marks two kinds of sites, and a policy saves one kind:

- ``product(a, w)`` — every ``a @ w`` of a weight with no batch dimension:
  the q, k, v and output projections, the MLP's three, the MoE router's
  logits. ``dots`` (``checkpoint_dots_with_no_batch_dims``) saves these.
  A product with a batch dimension (the MoE's per-expert ``bmm``, the
  einsum dispatch, attention) is no site, so it is classified by its
  shape where it is written, not by the aten op it reaches;
- ``named(name, fn, *args)`` — ``fn(*args)`` under a name of
  ``REMAT_SAVE_NAMES``. ``names`` saves these.

The saved set of a block, by policy (with the block's input under all
three): ``full`` nothing else; ``dots`` every product output; ``names``
``attn_norm_out`` and ``mlp_norm_out`` (K1's outputs), ``attn_out`` (K3's
output), ``ffn_out`` (the MLP's or the MoE's output, with the MoE's
float32 aux loss), ``moe_router_gate`` (the MoE's [B, S, k] gates).
With ``remat_offload`` (``names`` only) the named tensors live in pinned
host memory between the forward and the backward (``Offload``); the block
input stays on the device, as it does in the JAX package's offload policy.

The replay. The kernels are plain calls inside autograd Functions, which
no dispatch mode sees, so a saved tensor is substituted at its site in
Python:

- a saved product returns the stored output through ``_SavedProduct``,
  whose backward is the two products autograd's own ``mm`` backward
  computes: the replay never reruns it;
- a saved name returns the stored output through ``_SavedOut``, which
  reruns the site's ``fn`` only inside its own backward, to send the
  gradient on to the site's inputs. The ops between sites (the output
  projection, the residual adds, Gemma's post-norms) rerun in the replay.

So under ``names`` every op of the block runs twice per step, as under
``full``: the stored tensors split the backward into pieces, one site's
graph alive at a time, but save no forward work. Launches per layer and
step: K3 twice under ``full``, ``dots`` and ``names`` (once in the
forward, once in the replay; under ``names`` inside ``attn_out``'s
backward, as the JAX package may rerun its forward kernel there for the
lse residual, which is no named value), once under ``none``; K7 and K8
once under every policy.

Under FSDP the block's function gathers its parameters first
(``parallel.data_parallel.FsdpGather``): the remat block's inputs are the
rank's blocks, so a replay gathers again and no gathered layer is kept
between the forward and the backward.

The block's forward itself runs with gradients on, its saved tensors
dropped by a ``saved_tensors_hooks`` pair, so every kernel takes the same
branch as in the replay and under ``none``: the stored values are the
bits the replay and an unrematerialized step compute.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any, Callable, Optional

import torch

# The activations ``names`` saves (the JAX package's list and order).
REMAT_SAVE_NAMES = (
    "attn_out",         # K3's output                    [B, S, N, H]
    "attn_norm_out",    # the pre-attention norm's output [B, S, D]
    "mlp_norm_out",     # the pre-FFN norm's output       [B, S, D]
    "ffn_out",          # the MLP's / MoE's output        [B, S, D]
    "moe_router_gate",  # renormalized top-k gates        [B, S, k] float32
)


def remat_policy(cfg) -> Optional[str]:
    """The policy ``cfg.remat`` names, or None for ``none``; raises the JAX
    package's ValueError for ``remat_offload`` without ``names``."""
    if cfg.remat_offload and cfg.remat != "names":
        raise ValueError(
            f"model.remat_offload requires model.remat='names' "
            f"(got remat={cfg.remat!r}): the offload set IS the named set"
        )
    if cfg.remat not in ("none", "full", "dots", "names"):
        raise ValueError(f"model.remat={cfg.remat!r}; pick none|full|dots|names")
    return None if cfg.remat == "none" else cfg.remat


@dataclasses.dataclass
class RematLog:
    """What one forward's blocks kept for the backward, in bytes:
    ``block_inputs`` (every policy), ``saved`` (the policy's saved set
    beside the inputs, wherever it lives), and the offload traffic,
    ``to_host`` in the forward and ``to_device`` in the backward."""
    block_inputs: int = 0
    saved: int = 0
    to_host: int = 0
    to_device: int = 0


_local = threading.local()


def _tape():
    stack = getattr(_local, "stack", None)
    return stack[-1] if stack else None


@contextlib.contextmanager
def _using(tape):
    stack = _local.__dict__.setdefault("stack", [])
    stack.append(tape)
    try:
        yield
    finally:
        stack.pop()


def product(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``a @ w`` for a weight ``w`` [in, out] with no batch dimension: a
    ``dots`` site."""
    tape = _tape()
    return a @ w if tape is None else tape.product(a, w)


def named(name: str, fn: Callable, *args):
    """``fn(*args)``, a ``names`` site. ``args`` are tensors and parameter
    dicts (every tensor the gradient reaches through ``fn``); ``fn``
    returns a tensor or a tuple of tensors."""
    tape = _tape()
    return fn(*args) if tape is None else tape.named(name, fn, args)


def _nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _as_tuple(out) -> tuple:
    return out if isinstance(out, tuple) else (out,)


class _Record:
    """The block's forward: collects the policy's saved set."""

    def __init__(self, policy: str):
        self.policy = policy
        self.products: list[torch.Tensor] = []
        self.names: dict[str, tuple] = {}

    def product(self, a, w):
        y = a @ w
        if self.policy == "dots":
            self.products.append(y.detach())
        return y

    def named(self, name, fn, args):
        out = fn(*args)
        if self.policy == "names":
            self.names[name] = tuple(t.detach() for t in _as_tuple(out))
        return out

    def saved(self) -> tuple[list, list]:
        """(the saved tensors, flat, and the layout ``_Replay`` rebuilds
        them with)."""
        if self.policy == "dots":
            return list(self.products), [len(self.products)]
        layout = [(name, len(ts)) for name, ts in self.names.items()]
        return [t for ts in self.names.values() for t in ts], layout


class _Replay:
    """The block's backward: substitutes the saved set at its sites."""

    def __init__(self, policy: str, layout: list, saved: list):
        self.policy = policy
        self.products: list = []
        self.names: dict[str, tuple] = {}
        if policy == "dots":
            self.products = list(saved)
        elif policy == "names":
            it = iter(saved)
            self.names = {name: tuple(next(it) for _ in range(n)) for name, n in layout}
        self._next = 0

    def product(self, a, w):
        if self.policy != "dots":
            return a @ w
        y = self.products[self._next]
        self._next += 1
        return _SavedProduct.apply(a, w, y)

    def named(self, name, fn, args):
        # models.convert imports this module's importers: imported at use.
        from orion_tpu_torch.models.convert import tree_leaves

        if self.policy != "names":
            return fn(*args)
        stored = self.names[name]
        outs = _SavedOut.apply(self, fn, list(args), stored, *tree_leaves(list(args)))
        return outs if len(stored) > 1 else outs[0]


class _SavedProduct(torch.autograd.Function):
    """A stored ``a @ w`` in the replay: the stored output forward, the
    product's gradients backward (``mm``'s own: g @ w^T and a^T @ g over
    the rows of a)."""

    @staticmethod
    def forward(ctx, a, w, y):
        ctx.save_for_backward(a, w)
        return y.detach()

    @staticmethod
    def backward(ctx, g):
        a, w = ctx.saved_tensors
        g2 = g.reshape(-1, g.shape[-1])
        ga = gw = None
        if ctx.needs_input_grad[0]:
            ga = g2.mm(w.t()).view(a.shape)
        if ctx.needs_input_grad[1]:
            gw = a.reshape(-1, a.shape[-1]).t().mm(g2)
        return ga, gw, None


class _SavedOut(torch.autograd.Function):
    """A stored named site in the replay: the stored outputs forward; in
    the backward, ``fn`` reruns on the site's inputs (sites nested in it
    substituted again) and its gradient goes on to them."""

    @staticmethod
    def forward(ctx, tape, fn, args, stored, *flat):
        ctx.tape, ctx.fn, ctx.args = tape, fn, args
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(*flat)
        return tuple(t.detach() for t in stored)

    @staticmethod
    def backward(ctx, *grads):
        from orion_tpu_torch.models.convert import tree_unflatten

        inputs = [t.detach().requires_grad_(t.requires_grad) for t in ctx.saved_tensors]
        with torch.enable_grad(), _using(ctx.tape):
            outs = _as_tuple(ctx.fn(*tree_unflatten(ctx.args, inputs)))
        pairs = [(o, g) for o, g in zip(outs, grads) if g is not None and o.requires_grad]
        need = [t for t in inputs if t.requires_grad]
        got = iter(torch.autograd.grad([o for o, _ in pairs], need, [g for _, g in pairs],
                                       allow_unused=True) if pairs and need else ())
        return (None, None, None, None,
                *(next(got, None) if t.requires_grad else None for t in inputs))


def _dropped(_t):
    return None


def _never_read(_packed):
    raise RuntimeError("remat: the block's recording forward has no backward")


def _leaf(t: torch.Tensor) -> torch.Tensor:
    return t.detach().requires_grad_(t.requires_grad)


class _RematBlock(torch.autograd.Function):
    """One block under a policy: the forward keeps the block input and the
    saved set, the backward replays and differentiates the block."""

    @staticmethod
    def forward(ctx, run, policy, offload, log, x, *leaves):
        rec = _Record(policy)
        with torch.enable_grad(), torch.autograd.graph.saved_tensors_hooks(
                _dropped, _never_read), _using(rec):
            out, aux = run(_leaf(x), [_leaf(t) for t in leaves])
        saved, layout = rec.saved()
        if log is not None:
            log.block_inputs += _nbytes([x])
            log.saved += _nbytes(saved)
        ctx.run, ctx.policy, ctx.layout, ctx.n = run, policy, layout, len(leaves)
        ctx.offload = offload
        if offload is not None:
            ctx.slot = offload.put(saved)
            saved = []
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, *leaves, *saved)
        return out.detach(), (None if aux is None else aux.detach())

    @staticmethod
    def backward(ctx, g_out, g_aux):
        x, *rest = ctx.saved_tensors
        leaves, saved = rest[:ctx.n], rest[ctx.n:]
        if ctx.offload is not None:
            saved = ctx.offload.take(ctx.slot)
        x_, leaves_ = _leaf(x), [_leaf(t) for t in leaves]
        with torch.enable_grad(), _using(_Replay(ctx.policy, ctx.layout, saved)):
            out, aux = ctx.run(x_, leaves_)
            outs, grads = [out], [g_out]
            if aux is not None and g_aux is not None:
                outs.append(aux)
                grads.append(g_aux)
            need = [t for t in (x_, *leaves_) if t.requires_grad]
            got = iter(torch.autograd.grad(outs, need, grads, allow_unused=True))
        return (None, None, None, None,
                *(next(got) if t.requires_grad else None for t in (x_, *leaves_)))


def remat_block(policy: str, fn: Callable, x: torch.Tensor, params: Any,
                offload: Optional["Offload"] = None, log: Optional[RematLog] = None):
    """``fn(x, params)`` -> (x, aux or None) as one ``_RematBlock`` under
    ``policy`` (full, dots or names)."""
    from orion_tpu_torch.models.convert import tree_leaves, tree_unflatten

    def run(x_, leaves_):
        return fn(x_, tree_unflatten(params, leaves_))

    return _RematBlock.apply(run, policy, offload, log, x, *tree_leaves(params))


class Offload:
    """Residence of the ``names`` set in host memory for one step.

    ``put`` (a block's forward) copies a block's saved tensors to pinned
    host buffers on a side stream that waits for the block's work, so the
    copies overlap the next blocks; ``record_stream`` keeps the device
    memory from reuse until its copy is done. ``take`` (the block's
    backward) returns them on the device: from the prefetch that the
    block after it started, or copied then; it then starts the prefetch of
    the block before it. The device buffers are allocated on the compute
    stream, whose pool holds what the step frees (a side stream's pool
    would need memory of its own), and the compute stream waits on an
    event for each copy it reads. On the CPU both ways are plain copies."""

    def __init__(self, device, log: Optional[RematLog] = None):
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.stream = torch.cuda.Stream(self.device) if self.cuda else None
        self.log = log
        self._host: list = []
        self._fetched: dict = {}

    def put(self, tensors: list) -> int:
        if self.cuda:
            ready = torch.cuda.Event()
            ready.record()
            with torch.cuda.stream(self.stream):
                self.stream.wait_event(ready)
                host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                        .copy_(t, non_blocking=True) for t in tensors]
            for t in tensors:
                t.record_stream(self.stream)
        else:
            host = [t.clone() for t in tensors]
        if self.log is not None:
            self.log.to_host += _nbytes(tensors)
        self._host.append(host)
        return len(self._host) - 1

    def _fetch(self, slot: int):
        host = self._host[slot]
        self._host[slot] = None
        if not self.cuda:
            return [t.clone() for t in host], None
        # The copies' destinations come from the compute stream's memory
        # (where the step frees its blocks): the side stream starts them
        # once the compute stream's work so far is done.
        compute = torch.cuda.current_stream(self.device)
        dev = [torch.empty(t.shape, dtype=t.dtype, device=self.device) for t in host]
        self.stream.wait_stream(compute)
        with torch.cuda.stream(self.stream):
            for d, h in zip(dev, host):
                d.copy_(h, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self.stream)
        for d in dev:
            d.record_stream(self.stream)
        return dev, done

    def take(self, slot: int) -> list:
        dev, done = self._fetched.pop(slot, None) or self._fetch(slot)
        if self.cuda:
            torch.cuda.current_stream(self.device).wait_event(done)
        if self.log is not None:
            self.log.to_device += _nbytes(dev)
        if slot > 0 and self._host[slot - 1] is not None:
            self._fetched[slot - 1] = self._fetch(slot - 1)
        return dev
