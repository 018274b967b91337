"""Parameters for the port: seeded random init, and weights carried across
from the JAX package.

``init_params`` draws the same shapes with the same standard deviations
as ``orion_tpu/models/transformer.py::init_params`` (N(0, 0.02), residual
output projections scaled by 1/sqrt(2L), norm scales at 1, or at 0 under
``norm_scale_plus_one``; an MoE block's ``moe`` subtree: router [D, E],
w_in / w_gate [E, D, F], w_out [E, F, D]), from an explicit
``torch.Generator``. The two
frameworks draw different numbers from the same seed, so tests that
compare the packages carry the JAX tree across with ``from_jax_params``.

On a data-parallel mesh (``parallel/data_parallel.py``) a rank holds its
blocks of each leaf: ``shard_params`` cuts a whole tree into one rank's
blocks by ``parallel.sharding.param_layout``'s plan, and
``unshard_params`` puts every rank's blocks back together. A
tensor-parallel serving rank holds the blocks ``serving_blocks`` cuts: by
the same rules, ``heads``, ``kv_heads``, ``mlp`` and ``vocab`` over
``tp``, each block the one JAX's ``NamedSharding`` places at the rank's
mesh position. A dimension ``tp`` does not divide (a vocabulary of 50257
at tp = 2) raises, as the JAX package's ``device_put`` refuses it.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from orion_tpu_torch.config import ModelConfig
from orion_tpu_torch.models.transformer import Params, torch_dtype
from orion_tpu_torch.parallel.sharding import block_index, layout_at, local_block, parts


def _normal(gen, shape, std, device, dtype) -> torch.Tensor:
    x = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
    return x.mul_(std).to(dtype)


def init_params(
    cfg: ModelConfig,
    generator: torch.Generator,
    device=None,
    dtype=None,
) -> Params:
    """Random parameters on ``device`` (default: the generator's device)
    stored in ``dtype`` (default: ``cfg.param_dtype``)."""
    device = generator.device if device is None else torch.device(device)
    dt = torch_dtype(dtype if dtype is not None else cfg.param_dtype)
    D, V, L = cfg.d_model, cfg.vocab_size, cfg.n_layers
    H = cfg.resolved_head_dim
    N, K, F = cfg.n_heads, cfg.n_kv_heads, cfg.d_ff
    std = 0.02
    resid_std = std / (2 * L) ** 0.5

    def normal(shape, s=std):
        return _normal(generator, shape, s, device, dt)

    def zeros(shape):
        return torch.zeros(shape, device=device, dtype=dt)

    def norm_scale():
        if cfg.norm_scale_plus_one:
            return zeros((D,))
        return torch.ones((D,), device=device, dtype=dt)

    params: Params = {
        "embed": {"tokens": normal((V, D))},
        "final_norm": {"scale": norm_scale()},
    }
    if cfg.pos_embedding == "learned":
        params["embed"]["positions"] = normal((cfg.max_seq_len, D))
    if not cfg.tie_embeddings:
        params["lm_head"] = normal((D, V))
    if cfg.norm == "layernorm":
        params["final_norm"]["bias"] = zeros((D,))

    blocks = []
    for _ in range(L):
        block: Params = {
            "attn_norm": {"scale": norm_scale()},
            "mlp_norm": {"scale": norm_scale()},
            "attn": {
                "wq": normal((D, N * H)),
                "wk": normal((D, K * H)),
                "wv": normal((D, K * H)),
                "wo": normal((N * H, D), resid_std),
            },
        }
        if cfg.norm == "layernorm":
            block["attn_norm"]["bias"] = zeros((D,))
            block["mlp_norm"]["bias"] = zeros((D,))
        if cfg.post_norms:
            block["post_attn_norm"] = {"scale": norm_scale()}
            block["post_mlp_norm"] = {"scale": norm_scale()}
        if cfg.attn_bias:
            block["attn"]["bq"] = zeros((N * H,))
            block["attn"]["bk"] = zeros((K * H,))
            block["attn"]["bv"] = zeros((K * H,))
        if cfg.resolved_attn_out_bias:
            block["attn"]["bo"] = zeros((D,))
        if cfg.is_moe:
            E = cfg.n_experts
            block["moe"] = {
                "router": normal((D, E)),
                "w_in": normal((E, D, F)),
                "w_out": normal((E, F, D), resid_std),
            }
            if cfg.is_gated_mlp:
                block["moe"]["w_gate"] = normal((E, D, F))
        else:
            block["mlp"] = {
                "w_in": normal((D, F)),
                "w_out": normal((F, D), resid_std),
            }
            if cfg.is_gated_mlp:
                block["mlp"]["w_gate"] = normal((D, F))
            if cfg.mlp_bias:
                block["mlp"]["b_in"] = zeros((F,))
                block["mlp"]["b_out"] = zeros((D,))
        blocks.append(block)
    params["blocks"] = blocks
    return params


def tree_map(fn, tree: Any) -> Any:
    """Apply ``fn`` to every leaf of a tree of dicts and lists."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def tree_leaves_with_path(tree: Any, path: tuple = ()) -> list[tuple[tuple, Any]]:
    """(path, leaf) pairs in ``tree_map``'s order; a path holds the dict
    keys and list indices from the root to the leaf."""
    if isinstance(tree, dict):
        return [pl for k, v in tree.items() for pl in tree_leaves_with_path(v, path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [pl for i, v in enumerate(tree) for pl in tree_leaves_with_path(v, path + (i,))]
    return [(path, tree)]


def jax_leaves_with_path(tree: Any, path: tuple = ()) -> list[tuple[tuple, Any]]:
    """(path, leaf) pairs in ``jax.tree_util``'s order: dict keys sorted at
    every level, lists by index. The order of the JAX package's checkpoint
    files and of its sums over a tree, whatever order a tree's dicts were
    built in."""
    if isinstance(tree, dict):
        return [pl for k in sorted(tree) for pl in jax_leaves_with_path(tree[k], path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [pl for i, v in enumerate(tree) for pl in jax_leaves_with_path(v, path + (i,))]
    return [(path, tree)]


def tree_leaves(tree: Any) -> list:
    """The leaves of a tree of dicts and lists, in ``tree_map``'s order."""
    return [leaf for _, leaf in tree_leaves_with_path(tree)]


def tree_unflatten(tree: Any, leaves) -> Any:
    """A tree shaped like ``tree`` holding ``leaves`` (in ``tree_leaves``
    order)."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def to_device(params: Params, device, dtype=None) -> Params:
    """The tree on ``device`` (optionally cast); leaves already there with
    that dtype are returned as they are, without a copy."""
    dt = torch_dtype(dtype) if dtype is not None else None
    return tree_map(lambda t: t.to(device=device, dtype=dt), params)


def _to_tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":   # ml_dtypes bfloat16 from a JAX array
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def stack_layers(params: Params, cfg: ModelConfig) -> Params:
    """``params`` in the JAX package's layout: with ``scan_layers`` every
    block leaf stacked along a leading layer dimension (new tensors),
    otherwise the per-layer list as it is. The other leaves are the
    tensors themselves."""
    out = {k: v for k, v in params.items() if k != "blocks"}
    blocks = params["blocks"]
    if cfg.scan_layers:
        by_layer = [tree_leaves(b) for b in blocks]
        out["blocks"] = tree_unflatten(blocks[0], [torch.stack(layers)
                                                   for layers in zip(*by_layer)])
    else:
        out["blocks"] = list(blocks)
    return out


def unstack_layers(tree: Params, cfg: ModelConfig) -> Params:
    """The inverse of ``stack_layers``: a stacked ``blocks`` dict (the JAX
    package's ``scan_layers`` layout) split into one dict per layer (each
    leaf its own copy); a per-layer list is taken as it is."""
    out = {k: v for k, v in tree.items() if k != "blocks"}
    blocks = tree["blocks"]
    if isinstance(blocks, dict):
        out["blocks"] = [tree_map(lambda t: t[layer].clone(), blocks)
                         for layer in range(cfg.n_layers)]
    else:
        out["blocks"] = list(blocks)
    return out


def from_jax_params(
    tree: Params, cfg: ModelConfig, device: Optional[str] = None
) -> Params:
    """The JAX package's parameter tree (leaves as numpy arrays, or
    anything ``np.asarray`` takes) as the port's parameters.

    With ``scan_layers`` the JAX tree stacks every block leaf along a
    leading layer dimension; the port keeps one dict per layer, so the
    stack is split here. A per-layer list (``scan_layers=False``) is taken
    as it is. An MoE block's stacked [L, E, ...] expert leaves split the
    same way."""
    out = unstack_layers(tree_map(_to_tensor, tree), cfg)
    if device is not None:
        out = to_device(out, device)
    return out


def shard_params(tree: Params, layout: Any, sizes: dict, coords: dict,
                 state: bool = False) -> Params:
    """The rank at ``coords``' blocks of a whole per-layer tree (tensors,
    or numpy arrays such as the JAX package's carried across by
    ``from_jax_params``), each a tensor of its own: the parameters'
    blocks, or with ``state`` the optimizer state's (ZeRO-1 cuts those
    along ``dp`` too). ``layout`` is ``param_layout``'s tree."""
    def cut(path, t):
        lay = layout_at(layout, path)
        t = torch.as_tensor(t) if not torch.is_tensor(t) else t
        return local_block(t, lay.state_spec if state else lay.spec, sizes, coords).clone()

    return tree_unflatten(tree, [cut(p, t) for p, t in tree_leaves_with_path(tree)])


def unshard_params(trees: list, layout: Any, sizes: dict, coords: list,
                   state: bool = False) -> Params:
    """The whole per-layer tree from every rank's blocks: ``trees[r]`` is
    the tree of the rank at ``coords[r]`` (replicas of a block may repeat;
    each writes the same region)."""
    flat = [tree_leaves_with_path(t) for t in trees]

    def whole(i, path):
        lay = layout_at(layout, path)
        spec = lay.state_spec if state else lay.spec
        first = flat[0][i][1]
        shape = [n * parts(spec, d, sizes) for d, n in enumerate(first.shape)]
        out = first.new_empty(shape)
        for f, c in zip(flat, coords):
            idx = block_index(shape, spec, sizes, c)
            out[tuple(slice(a, b) for a, b in idx)] = f[i][1]
        return out

    return tree_unflatten(trees[0], [whole(i, p) for i, (p, _) in enumerate(flat[0])])


def serving_blocks(tree: Params, mcfg: ModelConfig, sizes: dict, coords: dict) -> Params:
    """The serving engine's parameters for the rank at ``coords`` of a mesh
    of ``sizes`` (``runtime.mesh.sizes`` / ``coords``): its blocks of a
    whole per-layer tree, each a tensor of its own on the tree's device."""
    from orion_tpu_torch.parallel.sharding import param_layout

    return shard_params(tree, param_layout(mcfg, sizes), sizes, coords)
