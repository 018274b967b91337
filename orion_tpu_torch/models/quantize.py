"""Weight-only int8 quantization for serving.

Counterpart of ``orion_tpu/models/quantize.py``. Decode reads every
weight once a step, so int8 weights halve the bytes bf16 weights move.
``model.weight_quant`` is a serving knob: the engine quantizes the given
params at construction and the trainer refuses the flag.

Representation: each quantized matmul weight becomes a ``{"q": int8
[..., in, out], "s": float32 [..., out]}`` subtree (per-output-channel
symmetric scales, the same bits as the JAX package's); ``load_weight``
dequantizes at use, so the model reads plain and quantized trees through
one path. Embeddings stay full precision (the tied unembedding reuses
them), and so do the MoE expert banks and the router, norms and biases,
as in the JAX package.
"""

from __future__ import annotations

from typing import Any

import torch

from orion_tpu_torch.config import ModelConfig

Params = dict[str, Any]

# Block-level weight names eligible for int8 (matmul weights only, under
# ``attn`` or ``mlp``: never norm scales, biases, embeddings or experts).
_QUANT_KEYS = frozenset({"wq", "wk", "wv", "wo", "w_in", "w_gate", "w_out"})


def is_quantized(w: Any) -> bool:
    return isinstance(w, dict) and "q" in w


def quantize_weight(w: torch.Tensor) -> dict[str, torch.Tensor]:
    """[..., in, out] float -> {"q": int8 [..., in, out], "s": f32 [..., out]}.

    The scale reduces over the contraction (``in``) axis, -2, so flat
    [in, out] and stacked [L, in, out] weights take the same code. A true
    divide, then round-half-to-even: the JAX package's bits. Both divides
    are tensor by tensor: on the card PyTorch turns a divide by a host
    scalar into a product with its reciprocal, which rounds otherwise."""
    wf = w.float()
    amax = wf.abs().amax(dim=-2)
    s = torch.where(amax > 0, amax / torch.full_like(amax, 127.0), torch.ones_like(amax))
    q = torch.round(wf / s[..., None, :]).clamp_(-127, 127).to(torch.int8)
    return {"q": q, "s": s}


def load_weight(w: Any, dtype: torch.dtype) -> torch.Tensor:
    """Dequantize-on-use: the one read path for maybe-quantized weights."""
    if is_quantized(w):
        return w["q"].to(dtype) * w["s"][..., None, :].to(dtype)
    return w.to(dtype)


def quantize_params(params: Params, cfg: ModelConfig, device=None) -> Params:
    """Quantize every eligible matmul weight of the tree (a new tree; the
    other leaves are the tensors themselves). With ``device`` each weight
    moves there one at a time before it is quantized, so quantizing a
    host-resident tree onto the card never holds more than one weight in
    full precision there. A weight quantized already is kept as it is."""
    del cfg   # the eligible leaves are named by the tree itself

    def quantize(w):
        if is_quantized(w):
            return w
        return quantize_weight(w if device is None else w.to(device))

    def convert(tree: Params, in_attn_or_mlp: bool) -> Params:
        out: Params = {}
        for k, v in tree.items():
            if isinstance(v, dict) and not is_quantized(v):
                out[k] = convert(v, k in ("attn", "mlp") or in_attn_or_mlp)
            elif in_attn_or_mlp and k in _QUANT_KEYS:
                out[k] = quantize(v)
            else:
                out[k] = v
        return out

    out = dict(params)
    blocks = params["blocks"]
    if isinstance(blocks, list):
        out["blocks"] = [convert(b, False) for b in blocks]
    else:
        out["blocks"] = convert(blocks, False)
    if "lm_head" in params:
        out["lm_head"] = quantize(params["lm_head"])
    return out


def weight_bytes(params: Any) -> int:
    """Bytes of every tensor in a (maybe quantized) tree."""
    if isinstance(params, dict):
        return sum(weight_bytes(v) for v in params.values())
    if isinstance(params, (list, tuple)):
        return sum(weight_bytes(v) for v in params)
    return params.numel() * params.element_size()
