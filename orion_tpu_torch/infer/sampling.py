"""Token sampling: greedy / temperature / top-k / nucleus (top-p).

Counterpart of ``orion_tpu/infer/sampling.py`` ``sample`` and
``filter_logits`` (constraint masks are not ported yet). Top-k and top-p
are masks over the full vocab (sort + cumulative sum), so shapes stay
static. Randomness comes from an explicit ``torch.Generator``; the JAX
package draws from ``jax.random`` keys, so sampled streams differ between
the packages while the filtered distributions agree.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def sample(
    logits: torch.Tensor,
    generator: torch.Generator,
    *,
    temperature=0.0,
    top_k=0,
    top_p=1.0,
) -> torch.Tensor:
    """logits [B, V] -> token ids [B] int32.

    Each parameter is a python scalar (whole batch) or a [B] tensor (per
    request). temperature <= 0 means greedy argmax for that row; top_k=0 /
    top_p=1.0 disable the filters. All-scalar greedy is a bare argmax.
    """
    no_topk = isinstance(top_k, int) and top_k == 0
    no_topp = isinstance(top_p, (int, float)) and top_p >= 1.0
    if isinstance(temperature, (int, float)):
        if temperature <= 0.0:
            return logits.argmax(dim=-1).to(torch.int32)
        if no_topk and no_topp:
            return _categorical(logits.float() / temperature, generator)

    B, _ = logits.shape
    dev = logits.device
    logits = logits.float()
    temp = torch.as_tensor(temperature, dtype=torch.float32, device=dev).expand(B)
    top_k = torch.as_tensor(top_k, dtype=torch.int32, device=dev).expand(B)
    top_p = torch.as_tensor(top_p, dtype=torch.float32, device=dev).expand(B)
    greedy = logits.argmax(dim=-1).to(torch.int32)
    scaled = filter_logits(logits, temp, top_k, top_p,
                           no_topk=no_topk, no_topp=no_topp)
    sampled = _categorical(scaled, generator)
    return torch.where(temp > 0, sampled, greedy)


def _categorical(logits: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(torch.int32)


def filter_logits(
    logits: torch.Tensor,   # [B, V] float32
    temp: torch.Tensor,     # [B] (rows <= 0 pass through at scale 1)
    top_k: torch.Tensor,    # [B] int
    top_p: torch.Tensor,    # [B] float
    *,
    no_topk: bool = False,
    no_topp: bool = False,
) -> torch.Tensor:
    """Temperature-scaled, top-k/top-p-masked logits [B, V]."""
    B, V = logits.shape
    scaled = logits / torch.where(temp > 0, temp, torch.ones_like(temp))[:, None]
    neg = torch.full_like(scaled, NEG_INF)
    if not (no_topk and no_topp):
        sorted_desc = torch.sort(scaled, dim=-1, descending=True).values
    if not no_topk:
        kth_idx = (top_k.long() - 1).clamp(0, V - 1)[:, None]
        kth = torch.gather(sorted_desc, 1, kth_idx)
        scaled = torch.where((top_k[:, None] > 0) & (scaled < kth), neg, scaled)
    if not no_topp:
        idx = torch.arange(V, device=logits.device)[None, :]
        sorted_masked = torch.where(
            (top_k[:, None] > 0) & (idx >= top_k[:, None]),
            torch.full_like(sorted_desc, NEG_INF), sorted_desc,
        )
        cum = torch.cumsum(torch.softmax(sorted_masked, dim=-1), dim=-1)
        keep_sorted = torch.cat(
            [torch.ones((B, 1), dtype=torch.bool, device=logits.device),
             cum[:, :-1] < top_p[:, None]], dim=-1,
        )
        thresh = torch.where(
            keep_sorted, sorted_masked, torch.full_like(sorted_masked, float("inf"))
        ).min(dim=-1, keepdim=True).values
        scaled = torch.where((top_p[:, None] < 1.0) & (scaled < thresh), neg, scaled)
    return scaled
