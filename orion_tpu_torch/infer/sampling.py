"""Token sampling: greedy / temperature / top-k / nucleus (top-p).

Counterpart of ``orion_tpu/infer/sampling.py`` ``sample``,
``filter_logits`` and the speculative verifiers ``spec_verify_sample``
and ``spec_verify_sample_tree``. Top-k and top-p are masks over the full
vocab (sort + cumulative sum), so shapes stay static.

Constrained decoding (``orion_tpu_torch.constrain``) composes a per-row
legal-token bitmask into the same filtered distribution every consumer
shares: greedy, sampled and both verifiers mask before any filtering, so
a constrained draft is accepted by the unconstrained acceptance math.
``legal_mask=None`` runs exactly the unconstrained code. Randomness comes from an explicit ``torch.Generator``; the JAX
package draws from ``jax.random`` keys, so sampled streams differ between
the packages while the filtered distributions agree.
"""

from __future__ import annotations

import torch

import numpy as np

NEG_INF = -1e30


class AllMaskedRows(ValueError):
    """Typed per-slot error: legal-mask rows that admit no token. The
    filtered distribution of such a row is undefined, so the engine fails
    the offending slots, and only those, before dispatch. ``slots`` lists
    the guilty row indices."""

    def __init__(self, slots):
        self.slots = list(slots)
        super().__init__(
            f"legal_mask rows {self.slots} admit no token (constraint "
            f"dead end); quarantine those slots"
        )


def check_legal_mask(legal_mask) -> None:
    """Host-side pre-dispatch validation: raise :class:`AllMaskedRows`
    naming every all-masked row (rows are the leading axes flattened)."""
    m = np.asarray(legal_mask, bool)
    rows = m.reshape(-1, m.shape[-1])
    bad = np.flatnonzero(~rows.any(axis=-1))
    if bad.size:
        raise AllMaskedRows(bad.tolist())


def _apply_mask(logits: torch.Tensor, legal_mask) -> torch.Tensor:
    """Illegal tokens drop to NEG_INF before temperature/top-k/top-p, so
    every downstream filter sees the constrained distribution."""
    if legal_mask is None:
        return logits
    return torch.where(legal_mask, logits.float(), NEG_INF)


def sample(
    logits: torch.Tensor,
    generator: torch.Generator,
    *,
    temperature=0.0,
    top_k=0,
    top_p=1.0,
    legal_mask=None,
) -> torch.Tensor:
    """logits [B, V] -> token ids [B] int32.

    Each parameter is a python scalar (whole batch) or a [B] tensor (per
    request). temperature <= 0 means greedy argmax for that row; top_k=0 /
    top_p=1.0 disable the filters. All-scalar greedy is a bare argmax.

    ``legal_mask`` ([B, V] bool tensor or None) constrains rows to their
    legal tokens: illegal logits drop to NEG_INF before any filter, and a
    row whose mask admits exactly one token takes that token on both the
    greedy and the sampled path. All-masked rows are a caller bug;
    validate with ``check_legal_mask`` before dispatch.
    """
    if legal_mask is not None:
        logits = _apply_mask(logits, legal_mask)
        forced = legal_mask.to(torch.uint8).argmax(dim=-1).to(torch.int32)
        single = legal_mask.sum(dim=-1) == 1
        toks = sample(logits, generator, temperature=temperature,
                      top_k=top_k, top_p=top_p)
        return torch.where(single, forced, toks)
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
    temp = _rows(temperature, torch.float32, B, dev)
    top_k = _rows(top_k, torch.int32, B, dev)
    top_p = _rows(top_p, torch.float32, B, dev)
    greedy = logits.argmax(dim=-1).to(torch.int32)
    scaled = filter_logits(logits, temp, top_k, top_p,
                           no_topk=no_topk, no_topp=no_topp)
    sampled = _categorical(scaled, generator)
    return torch.where(temp > 0, sampled, greedy)


def _rows(a, dtype, n: int, device) -> torch.Tensor:
    """A python scalar or an [n] per-row tensor as an [n] tensor of
    ``dtype`` on ``device``; a scalar is filled on the device, never
    copied from the host (a CUDA-graph capture refuses the copy)."""
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=dtype).expand(n)
    return torch.full((n,), a, dtype=dtype, device=device)


def _categorical(logits: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """One draw per row from softmax(logits): ``torch.multinomial``'s own
    one-sample path written out (exponential noise q, argmax of p / q), so
    it draws the same numbers from ``generator`` and picks the same
    tokens. Written out because ``multinomial`` checks its input first,
    with a host sync or a device-side assert, which a CUDA-graph capture
    refuses and which would turn a NaN row into a sticky device error
    instead of a row for the NaN guard."""
    probs = torch.softmax(logits, dim=-1)
    q = torch.empty_like(probs).exponential_(1, generator=generator)
    return torch.argmax(probs / q, dim=-1).to(torch.int32)


def filter_logits(
    logits: torch.Tensor,   # [B, V] float32
    temp: torch.Tensor,     # [B] (rows <= 0 pass through at scale 1)
    top_k: torch.Tensor,    # [B] int
    top_p: torch.Tensor,    # [B] float
    *,
    no_topk: bool = False,
    no_topp: bool = False,
    legal_mask=None,
) -> torch.Tensor:
    """Temperature-scaled, top-k/top-p-masked logits [B, V].

    ``legal_mask`` applies first, so top-k/top-p renormalize over the
    constrained support (top-k acts as min(k, legal count))."""
    B, V = logits.shape
    logits = _apply_mask(logits, legal_mask)
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


def _per_row(a, dtype, B: int, W: int, device) -> torch.Tensor:
    """A python scalar or a [B] per-request tensor, repeated over each
    row's W positions -> [B * W]."""
    if not isinstance(a, torch.Tensor):
        return _rows(a, dtype, B * W, device)
    return a.to(device=device, dtype=dtype).reshape(B, 1).expand(B, W).reshape(B * W)


def _filtered(logits: torch.Tensor, temperature, top_k, top_p) -> torch.Tensor:
    """[B, W, V] logits -> the filtered target logits [B * W, V] float32 and
    the per-position temperature [B * W]."""
    B, W, V = logits.shape
    dev = logits.device
    temp = _per_row(temperature, torch.float32, B, W, dev)
    no_topk = isinstance(top_k, int) and top_k == 0
    no_topp = isinstance(top_p, (int, float)) and top_p >= 1.0
    filtered = filter_logits(
        logits.reshape(B * W, V).float(), temp,
        _per_row(top_k, torch.int32, B, W, dev), _per_row(top_p, torch.float32, B, W, dev),
        no_topk=no_topk, no_topp=no_topp,
    )
    return filtered, temp


def spec_verify_sample(
    logits: torch.Tensor,       # [B, W, V] verify logits
    draft_next: torch.Tensor,   # [B, W] the draft each position checks; -1 none
    generator: torch.Generator,
    *,
    temperature=0.0,
    top_k=0,
    top_p=1.0,
    legal_mask=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-position draft acceptance: ``(accept [B, W] bool, alt [B, W]
    int32)``, the counterpart of ``orion_tpu/infer/sampling.py``'s. The host walks a row left to right, emitting
    draft j+1 while ``accept[j]`` holds and ``alt[j]`` at the first
    rejection or at the row's bonus position.

    Greedy rows (temperature <= 0): accept is an exact argmax match and
    alt the argmax; the all-scalar greedy case draws nothing from
    ``generator``. Sampled rows: rejection sampling against the filtered
    target p (``filter_logits``): accept with probability p(draft) (one
    u ~ U[0, 1) per position, drawn first), else alt from p with the draft
    excluded (the residual; the bonus position excludes nothing). Every
    emitted token's law is p. The draws come from ``generator``, not
    ``jax.random``: streams differ from the JAX package's, laws do not.

    ``legal_mask`` ([B, W, V] bool or None): position j's mask is the
    constraint state after the row's draft prefix up to j. Masking before
    filtering makes a forced draft's p exactly 1.0, so it is always
    accepted, greedy or sampled."""
    B, W, V = logits.shape
    logits = _apply_mask(logits, legal_mask)
    greedy = logits.argmax(dim=-1).to(torch.int32)
    dn = draft_next.to(logits.device).to(torch.int32)
    if isinstance(temperature, (int, float)) and temperature <= 0.0:
        return greedy == dn, greedy
    filtered, temp = _filtered(logits, temperature, top_k, top_p)
    dn = dn.reshape(B * W)
    probs = torch.softmax(filtered, dim=-1)
    p_draft = torch.gather(probs, 1, dn.clamp(0, V - 1).long()[:, None])[:, 0]
    u = torch.rand(B * W, generator=generator, device=logits.device)
    vocab = torch.arange(V, device=logits.device)[None, :]
    excl = (vocab == dn[:, None]) & (dn >= 0)[:, None]
    alt_s = _categorical(filtered.masked_fill(excl, NEG_INF), generator)
    g = greedy.reshape(B * W)
    accept = torch.where(temp > 0, u < p_draft, g == dn) & (dn >= 0)
    alt = torch.where(temp > 0, alt_s, g)
    return accept.reshape(B, W), alt.reshape(B, W)


def spec_verify_sample_tree(
    logits: torch.Tensor,   # [B, W, V] verify logits, one row per column
    tokens: torch.Tensor,   # [B, W] col 0 the pending token, then tree nodes
    parents: torch.Tensor,  # [B, W] parent column per column (col 0 ignored)
    lens: torch.Tensor,     # [B] real columns (1..W)
    generator: torch.Generator,
    *,
    temperature=0.0,
    top_k=0,
    top_p=1.0,
    legal_mask=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Token-tree acceptance, CHILD-indexed: ``accept[c]`` says whether
    node column c is accepted by its parent's logits, ``alt[j]`` is column
    j's fallback token. Counterpart of ``orion_tpu/infer/sampling.py``'s.

    Greedy: ``accept[c]`` is an exact argmax match against the parent
    (siblings are distinct, so at most one matches) and nothing is drawn
    in the all-scalar case. Sampled: sibling c is accepted with
    probability ``p(x_c) / (1 - elder siblings' p)`` (sequential multi-
    branch rejection against the shared filtered target, one u per
    column drawn first), and ``alt[j]`` is drawn from j's target with
    j's own children's tokens excluded. Every emitted token's law is p.

    ``legal_mask`` ([B, W, V] bool or None): column j's mask is the
    constraint state after j's ancestor path, so siblings at an FSM branch
    point are each legal under their shared parent's mask."""
    B, W, V = logits.shape
    logits = _apply_mask(logits, legal_mask)
    dev = logits.device
    steps = torch.arange(W, device=dev)[None, :]
    lens = lens.to(dev)
    tokens = tokens.to(dev).long()
    valid = (steps >= 1) & (steps < lens[:, None])                  # [B, W]
    par = parents.to(dev).long().clamp(0, W - 1)
    greedy = logits.argmax(dim=-1).to(torch.int32)                  # [B, W]
    g_accept = valid & (torch.gather(greedy, 1, par) == tokens)
    if isinstance(temperature, (int, float)) and temperature <= 0.0:
        return g_accept, greedy
    filtered, temp = _filtered(logits, temperature, top_k, top_p)
    filtered = filtered.reshape(B, W, V)
    probs = torch.softmax(filtered, dim=-1)
    bidx = torch.arange(B, device=dev)[:, None]
    parent_probs = probs[bidx, par]                                 # [B, W, V]
    p_vals = torch.gather(parent_probs, 2, tokens.clamp(0, V - 1)[:, :, None])[:, :, 0]
    p_vals = torch.where(valid, p_vals, torch.zeros_like(p_vals))
    # Elder-sibling mass: same parent, earlier column.
    same_par = par[:, :, None] == par[:, None, :]
    elder = (same_par & (steps[:, None, :] < steps[:, :, None])
             & valid[:, :, None] & valid[:, None, :])
    mass = torch.einsum("bcs,bs->bc", elder.float(), p_vals)
    u = torch.rand(B, W, generator=generator, device=dev)
    s_accept = valid & (u * torch.clamp(1.0 - mass, min=1e-9) < p_vals)
    # Residual per node: its target with its children's tokens excluded
    # (child tokens scattered onto their parents' rows; invalid columns
    # land on a dropped extra row).
    excl = torch.zeros(B, W + 1, V, dtype=torch.bool, device=dev)
    excl[bidx.expand(B, W), torch.where(valid, par, W), tokens.clamp(0, V - 1)] = True
    alt_s = _categorical(
        filtered.masked_fill(excl[:, :W], NEG_INF).reshape(B * W, V), generator
    ).reshape(B, W)
    tmat = temp.reshape(B, W)
    accept = torch.where(tmat > 0, s_accept, g_accept)
    alt = torch.where(tmat > 0, alt_s, greedy)
    return accept, alt
