"""Rotary position embeddings, with the rotation (K2) and its VJP (K6) as
one Triton kernel.

K2 replaces the TPU kernel ``orion_tpu/ops/pallas/rope.py::_rope_kernel``
with ``flip=False``: the Llama rotate-half rotation of every head of
x [B, S, N, H] by angles computed in-kernel from int32 positions. K6
replaces the same kernel with ``flip=True``, its VJP: the rotation is
orthogonal, so the cotangent is rotated back by the negated angles — the
same kernel with the sign of ``sin`` flipped (a ``FLIP`` constexpr), and
positions get no gradient. Each has its own wrapper and launch count.

What bounds it on an H100: bytes. Each element is read once and written
once with a handful of operations. The design gives one program a tile of
``BLOCK_S`` tokens of one batch row: it computes the tile's [BLOCK_S, H/2]
angles once, with libdevice's accurate ``cos``/``sin`` (the approximate
PTX forms lose accuracy at angles of thousands of radians, and positions
reach 8191 at Llama-3-8B serving lengths), then walks all N heads of the
tile with the angles held in registers — no cos/sin table ever goes to
device memory.

Frequencies: the JAX package's two paths compute them differently
(``1/theta**(i/half)`` in ``ops/rope.py``, ``exp(-log(theta) i/half)`` in
the Pallas kernel). Here the wrapper hands the kernel the [H/2] float32
inverse-frequency vector of ``rope_inv_freq``, computed as the xla path
does, on the CPU once per (head_dim, theta), so the kernel and the plain
version multiply by identical frequencies on any device.
"""

from __future__ import annotations

import functools

import torch

from orion_tpu_torch.ops.common import check_dtype, counted, on_cuda, triton_libdevice


@functools.lru_cache(maxsize=None)
def _inv_freq(head_dim: int, theta: float, device: torch.device) -> torch.Tensor:
    half = head_dim // 2
    freq = 1.0 / (
        torch.tensor(theta, dtype=torch.float32)
        ** (torch.arange(half, dtype=torch.float32) / half)
    )
    return freq.to(device)


def rope_inv_freq(head_dim: int, theta: float, device) -> torch.Tensor:
    """[head_dim // 2] float32 inverse frequencies (``_rope_xla``'s),
    computed on the CPU and kept on ``device``: one copy per device."""
    return _inv_freq(int(head_dim), float(theta), torch.device(device))


def rope_frequencies(
    head_dim: int, positions: torch.Tensor, theta: float
) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables [..., head_dim // 2] float32 for integer positions."""
    freq = rope_inv_freq(head_dim, theta, positions.device)
    angles = positions.float()[..., None] * freq
    return torch.cos(angles), torch.sin(angles)


def rope_plain(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """The plain version (``_rope_xla``): x [B, S, N, H], positions [B, S]."""
    cos, sin = rope_frequencies(x.shape[-1], positions, theta)
    cos = cos[:, :, None, :]
    sin = sin[:, :, None, :]
    xf = x.float()
    x1, x2 = xf.chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


_KERNEL = None
# Triton's language modules, bound by _kernel() at the first launch: the
# jitted body looks them up as module globals, which every Triton release
# resolves (closure variables are not). The CPU has no Triton.
tl = libdevice = None


def _kernel():
    global _KERNEL, tl, libdevice
    if _KERNEL is not None:
        return _KERNEL
    import triton
    import triton.language as tl

    libdevice = triton_libdevice()  # noqa: F811

    @triton.jit
    def _rope_fwd(
        x_ptr, pos_ptr, f_ptr, o_ptr, S, N,
        HALF: tl.constexpr, BLOCK_S: tl.constexpr, FLIP: tl.constexpr,
    ):
        b = tl.program_id(0).to(tl.int64)
        s0 = tl.program_id(1) * BLOCK_S
        rows = s0 + tl.arange(0, BLOCK_S)
        rm = rows < S
        cols = tl.arange(0, HALF)
        pos = tl.load(pos_ptr + b * S + rows, mask=rm, other=0).to(tl.float32)
        freq = tl.load(f_ptr + cols)
        ang = pos[:, None] * freq[None, :]
        c = libdevice.cos(ang)
        s = libdevice.sin(ang)
        if FLIP:
            s = -s
        m = rm[:, None]
        base = (b * S + rows.to(tl.int64))[:, None] * (N * 2 * HALF)
        for n in range(N):
            p1 = base + n * (2 * HALF) + cols[None, :]
            x1 = tl.load(x_ptr + p1, mask=m, other=0.0).to(tl.float32)
            x2 = tl.load(x_ptr + p1 + HALF, mask=m, other=0.0).to(tl.float32)
            ty = o_ptr.dtype.element_ty
            tl.store(o_ptr + p1, (x1 * c - x2 * s).to(ty), mask=m)
            tl.store(o_ptr + p1 + HALF, (x2 * c + x1 * s).to(ty), mask=m)

    _KERNEL = _rope_fwd
    return _KERNEL


def _launch(x: torch.Tensor, positions: torch.Tensor, theta: float, flip: bool):
    """Run the kernel over x [B, S, N, H]; returns (out, launched)."""
    check_dtype("x", x)
    B, S, N, H = x.shape
    half = H // 2
    if H % 2 or half & (half - 1):
        raise ValueError(f"head_dim {H} must be twice a power of two")
    if positions.shape != (B, S):
        raise ValueError(f"positions {tuple(positions.shape)} != ({B}, {S})")
    fn = _kernel()
    xc = x.contiguous()
    out = torch.empty_like(xc)
    pos = positions.to(torch.int32).contiguous()
    freq = rope_inv_freq(H, theta, x.device)
    if not (B and S):
        return out, False
    block_s = 16
    fn[(B, (S + block_s - 1) // block_s)](
        xc, pos, freq, out, S, N, HALF=half, BLOCK_S=block_s, FLIP=flip,
        num_warps=4,
    )
    return out, True


@counted
def rope_triton(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Launch K2 on CUDA tensors: x [B, S, N, H], positions [B, S]."""
    out, launched = _launch(x, positions, theta, False)
    if launched:
        rope_triton.launches += 1
    return out


@counted
def rope_bwd_triton(g: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Launch K6 on CUDA tensors: the cotangent g [B, S, N, H] of
    ``rope_triton`` rotated back (the VJP with respect to x)."""
    out, launched = _launch(g, positions, theta, True)
    if launched:
        rope_bwd_triton.launches += 1
    return out


class _Rope(torch.autograd.Function):
    """K2 forward, K6 backward; only positions are saved, as ``_rope_fwd``
    does."""

    @staticmethod
    def forward(ctx, x, positions, theta):
        ctx.theta = theta
        ctx.save_for_backward(positions)
        return rope_triton(x, positions, theta)

    @staticmethod
    def backward(ctx, g):
        (positions,) = ctx.saved_tensors
        return rope_bwd_triton(g, positions, ctx.theta), None, None


def apply_rope(
    x: torch.Tensor, positions: torch.Tensor, *, theta: float = 500_000.0
) -> torch.Tensor:
    """Apply rotary embedding to q or k.

    x: [B, S, N, H]; positions: [B, S] (or [S], broadcast over batch).
    """
    if positions.dim() == 1:
        positions = positions[None, :].expand(x.shape[0], -1)
    if on_cuda(x, positions):
        if torch.is_grad_enabled() and x.requires_grad:
            return _Rope.apply(x, positions, theta)
        return rope_triton(x, positions, theta)
    return rope_plain(x, positions, theta)
