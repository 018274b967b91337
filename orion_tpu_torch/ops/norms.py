"""RMSNorm / LayerNorm, with RMSNorm's forward (K1) and its dx (K5) as
Triton kernels.

K1 replaces the TPU kernel ``orion_tpu/ops/pallas/norms.py::_fwd_kernel``
(the ``pl.pallas_call`` in ``_rows_call``): y = x * rsqrt(mean(x^2) + eps)
* scale, in float32, cast back to x's dtype. K5 replaces ``_dx_kernel``
(same ``pl.pallas_call``): for a cotangent g it recomputes
r = rsqrt(mean(x^2) + eps) and writes dx = r * (g*s - x * r^2 *
mean(g*s*x)) in float32, cast to x's dtype. dscale = sum over rows of
g * x * r stays a plain PyTorch reduction, as the JAX package leaves it
to XLA outside the kernel.

What bounds both on an H100: bytes. Each reads its rows once and writes
them once (K5: x and g in, dx out) with a handful of operations per
element, far below the card's ridge point. The design keeps one row in
registers per program: a masked load of the whole row (D rounded up to a
power of two), the row reductions, and the store in the same pass, so
every byte crosses device memory exactly once. ``norm_scale_plus_one``
stays outside the kernels, as in ``models/transformer._norm``, so
autograd carries the ``(1 + w)`` itself.
"""

from __future__ import annotations

from typing import Optional

import torch

from orion_tpu_torch.ops.common import check_dtype, counted, on_cuda, triton_libdevice


def rmsnorm_plain(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """The plain version: float32 math, cast back (``_rmsnorm_xla``).
    Differentiable by autograd, which is how the CPU path trains."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * scale.float()).to(x.dtype)


_KERNELS = None
# Triton's language modules, bound by _kernels() at the first launch: the
# jitted bodies look them up as module globals, which every Triton release
# resolves (closure variables are not). The CPU has no Triton.
tl = libdevice = None


def _kernels():
    global _KERNELS, tl, libdevice
    if _KERNELS is not None:
        return _KERNELS
    import triton
    import triton.language as tl

    libdevice = triton_libdevice()  # noqa: F811

    @triton.jit
    def _rmsnorm_fwd(x_ptr, s_ptr, o_ptr, D, eps, BLOCK_D: tl.constexpr):
        row = tl.program_id(0).to(tl.int64)
        cols = tl.arange(0, BLOCK_D)
        m = cols < D
        x = tl.load(x_ptr + row * D + cols, mask=m, other=0.0).to(tl.float32)
        r = 1.0 / libdevice.sqrt(tl.sum(x * x, axis=0) / D + eps)
        s = tl.load(s_ptr + cols, mask=m, other=0.0).to(tl.float32)
        y = x * r * s
        tl.store(o_ptr + row * D + cols, y.to(o_ptr.dtype.element_ty), mask=m)

    @triton.jit
    def _rmsnorm_bwd(x_ptr, s_ptr, g_ptr, o_ptr, D, eps, BLOCK_D: tl.constexpr):
        row = tl.program_id(0).to(tl.int64)
        cols = tl.arange(0, BLOCK_D)
        m = cols < D
        x = tl.load(x_ptr + row * D + cols, mask=m, other=0.0).to(tl.float32)
        g = tl.load(g_ptr + row * D + cols, mask=m, other=0.0).to(tl.float32)
        s = tl.load(s_ptr + cols, mask=m, other=0.0).to(tl.float32)
        r = 1.0 / libdevice.sqrt(tl.sum(x * x, axis=0) / D + eps)
        u = g * s
        c = tl.sum(u * x, axis=0) / D
        dx = r * (u - x * r * r * c)
        tl.store(o_ptr + row * D + cols, dx.to(o_ptr.dtype.element_ty), mask=m)

    _KERNELS = (triton, _rmsnorm_fwd, _rmsnorm_bwd)
    return _KERNELS


def _rows(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    check_dtype("x", x)
    check_dtype("scale", scale)
    D = x.shape[-1]
    if scale.shape != (D,):
        raise ValueError(f"scale shape {tuple(scale.shape)} != ({D},)")
    return x.contiguous().view(-1, D)


def _launch(fn, triton, tensors, D: int, eps: float) -> None:
    """One program per row of ``tensors[0]`` ([R, D])."""
    block = triton.next_power_of_2(D)
    fn[(tensors[0].shape[0],)](
        *tensors, D, float(eps), BLOCK_D=block,
        num_warps=min(max(block // 512, 1), 16),
    )


@counted
def rmsnorm_triton(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """Launch K1 on CUDA tensors; x [..., D], scale [D]."""
    x2 = _rows(x, scale)
    triton, fwd, _ = _kernels()
    out = torch.empty_like(x2)
    if x2.shape[0]:
        _launch(fwd, triton, (x2, scale.contiguous(), out), x2.shape[1], eps)
        rmsnorm_triton.launches += 1
    return out.view(x.shape)


@counted
def rmsnorm_bwd_triton(
    x: torch.Tensor, scale: torch.Tensor, g: torch.Tensor, eps: float
) -> torch.Tensor:
    """Launch K5 on CUDA tensors: dx of ``rmsnorm`` at x for the
    cotangent g (same shape as x), in x's dtype."""
    x2 = _rows(x, scale)
    if g.shape != x.shape:
        raise ValueError(f"cotangent shape {tuple(g.shape)} != x {tuple(x.shape)}")
    check_dtype("g", g)
    g2 = g.contiguous().view(x2.shape)
    triton, _, bwd = _kernels()
    out = torch.empty_like(x2)
    if x2.shape[0]:
        _launch(bwd, triton, (x2, scale.contiguous(), g2, out), x2.shape[1], eps)
        rmsnorm_bwd_triton.launches += 1
    return out.view(x.shape)


class _RMSNorm(torch.autograd.Function):
    """K1 forward, K5 backward; saves (x, scale) as ``_rmsnorm_fwd`` does."""

    @staticmethod
    def forward(ctx, x, scale, eps):
        ctx.eps = eps
        ctx.save_for_backward(x, scale)
        return rmsnorm_triton(x, scale, eps)

    @staticmethod
    def backward(ctx, g):
        x, scale = ctx.saved_tensors
        dx = dscale = None
        if ctx.needs_input_grad[0]:
            dx = rmsnorm_bwd_triton(x, scale, g, ctx.eps)
        if ctx.needs_input_grad[1]:
            D = x.shape[-1]
            xf = x.reshape(-1, D).float()
            r = torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + ctx.eps)
            dscale = torch.einsum("rd,rd->d", g.reshape(-1, D).float(), xf * r)
            dscale = dscale.to(scale.dtype)
        return dx, dscale, None


def rmsnorm(
    x: torch.Tensor, scale: torch.Tensor, *, eps: float = 1e-5
) -> torch.Tensor:
    """Root-mean-square normalization over the last axis. On CUDA a call
    that needs a gradient goes through K1 forward and K5 backward."""
    if on_cuda(x, scale):
        if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad):
            return _RMSNorm.apply(x, scale, eps)
        return rmsnorm_triton(x, scale, eps)
    return rmsnorm_plain(x, scale, eps)


def layernorm(
    x: torch.Tensor,
    scale: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    *,
    eps: float = 1e-5,
) -> torch.Tensor:
    """LayerNorm over the last axis (GPT-2 family); plain PyTorch only,
    as the JAX package keeps it on its xla path."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps) * scale.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)
