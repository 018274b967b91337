"""RMSNorm / LayerNorm, with RMSNorm's forward (K1) and its backward (K5:
dx, and the scale's gradient in the same pass) as CUDA kernels for Hopper
(``csrc/rmsnorm.cu``).

K1 replaces the TPU kernel ``orion_tpu/ops/pallas/norms.py::_fwd_kernel``
(the ``pl.pallas_call`` in ``_rows_call``): y = x * rsqrt(mean(x^2) + eps)
* scale, in float32, cast back to x's dtype. K5 replaces ``_dx_kernel``
(same ``pl.pallas_call``): for a cotangent g it recomputes
r = rsqrt(mean(x^2) + eps) and writes dx = r * (g*s - x * r^2 *
mean(g*s*x)) in float32, cast to x's dtype; where the scale needs a
gradient it also writes float32 partial sums of dscale = sum over rows of
g * x * r, which the wrapper adds up with one ``sum(0)`` (the JAX package
leaves dscale to XLA as one fused reduction beside ``_dx_kernel``; eager
PyTorch would take it in seven passes over x and g in float32).

What bounds both on an H100: bytes, a few operations per element moved.
The kernels give each row a group of 4-8 warps (two 16-byte vectors a
lane each) over a persistent grid, keep the next rows' loads in flight
while they reduce and store the current one, read the scale through L1
in the rows' vector layout, and write dscale's partials without atomics,
so two launches give the same bits (``csrc/rmsnorm.cu`` says how).
``norm_scale_plus_one`` stays outside the kernels, as in
``models/transformer._norm``, so autograd carries the ``(1 + w)`` itself.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from orion_tpu_torch.ops import _build
from orion_tpu_torch.ops.common import check_dtype, counted, on_cuda


def rmsnorm_plain(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """The plain version: float32 math, cast back (``_rmsnorm_xla``).
    Differentiable by autograd, which is how the CPU path trains."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * scale.float()).to(x.dtype)


def rmsnorm_bwd_plain(
    x: torch.Tensor, scale: torch.Tensor, g: torch.Tensor, eps: float
) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain backward, ``_rmsnorm_bwd``'s float32 formulas: (dx in x's
    dtype, dscale in the scale's dtype) for the cotangent g."""
    D = x.shape[-1]
    xf, gf = x.reshape(-1, D).float(), g.reshape(-1, D).float()
    r = torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    u = gf * scale.float()
    dx = r * (u - xf * r * r * (u * xf).mean(dim=-1, keepdim=True))
    dscale = torch.einsum("rd,rd->d", gf, xf * r)
    return dx.to(x.dtype).view(x.shape), dscale.to(scale.dtype)


_DTYPE = {torch.bfloat16: 1, torch.float32: 0}
_FWD_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p]
_BWD_ARGS = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
             + [ctypes.c_float, ctypes.c_void_p])


def _rows(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """x as contiguous [R, D] rows, after checking both tensors lie on a
    CUDA device (before anything is built) and their dtypes and shapes."""
    if not (x.is_cuda and scale.is_cuda):
        raise ValueError("the RMSNorm kernels take CUDA tensors; CPU tensors go to "
                         "rmsnorm_plain / rmsnorm_bwd_plain")
    check_dtype("x", x)
    check_dtype("scale", scale)
    D = x.shape[-1]
    if D < 1 or scale.shape != (D,):
        raise ValueError(f"scale shape {tuple(scale.shape)} != ({D},)")
    return x.contiguous().view(-1, D)


@counted
def rmsnorm_cuda(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """Launch K1 on CUDA tensors; x [..., D], scale [D] (bf16 or float32,
    either beside either)."""
    x2 = _rows(x, scale)
    s = scale.contiguous()
    out = torch.empty_like(x2)
    R, D = x2.shape
    if R:
        rc = _build.entry("rmsnorm", "rmsnorm_fwd", _FWD_ARGS)(
            x2.data_ptr(), s.data_ptr(), out.data_ptr(), R, D, _DTYPE[x2.dtype],
            int(s.dtype == torch.float32), float(eps),
            torch.cuda.current_stream(x2.device).cuda_stream)
        _build.check(rc, "rmsnorm_fwd")
        rmsnorm_cuda.launches += 1
    return out.view(x.shape)


@functools.lru_cache(maxsize=None)
def _n_partials(R: int, D: int, dtype: int, aligned: int, device: int) -> int:
    """Partial rows K5 writes at this shape (a function of the shape and
    the card's residency, so fixed from launch to launch)."""
    with torch.cuda.device(device):
        n = _build.entry("rmsnorm", "rmsnorm_bwd_partials", [ctypes.c_int] * 4)(
            R, D, dtype, aligned)
    if n < 1:
        _build.check(-n, "rmsnorm_bwd_partials")
    return n


def rmsnorm_bwd_partials(
    x: torch.Tensor, scale: torch.Tensor, g: torch.Tensor, eps: float, need_dscale: bool
) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Launch K5 on CUDA tensors: (dx in x's dtype, dscale's float32
    partial rows [n, D] whose sum over rows is dscale, or None unless
    ``need_dscale``). Counted on ``rmsnorm_bwd_cuda``."""
    x2 = _rows(x, scale)
    if not g.is_cuda or g.shape != x.shape or g.dtype != x.dtype:
        raise ValueError(f"cotangent {tuple(g.shape)} {g.dtype} must match x "
                         f"{tuple(x.shape)} {x.dtype} on the same device")
    g2 = g.contiguous().view(x2.shape)
    s = scale.contiguous()
    R, D = x2.shape
    dx = torch.empty_like(x2)
    part = None
    if not R:
        if need_dscale:
            part = torch.zeros(1, D, dtype=torch.float32, device=x2.device)
        return dx.view(x.shape), part
    dt = _DTYPE[x2.dtype]
    if need_dscale:
        aligned = int(all(t.data_ptr() % 16 == 0 for t in (x2, g2, dx, s)))
        n = _n_partials(R, D, dt, aligned, x2.device.index)
        part = torch.empty(n, D, dtype=torch.float32, device=x2.device)
    rc = _build.entry("rmsnorm", "rmsnorm_bwd", _BWD_ARGS)(
        x2.data_ptr(), s.data_ptr(), g2.data_ptr(), dx.data_ptr(),
        None if part is None else part.data_ptr(), 0 if part is None else part.shape[0],
        R, D, dt, int(s.dtype == torch.float32), float(eps),
        torch.cuda.current_stream(x2.device).cuda_stream)
    _build.check(rc, "rmsnorm_bwd")
    rmsnorm_bwd_cuda.launches += 1
    return dx.view(x.shape), part


@counted
def rmsnorm_bwd_cuda(
    x: torch.Tensor, scale: torch.Tensor, g: torch.Tensor, eps: float,
    need_dscale: bool = True,
) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
    """K5 on CUDA tensors: (dx of ``rmsnorm`` at x for the cotangent g, in
    x's dtype; dscale in the scale's dtype, or None unless
    ``need_dscale``)."""
    dx, part = rmsnorm_bwd_partials(x, scale, g, eps, need_dscale)
    dscale = None if part is None else part.sum(dim=0).to(scale.dtype)
    return dx, dscale


class _RMSNorm(torch.autograd.Function):
    """K1 forward, K5 backward (one launch for dx and dscale); saves
    (x, scale) as ``_rmsnorm_fwd`` does."""

    @staticmethod
    def forward(ctx, x, scale, eps):
        ctx.eps = eps
        ctx.save_for_backward(x, scale)
        return rmsnorm_cuda(x, scale, eps)

    @staticmethod
    def backward(ctx, g):
        x, scale = ctx.saved_tensors
        dx, dscale = rmsnorm_bwd_cuda(x, scale, g, ctx.eps, ctx.needs_input_grad[1])
        return (dx if ctx.needs_input_grad[0] else None), dscale, None


def rmsnorm(
    x: torch.Tensor, scale: torch.Tensor, *, eps: float = 1e-5
) -> torch.Tensor:
    """Root-mean-square normalization over the last axis. On CUDA a call
    that needs a gradient goes through K1 forward and K5 backward."""
    if on_cuda(x, scale):
        if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad):
            return _RMSNorm.apply(x, scale, eps)
        return rmsnorm_cuda(x, scale, eps)
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
