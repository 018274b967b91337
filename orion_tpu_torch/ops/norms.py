"""RMSNorm / LayerNorm, with RMSNorm's forward as a Triton kernel (K1).

K1 replaces the TPU kernel ``orion_tpu/ops/pallas/norms.py::_fwd_kernel``
(the ``pl.pallas_call`` in ``_rows_call``): y = x * rsqrt(mean(x^2) + eps)
* scale, in float32, cast back to x's dtype.

What bounds it on an H100: bytes. It reads each row once and writes it
once (about four operations per element), so it sits far below the card's
ridge point. The design keeps one row in registers per program: a masked
load of the whole row (D rounded up to a power of two), the square-mean
reduction, and the scaled store in the same pass, so every byte crosses
device memory exactly once. ``norm_scale_plus_one`` stays outside the
kernel, as in ``models/transformer._norm``.
"""

from __future__ import annotations

from typing import Optional

import torch

from orion_tpu_torch.ops.common import check_dtype, counted, on_cuda, triton_libdevice


def rmsnorm_plain(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """The plain version: float32 math, cast back (``_rmsnorm_xla``)."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * scale.float()).to(x.dtype)


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
    def _rmsnorm_fwd(x_ptr, s_ptr, o_ptr, D, eps, BLOCK_D: tl.constexpr):
        row = tl.program_id(0).to(tl.int64)
        cols = tl.arange(0, BLOCK_D)
        m = cols < D
        x = tl.load(x_ptr + row * D + cols, mask=m, other=0.0).to(tl.float32)
        r = 1.0 / libdevice.sqrt(tl.sum(x * x, axis=0) / D + eps)
        s = tl.load(s_ptr + cols, mask=m, other=0.0).to(tl.float32)
        y = x * r * s
        tl.store(o_ptr + row * D + cols, y.to(o_ptr.dtype.element_ty), mask=m)

    _KERNEL = (triton, _rmsnorm_fwd)
    return _KERNEL


@counted
def rmsnorm_triton(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """Launch K1 on CUDA tensors; x [..., D], scale [D]."""
    check_dtype("x", x)
    check_dtype("scale", scale)
    D = x.shape[-1]
    if scale.shape != (D,):
        raise ValueError(f"scale shape {tuple(scale.shape)} != ({D},)")
    triton, fn = _kernel()
    x2 = x.contiguous().view(-1, D)
    out = torch.empty_like(x2)
    R = x2.shape[0]
    if R:
        block = triton.next_power_of_2(D)
        fn[(R,)](
            x2, scale.contiguous(), out, D, float(eps), BLOCK_D=block,
            num_warps=min(max(block // 512, 1), 16),
        )
        rmsnorm_triton.launches += 1
    return out.view(x.shape)


def rmsnorm(
    x: torch.Tensor, scale: torch.Tensor, *, eps: float = 1e-5
) -> torch.Tensor:
    """Root-mean-square normalization over the last axis."""
    if on_cuda(x, scale):
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
