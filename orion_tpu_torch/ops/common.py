"""Shared helpers for the port's ops and kernels.

Conventions every kernel wrapper in ``orion_tpu_torch.ops`` follows:

- Math is float32 inside the kernel whatever the activation dtype; inputs
  may be bfloat16 or float32 and outputs come back in the input's dtype.
- Dispatch follows the tensor's device. A CPU tensor goes to the plain
  PyTorch version that sits beside the kernel in the same module; a CUDA
  tensor launches the kernel, or raises. Nothing falls back silently, and
  ``ModelConfig.kernels`` is not read by the port.
- Each kernel wrapper carries a launch counter (``wrapper.launches``, a
  plain int) that it increments exactly where it launches its kernel.
  A CUDA-graph replay runs no Python, so the serving engine's graphs
  (``infer/executor.py``) record at capture what each wrapper launched
  (``recording_launches``) and credit it at every replay
  (``credit_launches``): the counts stay launches that ran.
- Under ``runtime.debug_nans`` each wrapper checks its floating outputs
  for NaN (``runtime/sanitize.py``): a dispatch mode does not see the
  kernels.
"""

from __future__ import annotations

import contextlib
import functools

import torch

from orion_tpu_torch.runtime import sanitize

NEG_INF = -1e30  # finite -inf stand-in: exp(NEG_INF - m) underflows to 0.
# float32(1/127) as a Python float (exact): the int8 scale is a MULTIPLY by
# this constant, never a divide by 127 (the two differ by an ulp on some
# inputs, enough to flip a greedy argmax).
INV127 = 0.007874015718698502


def round_up(n: int, m: int) -> int:
    return (n + m - 1) // m * m


def quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-vector int8: x [..., H] -> (q int8 [..., H], scale
    [...] float32) with x ~ q * scale; one scale per (token, kv head).

    Bit for bit the JAX package's ``quantize_kv``, and the arithmetic the
    CUDA kernels' fused writes repeat: ``s = max|x| * f32(1/127)``
    floored at 1e-8, ``q = round_half_even(x / s)`` with an IEEE divide.
    """
    xf = x.float()
    s = torch.clamp(xf.abs().amax(dim=-1) * INV127, min=1e-8)
    q = torch.round(xf / s[..., None])
    return q.to(torch.int8), s


TC_ROWS = 128   # product rows of a GQA-packed tensor-core block (G heads x q tile)


def q_tile(group: int) -> int:
    """Queries per block of a GQA-packed tensor-core kernel (K9, and K3
    with positions): the largest power of two whose G query heads fill at
    most TC_ROWS product rows."""
    if group < 1 or group > TC_ROWS:
        raise ValueError(f"{group} query heads per kv head: the tensor-core "
                         f"kernel packs at most {TC_ROWS}")
    tq = 1
    while 2 * tq * group <= TC_ROWS:
        tq *= 2
    return tq


def on_cuda(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on a CUDA device, False when every one
    lies on the CPU; raises on a mix or on any other device."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return False
    if kinds == {"cuda"}:
        return True
    raise ValueError(
        f"tensors must all lie on the CPU (plain version) or all on a CUDA "
        f"device (kernel); got devices {sorted(kinds)}"
    )


def check_dtype(name: str, t: torch.Tensor) -> None:
    if t.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name} must be float32 or bfloat16, got {t.dtype}")


def check_pools(q, k_pool, v_pool, k_scale, v_scale) -> None:
    """Validate the paged pools a kernel updates in place (K4, K9, K10):
    [rows, K, psz, H] with q's head_dim, of q's dtype or int8 with float32
    scale pools [rows, K, SW >= psz], all contiguous."""
    rows, K, psz, H = k_pool.shape
    quant = k_scale is not None
    if H != q.shape[-1] or v_pool.shape != k_pool.shape:
        raise ValueError(f"pool shapes {tuple(k_pool.shape)}, "
                         f"{tuple(v_pool.shape)} do not match q {tuple(q.shape)}")
    pool_dtype = torch.int8 if quant else q.dtype
    if k_pool.dtype != pool_dtype or v_pool.dtype != pool_dtype:
        raise TypeError(f"pools must be {pool_dtype}, got {k_pool.dtype}")
    tensors = [k_pool, v_pool]
    if quant:
        if (v_scale is None or k_scale.dtype != torch.float32
                or v_scale.shape != k_scale.shape or k_scale.dim() != 3
                or k_scale.shape[:2] != (rows, K) or k_scale.shape[2] < psz):
            raise ValueError("k_scale/v_scale must be float32 [rows, K, SW >= psz]")
        tensors += [k_scale, v_scale]
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("pools must be contiguous (they are updated in place)")


_COUNTED: list = []   # every wrapper ``counted`` made


def counted(fn):
    """Give a kernel wrapper its launch counter (``launches = 0`` on the
    returned wrapper, which the body increments through its module name)
    and, under ``runtime.debug_nans``, the NaN check of its outputs."""
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        out = fn(*args, **kwargs)
        if sanitize.debug_nans():
            sanitize.check_nan(out, fn.__name__)
        return out

    wrapper.launches = 0
    _COUNTED.append(wrapper)
    return wrapper


@contextlib.contextmanager
def recording_launches():
    """Record what a CUDA-graph capture launches: yields a dict that holds,
    on exit, ``{wrapper: launches}`` for every wrapper the block called,
    and leaves each wrapper's own count as it was before the block (a
    capture records its launches; none of them runs)."""
    before = [(fn, fn.launches) for fn in _COUNTED]
    rec: dict = {}
    try:
        yield rec
    finally:
        for fn, n in before:
            if fn.launches != n:
                rec[fn] = fn.launches - n
                fn.launches = n


def credit_launches(rec: dict) -> None:
    """Count a replay's launches: ``rec`` as ``recording_launches`` filled
    it at the graph's capture."""
    for fn, n in rec.items():
        fn.launches += n


def triton_libdevice():
    """Triton's libdevice math module (its path moved between releases).
    Imported only inside a launching function: the CPU has no Triton."""
    try:
        from triton.language.extra.cuda import libdevice
    except ImportError:
        from triton.language.extra import libdevice
    return libdevice
