"""Fused-op surface of the port: attention, RoPE, RMSNorm/LayerNorm, paged
decode attention.

Every op has a plain PyTorch version and, where the JAX package wrote a
Pallas kernel on the serving path, a kernel written by hand for Hopper.
Which one runs follows the tensors' device (see ``ops/common.py``).
"""

from orion_tpu_torch.ops.attention import (
    attention,
    attention_mask,
    attention_plain,
    flash_attention_cuda,
)
from orion_tpu_torch.ops.norms import layernorm, rmsnorm, rmsnorm_plain, rmsnorm_triton
from orion_tpu_torch.ops.paged_attention import (
    paged_attention,
    paged_attention_cuda,
    paged_attention_plain,
)
from orion_tpu_torch.ops.rope import (
    apply_rope,
    rope_frequencies,
    rope_plain,
    rope_triton,
)

# The kernel wrappers of the serving path, each with its ``launches`` count.
KERNELS = {
    "rmsnorm_fwd": rmsnorm_triton,
    "rope_fwd": rope_triton,
    "flash_fwd": flash_attention_cuda,
    "paged_decode": paged_attention_cuda,
}


def reset_launches() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def launches() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}


__all__ = [
    "KERNELS",
    "apply_rope",
    "attention",
    "attention_mask",
    "attention_plain",
    "flash_attention_cuda",
    "launches",
    "layernorm",
    "paged_attention",
    "paged_attention_cuda",
    "paged_attention_plain",
    "reset_launches",
    "rmsnorm",
    "rmsnorm_plain",
    "rmsnorm_triton",
    "rope_frequencies",
    "rope_plain",
    "rope_triton",
]
