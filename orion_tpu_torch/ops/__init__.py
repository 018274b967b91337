"""Fused-op surface of the port: attention, RoPE, RMSNorm/LayerNorm, paged
decode attention, paged-flash prefill, ragged paged attention (speculative
verification).

Every op has a plain PyTorch version and, where the JAX package wrote a
Pallas kernel on a ported path, a kernel written by hand for Hopper
(forward and, for training, backward). Which one runs follows the
tensors' device (see ``ops/common.py``).
"""

from orion_tpu_torch.ops.attention import (
    attention,
    attention_lse_plain,
    attention_mask,
    attention_plain,
    flash_attention_bwd_cuda,
    flash_attention_cuda,
    flash_attention_pos_cuda,
    flash_attention_with_lse,
    flash_dkv_cuda,
    flash_dkv_pos_cuda,
    flash_dq_cuda,
    flash_dq_pos_cuda,
)
from orion_tpu_torch.ops.flash_pos import (
    flash_attention_pos_split_plain,
    flash_pos_merge_cuda,
    flash_pos_merge_plain,
)
from orion_tpu_torch.ops.norms import (
    layernorm,
    rmsnorm,
    rmsnorm_bwd_cuda,
    rmsnorm_bwd_partials,
    rmsnorm_bwd_plain,
    rmsnorm_cuda,
    rmsnorm_plain,
)
from orion_tpu_torch.ops.common import quantize_kv
from orion_tpu_torch.ops.paged_attention import (
    paged_attention,
    paged_attention_cuda,
    paged_attention_int8_cuda,
    paged_attention_plain,
    paged_decode_merge_cuda,
    paged_decode_merge_plain,
)
from orion_tpu_torch.ops.paged_flash_prefill import (
    check_prefill_fit,
    paged_flash_prefill,
    paged_flash_prefill_cuda,
    paged_flash_prefill_int8_cuda,
    paged_flash_prefill_plain,
    paged_prefill_merge,
    paged_prefill_merge_cuda,
    paged_prefill_merge_plain,
)
from orion_tpu_torch.ops.ragged_paged_attention import (
    check_verify_fit,
    ragged_paged_attention,
    ragged_paged_attention_plain,
    ragged_verify_cuda,
    ragged_verify_int8_cuda,
    ragged_verify_merge_cuda,
    ragged_verify_merge_plain,
)
from orion_tpu_torch.ops.rope import (
    apply_rope,
    rope_bwd_triton,
    rope_frequencies,
    rope_plain,
    rope_triton,
)

# The kernel wrappers of the ported paths, each with its ``launches`` count.
KERNELS = {
    "rmsnorm_fwd": rmsnorm_cuda,
    "rope_fwd": rope_triton,
    "flash_fwd": flash_attention_cuda,
    "flash_fwd_pos": flash_attention_pos_cuda,
    "flash_fwd_pos_merge": flash_pos_merge_cuda,
    "paged_decode": paged_attention_cuda,
    "rmsnorm_bwd": rmsnorm_bwd_cuda,
    "rope_bwd": rope_bwd_triton,
    "flash_dq": flash_dq_cuda,
    "flash_dkv": flash_dkv_cuda,
    "flash_dq_pos": flash_dq_pos_cuda,
    "flash_dkv_pos": flash_dkv_pos_cuda,
    "paged_decode_int8": paged_attention_int8_cuda,
    "paged_prefill": paged_flash_prefill_cuda,
    "paged_prefill_int8": paged_flash_prefill_int8_cuda,
    "paged_prefill_merge": paged_prefill_merge_cuda,
    "ragged_verify": ragged_verify_cuda,
    "ragged_verify_int8": ragged_verify_int8_cuda,
    "paged_decode_merge": paged_decode_merge_cuda,
    "ragged_verify_merge": ragged_verify_merge_cuda,
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
    "attention_lse_plain",
    "attention_mask",
    "attention_plain",
    "check_prefill_fit",
    "check_verify_fit",
    "flash_attention_bwd_cuda",
    "flash_attention_cuda",
    "flash_attention_pos_cuda",
    "flash_attention_pos_split_plain",
    "flash_attention_with_lse",
    "flash_dkv_cuda",
    "flash_dkv_pos_cuda",
    "flash_dq_cuda",
    "flash_dq_pos_cuda",
    "flash_pos_merge_cuda",
    "flash_pos_merge_plain",
    "launches",
    "layernorm",
    "paged_attention",
    "paged_attention_cuda",
    "paged_attention_int8_cuda",
    "paged_attention_plain",
    "paged_decode_merge_cuda",
    "paged_decode_merge_plain",
    "paged_flash_prefill",
    "paged_flash_prefill_cuda",
    "paged_flash_prefill_int8_cuda",
    "paged_flash_prefill_plain",
    "paged_prefill_merge",
    "paged_prefill_merge_cuda",
    "paged_prefill_merge_plain",
    "quantize_kv",
    "ragged_paged_attention",
    "ragged_paged_attention_plain",
    "ragged_verify_cuda",
    "ragged_verify_int8_cuda",
    "ragged_verify_merge_cuda",
    "ragged_verify_merge_plain",
    "reset_launches",
    "rmsnorm",
    "rmsnorm_bwd_cuda",
    "rmsnorm_bwd_partials",
    "rmsnorm_bwd_plain",
    "rmsnorm_cuda",
    "rmsnorm_plain",
    "rope_bwd_triton",
    "rope_frequencies",
    "rope_plain",
    "rope_triton",
]
