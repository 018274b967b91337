"""orion_tpu_torch: the PyTorch/CUDA port of orion_tpu, for NVIDIA Hopper.

A second package beside the JAX one (``orion_tpu``, the reference), with
the same module layout and names: ``config``, ``ops``, ``models``,
``infer``, ``generate``. It imports ``torch`` and numpy, never ``jax`` and
nothing of ``orion_tpu``.

This slice serves: ``infer.InferenceEngine`` prefills and decodes over the
paged KV pool on four hand-written Hopper kernels — RMSNorm and RoPE in
Triton, flash-attention prefill and paged decode attention in CUDA C++
(``csrc/``). Every kernel has a plain PyTorch version beside it, which is
what runs for CPU tensors.
"""

__version__ = "0.1.0"
