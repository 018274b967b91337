"""orion_tpu_torch: the PyTorch/CUDA port of orion_tpu, for NVIDIA Hopper.

A second package beside the JAX one (``orion_tpu``, the reference), with
the same module layout and names: ``config``, ``ops``, ``models``,
``infer``, ``constrain``, ``generate``, ``data``, ``metrics``, ``runtime``, ``train``. It
imports ``torch`` and numpy, never ``jax`` and nothing of ``orion_tpu``.

It serves (``infer.InferenceEngine`` prefills and decodes over the paged
KV pool) and trains on one GPU (``train.Trainer``, ``python -m
orion_tpu_torch.train``) on eight hand-written Hopper kernels: RMSNorm
forward and dx and RoPE and its VJP in Triton; flash attention forward,
its dq and dk/dv backward, and paged decode attention in CUDA C++
(``csrc/``). Every kernel has a plain PyTorch version beside it, which is
what runs for CPU tensors.
"""

__version__ = "0.1.0"
