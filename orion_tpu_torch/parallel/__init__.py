"""Parallelism strategies over the mesh's process groups.

Counterpart of ``orion_tpu/parallel``. Ported so far: sequence / context
parallelism (``parallel/sequence.py``: ring, striped ring, Ulysses), the
sharding rules (``parallel/sharding.py``), the trainer's data-parallel
mesh (``parallel/data_parallel.py``: DDP, ZeRO-1, FSDP) and the serving
engine's tensor-parallel axis (``parallel/tensor.py``). Resharding and
pipelines are not ported yet (ROADMAP.md, Queue 1).
"""

from orion_tpu_torch.parallel.sequence import (
    ring_attention,
    sequence_attention,
    ulysses_attention,
)

__all__ = [
    "ring_attention",
    "sequence_attention",
    "ulysses_attention",
]
