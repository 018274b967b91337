"""Parallelism strategies over the mesh's process groups.

Counterpart of ``orion_tpu/parallel``. Ported so far: sequence / context
parallelism (``parallel/sequence.py``: ring, striped ring, Ulysses). The
JAX package's sharding rules, ZeRO-1, resharding and pipelines are not
ported yet (ROADMAP.md, Queue 1).
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
