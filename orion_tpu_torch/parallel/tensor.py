"""Tensor parallelism for serving: this rank's place on the ``tp`` axis and
the head arithmetic of a head-sharded model.

The JAX package shards the parameters over ``tp`` by its rules
(``heads``, ``kv_heads``, ``mlp`` and ``vocab`` go to ``tp``), lets XLA
partition the dense math from those shardings, and runs each Pallas
attention kernel per head shard under ``shard_map``. The port runs one
process per device: each rank holds its blocks of the parameters
(``models.convert.shard_params``) and ``n_kv_heads / tp`` heads of every
page of the KV pool, launches the same kernels on its ``n_heads / tp``
query heads, and does by hand the collectives XLA derives
(``models/transformer.py``: the column- and row-parallel products, the
vocab-parallel embedding and the gathered logits).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

from orion_tpu_torch.runtime.mesh import axis_size


@dataclasses.dataclass(frozen=True)
class TensorParallel:
    """The ``tp`` axis as one rank sees it: the axis's process group, its
    size and this rank's index on it."""

    group: Any
    size: int
    rank: int


def tp_of(mesh) -> Optional[TensorParallel]:
    """The mesh's ``tp`` axis, or None when it is 1 (or there is no mesh)."""
    if mesh is None or axis_size(mesh, "tp") == 1:
        return None
    return TensorParallel(group=mesh.get_group("tp"), size=axis_size(mesh, "tp"),
                          rank=mesh.get_local_rank("tp"))
