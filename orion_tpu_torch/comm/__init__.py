"""Collective communication over the mesh's process groups
(``comm/collectives.py``). The JAX package's quantized collectives
(``orion_tpu/comm/quantized.py``) are not ported yet."""

from orion_tpu_torch.comm.collectives import (
    CALLS,
    STAGED,
    all_gather,
    all_reduce,
    all_to_all,
    axis_index,
    axis_size,
    barrier,
    broadcast,
    broadcast_values,
    ppermute,
    reduce_scatter,
    ring_shift,
)

__all__ = [
    "CALLS",
    "STAGED",
    "all_gather",
    "all_reduce",
    "all_to_all",
    "axis_index",
    "axis_size",
    "barrier",
    "broadcast",
    "broadcast_values",
    "ppermute",
    "reduce_scatter",
    "ring_shift",
]
