"""Training data: deterministic (seed, step) batch streams."""

from orion_tpu_torch.data.loader import (
    Loader,
    MemmapLoader,
    SyntheticLoader,
    make_loader,
    pack_rows,
)

__all__ = ["Loader", "MemmapLoader", "SyntheticLoader", "make_loader", "pack_rows"]
