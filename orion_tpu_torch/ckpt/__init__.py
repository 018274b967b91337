"""Checkpoints in the JAX package's on-disk format (``ckpt/checkpoint.py``)."""

from orion_tpu_torch.ckpt.checkpoint import CKPT_FORMAT, CheckpointManager, CorruptCheckpoint

__all__ = ["CKPT_FORMAT", "CheckpointManager", "CorruptCheckpoint"]
