"""Serving: the continuous-batching engine over the paged KV pool."""

from orion_tpu_torch.infer.engine import InferenceEngine
from orion_tpu_torch.infer.scheduler import Request

__all__ = ["InferenceEngine", "Request"]
