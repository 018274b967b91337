"""Models of the port (dense decoder-only transformer)."""

from orion_tpu_torch.models.convert import from_jax_params, init_params, to_device
from orion_tpu_torch.models.transformer import forward, loss_fn

__all__ = ["forward", "from_jax_params", "init_params", "loss_fn", "to_device"]
