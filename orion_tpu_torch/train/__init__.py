"""Training on one GPU: the trainer, its step and the optimizer.

``python -m orion_tpu_torch.train`` is the command-line entry point
(``train/__main__.py``), the counterpart of the repository's ``train.py``.
"""

from orion_tpu_torch.train.optimizer import apply_updates, init_opt_state, make_schedule
from orion_tpu_torch.train.trainer import (
    Trainer,
    init_train_state,
    loss_and_grads,
    make_train_step,
)

__all__ = [
    "Trainer",
    "apply_updates",
    "init_opt_state",
    "init_train_state",
    "loss_and_grads",
    "make_schedule",
    "make_train_step",
]
