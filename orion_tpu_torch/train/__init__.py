"""Training on one GPU or over a dp x fsdp x sp mesh of them: the trainer,
its step, the optimizer (ZeRO-1 too), and the fault stack (checkpoints,
the anomaly guard, rollback, emergency saves).

``python -m orion_tpu_torch.train`` is the command-line entry point
(``train/__main__.py``), the counterpart of the repository's ``train.py``.
"""

from orion_tpu_torch.train.optimizer import apply_updates, init_opt_state, make_schedule
from orion_tpu_torch.train.trainer import (
    FaultInjected,
    RollbackFailed,
    Trainer,
    abstract_train_state,
    init_train_state,
    loss_and_grads,
    make_train_step,
    state_from_tree,
    state_to_tree,
)

__all__ = [
    "FaultInjected",
    "RollbackFailed",
    "Trainer",
    "abstract_train_state",
    "apply_updates",
    "init_opt_state",
    "init_train_state",
    "loss_and_grads",
    "make_schedule",
    "make_train_step",
    "state_from_tree",
    "state_to_tree",
]
