"""The sanitizer modes of the training step: ``runtime.debug_nans``,
``runtime.deterministic`` and the checks of ``runtime.checkify``.

Counterparts of the JAX package's ``jax_debug_nans``, its deterministic
reductions flag (``orion_tpu/runtime/distributed.py``) and its
``checkify``-wrapped step (``orion_tpu/train/trainer.py``).

- **debug_nans** (process-wide, as ``jax_debug_nans`` is): the first NaN
  of a step raises ``FloatingPointError``. In the forward
  (``nan_forward``) a dispatch mode checks the output of every aten op,
  and every kernel wrapper checks its own outputs (``ops.common.counted``:
  the kernels are plain calls no dispatch mode sees); in the backward
  (``nan_backward``) autograd's anomaly mode checks the output of every
  backward function, the kernels' included. Every check reads a flag
  back from the device: a debug mode.
- **deterministic** (process-wide): ``torch.use_deterministic_algorithms``,
  cuDNN's deterministic mode and a fixed cuBLAS workspace
  (``CUBLAS_WORKSPACE_CONFIG``). cuBLAS reads the variable when CUDA
  starts, so setting the flag in a process whose CUDA has started without
  it raises: as the JAX package's ``XLA_FLAGS``, it must come first.
- **checkify** (the trainer's checked step): ``check_indices`` holds the
  batch's tokens and targets to [0, vocab) on the host before the forward
  (an out-of-range index inside a kernel or ``gather`` on the card is a
  device-side assert, which leaves the CUDA context unusable), and
  ``check_finite`` holds the loss and every gradient to finite values
  before the optimizer writes the state. Both raise ``CheckifyError``, a
  ValueError, as the JAX package's ``JaxRuntimeError`` is.

With every flag off none of this runs: no launch and no read-back.
"""

from __future__ import annotations

import contextlib
import os

import torch
from torch.utils._python_dispatch import TorchDispatchMode

# The cuBLAS workspace setting that makes its GEMMs deterministic.
CUBLAS_WORKSPACE = ":4096:8"
_DETERMINISTIC_WORKSPACES = (":4096:8", ":16:8")
# Ops whose outputs are uninitialized memory: nothing to check.
_UNINITIALIZED = frozenset({"empty", "empty_like", "empty_strided", "new_empty",
                            "new_empty_strided", "resize_", "set_"})

_debug_nans = False


class CheckifyError(ValueError):
    """A check of the ``runtime.checkify`` step failed."""


def set_debug_nans(on: bool) -> None:
    global _debug_nans
    _debug_nans = bool(on)


def debug_nans() -> bool:
    return _debug_nans


def set_deterministic() -> None:
    """Turn deterministic mode on for the process (see the module note)."""
    if os.environ.get("CUBLAS_WORKSPACE_CONFIG") not in _DETERMINISTIC_WORKSPACES:
        if torch.cuda.is_initialized():
            raise RuntimeError(
                "runtime.deterministic: CUDA started before CUBLAS_WORKSPACE_CONFIG "
                f"was set, so cuBLAS would not read it; set it to {CUBLAS_WORKSPACE} "
                "in the environment, or build the Trainer before any CUDA call")
        os.environ["CUBLAS_WORKSPACE_CONFIG"] = CUBLAS_WORKSPACE
    torch.use_deterministic_algorithms(True)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False


def check_nan(out, where: str) -> None:
    """Raise FloatingPointError if a floating tensor of ``out`` (a tensor
    or a tuple/list of them) holds a NaN."""
    for t in out if isinstance(out, (tuple, list)) else (out,):
        if (isinstance(t, torch.Tensor) and t.is_floating_point() and t.numel()
                and bool(torch.isnan(t).any())):
            raise FloatingPointError(f"invalid value (nan) encountered in {where}")


class _NanCheck(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.overloadpacket.__name__ not in _UNINITIALIZED:
            check_nan(out, str(func))
        return out


def nan_forward():
    """The forward's NaN checks under debug_nans, else a no-op context."""
    return _NanCheck() if _debug_nans else contextlib.nullcontext()


@contextlib.contextmanager
def nan_backward():
    """The backward's NaN checks under debug_nans: anomaly mode's NaN
    error becomes FloatingPointError."""
    if not _debug_nans:
        yield
        return
    try:
        with torch.autograd.detect_anomaly(check_nan=True):
            yield
    except RuntimeError as e:
        if "nan" not in str(e):
            raise
        raise FloatingPointError(f"invalid value (nan) encountered in the backward: {e}") from e


def check_indices(batch: dict, vocab_size: int) -> None:
    """checkify: every token of ``inputs`` and ``targets`` in [0, vocab)."""
    for key in ("inputs", "targets"):
        t = batch[key]
        bad = (t < 0) | (t >= vocab_size)
        if bool(bad.any()):
            first = t[bad].reshape(-1)[0].item()
            raise CheckifyError(
                f"index out of bounds: {key} holds {first} outside [0, {vocab_size}) "
                f"({int(bad.sum())} tokens)")


def check_finite(loss: torch.Tensor, grads: list) -> None:
    """checkify: the loss and every gradient finite (one read-back)."""
    flags = torch.stack([torch.isfinite(loss).all()]
                        + [torch.isfinite(g).all() for g in grads]).tolist()
    if not all(flags):
        where = "the loss" if not flags[0] else f"{flags.count(False)} gradient leaves"
        raise CheckifyError(f"nan or inf in {where}: the step was not applied")
