"""Debug assertions on routing and position indices (``model.debug_asserts``).

Counterpart of ``orion_tpu/runtime/asserts.py``. The JAX package lowers a
``device_assert`` to a host callback inside the compiled step and raises
at the step's host sync point. Here the predicate is a tensor on the step's
device and the assert reads it back where it stands: with the flag on,
every assert site syncs, and a failing predicate raises
``DeviceAssertionError`` host-side before the bad index reaches
``one_hot`` / ``gather`` / ``index_add``. On the card that order matters:
an out-of-range index inside a kernel is a device-side assert, which
leaves the CUDA context unusable for the rest of the process. It is a
debug mode; the syncs cost what they cost.

With the flag off an assert site is a Python no-op: nothing is launched
and nothing is read back.

Sites: ``moe_route_idx`` and ``moe_route_pos`` (``models/moe.py``, both
dispatches), ``ring_positions`` and ``ring_striped_positions``
(``parallel/sequence.py``). ``inject(site)`` force-fails a named site (a
test hook, as in the JAX package; here it takes effect at once, there is
no trace cache). ``raise_if_failed`` drains the failures recorded since
its last call; the trainer calls it after each step, as the JAX trainer
does. The ring sites vote across the sequence-parallel group, so every
process raises at the same step.
"""

from __future__ import annotations

import logging
import threading

import torch
import torch.distributed

log = logging.getLogger("orion_tpu_torch.asserts")

_INJECTED: set[str] = set()
_failures: list[str] = []
_failures_lock = threading.Lock()


class DeviceAssertionError(AssertionError):
    """Raised host-side when a ``device_assert`` predicate fails."""


def inject(site: str) -> None:
    """Force the named assert site to fail (test hook)."""
    _INJECTED.add(site)


def clear_injected() -> None:
    _INJECTED.clear()


def device_assert(enabled: bool, pred, site: str, msg: str, group=None) -> None:
    """Assert ``pred`` (a boolean tensor, reduced with ``all``, or a Python
    bool) when ``enabled``; raise ``DeviceAssertionError`` naming ``site``
    if it fails. ``enabled`` is the config flag: when False nothing runs.
    With ``group`` (a process group whose every process reaches the same
    site in the same order) the processes vote, so a failure on one raises
    on all and none is left waiting in a collective."""
    if not enabled:
        return
    ok = site not in _INJECTED
    if ok:
        ok = bool(pred.all()) if isinstance(pred, torch.Tensor) else bool(pred)
    if group is not None:
        device = pred.device if isinstance(pred, torch.Tensor) else torch.device("cpu")
        vote = torch.tensor([int(ok)], dtype=torch.int32, device=device)
        torch.distributed.all_reduce(vote, op=torch.distributed.ReduceOp.MIN, group=group)
        ok = bool(vote.item())
    if ok:
        return
    rec = f"device_assert[{site}]: {msg}"
    log.error(rec)
    with _failures_lock:
        _failures.append(rec)
    raise_if_failed()


def raise_if_failed() -> None:
    """Raise ``DeviceAssertionError`` if any assert failed since the last
    call, draining the record either way."""
    with _failures_lock:
        if not _failures:
            return
        recs = list(_failures)
        _failures.clear()
    raise DeviceAssertionError("; ".join(recs))
