"""Dispatch executor of the serving engine: the fault envelope around every
device dispatch.

Counterpart of ``orion_tpu/infer/executor.py``'s ``run`` without its
XLA-fallback leg: the port has no fallback path, because a failing kernel
must never give way to its plain version. The envelope runs, in order,
the ``stall`` injection point, the ``dispatch`` injection point (raising
``InjectedFault`` BEFORE the call, so pool and page state stay
untouched) and the call. Any exception becomes ``DispatchFault(path)``,
after ``robust.dispatch_faults`` is counted and, for the verify paths, the
engine's speculation-fault ladder is told. The engine then fails the step,
not the process (``InferenceEngine.step``).

The call handed to ``run`` includes the step's one host fetch, so an
error the device reports at execution surfaces inside the envelope
without a synchronisation of its own. A fault after a launch has begun
may already have written the pool in place (K4, K9 and K10 fuse the KV
write); it is counted and contained all the same, and a sticky device
error fails every later step until ``inference.max_step_faults`` re-raises.

The executor holds a back-reference to its engine rather than copies of
its mutable state: ``reset_timing`` swaps the engine's ``robust`` stats
and the envelope must count into the live ones.
"""

from __future__ import annotations

import logging
import time
from typing import Any, Callable

from orion_tpu_torch.runtime.fault import DispatchFault, InjectedFault

log = logging.getLogger("orion_tpu_torch.infer")

VERIFY_PATHS = ("verify", "mixed_verify", "compact")


class DispatchExecutor:
    """The fault envelope of the engine's dispatches."""

    def __init__(self, engine):
        self.eng = engine

    def run(self, path: str, fn: Callable[..., Any], *args, **kwargs):
        """Run ``fn(*args, **kwargs)``, one device dispatch through its host
        fetch, at the injection points of ``path``; raises DispatchFault
        when it fails."""
        eng = self.eng
        inj = eng._injector
        if inj is not None:
            st = inj.take("stall", eng.step_no, path)
            if st is not None:
                log.warning("injected %.2fs stall in %s dispatch (step %d)",
                            st.stall_s, path, eng.step_no)
                time.sleep(st.stall_s)
        try:
            if inj is not None and inj.take("dispatch", eng.step_no, path) is not None:
                raise InjectedFault(f"injected {path} dispatch fault (step {eng.step_no})")
            return fn(*args, **kwargs)
        except Exception as e:
            raise self._fault(path, e) from e

    def contain(self, path: str, fn: Callable[..., Any], *args, **kwargs):
        """The envelope without injection points (the tree-speculation KV
        compaction, which the JAX engine runs outside the injector too)."""
        try:
            return fn(*args, **kwargs)
        except Exception as e:
            raise self._fault(path, e) from e

    def _fault(self, path: str, e: Exception) -> DispatchFault:
        """Count a failed dispatch (and, on a verify path, tell the
        speculation-fault ladder); the DispatchFault the engine contains."""
        eng = self.eng
        eng.robust.dispatch_faults += 1
        log.error("%s dispatch failed (step %d): %s: %s", path, eng.step_no,
                  type(e).__name__, e)
        if path in VERIFY_PATHS:
            eng._note_spec_fault(e)
        return DispatchFault(path, f"{type(e).__name__}: {e}")
