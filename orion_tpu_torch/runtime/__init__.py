"""Runtime support shared by serving and training: fault injection,
supervisor restarts, the watchdog and preemption flagging
(``runtime/fault.py``)."""

from orion_tpu_torch.runtime.fault import (
    DispatchFault,
    FaultInjector,
    FaultSpec,
    InjectedFault,
    Preempted,
    PreemptionHandler,
    Watchdog,
    run_with_restarts,
)

__all__ = ["DispatchFault", "FaultInjector", "FaultSpec", "InjectedFault", "Preempted",
           "PreemptionHandler", "Watchdog", "run_with_restarts"]
