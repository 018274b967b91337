"""Runtime support shared by serving: fault injection, the watchdog and
preemption flagging (``runtime/fault.py``)."""

from orion_tpu_torch.runtime.fault import (
    DispatchFault,
    FaultInjector,
    FaultSpec,
    InjectedFault,
    Preempted,
    PreemptionHandler,
    Watchdog,
)

__all__ = ["DispatchFault", "FaultInjector", "FaultSpec", "InjectedFault", "Preempted",
           "PreemptionHandler", "Watchdog"]
