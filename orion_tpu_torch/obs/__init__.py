"""Observability: span tracing, flight recording, the metrics registry and
SLO burn-rate monitoring (counterpart of ``orion_tpu/obs/``).

The serving engine and the trainer thread through this package:
``Tracer`` is the host-side ring of spans and events (Chrome trace-event
export with overflow accounting, ``torch.profiler.record_function`` ranges
for alignment with a device profile; ``merge_chrome`` merges several rings
onto one clock), ``FlightRecorder`` the bounded postmortem ring that dumps
on degradation triggers, ``MetricsRegistry`` the named-snapshot surface
over the Stats dataclasses (``metrics.py``) with pool occupancy and
device-memory gauges, exportable as Prometheus textfiles and JSONL time
series, and ``SLOMonitor`` the per-priority-class TTFT/ITL judge (which
waits for the router to drive it).
"""

from orion_tpu_torch.obs.flight import FlightRecorder, init_obs
from orion_tpu_torch.obs.registry import MetricsRegistry, bench_metrics_block, live_hbm_metrics
from orion_tpu_torch.obs.slo import SLOMonitor, SLOObjective, build_objectives
from orion_tpu_torch.obs.trace import (
    NULL_TRACER,
    NullTracer,
    Tracer,
    export_chrome_safe,
    merge_chrome,
    merge_chrome_safe,
    namespaced_path,
)

__all__ = [
    "FlightRecorder",
    "MetricsRegistry",
    "NULL_TRACER",
    "NullTracer",
    "SLOMonitor",
    "SLOObjective",
    "Tracer",
    "bench_metrics_block",
    "build_objectives",
    "export_chrome_safe",
    "init_obs",
    "live_hbm_metrics",
    "merge_chrome",
    "merge_chrome_safe",
    "namespaced_path",
]
