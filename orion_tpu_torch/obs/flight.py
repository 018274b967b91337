"""Flight recorder: a bounded postmortem ring that dumps on degradation.

Counterpart of ``orion_tpu/obs/flight.py``. Every degradation the fault
layers survive (a watchdog stall, consecutive failed steps, a NaN
quarantine, speculation switching itself off, a training anomaly
rollback) writes a postmortem: a JSON dump of the fault-adjacent window of
tracer spans, the recorder's own ring of engine events (dispatch faults,
failed steps, injected faults) and a metrics snapshot, into
``inference.flight_dir`` / ``train.flight_dir`` when the trigger fires.
``tools/obs_report.py`` renders a dump as a terminal timeline.
"""

from __future__ import annotations

import json
import logging
import os
import time
from collections import deque
from typing import Any, Callable, Optional

from orion_tpu_torch.obs.trace import NULL_TRACER, NullTracer, Tracer, serialize_events

log = logging.getLogger("orion_tpu_torch.obs")


class FlightRecorder:
    """Bounded ring of engine events riding a (possibly shared) tracer.

    ``note(kind, **fields)`` appends to the ring (fault paths only, never
    per token). ``dump(reason, **context)`` writes one self-contained JSON
    document:

      - ``reason`` / ``context``: the trigger;
      - ``spans``: the tracer ring's last ``window_s`` seconds;
      - ``events``: the recorder's own ring;
      - ``metrics``: the registry snapshot at dump time, given a
        ``snapshot`` callable.

    A dump is best-effort: a full disk degrades the postmortem, never the
    process it observes (``try_dump``).
    """

    def __init__(
        self,
        tracer: Tracer | NullTracer,
        directory: str,
        capacity: int = 2048,
        window_s: float = 60.0,
        snapshot: Optional[Callable[[], dict]] = None,
        min_interval_s: float = 10.0,
        max_dumps: int = 256,
    ):
        self.tracer = tracer
        self.directory = directory
        self.window_s = window_s
        self._events: deque[dict] = deque(maxlen=capacity)
        self._snapshot = snapshot
        self.dumps: list[str] = []   # paths written, oldest first
        # Throttle: a per-occurrence trigger (a watchdog stall every step of
        # a slow engine, one poisoned step quarantining N requests) must
        # not turn an incident into a stream of writes inside the step
        # loop. Repeats of a reason within min_interval_s are counted, not
        # written; max_dumps caps the recorder's lifetime disk use.
        self.min_interval_s = min_interval_s
        self.max_dumps = max_dumps
        self.throttled = 0
        self._last_dump: dict[str, float] = {}   # reason -> monotonic time

    def note(self, kind: str, **fields) -> None:
        """Record one engine event in the ring, and as a tracer instant so
        it also lands in the Chrome timeline."""
        self._events.append({"t": time.monotonic(), "kind": kind, **fields})
        self.tracer.instant(kind, **fields)

    def dump(self, reason: str, **context) -> Optional[str]:
        """Write the postmortem; returns its path, or None when the
        throttle suppressed it (the same reason within ``min_interval_s``,
        or ``max_dumps`` reached; counted in ``throttled``). File names
        carry the reason and a nanosecond stamp, so repeated triggers never
        clobber each other."""
        now = time.monotonic()
        last = self._last_dump.get(reason)
        if ((last is not None and now - last < self.min_interval_s)
                or len(self.dumps) >= self.max_dumps):
            self.throttled += 1
            return None
        self._last_dump[reason] = now
        os.makedirs(self.directory, exist_ok=True)
        spans = serialize_events([e for e in self.tracer.events() if e[3] >= now - self.window_s])
        doc: dict[str, Any] = {
            "reason": reason,
            "wall_time": time.strftime("%Y-%m-%dT%H:%M:%S%z"),
            "t_dump": now,
            "window_s": self.window_s,
            "context": context,
            "events": list(self._events),
            "spans": spans,
        }
        if self._snapshot is not None:
            try:
                doc["metrics"] = self._snapshot()
            except Exception as e:   # a metrics read must never kill a dump
                doc["metrics"] = {"error": f"{type(e).__name__}: {e}"}
        path = os.path.join(self.directory, f"flight_{reason}_{time.time_ns()}.json")
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            # default=str: a non-primitive value degrades to its repr.
            json.dump(doc, f, default=str)
        os.replace(tmp, path)
        self.dumps.append(path)
        log.error("flight recorder: %s -> %s", reason, path)
        return path

    def try_dump(self, reason: str, **context) -> Optional[str]:
        """``dump`` under the degradation contract: any failure to write the
        document is logged and swallowed, so the observed process never
        dies of its own postmortem. It wraps only the write: the fault that
        triggered the dump has been handled (or re-raised) by its caller."""
        try:
            return self.dump(reason, **context)
        except Exception as e:
            log.error("flight recorder dump failed (%s): %s", reason, e)
            return None


def init_obs(
    *,
    trace: bool,
    trace_ring: int,
    flight_dir: Optional[str],
    trace_path: Optional[str] = None,
    snapshot: Optional[Callable[[], dict]] = None,
    injector: Optional[Any] = None,
    device=None,
):
    """The obs wiring the engine and the trainer share: the tracer (NULL
    only when nothing asks for recording: a ``trace_path`` or ``flight_dir``
    implies recording with the ``trace`` flag off, since an export or a dump
    needs a ring to read), the flight recorder, and a FaultInjector's
    ``on_fire`` observer, so injected faults land in the postmortem ring.
    ``device`` is where the tensor work runs (``Tracer``). Returns
    ``(tracer, flight_or_None)``."""
    obs_on = trace or trace_path is not None or flight_dir is not None
    tracer = Tracer(capacity=trace_ring, device=device) if obs_on else NULL_TRACER
    flight = None
    if flight_dir is not None:
        flight = FlightRecorder(tracer, flight_dir, snapshot=snapshot)
        if injector is not None and injector.on_fire is None:
            injector.on_fire = (
                lambda kind, step, path, fl=flight: fl.note(
                    "injected_fault", fault=kind, step=step, path=path or "")
            )
    return tracer, flight
