"""Host-side span tracer: a bounded ring of spans and instant events.

Counterpart of ``orion_tpu/obs/trace.py``. Design constraints, in order:

  1. **No cost when disabled.** Callers hold ``NULL_TRACER``, whose every
     method is a no-op returning a shared null context manager: no clock
     read, no allocation, no branch beyond the attribute lookup. Device
     work is never touched in either mode: the tracer is host bookkeeping
     around dispatches (and around CUDA-graph captures and replays, never
     inside one).
  2. **Bounded.** The ring is a ``deque(maxlen=capacity)``: a long-running
     engine holds the most recent ``capacity`` events, which is what the
     flight recorder dumps when something degrades; evictions are counted
     in ``dropped``.
  3. **Profiler-aligned.** ``annotation()`` / ``step_annotation()`` (and
     ``span(..., annotate=True)``) open a ``torch.profiler.record_function``
     range of the same name, so host spans land in the same timeline as a
     ``torch.profiler`` capture (``train.profile_steps``); a step
     annotation is named ``f"{name}#{step}"``. On a CUDA device the same
     range is also pushed as an NVTX range.

Export is Chrome trace-event JSON (``export_chrome``), loadable in Perfetto
or ``chrome://tracing`` and read by ``tools/obs_report.py``: ``ts``/``dur``
are microseconds relative to tracer construction. Ring events carry
absolute ``time.monotonic()`` stamps, so ``merge_chrome`` merges several
tracers (a router's and one per replica engine) onto one clock by
re-basing against the earliest tracer's origin; each source becomes its
own Perfetto process.
"""

from __future__ import annotations

import json
import logging
import os
import time
from collections import deque
from typing import Any, Optional

import torch

log = logging.getLogger("orion_tpu_torch.obs")

# Event tuples in the ring: (kind, name, t_start, t_end, tags) with kind
# "span" (t_end >= t_start) or "instant" (t_end == t_start). Times are
# time.monotonic() seconds: a wall-clock step (NTP) must never produce a
# negative span in a postmortem artifact.
Event = tuple[str, str, float, float, dict]


class _NullCtx:
    """Shared reusable no-op context manager (the disabled tracer's span)."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_CTX = _NullCtx()


class NullTracer:
    """The disabled tracer: every call is a no-op. One shared instance
    (``NULL_TRACER``) serves every untraced engine and trainer, so the
    untraced host path is the plain code plus one attribute lookup and a
    no-op ``with`` per dispatch."""

    enabled = False
    dropped = 0
    capacity = 0

    def span(self, name: str, annotate: bool = False, **tags) -> _NullCtx:
        return _NULL_CTX

    def instant(self, name: str, **tags) -> None:
        return None

    def record_span(self, name: str, t_start: float, t_end: float, **tags) -> None:
        return None

    def annotation(self, name: str) -> _NullCtx:
        return _NULL_CTX

    def step_annotation(self, name: str, step: int) -> _NullCtx:
        return _NULL_CTX

    def events(self) -> list[Event]:
        return []

    def export_chrome(self, path: str) -> int:
        return 0

    def clear(self) -> None:
        return None


NULL_TRACER = NullTracer()


class _Annotation:
    """A ``torch.profiler.record_function`` range, and on a CUDA device an
    NVTX range of the same name. Only the ranges' host calls run: nothing
    is enqueued on the device, so an annotation may enclose a graph capture
    but is never opened inside one."""

    __slots__ = ("name", "_nvtx", "_rf")

    def __init__(self, name: str, nvtx: bool):
        self.name = name
        self._nvtx = nvtx
        self._rf = None

    def __enter__(self) -> "_Annotation":
        self._rf = torch.profiler.record_function(self.name)
        self._rf.__enter__()
        if self._nvtx:
            torch.cuda.nvtx.range_push(self.name)
        return self

    def __exit__(self, *exc) -> bool:
        if self._nvtx:
            torch.cuda.nvtx.range_pop()
        self._rf.__exit__(*exc)
        return False


class _Span:
    """One live span: stamps monotonic start and end and appends to the
    owning tracer's ring on exit. Exit always records: a span interrupted
    by an exception is the span a postmortem wants to see."""

    __slots__ = ("_tracer", "name", "tags", "t0", "t1", "_ann")

    def __init__(self, tracer: "Tracer", name: str, annotate: bool, tags: dict):
        self._tracer = tracer
        self.name = name
        self.tags = tags
        self.t0 = 0.0
        self.t1 = 0.0
        self._ann = tracer.annotation(name) if annotate else None

    def __enter__(self) -> "_Span":
        if self._ann is not None:
            self._ann.__enter__()
        self.t0 = time.monotonic()
        return self

    def __exit__(self, *exc) -> bool:
        self.t1 = time.monotonic()
        if self._ann is not None:
            self._ann.__exit__(*exc)
        self._tracer._append(("span", self.name, self.t0, self.t1, self.tags))
        return False

    @property
    def elapsed(self) -> float:
        return self.t1 - self.t0


class Tracer:
    """The enabled tracer: a bounded ring of spans and instants.

    ``device`` is where the traced program's tensor work runs. On a CUDA
    device the annotations also push NVTX ranges: they are what a CUDA-side
    timeline (Nsight Systems) shows beside the kernels, while
    ``record_function`` shows only in a ``torch.profiler`` capture. On the
    CPU there is no device timeline to align with, and a CPU build of
    torch has no NVTX library to call.

    ``deque.append`` is atomic under the GIL and the watchdog and
    checkpoint threads only ever ``instant()``, so the hot path takes no
    lock; ``events()`` snapshots with ``list()``. The ``dropped`` counter's
    check-then-append is not atomic, so concurrent appends at the ring
    boundary can undercount by a few; zero stays exactly zero (no append
    drops before the ring is full).
    """

    enabled = True

    def __init__(self, capacity: int = 16384, device=None):
        if capacity < 1:
            raise ValueError(f"tracer capacity={capacity} must be >= 1")
        self.capacity = capacity
        self._ring: deque[Event] = deque(maxlen=capacity)
        self.t0 = time.monotonic()
        # A deque(maxlen) evicts the oldest event silently: count the
        # evictions, so the registry gauges them and an export is flagged
        # as a truncated timeline.
        self.dropped = 0
        self._nvtx = device is not None and torch.device(device).type == "cuda"

    # -- recording ---------------------------------------------------------

    def _append(self, event: Event) -> None:
        if len(self._ring) == self.capacity:
            self.dropped += 1
        self._ring.append(event)

    def span(self, name: str, annotate: bool = False, **tags) -> _Span:
        """Context manager recording a [enter, exit) span; with
        ``annotate`` also an ``annotation(name)`` over the same window."""
        return _Span(self, name, annotate, tags)

    def instant(self, name: str, **tags) -> None:
        t = time.monotonic()
        self._append(("instant", name, t, t, tags))

    def record_span(self, name: str, t_start: float, t_end: float, **tags) -> None:
        """Append a span measured already (times on the time.monotonic
        clock): for call sites that cannot wrap their body in a ``with``
        (the engine's whole-step span)."""
        self._append(("span", name, t_start, t_end, tags))

    def annotation(self, name: str) -> _Annotation:
        """A profiler range only (records nothing in the ring)."""
        return _Annotation(name, self._nvtx)

    def step_annotation(self, name: str, step: int) -> _Annotation:
        """A profiler range named ``f"{name}#{step}"``: marks a train step
        in a ``torch.profiler`` capture over the same window, so the
        capture's steps line up with the host spans of the same dispatch."""
        return _Annotation(f"{name}#{step}", self._nvtx)

    # -- reading / export --------------------------------------------------

    def events(self) -> list[Event]:
        """Snapshot of the ring, oldest first."""
        return list(self._ring)

    def clear(self) -> None:
        self._ring.clear()
        self.dropped = 0

    def metrics(self) -> dict[str, int]:
        """Ring gauges for the metrics registry ("trace" section): event
        count, capacity and the overflow counter (nonzero: any export from
        this ring is a truncated timeline)."""
        return {"events": len(self._ring), "capacity": self.capacity,
                "dropped": self.dropped}

    def export_chrome(self, path: str) -> int:
        """Write the ring as Chrome trace-event JSON; returns the number of
        events written. Spans are "X" (complete) events, instants "i";
        ``ts``/``dur`` in microseconds relative to tracer construction; tags
        ride ``args``. The top-level ``metadata`` block carries the
        monotonic clock base and the ring's drop count."""
        evs: list[dict[str, Any]] = [
            {"name": "process_name", "ph": "M", "pid": 0, "tid": 0,
             "args": {"name": "orion-tpu host"}},
        ]
        evs.extend(_chrome_events(self.events(), self.t0, pid=0))
        meta = {"clock_base_monotonic_s": self.t0, "dropped_events": self.dropped,
                "ring_capacity": self.capacity}
        _write_chrome(path, evs, meta)
        return len(evs) - 1   # the metadata event excluded


def _chrome_events(events: list[Event], base: float, pid: int) -> list[dict[str, Any]]:
    """Ring events as Chrome trace-event dicts: ``ts``/``dur`` in
    microseconds re-based against ``base`` (a monotonic origin), under
    process ``pid``. Shared by the single-tracer export and the merge, so
    both emit the same event shapes."""
    out: list[dict[str, Any]] = []
    for kind, name, t_start, t_end, tags in events:
        ev: dict[str, Any] = {"name": name, "ts": (t_start - base) * 1e6, "pid": pid,
                              "tid": 0, "args": dict(tags)}
        if kind == "span":
            ev["ph"] = "X"
            ev["dur"] = (t_end - t_start) * 1e6
        else:
            ev["ph"] = "i"
            ev["s"] = "t"
        out.append(ev)
    return out


def _write_chrome(path: str, evs: list, meta: dict) -> None:
    """tmp + atomic rename: a poller (or a crash mid-write) never sees a
    torn document. default=str: a non-primitive tag value degrades to its
    repr instead of failing a shutdown-path export."""
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump({"traceEvents": evs, "displayTimeUnit": "ms", "metadata": meta}, f,
                  default=str)
    os.replace(tmp, path)


def merge_chrome(path: str, sources: list[tuple[str, Any]]) -> int:
    """Merge tracers into one Perfetto timeline: ``sources`` is
    ``[(name, tracer)]``. Each source becomes a process (``pid`` = its
    index, ``process_name``/``thread_name`` metadata = its name); every
    event is re-based onto the earliest tracer's origin (ring stamps are
    absolute ``time.monotonic()`` seconds). A disabled tracer contributes
    an empty process. Returns the events written (metadata rows excluded);
    the ``metadata`` block carries per-process event and drop counts."""
    enabled = [tr for _, tr in sources if tr.enabled]
    base = min((tr.t0 for tr in enabled), default=0.0)
    evs: list[dict[str, Any]] = []
    procs: dict[str, Any] = {}
    total = 0
    for pid, (name, tr) in enumerate(sources):
        evs.append({"name": "process_name", "ph": "M", "pid": pid, "tid": 0,
                    "args": {"name": name}})
        evs.append({"name": "thread_name", "ph": "M", "pid": pid, "tid": 0,
                    "args": {"name": name}})
        rows = _chrome_events(tr.events(), base, pid=pid)
        evs.extend(rows)
        total += len(rows)
        procs[name] = {
            "pid": pid, "events": len(rows), "dropped": tr.dropped,
            "clock_offset_us": (tr.t0 - base) * 1e6 if tr.enabled else None,
        }
    meta = {"merged": True, "clock_base_monotonic_s": base,
            "dropped_events": sum(tr.dropped for _, tr in sources), "processes": procs}
    _write_chrome(path, evs, meta)
    return total


def merge_chrome_safe(path: Optional[str], sources: list[tuple[str, Any]]) -> int:
    """``merge_chrome`` under the shutdown-path contract: a no-op without a
    path or with every source disabled; a write failure is logged, never
    raised. Returns the events written."""
    if not path or not any(tr.enabled for _, tr in sources):
        return 0
    try:
        n = merge_chrome(path, sources)
    except OSError as e:
        log.error("merged trace export to %s failed: %s", path, e)
        return 0
    log.info("merged %d trace events from %d processes to %s (load in Perfetto)",
             n, len(sources), path)
    return n


def namespaced_path(path: str, tag: str) -> str:
    """A per-replica sink path: ``tag`` before the extension
    (``("/tmp/trace.json", "replica-0")`` -> ``/tmp/trace.replica-0.json``),
    so replicas configured with one target never clobber one file."""
    root, ext = os.path.splitext(path)
    return f"{root}.{tag}{ext}" if ext else f"{path}.{tag}"


def export_chrome_safe(tracer, path: Optional[str]) -> int:
    """Chrome export under the shutdown-path contract (``engine.close`` and
    ``Trainer.fit`` end with it): a no-op with tracing off or no path; an
    export failure is logged, never raised (a full disk must not fail a
    clean shutdown). Returns the events written."""
    if not path or not tracer.enabled:
        return 0
    try:
        n = tracer.export_chrome(path)
    except OSError as e:
        log.error("trace export to %s failed: %s", path, e)
        return 0
    log.info("exported %d trace events to %s (load in Perfetto)", n, path)
    return n


def serialize_events(events: list[Event]) -> list[dict[str, Any]]:
    """Ring events as JSON-ready dicts (the flight recorder's dump format;
    times stay monotonic seconds so a reader can window on them)."""
    return [
        {"kind": kind, "name": name, "t_start": t_start, "t_end": t_end,
         "dur_ms": (t_end - t_start) * 1e3, **({"tags": tags} if tags else {})}
        for kind, name, t_start, t_end, tags in events
    ]
