"""Named-snapshot metrics registry with Prometheus and JSONL exporters.

Counterpart of ``orion_tpu/obs/registry.py``. The registry puts the
engine's and the trainer's Stats objects (``metrics.py``) behind one API,
beside gauges they never had (pool occupancy, device memory):

    reg = MetricsRegistry()
    reg.register("prefix", lambda: engine.prefix_stats.as_timing())
    reg.register("pool", engine_pool_provider)
    reg.snapshot()                      # {"prefix.hits": 3, "pool.free_pages": 12, ...}
    reg.export_prometheus("/run/metrics/orion.prom")
    reg.export_jsonl("/var/log/orion_metrics.jsonl")

Providers are zero-argument callables returning flat mappings, read at
snapshot time: registering costs nothing on the hot path, and a provider
reading live engine state always reports the current window
(``reset_timing`` swaps the Stats objects; the registry reads whichever is
live).
"""

from __future__ import annotations

import json
import os
import re
import time
from typing import Any, Callable, Mapping, Optional, Sequence

import torch

Provider = Callable[[], Mapping[str, Any]]

_NAME_RE = re.compile(r"^[A-Za-z_][A-Za-z0-9_]*$")
_PROM_SANITIZE = re.compile(r"[^a-zA-Z0-9_]")

# JSONL stamps are wall-clock (comparable across hosts) but never step
# backwards within a process: the wall clock is read once and advanced on
# the monotonic clock.
_T0_WALL = time.time()
_T0_MONO = time.monotonic()


def _wall_now() -> float:
    """Monotonic-within-process wall-clock seconds."""
    return _T0_WALL + (time.monotonic() - _T0_MONO)


def live_hbm_metrics(device=None) -> dict[str, int]:
    """Device-memory gauges of a CUDA device (default: the current one), or
    {} on the CPU, as the JAX package's reader returns {} where the backend
    has no allocator statistics. The JAX key names, fed by:

      - ``bytes_in_use``: ``torch.cuda.memory_stats`` ``allocated_bytes.all.current``
        (bytes of live tensors in the caching allocator);
      - ``peak_bytes_in_use``: ``allocated_bytes.all.peak`` (since the last
        ``torch.cuda.reset_peak_memory_stats``);
      - ``bytes_limit``: the device's total memory
        (``torch.cuda.get_device_properties(device).total_memory``).

    The JAX reader's ``largest_alloc_size`` is left out: the caching
    allocator keeps no such counter."""
    if device is None:
        if not torch.cuda.is_available():
            return {}
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type != "cuda":
        return {}
    stats = torch.cuda.memory_stats(device)
    return {
        "bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
        "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak", 0)),
        "bytes_limit": int(torch.cuda.get_device_properties(device).total_memory),
    }


class MetricsRegistry:
    """Named sections of lazily-read metric providers."""

    def __init__(self):
        self._providers: dict[str, Provider] = {}

    def register(self, name: str, provider: Provider) -> None:
        """Register (or replace) a section's provider. Section names are
        identifier-shaped; snapshot keys are ``section.key``."""
        if not _NAME_RE.match(name):
            raise ValueError(f"bad metrics section name {name!r}")
        self._providers[name] = provider

    def unregister(self, name: str) -> None:
        self._providers.pop(name, None)

    def sections(self) -> list[str]:
        return sorted(self._providers)

    def snapshot(self, sections: Optional[Sequence[str]] = None) -> dict[str, Any]:
        """One flat, name-spaced read of every (or the named) section. A
        provider that raises contributes a ``<section>.error`` string
        instead of taking the caller down: reads run inside serving loops
        and postmortem dumps."""
        out: dict[str, Any] = {}
        names = self.sections() if sections is None else sections
        for name in names:
            fn = self._providers.get(name)
            if fn is None:
                continue
            try:
                vals = fn() or {}
            except Exception as e:
                out[f"{name}.error"] = f"{type(e).__name__}: {e}"
                continue
            for k, v in vals.items():
                out[f"{name}.{k}"] = v
        return out

    # -- exporters ---------------------------------------------------------

    def export_prometheus(self, path: str, prefix: str = "orion",
                          snapshot: Optional[Mapping[str, Any]] = None) -> int:
        """Write the snapshot as a Prometheus textfile (``<prefix>_<key>
        <value>``, the node_exporter textfile-collector format) by tmp +
        rename, so the collector never reads a torn file. Non-numeric
        values are skipped; returns the samples written."""
        snap = self.snapshot() if snapshot is None else snapshot
        lines = []
        for key in sorted(snap):
            v = snap[key]
            if isinstance(v, bool):
                v = int(v)
            if not isinstance(v, (int, float)):
                continue
            lines.append(f"{prefix}_{_PROM_SANITIZE.sub('_', key)} {float(v):.17g}")
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            f.write("\n".join(lines) + ("\n" if lines else ""))
        os.replace(tmp, path)
        return len(lines)

    def export_jsonl(self, path: str,
                     snapshot: Optional[Mapping[str, Any]] = None) -> dict[str, Any]:
        """Append one time-series row ({"ts": unix seconds, **snapshot}) to
        a JSONL file; returns the row. The serving engine calls it from
        ``reset_timing`` with inference.metrics_jsonl set, one row a drain
        window."""
        row = {"ts": _wall_now()}
        row.update(self.snapshot() if snapshot is None else snapshot)
        with open(path, "a") as f:
            f.write(json.dumps(row, default=str) + "\n")
        return row


def bench_metrics_block(engine, timing: Optional[Mapping[str, Any]] = None) -> dict[str, Any]:
    """The standard ``"metrics"`` block of a bench's JSON line: the engine
    registry's gauge sections (pool occupancy, device memory) plus a
    drained ``reset_timing`` window, name-spaced ``serve.*``. Pass
    ``timing`` when the caller drained the window itself (a second drain
    would report zeros)."""
    block = engine.registry.snapshot(sections=("pool", "hbm"))
    src = timing if timing is not None else engine.reset_timing()
    block.update({f"serve.{k}": v for k, v in src.items()})
    return block
