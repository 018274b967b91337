"""SLO monitor: per-priority-class latency objectives and their windowed
burn rate.

Counterpart of ``orion_tpu/obs/slo.py``:

  - an **objective** is "fraction ``goal`` of class-``cls`` requests see
    ``metric`` (ttft | itl) <= ``target_s``" (``config.SLOConfig``: the
    fleet-wide ``slo.ttft_ms``/``slo.itl_ms`` plus per-class overrides in
    ``slo.per_class``);
  - observations accumulate in per-(metric, class) ``LatencyStats`` over a
    rolling window of ``slo.window_s``;
  - at each window close every objective's **burn rate** is
    ``(violating fraction) / (1 - goal)`` (1.0: the error budget burns at
    exactly the allowed rate); a window whose burn exceeds
    ``slo.burn_threshold``, with at least ``slo.min_events`` observations
    (an empty class window says nothing and never breaches), is an
    ``slo_breach``.

The monitor is passive: whoever owns the serving loop (the JAX package's
router) drives ``observe()`` and ``sweep()``, breaches go to the
``on_breach`` callback, and ``metrics()`` is a registry provider (the
``slo`` section). The port has no router yet, so nothing drives it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

from orion_tpu_torch.config import parse_per_class
from orion_tpu_torch.metrics import LatencyStats

METRICS = ("ttft", "itl")


@dataclass(frozen=True)
class SLOObjective:
    """One judged objective; ``cls`` None is the fleet-wide objective (every
    class counts toward it)."""

    metric: str                 # "ttft" | "itl"
    target_s: float             # latency objective, seconds
    cls: Optional[int] = None   # priority class; None = all classes
    goal: float = 0.99          # fraction that must meet target_s

    @property
    def key(self) -> str:
        """Identifier-shaped gauge suffix: ``ttft_all`` / ``itl_c2`` /
        ``ttft_cneg1`` (a negative class spells its sign, so registry keys
        stay Prometheus-safe)."""
        if self.cls is None:
            tag = "all"
        elif self.cls < 0:
            tag = f"cneg{-self.cls}"
        else:
            tag = f"c{self.cls}"
        return f"{self.metric}_{tag}"


def build_objectives(slo_cfg) -> list[SLOObjective]:
    """SLOConfig -> objectives: the fleet-wide ttft_ms/itl_ms, then the
    per-class overrides of ``slo.per_class`` (``config.parse_per_class``)."""
    out: list[SLOObjective] = []
    if slo_cfg.ttft_ms is not None:
        out.append(SLOObjective("ttft", slo_cfg.ttft_ms / 1e3, goal=slo_cfg.goal))
    if slo_cfg.itl_ms is not None:
        out.append(SLOObjective("itl", slo_cfg.itl_ms / 1e3, goal=slo_cfg.goal))
    for cls, targets in parse_per_class(slo_cfg.per_class).items():
        for metric, target_ms in targets.items():
            out.append(SLOObjective(metric, target_ms / 1e3, cls=cls, goal=slo_cfg.goal))
    return out


class SLOMonitor:
    """Windowed burn-rate monitor over a set of objectives.

    ``observe(metric, cls, seconds, now)`` records one event into the
    current window; ``sweep(now)`` closes the window once ``window_s`` has
    passed, judges every objective and returns the breaches (each also
    handed to ``on_breach``)."""

    def __init__(
        self,
        objectives: list[SLOObjective],
        window_s: float = 5.0,
        burn_threshold: float = 1.0,
        min_events: int = 1,
        on_breach: Optional[Callable[[dict], None]] = None,
    ):
        self.objectives = list(objectives)
        self.window_s = window_s
        self.burn_threshold = burn_threshold
        self.min_events = min_events
        self.on_breach = on_breach
        self.breaches = 0           # lifetime breach count
        self.windows = 0            # windows judged
        self._window_start: Optional[float] = None
        # (metric, cls) -> LatencyStats of the current window.
        self._window: dict[tuple[str, int], LatencyStats] = {}
        # objective.key -> burn of the last judged window (an unjudged
        # window keeps the previous value: the gauge never drops to zero
        # on an idle lull).
        self.last_burn: dict[str, float] = {o.key: 0.0 for o in self.objectives}
        self._last_window: dict[str, dict[str, float]] = {}

    @classmethod
    def from_config(cls, slo_cfg, on_breach=None) -> Optional["SLOMonitor"]:
        """Build from a ``config.SLOConfig``; None when no objective is
        configured (callers then skip observe and sweep)."""
        objectives = build_objectives(slo_cfg)
        if not objectives:
            return None
        return cls(objectives, window_s=slo_cfg.window_s,
                   burn_threshold=slo_cfg.burn_threshold,
                   min_events=slo_cfg.min_events, on_breach=on_breach)

    def observe(self, metric: str, cls: int, seconds: float, now: float) -> None:
        """Record one latency event for priority class ``cls`` at monotonic
        time ``now``; the first observation opens the window."""
        if self._window_start is None:
            self._window_start = now
        st = self._window.get((metric, cls))
        if st is None:
            st = self._window[(metric, cls)] = LatencyStats()
        st.record(seconds)

    def sweep(self, now: float, force: bool = False) -> list[dict]:
        """Close and judge the window once ``window_s`` has passed since it
        opened; returns the breach records (possibly none). A window with
        no observation never opens, so an idle fleet is never judged.
        ``force`` judges an open window at once (the shutdown path's last
        sweep; burn is a fraction, so a partial window's math holds)."""
        if self._window_start is None or (
            not force and now - self._window_start < self.window_s
        ):
            return []
        window, self._window = self._window, {}
        start, self._window_start = self._window_start, None
        self.windows += 1
        self._last_window = self._summarize(window)
        breaches: list[dict] = []
        for obj in self.objectives:
            if obj.cls is None:
                stats = [st for (m, _c), st in window.items() if m == obj.metric]
            else:
                st = window.get((obj.metric, obj.cls))
                stats = [st] if st is not None else []
            samples = [s for st in stats for s in st.samples]
            total = len(samples)
            if total < self.min_events:
                continue   # no evidence, no verdict: the gauge keeps its value
            bad = sum(1 for s in samples if s > obj.target_s)
            budget = max(1.0 - obj.goal, 1e-9)
            burn = (bad / total) / budget
            self.last_burn[obj.key] = burn
            if burn > self.burn_threshold:
                self.breaches += 1
                breach = {
                    "objective": obj.key,
                    "metric": obj.metric,
                    "cls": obj.cls,
                    "target_ms": round(obj.target_s * 1e3, 3),
                    "goal": obj.goal,
                    "burn": round(burn, 3),
                    "events": total,
                    "violations": bad,
                    "window_s": round(now - start, 3),
                    "worst_ms": round(max(samples) * 1e3, 3),
                }
                breaches.append(breach)
                if self.on_breach is not None:
                    self.on_breach(breach)
        return breaches

    @staticmethod
    def _summarize(window) -> dict[str, dict[str, float]]:
        """Per-(metric, class) percentiles of a closed window."""
        out: dict[str, dict[str, float]] = {}
        for (metric, cls), st in window.items():
            tag = f"cneg{-cls}" if cls < 0 else f"c{cls}"
            s = st.summary()
            out[f"{metric}_{tag}"] = {
                "count": s["count"],
                "p50_ms": round(s["p50"] * 1e3, 3),
                "p95_ms": round(s["p95"] * 1e3, 3),
                "p99_ms": round(s["p99"] * 1e3, 3),
            }
        return out

    def metrics(self) -> dict:
        """Registry provider (the ``slo`` section): lifetime breach and
        window counts, per-objective burn from the last judged window, and
        the last window's per-class percentiles."""
        out: dict = {"breaches": self.breaches, "windows": self.windows,
                     "objectives": len(self.objectives)}
        for key, burn in self.last_burn.items():
            out[f"burn_{key}"] = round(burn, 4)
        for key, summ in self._last_window.items():
            for k, v in summ.items():
                out[f"{key}_{k}"] = v
        return out
