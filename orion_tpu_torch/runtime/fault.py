"""Failure detection, supervisor restarts and fault injection, for the
serving engine and the trainer.

The port's copy of ``orion_tpu/runtime/fault.py``, which is pure Python:

  - ``PreemptionHandler``: SIGTERM only flips a flag, which the serving
    entry point (``orion_tpu_torch.generate``) checks at a step boundary
    to stop admission and drain the live requests, and the trainer at a
    step boundary to save and stop;
  - ``run_with_restarts``: the in-process supervisor loop that rebuilds
    the trainer after a recoverable failure, so it resumes from the newest
    intact checkpoint;
  - ``Watchdog``: a step-progress heartbeat; a wedged dispatch trips the
    callback after ``timeout_s`` without one. The serving engine uses the
    flag-only default, so a stalled step is counted, never fatal; training
    takes ``train.watchdog_action``;
  - ``FaultSpec`` / ``FaultInjector``: the deterministic injection
    schedule consulted at the injection points — dispatch exceptions, NaN
    page poisoning, page-pool exhaustion, stalls and host-tier restore
    faults in the engine, each at
    a configured engine step; on path "train" a dispatch exception before
    the step or a NaN-poisoned loss inside it, and a torn checkpoint
    commit ("partial_write").

``FaultSpec`` validates every kind the JAX package knows. The engine
consumes "dispatch", "nan", "pool", "stall" and "restore"
(``SERVING_KINDS``), the trainer "dispatch", "nan" and "partial_write"
(``TRAIN_KINDS``); an engine or a trainer built with an injector holding
any other kind raises ``NotImplementedError`` (KV migration and the
router are not ported).
"""

from __future__ import annotations

import logging
import os
import signal
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Optional, Sequence, Type

log = logging.getLogger("orion_tpu_torch.fault")

# The kinds the port's serving engine consumes, and the trainer.
SERVING_KINDS = ("dispatch", "nan", "pool", "stall", "restore")
TRAIN_KINDS = ("dispatch", "nan", "partial_write")


class Preempted(RuntimeError):
    """Raised by the trainer after a preemption-triggered final save."""


class InjectedFault(RuntimeError):
    """A FaultInjector-scheduled dispatch exception."""


class DispatchFault(RuntimeError):
    """A serving dispatch failed. Carries the coarse dispatch ``path``
    name ("prefill", "decode", "verify", "mixed", "mixed_verify",
    "compact") so the engine can react per path: repeated verify faults
    switch speculation off."""

    def __init__(self, path: str, detail: str = ""):
        super().__init__(f"{path} dispatch failed{': ' + detail if detail else ''}")
        self.path = path


class PreemptionHandler:
    """Installs SIGTERM preemption flagging.

    Usage: ``with PreemptionHandler() as h: ... if h.preempted: drain``.
    Signal delivery only sets a flag: the real work happens synchronously
    at a step boundary, where the state is consistent.

    Idempotent on re-entry: a nested ``__enter__`` keeps the ORIGINAL
    previous dispositions, and ``__exit__`` restores them exactly once.
    """

    def __init__(self, signals: Sequence[int] = (signal.SIGTERM,)):
        self.signals = tuple(signals)
        self._flag = threading.Event()
        self._prev: dict[int, object] = {}

    @property
    def preempted(self) -> bool:
        return self._flag.is_set()

    def _on_signal(self, signum, frame):
        log.warning("received signal %d: preemption flagged", signum)
        self._flag.set()

    def __enter__(self) -> "PreemptionHandler":
        for s in self.signals:
            if s in self._prev:
                continue  # double-enter: the first entry's prior handler wins
            try:
                self._prev[s] = signal.signal(s, self._on_signal)
            except ValueError:
                # Not the main thread: manual .trigger() only.
                log.debug("cannot install handler for signal %d", s)
        return self

    def trigger(self) -> None:
        """Flag preemption by hand (tests, external schedulers)."""
        self._flag.set()

    def __exit__(self, *exc) -> None:
        for s, prev in self._prev.items():
            signal.signal(s, prev)
        self._prev.clear()


def run_with_restarts(
    make_and_fit: Callable[[int], object],
    *,
    max_restarts: int = 3,
    retry_on: tuple[Type[BaseException], ...] = (Exception,),
    non_retryable: tuple[Type[BaseException], ...] = (ValueError, TypeError),
    backoff_s: float = 0.0,
    on_retry: Optional[Callable[[int, BaseException], None]] = None,
) -> object:
    """Supervisor loop: call ``make_and_fit(attempt)``, restarting on failure.

    ``make_and_fit`` must rebuild its world from scratch (config -> Trainer
    -> restore_or_init -> fit) so every attempt resumes from the newest
    checkpoint. KeyboardInterrupt and Preempted always propagate — those are
    orderly shutdowns, not failures — as do ``non_retryable`` types
    (config/typo errors are deterministic; retrying them wastes compute).

    ``on_retry(attempt, exc)`` fires before each restart with the attempt
    number about to run and the exception that killed the previous one —
    the hook ``python -m orion_tpu_torch.train`` uses to thread the restart
    count and last fault reason into the next attempt's step log.
    """
    attempt = 0
    while True:
        try:
            return make_and_fit(attempt)
        except (KeyboardInterrupt, Preempted):
            raise
        except non_retryable:
            raise
        except retry_on as e:
            attempt += 1
            if attempt > max_restarts:
                log.error("giving up after %d restarts", max_restarts)
                raise
            log.warning(
                "attempt %d failed (%s: %s); restarting (%d/%d)",
                attempt - 1, type(e).__name__, e, attempt, max_restarts,
            )
            if on_retry is not None:
                on_retry(attempt, e)
            if backoff_s:
                time.sleep(backoff_s)


class Watchdog:
    """Detects a stalled step loop (a wedged dispatch, a dead host).

    The step loop calls ``heartbeat()``; once armed, if no heartbeat
    arrives within ``timeout_s``, ``on_stall(elapsed)`` fires (default:
    log loudly). The watchdog ARMS AT THE FIRST HEARTBEAT, so a first
    step that builds kernels never trips it. The monitor is a daemon
    thread and never blocks the loop or process exit. ``timeout_s=None``
    is a disabled no-op watchdog.

    Lifecycle: the context-manager form or explicit ``start()``/``stop()``
    (the serving engine owns one across many ``step()`` calls). Both are
    idempotent, and a stopped watchdog can be started again.
    """

    def __init__(
        self,
        timeout_s: Optional[float],
        on_stall: Optional[Callable[[float], None]] = None,
        poll_s: Optional[float] = None,
        action: str = "log",
    ):
        if action not in ("log", "abort"):
            raise ValueError(f"unknown watchdog action {action!r}")
        self.timeout_s = timeout_s
        if on_stall is not None:
            self.on_stall = on_stall
        elif action == "abort":
            self.on_stall = self._abort_on_stall
        else:
            self.on_stall = self._default_on_stall
        self._poll_s = (
            poll_s if poll_s is not None else min((timeout_s or 40.0) / 4, 10.0)
        )
        self._last: Optional[float] = None   # None until armed
        self._stop = threading.Event()
        self._fired = False
        self._thread: Optional[threading.Thread] = None

    @staticmethod
    def _default_on_stall(elapsed: float) -> None:
        log.error("watchdog: no step completed for %.1fs", elapsed)

    @staticmethod
    def _abort_on_stall(elapsed: float) -> None:
        """Kill the process so a supervisor restarts it (a wedged device
        queue cannot be recovered in-process)."""
        log.error("watchdog: no step completed for %.1fs; aborting", elapsed)
        os.kill(os.getpid(), signal.SIGABRT)

    def heartbeat(self) -> None:
        self._last = time.monotonic()
        self._fired = False

    @property
    def stalled(self) -> bool:
        return self._fired

    @property
    def armed(self) -> bool:
        """True once the first heartbeat has arrived."""
        return self._last is not None

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def _run(self) -> None:
        while not self._stop.wait(self._poll_s):
            if self._last is None:
                continue  # not armed yet
            elapsed = time.monotonic() - self._last
            if elapsed > self.timeout_s and not self._fired:
                self._fired = True
                try:
                    self.on_stall(elapsed)
                except Exception:
                    # A broken observer must not kill the thread it reports through.
                    log.exception("watchdog on_stall callback failed")

    def start(self) -> "Watchdog":
        """Spawn the monitor thread (idempotent; no-op when disabled)."""
        if self.timeout_s is None or self.running:
            return self
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, name="orion-watchdog",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        """Stop and join the monitor thread (idempotent)."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def __enter__(self) -> "Watchdog":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


@dataclass
class FaultSpec:
    """One scheduled fault.

    ``kind`` (the engine consumes the first four, the trainer "dispatch"
    and "nan" on path "train", and "partial_write"):
      - "dispatch": raise InjectedFault instead of running the dispatch,
        BEFORE the call, so pool and page state stay untouched (training:
        before the step, feeding run_with_restarts);
      - "nan": poison the victim request's newest private KV page with NaN
        before the step's dispatch (needs inference.nan_guard for the
        engine to detect and quarantine it); training: the step's loss is
        multiplied by NaN inside the differentiated function, so NaNs flow
        through the real backward into every grad leaf;
      - "pool": the next page allocation of this step raises MemoryError,
        as an exhausted pool would;
      - "stall": sleep ``stall_s`` inside the dispatch path (trips the
        watchdog when stall_s > inference.watchdog_timeout_s);
      - "partial_write": tear the checkpoint commit of step ``step`` (the
        largest array file truncated after its checksum is recorded); the
        trainer's checkpoint manager consumes it;
      - "restore": the next host-tier restore of this step (a prefix-cache
        restore or a long-context page-in) raises inside its copy
        envelope, which unwinds both tiers and fails the step;
      - "migration" and the replica kinds ("replica_kill",
        "replica_stall", "replica_poison"; these need ``replica``): the JAX
        package's KV migration and router faults, validated here and
        refused by the port.

    ``step`` is the engine step to fire at (``InferenceEngine.step_no``;
    training: the 0-based step about to run, or the checkpoint's step);
    ``path`` optionally restricts dispatch/stall faults to one dispatch
    path ("prefill" | "decode" | "verify" | "mixed" | "mixed_verify");
    ``rid`` optionally selects the nan victim (default: the oldest active
    request); ``count`` fires the spec that many times.
    """

    kind: str
    step: int
    path: Optional[str] = None
    rid: Optional[int] = None
    stall_s: float = 0.0
    count: int = 1
    replica: Optional[int] = None

    REPLICA_KINDS = ("replica_kill", "replica_stall", "replica_poison")

    def __post_init__(self):
        if self.kind not in (
            "dispatch", "nan", "pool", "stall", "partial_write", "restore", "migration",
        ) + self.REPLICA_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}")
        if self.count < 1:
            raise ValueError(f"count must be >= 1, got {self.count}")
        if self.kind in self.REPLICA_KINDS and (self.replica is None or self.replica < 0):
            raise ValueError(f"{self.kind} needs replica=<index>, got {self.replica}")


@dataclass
class FaultInjector:
    """Deterministic fault schedule for the serving engine.

    The engine consults ``take(kind, step, path)`` at each injection
    point; a matching spec is consumed (its ``count`` decrements) and
    recorded in ``fired``. The injector never mutates engine state: every
    fault takes the code path a real failure would. ``on_fire(kind, step,
    path)`` is an optional observer called whenever a spec is consumed.
    """

    specs: list = field(default_factory=list)
    fired: list = field(default_factory=list)
    on_fire: Optional[Callable[[str, int, Optional[str]], None]] = None

    def take(self, kind: str, step: int, path: Optional[str] = None) -> Optional[FaultSpec]:
        for s in self.specs:
            if (
                s.kind == kind and s.step == step and s.count > 0
                and (s.path is None or path is None or s.path == path)
            ):
                s.count -= 1
                self.fired.append((kind, step, path))
                if self.on_fire is not None:
                    try:
                        self.on_fire(kind, step, path)
                    except Exception:
                        # A broken observer must not change which faults fire.
                        log.exception("FaultInjector on_fire observer failed")
                return s
        return None
