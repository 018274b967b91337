"""Dispatch executor of the serving engine: the fault envelope around every
device dispatch, and the dispatch programs.

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

``launch`` is the counterpart of the JAX executor's ``jit_program``: one
program per dispatch path and static shape. On the card it captures the
step into a ``torch.cuda.CUDAGraph`` the first time it sees a key
(``program_key``: the path, every input's shape and dtype, and the static
arguments: window, sampling scalars or per-slot tensors, the guard, a
constraint mask or none, chain or tree, the mixed step's buckets) and
replays it afterwards, so a decode window of W steps over every layer is
one graph launch instead of thousands of kernel launches issued from
Python. A program owns its static device inputs, filled each step from
pinned host staging by ``non_blocking`` copies, and the outputs its
capture allocated; every program of an engine shares one graph memory
pool. Before its capture the step runs once, eagerly, on a side stream:
that builds the CUDA libraries, compiles Triton's kernel and settles
cuBLAS, and every pool write it makes the replay makes again with the
same values (the engine's generator is rewound in between, so a sampled
replay draws what the eager step would have). The replay itself, not the
warm-up, produces the step's result. A capture or replay that fails
raises inside ``run``'s envelope as a ``DispatchFault``; the card never
falls back to the eager step. On the CPU, and on the card when the engine
is built with ``cuda_graphs=False``, ``launch`` runs the step eagerly.

The executor holds a back-reference to its engine rather than copies of
its mutable state: ``reset_timing`` swaps the engine's ``robust`` stats
and the envelope must count into the live ones.
"""

from __future__ import annotations

import gc
import logging
import time
from dataclasses import dataclass
from typing import Any, Callable, Optional

import numpy as np
import torch

from orion_tpu_torch.ops.common import credit_launches, recording_launches
from orion_tpu_torch.runtime.fault import DispatchFault, InjectedFault

log = logging.getLogger("orion_tpu_torch.infer")

VERIFY_PATHS = ("verify", "mixed_verify", "compact")


def program_key(path: str, tensors: dict, static: dict) -> tuple:
    """The key of a dispatch program: ``path``, each input's name, shape
    and dtype (an absent input is None), and the static arguments by
    name. Equal keys replay one graph; any difference captures another."""
    return (path,
            tuple((k, None if a is None else (a.shape, a.dtype.str))
                  for k, a in sorted(tensors.items())),
            tuple(sorted(static.items())))


@dataclass
class Program:
    """One captured dispatch: the graph, its static inputs (device) and
    their pinned staging (host), the outputs the capture allocated, and
    the launches each kernel wrapper recorded."""

    graph: Any
    inputs: dict
    staging: dict
    outputs: Any
    launches: dict
    staged: Any = None        # event: the last staging copies are done


class DispatchExecutor:
    """The fault envelope and the dispatch programs of the engine."""

    def __init__(self, engine, graphs: bool):
        self.eng = engine
        self.graphs = graphs        # CUDA graphs (the card), else eager
        self._programs: dict[tuple, Program] = {}
        self._pool = None           # one graph memory pool for every program
        self._bound = None          # (params, cache pointers) the graphs hold
        self.captures = 0
        self.replays = 0
        self.capture_s = 0.0
        self.pool_bytes = 0         # device memory reserved by the captures

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

    # -- dispatch programs -------------------------------------------------

    def launch(self, path: str, fn: Callable[..., Any], tensors: dict[str, Optional[np.ndarray]],
               static: dict):
        """``fn(**tensors, **static)`` on the engine's device, with each host
        array of ``tensors`` as a device tensor (None stays None): on the
        card the replay of the key's graph (captured on first sight), else
        the eager call. Returns ``fn``'s outputs, which a replay overwrites:
        fetch them before the next launch. Called inside ``run``."""
        if not self.graphs:
            dev = self.eng.device
            return fn(**{k: None if a is None else torch.from_numpy(a).to(dev)
                         for k, a in tensors.items()}, **static)
        self._check_bound()
        key = program_key(path, tensors, static)
        prog = self._programs.get(key)
        if prog is None:
            prog = self._capture(fn, tensors, static)
            self._programs[key] = prog
        else:
            self._stage(prog, tensors)
        prog.graph.replay()
        self.replays += 1
        credit_launches(prog.launches)
        return prog.outputs

    def drop_programs(self) -> None:
        """Forget every graph (and the pool they share): the call for any
        code that rebinds the engine's params or cache, whose addresses the
        graphs hold."""
        self._programs.clear()
        self._pool = None
        self._bound = None

    def _check_bound(self) -> None:
        eng = self.eng
        bound = (eng.params, tuple(t.data_ptr() for t in eng.cache.values()))
        if self._bound is None:
            self._bound = bound
        assert bound[0] is self._bound[0] and bound[1] == self._bound[1], (
            "the engine's params or KV pool were rebound under captured graphs, "
            "which hold the old addresses: call drop_programs() after rebinding")

    @staticmethod
    def _stage(prog: Program, tensors: dict) -> None:
        """Fill the program's static inputs from the host arrays: through
        its pinned staging, by non_blocking copies on the current stream
        (the replay follows them there). The host waits for the previous
        step's copies before it overwrites their staging."""
        if prog.staged is not None:
            prog.staged.synchronize()
        for k, a in tensors.items():
            if a is None:
                continue
            prog.staging[k].numpy()[...] = a
            prog.inputs[k].copy_(prog.staging[k], non_blocking=True)
        if prog.staged is None:
            prog.staged = torch.cuda.Event()
        prog.staged.record()

    def _end_failed_capture(self, graph) -> None:
        """End a capture the step broke. Where CUDA refuses to end it, the
        allocator stays bound to the pool, so later captures take a new
        one. Its own error adds nothing to the step's, which the caller
        re-raises."""
        try:
            graph.capture_end()
        except RuntimeError as e:
            log.debug("ending a failed capture: %s", e)
            self._pool = None

    def _capture(self, fn, tensors: dict, static: dict) -> Program:
        """Warm up, capture and return the program of a new key (its static
        inputs staged with this step's arrays)."""
        t0 = time.perf_counter()
        eng = self.eng
        dev = eng.device
        inputs, staging = {}, {}
        for k, a in tensors.items():
            if a is None:
                continue
            staging[k] = torch.from_numpy(np.empty_like(a)).pin_memory()
            inputs[k] = torch.empty(a.shape, dtype=staging[k].dtype, device=dev)
        args = {k: inputs.get(k) for k in tensors}
        prog = Program(graph=torch.cuda.CUDAGraph(), inputs=inputs, staging=staging,
                       outputs=None, launches={})
        self._stage(prog, tensors)
        gen = eng._gen
        rng = gen.get_state()
        side = torch.cuda.Stream(device=dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            fn(**args, **static)          # the warm-up (its launches ran: counted)
        torch.cuda.current_stream(dev).wait_stream(side)
        torch.cuda.synchronize(dev)
        gen.set_state(rng)                # the replay draws what the warm-up drew
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        graph = prog.graph
        graph.register_generator_state(gen)
        reserved = torch.cuda.memory_reserved(dev)
        # No garbage collection during the capture: collecting a dead
        # engine's graph there destroys it, a CUDA call the capture refuses.
        collecting = gc.isenabled()
        gc.disable()
        try:
            with recording_launches() as rec, torch.cuda.stream(side):
                graph.capture_begin(pool=self._pool)
                try:
                    prog.outputs = fn(**args, **static)
                except BaseException:
                    self._end_failed_capture(graph)
                    raise
                try:
                    graph.capture_end()
                except RuntimeError:
                    self._pool = None   # see _end_failed_capture
                    raise
        finally:
            if collecting:
                gc.enable()
        prog.launches = rec
        self.pool_bytes += torch.cuda.memory_reserved(dev) - reserved
        self.captures += 1
        self.capture_s += time.perf_counter() - t0
        return prog


