"""Rank processes for the port's data-parallel tests (not a test file).

``tests/torch_sp_worker.py``'s pattern: ``main`` is the target the tests
start with ``spawn``, once per rank; it imports torch and
``orion_tpu_torch`` only (no jax), and each Trainer joins the ranks through
``runtime.coordinator_address`` with a ``file://`` store. The one job runs
every case of the spawn in turn, each a port ``Trainer`` at the mesh its
overrides name, and saves what rank r computed to ``<out>.<r>``
(``torch.save``). A case (a dict) holds:

- ``id``, ``preset``, ``overrides`` (the mesh's process settings are added
  here), ``params``: the JAX package's parameter tree as numpy arrays (the
  trainer's init) or None (the seeded init);
- ``nan_at`` (optional): (rank, step): that rank's reduced gradient gets
  one NaN element in its first leaf at that step, so only it sees the
  anomaly and the vote must carry it to the others;
- ``specs`` (optional): ``FaultSpec`` fields, by rank, for a
  ``FaultInjector``;
- ``resume`` (optional): fit until the injected fault, then fit a fresh
  Trainer on the same config and record the step it resumed at;
- ``preempt`` (optional): (rank, n): that rank's preemption flag rises
  once its trainer has recorded n steps (the others' never does); the fit
  records the steps it took before ``Preempted`` and resumes as
  ``resume`` does;
- ``restore_only`` (optional): restore the newest checkpoint and record
  the state without a step;
- ``memory`` (optional): record ``memory_report()`` instead of a fit;
- ``first_step`` (optional): record the loss of one ``train_step`` on a
  fresh state instead of a fit.

Each case records the losses, grad norms and anomaly flags of its fit,
the last step's ``eval_loss`` (None without ``train.eval_interval``),
``robust`` (the ``TrainRobustnessStats`` fields), this rank's coordinates,
and the state's blocks (``params``, ``mu``, ``nu`` and ``master`` where
present, CPU tensors), which the tests put back together with
``models.convert.unshard_params``.
"""

from __future__ import annotations

import dataclasses
import sys

import torch

from tests.torch_sp_worker import collect  # noqa: F401  (re-exported for the tests)


def _ov(case, rank, world, store):
    return case["overrides"] + [f"runtime.coordinator_address=file://{store}",
                                 f"runtime.num_processes={world}",
                                 f"runtime.process_id={rank}"]


def _poison(tr, rank, at):
    """Wrap the trainer's reduction so rank ``at[0]`` sees one NaN in its
    first gradient leaf at step ``at[1]`` (counted in reductions)."""
    if at is None or rank != at[0]:
        return
    real, calls = tr.dp.reduce, {"n": 0}

    def reduce(loss, aux, grads, params):
        loss, aux, tree = real(loss, aux, grads, params)
        if calls["n"] == at[1]:
            from orion_tpu_torch.models.convert import tree_leaves

            tree_leaves(tree)[0].view(-1)[0] = float("nan")
        calls["n"] += 1
        return loss, aux, tree

    tr.dp.reduce = reduce


class _Flag:
    """A preemption handler whose flag rises once ``tr`` has recorded
    ``after`` steps (never with None)."""

    def __init__(self, tr, after):
        self.tr, self.after = tr, after

    @property
    def preempted(self) -> bool:
        return self.after is not None and len(self.tr.metrics.history) >= self.after


def _blocks(state):
    opt = state["opt"]
    out = {"params": state["params"], "mu": opt["mu"], "nu": opt["nu"]}
    if "master" in opt:
        out["master"] = opt["master"]
    return {k: _cpu(v) for k, v in out.items()}


def _cpu(tree):
    from orion_tpu_torch.models.convert import tree_map

    return tree_map(lambda t: t.detach().to("cpu", copy=True), tree)


def _trainer(case, rank, world, store):
    from orion_tpu_torch.config import get_config
    from orion_tpu_torch.models import from_jax_params
    from orion_tpu_torch.runtime.fault import FaultInjector, FaultSpec
    from orion_tpu_torch.train import Trainer

    cfg = get_config(case["preset"], _ov(case, rank, world, store))
    params = (None if case.get("params") is None
              else from_jax_params(case["params"], cfg.model))
    specs = case.get("specs", {}).get(rank, [])
    inj = FaultInjector(specs=[FaultSpec(**s) for s in specs]) if specs else None
    tr = Trainer(cfg, params=params, device="cpu", fault_injector=inj)
    _poison(tr, rank, case.get("nan_at"))
    return tr


def run_case(case, rank, world, store):
    from orion_tpu_torch.runtime.fault import Preempted
    from orion_tpu_torch.train.trainer import FaultInjected

    tr = _trainer(case, rank, world, store)
    row = {"coords": dict(tr.dp.coords), "sp_rank": tr.sp_rank}
    if case.get("memory"):
        row["memory"] = tr.memory_report()
        return row
    if case.get("first_step"):
        args = (tr._spike_limit(),) if tr.cfg.train.anomaly_guard else ()
        _, m = tr.train_step(tr.init_state(), tr.global_batch(0), *args)
        row["first_loss"] = m["loss"]
        return row
    if case.get("restore_only"):
        state, step = tr.restore_or_init()
        row.update(step=step, state=_blocks(state), quarantined=list(tr.ckpt.quarantined))
        return row
    kw = {}
    if case.get("preempt"):
        on, after = case["preempt"]
        kw["preemption_handler"] = _Flag(tr, after if rank == on else None)
    try:
        hist = tr.fit(**kw)
    except (FaultInjected, Preempted):
        if not (case.get("resume") or case.get("preempt")):
            raise
        row["faulted"] = True
        row["stopped_after"] = len(tr.metrics.history)
        tr = _trainer(dict(case, nan_at=None), rank, world, store)
        state, row["resumed_at"] = tr.restore_or_init()
        hist = tr.fit(state=state)
        row["quarantined"] = list(tr.ckpt.quarantined)
    row.update(losses=[m.loss for m in hist], grad_norms=[m.grad_norm for m in hist],
               anomaly=[m.extras.get("anomaly") for m in hist],
               eval_loss=hist[-1].extras.get("eval_loss"),
               robust=dataclasses.asdict(tr.robustness), state=_blocks(tr.state))
    return row


def main(rank: int, world: int, store: str, job_path: str, out: str) -> None:
    """One rank: run every case of the job, save, leave the group."""
    torch.set_num_threads(1)
    if "jax" in sys.modules:
        raise RuntimeError("a rank process imported jax")
    job = torch.load(job_path, weights_only=False)
    result = {case["id"]: run_case(case, rank, world, store) for case in job["cases"]}
    result["jax_imported"] = "jax" in sys.modules
    torch.save(result, f"{out}.{rank}")
    import torch.distributed as dist

    dist.barrier()
    dist.destroy_process_group()


def spawn(world: int, cases: list, tmp) -> object:
    """Start ``world`` rank processes on ``cases`` (returns the context;
    ``collect`` waits for it)."""
    import torch.multiprocessing as mp

    job_path = tmp / "job.pt"
    torch.save({"cases": cases}, job_path)
    return mp.start_processes(main, args=(world, str(tmp / "store"), str(job_path),
                                          str(tmp / "out")),
                              nprocs=world, start_method="spawn", join=False)
