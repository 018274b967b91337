"""Rank processes for the port's sequence-parallel tests (not a test file).

``main`` is the target the tests start with ``spawn``, once per rank: it
imports torch and ``orion_tpu_torch`` only (no jax), joins the ranks
through a ``file://`` store, runs every case of its job and saves what
rank r computed to ``<out>.<r>`` (``torch.save``). Jobs:

- ``"attention"``: ``sequence_attention`` of each case on this rank's
  shard of the global inputs, its gradients for the output cotangent, and
  the forward's ring exchanges (``comm.CALLS["ppermute"]``); the job's
  ``rejections``, each an exception's text; and, where the job holds
  ``collectives`` inputs, every collective of ``comm`` on this rank's
  rows with the gradient of the summed (output * cotangent) for each, and
  the process-wide agreements of ``runtime.distributed``.
- ``"train"``: the port's ``Trainer`` at ``parallel.sp`` = world from the
  job's weights, through ``Trainer.fit``: the losses, grad norms, and the
  final parameters' bytes.
- ``"asserts"``: for each case, the trainer at ``parallel.sp`` = world
  three times: clean, then with the case's assert site injected
  (``runtime/asserts.py``) and ``model.debug_asserts`` off, then on; the
  losses of each run, or the text of the ``DeviceAssertionError`` it
  raised.
"""

from __future__ import annotations

import hashlib
import sys

import numpy as np
import torch


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _shard(a, rank, world, axis=1):
    n = a.shape[axis] // world
    return a.narrow(axis, rank * n, n).contiguous()


def _mesh(world):
    from orion_tpu_torch.config import ParallelConfig
    from orion_tpu_torch.runtime.mesh import build_mesh

    return build_mesh(ParallelConfig(sp=world))


def attention_job(rank, world, job):
    from orion_tpu_torch.comm import CALLS
    from orion_tpu_torch.parallel import sequence_attention

    mesh = _mesh(world)
    out = {"cases": {}, "rejections": {}}
    for case in job["cases"]:
        q, k, v, do = (_t(job["inputs"][case["inputs"]][n]) for n in ("q", "k", "v", "do"))
        seg = job["inputs"][case["inputs"]].get("seg") if case["segments"] else None
        loc = [_shard(t, rank, world).requires_grad_() for t in (q, k, v)]
        sk = {}
        if seg is not None:
            s = _shard(_t(seg), rank, world)
            sk = dict(q_segment_ids=s, kv_segment_ids=s)
        CALLS.clear()
        o = sequence_attention(*loc, mesh, method=case["method"], causal=case["causal"],
                               logit_softcap=case["softcap"], window=case["window"], **sk)
        exchanges = CALLS["ppermute"]
        grads = torch.autograd.grad(o, loc, _shard(do, rank, world))
        out["cases"][case["id"]] = {"out": o.detach(), "grads": [g.detach() for g in grads],
                                    "ppermute": exchanges}
    for name, kw in job.get("rejections", {}).items():
        q, k, v = (_t(job["inputs"][kw["inputs"]][n]) for n in ("q", "k", "v"))
        try:
            sequence_attention(*(_shard(t, rank, world) for t in (q, k, v)), mesh,
                               **kw["kw"])
            out["rejections"][name] = None
        except ValueError as e:
            out["rejections"][name] = str(e)
    if "collectives" in job:
        out["collectives"] = collectives(rank, world, mesh, job["collectives"])
    return out


def collectives(rank, world, mesh, job):
    from orion_tpu_torch import comm

    group = mesh.get_group("sp")
    x = _shard(_t(job["x"]), rank, world, axis=0)
    wide = _shard(_t(job["wide"]), rank, world, axis=0)
    n = world
    ops = {
        "all_reduce_sum": lambda t, w: comm.all_reduce(t, group, "sum"),
        "all_reduce_mean": lambda t, w: comm.all_reduce(t, group, "mean"),
        "all_reduce_max": lambda t, w: comm.all_reduce(t, group, "max"),
        "all_reduce_min": lambda t, w: comm.all_reduce(t, group, "min"),
        "all_gather": lambda t, w: comm.all_gather(t, group, gather_axis=1),
        "all_gather_stacked": lambda t, w: comm.all_gather(t, group, gather_axis=1,
                                                           tiled=False),
        "reduce_scatter": lambda t, w: comm.reduce_scatter(w, group, scatter_axis=1),
        "all_to_all": lambda t, w: comm.all_to_all(t, group, split_axis=1, concat_axis=0),
        "ppermute": lambda t, w: comm.ppermute(t, group, [(i, (i + 1) % n) for i in range(n)]),
        "ppermute_partial": lambda t, w: comm.ppermute(t, group, [(0, n - 1), (1, 0)]),
        "ring_shift": lambda t, w: comm.ring_shift(t, group, shift=2),
        "broadcast": lambda t, w: comm.broadcast(t, group, root=1),
    }
    from orion_tpu_torch.runtime import distributed as rt

    out = {"size": comm.axis_size(group), "index": comm.axis_index(group),
           "barrier": comm.barrier(group),
           # The process-wide agreements over the default group.
           "steps": rt.agree_on_steps([2, 4, 6, 100 + rank] + ([8] if rank else [])),
           "all_ok": rt.agree_all(True), "one_vetoes": rt.agree_all(rank != 1),
           "info": rt.runtime_info("cpu")}
    rt.barrier("collectives")
    for name, fn in ops.items():
        xl, wl = x.clone().requires_grad_(), wide.clone().requires_grad_()
        y = fn(xl, wl)
        res = {"out": y.detach()}
        if y.requires_grad:
            cot = _shard(_t(job["cot"][name]), rank, world, axis=0)
            gx, gw = torch.autograd.grad((y * cot).sum(), [xl, wl], allow_unused=True)
            res["grad"] = (gx if gx is not None else gw).detach()
        out[name] = res
    return out


def train_job(rank, world, job):
    from orion_tpu_torch.config import get_config
    from orion_tpu_torch.models import from_jax_params
    from orion_tpu_torch.models.convert import tree_leaves_with_path
    from orion_tpu_torch.train import Trainer

    out = {}
    for case in job["cases"]:
        ov = case["overrides"] + [
            f"parallel.sp={world}", f"runtime.coordinator_address=file://{job['store']}",
            f"runtime.num_processes={world}", f"runtime.process_id={rank}"]
        cfg = get_config(case["preset"], ov)
        tr = Trainer(cfg, params=from_jax_params(case["params"], cfg.model), device="cpu")
        hist = tr.fit()
        digest = hashlib.sha256()
        for _, p in tree_leaves_with_path(tr.state["params"]):
            digest.update(p.detach().contiguous().numpy().tobytes())
        out[case["id"]] = {"losses": [m.loss for m in hist],
                           "grad_norms": [m.grad_norm for m in hist],
                           "params_sha256": digest.hexdigest(), "sp_rank": tr.sp_rank}
    return out


def asserts_job(rank, world, job):
    from orion_tpu_torch.config import get_config
    from orion_tpu_torch.runtime import asserts
    from orion_tpu_torch.train import Trainer

    out = {}
    for case in job["cases"]:
        row = {}
        for run, inject, flag in (("clean", False, False), ("off", True, False),
                                  ("on", True, True)):
            ov = case["overrides"] + [
                f"model.debug_asserts={str(flag).lower()}", f"parallel.sp={world}",
                f"runtime.coordinator_address=file://{job['store']}",
                f"runtime.num_processes={world}", f"runtime.process_id={rank}"]
            if inject:
                asserts.inject(case["site"])
            try:
                tr = Trainer(get_config(case["preset"], ov), device="cpu")
                row[run] = [m.loss for m in tr.fit()]
            except asserts.DeviceAssertionError as e:
                row[run] = str(e)
            finally:
                asserts.clear_injected()
        out[case["id"]] = row
    return out


JOBS = {"attention": attention_job, "train": train_job, "asserts": asserts_job}


def main(rank: int, world: int, store: str, kind: str, job_path: str, out: str) -> None:
    """One rank: join the group through ``store``, run the job, save."""
    torch.set_num_threads(1)
    if "jax" in sys.modules:
        raise RuntimeError("a rank process imported jax")
    job = torch.load(job_path, weights_only=False)
    if kind not in ("train", "asserts"):   # the trainer joins the group itself
        from orion_tpu_torch.config import RuntimeConfig
        from orion_tpu_torch.runtime.distributed import initialize

        initialize(RuntimeConfig(coordinator_address=f"file://{store}", num_processes=world,
                                 process_id=rank))
    result = JOBS[kind](rank, world, job)
    result["jax_imported"] = "jax" in sys.modules
    torch.save(result, f"{out}.{rank}")
    import torch.distributed as dist

    dist.barrier()
    dist.destroy_process_group()


def spawn(kind: str, world: int, job: dict, tmp) -> object:
    """Start ``world`` rank processes on ``job`` (returns the context;
    ``collect`` waits for it)."""
    import torch.multiprocessing as mp

    job_path = tmp / "job.pt"
    if kind in ("train", "asserts"):
        job = dict(job, store=str(tmp / "store"))
    torch.save(job, job_path)
    return mp.start_processes(main, args=(world, str(tmp / "store"), kind, str(job_path),
                                          str(tmp / "out")),
                              nprocs=world, start_method="spawn", join=False)


def collect(ctx, world: int, tmp, timeout: float = 240.0) -> list:
    """Wait for the ranks (raising if one failed) and load their results."""
    import time

    end = time.monotonic() + timeout
    while not ctx.join(timeout=1.0):
        if time.monotonic() > end:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"rank processes did not finish in {timeout} s")
    return [torch.load(f"{tmp / 'out'}.{r}", weights_only=False) for r in range(world)]
