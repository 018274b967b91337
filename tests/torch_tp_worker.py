"""Rank processes for the port's tensor-parallel serving tests (not a test
file).

``tests/torch_dp_worker.py``'s pattern: ``main`` is the target the tests
start with ``spawn``, once per rank; it imports torch and
``orion_tpu_torch`` only (no jax), and the engines join the ranks through
``runtime.coordinator_address`` with a ``file://`` store. The one job runs
every case of the spawn in turn, each a port ``InferenceEngine`` at the
mesh its overrides name, built from this rank's blocks
(``models.convert.serving_blocks``) of the JAX package's parameter tree,
and saves what rank r recorded to ``<out>.<r>`` (``torch.save``). A case
(a dict) holds:

- ``id``, ``preset``, ``overrides`` (the process settings are added here),
  ``params``: the JAX package's parameter tree as numpy arrays;
- ``waves``: lists of prompts, each wave submitted together and drained;
  ``n_new``: new tokens a request;
- ``deadlines`` (optional): ``deadline_s`` per prompt of every wave;
- ``slow`` (optional): (rank, seconds): that rank sleeps this long before
  every step (the others never do);
- ``specs`` (optional): ``FaultSpec`` fields, by rank, for a
  ``FaultInjector`` of that rank's engine;
- ``offload`` (optional): demote the prefix cache to the host tier
  (``offload_prefix_cache``) after every wave;
- ``keep`` (optional): record the rank's pool and parameter blocks.

Each case records the waves' streams and typed outcomes, the engine's
counters (prefix cache, speculation, robustness), its decode window, its
``plan_broadcasts``, the collectives' calls and staged bytes, this rank's
mesh coordinates and its local head counts, and with ``keep`` the cache
and the blocks (CPU tensors).
"""

from __future__ import annotations

import dataclasses
import sys
import time

import torch

from tests.torch_sp_worker import collect  # noqa: F401  (re-exported for the tests)


def _ov(case, rank, world, store):
    return case["overrides"] + [f"runtime.coordinator_address=file://{store}",
                                 f"runtime.num_processes={world}",
                                 f"runtime.process_id={rank}"]


def engine(case, rank, world, store):
    """This rank's engine for ``case`` and its mesh coordinates."""
    from orion_tpu_torch.config import get_config
    from orion_tpu_torch.infer import InferenceEngine
    from orion_tpu_torch.models import from_jax_params
    from orion_tpu_torch.models.convert import serving_blocks
    from orion_tpu_torch.runtime.fault import FaultInjector, FaultSpec
    from orion_tpu_torch.runtime.mesh import rank_coords

    cfg = get_config(case["preset"], _ov(case, rank, world, store))
    sizes = cfg.parallel.axis_sizes
    coords = rank_coords(rank, sizes)
    whole = from_jax_params(case["params"], cfg.model)
    blocks = serving_blocks(whole, cfg.model, sizes, coords)
    specs = case.get("specs", {}).get(rank, [])
    inj = FaultInjector(specs=[FaultSpec(**s) for s in specs]) if specs else None
    eng = InferenceEngine(cfg, blocks, device="cpu", cuda_graphs=False, fault_injector=inj)
    return eng, coords


def run_case(case, rank, world, store):
    from orion_tpu_torch import comm

    eng, coords = engine(case, rank, world, store)
    comm.CALLS.clear()
    comm.STAGED.clear()
    slow = case.get("slow")
    if slow is not None and slow[0] == rank:
        step = eng.step

        def late_step():
            time.sleep(slow[1])
            return step()

        eng.step = late_step
    streams, outcomes = [], []
    for prompts in case["waves"]:
        dls = case.get("deadlines") or [None] * len(prompts)
        reqs = [eng.submit_request(p, case["n_new"], deadline_s=d)
                for p, d in zip(prompts, dls)]
        while eng.has_work():
            eng.step()
        streams.append([r.generated for r in reqs])
        outcomes.append([r.outcome for r in reqs])
        if case.get("offload"):
            eng.offload_prefix_cache()
    eng.assert_page_accounting()
    row = {"coords": coords, "streams": streams, "outcomes": outcomes,
           "local_heads": eng.local_heads, "decode_window": eng.decode_window,
           "plan_broadcasts": eng.plan_broadcasts, "calls": dict(comm.CALLS),
           "staged": dict(comm.STAGED), "robust": dataclasses.asdict(eng.robust),
           "prefix": dataclasses.asdict(eng.prefix_stats),
           "spec": dataclasses.asdict(eng.spec_stats),
           "cache_shapes": {k: tuple(v.shape) for k, v in eng.cache.items()}}
    if case.get("keep"):
        from orion_tpu_torch.models.convert import tree_map

        row["cache"] = {k: v.clone() for k, v in eng.cache.items()}
        row["blocks"] = tree_map(lambda t: t.clone(), eng.params)
    eng.close()
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
