"""Multi-process bring-up: the process group every collective rides.

Counterpart of ``orion_tpu/runtime/distributed.py``. ``initialize`` is
``torch.distributed.init_process_group``: from ``env://`` as ``torchrun``
sets it (``WORLD_SIZE``, ``RANK``, ``MASTER_ADDR``, ``MASTER_PORT``), or
from ``runtime.coordinator_address`` / ``num_processes`` / ``process_id``
(an address with a scheme, ``tcp://host:port`` or ``file:///path``, is
used as it is; a bare ``host:port`` is taken as TCP). The backend follows
the device, never a retry: NCCL for a CUDA device, gloo for the CPU.
One process with no address and no ``torchrun`` environment needs no
group, and every helper below is then a pass-through, as in the JAX
package.

``initialize`` also applies the process-wide sanitizer flags
``runtime.deterministic`` and ``runtime.debug_nans`` (``apply_flags``,
``runtime/sanitize.py``), as the JAX package's does.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Optional

import torch
import torch.distributed as dist

from orion_tpu_torch.config import RuntimeConfig
from orion_tpu_torch.runtime import sanitize

log = logging.getLogger("orion_tpu_torch.runtime")


@dataclasses.dataclass(frozen=True)
class RuntimeInfo:
    process_id: int
    num_processes: int
    local_devices: int
    global_devices: int
    platform: str
    device_kind: str


def backend_for(device) -> str:
    """``nccl`` for a CUDA device, ``gloo`` for the CPU."""
    kind = torch.device(device).type
    if kind == "cuda":
        return "nccl"
    if kind == "cpu":
        return "gloo"
    raise ValueError(f"no process-group backend for device type {kind!r}")


def _init_method(address: str) -> str:
    return address if "://" in address else f"tcp://{address}"


def apply_flags(cfg: RuntimeConfig) -> None:
    """Turn on the process-wide modes ``cfg`` asks for: deterministic
    algorithms (before CUDA starts, or it raises) and NaN checks. Both stay
    on for the process, as the JAX package's config flags do."""
    if cfg.deterministic:
        sanitize.set_deterministic()
    if cfg.debug_nans:
        sanitize.set_debug_nans(True)


def initialize(cfg: Optional[RuntimeConfig] = None, device="cpu") -> RuntimeInfo:
    """Apply the sanitizer flags, then join (or create) the default process
    group; idempotent. With ``runtime.coordinator_address`` the group is
    ``num_processes`` wide and this process is ``process_id``; else a
    ``torchrun`` environment (``WORLD_SIZE`` set) is read through
    ``env://``; else nothing is done."""
    cfg = cfg or RuntimeConfig()
    apply_flags(cfg)
    if not dist.is_initialized():
        backend = backend_for(device)
        if cfg.coordinator_address:
            dist.init_process_group(
                backend, init_method=_init_method(cfg.coordinator_address),
                world_size=cfg.num_processes, rank=cfg.process_id)
        elif "WORLD_SIZE" in os.environ:
            dist.init_process_group(backend, init_method="env://")
        if dist.is_initialized():
            log.info("torch.distributed initialized (%s): process %d/%d", backend,
                     dist.get_rank(), dist.get_world_size())
    return runtime_info(device)


def join(cfg: RuntimeConfig, device) -> torch.device:
    """A rank's start: ``initialize`` unless a group already exists, then
    the device this process works on. A CUDA device with no index becomes
    the process's own card (``LOCAL_RANK`` under ``torchrun``, else its rank
    modulo the cards) and is made current."""
    device = torch.device(device)
    if not dist.is_initialized():
        initialize(cfg, device)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", int(os.environ.get(
                "LOCAL_RANK", process_index() % torch.cuda.device_count())))
        torch.cuda.set_device(device)
    return device


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


# Fixed width of the step-set gather: every process contributes the same
# shape (as the JAX package pads its allgather).
_AGREE_PAD = 128


def _group_device():
    """The device a collective's tensors live on: the current CUDA device
    under NCCL, the CPU under gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def agree_on_steps(local_steps) -> list:
    """The checkpoint steps every process can see, sorted ascending (the
    intersection across processes); one process: sorted pass-through."""
    local = sorted(set(int(s) for s in local_steps))
    if process_count() == 1:
        return local
    local = local[-_AGREE_PAD:]  # newest window; older ones are collected anyway
    padded = torch.full((_AGREE_PAD,), -1, dtype=torch.int64, device=_group_device())
    padded[: len(local)] = torch.tensor(local, dtype=torch.int64)
    rows = [torch.empty_like(padded) for _ in range(process_count())]
    dist.all_gather(rows, padded)
    sets = [set(int(v) for v in row.tolist() if v >= 0) for row in rows]
    return sorted(set.intersection(*sets))


def agree_all(ok: bool, tag: str = "agree_all") -> bool:
    """True iff every process reports ``ok``; one process: identity."""
    if process_count() == 1:
        return bool(ok)
    vote = torch.tensor([1 if ok else 0], dtype=torch.int32, device=_group_device())
    dist.all_reduce(vote, op=dist.ReduceOp.MIN)
    return bool(int(vote) == 1)


def barrier(tag: str) -> None:
    """Every process waits here for the others; one process: no-op."""
    if process_count() > 1:
        dist.barrier()


def runtime_info(device="cpu") -> RuntimeInfo:
    device = torch.device(device)
    if device.type == "cuda":
        local, kind = torch.cuda.device_count(), torch.cuda.get_device_name(device)
    else:
        local, kind = 1, "cpu"
    n = process_count()
    return RuntimeInfo(process_id=process_index(), num_processes=n, local_devices=local,
                       global_devices=n, platform=device.type, device_kind=kind)
