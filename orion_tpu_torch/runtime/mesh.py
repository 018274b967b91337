"""The device mesh: one process per device, named axes over the process group.

Counterpart of ``orion_tpu/runtime/mesh.py``: ``build_mesh`` gives a
``torch.distributed.device_mesh.DeviceMesh`` with the JAX package's axis
names in its order (``MESH_AXES``, outermost to innermost), so
``mesh.get_group("sp")`` is the sequence axis's process group and
``mesh.get_local_rank("sp")`` this process's place on it. The port runs
sequence parallelism alone so far: a mesh whose axes other than ``sp``
are 1. Any other axis above 1 raises and names its mode (ROADMAP.md
lists them in the order they come).
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from orion_tpu_torch.config import ParallelConfig

MESH_AXES: tuple[str, ...] = ("pp", "dp", "fsdp", "ep", "sp", "tp")

# The mode each axis stands for, in the words of the refusal.
_MODES = {"pp": "pipeline parallelism", "dp": "data parallelism (DDP)",
          "fsdp": "FSDP / ZeRO-3", "ep": "expert parallelism", "tp": "tensor parallelism"}


def check_axes(parallel: ParallelConfig) -> None:
    """Raise NotImplementedError for any axis other than sp above 1."""
    sizes = parallel.axis_sizes
    bad = [f"parallel.{a}={sizes[a]} ({_MODES[a]})" for a in MESH_AXES
           if a != "sp" and sizes[a] > 1]
    if bad:
        raise NotImplementedError(
            "not ported to orion_tpu_torch yet: " + ", ".join(bad)
            + "; the port runs sequence parallelism (parallel.sp) alone")


def build_mesh(parallel: ParallelConfig, device="cpu") -> DeviceMesh:
    """The named mesh over the default process group (one process a
    device): shape in ``MESH_AXES`` order, device type from ``device``.
    The group must be as wide as the mesh."""
    check_axes(parallel)
    sizes = parallel.axis_sizes
    shape = tuple(sizes[a] for a in MESH_AXES)
    n = parallel.num_devices
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != n:
        raise ValueError(
            f"parallel config wants {n} devices ({dict(sizes)}), but the "
            f"process group has {world} processes (one a device)")
    return init_device_mesh(torch.device(device).type, shape, mesh_dim_names=MESH_AXES)


def axis_size(mesh, axis: str) -> int:
    """The mesh's size along ``axis`` (1 without a mesh)."""
    return 1 if mesh is None else mesh.size(MESH_AXES.index(axis))
