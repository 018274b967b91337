"""The device mesh: one process per device, named axes over the process group.

Counterpart of ``orion_tpu/runtime/mesh.py``: ``build_mesh`` gives a
``torch.distributed.device_mesh.DeviceMesh`` with the JAX package's axis
names in its order (``MESH_AXES``, outermost to innermost; rank r sits at
the row-major position r, as device r does in the JAX package's mesh), so
``mesh.get_group("sp")`` is the sequence axis's process group and
``mesh.get_local_rank("sp")`` this process's place on it. ``group_of``
gives the group of several axes at once (the batch axes ``dp`` x
``fsdp``, or every data axis), built with the mesh. The port runs data
parallelism (``dp``), FSDP (``fsdp``) and sequence parallelism (``sp``),
alone or together; ``tp``, ``pp`` and ``ep`` above 1 raise and name their
mode (ROADMAP.md lists them in the order they come).
"""

from __future__ import annotations

import itertools

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from orion_tpu_torch.config import ParallelConfig

MESH_AXES: tuple[str, ...] = ("pp", "dp", "fsdp", "ep", "sp", "tp")

# The axes the port runs, and the mode each other axis stands for, in the
# words of the refusal.
PORTED_AXES = ("dp", "fsdp", "sp")
_MODES = {"pp": "pipeline parallelism", "ep": "expert parallelism",
          "tp": "tensor parallelism"}


def check_axes(parallel: ParallelConfig) -> None:
    """Raise NotImplementedError for tp, pp or ep above 1."""
    sizes = parallel.axis_sizes
    bad = [f"parallel.{a}={sizes[a]} ({_MODES[a]})" for a in MESH_AXES
           if a not in PORTED_AXES and sizes[a] > 1]
    if bad:
        raise NotImplementedError(
            "not ported to orion_tpu_torch yet: " + ", ".join(bad)
            + "; the port runs data parallelism (parallel.dp), FSDP (parallel.fsdp) "
            "and sequence parallelism (parallel.sp)")


def build_mesh(parallel: ParallelConfig, device="cpu") -> DeviceMesh:
    """The named mesh over the default process group (one process a
    device): shape in ``MESH_AXES`` order, device type from ``device``.
    The group must be as wide as the mesh. Every group of two or more
    ported axes above 1 is made here, on every rank in the same order
    (``group_of``)."""
    check_axes(parallel)
    sizes = parallel.axis_sizes
    shape = tuple(sizes[a] for a in MESH_AXES)
    n = parallel.num_devices
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != n:
        raise ValueError(
            f"parallel config wants {n} devices ({dict(sizes)}), but the "
            f"process group has {world} processes (one a device)")
    mesh = init_device_mesh(torch.device(device).type, shape, mesh_dim_names=MESH_AXES)
    live = [a for a in PORTED_AXES if sizes[a] > 1]
    me = dist.get_rank()
    groups = {}
    for k in range(2, len(live) + 1):
        for axes in itertools.combinations(live, k):
            rest = [a for a in MESH_AXES if a not in axes]
            for fixed in itertools.product(*(range(sizes[a]) for a in rest)):
                at = dict(zip(rest, fixed))
                ranks = [_rank_at({**at, **dict(zip(axes, c))}, sizes)
                         for c in itertools.product(*(range(sizes[a]) for a in axes))]
                group = dist.new_group(ranks)
                if me in ranks:
                    groups[axes] = group
    mesh._orion_groups = groups
    return mesh


def _rank_at(coords: dict, sizes) -> int:
    r = 0
    for a in MESH_AXES:
        r = r * sizes[a] + coords.get(a, 0)
    return r


def axis_size(mesh, axis: str) -> int:
    """The mesh's size along ``axis`` (1 without a mesh)."""
    return 1 if mesh is None else mesh.size(MESH_AXES.index(axis))


def coords(mesh) -> dict[str, int]:
    """This process's coordinate on every axis (all 0 without a mesh)."""
    if mesh is None:
        return {a: 0 for a in MESH_AXES}
    return {a: mesh.get_local_rank(a) for a in MESH_AXES}


def sizes(mesh) -> dict[str, int]:
    """The mesh's size on every axis (all 1 without a mesh)."""
    return {a: axis_size(mesh, a) for a in MESH_AXES}


def group_of(mesh, axes):
    """The process group of the named axes (those above 1; their product,
    this process's row of it), or None when none is above 1."""
    live = tuple(a for a in PORTED_AXES if a in axes and axis_size(mesh, a) > 1)
    if not live:
        return None
    if len(live) == 1:
        return mesh.get_group(live[0])
    return mesh._orion_groups[live]
