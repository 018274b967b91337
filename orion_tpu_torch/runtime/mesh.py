"""The device mesh: one process per device, named axes over the process group.

Counterpart of ``orion_tpu/runtime/mesh.py``: ``build_mesh`` gives a
``torch.distributed.device_mesh.DeviceMesh`` with the JAX package's axis
names in its order (``MESH_AXES``, outermost to innermost; rank r sits at
the row-major position r, as device r does in the JAX package's mesh), so
``mesh.get_group("sp")`` is the sequence axis's process group and
``mesh.get_local_rank("sp")`` this process's place on it. ``group_of``
gives the group of several axes at once (the batch axes ``dp`` x
``fsdp``, or every data axis), built with the mesh. The trainer runs
data parallelism (``dp``), FSDP (``fsdp``) and sequence parallelism
(``sp``), alone or together; the serving engine runs tensor parallelism
(``tp``), with ``dp`` replicas beside it. Every other axis above 1 raises
and names its mode (``check_axes``; ROADMAP.md lists them in the order
they come).

``parallel.dcn_axes`` is checked as the JAX package checks it (an unknown
axis name raises its ValueError) and is otherwise inert: the JAX package
lays those axes across slices of a multi-slice TPU mesh, while the port
runs one process per device and leaves the placement of processes on
hosts to whoever starts them.
"""

from __future__ import annotations

import itertools

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from orion_tpu_torch.config import ParallelConfig

MESH_AXES: tuple[str, ...] = ("pp", "dp", "fsdp", "ep", "sp", "tp")

# The axes the trainer runs, the axes the serving engine runs, and the mode
# each axis stands for, in the words of the refusal.
PORTED_AXES = ("dp", "fsdp", "sp")
SERVING_AXES = ("dp", "tp")
_MODES = {"pp": "pipeline parallelism", "dp": "data parallelism", "fsdp": "FSDP",
          "ep": "expert parallelism", "sp": "sequence parallelism",
          "tp": "tensor parallelism"}


def check_axes(parallel: ParallelConfig, ported=PORTED_AXES) -> None:
    """Raise NotImplementedError for every axis above 1 outside ``ported``
    (the trainer's axes by default), naming its mode."""
    sizes = parallel.axis_sizes
    bad = [f"parallel.{a}={sizes[a]} ({_MODES[a]})" for a in MESH_AXES
           if a not in ported and sizes[a] > 1]
    if bad:
        runs = ", ".join(f"{_MODES[a]} (parallel.{a})" for a in ported)
        raise NotImplementedError(
            "not ported to orion_tpu_torch yet: " + ", ".join(bad)
            + f"; here the port runs {runs}")


def check_dcn_axes(parallel: ParallelConfig) -> None:
    """The JAX package's ValueError for a ``parallel.dcn_axes`` name outside
    ``MESH_AXES`` (``orion_tpu/runtime/mesh.py`` ``hybrid_shapes``)."""
    bad = set(parallel.dcn_axes) - set(MESH_AXES)
    if bad:
        raise ValueError(
            f"parallel.dcn_axes names unknown mesh axes {sorted(bad)}; "
            f"valid: {MESH_AXES}"
        )


def build_mesh(parallel: ParallelConfig, device="cpu", ported=PORTED_AXES) -> DeviceMesh:
    """The named mesh over the default process group (one process a
    device): shape in ``MESH_AXES`` order, device type from ``device``.
    The group must be as wide as the mesh. Every group of two or more
    ``ported`` axes above 1 is made here, on every rank in the same order
    (``group_of``)."""
    check_dcn_axes(parallel)
    check_axes(parallel, ported)
    sizes = parallel.axis_sizes
    shape = tuple(sizes[a] for a in MESH_AXES)
    n = parallel.num_devices
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != n:
        raise ValueError(
            f"parallel config wants {n} devices ({dict(sizes)}), but the "
            f"process group has {world} processes (one a device)")
    mesh = init_device_mesh(torch.device(device).type, shape, mesh_dim_names=MESH_AXES)
    live = [a for a in ported if sizes[a] > 1]
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


def rank_coords(rank: int, sizes) -> dict[str, int]:
    """The mesh coordinates of process ``rank`` (row-major over
    ``MESH_AXES``, as ``build_mesh`` lays the ranks out), without a mesh."""
    out = {}
    for a in reversed(MESH_AXES):
        rank, out[a] = divmod(rank, sizes[a])
    return {a: out[a] for a in MESH_AXES}


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
    live = tuple(a for a in MESH_AXES if a in axes and axis_size(mesh, a) > 1)
    if not live:
        return None
    if len(live) == 1:
        return mesh.get_group(live[0])
    return mesh._orion_groups[live]
