"""Logical-axis -> mesh-axis sharding rules, and each rank's block of a leaf.

Counterpart of ``orion_tpu/parallel/sharding.py``. The model names every
parameter dimension with a logical axis (``models.transformer.
param_logical_axes``); the rule table maps logical axes to mesh axes; a
spec is a tuple with one entry per dimension, each None (replicated), an
axis name or a tuple of axis names, as JAX's ``PartitionSpec``. Where the
JAX package hands the spec to XLA, the port cuts each leaf itself: the
block a rank holds (``block_index``) is exactly the block JAX's
``NamedSharding`` places on the device at the same mesh position (the mesh
is row-major over ``runtime.mesh.MESH_AXES`` in both packages), so a
checkpoint's shard indices mean the same thing in either.

``param_layout`` is the trainer's plan: per leaf of the port's parameter
tree (one dict per layer) the parameter spec (``embed`` -> ``fsdp``), the
optimizer state's spec (with ``train.zero1`` the leaf's
``zero1_update_dim`` takes ``dp``) and the ZeRO-1 update dimension, with
the JAX package's choice made on the checkpoint layout (stacked layers
under ``scan_layers``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Optional, Sequence, Union

import torch

MeshAxes = Union[None, str, tuple[str, ...]]
Spec = tuple

# Logical axis name -> mesh axis (or axes). None = replicated along that dim.
DEFAULT_RULES: dict[str, MeshAxes] = {
    # Activations.
    "batch": ("dp", "fsdp"),   # fsdp shards the batch too (ZeRO data-parallel)
    "seq": "sp",
    # Parameters.
    "embed": "fsdp",           # ZeRO-3: gather-on-use along the embed axis
    "heads": "tp",
    "kv_heads": "tp",
    "mlp": "tp",
    "vocab": "tp",
    "expert": "ep",
    "layers": "pp",
    "pos": None,
}


def _axes(entry: MeshAxes) -> tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def logical_to_spec(
    logical_axes: Sequence[str],
    rules: Mapping[str, MeshAxes] = DEFAULT_RULES,
    axis_sizes: Optional[Mapping[str, int]] = None,
) -> Spec:
    """A tuple of logical axis names as a spec. With ``axis_sizes``, mesh
    axes of size 1 are elided (None instead of ``"tp"`` at tp = 1), and an
    axis used by two dimensions raises, as in the JAX package."""
    spec: list[MeshAxes] = []
    used: set[str] = set()
    for name in logical_axes:
        if name not in rules:
            raise ValueError(f"no sharding rule for logical axis {name!r}")
        axes = _axes(rules[name])
        if axis_sizes is not None:
            axes = tuple(a for a in axes if axis_sizes.get(a, 1) > 1)
        for a in axes:
            if a in used:
                raise ValueError(f"mesh axis {a!r} used twice in logical axes {logical_axes}")
            used.add(a)
        spec.append(None if not axes else axes[0] if len(axes) == 1 else axes)
    return tuple(spec)


def spec_desc(spec: Spec) -> list:
    """The spec as a checkpoint manifest records it (the JAX package's
    ``_sharding_desc`` of a train step's output): a list with None, a name
    or a list of names per dimension, trailing Nones dropped as XLA
    normalizes them ([] for a replicated leaf)."""
    out = [None if e is None else e if isinstance(e, str) else list(e) for e in spec]
    while out and out[-1] is None:
        out.pop()
    return out


def zero1_update_dim(shape: Sequence[int], spec: Spec, n: int) -> Optional[int]:
    """The dimension a leaf's weight update shards over for ZeRO-1: the
    largest dim divisible by the axis size ``n`` among dims no other mesh
    axis shards (ties break to the lowest index). None when no dim
    qualifies: that leaf's update stays replicated."""
    entries = tuple(spec) + (None,) * (len(shape) - len(tuple(spec)))
    best: Optional[int] = None
    for d, size in enumerate(shape):
        if entries[d] is not None or size == 0 or size % n:
            continue
        if best is None or size > shape[best]:
            best = d
    return best


def zero1_spec(shape: Sequence[int], spec: Spec, n: int, axis: str = "dp"
               ) -> tuple[Spec, int]:
    """(the optimizer state's spec, the update dim or -1): ``axis`` inserted
    at ``zero1_update_dim`` (``zero1_shardings``' per-leaf pair)."""
    if n <= 1:
        return tuple(spec), -1
    d = zero1_update_dim(shape, spec, n)
    if d is None:
        return tuple(spec), -1
    entries = list(spec) + [None] * (len(shape) - len(tuple(spec)))
    entries[d] = axis
    return tuple(entries), d


def batch_spec(axis_sizes: Mapping[str, int], shard_seq: bool = True) -> Spec:
    """The spec of a [B, S] token batch (``batch_sharding``): rows over
    ``dp`` x ``fsdp``, the sequence over ``sp`` (unless ``shard_seq`` is
    False)."""
    return logical_to_spec(("batch", "seq" if shard_seq else "pos"),
                           {**DEFAULT_RULES, "pos": None}, axis_sizes)


def block_index(shape: Sequence[int], spec: Spec, sizes: Mapping[str, int],
                coords: Mapping[str, int]) -> list[list[int]]:
    """[[start, stop], ...] of the block the rank at ``coords`` holds: along
    each dimension the coordinate over the entry's axes (row-major, in the
    entry's order) picks one of their product's equal parts."""
    entries = tuple(spec) + (None,) * (len(shape) - len(tuple(spec)))
    out = []
    for d, (size, entry) in enumerate(zip(shape, entries)):
        n, i = 1, 0
        for a in _axes(entry):
            n *= sizes.get(a, 1)
            i = i * sizes.get(a, 1) + coords.get(a, 0)
        if size % n:
            raise ValueError(f"dim {d} of {tuple(shape)} is not divisible by {n} "
                             f"(spec {spec})")
        c = size // n
        out.append([i * c, (i + 1) * c])
    return out


def local_block(t: torch.Tensor, spec: Spec, sizes: Mapping[str, int],
                coords: Mapping[str, int]) -> torch.Tensor:
    """The rank's block of ``t`` (a view)."""
    for d, (a, b) in enumerate(block_index(t.shape, spec, sizes, coords)):
        if b - a != t.shape[d]:
            t = t.narrow(d, a, b - a)
    return t


def writes_block(spec: Spec, sizes: Mapping[str, int], coords: Mapping[str, int]) -> bool:
    """Whether the rank at ``coords`` writes its block of a leaf to a
    checkpoint: the first replica of each block (coordinate 0 on every axis
    of size > 1 the spec does not use), as JAX writes shards of
    ``replica_id`` 0."""
    used = {a for e in spec for a in _axes(e)}
    return all(coords.get(a, 0) == 0 for a, n in sizes.items() if n > 1 and a not in used)


def is_sharded(spec: Spec) -> bool:
    return any(e is not None for e in spec)


def parts(spec: Spec, d: int, sizes: Mapping[str, int]) -> int:
    """How many blocks dimension ``d`` is cut into."""
    n = 1
    for a in _axes(spec[d] if d < len(spec) else None):
        n *= sizes.get(a, 1)
    return n


@dataclasses.dataclass(frozen=True)
class LeafLayout:
    """One leaf of the port's (per-layer) parameter tree: its parameter
    spec, the optimizer state's spec, the dimension ``fsdp`` cuts (None if
    none) and the ZeRO-1 update dimension (-1: replicated update), all in
    the per-layer leaf's dimensions; ``stacked`` when the checkpoint holds
    it with a leading layer dimension.

    ``zero1_layers``: the JAX package's ZeRO-1 update dim for the stacked
    leaf is the layer dimension (a norm scale whose embed dim fsdp cuts).
    The port then updates the leaf whole on every dp rank (the same
    values) and saves each rank's block of layers, so the checkpoint holds
    JAX's layout."""

    spec: Spec
    state_spec: Spec
    fsdp_dim: Optional[int]
    zero1_dim: int
    stacked: bool
    zero1_layers: bool = False

    def ckpt_spec(self, state: bool = False, held: bool = False) -> Spec:
        """The spec in the checkpoint layout (None, or ``dp`` under
        ``zero1_layers``, for the layer dim); with ``held`` the block this
        rank holds rather than the one it saves."""
        s = self.state_spec if state else self.spec
        if not self.stacked:
            return s
        return ("dp" if state and self.zero1_layers and not held else None,) + s


def layout_at(layout: Any, path: tuple) -> LeafLayout:
    """The ``LeafLayout`` at ``path`` of a ``param_layout`` tree."""
    for k in path:
        layout = layout[k]
    return layout


def param_layout(mcfg, axis_sizes: Mapping[str, int], zero1: bool = False) -> Any:
    """A tree like the port's parameters (one dict per layer) of
    ``LeafLayout``, from the JAX package's logical axes and rules. The
    ZeRO-1 update dim is the JAX package's choice on the checkpoint
    layout's shape (stacked under ``scan_layers``); it is computed at any
    dp > 1, and the state spec takes ``dp`` only with ``zero1``."""
    from orion_tpu_torch.models.convert import init_params
    from orion_tpu_torch.models.transformer import param_logical_axes

    per_layer = dataclasses.replace(mcfg, scan_layers=False)
    logical = param_logical_axes(per_layer)
    shapes = init_params(per_layer, torch.Generator(), device="meta", dtype=torch.float32)
    dp = axis_sizes.get("dp", 1)
    scanned = mcfg.scan_layers

    def build(path, axes, t):
        stacked = scanned and path[0] == "blocks"
        spec = logical_to_spec(axes, axis_sizes=axis_sizes)
        ck_shape = ((mcfg.n_layers,) if stacked else ()) + tuple(t.shape)
        ck_spec = ((None,) if stacked else ()) + spec
        state_ck, d = zero1_spec(ck_shape, ck_spec, dp)
        lead = 1 if stacked else 0
        layers = stacked and d == 0
        fsdp = [i for i, e in enumerate(spec) if "fsdp" in _axes(e)]
        return LeafLayout(spec=spec,
                          state_spec=state_ck[lead:] if zero1 and not layers else spec,
                          fsdp_dim=fsdp[0] if fsdp else None,
                          zero1_dim=d - lead if d >= lead else -1, stacked=stacked,
                          zero1_layers=zero1 and layers)

    return _map_with_path(build, logical, shapes)


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(a, str) for a in x)


def _map_with_path(fn, axes_tree, shapes, path: tuple = ()):
    """``fn(path, axes, shape_leaf)`` over a parameter tree (its own key
    order) and the logical-axes tree that describes it."""
    if _is_axes(axes_tree):
        return fn(path, axes_tree, shapes)
    if isinstance(shapes, dict):
        return {k: _map_with_path(fn, axes_tree[k], v, path + (k,)) for k, v in shapes.items()}
    return [_map_with_path(fn, axes_tree[i], v, path + (i,)) for i, v in enumerate(shapes)]
