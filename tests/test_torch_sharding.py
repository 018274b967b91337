"""The port's sharding rules (``orion_tpu_torch/parallel/sharding.py``)
against the JAX package's on the fake devices of ``conftest.py``.

Counterpart of ``tests/test_parallel.py::test_fsdp_actually_shards_params``
and ``tests/test_zero1.py::test_zero1_update_dim_choice``: for
``tiny-llama``, ``tiny-gemma2`` and ``tiny`` (GPT-2) at fsdp = 2, 4 and 8,
every leaf's block on every rank (``block_index`` of the spec
``param_layout`` gives, at the rank's mesh coordinates) is the index and
shape of the shard JAX's ``NamedSharding`` puts on the device at the same
mesh position, and ``shard_params`` cuts the same bytes from the JAX
package's init as ``jax.device_put`` does; ZeRO-1's update dimension and
state spec equal ``zero1_shardings``' at dp = 2, 4, 8 beside fsdp = 1, 2;
the batch's rows and sequence slice equal ``batch_sharding``'s.
"""

import jax
import numpy as np
import pytest

from orion_tpu.config import ParallelConfig as JParallel
from orion_tpu.config import get_config as j_get_config
from orion_tpu.models import init_params as j_init_params
from orion_tpu.models import param_logical_axes as j_param_logical_axes
from orion_tpu.parallel import batch_sharding, param_shardings, zero1_shardings
from orion_tpu.runtime import build_mesh as j_build_mesh
from orion_tpu_torch.config import get_config
from orion_tpu_torch.models.convert import shard_params, unshard_params
from orion_tpu_torch.models.transformer import param_logical_axes
from orion_tpu_torch.parallel.sharding import (
    batch_spec,
    block_index,
    layout_at,
    logical_to_spec,
    param_layout,
    spec_desc,
    zero1_update_dim,
)
from tests import torch_threads  # noqa: F401  (one intra-op thread)

PRESETS = ["tiny-llama", "tiny-gemma2", "tiny"]


def _mesh(devices, **sizes):
    p = JParallel(**sizes)
    return j_build_mesh(p, devices=devices[:p.num_devices]), dict(p.axis_sizes)


def _coords(mesh, device):
    at = np.argwhere(mesh.devices == device)[0]
    return {name: int(i) for name, i in zip(mesh.axis_names, at)}


def _index(index, shape):
    return [list(sl.indices(n)[:2]) for sl, n in zip(index, shape)]


def _port_path(path, scanned):
    keys = tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path)
    if keys[0] == "blocks" and scanned:
        keys = ("blocks", 0) + keys[1:]
    return keys


def _leaves(tree):
    return jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, tuple) and all(isinstance(a, str) for a in x))[0]


@pytest.mark.parametrize("fsdp", [2, 4, 8])
@pytest.mark.parametrize("preset", PRESETS)
def test_param_blocks_match_named_sharding(cpu_devices, preset, fsdp):
    jcfg, cfg = j_get_config(preset), get_config(preset)
    mesh, sizes = _mesh(cpu_devices, fsdp=fsdp)
    shapes = jax.eval_shape(lambda: j_init_params(jcfg.model, jax.random.key(0)))
    shardings = param_shardings(mesh, j_param_logical_axes(jcfg.model))
    layout = param_layout(cfg.model, sizes)
    sharded = 0
    for (path, sh), (_, s) in zip(jax.tree_util.tree_flatten_with_path(shardings)[0],
                                  jax.tree_util.tree_flatten_with_path(shapes)[0]):
        lay = layout_at(layout, _port_path(path, cfg.model.scan_layers))
        spec = lay.ckpt_spec()
        assert spec_desc(spec) == spec_desc(tuple(sh.spec)), path
        for device, index in sh.devices_indices_map(s.shape).items():
            want = _index(index, s.shape)
            assert block_index(s.shape, spec, sizes, _coords(mesh, device)) == want, path
            assert [b - a for a, b in want] == list(sh.shard_shape(s.shape))
        sharded += lay.fsdp_dim is not None
    assert sharded > 0


@pytest.mark.parametrize("preset", PRESETS)
def test_shard_params_cuts_what_device_put_places(cpu_devices, preset):
    """``shard_params`` of the JAX init (numpy, per-layer) gives each rank
    the bytes ``jax.device_put`` puts on its device at fsdp = 4, and
    ``unshard_params`` puts the whole tree back."""
    from orion_tpu_torch.models import from_jax_params
    from orion_tpu_torch.models.convert import tree_leaves_with_path

    jcfg, cfg = j_get_config(preset), get_config(preset)
    mesh, sizes = _mesh(cpu_devices, fsdp=4)
    jparams = j_init_params(jcfg.model, jax.random.key(0))
    placed = jax.device_put(jparams, param_shardings(mesh, j_param_logical_axes(jcfg.model)))
    whole = from_jax_params(jax.tree.map(np.asarray, jparams), cfg.model)
    layout = param_layout(cfg.model, sizes)
    coords = [_coords(mesh, d) for d in mesh.devices.reshape(-1)]
    blocks = [shard_params(whole, layout, sizes, c) for c in coords]
    by_rank = [dict(tree_leaves_with_path(b)) for b in blocks]
    for path, arr in jax.tree_util.tree_flatten_with_path(placed)[0]:
        port_path = _port_path(path, cfg.model.scan_layers)
        for s in arr.addressable_shards:
            rank = list(mesh.devices.reshape(-1)).index(s.device)
            want = np.asarray(s.data)
            if cfg.model.scan_layers and port_path[0] == "blocks":
                # The stacked leaf's layers are the port's per-layer leaves.
                for layer in range(cfg.model.n_layers):
                    got = by_rank[rank][("blocks", layer) + port_path[2:]].numpy()
                    np.testing.assert_array_equal(got, want[layer], err_msg=str(port_path))
            else:
                got = by_rank[rank][port_path].numpy()
                np.testing.assert_array_equal(got, want, err_msg=str(port_path))
    back = dict(tree_leaves_with_path(unshard_params(blocks, layout, sizes, coords)))
    for path, t in tree_leaves_with_path(whole):
        assert np.array_equal(back[path].numpy(), t.numpy()), path


@pytest.mark.parametrize("dp,fsdp", [(2, 1), (4, 1), (8, 1), (2, 2), (4, 2)])
@pytest.mark.parametrize("preset", PRESETS)
def test_zero1_dims_match_zero1_shardings(cpu_devices, preset, dp, fsdp):
    jcfg, cfg = j_get_config(preset), get_config(preset)
    mesh, sizes = _mesh(cpu_devices, dp=dp, fsdp=fsdp)
    shapes = jax.eval_shape(lambda: j_init_params(jcfg.model, jax.random.key(0)))
    zshard, dims = zero1_shardings(mesh, j_param_logical_axes(jcfg.model), shapes)
    layout = param_layout(cfg.model, sizes, zero1=True)
    for (path, sh), (_, d), (_, s) in zip(jax.tree_util.tree_flatten_with_path(zshard)[0],
                                          jax.tree_util.tree_flatten_with_path(dims)[0],
                                          jax.tree_util.tree_flatten_with_path(shapes)[0]):
        lay = layout_at(layout, _port_path(path, cfg.model.scan_layers))
        lead = 1 if lay.stacked else 0
        got = 0 if lay.zero1_layers else (lay.zero1_dim + lead if lay.zero1_dim >= 0 else -1)
        assert got == d, path
        spec = lay.ckpt_spec(state=True)
        assert spec_desc(spec) == spec_desc(tuple(sh.spec)), path
        for device, index in sh.devices_indices_map(s.shape).items():
            assert block_index(s.shape, spec, sizes, _coords(mesh, device)) == _index(
                index, s.shape), path


@pytest.mark.parametrize("sizes", [dict(dp=2), dict(fsdp=4), dict(dp=2, fsdp=2),
                                   dict(dp=2, sp=2), dict(dp=2, fsdp=2, sp=2)])
def test_batch_rows_match_batch_sharding(cpu_devices, sizes):
    mesh, all_sizes = _mesh(cpu_devices, **sizes)
    shape = (8, 64)
    sh = batch_sharding(mesh)
    for device, index in sh.devices_indices_map(shape).items():
        got = block_index(shape, batch_spec(all_sizes), all_sizes, _coords(mesh, device))
        assert got == _index(index, shape)


def _axes_at(tree, path):
    for k in path:
        tree = tree[getattr(k, "key", getattr(k, "idx", None))]
    return tree


@pytest.mark.parametrize("scan_layers", [True, False])
@pytest.mark.parametrize("preset", PRESETS)
def test_logical_axes_are_the_jax_packages(preset, scan_layers):
    ov = [f"model.scan_layers={scan_layers}"]
    jcfg, cfg = j_get_config(preset, ov), get_config(preset, ov)
    want = _leaves(j_param_logical_axes(jcfg.model))
    got = param_logical_axes(cfg.model)
    assert len(want) == len(_leaves(got))
    for path, axes in want:
        assert _axes_at(got, path) == axes, path


def test_zero1_update_dim_choice():
    """The JAX package's cases: the largest divisible unsharded dim wins,
    ties break low, already-sharded dims are excluded, None when nothing
    fits."""
    assert zero1_update_dim((6, 16, 8), (None, None, None), 8) == 1
    assert zero1_update_dim((16, 16), (None, None), 8) == 0
    assert zero1_update_dim((16, 8), ("fsdp", None), 8) == 1
    assert zero1_update_dim((6, 7), (None, None), 8) is None
    assert zero1_update_dim((64,), (None,), 8) == 0


def test_logical_to_spec_rules():
    sizes = {"dp": 2, "fsdp": 4, "tp": 1, "sp": 2}
    assert logical_to_spec(("vocab", "embed"), axis_sizes=sizes) == (None, "fsdp")
    assert logical_to_spec(("batch", "seq"), axis_sizes=sizes) == (("dp", "fsdp"), "sp")
    assert logical_to_spec(("batch", "seq"), axis_sizes={"dp": 2}) == ("dp", None)
    assert logical_to_spec(("embed", "mlp")) == ("fsdp", "tp")
    with pytest.raises(ValueError, match="no sharding rule"):
        logical_to_spec(("nope",))
    with pytest.raises(ValueError, match="used twice"):
        logical_to_spec(("embed", "embed"), axis_sizes=sizes)
