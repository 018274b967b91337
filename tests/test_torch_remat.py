"""The port's remat policies (``orion_tpu_torch/models/remat.py``) against
the JAX package's (``jax.checkpoint`` with ``remat_policy``), mirroring
``tests/test_scan_remat.py::test_remat_policies_grad_equivalent``.

For none, full, dots, names and names+offload on tiny-llama, tiny-mixtral
and tiny-gemma2, from the same weights (``from_jax_params``) and batch:
- the port's loss and every gradient against the JAX package's under the
  same policy (loss to 2e-6; gradients to 2e-6 absolute + 1e-4 relative,
  the tolerance of ``tests/test_torch_train.py``);
- each policy against the port's own none: the loss bitwise, gradients
  to 1e-6 (the replay sums a gradient's parts in another order);
- names against names+offload bitwise (the same saved set, elsewhere);
- the saved bytes, counted through ``saved_tensors_hooks``: names keeps
  exactly the named set beside full's block inputs, dots exactly the
  products, and the offload path holds none of it on the device and moves
  exactly the named set's bytes each way.
Float32 throughout.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orion_tpu.config import get_config as j_get_config
from orion_tpu.data import loader as j_loader
from orion_tpu.models import init_params as j_init_params
from orion_tpu.models.transformer import loss_fn as j_loss_fn
from orion_tpu_torch.config import get_config
from orion_tpu_torch.models import from_jax_params, loss_fn
from orion_tpu_torch.models.convert import tree_leaves, tree_leaves_with_path
from orion_tpu_torch.models.remat import RematLog, remat_policy
from tests import torch_threads  # noqa: F401  (one intra-op thread)

BASE = ["data.batch_size=2", "data.seq_len=32", "data.packed=true"]
PRESETS = ["tiny-llama", "tiny-mixtral", "tiny-gemma2"]
POLICIES = {
    "none": [],
    "full": ["model.remat=full"],
    "dots": ["model.remat=dots"],
    "names": ["model.remat=names"],
    "names+offload": ["model.remat=names", "model.remat_offload=true"],
}


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _jax_inputs(preset):
    """(numpy params, numpy batch) of the JAX package, once per preset."""
    jcfg = j_get_config(preset, BASE)
    jp = j_init_params(jcfg.model, jax.random.key(0))
    batch = dict(j_loader.SyntheticLoader(jcfg.data, 0, 1, jcfg.model.vocab_size).batch_at(3))
    return _np_tree(jp), batch


@functools.lru_cache(maxsize=None)
def _jax(preset, policy):
    """(loss, numpy grads) of the JAX package's loss_fn under ``policy``."""
    mcfg = j_get_config(preset, BASE + POLICIES[policy]).model
    jp, batch = _jax_inputs(preset)
    (loss, _), grads = jax.jit(
        jax.value_and_grad(j_loss_fn, has_aux=True), static_argnums=2
    )(jax.tree.map(jnp.asarray, jp), {k: jnp.asarray(v) for k, v in batch.items()}, mcfg)
    return float(loss), _np_tree(grads)


@functools.lru_cache(maxsize=None)
def _port(preset, policy):
    """(cfg, loss, grads, RematLog, bytes autograd saved in the forward:
    one count per storage, the parameters left out)."""
    cfg = get_config(preset, BASE + POLICIES[policy])
    jp, batch = _jax_inputs(preset)
    params = from_jax_params(jp, cfg.model)
    leaves = [leaf.requires_grad_(True) for leaf in tree_leaves(params)]
    own = {p.untyped_storage().data_ptr() for p in leaves}
    saved = {}

    def pack(t):
        ptr = t.untyped_storage().data_ptr()
        if ptr not in own:
            saved[ptr] = t.untyped_storage().nbytes()
        return t

    log = RematLog()
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        loss, _ = loss_fn(params, {k: torch.from_numpy(v.copy()) for k, v in batch.items()},
                          cfg.model, remat_log=log)
    grads = torch.autograd.grad(loss, leaves)
    return cfg, loss.detach(), grads, log, sum(saved.values())


@pytest.mark.parametrize("policy", list(POLICIES))
@pytest.mark.parametrize("preset", PRESETS)
def test_policy_matches_jax(preset, policy):
    jloss, jgrads = _jax(preset, policy)
    cfg, loss, grads, _, _ = _port(preset, policy)
    assert abs(float(loss) - jloss) < 2e-6
    want = from_jax_params(jgrads, cfg.model)
    for (path, w), g in zip(tree_leaves_with_path(want), grads):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=2e-6, rtol=1e-4,
                                   err_msg=str(path))


@pytest.mark.parametrize("policy", [p for p in POLICIES if p != "none"])
@pytest.mark.parametrize("preset", PRESETS)
def test_policy_matches_own_none(preset, policy):
    _, loss0, grads0, _, _ = _port(preset, "none")
    _, loss, grads, _, _ = _port(preset, policy)
    assert torch.equal(loss, loss0)
    for g, g0 in zip(grads, grads0):
        np.testing.assert_allclose(g.numpy(), g0.numpy(), atol=1e-6, rtol=0)


@pytest.mark.parametrize("preset", PRESETS)
def test_names_and_offload_bitwise(preset):
    _, loss, grads, _, _ = _port(preset, "names")
    _, loss_o, grads_o, _, _ = _port(preset, "names+offload")
    assert torch.equal(loss, loss_o)
    assert all(torch.equal(a, b) for a, b in zip(grads, grads_o))


def _named_set_bytes(m, B, S):
    """Bytes of REMAT_SAVE_NAMES over the layers (float32): the two norms'
    outputs, the attention output, the FFN output; with MoE the [B, S, k]
    gates and the aux loss scalar that rides with the FFN output."""
    per = B * S * (3 * m.d_model + m.n_heads * m.resolved_head_dim) * 4
    if m.is_moe:
        per += B * S * m.n_experts_per_token * 4 + 4
    return m.n_layers * per


def _product_bytes(m, B, S):
    """Bytes of the products dots saves (float32): q, k, v, the output
    projection, and the MLP's three, or the MoE router's logits."""
    H = m.resolved_head_dim
    per = m.n_heads * H + 2 * m.n_kv_heads * H + m.d_model
    if m.is_moe:
        per += m.n_experts
    else:
        per += (2 if m.is_gated_mlp else 1) * m.d_ff + m.d_model
    return m.n_layers * B * S * per * 4


@pytest.mark.parametrize("preset", PRESETS)
def test_saved_bytes_accounting(preset):
    cfg, _, _, log_full, full = _port(preset, "full")
    _, _, _, log_names, names = _port(preset, "names")
    _, _, _, log_off, off = _port(preset, "names+offload")
    _, _, _, log_dots, dots = _port(preset, "dots")
    none = _port(preset, "none")[-1]
    m, B, S = cfg.model, cfg.data.batch_size, cfg.data.seq_len
    named = _named_set_bytes(m, B, S)
    # Every policy keeps each block's input.
    for log in (log_full, log_names, log_off, log_dots):
        assert log.block_inputs == m.n_layers * B * S * m.d_model * 4
    assert log_full.saved == 0
    # names: exactly the named set beside full's saves.
    assert log_names.saved == named and names - full == named
    # names+offload: the same set, none of it on the device; moved both ways.
    assert log_off.saved == named and off == full
    assert log_off.to_host == log_off.to_device == named
    assert log_names.to_host == log_names.to_device == 0
    # dots: exactly the products.
    assert log_dots.saved == _product_bytes(m, B, S) and dots - full == log_dots.saved
    assert none > names > full
    if not m.is_moe:
        assert dots > names


def test_offload_needs_names():
    for remat in ("none", "full", "dots"):
        cfg = get_config("tiny-llama", [f"model.remat={remat}", "model.remat_offload=true"])
        with pytest.raises(ValueError, match="remat_offload requires model.remat='names'"):
            remat_policy(cfg.model)
    assert remat_policy(get_config("tiny-llama", ["model.remat=names",
                                                  "model.remat_offload=true"]).model) == "names"
    assert remat_policy(get_config("tiny-llama").model) is None
