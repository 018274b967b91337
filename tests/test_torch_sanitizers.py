"""The port's sanitizers against the JAX package's, mirroring
``tests/test_train.py::test_checkify_*`` and ``::test_debug_asserts_*``
(minus the ep=2 layout, which waits for expert parallelism):

- ``runtime.checkify`` (``runtime/sanitize.py``): a NaN and an
  out-of-vocabulary target raise ``CheckifyError`` (a ValueError, as the
  JAX package's ``JaxRuntimeError``) before the update, and a later
  healthy step runs; beside the anomaly guard and at sp=2 it is refused
  with the JAX trainer's own ValueError;
- ``model.debug_asserts`` (``runtime/asserts.py``): a truly corrupted
  router index raises ``DeviceAssertionError("moe_route_idx")`` in both
  dispatches; an injected ``ring_positions`` / ``ring_striped_positions``
  at sp=2 with a window raises on both ranks (gloo rank processes, one
  spawn for the file, ``tests/torch_sp_worker.py``); with the flag off an
  armed injection changes nothing;
- an out-of-range router index without the flag drops its assignment, as
  the JAX package's einsum dispatch does (the repaired semantics fault);
- ``runtime.debug_nans`` raises ``FloatingPointError`` where the JAX
  trainer does, forward and backward;
- ``runtime.deterministic`` sets PyTorch's process-wide flags.
The process-wide flags are restored after each test (``restore_sanitizers``).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orion_tpu.config import get_config as j_get_config
from orion_tpu.data import loader as j_loader
from orion_tpu.models import init_params as j_init_params
from orion_tpu.models import moe as j_moe
from orion_tpu.models.transformer import loss_fn as j_loss_fn
from orion_tpu.train import Trainer as JTrainer
from orion_tpu_torch.config import get_config
from orion_tpu_torch.models import from_jax_params, loss_fn, moe
from orion_tpu_torch.models.convert import tree_leaves
from orion_tpu_torch.runtime import sanitize
from orion_tpu_torch.runtime.asserts import DeviceAssertionError, clear_injected, inject
from orion_tpu_torch.runtime.sanitize import CheckifyError
from orion_tpu_torch.train import Trainer
from tests import torch_sp_worker as W
from tests import torch_threads  # noqa: F401  (one intra-op thread)
from tests.torch_flags import restore_sanitizers  # noqa: F401  (a fixture)

BASE = ["runtime.platform=cpu", "train.num_steps=2", "optimizer.warmup_steps=1",
        "train.log_interval=1000"]
SP_BASE = ["data.batch_size=4", "data.seq_len=64", "train.num_steps=1",
           "train.log_interval=100", "model.sliding_window=24"]
SP_CASES = {
    "ring": ("ring_positions", []),
    "striped": ("ring_striped_positions", ["parallel.sequence_method=ring_striped"]),
}


@pytest.fixture(scope="module")
def sp_asserts(tmp_path_factory):
    """The asserts job's results by rank (the ranks start once for the file)."""
    cases = [{"id": name, "site": site, "preset": "tiny-llama", "overrides": SP_BASE + extra}
             for name, (site, extra) in SP_CASES.items()]
    tmp = tmp_path_factory.mktemp("asserts_sp")
    return W.collect(W.spawn("asserts", 2, {"cases": cases}, tmp), 2, tmp)


def _trainer(preset="tiny", extra=()):
    tr = Trainer(get_config(preset, BASE + list(extra)), device="cpu")
    return tr, tr.init_state()


def _params_bits(state):
    return [p.detach().clone().view(torch.int32) for p in tree_leaves(state["params"])]


def test_checkify_catches_nan():
    """A healthy step passes; a NaN in the embedding table (tiny ties it
    to the LM head, so the loss is NaN) raises before the update."""
    tr, state = _trainer(extra=("runtime.checkify=true",))
    _, m = tr.train_step(state, tr.global_batch(0))
    assert np.isfinite(m["loss"])
    state["params"]["embed"]["tokens"][0, 0] = float("nan")
    before = _params_bits(state)
    with pytest.raises(CheckifyError, match="(?i)nan"):
        tr.train_step(state, tr.global_batch(1))
    assert all(torch.equal(a, b) for a, b in zip(before, _params_bits(state)))
    assert state["step"] == 1


def test_checkify_catches_oob_index_and_runs_on():
    tr, state = _trainer(extra=("runtime.checkify=true",))
    batch = tr.global_batch(0)
    batch["targets"] = batch["targets"].clone()
    batch["targets"][0, 0] = tr.cfg.model.vocab_size + 7
    with pytest.raises(CheckifyError, match="(?i)out.of.bounds|index"):
        tr.train_step(state, batch)
    assert isinstance(CheckifyError("x"), ValueError)
    _, m = tr.train_step(state, tr.global_batch(1))   # the next healthy step runs
    assert np.isfinite(m["loss"]) and state["step"] == 1


@pytest.mark.parametrize("extra", [
    ("train.anomaly_guard=true",),
    ("parallel.sp=2", "data.batch_size=4", "data.seq_len=32"),
])
def test_checkify_refusals_match_jax(extra, cpu_devices):
    ov = ["runtime.checkify=true", *extra]
    with pytest.raises(ValueError) as jerr:
        JTrainer(j_get_config("tiny", BASE + ov))
    with pytest.raises(ValueError) as err:
        Trainer(get_config("tiny", BASE + ov), device="cpu")
    assert str(err.value) == str(jerr.value)


def _corrupt(orig, set_index):
    def corrupt(x, router_w, cfg):
        probs, gate, idx = orig(x, router_w, cfg)
        return probs, gate, set_index(idx, cfg.n_experts + 3)
    return corrupt


def _torch_set(idx, v):
    idx = idx.clone()
    idx[0, 0, 0] = v
    return idx


@pytest.mark.parametrize("dispatch", ["sorted", "einsum"])
def test_debug_asserts_catch_true_router_corruption(dispatch, monkeypatch):
    """Without the flag the corrupted step trains (the assignment drops);
    with it the routing raises before the index is used."""
    monkeypatch.setattr(moe, "_router_topk", _corrupt(moe._router_topk, _torch_set))
    layout = ["data.batch_size=4", "data.seq_len=32", "train.num_steps=1",
              f"model.moe_dispatch={dispatch}"]
    tr, state = _trainer("tiny-mixtral", layout)
    _, m = tr.train_step(state, tr.global_batch(0))
    assert np.isfinite(m["loss"])
    tr, state = _trainer("tiny-mixtral", layout + ["model.debug_asserts=true"])
    with pytest.raises(DeviceAssertionError, match="moe_route_idx"):
        tr.train_step(state, tr.global_batch(0))


def test_debug_asserts_off_ignore_injection():
    """Flag off, injection armed: the same losses as without it."""
    layout = ["data.batch_size=4", "data.seq_len=32", "train.num_steps=2"]
    clean = [m.loss for m in _trainer("tiny-mixtral", layout)[0].fit()]
    try:
        inject("moe_route_idx")
        armed = [m.loss for m in _trainer("tiny-mixtral", layout)[0].fit()]
        tr, state = _trainer("tiny-mixtral", layout + ["model.debug_asserts=true"])
        with pytest.raises(DeviceAssertionError, match="moe_route_idx"):
            tr.train_step(state, tr.global_batch(0))
    finally:
        clear_injected()
    assert armed == clean


@pytest.mark.parametrize("name", sorted(SP_CASES))
def test_debug_asserts_injected_in_sp_ring(sp_asserts, name):
    site = SP_CASES[name][0]
    rows = [r[name] for r in sp_asserts]
    assert not any(r["jax_imported"] for r in sp_asserts)
    for row in rows:
        assert isinstance(row["clean"], list) and np.all(np.isfinite(row["clean"]))
        assert row["off"] == row["clean"]
        assert isinstance(row["on"], str) and f"device_assert[{site}]" in row["on"]


@pytest.mark.parametrize("dispatch", ["einsum", "sorted"])
def test_oob_router_index_drops_as_jax(dispatch, monkeypatch):
    """An expert index of E + 3 drops its assignment. The JAX package's
    einsum dispatch does so (``jax.nn.one_hot`` gives a zero row): the
    port's loss equals it to 2e-6 in both dispatches. The JAX package's
    sorted dispatch does not drop: ``take_along_axis`` fills the position
    with INT32_MIN, so ``keep`` holds, and the combine's gather clamps the
    index to expert E-1's slot 0, another token's output; its loss is
    finite but differs, and is not the reference here."""
    base = ["data.batch_size=2", "data.seq_len=32", "data.packed=true"]
    jcfg = j_get_config("tiny-mixtral", base)
    jp = j_init_params(jcfg.model, jax.random.key(0))
    batch = dict(j_loader.SyntheticLoader(jcfg.data, 0, 1, 256).batch_at(3))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    monkeypatch.setattr(j_moe, "_router_topk",
                        _corrupt(j_moe._router_topk, lambda i, v: i.at[0, 0, 0].set(v)))
    jloss = {d: float(jax.jit(lambda p, b, m=j_get_config(
        "tiny-mixtral", base + [f"model.moe_dispatch={d}"]).model: j_loss_fn(p, b, m)[0])(jp, jb))
        for d in ("einsum", dispatch)}
    cfg = get_config("tiny-mixtral", base + [f"model.moe_dispatch={dispatch}"])
    params = from_jax_params(jax.tree.map(np.asarray, jp), cfg.model)
    monkeypatch.setattr(moe, "_router_topk", _corrupt(moe._router_topk, _torch_set))
    loss, _ = loss_fn(params, {k: torch.from_numpy(v.copy()) for k, v in batch.items()},
                      cfg.model)
    assert np.isfinite(jloss[dispatch])
    assert abs(float(loss) - jloss["einsum"]) < 2e-6
    # The dropped assignment claims no capacity and is not kept.
    x = torch.randn(2, 32, cfg.model.d_model, generator=torch.Generator().manual_seed(0))
    idx, _, _, keep, (frac, _) = moe.route_indices(x, params["blocks"][0]["moe"]["router"],
                                                  cfg.model)
    assert not bool(keep[0, 0, 0]) and int(idx[0, 0, 0]) == 0
    assert float(frac.sum()) < 1.0


def test_debug_nans_raises_where_jax_does(restore_sanitizers):
    """A NaN planted in the embedding table raises FloatingPointError in
    the forward, in the JAX trainer (jax_debug_nans) and in the port."""
    ov = BASE + ["runtime.debug_nans=true", "train.num_steps=1"]
    jtr = JTrainer(j_get_config("tiny", ov))
    jstate = jtr.init_state()
    emb = jstate["params"]["embed"]["tokens"]
    planted = np.asarray(emb).copy()
    planted[0, 0] = np.nan
    # Planted by a copy: under jax_debug_nans a jnp update would raise itself.
    jstate["params"]["embed"]["tokens"] = jax.device_put(planted, emb.sharding)
    with pytest.raises(FloatingPointError):
        jtr.train_step(jstate, jtr.global_batch(0))
    jax.config.update("jax_debug_nans", False)
    tr, state = _trainer(extra=("runtime.debug_nans=true",))
    assert sanitize.debug_nans()
    _, m = tr.train_step(state, tr.global_batch(0))     # healthy: no raise
    assert np.isfinite(m["loss"])
    state["params"]["embed"]["tokens"][0, 0] = float("nan")
    with pytest.raises(FloatingPointError, match="nan"):
        tr.train_step(state, tr.global_batch(1))


def test_debug_nans_backward(restore_sanitizers):
    """A NaN born in the backward raises FloatingPointError (anomaly
    mode's check of every backward function's output)."""
    sanitize.set_debug_nans(True)
    x = torch.ones(3, requires_grad=True)
    y = (x * 2).sum()
    with pytest.raises(FloatingPointError, match="nan"):
        with sanitize.nan_backward():
            torch.autograd.grad(y, x, torch.tensor(float("nan")))


def test_deterministic_sets_torch_flags(restore_sanitizers, monkeypatch):
    monkeypatch.delenv("CUBLAS_WORKSPACE_CONFIG", raising=False)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    with pytest.raises(RuntimeError, match="CUBLAS_WORKSPACE_CONFIG"):
        Trainer(get_config("tiny-llama", ["runtime.deterministic=true"]), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)
    Trainer(get_config("tiny-llama", ["runtime.deterministic=true"]), device="cpu")
    assert torch.are_deterministic_algorithms_enabled()
    assert torch.backends.cudnn.deterministic and not torch.backends.cudnn.benchmark
    assert os.environ["CUBLAS_WORKSPACE_CONFIG"] == sanitize.CUBLAS_WORKSPACE
