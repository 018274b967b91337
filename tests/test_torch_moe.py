"""The port's mixture-of-experts layer (``orion_tpu_torch/models/moe.py``)
and the Mixtral family through the model, the trainer, the serving engine
and checkpoints, on the CPU (plain PyTorch versions), against the JAX
package: the same numpy-seeded inputs, the JAX weights carried across by
``from_jax_params``. Float32 throughout; each test states its tolerance.
Greedy streams must be equal token for token."""

import dataclasses
import functools
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orion_tpu.config import get_config as j_get_config
from orion_tpu.data import loader as j_loader
from orion_tpu.infer import InferenceEngine as JEngine
from orion_tpu.models import init_params as j_init_params
from orion_tpu.models import moe as j_moe
from orion_tpu.models.transformer import forward as j_forward
from orion_tpu.models.transformer import loss_fn as j_loss_fn
from orion_tpu.train import Trainer as JTrainer
from orion_tpu_torch.config import get_config
from orion_tpu_torch.infer import InferenceEngine
from orion_tpu_torch.models import forward, from_jax_params, init_params, loss_fn
from orion_tpu_torch.models import moe
from orion_tpu_torch.models.convert import tree_leaves_with_path
from orion_tpu_torch.train import Trainer, state_to_tree
from tests import torch_threads  # noqa: F401  (one intra-op thread)

PRESET = "tiny-mixtral"


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


@functools.lru_cache(maxsize=None)
def _jax_params():
    """The JAX package's tiny-mixtral init (one compiled call), shared by
    the model, trainer-free and engine tests."""
    return jax.jit(j_init_params, static_argnums=0)(
        j_get_config(PRESET).model, jax.random.key(0))


# -- the layer ----------------------------------------------------------------


def _layer_inputs(overflow, B=2, S=32, D=16, seed=0):
    """tests/test_model.py's MoE setup with numpy-seeded draws: capacity
    factor 0.5 under ``overflow`` so the drop path runs."""
    cfg_j = j_get_config(PRESET).model
    cfg_t = get_config(PRESET).model
    if overflow:
        cfg_j = dataclasses.replace(cfg_j, capacity_factor=0.5)
        cfg_t = dataclasses.replace(cfg_t, capacity_factor=0.5)
    E, F = cfg_t.n_experts, cfg_t.d_ff
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    params = {
        "router": (rng.standard_normal((D, E)) * 0.3).astype(np.float32),
        "w_in": (rng.standard_normal((E, D, F)) * 0.1).astype(np.float32),
        "w_gate": (rng.standard_normal((E, D, F)) * 0.1).astype(np.float32),
        "w_out": (rng.standard_normal((E, F, D)) * 0.1).astype(np.float32),
    }
    return cfg_j, cfg_t, x, params


@pytest.mark.parametrize("overflow", [False, True])
def test_routing_matches_jax(overflow):
    """``route_indices``: expert, capacity position and keep exactly the
    JAX package's, gates and aux stats to 1e-6; ``route``: the dispatch
    one-hot exactly, combine weights and aux loss to 1e-6. Overflow drops
    assignments (and none without it)."""
    cfg_j, cfg_t, x, p = _layer_inputs(overflow)
    j_idx, j_gate, j_pos, j_keep, j_stats = jax.jit(j_moe.route_indices, static_argnums=2)(
        jnp.asarray(x), jnp.asarray(p["router"]), cfg_j)
    idx, gate, pos, keep, stats = moe.route_indices(_t(x), _t(p["router"]), cfg_t)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))
    np.testing.assert_array_equal(pos.numpy(), np.asarray(j_pos))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(j_keep))
    np.testing.assert_allclose(gate.numpy(), np.asarray(j_gate), atol=1e-6)
    for a, b in zip(stats, j_stats):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)
    assert bool((~keep).any()) == overflow
    j_disp, j_comb, j_aux = jax.jit(j_moe.route, static_argnums=2)(
        jnp.asarray(x), jnp.asarray(p["router"]), cfg_j)
    disp, comb, aux = moe.route(_t(x), _t(p["router"]), cfg_t)
    np.testing.assert_array_equal(disp.numpy(), np.asarray(j_disp))
    np.testing.assert_allclose(comb.numpy(), np.asarray(j_comb), atol=1e-6)
    assert abs(float(aux) - float(j_aux)) < 1e-6


@pytest.mark.parametrize("overflow", [False, True])
@pytest.mark.parametrize("dispatch", ["einsum", "sorted"])
def test_moe_layer_and_grads_match_jax(dispatch, overflow):
    """``moe_mlp`` / ``moe_mlp_sorted`` through ``moe_dispatch``: output
    and aux loss to 1e-5; the gradient of sum(y^2) + aux with respect to
    x and every weight against ``jax.grad`` to 1e-5 absolute + 1e-4
    relative (float32 sums in another order)."""
    cfg_j, cfg_t, x, p = _layer_inputs(overflow, seed=3)
    cfg_j = dataclasses.replace(cfg_j, moe_dispatch=dispatch)
    cfg_t = dataclasses.replace(cfg_t, moe_dispatch=dispatch)

    def j_obj(x, p):
        y, aux = j_moe.moe_dispatch(x, p, cfg_j)
        return (y ** 2).sum() + aux, (y, aux)

    (_, (j_y, j_aux)), j_grads = jax.jit(
        jax.value_and_grad(j_obj, argnums=(0, 1), has_aux=True))(
        jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()})
    xt = _t(x).requires_grad_(True)
    pt = {k: _t(v).requires_grad_(True) for k, v in p.items()}
    y, aux = moe.moe_dispatch(xt, pt, cfg_t)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(j_y), atol=1e-5)
    assert abs(float(aux) - float(j_aux)) < 1e-5
    grads = torch.autograd.grad((y ** 2).sum() + aux, [xt, *pt.values()])
    want = [j_grads[0]] + [j_grads[1][k] for k in pt]
    for name, g, w in zip(["x", *pt], grads, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=1e-4,
                                   err_msg=name)


def test_dispatch_modes_and_refusals():
    """sorted_a2a is the sorted dispatch at ep = 1 (bitwise); at ep > 1 it
    raises naming expert parallelism (EP), and the trainer refuses the
    axis, and MoE under sequence parallelism (per-shard capacity and aux
    statistics are not ported); an unknown mode raises ValueError."""
    _, cfg_t, x, p = _layer_inputs(True)
    pt = {k: _t(v) for k, v in p.items()}
    want = moe.moe_mlp_sorted(_t(x), pt, cfg_t)
    a2a = dataclasses.replace(cfg_t, moe_dispatch="sorted_a2a")
    got = moe.moe_dispatch(_t(x), pt, a2a)
    assert all(torch.equal(a, b) for a, b in zip(got, want))

    class EpMesh:   # the named-mesh interface axis_size reads
        def size(self, dim):
            return 2 if dim == 3 else 1

    with pytest.raises(NotImplementedError, match="EP"):
        moe.moe_dispatch(_t(x), pt, a2a, EpMesh())
    with pytest.raises(ValueError, match="moe_dispatch"):
        moe.moe_dispatch(_t(x), pt, dataclasses.replace(cfg_t, moe_dispatch="banana"))
    with pytest.raises(NotImplementedError, match="expert parallelism"):
        Trainer(get_config(PRESET, ["parallel.ep=2"]), device="cpu")
    with pytest.raises(NotImplementedError, match="MoE"):
        Trainer(get_config(PRESET, ["parallel.sp=2"]), device="cpu")


# -- the model ---------------------------------------------------------------

SMALL = ["data.batch_size=2", "data.seq_len=32", "data.packed=true"]


@functools.lru_cache(maxsize=None)
def _jax_model():
    """(jax cfg, numpy params, numpy batch, logits, loss, aux, numpy grads)."""
    jcfg = j_get_config(PRESET, SMALL)
    jp = _jax_params()
    batch = dict(j_loader.SyntheticLoader(jcfg.data, 0, 1, jcfg.model.vocab_size).batch_at(3))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def fwd_loss(jp, jb):
        logits, _ = j_forward(jp, jb["inputs"], jcfg.model, positions=jb["positions"],
                              segment_ids=jb["segment_ids"])
        return logits, jax.value_and_grad(j_loss_fn, has_aux=True)(jp, jb, jcfg.model)

    logits, ((loss, aux), grads) = jax.jit(fwd_loss)(jp, jb)
    return (jcfg, _np(jp), batch, np.asarray(logits), float(loss), _np(aux), _np(grads))


def test_init_params_shapes_match_jax():
    """The port's seeded init draws the JAX package's tree: the same leaf
    paths, shapes and dtypes, expert banks included."""
    cfg = get_config(PRESET)
    jp = from_jax_params(_jax_model()[1], cfg.model)
    tp = init_params(cfg.model, torch.Generator().manual_seed(0))
    want = {p: (tuple(v.shape), v.dtype) for p, v in tree_leaves_with_path(jp)}
    got = {p: (tuple(v.shape), v.dtype) for p, v in tree_leaves_with_path(tp)}
    assert got == want
    assert got[(("blocks", 0, "moe", "w_in"))][0] == (4, 64, 128)


@pytest.mark.parametrize("remat", ["none", "full"])
def test_model_logits_loss_and_grads_match_jax(remat):
    """tiny-mixtral on packed batches: logits to 2e-5; loss, ce_loss and
    moe_aux (summed over the layers) to 2e-6; every gradient, experts and
    router included, to 2e-6 absolute + 1e-4 relative. remat=full reruns
    the router in the backward and must give the same gradients."""
    jcfg, jp, batch, jlogits, jloss, jaux, jgrads = _jax_model()
    cfg = get_config(PRESET, SMALL + [f"model.remat={remat}"])
    params = from_jax_params(jp, cfg.model)
    logits = forward(params, _t(batch["inputs"]), cfg.model,
                     positions=_t(batch["positions"]), segment_ids=_t(batch["segment_ids"]))
    np.testing.assert_allclose(logits.numpy(), jlogits, atol=2e-5)
    leaves = [leaf.requires_grad_(True) for _, leaf in tree_leaves_with_path(params)]
    loss, aux = loss_fn(params, {k: _t(v) for k, v in batch.items()}, cfg.model)
    grads = torch.autograd.grad(loss, leaves)
    assert abs(float(loss.detach()) - jloss) < 2e-6
    assert float(aux["moe_aux"]) > 0
    for key in ("ce_loss", "moe_aux", "tokens"):
        assert abs(float(aux[key].detach()) - float(jaux[key])) < 2e-6, key
    for (path, w), g in zip(tree_leaves_with_path(from_jax_params(jgrads, cfg.model)), grads):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=2e-6, rtol=1e-4,
                                   err_msg=str(path))


# -- the trainer and checkpoints ----------------------------------------------

TRAIN = ["train.num_steps=5", "train.log_interval=1000", "runtime.platform=cpu",
         "optimizer.warmup_steps=2", "checkpoint.save_interval_steps=5",
         "checkpoint.async_save=false"] + SMALL


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX trainer's five tiny-mixtral steps from its own init, saving
    step 5: (its checkpoint directory, the init params as numpy, its
    metrics)."""
    ck = tmp_path_factory.mktemp("ck")
    jtr = JTrainer(j_get_config(PRESET, TRAIN + [f"checkpoint.directory={ck}"]))
    state = jtr.init_state()
    init = _np(state["params"])
    return ck, init, jtr.fit(state=state)


def test_trainer_loss_curve_matches_jax(jax_run):
    """Five steps: step 1's loss to 1e-5, later losses to 1e-4 (AdamW's
    first updates are sign(g) * lr), gradient norms to 1e-4 relative, and
    moe_aux logged each step."""
    _, init, want = jax_run
    cfg = get_config(PRESET, TRAIN)
    got = Trainer(cfg, params=from_jax_params(init, cfg.model), device="cpu").fit()
    assert [m.step for m in got] == [m.step for m in want] == [1, 2, 3, 4, 5]
    assert abs(got[0].loss - want[0].loss) < 1e-5
    for g, w in zip(got, want):
        assert abs(g.loss - w.loss) < 1e-4, (g.step, g.loss, w.loss)
        assert abs(g.grad_norm - w.grad_norm) <= 1e-4 * w.grad_norm
        moe_aux = g.extras["moe_aux"]
        assert moe_aux > 0 and abs(moe_aux - w.extras["moe_aux"]) < 1e-4


def test_checkpoints_cross_restore_bitwise(jax_run, tmp_path):
    """The JAX trainer's step-5 checkpoint restores bitwise in the port's
    trainer (expert banks and router included); the port trains one step
    more and saves, and the JAX trainer restores that bitwise."""
    shutil.copytree(jax_run[0], tmp_path / "ck")
    ov = TRAIN + [f"checkpoint.directory={tmp_path}/ck"]
    cfg = get_config(PRESET, ov)
    tr = Trainer(cfg, device="cpu")
    state, step = tr.restore_or_init()
    assert step == 5
    jtr = JTrainer(j_get_config(PRESET, ov))
    jstate, jstep = jtr.ckpt.restore_latest(jtr.abstract_state())
    assert jstep == 5
    _assert_bitwise(_np(jstate), state_to_tree(state, cfg.model))

    ov6 = [o for o in ov if not o.startswith("train.num_steps")] + ["train.num_steps=6"]
    tr6 = Trainer(get_config(PRESET, ov6), device="cpu")
    tr6.fit()
    jtr6 = JTrainer(j_get_config(PRESET, ov6))
    jstate6, jstep6 = jtr6.ckpt.restore_latest(jtr6.abstract_state())
    assert jstep6 == 6
    _assert_bitwise(_np(jstate6), state_to_tree(tr6.state, cfg.model))
    assert "moe" in jstate6["params"]["blocks"]


def _bits(x):
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (x.view(torch.int16) if x.dtype == torch.bfloat16 else x).numpy().tobytes()
    return np.asarray(x).tobytes()


def _assert_bitwise(tree_a, tree_b):
    leaves_a, leaves_b = jax.tree.leaves(tree_a), jax.tree.leaves(tree_b)
    assert len(leaves_a) == len(leaves_b)
    for a, b in zip(leaves_a, leaves_b):
        assert _bits(a) == _bits(b)


# -- the serving engine --------------------------------------------------------

INFER = ["inference.max_seq_len=128", "inference.page_size=16", "inference.num_pages=32",
         "inference.max_batch_size=4", "inference.prefill_chunk=16",
         "inference.max_new_tokens=8", "inference.prefill_chunk_tokens=16"]
# Unchunked bursts stay in one 16-token bucket: the JAX engine at
# kernels=xla prefills one dispatch per bucket, the port one per burst, and
# a row's capacity follows the padded width it is handed. One burst of as
# many prompts as slots: each JAX engine compiles one prefill program.
PROMPTS = [[5, 3, 9], [250, 17, 4, 8, 100, 42], [7, 8, 9] * 4, [11, 13, 17, 19, 23] * 3]
_rng = np.random.default_rng(0)
SYS = _rng.integers(1, 256, 32).tolist()             # two pages
WAVE1 = [SYS + _rng.integers(1, 256, n).tolist() for n in (16, 21)]
# The second wave hits the system prompt, and its repeat of a page-multiple
# prompt is cached whole (copy-on-write).
WAVE2 = [SYS + _rng.integers(1, 256, 3).tolist(), WAVE1[0]]
DRIVES = {
    "plain": ([], [PROMPTS]),
    "chunked_prefix_int8kv": (["inference.chunked_prefill=true", "inference.prefix_cache=true",
                               "inference.kv_quant=int8"], [WAVE1, WAVE2]),
    # W = 5 verify rows: capacity 3 per expert at E = 4, so rows drop.
    "spec_chain": (["inference.speculative=true", "inference.speculate_tokens=4"],
                   [PROMPTS]),
}


@pytest.fixture(scope="module")
def weights():
    jp = _jax_params()
    return jp, from_jax_params(_np(jp), get_config(PRESET, INFER).model)


@pytest.mark.parametrize("drive", sorted(DRIVES))
def test_engine_streams_match_jax(weights, drive, monkeypatch):
    """Greedy streams equal to the JAX engine's, wave by wave: plain,
    chunked prefill with the prefix cache over an int8 pool (the second
    wave hits), and chain speculation, whose verify rows drop assignments
    (counted through the port's router) while the streams still agree."""
    jp, tp = weights
    ov, waves = DRIVES[drive]
    jeng = JEngine(j_get_config(PRESET, INFER + ov), jp)
    want = [jeng.generate(w, 12) for w in waves]
    dropped = {}
    route = moe.route_indices

    def counting(x, router_w, cfg):
        out = route(x, router_w, cfg)
        S = x.shape[1]
        dropped[S] = dropped.get(S, 0) + int((~out[3]).sum())
        return out

    monkeypatch.setattr(moe, "route_indices", counting)
    eng = InferenceEngine(get_config(PRESET, INFER + ov), tp, device="cpu")
    got = [eng.generate(w, 12) for w in waves]
    assert got == want
    eng.assert_page_accounting()
    if drive == "spec_chain":
        assert eng.spec_stats.verify_steps > 0 and dropped.get(5, 0) > 0, dropped
    if drive == "chunked_prefix_int8kv":
        assert eng.prefix_stats.hits == jeng.prefix_stats.hits > 0
        assert eng.timing["mixed_steps"] == jeng.timing["mixed_steps"]
