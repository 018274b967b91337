"""The port's training path on the CPU (plain PyTorch versions under
autograd) against the JAX package: loss and every parameter gradient,
the schedules and the optimizer update, the data streams, and whole
training runs, from the same weights (carried across by
``from_jax_params``) and the same batches. Float32 throughout; each test
states its tolerance."""

import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orion_tpu.config import get_config as j_get_config
from orion_tpu.data import loader as j_loader
from orion_tpu.models import init_params as j_init_params
from orion_tpu.models.transformer import loss_fn as j_loss_fn
from orion_tpu.train import Trainer as JTrainer
from orion_tpu.train import optimizer as j_opt
from orion_tpu_torch.config import get_config
from orion_tpu_torch.data import loader
from orion_tpu_torch.models import from_jax_params, loss_fn
from orion_tpu_torch.models.convert import tree_leaves_with_path
from orion_tpu_torch.train import Trainer, apply_updates, init_opt_state, make_schedule
from orion_tpu_torch.train.optimizer import global_norm, tree_all_finite

SMALL = ["data.batch_size=2", "data.seq_len=32", "data.packed=true"]


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


@functools.lru_cache(maxsize=None)
def _jax_loss_and_grads(preset, chunked, kernels):
    """(jax cfg, numpy params, numpy batch, loss, aux, numpy grads), once
    per (preset, chunked, kernels)."""
    ov = SMALL + (["model.loss_chunk=16"] if chunked else [])
    jcfg = j_get_config(preset, ov)
    mcfg = dataclasses.replace(jcfg.model, kernels=kernels)
    jp = j_init_params(mcfg, jax.random.key(0))
    batch = dict(j_loader.SyntheticLoader(jcfg.data, 0, 1, mcfg.vocab_size).batch_at(3))
    (loss, aux), grads = jax.jit(
        jax.value_and_grad(j_loss_fn, has_aux=True), static_argnums=2
    )(jp, {k: jnp.asarray(v) for k, v in batch.items()}, mcfg)
    return jcfg, _np_tree(jp), batch, float(loss), _np_tree(aux), _np_tree(grads)


# (b) loss_fn and every parameter gradient. Loss to 2e-6 absolute; grads
# to 2e-6 absolute + 1e-4 relative (two layers of float32 matmuls and the
# attention/softmax backward summed in another order).
@pytest.mark.parametrize("remat", ["none", "full"])
@pytest.mark.parametrize("chunked", [False, True])
@pytest.mark.parametrize("preset", ["tiny-llama", "tiny-gemma2", "tiny"])
def test_loss_and_grads_match_jax(preset, chunked, remat):
    jcfg, jp, batch, jloss, jaux, jgrads = _jax_loss_and_grads(preset, chunked, "xla")
    ov = SMALL + (["model.loss_chunk=16"] if chunked else []) + [f"model.remat={remat}"]
    cfg = get_config(preset, ov)
    params = from_jax_params(jp, cfg.model)
    leaves = [leaf.requires_grad_(True) for _, leaf in tree_leaves_with_path(params)]
    loss, aux = loss_fn(params, {k: _t(v) for k, v in batch.items()}, cfg.model)
    grads = torch.autograd.grad(loss, leaves)
    assert abs(float(loss.detach()) - jloss) < 2e-6
    for key in ("ce_loss", "moe_aux", "tokens"):
        assert abs(float(aux[key].detach()) - float(jaux[key])) < 2e-6, key
    want = from_jax_params(jgrads, cfg.model)
    for (path, w), g in zip(tree_leaves_with_path(want), grads):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=2e-6, rtol=1e-4,
                                   err_msg=str(path))


def test_loss_and_grads_match_jax_pallas_kernels():
    """tiny-llama against the JAX package's Pallas kernels (interpret
    mode): flash attention, RoPE and RMSNorm forward and backward."""
    _, jp, batch, jloss, _, jgrads = _jax_loss_and_grads("tiny-llama", False,
                                                         "pallas_interpret")
    cfg = get_config("tiny-llama", SMALL)
    params = from_jax_params(jp, cfg.model)
    leaves = [leaf.requires_grad_(True) for _, leaf in tree_leaves_with_path(params)]
    loss, _ = loss_fn(params, {k: _t(v) for k, v in batch.items()}, cfg.model)
    grads = torch.autograd.grad(loss, leaves)
    assert abs(float(loss.detach()) - jloss) < 2e-6
    for (path, w), g in zip(tree_leaves_with_path(from_jax_params(jgrads, cfg.model)),
                            grads):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=2e-6, rtol=1e-4,
                                   err_msg=str(path))


# (c) schedules against the JAX package's (optax's) to 1e-6 of the peak
# rate (the same float32 arithmetic, cos from two libraries), and two
# optimizer updates against the JAX ones.
@pytest.mark.parametrize("schedule", ["cosine", "linear", "constant"])
@pytest.mark.parametrize("warmup", [0, 5])
def test_schedule_matches_optax(schedule, warmup):
    ov = [f"optimizer.schedule={schedule}", f"optimizer.warmup_steps={warmup}",
          "optimizer.decay_steps=40"]
    cfg = get_config("tiny-llama", ov).optimizer
    want = j_opt.make_schedule(j_get_config("tiny-llama", ov).optimizer, 50)
    got = make_schedule(cfg, 50)
    for step in range(0, 60):
        w = float(want(jnp.asarray(step, jnp.int32)))
        assert abs(got(step) - w) <= 1e-6 * cfg.learning_rate, (step, got(step), w)


def _opt_tree(rng):
    return {
        "embed": {"tokens": rng.standard_normal((6, 4)).astype(np.float32)},
        "blocks": {"attn_norm": {"scale": rng.standard_normal(4).astype(np.float32)},
                   "mlp": {"w_in": rng.standard_normal((4, 5)).astype(np.float32),
                           "b_in": rng.standard_normal(5).astype(np.float32)}},
    }


@pytest.mark.parametrize("name", ["adamw", "sgd"])
@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_apply_updates_matches_jax(name, moments):
    """Two updates (bias correction at count 1 and 2, clipping, decay
    mask on scale/bias keys); params and moments to 1e-6 absolute + 1e-5
    relative (float32 math in another order; bf16 moments are the same
    float32 values rounded the same way)."""
    ov = [f"optimizer.name={name}", f"optimizer.moment_dtype={moments}",
          "optimizer.grad_clip_norm=2.0"]
    jcfg, cfg = j_get_config("tiny", ov).optimizer, get_config("tiny", ov).optimizer
    rng = np.random.default_rng(20)
    p0 = _opt_tree(rng)
    jp, jst = jax.tree.map(jnp.asarray, p0), j_opt.init_opt_state(jax.tree.map(jnp.asarray, p0), jcfg)
    tp = jax.tree.map(_t, p0)
    tst = init_opt_state(tp, cfg)
    for lr in (1e-2, 3e-3):
        g = _opt_tree(rng)
        jp, jst, jm = j_opt.apply_updates(jp, jax.tree.map(jnp.asarray, g), jst, jcfg,
                                          jnp.float32(lr))
        tg = jax.tree.map(_t, g)
        assert bool(tree_all_finite(tg)) and bool(j_opt.tree_all_finite(g))
        assert abs(float(global_norm(tg)) - float(j_opt.global_norm(g))) < 1e-5
        tp, tst, tm = apply_updates(tp, tg, tst, cfg, lr)
        assert abs(float(tm["grad_norm"]) - float(jm["grad_norm"])) < 1e-5
    g["blocks"]["mlp"]["b_in"][2] = np.nan
    assert not bool(tree_all_finite(jax.tree.map(_t, g)))
    assert tst["count"] == int(jst["count"]) == 2
    for a, b in ((tp, jp), (tst["mu"], jst["mu"]), (tst["nu"], jst["nu"])):
        for x, y in zip(jax.tree.leaves(jax.tree.map(lambda t: t.float().numpy(), a)),
                        jax.tree.leaves(jax.tree.map(lambda t: np.asarray(t, np.float32), b))):
            np.testing.assert_allclose(x, y, atol=1e-6, rtol=1e-5)


# (d) data streams, byte for byte.
@pytest.mark.parametrize("packed", [False, True])
def test_synthetic_loader_matches_jax(packed):
    ov = ["data.batch_size=4", "data.seq_len=64", f"data.packed={packed}",
          "data.pack_carry_group=2", "data.shuffle_seed=7"]
    jl = j_loader.SyntheticLoader(j_get_config("tiny", ov).data, 0, 1, 256)
    tl = loader.SyntheticLoader(get_config("tiny", ov).data, 0, 1, 256)
    for step in (0, 1, 17):
        want, got = jl.batch_at(step), tl.batch_at(step)
        assert sorted(want) == sorted(got)
        for key in want:
            assert want[key].dtype == got[key].dtype
            assert want[key].tobytes() == got[key].tobytes(), (step, key)
    # The cursor: skipping batches shifts the stream, on both sides alike.
    ahead = tl.batch_at(3)
    jl.skip_batches(2)
    tl.skip_batches(2)
    for key, val in tl.batch_at(1).items():
        assert val.tobytes() == jl.batch_at(1)[key].tobytes() == ahead[key].tobytes()


def test_pack_rows_matches_jax():
    rng = np.random.default_rng(21)
    rows = [[rng.integers(0, 50, size=int(n)).astype(np.int32)
             for n in rng.integers(1, 30, size=4)] for _ in range(6)]
    for group in (None, 2):
        want = j_loader.pack_rows(rows, 40, carry_group=group)
        got = loader.pack_rows(rows, 40, carry_group=group)
        for key in want:
            assert want[key].tobytes() == got[key].tobytes(), (group, key)


@pytest.mark.parametrize("packed", [False, True])
def test_memmap_loader_matches_jax(tmp_path, packed):
    path = tmp_path / "tokens.u16"
    toks = np.random.default_rng(22).integers(0, 300, size=5000).astype(np.uint16)
    toks[::37] = 0    # eos separators for the packed path
    toks.tofile(path)
    ov = ["data.source=memmap", f"data.path={path}", "data.batch_size=4",
          "data.seq_len=48", f"data.packed={packed}", "data.use_native_loader=false"]
    jl = j_loader.make_loader(j_get_config("tiny", ov).data, 300)
    tl = loader.make_loader(get_config("tiny", ov).data, 300)
    for step in (0, 5):
        want, got = jl.batch_at(step), tl.batch_at(step)
        assert sorted(want) == sorted(got)
        for key in want:
            assert want[key].tobytes() == got[key].tobytes(), (step, key)


# (e) whole runs: the port's Trainer against orion_tpu.train.Trainer.
@pytest.mark.parametrize("accum", [1, 2])
def test_trainer_loss_curve_matches_jax(accum):
    """Five tiny-llama steps from the JAX trainer's own init. Step 1's
    loss (before any update) to 1e-5; later steps to 1e-4: AdamW's first
    updates are sign(g) * lr, so a gradient element that is ~0 and
    differs in sign between the two float32 sums moves its parameter by
    2 lr (1e-3 here) in opposite directions. Gradient norms to 1e-4
    relative."""
    ov = ["train.num_steps=5", "train.log_interval=1000", "runtime.platform=cpu",
          f"train.grad_accum={accum}", "data.packed=true", "optimizer.warmup_steps=2"]
    jtr = JTrainer(j_get_config("tiny-llama", ov))
    state = jtr.init_state()
    cfg = get_config("tiny-llama", ov)
    params = from_jax_params(_np_tree(state["params"]), cfg.model)
    want = jtr.fit(state=state)
    got = Trainer(cfg, params=params, device="cpu").fit()
    assert [m.step for m in got] == [m.step for m in want] == [1, 2, 3, 4, 5]
    assert abs(got[0].loss - want[0].loss) < 1e-5
    for g, w in zip(got, want):
        assert abs(g.loss - w.loss) < 1e-4, (g.step, g.loss, w.loss)
        assert abs(g.grad_norm - w.grad_norm) <= 1e-4 * w.grad_norm
        assert abs(g.learning_rate - w.learning_rate) <= 1e-9


def test_trainer_grad_dtype_matches_jax():
    """train.grad_dtype=bfloat16: gradients taken against a bf16 copy of
    the master weights, on both sides. Losses to 1e-3: the float32
    gradient sums round to bf16, and a sum that lands near a rounding
    boundary rounds to the neighbouring bf16 value on one side."""
    ov = ["train.num_steps=3", "train.log_interval=1000", "runtime.platform=cpu",
          "train.grad_dtype=bfloat16", "optimizer.warmup_steps=1"] + SMALL
    jtr = JTrainer(j_get_config("tiny-llama", ov))
    state = jtr.init_state()
    cfg = get_config("tiny-llama", ov)
    params = from_jax_params(_np_tree(state["params"]), cfg.model)
    want = [m.loss for m in jtr.fit(state=state)]
    got = [m.loss for m in Trainer(cfg, params=params, device="cpu").fit()]
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)


# (f) the command line.
def test_train_cli_runs_on_cpu(capsys):
    from orion_tpu_torch.train.__main__ import main

    assert main(["--preset", "tiny-llama", "--device", "cpu", "--seed", "3",
                 "train.num_steps=3", "train.log_interval=1"] + SMALL) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert len([line for line in out if line.startswith("step ")]) == 3
    assert out[-1].startswith("done: 3 steps, final loss ")


def test_train_cli_print_config_and_presets(capsys):
    from orion_tpu_torch.train.__main__ import main

    assert main(["--preset", "llama-1b-bench", "--print-config"]) == 0
    cfg = json.loads(capsys.readouterr().out)
    assert cfg["model"]["d_model"] == 2048 and cfg["model"]["remat"] == "full"
    assert main(["--list-presets"]) == 0
    assert "llama-1b-bench" in capsys.readouterr().out.split()


def test_train_without_gpu_raises_unless_cpu_requested(monkeypatch):
    from orion_tpu_torch.train.__main__ import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["--preset", "tiny-llama", "train.num_steps=1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(get_config("tiny-llama"))
    assert Trainer(get_config("tiny-llama"), device="cpu").device.type == "cpu"


# (h) every trainer knob that is not ported raises; the fault-tolerance
# knobs (tests/test_torch_train_fault.py) build a trainer.
@pytest.mark.parametrize("override", [
    "checkpoint.directory={tmp}/ckpt", "train.anomaly_guard=true",
    "train.inject_fault_at_step=2", "train.max_restarts=1", "train.watchdog_timeout_s=30",
])
def test_ported_fault_knobs_build_a_trainer(override, tmp_path):
    tr = Trainer(get_config("tiny-llama", [override.format(tmp=tmp_path)]), device="cpu")
    assert (tr.ckpt is not None) == override.startswith("checkpoint.directory")


@pytest.mark.parametrize("override", [
    "train.zero1=true", "train.grad_quant_bits=8", "train.eval_interval=5",
    "parallel.dp=2", "parallel.tp=2", "model.remat=dots",
    "model.remat=names", "train.remat=names", "model.n_experts=4",
    "model.weight_quant=int8", "runtime.checkify=true",
    "runtime.debug_nans=true", "runtime.deterministic=true",
    "runtime.num_processes=2;runtime.coordinator_address=localhost:1234",
])
def test_unported_trainer_knobs_raise(override):
    with pytest.raises(NotImplementedError, match="not ported"):
        Trainer(get_config("tiny-llama", override.split(";")), device="cpu")


def test_loss_fn_rejects_unported_remat():
    cfg = get_config("tiny-llama", ["model.remat=dots"])
    params = from_jax_params(_np_tree(j_init_params(j_get_config("tiny-llama").model,
                                                    jax.random.key(0))), cfg.model)
    batch = {"inputs": torch.zeros(1, 4, dtype=torch.int32),
             "targets": torch.zeros(1, 4, dtype=torch.int32)}
    with pytest.raises(NotImplementedError, match="not ported"):
        loss_fn(params, batch, cfg.model)
