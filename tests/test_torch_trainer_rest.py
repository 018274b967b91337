"""The trainer's held-out evaluation, ``memory_report`` and the native
token reader of the port against the JAX package, mirroring
``tests/test_train.py::test_eval_loop`` and ``tests/test_data.py``'s
native-reader tests:

- ``train.eval_interval``: the port's eval losses equal the JAX
  trainer's at the same steps (2e-6), from the same weights; evaluation
  does not perturb training and repeats itself;
- ``Trainer.memory_report``: the state's bytes by category (params, grads
  at the gradient dtype, master, moments) equal the JAX report's byte for
  byte; the update writes every parameter and moment in place, and a
  planted out-of-place update raises the JAX report's RuntimeError;
- ``data/native`` (the port's copy of the C++ reader, built into
  ``orion_tpu_torch/_build``): bytes equal to numpy's and to the JAX
  package's reader, the bounds check, and ``MemmapLoader`` batches equal
  across both readers and to the JAX loader's.
"""

import jax
import numpy as np
import pytest

from orion_tpu.config import get_config as j_get_config
from orion_tpu.data import loader as j_loader
from orion_tpu.train import Trainer as JTrainer
from orion_tpu_torch.config import DataConfig, get_config
from orion_tpu_torch.data import loader
from orion_tpu_torch.data import native
from orion_tpu_torch.models import from_jax_params
from orion_tpu_torch.train import Trainer
from orion_tpu_torch.train import trainer as trainer_mod
from tests import torch_threads  # noqa: F401  (one intra-op thread)

EVAL = ["runtime.platform=cpu", "train.num_steps=6", "optimizer.warmup_steps=2",
        "train.log_interval=1000", "data.batch_size=4", "data.seq_len=32",
        "train.eval_batches=2"]


@pytest.fixture(scope="module")
def eval_runs():
    """(JAX history, port history, port history without eval, port trainer),
    both packages from the JAX trainer's init."""
    cfg_ov = EVAL + ["train.eval_interval=3"]
    jtr = JTrainer(j_get_config("tiny-llama", cfg_ov))
    state = jtr.init_state()
    params = jax.tree.map(np.asarray, state["params"])
    jhist = jtr.fit(state)
    cfg = get_config("tiny-llama", cfg_ov)
    tr = Trainer(cfg, params=from_jax_params(params, cfg.model), device="cpu")
    hist = tr.fit()
    plain_cfg = get_config("tiny-llama", EVAL)
    plain = Trainer(plain_cfg, params=from_jax_params(params, plain_cfg.model),
                    device="cpu").fit()
    return jhist, hist, plain, tr


def test_eval_losses_match_jax(eval_runs):
    jhist, hist, _, _ = eval_runs
    want = {m.step: m.extras.get("eval_loss") for m in jhist}
    got = {m.step: m.extras.get("eval_loss") for m in hist}
    assert [s for s, v in got.items() if v is not None] == [3, 6]
    assert [s for s, v in want.items() if v is not None] == [3, 6]
    for step in (3, 6):
        assert abs(got[step] - float(want[step])) < 2e-6, step


def test_eval_does_not_perturb_training(eval_runs):
    _, hist, plain, tr = eval_runs
    assert [m.loss for m in hist] == [m.loss for m in plain]
    e1, e2 = tr.evaluate(tr.state["params"]), tr.evaluate(tr.state["params"])
    assert e1 == e2 and np.isfinite(e1)


@pytest.mark.parametrize("overrides", [
    [],
    ["train.grad_dtype=bfloat16", "optimizer.moment_dtype=bfloat16"],
])
def test_memory_report_matches_jax(overrides):
    ov = ["runtime.platform=cpu", "data.batch_size=2", "data.seq_len=16",
          "train.num_steps=1"] + overrides
    jrep = JTrainer(j_get_config("tiny-llama", ov)).memory_report(assert_donation=False)
    rep = Trainer(get_config("tiny-llama", ov), device="cpu").memory_report()
    for key in ("params", "grads", "master", "moments"):
        assert rep["by_category"][key] == jrep["by_category"][key], key
    assert rep["donated_state_bytes"] == jrep["donated_state_bytes"]
    assert rep["donated_bytes_per_chip"] == jrep["donated_bytes_per_chip"]
    assert rep["available"] and rep["by_category"]["activations"] > 0
    assert rep["unaliased_donated_leaves"] == 0


def test_memory_report_catches_out_of_place_update(monkeypatch):
    real = trainer_mod.apply_updates

    def out_of_place(params, grads, opt_state, cfg, lr, gnorm=None):
        out = real(params, grads, opt_state, cfg, lr, gnorm=gnorm)
        opt_state["mu"]["final_norm"]["scale"] = opt_state["mu"]["final_norm"]["scale"].clone()
        return out

    monkeypatch.setattr(trainer_mod, "apply_updates", out_of_place)
    tr = Trainer(get_config("tiny-llama", ["data.batch_size=2", "data.seq_len=16"]),
                 device="cpu")
    with pytest.raises(RuntimeError, match="donation leaked a copy"):
        tr.memory_report()
    assert tr.memory_report(assert_donation=False)["unaliased_donated_leaves"] == 1


@pytest.fixture(scope="module")
def token_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("data") / "tokens.u16"
    tokens = np.random.default_rng(0).integers(0, 50000, size=20_000, dtype=np.uint16)
    tokens.tofile(path)
    return str(path), tokens


def test_native_reader_matches_numpy_and_jax(token_file):
    path, tokens = token_file
    j_native = pytest.importorskip("orion_tpu.data.native")
    rdr = native.NativeReader(path, np.uint16)
    assert native.library_path().parent.name == "_build"
    ref = loader._NumpyReader(path, np.dtype(np.uint16))
    jrdr = j_native.NativeReader(path, np.uint16)
    assert len(rdr) == len(ref) == len(jrdr) == len(tokens)
    offs = np.asarray([0, 17, 5000, len(tokens) - 129])
    got = rdr.gather(offs, 129)
    np.testing.assert_array_equal(got, ref.gather(offs, 129))
    np.testing.assert_array_equal(got, jrdr.gather(offs, 129))
    rdr.prefetch(offs, 129)
    with pytest.raises(IndexError):
        rdr.gather(np.asarray([len(tokens) - 10]), 129)
    rdr.close()
    jrdr.close()


@pytest.mark.parametrize("use_native", [True, False])
def test_memmap_loader_agrees_across_readers_and_jax(token_file, use_native):
    path, _ = token_file
    cfg = DataConfig(source="memmap", path=path, batch_size=4, seq_len=64,
                     use_native_loader=use_native)
    ldr = loader.MemmapLoader(cfg, 0, 1, vocab_size=50000)
    assert ldr.reader_kind == ("native" if use_native else "numpy")
    other = loader.MemmapLoader(DataConfig(source="memmap", path=path, batch_size=4,
                                           seq_len=64, use_native_loader=not use_native),
                                0, 1, vocab_size=50000)
    jldr = j_loader.MemmapLoader(j_get_config("tiny", [
        "data.source=memmap", f"data.path={path}", "data.batch_size=4", "data.seq_len=64",
        f"data.use_native_loader={str(use_native).lower()}"]).data, 0, 1, vocab_size=50000)
    for step in (0, 3):
        batch = ldr.batch_at(step)
        for key in batch:
            np.testing.assert_array_equal(batch[key], other.batch_at(step)[key])
            np.testing.assert_array_equal(batch[key], jldr.batch_at(step)[key])


def test_native_reader_fallback_is_logged(token_file, monkeypatch, caplog):
    path, _ = token_file

    def broken(*a, **k):
        raise ImportError("native reader build failed: no compiler")

    monkeypatch.setattr(native, "NativeReader", broken)
    cfg = DataConfig(source="memmap", path=path, batch_size=4, seq_len=64)
    with caplog.at_level("WARNING", logger="orion_tpu_torch.data"):
        ldr = loader.MemmapLoader(cfg, 0, 1, vocab_size=50000)
    assert ldr.reader_kind == "numpy"
    assert "native token reader unavailable" in caplog.text
