"""The port's trainer under sequence parallelism on the CPU against the JAX
trainer at the same sp.

Counterparts of ``tests/test_sequence.py::test_trainer_swa_sp_equivalence``
(tiny-llama, model.sliding_window=24), ``::test_trainer_gemma2_sp_equivalence``
(tiny-gemma2: per-layer windows through the ring, softcaps) and one
``ring_striped`` run: the port's ``Trainer`` at ``parallel.sp=2`` in two
gloo rank processes (``tests/torch_sp_worker.py``, one spawn for all
three runs; the ranks join through ``runtime.coordinator_address`` with a
``file://`` store) from the JAX trainer's own init, against the JAX
trainer at sp=2 on the fake devices of ``conftest.py``, step for step to
rtol 2e-4 (the JAX tests' tolerance); the parameters bitwise equal across
the ranks after the steps. Then the refusals: any other axis above 1
beside sp, and checkpoints and fault injection at sp > 1.
"""

import jax
import numpy as np
import pytest

from orion_tpu.config import get_config as j_get_config
from orion_tpu.train import Trainer as JTrainer
from orion_tpu_torch.config import get_config
from orion_tpu_torch.train import Trainer
from tests import torch_sp_worker as W
from tests import torch_threads  # noqa: F401  (one intra-op thread)

SP = 2
BASE = ["runtime.platform=cpu", "data.batch_size=4", "data.seq_len=64",
        "train.log_interval=100", "optimizer.warmup_steps=1"]
RUNS = {
    "swa": ("tiny-llama", 3, ["model.sliding_window=24"]),
    "gemma2": ("tiny-gemma2", 2, []),
    "striped": ("tiny-llama", 3, ["parallel.sequence_method=ring_striped"]),
}


def _overrides(name):
    preset, steps, extra = RUNS[name]
    return preset, BASE + [f"train.num_steps={steps}"] + extra


@pytest.fixture(scope="module")
def runs(tmp_path_factory, cpu_devices):
    """(JAX losses, port results by rank) per run: the JAX trainers' inits
    go to the rank processes, which train while the JAX trainers do."""
    jax_trainers, cases = {}, []
    for name in RUNS:
        preset, ov = _overrides(name)
        jtr = JTrainer(j_get_config(preset, ov + [f"parallel.sp={SP}"]))
        state = jtr.init_state()
        jax_trainers[name] = (jtr, state)
        cases.append({"id": name, "preset": preset, "overrides": ov,
                      "params": jax.tree.map(np.asarray, state["params"])})
    tmp = tmp_path_factory.mktemp("train_sp")
    ctx = W.spawn("train", SP, {"cases": cases}, tmp)
    want = {}
    for name, (jtr, state) in jax_trainers.items():
        losses = []
        for step in range(RUNS[name][1]):
            state, m = jtr.train_step(state, jtr.global_batch(step))
            losses.append(float(jax.device_get(m["loss"])))
        want[name] = losses
    return want, W.collect(ctx, SP, tmp)


@pytest.mark.parametrize("name", sorted(RUNS))
def test_trainer_sp_matches_jax_trainer(runs, name):
    want, ranks = runs
    assert not any(r["jax_imported"] for r in ranks)
    got = [r[name] for r in ranks]
    assert [g["sp_rank"] for g in got] == list(range(SP))
    np.testing.assert_allclose(got[0]["losses"], want[name], rtol=2e-4)
    # Every rank logs the same global losses and applies the same update.
    assert all(g["losses"] == got[0]["losses"] for g in got)
    assert all(g["grad_norms"] == got[0]["grad_norms"] for g in got)
    assert len({g["params_sha256"] for g in got}) == 1


# Parts that run beside sp: each builds its trainer in rank processes (four
# for the dp and fsdp meshes, two else) and takes a first step.
LIFTED = {"parallel.dp=2": 4, "parallel.fsdp=2": 4, "checkpoint.directory={tmp}/ckpt": 2,
          "train.inject_fault_at_step=1": 2, "train.anomaly_guard=true": 2}


@pytest.fixture(scope="module")
def lifted(tmp_path_factory):
    """The first-step loss of every rank of each lifted configuration."""
    from tests import torch_dp_worker as D

    out, ctxs = {}, []
    for world in (4, 2):
        tmp = tmp_path_factory.mktemp(f"lifted{world}")
        cases = [{"id": o, "preset": "tiny-llama", "params": None, "first_step": True,
                  "overrides": ["parallel.sp=2", o.format(tmp=tmp)]}
                 for o, w in LIFTED.items() if w == world]
        ctxs.append((world, tmp, D.spawn(world, cases, tmp)))
    for world, tmp, ctx in ctxs:
        for r in D.collect(ctx, world, tmp):
            assert not r.pop("jax_imported")
            for o, row in r.items():
                out.setdefault(o, []).append(row["first_loss"])
    return out


@pytest.mark.parametrize("override", [
    "parallel.dp=2", "parallel.fsdp=2", "parallel.tp=2", "parallel.pp=2", "parallel.ep=2",
    "checkpoint.directory={tmp}/ckpt", "train.inject_fault_at_step=1",
    "train.anomaly_guard=true", "train.grad_quant_bits=8",
])
def test_sp_with_unported_parts_raises(override, tmp_path, request):
    """The refusals are checked at construction, before any process group
    is joined; a lifted part's ranks take a first step with one finite
    loss, the same on every rank."""
    if override in LIFTED:
        losses = request.getfixturevalue("lifted")[override]
        assert len(losses) == LIFTED[override] and np.isfinite(losses[0])
        assert all(x == losses[0] for x in losses)
        return
    cfg = get_config("tiny-llama", ["parallel.sp=2", override.format(tmp=tmp_path)])
    with pytest.raises(NotImplementedError, match="not ported"):
        Trainer(cfg, device="cpu")


def test_sp_validates_as_the_jax_trainer():
    with pytest.raises(ValueError, match="divisible by parallel.sp"):
        Trainer(get_config("tiny-llama", ["parallel.sp=3"]), device="cpu")
    with pytest.raises(ValueError, match="ulysses needs"):
        Trainer(get_config("tiny-llama", ["parallel.sp=8", "data.seq_len=64",
                                          "parallel.sequence_method=ulysses",
                                          "model.n_heads=4", "model.n_kv_heads=2"]),
                device="cpu")
