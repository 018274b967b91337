"""The port's trainer over a dp x fsdp (x sp) mesh on the CPU against the
JAX trainer at the same mesh.

The port's ``Trainer`` runs in gloo rank processes (``tests/torch_dp_worker.py``,
one spawn of two ranks and one of four; the ranks join through
``runtime.coordinator_address`` with a ``file://`` store) from the JAX
trainer's own init, while the JAX trainers run the same configurations on
the fake devices of ``conftest.py``. Held: the losses step for step to rtol
2e-4 (``tests/test_torch_train_sp.py``'s tolerance), the final parameters
put back together from the ranks' blocks to 2e-6 + 1e-4 relative, every
rank logging the same losses, replicas of a block equal byte for byte,
each rank holding 1/fsdp of its fsdp leaves and 1/dp of its ZeRO-1
moments, and ZeRO-1 equal to the port's own run without it byte for byte
(``tests/test_zero1.py::test_zero1_losses_and_state_bitwise_vs_dp_baseline``
and ``::test_zero1_fsdp_composition_bitwise``).

The master split runs twice. With bf16 masters beside float32 compute
(``model.param_dtype=bfloat16``) both packages compute in float32, so the
final masters hold to JAX's like any parameters, and the working copy
equals the masters cast on every rank. With the usual mixed precision
(float32 masters, bf16 compute) the two packages' bf16 products round
differently, and AdamW turns gradients that change sign under that into
whole steps of the learning rate; there the losses hold to JAX's, and
the masters equal byte for byte the port's plain dp run that takes its
gradients against the same bf16 copy (``train.grad_dtype=bfloat16``).
Then ``memory_report`` per rank against the JAX report (with the
float32-master, bf16-compute split too), and the JAX trainer's
validations and the refusals of the parts still to come.
"""

import json

import jax
import numpy as np
import pytest
import torch

from orion_tpu.config import get_config as j_get_config
from orion_tpu.train import Trainer as JTrainer
from orion_tpu_torch.config import get_config
from orion_tpu_torch.models import from_jax_params
from orion_tpu_torch.models.convert import tree_leaves_with_path, unshard_params
from orion_tpu_torch.parallel.sharding import layout_at, param_layout
from orion_tpu_torch.train import Trainer
from tests import torch_dp_worker as W
from tests import torch_threads  # noqa: F401  (one intra-op thread)

BASE = ["runtime.platform=cpu", "data.batch_size=4", "data.seq_len=64",
        "train.log_interval=100", "optimizer.warmup_steps=1", "train.num_steps=3"]
# The master split with bf16 masters beside a float32 compute dtype, so the
# two packages compute in float32 and only the masters round to bf16.
SPLIT = ["parallel.dp=2", "train.zero1=true", "model.param_dtype=bfloat16"]
# ... and with the usual mixed precision (bf16 compute, float32 masters).
SPLIT_BF16 = ["parallel.dp=2", "train.zero1=true", "model.dtype=bfloat16"]
# id -> (preset, overrides, world)
RUNS = {
    "dp2": ("tiny-llama", ["parallel.dp=2"], 2),
    "fsdp2": ("tiny-llama", ["parallel.fsdp=2", "train.eval_interval=3",
                             "train.eval_batches=2"], 2),
    "dp2_zero1": ("tiny-llama", ["parallel.dp=2", "train.zero1=true"], 2),
    "dp2_zero1_split": ("tiny-llama", SPLIT, 2),
    "dp2_zero1_split_bf16": ("tiny-llama", SPLIT_BF16, 2),
    "dp2_bf16_grads": ("tiny-llama", ["parallel.dp=2", "model.dtype=bfloat16",
                                      "train.grad_dtype=bfloat16"], 2),
    "fsdp2_accum_mask": ("tiny-llama", ["parallel.fsdp=2", "train.grad_accum=2",
                                        "data.packed=true"], 2),
    "fsdp2_gemma2": ("tiny-gemma2", ["parallel.fsdp=2"], 2),
    "fsdp2_gpt2": ("tiny", ["parallel.fsdp=2"], 2),
    "dp2_fsdp2": ("tiny-llama", ["parallel.dp=2", "parallel.fsdp=2"], 4),
    "dp2_fsdp2_zero1": ("tiny-llama", ["parallel.dp=2", "parallel.fsdp=2",
                                       "train.zero1=true"], 4),
    "fsdp2_sp2": ("tiny-llama", ["parallel.fsdp=2", "parallel.sp=2"], 4),
}
# ZeRO-1 run -> the same mesh without it.
ZERO1_BASELINE = {"dp2_zero1": "dp2", "dp2_fsdp2_zero1": "dp2_fsdp2",
                  "dp2_zero1_split_bf16": "dp2_bf16_grads"}
SPLIT_RUNS = ("dp2_zero1_split",)
CKPT = ["checkpoint.save_interval_steps=3"]
# Runs whose parameters are held by their losses only (see the module note).
BF16_COMPUTE = ("dp2_zero1_split_bf16", "dp2_bf16_grads")


def _np(tree):
    return jax.tree.map(lambda x: np.asarray(jax.device_get(x)), tree)


def _working_copy(state):
    """The master split's working copy as the masters cast to its dtype.
    The JAX trainer's jitted init casts the bf16 masters up to float32
    where XLA folds the bf16 -> float32 round trip away, so its first
    working copy holds the unrounded init values; every later one is the
    masters cast, as the port's always is."""
    return jax.tree.map(lambda m, p: jax.device_put(m.astype(p.dtype), p.sharding),
                        state["opt"]["master"], state["params"])


def _cfg(name):
    preset, extra, _ = RUNS[name]
    return get_config(preset, BASE + extra)


@pytest.fixture(scope="module")
def runs(tmp_path_factory, cpu_devices):
    """(JAX losses and final state, port results by rank) per run: the JAX
    inits go to the rank processes, which train while the JAX trainers do."""
    cases = {2: [], 4: []}
    jax_trainers = {}
    for name, (preset, extra, world) in RUNS.items():
        jtr = JTrainer(j_get_config(preset, BASE + extra))
        state = jtr.init_state()
        if name in SPLIT_RUNS:
            state = dict(state, params=_working_copy(state))
        init = _np(state["opt"]["master"] if "master" in state["opt"] else state["params"])
        jax_trainers[name] = (jtr, state)
        cases[world].append({"id": name, "preset": preset, "overrides": BASE + extra,
                             "params": init})
    for name, extra in (("dp2_zero1_memory", RUNS["dp2_zero1"][1]),
                        ("dp2_memory", ["parallel.dp=2"]),
                        ("split_memory", SPLIT_BF16)):
        cases[2].append({"id": name, "preset": "tiny-llama", "overrides": BASE + extra,
                         "params": None, "memory": True})
    for name, extra in (("fsdp2_checkify", ["parallel.fsdp=2", "runtime.checkify=true"]),
                        ("dp2_zero1_checkify", ["parallel.dp=2", "train.zero1=true",
                                                "runtime.checkify=true"])):
        cases[2].append({"id": name, "preset": "tiny-llama", "overrides": BASE + extra,
                         "params": None, "first_step": True})
    # A checkpoint of ZeRO-1 beside fsdp (the norm scales ZeRO-1 splits by
    # layer): saved at the last step, restored at dp = 1 and in JAX.
    ckpt_dir = str(tmp_path_factory.mktemp("ckpt_dp2_fsdp2_zero1"))
    cases[4].append({"id": "dp2_fsdp2_zero1_ckpt", "preset": "tiny-llama",
                     "overrides": BASE + RUNS["dp2_fsdp2_zero1"][1] + CKPT + [
                         f"checkpoint.directory={ckpt_dir}"], "params": None})
    ctxs = {}
    for world in (2, 4):
        tmp = tmp_path_factory.mktemp(f"train_dp{world}")
        ctxs[world] = (W.spawn(world, cases[world], tmp), tmp)
    want = {}
    for name, (jtr, state) in jax_trainers.items():
        losses = []
        for step in range(jtr.cfg.train.num_steps):
            state, m = jtr.train_step(state, jtr.global_batch(step))
            losses.append(float(jax.device_get(m["loss"])))
        want[name] = (losses, _np(state))
        if jtr.cfg.train.eval_interval:
            want[name + "_eval"] = jtr.evaluate(state["params"])
    for name, extra in (("dp2_zero1", RUNS["dp2_zero1"][1]), ("split_bf16", SPLIT_BF16)):
        want[name + "_report"] = JTrainer(j_get_config(
            "tiny-llama", BASE + extra)).memory_report(assert_donation=False)
    want["ckpt_dir"] = ckpt_dir
    got = {world: W.collect(ctx, world, tmp) for world, (ctx, tmp) in ctxs.items()}
    return want, got


def _ranks(runs, name):
    world = RUNS[name][2]
    return [r[name] for r in runs[1][world]]


def _whole(name, ranks, part="params"):
    """The ranks' blocks of ``part`` put back together (per-layer tree)."""
    cfg = _cfg(name)
    sizes = dict(cfg.parallel.axis_sizes)
    layout = param_layout(cfg.model, sizes, cfg.train.zero1)
    return unshard_params([r["state"][part] for r in ranks], layout, sizes,
                          [r["coords"] for r in ranks], state=part != "params")


def _bits(t):
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy().tobytes()


@pytest.mark.parametrize("name", sorted(RUNS))
def test_trainer_matches_jax_trainer(runs, name):
    want, got = runs
    ranks = _ranks(runs, name)
    assert not any(r["jax_imported"] for r in got[RUNS[name][2]])
    losses, jstate = want[name]
    np.testing.assert_allclose(ranks[0]["losses"], losses, rtol=2e-4)
    assert all(r["losses"] == ranks[0]["losses"] for r in ranks)
    assert all(r["grad_norms"] == ranks[0]["grad_norms"] for r in ranks)
    cfg = _cfg(name)
    if "master" in ranks[0]["state"]:
        # The working copy is the masters cast to model.dtype on every rank.
        port = dict(tree_leaves_with_path(_whole(name, ranks, "master")))
        for r in ranks:
            for path, t in tree_leaves_with_path(r["state"]["params"]):
                assert torch.equal(t, port[path].to(t.dtype)), path
        jtree = jstate["opt"]["master"]
    else:
        port = dict(tree_leaves_with_path(_whole(name, ranks)))
        jtree = jstate["params"]
    if name in BF16_COMPUTE:
        return
    for path, w in tree_leaves_with_path(from_jax_params(jtree, cfg.model)):
        np.testing.assert_allclose(port[path].float().numpy(), w.float().numpy(),
                                   rtol=1e-4, atol=2e-6, err_msg=str(path))


@pytest.mark.parametrize("name", sorted(RUNS))
def test_ranks_hold_their_blocks(runs, name):
    """Each rank holds 1/fsdp of every leaf fsdp cuts (1/dp more of its
    moments under ZeRO-1), and every replica of a block is the same bytes."""
    ranks = _ranks(runs, name)
    cfg = _cfg(name)
    p = cfg.parallel
    layout = param_layout(cfg.model, dict(p.axis_sizes), cfg.train.zero1)
    whole = dict(tree_leaves_with_path(_whole(name, ranks)))
    for part in ("params", "mu"):
        by_block = {}
        for r in ranks:
            for path, t in tree_leaves_with_path(r["state"][part]):
                lay = layout_at(layout, path)
                n = p.fsdp if lay.fsdp_dim is not None else 1
                if part == "mu" and cfg.train.zero1 and lay.zero1_dim >= 0:
                    n *= p.dp
                assert t.numel() * n == whole[path].numel(), (part, path)
                key = (path, r["coords"]["fsdp"],
                       r["coords"]["dp"] if part == "mu" and cfg.train.zero1 else 0)
                by_block.setdefault(key, set()).add(_bits(t))
        assert all(len(v) == 1 for v in by_block.values()), part


def test_eval_matches_jax_trainer(runs):
    """``train.eval_interval`` at fsdp = 2: the held-out CE (gathers, the
    CE summed over the ranks) at the end of the fit, against the JAX
    trainer's ``evaluate`` of its final state."""
    ranks = _ranks(runs, "fsdp2")
    got = [r["eval_loss"] for r in ranks]
    assert got[0] is not None and all(g == got[0] for g in got)
    np.testing.assert_allclose(got[0], runs[0]["fsdp2_eval"], rtol=2e-4)


@pytest.mark.parametrize("name", ["fsdp2_checkify", "dp2_zero1_checkify"])
def test_checkify_steps_on_a_mesh(runs, name):
    """``runtime.checkify`` composes with dp, fsdp and ZeRO-1, as in the
    JAX trainer (its refusal is for manual shard_map regions only): a
    clean checked step's loss, the same on every rank."""
    losses = [r[name]["first_loss"] for r in runs[1][2]]
    assert np.isfinite(losses[0]) and losses == [losses[0]] * 2


@pytest.mark.parametrize("name", sorted(ZERO1_BASELINE))
def test_zero1_bitwise_vs_the_same_mesh_without_it(runs, name):
    z, b = _ranks(runs, name), _ranks(runs, ZERO1_BASELINE[name])
    assert z[0]["losses"] == b[0]["losses"]
    assert z[0]["grad_norms"] == b[0]["grad_norms"]
    # Under the master split the masters are the baseline's parameters.
    parts = {"mu": "mu", "nu": "nu",
             "master" if "master" in z[0]["state"] else "params": "params"}
    for part, base in parts.items():
        zt = tree_leaves_with_path(_whole(name, z, part))
        bt = dict(tree_leaves_with_path(_whole(ZERO1_BASELINE[name], b, base)))
        for path, t in zt:
            assert _bits(t) == _bits(bt[path]), (part, path)


def test_zero1_fsdp_checkpoint_restores_at_dp1_and_in_jax(runs):
    """The dp = 2 x fsdp = 2 ZeRO-1 checkpoint: each rank saves the blocks
    JAX's ``NamedSharding`` places (the norm scales by layer, as ZeRO-1
    shards them, though every dp rank updates them whole), and the state
    restores bit for bit in one process at dp = 1 and in the JAX trainer
    at the saving layout."""
    ckpt_dir = runs[0]["ckpt_dir"]
    ranks = [r["dp2_fsdp2_zero1_ckpt"] for r in runs[1][4]]
    cfg = get_config("tiny-llama", BASE + RUNS["dp2_fsdp2_zero1"][1])
    sizes = dict(cfg.parallel.axis_sizes)
    layout = param_layout(cfg.model, sizes, True)
    coords = [r["coords"] for r in ranks]
    saved = {part: dict(tree_leaves_with_path(unshard_params(
        [r["state"][part] for r in ranks], layout, sizes, coords, state=part != "params")))
        for part in ("params", "mu", "nu")}

    def held(tree):
        for part in ("params", "mu", "nu"):
            sub = tree["params"] if part == "params" else tree["opt"][part]
            for path, t in tree_leaves_with_path(sub):
                assert _bits(t) == _bits(saved[part][path]), (part, path)

    one = get_config("tiny-llama", BASE + CKPT + [f"checkpoint.directory={ckpt_dir}"])
    state, step = Trainer(one, device="cpu").restore_or_init()
    assert step == 3
    held(state)
    jtr = JTrainer(j_get_config("tiny-llama", BASE + RUNS["dp2_fsdp2_zero1"][1] + CKPT
                                + [f"checkpoint.directory={ckpt_dir}"]))
    jstate, step = jtr.ckpt.restore_latest(jtr.abstract_state())
    assert step == 3
    held({"params": from_jax_params(_np(jstate["params"]), cfg.model),
          "opt": {k: from_jax_params(_np(jstate["opt"][k]), cfg.model) for k in ("mu", "nu")}})
    with open(f"{ckpt_dir}/step_{step:08d}/manifest.json") as f:
        leaves = json.load(f)["leaves"]
    for p, leaf in jax.tree_util.tree_flatten_with_path(jstate)[0]:
        entry = leaves[jax.tree_util.keystr(p)]
        if entry["sharding"] and any(entry["sharding"]):
            blocks = sorted([[list(s.index[d].indices(n)[:2]) for d, n in enumerate(leaf.shape)]
                             for s in leaf.addressable_shards if s.replica_id == 0])
            assert blocks == sorted(s["index"] for s in entry["shards"]), p


@pytest.mark.parametrize("name", ["dp2_zero1", "split_bf16"])
def test_memory_report_per_rank_matches_jax(runs, name):
    """One rank's bytes by category equal the JAX report's per-chip bytes;
    ZeRO-1's moments (and the split's master) are 1/dp of the whole."""
    want = runs[0][name + "_report"]["by_category"]
    memory = "dp2_zero1_memory" if name == "dp2_zero1" else "split_memory"
    for r in runs[1][2]:
        got = r[memory]["memory"]["by_category"]
        for key in ("params", "grads", "master", "moments"):
            assert got[key] == want[key], (name, key)
    full = runs[1][2][0]["dp2_memory"]["memory"]["by_category"]
    got = runs[1][2][0][memory]["memory"]["by_category"]
    assert got["moments"] * 2 == full["moments"]
    if name == "dp2_zero1":
        assert got["master"] == 0 and got["params"] == full["params"]
    else:
        assert got["master"] * 2 == full["params"]          # f32 masters, 1/dp
        assert got["params"] * 2 == full["params"]          # the bf16 working copy


# The JAX trainer's own validations: the same ValueError text from both.
@pytest.mark.parametrize("overrides", [
    ["train.zero1=true"],
    ["train.zero1=true", "parallel.dp=2", "train.grad_quant_bits=8"],
    ["train.zero1_quantize=int8"],
    ["train.zero1=true", "parallel.dp=2", "parallel.fsdp=2", "train.zero1_quantize=int8"],
    ["parallel.dp=3"],
    ["parallel.fsdp=2", "train.grad_accum=4"],
])
def test_validations_match_the_jax_trainer(overrides):
    ov = ["runtime.platform=cpu", "data.batch_size=4"] + overrides
    with pytest.raises(ValueError) as jerr:
        JTrainer(j_get_config("tiny-llama", ov))
    with pytest.raises(ValueError) as perr:
        Trainer(get_config("tiny-llama", ov), device="cpu")
    assert str(perr.value) == str(jerr.value)


# What stays refused, each naming its mode, at construction (before any
# process group is joined).
@pytest.mark.parametrize("preset,overrides,match", [
    ("tiny-llama", ["parallel.tp=2"], "tensor parallelism"),
    ("tiny-llama", ["parallel.pp=2"], "pipeline parallelism"),
    ("tiny-llama", ["parallel.ep=2"], "expert parallelism"),
    ("tiny-llama", ["parallel.dp=2", "parallel.tp=2"], "parallel.tp=2"),
    ("tiny-llama", ["parallel.dp=2", "train.grad_quant_bits=8"], "grad_quant_bits"),
    ("tiny-llama", ["parallel.dp=2", "train.zero1=true", "train.zero1_quantize=int8"],
     "zero1_quantize"),
    ("tiny-mixtral", ["parallel.dp=2"], "MoE"),
    ("tiny-mixtral", ["parallel.fsdp=2"], "MoE"),
    ("tiny-mixtral", ["parallel.sp=2"], "MoE"),
])
def test_unported_modes_raise(preset, overrides, match):
    with pytest.raises(NotImplementedError, match=match):
        Trainer(get_config(preset, ["data.batch_size=4"] + overrides), device="cpu")
