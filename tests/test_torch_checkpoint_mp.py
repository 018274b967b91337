"""Multi-process checkpoints and the training fault stack across ranks, on
the CPU, against the JAX package.

The port's ``Trainer`` runs in two gloo rank processes
(``tests/torch_dp_worker.py``, one spawn for every case). Held:

- a checkpoint saved at fsdp = 2 restores in one process, and one saved
  at dp = 2 with ZeRO-1 restores at dp = 1
  (``tests/test_zero1.py::test_zero1_ckpt_saves_sharded_and_restores_across_dp``),
  and the fsdp = 2 one in dp = 2 ZeRO-1 ranks: the restored state equals
  the saved state (put back together from the ranks' blocks) bit for bit;
- a JAX checkpoint at fsdp = 2 restores in the port's fsdp = 2 ranks, and
  the port's in the JAX trainer, bit for bit; the two manifests hold the
  same leaves, shapes, dtypes and sharding records, and the port's shard
  indices are exactly the blocks JAX's ``NamedSharding`` places (the
  ``addressable_shards`` of replica 0), only the file names differing;
- the anomaly guard at dp = 2, with a NaN in one rank's gradient only:
  every rank skips that step and the parameters stay equal across ranks;
  the ZeRO-1 run equals the plain dp = 2 guarded run byte for byte, with
  and without the NaN
  (``tests/test_zero1.py::test_zero1_guard_bitwise_and_nan_skip``);
- ``inject_fault_at_step`` at dp = 2 with ZeRO-1, and a preemption flag
  raised on one rank only: every rank saves, stops and resumes at the
  same step, and the resumed run ends bit for bit
  where the uninterrupted one does; an anomaly rollback moves every rank
  back together; a checkpoint file torn on one rank makes every rank
  quarantine that step and restore the one before.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from orion_tpu.config import get_config as j_get_config
from orion_tpu.train import Trainer as JTrainer
from orion_tpu_torch.ckpt import CheckpointManager
from orion_tpu_torch.config import get_config
from orion_tpu_torch.models.convert import tree_leaves_with_path, unshard_params
from orion_tpu_torch.parallel.sharding import param_layout
from orion_tpu_torch.train import Trainer
from orion_tpu_torch.train.trainer import abstract_train_state, state_to_tree
from tests import torch_dp_worker as W
from tests import torch_threads  # noqa: F401  (one intra-op thread)

BASE = ["runtime.platform=cpu", "data.batch_size=4", "data.seq_len=64",
        "train.log_interval=100", "optimizer.warmup_steps=1"]
GUARD = ["parallel.dp=2", "train.num_steps=4", "train.anomaly_guard=true",
         "train.anomaly_limit=5"]
ZERO1 = ["parallel.dp=2", "train.zero1=true"]


def _ck(d, every=2):
    return [f"checkpoint.directory={d}", f"checkpoint.save_interval_steps={every}"]


def _np(tree):
    return jax.tree.map(lambda x: np.asarray(jax.device_get(x)), tree)


def _bits(x):
    if isinstance(x, torch.Tensor):
        x = (x.view(torch.int16) if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x).tobytes()


@pytest.fixture(scope="module")
def runs(tmp_path_factory, cpu_devices):
    tmp = tmp_path_factory.mktemp("ckpt_mp")
    d = {k: str(tmp / k) for k in ("A", "B", "C", "D", "E", "F", "G")}
    # The JAX trainer at fsdp = 2 writes C before the ranks start.
    JTrainer(j_get_config("tiny-llama", BASE + ["parallel.fsdp=2", "train.num_steps=2"]
                          + _ck(d["C"]))).fit()

    def case(cid, extra, **kw):
        return dict(id=cid, preset="tiny-llama", overrides=BASE + extra, params=None, **kw)

    cases = [
        case("save_fsdp2", ["parallel.fsdp=2", "train.num_steps=2"] + _ck(d["A"])),
        case("save_zero1", ZERO1 + ["train.num_steps=2"] + _ck(d["B"])),
        case("zero1_from_fsdp2", ZERO1 + ["train.num_steps=2"] + _ck(d["A"]),
             restore_only=True),
        case("fsdp2_from_jax", ["parallel.fsdp=2", "train.num_steps=2"] + _ck(d["C"]),
             restore_only=True),
        case("guard", GUARD),
        case("guard_zero1", GUARD + ["train.zero1=true"]),
        case("guard_nan", GUARD, nan_at=(1, 1)),
        case("guard_zero1_nan", GUARD + ["train.zero1=true"], nan_at=(1, 1)),
        case("zero1_4", ZERO1 + ["train.num_steps=4"]),
        case("zero1_inject", ZERO1 + ["train.num_steps=4", "train.inject_fault_at_step=2"]
             + _ck(d["D"], 1), resume=True),
        case("zero1_preempt", ZERO1 + ["train.num_steps=4"] + _ck(d["G"], 10),
             preempt=(1, 1)),
        case("rollback", GUARD + ["train.anomaly_limit=1"] + _ck(d["E"], 1), nan_at=(1, 2)),
        case("torn", ZERO1 + ["train.num_steps=3"] + _ck(d["F"], 1),
             specs={1: [{"kind": "partial_write", "step": 3, "path": "ckpt"}]}),
        case("torn_restore", ZERO1 + ["train.num_steps=3"] + _ck(d["F"], 1),
             restore_only=True),
    ]
    ctx = W.spawn(2, cases, tmp)
    return d, W.collect(ctx, 2, tmp)


def _cfg(extra):
    return get_config("tiny-llama", BASE + extra)


def _state(cfg, ranks, rows_key="state"):
    """The ranks' blocks put back together as a whole train-state tree in
    the checkpoint layout (step and count from the run)."""
    sizes = dict(cfg.parallel.axis_sizes)
    layout = param_layout(cfg.model, sizes, cfg.train.zero1)
    coords = [r["coords"] for r in ranks]

    def whole(part):
        return unshard_params([r[rows_key][part] for r in ranks], layout, sizes, coords,
                              state=part != "params")

    state = {"params": whole("params"), "opt": {"mu": whole("mu"), "nu": whole("nu"),
                                                "count": 0}, "step": 0}
    return state_to_tree(state, cfg.model)


def _assert_trees_bitwise(a, b, skip=("count", "step")):
    flat_b = dict((p, t) for p, t in tree_leaves_with_path(b))
    for path, t in tree_leaves_with_path(a):
        if path[-1] in skip:
            continue
        assert _bits(t) == _bits(flat_b[path]), path


def _manifest(d, step):
    with open(os.path.join(d, f"step_{step:08d}", "manifest.json")) as f:
        return json.load(f)


def test_ranks_did_not_import_jax(runs):
    assert not any(r["jax_imported"] for r in runs[1])


def test_fsdp2_checkpoint_restores_in_one_process(runs):
    d, ranks = runs
    saved = _state(_cfg(["parallel.fsdp=2"]), [r["save_fsdp2"] for r in ranks])
    cfg = _cfg(["train.num_steps=2"] + _ck(d["A"]))
    tree, step = CheckpointManager(d["A"], cfg.checkpoint).restore_latest(
        abstract_train_state(cfg))
    assert step == 2
    _assert_trees_bitwise(saved, tree)
    state, step = Trainer(cfg, device="cpu").restore_or_init()
    assert step == 2 and state["step"] == 2
    _assert_trees_bitwise(saved, state_to_tree(state, cfg.model))


def test_zero1_checkpoint_restores_at_dp1(runs):
    d, ranks = runs
    saved = _state(_cfg(ZERO1), [r["save_zero1"] for r in ranks])
    man = _manifest(d["B"], 2)
    mu = next(k for k in man["leaves"] if "'mu'" in k and "tokens" in k)
    assert "dp" in (man["leaves"][mu]["sharding"] or [])
    assert len(man["leaves"][mu]["shards"]) == 2
    cfg = _cfg(["train.num_steps=3"] + _ck(d["B"]))
    state, step = Trainer(cfg, device="cpu").restore_or_init()
    assert step == 2
    _assert_trees_bitwise(saved, state_to_tree(state, cfg.model))


def test_fsdp2_checkpoint_restores_in_zero1_ranks(runs):
    _, ranks = runs
    saved = _state(_cfg(["parallel.fsdp=2"]), [r["save_fsdp2"] for r in ranks])
    got = [r["zero1_from_fsdp2"] for r in ranks]
    assert [g["step"] for g in got] == [2, 2]
    _assert_trees_bitwise(saved, _state(_cfg(ZERO1), got))


def test_jax_checkpoint_restores_in_port_ranks(runs):
    d, ranks = runs
    jtr = JTrainer(j_get_config("tiny-llama", BASE + ["parallel.fsdp=2"] + _ck(d["C"])))
    jstate, step = jtr.ckpt.restore_latest(jtr.abstract_state())
    got = [r["fsdp2_from_jax"] for r in ranks]
    assert step == 2 and [g["step"] for g in got] == [2, 2]
    _assert_trees_bitwise(_np(jstate), _state(_cfg(["parallel.fsdp=2"]), got))


def test_port_checkpoint_restores_in_jax_and_manifests_agree(runs):
    d, ranks = runs
    saved = _state(_cfg(["parallel.fsdp=2"]), [r["save_fsdp2"] for r in ranks])
    jtr = JTrainer(j_get_config("tiny-llama", BASE + ["parallel.fsdp=2"] + _ck(d["A"])))
    jstate, step = jtr.ckpt.restore_latest(jtr.abstract_state())
    assert step == 2
    _assert_trees_bitwise(_np(jstate), saved)
    port, jax_m = _manifest(d["A"], 2), _manifest(d["C"], 2)
    assert sorted(port["leaves"]) == sorted(jax_m["leaves"])
    placed = {jax.tree_util.keystr(p): leaf for p, leaf in
              jax.tree_util.tree_flatten_with_path(jstate)[0]}
    for key, entry in port["leaves"].items():
        want = jax_m["leaves"][key]
        for field in ("dtype", "shape", "sharding"):
            assert entry[field] == want[field], (key, field)
        leaf = placed[key]
        blocks = sorted([[s.index[d].indices(n)[:2] for d, n in enumerate(leaf.shape)]
                         for s in leaf.addressable_shards if s.replica_id == 0])
        got = sorted(s["index"] for s in entry["shards"])
        if entry["sharding"] and any(entry["sharding"]):
            assert [[list(r) for r in b] for b in blocks] == got, key
        else:
            assert got == [None], key


def test_guard_skips_on_every_rank_and_zero1_matches_dp(runs):
    _, ranks = runs
    clean, clean_z = [r["guard"] for r in ranks], [r["guard_zero1"] for r in ranks]
    nan, nan_z = [r["guard_nan"] for r in ranks], [r["guard_zero1_nan"] for r in ranks]
    assert clean[0]["losses"] == clean_z[0]["losses"]
    for run in (nan, nan_z):
        for r in run:
            assert r["anomaly"] == [0.0, 1.0, 0.0, 0.0]
            assert r["robust"]["anomalous_steps"] == 1
            assert r["robust"]["nonfinite_steps"] == 1
            assert r["losses"][:2] == clean[0]["losses"][:2]
        assert _bits(run[0]["state"]["params"]["embed"]["tokens"]) == _bits(
            run[1]["state"]["params"]["embed"]["tokens"])
    for a, b in zip(nan, nan_z):
        assert a["losses"] == b["losses"]
        assert a["grad_norms"][:1] + a["grad_norms"][2:] == b["grad_norms"][:1] + b[
            "grad_norms"][2:]
    _assert_trees_bitwise(_state(_cfg(GUARD), nan),
                          _state(_cfg(GUARD + ["train.zero1=true"]), nan_z))


def test_injected_fault_resumes_every_rank_at_the_same_step(runs):
    _, ranks = runs
    got, base = [r["zero1_inject"] for r in ranks], [r["zero1_4"] for r in ranks]
    for g in got:
        assert g["faulted"] and g["resumed_at"] == 2 and g["quarantined"] == []
        assert g["robust"]["emergency_saves"] == 0   # the resumed run's own counters
        assert g["losses"] == base[0]["losses"][2:]
    _assert_trees_bitwise(_state(_cfg(ZERO1), got), _state(_cfg(ZERO1), base))


def test_preemption_on_one_rank_stops_every_rank_at_the_same_step(runs):
    """Rank 1 alone is preempted once it has taken a step: its flag rides
    the next step's loss reduction, so both ranks stop after step 2, save
    there, and resume to the uninterrupted run's end bit for bit."""
    _, ranks = runs
    got, base = [r["zero1_preempt"] for r in ranks], [r["zero1_4"] for r in ranks]
    for g in got:
        assert g["faulted"] and g["stopped_after"] == 2 and g["resumed_at"] == 2
        assert g["losses"] == base[0]["losses"][2:]
    _assert_trees_bitwise(_state(_cfg(ZERO1), got), _state(_cfg(ZERO1), base))


def test_anomaly_rollback_moves_every_rank(runs):
    _, ranks = runs
    got = [r["rollback"] for r in ranks]
    for g in got:
        assert g["robust"]["rollbacks"] == 1 and g["robust"]["anomalous_steps"] == 1
    assert got[0]["losses"] == got[1]["losses"]
    _assert_trees_bitwise(got[0]["state"]["params"], got[1]["state"]["params"], skip=())


def test_torn_file_on_one_rank_falls_back_on_every_rank(runs):
    _, ranks = runs
    got = [r["torn_restore"] for r in ranks]
    assert [g["step"] for g in got] == [2, 2]
    assert got[0]["quarantined"] == got[1]["quarantined"] and len(got[0]["quarantined"]) == 1
    assert got[0]["quarantined"][0][0] == 3
