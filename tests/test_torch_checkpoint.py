"""The port's checkpoint manager (``orion_tpu_torch/ckpt``) against the JAX
package's (``orion_tpu/ckpt``), on the CPU: the same state saved by both
gives byte-identical array files and equal manifest leaves; a checkpoint
either package writes restores bitwise in the other; the corruption matrix
run on twin directories quarantines the same steps for the same reasons and
leaves the same layout; and the manager's own contracts (torn-tmp sweep,
the crashed overwrite's aside copy, GC, interval/force/overwrite, the async
stamp, async capture against in-place updates). No tolerance anywhere."""

import json
import os
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec

from orion_tpu.ckpt import CheckpointManager as JManager
from orion_tpu.config import CheckpointConfig as JCkptConfig
from orion_tpu.config import get_config as j_get_config
from orion_tpu.runtime.fault import FaultInjector as JInjector
from orion_tpu.runtime.fault import FaultSpec as JSpec
from orion_tpu.train import Trainer as JTrainer
from orion_tpu.train.trainer import init_train_state as j_init_train_state
from orion_tpu_torch.ckpt import CheckpointManager
from orion_tpu_torch.config import CheckpointConfig, get_config
from orion_tpu_torch.data.loader import STREAM_FORMAT
from orion_tpu_torch.models import from_jax_params
from orion_tpu_torch.runtime.fault import FaultInjector, FaultSpec
from orion_tpu_torch.train import Trainer, state_from_tree, state_to_tree
from orion_tpu_torch.train.trainer import prng_key_data
from tests import torch_threads  # noqa: F401  (one intra-op thread)

TRAIN = ["runtime.platform=cpu", "train.log_interval=1000", "optimizer.warmup_steps=1",
         "data.batch_size=2", "data.seq_len=32"]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _bits(x):
    """A leaf's bytes, whichever package holds it."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.view(torch.int16) if x.dtype == torch.bfloat16 else x).numpy().tobytes()
    return np.asarray(x).tobytes()


def _files(d):
    return sorted(os.listdir(d))


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _layout(root):
    """Every file and directory under ``root``, relative, with each
    quarantine record's step and reason."""
    out = []
    for dirpath, dirnames, filenames in os.walk(root):
        rel = os.path.relpath(dirpath, root)
        out += [os.path.join(rel, n) + "/" for n in dirnames]
        for n in filenames:
            entry = os.path.join(rel, n)
            if n == "reason.json":
                rec = json.load(open(os.path.join(dirpath, n)))
                entry += f" {rec['step']} {rec['reason']}"
            out.append(entry)
    return sorted(out)


# -- the same state, byte for byte ------------------------------------------


def _jax_train_state(preset, overrides, count, step, seed=3):
    """A JAX train state with random moments (numpy), as the JAX trainer
    holds it."""
    jcfg = j_get_config(preset, overrides)
    state = _np(j_init_train_state(jcfg, jax.random.key(0)))
    rng = np.random.default_rng(seed)

    def fill(a):
        return rng.standard_normal(a.shape).astype(np.float32).astype(a.dtype)

    state["opt"]["mu"] = jax.tree.map(fill, state["opt"]["mu"])
    state["opt"]["nu"] = jax.tree.map(lambda a: np.abs(fill(a)), state["opt"]["nu"])
    state["opt"]["count"] = np.asarray(count, np.int32)
    state["step"] = np.asarray(step, np.int32)
    return jcfg, state


def _port_state(jstate, mcfg):
    return {
        "params": from_jax_params(jstate["params"], mcfg),
        "opt": {"mu": from_jax_params(jstate["opt"]["mu"], mcfg),
                "nu": from_jax_params(jstate["opt"]["nu"], mcfg),
                "count": int(jstate["opt"]["count"])},
        "step": int(jstate["step"]),
    }


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
@pytest.mark.parametrize("scan_layers", [True, False])
def test_save_is_byte_identical_to_jax(tmp_path, scan_layers, moments):
    """A tiny-llama train state (float32 params, moments in either dtype)
    saved by both managers: the same files, byte for byte, and the same
    manifest. The JAX side holds its arrays replicated on a one-device
    mesh, as a one-device JAX run does after its first step."""
    ov = TRAIN + [f"model.scan_layers={scan_layers}", f"optimizer.moment_dtype={moments}"]
    jcfg, jstate = _jax_train_state("tiny-llama", ov, count=3, step=5)
    cfg = get_config("tiny-llama", ov)
    whole = NamedSharding(Mesh(np.array(jax.devices("cpu")[:1]), ("dp",)), PartitionSpec())
    extra = {"loader": {"offset": 2}, "gnorm_ema": 0.125}
    jm = JManager(str(tmp_path / "jax"), JCkptConfig(async_save=False))
    jm.save(5, jax.tree.map(lambda a: jax.device_put(a, whole), jstate), force=True,
            extra=extra)
    pm = CheckpointManager(str(tmp_path / "port"), CheckpointConfig(async_save=False))
    pm.save(5, state_to_tree(_port_state(jstate, cfg.model), cfg.model), force=True,
            extra=extra)
    jd, pd = tmp_path / "jax" / "step_00000005", tmp_path / "port" / "step_00000005"
    assert _files(jd) == _files(pd)
    for name in _files(jd):
        assert _read(jd / name) == _read(pd / name), name
    jman = json.load(open(jd / "manifest.json"))
    assert jman["leaves"] == json.load(open(pd / "manifest.json"))["leaves"]
    key = "['params']['blocks']['attn']['wq']" if scan_layers \
        else "['params']['blocks'][1]['attn']['wq']"
    assert key in jman["leaves"]
    assert jman["leaves"]["['opt']['mu']['lm_head']"]["dtype"] == moments
    assert _read(tmp_path / "jax" / "stream_format.json") \
        == _read(tmp_path / "port" / "stream_format.json")


def test_prng_key_matches_jax():
    for seed in (0, 7, -1, 2 ** 31, 2 ** 32 + 5):
        want = np.ravel(jax.random.key_data(jax.random.key(seed))).tolist()
        assert prng_key_data(seed) == want, seed


# -- each package restores the other's trainer checkpoint -------------------


def _assert_state_equal(tree_a, tree_b):
    leaves_a, leaves_b = jax.tree.leaves(tree_a), jax.tree.leaves(tree_b)
    assert len(leaves_a) == len(leaves_b)
    for a, b in zip(leaves_a, leaves_b):
        assert _bits(a) == _bits(b)


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_trainer_checkpoints_cross_restore_bitwise(tmp_path, moments):
    """The JAX trainer checkpoints 2 steps; the port's trainer restores
    the state bitwise (params, moments, count, step, the loader cursor and
    guard state). Then the port trains on to 4 and checkpoints; the JAX
    trainer restores that bitwise."""
    ov = TRAIN + ["train.num_steps=2", "checkpoint.save_interval_steps=2",
                  f"checkpoint.directory={tmp_path}/ck", f"optimizer.moment_dtype={moments}",
                  "train.anomaly_guard=true"]
    jtr = JTrainer(j_get_config("tiny-llama", ov))
    jtr.fit()
    jstate, jstep = jtr.ckpt.restore_latest(jtr.abstract_state())
    assert jstep == 2
    cfg = get_config("tiny-llama", ov)
    tr = Trainer(cfg, device="cpu")
    state, step = tr.restore_or_init()
    assert step == state["step"] == 2 and state["opt"]["count"] == 2
    _assert_state_equal(_np(jstate), state_to_tree(state, cfg.model))
    assert tr._gnorm_ema == jtr._gnorm_ema and tr.loader.offset == jtr.loader.offset

    ov4 = [o for o in ov if not o.startswith("train.num_steps")] + ["train.num_steps=4"]
    tr4 = Trainer(get_config("tiny-llama", ov4), device="cpu")
    tr4.fit()
    jtr4 = JTrainer(j_get_config("tiny-llama", ov4))
    jstate4, jstep4 = jtr4.restore_or_init()
    assert jstep4 == 4 and int(jstate4["step"]) == 4
    _assert_state_equal(_np(jstate4), state_to_tree(tr4.state, cfg.model))
    assert jtr4._gnorm_ema == tr4._gnorm_ema
    assert jtr4.ckpt.last_restore_extra == tr4._ckpt_extra()


def test_state_tree_round_trip():
    """state_to_tree / state_from_tree invert each other, scan_layers on
    and off."""
    for scan in (True, False):
        ov = TRAIN + [f"model.scan_layers={scan}"]
        _, jstate = _jax_train_state("tiny-llama", ov, count=4, step=9)
        cfg = get_config("tiny-llama", ov)
        state = _port_state(jstate, cfg.model)
        back = state_from_tree(state_to_tree(state, cfg.model), cfg.model, "cpu")
        assert back["step"] == 9 and back["opt"]["count"] == 4
        _assert_state_equal(state_to_tree(back, cfg.model), _np(jstate))


def test_multi_host_shard_files_restore(tmp_path):
    """A leaf saved as per-host shard files (a multi-host JAX checkpoint)
    is assembled from its shards' regions, by both packages."""
    jm = JManager(str(tmp_path / "ck"), JCkptConfig(async_save=False))
    w = np.arange(24, dtype=np.float32).reshape(4, 6)
    jm.save(1, {"w": jnp.asarray(w), "b": jnp.ones(3, jnp.bfloat16)}, force=True)
    sdir = tmp_path / "ck" / "step_00000001"
    man = json.load(open(sdir / "manifest.json"))
    entry = man["leaves"]["['w']"]
    whole = entry["shards"][0]["file"]
    os.remove(sdir / whole)
    shards = []
    for j, rows in enumerate(((0, 2), (2, 4))):
        data = np.ascontiguousarray(w[rows[0]:rows[1]]).tobytes()
        name = f"arr_00001.p{j}.s0.bin"
        (sdir / name).write_bytes(data)
        shards.append({"file": name, "index": [list(rows), [0, 6]], "nbytes": len(data),
                       "crc32": zlib.crc32(data)})
    entry["shards"] = shards
    json.dump(man, open(sdir / "manifest.json", "w"))
    target = {"w": torch.zeros(4, 6), "b": torch.zeros(3, dtype=torch.bfloat16)}
    state, step = CheckpointManager(str(tmp_path / "ck"),
                                    CheckpointConfig()).restore_latest(target)
    assert step == 1
    assert _bits(state["w"]) == w.tobytes()
    assert state["b"].dtype == torch.bfloat16 and torch.equal(state["b"], torch.ones(3))
    jstate, _ = JManager(str(tmp_path / "ck"), JCkptConfig()).restore_latest(
        {"w": jnp.zeros((4, 6)), "b": jnp.zeros(3, jnp.bfloat16)})
    assert _bits(jstate["w"]) == w.tobytes()


# -- the corruption matrix, on twin directories ------------------------------


def _p_state(x=0.0):
    return {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3) + x,
            "h": torch.full((4,), x, dtype=torch.bfloat16),
            "opt": {"count": torch.tensor(int(x), dtype=torch.int32)}}


def _j_state(x=0.0):
    return {"w": jnp.arange(6, dtype=jnp.float32).reshape(2, 3) + x,
            "h": jnp.full((4,), x, jnp.bfloat16),
            "opt": {"count": jnp.asarray(int(x), jnp.int32)}}


def _twins(tmp_path, steps=(1, 2, 3), partial_write=None):
    specs = [] if partial_write is None else [("partial_write", partial_write)]
    jm = JManager(str(tmp_path / "jax"), JCkptConfig(async_save=False, max_to_keep=10),
                  fault_injector=JInjector(specs=[JSpec(k, s) for k, s in specs]))
    pm = CheckpointManager(str(tmp_path / "port"),
                           CheckpointConfig(async_save=False, max_to_keep=10),
                           fault_injector=FaultInjector(specs=[FaultSpec(k, s)
                                                               for k, s in specs]))
    for s in steps:
        jm.save(s, _j_state(float(s)), force=True)
        pm.save(s, _p_state(float(s)), force=True)
    return jm, pm


def _truncate(d):
    f = os.path.join(d, sorted(n for n in os.listdir(d) if n.endswith(".bin"))[0])
    with open(f, "r+b") as fh:
        fh.truncate(os.path.getsize(f) // 2)


def _flip(d):
    f = os.path.join(d, sorted(n for n in os.listdir(d) if n.endswith(".bin"))[0])
    raw = bytearray(open(f, "rb").read())
    raw[0] ^= 0xFF
    open(f, "wb").write(bytes(raw))


def _drop_manifest(d):
    os.remove(os.path.join(d, "manifest.json"))


def _garble_manifest(d):
    open(os.path.join(d, "manifest.json"), "w").write("{nope")


def _drop_array(d):
    os.remove(os.path.join(d, sorted(n for n in os.listdir(d) if n.endswith(".bin"))[0]))


def _step(root, s):
    return os.path.join(root, f"step_{s:08d}")


# case -> (steps saved, damage per step, partial_write step, other target,
#          expected restored step or None, expected quarantined list)
MATRIX = {
    "truncated_array": ((1, 2, 3), {3: _truncate}, None, False, 2,
                        [(3, "truncated_array")]),
    "bad_checksum": ((1, 2, 3), {3: _flip}, None, False, 2, [(3, "bad_checksum")]),
    "missing_manifest": ((1, 2, 3), {3: _drop_manifest}, None, False, 2,
                         [(3, "missing_manifest")]),
    "bad_manifest": ((1, 2, 3), {3: _garble_manifest}, None, False, 2,
                     [(3, "bad_manifest")]),
    "missing_array": ((1, 2, 3), {3: _drop_array}, None, False, 2, [(3, "missing_array")]),
    "leaf_mismatch": ((1,), {}, None, True, None, [(1, "leaf_mismatch")]),
    "multi_step_fallback": ((1, 2, 3), {3: _drop_manifest, 2: _truncate}, None, False, 1,
                            [(3, "missing_manifest"), (2, "truncated_array")]),
    "all_corrupt": ((1, 2), {1: _drop_manifest, 2: _drop_manifest}, None, False, None,
                    [(2, "missing_manifest"), (1, "missing_manifest")]),
    "partial_write": ((1, 2, 3), {}, 3, False, 2, [(3, "truncated_array")]),
}


@pytest.mark.parametrize("case", sorted(MATRIX))
def test_corruption_matrix_matches_jax(tmp_path, case):
    steps, damage, pw, other, want_step, want_q = MATRIX[case]
    jm, pm = _twins(tmp_path, steps, partial_write=pw)
    for s, fn in damage.items():
        fn(_step(jm._dir, s))
        fn(_step(pm._dir, s))
    if other:
        jt, pt = {"different": jnp.zeros(2)}, {"different": torch.zeros(2)}
    else:
        jt, pt = _j_state(), _p_state()
    jr, pr = jm.restore_latest(jt), pm.restore_latest(pt)
    assert pm.quarantined == jm.quarantined == want_q
    if want_step is None:
        assert jr is None and pr is None
    else:
        assert jr[1] == pr[1] == want_step
        assert pm.last_restore_step == want_step
        for a, b in zip(jax.tree.leaves(_np(jr[0])),
                        jax.tree.leaves(_p_state(float(want_step)))):
            assert _bits(a) == _bits(b)
        for a, b in zip(jax.tree.leaves(pr[0]), jax.tree.leaves(_p_state(float(want_step)))):
            assert _bits(a) == _bits(b)
    assert _layout(pm._dir) == _layout(jm._dir)
    if case == "leaf_mismatch":
        assert os.path.isdir(_step(pm._dir, 1))      # excluded, not moved


def test_verify_restore_off_skips_only_the_checksum(tmp_path):
    """checkpoint.verify_restore=false: a flipped byte passes (no CRC
    pass), a truncated file is still caught by its size."""
    pm = CheckpointManager(str(tmp_path / "ck"),
                           CheckpointConfig(async_save=False, verify_restore=False,
                                            max_to_keep=10))
    for s in (1, 2, 3):
        pm.save(s, _p_state(float(s)), force=True)
    _flip(_step(pm._dir, 3))
    _truncate(_step(pm._dir, 2))
    _, step = pm.restore_latest(_p_state())
    assert step == 3 and pm.quarantined == []
    _drop_manifest(_step(pm._dir, 3))
    _, step = pm.restore_latest(_p_state())
    assert step == 1
    assert pm.quarantined == [(3, "missing_manifest"), (2, "truncated_array")]


# -- the manager's contracts ---------------------------------------------------


def test_manifest_records_checksums_shapes_and_stream_state(tmp_path):
    pm = CheckpointManager(str(tmp_path / "ck"), CheckpointConfig(async_save=False))
    extra = {"loader": {"offset": 3}, "gnorm_ema": 0.125}
    assert pm.save(2, _p_state(1.0), force=True, extra=extra)
    sdir = tmp_path / "ck" / "step_00000002"
    man = json.load(open(sdir / "manifest.json"))
    assert man["format"] == 1 and man["step"] == 2 and man["stream_format"] == STREAM_FORMAT
    assert list(man["leaves"]) == ["['h']", "['opt']['count']", "['w']"]
    h = man["leaves"]["['h']"]
    assert h["dtype"] == "bfloat16" and h["shape"] == [4] and h["sharding"] == []
    shard = h["shards"][0]
    assert shard["nbytes"] == 8 and shard["index"] is None
    assert zlib.crc32(_read(sdir / shard["file"])) == shard["crc32"]
    state, step = pm.restore_latest(_p_state())
    assert step == 2 and pm.last_restore_extra == extra
    for a, b in zip(jax.tree.leaves(state), jax.tree.leaves(_p_state(1.0))):
        assert _bits(a) == _bits(b)


def test_interval_skip_force_and_overwrite(tmp_path):
    pm = CheckpointManager(str(tmp_path / "ck"),
                           CheckpointConfig(async_save=False, save_interval_steps=10,
                                            max_to_keep=10))
    built = []

    def lazy(x):
        def build():
            built.append(x)
            return _p_state(x)
        return build

    assert not pm.save(3, lazy(3.0))               # interval not due: not built
    assert built == []
    assert pm.save(10, lazy(0.0))                  # due
    assert not pm.save(10, _p_state())             # already committed: skip
    assert pm.save(11, _p_state(), force=True)
    assert pm.latest_step() == 11
    assert pm.save(11, _p_state(7.0), force=True, overwrite=True)
    state, step = pm.restore_latest(_p_state())
    assert step == 11 and torch.equal(state["w"], _p_state(7.0)["w"])
    assert built == [0.0]
    pm.close()


def test_async_commit_stamps_without_lag(tmp_path):
    pm = CheckpointManager(str(tmp_path / "ck"), CheckpointConfig(async_save=True))
    assert pm.save(0, _p_state(), force=True)
    pm.wait()
    stamp = tmp_path / "ck" / "stream_format.json"
    assert json.load(open(stamp))["stream_format"] == STREAM_FORMAT
    assert pm.latest_step() == 0 and not pm._stamp_pending
    assert not pm.save(1, _p_state())
    pm.close()


def test_async_capture_does_not_alias_in_place_update(tmp_path):
    """An async save on the CPU snapshots the state at save(): an in-place
    update right after it (as the optimizer makes) does not reach the
    file. The writer is held until the update has happened."""
    pm = CheckpointManager(str(tmp_path / "ck"), CheckpointConfig(async_save=True))
    commit, gate = pm._commit, __import__("threading").Event()

    def held(*job):
        assert gate.wait(10)
        commit(*job)

    pm._commit = held
    state = _p_state(1.0)
    assert pm.save(4, state, force=True)
    with torch.no_grad():
        state["w"].add_(100.0)
        state["h"].add_(100.0)
    gate.set()
    pm.wait()
    restored, _ = pm.restore_latest(_p_state())
    for a, b in zip(jax.tree.leaves(restored), jax.tree.leaves(_p_state(1.0))):
        assert _bits(a) == _bits(b)
    pm.close()


def test_async_save_error_surfaces_at_wait(tmp_path):
    pm = CheckpointManager(str(tmp_path / "ck"), CheckpointConfig(async_save=True))

    def boom(*job):
        raise OSError("disk full")

    pm._commit = boom
    assert pm.save(1, _p_state(), force=True)
    with pytest.raises(RuntimeError, match="async checkpoint save failed"):
        pm.wait()
    assert 1 not in pm._inflight
    pm.close()


def test_retention_gc_keeps_newest(tmp_path):
    pm = CheckpointManager(str(tmp_path / "ck"),
                           CheckpointConfig(async_save=False, max_to_keep=2))
    for s in (1, 2, 3, 4):
        pm.save(s, _p_state(float(s)), force=True)
    assert sorted(n for n in os.listdir(tmp_path / "ck") if n.startswith("step_")) \
        == ["step_00000003", "step_00000004"]


def test_crashed_overwrite_restores_aside_copy(tmp_path):
    d = str(tmp_path / "ck")
    CheckpointManager(d, CheckpointConfig(async_save=False)).save(3, _p_state(3.0),
                                                                   force=True)
    os.rename(_step(d, 3), _step(d, 3) + ".replaced")
    state, step = CheckpointManager(d, CheckpointConfig()).restore_latest(_p_state())
    assert step == 3 and torch.equal(state["w"], _p_state(3.0)["w"])
    os.makedirs(_step(d, 3) + ".replaced")
    pm = CheckpointManager(d, CheckpointConfig())
    assert not os.path.exists(_step(d, 3) + ".replaced") and pm.latest_step() == 3


def test_torn_tmp_dir_swept_on_init(tmp_path):
    d = str(tmp_path / "ck")
    CheckpointManager(d, CheckpointConfig(async_save=False)).save(1, _p_state(), force=True)
    torn = os.path.join(d, ".tmp-step_00000002")
    os.makedirs(torn)
    open(os.path.join(torn, "arr_00000.bin"), "wb").write(b"\x00" * 8)
    pm = CheckpointManager(d, CheckpointConfig())
    assert not os.path.exists(torn) and pm.latest_step() == 1
    assert pm.restore_latest(_p_state())[1] == 1
