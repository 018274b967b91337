"""The port's training fault stack against the JAX trainer's, on the CPU.

Each scenario runs the same fault schedule through both trainers from the
same weights (the JAX init, carried across by ``from_jax_params``) and
holds the port to three things: its resumed run equals its own
uninterrupted run bitwise (every logged loss and the final state), its
``TrainRobustnessStats`` equal the JAX trainer's with no tolerance, and its
losses equal the JAX trainer's to 1e-4 (float32 sums in another order; the
tolerance of ``tests/test_torch_train.py``'s curves). Also the loader
cursor, the guard's step (a skip is a bitwise no-op; a clean guarded step
equals an unguarded one), rollback without a checkpoint, checkpoints that
cross between the packages mid-run, and the serving CLI restoring a
trainer checkpoint."""

import functools
import json
import logging

import jax
import numpy as np
import pytest
import torch

from orion_tpu.config import get_config as j_get_config
from orion_tpu.runtime import fault as j_fault
from orion_tpu.train import Trainer as JTrainer
from orion_tpu_torch.config import get_config
from orion_tpu_torch.data import make_loader
from orion_tpu_torch.infer import InferenceEngine
from orion_tpu_torch.models import from_jax_params
from orion_tpu_torch.models.convert import to_device
from orion_tpu_torch.runtime import fault
from orion_tpu_torch.train import (
    RollbackFailed,
    Trainer,
    abstract_train_state,
    make_train_step,
    state_to_tree,
)
from tests import torch_threads  # noqa: F401  (one intra-op thread)

LOSS_TOL = 1e-4


def _ov(tmp_path=None, extra=(), sub="ckpt"):
    """The JAX package's fault-test schedule: 12 steps, saves every 4."""
    over = ["runtime.platform=cpu", "train.num_steps=12", "optimizer.warmup_steps=2",
            "train.log_interval=1000", "checkpoint.save_interval_steps=4"]
    if tmp_path is not None:
        over.append(f"checkpoint.directory={tmp_path}/{sub}")
    return over + list(extra)


@functools.lru_cache(maxsize=None)
def _jax_init(preset):
    """The JAX trainer's seeded init (numpy), for both packages."""
    state = JTrainer(j_get_config(preset, _ov())).init_state()
    return jax.tree.map(np.asarray, state["params"])


def _port(preset, ov, specs=(), **kw):
    cfg = get_config(preset, ov)
    inj = fault.FaultInjector(specs=[fault.FaultSpec(*s) for s in specs]) if specs else None
    return Trainer(cfg, params=from_jax_params(_jax_init(preset), cfg.model), device="cpu",
                   fault_injector=inj, **kw)


def _jax(preset, ov, specs=()):
    inj = j_fault.FaultInjector(specs=[j_fault.FaultSpec(*s) for s in specs]) \
        if specs else None
    return JTrainer(j_get_config(preset, ov), fault_injector=inj)


def _fit(trainer, raises=None, **kw):
    if raises is None:
        return trainer.fit(**kw)
    with pytest.raises(Exception) as info:
        trainer.fit(**kw)
    assert type(info.value).__name__ == raises, info.value
    return trainer.metrics.history


def _losses(*trainers):
    out = {}
    for t in trainers:
        for m in t.metrics.history:
            out.setdefault(m.step, []).append(m.loss)
    return out


def _same(a, b):
    return a == b or (np.isnan(a) and np.isnan(b))


@functools.lru_cache(maxsize=None)
def _uninterrupted(preset, extra=(), specs=()):
    """The port's run of the schedule with no interruption: losses by step
    and the final state's bytes."""
    t = _port(preset, _ov(extra=extra), specs)
    t.fit()
    tree = state_to_tree(t.state, t.cfg.model)
    return ({m.step: m.loss for m in t.metrics.history},
            [_bits(x) for x in jax.tree.leaves(tree)])


def _bits(x):
    x = x.detach().cpu()
    return (x.view(torch.int16) if x.dtype == torch.bfloat16 else x).numpy().tobytes()


def _check(preset, port_trainers, jax_trainers, extra=(), specs=()):
    """The three holds of the module docstring."""
    want_losses, want_state = _uninterrupted(preset, tuple(extra), tuple(specs))
    for step, losses in _losses(*port_trainers).items():
        for loss in losses:
            assert _same(loss, want_losses[step]), (step, loss, want_losses[step])
    last = port_trainers[-1]
    got = [_bits(x) for x in jax.tree.leaves(state_to_tree(last.state, last.cfg.model))]
    assert got == want_state
    for p, j in zip(port_trainers, jax_trainers):
        assert p.robustness.as_timing() == j.robustness.as_timing()
    jl = _losses(*jax_trainers)
    assert sorted(jl) == sorted(_losses(*port_trainers))
    for step, losses in _losses(*port_trainers).items():
        for a, b in zip(losses, jl[step]):
            assert _same(a, b) or abs(a - b) < LOSS_TOL, (step, a, b)


# -- the loader's cursor ------------------------------------------------------


def test_loader_cursor_state_roundtrip_and_skip():
    cfg = get_config("tiny", _ov())
    loader = make_loader(cfg.data, cfg.model.vocab_size)
    ahead = make_loader(cfg.data, cfg.model.vocab_size).batch_at(2)
    loader.skip_batches(2)
    assert loader.state_dict() == {"version": 1, "offset": 2, "stream_format": 2,
                                   "shuffle_seed": cfg.data.shuffle_seed}
    for key, val in loader.batch_at(0).items():
        assert val.tobytes() == ahead[key].tobytes()
    with pytest.raises(ValueError, match="rewinds"):
        loader.skip_batches(-1)
    fresh = make_loader(cfg.data, cfg.model.vocab_size)
    fresh.load_state_dict(loader.state_dict())
    assert fresh.offset == 2
    for key, val in fresh.batch_at(5).items():
        assert val.tobytes() == loader.batch_at(5)[key].tobytes()
    # The JAX loader's state dict is the same dict.
    from orion_tpu.data import make_loader as j_make_loader

    jl = j_make_loader(j_get_config("tiny", _ov()).data, cfg.model.vocab_size)
    jl.skip_batches(2)
    assert jl.state_dict() == loader.state_dict()


def test_loader_cursor_warns_on_stream_format_and_seed_mismatch(caplog):
    cfg = get_config("tiny", _ov())
    loader = make_loader(cfg.data, cfg.model.vocab_size)
    with caplog.at_level(logging.WARNING, logger="orion_tpu_torch.data"):
        loader.load_state_dict({"offset": 1, "stream_format": 1,
                                "shuffle_seed": cfg.data.shuffle_seed + 1})
    msgs = [r.message for r in caplog.records]
    assert any("data-stream format 1" in m for m in msgs)
    assert any("shuffle_seed" in m for m in msgs)
    assert loader.offset == 1


# -- the guard's step ----------------------------------------------------------


def _state_bytes(state, mcfg):
    return [_bits(x) for x in jax.tree.leaves(state_to_tree(state, mcfg))]


@pytest.mark.parametrize("poison", [False, True])
def test_guard_skip_is_bitwise_noop(poison):
    """An anomalous step (a spike against a limit of 0, or a NaN-poisoned
    loss) leaves params and moments bit-identical and the schedule count
    where it was; only ``step`` advances."""
    t = _port("tiny-llama", _ov(extra=["train.anomaly_guard=true"]))
    state = t.init_state()
    before = _state_bytes(state, t.cfg.model)
    step_fn = make_train_step(t.cfg, t._schedule, poison=poison)
    state, m = step_fn(state, t.global_batch(0), np.float32(0.0))
    assert m["anomaly"] == 1.0
    assert (m["nonfinite"], m["spike"]) == ((1.0, 0.0) if poison else (0.0, 1.0))
    assert state["step"] == 1 and state["opt"]["count"] == 0
    after = _state_bytes(state, t.cfg.model)
    assert after[:-1] == before[:-1]   # every leaf but ['step'], the last


def test_guarded_clean_step_equals_unguarded():
    t_on = _port("tiny-llama", _ov(extra=["train.anomaly_guard=true"]))
    t_off = _port("tiny-llama", _ov())
    s_on, m_on = t_on.train_step(t_on.init_state(), t_on.global_batch(0), np.float32(np.inf))
    s_off, m_off = t_off.train_step(t_off.init_state(), t_off.global_batch(0))
    assert m_on["anomaly"] == 0.0
    assert _state_bytes(s_on, t_on.cfg.model) == _state_bytes(s_off, t_off.cfg.model)
    assert (m_on["loss"], m_on["grad_norm"]) == (m_off["loss"], m_off["grad_norm"])


def test_trainer_refuses_fault_kinds_it_does_not_consume():
    with pytest.raises(NotImplementedError, match="fault kinds pool"):
        _port("tiny", _ov(), specs=[("pool", 2)])


# -- resume equivalence under the fault schedules ------------------------------


def test_resume_after_dispatch_fault(tmp_path):
    """Fault at step 7 -> emergency save at 7 (async saves) -> a fresh
    trainer resumes there."""
    specs = [("dispatch", 7, "train")]
    jt = [_jax("tiny", _ov(tmp_path, sub="j"), specs), _jax("tiny", _ov(tmp_path, sub="j"))]
    _fit(jt[0], "InjectedFault")
    _fit(jt[1])
    pt = [_port("tiny", _ov(tmp_path, sub="p"), specs), _port("tiny", _ov(tmp_path, sub="p"))]
    _fit(pt[0], "InjectedFault")
    assert pt[0].fault_injector.fired == [("dispatch", 7, "train")]
    _fit(pt[1])
    assert pt[1].metrics.history[0].step == 8
    _check("tiny", pt, jt)


def test_resume_after_torn_final_save(tmp_path):
    """partial_write tears the final checkpoint (12); the fresh trainer
    quarantines it, restores 8 and replays."""
    specs = [("partial_write", 12)]
    jt = [_jax("tiny", _ov(tmp_path, sub="j"), specs), _jax("tiny", _ov(tmp_path, sub="j"))]
    pt = [_port("tiny", _ov(tmp_path, sub="p"), specs), _port("tiny", _ov(tmp_path, sub="p"))]
    for t in jt + pt:
        _fit(t)
    assert pt[1].ckpt.quarantined == [(12, "truncated_array")]
    assert pt[1].robustness.corrupt_checkpoints == 1
    assert pt[1].metrics.history[0].step == 9
    _check("tiny", pt, jt)


def _countdown(base, after_checks):
    class CountdownHandler(base):
        def __init__(self):
            super().__init__()
            self._checks_left = after_checks

        @property
        def preempted(self):
            self._checks_left -= 1
            if self._checks_left <= 0:
                self._flag.set()
            return self._flag.is_set()

    return CountdownHandler()


def test_resume_after_sigterm(tmp_path):
    """Preemption flagged at the 7th step boundary: the emergency save at
    7 (behind the in-flight async save), then Preempted; resume."""
    jt = [_jax("tiny", _ov(tmp_path, sub="j")), _jax("tiny", _ov(tmp_path, sub="j"))]
    pt = [_port("tiny", _ov(tmp_path, sub="p")), _port("tiny", _ov(tmp_path, sub="p"))]
    for ts, mod in ((jt, j_fault), (pt, fault)):
        handler = _countdown(mod.PreemptionHandler, 7)
        with handler:
            _fit(ts[0], "Preempted", preemption_handler=handler)
        assert ts[0].robustness.emergency_saves == 1 and ts[0].ckpt.latest_step() == 7
        _fit(ts[1])
    _check("tiny", pt, jt)


def test_emergency_ckpt_off_resumes_from_periodic(tmp_path):
    """emergency_ckpt=false: a fault at step 6 saves nothing; the resume
    starts from the periodic checkpoint at 4."""
    extra = ["train.emergency_ckpt=false"]
    specs = [("dispatch", 6, "train")]
    jt = [_jax("tiny", _ov(tmp_path, extra, "j"), specs), _jax("tiny", _ov(tmp_path, extra, "j"))]
    pt = [_port("tiny", _ov(tmp_path, extra, "p"), specs),
          _port("tiny", _ov(tmp_path, extra, "p"))]
    for ts in (jt, pt):
        _fit(ts[0], "InjectedFault")
        assert ts[0].ckpt.latest_step() == 4
        _fit(ts[1])
    assert pt[0].robustness.emergency_saves == 0 and pt[1].metrics.history[0].step == 5
    _check("tiny", pt, jt, extra)


def test_run_with_restarts_with_injector(tmp_path):
    """A dispatch fault at 9 under the supervisor: the second attempt
    carries the restart count and the fault's reason, and the whole
    trajectory is the uninterrupted one."""
    specs = [("dispatch", 9, "train")]
    runs = {}
    for name, mod, make, sub in (("jax", j_fault, _jax, "j"), ("port", fault, _port, "p")):
        ov = _ov(tmp_path, sub=sub)
        first = make("tiny", ov, specs)
        inj = first.fault_injector
        trainers, last = [], {"reason": None}

        def make_and_fit(attempt, make=make, ov=ov, first=first, inj=inj, trainers=trainers,
                         last=last):
            t = first if attempt == 0 else make("tiny", ov)
            t.fault_injector = inj
            trainers.append(t)
            return t.fit(restart_info=(attempt, last["reason"]))

        def on_retry(attempt, exc, last=last):
            last["reason"] = f"{type(exc).__name__}: {exc}"

        mod.run_with_restarts(make_and_fit, max_restarts=2, on_retry=on_retry)
        runs[name] = trainers
    pt, jt = runs["port"], runs["jax"]
    assert len(pt) == 2 and pt[1].robustness.restarts == 1
    assert pt[1].robustness.last_fault_reason \
        == "InjectedFault: injected train dispatch fault at step 9"
    assert pt[1].metrics.history[0].extras["restarts"] == 1.0
    _check("tiny", pt, jt)


def test_guard_with_grad_accum_resume(tmp_path):
    """anomaly_guard x grad_accum=2 x async saves: a NaN step skipped at 5,
    a fault at 8, a resume; against the uninterrupted run with the same NaN."""
    extra = ["train.anomaly_guard=true", "train.grad_accum=2"]
    nan = [("nan", 5, "train")]
    specs = nan + [("dispatch", 8, "train")]
    jt = [_jax("tiny", _ov(tmp_path, extra, "j"), specs), _jax("tiny", _ov(tmp_path, extra, "j"))]
    pt = [_port("tiny", _ov(tmp_path, extra, "p"), specs),
          _port("tiny", _ov(tmp_path, extra, "p"))]
    for ts in (jt, pt):
        _fit(ts[0], "InjectedFault")
        _fit(ts[1])
    assert pt[0].robustness.nonfinite_steps == 1
    assert np.isnan(pt[0].metrics.history[5].loss)
    _check("tiny", pt, jt, extra, nan)


# -- auto-rollback ---------------------------------------------------------------


def test_nan_rollback_with_cursor_fast_forward(tmp_path):
    """Three NaN-poisoned steps (limit 3): each skipped, then the rollback
    restores step 4 and skips the 4-batch poison window; the cursor is
    persisted at the restored step; training recovers. Stats equal the JAX
    trainer's, losses to 1e-4 (NaN where JAX has NaN)."""
    extra = ["train.anomaly_guard=true", "train.anomaly_limit=3"]
    specs = [("nan", s, "train") for s in (5, 6, 7)]
    j = _jax("tiny-llama", _ov(tmp_path, extra, "j"), specs)
    p = _port("tiny-llama", _ov(tmp_path, extra, "p"), specs)
    _fit(j)
    hist = _fit(p)
    stats = p.robustness
    assert (stats.anomalous_steps, stats.nonfinite_steps, stats.rollbacks,
            stats.skipped_batches) == (3, 3, 1, 4)
    assert p.loader.offset == 4 and hist[-1].step == 12 and np.isfinite(hist[-1].loss)
    assert [m.step for m in hist if not np.isfinite(m.loss)] == [6, 7, 8]
    assert stats.as_timing() == j.robustness.as_timing()
    assert [m.step for m in hist] == [m.step for m in j.metrics.history]
    for a, b in zip(hist, j.metrics.history):
        assert _same(a.loss, b.loss) or abs(a.loss - b.loss) < LOSS_TOL, (a.step, a.loss, b.loss)
    _, step = p.ckpt.restore_latest(abstract_train_state(p.cfg))
    assert step == 12 and p.ckpt.last_restore_extra["loader"]["offset"] == 4


def test_rollback_without_checkpoint_raises():
    specs = [("nan", s, "train") for s in (1, 2)]
    t = _port("tiny", _ov(extra=["train.anomaly_guard=true", "train.anomaly_limit=2"]), specs)
    with pytest.raises(RollbackFailed, match="no checkpoint"):
        t.fit()
    assert t.robustness.rollbacks == 1


# -- checkpoints that cross between the packages mid-run ----------------------------


@pytest.mark.parametrize("first", ["jax", "port"])
def test_resume_across_packages_follows_jax_curve(tmp_path, first):
    """One package trains tiny-llama to step 6 (a dispatch fault there; its
    emergency save), the other resumes from that checkpoint to 12: every
    loss within 1e-4 of the JAX trainer's uninterrupted run."""
    ov = _ov(tmp_path)
    specs = [("dispatch", 6, "train")]
    make1, make2 = (_jax, _port) if first == "jax" else (_port, _jax)
    t1 = make1("tiny-llama", ov, specs)
    _fit(t1, "InjectedFault")
    t2 = make2("tiny-llama", ov)
    _fit(t2)
    assert [m.step for m in t2.metrics.history] == list(range(7, 13))
    ref = _jax("tiny-llama", _ov())
    ref.fit()
    want = {m.step: m.loss for m in ref.metrics.history}
    for m in t1.metrics.history + t2.metrics.history:
        assert abs(m.loss - want[m.step]) < LOSS_TOL, (m.step, m.loss, want[m.step])


# -- serving a trainer checkpoint -----------------------------------------------------


def _serve_cli(argv, capsys):
    from orion_tpu_torch.generate import main

    assert main(argv) == 0
    out = capsys.readouterr().out.strip().splitlines()
    return out[0], [json.loads(line)["generated"] for line in out[1:]]


def test_generate_serves_checkpoint_params(tmp_path, capsys):
    """The JAX trainer checkpoints tiny-llama; the port's CLI serves those
    params (its streams equal an engine built from them in memory), and
    says when there is no checkpoint instead of serving random weights
    silently."""
    ov = _ov(tmp_path, extra=["train.num_steps=4"])
    j = _jax("tiny-llama", ov)
    j.fit()
    jstate, _ = j.ckpt.restore_latest(j.abstract_state())
    cfg = get_config("tiny-llama", ov)
    argv = ["--preset", "tiny-llama", "--device", "cpu", "--tokens", "5,3,9",
            "--tokens", "7,8,9,10", "--max-new-tokens", "8",
            f"checkpoint.directory={tmp_path}/ckpt"]
    head, streams = _serve_cli(argv, capsys)
    assert head == "restored checkpoint step 4"
    params = to_device(from_jax_params(jax.tree.map(np.asarray, jstate["params"]), cfg.model),
                       "cpu", dtype=cfg.model.dtype)
    eng = InferenceEngine(cfg, params, device="cpu")
    reqs = [eng.submit_request(p, 8) for p in ([5, 3, 9], [7, 8, 9, 10])]
    while eng.has_work():
        eng.step()
    assert streams == [r.generated for r in reqs]
    head, _ = _serve_cli(argv[:-1] + [f"checkpoint.directory={tmp_path}/empty"], capsys)
    assert head.startswith("no intact checkpoint in ")


def test_train_cli_max_restarts(tmp_path, capsys):
    """``--max-restarts``: a fault at step 8 restarts the fit, which resumes
    from the emergency save and ends at step 12; without a checkpoint
    directory the option is refused."""
    from orion_tpu_torch.train.__main__ import main

    argv = ["--preset", "tiny-llama", "--device", "cpu", "--max-restarts", "1",
            "train.num_steps=12", "train.log_interval=1000", "train.inject_fault_at_step=8"]
    assert main(argv + [f"checkpoint.directory={tmp_path}/c"]) == 0
    assert capsys.readouterr().out.strip().splitlines()[-1].startswith("done: 12 steps")
    with pytest.raises(SystemExit):
        main(argv)
    assert "needs checkpoint.directory" in capsys.readouterr().err
