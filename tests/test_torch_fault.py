"""The port's serving lifecycle and fault containment against the JAX
engine: the same fault schedules, built from the same (kind, step, path,
rid, stall_s, count) tuples, drive the JAX engine (kernels="xla") and the
port's engine on the CPU (the plain versions), over the same tiny-llama
weights (``from_jax_params``). Tolerance: none. Greedy streams, typed
outcomes, the step at which each request surfaced, and every
RobustnessStats counter must be equal.

Also the pure-Python pieces of ``orion_tpu_torch/runtime/fault.py``
(Watchdog, PreemptionHandler, FaultSpec, FaultInjector) and the quarantine
primitives ``poison_page`` / ``scrub_pages`` against the JAX package's.
"""

import json
import os
import signal
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orion_tpu.config import get_config as j_get_config
from orion_tpu.infer import InferenceEngine as JEngine
from orion_tpu.infer import kv_cache as j_kv
from orion_tpu.models import init_params as j_init_params
from orion_tpu.runtime import fault as j_fault
from orion_tpu_torch.config import get_config
from orion_tpu_torch.infer import InferenceEngine
from orion_tpu_torch.infer import kv_cache as t_kv
from orion_tpu_torch.metrics import RobustnessStats
from orion_tpu_torch.models import from_jax_params
from orion_tpu_torch.runtime import fault as t_fault
from orion_tpu_torch.runtime.fault import (
    DispatchFault,
    FaultInjector,
    FaultSpec,
    PreemptionHandler,
    Watchdog,
)
from tests import torch_threads  # noqa: F401  (one intra-op thread)

INFER = [
    "inference.max_seq_len=128", "inference.page_size=16",
    "inference.num_pages=32", "inference.max_batch_size=4",
    "inference.prefill_chunk=16", "inference.max_new_tokens=8",
    "inference.decode_window=1",
]
# The JAX package's fault tests' traffic.
REP = [7, 8, 9, 7, 8, 9, 7, 8, 9, 7, 8]
MIX = [REP, [5, 3, 9, 250, 17], [7, 7, 7]]
# Speculative traffic: two prompts that end in loops the seed-0 tiny
# model's greedy streams fall into, so the n-gram proposer drafts (verify
# steps at engine steps 0-4, 8 and 12 with 16 new tokens).
SPEC_MIX = [[72, 62, 122] * 4, [238, 184, 167] * 4, [5, 3, 9, 250, 17]]
SPEC = ["inference.speculative=true", "inference.speculate_tokens=4"]
CHUNKED = ["inference.chunked_prefill=true", "inference.prefill_chunk_tokens=16"]
GUARD = ["inference.nan_guard=true"]
ROBUST_KEYS = tuple(RobustnessStats().as_timing())
SIDES = {"jax": j_fault, "torch": t_fault}


@pytest.fixture(scope="module")
def tiny():
    """JAX and port weights of the seed-0 tiny-llama, and the JAX engine's
    fault-free greedy streams of MIX and SPEC_MIX (the references every
    contained episode must reproduce)."""
    jcfg = j_get_config("tiny-llama", INFER)
    jp = j_init_params(jcfg.model, jax.random.key(0))
    tp = from_jax_params(jax.tree.map(np.asarray, jp), get_config("tiny-llama", INFER).model)
    eng = JEngine(jcfg, jp)
    return {"jax": jp, "torch": tp, "ref": eng.generate(MIX, 8),
            "spec_ref": eng.generate(SPEC_MIX, 16)}


def _engine(tiny, side, extra=(), faults=(), jax_extra=()):
    """One engine of ``side`` with INFER + ``extra`` and an injector built
    from ``faults`` (tuples of FaultSpec's fields), or none."""
    mod = SIDES[side]
    inj = mod.FaultInjector([mod.FaultSpec(*f) for f in faults]) if faults else None
    if side == "jax":
        cfg = j_get_config("tiny-llama", INFER + ["model.kernels=xla"] + list(extra)
                           + list(jax_extra))
        return JEngine(cfg, tiny["jax"], fault_injector=inj), inj
    cfg = get_config("tiny-llama", INFER + list(extra))
    return InferenceEngine(cfg, tiny["torch"], device="cpu", fault_injector=inj), inj


def _drain(eng, done=None):
    """Step until idle: {rid: (outcome, tokens, step it surfaced at)}."""
    done = {} if done is None else done
    while eng.has_work():
        n = eng.step_no
        for r in eng.step():
            done[r.rid] = (r.outcome, list(r.generated), n)
    return done


def _both(tiny, drive, extra=(), faults=(), jax_extra=()):
    """Run ``drive(eng)`` on the JAX and the port engine under the same
    schedule; require equal results, counters and fired faults. Returns
    the port's result with its counters under "robust"."""
    out = {}
    for side in ("jax", "torch"):
        eng, inj = _engine(tiny, side, extra, faults, jax_extra)
        res = drive(eng)
        t = eng.reset_timing()
        res["robust"] = {k: t[k] for k in ROBUST_KEYS}
        res["fired"] = list(inj.fired) if inj is not None else []
        eng.assert_page_accounting()
        eng.close()
        out[side] = res
    assert out["torch"] == out["jax"]
    return out["torch"]


def _generate(eng, prompts=MIX, n=8):
    rids = [eng.submit(p, n) for p in prompts]
    done = _drain(eng)
    return {"rids": rids, "done": done}


def _generate_spec(eng):
    return _generate(eng, SPEC_MIX, 16)


def _streams(res):
    return [res["done"][rid][1] for rid in res["rids"]]


# ---------------------------------------------------------------------------
# Contained dispatch faults and the failed-step ladder
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("path,extra,fault", [
    ("decode", [], ("dispatch", 2, "decode")),
    ("prefill", [], ("dispatch", 0, "prefill")),      # unwinds the admissions
    ("verify", SPEC, ("dispatch", 2, "verify")),
    ("mixed", CHUNKED, ("dispatch", 1, "mixed")),
    ("mixed_verify", SPEC + CHUNKED, ("dispatch", 2, "mixed_verify")),
])
def test_dispatch_fault_contained(tiny, path, extra, fault):
    """A dispatch fault fails the STEP (counted, state consistent) and every
    request completes byte-identically to the fault-free run."""
    spec = "verify" in path
    res = _both(tiny, _generate_spec if spec else _generate, extra, [fault])
    assert res["fired"] == [fault]
    assert res["robust"]["failed_steps"] == 1 and res["robust"]["dispatch_faults"] == 1
    assert _streams(res) == tiny["spec_ref" if spec else "ref"]
    assert {d[0] for d in res["done"].values()} == {"completed"}


def test_dispatch_fault_pallas_interpret_without_fallback(tiny):
    """The JAX engine on its Pallas kernels (interpret mode) with
    dispatch_fallback=false behaves as the port's envelope: the fault
    fails the step, no fallback runs."""
    res = _both(tiny, _generate, faults=[("dispatch", 2, "decode")],
                jax_extra=["model.kernels=pallas_interpret",
                           "inference.dispatch_fallback=false"])
    assert res["robust"]["failed_steps"] == 1
    assert res["robust"]["dispatch_fallbacks"] == 0
    assert _streams(res) == tiny["ref"]


def test_persistent_fault_reraises(tiny):
    """max_step_faults consecutive failed steps re-raise DispatchFault."""
    def drive(eng):
        for p in MIX:
            eng.submit(p, 8)
        with pytest.raises((DispatchFault, j_fault.DispatchFault)):
            while eng.has_work():
                eng.step()
        return {"step_no": eng.step_no}

    faults = [("dispatch", s, None, None, 0.0, 10) for s in range(20)]
    res = _both(tiny, drive, ["inference.max_step_faults=2"], faults)
    assert res["robust"]["failed_steps"] == 2 and res["step_no"] == 1


def test_pool_fault_at_admit_defers(tiny):
    res = _both(tiny, _generate, faults=[("pool", 0)])
    assert res["robust"]["pool_faults"] == 1 and res["robust"]["failed_steps"] == 0
    assert _streams(res) == tiny["ref"]


def test_pool_fault_at_grow_fails_step(tiny):
    """REP's write position crosses into its second page at step 5: the
    grow fails the step, pages stay owned, the retry completes."""
    res = _both(tiny, _generate, faults=[("pool", 5)])
    assert res["fired"] == [("pool", 5, None)]
    assert res["robust"]["pool_faults"] == 1 and res["robust"]["failed_steps"] == 1
    assert _streams(res) == tiny["ref"]


# ---------------------------------------------------------------------------
# NaN quarantine
# ---------------------------------------------------------------------------

def test_nan_guard_without_fault_bit_identical(tiny):
    res = _both(tiny, _generate, GUARD)
    assert _streams(res) == tiny["ref"]
    eng = InferenceEngine(get_config("tiny-llama", INFER), tiny["torch"], device="cpu")
    assert eng.generate(MIX, 8) == tiny["ref"]


@pytest.mark.parametrize("extra", [[], SPEC], ids=["plain", "speculative"])
def test_nan_quarantine_neighbors_exact(tiny, extra):
    """The poisoned slot ends "error:nan" (pages scrubbed, nothing donated);
    every neighbour's stream is the fault-free one. Speculative: the oldest
    slot is mid-verify at step 2, so the verify program's guard catches it."""
    spec = bool(extra)
    res = _both(tiny, _generate_spec if spec else _generate, GUARD + extra, [("nan", 2)])
    assert res["robust"]["quarantined_requests"] == 1
    ref = tiny["spec_ref" if spec else "ref"]
    outs = [res["done"][rid] for rid in res["rids"]]
    assert outs[0][0] == "error:nan" and outs[0][2] == 2   # the oldest, at once
    for i, d in enumerate(outs[1:], 1):
        assert d[0] == "completed" and d[1] == ref[i]


def test_nan_int8_chunked_decode_and_prefill_victims(tiny):
    """int8 pools, chunked prefill, the prefix cache: a decode victim (its
    k_scale rows poisoned) and a victim still in its prompt chunks, whose
    next chunks read the poisoned history. The JAX mixed step guards only
    decode rows, so the second is caught at its first guarded step: the
    port catches it at the same step."""
    long = list(range(1, 61))     # four chunks of 16, the last of 12

    def drive(eng):
        rids = [eng.submit(p, 8) for p in MIX + [long]]
        return {"rids": rids, "done": _drain(eng)}

    extra = GUARD + CHUNKED + ["inference.kv_quant=int8", "inference.prefix_cache=true"]
    res = _both(tiny, drive, extra, [("nan", 2, None, 0), ("nan", 3, None, 3)])
    outs = [res["done"][rid] for rid in res["rids"]]
    assert [d[0] for d in outs] == ["error:nan", "completed", "completed", "error:nan"]
    assert outs[3][2] > 3          # caught after its chunks, at a decode step
    assert res["robust"]["quarantined_requests"] == 2


# ---------------------------------------------------------------------------
# Deadlines, cancel, shedding, priorities, drain
# ---------------------------------------------------------------------------

def test_deadline_expiry_active_and_waiting(tiny):
    def drive(eng):
        r_dead = eng.submit_request(REP, 100)
        r_wait = eng.submit_request([5, 5, 5], 8)
        r_live = eng.submit_request(MIX[1], 8)
        eng.step()
        eng.step()
        r_dead.deadline = r_wait.deadline = time.monotonic()
        done = _drain(eng)
        assert 0 < len(done[r_dead.rid][1]) < 100 and done[r_wait.rid][1] == []
        return {"done": done}

    res = _both(tiny, drive, ["inference.max_batch_size=1"])
    assert [d[0] for d in res["done"].values()] == ["expired", "expired", "completed"]
    assert res["done"][2][1] == tiny["ref"][1]
    assert res["robust"]["expired_requests"] == 2


def test_deadline_expiry_waiting_by_clock(tiny):
    """The one case on the wall clock: a default deadline lapses while the
    request waits behind a one-slot batch."""
    def drive(eng):
        first = eng.submit_request(MIX[1], 8, deadline_s=3600.0)
        late = eng.submit_request([5, 5, 5], 8)
        eng.step()
        time.sleep(0.06)
        return {"done": _drain(eng), "first": first.rid, "late": late.rid}

    res = _both(tiny, drive, ["inference.max_batch_size=1",
                              "inference.default_deadline_s=0.05"])
    assert res["done"][res["first"]][0] == "completed"
    assert res["done"][res["late"]][0] == "expired"


def test_deadline_expiry_mid_prefill(tiny):
    def drive(eng):
        r_live = eng.submit_request(MIX[1], 8)
        r_pre = eng.submit_request(list(range(1, 91)), 8)
        eng.step()
        eng.step()
        r_pre.deadline = time.monotonic()
        done = _drain(eng)
        assert done[r_pre.rid][1] == [] and done[r_live.rid][1] == tiny["ref"][1]
        return {"done": done}

    res = _both(tiny, drive, CHUNKED + ["inference.max_batch_size=2"])
    assert [d[0] for d in res["done"].values()] == ["expired", "completed"]


def test_cancel_waiting_and_speculating_slot(tiny):
    def drive(eng):
        r_spec = eng.submit_request(SPEC_MIX[0], 24)
        r_wait = eng.submit_request([5, 5, 5], 8)
        eng.step()
        eng.step()
        verified = eng.spec_stats.verify_steps
        flags = [eng.cancel(r_wait.rid), eng.cancel(r_spec.rid)]
        done = _drain(eng)
        flags += [eng.cancel(r_spec.rid), eng.cancel(10_000)]
        return {"done": done, "flags": flags, "free": eng.alloc.free_pages,
                "verified": verified}

    res = _both(tiny, drive, SPEC + ["inference.max_batch_size=2"])
    assert res["verified"] >= 1 and res["flags"] == [True, True, False, False]
    assert {d[0] for d in res["done"].values()} == {"cancelled"}
    assert res["robust"]["cancelled_requests"] == 2 and res["free"] == 31


def test_queue_limit_sheds_lowest_priority(tiny):
    def drive(eng):
        a = eng.submit_request([1, 2, 3], 8, priority=2)
        eng.step()
        lo = eng.submit_request([4, 5], 8, priority=0)
        eng.submit_request([6, 7], 8, priority=1)
        eng.submit_request([8, 9], 8, priority=1)     # full: lo is shed
        shed_now = lo.outcome
        eng.submit_request([1, 1], 8, priority=0)     # itself the victim
        return {"done": _drain(eng), "shed_now": shed_now, "a": a.rid}

    res = _both(tiny, drive, ["inference.queue_limit=2", "inference.max_batch_size=1"])
    assert res["shed_now"] == "shed"
    assert [d[0] for d in res["done"].values()].count("shed") == 2
    assert res["robust"]["shed_requests"] == 2


def test_priority_admission_order(tiny):
    def drive(eng):
        eng.submit_request([1, 2], 4)
        eng.step()
        eng.submit_request([3, 4], 4, priority=0)
        eng.submit_request([5, 6], 4, priority=5)
        return {"done": _drain(eng)}

    res = _both(tiny, drive, ["inference.max_batch_size=1"])
    order = sorted(res["done"], key=lambda rid: res["done"][rid][2])
    assert order == [0, 2, 1]


def test_preemption_prefers_low_priority_victims(tiny):
    def drive(eng):
        lo = eng.submit_request(REP, 24, priority=0)
        eng.step()
        hi = eng.submit_request(MIX[1], 24, priority=5)
        eng.step()
        hostage = eng.alloc.alloc(eng.alloc.free_pages)
        for _ in range(20):
            if lo.slot is None or hi.slot is None:
                break
            eng.step()
        state = (lo.slot is None and not lo.done, hi.slot is not None)
        eng.alloc.free(hostage)
        return {"done": _drain(eng), "state": state}

    res = _both(tiny, drive, ["inference.max_batch_size=2"])
    assert res["state"] == (True, True)
    assert {d[0] for d in res["done"].values()} == {"completed"}


def test_pool_deferred_request_is_sheddable(tiny):
    def drive(eng):
        a = eng.submit_request([1, 2, 3], 8)
        eng.step()                        # pool fault: a deferred, un-claimed
        deferred = a.admit_seq
        eng.submit_request([4, 5], 8, priority=1)
        return {"done": _drain(eng), "deferred": deferred, "a": a.outcome}

    res = _both(tiny, drive, ["inference.queue_limit=1", "inference.max_batch_size=1"],
                [("pool", 0)])
    assert res["deferred"] == -1 and res["a"] == "shed"


def test_drain_sheds_queue_finishes_live_and_preempted(tiny):
    def drive(eng):
        live = eng.submit_request(REP, 8)
        eng.step()
        b = eng.submit_request(MIX[1], 8)
        eng.step()
        eng._preempt(b)                   # in flight again: drain finishes it
        waiters = [eng.submit_request([9, 9, 9], 8) for _ in range(3)]
        drained = eng.drain()
        post = eng.submit_request([1, 2], 4)
        return {"drained": sorted(r.rid for r in drained),
                "out": [(r.outcome, r.generated) for r in [live, b] + waiters + [post]]}

    res = _both(tiny, drive, ["inference.queue_limit=4"])
    assert res["out"][0] == ("completed", tiny["ref"][0])
    assert res["out"][1] == ("completed", tiny["ref"][1])
    assert {o for o, _ in res["out"][2:]} == {"shed"}


def test_submit_after_drain_and_close_is_typed_shed(tiny):
    def drive(eng):
        first = eng.generate(MIX[:2], 8)
        eng.drain()
        late = eng.submit_request([1, 2, 3], 4)
        surfaced = [late in eng.step()]
        eng.close()
        later = eng.submit_request([4, 5, 6], 4)
        surfaced.append(later in eng.step())
        return {"first": first, "late": (late.outcome, later.outcome), "surfaced": surfaced}

    res = _both(tiny, drive)
    assert res["first"] == tiny["ref"][:2]
    assert res["late"] == ("shed", "shed") and res["surfaced"] == [True, True]
    assert res["robust"]["shed_requests"] == 2


def test_drain_idempotent_under_concurrent_cancel(tiny):
    def drive(eng):
        reqs = [eng.submit_request(p, 8) for p in MIX]
        eng.step()
        flags = [eng.cancel(reqs[0].rid)]
        drained = sorted(r.rid for r in eng.drain())
        flags.append(eng.cancel(reqs[0].rid))
        again = eng.drain()
        return {"drained": drained, "flags": flags, "again": len(again),
                "out": [(r.outcome, r.generated) for r in reqs]}

    res = _both(tiny, drive)
    assert res["flags"] == [True, False] and res["again"] == 0
    assert res["out"][0][0] == "cancelled" and res["out"][1] == ("completed", tiny["ref"][1])


# ---------------------------------------------------------------------------
# Speculation auto-disable, watchdog, the CLI's drain
# ---------------------------------------------------------------------------

def test_spec_fault_auto_disable(tiny):
    """Past spec_fault_limit verify faults speculation switches off for the
    engine's life and decoding goes on through the plain window, exactly."""
    def drive(eng):
        res = _generate_spec(eng)
        res["disabled"] = eng._spec_disabled
        res["reason"] = eng.spec_stats.disabled_reason
        return res

    faults = [("dispatch", s, "verify") for s in range(16)]
    res = _both(tiny, drive, SPEC + ["inference.spec_fault_limit=2"], faults)
    assert res["disabled"] and "auto-disabled" in res["reason"]
    assert len(res["fired"]) == 2 and _streams(res) == tiny["spec_ref"]


def test_watchdog_stall_counted_not_fatal(tiny):
    """An injected stall past inference.watchdog_timeout_s is counted and
    the engine goes on. The timeout sits well above a tiny-model step on a
    loaded CPU, so only the injected stall counts on either engine."""
    def drive(eng):
        res = _generate(eng)
        res["running"] = eng._watchdog.running
        return res

    res = _both(tiny, drive, ["inference.watchdog_timeout_s=1.0"],
                [("stall", 2, None, None, 2.5)])
    assert res["robust"]["stalled_steps"] == 1 and res["running"]
    assert _streams(res) == tiny["ref"]


def test_engine_refuses_unported_fault_kinds(tiny):
    inj = FaultInjector([FaultSpec("migration", step=0)])
    with pytest.raises(NotImplementedError, match="not ported"):
        InferenceEngine(get_config("tiny-llama", INFER), tiny["torch"], device="cpu",
                        fault_injector=inj)


def test_generate_cli_drains_on_preemption(monkeypatch, capsys):
    """PreemptionHandler.trigger() through orion_tpu_torch.generate.main:
    after the first step the loop drains (live requests finish, the
    never-started one is shed) and main returns 0."""
    from orion_tpu_torch import generate

    class AfterFirstStep(PreemptionHandler):
        checks = 0

        @property
        def preempted(self):
            AfterFirstStep.checks += 1
            if AfterFirstStep.checks == 2:
                self.trigger()
            return super().preempted

    monkeypatch.setattr(t_fault, "PreemptionHandler", AfterFirstStep)
    tokens = ["5,3,9", "7,8", "1,2,3", "4,4", "9,9,9"]
    argv = ["--preset", "tiny-llama", "--max-new-tokens", "4", "--device", "cpu"]
    for t in tokens:
        argv += ["--tokens", t]
    assert generate.main(argv + INFER) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert out[0].startswith("SIGTERM: draining")
    lines = [json.loads(x) for x in out[1:]]
    assert [x["outcome"] for x in lines] == ["completed"] * 4 + ["shed"]
    assert [len(x["generated"]) for x in lines] == [4] * 4 + [0]


# ---------------------------------------------------------------------------
# The quarantine primitives against the JAX package's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
def test_poison_and_scrub_pages_match_jax(quant):
    L, NP, K, psz, H = 2, 6, 2, 16, 8
    rng = np.random.default_rng(0)
    if quant:
        arrs = {"k": rng.integers(-127, 128, (L * NP, K, psz, H)).astype(np.int8),
                "v": rng.integers(-127, 128, (L * NP, K, psz, H)).astype(np.int8),
                "k_scale": rng.random((L * NP, K, 128)).astype(np.float32),
                "v_scale": rng.random((L * NP, K, 128)).astype(np.float32)}
        jc = {k: jnp.asarray(v) for k, v in arrs.items()}
        tc = {k: torch.from_numpy(v.copy()) for k, v in arrs.items()}
    else:
        arrs = {n: rng.standard_normal((L * NP, K, psz, H)).astype(np.float32)
                for n in ("k", "v")}
        jc = {k: jnp.asarray(v, jnp.bfloat16) for k, v in arrs.items()}
        tc = {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in arrs.items()}
    kw = dict(n_layers=L, num_pages=NP)

    def same():
        for name in jc:
            want = np.asarray(jc[name]).view(np.uint8)
            got = tc[name].contiguous().view(torch.uint8).numpy()
            assert np.array_equal(got, want.reshape(got.shape)), name

    jc = j_kv.poison_page(jc, jnp.int32(3), **kw)
    t_kv.poison_page(tc, 3, **kw)
    same()
    target = "k_scale" if quant else "k"
    assert torch.isnan(tc[target][[3, NP + 3]].float()).all()
    jc = j_kv.scrub_pages(jc, jnp.asarray([3, 5, 0, 0], jnp.int32), **kw)
    t_kv.scrub_pages(tc, [3, 5, 0, 0], **kw)
    same()
    assert not any(torch.isnan(t.float()).any() for t in tc.values())


# ---------------------------------------------------------------------------
# runtime/fault.py's pure-Python pieces (the JAX package's own cases)
# ---------------------------------------------------------------------------

def test_preemption_handler_catches_sigterm():
    with PreemptionHandler() as h:
        assert not h.preempted
        os.kill(os.getpid(), signal.SIGTERM)
        for _ in range(50):
            if h.preempted:
                break
            time.sleep(0.01)
        assert h.preempted
    assert signal.getsignal(signal.SIGTERM) != h._on_signal


def test_preemption_handler_double_enter_restores_original():
    prev = signal.getsignal(signal.SIGTERM)
    h = PreemptionHandler()
    with h:
        installed = signal.getsignal(signal.SIGTERM)
        h.__enter__()
        assert signal.getsignal(signal.SIGTERM) == installed
        assert h._prev[signal.SIGTERM] == prev
    assert signal.getsignal(signal.SIGTERM) == prev


def test_watchdog_detects_stall_and_recovers():
    fired = []
    with Watchdog(timeout_s=0.2, on_stall=fired.append, poll_s=0.05) as wd:
        time.sleep(0.5)
        assert not wd.stalled          # unarmed before the first heartbeat
        wd.heartbeat()
        time.sleep(0.5)
        assert wd.stalled and len(fired) == 1
        wd.heartbeat()
        assert not wd.stalled
        time.sleep(0.1)
        assert len(fired) == 1
    assert not wd.running


def test_watchdog_abort_action_signals_process(monkeypatch):
    kills = []
    monkeypatch.setattr(os, "kill", lambda pid, sig: kills.append((pid, sig)))
    with Watchdog(timeout_s=0.2, poll_s=0.05, action="abort") as wd:
        wd.heartbeat()
        time.sleep(0.5)
        assert wd.stalled
    assert kills == [(os.getpid(), signal.SIGABRT)]


def test_watchdog_rejects_unknown_action():
    with pytest.raises(ValueError, match="action"):
        Watchdog(timeout_s=1.0, action="explode")


def test_watchdog_idempotent_daemon_lifecycle():
    wd = Watchdog(timeout_s=30.0, poll_s=0.05)
    assert not wd.running and not wd.armed
    wd.start()
    t1 = wd._thread
    assert wd.running and t1.daemon
    wd.start()
    assert wd._thread is t1
    wd.stop()
    assert not wd.running
    wd.stop()
    wd.start()
    assert wd.running and wd._thread is not t1
    wd.stop()
    off = Watchdog(timeout_s=None).start()
    assert not off.running
    off.stop()


def test_watchdog_quiet_under_heartbeats():
    fired = []
    with Watchdog(timeout_s=0.3, on_stall=fired.append, poll_s=0.05) as wd:
        for _ in range(6):
            time.sleep(0.05)
            wd.heartbeat()
    assert not fired and not wd.stalled


def test_fault_spec_validation_matches_jax():
    for mod in SIDES.values():
        with pytest.raises(ValueError, match="kind"):
            mod.FaultSpec("explode", step=0)
        with pytest.raises(ValueError, match="count"):
            mod.FaultSpec("dispatch", step=0, count=0)
        with pytest.raises(ValueError, match="replica"):
            mod.FaultSpec("replica_kill", step=0)
        mod.FaultSpec("replica_stall", step=0, replica=1, stall_s=0.5)


def test_fault_injector_take_matches_jax():
    """Path matching, counts and the fired log agree with the JAX copy."""
    calls = {}
    for side, mod in SIDES.items():
        seen = []
        inj = mod.FaultInjector(
            [mod.FaultSpec("dispatch", step=1, path="decode", count=2),
             mod.FaultSpec("stall", step=1), mod.FaultSpec("nan", step=2, rid=7)],
            on_fire=lambda *a: seen.append(a))
        got = [inj.take("dispatch", 1, "prefill"), inj.take("dispatch", 1, "decode"),
               inj.take("dispatch", 1, None), inj.take("dispatch", 1, "decode"),
               inj.take("stall", 1, "verify"), inj.take("nan", 2), inj.take("nan", 2)]
        calls[side] = ([None if g is None else (g.kind, g.rid) for g in got],
                       inj.fired, seen)
    assert calls["torch"] == calls["jax"]
    assert calls["torch"][1] == [("dispatch", 1, "decode"), ("dispatch", 1, None),
                                 ("stall", 1, "verify"), ("nan", 2, None)]


def test_fault_injector_observer_failure_is_contained():
    def boom(*a):
        raise RuntimeError("observer")

    inj = FaultInjector([FaultSpec("pool", step=0)], on_fire=boom)
    assert inj.take("pool", 0) is not None and inj.fired == [("pool", 0, None)]
