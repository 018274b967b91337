"""The port's long-context serving (inference.long_context: lazy chunk
provisioning, sliding-window page rolling, residency demotion, preempt-to-
host, the typed "shed:context_too_long", the restore fault mid page-in)
and the gather prefill body (inference.paged_prefill=false) on the CPU,
against the JAX package's engine (xla kernels) with the same seeded
weights.

The counterpart of ``tests/test_long_context.py``'s serving tests: with no
tolerance, the two engines give the same greedy streams, typed outcomes,
surfacing steps, paging and robustness counters, fired faults and host
pool state, and each over-pool stream equals the same request's on a pool
large enough to hold it. Left out: the paged-flash prefill kernel's parity
grid (K9, held by ``tests/test_torch_paged_ops.py``) and the serving bench
smoke (``tools/longcontext_bench.py``, not ported). The gather prefill
body's engine tests sit with K3's positions tests
(``tests/test_torch_attention_pos.py``).

A JAX engine compiles its programs per instance, so each configuration
builds one engine per package for the module, and the tests of a
configuration drive it in turn from idle (pools and host slots free, as
``assert_page_accounting`` checks after each drive): both packages' engines
go through the same drives in the same order, and surfacing steps count
from the drive's start.
"""

import dataclasses

import jax
import numpy as np
import pytest

from orion_tpu.config import get_config as j_get_config
from orion_tpu.infer import InferenceEngine as JEngine
from orion_tpu.models import init_params as j_init_params
from orion_tpu.runtime import fault as j_fault
from orion_tpu_torch.config import get_config
from orion_tpu_torch.infer import InferenceEngine
from orion_tpu_torch.metrics import PrefixCacheStats, RobustnessStats
from orion_tpu_torch.models import from_jax_params
from orion_tpu_torch.runtime import fault as t_fault
from tests import torch_threads  # noqa: F401  (one intra-op thread)

BASE = [
    "inference.max_seq_len=256", "inference.page_size=16",
    "inference.max_batch_size=2", "inference.prefill_chunk=16",
    "inference.max_new_tokens=8", "inference.chunked_prefill=true",
    "inference.prefill_chunk_tokens=32", "model.sliding_window=32",
]
LONG = ["inference.long_context=true", "inference.host_tier_bytes=262144",
        "inference.host_tier_min_tokens=0"]
# 200 tokens = 12.5 pages: the eager need never fits the 12-page pool, and
# the last chunk straddles a page (200 % 32 = 8).
PROMPT = [(i * 11) % 250 + 1 for i in range(200)]
COUNTERS = tuple(PrefixCacheStats().as_timing()) + tuple(RobustnessStats().as_timing())


@pytest.fixture(scope="module")
def weights():
    jcfg = j_get_config("tiny-llama", BASE)
    jp = j_init_params(jcfg.model, jax.random.key(0))
    return jp, from_jax_params(jax.tree.map(np.asarray, jp), get_config("tiny-llama", BASE).model)


def _cfgs(overrides, long=True):
    ov = BASE + (LONG if long else []) + list(overrides)
    jcfg = j_get_config("tiny-llama", ov)
    jcfg = dataclasses.replace(jcfg, model=dataclasses.replace(jcfg.model, kernels="xla"))
    return jcfg, get_config("tiny-llama", ov)


_ENGINES: dict = {}


def _engine(weights, side, overrides=(), long=True):
    """The module's engine of ``side`` for this configuration, idle, with
    a fault injector whose specs a test appends."""
    key = (side, tuple(overrides), long)
    if key not in _ENGINES:
        jcfg, cfg = _cfgs(overrides, long)
        mod = j_fault if side == "jax" else t_fault
        inj = mod.FaultInjector([])
        _ENGINES[key] = (JEngine(jcfg, weights[0], fault_injector=inj) if side == "jax"
                         else InferenceEngine(cfg, weights[1], device="cpu", fault_injector=inj))
    eng = _ENGINES[key]
    assert not eng.has_work()
    eng.reset_timing()
    eng.t0, eng.fired0, eng.preempt0 = eng.step_no, len(eng._injector.fired), eng.preemptions
    return eng


def _both(weights, drive, overrides=(), long=True):
    """``drive(eng, side)`` on both engines; results, counters, fired
    faults and host pool state must be equal. Returns the port's, with
    its timing under "timing"."""
    out = {}
    for side in ("jax", "torch"):
        eng = _engine(weights, side, overrides, long)
        res = drive(eng, side)
        t = eng.reset_timing()
        assert not {"counters", "fired", "host_pool", "preemptions"} & set(res)
        res["counters"] = {k: t.get(k) for k in COUNTERS}
        res["fired"] = [(k, s - eng.t0, r) for k, s, r in eng._injector.fired[eng.fired0:]]
        res["preemptions"] = eng.preemptions - eng.preempt0
        hp = eng._host_pool
        if hp is not None:
            res["host_pool"] = (hp.capacity, hp.free_slots)
        eng.assert_page_accounting()
        out[side] = res
        timing = t
    assert out["torch"] == out["jax"]
    return dict(out["torch"], timing=timing)


def _drain(eng, done=None):
    """Step until idle: {rid: (outcome, tokens, step it surfaced at,
    counted from the drive's start)}."""
    done = {} if done is None else done
    while eng.has_work():
        n = eng.step_no - eng.t0
        for r in eng.step():
            done[r.rid] = (r.outcome, list(r.generated), n)
    return done


_REF: dict = {}


def _reference(weights, overrides=()):
    """The request's stream on a 64-page pool without long_context (the
    identity every over-pool run is held to)."""
    key = tuple(overrides)
    if key not in _REF:
        _REF[key] = InferenceEngine(_cfgs(["inference.num_pages=64"] + list(overrides),
                                          long=False)[1], weights[1],
                                    device="cpu").generate([PROMPT], 8)[0]
    return _REF[key]


def _serve(eng, side):
    r = eng.submit_request(PROMPT, 8)
    done = _drain(eng)
    return {"done": done[r.rid], "free": eng.alloc.free_pages}


def test_validation(weights):
    """long_context needs chunked prefill and a host tier: the JAX
    engine's messages."""
    _, params = weights
    msgs = {}
    for side in ("jax", "torch"):
        no_chunk = [o for o in BASE if "chunk" not in o or "prefill_chunk=" in o]
        cases = [(no_chunk + LONG, "chunked"), (BASE + ["inference.long_context=true"], "host_tier")]
        for ov, word in cases:
            cfg = (j_get_config if side == "jax" else get_config)("tiny-llama", ov)
            with pytest.raises(ValueError, match=word) as e:
                if side == "jax":
                    JEngine(cfg, weights[0])
                else:
                    InferenceEngine(cfg, params, device="cpu")
            msgs.setdefault(side, []).append(str(e.value))
    assert msgs["torch"] == msgs["jax"]


@pytest.mark.parametrize("kv", ["float32", "int8"])
def test_overpool_admit_and_complete(weights, kv):
    """A greedy request whose eager footprint exceeds the pool is admitted
    on its lazy working set, rolls its pages behind the window and ends
    with the large pool's stream; with int8 pools and a residency cap of
    one page, its demoted pages (scale rows too) come back bit for bit."""
    ov = ["inference.num_pages=12"]
    if kv == "int8":
        ov += ["inference.kv_quant=int8", "inference.request_resident_pages=1"]
    res = _both(weights, _serve, ov)
    assert res["done"][1] == _reference(weights, ov[1:2])
    assert res["done"][0] == "completed" and res["free"] == 11
    if kv == "int8":
        c = res["counters"]
        assert c["request_paged_out"] > 0 and c["request_paged_out"] == c["request_paged_in"]


def test_residency_demotion_round_trip(weights):
    """request_resident_pages=1: every demoted page pages back in before
    the chunk that reads it, the page_in_s bucket fills, no slot stays."""
    res = _both(weights, _serve, ["inference.num_pages=12", "inference.request_resident_pages=1"])
    assert res["done"][1] == _reference(weights)
    c = res["counters"]
    assert c["request_paged_out"] > 0 and c["request_paged_out"] == c["request_paged_in"]
    assert res["timing"]["page_in_s"] > 0 and res["timing"]["spill_s"] > 0
    assert res["host_pool"][0] == res["host_pool"][1]


def test_shed_context_too_long(weights):
    """Full attention over the pool cannot run lazily: a typed
    "shed:context_too_long" and its counter, never a raise; feasible work
    still serves on the same engine."""
    ov = [o for o in BASE if "sliding" not in o] + LONG + ["inference.num_pages=12"]

    def drive(eng, side):
        r = eng.submit_request(PROMPT, 8)
        outcome, shed = r.outcome, eng.robust.shed_context
        first = eng.step()
        return {"at_submit": (outcome, shed), "surfaced": [x.rid for x in first],
                "short": eng.generate([PROMPT[:40]], 4)}

    out = {}
    for side in ("jax", "torch"):
        cfg = (j_get_config if side == "jax" else get_config)("tiny-llama", ov)
        eng = (JEngine(cfg, weights[0]) if side == "jax"
               else InferenceEngine(cfg, weights[1], device="cpu"))
        res = drive(eng, side)
        t = eng.reset_timing()
        res["counters"] = {k: t.get(k) for k in COUNTERS}
        eng.assert_page_accounting()
        out[side] = res
    assert out["torch"] == out["jax"]
    assert out["torch"]["at_submit"] == ("shed:context_too_long", 1)
    assert out["torch"]["counters"]["shed_requests"] == 1


@pytest.mark.parametrize("min_tokens", [0, 100000])
def test_preempt_long_request(weights, min_tokens):
    """Preempting a long request mid-prefill: past the break-even its live
    pages go to the host and it resumes at its cursor (no re-prefill);
    below it, the plain preemption recomputes. Same stream either way."""
    def drive(eng, side):
        r = eng.submit_request(PROMPT, 8)
        for _ in range(3):
            eng.step()
        cursor = r.prefill_done
        eng._preempt(r)
        spilled = (sorted(r.host_pages), r.host_cursor, r.prefill_done, r.slot)
        eng.assert_page_accounting()
        done = _drain(eng)
        return {"cursor": cursor, "spilled": spilled, "done": done[r.rid],
                "resumed_at_or_past": r.prefill_done >= cursor}

    # min_tokens 0 is LONG's own: the over-pool test's engine.
    res = _both(weights, drive, ["inference.num_pages=12"] + (
        [f"inference.host_tier_min_tokens={min_tokens}"] if min_tokens else []))
    assert res["done"][1] == _reference(weights)
    pages, host_cursor, _, slot = res["spilled"]
    assert slot is None
    if min_tokens == 0:
        assert pages and host_cursor == res["cursor"]
        c = res["counters"]
        assert c["request_paged_out"] > 0 and c["request_paged_out"] == c["request_paged_in"]
    else:
        assert not pages and res["spilled"][2] == 0


def test_swa_roll_drops_host_resident_page(weights):
    """A host-resident page the window rolls past leaves the tier at
    once, never restored to die."""
    def drive(eng, side):
        r = eng.submit_request(PROMPT, 8)
        for _ in range(3):
            eng.step()
        hp = eng._host_pool
        j = r.freed_until - 1
        assert j >= 0 and r.pages[j] is None
        r.host_pages[j] = hp.alloc(1)[0]
        free_before = hp.free_slots
        eng._roll_window()
        rolled = (j not in r.host_pages, hp.free_slots - free_before)
        return {"rolled": rolled, "done": _drain(eng)[r.rid]}

    res = _both(weights, drive, ["inference.num_pages=12"])
    assert res["rolled"] == (True, 1) and res["done"][1] == _reference(weights)


def test_speculation_held_while_pages_nonresident(weights):
    """A decode slot with a host-resident page drafts nothing (its verify
    would read a page not restored yet) until the page-in lands."""
    ov = ["inference.num_pages=12", "inference.speculative=true", "inference.decode_window=1"]

    def drive(eng, side):
        r = eng.submit_request(PROMPT, 6)
        while r.prefill_pending or not r.generated:
            eng.step()
        live = [j for j in range(r.freed_until, len(r.pages)) if r.pages[j] is not None]
        page = r.pages[live[0]]
        hids = eng._spill_pages([page], tree=False)
        r.host_pages[live[0]] = hids[0]
        r.pages[live[0]] = None
        eng.page_table[r.slot, live[0]] = 0
        eng.alloc.free([page])
        drafts = eng._propose_drafts([r])
        held = drafts is None or not drafts.get(r.slot)
        eng._page_in_request(r)
        return {"held": held, "resident": not r.host_pages, "done": _drain(eng)[r.rid]}

    res = _both(weights, drive, ov)
    assert res["held"] and res["resident"]
    assert res["done"][1] == _reference(weights)[:6]


def test_restore_fault_mid_page_in(weights):
    """A "restore" fault mid page-in fails the step, frees the fresh
    pages, keeps every host ref; the retry completes the same stream."""
    def drive(eng, side):
        r = eng.submit_request(PROMPT, 8)
        for _ in range(2):
            eng.step()
        held = dict(r.host_pages)
        assert held, "a residency cap of one page has demoted by now"
        eng._injector.specs.append(
            (j_fault if side == "jax" else t_fault).FaultSpec("restore", step=eng.step_no))
        eng.step()
        kept = (r.host_pages == held, eng.robust.failed_steps)
        eng.assert_page_accounting()
        return {"kept": kept, "done": _drain(eng)[r.rid]}

    res = _both(weights, drive, ["inference.num_pages=12", "inference.request_resident_pages=1"])
    assert res["kept"] == (True, 1) and res["done"][1] == _reference(weights)
    assert res["counters"]["dispatch_faults"] >= 1 and res["counters"]["failed_steps"] == 1


def test_two_long_requests_share_an_undersized_pool(weights):
    """Two over-pool requests at once on 14 pages with a residency cap:
    demotion, page-ins and preemption to the host interleave, and both
    streams equal their large-pool references."""
    ov = ["inference.num_pages=14", "inference.request_resident_pages=2"]
    other = [(i * 5) % 250 + 3 for i in range(180)]

    def drive(eng, side):
        rids = [eng.submit(PROMPT, 8), eng.submit(other, 8)]
        done = _drain(eng)
        return {"done": [done[r] for r in rids]}

    res = _both(weights, drive, ov)
    ref = InferenceEngine(_cfgs(["inference.num_pages=64"], long=False)[1], weights[1],
                          device="cpu").generate([PROMPT, other], 8)
    assert [d[1] for d in res["done"]] == ref
    assert res["counters"]["request_paged_out"] > 0
