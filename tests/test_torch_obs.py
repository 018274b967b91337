"""The port's observability (``orion_tpu_torch/obs``, ``metrics.LatencyStats``
and their wiring through the serving engine and the trainer) against the
JAX package's on the CPU, with the same seeded inputs through both.

Units: the tracer (spans, instants, measured spans, a span that raises, a
ring of 8 fed 20 events, the null tracer, annotations, the Chrome export,
the merge), the registry (snapshot, Prometheus bytes, JSONL rows), the
flight recorder (dump document, throttle, a failed write), ``init_obs``,
``LatencyStats`` and the SLO monitor over ``tests/test_slo.py``'s cases:
equal results, times aside.

Engines (tiny-llama, float32; the JAX engine at kernels=xla, which
prefills one dispatch per prompt bucket where the port prefills one per
burst, so an unchunked burst keeps its prompts in one 16-token bucket):
with tracing on, both engines' traces give the same ordered instants and
``dispatch/*`` and ``step`` spans with the same tags, for a plain serve,
a serve with chunked prefill, the prefix cache and tree speculation, and
a fault drive (a NaN quarantine, max_step_faults) whose flight dumps and
metrics rows are held too; a long-context serve (residency demotion and
page-ins through the host tier) in the port alone. Each configuration builds one engine per
package for the module (a JAX engine compiles per instance).

The trainer (tiny, 4 steps): one fit per package with tracing, the
anomaly guard and an injected NaN step (rollback), the flight recorder
and the Prometheus export; the port's also with a profiler window.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import math
import os

import jax
import numpy as np
import pytest

from orion_tpu import metrics as j_metrics
from orion_tpu import obs as j_obs
from orion_tpu.config import SLOConfig as JSLOConfig
from orion_tpu.config import get_config as j_get_config
from orion_tpu.infer import InferenceEngine as JEngine
from orion_tpu.models import init_params as j_init_params
from orion_tpu.runtime import fault as j_fault
from orion_tpu.train import Trainer as JTrainer
from orion_tpu_torch import metrics as t_metrics
from orion_tpu_torch import obs as t_obs
from orion_tpu_torch.config import SLOConfig, get_config
from orion_tpu_torch.infer import InferenceEngine
from orion_tpu_torch.models import from_jax_params
from orion_tpu_torch.obs import trace as t_trace
from orion_tpu_torch.runtime import fault as t_fault
from orion_tpu_torch.train import Trainer

SIDES = (("jax", j_obs), ("torch", t_obs))


def _pair_of(fn):
    """``fn(obs_module)`` for each package: (jax result, port result)."""
    return fn(j_obs), fn(t_obs)


def _no_times(events):
    return [(kind, name, tags) for kind, name, _, _, tags in events]


def _chrome_shape(doc):
    """A Chrome document with the clock readings taken out."""
    evs = [{k: v for k, v in e.items() if k not in ("ts", "dur")} for e in doc["traceEvents"]]
    meta = dict(doc["metadata"])
    meta.pop("clock_base_monotonic_s")
    for p in meta.get("processes", {}).values():
        p["clock_offset_us"] = p["clock_offset_us"] is not None
    return {"traceEvents": evs, "displayTimeUnit": doc["displayTimeUnit"], "metadata": meta}


# ---------------------------------------------------------------------------
# Tracer
# ---------------------------------------------------------------------------


def _tr_span(m):
    tr = m.Tracer()
    with tr.span("a", step=1):
        pass
    with tr.span("b", annotate=True, x=2):
        pass
    return tr


def _tr_instant(m):
    tr = m.Tracer()
    tr.instant("mark", rid=7)
    tr.instant("bare")
    return tr


def _tr_record(m):
    tr = m.Tracer()
    tr.record_span("step", 10.0, 12.5, step=3, decoded=True)
    return tr


def _tr_raises(m):
    tr = m.Tracer()
    with pytest.raises(RuntimeError):
        with tr.span("boom", k=1):
            raise RuntimeError("x")
    return tr


def _tr_ring(m):
    tr = m.Tracer(capacity=8)
    for i in range(20):
        tr.instant(f"e{i}", i=i)
    return tr


def _tr_annotations(m):
    tr = m.Tracer()
    with tr.annotation("orion/decode"):
        pass
    with tr.step_annotation("train", 3):
        pass
    tr.instant("after")
    return tr


def _tr_clear(m):
    tr = m.Tracer(capacity=4)
    for i in range(10):
        tr.instant(f"e{i}")
    tr.clear()
    tr.instant("x")
    return tr


TRACER_CASES = {"span": _tr_span, "instant": _tr_instant, "record_span": _tr_record,
                "span_raises": _tr_raises, "ring_overflow": _tr_ring,
                "annotations": _tr_annotations, "clear": _tr_clear}


@pytest.mark.parametrize("case", sorted(TRACER_CASES))
def test_tracer_matches_jax(case, tmp_path):
    """The same calls give the same ring (survivors, tags, ``dropped``,
    ``metrics()``) and the same Chrome document, clock readings aside."""
    jt, tt = _pair_of(TRACER_CASES[case])
    assert _no_times(tt.events()) == _no_times(jt.events())
    assert (tt.dropped, tt.capacity, tt.metrics()) == (jt.dropped, jt.capacity, jt.metrics())
    if case == "record_span":   # a measured span keeps its times
        assert tt.events() == jt.events()
    if case == "ring_overflow":
        assert [e[1] for e in tt.events()] == [f"e{i}" for i in range(12, 20)]
        assert tt.dropped == 12
    docs = []
    for name, tr in (("j", jt), ("t", tt)):
        n = tr.export_chrome(str(tmp_path / f"{name}.json"))
        doc = json.loads((tmp_path / f"{name}.json").read_text())
        assert n == len(doc["traceEvents"]) - 1
        docs.append(_chrome_shape(doc))
    assert docs[1] == docs[0]
    assert t_obs.export_chrome_safe(tt, None) == 0
    assert t_obs.export_chrome_safe(tt, str(tmp_path / "missing" / "t.json")) == 0


def test_null_tracer_is_inert(tmp_path):
    for _, m in SIDES:
        nt = m.NULL_TRACER
        assert isinstance(nt, m.NullTracer) and nt.enabled is False
        with nt.span("a", annotate=True, step=1), nt.annotation("b"), \
                nt.step_annotation("train", 2):
            pass
        nt.instant("c")
        nt.record_span("d", 0.0, 1.0)
        assert nt.events() == [] and nt.dropped == 0 and nt.capacity == 0
        assert nt.export_chrome(str(tmp_path / "x.json")) == 0
        assert m.export_chrome_safe(nt, str(tmp_path / "y.json")) == 0
    assert not list(tmp_path.iterdir())


def test_merge_chrome_matches_jax(tmp_path):
    """One process per source on the earliest tracer's clock, a null
    source an empty process, per-process counts in the metadata."""
    docs, ns = [], []
    for name, m in SIDES:
        t1 = m.Tracer(capacity=2)
        for i in range(3):
            t1.instant("route", rid=i)
        t2 = m.Tracer()
        with t2.span("dispatch/decode", step=0):
            pass
        path = tmp_path / f"{name}.json"
        ns.append(m.merge_chrome(str(path), [("router", t1), ("replica-0", t2),
                                            ("replica-1", m.NULL_TRACER)]))
        doc = json.loads(path.read_text())
        assert doc["metadata"]["processes"]["replica-0"]["clock_offset_us"] >= 0
        docs.append(_chrome_shape(doc))
        assert m.merge_chrome_safe(None, [("a", t1)]) == 0
        assert m.merge_chrome_safe(str(path), [("a", m.NULL_TRACER)]) == 0
        assert m.merge_chrome_safe(str(tmp_path / "no" / "m.json"), [("a", t1)]) == 0
    assert ns[0] == ns[1] == 3
    assert docs[1] == docs[0]


def test_paths_and_serialized_events_match_jax():
    for path, tag in (("/tmp/trace.json", "replica-0"), ("/tmp/trace", "r1"),
                      ("rel/m.prom.txt", "replica-2")):
        assert t_obs.namespaced_path(path, tag) == j_obs.namespaced_path(path, tag)
    evs = [("span", "a", 1.0, 1.5, {"step": 1}), ("instant", "b", 2.0, 2.0, {})]
    from orion_tpu.obs.trace import serialize_events as j_ser

    assert t_trace.serialize_events(evs) == j_ser(evs)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------


REGISTRY_CASES = {
    "mixed": {"a": lambda: {"x": 1, "y": 2.5, "name": "str"}, "b": lambda: {"z": True}},
    "raising": {"ok": lambda: {"n": 3}, "bad": lambda: 1 / 0, "empty": lambda: None},
    "numbers": {"f": lambda: {"tiny": 1e-20, "neg": -3, "big": 2 ** 40, "third": 1 / 3,
                              "key-with.dots": 7, "off": False}},
}


@pytest.mark.parametrize("case", sorted(REGISTRY_CASES))
def test_registry_matches_jax(case, tmp_path):
    """Equal snapshots, byte-equal Prometheus text and JSONL rows equal but
    for the stamp; a bad section name raises in both."""
    out = {}
    for name, m in SIDES:
        reg = m.MetricsRegistry()
        for sec, fn in REGISTRY_CASES[case].items():
            reg.register(sec, fn)
        reg.register("gone", lambda: {"x": 1})
        reg.unregister("gone")
        with pytest.raises(ValueError):
            reg.register("bad name", lambda: {})
        n = reg.export_prometheus(str(tmp_path / f"{name}.prom"))
        rows = [reg.export_jsonl(str(tmp_path / f"{name}.jsonl")) for _ in range(2)]
        lines = [json.loads(x) for x in (tmp_path / f"{name}.jsonl").read_text().splitlines()]
        assert lines == rows and rows[0]["ts"] <= rows[1]["ts"]
        out[name] = (reg.sections(), reg.snapshot(), reg.snapshot(sections=("a", "nope")), n,
                     (tmp_path / f"{name}.prom").read_bytes(),
                     [{k: v for k, v in r.items() if k != "ts"} for r in rows])
    assert out["torch"] == out["jax"]


def test_device_memory_gauges_on_cpu():
    """The CPU has no allocator statistics in either package: {} (so the
    hbm section adds no key to a CPU snapshot)."""
    assert t_obs.live_hbm_metrics("cpu") == j_obs.live_hbm_metrics(jax.devices("cpu")[0]) == {}


# ---------------------------------------------------------------------------
# Flight recorder and init_obs
# ---------------------------------------------------------------------------


def _flight_unit(m, d):
    tr = m.Tracer()
    fr = m.FlightRecorder(tr, str(d), capacity=3, snapshot=lambda: {"g.x": 1})
    with tr.span("work", step=0):
        pass
    for i in range(5):
        fr.note("evt", i=i)
    p = fr.dump("unit_test", why="test")
    again = fr.dump("unit_test")               # throttled: same reason
    other = fr.dump("other_reason")
    doc = json.loads(open(p).read())
    return {
        "reason": doc["reason"], "context": doc["context"], "window_s": doc["window_s"],
        "events": [{k: v for k, v in e.items() if k != "t"} for e in doc["events"]],
        "spans": [(s["kind"], s["name"], s.get("tags")) for s in doc["spans"]],
        "metrics": doc["metrics"], "again": again, "other": other is not None,
        "dumps": len(fr.dumps), "throttled": fr.throttled,
        "files": sorted(os.path.basename(f).rsplit("_", 1)[0] for f in fr.dumps),
    }


def _flight_cap(m, d):
    fr = m.FlightRecorder(m.Tracer(), str(d), max_dumps=1, min_interval_s=0.0,
                          snapshot=lambda: 1 / 0)
    first = fr.dump("a")
    doc = json.loads(open(first).read())
    return {"second": fr.dump("b"), "throttled": fr.throttled, "metrics": doc["metrics"]}


def _flight_unwritable(m, d):
    (d / "file").write_text("")
    fr = m.FlightRecorder(m.Tracer(), str(d / "file" / "sub"))
    return {"dump": fr.try_dump("x"), "dumps": fr.dumps}


FLIGHT_CASES = {"unit": _flight_unit, "max_dumps": _flight_cap, "unwritable": _flight_unwritable}


@pytest.mark.parametrize("case", sorted(FLIGHT_CASES))
def test_flight_recorder_matches_jax(case, tmp_path):
    """The dump document (times and paths aside), the throttle's counts and
    a failed write (logged, None) are the JAX recorder's."""
    out = {}
    for name, m in SIDES:
        d = tmp_path / name
        d.mkdir()
        out[name] = FLIGHT_CASES[case](m, d)
    assert out["torch"] == out["jax"]


@pytest.mark.parametrize("trace,path,flight", [
    (False, False, False), (True, False, False), (False, True, False), (False, False, True),
])
def test_init_obs_matches_jax(trace, path, flight, tmp_path):
    """The tracer is on when anything asks for a ring; the flight recorder
    with a flight_dir, and then an injected fault lands in its ring."""
    out = {}
    for (name, m), fmod in zip(SIDES, (j_fault, t_fault)):
        inj = fmod.FaultInjector(specs=[fmod.FaultSpec("nan", step=1)])
        tr, fl = m.init_obs(trace=trace, trace_ring=16,
                            flight_dir=str(tmp_path / name) if flight else None,
                            trace_path=str(tmp_path / f"{name}.json") if path else None,
                            injector=inj)
        inj.take("nan", 1)
        out[name] = (tr.enabled, tr.capacity, fl is None, inj.on_fire is None,
                     _no_times(tr.events()),
                     [] if fl is None else [{k: v for k, v in e.items() if k != "t"}
                                            for e in fl._events])
    assert out["torch"] == out["jax"]


# ---------------------------------------------------------------------------
# LatencyStats and the SLO monitor
# ---------------------------------------------------------------------------


LATENCY_CASES = {
    "empty": [], "single": [0.5], "four": [0.040, 0.010, 0.030, 0.020],
    "hundred": [float(i) for i in range(1, 101)],
    "random": np.random.default_rng(3).exponential(0.05, 37).tolist(),
}


@pytest.mark.parametrize("case", sorted(LATENCY_CASES))
def test_latency_stats_match_jax(case):
    j, t = j_metrics.LatencyStats(), t_metrics.LatencyStats()
    for v in LATENCY_CASES[case]:
        j.record(v)
        t.record(v)
    for p in (0, 1, 25, 50, 75, 95, 99, 99.9, 100):
        assert t.percentile(p) == j.percentile(p), p
    assert t.summary() == j.summary()
    if case == "four":
        assert [t.percentile(p) for p in (25, 50, 75, 95)] == [0.010, 0.020, 0.030, 0.040]
    if case == "hundred":
        assert t.percentile(99) == 99.0


@pytest.mark.parametrize("kw", [
    dict(ttft_ms=100, per_class="2:ttft=50,itl=10", goal=0.95),
    dict(itl_ms=30.5),
    dict(per_class="-1:itl=5;0:ttft=1000", goal=0.9),
    dict(),
])
def test_build_objectives_match_jax(kw):
    j = j_obs.build_objectives(JSLOConfig(**kw))
    t = t_obs.build_objectives(SLOConfig(**kw))
    assert [(o.metric, o.target_s, o.cls, o.goal, o.key) for o in t] == \
        [(o.metric, o.target_s, o.cls, o.goal, o.key) for o in j]
    assert (t_obs.SLOMonitor.from_config(SLOConfig(**kw)) is None) == (not j)


def _objs(m):
    return [m.SLOObjective("ttft", 0.100, goal=0.9), m.SLOObjective("itl", 0.010, cls=2, goal=0.9)]


# Each case: (objectives, monitor kwargs, [("o", metric, cls, seconds, now) |
# ("s", now, force)]), the scripts of tests/test_slo.py.
SLO_CASES = {
    "no_breach": (_objs, {}, [("o", "ttft", 0, 0.05, 0.0)] * 10 + [("s", 0.5, False),
                                                                  ("s", 1.5, False)]),
    "burn_math": (_objs, {}, [("o", "ttft", 0, v, 0.0) for v in [0.05] * 7 + [0.2] * 3]
                  + [("s", 2.0, False), ("s", 5.0, False)]),
    "empty_class": (_objs, {}, [("o", "itl", 0, 9.9, 0.0)] * 5 + [("s", 2.0, False)]),
    "fleet_wide": (lambda m: [m.SLOObjective("itl", 0.010, goal=0.9)], {},
                   [("o", "itl", 0, 9.9, 0.0), ("s", 2.0, False)]),
    "min_events": (_objs, {"min_events": 5}, [("o", "ttft", 0, 9.9, 0.0)] * 4
                   + [("s", 2.0, False)]),
    "idle": (_objs, {}, [("s", 100.0, False)]),
    "forced_final": (_objs, {}, [("o", "ttft", 0, 0.5, 0.0), ("s", 0.1, False),
                                 ("s", 0.1, True)]),
    "metrics_surface": (_objs, {}, [("o", "itl", 2, 0.005, 0.0), ("o", "itl", 2, 0.020, 0.0),
                                    ("o", "ttft", 0, 0.05, 0.0), ("o", "ttft", -1, 0.3, 0.1),
                                    ("s", 2.0, False)]),
}


@pytest.mark.parametrize("case", sorted(SLO_CASES))
def test_slo_monitor_matches_jax(case):
    """The same observations and sweeps give the same breaches (callback
    and return), burns, window counts and ``metrics()``."""
    objs, kw, script = SLO_CASES[case]
    out = {}
    for name, m in SIDES:
        fired = []
        mon = m.SLOMonitor(objs(m), window_s=1.0, on_breach=fired.append, **kw)
        swept = []
        for op in script:
            if op[0] == "o":
                mon.observe(op[1], op[2], op[3], now=op[4])
            else:
                swept.append(mon.sweep(op[1], force=op[2]))
        out[name] = (swept, fired, mon.windows, mon.breaches, mon.last_burn, mon.metrics())
    assert out["torch"] == out["jax"]
    if case == "burn_math":
        assert out["torch"][0][0][0]["burn"] == pytest.approx(3.0)


# ---------------------------------------------------------------------------
# Engines
# ---------------------------------------------------------------------------


BASE = [
    "model.max_seq_len=256", "inference.max_seq_len=256", "inference.page_size=16",
    "inference.num_pages=32", "inference.max_batch_size=4", "inference.prefill_chunk=16",
]
# Configurations: overrides, and each side's sinks under {d}.
TRACE = ["inference.trace=true", "inference.trace_path={d}/trace.json"]
ENGINE_CONFIGS = {
    "plain": ["inference.decode_window=2"] + TRACE,
    "features": ["inference.decode_window=1", "inference.prefix_cache=true",
                 "inference.chunked_prefill=true", "inference.prefill_chunk_tokens=16",
                 "inference.speculative=true", "inference.speculate_tokens=4",
                 "inference.spec_tree_width=2"] + TRACE,
    "faults": ["inference.decode_window=2", "inference.nan_guard=true",
               "inference.max_step_faults=2", "inference.dispatch_fallback=false",
               "inference.flight_dir={d}/flight", "inference.metrics_jsonl={d}/m.jsonl",
               "inference.metrics_prom={d}/m.prom"] + TRACE,
    # Long context over 12 pages: page rolling, residency demotion (spill,
    # page_out) and page-ins.
    "long": ["inference.max_batch_size=2", "inference.num_pages=12",
             "inference.chunked_prefill=true", "inference.prefill_chunk_tokens=32",
             "model.sliding_window=32", "inference.long_context=true",
             "inference.host_tier_bytes=262144", "inference.host_tier_min_tokens=0",
             "inference.request_resident_pages=2"] + TRACE,
}
PLAIN_WAVES = ([[1, 2, 3], [4, 5, 6, 7], [8, 9]], [[3, 1, 4, 1, 5], [9, 2, 6], [5, 3, 5, 8, 9],
                                                  [7, 9, 3], [2, 3, 8, 4, 6, 2]])
PLAIN_TRACE_IDS = [900, 901, 902, 903, 904]
LONG_PROMPT = [(i * 11) % 250 + 1 for i in range(200)]
REP = [7, 8, 9, 7, 8, 9, 7, 8, 9, 7, 8]
MIX = [REP, [5, 3, 9, 250, 17], list(range(2, 32))]
# Keys of a metrics row that only one package has, and why.
ONLY_JAX = {
    "serve.slot_steps": "the JAX engine's decode-waste tally (not ported)",
    "serve.wasted_steps": "the JAX engine's decode-waste tally (not ported)",
    "serve.migrate_out_s": "live migration's copy time (migration waits for the router)",
    "serve.migrate_in_s": "live migration's copy time (migration waits for the router)",
}
ONLY_PORT = {
    "serve.decode_s": "the port's decode-dispatch span (decode windows and verify)",
    "serve.mixed_s": "the port's mixed-dispatch span",
    "serve.verify_s": "the port's verify share of decode_s",
    "serve.prefill_tokens": "the port's prefill token count",
    "serve.verify_steps": "the port's verify dispatch count (the JAX engine counts it "
                          "with speculation only)",
    "serve.mixed_verify_steps": "the port's mixed verify dispatch count",
}


@pytest.fixture(scope="module")
def weights():
    """Seeded numpy weights in the JAX package's layout (its init's shapes;
    normal(0, 0.02) matrices, unit norm scales), for both engines."""
    shapes = jax.eval_shape(
        lambda: j_init_params(j_get_config("tiny-llama", BASE).model, jax.random.key(0)))
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map_with_path(
        lambda path, s: np.ones(s.shape, s.dtype) if path[-1].key == "scale"
        else (rng.standard_normal(s.shape) * 0.02).astype(s.dtype), shapes)
    return (jax.tree.map(jax.numpy.asarray, params),
            from_jax_params(params, get_config("tiny-llama", BASE).model))


def _engine(side, config, d, params, injector=None, traced=True):
    ov = BASE + [o.format(d=d) for o in ENGINE_CONFIGS[config]
                 if traced or not o.startswith("inference.trace")]
    if side == "jax":
        cfg = j_get_config("tiny-llama", ov)
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, kernels="xla"))
        return JEngine(cfg, params, fault_injector=injector)
    return InferenceEngine(get_config("tiny-llama", ov), params, device="cpu",
                           fault_injector=injector)


def _drain(eng, prompts, n_new, trace_ids=None):
    """Submit ``prompts`` together and step until idle; ``trace_ids`` gives
    each request a router's trace context (its id, failover attempt 1)."""
    ctx = ([{"trace_id": t, "attempt": 1} for t in trace_ids] if trace_ids
           else [{}] * len(prompts))
    reqs = [eng.submit_request(p, n_new, **c) for p, c in zip(prompts, ctx)]
    while eng.has_work():
        eng.step()
    return [(r.outcome, r.generated) for r in reqs]


def _drive_plain(eng, inj, d):
    # The second wave carries trace ids, as a router's retried placements.
    streams = [_drain(eng, PLAIN_WAVES[0], 6),
               _drain(eng, PLAIN_WAVES[1], 5, trace_ids=PLAIN_TRACE_IDS)]
    return {"streams": streams, "timing": eng.reset_timing()}


def _drive_features(eng, inj, d):
    streams = [_drain(eng, MIX, 16), _drain(eng, MIX, 16)]
    return {"streams": streams, "timing": eng.reset_timing()}


def _drive_long(eng, inj, d):
    return {"streams": [_drain(eng, [LONG_PROMPT, LONG_PROMPT[:150]], 8)],
            "timing": eng.reset_timing()}


def _drive_faults(eng, inj, d, fmod):
    """The NaN drive (a quarantine two steps in), a drain, a clean drive and
    a drain, then two decode dispatch faults in a row (max_step_faults=2
    re-raises), then close: three metrics rows."""
    out = {}
    s0 = eng.step_no
    inj.specs.append(fmod.FaultSpec("nan", step=s0 + 2))
    out["nan"] = _drain(eng, [[1, 2, 3], [4, 5, 6, 7]], 8)
    out["t1"] = eng.reset_timing()
    out["clean"] = _drain(eng, [[2, 7, 1, 8], [2, 8]], 4)
    out["t2"] = eng.reset_timing()
    s0 = eng.step_no
    inj.specs += [fmod.FaultSpec("dispatch", step=s, path="decode") for s in (s0 + 1, s0 + 2)]
    eng.submit([1, 2, 3], 8)
    eng.step()
    eng.step()
    with pytest.raises(fmod.DispatchFault):
        eng.step()
    out["fired"] = list(inj.fired)
    return out


_RUNS: dict = {}


def _run(config, weights, tmp_path_factory, sides=("jax", "torch")):
    """Each package's engine of ``config`` through its drive (once per
    module): side -> the drive's results, the exported trace, the engine."""
    for side in sides:
        if (config, side) in _RUNS:
            continue
        params, fmod = (weights[0], j_fault) if side == "jax" else (weights[1], t_fault)
        d = tmp_path_factory.mktemp(f"{config}-{side}")
        inj = fmod.FaultInjector([]) if config == "faults" else None
        eng = _engine(side, config, d, params, inj)
        if config == "faults":
            res = _drive_faults(eng, inj, d, fmod)
        else:
            drive = {"plain": _drive_plain, "features": _drive_features,
                     "long": _drive_long}[config]
            res = drive(eng, inj, d)
        eng.close()
        res["doc"] = json.loads((d / "trace.json").read_text())
        res["eng"], res["dir"] = eng, d
        _RUNS[config, side] = res
    return {side: _RUNS[config, side] for side in sides}


def _trace_rows(doc):
    """The compared events: every instant and every dispatch/* and step
    span, in order, with their tags."""
    return [(e["name"], e["ph"], e["args"]) for e in doc["traceEvents"]
            if e["ph"] == "i" or (e["ph"] == "X" and (e["name"].startswith("dispatch/")
                                                      or e["name"] == "step"))]


@pytest.mark.parametrize("config", ["plain", "features", "faults"])
def test_engine_trace_matches_jax(config, weights, tmp_path_factory):
    """Instants and dispatch/step spans equal the JAX engine's, in order
    and tags (step, rid/tid, outcome, tokens, the live slots' tids), and
    the streams are equal."""
    r = _run(config, weights, tmp_path_factory)
    j, t = r["jax"], r["torch"]
    for k in ("streams", "nan", "clean", "fired"):
        if k in j:
            assert t[k] == j[k], k
    rows = _trace_rows(t["doc"])
    assert rows == _trace_rows(j["doc"])
    names = {n for n, _, _ in rows}
    assert {"submit", "admit", "first_token", "outcome", "step"} <= names
    if config == "features":
        assert {"dispatch/mixed", "dispatch/mixed_verify", "dispatch/verify"} <= names
    if config == "plain":
        # A router's trace context: tid is the trace id, retried the attempt.
        outcomes = [a for n, _, a in rows if n == "outcome" and "retried" in a]
        assert sorted(a["tid"] for a in outcomes) == PLAIN_TRACE_IDS
        assert all(a["retried"] == 1 for a in outcomes)
        assert any(set(a.get("tids", ())) & set(PLAIN_TRACE_IDS) for _, _, a in rows)
    assert t["doc"]["metadata"]["dropped_events"] == 0


@pytest.mark.parametrize("config", ["plain", "features", "long"])
def test_engine_trace_counts(config, weights, tmp_path_factory):
    """One dispatch/<path> span per envelope call of that path, a
    dispatch/decode span per decode window, a step span per step, one
    first_token and one outcome per request. The long-context serve (the
    port's alone: its JAX engine's compiles would double the file's time)
    also records its spills, page-ins and page_out/page_in instants."""
    t = _run(config, weights, tmp_path_factory, sides=("torch",))["torch"]
    spans = [e for e in t["doc"]["traceEvents"] if e["ph"] == "X"]
    count = {}
    for e in spans:
        count[e["name"]] = count.get(e["name"], 0) + 1
    runs = t["eng"]._executor.runs
    assert {f"dispatch/{p}": n for p, n in runs.items()} == \
        {k: v for k, v in count.items() if k.startswith("dispatch/")}
    assert count.get("dispatch/decode", 0) + count.get("dispatch/verify", 0) \
        + count.get("dispatch/mixed", 0) + count.get("dispatch/mixed_verify", 0) >= \
        t["timing"]["windows"]
    if config == "plain":
        assert count["dispatch/decode"] == t["timing"]["windows"]
    assert count["step"] == t["timing"]["steps"]
    n_req = sum(len(w) for w in t["streams"])
    inst = [e["name"] for e in t["doc"]["traceEvents"] if e["ph"] == "i"]
    assert inst.count("first_token") == inst.count("outcome") == inst.count("submit") == n_req
    if config == "long":
        assert {"dispatch/spill", "dispatch/page_in"} <= set(count)
        assert inst.count("page_out") == count["dispatch/spill"]
        assert inst.count("page_in") == count["dispatch/page_in"]


def test_tracing_off_is_the_plain_path(weights, tmp_path_factory, monkeypatch):
    """Untraced, the port's engine holds NULL_TRACER, registers no trace
    section, makes no span or annotation object, and gives the traced
    engine's streams."""
    traced = _run("plain", weights, tmp_path_factory, sides=("torch",))["torch"]

    def refuse(*a, **k):
        raise AssertionError("a tracer object was made with tracing off")

    monkeypatch.setattr(t_trace._Span, "__init__", refuse)
    monkeypatch.setattr(t_trace._Annotation, "__init__", refuse)
    eng = _engine("torch", "plain", tmp_path_factory.mktemp("off"), weights[1], traced=False)
    assert eng.tracer is t_obs.NULL_TRACER and "trace" not in eng.registry.sections()
    assert [_drain(eng, w, n) for w, n in zip(PLAIN_WAVES, (6, 5))] == traced["streams"]
    assert traced["eng"].registry.snapshot(sections=("trace",))["trace.dropped"] == 0


def _dump(d, reason):
    paths = glob.glob(str(d / "flight" / f"flight_{reason}_*.json"))
    assert len(paths) == 1, paths
    return json.loads(open(paths[0]).read())


def _dump_shape(doc):
    return {
        "reason": doc["reason"], "context": doc["context"],
        "events": [{k: v for k, v in e.items() if k != "t"} for e in doc["events"]],
        "spans": [(s["kind"], s["name"], s.get("tags")) for s in doc["spans"]],
        "robust": {k: v for k, v in doc["metrics"].items() if k.startswith("robust.")},
    }


@pytest.mark.parametrize("reason", ["nan_quarantine", "max_step_faults"])
def test_flight_dumps_match_jax(reason, weights, tmp_path_factory):
    """An injected NaN gives one quarantine dump, two decode faults in a
    row one max_step_faults dump: reason, context, the ring's events (the
    injected faults among them), the span window and the robustness
    counters equal the JAX engine's."""
    r = _run("faults", weights, tmp_path_factory)
    j, t = _dump(r["jax"]["dir"], reason), _dump(r["torch"]["dir"], reason)
    assert _dump_shape(t) == _dump_shape(j)
    kinds = [e["kind"] for e in t["events"]]
    assert "injected_fault" in kinds
    if reason == "nan_quarantine":
        assert sorted(o for o, _ in r["torch"]["nan"]) == ["completed", "error:nan"]
        assert t["metrics"]["robust.quarantined_requests"] == 1
        assert any(s["name"].startswith("dispatch/") for s in t["spans"])
    else:
        assert t["context"]["consecutive"] == 2 and kinds.count("failed_step") == 2


def _is_count(v):
    return isinstance(v, int) and not isinstance(v, bool)


def test_metrics_rows_match_jax(weights, tmp_path_factory):
    """The JSONL rows (two drains and close's) and the Prometheus file have
    the same sections and keys but for the listed ones, and every count
    the same value; the hbm section is empty on the CPU."""
    r = _run("faults", weights, tmp_path_factory)
    rows, prom = {}, {}
    for side in ("jax", "torch"):
        d = r[side]["dir"]
        rows[side] = [json.loads(x) for x in (d / "m.jsonl").read_text().splitlines()]
        prom[side] = dict(line.rsplit(" ", 1) for line in (d / "m.prom").read_text().splitlines())
    assert len(rows["torch"]) == len(rows["jax"]) == 3
    for jr, tr in zip(rows["jax"], rows["torch"]):
        assert set(jr) - set(tr) == set(ONLY_JAX)
        assert set(tr) - set(jr) == set(ONLY_PORT)
        shared = (set(jr) & set(tr)) - {"ts"}
        assert {k.split(".")[0] for k in shared} == {"serve", "pool"}
        assert {k: tr[k] for k in shared if _is_count(jr[k])} == \
            {k: jr[k] for k in shared if _is_count(jr[k])}
    for key in ("serve.steps", "serve.quarantined_requests", "serve.failed_steps"):
        assert [x[key] for x in rows["torch"]] == [x[key] for x in rows["jax"]]
    assert rows["torch"][0]["serve.quarantined_requests"] == 1
    assert rows["torch"][2]["serve.failed_steps"] == 2
    prefixed = {f"orion_{k.replace('.', '_')}" for k in set(ONLY_JAX) | set(ONLY_PORT)}
    assert set(prom["torch"]) ^ set(prom["jax"]) <= prefixed
    assert prom["torch"]["orion_serve_steps"] == prom["jax"]["orion_serve_steps"]
    # The engines' registries: the same sections, the trace ring among them.
    assert r["torch"]["eng"].registry.sections() == r["jax"]["eng"].registry.sections()
    blk = t_obs.bench_metrics_block(r["torch"]["eng"], {"steps": 1})
    assert blk["serve.steps"] == 1 and "pool.free_pages" in blk


def test_obs_report_renders_port_trace(weights, tmp_path_factory, capsys):
    """tools/obs_report.py reads the port's trace and flight dump unchanged,
    with the headings tests/test_obs.py checks for the JAX engine's."""
    import tools.obs_report as obs_report

    d = _run("plain", weights, tmp_path_factory, sides=("torch",))["torch"]["dir"]
    assert obs_report.main([str(d / "trace.json")]) == 0
    out = capsys.readouterr().out
    for heading in ("span groups by total time", "dispatch/decode",
                    "per-request TTFT breakdown", "completed"):
        assert heading in out
    fdir = _run("faults", weights, tmp_path_factory, sides=("torch",))["torch"]["dir"]
    dump = glob.glob(str(fdir / "flight" / "flight_nan_quarantine_*.json"))[0]
    assert obs_report.main([dump]) == 0
    out = capsys.readouterr().out
    assert "reason=nan_quarantine" in out and "injected_fault" in out
    assert obs_report.main(["--compare", str(d / "trace.json"), dump]) == 0
    assert "span-share diff" in capsys.readouterr().out


def test_generate_cli_trace_and_flight_dir(tmp_path, capsys):
    """``--trace`` writes the Chrome trace and prints the event count and
    the obs_report recipe; ``--flight-dir`` builds the recorder."""
    from orion_tpu_torch.generate import main

    path = tmp_path / "t.json"
    assert main(["--preset", "tiny-llama", "--tokens", "5,3,9", "--max-new-tokens", "3",
                 "--device", "cpu", "--trace", str(path), "--flight-dir",
                 str(tmp_path / "f")] + BASE) == 0
    out = capsys.readouterr().out.splitlines()
    n = len(json.loads(path.read_text())["traceEvents"]) - 1
    assert out[0] == (f"trace written to {path}: {n} events (open in Perfetto, "
                      f"or run tools/obs_report.py {path})")
    assert json.loads(out[1])["outcome"] == "completed"


# ---------------------------------------------------------------------------
# Trainer
# ---------------------------------------------------------------------------


TRAIN_OV = ["train.num_steps=4", "train.anomaly_guard=true", "train.anomaly_limit=1",
            "train.trace=true", "train.trace_path={d}/trace.json",
            "train.flight_dir={d}/flight", "checkpoint.directory={d}/ckpt",
            "checkpoint.save_interval_steps=1", "train.metrics_prom={d}/m.prom",
            "train.log_interval=2"]


@pytest.fixture(scope="module")
def train_runs(tmp_path_factory):
    """One fit per package (tiny, the JAX trainer's init in both): 4 steps,
    a NaN at step 2 rolled back, traced, with the flight recorder and the
    Prometheus file; the port's with a profiler window over step 1."""
    out = {}
    jd = tmp_path_factory.mktemp("train-jax")
    inj = j_fault.FaultInjector(specs=[j_fault.FaultSpec("nan", step=2, path="train")])
    jt = JTrainer(j_get_config("tiny", [o.format(d=jd) for o in TRAIN_OV]), fault_injector=inj)
    params = jax.tree.map(np.asarray, jt.init_state()["params"])
    out["jax"] = (jt, jt.fit(), jd)
    td = tmp_path_factory.mktemp("train-torch")
    cfg = get_config("tiny", [o.format(d=td) for o in TRAIN_OV]
                     + ["train.profile_steps=(1,2)", f"train.profile_dir={td}/prof"])
    inj = t_fault.FaultInjector(specs=[t_fault.FaultSpec("nan", step=2, path="train")])
    tt = Trainer(cfg, params=from_jax_params(params, cfg.model), device="cpu",
                 fault_injector=inj)
    out["torch"] = (tt, tt.fit(), td)
    return out


def _train_events(d):
    doc = json.loads((d / "trace.json").read_text())
    return [e for e in doc["traceEvents"] if e["ph"] != "M"]


def test_trainer_spans_match_jax(train_runs):
    """data, dispatch, guard, ckpt and train_step spans (and the injected
    fault's instant) in the JAX trainer's order with its tags; each step's
    dispatch inside its train_step span; the losses agree."""
    j, t = _train_events(train_runs["jax"][2]), _train_events(train_runs["torch"][2])
    assert [(e["name"], e["ph"], e["args"]) for e in t] == \
        [(e["name"], e["ph"], e["args"]) for e in j]
    names = [e["name"] for e in t if e["ph"] == "X"]
    # Steps 0, 1, 2 (anomalous: no ckpt), 2 again after the rollback, 3.
    assert {p: names.count(p) for p in ("data", "dispatch", "guard", "ckpt", "train_step")} \
        == {"data": 5, "dispatch": 5, "guard": 5, "ckpt": 4, "train_step": 5}
    spans = [e for e in t if e["ph"] == "X"]
    steps = [e for e in spans if e["name"] == "train_step"]
    for phase in ("data", "dispatch", "guard"):
        inner = [e for e in spans if e["name"] == phase]
        for e, s in zip(inner, steps):
            assert s["ts"] <= e["ts"] and e["ts"] + e["dur"] <= s["ts"] + s["dur"] + 1.0
    jl = [m.loss for m in train_runs["jax"][1]]
    tl = [m.loss for m in train_runs["torch"][1]]
    assert len(tl) == len(jl) == 5 and math.isnan(tl[2]) and math.isnan(jl[2])
    assert np.allclose([x for i, x in enumerate(tl) if i != 2],
                       [x for i, x in enumerate(jl) if i != 2], rtol=1e-4, atol=1e-4)


def test_trainer_rollback_dump_matches_jax(train_runs):
    """The anomaly rollback's postmortem: its context, event ring (the
    injected fault), span window (the anomalous train_step closed) and
    robust.rollbacks are the JAX trainer's."""
    dumps = {}
    for side in ("jax", "torch"):
        paths = glob.glob(str(train_runs[side][2] / "flight" / "flight_anomaly_rollback_*"))
        assert len(paths) == 1
        dumps[side] = json.loads(open(paths[0]).read())
    assert _dump_shape(dumps["torch"]) == _dump_shape(dumps["jax"])
    t = dumps["torch"]
    assert t["context"] == {"failed_step": 2, "anomaly_run": 1}
    assert t["metrics"]["robust.rollbacks"] == 1
    assert any(e["kind"] == "injected_fault" for e in t["events"])
    assert any(s["name"] == "train_step" and s.get("tags", {}).get("anomalous")
               for s in t["spans"])
    assert train_runs["torch"][0].robustness.rollbacks == 1


def test_trainer_prometheus_and_profile_window(train_runs):
    """The Prometheus file holds the JAX trainer's keys (train and robust
    sections) with the same robust counts; the profiler window's trace
    under profile_dir holds the train#1 range and no other step's."""
    prom = {}
    for side in ("jax", "torch"):
        text = (train_runs[side][2] / "m.prom").read_text()
        prom[side] = dict(line.rsplit(" ", 1) for line in text.splitlines())
    assert set(prom["torch"]) == set(prom["jax"])
    assert {k: v for k, v in prom["torch"].items() if "robust" in k} == \
        {k: v for k, v in prom["jax"].items() if "robust" in k}
    assert prom["torch"]["orion_robust_rollbacks"] == "1"
    d = train_runs["torch"][2] / "prof"
    [path] = glob.glob(str(d / "*.json"))
    ranges = {e.get("name") for e in json.loads(open(path).read())["traceEvents"]}
    assert "train#1" in ranges and not {"train#0", "train#2", "train#3"} & ranges
