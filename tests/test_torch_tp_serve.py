"""The port's serving engine at tp = 2 on the CPU against the JAX engine
at the same mesh.

Two gloo rank processes (``tests/torch_tp_worker.py``, one spawn for the
file; the ranks join through ``runtime.coordinator_address`` with a
``file://`` store) each build an ``InferenceEngine`` from their blocks of
the JAX package's init (``models.convert.serving_blocks``) and serve the
same waves, while the JAX engine serves them on the fake devices of
``conftest.py`` with its parameters placed by ``param_shardings`` at
``tp = 2`` (``kernels="xla"``: XLA partitions the math from the
shardings; the JAX package's own tests pin those streams to the
``pallas_interpret`` ones). tiny-llama has 2 kv heads, so each rank holds
one. Held at float32, exactly: the greedy streams of every rank equal the
JAX engine's for plain decode (K4), chunked prefill with the prefix cache
and a warm second wave (K9, copy-on-write), int8 KV, chain and tree
speculation (K10), and tiny-gemma2 generating past its window (softcaps,
post-norms, tied embeddings, per-layer windows). Then the layout (each
rank's blocks are the ones JAX places on the device at its mesh position,
1/tp of every tp-sharded leaf), the pool (the ranks' slices put back
together along the kv heads equal the port's tp = 1 pool after the same
waves, to 1e-5 at float32; an int8 pool after dequantization, to one
quantization step of either side), the collectives (no byte staged for
CPU tensors, every rank the same counts), one slow rank: rank 1
sleeps before every step while deadlines expire, the decode window
autotunes and the watchdog counts stalls, and both ranks end with the same
streams, typed outcomes and counters, under the spawn's own timeout; and a
NaN page injected on rank 0 alone, which both ranks quarantine as the tp =
1 engine does. And, held against the port's tp = 1 engine with the same
seed (the JAX engine draws from another generator): sampled decode and
sampled speculation (temperature, top-k, top-p: every rank draws the same
tokens), and the host tier (the prefix cache demoted to host slots after
a wave, restored into each rank's pool slice by the next).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from orion_tpu.config import ParallelConfig as JParallel
from orion_tpu.config import get_config as j_get_config
from orion_tpu.infer import InferenceEngine as JEngine
from orion_tpu.models import init_params as j_init_params
from orion_tpu.models import param_logical_axes as j_param_logical_axes
from orion_tpu.parallel import param_shardings
from orion_tpu.runtime import build_mesh as j_build_mesh
from orion_tpu_torch.config import get_config
from orion_tpu_torch.infer import InferenceEngine
from orion_tpu_torch.models import from_jax_params
from orion_tpu_torch.models.convert import tree_leaves_with_path
from tests import torch_threads  # noqa: F401  (one intra-op thread)
from tests import torch_tp_worker as W

INFER = ["inference.max_seq_len=128", "inference.page_size=16", "inference.num_pages=32",
         "inference.max_batch_size=4", "inference.prefill_chunk=16",
         "inference.prefill_chunk_tokens=32"]
_rng = np.random.default_rng(0)
SYS = _rng.integers(1, 256, 32).tolist()             # two pages
WAVE1 = [SYS + _rng.integers(1, 256, n).tolist() for n in (16, 5, 37)]
# The second wave hits the cached system prompt, and its last prompt is a
# page-multiple prompt of the first wave whose whole context is cached
# (the copy-on-write admission).
WAVE2 = [SYS + _rng.integers(1, 256, n).tolist() for n in (3, 20)] + [WAVE1[0]]
SPEC = [[7, 8, 9, 7, 8, 9, 7, 8, 9, 7, 8], [5, 3, 9, 250, 17], list(range(2, 32))]
SPEC_ON = ["inference.speculative=true", "inference.speculate_tokens=4",
           "inference.decode_window=1"]
# id -> (preset, overrides, waves, new tokens a request)
CASES = {
    "plain": ("tiny-llama", [], [WAVE1, WAVE2], 8),
    "chunked_prefix": ("tiny-llama", ["inference.chunked_prefill=true",
                                      "inference.prefix_cache=true"], [WAVE1, WAVE2], 8),
    "int8": ("tiny-llama", ["inference.kv_quant=int8"], [WAVE1, WAVE2], 8),
    "spec_chain": ("tiny-llama", SPEC_ON, [SPEC], 40),
    "spec_tree": ("tiny-llama", SPEC_ON + ["inference.spec_tree_width=2"], [SPEC], 40),
}
GEMMA = ("tiny-gemma2", [], [[[5, 3, 9, 250, 17]]], 24)    # context 29 > window 16
# Held against the port's tp = 1 engine (the JAX engine draws from another
# generator): sampled decode and sampled speculation (rejection sampling),
# every rank drawing from the whole logits with the same seed; and the host
# tier, the prefix cache demoted after every wave, so the second wave
# restores its 6 shared pages from the host slots of each rank's slice.
SAMPLED = ["inference.temperature=0.8", "inference.top_k=50", "inference.top_p=0.9"]
SHARED = [(i * 7) % 250 + 1 for i in range(96)]                 # 6 full pages
TIER = ["inference.prefix_cache=true", "inference.host_tier_bytes=131072",
        "inference.host_tier_min_tokens=0"]
TP1_CASES = {
    "sampled": ("tiny-llama", SAMPLED, [WAVE1, WAVE2], 8),
    # top-k 2, so some drafts are accepted and some rejected.
    "sampled_spec": ("tiny-llama", SPEC_ON + SAMPLED[:1] + ["inference.top_k=2",
                                                         "inference.top_p=0.9"], [SPEC], 24),
    "host_tier": ("tiny-llama", TIER, [[SHARED, [5, 3, 9]], [SHARED + [7, 8], SHARED]], 6),
}
OFFLOAD = ("host_tier",)
KEEP = ("plain", "int8", "host_tier")
# The slow rank: deadlines that expire mid-serve, the autotune, a watchdog
# that flags the slow steps; rank 1 sleeps before every step.
SLOW = ("tiny-llama", ["inference.decode_window=1", "inference.decode_window_max=8",
                       "inference.decode_window_autotune=true",
                       "inference.watchdog_timeout_s=0.02"],
        [WAVE1 + [[42, 7]]], 40)
SLOW_DEADLINES = [None, 0.3, None, 0.05]
SLOW_SLEEP_S = 0.03
# The NaN guard with a page poisoned at step 2 on rank 0 only.
NAN = ("tiny-llama", ["inference.nan_guard=true", "inference.decode_window=1"],
       [WAVE1], 8)
NAN_SPEC = dict(kind="nan", step=2)

_PARAMS: dict = {}


def jax_params(preset):
    if preset not in _PARAMS:
        _PARAMS[preset] = j_init_params(j_get_config(preset).model, jax.random.key(0))
    return _PARAMS[preset]


def mesh_of(devices, **sizes):
    p = JParallel(**sizes)
    return j_build_mesh(p, devices=devices[:p.num_devices])


def jax_streams(mesh, preset, overrides, waves, n_new):
    """The JAX engine's streams per wave, its parameters placed at ``mesh``."""
    jcfg = j_get_config(preset, INFER + overrides)
    jcfg = dataclasses.replace(jcfg, model=dataclasses.replace(jcfg.model, kernels="xla"))
    placed = jax.device_put(jax_params(preset),
                            param_shardings(mesh, j_param_logical_axes(jcfg.model)))
    eng = JEngine(jcfg, placed)
    return [eng.generate(w, n_new) for w in waves], placed


def rank_cases(cases, mesh_overrides):
    """The worker's cases: each configuration with the mesh's overrides and
    the JAX init as numpy."""
    return [{"id": name, "preset": preset, "overrides": INFER + mesh_overrides + ov,
             "params": jax.tree.map(np.asarray, jax_params(preset)), "waves": waves,
             "n_new": n_new, "keep": name in KEEP, "offload": name in OFFLOAD}
            for name, (preset, ov, waves, n_new) in cases.items()]


@pytest.fixture(scope="module")
def served(tmp_path_factory, cpu_devices):
    """(JAX streams and placed params by case, the port's rows by rank):
    the ranks serve while the JAX engines do."""
    cases = dict(CASES, gemma2=GEMMA)
    jobs = rank_cases(dict(cases, **TP1_CASES), ["parallel.tp=2"])
    slow_preset, slow_ov, slow_waves, slow_new = SLOW
    jobs.append({"id": "slow", "preset": slow_preset, "overrides": INFER + ["parallel.tp=2"]
                 + slow_ov, "params": jobs[0]["params"], "waves": slow_waves,
                 "n_new": slow_new, "deadlines": SLOW_DEADLINES, "slow": (1, SLOW_SLEEP_S)})
    nan_job, = rank_cases({"nan": NAN}, ["parallel.tp=2"])
    jobs.append(dict(nan_job, specs={0: [NAN_SPEC]}))
    tmp = tmp_path_factory.mktemp("tp2")
    ctx = W.spawn(2, jobs, tmp)
    mesh = mesh_of(cpu_devices, tp=2)
    want = {name: jax_streams(mesh, preset, ov, waves, n_new)
            for name, (preset, ov, waves, n_new) in cases.items()}
    ranks = W.collect(ctx, 2, tmp, timeout=300.0)
    for r in ranks:
        assert not r.pop("jax_imported")
    return want, ranks, mesh


@pytest.mark.parametrize("case", list(CASES) + ["gemma2"])
def test_streams_match_jax_at_tp2(served, case):
    want, ranks, _ = served
    for r in ranks:
        assert r[case]["streams"] == want[case][0], case
        assert all(o == "completed" for wave in r[case]["outcomes"] for o in wave)
    assert ranks[0][case]["coords"]["tp"] == 0 and ranks[1][case]["coords"]["tp"] == 1
    # Each rank's pool holds K / tp = 1 kv head of every page.
    assert all(r[case]["cache_shapes"]["k"][1] == 1 for r in ranks)
    assert ranks[0][case]["local_heads"] == ranks[1][case]["local_heads"]


def test_features_ran_their_paths(served):
    """The warm wave hit the prefix cache (and copied a page on write),
    and the speculating engines accepted drafts, on both ranks alike."""
    _, ranks, _ = served
    for r in ranks:
        p = r["chunked_prefix"]["prefix"]
        assert p["hits"] > 0 and p["cow_pages"] > 0
        for case in ("spec_chain", "spec_tree"):
            assert r[case]["spec"]["accepted"] > 0
        assert r["spec_tree"]["spec"]["tree_branch_nodes"] > 0
    for case in CASES:
        for key in ("prefix", "spec", "robust", "calls"):
            assert ranks[0][case][key] == ranks[1][case][key], (case, key)


def test_collectives_stage_nothing_on_cpu(served):
    """CPU tensors on a gloo group are not staged: zero bytes, while every
    row-parallel product and logits gather ran."""
    _, ranks, _ = served
    for r in ranks:
        for case in CASES:
            assert r[case]["staged"] == {}
            assert r[case]["calls"]["all_reduce"] > 0 and r[case]["calls"]["all_gather"] > 0
            assert r[case]["plan_broadcasts"] == 0


def test_rank_blocks_are_jax_device_blocks(served):
    """Each rank's engine holds the bytes JAX's ``NamedSharding`` places on
    the device at its mesh position: 1/tp of every heads, kv_heads, mlp
    and vocab leaf."""
    want, ranks, mesh = served
    placed = want["plain"][1]
    by_rank = [dict(tree_leaves_with_path(r["plain"]["blocks"])) for r in ranks]
    devices = list(mesh.devices.reshape(-1))
    cut = 0
    for path, arr in jax.tree_util.tree_flatten_with_path(placed)[0]:
        keys = tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path)
        for s in arr.addressable_shards:
            rank = devices.index(s.device)
            data = np.asarray(s.data)
            if keys[0] == "blocks":      # stacked [L, ...]; the port's per layer
                for layer in range(data.shape[0]):
                    got = by_rank[rank][("blocks", layer) + keys[1:]].numpy()
                    np.testing.assert_array_equal(got, data[layer], err_msg=str(keys))
            else:
                np.testing.assert_array_equal(by_rank[rank][keys].numpy(), data,
                                              err_msg=str(keys))
            cut += data.shape != arr.shape
    assert cut > 0


def _tp1_drive(case):
    """The port's tp = 1 engine (seed 0, as every rank's) through ``case``'s
    waves, offloading after each where the ranks do: (streams per wave,
    the engine)."""
    preset, overrides, waves, n_new = {**CASES, **TP1_CASES}[case]
    cfg = get_config(preset, INFER + overrides)
    params = from_jax_params(jax.tree.map(np.asarray, jax_params(preset)), cfg.model)
    eng = InferenceEngine(cfg, params, device="cpu")
    streams = []
    for w in waves:
        streams.append(eng.generate(w, n_new))
        if case in OFFLOAD:
            eng.offload_prefix_cache()
    return streams, eng


@pytest.mark.parametrize("case", list(TP1_CASES))
def test_streams_match_tp1_port_at_tp2(served, case):
    """Sampled decode and sampled speculation at temperature 0.8, top-k 50
    (2 for speculation) and top-p 0.9, and the host tier: both ranks emit the same streams,
    equal to the port's tp = 1 engine's with the same seed (every rank
    draws from the whole gathered logits with a generator seeded as its
    peers'; a restored page is the rank's slice of the page it demoted),
    and the ranks' counters agree."""
    want, ranks, _ = served
    ref, eng = _tp1_drive(case)
    for r in ranks:
        assert r[case]["streams"] == ref, case
        assert all(o == "completed" for wave in r[case]["outcomes"] for o in wave)
    for key in ("prefix", "spec", "robust", "calls"):
        assert ranks[0][case][key] == ranks[1][case][key], (case, key)
    got = ranks[0][case]
    if case == "sampled":
        assert got["streams"] != want["plain"][0]      # the draws left the greedy path
    elif case == "sampled_spec":
        assert got["spec"]["drafted"] > 0
        assert got["spec"]["drafted"] > got["spec"]["accepted"] > 0
    else:
        p, p1 = got["prefix"], dataclasses.asdict(eng.prefix_stats)
        assert p["evicted_to_host"] > 0 and p["host_hits"] > 0
        assert p["host_restored_pages"] == p1["host_restored_pages"] == 6


@pytest.mark.parametrize("case", KEEP)
def test_rank_pools_put_together_equal_tp1_pool(served, case):
    """The ranks' pool slices, concatenated along the kv heads, equal the
    port's tp = 1 pool after the same waves (with the host tier: after
    pages were demoted and restored): float32 to 1e-5; int8 pools
    dequantized, each element within one quantization step (the larger of
    the two sides' scales) plus 1e-5, as a sum in another order may round
    a value to the neighbouring int8 level."""
    _, ranks, _ = served
    ref = _tp1_drive(case)[1].cache
    got = {k: torch.cat([r[case]["cache"][k] for r in ranks], dim=1) for k in ref}
    assert {k: v.shape for k, v in got.items()} == {k: v.shape for k, v in ref.items()}
    if "k_scale" not in ref:
        for k in ref:
            torch.testing.assert_close(got[k], ref[k], atol=1e-5, rtol=0)
        return
    psz = ref["k"].shape[2]
    for name in ("k", "v"):
        sg, sr = got[f"{name}_scale"][..., :psz], ref[f"{name}_scale"][..., :psz]
        torch.testing.assert_close(sg, sr, atol=1e-5, rtol=1e-4)
        dg = got[name].float() * sg[..., None]
        dr = ref[name].float() * sr[..., None]
        step = torch.maximum(sg, sr)[..., None]
        assert bool(((dg - dr).abs() <= step + 1e-5).all()), name


def test_slow_rank_ends_like_its_peer(served):
    """Rank 1 sleeps before every step: the deadlines, the autotune and the
    watchdog read rank 0's choices, so both ranks end alike, with the
    expiries and stalls the drive was built to cause."""
    _, ranks, _ = served
    a, b = (r["slow"] for r in ranks)
    for key in ("streams", "outcomes", "robust", "decode_window", "calls",
                "plan_broadcasts"):
        assert a[key] == b[key], key
    outcomes = a["outcomes"][0]
    assert outcomes[0] == outcomes[2] == "completed"
    assert "expired" in outcomes
    assert a["robust"]["expired"] == outcomes.count("expired")
    assert a["robust"]["stalled_steps"] > 0
    assert a["plan_broadcasts"] > 0 and a["calls"]["broadcast_values"] == a["plan_broadcasts"]


def test_nan_on_one_rank_is_quarantined_on_both(served):
    """A NaN page injected into rank 0's kv-head slice alone reaches both
    ranks' logits through the row-parallel sum: both quarantine the same
    request (outcome "error:nan", its pages scrubbed), and every stream and
    outcome equals the port's tp = 1 engine under the same schedule (which
    ``tests/test_torch_fault.py`` holds against the JAX engine)."""
    from orion_tpu_torch.runtime.fault import FaultInjector, FaultSpec

    _, ranks, _ = served
    preset, ov, waves, n_new = NAN
    cfg = get_config(preset, INFER + ov)
    params = from_jax_params(jax.tree.map(np.asarray, jax_params(preset)), cfg.model)
    eng = InferenceEngine(cfg, params, device="cpu",
                          fault_injector=FaultInjector(specs=[FaultSpec(**NAN_SPEC)]))
    reqs = [eng.submit_request(p, n_new) for p in waves[0]]
    while eng.has_work():
        eng.step()
    assert "error:nan" in [r.outcome for r in reqs]
    for r in ranks:
        assert r["nan"]["outcomes"] == [[q.outcome for q in reqs]]
        assert r["nan"]["streams"] == [[q.generated for q in reqs]]
        assert r["nan"]["robust"]["quarantined"] == eng.robust.quarantined == 1
