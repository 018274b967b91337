"""The port's host KV tier (``HostPagePool``, the prefix cache's demote /
restore, the engine's break-even gate, ``offload_prefix_cache`` and the
"restore" fault) on the CPU, against the JAX package's engine (xla
kernels) with the same seeded weights, converted by ``from_jax_params``.

The counterpart of ``tests/test_host_tier.py`` (its tests up to the
router's): with no tolerance, the two engines give the same greedy
streams, typed outcomes, surfacing steps, prefix-cache and host-tier
counters, robustness counters and fired faults; within each engine a page
that goes to the host and back is bitwise the page it was (int8 pools
with their scale rows). Left out, as they wait for modules the port has
not ported: the router's placement on a host-warm replica, and the
capacity-sweep bench smoke (``tools/prefix_cache_bench.py``). The JAX
package's pool gauges (``_pool_metrics``) belong to its observability
registry, not ported either; the host pool's own counts stand in.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from orion_tpu.config import get_config as j_get_config
from orion_tpu.infer import InferenceEngine as JEngine
from orion_tpu.infer import kv_cache as j_kv
from orion_tpu.infer.prefix_cache import HostPage as JHostPage
from orion_tpu.infer.prefix_cache import PrefixCache as JPrefixCache
from orion_tpu.models import init_params as j_init_params
from orion_tpu.runtime import fault as j_fault
from orion_tpu_torch.config import get_config
from orion_tpu_torch.infer import InferenceEngine
from orion_tpu_torch.infer import kv_cache as t_kv
from orion_tpu_torch.infer.kv_cache import gather_pages
from orion_tpu_torch.infer.prefix_cache import HostPage, PrefixCache
from orion_tpu_torch.metrics import PrefixCacheStats, RobustnessStats
from orion_tpu_torch.models import from_jax_params
from orion_tpu_torch.runtime import fault as t_fault
from tests import torch_threads  # noqa: F401  (one intra-op thread)

INFER = [
    "inference.max_seq_len=128", "inference.page_size=16",
    "inference.num_pages=32", "inference.max_batch_size=4",
    "inference.prefill_chunk=16", "inference.max_new_tokens=8",
]
# 16 host slots at tiny-llama's 8192 B a page; min_tokens=0 so every host
# match restores (the gate has a test of its own).
TIER = ["inference.prefix_cache=true", "inference.host_tier_bytes=131072",
        "inference.host_tier_min_tokens=0"]
SHARED = [(i * 7) % 250 + 1 for i in range(96)]          # 6 full pages
COUNTERS = tuple(PrefixCacheStats().as_timing()) + tuple(RobustnessStats().as_timing())


@pytest.fixture(scope="module")
def weights():
    jcfg = j_get_config("tiny-llama", INFER)
    jp = j_init_params(jcfg.model, jax.random.key(0))
    return jp, from_jax_params(jax.tree.map(np.asarray, jp), get_config("tiny-llama", INFER).model)


def _engine(weights, side, overrides=(), tier=True):
    """An engine of ``side`` with a fault injector a test may append to."""
    ov = INFER + (TIER if tier else []) + list(overrides)
    inj = (j_fault if side == "jax" else t_fault).FaultInjector([])
    if side == "jax":
        cfg = j_get_config("tiny-llama", ov)
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, kernels="xla"))
        return JEngine(cfg, weights[0], fault_injector=inj)
    return InferenceEngine(get_config("tiny-llama", ov), weights[1], device="cpu",
                           fault_injector=inj)


def _both(weights, drive, overrides=(), tier=True):
    """``drive(eng, side)`` on both engines; their results, counters,
    fired faults and host-pool state must be equal. Returns the port's."""
    out = {}
    for side in ("jax", "torch"):
        eng = _engine(weights, side, overrides, tier)
        res = drive(eng, side)
        t = eng.reset_timing()
        assert not {"counters", "fired", "host_pool"} & set(res)
        res["counters"] = {k: t.get(k) for k in COUNTERS}
        res["fired"] = list(eng._injector.fired)
        hp = eng._host_pool
        if hp is not None:
            res["host_pool"] = (hp.capacity, hp.free_slots,
                                eng._pcache.host_pages if eng._pcache else None)
        eng.assert_page_accounting()
        out[side] = res
    assert out["torch"] == out["jax"]
    return out["torch"]


def _drain(eng):
    """Step until idle: {rid: (outcome, tokens, step it surfaced at)}."""
    done = {}
    while eng.has_work():
        n = eng.step_no
        for r in eng.step():
            done[r.rid] = (r.outcome, list(r.generated), n)
    return done


def _gen(eng, prompts, n=4):
    rids = [eng.submit(p, n) for p in prompts]
    done = _drain(eng)
    return [done[r] for r in rids]


def _snapshot(eng, side, tokens, n_pages):
    """The cached prefix path's pages (every cache tensor, all layers) as
    numpy, and their page ids."""
    pages, node = eng._pcache.match(tokens + [999], max_pages=n_pages)
    assert node is not None and len(pages) == n_pages
    assert all(isinstance(p, int) for p in pages)
    if side == "jax":
        import jax.numpy as jnp

        blocks = jax.device_get(eng._gather_pages(eng.cache, jnp.asarray(pages, jnp.int32)))
    else:
        blocks = gather_pages(eng.cache, torch.tensor(pages), n_layers=eng.mcfg.n_layers,
                              num_pages=eng.icfg.num_pages)
    eng._pcache.unlock(node)
    return {k: _np(v) for k, v in blocks.items()}


def _np(a):
    """numpy of a JAX array or a torch tensor (bf16 through its bits)."""
    if isinstance(a, torch.Tensor):
        return (a.view(torch.int16) if a.dtype == torch.bfloat16 else a).numpy()
    return np.asarray(a)


def _host_bytes(eng, hids):
    return {k: _np(v) for k, v in eng._host_pool.load(hids).items()}


def _same_bytes(a, b):
    assert set(a) == set(b)
    for name in a:
        assert a[name].dtype == b[name].dtype, name
        assert a[name].tobytes() == b[name].tobytes(), name


# -- pure units --------------------------------------------------------------


@pytest.mark.parametrize("args", [
    (1 << 20, 16, 8.0, 0.002, 40000.0),     # 119 tokens
    (1 << 20, 16, 0.01, 0.0, 40000.0),      # restore never wins: None
    (1024, 16, 8.0, 0.0, 40000.0),          # the one-page floor
    (8_388_608, 64, 8.0, 0.002, 40000.0),   # llama3-8b-infer's page at the defaults
])
def test_break_even_math_matches_jax(args):
    assert t_kv.host_tier_break_even_tokens(*args) == j_kv.host_tier_break_even_tokens(*args)


def test_host_pool_unit_mechanics():
    """alloc/retain/release, exhaustion, LRU order, the evict-while-
    referenced refusal and a bitwise store/load, step for step as the JAX
    package's pool."""
    got = {}
    rng = np.random.default_rng(0)
    blocks = {"k": rng.standard_normal((2, 3, 8)).astype(np.float32),
              "v": rng.integers(-128, 127, (2, 3, 8)).astype(np.int8)}
    for name, mod, conv in (("jax", j_kv, lambda b: b),
                            ("torch", t_kv, lambda b: {k: torch.from_numpy(v)
                                                       for k, v in b.items()})):
        hp = mod.HostPagePool(4, page_bytes=64)
        log = []
        a, b, c = hp.alloc(3)
        hp.retain(a)
        log.append((hp.free_slots, hp.refcount(a), hp.release(a), hp.refcount(a)))
        with pytest.raises(MemoryError):
            hp.alloc(2)
        hp.touch(b)
        hp.touch(c)
        hp.touch(a)
        hp.retain(a)
        log.append(hp.evict_lru(3))              # a skipped: still referenced
        hp.release(a)
        log.append((hp.evict_lru(1), hp.free_slots))
        hids = hp.alloc(2)
        hp.store(hids, conv(blocks))
        out = {k: np.asarray(v) for k, v in hp.load(hids).items()}
        _same_bytes(out, blocks)
        got[name] = log
    assert got["torch"] == got["jax"]


def test_radix_demote_promote_unit():
    """The tree's tier mechanics without an engine, op for op against the
    JAX tree: one spill callback per demote (trailing entries first), the
    tiered peek, promote_path, clear releasing host slots, and a locked
    path that never demotes."""
    logs = {}
    for side, alloc_cls, pool_cls, tree_cls, host_cls in (
            ("jax", j_kv.PageAllocator, j_kv.HostPagePool, JPrefixCache, JHostPage),
            ("torch", t_kv.PageAllocator, t_kv.HostPagePool, PrefixCache, HostPage)):
        alloc, hp, spilled, log = alloc_cls(64), pool_cls(8), [], []

        def spill(pages, hp=hp, spilled=spilled):
            spilled.append(list(pages))
            return hp.alloc(len(pages))

        pc = tree_cls(4, alloc, host_pool=hp, spill=spill)
        toks = list(range(12))
        pages = alloc.alloc(3)
        pc.insert(toks, pages)
        alloc.free(pages)
        got, node = pc.match(toks + [99], max_pages=8)
        log.append((pc.evict(10), list(spilled)))          # locked: nothing
        pc.unlock(node)
        log.append((pc.demote(2), list(spilled), pc.total_pages, pc.host_pages,
                    [alloc.refcount(p) for p in pages], hp.free_slots))
        log.append(pc.peek_tiered(toks + [99], 8))
        got, node = pc.match(toks + [99], max_pages=8)
        log.append([isinstance(p, host_cls) for p in got])
        fresh = alloc.alloc(2)
        pc.promote_path(node, {1: fresh[0], 2: fresh[1]})
        got2, node2 = pc.match(toks + [99], max_pages=8)
        pc.unlock(node2)
        pc.unlock(node)
        log.append((pc.total_pages, pc.host_pages, hp.free_slots, got2 == [pages[0]] + fresh,
                    [alloc.refcount(p) for p in [pages[0]] + fresh]))
        log.append((pc.demote(3), pc.clear(), pc.host_pages, hp.free_slots))
        logs[side] = log
    assert logs["torch"] == logs["jax"]


# -- engine round trips --------------------------------------------------------


def test_tier_off_by_default_and_validation(weights):
    """host_tier_bytes defaults to 0 (no pool; offload is a no-op 0); the
    tier needs the prefix cache or long context (the JAX message), and
    must hold one page."""
    for side in ("jax", "torch"):
        eng = _engine(weights, side, tier=False)
        assert eng._host_pool is None and eng.offload_prefix_cache() == 0
    msgs = []
    for side in ("jax", "torch"):
        for ov in (["inference.host_tier_bytes=131072"],
                   ["inference.prefix_cache=true", "inference.host_tier_bytes=100"]):
            with pytest.raises(ValueError) as e:
                _engine(weights, side, ov, tier=False)
            msgs.append(str(e.value))
    assert msgs[:2] == msgs[2:] and "prefix_cache" in msgs[0]


@pytest.mark.parametrize("kv", ["float32", "int8", "bfloat16"])
def test_offload_restore_round_trip(weights, kv):
    """Offload demotes the idle tree (6 pages, one spill), the host slots
    hold the pages' bytes, a warm re-admission restores them, and the
    restored pages are bitwise the pre-offload pages; the streams, the
    counters and the host pool's state agree with the JAX engine's (the
    bf16 engines' streams are each held to their own tier-off run instead:
    the two packages round bf16 activations apart)."""
    ov = {"float32": [], "int8": ["inference.kv_quant=int8"],
          "bfloat16": ["model.dtype=bfloat16"]}[kv]

    def drive(eng, side):
        cold = _gen(eng, [SHARED])
        before = _snapshot(eng, side, SHARED, 6)
        eng.reset_timing()
        n = eng.offload_prefix_cache()
        t = eng.reset_timing()
        tree = (eng._pcache.total_pages, eng._pcache.host_pages)
        # The slots in tree order (one node): the pages' own bytes.
        _same_bytes(_host_bytes(eng, list(eng._pcache.held_host_pages())), before)
        warm = _gen(eng, [SHARED])
        after = _snapshot(eng, side, SHARED, 6)
        _same_bytes(after, before)
        res = {"offloaded": n, "tree": tree, "evicted_to_host": t["evicted_to_host"],
               "tree_after": (eng._pcache.total_pages, eng._pcache.host_pages),
               "outcomes": [(o, s) for o, _, s in cold + warm]}
        if kv == "bfloat16":
            assert [x[1] for x in warm] == [x[1] for x in cold]
        else:
            res["streams"] = [x[1] for x in cold + warm]
        if side == "torch":
            assert t["spill_s"] > 0
        return res

    res = _both(weights, drive, ov)
    assert res["offloaded"] == 6 and res["tree"] == (0, 6) and res["tree_after"] == (6, 0)
    assert res["counters"]["host_hits"] == 1 and res["counters"]["host_restored_pages"] == 6


def test_tier_on_streams_match_tier_off_and_jax(weights):
    """Serving with an offload between rounds gives the tier-off (cache on
    and cache off) engines' tokens, as the JAX engine does."""
    prompts = [SHARED[:48] + [7, 8, 9], SHARED[:48] + [200, 201], [5, 3, 9] * 6]
    ref = InferenceEngine(get_config("tiny-llama", INFER), weights[1],
                          device="cpu").generate(prompts, 6)
    assert InferenceEngine(get_config("tiny-llama", INFER + ["inference.prefix_cache=true"]),
                           weights[1], device="cpu").generate(prompts, 6) == ref

    def drive(eng, side):
        a = _gen(eng, prompts, 6)
        eng.offload_prefix_cache()
        b = _gen(eng, prompts, 6)
        assert [x[1] for x in a] == [x[1] for x in b] == ref
        return {"a": a, "b": b}

    assert _both(weights, drive)["counters"]["host_hits"] >= 1


def test_restore_into_tight_pool(weights):
    """A restore into a nearly full pool goes through the evict-for-
    headroom path (demoting other cold entries) and completes."""
    filler = [[(i * 13 + j) % 250 + 1 for i in range(32)] for j in (1, 2)]

    def drive(eng, side):
        cold = _gen(eng, [SHARED])
        n = eng.offload_prefix_cache()
        fref = _gen(eng, filler)
        warm = _gen(eng, [SHARED])
        t = eng.reset_timing()
        again = _gen(eng, filler)
        return {"n": n, "cold": cold, "fref": fref, "warm": warm, "again": again,
                "mid": (t["host_hits"], t["host_restored_pages"], t["evicted_to_host"])}

    res = _both(weights, drive, ["inference.num_pages=16"])
    assert res["warm"][0][1] == res["cold"][0][1] and res["mid"][:2] == (1, 6)


def test_break_even_gate_recomputes_small_match(weights):
    """A host span under host_tier_min_tokens recomputes: the skip counter
    moves, nothing restores, the markers stay, and the affinity probe
    reports no usable match."""
    def drive(eng, side):
        cold = _gen(eng, [SHARED])
        eng.offload_prefix_cache()
        warm = _gen(eng, [SHARED])
        return {"cold": cold, "warm": warm, "markers": eng._pcache.host_pages,
                "probe": eng.prefix_match_tokens(SHARED + [1])}

    res = _both(weights, drive, ["inference.host_tier_min_tokens=999"])
    assert res["markers"] == 6 and res["probe"] == 0
    c = res["counters"]
    assert c["host_recompute_skips"] >= 1 and c["host_hits"] == c["host_restored_pages"] == 0


def test_probe_advertises_host_match_above_gate(weights):
    """Above the gate the probe counts the host-resident span, as the JAX
    engine's does (a host-warm replica advertises its prefix)."""
    def drive(eng, side):
        _gen(eng, [SHARED])
        eng.offload_prefix_cache()
        return {"probe": eng.prefix_match_tokens(SHARED + [1])}

    assert _both(weights, drive)["probe"] == 96


def test_mid_restore_fault_unwinds_both_tiers(weights):
    """A "restore" fault inside the copy envelope fails the step (one
    dispatch fault, one failed step): fresh pages freed, in-flight host
    refs dropped, markers left unpromoted, both pools balanced; the retry
    restores for real and serves the cold stream."""
    def drive(eng, side):
        cold = _gen(eng, [SHARED])
        eng.offload_prefix_cache()
        free0 = eng.alloc.free_pages
        eng._injector.specs.append(
            (j_fault if side == "jax" else t_fault).FaultSpec("restore", step=eng.step_no))
        rid = eng.submit(SHARED, 4)
        eng.step()
        unwound = (eng._pcache.host_pages, eng._pcache.total_pages,
                   eng.alloc.free_pages == free0, eng._host_pool.free_slots)
        eng.assert_page_accounting()
        t = eng.reset_timing()
        done = _drain(eng)
        return {"cold": cold, "unwound": unwound, "done": done[rid],
                "first": (t["failed_steps"], t["dispatch_faults"])}

    res = _both(weights, drive)
    assert res["unwound"][:3] == (6, 0, True) and res["first"] == (1, 1)
    assert res["done"][1] == res["cold"][0][1]
    assert res["counters"]["host_hits"] == 1


def test_int8_chunked_long_prompt_composition(weights):
    """int8 pools + chunked prefill + the tier on a near-capacity prompt:
    an offload mid-stream keeps the tier-off int8 engine's stream."""
    ov = ["inference.kv_quant=int8", "inference.max_seq_len=256", "inference.num_pages=24",
          "inference.chunked_prefill=true", "inference.prefill_chunk_tokens=32"]
    long_p = [(i * 3) % 250 + 1 for i in range(112)]

    def drive(eng, side):
        a = _gen(eng, [long_p], 8)
        n = eng.offload_prefix_cache()
        b = _gen(eng, [long_p], 8)
        return {"a": a, "b": b, "n": n}

    res = _both(weights, drive, ov)
    ref = _gen(_engine(weights, "torch", ov, tier=False), [long_p], 8)
    assert res["a"][0][1] == res["b"][0][1] == ref[0][1] and res["n"] > 0
    assert res["counters"]["host_hits"] >= 1
