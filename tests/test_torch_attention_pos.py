"""K3's explicit-positions branch on the CPU: ``attention_plain`` with
``q_positions``/``kv_positions`` against the JAX package's attention
(``impl="xla"``, whose mask compares the same position arrays), and the
runner's gather prefill body (``prefill_step(..., paged_prefill=False)``)
against the JAX runner's, over float32 and int8 pools.

Float32 throughout: outputs to 1e-5, logits to 1e-4 (a few layers summed
in another order), pool bytes written from the same K/V to 1e-5. Rows
that attend nothing are left out (the JAX reference averages v over them,
every flash kernel returns zeros; the gather body's callers discard them).
The kernel itself runs only on the card (``chip_smoke.py`` holds it
against this plain version); here its wrapper refuses CPU tensors. Last,
engines with inference.paged_prefill=false (prefix-cache hits and chunks
through the gather body) against the JAX engine: streams, outcomes,
surfacing steps and counters with no tolerance.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orion_tpu.config import get_config as j_get_config
from orion_tpu.infer import InferenceEngine as JEngine
from orion_tpu.infer import runner as j_runner
from orion_tpu.infer.kv_cache import init_cache as j_init_cache
from orion_tpu.models import init_params as j_init_params
from orion_tpu.ops.attention import attention as j_attention
from orion_tpu_torch import ops
from orion_tpu_torch.config import get_config
from orion_tpu_torch.infer import InferenceEngine, runner
from orion_tpu_torch.infer.kv_cache import init_cache
from orion_tpu_torch.metrics import PrefixCacheStats, RobustnessStats
from orion_tpu_torch.models import from_jax_params

N, K, H = 4, 2, 16


def _gather_layout(rng, psz=8, P_pre=4, S=16):
    """The gather body's layout: rows resuming at page-aligned prefixes
    (0, 1 and 4 pages) with ragged tails, the prefix at [0, P_pre*psz)."""
    starts = np.array([0, psz, P_pre * psz])
    lens = np.array([S, 11, 5])
    B, n_pre = len(starts), P_pre * psz
    qpos = (starts[:, None] + np.arange(S)).astype(np.int32)
    qseg = (np.arange(S)[None] < lens[:, None]).astype(np.int32)
    kpos = np.concatenate([np.broadcast_to(np.arange(n_pre), (B, n_pre)), qpos], 1)
    kseg = np.concatenate([(np.arange(n_pre)[None] < starts[:, None]).astype(np.int32),
                           qseg], 1)
    q = rng.standard_normal((B, S, N, H)).astype(np.float32)
    kv = rng.standard_normal((2, B, n_pre + S, K, H)).astype(np.float32)
    return q, kv[0], kv[1], dict(q_positions=qpos, kv_positions=kpos.astype(np.int32),
                                 q_segment_ids=qseg, kv_segment_ids=kseg)


def _striped_layout(rng, B=2, S=32, stripes=4):
    """A striped permutation (position j*stripes + r at index r*S/stripes +
    j): positions that do not rise, as sequence parallelism gives."""
    perm = np.arange(S).reshape(S // stripes, stripes).T.reshape(-1)
    pos = np.broadcast_to(perm, (B, S)).astype(np.int32).copy()
    q = rng.standard_normal((B, S, N, H)).astype(np.float32)
    kv = rng.standard_normal((2, B, S, K, H)).astype(np.float32)
    return q, kv[0], kv[1], dict(q_positions=pos, kv_positions=pos)


@pytest.mark.parametrize("layout", ["gather", "striped"])
@pytest.mark.parametrize("window,softcap", [(None, None), (8, None), (None, 20.0),
                                            (12, 30.0)])
def test_attention_plain_positions_match_jax(layout, window, softcap):
    rng = np.random.default_rng(0)
    q, k, v, kw = (_gather_layout if layout == "gather" else _striped_layout)(rng)
    want = np.asarray(j_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True, window=window,
        logit_softcap=softcap, impl="xla", **{n: jnp.asarray(a) for n, a in kw.items()}))
    got = ops.attention_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), causal=True,
        window=window, logit_softcap=softcap,
        **{n: torch.from_numpy(a) for n, a in kw.items()}).numpy()
    # Rows that attend something: their own position is always visible.
    rows = kw.get("q_segment_ids", np.ones(q.shape[:2], np.int32)) > 0
    np.testing.assert_allclose(got[rows], want[rows], atol=1e-5, rtol=0)


def _no_build(*args, **kwargs):
    raise AssertionError("a kernel was built for CPU tensors")


def test_attention_positions_dispatch_and_refusals(monkeypatch):
    """``attention`` takes positions on the CPU through the plain version;
    the K3 wrapper refuses CPU tensors before any build and counts
    nothing, and positions come in pairs."""
    from orion_tpu_torch.ops import _build
    from orion_tpu_torch.ops.attention import _check_positions

    monkeypatch.setattr(_build, "library", _no_build)
    monkeypatch.setattr(_build, "entry", _no_build)
    rng = np.random.default_rng(1)
    q, k, v, kw = _striped_layout(rng)
    t = {n: torch.from_numpy(a) for n, a in kw.items()}
    args = [torch.from_numpy(a) for a in (q, k, v)]
    assert torch.equal(ops.attention(*args, seg_pad_zero=True, **t),
                       ops.attention_plain(*args, **t))
    ops.reset_launches()
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.flash_attention_pos_cuda(*args, t["q_positions"], t["kv_positions"])
    assert ops.launches()["flash_fwd_pos"] == 0
    with pytest.raises(ValueError, match="go together"):
        _check_positions(t["q_positions"], None, 2, 32, 32)


INFER_OVERRIDES = [
    "inference.max_seq_len=128", "inference.page_size=16",
    "inference.num_pages=32", "inference.max_batch_size=4",
    "inference.prefill_chunk=16", "inference.max_new_tokens=8",
]


def _pair(overrides=()):
    ov = INFER_OVERRIDES + list(overrides)
    jcfg = j_get_config("tiny-llama", ov)
    jcfg = dataclasses.replace(jcfg, model=dataclasses.replace(jcfg.model, kernels="xla"))
    cfg = get_config("tiny-llama", ov)
    jp = j_init_params(jcfg.model, jax.random.key(0))
    return jcfg, jp, cfg, from_jax_params(jax.tree.map(np.asarray, jp), cfg.model)


@pytest.mark.parametrize("quant", [False, True])
def test_prefill_step_gather_body_matches_jax(quant):
    """Cold rows fill prefix pages, then tail rows resume over them (0, 1
    and 2 prefix pages, ragged tails, a pad row) through the gather body
    on both sides: logits and every written pool row agree."""
    jcfg, jp, cfg, tp = _pair(["inference.kv_quant=int8"] if quant else [])
    rng = np.random.default_rng(2)
    V = cfg.model.vocab_size
    cold = rng.integers(0, V, size=(2, 32)).astype(np.int32)
    c_lens = np.array([32, 32], np.int32)
    c_pages = np.array([[1, 2], [3, 4]], np.int32)
    tail = np.zeros((4, 16), np.int32)
    t_lens = np.array([16, 9, 3, 1], np.int32)
    for i, n in enumerate(t_lens[:3]):
        tail[i, :n] = rng.integers(0, V, size=n)
    t_pages = np.array([[5], [6], [7], [0]], np.int32)
    pre_lens = np.array([32, 16, 0, 0], np.int32)
    pre_pages = np.array([[1, 2], [3, 0], [0, 0], [0, 0]], np.int32)

    jcache = j_init_cache(jcfg.model, jcfg.inference)
    cache = init_cache(cfg.model, cfg.inference, "cpu")
    _, jcache = j_runner.prefill_step(jp, jcache, jnp.asarray(cold), jnp.asarray(c_lens),
                                      jnp.asarray(c_pages), cfg=jcfg.model)
    runner.prefill_step(tp, cache, torch.from_numpy(cold), torch.from_numpy(c_lens),
                        torch.from_numpy(c_pages), cfg=cfg.model)
    jl, jcache = j_runner.prefill_step(
        jp, jcache, jnp.asarray(tail), jnp.asarray(t_lens), jnp.asarray(t_pages),
        jnp.asarray(pre_lens), jnp.asarray(pre_pages), cfg=jcfg.model, paged_prefill=False)
    tl, _ = runner.prefill_step(
        tp, cache, torch.from_numpy(tail), torch.from_numpy(t_lens),
        torch.from_numpy(t_pages), torch.from_numpy(pre_lens), torch.from_numpy(pre_pages),
        cfg=cfg.model, paged_prefill=False)
    np.testing.assert_allclose(tl.numpy()[:3], np.asarray(jl)[:3], atol=1e-4, rtol=0)
    NP = cfg.inference.num_pages
    live = (np.arange(cache["k"].shape[0]) % NP) != 0     # scratch page 0 excluded
    for name in cache:
        got, want = cache[name].numpy()[live], np.asarray(jcache[name])[live]
        if got.dtype == np.int8:
            # One code step where the float K/V round the other way.
            assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= 1, name
        else:
            np.testing.assert_allclose(got, want, atol=1e-5, rtol=0, err_msg=name)


COUNTERS = tuple(PrefixCacheStats().as_timing()) + tuple(RobustnessStats().as_timing())


def _drain(eng):
    """Step until idle: {rid: (outcome, tokens, step it surfaced at)}."""
    done = {}
    while eng.has_work():
        n = eng.step_no
        for r in eng.step():
            done[r.rid] = (r.outcome, list(r.generated), n)
    return done


@pytest.mark.parametrize("overrides", [
    ["inference.prefix_cache=true"],
    ["inference.prefix_cache=true", "inference.kv_quant=int8"],
    ["inference.chunked_prefill=true", "inference.prefix_cache=true"],
])
def test_gather_prefill_body_engine_matches_jax(overrides):
    """inference.paged_prefill=false: prefix-cache hits and chunks resume
    through the gather body (K3 with explicit positions on the card); the
    streams, outcomes and prefix counters equal the JAX engine's, and the
    paged_prefill=true port engine's streams (f32)."""
    base = INFER_OVERRIDES + ["inference.prefill_chunk_tokens=32"]
    jcfg0, jp, cfg0, tp = _pair()
    sys_p = [(i * 13) % 250 + 2 for i in range(32)]
    waves = [[sys_p + [5, 3, 9], sys_p + list(range(20, 40))], [sys_p + [7, 7], sys_p]]

    def drive(eng, side):
        out = []
        for w in waves:
            rids = [eng.submit(p, 6) for p in w]
            done = _drain(eng)
            out.append([done[r] for r in rids])
        return {"waves": out}

    out = {}
    for side in ("jax", "torch"):
        ov = base + overrides + ["inference.paged_prefill=false"]
        cfg = (j_get_config if side == "jax" else get_config)("tiny-llama", ov)
        if side == "jax":
            cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, kernels="xla"))
            eng = JEngine(cfg, jp)
        else:
            eng = InferenceEngine(cfg, tp, device="cpu")
        res = drive(eng, side)
        t = eng.reset_timing()
        res["counters"] = {k: t.get(k) for k in COUNTERS}
        out[side] = res
    assert out["torch"] == out["jax"]
    assert out["torch"]["counters"]["prefix_hits"] >= 2
    paged = InferenceEngine(get_config("tiny-llama", base + overrides), tp, device="cpu")
    assert drive(paged, "torch")["waves"] == out["torch"]["waves"]
