"""Chunked prefill, the prefix cache and the int8 KV pool of the port's
serving engine, on the CPU (plain PyTorch versions), against the JAX
package's engine: greedy token streams must be equal, token for token,
with the JAX weights carried across by ``from_jax_params``.

The traffic is two waves over one engine that share a two-page system
prompt: the second wave hits the prefix cache, and one of its prompts
repeats a page-multiple prompt of the first wave, whose whole context is
then cached (the copy-on-write admission).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from orion_tpu.config import get_config as j_get_config
from orion_tpu.infer import InferenceEngine as JEngine
from orion_tpu.models import init_params as j_init_params
from orion_tpu_torch.config import get_config
from orion_tpu_torch.infer import InferenceEngine
from orion_tpu_torch.infer.kv_cache import init_cache
from orion_tpu_torch.models import from_jax_params
from tests import torch_threads  # noqa: F401  (one intra-op thread)

INFER_OVERRIDES = [
    "inference.max_seq_len=128", "inference.page_size=16",
    "inference.num_pages=32", "inference.max_batch_size=4",
    "inference.prefill_chunk=16", "inference.max_new_tokens=8",
    "inference.prefill_chunk_tokens=32",
]
FEATURES = {
    "chunked": ["inference.chunked_prefill=true"],
    "prefix": ["inference.prefix_cache=true"],
    "int8": ["inference.kv_quant=int8"],
    "all": ["inference.chunked_prefill=true", "inference.prefix_cache=true",
            "inference.kv_quant=int8"],
}
_rng = np.random.default_rng(0)
SYS = _rng.integers(1, 256, 32).tolist()             # two pages
WAVE1 = [SYS + _rng.integers(1, 256, n).tolist() for n in (16, 5, 37)]
WAVE2 = [SYS + _rng.integers(1, 256, n).tolist() for n in (3, 20)] + [WAVE1[0]]

_PARAMS: dict = {}


def _pair(preset="tiny-llama", overrides=(), kernels="xla"):
    ov = INFER_OVERRIDES + list(overrides)
    jcfg = j_get_config(preset, ov)
    jcfg = dataclasses.replace(
        jcfg, model=dataclasses.replace(jcfg.model, kernels=kernels))
    cfg = get_config(preset, ov)
    if preset not in _PARAMS:
        jp = j_init_params(jcfg.model, jax.random.key(0))
        _PARAMS[preset] = (jp, from_jax_params(jax.tree.map(np.asarray, jp), cfg.model))
    jp, tp = _PARAMS[preset]
    return jcfg, jp, cfg, tp


def _waves(eng, n_new=8):
    return [eng.generate(WAVE1, n_new), eng.generate(WAVE2, n_new)]


STAT_KEYS = ("hits", "misses", "cached_tokens", "cow_pages", "inserted_pages")


@pytest.mark.parametrize("preset,feature", [
    ("tiny-llama", f) for f in sorted(FEATURES)] + [("tiny-gemma2", "all")])
def test_features_match_jax(preset, feature):
    """(e) chunked, prefix and int8 each alone and all three together;
    tiny-gemma2 (interleaved windows, softcaps, post-norms) with all three."""
    jcfg, jp, cfg, tp = _pair(preset, FEATURES[feature])
    jeng = JEngine(jcfg, jp)
    eng = InferenceEngine(cfg, tp, device="cpu")
    want, got = _waves(jeng), _waves(eng)
    assert got == want
    eng.assert_page_accounting()
    if cfg.inference.prefix_cache:
        j, t = jeng.prefix_stats, eng.prefix_stats
        assert [getattr(t, k) for k in STAT_KEYS] == [getattr(j, k) for k in STAT_KEYS]
    if cfg.inference.chunked_prefill:
        for k in ("mixed_steps", "prefill_chunks", "chunk_tokens", "chunk_pad_tokens"):
            assert eng.timing[k] == jeng.timing[k], k
    if cfg.inference.kv_quant:
        assert eng.cache["k"].dtype == torch.int8
        assert eng.cache["k_scale"].shape == (
            cfg.model.n_layers * cfg.inference.num_pages, cfg.model.n_kv_heads, 128)


def test_all_features_match_jax_pallas_kernels():
    """(e) all three against the JAX engine on its Pallas kernels (interpret
    mode), where the chunks past the first run the JAX paged-flash prefill
    kernel and decode K4's int8 branch."""
    jcfg, jp, cfg, tp = _pair("tiny-llama", FEATURES["all"], kernels="pallas_interpret")
    want = JEngine(jcfg, jp).generate(WAVE1, 3)
    assert InferenceEngine(cfg, tp, device="cpu").generate(WAVE1, 3) == want


@pytest.mark.parametrize("feature", ["prefix", "all"])
def test_prefix_hit_miss_and_copy_on_write(feature):
    """(f) the first wave misses, the second hits the system prompt, and the
    repeated page-multiple prompt is served whole from the cache through
    one copy-on-write page; clearing the cache returns every page."""
    jcfg, jp, cfg, tp = _pair("tiny-llama", FEATURES[feature])
    eng = InferenceEngine(cfg, tp, device="cpu")
    first = eng.generate(WAVE1, 8)
    st = eng.prefix_stats
    assert (st.hits, st.misses) == (0, 3)
    hit = eng.prefix_match_tokens(WAVE1[0])
    assert hit == len(WAVE1[0])                   # 48 tokens: the whole prompt
    assert eng.prefix_match_tokens(SYS + [0] * 40) == len(SYS)
    second = eng.generate(WAVE2, 8)
    assert (st.hits, st.misses, st.cow_pages) == (3, 3, 1)
    assert st.cached_tokens == 2 * len(SYS) + len(WAVE1[0]) - 1
    assert second[2] == first[0]                  # the COW admission's stream
    eng.assert_page_accounting()
    assert eng.clear_prefix_cache() > 0
    assert eng.alloc.free_pages == cfg.inference.num_pages - 1
    assert eng.prefix_match_tokens(WAVE1[0]) == 0


def _preempt_pair(feature):
    return _pair("tiny-llama", FEATURES[feature] + [
        "inference.chunked_prefill=true", "inference.num_pages=10",
        "inference.prefill_chunk_tokens=16", "inference.decode_window=4"])


def _drive_preempting(eng, late=tuple(range(100, 170)), check=None):
    """Two requests decode 60 tokens each; two steps in, a 70-token prompt
    arrives and is chunked in beside them until the pool runs out and the
    youngest — the prompt, mid-prefill — is preempted. Returns the streams
    in submission order; ``check`` runs after every step."""
    rids = [eng.submit(list(range(1, 11)), 60), eng.submit(list(range(1, 28)), 60)]
    done = {}
    for i in range(10 ** 4):
        if i == 2:
            rids.append(eng.submit(list(late), 10))
        if i > 2 and not eng.has_work():
            break
        done.update((r.rid, r.generated) for r in eng.step())
        if check is not None:
            check()
    return [done[r] for r in rids]


@pytest.mark.parametrize("feature", ["chunked", "all"])
def test_preemption_mid_prompt_matches_jax(feature):
    """(g) preemption of a prompt mid-prefill: it is re-admitted (resuming
    from its donated chunks when the prefix cache is on) and every stream
    stays the JAX engine's."""
    jcfg, jp, cfg, tp = _preempt_pair(feature)
    want = _drive_preempting(JEngine(jcfg, jp))
    eng = InferenceEngine(cfg, tp, device="cpu")
    cursors = []
    preempt = eng._preempt

    def spy(req):
        cursors.append(req.prefill_done if req.prefill_pending else None)
        preempt(req)

    eng._preempt = spy
    assert _drive_preempting(eng) == want
    assert any(c for c in cursors), f"no preemption mid-prompt: {cursors}"
    if cfg.inference.prefix_cache:
        assert eng.prefix_stats.hits >= 1      # the re-admission resumed
    eng.assert_page_accounting()


def test_page_accounting_after_every_step():
    """(j) the pool invariant after every engine step over one engine:
    mid-prompt preemption, then the two waves (prefix hits and a
    copy-on-write admission) on the same small pool."""
    _, _, cfg, tp = _preempt_pair("all")
    eng = InferenceEngine(cfg, tp, device="cpu")
    _drive_preempting(eng, check=eng.assert_page_accounting)
    for wave in (WAVE1, WAVE2):
        for p in wave:
            eng.submit(p, 8)
        while eng.has_work():
            eng.step()
            eng.assert_page_accounting()
    st = eng.prefix_stats
    assert st.hits >= 2 and st.cow_pages >= 1 and eng.preemptions >= 1
    eng.clear_prefix_cache()
    assert eng.alloc.free_pages == cfg.inference.num_pages - 1


def test_sampled_lone_request_same_chunked_and_unchunked():
    """(h) a mixed step with no live decode row draws nothing from the
    engine's generator, so a sampled request alone is the same stream
    whether its prompt is chunked or not."""
    prompt = list(range(3, 60))                         # two 32-token chunks
    streams = []
    for ov in ([], ["inference.chunked_prefill=true"]):
        _, _, cfg, tp = _pair("tiny-llama", ov + ["inference.temperature=1.0"])
        eng = InferenceEngine(cfg, tp, device="cpu", seed=7)
        streams.append(eng.generate([prompt], 12)[0])
        assert eng.timing["mixed_steps"] == (2 if ov else 0)
    assert streams[0] == streams[1]


@pytest.mark.parametrize("override,error,match", [
    ("inference.prefill_chunk_tokens=24", ValueError, "prefill_chunk_tokens"),
    ("inference.prefill_chunk_tokens=8", ValueError, "prefill_chunk_tokens"),
    ("inference.kv_quant=int4", ValueError, "kv_quant"),
])
def test_config_validation(override, error, match):
    """(i) bad chunk budgets and an unknown kv_quant raise as they do in the
    JAX engine (paged_prefill=false serves: tests/test_torch_attention_pos.py)."""
    ov = ["inference.chunked_prefill=true", override]
    jcfg, jp, cfg, tp = _pair("tiny-llama", ov)
    if error is ValueError:
        with pytest.raises(ValueError, match=match):
            JEngine(jcfg, jp)
    with pytest.raises(error, match=match):
        InferenceEngine(cfg, tp, device="cpu")
    if override.startswith("inference.kv_quant"):
        with pytest.raises(ValueError, match="kv_quant"):
            init_cache(cfg.model, cfg.inference, "cpu")
