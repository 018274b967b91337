"""The port's model and runner (plain PyTorch versions, CPU) against the JAX
package, with the JAX parameters carried across by ``from_jax_params``.

Float32 throughout. Logits agree to 1e-4 absolute (a few layers of float32
matmuls summed in another order); pool bytes written from the same K/V
math agree to 1e-5; greedy tokens agree exactly. The JAX side runs its
xla reference and its Pallas kernels in interpret mode.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orion_tpu.config import get_config as j_get_config
from orion_tpu.infer import runner as j_runner
from orion_tpu.infer.kv_cache import init_cache as j_init_cache
from orion_tpu.models import forward as j_forward
from orion_tpu.models import init_params as j_init_params
from orion_tpu_torch.config import get_config
from orion_tpu_torch.infer import runner
from orion_tpu_torch.infer.kv_cache import init_cache
from orion_tpu_torch.models import forward, from_jax_params, init_params
from tests import torch_threads  # noqa: F401  (one intra-op thread)

INFER_OVERRIDES = [
    "inference.max_seq_len=128", "inference.page_size=16",
    "inference.num_pages=32", "inference.max_batch_size=4",
    "inference.prefill_chunk=16", "inference.max_new_tokens=8",
]


def _pair(preset, overrides=(), kernels="xla"):
    """(jax cfg, jax params, port cfg, port params) from one JAX init."""
    ov = INFER_OVERRIDES + list(overrides)
    jcfg = j_get_config(preset, ov)
    jcfg = dataclasses.replace(
        jcfg, model=dataclasses.replace(jcfg.model, kernels=kernels))
    cfg = get_config(preset, ov)
    jp = j_init_params(jcfg.model, jax.random.key(0))
    tp = from_jax_params(jax.tree.map(np.asarray, jp), cfg.model)
    return jcfg, jp, cfg, tp


@pytest.mark.parametrize("preset", ["tiny-llama", "tiny-gemma2", "tiny"])
def test_forward_matches_jax(preset):
    jcfg, jp, cfg, tp = _pair(preset)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.model.vocab_size, size=(2, 24)).astype(np.int32)
    want, _ = j_forward(jp, jnp.asarray(toks), jcfg.model)
    got = forward(tp, torch.from_numpy(toks), cfg.model)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)


def test_forward_with_segments_matches_jax():
    jcfg, jp, cfg, tp = _pair("tiny-llama")
    rng = np.random.default_rng(1)
    toks = rng.integers(0, 256, size=(2, 20)).astype(np.int32)
    seg = np.array([[1] * 12 + [2] * 8, [1] * 15 + [0] * 5], np.int32)
    want, _ = j_forward(jp, jnp.asarray(toks), jcfg.model,
                        segment_ids=jnp.asarray(seg))
    got = forward(tp, torch.from_numpy(toks), cfg.model,
                  segment_ids=torch.from_numpy(seg))
    real = seg > 0
    np.testing.assert_allclose(got.numpy()[real], np.asarray(want)[real],
                               atol=1e-4, rtol=0)


def test_from_jax_params_takes_unstacked_blocks():
    """A per-layer block list (JAX scan_layers=False) carries across to the
    same parameters as the stacked tree."""
    _, jp, cfg, tp = _pair("tiny-llama")
    tree = jax.tree.map(np.asarray, jp)
    tree["blocks"] = [jax.tree.map(lambda a, i=i: a[i], tree["blocks"])
                      for i in range(cfg.model.n_layers)]
    ucfg = dataclasses.replace(cfg.model, scan_layers=False)
    listed = from_jax_params(tree, ucfg)
    toks = torch.tensor([[5, 3, 9, 250, 17]])
    assert torch.equal(forward(listed, toks, ucfg), forward(tp, toks, cfg.model))


@pytest.mark.parametrize("preset", ["tiny-llama", "tiny-gemma2", "tiny"])
def test_init_params_shapes_match_jax(preset):
    cfg = get_config(preset)
    jp = j_init_params(j_get_config(preset).model, jax.random.key(0))
    tp = init_params(cfg.model, torch.Generator().manual_seed(0))
    carried = from_jax_params(jax.tree.map(np.asarray, jp), cfg.model)

    def shapes(tree):
        if isinstance(tree, dict):
            return {k: shapes(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [shapes(v) for v in tree]
        return (tuple(tree.shape), tree.dtype)

    assert shapes(tp) == shapes(carried)
    wq = tp["blocks"][0]["attn"]["wq"]
    assert abs(float(wq.std()) - 0.02) < 0.005


def _prefill_inputs(cfg):
    """Three prompts of one 32-token bucket (ragged), plus a pad row of
    length 1 on scratch page 0; distinct pool pages per row."""
    lens = np.array([32, 19, 5, 1], np.int32)
    rng = np.random.default_rng(2)
    toks = np.zeros((4, 32), np.int32)
    for i, n in enumerate(lens[:3]):
        toks[i, :n] = rng.integers(0, cfg.model.vocab_size, size=n)
    pages = np.array([[1, 2], [3, 4], [5, 6], [0, 0]], np.int32)
    return toks, lens, pages


@pytest.mark.parametrize("kernels", ["xla", "pallas_interpret"])
def test_prefill_step_matches_jax(kernels):
    jcfg, jp, cfg, tp = _pair("tiny-llama", kernels=kernels)
    toks, lens, pages = _prefill_inputs(cfg)
    jcache = j_init_cache(jcfg.model, jcfg.inference)
    jl, jcache = j_runner.prefill_step(
        jp, jcache, jnp.asarray(toks), jnp.asarray(lens), jnp.asarray(pages),
        cfg=jcfg.model)
    cache = init_cache(cfg.model, cfg.inference, "cpu")
    tl, cache = runner.prefill_step(
        tp, cache, torch.from_numpy(toks), torch.from_numpy(lens),
        torch.from_numpy(pages), cfg=cfg.model)
    np.testing.assert_allclose(tl.numpy()[:3], np.asarray(jl)[:3], atol=1e-4, rtol=0)
    NP = cfg.inference.num_pages
    live = (np.arange(cache["k"].shape[0]) % NP) != 0     # page 0 excluded
    for name in ("k", "v"):
        np.testing.assert_allclose(cache[name].numpy()[live],
                                   np.asarray(jcache[name])[live], atol=1e-5, rtol=0)


def test_decode_window_matches_jax():
    """Prefill two prompts, then one fused 6-step greedy decode window with
    a third, idle slot: same [W, B] tokens and the same pool."""
    jcfg, jp, cfg, tp = _pair("tiny-llama", kernels="pallas_interpret")
    toks, lens, pages = _prefill_inputs(cfg)
    toks, lens, pages = toks[:2], lens[:2], pages[:2]
    jcache = j_init_cache(jcfg.model, jcfg.inference)
    jl, jcache = j_runner.prefill_step(
        jp, jcache, jnp.asarray(toks), jnp.asarray(lens), jnp.asarray(pages),
        cfg=jcfg.model)
    cache = init_cache(cfg.model, cfg.inference, "cpu")
    _, cache = runner.prefill_step(
        tp, cache, torch.from_numpy(toks), torch.from_numpy(lens),
        torch.from_numpy(pages), cfg=cfg.model)
    first = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    B, W = 3, 6
    last = np.array([first[0], first[1], 0], np.int32)
    seq = np.array([lens[0], lens[1], 0], np.int32)
    table = np.zeros((B, 8), np.int32)
    table[:2, :3] = [[1, 2, 7], [3, 4, 8]]
    active = np.array([True, True, False])
    jt, jcache = j_runner.decode_window(
        jp, jcache, jnp.asarray(last), jnp.asarray(seq), jnp.asarray(table),
        jnp.asarray(active), jax.random.split(jax.random.key(0), W),
        0.0, 0, 1.0, cfg=jcfg.model, max_seq_len=128)
    tt, cache = runner.decode_window(
        tp, cache, torch.from_numpy(last), torch.from_numpy(seq),
        torch.from_numpy(table), torch.from_numpy(active), torch.Generator(),
        n_steps=W, cfg=cfg.model, max_seq_len=128)
    assert tt.shape == (W, B)
    assert np.array_equal(tt.numpy()[:, :2], np.asarray(jt)[:, :2])
    live = (np.arange(cache["k"].shape[0]) % cfg.inference.num_pages) != 0
    np.testing.assert_allclose(cache["k"].numpy()[live],
                               np.asarray(jcache["k"])[live], atol=1e-5, rtol=0)
