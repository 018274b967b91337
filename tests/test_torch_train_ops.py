"""Gradients of the port's ops (plain PyTorch versions under autograd, CPU)
against ``jax.vjp`` through the JAX package's ops.

The JAX side runs its xla reference and its Pallas kernels in interpret
mode, so the Pallas backward kernels (RMSNorm ``_dx_kernel``, RoPE with
``flip=True``, flash attention ``_dq_kernel`` / ``_dkv_kernel``) are the
reference. Inputs and cotangents are made with numpy from a seed; all in
float32. Tolerance 1e-5 absolute for norms and RoPE (a few float32 terms),
2e-5 for attention (sums over up to 40 keys and 4 query heads in another
order). The kernels themselves (K5-K8) run only on the card, where
``chip_smoke.py`` holds them against these plain versions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orion_tpu import ops as jops
from orion_tpu.ops.pallas.flash_attention import flash_attention_with_lse
from orion_tpu_torch import ops
from orion_tpu_torch.ops.common import NEG_INF
from tests import torch_threads  # noqa: F401  (one intra-op thread)

IMPLS = ["xla", "pallas_interpret"]


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


def _jax_vjp(fn, args, cotangent):
    _, pull = jax.vjp(fn, *[jnp.asarray(a) for a in args])
    return [np.asarray(g) for g in pull(jnp.asarray(cotangent))]


def _torch_vjp(fn, args, cotangent):
    leaves = [_t(a).requires_grad_(True) for a in args]
    out = fn(*leaves)
    return [g.numpy() for g in torch.autograd.grad(out, leaves, _t(cotangent))]


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("shape", [(3, 7, 64), (5, 128)])
def test_rmsnorm_grads_match_jax(impl, shape):
    rng = np.random.default_rng(10)
    x, s, g = _rand(rng, *shape), 1 + 0.1 * _rand(rng, shape[-1]), _rand(rng, *shape)
    want = _jax_vjp(lambda a, b: jops.rmsnorm(a, b, eps=1e-5, impl=impl), (x, s), g)
    got = _torch_vjp(lambda a, b: ops.rmsnorm(a, b, eps=1e-5), (x, s), g)
    for w, o in zip(want, got):
        np.testing.assert_allclose(o, w, atol=1e-5, rtol=0)


@pytest.mark.parametrize("impl", IMPLS)
def test_rope_grads_match_jax(impl):
    rng = np.random.default_rng(11)
    x, g = _rand(rng, 2, 9, 4, 16), _rand(rng, 2, 9, 4, 16)
    pos = jnp.asarray(rng.integers(0, 64, size=(2, 9)).astype(np.int32))
    (want,) = _jax_vjp(lambda a: jops.apply_rope(a, pos, theta=10000.0, impl=impl), (x,), g)
    (got,) = _torch_vjp(lambda a: ops.apply_rope(a, _t(pos), theta=10000.0), (x,), g)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


B, S, N, K, H = 2, 40, 4, 2, 16

ATTN_CASES = {
    "causal_gqa": dict(),
    "segments_pad_zero": dict(segments="packed"),
    "window": dict(window=8),
    "softcap": dict(logit_softcap=20.0),
    "q_offset": dict(q_offset=6),
    # q segment 2 against kv segment 3: rows that attend nothing give zero
    # output and zero grads, never NaN (the xla path averages v there
    # instead, so this case runs against the Pallas kernels only).
    "masked_rows": dict(segments="disjoint"),
}


def _attn_case(case, rng):
    kw = dict(ATTN_CASES[case])
    off = kw.get("q_offset", 0)
    q = _rand(rng, B, S - off, N, H)
    k, v = _rand(rng, B, S, K, H), _rand(rng, B, S, K, H)
    do = _rand(rng, B, S - off, N, H)
    segs = kw.pop("segments", None)
    jseg, tseg = {}, {}
    if segs == "packed":
        seg = np.zeros((B, S), np.int32)
        seg[0, :25], seg[0, 25:35], seg[1, :] = 1, 2, 1
        jseg = dict(q_segment_ids=jnp.asarray(seg), kv_segment_ids=jnp.asarray(seg),
                    seg_pad_zero=True)
        tseg = dict(q_segment_ids=_t(seg), kv_segment_ids=_t(seg), seg_pad_zero=True)
    elif segs == "disjoint":
        qs = np.ones((B, S), np.int32)
        ks = qs.copy()
        qs[:, S // 2:], ks[:, S // 2:] = 2, 3
        jseg = dict(q_segment_ids=jnp.asarray(qs), kv_segment_ids=jnp.asarray(ks))
        tseg = dict(q_segment_ids=_t(qs), kv_segment_ids=_t(ks))
    return (q, k, v), do, kw, jseg, tseg


@pytest.mark.parametrize("impl,case", [
    (impl, case) for case in sorted(ATTN_CASES) for impl in IMPLS
    if not (case == "masked_rows" and impl == "xla")
])
def test_attention_grads_match_jax(impl, case):
    rng = np.random.default_rng(12)
    args, do, kw, jseg, tseg = _attn_case(case, rng)
    want = _jax_vjp(lambda q, k, v: jops.attention(q, k, v, causal=True, impl=impl,
                                                    **kw, **jseg), args, do)
    got = _torch_vjp(lambda q, k, v: ops.attention(q, k, v, causal=True, **kw, **tseg),
                     args, do)
    for name, w, o in zip("qkv", want, got):
        assert np.isfinite(o).all(), name
        np.testing.assert_allclose(o, w, atol=2e-5, rtol=0, err_msg=f"d{name}")


@pytest.mark.parametrize("case", ["causal_gqa", "segments_pad_zero", "masked_rows"])
def test_attention_lse_matches_jax(case):
    """The plain version of K3's lse output against the Pallas forward's
    (which reports rows that attend nothing as -inf, the port as NEG_INF)."""
    rng = np.random.default_rng(13)
    (q, k, v), _, kw, jseg, tseg = _attn_case(case, rng)
    jseg.pop("seg_pad_zero", None)
    tseg.pop("seg_pad_zero", None)
    _, want = flash_attention_with_lse(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                       causal=True, interpret=True, **kw, **jseg)
    got = ops.attention_lse_plain(_t(q), _t(k), causal=True, **kw, **tseg).numpy()
    want = np.asarray(want)
    none = np.isneginf(want)
    assert np.array_equal(got <= NEG_INF / 2, none)
    np.testing.assert_allclose(got[~none], want[~none], atol=1e-5, rtol=0)


def test_cpu_backward_launches_no_kernel():
    ops.reset_launches()
    rng = np.random.default_rng(14)
    x = _t(_rand(rng, 2, 3, 4, 16)).requires_grad_(True)
    y = ops.attention(ops.apply_rope(x, torch.zeros(2, 3, dtype=torch.int32)), x, x)
    ops.rmsnorm(y, torch.ones(16, requires_grad=True)).sum().backward()
    assert x.grad is not None
    assert ops.launches() == {name: 0 for name in ops.KERNELS}
