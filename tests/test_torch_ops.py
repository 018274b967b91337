"""The port's ops (plain PyTorch versions, CPU) against orion_tpu.ops.

Inputs are made with numpy from a seed and fed to both packages. The JAX
side runs its xla reference and its Pallas kernels in interpret mode. All
comparisons are float32; the tolerance is 1e-5 absolute unless a case
says otherwise (sums of a few dozen float32 terms in another order).
The kernels themselves run only on the card: chip_smoke.py holds them
against these plain versions there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orion_tpu import ops as jops
from orion_tpu.infer.sampling import filter_logits as j_filter_logits
from orion_tpu.ops.attention import attention_mask as j_mask
from orion_tpu.ops.pallas.paged_attention import paged_attention as j_paged
from orion_tpu_torch import ops
from orion_tpu_torch.infer.sampling import filter_logits, sample
from tests import torch_threads  # noqa: F401  (one intra-op thread)

ATOL = 1e-5
IMPLS = ["xla", "pallas_interpret"]


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("shape", [(3, 7, 64), (5, 128)])
def test_rmsnorm_matches_jax(impl, shape):
    rng = np.random.default_rng(0)
    x, s = _rand(rng, *shape), _rand(rng, shape[-1])
    want = jops.rmsnorm(jnp.asarray(x), jnp.asarray(s), eps=1e-5, impl=impl)
    got = ops.rmsnorm(_t(x), _t(s), eps=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


@pytest.mark.parametrize("impl", IMPLS)
def test_rope_matches_jax(impl):
    rng = np.random.default_rng(1)
    x = _rand(rng, 2, 9, 4, 16)
    pos = rng.integers(0, 64, size=(2, 9)).astype(np.int32)
    want = jops.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta=10000.0, impl=impl)
    got = ops.apply_rope(_t(x), _t(pos), theta=10000.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def test_rope_broadcasts_1d_positions():
    rng = np.random.default_rng(2)
    x = _rand(rng, 3, 5, 2, 8)
    pos = np.arange(5, dtype=np.int32)
    want = jops.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta=500000.0)
    got = ops.apply_rope(_t(x), _t(pos), theta=500000.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


ATTN_CASES = {
    # causal + ragged segment ids (0 = padding) + window + softcap + GQA
    "segments_window_softcap": dict(window=8, logit_softcap=20.0, segments=True),
    "causal_gqa": dict(),
    "q_offset": dict(q_offset=6),
}


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_attention_matches_jax(impl, case):
    kw = dict(ATTN_CASES[case])
    rng = np.random.default_rng(3)
    B, S, N, K, H = 2, 40, 4, 2, 16
    off = kw.get("q_offset", 0)
    q = _rand(rng, B, S - off, N, H)
    k, v = _rand(rng, B, S, K, H), _rand(rng, B, S, K, H)
    jkw, tkw = {}, {}
    rows = np.ones((B, S - off), bool)
    if kw.pop("segments", False):
        seg = np.zeros((B, S), np.int32)
        seg[0, :25], seg[0, 25:35], seg[1, :] = 1, 2, 1
        jkw = dict(q_segment_ids=jnp.asarray(seg), kv_segment_ids=jnp.asarray(seg),
                   seg_pad_zero=True)
        tkw = dict(q_segment_ids=_t(seg), kv_segment_ids=_t(seg), seg_pad_zero=True)
        rows = seg > 0   # padded query rows hold garbage on the kernel path
    want = jops.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          causal=True, impl=impl, **kw, **jkw)
    got = ops.attention(_t(q), _t(k), _t(v), causal=True, **kw, **tkw)
    np.testing.assert_allclose(got.numpy()[rows], np.asarray(want)[rows],
                               atol=ATOL, rtol=0)


def test_attention_mask_matches_jax():
    seg = np.array([[1, 1, 2, 2, 0]], np.int32)
    jm = j_mask(5, 5, causal=True, window=2, q_segment_ids=jnp.asarray(seg),
                kv_segment_ids=jnp.asarray(seg))
    tm = ops.attention_mask(5, 5, causal=True, window=2, q_segment_ids=_t(seg),
                            kv_segment_ids=_t(seg))
    assert np.array_equal(tm.numpy(), np.asarray(jm))


def _paged_inputs(rng):
    """Three slots over a 2-layer pool (12 pages per layer, page size 8),
    read at layer 1 (layer_base 12); every slot owns distinct pages."""
    B, N, K, H, psz, P, NP = 3, 4, 2, 16, 8, 4, 12
    k_pool, v_pool = _rand(rng, 2 * NP, K, psz, H), _rand(rng, 2 * NP, K, psz, H)
    table = np.zeros((B, P), np.int32)
    ids = rng.permutation(np.arange(1, NP)).astype(np.int32)
    table[0, :1], table[1, :2], table[2, :4] = ids[:1], ids[1:3], ids[3:7]
    last_pos = np.array([0, 13, 31], np.int32)
    q = _rand(rng, B, N, H)
    kn, vn = _rand(rng, B, K, H), _rand(rng, B, K, H)
    return q, k_pool, v_pool, table, last_pos, kn, vn, NP


@pytest.mark.parametrize("window,softcap", [(None, None), (5, None), (None, 10.0)])
def test_paged_decode_matches_jax(window, softcap):
    rng = np.random.default_rng(4)
    q, kp, vp, table, lp, kn, vn, NP = _paged_inputs(rng)
    jo, jk, jv = j_paged(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(table),
        jnp.asarray(lp), layer_base=NP, k_new=jnp.asarray(kn),
        v_new=jnp.asarray(vn), logit_softcap=softcap, window=window,
        interpret=True,
    )
    tk, tv = _t(kp), _t(vp)
    to, tk2, tv2 = ops.paged_attention(
        _t(q), tk, tv, _t(table), _t(lp), layer_base=NP, k_new=_t(kn),
        v_new=_t(vn), logit_softcap=softcap, window=window,
    )
    assert tk2 is tk and tv2 is tv          # updated in place
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=ATOL, rtol=0)
    live = (np.arange(kp.shape[0]) % NP) != 0    # page-0 rows excluded
    assert np.array_equal(tk.numpy()[live].view(np.int32),
                          np.asarray(jk)[live].view(np.int32))
    assert np.array_equal(tv.numpy()[live].view(np.int32),
                          np.asarray(jv)[live].view(np.int32))


def test_paged_decode_without_write_reads_pool():
    rng = np.random.default_rng(5)
    q, kp, vp, table, lp, _, _, NP = _paged_inputs(rng)
    want = j_paged(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                   jnp.asarray(table), jnp.asarray(lp), layer_base=NP,
                   interpret=True)
    got = ops.paged_attention(_t(q), _t(kp), _t(vp), _t(table), _t(lp),
                              layer_base=NP)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


@pytest.mark.parametrize("no_topk,no_topp", [(False, False), (False, True), (True, False)])
def test_filter_logits_matches_jax(no_topk, no_topp):
    rng = np.random.default_rng(6)
    logits = 3.0 * _rand(rng, 4, 50)
    temp = np.array([0.0, 0.7, 1.0, 1.5], np.float32)
    top_k = np.array([0, 5, 1, 50], np.int32)
    top_p = np.array([0.9, 1.0, 0.5, 0.2], np.float32)
    want = j_filter_logits(jnp.asarray(logits), jnp.asarray(temp),
                           jnp.asarray(top_k), jnp.asarray(top_p),
                           no_topk=no_topk, no_topp=no_topp)
    got = filter_logits(_t(logits), _t(temp), _t(top_k), _t(top_p),
                        no_topk=no_topk, no_topp=no_topp)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=1e-6)


def test_sample_greedy_and_filtered_support():
    gen = torch.Generator().manual_seed(0)
    logits = torch.tensor([[0.1, 3.0, -1.0, -1.0], [2.0, 0.0, 5.0, -3.0]])
    assert sample(logits, gen, temperature=0.0).tolist() == [1, 2]
    for _ in range(20):
        t = sample(torch.tensor([[5.0, 4.0, -10.0, -10.0]]), gen,
                   temperature=1.0, top_k=2)
        assert int(t[0]) in (0, 1)
        t = sample(torch.tensor([[10.0, 9.0, -10.0, -10.0]]), gen,
                   temperature=1.0, top_p=0.9)
        assert int(t[0]) in (0, 1)
    rows = sample(logits, gen, temperature=torch.tensor([0.0, 0.0]),
                  top_k=torch.tensor([0, 2]), top_p=torch.tensor([1.0, 0.5]))
    assert rows.tolist() == [1, 2]


def test_cpu_tensors_take_plain_versions_without_launching():
    ops.reset_launches()
    rng = np.random.default_rng(7)
    x = _t(_rand(rng, 2, 3, 8, 16))
    ops.rmsnorm(x, torch.ones(16))
    ops.apply_rope(x, torch.zeros(2, 3, dtype=torch.int32))
    ops.attention(x, x, x)
    assert ops.launches() == {name: 0 for name in ops.KERNELS}


def test_other_devices_raise_instead_of_falling_back():
    x = torch.empty(2, 4, 8, device="meta")
    with pytest.raises(ValueError, match="CPU"):
        ops.rmsnorm(x, torch.empty(8, device="meta"))
    with pytest.raises(ValueError, match="CPU"):
        ops.rmsnorm(torch.ones(2, 8), torch.empty(8, device="meta"))
