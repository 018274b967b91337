"""The port's int8 KV quantization, K4's int8 branch, K9 (paged-flash
prefill) and the prefix cache, on the CPU, against the JAX package.

Inputs are made with numpy from a seed and fed to both packages. The JAX
kernels run in interpret mode (their own CPU tests run them so), at the
sizes of the JAX package's own paged-prefill tests: page 16, 2 kv heads,
2 query heads each, head_dim 64. Outputs are compared in float32 to 1e-5
(sums of up to a few hundred float32 terms in another order, and the
int8 scale applied to the logit before or after the product); what is
written into the pools, int8 pages and float32 scales alike, must be
byte-equal. Page 0 is the scratch page pad rows and idle slots write,
never read: it is left out of the byte comparisons.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orion_tpu.infer.kv_cache import PageAllocator as JPageAllocator
from orion_tpu.infer.prefix_cache import PrefixCache as JPrefixCache
from orion_tpu.ops.pallas.common import quantize_kv as j_quantize_kv
from orion_tpu.ops.pallas.paged_attention import paged_attention as j_paged
from orion_tpu.ops.pallas.paged_flash_prefill import (
    paged_flash_prefill as j_paged_prefill,
)
from orion_tpu_torch import ops
from orion_tpu_torch.infer.kv_cache import PageAllocator, copy_page
from orion_tpu_torch.infer.prefix_cache import PrefixCache
from tests import torch_threads  # noqa: F401  (one intra-op thread)

ATOL = 1e-5
PSZ, K, G, H = 16, 2, 2, 64
N = K * G
SW = 128          # scale lanes of a page (the JAX package's one lane tile)


def _t(a):
    return torch.from_numpy(np.array(a))


def _pools(rng, rows, quant):
    """Random pools: int8 with float32 scales in (0.01, 0.06), or float32."""
    if quant:
        kp, vp = (rng.integers(-127, 128, (rows, K, PSZ, H)).astype(np.int8)
                  for _ in range(2))
        ks, vs = (rng.random((rows, K, SW)).astype(np.float32) * 0.05 + 0.01
                  for _ in range(2))
        return kp, vp, ks, vs
    kp, vp = (rng.standard_normal((rows, K, PSZ, H)).astype(np.float32)
              for _ in range(2))
    return kp, vp, None, None


def _bytes_equal(got: torch.Tensor, want, skip_rows=()) -> None:
    a, b = got.numpy(), np.asarray(want)
    keep = np.ones(a.shape[0], bool)
    keep[list(skip_rows)] = False
    assert a.dtype == b.dtype
    assert np.array_equal(a[keep].view(np.uint8), b[keep].view(np.uint8))


# -- (a) quantize_kv ----------------------------------------------------------


def _quant_rows(rng):
    rand = rng.standard_normal((6, 5, H)).astype(np.float32) * np.float32(3.0)
    # Multiples of 0.5 with max |x| = 127: the scale is float32(127 / 127)
    # and x / s lands on .5 ties, which round half to even.
    ties = (rng.integers(-254, 255, (4, H)) / 2).astype(np.float32)
    ties[:, 0] = 127.0
    tiny = rng.standard_normal((3, H)).astype(np.float32) * np.float32(1e-9)
    zero = np.zeros((2, H), np.float32)
    return {"random": rand, "ties": ties, "tiny": tiny, "zeros": zero}


@pytest.mark.parametrize("kind", ["random", "ties", "tiny", "zeros"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_bytes_match_jax(kind, dtype):
    x = _quant_rows(np.random.default_rng(0))[kind]
    jx = jnp.asarray(x).astype(dtype)
    tx = _t(x).to(getattr(torch, dtype))
    jq, js = j_quantize_kv(jx)
    tq, ts = ops.quantize_kv(tx)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    _bytes_equal(tq, jq)
    _bytes_equal(ts, js)


# -- (b) K4's int8 branch -----------------------------------------------------


@pytest.mark.parametrize("window,softcap", [(None, None), (24, 20.0)])
def test_paged_decode_int8_matches_jax(window, softcap):
    """Three slots over layer 1 of a two-layer pool: an idle slot (all-zero
    table: writes scratch page 0), and two live slots whose new token lands
    mid-page and on a page's first column."""
    rng = np.random.default_rng(1)
    NP, P = 12, 5
    rows, base = 2 * NP, NP
    kp, vp, ks, vs = _pools(rng, rows, quant=True)
    q = rng.standard_normal((3, N, H)).astype(np.float32)
    kn, vn = (rng.standard_normal((3, K, H)).astype(np.float32) for _ in range(2))
    table = np.zeros((3, P), np.int32)
    table[1, :3] = [4, 9, 2]
    table[2, :5] = [7, 1, 11, 3, 6]
    last_pos = np.array([0, 37, 64], np.int32)
    kw = dict(layer_base=base, logit_softcap=softcap, window=window)
    want = j_paged(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                   jnp.asarray(table), jnp.asarray(last_pos), interpret=True,
                   k_new=jnp.asarray(kn), v_new=jnp.asarray(vn),
                   k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs), **kw)
    pools = [_t(a) for a in (kp, vp, ks, vs)]
    got = ops.paged_attention(_t(q), pools[0], pools[1], _t(table), _t(last_pos),
                              k_new=_t(kn), v_new=_t(vn), k_scale=pools[2],
                              v_scale=pools[3], **kw)
    assert len(got) == 5 and all(g is p for g, p in zip(got[1:], pools))
    np.testing.assert_allclose(got[0].numpy()[1:], np.asarray(want[0])[1:],
                               atol=ATOL, rtol=0)
    for g, w in zip(got[1:], want[1:]):
        _bytes_equal(g, w, skip_rows=[base])
    # The write is quantize_kv's bits at column last_pos % psz.
    kq, ksc = ops.quantize_kv(_t(kn))
    for b in (1, 2):
        row = base + table[b, last_pos[b] // PSZ]
        col = last_pos[b] % PSZ
        assert torch.equal(pools[0][row, :, col], kq[b])
        assert torch.equal(pools[2][row, :, col], ksc[b])


# -- (c) K9, paged-flash prefill ------------------------------------------------


def _prefill_case(rng, quant, P_pre=3, NC=2):
    """Four rows over one pool: a full prefix and chunk; one prefix page
    and a ragged 7-token chunk; a prompt's first chunk (start 0) inside a
    P_pre > 0 batch; a pad row (length 1, all-zero walk)."""
    NP = 48
    B, S = 4, NC * PSZ
    kp, vp, ks, vs = _pools(rng, NP, quant)
    q = rng.standard_normal((B, S, N, H)).astype(np.float32)
    kn, vn = (rng.standard_normal((B, S, K, H)).astype(np.float32) for _ in range(2))
    walk = np.zeros((B, P_pre + NC), np.int32)
    ids = rng.permutation(NP - 1)[: 3 * (P_pre + NC)] + 1
    walk[:3] = ids.reshape(3, P_pre + NC)
    walk[1, 1:P_pre] = 0           # one prefix page: the rest pad the walk
    walk[2, :P_pre] = 0            # start 0: no history
    start = np.array([P_pre * PSZ, PSZ, 0, 0], np.int32)
    lens = np.array([S, 7, 20, 1], np.int32)
    return q, kp, vp, ks, vs, kn, vn, walk, start, lens


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("window,softcap", [(None, None), (24, None), (None, 20.0),
                                            (24, 20.0)])
def test_paged_flash_prefill_matches_jax(quant, window, softcap):
    rng = np.random.default_rng(3)
    P_pre = 3
    q, kp, vp, ks, vs, kn, vn, walk, start, lens = _prefill_case(rng, quant, P_pre)
    kw = dict(n_prefix_pages=P_pre, layer_base=0, logit_softcap=softcap, window=window)
    jscale = {} if not quant else dict(k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
    want = j_paged_prefill(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(walk),
        jnp.asarray(start), jnp.asarray(lens), jnp.asarray(kn), jnp.asarray(vn),
        interpret=True, **jscale, **kw)
    pools = [_t(kp), _t(vp)] + ([_t(ks), _t(vs)] if quant else [])
    scales = dict(k_scale=pools[2], v_scale=pools[3]) if quant else {}
    got = ops.paged_flash_prefill(_t(q), pools[0], pools[1], _t(walk), _t(start),
                                  _t(lens), _t(kn), _t(vn), **scales, **kw)
    assert len(got) == len(want) == 1 + len(pools)
    assert all(g is p for g, p in zip(got[1:], pools))
    real = np.arange(q.shape[1])[None] < lens[:, None]     # [B, S] real queries
    np.testing.assert_allclose(got[0].numpy()[real], np.asarray(want[0])[real],
                               atol=ATOL, rtol=0)
    for g, w in zip(got[1:], want[1:]):
        _bytes_equal(g, w, skip_rows=[0])
    # History pages are read, never written; scale lanes >= psz untouched.
    hist = walk[:, :P_pre][walk[:, :P_pre] > 0]
    assert np.array_equal(pools[0].numpy()[hist], kp[hist])
    if quant:
        written = walk[:3, P_pre:].ravel()
        assert np.array_equal(pools[2].numpy()[written][..., PSZ:], ks[written][..., PSZ:])


def test_paged_flash_prefill_plain_requires_paired_scales():
    rng = np.random.default_rng(4)
    q, kp, vp, ks, vs, kn, vn, walk, start, lens = _prefill_case(rng, True)
    with pytest.raises(ValueError, match="together"):
        ops.paged_flash_prefill(_t(q), _t(kp), _t(vp), _t(walk), _t(start), _t(lens),
                                _t(kn), _t(vn), n_prefix_pages=3, k_scale=_t(ks))


@pytest.mark.parametrize("head_dim,page_size,ok", [
    (128, 64, True), (256, 64, True), (64, 128, True), (128, 16, True),
    (128, 128, False), (256, 128, False), (128, 48, False), (128, 8, False),
    (96, 64, False),
])
def test_check_prefill_fit(head_dim, page_size, ok):
    kw = dict(n_heads=32, n_kv_heads=8, head_dim=head_dim, page_size=page_size)
    if ok:
        ops.check_prefill_fit(**kw)
    else:
        with pytest.raises(ValueError, match="page_size|head_dim"):
            ops.check_prefill_fit(**kw)


def test_copy_page_copies_every_layer_and_scale():
    rng = np.random.default_rng(5)
    NP = 6
    cache = {name: _t(a) for name, a in
             zip(("k", "v", "k_scale", "v_scale"), _pools(rng, 3 * NP, True))}
    before = {name: t.clone() for name, t in cache.items()}
    copy_page(cache, 2, 5, n_layers=3, num_pages=NP)
    for name, t in cache.items():
        for layer in range(3):
            assert torch.equal(t[layer * NP + 5], before[name][layer * NP + 2])
            assert torch.equal(t[layer * NP + 2], before[name][layer * NP + 2])
        other = [r for r in range(3 * NP) if r % NP != 5]
        assert torch.equal(t[other], before[name][other])


# -- (d) PrefixCache ----------------------------------------------------------


def test_prefix_cache_matches_jax():
    """One sequence of insert, match, lock, evict and clear through both
    trees, each over its own allocator: every return value, the page
    accounting and the refcounts stay the same."""
    psz, num_pages = 4, 40
    pairs = []
    for alloc_cls, cache_cls in ((JPageAllocator, JPrefixCache),
                                 (PageAllocator, PrefixCache)):
        alloc = alloc_cls(num_pages)
        pairs.append((alloc, cache_cls(psz, alloc)))
    rng = np.random.default_rng(6)
    sys_prompt = rng.integers(0, 50, 12).tolist()
    a = sys_prompt + rng.integers(0, 50, 9).tolist()     # 5 full pages + 1
    b = sys_prompt + rng.integers(0, 50, 8).tolist()     # shares 3 pages
    c = rng.integers(50, 99, 16).tolist()

    def run(alloc, pc):
        log = []
        pa = alloc.alloc(5)
        log.append(("insert a", pc.insert(a[:20], pa)))
        alloc.free(pa)                                   # the request's refs
        pages, node_b = pc.match(b, len(b) // psz)
        log.append(("match b", pages, pc.evictable_pages()))
        for p in pages:
            alloc.retain(p)
        pb = pages + alloc.alloc(2)
        pc2, node_c = pc.match(c, 4)
        log.append(("match c (miss)", pc2, node_c is None))
        log.append(("peek a", pc.peek(a, 5), pc.peek(a, 2), pc.peek(c, 4)))
        log.append(("evict under lock", pc.evict(10), pc.evictable_pages(),
                    pc.total_pages))
        log.append(("insert b", pc.insert(b[:20], pb)))
        pc.unlock(node_b)
        alloc.free(pb)
        pcc = alloc.alloc(4)
        log.append(("insert c", pc.insert(c, pcc)))
        alloc.free(pcc)
        pages, node = pc.match(a, 5)
        log.append(("rematch a", pages, pc.evictable_pages()))
        log.append(("evict 3", pc.evict(3), pc.total_pages, alloc.free_pages))
        pc.unlock(node)
        log.append(("evict 2", pc.evict(2), sorted(pc.held_pages())))
        log.append(("refs", [alloc.refcount(p) for p in range(num_pages)]))
        log.append(("clear", pc.clear(), pc.total_pages, pc.evictable_pages(),
                    alloc.free_pages))
        return log

    want, got = (run(*pair) for pair in pairs)
    assert got == want
    assert pairs[1][0].free_pages == num_pages - 1
