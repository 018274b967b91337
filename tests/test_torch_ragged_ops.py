"""K10's plain version (``ops.ragged_paged_attention_plain``, the verify
attention of speculative decoding) on the CPU, against the JAX package's
``ragged_paged_attention`` in interpret mode.

The cases are those of the JAX package's own ragged tests: 3 slots of W =
5 queries, head_dim 64, page 16, a 32-page pool; rows start at 0, mid-page
(13) and near the table's end (59) with 5, 1 and 3 real queries. Inputs
are made with numpy from a seed and fed to both packages. The table never
names page 0: the plain version parks padding tokens there, the port's
scratch page, which the byte comparisons leave out. Outputs of real query
rows agree within 1e-5 in float32 (sums of a few hundred terms in another
order; under int8 the scale applied to the logit before or after the
product); what is written into the pools, int8 pages and float32 scales
alike, must be byte-equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orion_tpu.ops.pallas.common import quantize_kv as j_quantize_kv
from orion_tpu.ops.pallas.ragged_paged_attention import (
    ragged_paged_attention as j_ragged,
)
from orion_tpu.infer.spec_decode import DraftTree
from orion_tpu_torch import ops
from orion_tpu_torch.ops.ragged_paged_attention import verify_smem_bytes
from tests import torch_threads  # noqa: F401  (one intra-op thread)

ATOL = 1e-5
B, W, H, PSZ, NUM_PAGES, SW = 3, 5, 64, 16, 32, 128
TABLE = np.array([[5, 17, 2, 9], [30, 1, 7, 3], [11, 4, 8, 22]], np.int32)
START = np.array([0, 13, 59], np.int32)
LENS = np.array([W, 1, 3], np.int32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _case(seed, N=8, K=2, rows=NUM_PAGES):
    rng = np.random.default_rng(seed)

    def f(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    return dict(q=f(B, W, N, H), kp=f(rows, K, PSZ, H), vp=f(rows, K, PSZ, H),
                kn=f(B, W, K, H), vn=f(B, W, K, H))


def _real_close(got, want, lens, atol=ATOL):
    got, want = np.asarray(got), np.asarray(want)
    for b in range(len(lens)):
        np.testing.assert_allclose(got[b, :lens[b]], want[b, :lens[b]], atol=atol)


def _bytes_equal(got: torch.Tensor, want, skip_rows=(0,)) -> None:
    a, b = got.numpy(), np.asarray(want)
    keep = np.ones(a.shape[0], bool)
    keep[list(skip_rows)] = False
    assert a.dtype == b.dtype
    assert np.array_equal(a[keep].view(np.uint8), b[keep].view(np.uint8))


def _both(c, *, start=START, lens=LENS, write=True, **kw):
    """The JAX kernel (interpret) and the port's plain version on the same
    inputs; returns (jax results, port results) as tuples."""
    jkw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
    tkw = {k: (_t(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
    if write:
        jkw.update(k_new=jnp.asarray(c["kn"]), v_new=jnp.asarray(c["vn"]))
        tkw.update(k_new=_t(c["kn"]), v_new=_t(c["vn"]))
    want = j_ragged(jnp.asarray(c["q"]), jnp.asarray(c["kp"]), jnp.asarray(c["vp"]),
                    jnp.asarray(TABLE), jnp.asarray(start), jnp.asarray(lens),
                    interpret=True, **jkw)
    got = ops.ragged_paged_attention(_t(c["q"]), _t(c["kp"]), _t(c["vp"]), _t(TABLE),
                                     _t(start), _t(lens), **tkw)
    if not write:
        return (want,), (got,)
    return tuple(want), tuple(got)


@pytest.mark.parametrize("gqa", [(8, 8), (8, 2), (4, 1)])
def test_gqa_matches_jax(gqa):
    """(a) read-only attention over the pool, query-per-kv-head groups of
    1, 4 and 4 (one kv head)."""
    N, K = gqa
    c = _case(2, N=N, K=K)
    want, got = _both(c, write=False)
    _real_close(got[0], want[0], LENS)


@pytest.mark.parametrize("start,lens", [
    (START, LENS),
    # Rows straddling page boundaries: the W tokens land on two pages.
    (np.array([14, 30, 46], np.int32), np.array([5, 4, 2], np.int32)),
])
def test_fused_write_matches_jax(start, lens):
    """(b) the W real tokens' K/V written into float32 pools, byte-equal to
    the JAX kernel's writes; outputs of real rows within 1e-5."""
    c = _case(3)
    want, got = _both(c, start=start, lens=lens)
    _real_close(got[0], want[0], lens)
    _bytes_equal(got[1], want[1])
    _bytes_equal(got[2], want[2])


def _int8_pools(c):
    """int8 pools and [rows, K, 128] float32 scale pools made by the JAX
    quantizer from the case's float pools (lanes past the page zero)."""
    out = []
    for pool in (c["kp"], c["vp"]):
        q, s = j_quantize_kv(jnp.asarray(pool).transpose(0, 2, 1, 3))
        sc = np.zeros((pool.shape[0], pool.shape[1], SW), np.float32)
        sc[:, :, :PSZ] = np.asarray(s).transpose(0, 2, 1)
        out += [np.asarray(q.transpose(0, 2, 1, 3)), sc]
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_matches_jax(dtype):
    """(c) int8 pools: the in-place quantized write of the real tokens
    (pages and scale columns) byte-equal to the JAX kernel's; outputs
    within 1e-5 in float32 (bf16 queries: within one bf16 ulp at the
    outputs' scale, 2e-2, as the port's rounding of dequantized K/V to bf16
    differs from the kernel's float32 scaling)."""
    c = _case(11)
    kq, ks, vq, vs = _int8_pools(c)
    c = dict(c, kp=kq, vp=vq)
    if dtype == "bfloat16":
        jq = jnp.asarray(c["q"]).astype(jnp.bfloat16)
        jk, jv = (jnp.asarray(c[n]).astype(jnp.bfloat16) for n in ("kn", "vn"))
        tq = _t(c["q"]).to(torch.bfloat16)
        tk, tv = (_t(c[n]).to(torch.bfloat16) for n in ("kn", "vn"))
    else:
        jq, jk, jv = (jnp.asarray(c[n]) for n in ("q", "kn", "vn"))
        tq, tk, tv = (_t(c[n]) for n in ("q", "kn", "vn"))
    want = j_ragged(jq, jnp.asarray(kq), jnp.asarray(vq), jnp.asarray(TABLE),
                    jnp.asarray(START), jnp.asarray(LENS), k_new=jk, v_new=jv,
                    k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs), interpret=True)
    got = ops.ragged_paged_attention(tq, _t(kq), _t(vq), _t(TABLE), _t(START), _t(LENS),
                                     k_new=tk, v_new=tv, k_scale=_t(ks), v_scale=_t(vs))
    _real_close(got[0].float(), np.asarray(want[0], np.float32), LENS,
                atol=ATOL if dtype == "float32" else 2e-2)
    for g, w in zip(got[1:], want[1:]):
        _bytes_equal(g, w)


@pytest.mark.parametrize("window,softcap", [(5, None), (20, None), (1000, None),
                                            (None, 20.0), (7, 30.0)])
def test_window_and_softcap_match_jax(window, softcap):
    """(d) sliding windows per query (pages behind the earliest query's
    window are skipped by the kernel, masked by the plain version) and
    the logit softcap (queries scaled by 4 into the tanh's curve)."""
    c = _case(7)
    c["q"] = c["q"] * np.float32(4.0)
    want, got = _both(c, window=window, logit_softcap=softcap)
    _real_close(got[0], want[0], LENS)
    _bytes_equal(got[1], want[1])


def test_layer_base_matches_jax():
    """(e) a two-layer flat pool at layer_base = num_pages: reads and writes
    land in layer 1's rows; layer 0's rows stay as they were."""
    c = _case(5, rows=2 * NUM_PAGES)
    before = c["kp"].copy()
    want, got = _both(c, layer_base=NUM_PAGES)
    _real_close(got[0], want[0], LENS)
    _bytes_equal(got[1], want[1], skip_rows=(NUM_PAGES,))   # layer 1's scratch page
    _bytes_equal(got[2], want[2], skip_rows=(NUM_PAGES,))
    assert np.array_equal(got[1].numpy()[:NUM_PAGES], before[:NUM_PAGES])


def _tree_arrays(parents):
    """[B, W] depths and ancestor words for one tree shared by all rows,
    columns past the tree chain-shaped (as the engine pads them)."""
    t = DraftTree(tokens=[0] * len(parents), parents=list(parents))
    steps = np.arange(W, dtype=np.int64)
    depths = np.tile(steps, (B, 1)).astype(np.int32)
    words = np.tile((np.int64(1) << (steps + 1)) - 1, (B, 1)).astype(np.int32)
    n = len(parents) + 1
    depths[:, :n] = t.depths()
    words[:, :n] = t.mask_words()
    return depths, words


def _ancestor_reference(c, parents, lens, window=None):
    """Attention of each real query over exactly what a token tree lets it
    see, written out per query: the context below start, and the new slots
    on its own root path (itself included); under a window, new slots by
    depth and context by start + depth. float64, after the plain version's
    scatter (slot-sequential writes)."""
    q, kp, vp = c["q"].astype(np.float64), c["kp"].copy(), c["vp"].copy()
    N, K = q.shape[2], kp.shape[1]
    G = N // K
    t = DraftTree(tokens=[0] * len(parents), parents=list(parents))
    depth = t.depths() + list(range(len(parents) + 1, W))
    par = [0] + list(parents) + list(range(len(parents), W - 1))
    out = np.zeros(q.shape)
    for b in range(B):
        st = int(START[b])
        for j in range(int(lens[b])):
            pos = st + j
            kp[TABLE[b, pos // PSZ], :, pos % PSZ] = c["kn"][b, j]
            vp[TABLE[b, pos // PSZ], :, pos % PSZ] = c["vn"][b, j]
        for w in range(int(lens[b])):
            path, i = {w}, w
            while i:
                i = par[i]
                path.add(i)
            vis = [p for p in range(st) if window is None or p >= st + depth[w] - window + 1]
            vis += [st + i for i in sorted(path)
                    if window is None or depth[i] >= depth[w] - window + 1]
            kk = np.stack([kp[TABLE[b, p // PSZ], :, p % PSZ] for p in vis])   # [T, K, H]
            vv = np.stack([vp[TABLE[b, p // PSZ], :, p % PSZ] for p in vis])
            for n in range(N):
                z = kk[:, n // G].astype(np.float64) @ q[b, w, n] * H ** -0.5
                p_ = np.exp(z - z.max())
                out[b, w, n] = (p_ / p_.sum()) @ vv[:, n // G]
    return out


@pytest.mark.parametrize("window", [None, 2])
def test_tree_branchy_matches_reference_and_jax(window):
    """(f) a branchy tree (columns 1<-0, 2<-1, 3<-0, 4<-3: two siblings off
    the root, each with a child): sibling slots must not see each other,
    the write stays slot-sequential; against the per-query ancestor
    reference and the JAX kernel."""
    c = _case(9)
    parents = [0, 1, 0, 3]
    depths, words = _tree_arrays(parents)
    want, got = _both(c, tree_mask=words, depths=depths, window=window)
    _real_close(got[0], want[0], LENS)
    _bytes_equal(got[1], want[1])
    _real_close(got[0], _ancestor_reference(c, parents, LENS, window), LENS)


@pytest.mark.parametrize("window", [None, 20])
def test_tree_chain_shaped_is_chain_bitwise(window):
    """(f) chain-shaped words and depths give bitwise the chain's outputs
    and pool writes (scratch page 0 aside, where padding tokens of several
    rows land in no fixed order)."""
    c = _case(4)
    depths, words = _tree_arrays(list(range(W - 1)))
    args = lambda: (_t(c["q"]), _t(c["kp"]), _t(c["vp"]), _t(TABLE), _t(START),  # noqa: E731
                    _t(LENS))
    kw = dict(k_new=_t(c["kn"]), v_new=_t(c["vn"]), window=window)
    chain = ops.ragged_paged_attention(*args(), **kw)
    tree = ops.ragged_paged_attention(*args(), tree_mask=_t(words), depths=_t(depths), **kw)
    assert torch.equal(chain[0], tree[0])
    for a, b in zip(chain[1:], tree[1:]):
        _bytes_equal(a, b.numpy())      # padding tokens land on scratch page 0


def test_w1_matches_paged_decode_plain():
    """W = 1 is K4's decode: the same output and the same pool write as
    ``paged_attention_plain`` at last_pos = start."""
    c = _case(6)
    one = np.ones(B, np.int32)
    got = ops.ragged_paged_attention(
        _t(c["q"][:, :1]), _t(c["kp"]), _t(c["vp"]), _t(TABLE), _t(START), _t(one),
        k_new=_t(c["kn"][:, :1]), v_new=_t(c["vn"][:, :1]))
    want = ops.paged_attention_plain(
        _t(c["q"][:, 0]), _t(c["kp"]), _t(c["vp"]), _t(TABLE), _t(START),
        k_new=_t(c["kn"][:, 0]), v_new=_t(c["vn"][:, 0]))
    torch.testing.assert_close(got[0][:, 0], want[0], atol=1e-6, rtol=0)
    _bytes_equal(got[1], want[1].numpy())


def test_fit_check():
    """(g) the shared-memory fit: Llama-3-8B's shape fits up to W = 31 at
    page 64; a too-wide W or head_dim is a config error naming the knob."""
    shape = dict(n_heads=32, n_kv_heads=8, page_size=64)
    for w in (1, 5, 8, 31):
        ops.check_verify_fit(w, head_dim=128, **shape)
    assert verify_smem_bytes(31, head_dim=128, **shape) <= 232448
    with pytest.raises(ValueError, match="speculate_tokens"):
        ops.check_verify_fit(33, head_dim=128, **shape)
    with pytest.raises(ValueError, match="speculate_tokens"):
        ops.check_verify_fit(16, head_dim=256, **shape)
    with pytest.raises(ValueError, match="head_dim"):
        ops.check_verify_fit(5, head_dim=96, **shape)


def test_tree_width_limit_and_argument_checks():
    q = torch.zeros(1, 32, 4, 64)
    pool = torch.zeros(8, 2, 16, 64)
    z = torch.zeros(1, 32, dtype=torch.int32)
    one = torch.ones(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="31"):
        ops.ragged_paged_attention(q, pool, pool, z, one, one, tree_mask=z, depths=z)
    with pytest.raises(ValueError, match="together"):
        ops.ragged_paged_attention(q[:, :2], pool, pool, z[:, :2], one, one,
                                   tree_mask=z[:, :2])
    with pytest.raises(ValueError, match="window"):
        ops.ragged_paged_attention(q[:, :2], pool, pool, z[:, :2], one, one, window=0)
