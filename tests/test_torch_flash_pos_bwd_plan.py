"""The plan of K7-pos and K8-pos at head_dim 64 and 128 (``ops/flash_pos_bwd.py``):
the classes of every (q tile, kv tile) pair, the blocks' walks and their
longest-first order, and the plain tiled backward that walks them, on the
CPU.

Each layout is a batch row: fine stripes (a permutation in 4 stripes),
the striped ring's coarse stripes (c = S / sp) for a past block and the
diagonal one, a block wholly in the causal future, two random
permutations; under a window the windowed ring's past block, whose query
rows from window - 1 on attend nothing; ragged lengths with segment ids
and a softcap, causal and not. The tiled backward (float32) is held
against the VJP of the JAX package's ``flash_attention_with_lse`` in
interpret mode (its ``_dq_kernel`` / ``_dkv_kernel`` has_pos branches),
with cotangents for both outputs, to 2e-6 absolute + 1e-4 relative. The
classes are held against ``ops.attention_mask``: a DEAD tile admits no
pair, a FULL tile every pair, and every admitted pair lies in a tile some
block's walk visits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orion_tpu.ops.pallas.flash_attention import flash_attention_with_lse as j_flash_lse
from orion_tpu_torch import ops
from orion_tpu_torch.ops import flash_pos_bwd as fpb
from orion_tpu_torch.parallel.sequence import striped_positions
from tests import torch_threads  # noqa: F401  (one intra-op thread)

S, N, K, H = 256, 4, 2, 16
SP, IDX = 4, 2          # the coarse stripes: rank IDX of a ring of SP, c = S / SP
WINDOW = 100


def _stripes(n, stripes):
    return np.arange(n).reshape(n // stripes, stripes).T.reshape(-1)


def _ring(src):
    return striped_positions(src, SP, S).numpy()


def _layouts(case, rng):
    """(qpos [B, Sq], kpos [B, Skv], qseg, kseg, kw) of a case."""
    iota = np.arange(S)
    fine = _stripes(S, 4)
    if case == "stripes":
        rows = [(fine, fine), (_ring(IDX), _ring(IDX - 1)), (_ring(IDX), _ring(IDX)),
                (iota, 2 * S + iota), (rng.permutation(S), rng.permutation(S))]
        kw = dict(causal=True, window=None, logit_softcap=None)
    elif case == "window":
        rows = [(fine, fine), (S + iota, iota), (rng.permutation(S), rng.permutation(S))]
        kw = dict(causal=True, window=WINDOW, logit_softcap=None)
    else:   # ragged lengths, segment ids, softcap; causal or not
        Sq, Skv = 200, 136
        rows = [(rng.integers(0, 300, Sq), rng.integers(0, 300, Skv)) for _ in range(2)]
        kw = dict(causal=case == "ragged_causal", window=None, logit_softcap=30.0)
    qpos = np.stack([r[0] for r in rows]).astype(np.int32)
    kpos = np.stack([r[1] for r in rows]).astype(np.int32)
    qseg = kseg = None
    if case.startswith("ragged"):
        # Segment ids in runs, so some tiles hold one id and some two.
        qseg = np.sort(rng.integers(1, 4, qpos.shape), axis=1).astype(np.int32)
        kseg = np.sort(rng.integers(1, 4, kpos.shape), axis=1).astype(np.int32)
    return qpos, kpos, qseg, kseg, kw


CASES = ["stripes", "window", "ragged_causal", "ragged_noncausal"]


def _inputs(case):
    rng = np.random.default_rng(CASES.index(case))
    qpos, kpos, qseg, kseg, kw = _layouts(case, rng)
    B, Sq, Skv = qpos.shape[0], qpos.shape[1], kpos.shape[1]
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return (f(B, Sq, N, H), f(B, Skv, K, H), f(B, Skv, K, H), f(B, Sq, N, H), f(B, N, Sq),
            qpos, kpos, qseg, kseg, kw)


def _t(x):
    return None if x is None else torch.from_numpy(x)


@pytest.mark.parametrize("case", CASES)
def test_tiled_backward_matches_jax_kernel(case):
    q, k, v, do, g_lse, qpos, kpos, qseg, kseg, kw = _inputs(case)
    seg = {} if qseg is None else dict(q_segment_ids=jnp.asarray(qseg),
                                       kv_segment_ids=jnp.asarray(kseg))

    def jfn(a, b, c):
        return j_flash_lse(a, b, c, q_positions=jnp.asarray(qpos),
                           kv_positions=jnp.asarray(kpos), interpret=True, **seg, **kw)

    (_, jl), vjp = jax.vjp(jfn, *(jnp.asarray(t) for t in (q, k, v)))
    jgrads = [np.asarray(g) for g in vjp((jnp.asarray(do), jnp.asarray(g_lse)))]

    tq, tk, tv, tdo = (torch.from_numpy(t) for t in (q, k, v, do))
    pkw = dict(q_positions=_t(qpos), kv_positions=_t(kpos), q_segment_ids=_t(qseg),
               kv_segment_ids=_t(kseg), **kw)
    out = ops.attention_plain(tq, tk, tv, **pkw)
    lse = ops.attention_lse_plain(tq, tk, **pkw)                  # NEG_INF where dead
    delta = (tdo * out).sum(-1).transpose(1, 2) - torch.from_numpy(g_lse)
    grads = fpb.flash_pos_bwd_tiled_plain(tq, tk, tv, tdo, lse, delta, **pkw)

    for name, a, b in zip(("dq", "dk", "dv"), grads, jgrads):
        assert torch.isfinite(a).all(), name
        np.testing.assert_allclose(a.numpy(), b, atol=2e-6, rtol=1e-4, err_msg=name)
    dead = np.isneginf(np.asarray(jl))                             # [B, N, Sq]
    assert not grads[0].numpy()[dead.transpose(0, 2, 1)].any()
    if case == "stripes":
        assert dead[3].all()                                       # the future block
    if case == "window":
        assert dead[1][:, WINDOW - 1:].all() and not dead[1][:, :WINDOW - 1].any()


@pytest.mark.parametrize("case", CASES)
def test_plan_covers_every_admitted_pair(case):
    _, _, _, _, _, qpos, kpos, qseg, kseg, kw = _inputs(case)
    Sq, Skv = qpos.shape[1], kpos.shape[1]
    kw = dict(causal=kw["causal"], window=kw["window"])
    classes = fpb.bwd_classes(_t(qpos), _t(kpos), _t(qseg), _t(kseg), **kw)
    mask = ops.attention_mask(Sq, Skv, q_positions=_t(qpos), kv_positions=_t(kpos),
                              q_segment_ids=_t(qseg), kv_segment_ids=_t(kseg), **kw)
    if mask is None:
        mask = torch.ones(qpos.shape[0], Sq, Skv, dtype=torch.bool)
    mask = mask.expand(qpos.shape[0], Sq, Skv)
    T = fpb.TILE
    n_qt, n_kt = fpb.n_tiles(Sq), fpb.n_tiles(Skv)
    assert classes.shape == (qpos.shape[0], n_qt, n_kt)
    seen = torch.zeros_like(classes, dtype=torch.bool)
    for b in range(qpos.shape[0]):
        for blk in range(fpb.n_tiles(Sq, fpb.BLOCK)):
            for s, *cls in fpb.dq_walk(classes, b, blk):
                for w, c in enumerate(cls):
                    if 2 * blk + w < n_qt:
                        assert c == classes[b, 2 * blk + w, s]
                        seen[b, 2 * blk + w, s] |= c != fpb.DEAD
        dkv_seen = torch.zeros_like(seen[b])
        for blk in range(fpb.n_tiles(Skv, fpb.BLOCK)):
            for t, *cls in fpb.dkv_walk(classes, b, blk):
                for w, c in enumerate(cls):
                    if 2 * blk + w < n_kt:
                        assert c == classes[b, t, 2 * blk + w]
                        dkv_seen[t, 2 * blk + w] |= c != fpb.DEAD
        # Both walks visit exactly the tiles that are not DEAD.
        assert torch.equal(seen[b], classes[b] != fpb.DEAD)
        assert torch.equal(dkv_seen, classes[b] != fpb.DEAD)
        for t in range(n_qt):
            for s in range(n_kt):
                m = mask[b, t * T:(t + 1) * T, s * T:(s + 1) * T]
                c = int(classes[b, t, s])
                if c == fpb.DEAD:
                    assert not m.any(), (b, t, s)
                elif c == fpb.FULL:
                    assert m.shape == (T, T) and m.all(), (b, t, s)
    if case == "stripes":
        # Coarse stripes (c = 64, one tile): over the past block SP (SP + 1)
        # / 2 of the SP^2 stripe pairs are live, every one FULL; on the
        # diagonal block the same pairs, the diagonal's MASKED.
        for row, n_full in ((1, SP * (SP + 1) // 2), (2, SP * (SP - 1) // 2)):
            live = classes[row] != fpb.DEAD
            assert int(live.sum()) == SP * (SP + 1) // 2
            assert int((classes[row] == fpb.FULL).sum()) == n_full
        assert not (classes[3] != fpb.DEAD).any()


@pytest.mark.parametrize("case", CASES)
def test_block_order_is_most_work_first(case):
    _, _, _, _, _, qpos, kpos, qseg, kseg, kw = _inputs(case)
    classes = fpb.bwd_classes(_t(qpos), _t(kpos), _t(qseg), _t(kseg),
                              causal=kw["causal"], window=kw["window"])
    for dim, walk in ((1, fpb.dq_walk), (2, fpb.dkv_walk)):
        order = fpb.block_order(classes, dim)
        for b in range(classes.shape[0]):
            o = order[b].tolist()
            assert sorted(o) == list(range(len(o)))
            # K7: steps of the walk; K8: live (q tile, kv tile) pairs of it.
            lens = [len(walk(classes, b, i)) if dim == 1 else
                    sum((c0 != fpb.DEAD) + (c1 != fpb.DEAD) for _, c0, c1 in walk(classes, b, i))
                    for i in o]
            assert lens == sorted(lens, reverse=True)
            for i in range(1, len(o)):
                if lens[i] == lens[i - 1]:
                    assert o[i] > o[i - 1]


def test_scratch_size_and_head_dims():
    assert fpb.plan_scratch_ints(2, 200, 136) == 2 * (4 * 4 + 4 * 3 + 2)
    assert fpb.plan_scratch_ints(1, 16384, 262144) == 4 * 256 + 4 * 4096 + 2048
    assert fpb.WG_HEAD_DIMS == (64, 128)


def test_kernel_constants_match_plan():
    """The CUDA kernels' tile, block and class constants are the plan's
    (``csrc/flash_bwd.cu`` namespace wg); only nvcc reads that file."""
    from pathlib import Path

    src = (Path(__file__).resolve().parents[1] / "orion_tpu_torch" / "csrc"
           / "flash_bwd.cu").read_text()
    wg = src[src.index("namespace wg {"):]
    assert f"constexpr int T = {fpb.TILE};" in wg
    assert "constexpr int ROWS = 2 * T;" in wg and fpb.BLOCK == 2 * fpb.TILE
    assert (f"constexpr int DEAD = {fpb.DEAD}, MASKED = {fpb.MASKED}, FULL = {fpb.FULL};"
            in wg)
    assert "if constexpr (HD == 64 || HD == 128)" in src
    assert fpb.WG_HEAD_DIMS == (64, 128)
