"""K9's tensor-core design on the CPU: the shape check, the split plan and
the merge of split partials, against the unsplit plain version and the
JAX package.

The bf16 K9 kernel (``csrc/paged_prefill.cu``) splits a row's history
into blocks of ``SPLIT_PAGES`` pages across the grid; a row with more
than one split leaves float32 partials (O unnormalized, m, l) that the
merge kernel combines. What is mirrored in Python and tested here:
``check_prefill_fit``'s carve-up, ``q_tile``, ``active_splits``,
``walk_plan`` (which key blocks a block walks) and the merge's plain
version. What lives only inside the kernel: the per-key masks inside a
key block (keys at or past the row's history, behind a query's window,
after a query in the chunk), the online softmax that produces each
split's partial, the int8-to-bf16 conversion of staged pages and the
fused write of the chunk tokens; chip_smoke.py holds those against
``paged_flash_prefill_plain`` on the card.

The partials here are ``paged_flash_prefill_plain``'s math restricted to
each split's keys (float32); merged, they must equal the unsplit plain
version within 1e-6 (float32 sums of a few hundred terms in another
order), and the JAX package's kernel (interpret mode) within 1e-5, as
tests/test_torch_paged_ops.py holds the plain version.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import assume, given, settings
from hypothesis import strategies as st

from orion_tpu.ops.pallas.paged_flash_prefill import (
    paged_flash_prefill as j_paged_prefill,
)
from orion_tpu_torch import ops
from orion_tpu_torch.ops.common import NEG_INF
from orion_tpu_torch.ops.paged_attention import dequantize_pages
from orion_tpu_torch.ops.paged_flash_prefill import (
    SMEM_BUDGET_BYTES,
    SPLIT_PAGES,
    TC_ROWS,
    active_splits,
    KEY_BLOCK,
    n_splits,
    prefill_tc_smem_bytes,
    q_tile,
    walk_plan,
)
from tests import torch_threads  # noqa: F401  (one intra-op thread)

PSZ, K, G, H = 16, 2, 2, 64
N = K * G
SW = 128
SPLIT = 4          # pages per split in the merge tests: 64 keys, one key block


@pytest.mark.parametrize("n_heads,n_kv_heads,head_dim,page_size,ok", [
    (32, 8, 128, 64, True), (32, 8, 256, 64, True), (32, 8, 64, 128, True),
    (32, 8, 128, 16, True), (32, 8, 128, 128, True), (32, 8, 256, 128, True),
    (32, 8, 16, 32, True), (8, 8, 128, 64, True), (64, 8, 128, 64, True),
    (128, 1, 128, 64, True), (256, 1, 128, 64, False),
    (32, 8, 128, 48, False), (32, 8, 128, 8, False), (32, 8, 96, 64, False),
    (32, 8, 128, 256, False), (32, 6, 128, 64, False),
])
def test_check_prefill_fit_bf16(n_heads, n_kv_heads, head_dim, page_size, ok):
    """The tensor-core kernel's carve-up does not depend on the page size:
    page 128 now fits at every head_dim; G above TC_ROWS query heads, a
    head_dim outside FLASH_HEAD_DIMS and a page size that is not a power
    of two in [16, 128] are refused."""
    kw = dict(n_heads=n_heads, n_kv_heads=n_kv_heads, head_dim=head_dim,
              page_size=page_size, dtype=torch.bfloat16)
    if ok:
        ops.check_prefill_fit(**kw)
    else:
        with pytest.raises(ValueError, match="page_size|head_dim|query heads|multiple"):
            ops.check_prefill_fit(**kw)


@pytest.mark.parametrize("dtype,ok", [(torch.float32, False), (None, False),
                                      (torch.bfloat16, True)])
def test_check_prefill_fit_by_dtype(dtype, ok):
    """Page 128 at head_dim 128 fits the bf16 kernel but not the float32
    one; None checks both."""
    kw = dict(n_heads=32, n_kv_heads=8, head_dim=128, page_size=128, dtype=dtype)
    if ok:
        ops.check_prefill_fit(**kw)
    else:
        with pytest.raises(ValueError, match="page_size"):
            ops.check_prefill_fit(**kw)


@pytest.mark.parametrize("head_dim", [16, 32, 64, 128, 256])
def test_tc_smem_within_budget(head_dim):
    """Both pool branches fit one block; at head_dim <= 128, where the
    kernel is built for two blocks per SM, two fit an SM's 228 KB (1 KB
    reserved per block)."""
    for quant in (False, True):
        need = prefill_tc_smem_bytes(head_dim, quant)
        assert need <= SMEM_BUDGET_BYTES
        if head_dim <= 128:
            assert 2 * (need + 1024) <= 228 * 1024


@pytest.mark.parametrize("group,tq", [(1, 128), (2, 64), (3, 32), (4, 32), (7, 16),
                                      (8, 16), (128, 1)])
def test_q_tile(group, tq):
    assert q_tile(group) == tq
    assert tq * group <= TC_ROWS < 2 * tq * group


def test_active_splits_at_the_smoke_shapes():
    """The chunked serve's rows of the kernels phase (starts 0/1024/4096/
    7936, page 64, the walk padded to 128 prefix pages): one, one, four
    and eight splits of SPLIT_PAGES pages."""
    assert n_splits(128) == 8
    got = [active_splits(s, page_size=64, n_prefix_pages=128) for s in (0, 1024, 4096, 7936)]
    assert got == [1, 1, 4, 8]


@settings(max_examples=200, deadline=None)
@given(
    psz=st.sampled_from([16, 32, 64, 128]),
    group=st.sampled_from([1, 2, 4, 8]),
    split_pages=st.sampled_from([1, 2, 4, 8, 16]),
    n_pre=st.integers(0, 40),
    n_chunk=st.integers(1, 4),
    data=st.data(),
)
def test_walk_plan_covers_each_attended_key_once(psz, group, split_pages, n_pre, n_chunk,
                                                 data):
    """Over every q tile and split of a row: each history key a real query
    attends is walked by exactly one split and no key at or past the
    row's history is read (so never a chunk page); each chunk key a real
    query attends is walked by split 0 only; splits past the row's active
    ones, and q tiles with no real query, walk nothing."""
    kb = KEY_BLOCK
    assume(split_pages * psz % kb == 0)   # the kernel refuses other splits
    P_pre = data.draw(st.integers(n_pre, n_pre + 8))   # the walk's padded width
    start = n_pre * psz
    S = n_chunk * psz
    qlen = data.draw(st.integers(1, S))
    window = data.draw(st.one_of(st.none(), st.integers(1, start + S + 5)))
    tq = q_tile(group)
    n_hkeys = min(P_pre, start // psz) * psz
    n_sp = n_splits(P_pre, split_pages)
    n_act = active_splits(start, page_size=psz, n_prefix_pages=P_pre,
                          split_pages=split_pages)
    assert n_act <= n_sp
    kw = dict(tq=tq, page_size=psz, n_prefix_pages=P_pre, window=window,
              split_pages=split_pages)
    for q0 in range(0, S, tq):
        hist_seen = np.zeros(n_hkeys, np.int64)
        chunk_seen = np.zeros(S, np.int64)
        for split in range(n_sp):
            (h0, h1), (c0, c1) = walk_plan(start, qlen, q0, split, **kw)
            if split >= n_act or q0 >= qlen:
                assert h1 <= h0 and c1 <= c0
                continue
            keys = np.arange(h0 * kb, max(h1, h0) * kb)
            read = keys[keys < n_hkeys]          # the rest is masked, not read
            assert (read // psz < min(P_pre, start // psz)).all()
            hist_seen[read] += 1
            if split > 0:
                assert c1 <= c0
            ck = np.arange(c0 * kb, max(c1, c0) * kb)
            chunk_seen[ck[ck < S]] += 1
        for q in range(q0, min(q0 + tq, qlen)):
            pos = start + q
            lo = pos - window + 1 if window else 0
            att = np.arange(n_hkeys)
            att = att[att >= lo]
            assert (hist_seen[att] == 1).all(), (q, att[hist_seen[att] != 1])
            catt = np.arange(q + 1)
            catt = catt[catt >= (q - window + 1 if window else 0)]
            assert (chunk_seen[catt] == 1).all()
        assert (hist_seen <= 1).all() and (chunk_seen <= 1).all()


def _t(a):
    return torch.from_numpy(np.array(a))


def _case(rng, quant):
    """Four rows on a 48-page pool, P_pre 12 (three splits of SPLIT pages):
    a row over all 12 history pages, a row with one page, a first chunk
    (no history) and a pad row (all-zero walk)."""
    NP, P_pre, S = 48, 12, 2 * PSZ
    NC, B = S // PSZ, 4
    if quant:
        kp, vp = (rng.integers(-127, 128, (NP, K, PSZ, H)).astype(np.int8) for _ in range(2))
        # Scales in (0.004, 0.012): dequantized values within +-1.5, as the
        # float32 case's, so both hold to the same 1e-6.
        ks, vs = (rng.random((NP, K, SW)).astype(np.float32) * 0.008 + 0.004
                  for _ in range(2))
    else:
        kp, vp = (rng.standard_normal((NP, K, PSZ, H)).astype(np.float32) for _ in range(2))
        ks = vs = None
    q = rng.standard_normal((B, S, N, H)).astype(np.float32)
    kn, vn = (rng.standard_normal((B, S, K, H)).astype(np.float32) for _ in range(2))
    walk = np.zeros((B, P_pre + NC), np.int32)
    ids = rng.permutation(NP - 1)[: 3 * (P_pre + NC)] + 1
    walk[:3] = ids.reshape(3, P_pre + NC)
    walk[1, 1:P_pre] = 0
    walk[2, :P_pre] = 0
    start = np.array([P_pre * PSZ, PSZ, 0, 0], np.int32)
    lens = np.array([S, 7, S - 3, 1], np.int32)
    return q, kp, vp, ks, vs, kn, vn, walk, start, lens, P_pre


def _split_partials(q, kp, vp, ks, vs, kn, vn, walk, start, lens, P_pre, window, softcap):
    """Each split's partial (O unnormalized, m, l), float32, as the kernel
    leaves it: the plain version's logits and mask over the split's
    history pages (and, for split 0, the chunk); NEG_INF / 0 / 0 where a
    row attends nothing in the split. Returns o_part, ml_part and the
    outputs of rows with one active split (the kernel writes those)."""
    B, S = q.shape[:2]
    n_sp = n_splits(P_pre, SPLIT)
    o_part = torch.zeros(n_sp, B, S, N, H)
    ml_part = torch.zeros(n_sp, B, S, N, 2)
    ml_part[..., 0] = NEG_INF
    direct = torch.zeros(B, S, N, H)
    walk = walk.long()
    for b in range(B):
        st_b, qlen = int(start[b]), int(lens[b])
        n_hist = min(P_pre, st_b // PSZ)
        n_act = active_splits(st_b, page_size=PSZ, n_prefix_pages=P_pre, split_pages=SPLIT)
        for s in range(n_act):
            pages = range(s * SPLIT, min((s + 1) * SPLIT, n_hist))
            kk, vv, pos = [], [], []
            for ip in pages:
                row = walk[b, ip]
                kpg, vpg = kp[row], vp[row]                      # [K, psz, H]
                if ks is not None:
                    kpg = dequantize_pages(kpg, ks[row], torch.float32)
                    vpg = dequantize_pages(vpg, vs[row], torch.float32)
                kk.append(kpg.transpose(0, 1))
                vv.append(vpg.transpose(0, 1))
                pos.append(torch.arange(ip * PSZ, (ip + 1) * PSZ))
            n_h = sum(len(p) for p in pos)
            if s == 0:
                kk.append(kn[b])
                vv.append(vn[b])
                pos.append(st_b + torch.arange(S))
            if not kk:
                continue
            kc, vc, kpos = torch.cat(kk), torch.cat(vv), torch.cat(pos)   # [T, K, H]
            qpos = st_b + torch.arange(S)
            dist = qpos[:, None] - kpos[None]
            is_chunk = torch.arange(len(kpos)) >= n_h
            # Real queries attend real keys: history below start, chunk keys < lens.
            mask = (dist >= 0) & (~is_chunk | (kpos - st_b < qlen))[None]
            mask = mask & (torch.arange(S) < qlen)[:, None]
            if window is not None:
                mask = mask & (dist < window)
            kx = kc.repeat_interleave(G, dim=1)
            vx = vc.repeat_interleave(G, dim=1)
            z = torch.einsum("qnh,tnh->nqt", q[b], kx) * H ** -0.5
            if softcap is not None:
                z = softcap * torch.tanh(z / softcap)
            z = torch.where(mask[None], z, torch.full_like(z, -torch.inf))
            m = z.amax(dim=-1)                                           # [N, S]
            live = m > -torch.inf
            p = torch.where(live[..., None], torch.exp(z - torch.where(live, m, 0)[..., None]),
                            torch.zeros_like(z))
            o = torch.einsum("nqt,tnh->qnh", p, vx)
            l = p.sum(-1).T
            m = torch.where(live, m, torch.full_like(m, NEG_INF)).T      # [S, N]
            if n_act == 1:
                direct[b] = o / torch.where(l > 0, l, 1.0)[..., None]
            else:
                o_part[s, b], ml_part[s, b, ..., 0], ml_part[s, b, ..., 1] = o, m, l
    return o_part, ml_part, direct


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("window,softcap", [(None, None), (40, None), (100, 20.0),
                                            (None, 20.0), (7, None)])
def test_merge_of_split_partials_matches_unsplit(quant, window, softcap):
    """Row 0's history spans three splits (merged); rows 1-3 have one
    split (no history, one page, a pad row: written directly). Window 40
    clamps inside row 0's last split, 100 spans two, 7 lies inside the
    chunk."""
    rng = np.random.default_rng(11)
    q, kp, vp, ks, vs, kn, vn, walk, start, lens, P_pre = _case(rng, quant)
    args = [_t(a) for a in (q, kp, vp, walk, start, lens, kn, vn)]
    scales = dict(k_scale=_t(ks), v_scale=_t(vs)) if quant else {}
    o_part, ml_part, out = _split_partials(
        args[0], args[1], args[2], scales.get("k_scale"), scales.get("v_scale"), args[6],
        args[7], args[3], args[4], args[5], P_pre, window, softcap)
    assert [active_splits(int(s), page_size=PSZ, n_prefix_pages=P_pre, split_pages=SPLIT)
            for s in start] == [3, 1, 1, 1]
    merged = ops.paged_prefill_merge(o_part, ml_part, args[4].to(torch.int32), out,
                                     n_prefix_pages=P_pre, page_size=PSZ,
                                     split_pages=SPLIT)
    assert merged is out
    want = ops.paged_flash_prefill_plain(
        *[a.clone() for a in args[:3]], *args[3:], n_prefix_pages=P_pre,
        window=window, logit_softcap=softcap,
        **{k: v.clone() for k, v in scales.items()})[0]
    real = torch.arange(q.shape[1])[None] < args[5][:, None]
    torch.testing.assert_close(merged[real], want[real], atol=1e-6, rtol=0)
    jscale = {k: jnp.asarray(v.numpy()) for k, v in scales.items()}
    jwant = j_paged_prefill(
        *(jnp.asarray(a) for a in (q, kp, vp, walk, start, lens, kn, vn)),
        n_prefix_pages=P_pre, layer_base=0, window=window, logit_softcap=softcap,
        interpret=True, **jscale)[0]
    np.testing.assert_allclose(merged.numpy()[real.numpy()], np.asarray(jwant)[real.numpy()],
                               atol=1e-5, rtol=0)


def test_merge_plain_leaves_single_split_rows_and_zeros_empty_rows():
    """Rows with one active split are the kernel's to write and stay as
    they are; a merged row whose splits attend nothing (l = 0 everywhere)
    comes out as zeros, not NaN; splits past a row's active ones are never
    read (garbage there changes nothing)."""
    B, S, n_sp = 3, 4, 3
    start = torch.tensor([2 * SPLIT * PSZ, 0, SPLIT * PSZ], dtype=torch.int32)
    gen = torch.Generator().manual_seed(0)
    o_part = torch.randn(n_sp, B, S, N, H, generator=gen)
    ml_part = torch.randn(n_sp, B, S, N, 2, generator=gen)
    ml_part[..., 1] = ml_part[..., 1].abs()
    ml_part[:, 0, 1, :, 0] = NEG_INF          # row 0, query 1: nothing attended
    ml_part[:, 0, 1, :, 1] = 0.0
    o_part[:, 0, 1] = 0.0
    o_part[2, 0] = float("nan")               # split 2 is not active for row 0
    out = torch.full((B, S, N, H), 7.0)
    ops.paged_prefill_merge_plain(o_part, ml_part, start, out, n_prefix_pages=3 * SPLIT,
                                  page_size=PSZ, split_pages=SPLIT)
    assert torch.isfinite(out).all()
    assert (out[0, 1] == 0).all()
    assert (out[1] == 7.0).all() and (out[2] == 7.0).all()
    m, l = ml_part[:2, 0, 0, :, 0], ml_part[:2, 0, 0, :, 1]
    w = torch.exp(m - m.amax(0))
    want = (o_part[:2, 0, 0] * w[..., None]).sum(0) / (l * w).sum(0)[..., None]
    torch.testing.assert_close(out[0, 0], want, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("page_size", [16, 32, 64, 128])
def test_split_pages_hold_whole_key_blocks(page_size):
    """A split of SPLIT_PAGES pages holds whole key blocks at every page
    size, as the kernel requires (it refuses other splits)."""
    assert SPLIT_PAGES * page_size % KEY_BLOCK == 0
