"""K10's tensor-core design on the CPU: the split plan of the verify walk
and the merge of split partials, against the unsplit plain version and the
JAX package.

The bf16 K10 kernel (``csrc/ragged_verify.cu``) splits a slot's page walk
into blocks of ``VERIFY_SPLIT_PAGES`` pages across the grid; a slot whose
walk spans more than one split leaves float32 partials (O unnormalized, m,
l for every query row) that the merge kernel combines in split order. What
is mirrored in Python and tested here: ``verify_n_splits`` (the grid's
width, from the page table's width alone), ``verify_active_splits`` (which
splits hold work: the slot's walk from ``max(0, start - window + 1)`` to
its last written position, chain and tree alike), the merge's plain
version, the fit check by dtype, and, in this file, ``_split_keys`` (which
positions each split attends and whose drafts it writes, as the kernel's
``klo``/``khi``). What lives only inside the kernel: the per-(row, key)
mask of a 32-key step, the online softmax of each warp and their merge,
the int8 to bf16 conversion, the fused write of the drafts and the
shared-memory carve-up (held by static_asserts in the source);
chip_smoke.py holds those against ``ragged_paged_attention_plain`` on the
card.

The partials here are ``ragged_paged_attention_plain``'s math restricted to
each split's keys (float32, over the pools as the plain version leaves them
after its write); merged, they must equal the unsplit plain version within
1e-6 (float32 sums of a few hundred terms in another order), and the JAX
package's kernel (interpret mode, as tests/test_torch_ragged_ops.py runs
it) within 1e-5.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from orion_tpu.ops.pallas.ragged_paged_attention import (
    ragged_paged_attention as j_ragged,
)
from orion_tpu_torch import ops
from orion_tpu_torch.infer.spec_decode import DraftTree
from orion_tpu_torch.ops.attention import FLASH_HEAD_DIMS
from orion_tpu_torch.ops.common import NEG_INF
from orion_tpu_torch.ops.ragged_paged_attention import (
    SMEM_BUDGET_BYTES,
    VERIFY_SPLIT_PAGES,
    verify_active_splits,
    verify_mask,
    verify_n_splits,
)
from tests import torch_threads  # noqa: F401  (one intra-op thread)

K, G, H = 2, 2, 64
N = K * G
W = 5
SW = 128          # scale lanes of a page (the JAX package's one lane tile)
SPLIT = 2         # pages per split in the merge tests
P = 8             # the page table's width: four splits
NP = 40           # pages per layer; the tests run layer 1 of two
TREE = [0, 1, 0, 3]   # columns 1<-0, 2<-1, 3<-0, 4<-3: query 4 at depth 2


def _split_keys(start, lens, split, *, page_size, n_pages, window=None,
                split_pages=VERIFY_SPLIT_PAGES):
    """The positions [lo, hi) split ``split`` of a slot walks (lo == hi:
    none), as the kernel's ``klo``/``khi``; it also writes the drafts at
    positions [max(lo, start), hi)."""
    keys = split_pages * page_size
    if split not in verify_active_splits(start, lens, page_size=page_size, n_pages=n_pages,
                                         window=window, split_pages=split_pages):
        return 0, 0
    last = min(start + lens - 1, n_pages * page_size - 1)
    first = max(0, start - window + 1) if window else 0
    return max(split * keys, first), min((split + 1) * keys, last + 1)


def _tree_arrays(B, parents, width=W):
    """[B, width] depths and ancestor words of one tree for every row,
    columns past the tree chain-shaped (as the engine pads them)."""
    t = DraftTree(tokens=[0] * len(parents), parents=list(parents))
    n = len(parents) + 1
    depths = list(t.depths()) + list(range(n, width))
    words = list(t.mask_words()) + [(1 << (j + 1)) - 1 for j in range(n, width)]
    return np.array([depths] * B, np.int32), np.array([words] * B, np.int32)


@pytest.mark.parametrize("n_pages,split_pages,want", [
    (128, 8, 16), (128, 4, 32), (128, 16, 8), (1, 8, 1), (9, 8, 2), (8, 8, 1), (0, 8, 1),
])
def test_verify_n_splits(n_pages, split_pages, want):
    assert verify_n_splits(n_pages, split_pages) == want
    assert want * split_pages >= n_pages   # the grid covers every page of the table


def test_split_pages_mirror_the_kernel_source():
    """VERIFY_SPLIT_PAGES is the kernel's compile-time SPLIT_PAGES (the
    launcher refuses a grid of another width, but only on the card)."""
    src = (Path(__file__).resolve().parents[1] / "orion_tpu_torch" / "csrc"
           / "ragged_verify.cu").read_text()
    assert re.findall(r"constexpr int SPLIT_PAGES = (\d+);", src) == [str(VERIFY_SPLIT_PAGES)]


def test_active_splits_at_the_smoke_shapes():
    """The kernels phase's K10 slots (page 64, 128-page table): a pad row
    has one split (0); the slot at the context edge (start 8189, two of its
    five tokens past the table) spans every split; a 1000-token window
    leaves the leading ones idle; drafts straddling a split boundary
    activate both splits."""
    kw = dict(page_size=64, n_pages=128)
    n = verify_n_splits(128)
    sk = 64 * VERIFY_SPLIT_PAGES
    assert n == -(-128 // VERIFY_SPLIT_PAGES)
    assert list(verify_active_splits(0, 1, **kw)) == [0]
    assert list(verify_active_splits(8189, 5, **kw)) == list(range(n))
    sp = verify_active_splits(8189, 5, window=1000, **kw)
    assert sp.stop == n and sp.start == (8189 - 999) // sk
    assert list(verify_active_splits(sk - 2, 5, window=1, **kw)) == [0, 1]


def test_tree_window_row_opens_a_split_before_the_chain():
    """The smoke's "straddle" row at start 272, page 16 (a split is 128
    keys), tree TREE under a window of 20: query 4 (depth 2) sees context
    from 272 + 2 - 19 = 255, in split 1, where a chain query 4 would start
    at 257, in split 2. The slot's plan holds split 1 and its keys, and
    the merge's range is the slot's, so that key is attended once."""
    start, lens, psz, window = 272, 5, 16, 20
    depths, words = _tree_arrays(1, TREE)
    mask = verify_mask(torch.tensor([start]), W, P * 4 * psz, window=window,
                       tree_mask=torch.from_numpy(words), depths=torch.from_numpy(depths))[0]
    chain = verify_mask(torch.tensor([start]), W, P * 4 * psz, window=window)[0]
    assert mask[4, 255] and not chain[4, 255] and not chain[4, 256]
    kw = dict(page_size=psz, n_pages=4 * P, window=window)
    assert list(verify_active_splits(start, lens, **kw)) == [1, 2]
    assert _split_keys(start, lens, 1, **kw) == (253, 256)


@settings(max_examples=150, deadline=None)
@given(
    psz=st.sampled_from([16, 32, 64]),
    split_pages=st.sampled_from([1, 2, 4, 8]),
    n_pages=st.integers(1, 24),
    width=st.integers(1, 8),
    data=st.data(),
)
def test_split_plan_covers_each_attended_key_once(psz, split_pages, n_pages, width, data):
    """Over every split of the grid, chain or tree, with or without a
    window: the splits' key ranges are disjoint and their union is the
    slot's walk; every position a real query attends lies in exactly one
    active split; every active split walks at least one position and the
    others none; each real draft is written by exactly one split, the one
    that walks its page, and no other split walks a key of that page."""
    cap = n_pages * psz
    start = data.draw(st.integers(0, cap - 1))
    lens = data.draw(st.integers(1, width))
    window = data.draw(st.one_of(st.none(), st.integers(1, cap + 5)))
    tree = data.draw(st.booleans())
    kw = dict(page_size=psz, n_pages=n_pages, window=window, split_pages=split_pages)
    n_sp = verify_n_splits(n_pages, split_pages)
    active = verify_active_splits(start, lens, **kw)
    assert 0 <= active.start <= active.stop - 1 < n_sp
    tkw = {}
    if tree:
        parents = [data.draw(st.integers(0, i)) for i in range(width - 1)]
        depths, words = _tree_arrays(1, parents, width)
        tkw = dict(tree_mask=torch.from_numpy(words), depths=torch.from_numpy(depths))
    mask = verify_mask(torch.tensor([start]), width, cap, window=window, **tkw)[0].numpy()
    seen = np.zeros(cap, np.int64)
    writers = np.zeros(cap, np.int64)
    pages_of = {}
    for split in range(n_sp):
        lo, hi = _split_keys(start, lens, split, **kw)
        if split not in active:
            assert lo == hi
            continue
        assert lo < hi
        seen[lo:hi] += 1
        writers[max(lo, start):hi] += 1
        pages_of[split] = set(range(lo // psz, (hi - 1) // psz + 1))
    last = min(start + lens - 1, cap - 1)
    first = max(0, start - window + 1) if window else 0
    want = np.zeros_like(seen)
    want[first:last + 1] = 1
    assert np.array_equal(seen, want)
    attended = mask[:lens].any(axis=0)
    assert (seen[attended] == 1).all()
    drafts = np.zeros_like(writers)
    drafts[start:last + 1] = 1
    assert np.array_equal(writers, drafts)
    for pos in range(start, last + 1):
        owners = [s for s, pages in pages_of.items() if pos // psz in pages]
        assert len(owners) == 1


def _t(a):
    return torch.from_numpy(np.array(a))


def _rows(psz):
    """A pad row, a row inside split 0, drafts straddling the split
    boundary at 2 pages (start sk - 2: two tokens before it, three after),
    a row mid-page in the third split, and a row at the table's end (two
    of its five tokens past it)."""
    sk = SPLIT * psz
    start = np.array([0, 3, sk - 2, 2 * sk + psz // 2 + 3, P * psz - 3], np.int32)
    lens = np.array([1, 4, 5, 3, 5], np.int32)
    return start, lens


def _case(rng, quant, psz):
    """Five rows (``_rows``) over layer 1 of a two-layer pool, live rows on
    distinct pages through their last written position; the pad row's
    table is all zero."""
    rows = 2 * NP
    if quant:
        kp, vp = (rng.integers(-127, 128, (rows, K, psz, H)).astype(np.int8) for _ in range(2))
        # Scales in (0.004, 0.012): dequantized values within +-1.5, as the
        # float32 case's, so both hold to the same 1e-6.
        ks, vs = (rng.random((rows, K, SW)).astype(np.float32) * 0.008 + 0.004
                  for _ in range(2))
    else:
        kp, vp = (rng.standard_normal((rows, K, psz, H)).astype(np.float32) for _ in range(2))
        ks = vs = None
    start, lens = _rows(psz)
    B = len(start)
    q = rng.standard_normal((B, W, N, H)).astype(np.float32)
    kn, vn = (rng.standard_normal((B, W, K, H)).astype(np.float32) for _ in range(2))
    table = np.zeros((B, P), np.int32)
    ids = rng.permutation(NP - 1) + 1
    used = 0
    for b in range(1, B):
        n = min(start[b] + lens[b] - 1, P * psz - 1) // psz + 1
        table[b, :n] = ids[used:used + n]
        used += n
    return q, kp, vp, ks, vs, kn, vn, table, start, lens


def _split_partials(q, kp, vp, ks, vs, table, start, lens, psz, window, softcap, tkw):
    """Each active split's partial (O unnormalized, m, l for every query
    row), float32, as the kernel leaves it: the plain version's masked
    logits over the split's keys of the pools (after the drafts' write); a
    row that sees none of the split's keys holds m = NEG_INF, l = 0, O =
    0. Splits a slot does not use hold NaN (the merge must never read
    them). Returns o_part, ml_part and the outputs of slots with one
    active split (the kernel writes those; the others zero)."""
    B = q.shape[0]
    cap = P * psz
    n_sp = verify_n_splits(P, SPLIT)
    o_part = torch.full((n_sp, B, W, N, H), float("nan"))
    ml_part = torch.full((n_sp, B, W, N, 2), float("nan"))
    direct = torch.zeros(B, W, N, H)
    kw = dict(page_size=psz, n_pages=P, window=window, split_pages=SPLIT)
    mask = verify_mask(start, W, cap, window=window, **tkw)                  # [B, W, T]
    for b in range(B):
        st_, n_ = int(start[b]), int(lens[b])
        active = verify_active_splits(st_, n_, **kw)
        pos = torch.arange(cap)
        rows = NP + table[b, pos // psz].long()
        kk, vv = kp[rows, :, pos % psz], vp[rows, :, pos % psz]             # [T, K, H]
        if ks is not None:
            kk = kk.float() * ks[rows, :, pos % psz][..., None]
            vv = vv.float() * vs[rows, :, pos % psz][..., None]
        kx, vx = kk.repeat_interleave(G, dim=1), vv.repeat_interleave(G, dim=1)
        z = torch.einsum("wnh,tnh->wnt", q[b], kx) * H ** -0.5
        if softcap is not None:
            z = softcap * torch.tanh(z / softcap)
        for s in active:
            lo, hi = _split_keys(st_, n_, s, **kw)
            keep = mask[b].clone()
            keep[:, :lo] = False
            keep[:, hi:] = False
            zs = torch.where(keep[:, None, :], z, torch.tensor(-float("inf")))
            m = zs.amax(dim=-1).clamp(min=NEG_INF)                          # [W, N]
            p = torch.exp(zs - m[..., None])
            o = torch.einsum("wnt,tnh->wnh", p, vx)
            l = p.sum(-1)
            if len(active) == 1:
                direct[b] = o / torch.where(l > 0, l, 1.0)[..., None]
            else:
                o_part[s, b], ml_part[s, b, ..., 0], ml_part[s, b, ..., 1] = o, m, l
    return o_part, ml_part, direct


MERGE_CASES = [
    (False, 16, "chain"), (True, 16, "chain"), (False, 64, "chain_window_softcap"),
    (True, 64, "tree"), (False, 16, "tree_window"), (True, 16, "tree_window_softcap"),
    (False, 64, "tree_window"), (True, 64, "chain_window"),
]


@pytest.mark.parametrize("quant,psz,mode", MERGE_CASES, ids=[
    f"{'int8' if q else 'f32'}-page{p}-{m}" for q, p, m in MERGE_CASES])
def test_merge_of_split_partials_matches_unsplit(quant, psz, mode):
    """Rows over one to four splits (and a pad row; drafts straddling a
    split boundary; drafts past the table), merged from their split
    partials, against the unsplit plain version and the JAX kernel. The
    window (a split and 7 keys) puts its lower edge inside a split; under
    the tree, query 4 (depth 2) opens its context two keys before a
    chain query 4 would."""
    sk = SPLIT * psz
    window = sk + 7 if "window" in mode else None
    softcap = 20.0 if "softcap" in mode else None
    rng = np.random.default_rng(11)
    q, kp, vp, ks, vs, kn, vn, table, start, lens = _case(rng, quant, psz)
    tkw = {}
    if mode.startswith("tree"):
        depths, words = _tree_arrays(len(start), TREE)
        tkw = dict(tree_mask=_t(words), depths=_t(depths))
    scales = dict(k_scale=_t(ks), v_scale=_t(vs)) if quant else {}
    kw = dict(layer_base=NP, k_new=_t(kn), v_new=_t(vn), window=window, logit_softcap=softcap)
    res = ops.ragged_paged_attention_plain(_t(q), _t(kp), _t(vp), _t(table), _t(start),
                                           _t(lens), **scales, **kw, **tkw)
    want, pools = res[0], res[1:]
    n_active = [len(verify_active_splits(int(s), int(n), page_size=psz, n_pages=P,
                                         window=window, split_pages=SPLIT))
                for s, n in zip(start, lens)]
    assert n_active[0] == 1 and n_active[2] >= 2 and (window or max(n_active) == 4)
    o_part, ml_part, direct = _split_partials(
        _t(q), *pools[:2], *(pools[2:] if quant else (None, None)), _t(table),
        _t(start), _t(lens), psz, window, softcap, tkw)
    merged = ops.ragged_verify_merge_plain(o_part, ml_part, _t(start), _t(lens), direct,
                                           page_size=psz, n_pages=P, window=window,
                                           split_pages=SPLIT)
    assert merged is direct
    real = (np.arange(W)[None] < lens[:, None])
    real[0] = False    # the pad row
    torch.testing.assert_close(merged[real], want[real], atol=1e-6, rtol=0)
    jx = {k: jnp.asarray(v.numpy()) for k, v in tkw.items()}
    if quant:
        jx.update(k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
    jwant = j_ragged(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(table),
                     jnp.asarray(start), jnp.asarray(lens), interpret=True, layer_base=NP,
                     k_new=jnp.asarray(kn), v_new=jnp.asarray(vn), window=window,
                     logit_softcap=softcap, **jx)[0]
    np.testing.assert_allclose(merged.numpy()[real], np.asarray(jwant)[real], atol=1e-5, rtol=0)


def test_merge_plain_leaves_single_split_slots_and_zeros_empty_rows():
    """Slots with one active split are the kernel's to write and stay as
    they are; a merged row whose splits attend nothing (l = 0 everywhere)
    comes out as zeros, not NaN; an empty partial (m = NEG_INF, l = 0, O =
    0) beside real ones changes nothing; splits outside a slot's active
    range are never read (NaN there changes nothing)."""
    psz = 16
    sk = SPLIT * psz
    n_sp, B = 4, 3
    # Under a window of two splits less one key: slot 0 spans splits 1-3
    # (split 0 behind its window), slot 1 one split, slot 2 splits 2-3.
    start = torch.tensor([3 * sk + 1, 2, 4 * sk - 2], dtype=torch.int32)
    lens = torch.tensor([3, 2, 2], dtype=torch.int32)
    kw = dict(page_size=psz, n_pages=P, window=2 * sk - 1, split_pages=SPLIT)
    assert [list(verify_active_splits(int(s), int(n), **kw)) for s, n in zip(start, lens)] == [
        [1, 2, 3], [0], [2, 3]]
    gen = torch.Generator().manual_seed(0)
    o_part = torch.randn(n_sp, B, W, N, H, generator=gen)
    ml_part = torch.randn(n_sp, B, W, N, 2, generator=gen)
    ml_part[..., 1] = ml_part[..., 1].abs()
    ml_part[:, 2, 1, 1, 0] = NEG_INF          # slot 2, query 1, head 1: nothing attended
    ml_part[:, 2, 1, 1, 1] = 0.0
    o_part[:, 2, 1, 1] = 0.0
    for s, b in ((0, 0), (0, 2), (1, 2)):      # outside the slots' active splits
        o_part[s, b] = ml_part[s, b] = float("nan")
    want0 = _merge_ref(o_part[1:4, 0], ml_part[1:4, 0])
    ml_part[2, 0, 3, :, 0], ml_part[2, 0, 3, :, 1] = NEG_INF, 0.0   # slot 0, query 3:
    o_part[2, 0, 3] = 0.0                                            # split 2 empty
    want03 = _merge_ref(o_part[[1, 3], 0, 3], ml_part[[1, 3], 0, 3])
    out = torch.full((B, W, N, H), 7.0)
    ops.ragged_verify_merge_plain(o_part, ml_part, start, lens, out, **kw)
    assert torch.isfinite(out).all()
    assert (out[2, 1, 1] == 0).all()
    assert (out[1] == 7.0).all()
    torch.testing.assert_close(out[0, :3], want0[:3], atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(out[0, 3], want03, atol=1e-6, rtol=1e-6)


def _merge_ref(o, ml):
    m, l = ml[..., 0], ml[..., 1]
    w = torch.exp(m - m.amax(0))
    return (o * w[..., None]).sum(0) / (l * w).sum(0)[..., None]


def _merge_args():
    B, n_sp = 2, 3
    return dict(o_part=torch.zeros(n_sp, B, W, N, H), ml_part=torch.zeros(n_sp, B, W, N, 2),
                start=torch.zeros(B, dtype=torch.int32), lens=torch.ones(B, dtype=torch.int32),
                out=torch.zeros(B, W, N, H, dtype=torch.bfloat16))


@pytest.mark.parametrize("bad", ["ml_shape", "out_shape", "out_dtype", "start_dtype",
                                 "lens_shape", "strided"])
def test_merge_launcher_refuses_misshapen_arguments(bad):
    """The merge's launcher checks shapes, dtypes and layout before it
    builds or launches anything (so on any device)."""
    a = _merge_args()
    if bad == "ml_shape":
        a["ml_part"] = torch.zeros(3, 2, W, N, 3)
    elif bad == "out_shape":
        a["out"] = torch.zeros(2, W + 1, N, H, dtype=torch.bfloat16)
    elif bad == "out_dtype":
        a["out"] = a["out"].float()
    elif bad == "start_dtype":
        a["start"] = a["start"].long()
    elif bad == "lens_shape":
        a["lens"] = torch.ones(3, dtype=torch.int32)
    else:
        a["o_part"] = torch.zeros(3, 2, W, N, 2 * H)[..., ::2]
    with pytest.raises(ValueError, match="merge"):
        ops.ragged_verify_merge_cuda(a["o_part"], a["ml_part"], a["start"], a["lens"],
                                     a["out"], page_size=16, n_pages=P)


def _old_fit(W_, n_heads, n_kv_heads, head_dim, page_size):
    """The fit check's formula before the bf16 kernel (the float32
    kernel's shared memory, frozen here): True where it admits W_."""
    R = W_ * (n_heads // n_kv_heads)
    need = 4 * (2 * R * head_dim + page_size * (2 * head_dim + 1) + R * page_size + 3 * R
                + 2 * page_size + 2 * W_)
    return W_ >= 1 and need <= 232448


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, "bfloat16"])
def test_fit_check_keeps_every_width_it_admitted(dtype):
    """Every (W, heads, head_dim, page size) the old formula admitted stays
    admitted in both dtypes; float32 keeps exactly the old formula; bf16
    also admits wider W (its shared memory does not grow with W)."""
    for hd in FLASH_HEAD_DIMS:
        for n_heads, n_kv in ((32, 8), (8, 8), (64, 8), (16, 1)):
            for psz in (16, 64, 128):
                shape = dict(n_heads=n_heads, n_kv_heads=n_kv, head_dim=hd, page_size=psz)
                for w in range(1, 40):
                    old = _old_fit(w, **shape)
                    try:
                        ops.check_verify_fit(w, dtype=dtype, **shape)
                        ok = True
                    except ValueError:
                        ok = False
                    if old:
                        assert ok, (w, shape)
                    elif dtype == torch.float32:
                        assert not ok, (w, shape)
                    else:
                        assert ok, (w, shape)
    assert SMEM_BUDGET_BYTES == 232448
    ops.check_verify_fit(64, n_heads=32, n_kv_heads=8, head_dim=128, page_size=64,
                         dtype=dtype if dtype != torch.float32 else torch.bfloat16)
    with pytest.raises(ValueError, match="speculate_tokens"):
        ops.check_verify_fit(0, n_heads=32, n_kv_heads=8, head_dim=128, page_size=64,
                             dtype=dtype)
    with pytest.raises(ValueError, match="head_dim"):
        ops.check_verify_fit(5, n_heads=32, n_kv_heads=8, head_dim=96, page_size=64,
                             dtype=dtype)
