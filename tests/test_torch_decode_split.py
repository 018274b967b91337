"""K4's tensor-core design on the CPU: the split plan, the shared-memory
carve-up and the merge of split partials, against the unsplit plain
version and the JAX package.

The bf16 K4 kernel (``csrc/paged_decode.cu``) splits a slot's page walk
into blocks of ``DECODE_SPLIT_PAGES`` pages across the grid; a slot whose
walk spans more than one split leaves float32 partials (O unnormalized,
m, l per head) that the merge kernel combines in split order. What is
mirrored in Python and tested here: ``decode_n_splits`` (the grid's width,
from the page table's width alone), ``decode_active_splits`` (which splits
hold work, the window included), the merge's plain version, and, in this
file, ``_split_keys`` (which positions each split attends, as the kernel's
``klo``/``khi``). What lives only inside the kernel: the per-key mask of a
32-key step, the online softmax of each warp and their merge, the int8 to
bf16 conversion of staged pages, the fused write of the new token and the
shared-memory carve-up (held by static_asserts in the source);
chip_smoke.py holds those against ``paged_attention_plain`` on the card.

The partials here are ``paged_attention_plain``'s math restricted to each
split's keys (float32, over the pools as the plain version leaves them
after its write); merged, they must equal the unsplit plain version
within 1e-6 (float32 sums of a few hundred terms in another order), and
the JAX package's kernel (interpret mode, as
tests/test_torch_paged_ops.py runs it) within 1e-5.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from orion_tpu.ops.pallas.paged_attention import paged_attention as j_paged
from orion_tpu_torch import ops
from orion_tpu_torch.ops.common import NEG_INF
from orion_tpu_torch.ops.paged_attention import (
    DECODE_SPLIT_PAGES,
    decode_active_splits,
    decode_n_splits,
)
from tests import torch_threads  # noqa: F401  (one intra-op thread)

K, G, H = 2, 2, 64
N = K * G
SW = 128          # scale lanes of a page (the JAX package's one lane tile)
SPLIT = 2         # pages per split in the merge tests
P = 8             # the page table's width: four splits
NP = 40           # pages per layer; the tests run layer 1 of two


def _split_keys(last_pos, split, *, page_size, window=None, split_pages=DECODE_SPLIT_PAGES):
    """The positions [lo, hi) split ``split`` of a slot at ``last_pos``
    attends (lo == hi: none), as the kernel's ``klo``/``khi``."""
    keys = split_pages * page_size
    if split not in decode_active_splits(last_pos, page_size=page_size, window=window,
                                         split_pages=split_pages):
        return 0, 0
    lo = max(split * keys, max(0, last_pos - window + 1) if window else 0)
    return lo, min((split + 1) * keys, last_pos + 1)


@pytest.mark.parametrize("n_pages,split_pages,want", [
    (128, 8, 16), (128, 4, 32), (128, 16, 8), (1, 8, 1), (9, 8, 2), (8, 8, 1), (0, 8, 1),
])
def test_decode_n_splits(n_pages, split_pages, want):
    assert decode_n_splits(n_pages, split_pages) == want
    assert want * split_pages >= n_pages   # the grid covers every page of the table


def test_split_pages_mirror_the_kernel_source():
    """DECODE_SPLIT_PAGES is the kernel's compile-time SPLIT_PAGES (the
    launcher refuses a grid of another width, but only on the card)."""
    src = (Path(__file__).resolve().parents[1] / "orion_tpu_torch" / "csrc"
           / "paged_decode.cu").read_text()
    assert re.findall(r"constexpr int SPLIT_PAGES = (\d+);", src) == [str(DECODE_SPLIT_PAGES)]


def test_active_splits_at_the_smoke_shapes():
    """The kernels phase's K4 slots (page 64, 128-page table): an idle
    slot has one split (0); the longest context (8191) spans every split
    of the grid; a 1000-token window leaves the leading ones idle."""
    kw = dict(page_size=64)
    n = decode_n_splits(128)
    assert n == -(-128 // DECODE_SPLIT_PAGES)
    assert list(decode_active_splits(0, **kw)) == [0]
    assert list(decode_active_splits(8191, **kw)) == list(range(n))
    sp = decode_active_splits(8191, window=1000, **kw)
    assert sp.stop == n and sp.start == (8191 - 999) // (64 * DECODE_SPLIT_PAGES)


@settings(max_examples=300, deadline=None)
@given(
    psz=st.sampled_from([16, 32, 64, 128]),
    split_pages=st.sampled_from([1, 2, 4, 8, 16]),
    n_pages=st.integers(1, 40),
    data=st.data(),
)
def test_split_plan_covers_each_attended_key_once(psz, split_pages, n_pages, data):
    """Over every split of the grid: each position the slot attends
    (behind last_pos, inside the window) is attended by exactly one split,
    and no other; every active split attends at least one position and
    the others none; the last active split owns page last_pos // psz (it
    writes the new token) and no other split reads a key of that page."""
    last_pos = data.draw(st.integers(0, n_pages * psz - 1))
    window = data.draw(st.one_of(st.none(), st.integers(1, n_pages * psz + 5)))
    kw = dict(page_size=psz, window=window, split_pages=split_pages)
    n_sp = decode_n_splits(n_pages, split_pages)
    active = decode_active_splits(last_pos, **kw)
    assert 0 <= active.start <= active.stop - 1 < n_sp
    seen = np.zeros(n_pages * psz, np.int64)
    owner_page = last_pos // psz
    for split in range(n_sp):
        lo, hi = _split_keys(last_pos, split, **kw)
        if split not in active:
            assert lo == hi
            continue
        assert lo < hi
        seen[lo:hi] += 1
        pages = set(range(lo // psz, (hi - 1) // psz + 1))
        assert (owner_page in pages) == (split == active.stop - 1)
    first = max(0, last_pos - window + 1) if window else 0
    want = np.zeros_like(seen)
    want[first:last_pos + 1] = 1
    assert np.array_equal(seen, want)


def _t(a):
    return torch.from_numpy(np.array(a))


def _last_pos(psz):
    """An idle slot, a context of exactly one split, one a key past it,
    one mid-page in the third split, and the table's longest context."""
    sk = SPLIT * psz
    return np.array([0, sk - 1, sk, 2 * sk + psz // 2 + 3, P * psz - 1], np.int32)


def _case(rng, quant, psz):
    """Five slots (``_last_pos``) over layer 1 of a two-layer pool, live
    slots on distinct pages; the idle slot's table is all zero."""
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
    last_pos = _last_pos(psz)
    B = len(last_pos)
    q = rng.standard_normal((B, N, H)).astype(np.float32)
    kn, vn = (rng.standard_normal((B, K, H)).astype(np.float32) for _ in range(2))
    table = np.zeros((B, P), np.int32)
    ids = rng.permutation(NP - 1) + 1
    used = 0
    for b, lp in enumerate(last_pos):
        n = lp // psz + 1 if lp else 0
        table[b, :n] = ids[used:used + n]
        used += n
    return q, kp, vp, ks, vs, kn, vn, table, last_pos


def _split_partials(q, kp, vp, ks, vs, table, last_pos, psz, window, softcap):
    """Each active split's partial (O unnormalized, m, l), float32, as the
    kernel leaves it: the plain version's logits over the split's keys of
    the pools (after the new token's write). Splits a slot does not use
    hold NaN (the merge must never read them). Returns o_part, ml_part
    and the outputs of slots with one active split (the kernel writes
    those; the others zero)."""
    B = q.shape[0]
    n_sp = decode_n_splits(P, SPLIT)
    o_part = torch.full((n_sp, B, N, H), float("nan"))
    ml_part = torch.full((n_sp, B, N, 2), float("nan"))
    direct = torch.zeros(B, N, H)
    kw = dict(page_size=psz, window=window, split_pages=SPLIT)
    for b, lp in enumerate(last_pos.tolist()):
        active = decode_active_splits(lp, **kw)
        for s in active:
            lo, hi = _split_keys(lp, s, **kw)
            pos = torch.arange(lo, hi)
            rows = NP + table[b, pos // psz].long()
            kk, vv = kp[rows, :, pos % psz], vp[rows, :, pos % psz]        # [T, K, H]
            if ks is not None:
                kk = kk.float() * ks[rows, :, pos % psz][..., None]
                vv = vv.float() * vs[rows, :, pos % psz][..., None]
            kx = kk.repeat_interleave(G, dim=1)
            vx = vv.repeat_interleave(G, dim=1)
            z = torch.einsum("nh,tnh->nt", q[b], kx) * H ** -0.5
            if softcap is not None:
                z = softcap * torch.tanh(z / softcap)
            m = z.amax(dim=-1)
            p = torch.exp(z - m[:, None])
            o = torch.einsum("nt,tnh->nh", p, vx)
            l = p.sum(-1)
            if len(active) == 1:
                direct[b] = o / l[:, None]
            else:
                o_part[s, b], ml_part[s, b, :, 0], ml_part[s, b, :, 1] = o, m, l
    return o_part, ml_part, direct


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("psz", [16, 32, 64])
@pytest.mark.parametrize("window,softcap", [
    (None, None), ("edge_in_split", 20.0), ("leading_empty", None),
])
def test_merge_of_split_partials_matches_unsplit(quant, psz, window, softcap):
    """Slots over one, two, three and four splits (and an idle slot),
    merged from their split partials, against the unsplit plain version
    and the JAX kernel. Window "edge_in_split" (a split and 7 keys) puts
    its lower edge inside a split; "leading_empty" (two splits less 5)
    leaves the longest slot's first two splits empty."""
    sk = SPLIT * psz
    window = {"edge_in_split": sk + 7, "leading_empty": 2 * sk - 5}.get(window, window)
    rng = np.random.default_rng(7)
    q, kp, vp, ks, vs, kn, vn, table, last_pos = _case(rng, quant, psz)
    scales = dict(k_scale=_t(ks), v_scale=_t(vs)) if quant else {}
    kw = dict(layer_base=NP, k_new=_t(kn), v_new=_t(vn), window=window, logit_softcap=softcap)
    res = ops.paged_attention_plain(_t(q), _t(kp), _t(vp), _t(table), _t(last_pos),
                                    **scales, **kw)
    want, pools = res[0], res[1:]
    if quant:
        assert [len(decode_active_splits(int(x), page_size=psz, split_pages=SPLIT))
                for x in last_pos] == [1, 1, 2, 3, 4]
    o_part, ml_part, direct = _split_partials(
        _t(q), *pools[:2], *(pools[2:] if quant else (None, None)), _t(table),
        _t(last_pos), psz, window, softcap)
    merged = ops.paged_decode_merge_plain(o_part, ml_part, _t(last_pos), direct,
                                          page_size=psz, window=window, split_pages=SPLIT)
    assert merged is direct
    live = last_pos > 0
    torch.testing.assert_close(merged[live], want[live], atol=1e-6, rtol=0)
    jscale = {k: jnp.asarray(v) for k, v in (("k_scale", ks), ("v_scale", vs)) if quant}
    jwant = j_paged(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(table),
                    jnp.asarray(last_pos), interpret=True, layer_base=NP,
                    k_new=jnp.asarray(kn), v_new=jnp.asarray(vn), window=window,
                    logit_softcap=softcap, **jscale)[0]
    np.testing.assert_allclose(merged.numpy()[live], np.asarray(jwant)[live], atol=1e-5,
                               rtol=0)


def test_merge_plain_leaves_single_split_slots_and_zeros_empty_heads():
    """Slots with one active split are the kernel's to write and stay as
    they are; a merged head whose splits attend nothing (l = 0 everywhere)
    comes out as zeros, not NaN; splits outside a slot's active range are
    never read (NaN there changes nothing)."""
    psz = 16
    sk = SPLIT * psz
    n_sp, B = 4, 3
    # Under a window of two splits less one key: slot 0 spans splits 1-3
    # (split 0 behind its window), slot 1 one split, slot 2 splits 2-3.
    last_pos = torch.tensor([3 * sk + 3, 5, 4 * sk - 1], dtype=torch.int32)
    kw = dict(page_size=psz, window=2 * sk - 1, split_pages=SPLIT)
    assert [list(decode_active_splits(int(x), **kw)) for x in last_pos] == [[1, 2, 3], [0],
                                                                             [2, 3]]
    gen = torch.Generator().manual_seed(0)
    o_part = torch.randn(n_sp, B, N, H, generator=gen)
    ml_part = torch.randn(n_sp, B, N, 2, generator=gen)
    ml_part[..., 1] = ml_part[..., 1].abs()
    ml_part[:, 2, 1, 0] = NEG_INF          # slot 2, head 1: nothing attended
    ml_part[:, 2, 1, 1] = 0.0
    o_part[:, 2, 1] = 0.0
    for s, b in ((0, 0), (0, 2), (1, 2)):   # outside the slots' active splits
        o_part[s, b] = ml_part[s, b] = float("nan")
    out = torch.full((B, N, H), 7.0)
    ops.paged_decode_merge_plain(o_part, ml_part, last_pos, out, **kw)
    assert torch.isfinite(out).all()
    assert (out[2, 1] == 0).all()
    assert (out[1] == 7.0).all()
    m, l = ml_part[1:4, 0, :, 0], ml_part[1:4, 0, :, 1]
    w = torch.exp(m - m.amax(0))
    want = (o_part[1:4, 0] * w[..., None]).sum(0) / (l * w).sum(0)[..., None]
    torch.testing.assert_close(out[0], want, atol=1e-6, rtol=1e-6)


def _merge_args():
    B, n_sp = 2, 3
    return dict(o_part=torch.zeros(n_sp, B, N, H), ml_part=torch.zeros(n_sp, B, N, 2),
                last_pos=torch.zeros(B, dtype=torch.int32),
                out=torch.zeros(B, N, H, dtype=torch.bfloat16))


@pytest.mark.parametrize("bad", ["ml_shape", "out_dtype", "last_pos_dtype", "strided"])
def test_merge_launcher_refuses_misshapen_arguments(bad):
    """The merge's launcher checks shapes, dtypes and layout before it
    builds or launches anything (so on any device)."""
    a = _merge_args()
    if bad == "ml_shape":
        a["ml_part"] = torch.zeros(3, 2, N, 3)
    elif bad == "out_dtype":
        a["out"] = a["out"].float()
    elif bad == "last_pos_dtype":
        a["last_pos"] = a["last_pos"].long()
    else:
        a["o_part"] = torch.zeros(3, 2, N, 2 * H)[..., ::2]
    with pytest.raises(ValueError, match="merge"):
        ops.paged_decode_merge_cuda(a["o_part"], a["ml_part"], a["last_pos"], a["out"],
                                    page_size=16)
