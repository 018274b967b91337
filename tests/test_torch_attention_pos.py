"""K3's explicit-positions branch on the CPU: ``attention_plain`` with
``q_positions``/``kv_positions`` against the JAX package's attention
(``impl="xla"``, whose mask compares the same position arrays), and the
runner's gather prefill body (``prefill_step(..., paged_prefill=False)``)
against the JAX runner's, over float32 and int8 pools.

Float32 throughout: outputs to 1e-5, logits to 1e-4 (a few layers summed
in another order), pool bytes written from the same K/V to 1e-5. Rows
that attend nothing are left out (the JAX reference averages v over them,
every flash kernel returns zeros; the gather body's callers discard them).
The kernel itself runs only on the card (``chip_smoke.py`` holds it
against this plain version); here its wrapper refuses CPU tensors. The
bf16 kernel's split walk (``ops/flash_pos.py``: GQA-packed blocks, a live
step list shared evenly by a block's splits, float32 partials and a merge
in split order) is held here through its plain version, split for split,
against the JAX package's ``flash_attention_with_lse`` (interpret mode):
outputs and lse of the real rows to 1e-5, a row that attends nothing as
zeros and NEG_INF (-inf there), and the plan's live steps against every
pair the mask admits. Last,
engines with inference.paged_prefill=false (prefix-cache hits and chunks
through the gather body) against the JAX engine: streams, outcomes,
surfacing steps and counters with no tolerance.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orion_tpu.config import get_config as j_get_config
from orion_tpu.infer import InferenceEngine as JEngine
from orion_tpu.infer import runner as j_runner
from orion_tpu.infer.kv_cache import init_cache as j_init_cache
from orion_tpu.models import init_params as j_init_params
from orion_tpu.ops.attention import attention as j_attention
from orion_tpu.ops.pallas.flash_attention import flash_attention_with_lse
from orion_tpu_torch import ops
from orion_tpu_torch.ops import flash_pos
from orion_tpu_torch.ops.common import NEG_INF, TC_ROWS
from orion_tpu_torch.config import get_config
from orion_tpu_torch.infer import InferenceEngine, runner
from orion_tpu_torch.infer.kv_cache import init_cache
from orion_tpu_torch.metrics import PrefixCacheStats, RobustnessStats
from orion_tpu_torch.models import from_jax_params
from tests import torch_threads  # noqa: F401  (one intra-op thread)

N, K, H = 4, 2, 16


def _gather_layout(rng, psz=8, P_pre=4, S=16):
    """The gather body's layout: rows resuming at page-aligned prefixes
    (0, 1 and 4 pages) with ragged tails, the prefix at [0, P_pre*psz)."""
    starts = np.array([0, psz, P_pre * psz])
    lens = np.array([S, 11, 5])
    B, n_pre = len(starts), P_pre * psz
    qpos = (starts[:, None] + np.arange(S)).astype(np.int32)
    qseg = (np.arange(S)[None] < lens[:, None]).astype(np.int32)
    kpos = np.concatenate([np.broadcast_to(np.arange(n_pre), (B, n_pre)), qpos], 1)
    kseg = np.concatenate([(np.arange(n_pre)[None] < starts[:, None]).astype(np.int32),
                           qseg], 1)
    q = rng.standard_normal((B, S, N, H)).astype(np.float32)
    kv = rng.standard_normal((2, B, n_pre + S, K, H)).astype(np.float32)
    return q, kv[0], kv[1], dict(q_positions=qpos, kv_positions=kpos.astype(np.int32),
                                 q_segment_ids=qseg, kv_segment_ids=kseg)


def _striped_layout(rng, B=2, S=32, stripes=4):
    """A striped permutation (position j*stripes + r at index r*S/stripes +
    j): positions that do not rise, as sequence parallelism gives."""
    perm = np.arange(S).reshape(S // stripes, stripes).T.reshape(-1)
    pos = np.broadcast_to(perm, (B, S)).astype(np.int32).copy()
    q = rng.standard_normal((B, S, N, H)).astype(np.float32)
    kv = rng.standard_normal((2, B, S, K, H)).astype(np.float32)
    return q, kv[0], kv[1], dict(q_positions=pos, kv_positions=pos)


@pytest.mark.parametrize("layout", ["gather", "striped"])
@pytest.mark.parametrize("window,softcap", [(None, None), (8, None), (None, 20.0),
                                            (12, 30.0)])
def test_attention_plain_positions_match_jax(layout, window, softcap):
    rng = np.random.default_rng(0)
    q, k, v, kw = (_gather_layout if layout == "gather" else _striped_layout)(rng)
    want = np.asarray(j_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True, window=window,
        logit_softcap=softcap, impl="xla", **{n: jnp.asarray(a) for n, a in kw.items()}))
    got = ops.attention_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), causal=True,
        window=window, logit_softcap=softcap,
        **{n: torch.from_numpy(a) for n, a in kw.items()}).numpy()
    # Rows that attend something: their own position is always visible.
    rows = kw.get("q_segment_ids", np.ones(q.shape[:2], np.int32)) > 0
    np.testing.assert_allclose(got[rows], want[rows], atol=1e-5, rtol=0)


def _no_build(*args, **kwargs):
    raise AssertionError("a kernel was built for CPU tensors")


def test_attention_positions_dispatch_and_refusals(monkeypatch):
    """``attention`` takes positions on the CPU through the plain version;
    the K3 wrapper refuses CPU tensors before any build and counts
    nothing, and positions come in pairs."""
    from orion_tpu_torch.ops import _build
    from orion_tpu_torch.ops.attention import _check_positions

    monkeypatch.setattr(_build, "library", _no_build)
    monkeypatch.setattr(_build, "entry", _no_build)
    rng = np.random.default_rng(1)
    q, k, v, kw = _striped_layout(rng)
    t = {n: torch.from_numpy(a) for n, a in kw.items()}
    args = [torch.from_numpy(a) for a in (q, k, v)]
    assert torch.equal(ops.attention(*args, seg_pad_zero=True, **t),
                       ops.attention_plain(*args, **t))
    ops.reset_launches()
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.flash_attention_pos_cuda(*args, t["q_positions"], t["kv_positions"])
    assert ops.launches()["flash_fwd_pos"] == 0
    with pytest.raises(ValueError, match="go together"):
        _check_positions(t["q_positions"], None, 2, 32, 32)


def _split_case(case, rng):
    """Inputs of a split-and-merge case: (q, k, v, positions and segments,
    window, n_splits, split_steps), numpy. Small split sizes so that a
    few hundred keys split several ways."""
    window, n_splits, split_steps = None, 6, 1
    if case in ("gather", "gather_window"):
        q, k, v, kw = _gather_layout(rng, P_pre=12, S=40)
        window = 20 if case == "gather_window" else None
    elif case == "striped":
        q, k, v, kw = _striped_layout(rng, S=128)
        n_splits, split_steps = 3, 1
    else:
        # G = 8 (tq = 16: three q tiles a row): row 0 resumes at 0 over a
        # prefix of padding (two live steps of eleven, so four of its six
        # splits have none), row 1 over all of it, and row 2 attends
        # nothing (every kv position past its queries').
        B, S, n_pre, n, kh = 3, 40, 256, 8, 1
        qpos = np.stack([np.arange(S), n_pre + np.arange(S), np.arange(S)]).astype(np.int32)
        kpos = np.concatenate([np.broadcast_to(np.arange(n_pre), (B, n_pre)), qpos], 1)
        kpos[2] += 10 ** 6
        kseg = np.ones((B, n_pre + S), np.int32)
        kseg[0, :n_pre] = 0
        qseg = np.ones((B, S), np.int32)
        q = rng.standard_normal((B, S, n, H)).astype(np.float32)
        kv = rng.standard_normal((2, B, n_pre + S, kh, H)).astype(np.float32)
        k, v = kv[0], kv[1]
        kw = dict(q_positions=qpos, kv_positions=kpos.astype(np.int32), q_segment_ids=qseg,
                  kv_segment_ids=kseg)
        split_steps = 2
    return q, k, v, kw, window, n_splits, split_steps


@pytest.mark.parametrize("case", ["gather", "gather_window", "striped", "empty_splits"])
def test_split_merge_plain_matches_jax(case):
    """The bf16 kernel's split walk, in PyTorch: each split's partials over
    its share of the block's live steps, merged in split order, against the
    JAX kernel's output and lse on every real row; the plan really splits
    (some block merges several splits, some leaves splits with no step)."""
    rng = np.random.default_rng(5)
    q, k, v, kw, window, n_splits, split_steps = _split_case(case, rng)
    want_o, want_lse = flash_attention_with_lse(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True, window=window,
        interpret=True, **{n: jnp.asarray(a) for n, a in kw.items()})
    t = {n: torch.from_numpy(a) for n, a in kw.items()}
    seg_pad_zero = "q_segment_ids" in t
    got_o, got_lse = flash_pos.flash_attention_pos_split_plain(
        *(torch.from_numpy(a) for a in (q, k, v)), t["q_positions"], t["kv_positions"],
        q_segment_ids=t.get("q_segment_ids"), kv_segment_ids=t.get("kv_segment_ids"),
        window=window, seg_pad_zero=seg_pad_zero, return_lse=True, n_splits=n_splits,
        split_steps=split_steps)
    _, n_act = flash_pos.split_plan(
        t["q_positions"], t["kv_positions"], t.get("q_segment_ids"), t.get("kv_segment_ids"),
        n_heads=q.shape[2], n_kv_heads=k.shape[2], window=window, seg_pad_zero=seg_pad_zero,
        n_splits=n_splits, split_steps=split_steps)
    assert n_act.max() > 1
    if case != "striped":
        assert n_act.min() < n_splits
    rows = kw.get("q_segment_ids", np.ones(q.shape[:2], np.int32)) > 0
    np.testing.assert_allclose(got_o.numpy()[rows], np.asarray(want_o)[rows], atol=1e-5,
                               rtol=0)
    got_lse = got_lse.numpy().transpose(0, 2, 1)[rows]
    want_lse = np.asarray(want_lse).transpose(0, 2, 1)[rows]
    none = np.isneginf(want_lse)
    assert np.array_equal(got_lse <= NEG_INF / 2, none)
    np.testing.assert_allclose(got_lse[~none], want_lse[~none], atol=1e-5, rtol=0)
    if case == "empty_splits":
        assert none[2 * q.shape[1]:].all() and not none[:2 * q.shape[1]].any()
        assert not got_o[2].any()


def test_split_plan_covers_every_admitted_pair():
    """live_steps lists, in order, every key step that holds a pair the
    mask admits for some real query of the block (and block_live keeps
    each block that has one); the splits' shares tile the list, and the
    grid's split count follows the shapes (4 at the gather body's, 2 at
    a serve's burst of four 1024-token tails over a 1024-token prefix and
    at a training-sized batch, 1 where no walk exceeds one split)."""
    rng = np.random.default_rng(6)
    for case in ("gather", "gather_window", "striped", "empty_splits"):
        q, k, v, kw, window, n_splits, split_steps = _split_case(case, rng)
        t = {n: torch.from_numpy(a) for n, a in kw.items()}
        N, K = q.shape[2], k.shape[2]
        mask = ops.attention_mask(q.shape[1], k.shape[1], window=window, **t)
        steps, n_act = flash_pos.split_plan(
            t["q_positions"], t["kv_positions"], t.get("q_segment_ids"),
            t.get("kv_segment_ids"), n_heads=N, n_kv_heads=K, window=window,
            seg_pad_zero="q_segment_ids" in t, n_splits=n_splits, split_steps=split_steps)
        tq = ops.common.q_tile(N // K)
        if "q_segment_ids" in t:
            mask = mask & (t["q_segment_ids"] > 0)[:, :, None]   # real queries
        for (b, qt), s_list in steps.items():
            block = mask[b, qt * tq:qt * tq + tq]
            need = sorted({int(c) // flash_pos.KEY_STEP for c in torch.nonzero(block)[:, 1]})
            assert set(need) <= set(s_list) and s_list == sorted(s_list), (case, b, qt)
            na = int(n_act[b, qt])
            assert na == flash_pos.active_splits(len(s_list), n_splits, split_steps)
            shares = [flash_pos.split_share(len(s_list), na, sp) for sp in range(na)]
            assert [i for lo, hi in shares for i in range(lo, hi)] == list(range(len(s_list)))
            assert all(lo < hi for lo, hi in shares) or not s_list
    assert flash_pos.grid_splits(4, 256, 128 * 64 + 256, 32, 8) == 4
    assert flash_pos.grid_splits(4, 1024, 2048, 32, 8) == 2
    assert flash_pos.grid_splits(8, 2048, 2048, 32, 8) == 2
    assert flash_pos.grid_splits(8, 1024, 1024, 32, 8) == 1
    assert flash_pos.active_splits(0, 8) == 1 and flash_pos.active_splits(250, 8) == 8


def test_split_constants_match_kernel_source():
    """The plan's key step, liveness tile and row count are the kernel's
    (csrc/flash_tc.cuh)."""
    import re
    from pathlib import Path

    src = (Path(ops.__file__).resolve().parent.parent / "csrc" / "flash_tc.cuh").read_text()
    consts = dict(re.findall(r"constexpr int (\w+) = (\d+);", src))
    assert int(consts["KB"]) == flash_pos.KEY_STEP
    assert int(consts["SUB"]) == flash_pos.SUB
    assert int(consts["ROWS"]) == TC_ROWS


def test_split_merge_plain_and_refusals(monkeypatch):
    """The merge's plain version combines the splits of blocks with more
    than one active split (rows of the others untouched); its CUDA wrapper
    refuses CPU tensors before any build and counts nothing."""
    from orion_tpu_torch.ops import _build

    monkeypatch.setattr(_build, "library", _no_build)
    monkeypatch.setattr(_build, "entry", _no_build)
    gen = torch.Generator().manual_seed(7)
    n_sp, B, Sq, N, Hd, tq = 3, 2, 8, 2, 16, 4
    o_part = torch.randn(n_sp, B, Sq, N, Hd, generator=gen)
    ml_part = torch.randn(n_sp, B, Sq, N, 2, generator=gen).abs()
    n_act = torch.tensor([[1, 3], [2, 1]], dtype=torch.int32)
    out = torch.zeros(B, Sq, N, Hd, dtype=torch.bfloat16)
    lse = torch.zeros(B, N, Sq)
    ops.reset_launches()
    out, lse = flash_pos.flash_pos_merge_plain(o_part, ml_part, n_act, out, lse, tq=tq)
    assert not out[0, :4].any() and not out[1, 4:].any() and out[0, 4:].any()
    w = torch.exp(ml_part[:2, 1, :4, ..., 0] - ml_part[:2, 1, :4, ..., 0].amax(0))
    want = (o_part[:2, 1, :4] * w[..., None]).sum(0) / (ml_part[:2, 1, :4, ..., 1] * w).sum(0)[
        ..., None]
    torch.testing.assert_close(out[1, :4].float(), want, atol=1e-2, rtol=1e-2)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.flash_pos_merge_cuda(o_part, ml_part, n_act, out, lse, tq=tq)
    assert ops.launches()["flash_fwd_pos_merge"] == 0


INFER_OVERRIDES = [
    "inference.max_seq_len=128", "inference.page_size=16",
    "inference.num_pages=32", "inference.max_batch_size=4",
    "inference.prefill_chunk=16", "inference.max_new_tokens=8",
]


def _pair(overrides=()):
    ov = INFER_OVERRIDES + list(overrides)
    jcfg = j_get_config("tiny-llama", ov)
    jcfg = dataclasses.replace(jcfg, model=dataclasses.replace(jcfg.model, kernels="xla"))
    cfg = get_config("tiny-llama", ov)
    jp = j_init_params(jcfg.model, jax.random.key(0))
    return jcfg, jp, cfg, from_jax_params(jax.tree.map(np.asarray, jp), cfg.model)


@pytest.mark.parametrize("quant", [False, True])
def test_prefill_step_gather_body_matches_jax(quant):
    """Cold rows fill prefix pages, then tail rows resume over them (0, 1
    and 2 prefix pages, ragged tails, a pad row) through the gather body
    on both sides: logits and every written pool row agree."""
    jcfg, jp, cfg, tp = _pair(["inference.kv_quant=int8"] if quant else [])
    rng = np.random.default_rng(2)
    V = cfg.model.vocab_size
    cold = rng.integers(0, V, size=(2, 32)).astype(np.int32)
    c_lens = np.array([32, 32], np.int32)
    c_pages = np.array([[1, 2], [3, 4]], np.int32)
    tail = np.zeros((4, 16), np.int32)
    t_lens = np.array([16, 9, 3, 1], np.int32)
    for i, n in enumerate(t_lens[:3]):
        tail[i, :n] = rng.integers(0, V, size=n)
    t_pages = np.array([[5], [6], [7], [0]], np.int32)
    pre_lens = np.array([32, 16, 0, 0], np.int32)
    pre_pages = np.array([[1, 2], [3, 0], [0, 0], [0, 0]], np.int32)

    jcache = j_init_cache(jcfg.model, jcfg.inference)
    cache = init_cache(cfg.model, cfg.inference, "cpu")
    _, jcache = j_runner.prefill_step(jp, jcache, jnp.asarray(cold), jnp.asarray(c_lens),
                                      jnp.asarray(c_pages), cfg=jcfg.model)
    runner.prefill_step(tp, cache, torch.from_numpy(cold), torch.from_numpy(c_lens),
                        torch.from_numpy(c_pages), cfg=cfg.model)
    jl, jcache = j_runner.prefill_step(
        jp, jcache, jnp.asarray(tail), jnp.asarray(t_lens), jnp.asarray(t_pages),
        jnp.asarray(pre_lens), jnp.asarray(pre_pages), cfg=jcfg.model, paged_prefill=False)
    tl, _ = runner.prefill_step(
        tp, cache, torch.from_numpy(tail), torch.from_numpy(t_lens),
        torch.from_numpy(t_pages), torch.from_numpy(pre_lens), torch.from_numpy(pre_pages),
        cfg=cfg.model, paged_prefill=False)
    np.testing.assert_allclose(tl.numpy()[:3], np.asarray(jl)[:3], atol=1e-4, rtol=0)
    NP = cfg.inference.num_pages
    live = (np.arange(cache["k"].shape[0]) % NP) != 0     # scratch page 0 excluded
    for name in cache:
        got, want = cache[name].numpy()[live], np.asarray(jcache[name])[live]
        if got.dtype == np.int8:
            # One code step where the float K/V round the other way.
            assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= 1, name
        else:
            np.testing.assert_allclose(got, want, atol=1e-5, rtol=0, err_msg=name)


COUNTERS = tuple(PrefixCacheStats().as_timing()) + tuple(RobustnessStats().as_timing())


def _drain(eng):
    """Step until idle: {rid: (outcome, tokens, step it surfaced at)}."""
    done = {}
    while eng.has_work():
        n = eng.step_no
        for r in eng.step():
            done[r.rid] = (r.outcome, list(r.generated), n)
    return done


@pytest.mark.parametrize("overrides", [
    ["inference.prefix_cache=true"],
    ["inference.prefix_cache=true", "inference.kv_quant=int8"],
    ["inference.chunked_prefill=true", "inference.prefix_cache=true"],
])
def test_gather_prefill_body_engine_matches_jax(overrides):
    """inference.paged_prefill=false: prefix-cache hits and chunks resume
    through the gather body (K3 with explicit positions on the card); the
    streams, outcomes and prefix counters equal the JAX engine's, and the
    paged_prefill=true port engine's streams (f32)."""
    base = INFER_OVERRIDES + ["inference.prefill_chunk_tokens=32"]
    jcfg0, jp, cfg0, tp = _pair()
    sys_p = [(i * 13) % 250 + 2 for i in range(32)]
    waves = [[sys_p + [5, 3, 9], sys_p + list(range(20, 40))], [sys_p + [7, 7], sys_p]]

    def drive(eng, side):
        out = []
        for w in waves:
            rids = [eng.submit(p, 6) for p in w]
            done = _drain(eng)
            out.append([done[r] for r in rids])
        return {"waves": out}

    out = {}
    for side in ("jax", "torch"):
        ov = base + overrides + ["inference.paged_prefill=false"]
        cfg = (j_get_config if side == "jax" else get_config)("tiny-llama", ov)
        if side == "jax":
            cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, kernels="xla"))
            eng = JEngine(cfg, jp)
        else:
            eng = InferenceEngine(cfg, tp, device="cpu")
        res = drive(eng, side)
        t = eng.reset_timing()
        res["counters"] = {k: t.get(k) for k in COUNTERS}
        out[side] = res
    assert out["torch"] == out["jax"]
    assert out["torch"]["counters"]["prefix_hits"] >= 2
    paged = InferenceEngine(get_config("tiny-llama", base + overrides), tp, device="cpu")
    assert drive(paged, "torch")["waves"] == out["torch"]["waves"]
