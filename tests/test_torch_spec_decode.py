"""Speculative decoding in the port (``orion_tpu_torch``), on the CPU,
against the JAX package.

- The drafter (``infer/spec_decode.py``, a copy of the JAX module) equals
  the JAX one, source and behaviour, over seeded contexts.
- The verifiers (``sampling.spec_verify_sample`` and ``_tree``): greedy
  verdicts equal JAX's on the same logits; sampled verdicts draw from a
  ``torch.Generator`` (not ``jax.random``), so they are pinned by their
  law: the emitted token is distributed as the filtered target within a
  total-variation bound of 0.02 over 40000 draws (the Monte-Carlo TV of a
  V = 8 law at that N is about 0.007).
- Rollback and KV compaction: pages and pools byte-equal to JAX's.
- The engine: greedy streams with speculation on equal those with it off
  and those of the JAX engine (xla kernels) token for token, with equal
  speculation counters, on tiny-llama and tiny-gemma2 (softcaps,
  interleaved windows), chain and token-tree drafting, alone and composed
  with int8 pools, the prefix cache and chunked prefill.

The traffic is the JAX suite's (``tests/test_spec_decode.py``): cyclic
prompts whose greedy continuations loop, so the n-gram drafter drafts, at
decode_window 1.
"""

import dataclasses
import inspect

import jax
import numpy as np
import pytest
import torch

import orion_tpu.infer.spec_decode as jsd
import orion_tpu_torch.infer.spec_decode as tsd
from orion_tpu.config import get_config as j_get_config
from orion_tpu.infer import InferenceEngine as JEngine
from orion_tpu.infer.kv_cache import PageAllocator as JPageAllocator
from orion_tpu.infer.kv_cache import compact_draft_kv as j_compact
from orion_tpu.infer.kv_cache import rollback_pages as j_rollback
from orion_tpu.infer.sampling import spec_verify_sample as j_verify
from orion_tpu.infer.sampling import spec_verify_sample_tree as j_verify_tree
from orion_tpu.models import init_params as j_init_params
from orion_tpu_torch.config import get_config
from orion_tpu_torch.infer import InferenceEngine
from orion_tpu_torch.infer.kv_cache import PageAllocator, compact_draft_kv, rollback_pages
from orion_tpu_torch.infer.sampling import (
    filter_logits,
    spec_verify_sample,
    spec_verify_sample_tree,
)
from orion_tpu_torch.models import from_jax_params
from tests import torch_threads  # noqa: F401  (one intra-op thread)

INFER_OVERRIDES = [
    "inference.max_seq_len=128", "inference.page_size=16",
    "inference.num_pages=32", "inference.max_batch_size=4",
    "inference.prefill_chunk=16", "inference.max_new_tokens=8",
    "inference.decode_window=1",
]
SPEC = ["inference.speculative=true", "inference.speculate_tokens=4"]
TREE = ["inference.spec_tree_width=2"]
COMPOSED = ["inference.kv_quant=int8", "inference.prefix_cache=true",
            "inference.chunked_prefill=true", "inference.prefill_chunk_tokens=16"]
MODES = {"chain": [], "tree": TREE, "chain_composed": COMPOSED,
         "tree_composed": TREE + COMPOSED}

REP = [7, 8, 9, 7, 8, 9, 7, 8, 9, 7, 8]
MIX = [REP, [5, 3, 9, 250, 17], list(range(2, 32))]

_PARAMS: dict = {}


def _params(preset):
    if preset not in _PARAMS:
        jcfg = j_get_config(preset, INFER_OVERRIDES)
        jp = j_init_params(jcfg.model, jax.random.key(0))
        tp = from_jax_params(jax.tree.map(np.asarray, jp),
                             get_config(preset, INFER_OVERRIDES).model)
        _PARAMS[preset] = (jp, tp)
    return _PARAMS[preset]


def _port(preset="tiny-llama", overrides=(), spec=True, **kw):
    cfg = get_config(preset, INFER_OVERRIDES + (SPEC if spec else []) + list(overrides))
    return InferenceEngine(cfg, _params(preset)[1], device="cpu", **kw)


def _jax(preset="tiny-llama", overrides=(), spec=True, **kw):
    cfg = j_get_config(preset, INFER_OVERRIDES + (SPEC if spec else []) + list(overrides))
    return JEngine(cfg, _params(preset)[0], **kw)


def _waves(eng, n_new=16):
    """Two waves of MIX: the second one hits the prefix cache (when on),
    whose token paths are then a draft source too."""
    return [eng.generate(MIX, n_new), eng.generate(MIX, n_new)]


# -- (h) the drafter -----------------------------------------------------------


def test_spec_decode_copy_matches_jax_source():
    """The port's module is a copy: every function and class has the JAX
    module's source, and it imports nothing of the JAX package."""
    names = ["propose_ngram", "propose_ngram_candidates", "DraftTree", "build_tree",
             "SpecState", "NgramProposer"]
    for name in names:
        assert inspect.getsource(getattr(tsd, name)) == inspect.getsource(getattr(jsd, name))
    src = inspect.getsource(tsd)
    assert "import orion_tpu\n" not in src and "from orion_tpu." not in src


def _contexts(seed, n=60):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        L = int(rng.integers(2, 40))
        out.append(rng.integers(0, int(rng.integers(3, 12)), L).tolist())
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_drafter_matches_jax(seed):
    """(h) propose_ngram, propose_ngram_candidates, build_tree (tokens,
    parents, depths, mask words, children, depth), and NgramProposer's
    chain and tree proposals with their SpecState adaptation, over seeded
    contexts with and without extra sources."""
    ctxs = _contexts(seed)
    extra = [tuple(c) for c in _contexts(seed + 10, 4)]
    for i, ctx in enumerate(ctxs):
        src = extra if i % 2 else ()
        for k in (1, 3, 6):
            for lo, hi in ((1, 3), (2, 2)):
                kw = dict(max_n=hi, min_n=lo, extra_sources=src)
                assert tsd.propose_ngram(ctx, k, **kw) == jsd.propose_ngram(ctx, k, **kw)
                cands = tsd.propose_ngram_candidates(ctx, k, max_candidates=3, **kw)
                assert cands == jsd.propose_ngram_candidates(ctx, k, max_candidates=3, **kw)
                for budget in (2, 4, 8):
                    a, b = tsd.build_tree(cands, budget), jsd.build_tree(cands, budget)
                    assert (a.tokens, a.parents) == (b.tokens, b.parents)
                    if len(a):
                        assert a.depths() == b.depths()
                        assert a.mask_words() == b.mask_words()
                        assert a.children() == b.children()
                        assert a.max_depth == b.max_depth
    for width in (1, 2, 3):
        tp = tsd.NgramProposer(speculate_tokens=4, max_n=3, min_n=1, tree_width=width)
        jp = jsd.NgramProposer(speculate_tokens=4, max_n=3, min_n=1, tree_width=width)
        rng = np.random.default_rng(seed + width)
        for step, ctx in enumerate(ctxs * 2):
            rid = step % 5
            limit = int(rng.integers(0, 6))
            if width == 1:
                got = tp.propose(rid, ctx, limit, extra)
                assert got == jp.propose(rid, ctx, limit, extra)
                drafted = len(got)
            else:
                got, want = (p.propose_tree(rid, ctx, limit, extra) for p in (tp, jp))
                assert (got is None) == (want is None)
                if got is not None:
                    assert (got.tokens, got.parents) == (want.tokens, want.parents)
                drafted = got.max_depth if got is not None else 0
            acc = int(rng.integers(0, drafted + 1))
            tp.state(rid).update(drafted, acc, 4)
            jp.state(rid).update(drafted, acc, 4)
            assert dataclasses.asdict(tp.state(rid)) == dataclasses.asdict(jp.state(rid))
            if step % 17 == 0:
                tp.drop(rid)
                jp.drop(rid)


# -- (i) greedy verdicts ------------------------------------------------------


def _verify_inputs(seed, B=4, W=5, V=64):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((B, W, V)).astype(np.float32) * 3
    greedy = logits.argmax(-1)
    # Drafts that match the argmax at some positions, miss at others, and
    # -1 at bonus / padding positions.
    lens = rng.integers(1, W + 1, B)
    dn = np.where(rng.random((B, W)) < 0.5, greedy, rng.integers(0, V, (B, W)))
    dn = np.where(np.arange(W)[None] + 1 < lens[:, None], dn, -1).astype(np.int32)
    return logits, dn, lens.astype(np.int32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_greedy_verdicts_match_jax(seed):
    """(i) chain and tree, greedy: accept and alt equal JAX's on the same
    logits, and the port's generator is not drawn from."""
    logits, dn, lens = _verify_inputs(seed)
    gen = torch.Generator().manual_seed(0)
    state = gen.get_state()
    acc, alt = spec_verify_sample(torch.from_numpy(logits), torch.from_numpy(dn), gen)
    jacc, jalt = j_verify(jax.numpy.asarray(logits), jax.numpy.asarray(dn), jax.random.key(0))
    assert np.array_equal(acc.numpy(), np.asarray(jacc))
    assert np.array_equal(alt.numpy(), np.asarray(jalt))
    B, W = dn.shape
    rng = np.random.default_rng(seed + 7)
    tokens = np.where(rng.random((B, W)) < 0.5, logits.argmax(-1),
                      rng.integers(0, 64, (B, W))).astype(np.int32)
    parents = np.array([[0, 0, 1, 0, 3]] * B, np.int32)
    acc, alt = spec_verify_sample_tree(
        torch.from_numpy(logits), torch.from_numpy(tokens), torch.from_numpy(parents),
        torch.from_numpy(lens), gen)
    jacc, jalt = j_verify_tree(*(jax.numpy.asarray(a) for a in (logits, tokens, parents, lens)),
                               jax.random.key(0))
    assert np.array_equal(acc.numpy(), np.asarray(jacc))
    assert np.array_equal(alt.numpy(), np.asarray(jalt))
    assert torch.equal(gen.get_state(), state)


# -- (j) sampled verdicts: the law -------------------------------------------

N_DRAWS, TV_BOUND = 40000, 0.02


def _target(logits_row, temp, top_k=0, top_p=1.0):
    t = torch.from_numpy(logits_row)[None]
    f = filter_logits(t, torch.tensor([temp]), torch.tensor([top_k]), torch.tensor([top_p]),
                      no_topk=top_k == 0, no_topp=top_p >= 1.0)
    return torch.softmax(f, -1)[0].numpy().astype(np.float64)


def _tv(samples, p):
    emp = np.bincount(samples, minlength=len(p)) / len(samples)
    return 0.5 * np.abs(emp - p).sum()


@pytest.mark.parametrize("filters", [dict(), dict(top_k=5), dict(top_p=0.8)])
def test_sampled_chain_law(filters):
    """(j) chain: the emitted token (the draft if accepted, else the
    residual draw) follows the filtered target; acceptance follows
    p(draft); the residual never re-emits the rejected draft; the bonus
    position (no draft) is a plain draw from the target."""
    V, temp = 8, 0.7
    row = np.random.default_rng(2).standard_normal(V).astype(np.float32) * 2
    p = _target(row, temp, **filters)
    draft = int(np.argsort(p)[-2])
    logits = torch.from_numpy(np.broadcast_to(row, (N_DRAWS, 1, V)).copy())
    gen = torch.Generator().manual_seed(3)
    acc, alt = spec_verify_sample(logits, torch.full((N_DRAWS, 1), draft), gen,
                                  temperature=temp, **filters)
    acc, alt = acc[:, 0].numpy(), alt[:, 0].numpy()
    assert abs(acc.mean() - p[draft]) < 0.01
    assert _tv(np.where(acc, draft, alt), p) < TV_BOUND
    assert not np.any(alt[~acc] == draft)
    acc_b, alt_b = spec_verify_sample(logits, torch.full((N_DRAWS, 1), -1), gen,
                                      temperature=temp, **filters)
    assert not acc_b.any()
    assert _tv(alt_b[:, 0].numpy(), p) < TV_BOUND


def test_sampled_tree_law():
    """(j) tree: two sibling drafts off the root. The emitted token (the
    first accepted sibling, else the residual with both excluded) follows
    the target; the younger sibling is accepted, after the elder's
    rejection, with p(c2) / (1 - p(c1)); the residual never re-emits a
    rejected sibling."""
    V, temp = 8, 0.7
    row = np.random.default_rng(2).standard_normal(V).astype(np.float32) * 2
    p = _target(row, temp)
    order = np.argsort(p)
    c1, c2 = int(order[-2]), int(order[-3])
    logits = torch.from_numpy(np.broadcast_to(row, (N_DRAWS, 3, V)).copy())
    tokens = torch.tensor([[0, c1, c2]]).expand(N_DRAWS, 3)
    parents = torch.zeros(N_DRAWS, 3, dtype=torch.int32)
    lens = torch.full((N_DRAWS,), 3, dtype=torch.int32)
    gen = torch.Generator().manual_seed(4)
    acc, alt = spec_verify_sample_tree(logits, tokens, parents, lens, gen, temperature=temp)
    acc, alt = acc.numpy(), alt.numpy()
    emitted = np.where(acc[:, 1], c1, np.where(acc[:, 2], c2, alt[:, 0]))
    assert abs(acc[:, 1].mean() - p[c1]) < 0.01
    younger = acc[~acc[:, 1], 2].mean()
    assert abs(younger - p[c2] / (1 - p[c1])) < 0.015
    assert _tv(emitted, p) < TV_BOUND
    rej = ~acc[:, 1] & ~acc[:, 2]
    assert not np.any((alt[rej, 0] == c1) | (alt[rej, 0] == c2))


# -- (k) rollback and compaction ----------------------------------------------


def test_rollback_pages_matches_jax():
    """(k) the tail pages go back to the pool: the same pages, the same
    free list and refcounts as the JAX allocator's."""
    t_alloc, j_alloc = PageAllocator(16), JPageAllocator(16)
    t_pages, j_pages = t_alloc.alloc(7), j_alloc.alloc(7)
    assert t_pages == j_pages
    t_alloc.retain(t_pages[0])
    j_alloc.retain(j_pages[0])
    assert rollback_pages(t_alloc, t_pages, 3) == j_rollback(j_alloc, j_pages, 3)
    assert t_pages == j_pages
    assert t_alloc._free == j_alloc._free and t_alloc._refs == j_alloc._refs
    assert rollback_pages(t_alloc, t_pages, 3) == []


@pytest.mark.parametrize("quant", [False, True])
def test_compact_draft_kv_matches_jax(quant):
    """(k) gather-before-scatter moves across two layers and every cache
    tensor (int8 pages with their scale columns): pools byte-equal to the
    JAX compaction's. Slot 0 moves columns [3, 1] to cursor + 1, + 2 across
    a page boundary; slot 1 is an identity row."""
    L, NP, K, psz, H = 2, 8, 2, 4, 8
    rng = np.random.default_rng(0)
    if quant:
        cache = {"k": rng.integers(-127, 128, (L * NP, K, psz, H)).astype(np.int8),
                 "v": rng.integers(-127, 128, (L * NP, K, psz, H)).astype(np.int8),
                 "k_scale": rng.random((L * NP, K, 16)).astype(np.float32),
                 "v_scale": rng.random((L * NP, K, 16)).astype(np.float32)}
    else:
        cache = {n: rng.standard_normal((L * NP, K, psz, H)).astype(np.float32)
                 for n in ("k", "v")}
    pt = np.array([[1, 2, 3], [4, 5, 6]], np.int32)
    seq = np.array([3, 5], np.int32)
    src = np.array([[0, 3, 1, 3], [0, 1, 2, 3]], np.int32)
    want = j_compact({n: jax.numpy.asarray(a) for n, a in cache.items()},
                     jax.numpy.asarray(pt), jax.numpy.asarray(seq), jax.numpy.asarray(src),
                     n_layers=L, num_pages=NP)
    got = {n: torch.from_numpy(a.copy()) for n, a in cache.items()}
    compact_draft_kv(got, torch.from_numpy(pt), torch.from_numpy(seq),
                     torch.from_numpy(src), n_layers=L, num_pages=NP)
    for n in cache:
        a, b = got[n].numpy(), np.asarray(want[n])
        assert np.array_equal(a.view(np.uint8), b.view(np.uint8)), n
    assert not np.array_equal(got["k"].numpy(), cache["k"])   # something moved


# -- (l), (m) engine streams and counters against the JAX engine --------------

_RUNS: dict = {}


def _run_pair(preset, mode):
    """(port spec-on, port spec-off, JAX spec-on) streams over two waves,
    with both engines' spec_stats; computed once per (preset, mode)."""
    key = (preset, mode)
    if key not in _RUNS:
        ov = MODES[mode]
        on, off, jeng = _port(preset, ov), _port(preset, ov, spec=False), _jax(preset, ov)
        _RUNS[key] = dict(on=_waves(on), off=_waves(off), jax=_waves(jeng),
                          stats=on.spec_stats, jstats=jeng.spec_stats, timing=dict(on.timing),
                          eng=on)
    return _RUNS[key]


CASES = [(p, m) for p in ("tiny-llama", "tiny-gemma2") for m in MODES]


@pytest.mark.parametrize("preset,mode", CASES)
def test_engine_streams_match(preset, mode):
    """(l) greedy: port spec-on == port spec-off == JAX spec-on, token for
    token; the pool accounting holds after the waves."""
    r = _run_pair(preset, mode)
    assert r["on"] == r["off"]
    assert r["on"] == r["jax"]
    r["eng"].assert_page_accounting()


@pytest.mark.parametrize("preset,mode", CASES)
def test_engine_spec_stats_match_jax(preset, mode):
    """(m) every speculation counter equals the JAX engine's on the same
    traffic; drafts were verified and some accepted; under chunked prefill
    some verify rows rode a mixed step."""
    r = _run_pair(preset, mode)
    got, want = dataclasses.asdict(r["stats"]), dataclasses.asdict(r["jstats"])
    assert got == want
    assert got["verify_steps"] > 0 and got["accepted"] > 0
    assert got["rolled_back"] == got["drafted"] - got["accepted"]
    assert r["timing"]["verify_steps"] == got["verify_steps"]
    if "chunked" in mode or "composed" in mode:
        assert r["timing"]["mixed_verify_steps"] > 0


def _tree_for(ref, context, base_len, limit):
    """A branchy DraftTree whose SECOND branch is the true continuation:
    acceptance must walk off the primary chain and compact its KV."""
    i = len(context) - base_len
    good = ref[i:i + 2]
    if len(good) < 2 or limit < 4:
        return None
    return tsd.DraftTree(tokens=[201, 202, good[0], good[1]], parents=[0, 1, 0, 3])


@pytest.mark.parametrize("pools", ["float32", "int8"])
def test_offpath_tree_acceptance_compacts_kv(pools):
    """(l)/(m) an accepted path off the primary chain: its KV is compacted
    (int8 pages with their scales) before the next step reads it — the
    continued stream equals spec-off, and the counters equal the JAX
    engine's under the same forced trees."""
    ov = ["inference.spec_tree_width=3"] + (["inference.kv_quant=int8"]
                                            if pools == "int8" else [])
    ref = _port(overrides=ov[1:], spec=False).generate([REP], 16)[0]
    engines = [_port(overrides=ov), _jax(overrides=ov)]
    for eng, cls in zip(engines, (tsd.DraftTree, jsd.DraftTree)):
        def forced(rid, context, limit, extra_sources=(), _cls=cls):
            t = _tree_for(ref, context, len(REP), limit)
            return None if t is None else _cls(tokens=t.tokens, parents=t.parents)
        eng._spec.propose_tree = forced
    outs = [eng.generate([REP], 16)[0] for eng in engines]
    assert outs[0] == ref and outs[1] == ref
    st, jst = engines[0].spec_stats, engines[1].spec_stats
    assert st.compactions > 0 and st.compacted_tokens > 0
    assert dataclasses.asdict(st) == dataclasses.asdict(jst)
    engines[0].assert_page_accounting()


def test_sampled_tree_engine_top1_matches_spec_off():
    """Sampled serving (temperature 0.9, top_k 1: the target is one token)
    through the sampled tree walk equals spec-off, and drafts are
    accepted."""
    sam = ["inference.temperature=0.9", "inference.top_k=1"]
    a = _port(overrides=sam + ["inference.spec_tree_width=3"], seed=5)
    b = _port(overrides=sam, spec=False, seed=5)
    assert a.generate(MIX, 40) == b.generate(MIX, 40)
    assert a.spec_stats.accepted > 0


# -- (n) EOS mid-acceptance and the context edge -------------------------------


def test_eos_mid_acceptance():
    """(n) an EOS inside an accepted draft run ends the request at the EOS
    exactly as decoding without speculation does, as in the JAX engine."""
    free = _port(spec=False).generate([REP], 20)[0]
    eos = free[6]
    ref = _port(spec=False, eos_id=eos).generate([REP], 20)
    assert _port(eos_id=eos).generate([REP], 20) == ref
    assert _jax(eos_id=eos).generate([REP], 20) == ref
    assert ref[0][-1] == eos and len(ref[0]) < 20


def test_drafts_capped_at_context_edge():
    """(n) a request decoding to max_seq_len: drafts are capped at
    max_seq_len - 1 - cursor (the cap is reached), the stream ends at the
    context edge, equal to spec-off's and the JAX engine's."""
    ref = _port(spec=False).generate([REP], 200)
    eng = _port()
    limits = []
    propose = eng._spec.propose

    def recording(rid, context, limit, extra_sources=()):
        limits.append((len(context), limit))
        return propose(rid, context, limit, extra_sources)

    eng._spec.propose = recording
    got = eng.generate([REP], 200)
    # The last token is sampled at position 127 and ends the request.
    assert got == ref and len(REP) + len(got[0]) == 128 + 1
    assert got == _jax().generate([REP], 200)
    # The last proposals near the edge were capped below speculate_tokens.
    edge = [lim for n, lim in limits if n >= 128 - 4]
    assert edge and min(edge) < 4 and all(n - 1 + lim <= 127 for n, lim in limits)


# -- (o) preemption of a speculating slot --------------------------------------


@pytest.mark.parametrize("tree", [False, True])
def test_preemption_of_speculating_slot(tree):
    """(o) pool pressure (10 pages) preempts requests while speculation is
    in flight, once from inside a verify step's own page provisioning:
    every request still produces its solo spec-off stream, the page
    accounting holds after EVERY step, and after every verify step the
    live slots hold exactly their cursor-covering pages (the footprint of
    a spec-off window=1 step; a step that fell back to the plain window
    keeps the verify width's pages, as in the JAX engine); at drain every
    page comes back."""
    ov = ["inference.num_pages=10", "inference.prefix_cache=true"]
    ov_t = ov + (["inference.spec_tree_width=3"] if tree else [])
    prompts = [[(i * 7) % 250 + 1 for i in range(16)],
               [(i * 11) % 250 + 1 for i in range(16)],
               [7, 8, 9] * 5 + [7]]
    singles = [_port(overrides=ov, spec=False).generate([p], 60)[0] for p in prompts]
    eng = _port(overrides=ov_t)
    in_verify, by_verify = [False], []
    preempt, verify_all = eng._preempt, eng._verify_all

    def recording_preempt(req):
        by_verify.append(in_verify[0])
        return preempt(req)

    def recording_verify(drafts):
        in_verify[0] = True
        try:
            return verify_all(drafts)
        finally:
            in_verify[0] = False

    eng._preempt, eng._verify_all = recording_preempt, recording_verify
    rids = [eng.submit(p, 60) for p in prompts]
    out = {}
    while eng.has_work():
        verified = eng.spec_stats.verify_steps
        for r in eng.step():
            out[r.rid] = r.generated
        eng.assert_page_accounting()
        for r in eng.slots:
            if r is not None and not r.done:
                cursor = int(eng.seq_lens[r.slot])
                cover = (cursor - 1) // eng.psz + 1
                if eng.spec_stats.verify_steps > verified:
                    assert len(r.pages) == cover
                else:
                    assert cover <= len(r.pages) <= (cursor + 4) // eng.psz + 1
    assert [out[rid] for rid in rids] == singles
    assert eng.preemptions >= 2 and any(by_verify) and eng.spec_stats.accepted > 0
    eng.clear_prefix_cache()
    assert eng.alloc.free_pages == 10 - 1


# -- (p) the draft-density gate --------------------------------------------------


def test_draft_density_gate():
    """(p) spec_min_draft_slots=3: steps where fewer slots drafted run the
    plain window (counted as gated) and the stream is unchanged; a lone
    drafting request still verifies (the threshold clamps to the live
    slots) and is never gated."""
    news = (40, 40, 12)     # the third request leaves early

    def serve(eng):
        rids = [eng.submit(p, n) for p, n in zip(MIX, news)]
        out = {}
        while eng.has_work():
            for r in eng.step():
                out[r.rid] = r.generated
        return [out[rid] for rid in rids]

    eng = _port(overrides=["inference.spec_min_draft_slots=3"])
    assert serve(eng) == serve(_port(spec=False))
    t = eng.reset_timing()
    assert t["spec_gated_steps"] > 0 and t["verify_steps"] > 0, t
    assert eng.reset_timing()["spec_gated_steps"] == 0          # drained
    solo = _port(overrides=["inference.spec_min_draft_slots=3"])
    assert solo.generate([REP], 40) == _port(spec=False).generate([REP], 40)
    ts = solo.reset_timing()
    assert ts["verify_steps"] > 0 and ts["spec_gated_steps"] == 0, ts


# -- (q) validation ---------------------------------------------------------------


@pytest.mark.parametrize("overrides,match", [
    (["inference.spec_min_draft_slots=0"], "spec_min_draft_slots"),
    (["inference.spec_tree_width=8"], "spec_tree_width"),
    (["inference.speculate_tokens=40", "inference.spec_tree_width=2"], "31"),
    (["inference.speculate_tokens=0"], "speculate_tokens"),
    (["inference.spec_ngram_min=3", "inference.spec_ngram_max=2"], "spec_ngram"),
    (["inference.speculate_tokens=1000"], "speculate_tokens"),
])
def test_validation_errors(overrides, match):
    """(q) each bad knob fails at construction with its name: the gate's
    threshold, a tree wider than its node budget, tree columns past the
    int32 words, no drafts, an empty n-gram range, and a verify width
    K10's block cannot hold."""
    with pytest.raises(ValueError, match=match):
        _port(overrides=overrides)


def test_wide_chain_is_legal_and_defaults_off():
    """A chain of 40 drafts fits K10 at tiny-llama's width (no int32 words
    on the chain), and speculation is off by default."""
    assert _port(overrides=["inference.speculate_tokens=40"])._spec is not None
    eng = _port(spec=False)
    assert eng._spec is None and "spec_drafted" not in eng.reset_timing()
