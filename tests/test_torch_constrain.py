"""Grammar-constrained decoding in the port (``orion_tpu_torch``), on the
CPU, against the JAX package (``tests/test_constrain.py`` case by case).

- The compiler (``orion_tpu_torch/constrain``, a copy of the JAX package's
  pure-Python frontends): the same source, token-DFA tables equal bit for
  bit over the JAX suite's patterns and schemas (its randomized schemas
  too, drawn from the same ``random.Random(16)`` stream), and the same
  ``ConstraintError`` text for the same bad inputs.
- The samplers with ``legal_mask``: greedy tokens and forced single-legal
  rows equal, ``filter_logits`` within 1e-6, the same ``AllMaskedRows``
  slots, and ``legal_mask=None`` bitwise the call without the argument.
  Sampled rows draw from a ``torch.Generator``, not ``jax.random``, so
  they are held by ``filter_logits``' distribution only.
- The engine against the JAX engine on seed-0 tiny-llama (weights by
  ``from_jax_params``), f32: greedy streams, typed outcomes, the step each
  request surfaced at, every ``ConstraintStats`` counter but the two times
  (``compile_s``, ``advance_s``), the robustness counters and the page
  allocator's free list and refcounts are equal, with no tolerance. The
  JAX engine at kernels="xla" prefills a burst in one dispatch per prompt
  bucket, the port (as the JAX engine on its Pallas path) in one dispatch,
  and ``constrain_masked_steps`` counts masked dispatches: where counters
  are compared, each burst's prompts share one bucket (at most 16 tokens).
- The CLI's ``--regex`` / ``--json-schema`` validation.
"""

import inspect
import json
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import orion_tpu.constrain as jc
import orion_tpu.constrain.dfa as jc_dfa
import orion_tpu.constrain.regex as jc_regex
import orion_tpu.constrain.schema as jc_schema
import orion_tpu.infer.sampling as js
import orion_tpu_torch.constrain as tc
import orion_tpu_torch.constrain.dfa as tc_dfa
import orion_tpu_torch.constrain.regex as tc_regex
import orion_tpu_torch.constrain.schema as tc_schema
import orion_tpu_torch.infer.sampling as ts
from orion_tpu.config import get_config as j_get_config
from orion_tpu.infer import InferenceEngine as JEngine
from orion_tpu.models import init_params as j_init_params
from orion_tpu.runtime import fault as j_fault
from orion_tpu_torch.config import get_config
from orion_tpu_torch.infer import InferenceEngine
from orion_tpu_torch.metrics import ConstraintStats, RobustnessStats
from orion_tpu_torch.models import from_jax_params
from orion_tpu_torch.runtime import fault as t_fault
from tests import torch_threads  # noqa: F401  (one intra-op thread)

INFER = [
    "inference.max_seq_len=128", "inference.page_size=16",
    "inference.num_pages=32", "inference.max_batch_size=4",
    "inference.prefill_chunk=16", "inference.decode_window=1",
]
SPEC = ["inference.speculative=true", "inference.speculate_tokens=4"]
CON = ["inference.constrained=true"]
CHUNKED = ["inference.chunked_prefill=true", "inference.prefill_chunk_tokens=16"]
REP = [7, 8, 9, 7, 8, 9, 7, 8, 9, 7, 8]
MIX = [REP, [5, 3, 9, 250, 17], list(range(2, 32))]

FORCED = ("regex", r'\{"key": "val", "n": [0-9]{2}\}')
AMBIGUOUS = ("regex", r"(abc|xyz|pqr)[0-9]{2}")
# Every ConstraintStats counter but the two host times.
COUNTERS = tuple(k for k in ConstraintStats().as_timing()
                 if k not in ("constrain_compile_s", "constrain_advance_s"))
ROBUST = tuple(RobustnessStats().as_timing())
SIDES = {"jax": (jc, j_fault), "torch": (tc, t_fault)}


# -- the JAX suite's patterns and schemas -------------------------------------

LEAF = [
    {"type": "boolean"}, {"type": "integer"}, {"type": "null"},
    {"enum": ["hi", -3, True]},
    {"type": "string", "maxLength": 3},
    {"type": "array", "items": {"type": "boolean"}, "maxItems": 2},
]


def _random_rounds():
    """The two rounds of test_greedy_constrained_always_fsm_valid_random_
    schemas: (four JSON-schema texts, four prompts) each, drawn from
    random.Random(16) in that test's order."""
    r = random.Random(16)
    rounds = []
    for _ in range(2):
        schemas = []
        for _ in range(4):
            props = {f"k{j}": r.choice(LEAF) for j in range(r.randint(1, 3))}
            schemas.append(json.dumps({"type": "object", "properties": props}))
        prompts = [[r.randrange(1, 256) for _ in range(5)] for _ in range(4)]
        rounds.append((schemas, prompts))
    return rounds


RANDOM_ROUNDS = _random_rounds()
REGEXES = [
    r"(ab|cd)+e?", r'\{"n": -?[0-9]{1,3}\}', "a(b|c)", "ab", FORCED[1],
    AMBIGUOUS[1], "[0-9]+", "(true|false)",
]
SCHEMAS = [
    {"type": "object", "properties": {"ok": {"type": "boolean"},
                                      "n": {"type": "integer"}}},
    {"enum": ["a", 3, None]},
    {"type": "array", "items": {"type": "integer"}, "maxItems": 2},
    {"type": "null"}, {"type": "boolean"},
] + [json.loads(s) for schemas, _ in RANDOM_ROUNDS for s in schemas]
CASES = ([("regex", p, 256) for p in REGEXES] + [("regex", "[0-9]x", 64)]
         + [("json_schema", json.dumps(s), 256) for s in SCHEMAS])


def _spec(mod, kind_text):
    """A ConstraintSpec of the package ``mod`` (each engine type-checks
    against its own class); None passes through."""
    if kind_text is None:
        return None
    kind, text = kind_text
    return mod.ConstraintSpec(**{kind: text})


# -- the compiler ---------------------------------------------------------------


@pytest.mark.parametrize("jmod,tmod", [
    (jc, tc), (jc_dfa, tc_dfa), (jc_regex, tc_regex), (jc_schema, tc_schema)],
    ids=["init", "dfa", "regex", "schema"])
def test_constrain_copy_matches_jax_source(jmod, tmod):
    """The port's modules are the JAX package's, imports repointed."""
    jsrc = inspect.getsource(jmod).replace("orion_tpu.constrain", "PKG")
    tsrc = inspect.getsource(tmod).replace("orion_tpu_torch.constrain", "PKG")
    if jmod is jc:   # the package docstrings differ in their first line
        jsrc, tsrc = jsrc.split("\n", 1)[1], tsrc.split("\n", 1)[1]
    assert tsrc == jsrc
    assert "from orion_tpu." not in inspect.getsource(tmod)


@pytest.mark.parametrize("kind,text,vocab", CASES,
                         ids=[f"{k}{i}" for i, (k, _, _) in enumerate(CASES)])
def test_token_dfa_tables_equal_jax(kind, text, vocab):
    jd, _ = jc.compile_token_dfa(_spec(jc, (kind, text)).pattern(), vocab)
    td, _ = tc.compile_token_dfa(_spec(tc, (kind, text)).pattern(), vocab)
    for name in ("next_state", "accepting", "legal", "legal_count", "only_token"):
        a, b = getattr(td, name), getattr(jd, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert (td.start, td.pattern_sha) == (jd.start, jd.pattern_sha)


BAD = [
    ("compile_regex", ("(ab",), {}),
    ("compile_regex", ("a)",), {}),
    ("compile_regex", ("[0-9]{100}",), {"max_states": 8}),
    ("schema_to_regex", ({"$ref": "#/defs/x"},), {}),
    ("schema_to_regex", ({"type": "object"},), {}),
    ("schema_to_regex", ({"enum": []},), {}),
    ("schema_to_regex", ("{not json",), {}),
    ("ConstraintSpec", (), {}),
    ("ConstraintSpec", (), {"regex": "a", "json_schema": '{"type": "null"}'}),
    ("ConstraintSpec", (), {"regex": ""}),
]


@pytest.mark.parametrize("fn,args,kw", BAD, ids=[f"bad{i}" for i in range(len(BAD))])
def test_constraint_errors_match_jax(fn, args, kw):
    msgs = []
    for mod in (jc, tc):
        with pytest.raises(mod.ConstraintError) as ei:
            getattr(mod, fn)(*args, **kw)
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]


def test_unserveable_constraint_and_memo_cache_match_jax():
    """A dead start state is refused with the same text; the memo cache
    keys on (sha256(pattern), vocab, max_states) with the LRU bound."""
    msgs = []
    for mod in (jc, tc):
        with pytest.raises(mod.ConstraintError) as ei:
            mod.compile_constraint(mod.ConstraintSpec(regex="xyz"), 64)
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]
    tc.cache_clear()
    hits = [tc.compile_token_dfa(p, 256, cache_size=2)[1]
            for p in ("ab", "ab", "cd", "ef", "ab", "ab")]
    assert hits == [False, True, False, False, False, True]
    assert tc.compile_token_dfa("ab", 256, max_states=64)[1] is False


def test_constraint_state_walk_matches_jax():
    """ConstraintState's walk over the JAX suite's unit patterns: masks,
    choices, forced runs, branch tokens, peek/walk/sync and the terminal
    classification, state for state."""
    for pattern, vocab, eos, toks in [
        ("a(b|c)", 256, None, b"ac"), ("ab", 256, 0, b"ab\x00"),
        ("[0-9]x", 64, None, b"0"), (FORCED[1], 256, 255, b'{"key": "val", "n": 42}'),
        (AMBIGUOUS[1], 256, None, b"xyz1"),
    ]:
        states = []
        for mod in (jc, tc):
            dfa, _ = mod.compile_token_dfa(pattern, vocab)
            c = mod.ConstraintState(dfa, eos)
            trace = []
            for t in toks:
                trace.append((c.state, c.mask_row().tolist(), c.mask_choices(),
                              c.forced_run(5), c.branch_tokens(3), c.peek(t),
                              c.walk(list(toks)), c.is_complete(), c.is_dead()))
                c.advance(t)
            trace.append((c.state, c.is_complete(), c.is_dead(), c.n_advanced,
                          c.sync(list(toks[:-1])), c.state, c.sync([ord("q")])))
            states.append(trace)
        assert states[0] == states[1], pattern


# -- the samplers -----------------------------------------------------------------


def _logits_and_mask(seed, shape):
    """Seeded logits and a legal mask over the last axis whose rows mix
    all-True, single-legal and random supports."""
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal(shape).astype(np.float32) * 3
    V = shape[-1]
    rows = logits.reshape(-1, V)
    mask = rng.random(rows.shape) < 0.4
    mask[0] = True
    for i in range(1, rows.shape[0], 3):
        mask[i] = False
        mask[i, rng.integers(V)] = True
    mask[~mask.any(-1), 0] = True
    return logits, mask.reshape(shape)


def test_sample_masked_greedy_and_forced_rows_equal_jax():
    logits, mask = _logits_and_mask(0, (9, 40))
    single = mask.sum(-1) == 1
    jt = np.asarray(js.sample(jnp.asarray(logits), jax.random.key(0), temperature=0.0,
                              legal_mask=jnp.asarray(mask)))
    gen = torch.Generator().manual_seed(0)
    tt = ts.sample(torch.from_numpy(logits), gen, temperature=0.0,
                   legal_mask=torch.from_numpy(mask)).numpy()
    np.testing.assert_array_equal(tt, jt)
    assert mask[np.arange(9), tt].all()
    # Sampled and mixed rows: the forced rows equal JAX's; every token is legal.
    temp = np.where(np.arange(9) % 2, 0.8, 0.0).astype(np.float32)
    for kw in (dict(temperature=1.0), dict(temperature=0.7, top_k=3, top_p=0.9),
               dict(temperature=temp, top_k=np.full(9, 5, np.int32),
                    top_p=np.full(9, 0.8, np.float32))):
        jkw = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
        tkw = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
               for k, v in kw.items()}
        jt = np.asarray(js.sample(jnp.asarray(logits), jax.random.key(1),
                                  legal_mask=jnp.asarray(mask), **jkw))
        tt = ts.sample(torch.from_numpy(logits), gen, legal_mask=torch.from_numpy(mask),
                       **tkw).numpy()
        np.testing.assert_array_equal(tt[single], jt[single])
        assert mask[np.arange(9), tt].all()
        greedy = (np.broadcast_to(np.asarray(kw["temperature"]), (9,)) <= 0) & ~single
        np.testing.assert_array_equal(tt[greedy], jt[greedy])


@pytest.mark.parametrize("top_k,top_p", [(0, 1.0), (5, 1.0), (0, 0.8), (50, 0.9)])
def test_filter_logits_masked_matches_jax(top_k, top_p):
    """The mask applies first: the filtered distributions agree within
    1e-6 (top-k beyond the legal count keeps every legal token)."""
    logits, mask = _logits_and_mask(1, (9, 64))
    temp = np.linspace(0.0, 1.5, 9).astype(np.float32)
    tk = np.full(9, top_k, np.int32)
    tp = np.full(9, top_p, np.float32)
    flags = dict(no_topk=top_k == 0, no_topp=top_p >= 1.0)
    jf = np.asarray(js.filter_logits(jnp.asarray(logits), jnp.asarray(temp), jnp.asarray(tk),
                                     jnp.asarray(tp), legal_mask=jnp.asarray(mask), **flags))
    tf = ts.filter_logits(torch.from_numpy(logits), torch.from_numpy(temp),
                          torch.from_numpy(tk), torch.from_numpy(tp),
                          legal_mask=torch.from_numpy(mask), **flags).numpy()
    np.testing.assert_allclose(tf, jf, rtol=1e-6, atol=1e-6)
    assert (tf[~mask] <= ts.NEG_INF / temp.max()).all()   # NEG_INF, scaled
    probs = torch.softmax(torch.from_numpy(tf), -1).numpy()
    jprobs = np.asarray(jax.nn.softmax(jnp.asarray(jf), -1))
    np.testing.assert_allclose(probs, jprobs, rtol=1e-6, atol=1e-6)


def test_check_legal_mask_names_the_same_slots():
    for shape, dead in [((5, 16), [1, 4]), ((2, 3, 16), [(1, 0), (0, 2)])]:
        m = np.ones(shape, bool)
        for d in dead:
            m[d] = False
        slots = []
        for mod in (js, ts):
            with pytest.raises(mod.AllMaskedRows) as ei:
                mod.check_legal_mask(m)
            slots.append(ei.value.slots)
        assert slots[0] == slots[1]
    ts.check_legal_mask(np.ones((2, 16), bool))


def test_legal_mask_none_is_bitwise_the_unmasked_call():
    logits, _ = _logits_and_mask(2, (6, 32))
    lt = torch.from_numpy(logits)
    temp = torch.full((6,), 0.9)
    tk = torch.full((6,), 4, dtype=torch.int32)
    tp = torch.full((6,), 0.9)
    for kw in (dict(temperature=0.0), dict(temperature=0.8),
               dict(temperature=temp, top_k=tk, top_p=tp)):
        a = ts.sample(lt, torch.Generator().manual_seed(3), **kw)
        b = ts.sample(lt, torch.Generator().manual_seed(3), legal_mask=None, **kw)
        assert torch.equal(a, b)
    assert torch.equal(ts.filter_logits(lt, temp, tk, tp),
                       ts.filter_logits(lt, temp, tk, tp, legal_mask=None))
    l3 = lt.reshape(2, 3, 32)
    dn = torch.tensor([[3, 5, -1], [7, -1, -1]])
    for kw in (dict(temperature=0.0), dict(temperature=0.8, top_k=4)):
        a = ts.spec_verify_sample(l3, dn, torch.Generator().manual_seed(4), **kw)
        b = ts.spec_verify_sample(l3, dn, torch.Generator().manual_seed(4),
                                  legal_mask=None, **kw)
        assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_masked_verifiers_greedy_equal_jax():
    """Chain and tree verdicts under [B, W, V] masks equal JAX's; a forced
    draft (single legal token at its parent) is always accepted, sampled
    rows included."""
    B, W, V = 3, 4, 24
    logits, mask = _logits_and_mask(5, (B, W, V))
    rng = np.random.default_rng(6)
    tokens = rng.integers(0, V, (B, W)).astype(np.int32)
    lens = np.array([4, 2, 3], np.int32)
    # Column j + 1 drafts the forced token of column j's mask where single.
    for b in range(B):
        for j in range(W - 1):
            if mask[b, j].sum() == 1:
                tokens[b, j + 1] = int(np.flatnonzero(mask[b, j])[0])
    dn = np.where(np.arange(W)[None] + 1 < lens[:, None],
                  np.concatenate([tokens[:, 1:], np.full((B, 1), -1, np.int32)], 1), -1)
    ja, jalt = js.spec_verify_sample(jnp.asarray(logits), jnp.asarray(dn), jax.random.key(0),
                                     legal_mask=jnp.asarray(mask))
    ta, talt = ts.spec_verify_sample(torch.from_numpy(logits), torch.from_numpy(dn),
                                     torch.Generator(), legal_mask=torch.from_numpy(mask))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(talt.numpy(), np.asarray(jalt))
    forced = (mask.sum(-1) == 1) & (dn >= 0)
    sa, _ = ts.spec_verify_sample(torch.from_numpy(logits), torch.from_numpy(dn),
                                  torch.Generator().manual_seed(1), temperature=1.0,
                                  legal_mask=torch.from_numpy(mask))
    assert sa.numpy()[forced].all()
    parents = np.array([[0, 0, 0, 1], [0, 0, 1, 2], [0, 0, 1, 1]], np.int32)
    jt = js.spec_verify_sample_tree(jnp.asarray(logits), jnp.asarray(tokens),
                                    jnp.asarray(parents), jnp.asarray(lens),
                                    jax.random.key(0), legal_mask=jnp.asarray(mask))
    tt = ts.spec_verify_sample_tree(torch.from_numpy(logits), torch.from_numpy(tokens),
                                    torch.from_numpy(parents), torch.from_numpy(lens),
                                    torch.Generator(), legal_mask=torch.from_numpy(mask))
    for a, b in zip(tt, jt):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# -- the engine against the JAX engine ------------------------------------------


@pytest.fixture(scope="module")
def tiny():
    """JAX and port weights of seed-0 tiny-llama, at vocab 256 and 64."""
    out = {}
    for vocab in (256, 64):
        ov = INFER + [f"model.vocab_size={vocab}"]
        jp = j_init_params(j_get_config("tiny-llama", ov).model, jax.random.key(0))
        tp = from_jax_params(jax.tree.map(np.asarray, jp), get_config("tiny-llama", ov).model)
        out[vocab] = {"jax": jp, "torch": tp}
    return out


def _engine(tiny, side, extra, faults=(), vocab=256):
    mod = SIDES[side][1]
    inj = mod.FaultInjector([mod.FaultSpec(*f) for f in faults]) if faults else None
    ov = INFER + [f"model.vocab_size={vocab}"] + list(extra)
    if side == "jax":
        return JEngine(j_get_config("tiny-llama", ov), tiny[vocab]["jax"],
                       fault_injector=inj)
    return InferenceEngine(get_config("tiny-llama", ov), tiny[vocab]["torch"],
                           device="cpu", fault_injector=inj)


def _serve(eng, side, prompts, max_new, specs):
    """Submit with the side's ConstraintSpec and step until idle: per
    request (outcome, tokens, the step it surfaced at), in submit order."""
    cmod = SIDES[side][0]
    reqs = [eng.submit_request(p, max_new, constraint=_spec(cmod, s))
            for p, s in zip(prompts, specs)]
    surfaced = {}
    while eng.has_work():
        n = eng.step_no
        for r in eng.step():
            surfaced[r.rid] = n
    return [(r.outcome, list(r.generated), surfaced[r.rid]) for r in reqs]


def _both(tiny, extra, drive, faults=(), vocab=256):
    """``drive(eng, side)`` on the JAX and the port engine; the results,
    the constraint and robustness counters, and the allocator's state must
    be equal. Returns the port's result and counters."""
    out = {}
    for side in ("jax", "torch"):
        SIDES[side][0].cache_clear()   # compile hits start from an empty memo
        eng = _engine(tiny, side, extra, faults, vocab)
        res = drive(eng, side)
        t = eng.reset_timing()
        counters = {k: t.get(k) for k in COUNTERS + ROBUST}
        alloc = (sorted(eng.alloc._free), list(eng.alloc._refs))
        out[side] = (res, counters, alloc)
    assert out["torch"] == out["jax"]
    return out["torch"][:2]


def _check_legal(results, specs, max_new, vocab=256):
    """Every constrained stream re-walks legally under a fresh compile;
    one that completed short of its token budget (by the grammar) ends in
    an accepting state."""
    for (outcome, toks, _), s in zip(results, specs):
        if s is None:
            continue
        dfa, _ = tc.compile_constraint(_spec(tc, s), vocab)
        c = tc.ConstraintState(dfa)
        assert c.sync(toks), (s, toks)
        if outcome == "completed" and len(toks) < max_new:
            assert dfa.accepting[c.state], (s, toks)


@pytest.mark.parametrize("extra", [SPEC, SPEC + CHUNKED], ids=["verify", "mixed_verify"])
def test_constrained_off_byte_identity(tiny, extra):
    """constrained=true with no constraint is the constrained=false engine
    (and the JAX engine), on the verify and the mixed verify path, and
    builds no mask."""
    def drive(eng, side):
        return eng.generate(MIX, 24)

    on, t = _both(tiny, extra + CON, drive)
    off = _engine(tiny, "torch", extra).generate(MIX, 24)
    assert on == off
    assert t["constrain_masked_steps"] == 0 and t["constrain_requests"] == 0


def test_constraint_needs_flag_and_type(tiny):
    for side in ("jax", "torch"):
        cmod = SIDES[side][0]
        eng = _engine(tiny, side, SPEC)
        with pytest.raises(ValueError, match="inference.constrained"):
            eng.submit_request(REP, 8, constraint=cmod.ConstraintSpec(regex="ab"))
        eng2 = _engine(tiny, side, CON)
        with pytest.raises(ValueError, match="ConstraintSpec"):
            eng2.submit_request(REP, 8, constraint="[0-9]+")


@pytest.mark.parametrize("extra", [
    SPEC + CON, CON,
    SPEC + CON + CHUNKED + ["inference.kv_quant=int8", "inference.prefix_cache=true",
                            "inference.spec_tree_width=2"]],
    ids=["spec", "constrained_only", "tree_int8_chunked_prefix"])
def test_random_schemas_four_grammars_in_one_batch(tiny, extra):
    """Both rounds of the JAX suite's randomized schemas, four grammars in
    one batch, on one engine; every stream legal, every request completed."""
    def drive(eng, side):
        return [_serve(eng, side, prompts, 24, [("json_schema", s) for s in schemas])
                for schemas, prompts in RANDOM_ROUNDS]

    rounds, t = _both(tiny, extra, drive)
    for res, (schemas, _) in zip(rounds, RANDOM_ROUNDS):
        assert [o for o, _, _ in res] == ["completed"] * 4
        _check_legal(res, [("json_schema", s) for s in schemas], 24)
    assert t["constrain_requests"] == 8 and t["constrain_masked_rows"] > 0
    assert t["constrain_dead_ends"] == 0


@pytest.mark.parametrize("extra", [SPEC + CON, CON + CHUNKED],
                         ids=["spec", "constrained_only_chunked"])
def test_forced_runs_free_drafts_and_completion(tiny, extra):
    def drive(eng, side):
        return _serve(eng, side, [REP, [5, 3, 9, 250, 17]], 48, [FORCED, None])

    res, t = _both(tiny, extra, drive)
    text = bytes(res[0][1]).decode()
    assert res[0][0] == "completed" and len(text) == 23
    assert text.startswith('{"key": "val", "n": ') and text.endswith("}")
    assert t["constrain_forced_drafted"] > 0
    assert t["constrain_forced_accepted"] == t["constrain_forced_drafted"]
    assert t["constrain_completed"] == 1


def test_forced_run_rollback_window1_footprint(tiny):
    """Mid-run every live slot holds exactly its cursor's pages; streams and
    the allocator's final state equal the speculate_tokens=1 engine's and
    the JAX engine's."""
    prompts, specs = [REP, list(range(2, 16))], [FORCED, FORCED]

    def drive(eng, side):
        cmod = SIDES[side][0]
        reqs = [eng.submit_request(p, 32, constraint=_spec(cmod, s))
                for p, s in zip(prompts, specs)]
        while eng.has_work():
            eng.step()
            for r in eng.slots:
                if r is not None and not r.done:
                    assert len(r.pages) == (int(eng.seq_lens[r.slot]) - 1) // eng.psz + 1
        return [list(r.generated) for r in reqs]

    res, _ = _both(tiny, SPEC + CON, drive)
    ref = _engine(tiny, "torch", CON + ["inference.speculative=true",
                                        "inference.speculate_tokens=1"])
    assert drive(ref, "torch") == res
    eng = _engine(tiny, "torch", SPEC + CON)
    drive(eng, "torch")
    assert sorted(eng.alloc._free) == sorted(ref.alloc._free)
    assert eng.alloc._refs == ref.alloc._refs


def test_tree_branches_at_fsm_ambiguity(tiny):
    def drive(eng, side):
        return _serve(eng, side, [REP, [5, 3, 9, 250, 17]], 16, [AMBIGUOUS, AMBIGUOUS])

    res, t = _both(tiny, SPEC + CON + ["inference.spec_tree_width=3"], drive)
    assert t["constrain_branch_points"] > 0 and t["constrain_forced_accepted"] > 0
    chain = _engine(tiny, "torch", SPEC + CON)
    assert [g for _, g, _ in _serve(chain, "torch", [REP, [5, 3, 9, 250, 17]], 16,
                                    [AMBIGUOUS, AMBIGUOUS])] == [g for _, g, _ in res]
    for _, g, _ in res:
        assert bytes(g[:3]).decode() in ("abc", "xyz", "pqr")


def test_dead_end_quarantine_neighbors_unaffected(tiny):
    """vocab 64 spells digits but not 'x': the walk dead-ends, typed, and
    the unconstrained neighbour's stream equals its solo run."""
    def drive(eng, side):
        cmod = SIDES[side][0]
        with pytest.raises(cmod.ConstraintError, match="first"):
            eng.submit_request([1, 2, 3], 8, constraint=cmod.ConstraintSpec(regex="xyz"))
        return _serve(eng, side, [[1, 2, 3], [5, 6, 7]], 8, [("regex", "[0-9]x"), None])

    res, t = _both(tiny, SPEC + CON, drive, vocab=64)
    assert res[0][0] == "error:constraint_dead_end" and len(res[0][1]) == 1
    assert res[1][0] == "completed"
    assert t["constrain_dead_ends"] == 1 and t["quarantined_requests"] == 1
    solo = _serve(_engine(tiny, "torch", SPEC + CON, vocab=64), "torch", [[5, 6, 7]], 8, [None])
    assert res[1][1] == solo[0][1]


@pytest.mark.parametrize("extra", [SPEC + CON, CON], ids=["spec", "constrained_only"])
def test_nan_fault_on_constrained_slot(tiny, extra):
    """A NaN poisoned into the constrained request's pages surfaces as
    "error:nan" at the JAX engine's step (the guard reads the logits
    before the mask); its neighbours complete."""
    def drive(eng, side):
        return _serve(eng, side, [list(range(2, 16)), REP, [5, 3, 9, 250, 17]], 32,
                      [("regex", "[a-z]{40}"), None, FORCED])

    res, t = _both(tiny, extra + ["inference.nan_guard=true"], drive,
                   faults=[("nan", 2, None, 0)])
    assert res[0][0] == "error:nan" and res[0][2] == 2
    assert [o for o, _, _ in res[1:]] == ["completed", "completed"]
    assert t["quarantined_requests"] == 1


# -- the CLI ------------------------------------------------------------------------


def test_generate_cli_constraint_validation(tmp_path, capsys):
    from orion_tpu_torch import generate

    with pytest.raises(SystemExit, match="mutually exclusive"):
        generate.main(["--regex", "ab", "--json-schema", "s.json", "--device", "cpu"])
    with pytest.raises(SystemExit, match="invalid constraint"):
        generate.main(["--regex", "(ab", "--device", "cpu"])
    with pytest.raises(SystemExit, match="json-schema"):
        generate.main(["--json-schema", str(tmp_path / "missing.json"), "--device", "cpu"])
    bad = tmp_path / "bad.json"
    bad.write_text('{"$ref": "#/x"}')
    with pytest.raises(SystemExit, match="invalid constraint"):
        generate.main(["--json-schema", str(bad), "--device", "cpu"])
    schema = tmp_path / "s.json"
    schema.write_text(json.dumps(SCHEMAS[0]))
    capsys.readouterr()
    assert generate.main(["--json-schema", str(schema), "--device", "cpu",
                          "--tokens", "5,3,9", "--max-new-tokens", "32"] + INFER) == 0
    (line,) = capsys.readouterr().out.strip().splitlines()
    out = json.loads(line)
    assert out["outcome"] == "completed"
    _check_legal([(out["outcome"], out["generated"], 0)],
                 [("json_schema", json.dumps(SCHEMAS[0]))], 32)
