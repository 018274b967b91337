"""The port's decode-window autotune and dispatch programs on the CPU.

The autotune (``InferenceEngine._autotune_window``, the step's timing
split, ``_provision_window``) is held against the JAX engine: the same
decisions, window by window, and greedy streams equal with no tolerance.
The dispatch programs' keys and the launch credit of a replay are checked
in pure Python (CUDA graphs themselves run only on the card:
``chip_smoke.py --phases device,build,serve_graphs``).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from orion_tpu.config import get_config as j_get_config
from orion_tpu.infer import InferenceEngine as JEngine
from orion_tpu.models import init_params as j_init_params
from orion_tpu_torch import ops
from orion_tpu_torch.config import get_config
from orion_tpu_torch.constrain import ConstraintSpec
from orion_tpu_torch.infer import InferenceEngine
from orion_tpu_torch.infer.executor import DispatchExecutor, program_key
from orion_tpu_torch.infer.sampling import _categorical
from orion_tpu_torch.models import from_jax_params
from orion_tpu_torch.ops import common
from tests import torch_threads  # noqa: F401  (one intra-op thread)

INFER_OVERRIDES = [
    "inference.max_seq_len=128", "inference.page_size=16",
    "inference.num_pages=32", "inference.max_batch_size=4",
    "inference.prefill_chunk=16", "inference.max_new_tokens=8",
]
AUTOTUNE = ["inference.decode_window=2", "inference.decode_window_autotune=true",
            "inference.decode_window_max=16"]
GROW = AUTOTUNE + ["inference.decode_host_share_target=0.0"]
PROMPT = [5, 3, 9, 250, 17]


@pytest.fixture(scope="module")
def weights():
    jcfg = j_get_config("tiny-llama", INFER_OVERRIDES)
    jp = j_init_params(jcfg.model, jax.random.key(0))
    tp = from_jax_params(jax.tree.map(np.asarray, jp), get_config("tiny-llama").model)
    return jp, tp


def _engines(weights, overrides=(), *, jax_engine=True):
    """(JAX engine at kernels=xla or None, the port's engine on the CPU)
    with the same config and weights."""
    jp, tp = weights
    ov = INFER_OVERRIDES + list(overrides)
    port = InferenceEngine(get_config("tiny-llama", ov), tp, device="cpu")
    if not jax_engine:
        return None, port
    jcfg = j_get_config("tiny-llama", ov)
    jcfg = dataclasses.replace(jcfg, model=dataclasses.replace(jcfg.model, kernels="xla"))
    return JEngine(jcfg, jp), port


def _drive(eng, prompt, n):
    """Serve one request step by step: (its tokens, the window after each
    step)."""
    req = eng.submit_request(prompt, n)
    windows = []
    while eng.has_work():
        eng.step()
        windows.append(eng.decode_window)
    return req.generated, windows


# -- the autotune against the JAX engine ------------------------------------


def test_autotune_grows_with_the_jax_engines_windows_and_tokens(weights):
    """Target 0.0 (every evaluated step wants to grow): both engines grow
    on the same steps, and the greedy stream is the fixed window's."""
    jeng, eng = _engines(weights, GROW)
    _, fixed = _engines(weights, jax_engine=False)
    want = fixed.generate([PROMPT], 14)[0]
    j_out, j_windows = _drive(jeng, PROMPT, 14)
    got, windows = _drive(eng, PROMPT, 14)
    assert got == j_out == want
    assert windows == j_windows
    assert 2 < eng.decode_window <= 16
    t = eng.reset_timing()
    assert t["prefill_s"] > 0.0 and t["decode_window"] == eng.decode_window


def _hook_decisions(eng):
    """The shrink / hold / grow / floor sequence of the JAX test, through
    the measured-split hook."""
    out = []
    eng.decode_window = 16
    eng._dev_span, eng._prefill_span = 0.99, 0.0    # host 0.01 < 0.25 / 4: halve
    eng._autotune_window(1.0)
    out.append(eng.decode_window)
    eng._dev_span = 0.9                              # inside [target/4, target]: hold
    eng._autotune_window(1.0)
    out.append(eng.decode_window)
    eng._dev_span = 0.5                              # above the target: grow
    eng._autotune_window(1.0)
    out.append(eng.decode_window)
    eng.decode_window = 2
    eng._dev_span = 0.99                             # the floor is decode_window
    eng._autotune_window(1.0)
    out.append(eng.decode_window)
    eng._dev_span, eng._prefill_span = 0.3, 0.6      # prefill is not host time
    eng._autotune_window(1.0)
    out.append(eng.decode_window)
    out.append(eng.reset_timing()["decode_window"])
    return out


def test_autotune_hook_decisions_equal_the_jax_engines(weights):
    jeng, eng = _engines(weights, AUTOTUNE)
    got = _hook_decisions(eng)
    assert got == _hook_decisions(jeng)
    assert got == [8, 8, 16, 2, 2, 2]


def test_autotune_skips_the_step_after_a_resize(weights):
    """A resize's next decode step carries the new window's capture (JAX:
    its recompile): never two resizes on consecutive steps, on both
    engines alike; the resize itself arms the skip."""
    jeng, eng = _engines(weights, GROW)
    grew = []
    for e in (jeng, eng):
        _, windows = _drive(e, PROMPT, 14)
        w = [2] + windows
        grew.append([a != b for a, b in zip(w, w[1:])])
    assert grew[0] == grew[1]
    assert any(grew[1])
    assert not any(a and b for a, b in zip(grew[1], grew[1][1:]))
    _, fresh = _engines(weights, GROW, jax_engine=False)
    fresh._dev_span, fresh._prefill_span = 0.5, 0.0
    assert not fresh._autotune_skip
    fresh._autotune_window(1.0)
    assert fresh.decode_window == 4 and fresh._autotune_skip


@pytest.mark.parametrize("overrides", [
    [], AUTOTUNE, AUTOTUNE + ["inference.speculative=true"],
    ["inference.speculative=true", "inference.speculate_tokens=6"],
    AUTOTUNE[:1] + AUTOTUNE[1:2] + ["inference.decode_window_max=2"],
], ids=["fixed", "autotune", "autotune_spec", "spec", "autotune_max_eq"])
def test_provision_window_matches_jax(weights, overrides):
    """Admission budgets for decode_window_max under the autotune, so a
    grown window never strands an admitted request."""
    jeng, eng = _engines(weights, overrides)
    assert eng._provision_window == jeng._provision_window
    if eng.icfg.decode_window_autotune:
        assert eng._provision_window >= eng.icfg.decode_window_max
    # The budget reaches admission: the same needs, and worst case at submit.
    assert [eng._admission_need(n)[-1] for n in range(1, 100)] == [
        jeng._admission_need(n)[-1] for n in range(1, 100)]
    assert eng._worst_admission_need(5, 100) == jeng._worst_admission_need(5, 100)


def test_window_max_below_window_raises_as_jax(weights):
    bad = ["inference.decode_window=8", "inference.decode_window_autotune=true",
           "inference.decode_window_max=4"]
    jcfg = j_get_config("tiny-llama", INFER_OVERRIDES + bad)
    msgs = []
    for build in (lambda: _engines(weights, bad, jax_engine=False),
                  lambda: JEngine(jcfg, weights[0])):
        with pytest.raises(ValueError, match="decode_window_max") as e:
            build()
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    # Without the autotune the cap is not read.
    _engines(weights, bad[:1] + bad[2:], jax_engine=False)


# The JAX engine's timing keys that belong to modules the port has not
# ported (migration) or that it does not keep (the decode-waste tally).
JAX_ONLY_KEYS = {"migrate_out_s", "migrate_in_s", "slot_steps", "wasted_steps"}


def test_reset_timing_keys_and_split_match_jax(weights):
    jeng, eng = _engines(weights, ["inference.decode_window=4"])
    prompts = [[5, 3, 9], [250, 17, 4, 8, 100, 42], [7] * 20, [1, 2], [99, 98, 97]]
    assert eng.generate(prompts, 6) == jeng.generate(prompts, 6)
    j, t = jeng.reset_timing(), eng.reset_timing()
    assert set(j) - set(t) == JAX_ONLY_KEYS
    for k in ("device_s", "decode_device_s", "mixed_device_s", "host_s", "prefill_s"):
        assert k in t and isinstance(t[k], float)
    for k in ("windows", "steps", "decode_slot_steps", "decode_window",
              "dispatch_faults", "failed_steps"):
        assert t[k] == j[k], k
    assert t["device_s"] == pytest.approx(t["decode_device_s"] + t["mixed_device_s"])
    assert t["decode_device_s"] >= t["decode_s"] > 0 and t["host_s"] > 0
    assert set(eng.reset_timing()) == set(t)


# -- dispatch programs: keys and launch credit (pure Python) -----------------


def _keys(eng, prompts, n, **submit_kw):
    """Drive ``eng`` on ``prompts`` and return the program key of every
    dispatch it launched, in order."""
    keys = []
    real = eng._executor.launch

    def record(path, fn, tensors, static):
        keys.append(program_key(path, tensors, static))
        return real(path, fn, tensors, static)

    eng._executor.launch = record
    for p in prompts:
        eng.submit(p, n, **submit_kw)
    while eng.has_work():
        eng.step()
    return keys


def _variant_keys(weights, name):
    base = ["inference.decode_window=2"]
    variants = {
        "base": (base, {}),
        "window": (["inference.decode_window=4"], {}),
        "per_slot_sampling": (base, dict(temperature=0.7, top_k=5)),
        "scalar_sampling": (base + ["inference.temperature=0.7"], {}),
        "guard": (base + ["inference.nan_guard=true"], {}),
        "chain": (base + ["inference.speculative=true"], {}),
        "tree": (base + ["inference.speculative=true", "inference.spec_tree_width=2"], {}),
        "constrained": (base + ["inference.constrained=true"],
                        dict(constraint=ConstraintSpec(regex="[a-c]{3,6}"))),
    }
    ov, kw = variants[name]
    _, eng = _engines(weights, ov, jax_engine=False)
    prompts = [[7, 8, 9] * 4, [5, 6] * 5]   # cyclic: both slots draft
    # The path each variant shapes (a speculating engine still runs plain
    # windows, the base's program, when nothing drafts).
    path = "verify" if name in ("chain", "tree", "constrained") else "decode"
    return {k for k in _keys(eng, prompts, 24, **kw) if k[0] == path}


VARIANTS = ["window", "per_slot_sampling", "scalar_sampling", "guard", "chain", "tree",
            "constrained"]


def test_program_keys_distinct_by_variant(weights):
    """W, the sampling variant, the guard, a constraint mask, chain and
    tree each give programs of their own: no key is shared."""
    keys = {v: _variant_keys(weights, v) for v in ["base"] + VARIANTS}
    names = list(keys)
    for i, a in enumerate(names):
        assert keys[a], a
        for b in names[i + 1:]:
            assert not keys[a] & keys[b], (a, b)


@pytest.mark.parametrize("variant", VARIANTS)
def test_program_key_names_its_variant(weights, variant):
    """Each variant's verify or decode keys carry what sets them apart."""
    flat = repr(sorted(map(repr, _variant_keys(weights, variant))))
    marker = {"window": "('n_steps', 4)", "per_slot_sampling": "'temperature', ((4,)",
              "scalar_sampling": "('temperature', 0.7)", "guard": "('nan_guard', True)",
              "chain": "'verify'", "tree": "'tree_mask', ((4, 5)",
              "constrained": "'legal_mask', ((4, 5, 256)"}[variant]
    assert marker in flat


def test_equal_steps_replay_one_program(weights):
    """Every decode window of a steady batch has one key: one graph."""
    _, eng = _engines(weights, ["inference.decode_window=2"], jax_engine=False)
    keys = _keys(eng, [[5, 3, 9], [1, 2, 3, 4]], 8)
    assert len(keys) == eng.timing["windows"] >= 3
    assert len(set(keys)) == 1 and keys[0][0] == "decode"


def test_mixed_step_buckets_are_powers_of_two(weights):
    """Mixed steps key on their row and prefix-walk buckets, both powers
    of two (the walk may be empty), so the programs stay few."""
    _, eng = _engines(weights, ["inference.chunked_prefill=true",
                                "inference.prefill_chunk_tokens=16",
                                "inference.prefix_cache=true"], jax_engine=False)
    prompts = [list(range(1, 40)), list(range(2, 20)), [5, 3, 9], list(range(3, 60))]
    mixed = [k for k in _keys(eng, prompts, 4) if k[0] == "mixed"]
    assert mixed
    shapes = {dict(k[1])["p_tokens"][0] + dict(k[1])["p_prefix_pages"][0][1:] for k in mixed}
    for nb, _s, p_pre in shapes:
        assert nb & (nb - 1) == 0 and (p_pre == 0 or p_pre & (p_pre - 1) == 0)
    # One program per bucket pair, with or without a live decode row.
    assert len(set(mixed)) <= 2 * len(shapes)


def test_program_key_is_shape_and_static_only():
    B = 4
    a = dict(tokens=np.zeros(B, np.int32), page_table=np.zeros((B, 8), np.int32),
             legal_mask=None)
    b = {k: (None if v is None else v + 1) for k, v in a.items()}
    st = dict(n_steps=8, nan_guard=False, temperature=0.0)
    assert program_key("decode", a, st) == program_key("decode", b, dict(reversed(st.items())))
    assert program_key("decode", a, st) != program_key("verify", a, st)
    assert program_key("decode", a, st) != program_key("decode", a, {**st, "n_steps": 16})
    c = dict(a, page_table=np.zeros((B, 9), np.int32))
    assert program_key("decode", a, st) != program_key("decode", c, st)
    d = dict(a, legal_mask=np.ones((B, 5), bool))
    assert program_key("decode", a, st) != program_key("decode", d, st)
    e = dict(a, tokens=np.zeros(B, np.int64))
    assert program_key("decode", a, st) != program_key("decode", e, st)


def test_launch_credit_on_replay():
    """A capture records each wrapper's launches and restores the counts;
    every replay credits them."""
    @common.counted
    def fake_kernel():
        fake_kernel.launches += 1

    @common.counted
    def other_kernel():
        other_kernel.launches += 1

    fake_kernel()
    with common.recording_launches() as rec:
        for _ in range(3):
            fake_kernel()
        other_kernel()
    assert rec == {fake_kernel: 3, other_kernel: 1}
    assert fake_kernel.launches == 1 and other_kernel.launches == 0
    for _ in range(2):
        common.credit_launches(rec)
    assert fake_kernel.launches == 7 and other_kernel.launches == 2
    with pytest.raises(RuntimeError):
        with common.recording_launches() as failed:
            fake_kernel()
            raise RuntimeError("capture failed")
    assert fake_kernel.launches == 7
    common._COUNTED.remove(fake_kernel)
    common._COUNTED.remove(other_kernel)
    # Every kernel wrapper of the port is recorded by a capture.
    assert set(ops.KERNELS.values()) <= set(common._COUNTED)
    assert failed == {fake_kernel: 1}


def test_eager_launch_and_bound_check(weights):
    """On the CPU ``launch`` runs the step eagerly on tensors of the host
    arrays; a graph executor refuses a rebound pool until its programs
    are dropped."""
    _, eng = _engines(weights, jax_engine=False)
    assert not eng._executor.graphs
    assert not InferenceEngine(eng.cfg, weights[1], device="cpu", cuda_graphs=True)._executor.graphs
    out = eng._executor.launch(
        "decode", lambda x, y, k: (x * k, y), dict(x=np.arange(3, dtype=np.int32), y=None),
        dict(k=2))
    assert out[0].tolist() == [0, 2, 4] and out[1] is None
    ex = DispatchExecutor(eng, graphs=True)
    ex._check_bound()
    ex._check_bound()
    eng.cache = {k: v.clone() for k, v in eng.cache.items()}
    with pytest.raises(AssertionError, match="drop_programs"):
        ex._check_bound()
    ex.drop_programs()
    ex._check_bound()


def test_categorical_draws_multinomials_numbers():
    """The sampler's written-out draw picks the tokens ``torch.multinomial``
    picks from the same generator state (so the port's sampled streams
    are what they were)."""
    rng = np.random.default_rng(0)
    for seed in range(8):
        logits = torch.from_numpy(rng.standard_normal((5, 300)).astype(np.float32) * 3)
        g1, g2 = torch.Generator(), torch.Generator()
        g1.manual_seed(seed)
        g2.manual_seed(seed)
        for _ in range(3):
            want = torch.multinomial(torch.softmax(logits, -1), 1, generator=g1)[:, 0]
            assert _categorical(logits, g2).tolist() == want.tolist()
