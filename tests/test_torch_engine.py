"""The port's serving engine on the CPU (plain PyTorch versions) against the
JAX package's engine: greedy token streams must be equal, token for token,
with the JAX weights carried across by ``from_jax_params``."""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from orion_tpu.config import get_config as j_get_config
from orion_tpu.infer import InferenceEngine as JEngine
from orion_tpu.models import init_params as j_init_params
from orion_tpu_torch.config import get_config
from orion_tpu_torch.infer import InferenceEngine
from orion_tpu_torch.models import from_jax_params
from tests import torch_threads  # noqa: F401  (one intra-op thread)

INFER_OVERRIDES = [
    "inference.max_seq_len=128", "inference.page_size=16",
    "inference.num_pages=32", "inference.max_batch_size=4",
    "inference.prefill_chunk=16", "inference.max_new_tokens=8",
]
SIX_PROMPTS = [
    [5, 3, 9], [250, 17, 4, 8, 100, 42], [7] * 20, [1, 2],
    [99, 98, 97, 96], [11, 13, 17, 19, 23],
]  # 6 requests > max_batch_size=4: admission queues


def _pair(preset="tiny-llama", overrides=(), kernels="xla"):
    ov = INFER_OVERRIDES + list(overrides)
    jcfg = j_get_config(preset, ov)
    jcfg = dataclasses.replace(
        jcfg, model=dataclasses.replace(jcfg.model, kernels=kernels))
    cfg = get_config(preset, ov)
    jp = j_init_params(jcfg.model, jax.random.key(0))
    tp = from_jax_params(jax.tree.map(np.asarray, jp), cfg.model)
    return jcfg, jp, cfg, tp


@pytest.mark.parametrize("kernels", ["xla", "pallas_interpret"])
def test_greedy_stream_matches_jax(kernels):
    jcfg, jp, cfg, tp = _pair(kernels=kernels)
    prompt = [5, 3, 9, 250, 17]
    want = JEngine(jcfg, jp).generate([prompt], 8)
    got = InferenceEngine(cfg, tp, device="cpu").generate([prompt], 8)
    assert got == want


@pytest.mark.parametrize("kernels", ["xla", "pallas_interpret"])
def test_continuous_batching_matches_jax(kernels):
    jcfg, jp, cfg, tp = _pair(kernels=kernels)
    want = JEngine(jcfg, jp).generate(SIX_PROMPTS, 6)
    eng = InferenceEngine(cfg, tp, device="cpu")
    got = eng.generate(SIX_PROMPTS, 6)
    assert got == want
    singles = [InferenceEngine(cfg, tp, device="cpu").generate([p], 6)[0]
               for p in SIX_PROMPTS]
    assert got == singles
    assert eng.alloc.free_pages == cfg.inference.num_pages - 1   # all returned


def test_gemma2_beyond_window_matches_jax():
    """Interleaved local/global windows, post-norms and both softcaps,
    generating past the 16-token window."""
    jcfg, jp, cfg, tp = _pair("tiny-gemma2")
    prompt = [5, 3, 9, 250, 17]
    want = JEngine(jcfg, jp).generate([prompt], 20)
    got = InferenceEngine(cfg, tp, device="cpu").generate([prompt], 20)
    assert got == want


def test_preemption_under_pool_pressure_matches_jax():
    """Two requests that outgrow a 7-page pool: the youngest is preempted,
    recomputed on re-admission, and both streams stay the JAX engine's."""
    jcfg, jp, cfg, tp = _pair(overrides=["inference.num_pages=8"])
    prompts = [[5, 3, 9, 250, 17, 8, 100, 42, 77, 31, 2, 6, 90, 55, 21],
               [7, 11, 13, 17, 19, 23, 29, 31, 37, 41, 43, 47, 53, 59, 61]]
    want = JEngine(jcfg, jp).generate(prompts, 50)
    eng = InferenceEngine(cfg, tp, device="cpu")
    got = eng.generate(prompts, 50)
    assert eng.preemptions > 0, "scenario failed to exercise preemption"
    assert got == want


def test_mid_flight_admission_and_stream():
    _, _, cfg, tp = _pair(overrides=["inference.decode_window=2"])
    p1, p2 = [5, 3, 9, 250, 17], [42, 7]
    ref = [InferenceEngine(cfg, tp, device="cpu").generate([p], 8)[0]
           for p in (p1, p2)]
    eng = InferenceEngine(cfg, tp, device="cpu")
    eng.submit(p1, 8)
    finished = eng.step() + eng.step()
    eng.submit(p2, 8)
    while eng.has_work():
        finished += eng.step()
    assert [r.generated for r in sorted(finished, key=lambda r: r.rid)] == ref
    assert all(r.outcome == "completed" for r in finished)
    got: dict[int, list[int]] = {}
    for rid, toks in InferenceEngine(cfg, tp, device="cpu").stream([p1, p2], 8):
        got.setdefault(rid, []).extend(toks)
    assert [got[r] for r in sorted(got)] == ref


def test_eos_and_zero_token_requests():
    _, _, cfg, tp = _pair()
    ref = InferenceEngine(cfg, tp, device="cpu").generate([[5, 3, 9]], 8)[0]
    eng = InferenceEngine(cfg, tp, device="cpu", eos_id=ref[2])
    assert eng.generate([[5, 3, 9]], 8)[0] == ref[:3]
    assert InferenceEngine(cfg, tp, device="cpu").generate([[1, 2, 3]], 0) == [[]]


def test_sampled_requests_stay_in_vocab_and_filters():
    _, _, cfg, tp = _pair()
    eng = InferenceEngine(cfg, tp, device="cpu", seed=3)
    reqs = [eng.submit_request([5, 3, 9], 6, temperature=1.0, top_k=3),
            eng.submit_request([7, 7], 6)]
    while eng.has_work():
        eng.step()
    assert all(len(r.generated) == 6 for r in reqs)
    assert all(0 <= t < cfg.model.vocab_size for r in reqs for t in r.generated)


def test_engine_without_gpu_raises_unless_cpu_requested(monkeypatch):
    _, _, cfg, tp = _pair()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        InferenceEngine(cfg, tp)
    assert InferenceEngine(cfg, tp, device="cpu").device.type == "cpu"


@pytest.mark.parametrize("override", [
    "inference.dispatch_retries=2",
    "inference.dispatch_retry_backoff_s=0.5",
    "model.debug_asserts=true",
])
def test_unported_features_raise(override):
    _, _, cfg, tp = _pair(overrides=[override])
    with pytest.raises(NotImplementedError, match="not ported"):
        InferenceEngine(cfg, tp, device="cpu")


@pytest.mark.parametrize("override", [
    "inference.nan_guard=true", "inference.queue_limit=4",
    "inference.default_deadline_s=5.0", "inference.watchdog_timeout_s=30.0",
    "inference.spec_fault_limit=5", "inference.max_step_faults=8",
])
def test_fault_knobs_construct_and_serve(override):
    """The lifecycle and fault knobs build an engine that serves one prompt
    as the JAX engine does with the same knob."""
    jcfg, jp, cfg, tp = _pair(overrides=[override])
    prompt = [5, 3, 9, 250, 17]
    j_eng = JEngine(jcfg, jp)
    want = j_eng.generate([prompt], 8)
    j_eng.close()
    eng = InferenceEngine(cfg, tp, device="cpu")
    assert eng.generate([prompt], 8) == want
    eng.close()


def test_fault_ladder_defaults_construct():
    # The fallback leg's knobs at their defaults are accepted (any other
    # value raises, above); the ladder's own knobs at theirs too.
    _, _, cfg, tp = _pair(overrides=["inference.dispatch_retries=1",
                                     "inference.spec_fault_limit=3",
                                     "inference.max_step_faults=4"])
    assert InferenceEngine(cfg, tp, device="cpu").generate([[5, 3, 9]], 2)


def test_generate_cli_runs_on_cpu(capsys):
    from orion_tpu_torch.generate import main

    assert main(["--preset", "tiny-llama", "--tokens", "5,3,9", "--tokens", "7,8",
                 "--max-new-tokens", "4", "--device", "cpu"] + INFER_OVERRIDES) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.strip().splitlines()]
    assert [len(x["generated"]) for x in lines] == [4, 4]
    assert all(x["outcome"] == "completed" for x in lines)
