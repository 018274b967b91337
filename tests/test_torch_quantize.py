"""The port's int8 weights (``orion_tpu_torch/models/quantize.py``) against
the JAX package's ``orion_tpu/models/quantize.py`` on the CPU: the
quantized bytes and scales bit for bit, the dequantized reads, which
leaves of a tree are quantized, a quantized engine's greedy streams token
for token, and the refusals (the engine's for an unknown mode, the
trainer's for any)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orion_tpu.config import get_config as j_get_config
from orion_tpu.infer import InferenceEngine as JEngine
from orion_tpu.models import init_params as j_init_params
from orion_tpu.models import quantize as j_quant
from orion_tpu.train import Trainer as JTrainer
from orion_tpu_torch.config import get_config
from orion_tpu_torch.infer import InferenceEngine
from orion_tpu_torch.models import from_jax_params
from orion_tpu_torch.models import quantize as quant
from orion_tpu_torch.models.convert import tree_leaves_with_path
from orion_tpu_torch.train import Trainer
from tests import torch_threads  # noqa: F401  (one intra-op thread)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _init(mcfg):
    """The JAX package's init, as one compiled call."""
    return jax.jit(j_init_params, static_argnums=0)(mcfg, jax.random.key(0))


def _bits(x):
    if isinstance(x, torch.Tensor):
        return (x.view(torch.int16) if x.dtype == torch.bfloat16 else x).numpy().tobytes()
    return np.asarray(x).tobytes()


def _weights(shape, dtype, seed=0):
    """Normal draws with a zero output column, a column of one repeated
    value and exact half-steps of its scale (round-half-to-even)."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal(shape).astype(np.float32) * 0.05
    w[..., 0] = 0.0
    w[..., 1] = 0.25
    w[..., :4, 2] = np.array([127.0, 0.5, 1.5, -2.5], np.float32)
    jw = jnp.asarray(w, jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    tw = torch.from_numpy(w).to(torch.bfloat16 if dtype == "bfloat16" else torch.float32)
    return jw, tw


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(64, 48), (3, 64, 48)], ids=["flat", "stacked"])
def test_quantize_weight_bitwise(shape, dtype):
    """q and s byte for byte the JAX package's, flat [in, out] and stacked
    [L, in, out], from float32 and bfloat16 weights; load_weight's
    dequantized read bitwise too, in both compute dtypes."""
    jw, tw = _weights(shape, dtype)
    want, got = j_quant.quantize_weight(jw), quant.quantize_weight(tw)
    assert got["q"].dtype == torch.int8 and got["s"].dtype == torch.float32
    assert got["q"].shape == shape and got["s"].shape == shape[:-2] + shape[-1:]
    assert _bits(got["q"]) == _bits(want["q"])
    assert _bits(got["s"]) == _bits(want["s"])
    for dt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        assert _bits(quant.load_weight(got, dt)) == _bits(j_quant.load_weight(want, jdt))
    assert _bits(quant.load_weight(tw, torch.float32)) == _bits(
        j_quant.load_weight(jw, jnp.float32))


@pytest.mark.parametrize("preset", ["tiny-llama", "tiny-mixtral"])
def test_quantize_params_tree_matches_jax(preset):
    """quantize_params quantizes exactly the JAX package's leaves, with
    its bits: the attention and MLP matmul weights and lm_head; never the
    embeddings, norms, the router or the expert banks. A tree quantized
    already passes through as it is."""
    jcfg = j_get_config(preset)
    cfg = get_config(preset)
    jp = _init(jcfg.model)
    # Eager, as the JAX engine quantizes (a compiled divide may round
    # otherwise). The JAX tree stacks the layers; its per-layer, per-channel
    # scales split into the port's per-layer leaves.
    jq = j_quant.quantize_params(jp, jcfg.model)
    want = dict(tree_leaves_with_path(from_jax_params(_np(jq), cfg.model)))
    tq = quant.quantize_params(from_jax_params(_np(jp), cfg.model), cfg.model)
    got = dict(tree_leaves_with_path(tq))
    assert sorted(got) == sorted(want)
    for path, leaf in got.items():
        assert _bits(leaf) == _bits(want[path]), path
    quantized = {p[:-1] for p in got if p[-1] in ("q", "s")}
    assert ("lm_head",) in quantized
    assert (("blocks", 0, "attn", "wq")) in quantized
    assert not any("moe" in p or "embed" in p for p in quantized)
    assert (("blocks", 0, "mlp", "w_in") in quantized) == (preset == "tiny-llama")
    again = quant.quantize_params(tq, cfg.model)
    assert all(a is b for (_, a), (_, b) in zip(tree_leaves_with_path(again),
                                               tree_leaves_with_path(tq)))
    assert quant.weight_bytes(tq) < quant.weight_bytes(from_jax_params(_np(jp), cfg.model))


INFER = ["inference.max_seq_len=128", "inference.page_size=16", "inference.num_pages=32",
         "inference.max_batch_size=4", "inference.prefill_chunk=16",
         "inference.max_new_tokens=8", "model.weight_quant=int8"]
PROMPTS = [[5, 3, 9], [250, 17, 4, 8, 100, 42], [7] * 14, [11, 13, 17, 19, 23]]


def test_int8_engine_streams_match_jax():
    """tiny-llama with model.weight_quant=int8 (one burst of four prompts):
    the greedy streams token for token the JAX engine's, and the
    engine's matmul weights held as int8 with float32 scales."""
    jcfg = j_get_config("tiny-llama", INFER)
    cfg = get_config("tiny-llama", INFER)
    jp = _init(jcfg.model)
    want = JEngine(jcfg, jp).generate(PROMPTS, 10)
    eng = InferenceEngine(cfg, from_jax_params(_np(jp), cfg.model), device="cpu")
    assert eng.generate(PROMPTS, 10) == want
    wq = eng.params["blocks"][0]["attn"]["wq"]
    assert wq["q"].dtype == torch.int8 and wq["s"].dtype == torch.float32
    assert eng.params["lm_head"]["q"].dtype == torch.int8


def test_weight_quant_refusals_match_jax():
    """An unknown mode: the engine's ValueError, as the JAX engine's. Any
    mode in the trainer: the JAX trainer's own ValueError and message."""
    ov = INFER[:-1] + ["model.weight_quant=int4"]
    jp = _init(j_get_config("tiny-llama").model)
    with pytest.raises(ValueError) as j_err:
        JEngine(j_get_config("tiny-llama", ov), jp)
    cfg = get_config("tiny-llama", ov)
    with pytest.raises(ValueError) as err:
        InferenceEngine(cfg, from_jax_params(_np(jp), cfg.model), device="cpu")
    assert str(err.value) == str(j_err.value)
    for mode in ("int8", "int4"):
        ov = ["runtime.platform=cpu", f"model.weight_quant={mode}"]
        with pytest.raises(ValueError) as j_err:
            JTrainer(j_get_config("tiny-llama", ov))
        with pytest.raises(ValueError) as err:
            Trainer(get_config("tiny-llama", ov), device="cpu")
        assert str(err.value) == str(j_err.value)
