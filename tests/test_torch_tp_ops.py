"""The tensor-parallel forms of K3, K4, K9 and K10 on the CPU: each rank
runs the port's op (``ops.attention``, ``paged_attention``,
``paged_flash_prefill``, ``ragged_paged_attention``) on its block of the
heads, as a serving rank's runner does, against the JAX package's ops
with a ``tp`` mesh of two fake devices (the Pallas kernels in interpret
mode under their head-sharded ``shard_map``); and the serving refusals
and repairs that come with tensor parallelism.

Inputs are made with numpy from a seed: 8 query heads over 4 kv heads,
so each of the two ranks runs 4 over 2 (the GQA group is the same on
every rank). Every rank's output heads and pool slices are put back
together along the heads and compared with the JAX op's: outputs of real
rows within 1e-5 in float32 (sums in another order), pool writes byte
for byte.

Then the refusals at construction, before any process group is joined:
tp = 4 on tiny-llama (2 kv heads) raises the JAX engine's "divisible"
ValueError (``tests/test_infer.py::test_sharded_engine_pallas_rejects_
indivisible_heads``), fsdp and sp in the engine, MoE, int8 weights and
CUDA graphs at tp > 1 and the trainer at tp > 1 raise NotImplementedError
naming them; a vocabulary tp does not divide is refused by both packages.
And the repairs: the scan unit's ValueError and the trainer's refusal of
``scan_group`` > 1, and ``parallel.dcn_axes`` checked as the JAX package
checks it.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orion_tpu.config import ParallelConfig as JParallelConfig
from orion_tpu.config import get_config as j_get_config
from orion_tpu.models.transformer import _hidden_states as j_hidden_states
from orion_tpu.models.transformer import init_params as j_init_params
from orion_tpu.ops.attention import attention as j_attention
from orion_tpu.ops.pallas.common import quantize_kv as j_quantize_kv
from orion_tpu.ops.pallas.paged_attention import paged_attention as j_paged
from orion_tpu.ops.pallas.paged_flash_prefill import paged_flash_prefill as j_prefill
from orion_tpu.ops.pallas.ragged_paged_attention import ragged_paged_attention as j_ragged
from orion_tpu.runtime import build_mesh as j_build_mesh
from orion_tpu_torch import ops
from orion_tpu_torch.config import get_config
from orion_tpu_torch.infer import InferenceEngine
from orion_tpu_torch.models import from_jax_params, init_params
from orion_tpu_torch.models.convert import serving_blocks
from orion_tpu_torch.models.transformer import _hidden_states
from orion_tpu_torch.train import Trainer
from tests import torch_threads  # noqa: F401  (one intra-op thread)

ATOL = 1e-5
TP = 2
N, K, H, PSZ, ROWS, SW = 8, 4, 64, 16, 32, 128
TABLE = np.array([[5, 17, 2, 9], [30, 1, 7, 3], [11, 4, 8, 22]], np.int32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _mesh(tp=TP):
    return j_build_mesh(JParallelConfig(tp=tp), devices=jax.devices("cpu")[:tp])


def _f(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _cat(parts, dim):
    return torch.cat(parts, dim).numpy()


def _int8_pools(kp, vp):
    """int8 pools and [rows, K, 128] float32 scale pools made by the JAX
    quantizer from float pools (lanes past the page zero)."""
    out = []
    for pool in (kp, vp):
        q, s = j_quantize_kv(jnp.asarray(pool).transpose(0, 2, 1, 3))
        sc = np.zeros((pool.shape[0], pool.shape[1], SW), np.float32)
        sc[:, :, :PSZ] = np.asarray(s).transpose(0, 2, 1)
        out += [np.asarray(q.transpose(0, 2, 1, 3)), sc]
    return out


def _ranks(fn, *args, **kw):
    """``fn`` as each rank of tp runs it: every ``(array, dim)`` argument
    cut to the rank's block of heads along ``dim`` (rank r holds heads
    [r * n / tp, (r + 1) * n / tp), where JAX's ``P(..., "tp", ...)``
    places them), every other array whole. Tuples of outputs by rank."""
    def cut(a, r):
        if isinstance(a, tuple):
            arr, dim = a
            n = arr.shape[dim] // TP
            return _t(arr).narrow(dim, r * n, n).contiguous()
        return _t(a) if isinstance(a, np.ndarray) else a

    out = []
    for r in range(TP):
        o = fn(*(cut(a, r) for a in args), **{k: cut(v, r) for k, v in kw.items()})
        out.append(o if isinstance(o, tuple) else (o,))
    return out


def _pools_equal(got, want, skip_rows=()):
    a, b = np.asarray(got), np.asarray(want)
    keep = np.ones(a.shape[0], bool)
    keep[list(skip_rows)] = False
    assert a.dtype == b.dtype
    assert np.array_equal(a[keep].view(np.uint8), b[keep].view(np.uint8))


@pytest.mark.parametrize("kw", [
    dict(causal=True),
    dict(causal=True, window=7, logit_softcap=30.0),
])
def test_attention_tp_matches_jax(kw):
    """K3 on each rank's heads: a ragged burst (segment 0 is padding) over 8/4 heads."""
    rng = np.random.default_rng(1)
    B, S = 2, 24
    q, k, v = _f(rng, B, S, N, H), _f(rng, B, S, K, H), _f(rng, B, S, K, H)
    seg = (np.arange(S)[None] < np.array([[24], [17]])).astype(np.int32)
    want = j_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       q_segment_ids=jnp.asarray(seg), kv_segment_ids=jnp.asarray(seg),
                       impl="pallas_interpret", seg_pad_zero=True, mesh=_mesh(), **kw)
    got = _ranks(ops.attention, (q, 2), (k, 2), (v, 2), q_segment_ids=seg,
                 kv_segment_ids=seg, seg_pad_zero=True, **kw)
    assert got[0][0].shape == (B, S, N // TP, H)
    out, ref = _cat([g[0] for g in got], 2), np.asarray(want)
    for b, n in enumerate((24, 17)):
        np.testing.assert_allclose(out[b, :n], ref[b, :n], atol=ATOL)


@pytest.mark.parametrize("quant", [False, True])
def test_paged_attention_tp_matches_jax(quant):
    """K4 on each rank's heads: the new token written into each rank's pool slice."""
    rng = np.random.default_rng(2)
    B = TABLE.shape[0]
    q, kp, vp = _f(rng, B, N, H), _f(rng, ROWS, K, PSZ, H), _f(rng, ROWS, K, PSZ, H)
    kn, vn = _f(rng, B, K, H), _f(rng, B, K, H)
    last = np.array([5, 40, 63], np.int32)
    pools = [kp, vp]
    if quant:
        kp8, ks, vp8, vs = _int8_pools(kp, vp)
        pools = [kp8, vp8, ks, vs]
    names = ["k_pool", "v_pool"] + (["k_scale", "v_scale"] if quant else [])
    jkw = dict(zip(names[2:], map(jnp.asarray, pools[2:])))
    want = j_paged(jnp.asarray(q), jnp.asarray(pools[0]), jnp.asarray(pools[1]),
                   jnp.asarray(TABLE), jnp.asarray(last), k_new=jnp.asarray(kn),
                   v_new=jnp.asarray(vn), interpret=True, mesh=_mesh(), **jkw)
    tkw = {n: (p, 1) for n, p in zip(names[2:], pools[2:])}
    got = _ranks(ops.paged_attention, (q, 1), (pools[0], 1), (pools[1], 1), TABLE, last,
                 k_new=(kn, 1), v_new=(vn, 1), **tkw)
    np.testing.assert_allclose(_cat([g[0] for g in got], 1), np.asarray(want[0]), atol=ATOL)
    for i in range(1, len(want)):
        _pools_equal(_cat([g[i] for g in got], 1), want[i])


@pytest.mark.parametrize("quant", [False, True])
def test_paged_flash_prefill_tp_matches_jax(quant):
    """K9 on each rank's heads: two chunk rows of 32 resuming over 2 and 1 cached
    pages, the chunk's pages written into each rank's pool slice."""
    rng = np.random.default_rng(3)
    B, S, P_pre = 2, 32, 2
    q = _f(rng, B, S, N, H)
    kp, vp = _f(rng, ROWS, K, PSZ, H), _f(rng, ROWS, K, PSZ, H)
    kn, vn = _f(rng, B, S, K, H), _f(rng, B, S, K, H)
    walk = np.array([[3, 9, 12, 13], [6, 0, 20, 21]], np.int32)
    start = np.array([32, 16], np.int32)
    lens = np.array([32, 20], np.int32)
    pools = [kp, vp]
    if quant:
        kp8, ks, vp8, vs = _int8_pools(kp, vp)
        pools = [kp8, vp8, ks, vs]
    scales = dict(zip(["k_scale", "v_scale"], pools[2:]))
    args = (q, pools[0], pools[1], walk, start, lens, kn, vn)
    want = j_prefill(*map(jnp.asarray, args), n_prefix_pages=P_pre, interpret=True,
                     mesh=_mesh(), **{k: jnp.asarray(v) for k, v in scales.items()})
    got = _ranks(ops.paged_flash_prefill, (q, 2), (pools[0], 1), (pools[1], 1), walk, start,
                 lens, (kn, 2), (vn, 2), n_prefix_pages=P_pre,
                 **{k: (v, 1) for k, v in scales.items()})
    out, ref = _cat([g[0] for g in got], 2), np.asarray(want[0])
    for b in range(B):
        np.testing.assert_allclose(out[b, :lens[b]], ref[b, :lens[b]], atol=ATOL)
    for i in range(1, len(want)):
        _pools_equal(_cat([g[i] for g in got], 1), want[i])


def _tree(B, W):
    """A width-2 token tree on every row: columns 1-2 children of 0, 3 of
    1, 4 of 2; ancestor words and depths as the JAX runner packs them."""
    parents = [0, 0, 0, 1, 2]
    depth = [0, 1, 1, 2, 2]
    words = []
    for j in range(W):
        w, a = 0, j
        while True:
            w |= 1 << a
            if a == 0:
                break
            a = parents[a]
        words.append(w)
    return (np.tile(np.array(words, np.int32), (B, 1)),
            np.tile(np.array(depth, np.int32), (B, 1)))


@pytest.mark.parametrize("mode", ["chain", "tree", "int8"])
def test_ragged_paged_attention_tp_matches_jax(mode):
    """K10 on each rank's heads: W = 5 queries a slot, chain or token tree, float32
    or int8 pools; each rank writes the drafts into its slice."""
    rng = np.random.default_rng(4)
    B, W = TABLE.shape[0], 5
    q = _f(rng, B, W, N, H)
    kp, vp = _f(rng, ROWS, K, PSZ, H), _f(rng, ROWS, K, PSZ, H)
    kn, vn = _f(rng, B, W, K, H), _f(rng, B, W, K, H)
    start = np.array([0, 13, 59], np.int32)
    lens = np.array([W, 1, 3], np.int32) if mode != "tree" else np.full(B, W, np.int32)
    pools = [kp, vp]
    extra = {}
    if mode == "int8":
        kp8, ks, vp8, vs = _int8_pools(kp, vp)
        pools = [kp8, vp8]
        extra = dict(k_scale=ks, v_scale=vs)
    if mode == "tree":
        tm, dp = _tree(B, W)
        extra = dict(tree_mask=tm, depths=dp)
    args = (q, pools[0], pools[1], TABLE, start, lens)
    want = j_ragged(*map(jnp.asarray, args), k_new=jnp.asarray(kn), v_new=jnp.asarray(vn),
                    interpret=True, mesh=_mesh(),
                    **{k: jnp.asarray(v) for k, v in extra.items()})
    heads = {"k_scale": 1, "v_scale": 1}
    got = _ranks(ops.ragged_paged_attention, (q, 2), (pools[0], 1), (pools[1], 1), TABLE,
                 start, lens, k_new=(kn, 2), v_new=(vn, 2),
                 **{k: (v, heads[k]) if k in heads else v for k, v in extra.items()})
    out, ref = _cat([g[0] for g in got], 2), np.asarray(want[0])
    for b in range(B):
        np.testing.assert_allclose(out[b, :lens[b]], ref[b, :lens[b]], atol=ATOL)
    # Page 0 is the port's scratch page (its plain version parks padding
    # tokens there); every other row is byte-equal.
    for i in range(1, len(want)):
        _pools_equal(_cat([g[i] for g in got], 1), want[i], skip_rows=(0,))


# -- refusals at construction -------------------------------------------------

SMALL = ["inference.max_seq_len=128", "inference.page_size=16", "inference.num_pages=32",
         "inference.max_batch_size=4", "inference.prefill_chunk=16"]


def _engine(preset, overrides, **kw):
    cfg = get_config(preset, SMALL + overrides)
    gen = torch.Generator()
    gen.manual_seed(0)
    return InferenceEngine(cfg, init_params(cfg.model, gen), device="cpu", **kw)


def test_indivisible_heads_raise_the_jax_engines_error(cpu_devices):
    """tp = 4 on tiny-llama (K = 2): the JAX engine's ValueError, with its
    text, before any process group is joined."""
    from orion_tpu.infer import InferenceEngine as JEngine
    from orion_tpu.models.transformer import param_logical_axes
    from orion_tpu.parallel.sharding import param_shardings

    jcfg = j_get_config("tiny-llama", SMALL)
    jcfg = dataclasses.replace(jcfg, model=dataclasses.replace(jcfg.model,
                                                               kernels="pallas_interpret"))
    mesh = j_build_mesh(JParallelConfig(tp=4), devices=cpu_devices[:4])
    params = j_init_params(jcfg.model, jax.random.key(0))
    sharded = jax.device_put(params, param_shardings(mesh, param_logical_axes(jcfg.model)))
    with pytest.raises(ValueError, match="divisible") as want:
        JEngine(jcfg, sharded)
    with pytest.raises(ValueError, match="divisible") as got:
        _engine("tiny-llama", ["parallel.tp=4"], cuda_graphs=False)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("preset,overrides,kw,match", [
    ("tiny-llama", ["parallel.fsdp=2"], {}, "parallel.fsdp=2 \\(FSDP\\)"),
    ("tiny-llama", ["parallel.sp=2"], {}, "parallel.sp=2 \\(sequence parallelism\\)"),
    ("tiny-llama", ["parallel.tp=2", "parallel.pp=2"], dict(cuda_graphs=False),
     "pipeline parallelism"),
    ("tiny-mixtral", ["parallel.tp=2"], dict(cuda_graphs=False), "MoE"),
    ("tiny-llama", ["parallel.tp=2", "model.weight_quant=int8"], dict(cuda_graphs=False),
     "weight_quant=int8"),
    ("tiny-llama", ["parallel.tp=2"], {}, "cuda_graphs=True"),
])
def test_engine_refuses_what_tp_serving_does_not_run(preset, overrides, kw, match):
    with pytest.raises(NotImplementedError, match=match):
        _engine(preset, overrides, **kw)


def test_trainer_refuses_tp():
    with pytest.raises(NotImplementedError, match="tensor parallelism"):
        Trainer(get_config("tiny-llama", ["parallel.tp=2", "data.batch_size=4"]),
                device="cpu")


def test_indivisible_vocab_is_refused_by_both(cpu_devices):
    """A vocabulary of 257 at tp = 2: JAX's device_put refuses the
    vocab-sharded leaves, and so does the port's cut."""
    from orion_tpu.models.transformer import param_logical_axes
    from orion_tpu.parallel.sharding import param_shardings

    ov = SMALL + ["model.vocab_size=257"]
    jcfg = j_get_config("tiny-llama", ov)
    mesh = j_build_mesh(JParallelConfig(tp=2), devices=cpu_devices[:2])
    params = j_init_params(jcfg.model, jax.random.key(0))
    with pytest.raises(ValueError, match="divisible by 2"):
        jax.device_put(params, param_shardings(mesh, param_logical_axes(jcfg.model)))
    cfg = get_config("tiny-llama", ov)
    whole = from_jax_params(jax.tree.map(np.asarray, params), cfg.model)
    sizes = dict(cfg.parallel.axis_sizes, tp=2)
    with pytest.raises(ValueError, match="not divisible by 2"):
        serving_blocks(whole, cfg.model, sizes, {"tp": 1})


# -- repairs --------------------------------------------------------------------


def test_scan_unit_raises_the_jax_error():
    """tiny-llama (2 layers) with scan_group 3: the JAX forward's ValueError,
    with its text, from the port's too."""
    ov = ["model.scan_group=3"]
    jcfg = j_get_config("tiny-llama", ov)
    tokens = np.zeros((1, 8), np.int32)
    with pytest.raises(ValueError, match="layer-scan unit 3") as want:
        j_hidden_states(j_init_params(jcfg.model, jax.random.key(0)), jnp.asarray(tokens),
                        jcfg.model)
    cfg = get_config("tiny-llama", ov)
    gen = torch.Generator()
    gen.manual_seed(0)
    with pytest.raises(ValueError) as got:
        _hidden_states(init_params(cfg.model, gen), _t(tokens), cfg.model)
    assert str(got.value) == str(want.value)


def test_trainer_refuses_scan_group():
    """A scan unit that divides the layers: the grouped remat boundary is
    refused by name (an indivisible one is the JAX trainer's ValueError)."""
    with pytest.raises(NotImplementedError, match="model.scan_group > 1"):
        Trainer(get_config("tiny-llama", ["model.scan_group=2", "data.batch_size=4"]),
                device="cpu")
    with pytest.raises(ValueError, match="layer-scan unit 3"):
        Trainer(get_config("tiny-llama", ["model.scan_group=3", "data.batch_size=4"]),
                device="cpu")


def test_dcn_axes_are_checked_as_in_jax(cpu_devices):
    from orion_tpu_torch.runtime.mesh import check_dcn_axes

    with pytest.raises(ValueError) as want:
        j_build_mesh(JParallelConfig(tp=2, dcn_axes=("bogus",)), devices=cpu_devices[:2])
    cfg = get_config("tiny-llama", ["parallel.dcn_axes=bogus,"])
    with pytest.raises(ValueError) as got:
        check_dcn_axes(cfg.parallel)
    assert str(got.value) == str(want.value)
    for make in (lambda: Trainer(cfg, device="cpu"), lambda: _engine("tiny-llama", [
            "parallel.dcn_axes=bogus,"])):
        with pytest.raises(ValueError, match="unknown mesh axes"):
            make()
    check_dcn_axes(get_config("tiny-llama", ["parallel.dcn_axes=dp,"]).parallel)
