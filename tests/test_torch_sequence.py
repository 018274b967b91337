"""The port's sequence parallelism on the CPU against the JAX package.

Counterparts of ``tests/test_sequence.py``'s single-mesh cases: the port's
``parallel.sequence_attention`` (ring, ring_striped, ulysses) at sp 2, 4
and 8 in gloo rank processes (``tests/torch_sp_worker.py``: spawned, one
a rank, torch and the port only, joined through a ``file://`` store;
one spawn per world size, every case of that size inside it), against
the JAX package on the 8 fake devices of ``conftest.py``: its
``sequence_attention`` itself (impl xla) for one case of each method, and
for the rest its single-device ``attention_xla``, which
``tests/test_sequence.py`` holds that function to. Causal and not, GQA,
Ulysses' kv replication, segment ids, softcap, windows (with the ring's
truncation counted in the collectives' exchanges), the rejections; then
every collective of ``comm`` and its gradient against the JAX package's
on the fake mesh. float32: outputs to 1e-5, gradients to 2e-6 absolute +
1e-4 relative, as the port's other gradient tests.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from orion_tpu.comm import collectives as jc
from orion_tpu.ops.attention import attention_xla
from orion_tpu.parallel import sequence_attention as j_sequence_attention
from tests import torch_sp_worker as W
from tests.conftest import make_mesh
from tests import torch_threads  # noqa: F401  (one intra-op thread)

B, S, N, H = 2, 64, 8, 16
OUT_TOL = dict(atol=1e-5, rtol=0)
GRAD_TOL = dict(atol=2e-6, rtol=1e-4)


def _inputs(seed, n_kv):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    seg = np.concatenate([np.zeros((B, 24), np.int32), np.ones((B, 40), np.int32)], 1)
    return {"q": f(B, S, N, H), "k": f(B, S, n_kv, H), "v": f(B, S, n_kv, H),
            "do": f(B, S, N, H), "seg": seg}


INPUTS = {"gqa": (0, 2), "mha": (1, 8)}


def _case(method, sp, *, causal=True, kv="gqa", segments=False, softcap=None, window=None,
          jax_sp=False):
    cid = f"{method}-sp{sp}-{'causal' if causal else 'full'}-{kv}"
    cid += "-seg" * segments + (f"-cap{softcap:g}" if softcap else "")
    cid += f"-w{window}" if window else ""
    return dict(id=cid, method=method, sp=sp, causal=causal, inputs=kv, segments=segments,
                softcap=softcap, window=window, jax_sp=jax_sp)


METHODS = ("ring", "ring_striped", "ulysses")
CASES = (
    # Each method at every world size (GQA; Ulysses replicates kv heads at 4, 8).
    [_case(m, sp) for m in METHODS for sp in (2, 4, 8)]
    # Off the default: no causal mask, segments, softcap, and one case each
    # against the JAX package's sequence_attention itself.
    + [_case(m, 4, causal=False) for m in METHODS]
    + [_case(m, 4, kv="mha", segments=True) for m in METHODS]
    + [_case(m, 8, softcap=30.0) for m in METHODS]
    + [_case(m, 4, segments=True, softcap=30.0, window=20, jax_sp=True) for m in METHODS]
    # Windows smaller than, inside and across the shard (s_loc = 8 at sp 8).
    + [_case(m, 8, window=w) for m in METHODS for w in (5, 16, 40)]
    # The truncated ring: one step back (5), the diagonal alone (1).
    + [_case("ring", 8, window=1)]
)
REJECTIONS = {
    "unknown method": dict(inputs="gqa", kw=dict(method="zigzag")),
    "window without causal": dict(inputs="gqa", kw=dict(method="ring", causal=False, window=8)),
    "ulysses heads": dict(inputs="mha_bad", kw=dict(method="ulysses")),
    "striped divisibility": dict(inputs="short", kw=dict(method="ring_striped")),
}
REJECT_MATCH = {"unknown method": "unknown sequence method",
                "window without causal": "causal", "ulysses heads": "divisible",
                "striped divisibility": "divisible by sp"}


@functools.lru_cache(maxsize=None)
def _job_inputs():
    out = {name: _inputs(seed, n_kv) for name, (seed, n_kv) in INPUTS.items()}
    rng = np.random.default_rng(2)
    out["mha_bad"] = {n: rng.standard_normal((B, S, h, H)).astype(np.float32)
                      for n, h in (("q", 4), ("k", 2), ("v", 2))}   # 4 heads at sp 8
    out["short"] = {n: rng.standard_normal((B, 32, 2, H)).astype(np.float32)
                    for n in ("q", "k", "v")}                        # S % sp^2 != 0 at 8
    return out


def _ref_key(case):
    """What the JAX reference depends on: the inputs and mask, and the
    method and world size only where the JAX sequence_attention runs."""
    sp = (case["method"], case["sp"]) if case["jax_sp"] else None
    return (sp, case["causal"], case["inputs"], case["segments"], case["softcap"],
            case["window"])


@functools.lru_cache(maxsize=None)
def _jax_reference(key):
    """(out, (dq, dk, dv)) of the JAX package for a case's key, global."""
    sp, causal, inputs, segments, softcap, window = key
    x = _job_inputs()[inputs]
    q, k, v, do = (jnp.asarray(x[n]) for n in ("q", "k", "v", "do"))
    seg = jnp.asarray(x["seg"]) if segments else None
    kw = dict(causal=causal, q_segment_ids=seg, kv_segment_ids=seg, logit_softcap=softcap,
              window=window)
    if sp is not None:
        mesh = make_mesh(jax.devices("cpu"), sp=sp[1])
        fn = functools.partial(j_sequence_attention, mesh=mesh, method=sp[0], **kw)
    else:
        fn = functools.partial(attention_xla, **kw)

    @jax.jit
    def fwd_bwd(q, k, v, do):
        out, vjp = jax.vjp(lambda a, b, c: fn(a, b, c), q, k, v)
        return out, vjp(do)

    out, grads = fwd_bwd(q, k, v, do)
    return np.asarray(out), [np.asarray(g) for g in grads]


@pytest.fixture(scope="module")
def sp_results(tmp_path_factory, cpu_devices):
    """Every case's per-rank results, by world size, the collectives' (run
    at sp = COLL_SP), and the JAX package's collectives: the three spawns
    run together while the parent computes the JAX side."""
    cots = _coll_cotangents()
    ctxs = {}
    for sp in (2, 4, 8):
        tmp = tmp_path_factory.mktemp(f"sp{sp}")
        job = {"inputs": _job_inputs(), "cases": [c for c in CASES if c["sp"] == sp],
               "rejections": REJECTIONS if sp == 8 else {}}
        if sp == COLL_SP:
            job["collectives"] = dict(zip(("x", "wide"), _coll_inputs()), cot=cots)
        ctxs[sp] = (W.spawn("attention", sp, job, tmp), tmp)
    for case in CASES:
        _jax_reference(_ref_key(case))
    jax_coll = _jax_collectives(make_mesh(cpu_devices, sp=COLL_SP), cots)
    return {sp: W.collect(ctx, sp, tmp) for sp, (ctx, tmp) in ctxs.items()}, jax_coll


def _gather(parts):
    return np.concatenate([np.asarray(p) for p in parts], axis=1)


@pytest.mark.parametrize("case", CASES, ids=[c["id"] for c in CASES])
def test_sequence_attention_matches_jax(sp_results, case):
    ranks = sp_results[0][case["sp"]]
    assert not any(r["jax_imported"] for r in ranks)
    got = [r["cases"][case["id"]] for r in ranks]
    out = _gather([g["out"] for g in got])
    grads = [_gather([g["grads"][i] for g in got]) for i in range(3)]
    want_out, want_grads = _jax_reference(_ref_key(case))
    np.testing.assert_allclose(out, want_out, **OUT_TOL)
    for name, a, b in zip(("dq", "dk", "dv"), grads, want_grads):
        np.testing.assert_allclose(a, b, **GRAD_TOL, err_msg=name)


def test_ring_window_truncates_ring_steps(sp_results):
    """The windowed ring drops the steps wholly behind the window, and
    their exchanges with them (k and v each step): 7 steps at sp 8
    without a window, one with window 5 (< s_loc + 2 = 10), none with
    window 1 (the diagonal alone). Striped and Ulysses exchange no blocks
    point to point beyond the ring's sp - 1 steps / at all."""
    got = {cid: r["cases"][cid]["ppermute"] for r in sp_results[0][8] for cid in r["cases"]}
    assert got["ring-sp8-causal-gqa"] == 2 * 7
    assert got["ring-sp8-causal-gqa-w5"] == 2 * 1
    assert got["ring-sp8-causal-gqa-w1"] == 0
    assert got["ring-sp8-causal-gqa-w16"] == 2 * 2
    assert got["ring_striped-sp8-causal-gqa-w5"] == 2 * 7   # no step can be dropped
    assert got["ulysses-sp8-causal-gqa"] == 0


@pytest.mark.parametrize("name", sorted(REJECTIONS))
def test_sequence_attention_rejections(sp_results, name):
    """Each rank raises ValueError with the JAX package's reason."""
    texts = [r["rejections"][name] for r in sp_results[0][8]]
    assert all(t is not None and REJECT_MATCH[name] in t for t in texts), texts


# -- collectives ----------------------------------------------------------------

COLL_SP = 4
ROWS, COLS = 2, 8
COLL_OPS = ("all_reduce_sum", "all_reduce_mean", "all_reduce_max", "all_reduce_min",
            "all_gather", "all_gather_stacked", "reduce_scatter", "all_to_all", "ppermute",
            "ppermute_partial", "ring_shift", "broadcast")
NO_GRAD = ("all_reduce_max", "all_reduce_min")


def _coll_inputs():
    rng = np.random.default_rng(7)
    x = rng.standard_normal((COLL_SP * ROWS, COLS)).astype(np.float32)
    wide = rng.standard_normal((COLL_SP * ROWS, COLS * COLL_SP)).astype(np.float32)
    return x, wide


def _coll_bodies():
    """The JAX package's collectives as shard_map bodies, under the port's
    op names (``tests/torch_sp_worker.py`` ``collectives``)."""
    n = COLL_SP
    return {
        "all_reduce_sum": lambda t, w: jc.all_reduce(t, "sp", "sum"),
        "all_reduce_mean": lambda t, w: jc.all_reduce(t, "sp", "mean"),
        "all_reduce_max": lambda t, w: jc.all_reduce(t, "sp", "max"),
        "all_reduce_min": lambda t, w: jc.all_reduce(t, "sp", "min"),
        "all_gather": lambda t, w: jc.all_gather(t, "sp", gather_axis=1),
        "all_gather_stacked": lambda t, w: jc.all_gather(t, "sp", gather_axis=1,
                                                         tiled=False),
        "reduce_scatter": lambda t, w: jc.reduce_scatter(w, "sp", scatter_axis=1),
        "all_to_all": lambda t, w: jc.all_to_all(t, "sp", split_axis=1, concat_axis=0),
        "ppermute": lambda t, w: jc.ppermute(t, "sp", [(i, (i + 1) % n) for i in range(n)]),
        "ppermute_partial": lambda t, w: jc.ppermute(t, "sp", [(0, n - 1), (1, 0)]),
        "ring_shift": lambda t, w: jc.ring_shift(t, "sp", shift=2),
        "broadcast": lambda t, w: jc.broadcast(t, "sp", root=1),
    }


def _global_fn(body, mesh):
    from jax.sharding import PartitionSpec as P

    return jax.shard_map(body, mesh=mesh, in_specs=(P("sp"), P("sp")), out_specs=P("sp"),
                         check_vma=False)


def _coll_cotangents():
    """A cotangent for each op's global output (shapes from the JAX ops)."""
    mesh = make_mesh(jax.devices("cpu"), sp=COLL_SP)
    shapes = jax.eval_shape(
        lambda a, b: {k: _global_fn(f, mesh)(a, b) for k, f in _coll_bodies().items()},
        *_coll_inputs())
    rng = np.random.default_rng(8)
    return {name: rng.standard_normal(shapes[name].shape).astype(np.float32)
            for name in COLL_OPS}


def _jax_collectives(mesh, cots):
    """Each op's global output (shards stacked on rows, as the port's ranks
    hold them) and the gradient of sum(output * cotangent) by its input."""

    @jax.jit
    def run(x, wide, cot):
        res = {}
        for name, body in _coll_bodies().items():
            f = _global_fn(body, mesh)
            if name in NO_GRAD:
                res[name] = (f(x, wide), None)
                continue
            arg = 1 if name == "reduce_scatter" else 0
            g = jax.grad(lambda a, b: (f(a, b) * cot[name]).sum(), argnums=arg)(x, wide)
            res[name] = (f(x, wide), g)
        return res

    res = run(*(jnp.asarray(t) for t in _coll_inputs()),
              {k: jnp.asarray(v) for k, v in cots.items()})
    out = {name: np.asarray(y) for name, (y, _) in res.items()}
    grads = {name: None if g is None else np.asarray(g) for name, (_, g) in res.items()}
    return out, grads


@pytest.mark.parametrize("op", COLL_OPS)
def test_collective_matches_jax(sp_results, op):
    """Outputs as the JAX package's collectives give them (rank r's rows are
    the JAX output's shard r), and the gradients (the transposes: inverse
    permutation, inverse all_to_all, reduce-scatter, ...) to float32
    rounding; max and min carry no gradient."""
    ranks = [r["collectives"] for r in sp_results[0][COLL_SP]]
    out, grads = sp_results[1]
    got = np.concatenate([np.asarray(r[op]["out"]) for r in ranks], axis=0)
    np.testing.assert_allclose(got, out[op], atol=1e-6, rtol=1e-6)
    if op in NO_GRAD:
        assert all("grad" not in r[op] for r in ranks)
        return
    g = np.concatenate([np.asarray(r[op]["grad"]) for r in ranks], axis=0)
    np.testing.assert_allclose(g, grads[op], atol=1e-6, rtol=1e-6)


def test_collective_axis_facts(sp_results):
    ranks = [r["collectives"] for r in sp_results[0][COLL_SP]]
    assert [r["index"] for r in ranks] == list(range(COLL_SP))
    assert {r["size"] for r in ranks} == {r["barrier"] for r in ranks} == {COLL_SP}


def test_runtime_agreements(sp_results):
    """runtime.distributed's process-wide votes (the multi-process
    checkpoint restore's): the steps every rank sees, all ranks ok, one
    veto; and each rank's runtime_info."""
    ranks = [r["collectives"] for r in sp_results[0][COLL_SP]]
    assert all(r["steps"] == [2, 4, 6] for r in ranks)
    assert all(r["all_ok"] and not r["one_vetoes"] for r in ranks)
    assert [(r["info"].process_id, r["info"].num_processes, r["info"].platform)
            for r in ranks] == [(i, COLL_SP, "cpu") for i in range(COLL_SP)]
