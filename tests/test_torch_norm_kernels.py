"""RMSNorm's backward in the port (K5's plain version and the autograd
wiring around K1/K5) against ``jax.vjp`` through the JAX package, on the
CPU.

The JAX side runs its xla reference and its Pallas kernels in interpret
mode (``_dx_kernel`` for dx, XLA's einsum for dscale). Inputs and
cotangents come from numpy with a seed; bfloat16 inputs are the float32
arrays rounded once on both sides. Tolerance 1e-5 absolute in float32 (a
few float32 terms per row in another order) and 1e-2 absolute plus 1e-2
relative in bfloat16 (each output rounds once to bf16, one ulp is at most
2^-7 of its value, and dscale sums up to 37 rows). The kernels themselves
(``csrc/rmsnorm.cu``) run only on the card, where ``chip_smoke.py`` holds
them against these plain versions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orion_tpu import ops as jops
from orion_tpu_torch import ops
from orion_tpu_torch.ops import _build, norms
from tests import torch_threads  # noqa: F401  (one intra-op thread)

IMPLS = ["xla", "pallas_interpret"]
# (x dtype, scale dtype): training runs bfloat16 rows beside the float32
# master scale.
DTYPES = {
    "float32": ("float32", "float32"),
    "bfloat16": ("bfloat16", "bfloat16"),
    "bf16_rows_f32_scale": ("bfloat16", "float32"),
}
TOL = {"float32": dict(atol=1e-5, rtol=0), "bfloat16": dict(atol=1e-2, rtol=1e-2)}
# D = 100 is no multiple of 8 (the kernels' generic scalar path); 37 rows
# is odd; [3, 5, 64] has a batch axis.
SHAPES = [(1, 100), (37, 768), (3, 5, 64)]


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    s = (1 + 0.1 * rng.standard_normal(shape[-1])).astype(np.float32)
    g = rng.standard_normal(shape).astype(np.float32)
    return x, s, g


def _jax(a, dtype):
    return jnp.asarray(a).astype(jnp.dtype(dtype))


def _torch(a, dtype):
    return torch.from_numpy(a.copy()).to(getattr(torch, dtype))


def _jax_grads(x, s, g, xdt, sdt, impl):
    _, pull = jax.vjp(lambda a, b: jops.rmsnorm(a, b, eps=1e-5, impl=impl),
                      _jax(x, xdt), _jax(s, sdt))
    dx, ds = pull(_jax(g, xdt))
    return np.asarray(dx.astype(jnp.float32)), np.asarray(ds.astype(jnp.float32))


def _close(got, want, xdt):
    np.testing.assert_allclose(got.float().numpy(), want, **TOL[xdt])


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("dtypes", sorted(DTYPES))
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_rmsnorm_bwd_plain_matches_jax(impl, dtypes, shape):
    xdt, sdt = DTYPES[dtypes]
    x, s, g = _inputs(shape, 20)
    want_dx, want_ds = _jax_grads(x, s, g, xdt, sdt, impl)
    dx, ds = ops.rmsnorm_bwd_plain(_torch(x, xdt), _torch(s, sdt), _torch(g, xdt), 1e-5)
    assert dx.dtype == getattr(torch, xdt) and dx.shape == shape
    assert ds.dtype == getattr(torch, sdt) and ds.shape == (shape[-1],)
    _close(dx, want_dx, xdt)
    _close(ds, want_ds, xdt)


@pytest.fixture
def plain_kernels(monkeypatch):
    """K1/K5's wrappers replaced by the plain versions, recording how the
    backward called K5."""
    calls = []

    def fwd(x, scale, eps):
        return ops.rmsnorm_plain(x, scale, eps)

    def bwd(x, scale, g, eps, need_dscale=True):
        calls.append(need_dscale)
        dx, ds = ops.rmsnorm_bwd_plain(x, scale, g, eps)
        return dx, (ds if need_dscale else None)

    monkeypatch.setattr(norms, "rmsnorm_cuda", fwd)
    monkeypatch.setattr(norms, "rmsnorm_bwd_cuda", bwd)
    return calls


@pytest.mark.parametrize("wrt", ["x", "scale", "both"])
def test_rmsnorm_autograd_wiring(plain_kernels, wrt):
    """``_RMSNorm`` (K1 forward, one K5 launch backward) on CPU tensors,
    gradients against ``jax.vjp`` of the Pallas kernel in interpret mode."""
    x, s, g = _inputs((4, 6, 64), 21)
    want_dx, want_ds = _jax_grads(x, s, g, "float32", "float32", "pallas_interpret")
    xt = _torch(x, "float32").requires_grad_(wrt in ("x", "both"))
    st = _torch(s, "float32").requires_grad_(wrt in ("scale", "both"))
    out = norms._RMSNorm.apply(xt, st, 1e-5)
    np.testing.assert_allclose(out.detach().numpy(),
                               np.asarray(jops.rmsnorm(jnp.asarray(x), jnp.asarray(s))),
                               atol=1e-5, rtol=0)
    leaves = [t for t in (xt, st) if t.requires_grad]
    grads = torch.autograd.grad(out, leaves, _torch(g, "float32"))
    want = {"x": [want_dx], "scale": [want_ds], "both": [want_dx, want_ds]}[wrt]
    for got, w in zip(grads, want):
        np.testing.assert_allclose(got.numpy(), w, atol=1e-5, rtol=0)
    assert plain_kernels == [wrt in ("scale", "both")]


def _no_build(*args, **kwargs):
    raise AssertionError("a kernel was built for CPU tensors")


@pytest.mark.parametrize("kernel", ["rmsnorm_cuda", "rmsnorm_bwd_cuda"])
def test_cuda_wrappers_refuse_cpu_tensors_before_building(monkeypatch, kernel):
    monkeypatch.setattr(_build, "library", _no_build)
    monkeypatch.setattr(_build, "entry", _no_build)
    x, s = torch.ones(2, 8), torch.ones(8)
    args = (x, s, 1e-5) if kernel == "rmsnorm_cuda" else (x, s, torch.ones(2, 8), 1e-5, True)
    ops.reset_launches()
    with pytest.raises(ValueError, match="CUDA tensors"):
        getattr(ops, kernel)(*args)
    assert ops.launches()["rmsnorm_fwd"] == ops.launches()["rmsnorm_bwd"] == 0
