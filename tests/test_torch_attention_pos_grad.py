"""The gradient of attention with explicit positions on the CPU: the port's
``ops.flash_attention_with_lse`` (the plain versions under autograd; on
the card K3-pos, K7-pos and K8-pos, which ``chip_smoke.py`` holds against
these) against the VJP of the JAX package's ``flash_attention_with_lse``
in interpret mode (its ``_dq_kernel`` / ``_dkv_kernel`` has_pos branches),
with cotangents for both outputs (the lse cotangent folds into delta).

One call covers three layouts, a batch row each: the striped permutation
(positions that do not rise), a windowed ring's past block (queries at
s + i over keys at j: query rows from window - 1 on attend nothing), and a
block wholly in the causal future (every row attends nothing). float32:
outputs and lse to 1e-5 (lse -inf on the same rows), gradients to 2e-6
absolute + 1e-4 relative; rows that attend nothing give zero gradients.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orion_tpu.ops.pallas.flash_attention import flash_attention_with_lse as j_flash_lse
from orion_tpu_torch import ops
from tests import torch_threads  # noqa: F401  (one intra-op thread)

S, N, K, H = 64, 4, 2, 16


def _layout():
    stripes = 4
    striped = np.arange(S).reshape(S // stripes, stripes).T.reshape(-1)
    iota = np.arange(S)
    qpos = np.stack([striped, S + iota, iota]).astype(np.int32)
    kpos = np.stack([striped, iota, 2 * S + iota]).astype(np.int32)
    rng = np.random.default_rng(0)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return (f(3, S, N, H), f(3, S, K, H), f(3, S, K, H), f(3, S, N, H), f(3, N, S),
            qpos, kpos)


@pytest.mark.parametrize("window,softcap", [(None, None), (24, 30.0)])
def test_positions_gradients_match_jax_kernel(window, softcap):
    q, k, v, do, g_lse, qpos, kpos = _layout()
    kw = dict(causal=True, window=window, logit_softcap=softcap)

    def jfn(a, b, c):
        return j_flash_lse(a, b, c, q_positions=jnp.asarray(qpos),
                           kv_positions=jnp.asarray(kpos), interpret=True, **kw)

    (jo, jl), vjp = jax.vjp(jfn, *(jnp.asarray(t) for t in (q, k, v)))
    jgrads = [np.asarray(g) for g in vjp((jnp.asarray(do), jnp.asarray(g_lse)))]

    leaves = [torch.from_numpy(t).requires_grad_() for t in (q, k, v)]
    out, lse = ops.flash_attention_with_lse(
        *leaves, q_positions=torch.from_numpy(qpos), kv_positions=torch.from_numpy(kpos), **kw)
    grads = torch.autograd.grad([out, lse], leaves,
                                [torch.from_numpy(do), torch.from_numpy(g_lse)])

    jl = np.asarray(jl)
    dead = np.isneginf(jl)                                   # [3, N, S]
    assert dead[2].all() and not dead[0].any()
    if window is not None:
        assert dead[1][:, window - 1:].all() and not dead[1][:, :window - 1].any()
    np.testing.assert_array_equal(np.isneginf(lse.detach().numpy()), dead)
    live_rows = ~dead.transpose(0, 2, 1)                     # [3, S, N]
    np.testing.assert_allclose(lse.detach().numpy()[~dead], jl[~dead], atol=1e-5, rtol=0)
    np.testing.assert_allclose(out.detach().numpy()[live_rows], np.asarray(jo)[live_rows],
                               atol=1e-5, rtol=0)
    for name, a, b in zip(("dq", "dk", "dv"), grads, jgrads):
        assert torch.isfinite(a).all(), name
        np.testing.assert_allclose(a.numpy(), b, atol=2e-6, rtol=1e-4, err_msg=name)
    # Rows that attend nothing: zero gradients (the future block wholly).
    assert not grads[0][2].any() and not grads[1][2].any() and not grads[2][2].any()
    assert not grads[0].numpy()[~live_rows].any()


def test_lse_cotangent_alone():
    """Only the lse used downstream (the merge's weights): the gradient
    through the lse cotangent alone, against the JAX kernel's VJP."""
    q, k, v, _, g_lse, qpos, kpos = _layout()
    kw = dict(causal=True)

    def jfn(a, b, c):
        return j_flash_lse(a, b, c, q_positions=jnp.asarray(qpos),
                           kv_positions=jnp.asarray(kpos), interpret=True, **kw)[1]

    _, vjp = jax.vjp(jfn, *(jnp.asarray(t) for t in (q, k, v)))
    jgrads = vjp(jnp.asarray(g_lse))
    leaves = [torch.from_numpy(t).requires_grad_() for t in (q, k, v)]
    _, lse = ops.flash_attention_with_lse(
        *leaves, q_positions=torch.from_numpy(qpos), kv_positions=torch.from_numpy(kpos), **kw)
    grads = torch.autograd.grad(lse, leaves, torch.from_numpy(g_lse), allow_unused=True)
    assert grads[2] is None   # the lse does not depend on v (the JAX VJP: zeros)
    for name, a, b in zip(("dq", "dk", "dv"), grads, jgrads):
        a = torch.zeros(b.shape) if a is None else a
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-6, rtol=1e-4,
                                   err_msg=name)


def test_positions_gradient_wrappers_refuse_cpu_tensors():
    """K7-pos and K8-pos launch only on CUDA tensors (the CPU takes the
    plain versions), refusing before any build."""
    q, k, v, do, g_lse, qpos, kpos = _layout()
    t = [torch.from_numpy(x) for x in (q, k, v, do)]
    lse = torch.zeros(3, N, S)
    for fn in (ops.flash_dq_pos_cuda, ops.flash_dkv_pos_cuda):
        with pytest.raises(ValueError, match="CUDA"):
            fn(*t, lse, lse, torch.from_numpy(qpos), torch.from_numpy(kpos))
