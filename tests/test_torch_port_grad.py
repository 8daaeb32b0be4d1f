"""Port parity on the CPU for the gradients of the kernel ops and the small
loss functions: the port's GroupNorm and attention backward (the plain
versions its CPU path runs) against the JAX package's Pallas backward kernels
in interpret mode and its closed forms; the focal loss and the Gaussian KL /
NLL against the JAX package.

Inputs are made with numpy from a seed and handed to both frameworks as numpy
arrays. Tolerances:
- fp32: the same fp32 arithmetic in another summation order, so 1e-5 of the
  largest magnitude of the reference (1e-4 for sums over a whole GroupNorm
  group, dgamma and dbeta);
- bf16: both sides start from the same bf16 inputs and round their fp32
  results to bf16 at the same points; two roundings of fp32 values that
  differ in the last bits can sit one bf16 ulp apart (2^-7 relative), and in
  attention a flipped rounding of P or dS moves a sum over L by about one ulp
  of one term.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from generative_detection_tpu.ops.attention import _make_attention_custom
from generative_detection_tpu.ops.focal import sigmoid_focal_loss as jax_focal
from generative_detection_tpu.ops.norm import _make_gn_chunked_custom_vjp, _make_gn_custom_vjp
from generative_detection_tpu.utils.distributions import (
    DiagonalGaussianDistribution as JaxGaussian,
)
from generative_detection_tpu.utils.distributions import kl_vs_prior_table as jax_kl_table
from generative_detection_tpu_torch.ops import group_norm, single_head_attention
from generative_detection_tpu_torch.ops.focal import sigmoid_focal_loss
from generative_detection_tpu_torch.ops.norm import (
    _gn_backward_reference,
    _gn_forward_reference,
    group_norm_backward,
)
from generative_detection_tpu_torch.utils.distributions import (
    DiagonalGaussianDistribution,
    kl_vs_prior_table,
)
from tests._torch_cpu import one_torch_thread  # noqa: F401 (autouse)

_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_JAX = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _bf16_round(a, dtype):
    return a.astype(ml_dtypes.bfloat16).astype(np.float32) if dtype == "bfloat16" else a


def _np(x):
    return np.asarray(x.detach().float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32))


def _close(got, want, rel, rtol=0.0):
    """|got - want| <= rel * max|want| + rtol * |want| elementwise."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rel * np.abs(want).max())


# dx: (rel of max |dx|, rtol); dgamma / dbeta: rel of their max
_GN_TOL = {"float32": ((1e-5, 0.0), 1e-4), "bfloat16": ((1e-2, 8e-3), 1e-4)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", [None, "silu"])
def test_group_norm_backward_matches_jax_kernels_and_closed_form(act, dtype):
    rng = np.random.default_rng(10)
    shape = (2, 8, 8, 128)
    x = _bf16_round((rng.normal(size=shape) * 2 + 0.5).astype(np.float32), dtype)
    dy = _bf16_round(rng.normal(size=shape).astype(np.float32), dtype)
    gamma = (1 + 0.1 * rng.normal(size=128)).astype(np.float32)
    beta = (0.1 * rng.normal(size=128)).astype(np.float32)

    xt = torch.from_numpy(x).to(_TORCH[dtype]).requires_grad_(True)
    gt = torch.from_numpy(gamma).requires_grad_(True)
    bt = torch.from_numpy(beta).requires_grad_(True)
    y = group_norm(xt, gt, bt, 32, 1e-6, act)
    y.backward(torch.from_numpy(dy).to(_TORCH[dtype]))
    assert xt.grad.dtype == _TORCH[dtype] and gt.grad.dtype == torch.float32

    args = (jnp.asarray(x, _JAX[dtype]), jnp.asarray(gamma), jnp.asarray(beta))
    dyj = jnp.asarray(dy, _JAX[dtype])
    (dx_tol, dg_tol) = _GN_TOL[dtype]
    for make in (_make_gn_chunked_custom_vjp, _make_gn_custom_vjp):
        yj, vjp = jax.vjp(make(32, 1e-6, act, True), *args)
        dxj, dgj, dbj = vjp(dyj)
        _close(y, yj, *dx_tol)
        _close(xt.grad, dxj, *dx_tol)
        _close(gt.grad, dgj, dg_tol)
        _close(bt.grad, dbj, dg_tol)


def test_group_norm_backward_takes_the_forward_stats():
    """The CPU path's backward is the plain closed form on the forward's
    (mean, rstd), and it never recomputes them: corrupting the saved stats
    changes the gradient."""
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.normal(size=(1, 4, 4, 64)).astype(np.float32))
    dy = torch.from_numpy(rng.normal(size=(1, 4, 4, 64)).astype(np.float32))
    gamma, beta = torch.ones(64), torch.zeros(64)
    _, mean, rstd = _gn_forward_reference(x, gamma, beta, 32, 1e-6, "silu")
    got = group_norm_backward(x, dy, (mean, rstd), gamma, beta, 32, 1e-6, "silu")
    want = _gn_backward_reference(x, dy, mean, rstd, gamma, beta, "silu")
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    moved = group_norm_backward(x, dy, (mean + 1.0, rstd), gamma, beta, 32, 1e-6, "silu")
    assert not torch.allclose(moved[0], got[0])
    with torch.no_grad():
        out = group_norm(x.requires_grad_(True), gamma, beta, 32, 1e-6, "silu")
    assert out.grad_fn is None


# (rel of max |grad|, rtol) per dtype
_ATTN_TOL = {"float32": (1e-5, 0.0), "bfloat16": (2e-2, 8e-3)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_backward_matches_jax_pallas_kernel(dtype):
    rng = np.random.default_rng(12)
    shape = (2, 256, 128)
    q, k, v, do = (_bf16_round(rng.normal(size=shape).astype(np.float32), dtype)
                   for _ in range(4))
    qt, kt, vt = (torch.from_numpy(a).to(_TORCH[dtype]).requires_grad_(True) for a in (q, k, v))
    o = single_head_attention(qt, kt, vt)
    o.backward(torch.from_numpy(do).to(_TORCH[dtype]))

    fn = _make_attention_custom(128, True)
    oj, vjp = jax.vjp(fn, *(jnp.asarray(a, _JAX[dtype]) for a in (q, k, v)))
    grads = vjp(jnp.asarray(do, _JAX[dtype]))
    _close(o, oj, *_ATTN_TOL[dtype])
    for got, want in zip((qt.grad, kt.grad, vt.grad), grads):
        assert got.dtype == _TORCH[dtype]
        _close(got, want, *_ATTN_TOL[dtype])


def test_sigmoid_focal_loss_matches_jax():
    rng = np.random.default_rng(13)
    logits = (rng.normal(size=(6, 11)) * 3).astype(np.float32)
    targets = np.array([0, 3, 10, 11, 5, 11], np.int32)  # 11 == num_classes: all negative
    weight = rng.uniform(size=6).astype(np.float32)
    for kw in ({}, {"reduction": "sum"}, {"reduction": "none"}, {"avg_factor": 4.0}):
        got = sigmoid_focal_loss(torch.from_numpy(logits), torch.from_numpy(targets), **kw)
        want = jax_focal(jnp.asarray(logits), jnp.asarray(targets), **kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)
    got = sigmoid_focal_loss(torch.from_numpy(logits), torch.from_numpy(targets),
                             weight=torch.from_numpy(weight))
    want = jax_focal(jnp.asarray(logits), jnp.asarray(targets), weight=jnp.asarray(weight))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def test_gaussian_kl_and_nll_match_jax():
    rng = np.random.default_rng(14)
    p = (rng.normal(size=(3, 4, 4, 8)) * 2).astype(np.float32)
    d = DiagonalGaussianDistribution.from_parameters(torch.from_numpy(p), dim=-1)
    dj = JaxGaussian.from_parameters(jnp.asarray(p), axis=-1)
    np.testing.assert_allclose(d.kl().numpy(), np.asarray(dj.kl()), rtol=1e-5)
    s = rng.normal(size=(3, 4, 4, 4)).astype(np.float32)
    np.testing.assert_allclose(
        d.nll(torch.from_numpy(s)).numpy(), np.asarray(dj.nll(jnp.asarray(s))), rtol=1e-5
    )
    # against another distribution: (B, 8) posterior vs a (1, 8) prior
    m, lv = (rng.normal(size=(3, 8)).astype(np.float32) for _ in range(2))
    pm, plv = (rng.normal(size=(1, 8)).astype(np.float32) for _ in range(2))
    post = DiagonalGaussianDistribution(torch.from_numpy(m), torch.from_numpy(lv))
    prior = DiagonalGaussianDistribution(torch.from_numpy(pm), torch.from_numpy(plv))
    want = JaxGaussian(jnp.asarray(m), jnp.asarray(lv)).kl(
        JaxGaussian(jnp.asarray(pm), jnp.asarray(plv)))
    np.testing.assert_allclose(post.kl(prior).numpy(), np.asarray(want), rtol=1e-5)
    assert torch.equal(
        DiagonalGaussianDistribution(post.mean, post.logvar, deterministic=True).kl(),
        torch.zeros(3),
    )


def test_kl_vs_prior_table_matches_jax():
    rng = np.random.default_rng(15)
    m, lv, pm, plv = (rng.normal(size=(5, 8)).astype(np.float32) for _ in range(4))
    got = kl_vs_prior_table(*map(torch.from_numpy, (m, lv, pm, plv)))
    want = jax_kl_table(*map(jnp.asarray, (m, lv, pm, plv)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
