"""Attention at lengths and widths off the kernels' grid (L % 128 != 0, C not
in 64, 128, 256, 512).

The JAX package computes them with its XLA attention (``_attention_reference``)
and takes the gradient by autodiff. On the card the port zero-pads q, k, v
(and dO) to the kernels' grid, the kernels mask the padded keys' logits to
-inf and take the true scale, and the padded rows and channels are sliced
off. These tests run that route on the CPU with the kernels' plain versions
(pad -> masked plain version -> slice, ``attention._on_grid``) and hold it
against the JAX package on the same numpy inputs."""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from generative_detection_tpu.ops.attention import single_head_attention as jax_attention
from generative_detection_tpu_torch.ops import attention
from tests._torch_cpu import one_torch_thread  # noqa: F401 (autouse)

# a 384^2 pose config's mid block (24^2 at C = 512), a 320^2 plain
# autoencoder's lowest level (20^2), and attention at ch 48 (C = 96)
SHAPES = [(1, 576, 512), (2, 400, 512), (2, 256, 96)]
# Limits as tests/test_torch_port_attention_c64.py states them at C = 64,
# max |err| <= tol * RMS(JAX's result): fp32 the same arithmetic in another
# order; bf16 rounds P, O and the cotangents at other points than JAX's
# autodiff does. fp32's rounding in the C-long dot products grows as
# sqrt(C), so its limits scale by sqrt(C / 64): at (1, 576, 512) JAX's XLA
# attention and the plain version each sit 9.0e-6 and 6.0e-6 of the RMS from
# a float64 result, 1.16e-5 apart, past the C = 64 limit of 1e-5.
TOL = {
    torch.float32: {"fwd": 1e-5, "bwd": 2e-5},
    torch.bfloat16: {"fwd": 2e-2, "bwd": 5e-2},
}


def _tol(dtype, c, which):
    return TOL[dtype][which] * (max(c / 64, 1.0) ** 0.5 if dtype == torch.float32 else 1.0)
NP_DTYPES = {torch.float32: np.float32, torch.bfloat16: ml_dtypes.bfloat16}


def _close(got, want, tol):
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    rms = float(np.sqrt(np.mean(want**2)))
    err = float(np.abs(got - want).max())
    assert err <= tol * rms, f"max err {err} > {tol} x RMS {rms}"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SHAPES)
def test_padded_masked_route_matches_jax_forward_and_vjp(shape, dtype):
    rng = np.random.default_rng(sum(shape))
    arrays = [rng.normal(size=shape).astype(np.float32) for _ in range(4)]
    jq, jk, jv, jdo = (jnp.asarray(a.astype(NP_DTYPES[dtype])) for a in arrays)
    q, k, v, do = (torch.from_numpy(a).to(dtype) for a in arrays)
    want_o, vjp = jax.vjp(jax_attention, jq, jk, jv)
    want_grads = vjp(jdo)

    attention._check_kernel_args(q, k, v, do)  # the kernels take the shape
    copies = attention.single_head_attention.pad_copies
    o, lse = attention._on_grid(attention._attention_reference, (q, k, v))
    di = (do.float() * o.float()).sum(-1)
    grads = attention._on_grid(attention._attention_backward_reference, (q, k, v, do), (lse, di))
    assert attention.single_head_attention.pad_copies == copies + 2

    assert o.dtype == dtype and o.shape == shape and lse.shape == shape[:2]
    _close(o, want_o, _tol(dtype, shape[-1], "fwd"))
    for g, w in zip(grads, want_grads):
        assert g.dtype == dtype and g.shape == shape and g.is_contiguous()
        _close(g, w, _tol(dtype, shape[-1], "bwd"))


@pytest.mark.parametrize("l, c, grid", [
    (576, 512, (640, 512)), (400, 512, (512, 512)), (256, 96, (256, 128)), (100, 64, (128, 64)),
    (4096, 256, (4096, 256)), (256, 512, (256, 512)), (256, 64, (256, 64)),
])
def test_kernel_grid_rule(l, c, grid):
    """The shapes off the grid are padded to the next L % 128 == 0 and the
    next kernel width; the flagship's (B, 4096, 256), (B, 256, 512) and the
    tiny configs' (B, 256, 64) are on it and take no copy."""
    assert attention.kernel_shape(l, c) == grid
    q = torch.randn(1, l, c)
    copies = attention.single_head_attention.pad_copies
    o, _ = attention._on_grid(attention._attention_reference, (q, q, q))
    assert o.shape == q.shape
    assert attention.single_head_attention.pad_copies == copies + ((l, c) != grid)


def test_widths_past_512_raise():
    q = torch.zeros(1, 256, 640)
    with pytest.raises(ValueError, match="attention kernel takes C <= 512"):
        attention._check_kernel_args(q, q, q)
