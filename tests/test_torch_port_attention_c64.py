"""Attention at C = 64, the width of the repo's tiny configs (tiny_cpu.yaml,
plain_kl_tiny.yaml: every attention site at (B, 256, 64)).

The JAX package sends C % 128 != 0 to its XLA attention
(``_attention_reference``: fp32 logits, P rounded to v's dtype) and takes
its gradient by autodiff. The port runs its kernels there on the card; on the
CPU it runs their plain versions, which these tests hold against the JAX
package on the same numpy inputs."""

from pathlib import Path

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from generative_detection_tpu.ops.attention import single_head_attention as jax_attention
from generative_detection_tpu_torch.config import instantiate_from_config, merge_configs
from generative_detection_tpu_torch.models.blocks import AttnBlock
from generative_detection_tpu_torch.ops import attention
from tests._torch_cpu import one_torch_thread  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parents[1]
SHAPE = (2, 256, 64)

# Limits, port against the JAX package, max |err| <= tol * RMS(JAX's result):
# - fp32: the same fp32 arithmetic summed in another order;
# - bf16 forward: both round P to bf16 and O to bf16 from fp32 values that
#   differ in the last bits (one bf16 ulp is 2^-8 relative);
# - bf16 backward: the port rounds where the TPU kernel does (P to dO's
#   dtype before dV, dS to q's dtype before dK and dQ); JAX's autodiff of
#   the XLA route rounds its cotangents at other points (dP and dlogits in
#   bf16), a few bf16 ulps of each gradient.
TOL = {
    torch.float32: {"fwd": 1e-5, "bwd": 2e-5},
    torch.bfloat16: {"fwd": 2e-2, "bwd": 5e-2},
}
NP_DTYPES = {torch.float32: np.float32, torch.bfloat16: ml_dtypes.bfloat16}


def _inputs(dtype):
    rng = np.random.default_rng(64)
    arrays = [rng.normal(size=SHAPE).astype(np.float32) for _ in range(4)]
    jax_in = [jnp.asarray(a.astype(NP_DTYPES[dtype])) for a in arrays]
    torch_in = [torch.from_numpy(a).to(dtype) for a in arrays]
    return jax_in, torch_in


def _close(got, want, tol):
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    rms = float(np.sqrt(np.mean(want**2)))
    err = float(np.abs(got - want).max())
    assert err <= tol * rms, f"max err {err} > {tol} x RMS {rms}"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_c64_matches_jax_forward_and_vjp(dtype):
    (jq, jk, jv, jdo), (q, k, v, do) = _inputs(dtype)
    want_o, vjp = jax.vjp(jax_attention, jq, jk, jv)
    want_grads = vjp(jdo)

    q, k, v = (t.requires_grad_(True) for t in (q, k, v))
    o = attention.single_head_attention(q, k, v)
    grads = torch.autograd.grad(o, (q, k, v), do)

    assert o.dtype == dtype and o.shape == SHAPE
    _close(o.detach(), want_o, TOL[dtype]["fwd"])
    for g, w in zip(grads, want_grads):
        assert g.dtype == dtype and g.shape == SHAPE
        _close(g, w, TOL[dtype]["bwd"])
    # the shape is one the kernels take on a CUDA tensor
    attention._check_kernel_args(q, k, v, do)


def test_tiny_config_encoder_runs_attention_at_its_own_width():
    """tiny_cpu.yaml at ch 32 (no override): the encoder's two attention
    sites are (2, 256, 64), and the kernels' gate admits them."""
    model = instantiate_from_config(
        merge_configs([str(REPO / "configs/autoencoder/pose/tiny_cpu.yaml")])["model"]
    )
    net = model.init_net(torch.Generator().manual_seed(0), device="cpu")
    seen = []

    def on_attn(_m, inp, out):
        b, c, h, w = inp[0].shape
        seen.append((b, h * w, c))
        assert torch.isfinite(out).all()

    for m in net.encoder.modules():
        if isinstance(m, AttnBlock):
            m.register_forward_hook(on_attn)
    x = torch.from_numpy(np.random.default_rng(3).uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32))
    with torch.no_grad():
        out = net.encode(x)
    assert seen == [SHAPE, SHAPE]
    assert torch.isfinite(out[1]).all() and torch.isfinite(out[0].mean).all()
    q = torch.zeros(SHAPE)
    attention._check_kernel_args(q, q, q)
