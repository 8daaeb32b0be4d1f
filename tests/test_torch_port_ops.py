"""Port parity on the CPU: the port's GroupNorm and attention against the JAX
package's plain versions and its Pallas kernels (interpret mode), plus the
port's config loader and its independence from JAX.

Inputs are made with numpy from a seed and handed to both frameworks as numpy
arrays."""

import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from generative_detection_tpu.ops.attention import _attention_reference as jax_attention
from generative_detection_tpu.ops.attention import _mha_fwd_call
from generative_detection_tpu.ops.norm import _gn_pallas
from generative_detection_tpu.ops.norm import _gn_reference as jax_gn
from generative_detection_tpu_torch.config import instantiate_from_config, merge_configs
from generative_detection_tpu_torch.losses import LPIPSWithDiscriminator, PoseLoss
from generative_detection_tpu_torch.models import Autoencoder, PoseAutoencoder
from generative_detection_tpu_torch.ops import attention, group_norm, single_head_attention
from generative_detection_tpu_torch.ops.norm import _gn_reference
from tests._torch_cpu import one_torch_thread  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parents[1]
_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_JAX = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
# fp32: the same one-pass fp32 arithmetic in another summation order.
# bf16: both round the same fp32 value to bf16 (one ulp is 2^-8 relative),
# from fp32 values that differ in the last bits.
_GN_TOL = {"float32": dict(rtol=0, atol=1e-5), "bfloat16": dict(rtol=1e-2, atol=2e-2)}


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else jnp.asarray(x, jnp.float32))


def _gn_inputs(seed, shape, dtype):
    rng = np.random.default_rng(seed)
    c = shape[-1]
    x = (rng.normal(size=shape) * 2.0 + 0.5).astype(np.float32)
    if dtype == "bfloat16":  # both frameworks start from the same bf16 values
        x = x.astype(ml_dtypes.bfloat16).astype(np.float32)
    gamma = (1.0 + 0.1 * rng.normal(size=c)).astype(np.float32)
    beta = (0.1 * rng.normal(size=c)).astype(np.float32)
    return x, gamma, beta


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", [None, "silu"])
def test_group_norm_matches_jax_reference_and_pallas_kernel(act, dtype):
    x, gamma, beta = _gn_inputs(0, (2, 8, 8, 128), dtype)
    got = group_norm(
        torch.from_numpy(x).to(_TORCH[dtype]), torch.from_numpy(gamma),
        torch.from_numpy(beta), 32, 1e-6, act,
    )
    assert got.dtype == _TORCH[dtype] and got.shape == x.shape
    xj = jnp.asarray(x, _JAX[dtype])
    want_ref = jax_gn(xj, jnp.asarray(gamma), jnp.asarray(beta), 32, 1e-6, act)
    want_kernel = _gn_pallas(xj, jnp.asarray(gamma), jnp.asarray(beta), 32, 1e-6, act,
                             interpret=True)
    np.testing.assert_allclose(_np(got), _np(want_ref), **_GN_TOL[dtype])
    np.testing.assert_allclose(_np(got), _np(want_kernel), **_GN_TOL[dtype])


def test_group_norm_clamps_negative_variance():
    """A constant group has zero variance, but the one-pass E[x^2] - E[x]^2
    rounds below -eps for some constants (47.9 and 63.7 here), where rsqrt
    without the clamp gives NaN."""
    consts = [0.1, 7.1, 47.9, 63.7]
    x = torch.tensor(consts).reshape(-1, 1, 1, 1).expand(-1, 4, 4, 64).contiguous()
    xg = x.reshape(len(consts), 16, 32, 2)
    raw_var = xg.square().mean(dim=(1, 3)) - xg.mean(dim=(1, 3)).square()
    assert (raw_var + 1e-6 < 0).any(), "precondition: the clamp must matter"
    gamma, beta = torch.full((64,), 1.0), torch.full((64,), 0.25)
    got = group_norm(x, gamma, beta, 32, 1e-6, "silu")
    want = jax_gn(jnp.asarray(x.numpy()), jnp.asarray(gamma.numpy()),
                  jnp.asarray(beta.numpy()), 32, 1e-6, "silu")
    assert torch.isfinite(got).all()
    # x - mean is a rounding residue of an ulp or two of x, amplified by
    # rstd <= eps^-0.5 = 1000: one ulp of 63.7 gives 7.6e-3
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=2e-2)


def test_group_norm_reference_is_the_cpu_path():
    x, gamma, beta = _gn_inputs(1, (1, 4, 4, 64), "float32")
    args = (torch.from_numpy(x), torch.from_numpy(gamma), torch.from_numpy(beta))
    assert torch.equal(group_norm(*args, 32, 1e-6, None), _gn_reference(*args, 32, 1e-6, None))
    with pytest.raises(ValueError, match="not divisible"):
        group_norm(args[0][..., :48], args[1][:48], args[2][:48], 32)


def _qkv(seed, shape):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for _ in range(3)]


def test_attention_matches_jax_pallas_kernel_with_lse():
    q, k, v = _qkv(2, (1, 256, 128))
    o, lse = single_head_attention(*map(torch.from_numpy, (q, k, v)), return_lse=True)
    o_k, lse_k = _mha_fwd_call(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 128, True)
    assert o.shape == (1, 256, 128) and lse.shape == (1, 256) and lse.dtype == torch.float32
    # fp32 on both sides; sums over 128 channels and 256 keys in another order
    np.testing.assert_allclose(o.numpy(), np.asarray(o_k), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_k)[:, 0, :], rtol=1e-5, atol=1e-5)


def test_attention_matches_jax_reference_at_flagship_width():
    q, k, v = _qkv(3, (1, 4096, 256))
    o = single_head_attention(*map(torch.from_numpy, (q, k, v)))
    want = jax_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    np.testing.assert_allclose(o.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize(
    "l, c, ok",
    [(4096, 256, True), (256, 512, True), (16384, 256, True), (256, 64, True), (192, 256, False),
     (256, 96, False)],
)
def test_attention_kernel_gate(l, c, ok):
    # ``ok``: on the kernels' grid (L % 128 == 0, the JAX package's gate; C in
    # 64, 128, 256, 512). Every (L, C) the flagship detector and train step
    # run, L = 16384 and the tiny configs' (256, 64) are, and run as they are;
    # L = 192 and C = 96 are not, and are padded to (256, 256) and (256, 128).
    # The kernels take both. Checked on CPU tensors.
    q = torch.zeros(1, l, c, dtype=torch.bfloat16)
    attention._check_kernel_args(q, q, q)
    assert (attention.kernel_shape(l, c) == (l, c)) == ok


def test_attention_rejects_mismatched_inputs():
    q = torch.zeros(1, 64, 128)
    with pytest.raises(ValueError):
        single_head_attention(q, q[:, :32], q)
    with pytest.raises(ValueError):
        single_head_attention(q, q.double(), q)


@pytest.mark.parametrize(
    "name",
    ["autoencoder_kl_16x16x16", "local_autoencoder_kl_16x16x16", "synthetic_smoke", "tiny_cpu"],
)
def test_pose_configs_build_port_objects(name):
    cfg = merge_configs([str(REPO / "configs/autoencoder/pose" / f"{name}.yaml")])
    model = instantiate_from_config(cfg["model"])
    assert isinstance(model, PoseAutoencoder)
    assert model.num_classes == cfg["model"]["params"]["lossconfig"]["params"]["num_classes"]
    net = model.build_net()
    assert type(net.pose_decoder).__module__.startswith("generative_detection_tpu_torch")
    assert type(net.pose_encoder).__module__.startswith("generative_detection_tpu_torch")


@pytest.mark.parametrize(
    "target",
    [
        "src.modules.losses.LPIPSWithDiscriminator",
        "generative_detection_tpu.models.autoencoder.Autoencoder",
        "src.models.autoencoder.Autoencoder",
        "generative_detection_tpu.losses.contperceptual.LPIPSWithDiscriminator",
    ],
)
def test_plain_autoencoder_targets_build_the_port_classes(target):
    plain = merge_configs([str(REPO / "configs/autoencoder/plain_kl_tiny.yaml")])["model"]
    params = plain["params"] if target.endswith(".Autoencoder") else {"disc_start": 7}
    obj = instantiate_from_config({"target": target, "params": params})
    if target.endswith(".Autoencoder"):
        assert isinstance(obj, Autoencoder) and obj.step_family == "plain"
        assert isinstance(obj.build_loss(), LPIPSWithDiscriminator)
    else:
        assert isinstance(obj, LPIPSWithDiscriminator) and obj.disc_start == 7
        assert not obj.logvar.requires_grad


@pytest.mark.parametrize(
    "target",
    [
        "src.modules.losses.PoseLoss",
        "src.modules.losses.contperceptual.PoseLoss",
        "generative_detection_tpu.losses.contperceptual.PoseLoss",
    ],
)
def test_pose_loss_targets_build_the_port_loss(target):
    loss = instantiate_from_config(
        {"target": target, "params": {"num_classes": 11, "disc_start": 5, "disc_weight": 0.5,
                                      "dataset_stats_path": None}}
    )
    assert isinstance(loss, PoseLoss)
    assert (loss.disc_start, loss.disc_weight, loss.num_classes) == (5, 0.5, 11)
    assert not loss.logvar.requires_grad
    plain = instantiate_from_config(
        {"target": "generative_detection_tpu.losses.contperceptual.LPIPSWithDiscriminator",
         "params": {}}
    )
    assert isinstance(plain, LPIPSWithDiscriminator) and not isinstance(plain, PoseLoss)


def test_port_imports_without_jax():
    """Every module of the port (and chip_smoke.py) imports with jax, flax,
    optax, orbax and the JAX package made unimportable."""
    code = (
        "import sys, importlib, pkgutil\n"
        "for m in ('jax', 'flax', 'optax', 'orbax', 'generative_detection_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import generative_detection_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "import chip_smoke\n"
        "print(len(names))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 46
