"""Port parity on the CPU: flax-initialised JAX parameters go through
``state_dict_from_jax`` into the port (``load_state_dict(strict=True)``), and
each piece of the network is held to the JAX package in fp32.

Tolerance: 1e-4 of the reference's largest magnitude. Both sides compute in
fp32 on the CPU with convolutions and sums in another order."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generative_detection_tpu.models.blocks import AttnBlock as JaxAttnBlock
from generative_detection_tpu.models.blocks import ResnetBlock as JaxResnetBlock
from generative_detection_tpu.utils.distributions import (
    DiagonalGaussianDistribution as JaxGaussian,
)
from generative_detection_tpu.models.autoencoder import rescale_minmax as jax_rescale_minmax
from generative_detection_tpu_torch.models import PoseAutoencoder, rescale_minmax
from generative_detection_tpu_torch.models.blocks import AttnBlock, ResnetBlock
from generative_detection_tpu_torch.utils.distributions import DiagonalGaussianDistribution
from generative_detection_tpu_torch.utils.jax_compat import state_dict_from_jax
from tests.test_models import SMALL_DD, SMALL_LOSSCONFIG, small_model


def _close(got, want, rel=1e-4):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= rel * scale, f"max err {err} > {rel} * {scale}"


def port_small_model():
    return PoseAutoencoder(
        ddconfig=SMALL_DD, lossconfig=SMALL_LOSSCONFIG, embed_dim=16, input_size=32,
        dropout_warmup_steps=10, pose_conditioned_generation_steps=10,
    )


def jax_net_params(m, batch=2):
    x = jnp.zeros((batch, 32, 32, 3))
    k = jax.random.PRNGKey(0)
    rngs = {"params": k, "sample": k, "dropout": k, "noise": k}
    params = m.net.init(rngs, x, jnp.asarray(0, jnp.int32))["params"]
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.fixture(scope="module")
def nets():
    jm = small_model()
    params = jax_net_params(jm)
    net = port_small_model().build_net()
    net.load_state_dict(state_dict_from_jax(params), strict=True)
    return jm, params, net.eval()


def test_state_dict_from_jax_covers_every_port_key(nets):
    _, params, net = nets
    sd = state_dict_from_jax(params)
    assert set(sd) == set(net.state_dict())
    assert "encoder.mid.block_1.norm1.weight" in sd
    assert "encoder.down.1.attn.0.q.weight" in sd
    assert "pose_decoder.layers.4.weight" in sd and "pose_encoder.layers.3.weight" in sd


def test_encode_matches_jax(nets):
    jm, params, net = nets
    x = np.random.default_rng(0).normal(size=(2, 32, 32, 3)).astype(np.float32)
    post_j, feat_j = jm.net.apply({"params": params}, jnp.asarray(x), method=jm.net.encode)
    with torch.no_grad():
        post, feat = net.encode(torch.from_numpy(x))
    _close(post.mean, post_j.mean)
    _close(post.logvar, post_j.logvar)
    _close(feat, feat_j)


def test_pose_decode_and_encode_match_jax(nets):
    jm, params, net = nets
    rng = np.random.default_rng(1)
    feat = rng.normal(size=(2, 16, 16, 16)).astype(np.float32)
    dec_j, bbox_j = jm.net.apply(
        {"params": params}, jnp.asarray(feat), False, method=jm.net._decode_pose,
        rngs={"sample": jax.random.PRNGKey(0)},
    )
    with torch.no_grad():
        dec, bbox = net._decode_pose(torch.from_numpy(feat), sample_posterior=False)
    _close(dec, dec_j)
    _close(bbox.logvar, bbox_j.logvar)
    pose = rng.normal(size=(2, 19)).astype(np.float32)
    enc_j = jm.net.apply({"params": params}, jnp.asarray(pose), method=jm.net._encode_pose)
    with torch.no_grad():
        enc = net._encode_pose(torch.from_numpy(pose))
    _close(enc, enc_j)


def test_decode_matches_jax(nets):
    jm, params, net = nets
    z = np.random.default_rng(2).normal(size=(2, 16, 16, 16)).astype(np.float32)
    out_j, pre_j = jm.net.apply(
        {"params": params}, jnp.asarray(z), True, method=jm.net.decode
    )
    with torch.no_grad():
        out, pre = net.decode(torch.from_numpy(z), return_pre_out=True)
    _close(out, out_j)
    _close(pre, pre_j)


def _block_state_dict(params):
    sd = state_dict_from_jax({"encoder": {"down_0_block_0": params}})
    return {k.removeprefix("encoder.down.0.block.0."): v for k, v in sd.items()}


def _to_port(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)


@pytest.mark.parametrize(
    "kind, shape", [("resnet", (1, 64, 64, 128)), ("attn", (1, 64, 64, 256))]
)
def test_flagship_width_block_matches_jax(kind, shape):
    x = np.random.default_rng(3).normal(size=shape).astype(np.float32)
    if kind == "resnet":
        jblock, block = JaxResnetBlock(256), ResnetBlock(128, 256)
    else:
        jblock, block = JaxAttnBlock(), AttnBlock(256)
    params = jblock.init(jax.random.PRNGKey(4), jnp.asarray(x))["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    block.load_state_dict(_block_state_dict(params), strict=True)
    want = jblock.apply({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        got = block(_to_port(x)).permute(0, 2, 3, 1)
    _close(got, want)


def test_diagonal_gaussian_matches_jax():
    p = np.random.default_rng(5).normal(size=(2, 4, 4, 8)).astype(np.float32) * 30
    d = DiagonalGaussianDistribution.from_parameters(torch.from_numpy(p), dim=-1)
    dj = JaxGaussian.from_parameters(jnp.asarray(p), axis=-1)
    for name in ("mean", "logvar", "std", "var"):
        np.testing.assert_allclose(
            getattr(d, name).numpy(), np.asarray(getattr(dj, name)), rtol=1e-6
        )
    assert torch.equal(d.mode(), d.mean)
    g = torch.Generator().manual_seed(0)
    s = d.sample(g)
    assert s.shape == d.mean.shape and torch.isfinite(s).all()


@pytest.mark.parametrize("num_shards", [1, 2])
def test_rescale_minmax_matches_jax(num_shards):
    x = np.random.default_rng(6).uniform(0, 255, size=(4, 8, 8, 3)).astype(np.float32)
    np.testing.assert_allclose(
        rescale_minmax(torch.from_numpy(x), num_shards).numpy(),
        np.asarray(jax_rescale_minmax(jnp.asarray(x), num_shards)),
        rtol=1e-6, atol=1e-6,
    )
