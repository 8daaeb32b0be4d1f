"""The port's CUDA kernels against their plain PyTorch versions on the card,
and the tiny detector and train step on the card against the CPU.

Needs a CUDA card, ``nvcc`` and no JAX: run with
``python -m pytest -m gpu --noconftest tests/test_torch_port_gpu.py``.
Without a card every test skips (decided in the fixture, not at import)."""

from pathlib import Path

import numpy as np
import pytest
import torch

from generative_detection_tpu_torch.config import instantiate_from_config, merge_configs
from generative_detection_tpu_torch.ops import attention, norm
from generative_detection_tpu_torch.serving import make_detector_fn
from generative_detection_tpu_torch.train import create_train_state, make_train_step

pytestmark = pytest.mark.gpu
REPO = Path(__file__).resolve().parents[1]

GN_ROWS = [(256, 128), (128, 128), (64, 128), (64, 256), (32, 256), (16, 256), (16, 512)]
# fp32: the same fp32 arithmetic in another order. bf16: both sides round the
# fp32 result to bf16 (one ulp is 2^-8 relative) from values that differ in
# the last bits.
GN_TOL = {torch.float32: dict(rtol=0, atol=1e-4), torch.bfloat16: dict(rtol=8e-3, atol=2e-2)}
# Attention: max |err| <= tol * RMS(plain). A row's softmax spreads over about
# L/e keys, so the output's RMS is about sqrt(e / L); an absolute limit would
# hide a dropped K/V tile at L=4096. bf16 also rounds P to bf16 against a
# running rather than the final max.
ATTN_REL_TOL = {torch.float32: 1e-3, torch.bfloat16: 0.1}
# GroupNorm dx, |err| <= tol * RMS(plain dx) + rtol * |plain dx|: fp32
# differs in summation order only; bf16 rounds dx to bf16 from fp32 values
# that differ in the last bits, so the two can sit one bf16 ulp apart (up to
# 2^-7 relative), as in the forward. dgamma/dbeta are fp32 sums of the same
# products in another order: 1e-4 of their largest magnitude.
GN_BWD_TOL = {torch.float32: (1e-4, 0.0), torch.bfloat16: (2e-2, 8e-3)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _gn_inputs(g, shape, dtype):
    c = shape[-1]
    x = (torch.randn(shape, device="cuda", generator=g) * 2 + 0.5).to(dtype)
    gamma = 1 + 0.1 * torch.randn(c, device="cuda", generator=g)
    beta = 0.1 * torch.randn(c, device="cuda", generator=g)
    return x, gamma, beta


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act", [None, "silu"])
@pytest.mark.parametrize("hw, c", GN_ROWS)
def test_group_norm_kernel_matches_plain(cuda, hw, c, act, dtype):
    x, gamma, beta = _gn_inputs(cuda, (2, hw, hw, c), dtype)
    before = norm.group_norm.launches
    got = norm.group_norm(x, gamma, beta, 32, 1e-6, act)
    want = norm._gn_reference(x, gamma, beta, 32, 1e-6, act)
    torch.cuda.synchronize()
    assert norm.group_norm.launches == before + 1
    assert got.dtype == dtype and got.is_contiguous()
    torch.testing.assert_close(got.float(), want.float(), **GN_TOL[dtype])


def test_group_norm_kernel_is_deterministic(cuda):
    x, gamma, beta = _gn_inputs(cuda, (4, 128, 128, 128), torch.float32)
    a = norm.group_norm(x, gamma, beta, 32, 1e-6, "silu")
    b = norm.group_norm(x, gamma, beta, 32, 1e-6, "silu")
    assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 4096, 256), (2, 256, 512), (1, 256, 128)])
def test_attention_kernel_matches_plain(cuda, shape, dtype):
    q, k, v = (torch.randn(shape, device="cuda", generator=cuda).to(dtype) for _ in range(3))
    before = attention.single_head_attention.launches
    o, lse = attention.single_head_attention(q, k, v, return_lse=True)
    want_o, want_lse = attention._attention_reference(q, k, v)
    torch.cuda.synchronize()
    assert attention.single_head_attention.launches == before + 1
    assert o.dtype == dtype and lse.shape == shape[:2]
    want_o = want_o.float()
    limit = ATTN_REL_TOL[dtype] * want_o.pow(2).mean().sqrt()
    assert (o.float() - want_o).abs().max() <= limit
    torch.testing.assert_close(lse, want_lse, rtol=0, atol=1e-3)


def _rms_close(got, want, tol, rtol=0.0):
    """|got - want| <= tol * RMS(want) + rtol * |want| elementwise."""
    want = want.float()
    err = (got.float() - want).abs()
    limit = tol * want.pow(2).mean().sqrt() + rtol * want.abs()
    assert (err <= limit).all(), f"max err {err.max()}, {int((err > limit).sum())} outside"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act", [None, "silu"])
@pytest.mark.parametrize("hw, c", GN_ROWS)
def test_group_norm_backward_kernel_matches_plain(cuda, hw, c, act, dtype):
    x, gamma, beta = _gn_inputs(cuda, (2, hw, hw, c), dtype)
    dy = torch.randn(x.shape, device="cuda", generator=cuda).to(dtype)
    _, partial = norm._gn_cuda(x, gamma, beta, 32, 1e-6, act)
    _, mean, rstd = norm._gn_forward_reference(x, gamma, beta, 32, 1e-6, act)
    before = norm.group_norm_backward.launches
    dx, dgamma, dbeta = norm.group_norm_backward(x, dy, (partial,), gamma, beta, 32, 1e-6, act)
    want = norm._gn_backward_reference(x, dy, mean, rstd, gamma, beta, act)
    torch.cuda.synchronize()
    assert norm.group_norm_backward.launches == before + 1
    assert dx.dtype == dtype and dgamma.dtype == torch.float32 and dgamma.shape == (c,)
    _rms_close(dx, want[0], *GN_BWD_TOL[dtype])
    for got, w in zip((dgamma, dbeta), want[1:]):
        torch.testing.assert_close(got, w, rtol=0, atol=1e-4 * w.abs().max().item())


def test_group_norm_autograd_runs_the_backward_kernel(cuda):
    x, gamma, beta = _gn_inputs(cuda, (2, 32, 32, 256), torch.bfloat16)
    x.requires_grad_(True)
    gamma.requires_grad_(True)
    before = norm.group_norm_backward.launches
    norm.group_norm(x, gamma, beta, 32, 1e-6, "silu").float().square().sum().backward()
    assert norm.group_norm_backward.launches == before + 1
    assert x.grad.dtype == torch.bfloat16 and torch.isfinite(x.grad).all()
    assert torch.isfinite(gamma.grad).all() and gamma.grad.abs().sum() > 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 4096, 256), (2, 256, 512), (1, 256, 128)])
def test_attention_backward_kernel_matches_plain(cuda, shape, dtype):
    q, k, v, do = (torch.randn(shape, device="cuda", generator=cuda).to(dtype) for _ in range(4))
    o, lse = attention.single_head_attention(q, k, v, return_lse=True)
    di = (do.float() * o.float()).sum(-1)
    before = attention.attention_backward.launches
    got = attention.attention_backward(q, k, v, o, lse, do)
    want = attention._attention_backward_reference(q, k, v, do, lse, di)
    torch.cuda.synchronize()
    assert attention.attention_backward.launches == before + 1
    for g, w in zip(got, want):
        assert g.dtype == dtype and g.shape == shape
        _rms_close(g, w, ATTN_REL_TOL[dtype])


def test_kernels_raise_outside_their_shapes(cuda):
    q = torch.randn(1, 256, 96, device="cuda")
    with pytest.raises(ValueError, match="attention kernel takes"):
        attention.single_head_attention(q, q, q)
    q = torch.randn(1, 100, 128, device="cuda")
    with pytest.raises(ValueError, match="attention kernel takes"):
        attention.single_head_attention(q, q, q)
    q = torch.randn(1, 256, 128, device="cuda", dtype=torch.float16)
    with pytest.raises(TypeError):
        attention.single_head_attention(q, q, q)
    x = torch.randn(1, 8, 8, 128, device="cuda")
    gamma, beta = torch.ones(128, device="cuda"), torch.zeros(128, device="cuda")
    with pytest.raises(ValueError, match="contiguous"):
        norm.group_norm(x.transpose(1, 2), gamma, beta)
    with pytest.raises(ValueError, match="float32"):
        norm.group_norm(x, gamma.bfloat16(), beta)
    with pytest.raises(ValueError, match="C % 32"):
        norm.group_norm(x[..., :48].contiguous(), gamma[:48], beta[:48], num_groups=16)


def test_tiny_detector_card_matches_cpu(cuda):
    # ch 128 puts both attention sites at C = 256, a width the kernel takes
    cfg = merge_configs(
        [str(REPO / "configs/autoencoder/pose/tiny_cpu.yaml")], ["model.params.ddconfig.ch=128"]
    )
    model = instantiate_from_config(cfg["model"])
    net = model.init_net(torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(0)
    b = 2
    args = (
        rng.normal(size=(b, 32, 32, 3)).astype(np.float32),
        np.full((b,), 1266.0, np.float32),
        np.tile(np.float32([800.0, 450.0]), (b, 1)),
        np.full((b,), 100.0, np.float32),
        np.tile(np.float32([820.0, 460.0]), (b, 1)),
        np.full((b,), 2.56, np.float32),
    )
    hmin, hmax = np.full(11, 0.5, np.float32), np.full(11, 4.0, np.float32)
    outs = []
    for device in ("cuda", "cpu"):
        det = make_detector_fn(model, net, hmin, hmax, 32, dtype="float32", device=device)
        outs.append([t.cpu().numpy() for t in det(*args)])
    (boxes, cls, score), (wboxes, wcls, wscore) = outs
    np.testing.assert_allclose(boxes, wboxes, rtol=1e-3, atol=1e-3)
    np.testing.assert_array_equal(cls, wcls)
    np.testing.assert_allclose(score, wscore, rtol=0, atol=1e-5)


def test_tiny_train_step_card_matches_cpu(cuda):
    """One fp32 step past the curriculum from the same weights and draws; the
    Adam first moments are (1 - b1) * the clipped gradients. Limits: losses
    1e-3 relative; moments 1e-3 of each optimizer's largest (the composite
    loss is ~1e6, so summation noise scales with the global gradient)."""
    cfg = merge_configs(
        [str(REPO / "configs/autoencoder/pose/tiny_cpu.yaml")], ["model.params.ddconfig.ch=128"]
    )
    model = instantiate_from_config(cfg["model"])
    rng = np.random.default_rng(1)
    host = model.example_batch(2)
    host[model.image_rgb_key] = rng.uniform(0, 1, size=(2, 32, 32, 3)).astype(np.float32)
    host[model.class_key] = host["original_class_id"] = np.array([0, 4], np.int32)
    host[model.bbox_key] = rng.uniform(1, 4, size=(2, 3)).astype(np.float32)
    draws = {"posterior": rng.normal(size=(2, 16, 16, 16)), "noise": rng.normal(size=(2, 16, 16, 16)),
             "dropout": rng.uniform(size=(2, 16, 16, 16)), "bbox": rng.normal(size=(2, 8))}
    step = make_train_step(model, phase="full", compute_dtype=torch.float32)
    out = {}
    for device in ("cuda", "cpu"):
        state = create_train_state(model, 1e-4, seed=0, device=device)
        state.step = 6
        before = attention.attention_backward.launches, norm.group_norm_backward.launches
        state, metrics = step(state, model.prepare_batch(host, device=device),
                              {k: torch.tensor(v, dtype=torch.float32, device=device)
                               for k, v in draws.items()})
        if device == "cuda":
            assert attention.attention_backward.launches > before[0]
            assert norm.group_norm_backward.launches > before[1]
        out[device] = (
            {k: float(metrics[k]) for k in ("aeloss", "discloss", "train/d_weight")},
            [torch.cat([opt.moments(p)[0].flatten().cpu() for p in opt.params])
             for opt in (state.opt_ae, state.opt_disc)],
        )
    (got, got_m), (want, want_m) = out["cuda"], out["cpu"]
    for k, w in want.items():
        assert abs(got[k] - w) <= 1e-3 * abs(w), (k, got[k], w)
    for g, w in zip(got_m, want_m):
        torch.testing.assert_close(g, w, rtol=0, atol=1e-3 * w.abs().max().item())
