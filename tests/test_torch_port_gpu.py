"""The port's CUDA kernels against their plain PyTorch versions on the card,
and the tiny detector and train step on the card against the CPU.

Needs a CUDA card, ``nvcc`` and no JAX: run with
``python -m pytest -m gpu --noconftest tests/test_torch_port_gpu.py``.
Without a card every test skips (decided in the fixture, not at import)."""

import os
import subprocess
import sys
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

# (h=w, C): the flagship's rows (every train-step site), and the tiny configs'
# C = 32 and 64 (one and two channels per group)
GN_ROWS = [(256, 128), (128, 128), (128, 256), (64, 128), (64, 256), (32, 256), (32, 512),
           (16, 256), (16, 512), (16, 32), (32, 32), (16, 64)]
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


@pytest.mark.parametrize("batch", [1, 2])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act", [None, "silu"])
@pytest.mark.parametrize("hw, c", GN_ROWS)
def test_group_norm_kernel_matches_plain(cuda, hw, c, act, dtype, batch):
    x, gamma, beta = _gn_inputs(cuda, (batch, hw, hw, c), dtype)
    before, two_pass = norm.group_norm.launches, norm.group_norm.two_pass
    got = norm.group_norm(x, gamma, beta, 32, 1e-6, act)
    want = norm._gn_reference(x, gamma, beta, 32, 1e-6, act)
    torch.cuda.synchronize()
    assert norm.group_norm.launches == before + 1
    assert norm.group_norm.two_pass == two_pass  # every model row takes the resident kernel
    assert got.dtype == dtype and got.is_contiguous()
    torch.testing.assert_close(got.float(), want.float(), **GN_TOL[dtype])


# Rows off the model's grid (B, H, W, C, dtype) and the route the rule gives
# them: ragged row counts, the widest rows, a batch whose rows take many
# rounds of the card, a group that splits a 16-byte vector (C / G = 3) and
# rows too long for the card (the two-pass kernels)
GN_EDGE_ROWS = [
    ((2, 24, 24, 128), torch.bfloat16, "resident"), ((3, 40, 40, 256), torch.float32, "resident"),
    ((2, 8, 8, 2048), torch.bfloat16, "resident"), ((2, 8, 8, 1024), torch.float32, "resident"),
    ((1, 250, 250, 64), torch.bfloat16, "resident"), ((1, 300, 300, 64), torch.bfloat16, "two_pass"),
    ((16, 256, 256, 128), torch.bfloat16, "resident"),
    ((2, 7, 5, 96), torch.bfloat16, "two_pass"), ((1, 512, 512, 64), torch.float32, "two_pass"),
]


@pytest.mark.parametrize("act", [None, "silu"])
@pytest.mark.parametrize("shape, dtype, route", GN_EDGE_ROWS)
def test_group_norm_kernel_takes_edge_rows(cuda, shape, dtype, route, act):
    x, gamma, beta = _gn_inputs(cuda, shape, dtype)
    assert norm._route_of(x, 32).kind == route
    two_pass = norm.group_norm.two_pass
    got = norm.group_norm(x, gamma, beta, 32, 1e-6, act)
    want = norm._gn_reference(x, gamma, beta, 32, 1e-6, act)
    torch.cuda.synchronize()
    assert norm.group_norm.two_pass == two_pass + (route == "two_pass")
    torch.testing.assert_close(got.float(), want.float(), **GN_TOL[dtype])


# The SiLU's tail: t = 6 xhat - 10 reaches t < -16, where silu(t) is tiny and
# an absolute limit says nothing. The kernel's y must keep the plain one's
# relative precision there: one bf16 rounding (2^-7), or fp32's (t itself
# differs in its last bits, which |t| amplifies). The atol covers t near 0,
# where 6 xhat - 10 cancels: t carries the rounding of 10 (~1e-6), and so
# does y = t / 2 there.
SILU_TAIL_TOL = {torch.float32: dict(rtol=1e-4, atol=5e-6),
                 torch.bfloat16: dict(rtol=2 ** -7, atol=1e-5)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape, route", [((2, 64, 64, 128), "resident"),
                                          ((2, 7, 5, 96), "two_pass")])
def test_group_norm_silu_tail_keeps_relative_precision(cuda, shape, route, dtype):
    x, _, _ = _gn_inputs(cuda, shape, dtype)
    gamma = torch.full((shape[-1],), 6.0, device="cuda")
    beta = torch.full((shape[-1],), -10.0, device="cuda")
    assert norm._route_of(x, 32).kind == route
    got = norm.group_norm(x, gamma, beta, 32, 1e-6, "silu").float()
    want = norm._gn_reference(x, gamma, beta, 32, 1e-6, "silu").float()
    assert ((want < 0) & (want > -1e-6)).any()  # the tail (t < -16) is reached
    torch.testing.assert_close(got, want, **SILU_TAIL_TOL[dtype])


@pytest.mark.parametrize("shape, dtype", [((4, 128, 128, 128), torch.float32),
                                          ((16, 256, 256, 128), torch.bfloat16),
                                          ((2, 16, 16, 512), torch.bfloat16),
                                          ((2, 7, 5, 96), torch.bfloat16)])
def test_group_norm_kernel_is_deterministic(cuda, shape, dtype):
    """Both routes (the last shape takes the two-pass kernels): y and the
    stats repeat bit for bit."""
    x, gamma, beta = _gn_inputs(cuda, shape, dtype)
    a, pa = norm._gn_cuda(x, gamma, beta, 32, 1e-6, "silu")
    b, pb = norm._gn_cuda(x, gamma, beta, 32, 1e-6, "silu")
    assert torch.equal(a, b) and torch.equal(pa, pb)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 256, 256, 128), (3, 40, 40, 256), (2, 16, 16, 512)])
def test_group_norm_stats_layout_matches_plain(cuda, shape, dtype):
    """The resident kernel's stats for the backward: each image's (sum,
    sumsq) per group in tile 0, exact zeros in the other tiles; the affine's
    per-tile partials fold (over tiles) to the same sums."""
    x, gamma, beta = _gn_inputs(cuda, shape, dtype)
    _, partial = norm._gn_cuda(x, gamma, beta, 32, 1e-6, None)
    _, _, partial_aff = norm.group_norm_affine(x, gamma, beta)
    want = norm._gn_partial_reference(x, 32)
    assert partial.shape == partial_aff.shape == want.shape and not partial[:, 1:].any()
    for got in (partial[:, 0], partial_aff.sum(dim=1)):
        torch.testing.assert_close(got, want[:, 0], rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 4096, 256), (2, 256, 512), (1, 256, 128), (2, 256, 64),
                                   (4, 1024, 64)])
def test_attention_kernel_matches_plain(cuda, shape, dtype):
    q, k, v = (torch.randn(shape, device="cuda", generator=cuda).to(dtype) for _ in range(3))
    before = attention.single_head_attention.launches
    split_before = _split_forward_launches()
    o, lse = attention.single_head_attention(q, k, v, return_lse=True)
    want_o, want_lse = attention._attention_reference(q, k, v)
    torch.cuda.synchronize()
    assert attention.single_head_attention.launches == before + 1
    # fp32 takes the split-precision kernel at every width, bf16 not
    assert _split_forward_launches() == split_before + (dtype == torch.float32)
    assert o.dtype == dtype and lse.shape == shape[:2]
    want_o = want_o.float()
    limit = ATTN_REL_TOL[dtype] * want_o.pow(2).mean().sqrt()
    assert (o.float() - want_o).abs().max() <= limit
    torch.testing.assert_close(lse, want_lse, rtol=0, atol=1e-3)


def _split_forward_launches():
    """Forward calls that ran either split-precision kernel (C <= 256, C = 512)."""
    return attention.split_precision.launches + attention.split_precision_512.launches


def _split_backward_launches():
    """Backward calls that ran either split-precision kernel (C <= 256, C = 512)."""
    return attention.split_backward.launches + attention.split_backward_512.launches


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
    dx, dgamma, dbeta = norm.group_norm_backward(x, dy, partial, gamma, beta, 32, 1e-6, act)
    want = norm._gn_backward_reference(x, dy, mean, rstd, gamma, beta, act)
    torch.cuda.synchronize()
    assert norm.group_norm_backward.launches == before + 1
    assert dx.dtype == dtype and dgamma.dtype == torch.float32 and dgamma.shape == (c,)
    _rms_close(dx, want[0], *GN_BWD_TOL[dtype])
    for got, w in zip((dgamma, dbeta), want[1:]):
        torch.testing.assert_close(got, w, rtol=0, atol=1e-4 * w.abs().max().item())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(16, 256, 256, 128), (16, 16, 16, 512)])
def test_group_norm_backward_kernel_is_deterministic(cuda, shape, dtype):
    """The flagship step's largest site (units of half or a quarter of an
    image's channels, many tiles each) and a 16^2 site (one unit per image):
    dx, dgamma and dbeta repeat bit for bit."""
    x, gamma, beta = _gn_inputs(cuda, shape, dtype)
    dy = torch.randn(x.shape, device="cuda", generator=cuda).to(dtype)
    _, partial = norm._gn_cuda(x, gamma, beta, 32, 1e-6, "silu")
    args = (x, dy, partial, gamma, beta, 32, 1e-6, "silu")
    first = norm.group_norm_backward(*args)
    second = norm.group_norm_backward(*args)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


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
@pytest.mark.parametrize("shape", [(2, 4096, 256), (2, 256, 512), (1, 256, 128), (2, 256, 64),
                                   (4, 1024, 64), (16, 256, 512), (2, 256, 128)])
def test_attention_backward_kernel_matches_plain(cuda, shape, dtype):
    q, k, v, do = (torch.randn(shape, device="cuda", generator=cuda).to(dtype) for _ in range(4))
    o, lse = attention.single_head_attention(q, k, v, return_lse=True)
    di = (do.float() * o.float()).sum(-1)
    before = (attention.attention_backward.launches, _split_backward_launches(),
              attention.backward_512.launches)
    got = attention.attention_backward(q, k, v, o, lse, do)
    want = attention._attention_backward_reference(q, k, v, do, lse, di)
    torch.cuda.synchronize()
    # fp32 takes the split-precision backward at every width, bf16 not; bf16
    # at C = 512 counts its own kernel
    split = attention.split_precision(q)
    assert (attention.attention_backward.launches, _split_backward_launches(),
            attention.backward_512.launches) == (
        before[0] + 1, before[1] + split, before[2] + (not split and shape[2] == 512))
    for g, w in zip(got, want):
        assert g.dtype == dtype and g.shape == shape
        _rms_close(g, w, ATTN_REL_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 4096, 256), (16, 256, 512), (2, 256, 64), (1, 256, 128)])
def test_attention_backward_kernel_is_deterministic(cuda, dtype, shape):
    q, k, v, do = (torch.randn(shape, device="cuda", generator=cuda).to(dtype) for _ in range(4))
    o, lse = attention.single_head_attention(q, k, v, return_lse=True)
    first = attention.attention_backward(q, k, v, o, lse, do)
    second = attention.attention_backward(q, k, v, o, lse, do)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("c", [64, 128, 256, 512])
@pytest.mark.parametrize("l", [256, 1024, 4096])
def test_split_precision_backward_matches_plain(cuda, l, c):
    """fp32 at every width the split-precision backward takes: dq, dk, dv
    against the plain version, the launch counters, a bit-equal repeat."""
    shape = (2, l, c)
    q, k, v, do = (torch.randn(shape, device="cuda", generator=cuda) for _ in range(4))
    o, lse = attention.single_head_attention(q, k, v, return_lse=True)
    di = (do * o).sum(-1)
    before = attention.attention_backward.launches, _split_backward_launches()
    got = attention.attention_backward(q, k, v, o, lse, do)
    again = attention.attention_backward(q, k, v, o, lse, do)
    want = attention._attention_backward_reference(q, k, v, do, lse, di)
    torch.cuda.synchronize()
    assert (attention.attention_backward.launches, _split_backward_launches()) == (
        before[0] + 2, before[1] + 2)
    for g, a, w in zip(got, again, want):
        assert g.dtype == torch.float32 and g.shape == shape
        _rms_close(g, w, ATTN_REL_TOL[torch.float32])
        assert torch.equal(g, a)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 4096, 256), (2, 256, 512), (16, 256, 512), (2, 256, 64),
                                   (2, 256, 128)])
def test_attention_peaked_softmax_matches_plain(cuda, shape, dtype):
    """q and k scaled by 4: each row's softmax sits on a handful of keys, so
    the output's RMS is that of v and a dropped, mis-indexed or permuted key
    tile is an O(1) error rather than one under 0.1 RMS."""
    q, k = (4 * torch.randn(shape, device="cuda", generator=cuda) for _ in range(2))
    v, do = (torch.randn(shape, device="cuda", generator=cuda) for _ in range(2))
    q, k, v, do = (t.to(dtype) for t in (q, k, v, do))
    o, lse = attention.single_head_attention(q, k, v, return_lse=True)
    want_o, want_lse = attention._attention_reference(q, k, v)
    _rms_close(o, want_o, ATTN_REL_TOL[dtype])
    torch.testing.assert_close(lse, want_lse, rtol=0, atol=1e-3)
    di = (do.float() * o.float()).sum(-1)
    got = attention.attention_backward(q, k, v, o, lse, do)
    want = attention._attention_backward_reference(q, k, v, do, lse, di)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        _rms_close(g, w, ATTN_REL_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_kernels_match_plain_at_16384(cuda, dtype):
    # B9's length: where the JAX package hands B1/B2's function to jax's own
    # TPU kernel (L * C * 4 > 8 MiB), the port keeps its kernels
    shape = (1, 16384, 256)
    q, k, v, do = (torch.randn(shape, device="cuda", generator=cuda).to(dtype) for _ in range(4))
    o, lse = attention.single_head_attention(q, k, v, return_lse=True)
    want_o, want_lse = attention._attention_reference(q, k, v)
    _rms_close(o, want_o, ATTN_REL_TOL[dtype])
    torch.testing.assert_close(lse, want_lse, rtol=0, atol=1e-3)
    del want_o, want_lse
    di = (do.float() * o.float()).sum(-1)
    got = attention.attention_backward(q, k, v, o, lse, do)
    want = attention._attention_backward_reference(q, k, v, do, lse, di)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        _rms_close(g, w, ATTN_REL_TOL[dtype])


def _attention_f64(q, k, v, do, rows=2048):
    """O and (dq, dk, dv) of batch-1 attention in float64 on the card, ``rows``
    query rows at a time (the whole 65536^2 float64 matrix is 34 GB)."""
    q, k, v, do = (t[0].double() for t in (q, k, v, do))
    scale = q.shape[-1] ** -0.5
    o, dq = torch.empty_like(q), torch.empty_like(q)
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    for r in range(0, q.shape[0], rows):
        sl = slice(r, r + rows)
        p = torch.softmax((q[sl] @ k.T) * scale, dim=-1)
        o[sl] = p @ v
        dv += p.T @ do[sl]
        ds = p * (do[sl] @ v.T - (do[sl] * o[sl]).sum(-1, keepdim=True)) * scale
        dq[sl] = ds @ k
        dk += ds.T @ q[sl]
    return o[None], dq[None], dk[None], dv[None]


@pytest.mark.parametrize("l", [4096, 65536])
def test_fp32_split_attention_meets_the_gate_against_float64_at_long_l(cuda, l):
    """C5: the split kernels' wgmma accumulator chains, flushed into an IEEE
    fp32 sum every 64 tiles, keep O, dQ, dK and dV within 1e-3 of their RMS
    from float64 at (1, 65536, 256) (a 1024^2 input's level-2 attention;
    1.5e-3 to 2.3e-3 before the flush); at 4096 nothing flushes."""
    q, k, v, do = (torch.randn(1, l, 256, device="cuda", generator=cuda) for _ in range(4))
    o, lse = attention.single_head_attention(q, k, v, return_lse=True)
    got = (o, *attention.attention_backward(q, k, v, o, lse, do))
    for name, g, w in zip(("o", "dq", "dk", "dv"), got, _attention_f64(q, k, v, do)):
        rms = w.pow(2).mean().sqrt().item()
        err = (g.double() - w).abs().max().item()
        assert err <= ATTN_REL_TOL[torch.float32] * rms, (name, err / rms)


# Shapes off the kernels' grid: a 384^2 pose config's mid block, a 320^2 plain
# autoencoder's lowest level, attention at C = 96, L < 128, and a tail at
# the bf16 wgmma backward's C = 256
TAIL_SHAPES = [(1, 576, 512), (2, 400, 512), (2, 256, 96), (2, 100, 64), (1, 200, 256)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", TAIL_SHAPES)
def test_attention_off_the_grid_matches_plain(cuda, shape, dtype):
    """Padded to the grid, the padded keys masked, sliced back: the forward,
    the flash forward and the backward against the plain versions on the
    unpadded inputs, one pad copy each, a bit-equal repeat."""
    q, k, v, do = (torch.randn(shape, device="cuda", generator=cuda).to(dtype) for _ in range(4))
    copies = attention.single_head_attention.pad_copies
    o, lse = attention.single_head_attention(q, k, v, return_lse=True)
    flash = attention.flash_attention_forward(q, k, v)
    di = (do.float() * o.float()).sum(-1)
    got = attention.attention_backward(q, k, v, o, lse, do)
    again = attention.attention_backward(q, k, v, o, lse, do)
    want_o, want_lse = attention._attention_reference(q, k, v)
    want_flash = attention._flash_reference(q, k, v)
    want = attention._attention_backward_reference(q, k, v, do, lse, di)
    torch.cuda.synchronize()
    assert attention.single_head_attention.pad_copies == copies + 4
    assert o.shape == flash.shape == shape and lse.shape == shape[:2]
    _rms_close(o, want_o, ATTN_REL_TOL[dtype])
    torch.testing.assert_close(lse, want_lse, rtol=0, atol=1e-3)
    _rms_close(flash, want_flash, ATTN_REL_TOL[dtype])
    for g, a, w in zip(got, again, want):
        assert g.dtype == dtype and g.shape == shape
        _rms_close(g, w, ATTN_REL_TOL[dtype])
        assert torch.equal(g, a)


def test_flagship_attention_shapes_take_no_pad_copy(cuda):
    copies = attention.single_head_attention.pad_copies
    for shape in [(2, 4096, 256), (2, 256, 512), (2, 256, 64)]:
        q = torch.randn(shape, device="cuda", generator=cuda, requires_grad=True)
        attention.single_head_attention(q, q, q).sum().backward()
    torch.cuda.synchronize()
    assert attention.single_head_attention.pad_copies == copies


def test_fp32_detector_is_ieee_under_default_flags(cuda):
    """C4: in a fresh process with PyTorch's default TF32 flags (cuDNN's on),
    the fp32 detector on the card matches the CPU at chip_smoke.py's limits
    (boxes 1e-3, equal classes, scores 1e-5) and leaves the flags as found."""
    code = """
import numpy as np, torch
from generative_detection_tpu_torch.config import instantiate_from_config, merge_configs
from generative_detection_tpu_torch.serving import make_detector_fn
flags = (torch.backends.cudnn.allow_tf32, torch.get_float32_matmul_precision())
assert flags[0], flags
cfg = merge_configs(["configs/autoencoder/pose/tiny_cpu.yaml"], ["model.params.ddconfig.ch=128"])
model = instantiate_from_config(cfg["model"])
net = model.init_net(torch.Generator().manual_seed(0), device="cpu")
rng = np.random.default_rng(4)
b = 2
args = (rng.normal(size=(b, 32, 32, 3)).astype(np.float32), np.full((b,), 1266.0, np.float32),
        np.tile(np.float32([800.0, 450.0]), (b, 1)), np.full((b,), 100.0, np.float32),
        np.tile(np.float32([820.0, 460.0]), (b, 1)), np.full((b,), 2.56, np.float32))
hmin, hmax = np.full(11, 0.5, np.float32), np.full(11, 4.0, np.float32)
outs = [[t.cpu().numpy() for t in make_detector_fn(
    model, net, hmin, hmax, 32, dtype="float32", device=d)(*args)] for d in ("cuda", "cpu")]
(boxes, cls, score), (wboxes, wcls, wscore) = outs
np.testing.assert_allclose(boxes, wboxes, rtol=1e-3, atol=1e-3)
np.testing.assert_array_equal(cls, wcls)
np.testing.assert_allclose(score, wscore, rtol=0, atol=1e-5)
assert (torch.backends.cudnn.allow_tf32, torch.get_float32_matmul_precision()) == flags
"""
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    run = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=600)
    assert run.returncode == 0, run.stdout + run.stderr


def test_kernels_raise_outside_their_shapes(cuda):
    # any L and any C <= 512 are padded to the kernels' grid; C > 512 has no kernel
    q = torch.randn(1, 256, 640, device="cuda")
    with pytest.raises(ValueError, match="attention kernel takes C <= 512"):
        attention.single_head_attention(q, q, q)
    with pytest.raises(ValueError, match="attention kernel takes C <= 512"):
        attention.flash_attention_forward(q, q, q)
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
    _tiny_train_step_card_vs_cpu()


def test_tiny_train_step_at_its_own_width_card_matches_cpu(cuda):
    """The same step at tiny_cpu.yaml's own ch 32: attention at (2, 256, 64)
    and GroupNorm at C = 32 and 64 run their kernels on the card."""
    _tiny_train_step_card_vs_cpu(ch=None)


def test_tiny_fused_winograd_train_step_card_matches_cpu(cuda, monkeypatch):
    """The same step with GDT_WINOGRAD=fused: the in-band (32x32) norm+conv
    pairs run the fused GroupNorm+SiLU+Winograd forward, dgrad and weight
    gradient kernels on the card and their plain versions on the CPU."""
    from generative_detection_tpu_torch.ops import winograd_rows as wr

    monkeypatch.setenv("GDT_WINOGRAD", "fused")
    before = (wr.wino_rows_forward.launches, wr.wino_rows_dgrad.launches, wr.wino_wgrad.launches)
    _tiny_train_step_card_vs_cpu()
    after = (wr.wino_rows_forward.launches, wr.wino_rows_dgrad.launches, wr.wino_wgrad.launches)
    assert [b - a for a, b in zip(before, after)] == [6, 6, 6]


def _tiny_train_step_card_vs_cpu(ch=128):
    """tiny_cpu.yaml at ``ch`` (None: the config's own 32)."""
    cfg = merge_configs(
        [str(REPO / "configs/autoencoder/pose/tiny_cpu.yaml")],
        [] if ch is None else [f"model.params.ddconfig.ch={ch}"],
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


# ---- the opt-in conv formulations (B6-B8), the flash variant (B5) ---------

# Kernel against plain version, max |err| <= tol * RMS(plain): fp32 differs
# in summation order; bf16 rounds the same fp32 values to bf16 (and the
# activation of the prologue, computed as v / (1 + e^-v) in the kernel and
# v * sigmoid(v) in the plain version, can round one bf16 ulp apart).
CONV_REL_TOL = {torch.float32: 1e-3, torch.bfloat16: 0.1}


def _conv_inputs(g, shape, co, dtype):
    from generative_detection_tpu_torch.ops.norm import group_norm_affine

    x, gamma, beta = _gn_inputs(g, shape, dtype)
    c = shape[-1]
    k = torch.randn(3, 3, c, co, device="cuda", generator=g) / (9 * c) ** 0.5
    bias = 0.1 * torch.randn(co, device="cuda", generator=g)
    a, b, _ = group_norm_affine(x, gamma, beta)
    return x, gamma, beta, k, bias, a, b


def _rel_close(got, want, tol):
    want = want.float()
    err = (got.float() - want).abs().max()
    assert err <= tol * want.pow(2).mean().sqrt(), f"max err {err}, rms {want.pow(2).mean().sqrt()}"


# The detector's GroupNorm rows (h=w, C), where the fused detector takes the affine
AFFINE_ROWS = [(256, 128), (128, 128), (64, 128), (64, 256), (32, 256), (16, 256), (16, 512)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hw, c", AFFINE_ROWS + [(7, 96)])
def test_group_norm_affine_kernel_matches_plain(cuda, hw, c, dtype):
    x, gamma, beta = _gn_inputs(cuda, (2, hw, hw, c), dtype)
    before = norm.group_norm_affine.launches
    a, b, partial = norm.group_norm_affine(x, gamma, beta)
    a2, b2, partial2 = norm.group_norm_affine(x, gamma, beta)
    wa, wb, _, _ = norm._gn_affine_reference(x, gamma, beta, 32, 1e-6)
    assert norm.group_norm_affine.launches == before + 2
    torch.testing.assert_close(a, wa, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(b, wb, rtol=1e-4, atol=1e-5)
    assert partial.shape == norm._partial_shape(2, hw * hw, 32)
    assert torch.equal(a, a2) and torch.equal(b, b2) and torch.equal(partial, partial2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape, co", [((2, 64, 64, 128), 256), ((2, 16, 16, 512), 512),
                                       ((2, 8, 8, 128), 128), ((2, 32, 32, 256), 128),
                                       ((2, 256, 256, 128), 128), ((2, 128, 128, 128), 128),
                                       ((1, 8, 72, 128), 128), ((2, 6, 96, 128), 256),
                                       ((2, 12, 32, 128), 128), ((1, 20, 16, 256), 128)])
def test_fused_conv_kernel_matches_plain(cuda, shape, co, dtype):
    # (256, 128, 128) and (128, 128, 128): the fused detector's largest sites;
    # W = 72 and 96: a 64-column tile past the image (C2); H = 6: a 4-row
    # tile past the image; W = 32 and 16 (bf16: 2 or 4 image rows an
    # accumulator) with H past a tile's 8 or 16 rows
    from generative_detection_tpu_torch.ops import fused_conv

    x, _, _, k, bias, a, b = _conv_inputs(cuda, shape, co, dtype)
    before = fused_conv.gn_silu_conv.launches
    out, z = fused_conv._fused_forward(x, a, b, k, bias, emit_z=True)
    out2, _ = fused_conv._fused_forward(x, a, b, k, bias, emit_z=False)
    want_z = fused_conv._silu_affine(x, a, b)
    want = fused_conv._conv_bias(want_z, k, bias)
    torch.cuda.synchronize()
    assert fused_conv.gn_silu_conv.launches == before + 2
    assert out.dtype == dtype and out.shape == shape[:3] + (co,)
    assert torch.equal(out, out2)
    _rel_close(out, want, CONV_REL_TOL[dtype])
    _rel_close(z, want_z, CONV_REL_TOL[dtype])


_REPEAT_SITES = [((2, 256, 256, 128), 128), ((2, 16, 16, 512), 512), ((2, 8, 96, 128), 256)]


@pytest.mark.parametrize("shape, co, dtype",
                         [(s, co, torch.bfloat16) for s, co in _REPEAT_SITES]
                         + [(s, co, torch.float32) for s, co in _REPEAT_SITES]
                         + [((2, 12, 32, 128), 64, torch.float32)])
def test_fused_conv_kernel_repeats_bit_equal(cuda, shape, co, dtype):
    """The B6 kernels (bf16, and fp32 on split precision) give the same bits
    on a repeat, z too: every output element is written by one block."""
    from generative_detection_tpu_torch.ops import fused_conv

    x, _, _, k, bias, a, b = _conv_inputs(cuda, shape, co, dtype)
    runs = [fused_conv._fused_forward(x, a, b, k, bias, emit_z=True) for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(runs[0][0], runs[1][0])
    assert torch.equal(runs[0][1], runs[1][1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("gn", [False, True])
@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("hw, c, co", [(32, 128, 256), (64, 256, 128), (16, 128, 128),
                                       (128, 256, 128), (32, 512, 256), (48, 128, 128),
                                       ((8, 96), 128, 128)])
def test_wino_rows_kernel_matches_plain(cuda, hw, c, co, m, gn, dtype):
    # (128, 256, 128): the fused step's largest site, at batch 2; (32, 512,
    # 256): C = 512 and two output-channel tiles; W = 48 and (H, W) = (8,
    # 96): a 64-column tile runs past the image (96: C2, in fp32 too)
    from generative_detection_tpu_torch.ops import winograd_rows as wr

    h, w = hw if isinstance(hw, tuple) else (hw, hw)
    x, _, _, k, bias, a, b = _conv_inputs(cuda, (2, h, w, c), co, dtype)
    u = wr._u3n(k, dtype, m)
    ab = (a, b) if gn else None
    before = wr.wino_rows_forward.launches
    got = wr.wino_rows_forward(x, u, bias, m, ab)
    want = wr._wino_rows_reference(x, u, bias, *(ab or (None, None)), m)
    torch.cuda.synchronize()
    assert wr.wino_rows_forward.launches == before + 1
    _rel_close(got, want, CONV_REL_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("hw, c, co", [(128, 256, 128), (32, 512, 256)])
def test_wino_rows_kernel_repeats_bit_equal(cuda, hw, c, co, m, dtype):
    """The forward with the GroupNorm prologue and the dgrad (the same kernel
    on dy with the rotated, io-swapped kernel) give the same bits on a
    repeat, in bf16 and in fp32 on split precision (where the two
    warpgroups' partial sums meet in shared memory in a fixed order): every
    output element is written by one block."""
    from generative_detection_tpu_torch.ops import winograd_rows as wr

    x, _, _, k, bias, a, b = _conv_inputs(cuda, (2, hw, hw, c), co, dtype)
    dy = torch.randn(2, hw, hw, co, device="cuda", generator=cuda).to(dtype)
    u = wr._u3n(k, dtype, m)
    u_rot = wr._u3n(k.flip(0, 1).transpose(2, 3), dtype, m)
    out = [wr.wino_rows_forward(x, u, bias, m, (a, b)) for _ in range(2)]
    dz = [wr.wino_rows_dgrad(dy, u_rot, m) for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(out[0], out[1])
    assert torch.equal(dz[0], dz[1])
    zero = torch.zeros(c, device="cuda")
    _rel_close(dz[0], wr._wino_rows_reference(dy, u_rot, zero, None, None, m), CONV_REL_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("gn", [False, True])
@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("hw, c, co", [(32, 128, 256), (16, 256, 128), (128, 256, 128),
                                       (48, 128, 128)])
def test_wino_wgrad_kernel_matches_plain(cuda, hw, c, co, m, gn, dtype):
    # (128, 256, 128): the fused step's largest site, at batch 2; W = 48: the
    # bf16 kernel's last 32-column chunk of each row runs past the image
    from generative_detection_tpu_torch.ops import conv3x3
    from generative_detection_tpu_torch.ops import winograd_rows as wr

    x, _, _, _, _, a, b = _conv_inputs(cuda, (2, hw, hw, c), co, dtype)
    dy = torch.randn(2, hw, hw, co, device="cuda", generator=cuda).to(dtype)
    ab = (a, b) if gn else None
    got = conv3x3.conv3x3_wgrad(x, dy, m, ab)
    again = conv3x3.conv3x3_wgrad(x, dy, m, ab)
    want = wr._wino_wgrad_reference(x, dy, *(ab or (None, None)), m)
    torch.cuda.synchronize()
    assert torch.equal(got, again)  # split-K partials folded in a fixed order
    _rel_close(got, want, CONV_REL_TOL[dtype])


@pytest.mark.parametrize("b, hw, c, co", [(16, 128, 256, 128), (2, 40, 64, 192),
                                          (2, 16, 128, 64)])
def test_wino_wgrad_split_kernel_matches_plain(cuda, b, hw, c, co):
    """The fp32 weight gradient on split precision (wgrad_split_wgmma_kernel)
    at the fused step's largest site at its batch (65 536 positions a point,
    split so that no block sums more than 4096), at W = 40 (a chunk of 16
    positions past the image) with CO % 128 == 64 (the second warpgroup's
    channels past CO), and at CO = 64; a repeat gives the same bits."""
    from generative_detection_tpu_torch.ops import conv3x3
    from generative_detection_tpu_torch.ops import winograd_rows as wr

    x, _, _, _, _, a, b_ = _conv_inputs(cuda, (b, hw, hw, c), co, torch.float32)
    dy = torch.randn(b, hw, hw, co, device="cuda", generator=cuda)
    before = wr.wino_wgrad.launches
    got = wr.wino_wgrad(x, dy, torch.float32, 4, (a, b_))
    du = conv3x3.conv3x3_wgrad(x, dy, 4, (a, b_))
    again = conv3x3.conv3x3_wgrad(x, dy, 4, (a, b_))
    want = wr._wino_wgrad_reference(x, dy, a, b_, 4)
    torch.cuda.synchronize()
    # every launch runs in gdt::wino_wgrad and counts there, the direct ones too
    assert wr.wino_wgrad.launches == before + 3 and got.shape == (3, 3, c, co)
    assert torch.equal(du, again)
    _rel_close(du, want, CONV_REL_TOL[torch.float32])


def test_conv_autograd_runs_the_kernels(cuda):
    """gn_silu_wino_conv3x3 under autograd: forward, dgrad and weight
    gradient kernels each launch once, and the gradients match the plain
    composite's in fp32."""
    from generative_detection_tpu_torch.ops import fused_conv
    from generative_detection_tpu_torch.ops import winograd_rows as wr

    x, gamma, beta, k, bias, _, _ = _conv_inputs(cuda, (2, 32, 32, 128), 256, torch.float32)
    args = [t.clone().requires_grad_(True) for t in (x, gamma, beta, k, bias)]
    before = (wr.wino_rows_forward.launches, wr.wino_rows_dgrad.launches, wr.wino_wgrad.launches)
    out = wr.gn_silu_wino_conv3x3(*args, torch.float32, 4)
    ct = torch.randn(out.shape, device="cuda", generator=cuda)
    grads = torch.autograd.grad(out, args, ct)
    after = (wr.wino_rows_forward.launches, wr.wino_rows_dgrad.launches, wr.wino_wgrad.launches)
    assert [b - a for a, b in zip(before, after)] == [1, 1, 1]
    ref = [t.clone().requires_grad_(True) for t in (x, gamma, beta, k, bias)]
    want_out = fused_conv.gn_silu_conv_reference(*ref)
    want = torch.autograd.grad(want_out, ref, ct)
    _rel_close(out, want_out, 1e-3)
    for g, w in zip(grads, want):
        _rel_close(g, w, 1e-3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 4096, 256), (2, 256, 512), (1, 256, 128), (2, 256, 64)])
def test_flash_attention_kernel_matches_plain(cuda, shape, dtype):
    q, k, v = (torch.randn(shape, device="cuda", generator=cuda).to(dtype) for _ in range(3))
    before = attention.flash_attention_forward.launches
    split_before = _split_forward_launches()
    o = attention.flash_attention_forward(q, k, v)
    want = attention._flash_reference(q, k, v)
    torch.cuda.synchronize()
    assert attention.flash_attention_forward.launches == before + 1
    assert _split_forward_launches() == split_before + (dtype == torch.float32)
    _rel_close(o, want, ATTN_REL_TOL[dtype])


@pytest.mark.parametrize("l, c", [(l, c) for c in (64, 128, 256) for l in (256, 1024, 4096)]
                         + [(256, 512), (1024, 512)])
def test_split_precision_forward_matches_plain(cuda, l, c):
    """fp32 at every width, through both entry points: B1 with its lse, B5
    without (at C = 512 the kernel that owns half of O's channels); each
    repeated bit for bit."""
    shape = (2, l, c)
    q, k, v = (torch.randn(shape, device="cuda", generator=cuda) for _ in range(3))
    counter = attention.split_precision_512 if c == 512 else attention.split_precision
    before = (attention.single_head_attention.launches,
              attention.flash_attention_forward.launches, counter.launches)
    o, lse = attention.single_head_attention(q, k, v, return_lse=True)
    o2, lse2 = attention.single_head_attention(q, k, v, return_lse=True)
    f = attention.flash_attention_forward(q, k, v)
    f2 = attention.flash_attention_forward(q, k, v)
    want_o, want_lse = attention._attention_reference(q, k, v)
    want_f = attention._flash_reference(q, k, v)
    torch.cuda.synchronize()
    assert (attention.single_head_attention.launches, attention.flash_attention_forward.launches,
            counter.launches) == (before[0] + 2, before[1] + 2, before[2] + 4)
    assert o.dtype == f.dtype == torch.float32 and lse.shape == shape[:2]
    _rel_close(o, want_o, ATTN_REL_TOL[torch.float32])
    torch.testing.assert_close(lse, want_lse, rtol=0, atol=1e-3)
    _rel_close(f, want_f, ATTN_REL_TOL[torch.float32])
    assert torch.equal(o, o2) and torch.equal(lse, lse2) and torch.equal(f, f2)


@pytest.mark.parametrize("c", [64, 128, 256, 512])
@pytest.mark.parametrize("l", [256, 1024, 4096])
def test_flash_attention_bf16_kernel_matches_plain(cuda, l, c):
    """B5 on bf16 inputs (P in two bf16 pieces) at every width, repeated bit
    for bit; it runs no split-precision kernel."""
    q, k, v = (torch.randn(2, l, c, device="cuda", generator=cuda).bfloat16() for _ in range(3))
    before = attention.flash_attention_forward.launches, _split_forward_launches()
    o = attention.flash_attention_forward(q, k, v)
    again = attention.flash_attention_forward(q, k, v)
    want = attention._flash_reference(q, k, v)
    torch.cuda.synchronize()
    assert (attention.flash_attention_forward.launches,
            _split_forward_launches()) == (before[0] + 2, before[1])
    assert o.dtype == torch.bfloat16
    _rel_close(o, want, ATTN_REL_TOL[torch.bfloat16])
    assert torch.equal(o, again)


def _tiny_model():
    cfg = merge_configs(
        [str(REPO / "configs/autoencoder/pose/tiny_cpu.yaml")], ["model.params.ddconfig.ch=128"]
    )
    return instantiate_from_config(cfg["model"])


def test_tiny_fused_detector_card_matches_cpu(cuda, monkeypatch):
    from generative_detection_tpu_torch.ops import fused_conv

    monkeypatch.setenv("GDT_FUSE_INFERENCE", "1")
    model = _tiny_model()
    net = model.init_net(torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(2)
    b = 2
    args = (
        rng.normal(size=(b, 32, 32, 3)).astype(np.float32), np.full((b,), 1266.0, np.float32),
        np.tile(np.float32([800.0, 450.0]), (b, 1)), np.full((b,), 100.0, np.float32),
        np.tile(np.float32([820.0, 460.0]), (b, 1)), np.full((b,), 2.56, np.float32),
    )
    hmin, hmax = np.full(11, 0.5, np.float32), np.full(11, 4.0, np.float32)
    outs = []
    for device in ("cuda", "cpu"):
        before = fused_conv.gn_silu_conv.launches
        det = make_detector_fn(model, net, hmin, hmax, 32, dtype="float32", device=device)
        outs.append([t.cpu().numpy() for t in det(*args)])
        if device == "cuda":
            assert fused_conv.gn_silu_conv.launches == before + 8
    (boxes, cls, score), (wboxes, wcls, wscore) = outs
    np.testing.assert_allclose(boxes, wboxes, rtol=1e-3, atol=1e-3)
    np.testing.assert_array_equal(cls, wcls)
    np.testing.assert_allclose(score, wscore, rtol=0, atol=1e-5)


def test_conv_kernels_raise_outside_their_shapes(cuda):
    from generative_detection_tpu_torch.ops import conv3x3

    u = torch.zeros(9, 128, 128, device="cuda")
    bias = torch.zeros(128, device="cuda")
    with pytest.raises(ValueError, match="runs only with the GroupNorm prologue"):
        conv3x3.conv3x3_forward(torch.zeros(1, 8, 96, 128, device="cuda"), u, bias, 1)
    with pytest.raises(ValueError, match="CO % 64 == 0"):
        conv3x3.conv3x3_forward(torch.zeros(1, 8, 8, 128, device="cuda"),
                                u[..., :96].contiguous(), bias[:96], 1)
    with pytest.raises(TypeError):
        conv3x3.conv3x3_forward(torch.zeros(1, 8, 8, 128, device="cuda", dtype=torch.float16),
                                u.half(), bias, 1)
    # the bf16 row-Winograd kernel: any W, but 128 output channels a block
    u4 = torch.zeros(18, 128, 64, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CO % 128 == 0"):
        conv3x3.conv3x3_forward(torch.zeros(1, 8, 96, 128, device="cuda", dtype=torch.bfloat16),
                                u4, bias[:64], 4)
    with pytest.raises(ValueError, match="H % mode == 0"):
        conv3x3.conv3x3_forward(torch.zeros(1, 6, 96, 128, device="cuda", dtype=torch.bfloat16),
                                torch.zeros(18, 128, 128, device="cuda", dtype=torch.bfloat16),
                                bias, 4)
    with pytest.raises(ValueError, match="C % 64 == 0"):
        z = torch.zeros(1, 8, 8, 32, device="cuda")
        conv3x3.conv3x3_wgrad(z, torch.zeros(1, 8, 8, 128, device="cuda"), 4)
    with pytest.raises(ValueError, match="CO % 128 == 0"):
        z = torch.zeros(1, 8, 8, 64, device="cuda", dtype=torch.bfloat16)
        conv3x3.conv3x3_wgrad(z, torch.zeros(1, 8, 8, 64, device="cuda", dtype=torch.bfloat16), 4)


def test_tiny_trainer_fit_card_matches_cpu(cuda, tmp_path, monkeypatch):
    """Two steps of the Trainer's fit (a 'pretrain' then a 'full' step, and a
    validation) of tiny_cpu.yaml at ch 128, on the card and on the CPU, from
    the same seed, batches and forward draws (the draws handed to the net's
    forward, since the card's and the CPU's generators differ). Limits: the
    card-vs-CPU step's, losses and d_weight 1e-3 relative (1e-6 absolute for
    the values the lean pretrain step logs as zero)."""
    import json

    from generative_detection_tpu_torch.models.autoencoder import PoseAutoencoderNet
    from generative_detection_tpu_torch.train import Trainer
    from generative_detection_tpu_torch.train.metrics import MetricsLogger

    cfg = merge_configs([str(REPO / "configs/autoencoder/pose/tiny_cpu.yaml")],
                        ["model.params.ddconfig.ch=128"])
    model = instantiate_from_config(cfg["model"])
    model.learning_rate = 1e-4
    rng = np.random.default_rng(2)
    draws = {"posterior": rng.normal(size=(8, 16, 16, 16)), "noise": rng.normal(size=(8, 16, 16, 16)),
             "dropout": rng.uniform(size=(8, 16, 16, 16)), "bbox": rng.normal(size=(8, 8))}
    forward = PoseAutoencoderNet.forward

    def fwd(self, x, *args, **kw):
        if x.shape[0] == 8 and not kw.get("draws"):
            kw["draws"] = {k: torch.tensor(v, dtype=torch.float32, device=x.device)
                           for k, v in draws.items()}
        return forward(self, x, *args, **kw)

    monkeypatch.setattr(PoseAutoencoderNet, "forward", fwd)
    rows = {}
    for device in ("cuda", "cpu"):
        logdir = str(tmp_path / device)
        trainer = Trainer(model, logdir=logdir, max_epochs=1, max_steps=2, limit_val_batches=1,
                          log_every_n_steps=1, device=device,
                          logger=MetricsLogger(logdir))
        before = norm.group_norm_backward.launches, attention.split_backward.launches
        trainer.fit(instantiate_from_config(cfg["data"]))
        trainer.logger.close()
        if device == "cuda":
            assert norm.group_norm_backward.launches > before[0]
            assert attention.split_backward.launches > before[1]
        with open(os.path.join(logdir, "metrics.jsonl")) as f:
            rows[device] = [json.loads(line) for line in f if "aeloss" in line]
    assert [r["step"] for r in rows["cuda"]] == [r["step"] for r in rows["cpu"]] == [1, 2]
    for got, want in zip(rows["cuda"], rows["cpu"]):
        for k in ("aeloss", "discloss", "train/d_weight", "train/rec_loss", "train/kl_loss_obj"):
            assert abs(got[k] - want[k]) <= 1e-3 * abs(want[k]) + 1e-6, (got["step"], k, got[k],
                                                                         want[k])


def test_tiny_plain_fit_card_matches_cpu(cuda, tmp_path, monkeypatch):
    """Two steps of the Trainer's fit of the plain family
    (plain_kl_tiny.yaml as shipped: ch 32, fp32, disc_start 2, one
    validation), on the card and on the CPU, from the same seed, batches and
    posterior draws (handed to the net's forward). Limits: the card-vs-CPU
    step's, losses and d_weight 1e-3 relative (1e-6 absolute for the GAN
    terms before disc_start, zero on both)."""
    import json

    from generative_detection_tpu_torch.models.autoencoder import AutoencoderKLNet
    from generative_detection_tpu_torch.train import Trainer
    from generative_detection_tpu_torch.train.metrics import MetricsLogger

    cfg = merge_configs([str(REPO / "configs/autoencoder/plain_kl_tiny.yaml")])
    model = instantiate_from_config(cfg["model"])
    model.learning_rate = 1e-4
    eps = np.random.default_rng(3).normal(size=(8, 16, 16, 16))
    forward = AutoencoderKLNet.forward

    def fwd(self, x, *args, **kw):
        if x.shape[0] == 8 and not kw.get("draws"):
            kw["draws"] = {"posterior": torch.tensor(eps, dtype=torch.float32, device=x.device)}
        return forward(self, x, *args, **kw)

    monkeypatch.setattr(AutoencoderKLNet, "forward", fwd)
    rows = {}
    for device in ("cuda", "cpu"):
        logdir = str(tmp_path / device)
        trainer = Trainer(model, logdir=logdir, max_epochs=1, max_steps=2, limit_val_batches=1,
                          log_every_n_steps=1, device=device, logger=MetricsLogger(logdir))
        before = norm.group_norm_backward.launches, attention.split_backward.launches
        trainer.fit(instantiate_from_config(cfg["data"]))
        trainer.logger.close()
        if device == "cuda":
            assert norm.group_norm_backward.launches > before[0]
            assert attention.split_backward.launches > before[1]
        with open(os.path.join(logdir, "metrics.jsonl")) as f:
            rows[device] = [json.loads(line) for line in f]
    steps = {d: [r for r in rs if "aeloss" in r] for d, rs in rows.items()}
    assert [r["step"] for r in steps["cuda"]] == [r["step"] for r in steps["cpu"]] == [1, 2]
    for got, want in zip(steps["cuda"], steps["cpu"]):
        for k in ("aeloss", "discloss", "train/d_weight", "train/rec_loss", "train/kl_loss"):
            assert abs(got[k] - want[k]) <= 1e-3 * abs(want[k]) + 1e-6, (got["step"], k, got[k],
                                                                         want[k])
    (val_card,), (val_cpu,) = ([r for r in rs if "val/rec_loss" in r] for rs in rows.values())
    assert abs(val_card["val/rec_loss"] - val_cpu["val/rec_loss"]) <= 1e-3 * val_cpu["val/rec_loss"]


def test_raw_crop_prepare_batch_card_matches_cpu(cuda):
    """The raw-crop branch of ``prepare_batch`` at the flagship's shape
    (batch 16, 400x400 uint8 buffers, output 256): crop-resize, mask and
    rescale on the card against the CPU's. Masks bit-equal, ``rgb_gt``
    within 1e-5 (the same float32 arithmetic on both)."""
    from generative_detection_tpu_torch.data.synthetic import raw_crop_batch
    from generative_detection_tpu_torch.models import autoencoder

    model = instantiate_from_config(merge_configs(
        [str(REPO / "configs/autoencoder/pose/autoencoder_kl_16x16x16.yaml")])["model"])
    batch = raw_crop_batch(16, 256, seed=4)
    before = autoencoder.batch_contracts["raw"]
    got = model.prepare_batch(batch, device="cuda")
    want = model.prepare_batch(batch, device="cpu")
    assert autoencoder.batch_contracts["raw"] == before + 2
    assert got["rgb_gt"].shape == (16, 256, 256, 3) and got["rgb_gt"].is_cuda
    assert torch.equal(got["mask_2d_bbox"].cpu(), want["mask_2d_bbox"])
    assert 0 < float(want["mask_2d_bbox"].mean()) < 1
    assert (got["rgb_gt"].cpu() - want["rgb_gt"]).abs().max().item() <= 1e-5
    for k in want:
        assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype, k


def test_eval_cli_card_matches_cpu(cuda, tmp_path):
    """``eval_cli`` on tiny_cpu.yaml, on the card and with ``--device cpu``,
    in both image contracts: the metrics within the tiny card-vs-CPU
    tolerances (PERF.md section 2: 1e-3 relative for PSNR and KL, boxes
    1e-3, so the box metrics 1e-3 relative plus 1e-3 absolute)."""
    from generative_detection_tpu_torch import eval_cli

    tiny = str(REPO / "configs/autoencoder/pose/tiny_cpu.yaml")
    for raw in (False, True):
        dotlist = ["data.params.validation.params.device_preprocess=true"] if raw else []
        card = eval_cli.main(["-b", tiny, "--limit", "2", *dotlist])
        cpu = eval_cli.main(["-b", tiny, "--limit", "2", "--device", "cpu", *dotlist])
        assert list(card) == list(cpu)
        for k, want in cpu.items():
            if k == "split":
                assert card[k] == want
            else:
                assert abs(card[k] - want) <= 1e-3 * abs(want) + (0 if k in ("psnr", "kl")
                                                                  else 1e-3), (raw, k)


def _tiny_request(b, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, 32, 32, 3)).astype(np.float32), np.full((b,), 1266.0, np.float32),
            np.tile(np.float32([800.0, 450.0]), (b, 1)), rng.uniform(60, 200, b).astype(np.float32),
            np.tile(np.float32([820.0, 460.0]), (b, 1)), np.full((b,), 2.56, np.float32))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_exported_tiny_detector_matches_live_on_the_card(cuda, dtype):
    """A batch-polymorphic artifact of the tiny detector at ch 128 (attention
    at C = 256), exported and loaded on the card in this process, serves
    batches 1 and 3 as the live detector does, and its calls launch the
    kernels through the gdt operators: 11 GroupNorm and 2 attention launches
    a request, as the live path's."""
    from generative_detection_tpu_torch.serving import export_detector, load_detector

    model = _tiny_model()
    net = model.init_net(torch.Generator().manual_seed(0), device="cpu")
    hmin, hmax = np.full(11, 0.5, np.float32), np.full(11, 4.0, np.float32)
    blob = export_detector(model, net, hmin, hmax, batch=None, dtype=dtype)
    detect = load_detector(blob)
    assert detect.metadata["device"] == "cuda" and detect.metadata["dtype"] == dtype
    live = make_detector_fn(model, net, hmin, hmax, 32, dtype=dtype)
    def launches():
        return norm.group_norm.launches, attention.single_head_attention.launches

    for b in (1, 3):
        args = _tiny_request(b, b)
        before = launches()
        want = [t.cpu() for t in live(*args)]
        mid = launches()
        got = [t.cpu() for t in detect(*args)]
        after = launches()
        assert [m - a for a, m in zip(before, mid)] == [11, 2]
        assert [z - m for m, z in zip(mid, after)] == [11, 2]
        assert torch.equal(got[1], want[1])
        np.testing.assert_allclose(got[0].numpy(), want[0].numpy(), rtol=1e-3, atol=1e-3)
        np.testing.assert_allclose(got[2].numpy(), want[2].numpy(), rtol=0, atol=1e-5)


def test_fp32_artifact_is_ieee_under_default_flags(cuda, tmp_path):
    """C4 for a loaded artifact, and a load in another process: one process
    exports an fp32 artifact of the tiny detector on the card and writes it
    with the CPU detector's outputs; a fresh process with PyTorch's default
    TF32 flags loads it and matches those outputs at chip_smoke.py's limits,
    leaving the flags as found; a process with CUDA hidden cannot load it (it
    never runs on the CPU)."""
    export = """
import sys, numpy as np, torch
from generative_detection_tpu_torch.config import instantiate_from_config, merge_configs
from generative_detection_tpu_torch.serving import export_detector, make_detector_fn
cfg = merge_configs(["configs/autoencoder/pose/tiny_cpu.yaml"], ["model.params.ddconfig.ch=128"])
model = instantiate_from_config(cfg["model"])
net = model.init_net(torch.Generator().manual_seed(0), device="cpu")
rng = np.random.default_rng(4)
b = 2
args = (rng.normal(size=(b, 32, 32, 3)).astype(np.float32), np.full((b,), 1266.0, np.float32),
        np.tile(np.float32([800.0, 450.0]), (b, 1)), np.full((b,), 100.0, np.float32),
        np.tile(np.float32([820.0, 460.0]), (b, 1)), np.full((b,), 2.56, np.float32))
hmin, hmax = np.full(11, 0.5, np.float32), np.full(11, 4.0, np.float32)
open(sys.argv[1], "wb").write(export_detector(model, net, hmin, hmax, batch=None, dtype="float32"))
want = [t.numpy() for t in make_detector_fn(model, net, hmin, hmax, 32, dtype="float32",
                                              device="cpu")(*args)]
np.savez(sys.argv[2], *args, *want)
"""
    serve = """
import sys, numpy as np, torch
from generative_detection_tpu_torch.serving import load_detector
flags = (torch.backends.cudnn.allow_tf32, torch.get_float32_matmul_precision())
assert flags[0], flags
data = np.load(sys.argv[2])
args, want = [data[f"arr_{i}"] for i in range(6)], [data[f"arr_{i}"] for i in range(6, 9)]
got = [t.cpu().numpy() for t in load_detector(open(sys.argv[1], "rb").read())(*args)]
np.testing.assert_allclose(got[0], want[0], rtol=1e-3, atol=1e-3)
np.testing.assert_array_equal(got[1], want[1])
np.testing.assert_allclose(got[2], want[2], rtol=0, atol=1e-5)
assert (torch.backends.cudnn.allow_tf32, torch.get_float32_matmul_precision()) == flags
"""
    hidden = """
import sys, pytest
from generative_detection_tpu_torch.serving import load_detector
blob = open(sys.argv[1], "rb").read()
with pytest.raises(RuntimeError, match="CUDA is not available"):
    load_detector(blob)
with pytest.raises(ValueError, match="exported for cuda"):
    load_detector(blob, device="cpu")
"""
    files = [str(tmp_path / "tiny.pt2"), str(tmp_path / "io.npz")]
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    for code, extra in ((export, {}), (serve, {}), (hidden, {"CUDA_VISIBLE_DEVICES": ""})):
        run = subprocess.run([sys.executable, "-c", code, *files], cwd=REPO,
                             env={**env, **extra}, capture_output=True, text=True, timeout=600)
        assert run.returncode == 0, run.stdout + run.stderr


def _parallel_worker():
    """``tests/torch_parallel_worker.py`` by its path (a ``tests`` package
    elsewhere on the path may shadow this one)."""
    import importlib.util

    path = REPO / "tests" / "torch_parallel_worker.py"
    spec = importlib.util.spec_from_file_location("torch_parallel_worker", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_world1_nccl_steps_are_bit_equal_to_one_process(cuda, monkeypatch):
    """Two fp32 steps of tiny_cpu.yaml at ch 128 inside a process group of
    one rank over NCCL (torch's launch environment, joined as ``train_cli``
    joins it) against the same steps outside any group, from one seed, batch
    and draws, cuDNN deterministic: every collective of a one-rank world is
    the identity, so the metrics and the weights are bit-equal."""
    import torch.distributed as dist

    from generative_detection_tpu_torch.parallel import multihost

    worker = _parallel_worker()
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    want = worker.card_steps()
    for k, v in dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="127.0.0.1",
                     MASTER_PORT=str(multihost.free_port())).items():
        monkeypatch.setenv(k, v)
    monkeypatch.delenv("GDT_DIST_BACKEND", raising=False)
    w = multihost.maybe_initialize()
    try:
        assert w.active and w.size == 1 and "nccl" in str(dist.get_backend())
        got = worker.card_steps()
    finally:
        multihost.shutdown()
    assert got == want


def test_two_ranks_share_the_card_over_gloo(cuda, tmp_path):
    """Two ranks on the one card (``GDT_DIST_BACKEND=gloo``: NCCL refuses two
    ranks on one device), each at batch 4 of tiny_cpu.yaml at ch 128, fp32:
    both ranks log the same metrics and hold the same weights, and the first
    step's losses and d_weight are one process's at batch 8 within the
    card-vs-CPU limit (1e-3 relative): the convolutions' algorithms differ
    with the batch. The second step starts from weights that Adam's first
    update already set apart (ROADMAP.md section C), so it is not held."""
    import json

    from generative_detection_tpu_torch.parallel import multihost

    worker = _parallel_worker()
    multihost.spawn_ranks([worker.__file__, "--card", str(tmp_path)], 2, timeout=600,
                          env=dict(os.environ, GDT_DIST_BACKEND="gloo"))
    ranks = [json.loads((tmp_path / f"card_rank{r}.json").read_text()) for r in range(2)]
    assert ranks[0] == ranks[1] and ranks[0][-1]["jax_modules"] == []
    want = worker.card_steps()[0]
    got = ranks[0][0]
    assert want["train/d_weight"] > 0
    for k in ("aeloss", "discloss", "train/d_weight", "train/rec_loss", "train/kl_loss_obj"):
        assert abs(got[k] - want[k]) <= 1e-3 * abs(want[k]) + 1e-6, (k, got[k], want[k])


def test_world1_nccl_fsdp_steps_are_bit_equal_to_one_process(cuda, monkeypatch):
    """``card_steps`` with FSDP inside a process group of one rank over NCCL
    against the same steps outside any group, cuDNN deterministic: a world
    of one shards nothing (the JAX package's mesh of one is replicated), so
    the metrics and the weights are bit-equal."""
    import torch.distributed as dist

    from generative_detection_tpu_torch.parallel import multihost

    worker = _parallel_worker()
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    want = worker.card_steps()
    for k, v in dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="127.0.0.1",
                     MASTER_PORT=str(multihost.free_port())).items():
        monkeypatch.setenv(k, v)
    monkeypatch.delenv("GDT_DIST_BACKEND", raising=False)
    w = multihost.maybe_initialize()
    try:
        assert w.active and w.size == 1 and "nccl" in str(dist.get_backend())
        got = worker.card_steps(fsdp=True)
    finally:
        multihost.shutdown()
    assert got == want


def test_two_fsdp_ranks_share_the_card_over_gloo(cuda, tmp_path):
    """Two ranks on the one card over gloo (every gather and reduce-scatter
    staged through the host), each at batch 4 of tiny_cpu.yaml at ch 128,
    fp32, one step unsharded and one with FSDP from the same seed, batch and
    draws: the FSDP metrics within 1e-6 relative of the unsharded ones, the
    weights after the step within 2.05 lr (``tests/test_fsdp.py``'s bound),
    each optimizer's gradient before the clip within 1e-5 of its largest and
    its global norm within 1e-3 relative (``worker.step_grads``: from the
    consolidated moments, the clip undone), the same kernel launches, both ranks alike, and each rank holding at most
    its shard of parameters, gradients and moments at rest."""
    import json

    from generative_detection_tpu_torch.parallel import multihost

    worker = _parallel_worker()
    multihost.spawn_ranks([worker.__file__, "--card-fsdp", str(tmp_path)], 2, timeout=600,
                          env=dict(os.environ, GDT_DIST_BACKEND="gloo"))
    ranks = [json.loads((tmp_path / f"card_fsdp_rank{r}.json").read_text()) for r in range(2)]
    r0 = ranks[0]
    assert r0["fsdp"] == ranks[1]["fsdp"] and r0["jax_modules"] == []
    assert r0["unsharded"]["train/d_weight"] > 0
    for k, v in r0["unsharded"].items():
        assert abs(r0["fsdp"][k] - v) <= 1e-6 * abs(v), (k, r0["fsdp"][k], v)
    for r in ranks:
        assert r["weights_max_abs_diff_over_lr"] <= 2.05
        assert len(r["grads_rel_diff"]) == 6
        for k, d in r["grads_rel_diff"].items():
            assert d <= (1e-3 if k.endswith(".grad_norm") else 1e-5), (k, d)
        assert r["launches"][0] == r["launches"][1] and min(r["launches"][0]) > 0
        for name in ("net", "lpips", "disc"):
            h = r["at_rest"][name]
            assert h["params"] <= -(-h["n"] // 2) + h["units"] and not h["held"], (name, h)
            assert h["grads"] == (0 if name == "lpips" else h["params"]), (name, h)
