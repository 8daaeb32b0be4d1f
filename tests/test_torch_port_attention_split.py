"""The split-precision design of the port's fp32 attention, forward and
backward, on the CPU.

On the card, fp32 attention at C in ``SPLIT_CHANNELS`` runs every product on
the bf16 tensor cores: every fp32 operand x becomes three bf16 pieces, each
the round-to-nearest-even bf16 of what the earlier pieces leave, and each
product sums the six piece products with i + j <= 2 in fp32 (the backward
splits P and dS too, in registers). The emulation below does the same
arithmetic in plain PyTorch, the roundings with integer operations on the
fp32 bits, so the design is held to the fp32 gate here (max |err| <= 1e-3
RMS of the plain output, as on the card) against the port's plain versions
and the JAX package's Pallas kernels in interpret mode. A single TF32 pass
(the tensor core's other fp32 input type, 10 mantissa bits) misses that gate:
the split is what makes the tensor cores usable for fp32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generative_detection_tpu.ops.attention import _attention_pallas, _make_attention_custom
from generative_detection_tpu_torch.ops import attention

FP32_REL_TOL = 1e-3  # ATTN_REL_TOL[float32] of the card tests and chip_smoke.py


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(torch.int32)


def _bf16_rn(x: torch.Tensor) -> torch.Tensor:
    """x rounded to the nearest bf16 (ties to even), as fp32: the top 16
    bits after adding half an ulp of the kept part (finite inputs)."""
    b = _bits(x).to(torch.int64)
    b = (b + 0x7FFF + ((b >> 16) & 1)) & ~0xFFFF
    return b.to(torch.int32).view(torch.float32)


def _tf32_trunc(x: torch.Tensor) -> torch.Tensor:
    """x as the tensor core reads a TF32 operand: the low 13 mantissa bits dropped."""
    return (_bits(x) & ~0x1FFF).view(torch.float32)


def _pieces(x: torch.Tensor, n: int):
    out = []
    for _ in range(n):
        p = _bf16_rn(x)
        out.append(p)
        x = x - p  # exact in fp32
    return out


def _split_matmul(eq: str, a: torch.Tensor, b: torch.Tensor, n: int) -> torch.Tensor:
    """sum over i + j < n of a_i b_j, each piece product exact in fp32 and
    accumulated in fp32."""
    pa, pb = _pieces(a, n), _pieces(b, n)
    return sum(torch.einsum(eq, pa[i], pb[j]) for i in range(n) for j in range(n - i))


def _emulated(q, k, v, matmul):
    """The kernel's forward with its products taken by ``matmul(eq, a, b)``:
    raw logits, fp32 softmax weights P and their row sum l, O = (P V) / l."""
    s = matmul("blc,bmc->blm", q, k) * q.shape[-1] ** -0.5
    p = torch.exp(s - s.amax(-1, keepdim=True))
    return matmul("blm,bmc->blc", p, v) / p.sum(-1, keepdim=True)


def _emulated_backward(q, k, v, do, lse, di, matmul):
    """The split backward's arithmetic in its order, with its products taken
    by ``matmul(eq, a, b)``: raw logits S, P = exp(S scale - lse), dP = dO
    V^T, dS = P (dP - di) scale, then dV = P^T dO, dK = dS^T Q, dQ = dS K
    (P and dS are operands of those products, so a split matmul splits them
    into pieces as the kernel does in registers)."""
    scale = q.shape[-1] ** -0.5
    s = matmul("blc,bmc->blm", q, k)
    p = torch.exp(s * scale - lse[..., None])
    dp = matmul("blc,bmc->blm", do, v)
    ds = p * (dp - di[..., None]) * scale
    return (matmul("blm,bmc->blc", ds, k), matmul("blm,blc->bmc", ds, q),
            matmul("blm,blc->bmc", p, do))


def _rel_max_err(got, want) -> float:
    return ((got - want).abs().max() / want.pow(2).mean().sqrt()).item()


@pytest.fixture(scope="module")
def qkv():
    rng = np.random.default_rng(0)
    return [rng.standard_normal((2, 512, 256)).astype(np.float32) for _ in range(3)]


def test_bf16_rounding_by_bits_matches_torch():
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(4096).astype(np.float32))
    x = torch.cat([x, x * 1e-30, x * 1e30, torch.tensor([0.0, -0.0, 1.0 + 2.0**-8])])
    assert torch.equal(_bf16_rn(x), x.to(torch.bfloat16).float())


def test_three_pieces_carry_fp32():
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(1 << 16).astype(np.float32))
    p0, p1, p2 = _pieces(x, 3)
    assert torch.equal(p0, x.to(torch.bfloat16).float())
    residual = (x.double() - p0.double() - p1.double() - p2.double()).abs()
    assert (residual <= 2.0**-24 * x.double().abs()).all()


def test_split_forward_meets_the_fp32_gate_and_one_tf32_pass_does_not(qkv):
    q, k, v = (torch.from_numpy(a) for a in qkv)
    plain = attention._flash_reference(q, k, v)
    pallas = torch.from_numpy(np.array(_attention_pallas(
        *(jnp.asarray(a) for a in qkv), interpret=True)))
    split = _emulated(q, k, v, lambda eq, a, b: _split_matmul(eq, a, b, 3))
    tf32 = _emulated(q, k, v, lambda eq, a, b: torch.einsum(eq, _tf32_trunc(a), _tf32_trunc(b)))
    for want in (plain, pallas):
        assert _rel_max_err(split, want) <= FP32_REL_TOL
        assert _rel_max_err(tf32, want) > FP32_REL_TOL
    assert _rel_max_err(pallas, plain) <= FP32_REL_TOL


def test_split_backward_meets_the_fp32_gate_and_one_tf32_pass_does_not():
    rng = np.random.default_rng(3)
    q, k, v, do = (rng.standard_normal((1, 256, 128)).astype(np.float32) for _ in range(4))
    qt, kt, vt, dot = (torch.from_numpy(a) for a in (q, k, v, do))
    o, lse = attention._attention_reference(qt, kt, vt)
    di = (dot * o).sum(-1)
    plain = attention._attention_backward_reference(qt, kt, vt, dot, lse, di)
    _, vjp = jax.vjp(_make_attention_custom(128, True), *(jnp.asarray(a) for a in (q, k, v)))
    pallas = [torch.from_numpy(np.array(g)) for g in vjp(jnp.asarray(do))]
    split = _emulated_backward(qt, kt, vt, dot, lse, di,
                               lambda eq, a, b: _split_matmul(eq, a, b, 3))
    tf32 = _emulated_backward(
        qt, kt, vt, dot, lse, di,
        lambda eq, a, b: torch.einsum(eq, _tf32_trunc(a), _tf32_trunc(b)))
    for want in (plain, pallas):
        for got, w in zip(split, want):  # dq, dk, dv
            assert _rel_max_err(got, w) <= FP32_REL_TOL
        assert max(_rel_max_err(got, w) for got, w in zip(tf32, want)) > FP32_REL_TOL
    for got, w in zip(pallas, plain):
        assert _rel_max_err(got, w) <= FP32_REL_TOL


@pytest.mark.parametrize("dtype, c, split", [
    (torch.float32, 64, True), (torch.float32, 128, True), (torch.float32, 256, True),
    (torch.float32, 512, False), (torch.bfloat16, 256, False),
])
def test_split_precision_widths(dtype, c, split):
    # ``split``: the forward's route (fp32 at C <= 256; C = 512 keeps FMA);
    # the backward takes the split-precision kernels at every fp32 width
    q = torch.zeros(1, 128, c, dtype=dtype)
    assert attention.split_precision(q) == split
    assert attention.split_precision_backward(q) == (dtype == torch.float32)
    scratch = attention._split_scratch(q)
    assert (scratch is not None) == split
    backward = attention._split_scratch(q, backward=True)
    assert (backward is not None) == (dtype == torch.float32)
    if split:  # three pieces of q, k, v
        assert scratch.dtype == torch.bfloat16 and scratch.numel() == 9 * q.numel()
    if backward is not None:  # and of dO in the backward
        assert backward.dtype == torch.bfloat16 and backward.numel() == 12 * q.numel()


def test_cpu_tensors_take_the_plain_versions():
    q = torch.randn(1, 128, 256)
    before = (attention.split_precision.launches, attention.flash_attention_forward.launches,
              attention.split_backward.launches, attention.attention_backward.launches)
    assert torch.equal(attention.flash_attention_forward(q, q, q),
                       attention._flash_reference(q, q, q))
    o, lse = attention.single_head_attention(q, q, q, return_lse=True)
    got = attention.attention_backward(q, q, q, o, lse, q)
    want = attention._attention_backward_reference(q, q, q, q, lse, (q * o).sum(-1))
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert (attention.split_precision.launches, attention.flash_attention_forward.launches,
            attention.split_backward.launches, attention.attention_backward.launches) == before
