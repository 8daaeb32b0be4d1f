"""The split-precision design of the port's fp32 attention, forward and
backward, on the CPU.

On the card, fp32 attention at every width runs every product on
the bf16 tensor cores: every fp32 operand x becomes three bf16 pieces, each
the round-to-nearest-even bf16 of what the earlier pieces leave, and each
product sums the six piece products with i + j <= 2 in fp32 (the backward
splits P and dS too, in registers). The emulation below does the same
arithmetic in plain PyTorch, the roundings with integer operations on the
fp32 bits, so the design is held to the fp32 gate here (max |err| <= 1e-3
RMS of the plain output, as on the card) against the port's plain versions
and the JAX package's Pallas kernels in interpret mode. A single TF32 pass
(the tensor core's other fp32 input type, 10 mantissa bits) misses that gate:
the split is what makes the tensor cores usable for fp32. At C = 512 the
forward forms S from 256-column piece tiles in one fp32 accumulator, every
small piece product before either leading one; ``_kernel_512_forward``
repeats that order, with the kernel's online softmax over 64-key tiles.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generative_detection_tpu.ops.attention import (
    _attention_pallas, _make_attention_custom, _mha_fwd_call,
)
from generative_detection_tpu_torch.ops import attention
from tests._torch_cpu import one_torch_thread  # noqa: F401 (autouse)

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


# The C = 512 forward's order of S's piece products (i, j) of Q_i K_j^T over
# 256-column block cb: each block's small ones, block 1's leading (0, 0), and
# block 0's (0, 0) last (from its K_0 streamed again).
S_ORDER_512 = ([(0, 2, 0), (1, 1, 0), (0, 1, 0), (1, 0, 0), (2, 0, 0)]
               + [(0, 2, 1), (1, 1, 1), (0, 1, 1), (1, 0, 1), (2, 0, 1), (0, 0, 1)]
               + [(0, 0, 0)])


def _kernel_512_forward(q, k, v, bk=64, w=256):
    """``attn_fwd_split512_wgmma_kernel``'s arithmetic in its order, each
    piece product exact in fp32 and summed in fp32: per tile of ``bk`` keys,
    S from ``S_ORDER_512``; the online softmax in the log2 domain (running
    max m, P = 2^(S scale log2(e) - m), l rescaled by 2^(m_old - m)); O
    rescaled, then O += P_i V_j over V_2, V_1, V_0 (i <= 2 - j, small
    first). Returns (O / l, lse)."""
    log2e = 1.4426950408889634
    scale_log2 = q.shape[-1] ** -0.5 * log2e
    qp, kp, vp = (_pieces(t, 3) for t in (q, k, v))
    acc = torch.zeros_like(q)
    m = torch.full(q.shape[:2], float("-inf"))
    lsum = torch.zeros(q.shape[:2])
    for k0 in range(0, k.shape[1], bk):
        keys = slice(k0, k0 + bk)
        s = torch.zeros(q.shape[0], q.shape[1], bk)
        for i, j, cb in S_ORDER_512:
            cols = slice(cb * w, (cb + 1) * w)
            s = s + torch.einsum("blc,bmc->blm", qp[i][..., cols], kp[j][:, keys, cols])
        m_new = torch.maximum(m, s.amax(-1) * scale_log2)
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s * scale_log2 - m_new[..., None])
        m, lsum = m_new, lsum * alpha + p.sum(-1)
        pp = _pieces(p, 3)
        acc = acc * alpha[..., None]
        for j in (2, 1, 0):
            for i in range(2 - j, -1, -1):
                acc = acc + torch.einsum("blm,bmc->blc", pp[i], vp[j][:, keys])
    return acc / lsum[..., None], (m + torch.log2(lsum)) / log2e


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


def test_split_forward_at_512_in_the_kernels_order_meets_the_fp32_gate():
    """The C = 512 kernel's order (the deferred leading product of column
    block 0 included) against the JAX package's ``_mha_fwd_call`` in
    interpret mode and the port's plain version, o and lse; one TF32 pass
    misses the gate."""
    rng = np.random.default_rng(4)
    arrays = [rng.standard_normal((2, 256, 512)).astype(np.float32) for _ in range(3)]
    q, k, v = (torch.from_numpy(a) for a in arrays)
    o_jax, lse_jax = _mha_fwd_call(*(jnp.asarray(a) for a in arrays), 128, True)
    pallas = (torch.from_numpy(np.array(o_jax)), torch.from_numpy(np.array(lse_jax))[:, 0])
    plain = attention._attention_reference(q, k, v)
    o, lse = _kernel_512_forward(q, k, v)
    tf32 = _emulated(q, k, v, lambda eq, a, b: torch.einsum(eq, _tf32_trunc(a), _tf32_trunc(b)))
    for want_o, want_lse in (pallas, plain):
        assert _rel_max_err(o, want_o) <= FP32_REL_TOL
        assert (lse - want_lse).abs().max().item() <= 1e-3  # LSE_TOL of the card checks
        assert _rel_max_err(tf32, want_o) > FP32_REL_TOL


@pytest.mark.parametrize("dtype, c, split", [
    (torch.float32, 64, True), (torch.float32, 128, True), (torch.float32, 256, True),
    (torch.float32, 512, True), (torch.bfloat16, 256, False),
])
def test_split_precision_widths(dtype, c, split):
    # ``split``: fp32 takes the split-precision kernels at every width, the
    # forward (C = 512 since its own kernel) and the backward; bf16 never
    q = torch.zeros(1, 128, c, dtype=dtype)
    assert attention.split_precision(q) == split
    scratch = attention._split_scratch(q)
    assert (scratch is not None) == split
    backward = attention._split_scratch(q, backward=True)
    assert (backward is not None) == split
    if split:  # three pieces of q, k, v, and of dO in the backward
        assert scratch.dtype == torch.bfloat16 and scratch.numel() == 9 * q.numel()
        assert backward.dtype == torch.bfloat16 and backward.numel() == 12 * q.numel()


def test_cpu_tensors_take_the_plain_versions():
    for c in (256, 512):
        q = torch.randn(1, 128, c)
        before = (attention.split_precision.launches, attention.split_precision_512.launches,
                  attention.flash_attention_forward.launches, attention.split_backward.launches,
                  attention.split_backward_512.launches, attention.attention_backward.launches)
        assert torch.equal(attention.flash_attention_forward(q, q, q),
                           attention._flash_reference(q, q, q))
        o, lse = attention.single_head_attention(q, q, q, return_lse=True)
        got = attention.attention_backward(q, q, q, o, lse, q)
        want = attention._attention_backward_reference(q, q, q, q, lse, (q * o).sum(-1))
        assert all(torch.equal(g, w) for g, w in zip(got, want))
        assert (attention.split_precision.launches, attention.split_precision_512.launches,
                attention.flash_attention_forward.launches, attention.split_backward.launches,
                attention.split_backward_512.launches,
                attention.attention_backward.launches) == before
