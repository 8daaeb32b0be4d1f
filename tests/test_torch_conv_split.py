"""The split-precision design of the port's fp32 3x3 conv kernels, on the CPU.

On the card the fp32 fused GroupNorm+SiLU+conv (B6,
``fused_conv_split_wgmma_kernel``), the fp32 row-Winograd forward and dgrad
(B7, ``wino_rows_split_wgmma_kernel``) and weight gradient (B8,
``wgrad_split_wgmma_kernel``) run their products on the bf16 tensor cores:
every fp32 operand becomes three bf16 pieces, each the round-to-nearest-even
bf16 of what the earlier pieces leave, and each product sums the six piece
products with i + j <= 2 in fp32. The emulation below does that arithmetic in
plain PyTorch (the roundings with integer operations on the fp32 bits, as
``test_torch_port_attention_split.py`` does) and holds it to the kernels'
card gate, max |err| <= 1e-3 of the RMS, against float64: the direct conv
over a flagship contraction (9 x 128 channels), the row-Winograd forward at
F(2,3) and F(4,3), with and without the GroupNorm+SiLU prologue, over C =
512 (the widest fused site; V_a summed in fp32 from the fp32 activation,
then split; AT and the bias in fp32), and the weight gradient over 65 536
positions (the largest flagship site's contraction, narrow channels). One
bf16 pass misses that gate. The tensor core's own fp32 summation is not
emulated: the card tests measure it.

Then the pure shape and split-count rules of ``ops/conv3x3.py``: every
shape the parent's fp32 rules admitted (forward: C % 16, CO % 64, H % mode;
weight gradient: C % 64, CO % 64, H % m) is still admitted, at the flagship
sites, at W = 48, 72, 96, 100 and 200, and at the tiny configs' widths, and
the fp32 weight gradient's splits keep every block's chain of positions
within ``SPLIT_CHAIN``.
"""

import math

import pytest
import torch
import torch.nn.functional as F

from generative_detection_tpu_torch.ops import conv3x3
from generative_detection_tpu_torch.ops import winograd_rows as wr
from tests._torch_cpu import one_torch_thread  # noqa: F401 (autouse)

FP32_REL_TOL = 1e-3  # CONV_REL_TOL[float32] of the card tests and chip_smoke.py


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(torch.int32)


def _bf16_rn(x: torch.Tensor) -> torch.Tensor:
    """x rounded to the nearest bf16 (ties to even), as fp32 (finite inputs)."""
    b = _bits(x).to(torch.int64)
    b = (b + 0x7FFF + ((b >> 16) & 1)) & ~0xFFFF
    return b.to(torch.int32).view(torch.float32)


def _pieces(x: torch.Tensor, n: int = 3):
    out = []
    for _ in range(n):
        p = _bf16_rn(x)
        out.append(p)
        x = x - p  # exact in fp32
    return out


def _split(fn, a: torch.Tensor, b: torch.Tensor, n: int = 3) -> torch.Tensor:
    """sum over i + j < n of fn(a_i, b_j), the small piece products first,
    each exact in fp32 and summed in fp32."""
    pa, pb = _pieces(a, n), _pieces(b, n)
    pairs = sorted(((i, j) for i in range(n) for j in range(n - i)), key=lambda p: -sum(p))
    return sum(fn(pa[i], pb[j]) for i, j in pairs)


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    return ((got.double() - want).abs().max() / want.pow(2).mean().sqrt()).item()


def _conv(z, k):
    """3x3 SAME conv, NHWC / HWIO, in z's dtype."""
    return F.conv2d(z.permute(0, 3, 1, 2), k.permute(3, 2, 0, 1), padding=1).permute(0, 2, 3, 1)


def test_six_product_direct_conv_meets_the_fp32_gate():
    """B6's products: a flagship contraction of 9 x 128 channels."""
    g = torch.Generator().manual_seed(0)
    z = torch.randn(2, 16, 16, 128, generator=g)
    k = torch.randn(3, 3, 128, 64, generator=g) / (9 * 128) ** 0.5
    want = _conv(z.double(), k.double())
    assert _rel(_split(_conv, z, k), want) <= FP32_REL_TOL
    assert _rel(_conv(_bf16_rn(z), _bf16_rn(k)), want) > FP32_REL_TOL


def _points(z, m):
    """V_a of every point a over the t-rows, in z's dtype (the kernel's and
    the plain version's fp32 sums)."""
    bt = wr._MATS[m][0]
    ht = z.shape[1] // m
    zp = F.pad(z, (0, 0, 0, 0, 1, 1))
    rows = [zp[:, u::m][:, :ht] for u in range(m + 2)]
    return [sum(float(bt[a, u]) * rows[u] for u in range(m + 2) if bt[a, u])
            for a in range(m + 2)]


def _wino_forward(z, u, bias, m, matmul):
    """out[m t + i] = sum_a AT[i, a] sum_dx shift_dx(V_a U[a, dx]) + bias over
    z's t-rows, in z's dtype; every V_a U[a, dx] taken by ``matmul``."""
    at = wr._MATS[m][2]
    g = [sum(wr._shift(matmul(v, u[3 * a + dx]), dx) for dx in range(3))
         for a, v in enumerate(_points(z, m))]
    rows = [sum(float(at[i, a]) * g[a] for a in range(m + 2) if at[i, a]) + bias
            for i in range(m)]
    n, h, w, _ = z.shape
    return torch.stack(rows, dim=2).reshape(n, h, w, u.shape[-1])


@pytest.mark.parametrize("gn", [False, True])
@pytest.mark.parametrize("m", [2, 4])
def test_six_product_row_winograd_forward_meets_the_fp32_gate(m, gn):
    """B7's products at C = 512: V_a summed in fp32 from the (activated)
    fp32 rows, then split; U split; AT and the bias in fp32."""
    g = torch.Generator().manual_seed(3 + m + 10 * gn)
    c, co = 512, 32
    x = torch.randn(1, 8, 16, c, generator=g) * 2 + 0.5
    k = torch.randn(3, 3, c, co, generator=g) / (9 * c) ** 0.5
    bias = 0.1 * torch.randn(co, generator=g)
    u = wr.transform_kernel_rows(k, m).reshape(-1, c, co)  # fp32, as the kernel gets it
    z, z64 = x, x.double()
    if gn:  # silu(x a + b), rows outside the image zero after it (_points pads)
        a, b = 1 + 0.1 * torch.randn(c, generator=g), 0.1 * torch.randn(c, generator=g)
        z, z64 = F.silu(x * a + b), F.silu(z64 * a.double() + b.double())
    want = _wino_forward(z64, u.double(), bias.double(), m, torch.matmul)
    got = _wino_forward(z, u, bias, m, lambda v, w: _split(torch.matmul, v, w))
    assert got.dtype == torch.float32
    assert _rel(got, want) <= FP32_REL_TOL
    one_pass = _wino_forward(z, u, bias, m, lambda v, w: _bf16_rn(v) @ _bf16_rn(w))
    assert _rel(one_pass, want) > FP32_REL_TOL


def _dm(dy, m):
    at = wr._MATS[m][2]
    return [sum(float(at[i, a]) * dy[:, i::m] for i in range(m) if at[i, a])
            for a in range(m + 2)]


def _wgrad(z, dy, m, matmul):
    """dU[a, dx] = sum over positions of shift_dx(V_a)^T dM_a, every product
    taken by ``matmul(v, d)``."""
    return torch.stack([matmul(wr._shift(v, dx), d) for v, d in zip(_points(z, m), _dm(dy, m))
                        for dx in range(3)])


def test_six_product_weight_gradient_over_65536_positions_meets_the_fp32_gate():
    """B8's products: B (H / M) W = 65 536 positions, as at the flagship's
    16x128x128x256->128 site, F(4,3), 8 channels in and out."""
    g = torch.Generator().manual_seed(1)
    m = 4
    z = torch.randn(4, 64, 1024, 8, generator=g)
    dy = torch.randn(4, 64, 1024, 8, generator=g)
    assert z.shape[0] * z.shape[1] // m * z.shape[2] == 65536

    def einsum(v, d):
        return torch.einsum("nhwc,nhwo->co", v, d)

    want = _wgrad(z.double(), dy.double(), m, einsum)
    assert _rel(_wgrad(z, dy, m, lambda v, d: _split(einsum, v, d)), want) <= FP32_REL_TOL
    assert _rel(_wgrad(z, dy, m, lambda v, d: einsum(_bf16_rn(v), _bf16_rn(d))),
                want) > FP32_REL_TOL


# ---- the shape and split-count rules ---------------------------------------

def _parent_forward_admits(shape, co, mode, gn):
    """The parent's fp32 forward rule (mode 1 its split-precision direct
    form, modes 2 and 4 its FMA row-Winograd kernel)."""
    _, h, _, c = shape
    return mode in (1, 2, 4) and c % 16 == 0 and co % 64 == 0 and h % mode == 0 and (
        mode != 1 or gn)


def _parent_wgrad_admits(shape, co, m):
    """The parent's fp32 weight-gradient rule (its FMA kernel)."""
    _, h, _, c = shape
    return m in (2, 4) and c % 64 == 0 and co % 64 == 0 and h % m == 0


# (B, H, W, C, CO): the flagship's fused detector sites (batch 8 and 32), its
# fused step's weight-gradient sites (batch 16), W = 72 and 96 (past a
# 64-column tile, C2), W = 16 and 32 (packed rows), CO % 128 == 64, and the
# tiny configs' widths (ch 32 and 128, 32x32 input, batch 2)
SITES = [
    (8, 256, 256, 128, 128), (32, 128, 128, 128, 128), (8, 64, 64, 128, 256),
    (32, 64, 64, 256, 256), (8, 32, 32, 256, 256), (32, 16, 16, 256, 512),
    (8, 16, 16, 512, 512),
    (16, 128, 128, 256, 128), (16, 128, 128, 128, 128), (16, 64, 64, 256, 256),
    (16, 64, 64, 128, 256), (16, 32, 32, 256, 256), (16, 32, 32, 512, 256),
    (1, 8, 72, 128, 128), (2, 6, 96, 128, 256), (2, 32, 96, 128, 128),
    (2, 12, 32, 128, 128), (1, 20, 16, 256, 128), (2, 32, 40, 64, 192),
    (2, 32, 32, 32, 32), (2, 16, 16, 32, 64), (2, 16, 16, 64, 64),
    (2, 32, 32, 128, 128), (2, 16, 16, 128, 256), (2, 16, 16, 256, 256),
    (2, 8, 8, 256, 256), (2, 8, 8, 48, 64),
    (2, 8, 48, 128, 128), (1, 4, 200, 16, 64), (2, 12, 100, 32, 320),
]


@pytest.mark.parametrize("b, h, w, c, co", SITES)
def test_fp32_rules_admit_every_shape_the_parent_admitted(b, h, w, c, co):
    f32 = torch.float32
    shape = (b, h, w, c)
    for mode in (1, 2, 4):
        for gn in (False, True):
            for emit_z in ((False, True) if mode == 1 and gn else (False,)):
                if _parent_forward_admits(shape, co, mode, gn):
                    assert conv3x3.forward_shape_error(shape, co, f32, mode, gn, emit_z) is None
    for m in (2, 4):
        if not _parent_wgrad_admits(shape, co, m):
            continue
        assert conv3x3.wgrad_shape_error(shape, co, f32, m) is None
        splits = conv3x3._wgrad_splits(b, h, w, c, co, m, f32)
        chunks = b * (h // m) * math.ceil(w / conv3x3.KP[f32])
        assert 1 <= splits <= chunks
        assert math.ceil(chunks / splits) * conv3x3.KP[f32] <= conv3x3.SPLIT_CHAIN


def test_fp32_rules_agree_with_the_parent_on_a_grid():
    """Over a grid of shapes the fp32 rules admit exactly what the parent's
    did (neither rule changed; the kernels behind them did)."""
    f32 = torch.float32
    for h in (6, 8, 12, 16, 30, 32):
        for w in (8, 16, 24, 32, 40, 72, 96):
            for c in (16, 32, 48, 64, 96, 128):
                for co in (32, 64, 96, 128, 192):
                    shape = (2, h, w, c)
                    for mode in (1, 2, 4):
                        got = conv3x3.forward_shape_error(shape, co, f32, mode, gn=True) is None
                        assert got == _parent_forward_admits(shape, co, mode, True), (shape, co)
                    for m in (2, 4):
                        got = conv3x3.wgrad_shape_error(shape, co, f32, m) is None
                        assert got == _parent_wgrad_admits(shape, co, m), (shape, co, m)


def test_bf16_wgrad_splits_are_the_parent_s():
    """The bf16 weight gradient keeps its split count: 264 blocks' worth,
    at most one a chunk of 32 positions, no chain bound."""
    bf16 = torch.bfloat16
    for b, h, w, c, co in SITES:
        if c % 64 or co % 128 or h % 4:
            continue
        chunks = b * (h // 4) * math.ceil(w / 32)
        want = max(1, min(math.ceil(264 / ((c // 64) * (co // 128) * 6)), chunks))
        assert conv3x3._wgrad_splits(b, h, w, c, co, 4, bf16) == want
