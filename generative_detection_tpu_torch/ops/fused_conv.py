"""Fused GroupNorm+SiLU -> 3x3 SAME conv (``ops/fused_conv.py`` of the JAX
package), over NHWC activations and HWIO (3, 3, C, CO) kernels.

``gn_silu_conv`` computes the per-(image, channel) affine (a, b) of the
GroupNorm (``norm.group_norm_affine``: the stats kernel on the card), then
conv(silu(x a + b)) + bias with the activation made inside the convolution:
on the card ``fused_conv_wgmma_kernel`` of ``csrc/conv3x3_wino.cu`` in bf16
(``fused_conv_split_wgmma_kernel``, the same pipeline on split precision, in
fp32), on the CPU the plain ``gn_silu_conv_reference``. Two backward variants, one
``torch.autograd.Function`` each, as the JAX package's two custom VJPs:

- inference (``save_activation=False``, ``_make_fused_vjp``): the forward
  keeps x only and the backward rematerialises z = silu(x a + b);
- training (``save_activation=True``, ``_make_fused_vjp_train``): the kernel
  also writes z, which the backward reads.

Both backwards are the vjp of the plain composite: the convolution's input
and weight gradients (cuDNN on the card, as XLA's conv in JAX) and the
GroupNorm+SiLU pullback through ``norm.group_norm_backward`` (its kernels on
the card) from the stats the forward kept.

Kernel note: replaces ``_fused_pallas`` (kernel ``_fused_kernel``), which
DMAs row tiles plus halos into VMEM, activates them there and runs nine
tile-wide MXU products with masked rolls for the column shifts. The Hopper
kernel, ``fused_conv_wgmma_kernel`` (``csrc/conv3x3_wino.cu``, the direct
form of B7's pipeline: raw rows by TMA, activated once per 128 output
channels, nine SS ``wgmma`` taps per output row, TMA-store epilogue; in
fp32 every point and weight slab three bf16 pieces and six piece products a
tap), tiles its own way and takes any W, so ``_pick_tile`` below only
decides which sites are routed to it, exactly as on the TPU.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .conv3x3 import conv3x3_forward
from .norm import _gn_affine_reference, group_norm_affine, group_norm_backward

# Per-program VMEM budget of the TPU kernel (bytes); routing only.
_VMEM_BUDGET = 9 * 1024 * 1024


def _itemsize(dtype) -> int:
    return 2 if dtype == torch.bfloat16 else 4


def _pick_tile(h: int, w: int, c: int, co: int, itemsize: int) -> Optional[int]:
    """Largest row tile TR dividing h whose TPU scratch fits the budget: the
    TPU kernel's routing rule, not the Hopper kernel's tile (four
    accumulators of 64 positions by 128 output channels, any H and W)."""
    for tr in (32, 16, 8, 4, 2, 1):
        if h % tr:
            continue
        zs = (tr + 2) * w * c * itemsize
        qbuf = 4 * tr * w * co * 4
        wts = 9 * c * co * itemsize
        out = 2 * tr * w * co * itemsize
        zout = 2 * tr * w * c * itemsize
        if zs + qbuf + wts + out + zout <= _VMEM_BUDGET:
            return tr
    return None


def fused_eligible(x_shape, co: int, dtype, num_groups: int = 32) -> bool:
    """Whether ``gn_silu_conv`` takes the fused kernel (``fused_conv.py:366``
    of the JAX package, without its Pallas availability probe)."""
    _, h, wd, c = x_shape
    return (
        c % num_groups == 0
        and c % 128 == 0
        and co % 128 == 0
        and wd % 8 == 0
        and _pick_tile(h, wd, c, co, _itemsize(dtype)) is not None
    )


def _silu_affine(x, a, b):
    """silu(x a + b) in fp32, rounded to x's dtype; a, b (B, C) fp32."""
    z = x.float() * a[:, None, None, :] + b[:, None, None, :]
    return (z * torch.sigmoid(z)).to(x.dtype)


def _conv_bias(z, w, bias):
    """3x3 SAME conv in z's dtype, bias added in fp32, rounded to z's dtype
    (the plain version's rounding)."""
    out = F.conv2d(z.permute(0, 3, 1, 2), w.to(z.dtype).permute(3, 2, 0, 1), padding=1)
    return (out.permute(0, 2, 3, 1).float() + bias.float()).to(z.dtype)


def gn_silu_conv_reference(x, gamma, beta, w, bias, num_groups: int = 32, eps: float = 1e-6):
    """Plain composite: GN -> SiLU -> 3x3 SAME conv (NHWC, HWIO weights); z
    is rounded to x's dtype before the conv and the bias is added in fp32."""
    a, b, _, _ = _gn_affine_reference(x, gamma, beta, num_groups, eps)
    return _conv_bias(_silu_affine(x, a, b), w, bias)


def _fused_forward(x, a, b, w, bias, emit_z):
    """(out, z) of the fused forward from the affine: the kernel on the card,
    the plain version on the CPU. z is None unless ``emit_z``."""
    if x.device.type == "cpu":
        z = _silu_affine(x, a, b)
        return _conv_bias(z, w, bias), (z if emit_z else None)
    w9 = w.to(x.dtype).reshape(9, w.shape[2], w.shape[3]).contiguous()
    res = conv3x3_forward(x, w9, bias, 1, gn_ab=(a, b), emit_z=emit_z)
    gn_silu_conv.launches += 1
    return res if emit_z else (res, None)


def _fused_vjp_forward(ctx, x, gamma, beta, w, bias, num_groups, eps, save_activation):
    a, b, stats = group_norm_affine(x, gamma, beta, num_groups, eps)
    out, z = _fused_forward(x, a, b, w, bias, save_activation)
    ctx.save_for_backward(x, gamma, beta, w, a, b, z, *stats)
    ctx.cfg = (num_groups, eps, bias.dtype)
    return out


def _fused_vjp_backward(ctx, dy):
    """The vjp of the plain composite, from the saved z or a recomputed one."""
    x, gamma, beta, w, a, b, z, *stats = ctx.saved_tensors
    num_groups, eps, bias_dtype = ctx.cfg
    if z is None:
        z = _silu_affine(x, a, b)
    dz, dw, _ = torch.ops.aten.convolution_backward(
        dy.to(x.dtype).permute(0, 3, 1, 2), z.permute(0, 3, 1, 2),
        w.to(x.dtype).permute(3, 2, 0, 1),
        None, [1, 1], [1, 1], [1, 1], False, [0, 0], 1, [True, True, False],
    )
    dbias = dy.float().sum(dim=(0, 1, 2)).to(bias_dtype)
    dx, dgamma, dbeta = group_norm_backward(
        x, dz.permute(0, 2, 3, 1).contiguous(), stats, gamma, beta, num_groups, eps, "silu"
    )
    return (dx, dgamma.to(gamma.dtype), dbeta.to(beta.dtype),
            dw.permute(2, 3, 1, 0).to(w.dtype), dbias, None, None)


class _FusedConvFn(torch.autograd.Function):
    """Inference variant (``_make_fused_vjp``): the forward writes only the
    output; the backward rematerialises z = silu(x a + b)."""

    @staticmethod
    def forward(ctx, x, gamma, beta, w, bias, num_groups, eps):
        return _fused_vjp_forward(ctx, x, gamma, beta, w, bias, num_groups, eps, False)

    backward = staticmethod(_fused_vjp_backward)


class _FusedConvTrainFn(torch.autograd.Function):
    """Training variant (``_make_fused_vjp_train``): the kernel also writes
    z, which the backward reads."""

    @staticmethod
    def forward(ctx, x, gamma, beta, w, bias, num_groups, eps):
        return _fused_vjp_forward(ctx, x, gamma, beta, w, bias, num_groups, eps, True)

    backward = staticmethod(_fused_vjp_backward)


def gn_silu_conv(
    x: torch.Tensor,
    gamma: torch.Tensor,
    beta: torch.Tensor,
    w: torch.Tensor,
    bias: torch.Tensor,
    num_groups: int = 32,
    eps: float = 1e-6,
    save_activation: bool = False,
) -> torch.Tensor:
    """GroupNorm(num_groups, eps) -> SiLU -> Conv3x3(SAME) over NHWC ``x``.

    ``w``: (3, 3, C, CO) HWIO; ``bias``: (CO,). Computes in x's dtype. Takes
    the fused path when ``fused_eligible`` says so, else the plain composite
    (the JAX package's XLA fallback). ``save_activation`` picks the training
    variant (z written by the forward) over the inference one (z recomputed
    in the backward)."""
    bsz, h, wd, c = x.shape
    kh, kw, ci, co = w.shape
    if (kh, kw) != (3, 3) or ci != c:
        raise ValueError(f"gn_silu_conv: kernel {tuple(w.shape)} for input {tuple(x.shape)}")
    if c % num_groups:
        raise ValueError(f"channels {c} not divisible by groups {num_groups}")
    with torch.autocast(x.device.type, enabled=False):
        if fused_eligible(x.shape, co, x.dtype, num_groups):
            fn = _FusedConvTrainFn if save_activation else _FusedConvFn
            return fn.apply(x, gamma, beta, w, bias, num_groups, eps)
        return gn_silu_conv_reference(x, gamma, beta, w, bias, num_groups, eps)


gn_silu_conv.launches = 0  # calls that launched the fused kernel (B6, either dtype)
