"""Subpixel (phase-decomposed) nearest-2x upsample + 3x3 conv
(``ops/upsample.py`` of the JAX package, ``GDT_SUBPIXEL_UP=1``), over NHWC
activations and HWIO (3, 3, C, CO) kernels.

With u[r] = x[floor(r/2)] and o[r] = K0 u[r-1] + K1 u[r] + K2 u[r+1]:

    o[2i]   = K0 x[i-1] + (K1 + K2) x[i]
    o[2i+1] = (K0 + K1) x[i] + K2 x[i+1]

so the op is one 2x2 VALID conv with 4 CO outputs over x padded by one on
every side, at the low resolution (4/9 of the products), and a
depth-to-space interleave. The tap sums run in the kernel's own dtype (fp32
parameters) before any cast. Plain tensor ops: the JAX package has no
Pallas kernel here either (XLA's conv).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def phase_kernel(kernel: torch.Tensor) -> torch.Tensor:
    """(3, 3, Cin, Cout) -> (2, 2, Cin, 4*Cout), output-channel groups
    [P00, P01, P10, P11] for output phase (row parity, column parity)."""
    k0, k1, k2 = kernel[0], kernel[1], kernel[2]
    r0 = torch.stack([k0, k1 + k2], dim=0)  # phase a=0: x rows (i-1, i)
    r1 = torch.stack([k0 + k1, k2], dim=0)  # phase a=1: x rows (i, i+1)

    def cols(m):
        c0 = torch.stack([m[:, 0], m[:, 1] + m[:, 2]], dim=1)
        c1 = torch.stack([m[:, 0] + m[:, 1], m[:, 2]], dim=1)
        return c0, c1

    p00, p01 = cols(r0)
    p10, p11 = cols(r1)
    return torch.cat([p00, p01, p10, p11], dim=-1)


def subpixel_upsample_conv(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
                           dtype=torch.float32) -> torch.Tensor:
    """nearest-2x upsample + 3x3 SAME conv computed at the low resolution.
    x (B, H, W, Cin) -> (B, 2H, 2W, Cout) in ``dtype``."""
    b, h, w, _ = x.shape
    cout = kernel.shape[-1]
    w4 = phase_kernel(kernel).to(dtype)
    xp = F.pad(x.to(dtype), (0, 0, 1, 1, 1, 1))
    y = F.conv2d(xp.permute(0, 3, 1, 2), w4.permute(3, 2, 0, 1)).permute(0, 2, 3, 1)
    p00 = y[:, :-1, :-1, 0 * cout : 1 * cout]
    p01 = y[:, :-1, 1:, 1 * cout : 2 * cout]
    p10 = y[:, 1:, :-1, 2 * cout : 3 * cout]
    p11 = y[:, 1:, 1:, 3 * cout : 4 * cout]
    arr = torch.stack([p00, p01, p10, p11], dim=-2)  # (B, H, W, 4, Cout)
    arr = arr.reshape(b, h, w, 2, 2, cout).permute(0, 1, 3, 2, 4, 5)
    return arr.reshape(b, 2 * h, 2 * w, cout) + bias.to(dtype)
