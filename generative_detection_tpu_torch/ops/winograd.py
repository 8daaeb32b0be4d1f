"""Winograd F(2x2, 3x3) convolution as plain tensor ops (``ops/winograd.py``
of the JAX package, ``GDT_WINOGRAD=1|xla``), over NHWC activations and HWIO
(3, 3, C, CO) kernels.

    Y = A^T [ (G g G^T) (.) (B^T d B) ] A

per 2x2 output tile: the transforms are adds, the sixteen (tiles, C) x
(C, CO) products one batched matmul accumulating in fp32. The JAX package
leaves this formulation to XLA (no Pallas kernel), so the port leaves it to
PyTorch. The output transform runs on the fp32 products, as the JAX
package's default (its ``GDT_WINOGRAD_CAST`` A/B switch is not ported).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

_G = np.array([[1, 0, 0], [0.5, 0.5, 0.5], [0.5, -0.5, 0.5], [0, 0, 1]], np.float32)


@functools.lru_cache(maxsize=None)
def _g_matrix(device: torch.device) -> torch.Tensor:
    """G on ``device``, copied once (a per-call host copy waits for the card)."""
    return torch.from_numpy(_G).to(device)


def transform_kernel(kernel: torch.Tensor) -> torch.Tensor:
    """(3, 3, Cin, Cout) -> (4, 4, Cin, Cout): U = G g G^T, in fp32."""
    g = _g_matrix(kernel.device)
    return torch.einsum("au,bv,uvio->abio", g, g, kernel.float())


def _bt_rows(col):
    return (col[0] - col[2], col[1] + col[2], col[2] - col[1], col[1] - col[3])


def _at_rows(col):
    return (col[0] + col[1] + col[2], col[1] - col[2] - col[3])


def winograd_conv3x3(x: torch.Tensor, kernel: torch.Tensor, bias, dtype=torch.float32):
    """3x3 stride-1 SAME conv via Winograd F(2x2, 3x3); H and W even.
    Returns (N, H, W, Cout) in ``dtype``."""
    n, h, w, cin = x.shape
    cout = kernel.shape[-1]
    if h % 2 or w % 2:
        raise ValueError("Winograd tiling needs even H, W")
    th, tw = h // 2, w // 2
    u = transform_kernel(kernel).to(dtype)
    xp = F.pad(x.to(dtype), (0, 0, 1, 1, 1, 1))
    # d[a][b]: (N, th, tw, C), the (a, b) element of every 4x4 tile
    d = [[xp[:, a : a + 2 * th : 2, b : b + 2 * tw : 2, :] for b in range(4)] for a in range(4)]
    cols = [_bt_rows([d[r][b] for r in range(4)]) for b in range(4)]  # [b][a]
    v = [_bt_rows([cols[b][a] for b in range(4)]) for a in range(4)]  # [a][b]
    vs = torch.stack([torch.stack(list(v[a]), dim=0) for a in range(4)], dim=0)
    # sixteen products over Cin, fp32 accumulation: (4, 4, N, th, tw, Cout)
    m = torch.einsum("abnhwc,abco->abnhwo", vs.float(), u.float())
    ycols = [_at_rows([m[r, b] for r in range(4)]) for b in range(4)]  # [b][i]
    yout = [_at_rows([ycols[b][i] for b in range(4)]) for i in range(2)]  # [i][j]
    arr = torch.stack([yout[0][0], yout[0][1], yout[1][0], yout[1][1]], dim=-2)
    arr = arr.reshape(n, th, tw, 2, 2, cout).permute(0, 1, 3, 2, 4, 5)
    out = arr.reshape(n, h, w, cout).to(dtype)
    if bias is not None:
        out = out + bias.to(dtype)
    return out
