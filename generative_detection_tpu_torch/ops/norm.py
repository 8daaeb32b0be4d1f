"""GroupNorm(+SiLU) over NHWC feature maps.

``group_norm`` takes a CPU tensor through ``_gn_reference`` (the plain
PyTorch version) and a CUDA tensor through the hand-written kernel in
``csrc/group_norm.cu``, or raises. There is no other path.

Kernel note: replaces ``generative_detection_tpu/ops/norm.py`` ``_gn_pallas``
(kernel ``_gn_kernel``), which runs only on rows of <= 512K elements because
the whole row must sit in TPU VMEM. On the H100 the kernel is memory-bound
(read x, write y); it streams row tiles in two launches, a deterministic
stats pass with per-tile partials and an apply pass, so one kernel takes
every GroupNorm of the model, from 16x16x512 up to 256x256x128 per image.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_THREADS = 256
# stats blocks to aim for: a few per SM of the H100's 132
_TARGET_BLOCKS = 528


def _gn_reference(
    x: torch.Tensor,
    gamma: torch.Tensor,
    beta: torch.Tensor,
    num_groups: int,
    eps: float,
    act: Optional[str],
) -> torch.Tensor:
    """Plain version: fp32 one-pass E[x^2] - E[x]^2 stats, variance clamped
    at >= 0, output in ``x.dtype`` (``norm.py:38-60`` of the JAX package)."""
    b, h, w, c = x.shape
    xg = x.reshape(b, h * w, num_groups, c // num_groups).float()
    mean = xg.mean(dim=(1, 3), keepdim=True)
    meansq = xg.square().mean(dim=(1, 3), keepdim=True)
    var = torch.clamp(meansq - mean.square(), min=0.0)
    y = ((xg - mean) * torch.rsqrt(var + eps)).reshape(b, h, w, c)
    y = y * gamma.float() + beta.float()
    if act == "silu":
        y = y * torch.sigmoid(y)
    return y.to(x.dtype)


def _tiling(b: int, l: int) -> tuple[int, int]:
    """Rows per tile and tiles per image: enough blocks to fill the card."""
    tiles = max(1, min(math.ceil(_TARGET_BLOCKS / b), math.ceil(l / 16)))
    rows = math.ceil(l / tiles)
    return rows, math.ceil(l / rows)


def _lib() -> ctypes.CDLL:
    lib = _build.load("group_norm")
    if lib.gdt_group_norm_fwd.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.gdt_group_norm_fwd.argtypes = [
            p, p, p, p, p, i, i, i, i, i, i, ctypes.c_float, i, i, p,
        ]
        lib.gdt_group_norm_fwd.restype = i
    return lib


def _gn_cuda(x, gamma, beta, num_groups, eps, act):
    b, h, w, c = x.shape
    if x.dtype not in _DTYPES:
        raise TypeError(f"group_norm kernel takes float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("group_norm kernel takes a contiguous NHWC tensor")
    vec = 16 // x.element_size()
    if c % 32 or c // vec > _THREADS:
        raise ValueError(
            f"group_norm kernel takes C % 32 == 0 and C <= {_THREADS * vec} "
            f"for {x.dtype}, got C={c}"
        )
    for name, p in (("gamma", gamma), ("beta", beta)):
        if p.dtype != torch.float32 or p.shape != (c,) or p.device != x.device:
            raise ValueError(f"group_norm {name} must be float32 ({c},) on {x.device}")
    if act not in (None, "silu"):
        raise ValueError(f"group_norm act must be None or 'silu', got {act!r}")
    gamma, beta = gamma.contiguous(), beta.contiguous()
    if x.data_ptr() % 16:
        raise ValueError("group_norm kernel needs a 16-byte aligned tensor")
    l = h * w
    rows, tiles = _tiling(b, l)
    y = torch.empty_like(x)
    partial = torch.empty((b, tiles, 2, num_groups), dtype=torch.float32, device=x.device)
    lib = _lib()
    rc = lib.gdt_group_norm_fwd(
        x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), y.data_ptr(),
        partial.data_ptr(), b, l, c, num_groups, rows, tiles, eps,
        int(act == "silu"), _DTYPES[x.dtype], torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(lib, rc, "group_norm kernel launch")
    group_norm.launches += 1
    return y


def group_norm(
    x: torch.Tensor,
    gamma: torch.Tensor,
    beta: torch.Tensor,
    num_groups: int = 32,
    eps: float = 1e-6,
    act: Optional[str] = None,
) -> torch.Tensor:
    """GroupNorm over NHWC ``x`` with optional fused SiLU (``act='silu'``).

    ``gamma``/``beta`` stay float32 whatever the activation dtype."""
    if x.dim() != 4:
        raise ValueError(f"group_norm takes (B, H, W, C), got {tuple(x.shape)}")
    if x.shape[-1] % num_groups:
        raise ValueError(f"channels {x.shape[-1]} not divisible by groups {num_groups}")
    if x.device.type == "cpu":
        return _gn_reference(x, gamma, beta, num_groups, eps, act)
    if x.device.type != "cuda":
        raise ValueError(f"group_norm runs on cpu or cuda, got {x.device}")
    return _gn_cuda(x, gamma, beta, num_groups, eps, act)


group_norm.launches = 0  # calls that launched the kernel; each runs stats + apply
