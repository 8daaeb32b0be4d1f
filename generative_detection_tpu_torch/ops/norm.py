"""GroupNorm(+SiLU) over NHWC feature maps, forward and backward.

``group_norm`` takes a CPU tensor through the plain PyTorch versions
(``_gn_reference``, ``_gn_backward_reference``) and a CUDA tensor through the
hand-written kernels in ``csrc/group_norm.cu`` (forward) and
``csrc/group_norm_bwd.cu`` (backward), or raises. There is no other path.
When autograd needs the result, the call goes through ``_GroupNormFn``; its
forward keeps the per-(image, group) statistics (the kernel's stats partials
on the card, mean and rstd on the CPU) so the backward never recomputes
them. Under ``torch.no_grad`` and ``inference_mode`` nothing is saved.

Kernel notes:

- forward: replaces ``generative_detection_tpu/ops/norm.py`` ``_gn_pallas``
  (kernel ``_gn_kernel``), which runs only on rows of <= 512K elements
  because the whole row must sit in TPU VMEM, and the chunked stats and
  apply kernels ``_gn_chunked_stats``/``_gn_chunked_apply`` that take larger
  rows. On the H100 it is memory-bound (read x, write y); it streams row
  tiles in two launches, a deterministic stats pass with per-tile partials
  and an apply pass, so one kernel takes every GroupNorm of the model, from
  16x16x512 up to 256x256x128 per image.
- backward: replaces the chunked custom VJP's reduce and dx kernels
  (``_gn_bwd_reduce_chunk_kernel``, ``_gn_bwd_dx_chunk_kernel``). Also
  memory-bound (read x and dy, write dx); two launches, a reduce pass with
  per-tile partials and a dx pass that folds them in a fixed order.
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


def _gn_forward_reference(x, gamma, beta, num_groups, eps, act):
    """Plain forward that also returns the per-(image, group) ``mean`` and
    ``rstd``, each (B, G) float32."""
    b, h, w, c = x.shape
    xg = x.reshape(b, h * w, num_groups, c // num_groups).float()
    mean = xg.mean(dim=(1, 3), keepdim=True)
    meansq = xg.square().mean(dim=(1, 3), keepdim=True)
    var = torch.clamp(meansq - mean.square(), min=0.0)
    rstd = torch.rsqrt(var + eps)
    y = ((xg - mean) * rstd).reshape(b, h, w, c)
    y = y * gamma.float() + beta.float()
    if act == "silu":
        y = y * torch.sigmoid(y)
    return y.to(x.dtype), mean.reshape(b, num_groups), rstd.reshape(b, num_groups)


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
    return _gn_forward_reference(x, gamma, beta, num_groups, eps, act)[0]


def _gn_backward_reference(x, dy, mean, rstd, gamma, beta, act):
    """Plain backward, the closed form of ``norm.py:511-537`` of the JAX
    package from the forward's ``mean`` and ``rstd`` (B, G): returns
    (dx in ``x.dtype``, dgamma, dbeta float32 (C,))."""
    b, h, w, c = x.shape
    g = mean.shape[-1]
    shape = (b, h * w, g, c // g)
    xhat = (x.float().reshape(shape) - mean.reshape(b, 1, g, 1)) * rstd.reshape(b, 1, g, 1)
    g32 = gamma.float().reshape(1, 1, g, c // g)
    dy32 = dy.float().reshape(shape)
    if act == "silu":
        z = xhat * g32 + beta.float().reshape(1, 1, g, c // g)
        sig = torch.sigmoid(z)
        dz = dy32 * sig * (1.0 + z * (1.0 - sig))
    else:
        dz = dy32
    dgamma = (dz * xhat).sum(dim=(0, 1)).reshape(c)
    dbeta = dz.sum(dim=(0, 1)).reshape(c)
    dxhat = dz * g32
    m1 = dxhat.mean(dim=(1, 3), keepdim=True)
    m2 = (dxhat * xhat).mean(dim=(1, 3), keepdim=True)
    dx = (dxhat - m1 - xhat * m2) * rstd.reshape(b, 1, g, 1)
    return dx.reshape(b, h, w, c).to(x.dtype), dgamma, dbeta


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


def _bwd_lib() -> ctypes.CDLL:
    lib = _build.load("group_norm_bwd")
    if lib.gdt_group_norm_bwd.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.gdt_group_norm_bwd.argtypes = [
            p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, ctypes.c_float, i, i, p,
        ]
        lib.gdt_group_norm_bwd.restype = i
    return lib


def _check_kernel_args(x, gamma, beta, act):
    c = x.shape[-1]
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
    if x.data_ptr() % 16:
        raise ValueError("group_norm kernel needs a 16-byte aligned tensor")


def _gn_cuda(x, gamma, beta, num_groups, eps, act):
    """Forward kernel: returns (y, partial), ``partial`` the (B, tiles, 2, G)
    float32 per-tile (sum, sumsq) that the backward kernels fold again."""
    _check_kernel_args(x, gamma, beta, act)
    b, h, w, c = x.shape
    gamma, beta = gamma.contiguous(), beta.contiguous()
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
    return y, partial


def _gn_backward_cuda(x, dy, partial, gamma, beta, num_groups, eps, act):
    """Backward kernels: returns (dx, dgamma, dbeta) from the forward's
    stats ``partial``."""
    _check_kernel_args(x, gamma, beta, act)
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError("group_norm backward: dy must match x in shape, dtype and device")
    if not dy.is_contiguous():
        dy = dy.contiguous()
        group_norm_backward.grad_copies += 1
    if dy.data_ptr() % 16:
        raise ValueError("group_norm backward kernel needs a 16-byte aligned dy")
    b, h, w, c = x.shape
    l = h * w
    rows, tiles = _tiling(b, l)
    if partial.shape != (b, tiles, 2, num_groups) or partial.dtype != torch.float32:
        raise ValueError("group_norm backward: partial does not come from this forward")
    gamma, beta = gamma.contiguous(), beta.contiguous()
    dx = torch.empty_like(x)
    chan = torch.empty((b, tiles, 2, c), dtype=torch.float32, device=x.device)
    grp = torch.empty((b, tiles, 2, num_groups), dtype=torch.float32, device=x.device)
    dgb = torch.empty((2, c), dtype=torch.float32, device=x.device)
    lib = _bwd_lib()
    rc = lib.gdt_group_norm_bwd(
        x.data_ptr(), dy.data_ptr(), partial.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
        chan.data_ptr(), grp.data_ptr(), dx.data_ptr(), dgb.data_ptr(), b, l, c,
        num_groups, rows, tiles, eps, int(act == "silu"), _DTYPES[x.dtype],
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(lib, rc, "group_norm backward kernel launch")
    group_norm_backward.launches += 1
    return dx, dgb[0], dgb[1]


def _gn_forward(x, gamma, beta, num_groups, eps, act):
    """(y, stats) by device: stats are (mean, rstd) on the CPU and the
    kernel's (partial,) on the card."""
    if x.device.type == "cpu":
        y, mean, rstd = _gn_forward_reference(x, gamma, beta, num_groups, eps, act)
        return y, (mean, rstd)
    if x.device.type != "cuda":
        raise ValueError(f"group_norm runs on cpu or cuda, got {x.device}")
    y, partial = _gn_cuda(x, gamma, beta, num_groups, eps, act)
    return y, (partial,)


def group_norm_backward(x, dy, stats, gamma, beta, num_groups=32, eps=1e-6, act=None):
    """(dx, dgamma, dbeta) of ``group_norm`` from the ``stats`` its forward
    kept: (mean, rstd) for a CPU tensor, (partial,) for a CUDA tensor."""
    if x.device.type == "cpu":
        return _gn_backward_reference(x, dy, *stats, gamma, beta, act)
    return _gn_backward_cuda(x, dy, *stats, gamma, beta, num_groups, eps, act)


group_norm_backward.launches = 0  # calls that launched the kernels (reduce + dx)
group_norm_backward.grad_copies = 0  # gradients that arrived non-contiguous


class _GroupNormFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, gamma, beta, num_groups, eps, act):
        y, stats = _gn_forward(x, gamma, beta, num_groups, eps, act)
        ctx.save_for_backward(x, gamma, beta, *stats)
        ctx.cfg = (num_groups, eps, act)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, gamma, beta, *stats = ctx.saved_tensors
        dx, dgamma, dbeta = group_norm_backward(x, dy, stats, gamma, beta, *ctx.cfg)
        return dx, dgamma, dbeta, None, None, None


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
    if torch.is_grad_enabled() and (x.requires_grad or gamma.requires_grad or beta.requires_grad):
        return _GroupNormFn.apply(x, gamma, beta, num_groups, eps, act)
    return _gn_forward(x, gamma, beta, num_groups, eps, act)[0]


group_norm.launches = 0  # calls that launched the kernel; each runs stats + apply
