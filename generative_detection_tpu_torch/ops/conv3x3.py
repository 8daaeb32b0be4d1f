"""ctypes bindings of the 3x3 convolution kernels: ``csrc/conv3x3_wino.cu``
(TMA + ``wgmma``, bf16 and fp32 on split precision: the direct forward with
the GroupNorm+SiLU prologue, B6, and the row-Winograd forward and dgrad, B7)
and ``csrc/conv3x3_wgrad.cu`` (the row-Winograd weight gradient, B8: bf16
``wgmma``, fp32 split-precision ``wgmma``).

These launch and check; they count nothing. The wrappers that own the
launch counts are in ``ops.fused_conv`` and ``ops.winograd_rows``.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
BN = 64  # output channels per tile of the fp32 forward kernels
KC = 16  # input-channel chunk of the forward kernels
TN_WINO = 128  # output channels per tile of the bf16 forward kernels
TC = 64  # input channels per block of the weight-gradient kernels
TN_WGRAD = 128  # output channels per block of the weight-gradient kernels
KP = {torch.bfloat16: 32, torch.float32: 16}  # columns per chunk of the weight-gradient kernels
# weight-gradient blocks to aim for: two waves of one block per SM of the
# H100's 132 (177 KB of shared memory a block in bf16, 205 KB in fp32)
_TARGET_BLOCKS = 264
# fp32 weight gradient: the most positions one block sums. The tensor core
# truncates its fp32 sum to the accumulator's size, so the error grows with
# a block's chain of products; the split attention backward measured ~2e-4
# of the RMS at a chain of 4096 keys (gate 1e-3).
SPLIT_CHAIN = 4096


def _wino_lib() -> ctypes.CDLL:
    lib = _build.load("conv3x3_wino")
    if lib.gdt_conv3x3_wino.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.gdt_conv3x3_wino.argtypes = [p] * 8 + [i] * 9 + [p]
        lib.gdt_conv3x3_wino.restype = i
    return lib


def _wgrad_lib() -> ctypes.CDLL:
    lib = _build.load("conv3x3_wgrad")
    if lib.gdt_conv3x3_wgrad.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.gdt_conv3x3_wgrad.argtypes = [p] * 6 + [i] * 9 + [p]
        lib.gdt_conv3x3_wgrad.restype = i
    return lib


def _check(*tensors, dtype):
    if dtype not in _DTYPES:
        raise TypeError(f"conv3x3 kernels take float32 or bfloat16, got {dtype}")
    for t in tensors:
        if t is None:
            continue
        if t.device.type != "cuda" or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("conv3x3 kernels take contiguous, 16-byte aligned CUDA tensors")


def _affine_args(gn_ab, b, c, device):
    if gn_ab is None:
        return None, None
    ga, gb = (t.float().reshape(b, c).contiguous() for t in gn_ab)
    if ga.device != device:
        raise ValueError("conv3x3: the GroupNorm affine must be on the input's device")
    return ga, gb


def forward_shape_error(shape, co: int, dtype, mode: int, gn: bool = False,
                        emit_z: bool = False) -> Optional[str]:
    """Why ``conv3x3_forward`` refuses an input of ``shape`` (B, H, W, C) with
    ``co`` output channels, or None when a kernel takes it. Every mode runs
    ``csrc/conv3x3_wino.cu`` (mode 1, the direct form, is B6; mode 2 or 4,
    the row-Winograd forward and dgrad, B7): bf16 C % 16, CO % 128, H %
    mode; fp32 on split precision (tiles of 64 output channels) C % 16, CO %
    64, H % mode. Both take any W. Mode 1 runs only with the GroupNorm
    prologue."""
    _, h, w, c = shape
    if mode not in (1, 2, 4):
        return f"mode {mode} is not 1, 2 or 4"
    if emit_z and (mode != 1 or not gn):
        return "emit_z needs mode 1 with the GroupNorm prologue"
    tn = TN_WINO if dtype == torch.bfloat16 else BN
    if c % KC or co % tn or h % mode:
        return (f"the {dtype} conv3x3 kernel takes C % {KC} == 0, CO % {tn} == 0 and "
                f"H % mode == 0, got {tuple(shape)}->{co}, mode {mode}")
    if mode == 1 and not gn:
        return "mode 1 (the direct conv) runs only with the GroupNorm prologue"
    return None


def conv3x3_forward(
    x: torch.Tensor,
    u: torch.Tensor,
    bias: torch.Tensor,
    mode: int,
    gn_ab: Optional[tuple] = None,
    emit_z: bool = False,
):
    """Launch the forward kernel: x (B, H, W, C), u (P*3, C, CO) in x's dtype
    (P = 3 for ``mode`` 1, the direct kernel; mode + 2 for F(mode,3)), bias
    (CO,) fp32, ``gn_ab`` the (B, C) fp32 GroupNorm affine of the prologue.
    Every mode takes ``csrc/conv3x3_wino.cu``; in fp32 a pre-pass splits u
    into three bf16 pieces, in scratch allocated here
    (``forward_shape_error`` gives the shapes it takes). Returns out (B, H,
    W, CO), and z (B, H, W, C) with ``emit_z``."""
    b, h, w, c = x.shape
    co = u.shape[-1]
    pts = 3 if mode == 1 else mode + 2
    bias = bias.float().contiguous()
    ga, gb = _affine_args(gn_ab, b, c, x.device)
    _check(x, u, bias, ga, gb, dtype=x.dtype)
    err = forward_shape_error(x.shape, co, x.dtype, mode, gn_ab is not None, emit_z)
    if err is None and (u.shape != (pts * 3, c, co) or u.dtype != x.dtype):
        err = f"u must be ({pts * 3}, {c}, {co}) {x.dtype}, got {tuple(u.shape)} {u.dtype}"
    if err is not None:
        raise ValueError(err)
    out = torch.empty((b, h, w, co), dtype=x.dtype, device=x.device)
    z = torch.empty_like(x) if emit_z else None
    stream = torch.cuda.current_stream(x.device).cuda_stream
    ptrs = (x.data_ptr(), u.data_ptr(), bias.data_ptr(),
            ga.data_ptr() if ga is not None else None, gb.data_ptr() if gb is not None else None,
            out.data_ptr())
    pieces = (torch.empty(3 * u.numel(), dtype=torch.bfloat16, device=x.device)
              if x.dtype == torch.float32 else None)
    lib = _wino_lib()
    rc = lib.gdt_conv3x3_wino(*ptrs, z.data_ptr() if z is not None else None,
                              pieces.data_ptr() if pieces is not None else None, b, h, w, c, co,
                              mode, int(gn_ab is not None), int(emit_z), _DTYPES[x.dtype], stream)
    _build.check(lib, rc, "conv3x3 kernel launch")
    return (out, z) if emit_z else out


def wgrad_shape_error(shape, co: int, dtype, m: int) -> Optional[str]:
    """Why ``conv3x3_wgrad`` refuses z of ``shape`` (B, H, W, C) with ``co``
    output channels, or None when its kernel takes it: C % 64, H % m, and CO
    % 128 (bf16) or CO % 64 (fp32, whose blocks of 128 output channels store
    only the first 64 past CO); any W."""
    _, h, _, c = shape
    tn = TN_WGRAD if dtype == torch.bfloat16 else BN
    if m not in (2, 4) or c % TC or co % tn or h % m:
        return (f"conv3x3 wgrad kernel takes C % {TC} == 0, CO % {tn} == 0 ({dtype}) and "
                f"H % m == 0, got z {tuple(shape)}, CO {co}, m {m}")
    return None


def _wgrad_splits(b: int, h: int, w: int, c: int, co: int, m: int, dtype) -> int:
    """Split-K factor of the weight-gradient kernel: enough blocks to fill
    the card, at most one per position chunk; in fp32 also enough that no
    block sums more than ``SPLIT_CHAIN`` positions."""
    chunks = b * (h // m) * math.ceil(w / KP[dtype])
    blocks = (c // TC) * math.ceil(co / TN_WGRAD) * (m + 2)
    splits = math.ceil(_TARGET_BLOCKS / blocks)
    if dtype == torch.float32:
        splits = max(splits, math.ceil(chunks * KP[dtype] / SPLIT_CHAIN))
    return max(1, min(splits, chunks))


def conv3x3_wgrad(
    z: torch.Tensor, dy: torch.Tensor, m: int, gn_ab: Optional[tuple] = None
) -> torch.Tensor:
    """Launch ``csrc/conv3x3_wgrad.cu``: z (B, H, W, C) (raw x with
    ``gn_ab``), dy (B, H, W, CO) in z's dtype (bf16: TMA + ``wgmma``; fp32:
    split-precision ``wgmma``; any W). Returns dU ((m+2)*3, C, CO) float32."""
    b, h, w, c = z.shape
    co = dy.shape[-1]
    ga, gb = _affine_args(gn_ab, b, c, z.device)
    _check(z, dy, ga, gb, dtype=z.dtype)
    err = wgrad_shape_error(z.shape, co, z.dtype, m)
    if err is None and (dy.shape != (b, h, w, co) or dy.dtype != z.dtype):
        err = f"dy must be {(b, h, w, co)} {z.dtype}, got {tuple(dy.shape)} {dy.dtype}"
    if err is not None:
        raise ValueError(err)
    splits = _wgrad_splits(b, h, w, c, co, m, z.dtype)
    pts = m + 2
    part = torch.empty((splits, pts * 3, c, co), dtype=torch.float32, device=z.device)
    du = torch.empty((pts * 3, c, co), dtype=torch.float32, device=z.device)
    lib = _wgrad_lib()
    rc = lib.gdt_conv3x3_wgrad(
        z.data_ptr(), dy.data_ptr(),
        ga.data_ptr() if ga is not None else None,
        gb.data_ptr() if gb is not None else None,
        part.data_ptr(), du.data_ptr(), b, h, w, c, co, m, int(gn_ab is not None), splits,
        _DTYPES[z.dtype], torch.cuda.current_stream(z.device).cuda_stream,
    )
    _build.check(lib, rc, "conv3x3 wgrad kernel launch")
    return du
