"""Row-Winograd 3x3 conv: F(m,3) along H, direct along W, forward, dgrad and
weight gradient (``ops/winograd_pallas.py`` of the JAX package), over NHWC
activations and HWIO (3, 3, C, CO) kernels.

Math (rows; columns stay a direct 3-tap conv), for output rows m t .. m t +
m - 1:

  V_a[t]   = sum_u BT[a, u] z[m t + u - 1]            (fp32 sum, cast to T)
  U[a, dx] = sum_ky G[a, ky] K[ky, dx]                 (torch op, fp32 -> T)
  G_a      = sum_dx shift_dx(V_a @ U[a, dx])           (fp32 accumulate)
  out[m t + i] = sum_a AT[i, a] G_a[t] + bias          (fp32, cast to T)

- ``wino_rows_conv3x3``: the conv with its backward, dz through the same
  kernel with the rotated, io-swapped kernel when the swapped tile fits, else
  cuDNN's dgrad; dK through the weight-gradient kernel when its tile fits,
  else cuDNN's weight gradient; db a reduction.
- ``gn_silu_wino_conv3x3``: GroupNorm+SiLU -> the same conv, the activation
  made inside the kernel from the affine of ``norm.group_norm_affine``; its
  backward also recomputes the activation inside the weight-gradient kernel,
  and pulls dz back through ``norm.group_norm_backward``.

Every kernel call goes through an operator of ``torch.ops.gdt``
(``gdt::wino_rows``, ``wino_rows_dgrad``, ``wino_wgrad``; ``ops/library.py``).
A CPU tensor takes the plain versions (``_wino_rows_reference``,
``_wino_wgrad_reference``: the same V/U/G/AT algorithm and rounding in torch
ops); a CUDA tensor takes ``csrc/conv3x3_wino.cu`` for the forward and
dgrad (bf16 ``wgmma``, fp32 split-precision ``wgmma``; replacing
``_wino_rows_pallas``) and ``csrc/conv3x3_wgrad.cu`` for the weight
gradient (the same two routes; replacing ``_wino_wgrad_pallas``), or raises. The TPU's tile pickers stay as routing
rules, so the same sites take these kernels as on the TPU.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from .conv3x3 import _launch_wgrad, _launch_wino
from .norm import group_norm_affine, group_norm_backward

# F(2,3) 1-D transforms.
_BT2 = np.array([[1, 0, -1, 0], [0, 1, 1, 0], [0, -1, 1, 0], [0, 1, 0, -1]], np.float32)
_G2 = np.array([[1, 0, 0], [0.5, 0.5, 0.5], [0.5, -0.5, 0.5], [0, 0, 1]], np.float32)
_AT2 = np.array([[1, 1, 1, 0], [0, 1, -1, -1]], np.float32)

# F(4,3) 1-D transforms (Lavin & Gray points {0, +-1, +-2, inf}).
_BT4 = np.array(
    [
        [4, 0, -5, 0, 1, 0],
        [0, -4, -4, 1, 1, 0],
        [0, 4, -4, -1, 1, 0],
        [0, -2, -1, 2, 1, 0],
        [0, 2, -1, -2, 1, 0],
        [0, 4, 0, -5, 0, 1],
    ],
    np.float32,
)
_G4 = np.array(
    [
        [1 / 4, 0, 0],
        [-1 / 6, -1 / 6, -1 / 6],
        [-1 / 6, 1 / 6, -1 / 6],
        [1 / 24, 1 / 12, 1 / 6],
        [1 / 24, -1 / 12, 1 / 6],
        [0, 0, 1],
    ],
    np.float32,
)
_AT4 = np.array(
    [[1, 1, 1, 1, 1, 0], [0, 1, -1, 2, -2, 0], [0, 1, 1, 4, 4, 0], [0, 1, -1, 8, -8, 1]],
    np.float32,
)

_MATS = {2: (_BT2, _G2, _AT2), 4: (_BT4, _G4, _AT4)}

# Per-program VMEM budget of the TPU kernels (bytes); routing only.
_VMEM_BUDGET = 10 * 1024 * 1024


@functools.lru_cache(maxsize=None)
def _g_matrix_once(m_out: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_MATS[m_out][1]).to(device)


def _g_matrix(m_out: int, device: torch.device) -> torch.Tensor:
    """G of F(m_out,3) on ``device``, copied once: a copy from host memory per
    call would make the host wait for the card's queue on every conv. Under
    a tracer (``torch.export``) a fresh copy: the tracer's tensor must not
    outlive the trace in the cache."""
    if torch.compiler.is_compiling():
        return torch.from_numpy(_MATS[m_out][1]).to(device)
    return _g_matrix_once(m_out, device)


def transform_kernel_rows(kernel: torch.Tensor, m_out: int = 2) -> torch.Tensor:
    """(3, 3, Cin, Cout) -> (m_out+2, 3, Cin, Cout) fp32: U[a,dx] = sum G[a,ky] K[ky,dx]."""
    return torch.einsum("ak,kxio->axio", _g_matrix(m_out, kernel.device), kernel.float())


def _pick_tile(h: int, w: int, c: int, co: int, itemsize: int, m_out: int):
    """Largest row tile TR (multiple of m_out) dividing h that fits VMEM."""
    n_pts = m_out + 2
    for tr in (32, 16, 8, 4, 2):
        if tr % m_out or h % tr:
            continue
        zs = (tr + 2) * w * c * itemsize
        u = 3 * n_pts * c * co * itemsize
        acc = n_pts * (tr // m_out) * w * co * 4
        out = 2 * tr * w * co * itemsize
        if zs + u + acc + out <= _VMEM_BUDGET:
            return tr
    return None


def _wgrad_tile(h, w, c, co, itemsize, m_out):
    """Row tile of the TPU weight-gradient kernel (adds the dy block and the
    fp32 dU to VMEM)."""
    n_pts = m_out + 2
    for tr in (32, 16, 8, 4, 2):
        if tr % m_out or h % tr:
            continue
        zs = (tr + max(2, m_out)) * w * c * itemsize
        dsz = tr * w * co * itemsize
        du = 3 * n_pts * c * co * 4
        work = n_pts * (tr // m_out) * w * max(c, co) * 4 * 2
        if zs + dsz + du + work <= _VMEM_BUDGET:
            return tr
    return None


def wino_rows_eligible(shape, cout, dtype, m_out: int = 2) -> bool:
    """Whether ``wino_rows_conv3x3`` takes the kernel: the JAX package's
    on-chip rule (C and CO multiples of 128, a tile that fits VMEM)."""
    n, h, w, c = shape
    if h % m_out or c % 128 or cout % 128:
        return False
    return _pick_tile(h, w, c, cout, dtype.itemsize, m_out) is not None


def gn_silu_wino_eligible(shape, cout, dtype, m_out: int = 4, num_groups: int = 32):
    """Whether ``gn_silu_wino_conv3x3`` can take the fused kernel path."""
    return shape[-1] % num_groups == 0 and wino_rows_eligible(shape, cout, dtype, m_out)


# ---------------------------------------------------------------------------
# plain versions (the CPU path and the card's yardstick)
# ---------------------------------------------------------------------------


def _coef_sum(coefs, terms, dtype=None):
    """sum_j coefs[j] * terms[j] in order, zero coefficients skipped; with
    ``dtype`` every partial sum is rounded to it (the TPU kernel's adds in the
    activation dtype)."""
    acc = None
    for cf, t in zip(coefs, terms):
        cf = float(cf)
        if cf == 0.0:
            continue
        term = t if cf == 1.0 else t * cf
        acc = term if acc is None else acc + term
        if dtype is not None:
            acc = acc.to(dtype)
    return acc


def _row_points(z, ga, gb, m_out):
    """The V_a of every t-row, each (N, H/m, W, C) in z's dtype: the
    activation silu(z a + b) first when ``ga`` is given, rows outside the
    image zero after it."""
    bt = _MATS[m_out][0]
    if ga is not None:
        v = z.float() * ga[:, None, None, :] + gb[:, None, None, :]
        z = (v * torch.sigmoid(v)).to(z.dtype)
    ht = z.shape[1] // m_out
    zp = F.pad(z, (0, 0, 0, 0, 1, 1))
    rows = [zp[:, u::m_out][:, :ht].float() for u in range(m_out + 2)]
    return [_coef_sum(bt[a], rows).to(z.dtype) for a in range(m_out + 2)]


def _shift(v, dx):
    """shift_dx(v)[x] = v[x + dx - 1] along W, zero outside."""
    if dx == 0:
        return F.pad(v[:, :, :-1], (0, 0, 1, 0))
    if dx == 2:
        return F.pad(v[:, :, 1:], (0, 0, 0, 1))
    return v


def _wino_rows_reference(z, u3n, bias, ga, gb, m_out):
    """Plain forward: z (N, H, W, C) in T, u3n (3(m+2), C, CO) in T, bias
    (CO,) fp32, ga/gb (N, C) fp32 or None. Returns (N, H, W, CO) in T."""
    at = _MATS[m_out][2]
    n, h, w, _ = z.shape
    co = u3n.shape[-1]
    v = _row_points(z, ga, gb, m_out)
    g = []
    for a, va in enumerate(v):
        q = [_shift(va.float() @ u3n[3 * a + dx].float(), dx) for dx in range(3)]
        g.append(q[0] + q[1] + q[2])
    phases = [_coef_sum(at[i], g) + bias.float() for i in range(m_out)]
    out = torch.stack(phases, dim=2).reshape(n, h, w, co)
    return out.to(z.dtype)


def _wino_wgrad_reference(z, dy, ga, gb, m_out):
    """Plain weight gradient: dU (3(m+2), C, CO) fp32 from z (raw x when
    ``ga`` is given) and dy, both in T."""
    at = _MATS[m_out][2]
    v = _row_points(z, ga, gb, m_out)
    dphase = [dy[:, i::m_out] for i in range(m_out)]
    out = []
    for a, va in enumerate(v):
        dm = _coef_sum(at[:, a], dphase, dy.dtype).float()
        for dx in range(3):
            out.append(torch.einsum("nhwc,nhwo->co", _shift(va, dx).float(), dm))
    return torch.stack(out)


# ---------------------------------------------------------------------------
# wrappers: the CPU takes the plain versions, the card the kernels
# ---------------------------------------------------------------------------


# the operators' implementations (registered in ``ops/library.py``): z
# (N, H, W, C) in T, u the transformed kernel (3(m+2), C, CO) in T, bias
# (CO,), ga/gb the (N, C) float32 affine or None


def _wino_rows_cuda(z, u, bias, ga, gb, m):
    """``gdt::wino_rows`` on the card: the forward kernel (B7)."""
    out, _ = _launch_wino(z, u, bias, ga, gb, m, False)
    wino_rows_forward.launches += 1
    return out


def _wino_rows_cpu(z, u, bias, ga, gb, m):
    return _wino_rows_reference(z, u, bias, ga, gb, m)


def _wino_rows_fake(z, u, bias, ga, gb, m):
    return z.new_empty((*z.shape[:3], u.shape[-1]))


def _zero_bias(u):
    return torch.zeros(u.shape[-1], dtype=torch.float32, device=u.device)


def _wino_rows_dgrad_cuda(dy, u, m):
    """``gdt::wino_rows_dgrad`` on the card: the same kernel (B7) on dy with
    the rotated, io-swapped kernel's transform, no bias."""
    out, _ = _launch_wino(dy, u, _zero_bias(u), None, None, m, False)
    wino_rows_dgrad.launches += 1
    return out


def _wino_rows_dgrad_cpu(dy, u, m):
    return _wino_rows_reference(dy, u, _zero_bias(u), None, None, m)


def _wino_rows_dgrad_fake(dy, u, m):
    return dy.new_empty((*dy.shape[:3], u.shape[-1]))


def _wino_wgrad_cuda(z, dy, ga, gb, m):
    """``gdt::wino_wgrad`` on the card: dU from the weight-gradient kernel
    (B8)."""
    du = _launch_wgrad(z, dy, ga, gb, m)
    wino_wgrad.launches += 1
    return du


def _wino_wgrad_cpu(z, dy, ga, gb, m):
    return _wino_wgrad_reference(z, dy, ga, gb, m)


def _wino_wgrad_fake(z, dy, ga, gb, m):
    return z.new_empty(((m + 2) * 3, z.shape[-1], dy.shape[-1]), dtype=torch.float32)


def wino_rows_forward(z, u3n, bias, m_out, gn_ab=None):
    """The row-Winograd forward (B7) from the transformed kernel ``u3n``,
    through ``gdt::wino_rows``."""
    ga, gb = gn_ab if gn_ab is not None else (None, None)
    return torch.ops.gdt.wino_rows(z, u3n, bias, ga, gb, m_out)


def wino_rows_dgrad(dy, u3n_rot, m_out):
    """dz of the row-Winograd conv: the same kernel on dy with the rotated,
    io-swapped kernel's transform ``u3n_rot`` (B7 as dgrad), through
    ``gdt::wino_rows_dgrad``."""
    return torch.ops.gdt.wino_rows_dgrad(dy, u3n_rot, m_out)


wino_rows_forward.launches = 0  # launches of the forward kernel as the forward
wino_rows_dgrad.launches = 0  # launches of it as the dgrad


def wino_wgrad(z, dy, dtype, m_out: int = 2, gn_ab=None):
    """Winograd weight gradient (B8) dK[ky,kx] = sum_a G[a,ky] dU[a,kx],
    (3, 3, C, CO) fp32, dU through ``gdt::wino_wgrad``. With ``gn_ab=(a,
    b)`` (per-(batch, channel) fp32 GroupNorm affines), ``z`` is the raw
    pre-norm input and the activation silu(z a + b) is recomputed inside."""
    n, h, w, c = z.shape
    co = dy.shape[-1]
    z, dy = z.to(dtype).contiguous(), dy.to(dtype).contiguous()
    ga, gb = gn_ab if gn_ab is not None else (None, None)
    du = torch.ops.gdt.wino_wgrad(z, dy, ga, gb, m_out)
    return torch.einsum("ak,axio->kxio", _g_matrix(m_out, du.device),
                        du.reshape(m_out + 2, 3, c, co))


wino_wgrad.launches = 0  # launches of csrc/conv3x3_wgrad.cu (either dtype)


def _u3n(kernel, dtype, m_out):
    c, co = kernel.shape[2], kernel.shape[3]
    return transform_kernel_rows(kernel, m_out).to(dtype).reshape(-1, c, co).contiguous()


def _direct(z, kernel, dtype):
    """cuDNN's (or the CPU's) direct 3x3 SAME conv in ``dtype``, NHWC/HWIO."""
    out = F.conv2d(z.to(dtype).permute(0, 3, 1, 2), kernel.to(dtype).permute(3, 2, 0, 1),
                   padding=1)
    return out.permute(0, 2, 3, 1)


def _direct_wgrad(z, dy, kernel_shape, dtype):
    """cuDNN's weight gradient of the direct conv, HWIO in ``dtype``."""
    co, c = kernel_shape[3], kernel_shape[2]
    _, dw, _ = torch.ops.aten.convolution_backward(
        dy.to(dtype).permute(0, 3, 1, 2), z.to(dtype).permute(0, 3, 1, 2),
        torch.empty((co, c, 3, 3), dtype=dtype, device=z.device),
        None, [1, 1], [1, 1], [1, 1], False, [0, 0], 1, [False, True, False],
    )
    return dw.permute(2, 3, 1, 0)


def _fwd_impl(z, kernel, bias, dtype, m_out, gn_ab=None):
    n, h, w, c = z.shape
    co = kernel.shape[-1]
    if _pick_tile(h, w, c, co, dtype.itemsize, m_out) is None:
        raise ValueError(
            f"no VMEM-provable row tile for shape {tuple(z.shape)}->{co} with "
            f"m_out={m_out}; gate calls on wino_rows_eligible()"
        )
    b = torch.zeros(co, dtype=torch.float32, device=z.device) if bias is None else bias.float()
    return wino_rows_forward(z.to(dtype).contiguous(), _u3n(kernel, dtype, m_out), b, m_out,
                             gn_ab)


def _dz(dy, kernel, dtype, m_out, like):
    """dz: the dgrad kernel with the rotated, io-swapped kernel when its
    (swapped) tile fits, else cuDNN's dgrad (the JAX package's XLA
    fallback)."""
    k_rot = kernel.flip(0, 1).transpose(2, 3)
    n, h, w, co = dy.shape
    if _pick_tile(h, w, co, k_rot.shape[-1], dtype.itemsize, m_out) is not None:
        dz = wino_rows_dgrad(dy.to(dtype).contiguous(), _u3n(k_rot, dtype, m_out), m_out)
    else:
        dz = _direct(dy, k_rot, dtype)
    return dz.to(like.dtype)


def _use_wgrad_kernel(z, dy, dtype, m_out):
    return _wgrad_tile(z.shape[1], z.shape[2], z.shape[3], dy.shape[-1], dtype.itemsize,
                       m_out) is not None


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors)


class _WinoRowsFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, z, kernel, bias, dtype, m_out):
        ctx.save_for_backward(z, kernel)
        ctx.cfg = (dtype, m_out, None if bias is None else bias.dtype)
        return _fwd_impl(z, kernel, bias, dtype, m_out)

    @staticmethod
    def backward(ctx, dy):
        z, kernel = ctx.saved_tensors
        dtype, m_out, bias_dtype = ctx.cfg
        dz = _dz(dy, kernel, dtype, m_out, z)
        if _use_wgrad_kernel(z, dy, dtype, m_out):
            dk = wino_wgrad(z, dy, dtype, m_out)
        else:
            dk = _direct_wgrad(z, dy, kernel.shape, dtype)
        db = None if bias_dtype is None else dy.float().sum(dim=(0, 1, 2)).to(bias_dtype)
        return dz, dk.to(kernel.dtype), db, None, None


def wino_rows_conv3x3(z, kernel, bias, dtype=torch.float32, m_out: int = 2):
    """3x3 stride-1 SAME conv via the row-Winograd kernel.

    z: (N, H, W, Cin) with H % m_out == 0; kernel: (3, 3, Cin, Cout); bias:
    (Cout,) or None; m_out: 2 (F(2,3)) or 4 (F(4,3)). Computes in ``dtype``
    and returns it."""
    with torch.autocast(z.device.type, enabled=False):
        if _needs_grad(z, kernel, bias):
            return _WinoRowsFn.apply(z, kernel, bias, dtype, m_out)
        return _fwd_impl(z, kernel, bias, dtype, m_out)


class _GnWinoFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, gamma, beta, kernel, bias, dtype, m_out, num_groups, eps):
        a, b, stats = group_norm_affine(x, gamma, beta, num_groups, eps)
        ctx.save_for_backward(x, gamma, beta, kernel, a, b, stats)
        ctx.cfg = (dtype, m_out, num_groups, eps, None if bias is None else bias.dtype)
        return _fwd_impl(x, kernel, bias, dtype, m_out, gn_ab=(a, b))

    @staticmethod
    def backward(ctx, dy):
        x, gamma, beta, kernel, a, b, stats = ctx.saved_tensors
        dtype, m_out, num_groups, eps, bias_dtype = ctx.cfg
        # cotangent of the activation z: the dgrad kernel (or cuDNN's dgrad)
        dz = _dz(dy, kernel, dtype, m_out, x)
        # weight gradient: the kernel reads raw x and recomputes the
        # activation, else recompute z here for cuDNN's weight gradient
        if _use_wgrad_kernel(x, dy, dtype, m_out):
            dk = wino_wgrad(x, dy, dtype, m_out, gn_ab=(a, b))
        else:
            v = x.float() * a[:, None, None, :] + b[:, None, None, :]
            dk = _direct_wgrad((v * torch.sigmoid(v)).to(x.dtype), dy, kernel.shape, dtype)
        db = None if bias_dtype is None else dy.float().sum(dim=(0, 1, 2)).to(bias_dtype)
        dx, dgamma, dbeta = group_norm_backward(
            x, dz.contiguous(), stats, gamma, beta, num_groups, eps, "silu"
        )
        return (dx, dgamma.to(gamma.dtype), dbeta.to(beta.dtype), dk.to(kernel.dtype), db,
                None, None, None, None)


def gn_silu_wino_conv3x3(
    x, gamma, beta, kernel, bias, dtype=torch.float32, m_out: int = 4,
    num_groups: int = 32, eps: float = 1e-6,
):
    """GroupNorm(num_groups, eps) -> SiLU -> 3x3 SAME conv, the conv on the
    row-Winograd kernel with the normalize made inside it. Semantics of
    ``ops.fused_conv.gn_silu_conv_reference``; gate calls on
    ``gn_silu_wino_eligible``."""
    with torch.autocast(x.device.type, enabled=False):
        if _needs_grad(x, gamma, beta, kernel, bias):
            return _GnWinoFn.apply(x, gamma, beta, kernel, bias, dtype, m_out, num_groups, eps)
        # forward only: the affine without the backward's stats
        a, b, _ = group_norm_affine(x, gamma, beta, num_groups, eps, keep_stats=False)
        return _fwd_impl(x, kernel, bias, dtype, m_out, gn_ab=(a, b))
