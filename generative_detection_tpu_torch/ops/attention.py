"""Single-head spatial self-attention over (B, L, C) tokens, forward and backward.

    o = softmax(q k^T * C^-0.5) v      (no output scale)

``single_head_attention`` takes CPU tensors through the plain PyTorch versions
(``_attention_reference``, ``_attention_backward_reference``, materialized
logits) and CUDA tensors through the hand-written kernels in
``csrc/attention.cu`` (forward) and ``csrc/attention_bwd.cu`` (backward), or
raises. When autograd needs the result, the call goes through
``_AttentionFn``, whose forward keeps (q, k, v, o, lse).

Kernel notes:

- forward: replaces ``generative_detection_tpu/ops/attention.py``
  ``_mha_fwd_call`` (kernel ``_mha_fwd_kernel``), which holds full-length K/V
  in TPU VMEM. Hopper's 227 KB of shared memory cannot: the kernel streams
  K/V tiles with an online softmax, splits the output channels across warps
  at C = 512, and runs bf16 on the tensor cores (``mma.sync``) and fp32 on
  FMA. At (B, 4096, 256) it is compute-bound; at (B, 256, 512) memory-bound.
- backward: replaces ``_mha_bwd_call`` (kernel ``_mha_bwd_kernel``), one
  k-major pass with two (L, C) fp32 accumulators in VMEM. On the H100 it is
  two deterministic launches (FlashAttention-2's split): dK/dV per key tile
  over a 128-channel slice, then dQ per query tile. di = rowsum(dO * O) is a
  torch reduction, as it is XLA outside the Pallas body in the JAX package.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
KERNEL_CHANNELS = (128, 256, 512)
KERNEL_L_MULTIPLE = 64


def _attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """Plain version (``attention.py:49-54`` of the JAX package): fp32 logits,
    softmax weights cast to v's dtype before the product. Returns (o, lse)."""
    c = q.shape[-1]
    logits = torch.einsum("blc,bmc->blm", q.float(), k.float()) * c**-0.5
    w = torch.softmax(logits, dim=-1)
    o = torch.einsum("blm,bmc->blc", w.to(v.dtype).float(), v.float()).to(q.dtype)
    return o, torch.logsumexp(logits, dim=-1)


def _attention_backward_reference(q, k, v, do, lse, di):
    """Plain backward with materialized logits, rounding where
    ``_mha_bwd_kernel`` (``attention.py:180-223`` of the JAX package) does:
    P is cast to dO's dtype before dV = P^T dO, and dS = P (dP - di) * scale
    to q's dtype before dK = dS^T q and dQ = dS k. Returns (dq, dk, dv) in
    q's dtype."""
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("blc,bmc->blm", q.float(), k.float()) * scale
    p = torch.exp(s - lse[..., None])
    dv = torch.einsum("blm,blc->bmc", p.to(do.dtype).float(), do.float())
    dp = torch.einsum("blc,bmc->blm", do.float(), v.float())
    ds = (p * (dp - di[..., None]) * scale).to(q.dtype).float()
    dk = torch.einsum("blm,blc->bmc", ds, q.float())
    dq = torch.einsum("blm,bmc->blc", ds, k.float())
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


def _lib() -> ctypes.CDLL:
    lib = _build.load("attention")
    if lib.gdt_attention_fwd.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.gdt_attention_fwd.argtypes = [p, p, p, p, p, i, i, i, ctypes.c_float, i, p]
        lib.gdt_attention_fwd.restype = i
    return lib


def _bwd_lib() -> ctypes.CDLL:
    lib = _build.load("attention_bwd")
    if lib.gdt_attention_bwd.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.gdt_attention_bwd.argtypes = [p] * 9 + [i, i, i, ctypes.c_float, i, p]
        lib.gdt_attention_bwd.restype = i
    return lib


def _check_kernel_args(*tensors):
    b, l, c = tensors[0].shape
    if tensors[0].dtype not in _DTYPES:
        raise TypeError(f"attention kernel takes float32 or bfloat16, got {tensors[0].dtype}")
    if c not in KERNEL_CHANNELS or l % KERNEL_L_MULTIPLE:
        raise ValueError(
            f"attention kernel takes C in {KERNEL_CHANNELS} and L % "
            f"{KERNEL_L_MULTIPLE} == 0, got L={l}, C={c}"
        )
    for t in tensors:
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("attention kernel takes contiguous, 16-byte aligned tensors")


def _attention_cuda(q, k, v):
    _check_kernel_args(q, k, v)
    b, l, c = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((b, l), dtype=torch.float32, device=q.device)
    lib = _lib()
    rc = lib.gdt_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        b, l, c, float(c) ** -0.5, _DTYPES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(lib, rc, "attention kernel launch")
    single_head_attention.launches += 1
    return o, lse


def _attention_backward_cuda(q, k, v, do, lse, di):
    _check_kernel_args(q, k, v, do)
    b, l, c = q.shape
    for name, t in (("lse", lse), ("di", di)):
        if t.shape != (b, l) or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"attention backward: {name} must be contiguous float32 ({b}, {l})")
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    lib = _bwd_lib()
    rc = lib.gdt_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        di.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, l, c,
        float(c) ** -0.5, _DTYPES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(lib, rc, "attention backward kernel launch")
    attention_backward.launches += 1
    return dq, dk, dv


def _attention_forward(q, k, v):
    if q.device.type == "cpu":
        return _attention_reference(q, k, v)
    if q.device.type == "cuda":
        return _attention_cuda(q, k, v)
    raise ValueError(f"attention runs on cpu or cuda, got {q.device}")


def attention_backward(q, k, v, o, lse, do):
    """(dq, dk, dv) of ``single_head_attention`` from its forward's (o, lse)
    and the output gradient ``do``."""
    if do.dtype != q.dtype or do.shape != q.shape:
        raise ValueError("attention backward: do must match q in shape and dtype")
    di = (do.float() * o.float()).sum(dim=-1)
    if q.device.type == "cpu":
        return _attention_backward_reference(q, k, v, do, lse, di)
    if not do.is_contiguous():
        do = do.contiguous()
        attention_backward.grad_copies += 1
    return _attention_backward_cuda(q, k, v, do, lse, di)


attention_backward.launches = 0  # calls that launched the kernels (dK/dV + dQ)
attention_backward.grad_copies = 0  # output gradients that arrived non-contiguous


class _AttentionFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v):
        o, lse = _attention_forward(q, k, v)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        return attention_backward(*ctx.saved_tensors, do)


def single_head_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, return_lse: bool = False
):
    """softmax(q k^T / sqrt(C)) v over (B, L, C); with ``return_lse`` also the
    row logsumexp of the scaled logits as (B, L) float32."""
    if q.dim() != 3 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(
            f"attention takes equal (B, L, C) q, k, v, got {q.shape}, {k.shape}, {v.shape}"
        )
    if not (q.dtype == k.dtype == v.dtype and q.device == k.device == v.device):
        raise ValueError("attention q, k, v must share dtype and device")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        o, lse = _AttentionFn.apply(q, k, v)
    else:
        o, lse = _attention_forward(q, k, v)
    return (o, lse) if return_lse else o


single_head_attention.launches = 0
