"""Single-head spatial self-attention over (B, L, C) tokens.

    o = softmax(q k^T * C^-0.5) v      (no output scale)

``single_head_attention`` takes CPU tensors through ``_attention_reference``
(the plain PyTorch version, materialized logits) and CUDA tensors through the
hand-written kernel in ``csrc/attention.cu``, or raises.

Kernel note: replaces ``generative_detection_tpu/ops/attention.py``
``_mha_fwd_call`` (kernel ``_mha_fwd_kernel``), which holds full-length K/V in
TPU VMEM. Hopper's 227 KB of shared memory cannot: the kernel streams K/V
tiles with an online softmax, splits the output channels across warps at
C = 512, and runs bf16 on the tensor cores (``mma.sync``) and fp32 on FMA.
At (B, 4096, 256) it is compute-bound; at (B, 256, 512) memory-bound.
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


def _lib() -> ctypes.CDLL:
    lib = _build.load("attention")
    if lib.gdt_attention_fwd.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.gdt_attention_fwd.argtypes = [p, p, p, p, p, i, i, i, ctypes.c_float, i, p]
        lib.gdt_attention_fwd.restype = i
    return lib


def _attention_cuda(q, k, v):
    b, l, c = q.shape
    if q.dtype not in _DTYPES:
        raise TypeError(f"attention kernel takes float32 or bfloat16, got {q.dtype}")
    if c not in KERNEL_CHANNELS or l % KERNEL_L_MULTIPLE:
        raise ValueError(
            f"attention kernel takes C in {KERNEL_CHANNELS} and L % "
            f"{KERNEL_L_MULTIPLE} == 0, got L={l}, C={c}"
        )
    for t in (q, k, v):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("attention kernel takes contiguous, 16-byte aligned tensors")
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
    if q.device.type == "cpu":
        o, lse = _attention_reference(q, k, v)
    elif q.device.type == "cuda":
        o, lse = _attention_cuda(q, k, v)
    else:
        raise ValueError(f"attention runs on cpu or cuda, got {q.device}")
    return (o, lse) if return_lse else o


single_head_attention.launches = 0
