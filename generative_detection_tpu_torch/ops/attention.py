"""Single-head spatial self-attention over (B, L, C) tokens, forward and backward.

    o = softmax(q k^T * C^-0.5) v      (no output scale)

Every call goes through an operator of ``torch.ops.gdt`` (``ops/library.py``):
``gdt::attention_fwd``, ``flash_attention_fwd`` and ``attention_bwd``. The
dispatcher sends CPU tensors to the plain PyTorch versions
(``_attention_reference``, ``_attention_backward_reference``, materialized
logits) and CUDA tensors to the hand-written kernels in
``csrc/attention.cu`` (forward) and ``csrc/attention_bwd.cu`` (backward),
which raise where they cannot run. When autograd needs the result, the call goes through
``_AttentionFn``, whose forward keeps (q, k, v, o, lse).

Kernel notes:

- forward: replaces ``generative_detection_tpu/ops/attention.py``
  ``_mha_fwd_call`` (kernel ``_mha_fwd_kernel``), which holds full-length K/V
  in TPU VMEM. Hopper's 227 KB of shared memory cannot: the kernel streams
  K/V tiles with an online softmax. bf16 runs a warp-specialized kernel (a
  TMA producer, two ``wgmma`` consumer warpgroups, S and P in registers; at
  C = 512 the warpgroups split O's channels). fp32 runs both products on
  the tensor cores at fp32 accuracy: a pre-pass splits q, k and
  v into three bf16 pieces each (into scratch this wrapper allocates, 18
  bytes an element), and each product is the six piece products with
  i + j <= 2 (split-precision ``wgmma``); at C = 512 a block owns half of
  O's channels and forms S over all 512 from 256-column piece tiles. At
  (B, 4096, 256) it is compute-bound; at (B, 256, 512) memory-bound.
- backward: replaces ``_mha_bwd_call`` (kernel ``_mha_bwd_kernel``), one
  k-major pass with two (L, C) fp32 accumulators in VMEM. On the H100 it is
  blocks that each own 64 rows of one output, deterministic (no atomics).
  bf16 runs TMA and ``wgmma`` at every width: at C = 64, 128 and 256 two
  launches, dK/dV per key tile with one warpgroup per accumulator (S^T, P^T
  and dV; dP^T, dS^T and dK), then dQ per query tile; at C = 512 one launch
  whose blocks each own 64 rows and one 256-channel half of dK, dQ or dV
  and form S (and dP) over all 512 channels. fp32 at every width runs all
  five products split-precision, as the forward: a pre-pass splits q, k, v
  and dO into three bf16 pieces each (into scratch this wrapper allocates,
  24 bytes an element of q), then one launch whose blocks each accumulate dK, dQ or dV
  for 64 rows, keep one operand's pieces resident and stream the rest; at
  C = 512 a block owns half the output channels and forms S and dP over
  all 512 from 256-column piece tiles.
  di = rowsum(dO * O) is a torch reduction, as it is XLA outside the Pallas
  body in the JAX package.
- forward-only flash variant: ``flash_attention_forward`` replaces
  ``_attention_pallas`` (kernel ``_flash_kernel``), which upcasts q, k, v to
  fp32, keeps P in fp32 and writes no lse. In the JAX package only its
  availability probe and interpret mode reach it. On the H100, fp32 inputs
  take the forward's fp32 kernels without the lse; bf16 inputs take the
  bf16 kernel with P in two bf16 pieces (hi, lo) instead of rounded to
  bf16 (a product of two bf16 values is exact in fp32).

Shapes off the kernels' grid: the kernels run L % 128 == 0 and C in
``KERNEL_CHANNELS``. Any other L, and any C <= 512, is zero-padded up to
that grid (``kernel_shape``), the kernels mask the logits of the padded keys
to -inf (``l_valid``, the true L) and take the true scale C^-0.5, and the
padded rows and channels are sliced off the outputs. Zero channels add
nothing to q . k and give zero columns; a padded query row has a finite lse,
and in the backward dO = 0 and di = 0, so it adds nothing to dK or dV. The
JAX package sends such shapes to its XLA attention. Each padded call counts
one ``single_head_attention.pad_copies``; the flagship's shapes take none.
C > 512 has no kernel and raises.
"""

from __future__ import annotations

import ctypes
from types import SimpleNamespace

import torch
import torch.nn.functional as F

from . import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
KERNEL_CHANNELS = (64, 128, 256, 512)
KERNEL_L_MULTIPLE = 128  # the JAX package's gate (l % 128 == 0); the forward's q tile
# The bf16 pieces the split-precision kernels keep in scratch, three of each
# operand: q, k, v (forward), and dO (backward)
SPLIT_PIECES = 9
SPLIT_BWD_PIECES = 12


def kernel_shape(l: int, c: int) -> tuple:
    """The (L, C) the kernels run an (l, c) attention at: l up to a multiple
    of ``KERNEL_L_MULTIPLE``, c up to the next of ``KERNEL_CHANNELS``."""
    if l < 1 or not 1 <= c <= KERNEL_CHANNELS[-1]:
        raise ValueError(f"attention kernel takes C <= {KERNEL_CHANNELS[-1]} and L >= 1, "
                         f"got L={l}, C={c}")
    lp = -(-l // KERNEL_L_MULTIPLE) * KERNEL_L_MULTIPLE
    return lp, next(w for w in KERNEL_CHANNELS if w >= c)


def _scaled_logits(q, k, l_valid, scale):
    """fp32 q k^T * scale, the logits of keys at or past ``l_valid`` -inf."""
    s = torch.einsum("blc,bmc->blm", q.float(), k.float()) * scale
    if l_valid is not None and l_valid < k.shape[1]:
        s[..., l_valid:] = float("-inf")
    return s


def _scale(q, scale):
    return q.shape[-1] ** -0.5 if scale is None else scale


def _attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         l_valid=None, scale=None):
    """Plain version (``attention.py:49-54`` of the JAX package): fp32 logits,
    softmax weights cast to v's dtype before the product. Returns (o, lse).
    ``l_valid``: keys at or past it are masked (the kernels' padded rows);
    ``scale``: the logits' scale, C^-0.5 of q's width by default."""
    logits = _scaled_logits(q, k, l_valid, _scale(q, scale))
    w = torch.softmax(logits, dim=-1)
    o = torch.einsum("blm,bmc->blc", w.to(v.dtype).float(), v.float()).to(q.dtype)
    return o, torch.logsumexp(logits, dim=-1)


def _attention_backward_reference(q, k, v, do, lse, di, l_valid=None, scale=None):
    """Plain backward with materialized logits, rounding where
    ``_mha_bwd_kernel`` (``attention.py:180-223`` of the JAX package) does:
    P is cast to dO's dtype before dV = P^T dO, and dS = P (dP - di) * scale
    to q's dtype before dK = dS^T q and dQ = dS k. Returns (dq, dk, dv) in
    q's dtype. ``l_valid`` and ``scale`` as in ``_attention_reference``."""
    scale = _scale(q, scale)
    p = torch.exp(_scaled_logits(q, k, l_valid, scale) - lse[..., None])
    dv = torch.einsum("blm,blc->bmc", p.to(do.dtype).float(), do.float())
    dp = torch.einsum("blc,bmc->blm", do.float(), v.float())
    ds = (p * (dp - di[..., None]) * scale).to(q.dtype).float()
    dk = torch.einsum("blm,blc->bmc", ds, q.float())
    dq = torch.einsum("blm,bmc->blc", ds, k.float())
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


def _on_grid(run, tensors, rows=()):
    """``run(*tensors, *rows, l_valid, scale)`` on the (B, L, C) ``tensors``
    and (B, L) ``rows`` zero-padded to the kernels' grid (``kernel_shape``),
    its outputs ((B, L', C') or (B, L')) sliced back to (B, L, C) or (B, L).
    On the grid nothing is copied; each padded call counts one
    ``single_head_attention.pad_copies``."""
    _, l, c = tensors[0].shape
    lp, cp = kernel_shape(l, c)
    scale = c ** -0.5
    if (lp, cp) == (l, c):
        return run(*tensors, *rows, l, scale)
    single_head_attention.pad_copies += 1
    out = run(*(F.pad(t, (0, cp - c, 0, lp - l)) for t in tensors),
              *(F.pad(r, (0, lp - l)) for r in rows), l, scale)
    single = isinstance(out, torch.Tensor)
    out = [t[:, :l, :c] if t.dim() == 3 else t[:, :l] for t in ([out] if single else out)]
    out = [t.contiguous() for t in out]
    return out[0] if single else tuple(out)


def _lib() -> ctypes.CDLL:
    lib = _build.load("attention")
    if lib.gdt_attention_fwd.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.gdt_attention_fwd.argtypes = [p, p, p, p, p, p, i, i, i, i, ctypes.c_float, i, p]
        lib.gdt_attention_fwd.restype = i
        lib.gdt_flash_attention_fwd.argtypes = [p, p, p, p, p, i, i, i, i, ctypes.c_float, i, p]
        lib.gdt_flash_attention_fwd.restype = i
    return lib


def _flash_reference(q, k, v, l_valid=None, scale=None):
    """Plain forward-only flash numerics (``_flash_kernel``): q, k, v upcast
    to fp32, softmax and P . V in fp32, output in q's dtype. ``l_valid`` and
    ``scale`` as in ``_attention_reference``."""
    w = torch.softmax(_scaled_logits(q, k, l_valid, _scale(q, scale)), dim=-1)
    return torch.einsum("blm,bmc->blc", w, v.float()).to(q.dtype)


def _bwd_lib() -> ctypes.CDLL:
    lib = _build.load("attention_bwd")
    if lib.gdt_attention_bwd.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.gdt_attention_bwd.argtypes = [p] * 10 + [i, i, i, i, ctypes.c_float, i, p]
        lib.gdt_attention_bwd.restype = i
    return lib


def _check_inputs(q):
    """Raise unless the kernels take (B, L, C) inputs like ``q``: float32 or
    bfloat16, C <= 512 (other L and C go through ``kernel_shape``'s
    padding). Shape and dtype only: the wrappers check them where a tracer
    sees them."""
    _, l, c = q.shape
    if q.dtype not in _DTYPES:
        raise TypeError(f"attention kernel takes float32 or bfloat16, got {q.dtype}")
    kernel_shape(l, c)


def _check_layout(*tensors):
    """Raise unless every tensor is contiguous and 16-byte aligned (inside
    the CUDA implementations, on the tensors the kernels read)."""
    for t in tensors:
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("attention kernel takes contiguous, 16-byte aligned tensors")


def _check_kernel_args(*tensors):
    """Raise unless the kernels take (B, L, C) ``tensors``: the wrappers'
    checks and the CUDA implementations' together."""
    _check_inputs(tensors[0])
    _check_layout(*tensors)


def split_precision(q) -> bool:
    """Whether attention on ``q`` on the card (either forward entry point,
    and the backward) runs the split-precision kernels: fp32, at every
    width of the kernels' grid."""
    return q.dtype == torch.float32


# forward calls that launched the split-precision kernel: at C <= 256
# (attn_fwd_split_wgmma_kernel), and at C = 512 (attn_fwd_split512_wgmma_kernel)
split_precision.launches = 0
split_precision_512 = SimpleNamespace(launches=0)
# backward calls that launched the split-precision kernels: at C <= 256
# (attn_bwd_split_wgmma_kernel), and at C = 512 (attn_bwd_split512_wgmma_kernel)
split_backward = SimpleNamespace(launches=0)
split_backward_512 = SimpleNamespace(launches=0)
# bf16 backward calls that launched the C = 512 kernel (attn_bwd_c512_wgmma_kernel)
backward_512 = SimpleNamespace(launches=0)


def _split_scratch(q, backward=False):
    """The bf16 pieces (of q, k, v, and dO in the backward) that the
    split-precision kernels write and read, or None where the kernels need
    none."""
    if not split_precision(q):
        return None
    pieces = SPLIT_BWD_PIECES if backward else SPLIT_PIECES
    return torch.empty(pieces * q.numel(), dtype=torch.bfloat16, device=q.device)


def _count_split(scratch, counter) -> None:
    if scratch is not None:
        counter.launches += 1


def _ptr(t) -> int:
    return 0 if t is None else t.data_ptr()


def _stream(t) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


# ---------------------------------------------------------------------------
# the operators' implementations (registered in ``ops/library.py``): the CUDA
# ones launch the kernels on the grid's shapes and count, the CPU ones are the
# plain versions, the fake ones give the outputs' shapes
# ---------------------------------------------------------------------------


def _attention_fwd_cuda(q, k, v, l_valid, scale):
    """``gdt::attention_fwd`` on the card: (o, lse)."""
    _check_layout(q, k, v)
    b, l, c = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((b, l), dtype=torch.float32, device=q.device)
    scratch = _split_scratch(q)
    lib = _lib()
    rc = lib.gdt_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(), _ptr(scratch),
        b, l, c, l_valid, scale, _DTYPES[q.dtype], _stream(q),
    )
    _build.check(lib, rc, "attention kernel launch")
    single_head_attention.launches += 1
    _count_split(scratch, split_precision_512 if c == 512 else split_precision)
    return o, lse


def _attention_fwd_cpu(q, k, v, l_valid, scale):
    return _attention_reference(q, k, v, l_valid, scale)


def _attention_fwd_fake(q, k, v, l_valid, scale):
    return torch.empty_like(q), q.new_empty(q.shape[:2], dtype=torch.float32)


def _flash_attention_fwd_cuda(q, k, v, l_valid, scale):
    """``gdt::flash_attention_fwd`` on the card: o."""
    _check_layout(q, k, v)
    b, l, c = q.shape
    o = torch.empty_like(q)
    scratch = _split_scratch(q)
    lib = _lib()
    rc = lib.gdt_flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), _ptr(scratch), b, l, c,
        l_valid, scale, _DTYPES[q.dtype], _stream(q),
    )
    _build.check(lib, rc, "flash attention kernel launch")
    flash_attention_forward.launches += 1
    _count_split(scratch, split_precision_512 if c == 512 else split_precision)
    return o


def _flash_attention_fwd_cpu(q, k, v, l_valid, scale):
    return _flash_reference(q, k, v, l_valid, scale)


def _flash_attention_fwd_fake(q, k, v, l_valid, scale):
    return torch.empty_like(q)


def _attention_bwd_cuda(q, k, v, do, lse, di, l_valid, scale):
    """``gdt::attention_bwd`` on the card: (dq, dk, dv)."""
    _check_layout(q, k, v, do, lse, di)
    b, l, c = q.shape
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    scratch = _split_scratch(q, backward=True)
    lib = _bwd_lib()
    rc = lib.gdt_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        di.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), _ptr(scratch), b, l, c,
        l_valid, scale, _DTYPES[q.dtype], _stream(q),
    )
    _build.check(lib, rc, "attention backward kernel launch")
    attention_backward.launches += 1
    _count_split(scratch, split_backward_512 if c == 512 else split_backward)
    if scratch is None and c == 512:
        backward_512.launches += 1
    return dq, dk, dv


def _attention_bwd_cpu(q, k, v, do, lse, di, l_valid, scale):
    return _attention_backward_reference(q, k, v, do, lse, di, l_valid, scale)


def _attention_bwd_fake(q, k, v, do, lse, di, l_valid, scale):
    return tuple(torch.empty_like(q) for _ in range(3))


# ---------------------------------------------------------------------------
# the wrappers: every kernel runs through an operator of ``torch.ops.gdt``;
# on the card the inputs are padded to the kernels' grid first
# ---------------------------------------------------------------------------


def _plain_args(q):
    """The true length and scale that a CPU call hands its operator."""
    _, l, c = q.shape
    return l, c ** -0.5


def _attention_cuda(q, k, v):
    _check_inputs(q)
    return _on_grid(torch.ops.gdt.attention_fwd, (q, k, v))


def flash_attention_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Forward-only softmax(q k^T / sqrt(C)) v over (B, L, C) with every
    product to fp32 accuracy whatever the input dtype (the counterpart of
    the JAX package's ``_attention_pallas``). Not differentiable."""
    if q.dim() != 3 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"flash attention takes equal (B, L, C) q, k, v, got {q.shape}")
    if q.device.type == "cuda":
        _check_inputs(q)
        return _on_grid(torch.ops.gdt.flash_attention_fwd, (q, k, v))
    return torch.ops.gdt.flash_attention_fwd(q, k, v, *_plain_args(q))


flash_attention_forward.launches = 0


def _attention_backward_cuda(q, k, v, do, lse, di):
    _check_inputs(q)
    b, l, _ = q.shape
    for name, t in (("lse", lse), ("di", di)):
        if t.shape != (b, l) or t.dtype != torch.float32:
            raise ValueError(f"attention backward: {name} must be float32 ({b}, {l})")
    return _on_grid(torch.ops.gdt.attention_bwd, (q, k, v, do), (lse, di))


def _attention_forward(q, k, v):
    if q.device.type == "cuda":
        return _attention_cuda(q, k, v)
    return torch.ops.gdt.attention_fwd(q, k, v, *_plain_args(q))


def attention_backward(q, k, v, o, lse, do):
    """(dq, dk, dv) of ``single_head_attention`` from its forward's (o, lse)
    and the output gradient ``do``."""
    if do.dtype != q.dtype or do.shape != q.shape:
        raise ValueError("attention backward: do must match q in shape and dtype")
    di = (do.float() * o.float()).sum(dim=-1)
    if q.device.type != "cuda":
        return torch.ops.gdt.attention_bwd(q, k, v, do, lse, di, *_plain_args(q))
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
single_head_attention.pad_copies = 0  # kernel calls whose inputs were padded to the grid
