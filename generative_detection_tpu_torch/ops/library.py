"""The port's CUDA kernels as PyTorch operators: the ``gdt`` namespace.

Every ctypes launch of the port runs inside the CUDA implementation of one of
these operators, so a graph that ``torch.export`` traces holds each kernel as
one ``torch.ops.gdt.*`` node, and a loaded artifact launches (and counts) the
kernels as the live modules do. Each operator has four parts:

- a schema;
- a CUDA implementation: the hand-written kernel launched on the current
  stream. It checks pointers and alignment, allocates its scratch, picks its
  route from the concrete shape (the GroupNorm forward's resident or two-pass
  kernels, the split-precision attention's pieces) and counts its launches;
- a CPU implementation: the kernel's plain PyTorch version;
- a fake implementation: the outputs' shapes and dtypes from the inputs'
  alone, with no choice that depends on the batch, so one traced graph serves
  any batch.

The dispatcher picks the implementation by the inputs' device: a CPU tensor
takes the plain version, a CUDA tensor the kernel, which raises where it
cannot run. There is no probe and no fallback.

The operators are registered with ``torch.library.Library`` (``define`` and
one ``impl`` per dispatch key), which costs less host time per call than
``@torch.library.custom_op`` (``tools/op_dispatch_cost.py`` measures both;
``PERF.md`` §6 has the H100's numbers).
Importing ``generative_detection_tpu_torch.ops`` registers them; loading an
exported graph needs the package imported, and the kernels are built at
their first launch (``ops/_build.py``).

Training operators (``*_train``) also return the stats their backward folds:
the kernels' (B, tiles, 2, G) partials on the card, whose tiling depends on
the batch, and (mean, rstd) stacked as (2, B, G) on the CPU. The serving
path calls the stat-less ones.
"""

from __future__ import annotations

import torch

from . import attention, fused_conv, norm
from . import winograd_rows as wr

NAMESPACE = "gdt"

# name: (schema, CPU implementation, CUDA implementation, fake implementation)
OPS = {
    "group_norm": (
        "(Tensor x, Tensor gamma, Tensor beta, int num_groups, float eps, str? act) -> Tensor",
        norm._group_norm_cpu, norm._group_norm_cuda, norm._group_norm_fake),
    "group_norm_train": (
        "(Tensor x, Tensor gamma, Tensor beta, int num_groups, float eps, str? act)"
        " -> (Tensor, Tensor)",
        norm._group_norm_train_cpu, norm._group_norm_train_cuda, norm._group_norm_train_fake),
    "group_norm_affine": (
        "(Tensor x, Tensor gamma, Tensor beta, int num_groups, float eps) -> (Tensor, Tensor)",
        norm._group_norm_affine_cpu, norm._group_norm_affine_cuda, norm._group_norm_affine_fake),
    "group_norm_affine_train": (
        "(Tensor x, Tensor gamma, Tensor beta, int num_groups, float eps)"
        " -> (Tensor, Tensor, Tensor)",
        norm._group_norm_affine_train_cpu, norm._group_norm_affine_train_cuda,
        norm._group_norm_affine_train_fake),
    "group_norm_bwd": (
        "(Tensor x, Tensor dy, Tensor stats, Tensor gamma, Tensor beta, int num_groups,"
        " float eps, str? act) -> (Tensor, Tensor)",
        norm._group_norm_bwd_cpu, norm._group_norm_bwd_cuda, norm._group_norm_bwd_fake),
    "attention_fwd": (
        "(Tensor q, Tensor k, Tensor v, int l_valid, float scale) -> (Tensor, Tensor)",
        attention._attention_fwd_cpu, attention._attention_fwd_cuda,
        attention._attention_fwd_fake),
    "flash_attention_fwd": (
        "(Tensor q, Tensor k, Tensor v, int l_valid, float scale) -> Tensor",
        attention._flash_attention_fwd_cpu, attention._flash_attention_fwd_cuda,
        attention._flash_attention_fwd_fake),
    "attention_bwd": (
        "(Tensor q, Tensor k, Tensor v, Tensor do, Tensor lse, Tensor di, int l_valid,"
        " float scale) -> (Tensor, Tensor, Tensor)",
        attention._attention_bwd_cpu, attention._attention_bwd_cuda,
        attention._attention_bwd_fake),
    "fused_conv": (
        "(Tensor x, Tensor w, Tensor bias, Tensor ga, Tensor gb) -> Tensor",
        fused_conv._fused_conv_cpu, fused_conv._fused_conv_cuda, fused_conv._fused_conv_fake),
    "fused_conv_z": (
        "(Tensor x, Tensor w, Tensor bias, Tensor ga, Tensor gb) -> (Tensor, Tensor)",
        fused_conv._fused_conv_z_cpu, fused_conv._fused_conv_z_cuda,
        fused_conv._fused_conv_z_fake),
    "wino_rows": (
        "(Tensor x, Tensor u, Tensor bias, Tensor? ga, Tensor? gb, int m) -> Tensor",
        wr._wino_rows_cpu, wr._wino_rows_cuda, wr._wino_rows_fake),
    "wino_rows_dgrad": (
        "(Tensor dy, Tensor u, int m) -> Tensor",
        wr._wino_rows_dgrad_cpu, wr._wino_rows_dgrad_cuda, wr._wino_rows_dgrad_fake),
    "wino_wgrad": (
        "(Tensor z, Tensor dy, Tensor? ga, Tensor? gb, int m) -> Tensor",
        wr._wino_wgrad_cpu, wr._wino_wgrad_cuda, wr._wino_wgrad_fake),
}

# The ctypes entry points each operator's CUDA implementation launches.
ENTRY_POINTS = {
    "group_norm": ("gdt_group_norm_resident", "gdt_group_norm_fwd"),
    "group_norm_train": ("gdt_group_norm_resident", "gdt_group_norm_fwd"),
    "group_norm_affine": ("gdt_group_norm_affine",),
    "group_norm_affine_train": ("gdt_group_norm_affine",),
    "group_norm_bwd": ("gdt_group_norm_bwd",),
    "attention_fwd": ("gdt_attention_fwd",),
    "flash_attention_fwd": ("gdt_flash_attention_fwd",),
    "attention_bwd": ("gdt_attention_bwd",),
    "fused_conv": ("gdt_conv3x3_wino",),
    "fused_conv_z": ("gdt_conv3x3_wino",),
    "wino_rows": ("gdt_conv3x3_wino",),
    "wino_rows_dgrad": ("gdt_conv3x3_wino",),
    "wino_wgrad": ("gdt_conv3x3_wgrad",),
}

LIB = torch.library.Library(NAMESPACE, "DEF")
for _name, (_schema, _cpu, _cuda, _fake) in OPS.items():
    LIB.define(_name + _schema)
    LIB.impl(_name, _cpu, "CPU")
    LIB.impl(_name, _cuda, "CUDA")
    torch.library.register_fake(f"{NAMESPACE}::{_name}", _fake, lib=LIB)

CUDA_IMPLS = {name: spec[2] for name, spec in OPS.items()}
