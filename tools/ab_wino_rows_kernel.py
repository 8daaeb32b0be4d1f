#!/usr/bin/env python3
"""Compare the row-Winograd forward kernel (B7, the forward with the
GroupNorm prologue and the dgrad) of checkouts of the PyTorch port on one
card, each tree in its own process, in the order given.

    python3 tools/ab_wino_rows_kernel.py [--fp32] PARENT_TREE CHANGE_TREE CHANGE_TREE PARENT_TREE

A tree is a directory holding a checkout (e.g. from ``git archive``); its
``generative_detection_tpu_torch`` is imported and builds its own kernels.
At every site where the flagship train step with GDT_WINOGRAD=fused takes
the kernel (batch 16, F(4,3)): the forward with the GroupNorm prologue at
(h = w, C -> CO), and the dgrad at the same site with C and CO swapped.
Each run times ``conv3x3_forward`` (mean of 20 launches after a warm-up,
CUDA events), splits the device time by kernel (``torch.profiler``),
checks the result against the plain version (max |err| / RMS(plain)) and a
repeat for equal bits, times cuDNN's forward or dgrad of the direct conv on
the same inputs (a yardstick the port never calls), and gives the card's
bound (the products the Winograd form does, ``winograd_flops``, at 989
TFLOP/s, or the bytes moved once at 3.35 TB/s) and the share of it reached.
bf16 by default; ``--fp32`` times the fp32 route on fp32 inputs with cuDNN's
TF32 off: its bound counts the split route's six bf16 piece products a
product at 989 TFLOP/s, with the CUDA cores' bound (67 TFLOP/s) beside it,
the profiler's split gives the weights' pre-pass (``split_weights_kernel``)
apart from the kernel, and ``err_vs_fp32_direct_rel`` is the error against
cuDNN's fp32 direct conv (or dgrad) on the same inputs. One JSON line per
tree, with every site and the sums over a fused step's sites (each site's
time times its count, ``step_ms``); the card's name and power limit come
last.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re
import subprocess
import sys
from pathlib import Path

# (h = w, C, CO) and count of the fused step's Winograd forward sites; each
# also takes the dgrad kernel (C and CO swapped)
SITES = ((128, 256, 128, 1), (128, 128, 128, 9), (64, 256, 256, 9), (64, 128, 256, 1),
         (32, 256, 256, 9), (32, 512, 256, 1))
BATCH, M = 16, 4
PEAK_FLOPS, HBM_BYTES_PER_S = 989e12, 3.35e12
FP32_CORES_FLOPS = 67e12  # fp32 outside the tensor cores
SPLIT_PRODUCTS = 6  # bf16 piece products of an fp32 product on split precision

_spec = importlib.util.spec_from_file_location(
    "ab_wgrad", Path(__file__).resolve().with_name("ab_wgrad_kernel.py"))
ab_wgrad = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(ab_wgrad)
_time_ms, winograd_flops = ab_wgrad._time_ms, ab_wgrad.winograd_flops


def _kernel_split(fn, calls: int = 3,
                  pattern: str = r"(wino_rows_(split_)?wgmma_kernel|conv3x3_bf16_kernel"
                                 r"|conv3x3_f32_kernel|split_weights_kernel)") -> dict:
    """Device ms per call of each conv kernel (named by ``pattern``) that ``fn`` launches."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    split = {}
    for e in prof.key_averages():
        name = re.search(pattern, e.key)
        if name:
            split[name.group(0)] = split.get(name.group(0), 0.0) + e.device_time_total / calls / 1e3
    return split


def _site(g, hw, c, co, dgrad: bool, dt) -> dict:
    """The fused site (h = w, C -> CO) in ``dt``: the forward with the
    prologue, or (``dgrad``) the same kernel on dy (CO channels) with the
    rotated, io-swapped kernel, giving dz (C channels)."""
    import torch
    import torch.nn.functional as F

    from generative_detection_tpu_torch.ops import conv3x3, norm
    from generative_detection_tpu_torch.ops import winograd_rows as wr

    fp32 = dt == torch.float32
    c_in, c_out = (co, c) if dgrad else (c, co)
    x = (torch.randn(BATCH, hw, hw, c_in, device="cuda", generator=g) * 2 + 0.5).to(dt)
    k = torch.randn(3, 3, c, co, device="cuda", generator=g) / (9 * c) ** 0.5  # the forward's
    w_lib = k.to(dt).permute(3, 2, 0, 1).contiguous()
    if dgrad:
        u = wr._u3n(k.flip(0, 1).transpose(2, 3), dt, M)
        bias, ab = torch.zeros(c_out, device="cuda"), None
        dy = x.permute(0, 3, 1, 2)
        z = torch.empty(BATCH, c, hw, hw, device="cuda", dtype=dt).to(
            memory_format=torch.channels_last)

        def library():
            return torch.ops.aten.convolution_backward(
                dy, z, w_lib, None, [1, 1], [1, 1], [1, 1], False, [0, 0], 1,
                [True, False, False])
    else:
        gamma = 1 + 0.1 * torch.randn(c, device="cuda", generator=g)
        beta = 0.1 * torch.randn(c, device="cuda", generator=g)
        bias = 0.1 * torch.randn(co, device="cuda", generator=g)
        a, b, _ = norm.group_norm_affine(x, gamma, beta)
        u, ab = wr._u3n(k, dt, M), (a, b)
        v = x.float() * a[:, None, None, :] + b[:, None, None, :]
        z = (v * torch.sigmoid(v)).to(dt).permute(0, 3, 1, 2)
        b_lib = bias.to(dt)

        def library():
            return F.conv2d(z, w_lib, b_lib, padding=1)

    def kernel():
        return conv3x3.conv3x3_forward(x, u, bias, M, gn_ab=ab)

    def rel(ref):
        ref = ref.float()
        return ((got.float() - ref).abs().max() / ref.pow(2).mean().sqrt()).item()

    got, again = kernel(), kernel()
    err = rel(wr._wino_rows_reference(x, u, bias, *(ab or (None, None)), M))
    esz = x.element_size()
    flops = winograd_flops(BATCH, hw, hw, c_in, c_out, M)
    nbytes = BATCH * hw * hw * (c_in + c_out) * esz + u.numel() * esz + (
        0 if dgrad else (2 * BATCH * c + co) * 4)
    t_bytes = nbytes / HBM_BYTES_PER_S
    bound = max((SPLIT_PRODUCTS if fp32 else 1) * flops / PEAK_FLOPS, t_bytes) * 1e3
    ms = _time_ms(kernel)
    site = {"shape": [BATCH, hw, hw, c_in, c_out], "dtype": str(dt).split(".")[1], "ms": ms,
            "bound_ms": bound, "bound_share": bound / ms, "max_err_rel_rms": err,
            "repeat_equal": bool(torch.equal(got, again)), "kernel_ms": _kernel_split(kernel),
            "cudnn_ms": _time_ms(library)}
    if fp32:
        site["cuda_cores_bound_ms"] = max(flops / FP32_CORES_FLOPS, t_bytes) * 1e3
        ref = library()  # cuDNN's fp32 direct conv or dgrad, TF32 off
        site["err_vs_fp32_direct_rel"] = rel((ref[0] if dgrad else ref).permute(0, 2, 3, 1))
    return site


def run_one(tree: str, fp32: bool = False) -> dict:
    tree = os.path.abspath(tree)
    os.chdir(tree)
    sys.path.insert(0, tree)
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    dt = torch.float32 if fp32 else torch.bfloat16
    g = torch.Generator(device="cuda").manual_seed(0)
    out = {"tree": tree, "dtype": str(dt).split(".")[1]}
    for name, dgrad in (("forward", False), ("dgrad", True)):
        sites = []
        for hw, c, co, n in SITES:
            site = _site(g, hw, c, co, dgrad, dt)
            site["sites_per_step"] = n
            sites.append(site)
            torch.cuda.empty_cache()
        out[name] = {
            "sites": sites,
            "step_ms": sum(s["ms"] * s["sites_per_step"] for s in sites),
            "cudnn_step_ms": sum(s["cudnn_ms"] * s["sites_per_step"] for s in sites),
            "bound_step_ms": sum(s["bound_ms"] * s["sites_per_step"] for s in sites),
        }
    return out


def main(argv) -> int:
    fp32 = "--fp32" in argv
    argv = [a for a in argv if a != "--fp32"]
    if len(argv) == 3 and argv[1] == "--one":
        print(json.dumps(run_one(argv[2], fp32)), flush=True)
        return 0
    if len(argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    for tree in argv[1:]:
        subprocess.run([sys.executable, os.path.abspath(__file__), "--one", tree]
                       + (["--fp32"] if fp32 else []), check=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
