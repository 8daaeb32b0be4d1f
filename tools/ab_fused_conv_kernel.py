#!/usr/bin/env python3
"""Compare the fused GroupNorm+SiLU+conv kernel (B6) of checkouts of the
PyTorch port on one card, each tree in its own process, in the order given.

    python3 tools/ab_fused_conv_kernel.py [--fp32] PARENT_TREE CHANGE_TREE CHANGE_TREE PARENT_TREE

A tree is a directory holding a checkout (e.g. from ``git archive``); its
``generative_detection_tpu_torch`` is imported and builds its own kernels.
At every site where the flagship detector with GDT_FUSE_INFERENCE=1 takes
the kernel (batch 32, (h = w, C -> CO), 24 sites a request), each run times
``conv3x3_forward`` in direct mode from the GroupNorm affine (mean of 20
launches after a warm-up, CUDA events), splits the device time by kernel
(``torch.profiler``), checks the result against the plain version (max
|err| / RMS(plain)) and a repeat for equal bits, and times beside it the
stats kernel that makes the affine, and B3 (GroupNorm+SiLU) followed by
cuDNN's conv on the same inputs (a yardstick the port never calls; TF32
off). The card's bound is the direct conv's 2 * 9 * B * H * W * C * CO flops
at 989 TFLOP/s, or the bytes moved once at 3.35 TB/s, whichever is longer.
bf16 by default; ``--fp32`` times the fp32 route on fp32 inputs at the same
sites (the profiler's split shows the weight pre-pass beside the kernel), its
bound counting the split-precision route's six bf16 piece products, with the
bound on the CUDA cores' 67 TFLOP/s beside it. One JSON line per tree, with
every site and the sums over a request's sites (each site's time times its
count, where the JAX package's routing rule ``fused_eligible`` sends the
site to the kernel in the run's dtype: in fp32 the 16x16x512->512 sites
exceed the TPU kernel's VMEM budget and take the plain composite); the
card's name and power limit come last.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

# (h = w, C, CO) and count of the fused detector's B6 sites per request
SITES = ((256, 128, 128, 4), (128, 128, 128, 4), (64, 128, 256, 1), (64, 256, 256, 3),
         (32, 256, 256, 4), (16, 256, 512, 1), (16, 512, 512, 7))
BATCH = 32
PEAK_FLOPS, HBM_BYTES_PER_S = 989e12, 3.35e12
FP32_CORES_FLOPS, SPLIT_PRODUCTS = 67e12, 6
# the B6 kernels (bf16; fp32 on split precision and its weight pre-pass),
# and the mma.sync and FMA kernels of earlier checkouts
KERNELS = (r"(fused_conv_wgmma_kernel|fused_conv_split_wgmma_kernel|split_weights_kernel"
           r"|conv3x3_bf16_kernel|conv3x3_f32_kernel)")

_spec = importlib.util.spec_from_file_location(
    "ab_wino_rows", Path(__file__).resolve().with_name("ab_wino_rows_kernel.py"))
ab_wino_rows = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(ab_wino_rows)
_time_ms = ab_wino_rows._time_ms


def _site(g, hw, c, co, dt) -> dict:
    import torch
    import torch.nn.functional as F

    from generative_detection_tpu_torch.ops import conv3x3, fused_conv, norm

    x = (torch.randn(BATCH, hw, hw, c, device="cuda", generator=g) * 2 + 0.5).to(dt)
    gamma = 1 + 0.1 * torch.randn(c, device="cuda", generator=g)
    beta = 0.1 * torch.randn(c, device="cuda", generator=g)
    k = torch.randn(3, 3, c, co, device="cuda", generator=g) / (9 * c) ** 0.5
    bias = 0.1 * torch.randn(co, device="cuda", generator=g)
    a, b, _ = norm.group_norm_affine(x, gamma, beta)
    w9 = k.to(dt).reshape(9, c, co).contiguous()
    w_lib, b_lib = k.to(dt).permute(3, 2, 0, 1).contiguous(), bias.to(dt)

    def kernel():
        return conv3x3.conv3x3_forward(x, w9, bias, 1, gn_ab=(a, b))

    def library():
        y = norm.group_norm(x, gamma, beta, 32, 1e-6, "silu")
        return F.conv2d(y.permute(0, 3, 1, 2), w_lib, b_lib, padding=1)

    got, again = kernel(), kernel()
    want = fused_conv._conv_bias(fused_conv._silu_affine(x, a, b), k, bias)
    err = ((got.float() - want.float()).abs().max() / want.float().pow(2).mean().sqrt()).item()
    esz = x.element_size()
    nbytes = BATCH * hw * hw * (c + co) * esz + w9.numel() * esz + (2 * BATCH * c + co) * 4
    flops, t_bytes = 2 * 9 * BATCH * hw * hw * c * co, nbytes / HBM_BYTES_PER_S
    fp32 = dt == torch.float32
    bound = max((SPLIT_PRODUCTS if fp32 else 1) * flops / PEAK_FLOPS, t_bytes) * 1e3
    ms = _time_ms(kernel)
    site = {"shape": [BATCH, hw, hw, c, co], "ms": ms, "bound_ms": bound,
            "bound_share": bound / ms, "max_err_rel_rms": err,
            "repeat_equal": bool(torch.equal(got, again)),
            "kernel_ms": ab_wino_rows._kernel_split(kernel, pattern=KERNELS),
            "affine_ms": _time_ms(lambda: norm.group_norm_affine(x, gamma, beta)),
            "b3_cudnn_ms": _time_ms(library)}
    if fp32:
        site["cuda_cores_bound_ms"] = max(flops / FP32_CORES_FLOPS, t_bytes) * 1e3
    return site


def run_one(tree: str, fp32: bool) -> dict:
    tree = os.path.abspath(tree)
    os.chdir(tree)
    sys.path.insert(0, tree)
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(0)
    dt = torch.float32 if fp32 else torch.bfloat16
    sites = []
    from generative_detection_tpu_torch.ops import fused_conv

    for hw, c, co, n in SITES:
        site = _site(g, hw, c, co, dt)
        routed = fused_conv.fused_eligible((BATCH, hw, hw, c), co, dt)
        site["sites_per_request"] = n if routed else 0
        sites.append(site)
        torch.cuda.empty_cache()
    return {
        "tree": tree, "dtype": str(dt).split(".")[1], "sites": sites,
        "request_ms": sum(s["ms"] * s["sites_per_request"] for s in sites),
        "request_affine_ms": sum(s["affine_ms"] * s["sites_per_request"] for s in sites),
        "request_b3_cudnn_ms": sum(s["b3_cudnn_ms"] * s["sites_per_request"] for s in sites),
        "request_bound_ms": sum(s["bound_ms"] * s["sites_per_request"] for s in sites),
    }


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
