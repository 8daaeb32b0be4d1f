#!/usr/bin/env python3
"""Compare the bf16 fused GroupNorm+SiLU+conv kernel (B6) of checkouts of the
PyTorch port on one card, each tree in its own process, in the order given.

    python3 tools/ab_fused_conv_kernel.py PARENT_TREE CHANGE_TREE CHANGE_TREE PARENT_TREE

A tree is a directory holding a checkout (e.g. from ``git archive``); its
``generative_detection_tpu_torch`` is imported and builds its own kernels.
At every site where the flagship detector with GDT_FUSE_INFERENCE=1 takes
the kernel (batch 32, (h = w, C -> CO), 24 sites a request), each run times
``conv3x3_forward`` in direct mode from the GroupNorm affine (mean of 20
launches after a warm-up, CUDA events), splits the device time by kernel
(``torch.profiler``), checks the result against the plain version (max
|err| / RMS(plain)) and a repeat for equal bits, and times beside it the
stats kernel that makes the affine, and B3 (GroupNorm+SiLU) followed by
cuDNN's conv on the same inputs (a yardstick the port never calls). The
card's bound is the direct conv's 2 * 9 * B * H * W * C * CO flops at 989
TFLOP/s, or the bytes moved once at 3.35 TB/s, whichever is longer. One
JSON line per tree, with every site and the sums over a request's sites
(each site's time times its count); the card's name and power limit come
last.
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
# the B6 kernel, and the mma.sync kernel of earlier checkouts
KERNELS = r"(fused_conv_wgmma_kernel|conv3x3_bf16_kernel)"

_spec = importlib.util.spec_from_file_location(
    "ab_wino_rows", Path(__file__).resolve().with_name("ab_wino_rows_kernel.py"))
ab_wino_rows = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(ab_wino_rows)
_time_ms = ab_wino_rows._time_ms


def _site(g, hw, c, co) -> dict:
    import torch
    import torch.nn.functional as F

    from generative_detection_tpu_torch.ops import conv3x3, fused_conv, norm

    dt = torch.bfloat16
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
    nbytes = BATCH * hw * hw * (c + co) * 2 + w9.numel() * 2 + (2 * BATCH * c + co) * 4
    bound = max(2 * 9 * BATCH * hw * hw * c * co / PEAK_FLOPS, nbytes / HBM_BYTES_PER_S) * 1e3
    ms = _time_ms(kernel)
    return {"shape": [BATCH, hw, hw, c, co], "ms": ms, "bound_ms": bound,
            "bound_share": bound / ms, "max_err_rel_rms": err,
            "repeat_equal": bool(torch.equal(got, again)),
            "kernel_ms": ab_wino_rows._kernel_split(kernel, pattern=KERNELS),
            "affine_ms": _time_ms(lambda: norm.group_norm_affine(x, gamma, beta)),
            "b3_cudnn_ms": _time_ms(library)}


def run_one(tree: str) -> dict:
    tree = os.path.abspath(tree)
    os.chdir(tree)
    sys.path.insert(0, tree)
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(0)
    sites = []
    for hw, c, co, n in SITES:
        site = _site(g, hw, c, co)
        site["sites_per_request"] = n
        sites.append(site)
        torch.cuda.empty_cache()
    return {
        "tree": tree, "sites": sites,
        "request_ms": sum(s["ms"] * s["sites_per_request"] for s in sites),
        "request_affine_ms": sum(s["affine_ms"] * s["sites_per_request"] for s in sites),
        "request_b3_cudnn_ms": sum(s["b3_cudnn_ms"] * s["sites_per_request"] for s in sites),
        "request_bound_ms": sum(s["bound_ms"] * s["sites_per_request"] for s in sites),
    }


def main(argv) -> int:
    if len(argv) == 3 and argv[1] == "--one":
        print(json.dumps(run_one(argv[2])), flush=True)
        return 0
    if len(argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    for tree in argv[1:]:
        subprocess.run([sys.executable, os.path.abspath(__file__), "--one", tree], check=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
