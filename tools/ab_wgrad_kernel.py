#!/usr/bin/env python3
"""Compare the bf16 row-Winograd weight-gradient kernel (B8,
``csrc/conv3x3_wgrad.cu``) of checkouts of the PyTorch port on one card,
each tree in its own process, in the order given.

    python3 tools/ab_wgrad_kernel.py PARENT_TREE CHANGE_TREE CHANGE_TREE PARENT_TREE

A tree is a directory holding a checkout (e.g. from ``git archive``); its
``generative_detection_tpu_torch`` is imported and builds its own kernels.
At every site where the flagship train step with GDT_WINOGRAD=fused takes
the kernel (batch 16, F(4,3), GroupNorm recompute), each run times
``conv3x3_wgrad`` (the kernel and its split-K fold; mean of 20 launches
after a warm-up, CUDA events), splits the device time by kernel
(``torch.profiler``), checks the result against the plain version (max
|err| / RMS(plain)) and a repeat for equal bits, times cuDNN's weight
gradient of the direct conv on the activation (a yardstick the port never
calls), and prints one JSON line per tree with the card's bound (the
products the kernel does, ``winograd_flops``, at 989 TFLOP/s, or the bytes
of z, dy and dU at 3.35 TB/s). For a tree with the wgmma kernel each site
also gives the bytes its design moves (``wgrad_traffic``: a model of the
tiling, not a counter read on the card). The card's name and power limit
come last.
"""

from __future__ import annotations

import json
import math
import os
import re
import subprocess
import sys

# (h = w, C, CO) and count of the fused step's weight-gradient kernel sites
SITES = ((128, 256, 128, 1), (128, 128, 128, 9), (64, 256, 256, 9), (64, 128, 256, 1),
         (32, 256, 256, 9))
BATCH, M = 16, 4
PEAK_FLOPS, HBM_BYTES_PER_S = 989e12, 3.35e12


def winograd_flops(b: int, h: int, w: int, c: int, co: int, m: int) -> int:
    """Products of the row-Winograd F(m, 3) forms (forward, dgrad and weight
    gradient alike): m + 2 points of 3 taps for every m rows, against the
    direct conv's 9 taps a row; half of 2 * 9 * B * H * W * C * CO at m = 4."""
    return 2 * (m + 2) * 3 * b * (h // m) * w * c * co


def wgrad_traffic(b: int, h: int, w: int, c: int, co: int, m: int) -> dict:
    """Bytes the bf16 weight-gradient kernel moves, by its design: raw z rows
    read from L2 (m + 2) / m times per (point, TN_BF16-channel co tile), dy
    rows (with a 2-column halo) once per (point, TC-channel c tile); and at
    least from HBM: z and dy once, the split-K partials written and read
    back once, and dU written."""
    import torch

    from generative_detection_tpu_torch.ops import conv3x3

    pts, chunks = m + 2, math.ceil(w / conv3x3.KP)
    z = b * h * chunks * conv3x3.KP * c * 2 * (m + 2) / m * pts * (co // conv3x3.TN_BF16)
    dy = b * h * chunks * (conv3x3.KP + 2) * co * 2 * pts * (c // conv3x3.TC)
    splits = conv3x3._wgrad_splits(b, h, w, c, co, m, torch.bfloat16)
    part = splits * pts * 3 * c * co * 4
    hbm = b * h * w * (c + co) * 2 + 2 * part + pts * 3 * c * co * 4
    return {"l2_read_bytes": z + dy, "hbm_once_bytes": hbm}


def _time_ms(fn, iters: int = 20) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _kernel_split(fn, calls: int = 3) -> dict:
    """Device ms per call of each kernel that ``fn`` launches."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    split = {}
    for e in prof.key_averages():
        name = re.search(r"(wgrad_\w+_kernel|fold_kernel)", e.key)
        if name:
            split[name.group(0)] = split.get(name.group(0), 0.0) + e.device_time_total / calls / 1e3
    return split


def run_one(tree: str) -> dict:
    tree = os.path.abspath(tree)
    os.chdir(tree)
    sys.path.insert(0, tree)
    import torch

    from generative_detection_tpu_torch.ops import conv3x3, norm
    from generative_detection_tpu_torch.ops import winograd_rows as wr

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(0)
    out = {"tree": tree, "sites": []}
    for hw, c, co, n in SITES:
        x = (torch.randn(BATCH, hw, hw, c, device="cuda", generator=g) * 2 + 0.5).bfloat16()
        dy = torch.randn(BATCH, hw, hw, co, device="cuda", generator=g).bfloat16()
        gamma = 1 + 0.1 * torch.randn(c, device="cuda", generator=g)
        beta = 0.1 * torch.randn(c, device="cuda", generator=g)
        a, b, _ = norm.group_norm_affine(x, gamma, beta)
        got = conv3x3.conv3x3_wgrad(x, dy, M, (a, b))
        again = conv3x3.conv3x3_wgrad(x, dy, M, (a, b))
        want = wr._wino_wgrad_reference(x, dy, a, b, M)
        err = ((got - want).abs().max() / want.pow(2).mean().sqrt()).item()
        ms = _time_ms(lambda: conv3x3.conv3x3_wgrad(x, dy, M, (a, b)))
        v = x.float() * a[:, None, None, :] + b[:, None, None, :]
        z = (v * torch.sigmoid(v)).bfloat16().permute(0, 3, 1, 2)
        dy_nchw = dy.permute(0, 3, 1, 2)
        wt = torch.empty(co, c, 3, 3, device="cuda", dtype=torch.bfloat16)

        def cudnn():
            return torch.ops.aten.convolution_backward(
                dy_nchw, z, wt, None, [1, 1], [1, 1], [1, 1], False, [0, 0], 1,
                [False, True, False])

        flops = winograd_flops(BATCH, hw, hw, c, co, M)
        nbytes = (x.numel() + dy.numel()) * 2 + (M + 2) * 3 * c * co * 4 + 2 * BATCH * c * 4
        bound = max(flops / PEAK_FLOPS, nbytes / HBM_BYTES_PER_S) * 1e3
        site = {"shape": [BATCH, hw, hw, c, co], "sites_per_step": n, "ms": ms,
                "bound_ms": bound, "bound_share": bound / ms,
                "max_err_rel_rms": err, "repeat_equal": bool(torch.equal(got, again)),
                "kernel_ms": _kernel_split(lambda: conv3x3.conv3x3_wgrad(x, dy, M, (a, b))),
                "cudnn_ms": _time_ms(cudnn)}
        if hasattr(conv3x3, "TN_BF16"):  # the wgmma kernel's design
            site.update(wgrad_traffic(BATCH, hw, hw, c, co, M))
        out["sites"].append(site)
        del x, dy, z, got, again, want, v
        torch.cuda.empty_cache()
    out["step_ms"] = sum(s["ms"] * s["sites_per_step"] for s in out["sites"])
    return out


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
