#!/usr/bin/env python3
"""Compare the row-Winograd weight-gradient kernel (B8,
``csrc/conv3x3_wgrad.cu``) of checkouts of the PyTorch port on one card,
each tree in its own process, in the order given.

    python3 tools/ab_wgrad_kernel.py [--fp32] PARENT_TREE CHANGE_TREE CHANGE_TREE PARENT_TREE

A tree is a directory holding a checkout (e.g. from ``git archive``); its
``generative_detection_tpu_torch`` is imported and builds its own kernels.
At every site where the flagship train step with GDT_WINOGRAD=fused takes
the kernel (batch 16, F(4,3), GroupNorm recompute), each run times
``conv3x3_wgrad`` (the kernel and its split-K fold; mean of 20 launches
after a warm-up, CUDA events), splits the device time by kernel
(``torch.profiler``: the kernel and the fold), checks the result against the
plain version (max |err| / RMS(plain)) and a repeat for equal bits, times
cuDNN's weight gradient of the direct conv on the activation (a yardstick the
port never calls; TF32 off), and prints one JSON line per tree with the
card's bound (the products the kernel does, ``winograd_flops``, at 989
TFLOP/s, or the bytes of z, dy and dU at 3.35 TB/s) and the bytes its design
moves (``wgrad_traffic``: a model of the tiling, not a counter read on the
card). bf16 by default; ``--fp32`` times the fp32 route on fp32 inputs at the
same sites, its bound counting the split-precision route's six bf16 piece
products, with the bound on the CUDA cores' 67 TFLOP/s beside it. The card's
name and power limit come last.
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
FP32_CORES_FLOPS = 67e12  # fp32 outside the tensor cores
SPLIT_PRODUCTS = 6  # bf16 piece products of an fp32 product on split precision
# The kernels' tiling: 64 input x 128 output channels a block; positions a
# chunk (bf16 32, fp32 16)
TC, TN, CHUNK = 64, 128, {"bfloat16": 32, "float32": 16}


def winograd_flops(b: int, h: int, w: int, c: int, co: int, m: int) -> int:
    """Products of the row-Winograd F(m, 3) forms (forward, dgrad and weight
    gradient alike): m + 2 points of 3 taps for every m rows, against the
    direct conv's 9 taps a row; half of 2 * 9 * B * H * W * C * CO at m = 4."""
    return 2 * (m + 2) * 3 * b * (h // m) * w * c * co


def wgrad_traffic(b: int, h: int, w: int, c: int, co: int, m: int, dtype: str = "bfloat16",
                  splits: int = 1) -> dict:
    """Bytes the wgmma weight-gradient kernels move, by their design: raw z
    rows read from L2 (m + 2) / m times per (point, 128-channel co tile), dy
    rows (with a 2-column halo a chunk) once per (point, 64-channel c tile);
    and at least from HBM: z and dy once, the ``splits`` split-K partials
    written and read back once, and dU written."""
    esz = 4 if dtype == "float32" else 2
    pts, kc = m + 2, CHUNK[dtype]
    chunks = math.ceil(w / kc)
    z = b * h * chunks * kc * c * esz * (m + 2) / m * pts * math.ceil(co / TN)
    dy = b * h * chunks * (kc + 2) * co * esz * pts * (c // TC)
    part = splits * pts * 3 * c * co * 4
    hbm = b * h * w * (c + co) * esz + 2 * part + pts * 3 * c * co * 4
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


def run_one(tree: str, fp32: bool) -> dict:
    tree = os.path.abspath(tree)
    os.chdir(tree)
    sys.path.insert(0, tree)
    import torch

    from generative_detection_tpu_torch.ops import conv3x3, norm
    from generative_detection_tpu_torch.ops import winograd_rows as wr

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    dt = torch.float32 if fp32 else torch.bfloat16
    name = str(dt).split(".")[1]
    g = torch.Generator(device="cuda").manual_seed(0)
    out = {"tree": tree, "dtype": name, "sites": []}
    for hw, c, co, n in SITES:
        x = (torch.randn(BATCH, hw, hw, c, device="cuda", generator=g) * 2 + 0.5).to(dt)
        dy = torch.randn(BATCH, hw, hw, co, device="cuda", generator=g).to(dt)
        gamma = 1 + 0.1 * torch.randn(c, device="cuda", generator=g)
        beta = 0.1 * torch.randn(c, device="cuda", generator=g)
        a, b, _ = norm.group_norm_affine(x, gamma, beta)
        got = conv3x3.conv3x3_wgrad(x, dy, M, (a, b))
        again = conv3x3.conv3x3_wgrad(x, dy, M, (a, b))
        want = wr._wino_wgrad_reference(x, dy, a, b, M)
        err = ((got - want).abs().max() / want.pow(2).mean().sqrt()).item()
        ms = _time_ms(lambda: conv3x3.conv3x3_wgrad(x, dy, M, (a, b)))
        v = x.float() * a[:, None, None, :] + b[:, None, None, :]
        z = (v * torch.sigmoid(v)).to(dt).permute(0, 3, 1, 2)
        dy_nchw = dy.permute(0, 3, 1, 2)
        wt = torch.empty(co, c, 3, 3, device="cuda", dtype=dt)

        def cudnn():
            return torch.ops.aten.convolution_backward(
                dy_nchw, z, wt, None, [1, 1], [1, 1], [1, 1], False, [0, 0], 1,
                [False, True, False])

        flops = winograd_flops(BATCH, hw, hw, c, co, M)
        esz = x.element_size()
        nbytes = (x.numel() + dy.numel()) * esz + (M + 2) * 3 * c * co * 4 + 2 * BATCH * c * 4
        t_bytes = nbytes / HBM_BYTES_PER_S
        bound = max((SPLIT_PRODUCTS if fp32 else 1) * flops / PEAK_FLOPS, t_bytes) * 1e3
        splits = conv3x3._wgrad_splits(BATCH, hw, hw, c, co, M, dt)
        site = {"shape": [BATCH, hw, hw, c, co], "sites_per_step": n, "ms": ms,
                "bound_ms": bound, "bound_share": bound / ms, "splits": splits,
                "max_err_rel_rms": err, "repeat_equal": bool(torch.equal(got, again)),
                "kernel_ms": _kernel_split(lambda: conv3x3.conv3x3_wgrad(x, dy, M, (a, b))),
                "cudnn_ms": _time_ms(cudnn),
                **wgrad_traffic(BATCH, hw, hw, c, co, M, name, splits)}
        if fp32:
            site["cuda_cores_bound_ms"] = max(flops / FP32_CORES_FLOPS, t_bytes) * 1e3
        out["sites"].append(site)
        del x, dy, z, got, again, want, v
        torch.cuda.empty_cache()
    out["step_ms"] = sum(s["ms"] * s["sites_per_step"] for s in out["sites"])
    out["step_cudnn_ms"] = sum(s["cudnn_ms"] * s["sites_per_step"] for s in out["sites"])
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
