#!/usr/bin/env python3
"""Time the bf16 row-Winograd forward kernel (B7) of checkouts of the PyTorch
port over the input-channel count, on one card, each tree in its own
process, in the order given.

    python3 tools/scan_wino_rows_kernel.py TREE [TREE ...]

At 16 x 128 x 128 x C -> 128, F(4,3), for C in 16, 64, 128, 256 (1 to 16
chunks of 16 channels), without and with the GroupNorm prologue: the mean
of 20 launches after a warm-up (CUDA events). A straight line through the
times splits a block's fixed cost (its prologue and epilogue) from the cost
of one chunk, which is how variants of the kernel were compared. One JSON
line per tree; the card's name and power limit come last.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

CHANNELS = (16, 64, 128, 256)
BATCH, HW, CO, M = 16, 128, 128, 4


def run_one(tree: str) -> dict:
    tree = os.path.abspath(tree)
    os.chdir(tree)
    sys.path.insert(0, tree)
    import torch

    from generative_detection_tpu_torch.ops import conv3x3
    from generative_detection_tpu_torch.ops import winograd_rows as wr

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device")

    def time_ms(fn, iters=20):
        fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters

    g = torch.Generator(device="cuda").manual_seed(0)
    out = {}
    for c in CHANNELS:
        x = (torch.randn(BATCH, HW, HW, c, device="cuda", generator=g) * 2 + 0.5).bfloat16()
        k = torch.randn(3, 3, c, CO, device="cuda", generator=g) / (9 * c) ** 0.5
        u = wr._u3n(k, torch.bfloat16, M)
        bias = torch.zeros(CO, device="cuda")
        ab = (torch.ones(BATCH, c, device="cuda"), torch.zeros(BATCH, c, device="cuda"))
        out[c] = {"ms": time_ms(lambda: conv3x3.conv3x3_forward(x, u, bias, M)),
                  "ms_gn": time_ms(lambda: conv3x3.conv3x3_forward(x, u, bias, M, gn_ab=ab))}
    return {"tree": tree, "shape": [BATCH, HW, HW, "C", CO], "by_channels": out}


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
