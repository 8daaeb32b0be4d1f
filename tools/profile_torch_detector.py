#!/usr/bin/env python3
"""Where the PyTorch port's detector and train step spend device time, on one
CUDA card.

    python3 tools/profile_torch_detector.py [--batch 1 8 32] [--requests 5] [--fp32]
    python3 tools/profile_torch_detector.py --train [--steps 5] [--fp32] [--train-batch 16]

Builds the flagship config (configs/autoencoder/pose/autoencoder_kl_16x16x16.yaml)
at full width with seeded random weights. By default it serves bf16 requests
(the serving default) and prints one JSON line per batch size; with
``--train`` it runs the flagship train step as chip_smoke.py does (batch 16,
bf16 compute, fp32 master weights, past the curriculum) and prints one line.
With ``--fp32`` both run in fp32, as the config ships them (TF32 off for
products and convolutions, as chip_smoke.py runs its fp32 phases).
Each line gives the wall time per request or step inside the profiled
window, the device time per request or step, the device's busy share of the
window, and the device time split into classes of kernels (the port's
GroupNorm and attention kernels, forward and backward, cuDNN and cuBLAS
convolutions and products, the optimizer, everything else). The profiler
adds host overhead, so the busy share here is a lower bound; chip_smoke.py
gives the unprofiled latencies. The switches of the opt-in conv paths are
read from the environment as the package reads them:

    GDT_FUSE_INFERENCE=1 python3 tools/profile_torch_detector.py
    GDT_WINOGRAD=fused python3 tools/profile_torch_detector.py --train
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from collections import defaultdict
from pathlib import Path

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from chip_smoke import (  # noqa: E402
    TRAIN_BATCH,
    detector_inputs,
    flagship_detector,
    flagship_train,
    train_batch,
)
from generative_detection_tpu_torch.serving import make_detector_fn  # noqa: E402

# Kernel classes by substrings of the (demangled, lower-cased) kernel name,
# first match wins: the port's kernels before the library classes, whose
# keys ("wgrad", "conv") would also match them.
CLASSES = (
    # B7, forward and dgrad: bf16, and fp32 on split precision
    ("wino_rows_kernel", ("wino_rows_wgmma_kernel", "wino_rows_split_wgmma_kernel")),
    # B6 bf16; conv3x3_bf16 is its earlier mma.sync kernel, for profiling an
    # older checkout with this tool; in fp32 the split-precision kernel
    ("fused_conv_kernel", ("fused_conv_wgmma_kernel", "conv3x3_bf16",
                           "fused_conv_split_wgmma_kernel")),
    # the weights' pieces before fp32 B6 and B7
    ("split_weights_kernel", ("split_weights_kernel",)),
    # the FMA fp32 kernels before the split-precision ones, for profiling an
    # older checkout: B7 (and B6) in fp32
    ("conv3x3_kernel", ("conv3x3_f32",)),
    ("conv3x3_wgrad_kernel", ("wgrad_wgmma_kernel", "wgrad_split_wgmma_kernel", "wgrad_f32_kernel",
                              "::fold_kernel")),  # B8
    ("group_norm_kernel", ("gn_fwd_resident", "gn_stats", "gn_apply", "gn_affine")),
    ("group_norm_bwd_kernel", ("gn_bwd",)),
    ("attention_kernel", ("attn_fwd",)),
    ("attention_bwd_kernel", ("attn_bwd",)),
    ("conv_and_matmul", ("conv", "gemm", "xmma", "cudnn", "cutlass", "wgrad", "dgrad")),
    ("optimizer", ("adam",)),
)


def kernel_class(name: str) -> str:
    low = name.lower()
    for cls, keys in CLASSES:
        if any(k in low for k in keys):
            return cls
    return "other"


def profiled(fn, n: int) -> dict:
    """Run ``fn`` ``n`` times under the profiler: wall and device ms per run,
    busy share, device ms per run by class, and the top kernels."""
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_class, by_kernel = defaultdict(float), defaultdict(float)
    for evt in prof.events():
        if evt.device_type != DeviceType.CUDA:
            continue
        us = evt.time_range.elapsed_us()
        by_class[kernel_class(evt.name)] += us / 1e3
        by_kernel[evt.name] += us / 1e3
    busy_ms = sum(by_class.values())
    if busy_ms == 0.0:
        raise SystemExit("the profiler recorded no device time; time with CUDA events")
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]
    return {
        "wall_ms_per_run": wall_ms / n,
        "device_ms_per_run": busy_ms / n,
        "device_busy_share": busy_ms / wall_ms,
        "device_ms_per_run_by_class": {k: v / n for k, v in sorted(by_class.items())},
        "top_kernels_ms_per_run": [[k[:90], v / n] for k, v in top],
        "device": torch.cuda.get_device_name(0),
        "switches": {k: v for k, v in os.environ.items() if k.startswith("GDT_")},
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, nargs="+", default=[1, 8, 32])
    ap.add_argument("--requests", type=int, default=5)
    ap.add_argument("--train", action="store_true", help="profile the flagship train step")
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--fp32", action="store_true", help="the config's own fp32 path")
    ap.add_argument("--train-batch", type=int, default=TRAIN_BATCH,
                    help="the train step's batch (default the flagship's 16)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    dtype = "float32" if args.fp32 else "bfloat16"
    if args.fp32:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    if args.train:
        model, state, step = flagship_train(None if args.fp32 else torch.bfloat16)
        batch = train_batch(args.train_batch, model.input_size, "cuda", 1)
        for _ in range(3):
            step(state, batch)
        torch.cuda.synchronize()
        out = profiled(lambda: step(state, batch), args.steps)
        print(json.dumps({"mode": "train", "batch": args.train_batch, "dtype": dtype,
                          "steps": args.steps, **out}), flush=True)
        return 0

    model, net, hmin, hmax = flagship_detector()
    detect = make_detector_fn(model, net, hmin, hmax, 256, dtype=dtype)
    for b in args.batch:
        inputs = [torch.as_tensor(a, device="cuda") for a in detector_inputs(b, b)]
        for _ in range(3):
            detect(*inputs)
        torch.cuda.synchronize()
        out = profiled(lambda: detect(*inputs), args.requests)
        print(json.dumps({"mode": "detector", "batch": b, "dtype": dtype,
                          "requests": args.requests, **out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
