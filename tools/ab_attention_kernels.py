#!/usr/bin/env python3
"""Compare the attention kernels (B1 forward, B2 backward, the flash variant
B5) of two checkouts of the PyTorch port on one card, each tree in its own
process, in the order given.

    python3 tools/ab_attention_kernels.py PARENT_TREE CHANGE_TREE CHANGE_TREE PARENT_TREE

A tree is a directory holding a checkout (e.g. from ``git archive``); its
``generative_detection_tpu_torch`` is imported and builds its own kernels.
At every attention site of the flagship detector (batch 8), and at L =
16384 (batch 1), each run times the bf16 forward (``single_head_attention``
with its lse); the bf16 backward (``_attention_backward_cuda``) at every
site of the flagship train step (batch 16), the tiny configs' (C = 64), the
C = 128 kernels', the shapes off the kernels' grid (padded) and L = 16384
(``BWD_SITES``). Each is the mean of 20 launches after a warm-up (CUDA
events), checked against the plain version (max |err| / RMS(plain)), its
device time split by kernel (``torch.profiler``, 3 calls: at small sites
the host's launch cost exceeds the kernels' and sets the event time), with
the card's bound (bf16 peak 989 TFLOP/s, 3.35 TB/s) and the achieved
TFLOP/s; each backward also with SDPA's backward on the same bf16 inputs
(its forward and backward less its forward), whether a repeat is
bit-equal, and its error with a peaked softmax (q and k scaled by 4). Then
the fp32 forward (B1 with its lse)
at the flagship's fp32 sites at batch 8, 16 and 32 (a train step's and a
detector request's), and B5 on fp32 and on bf16 inputs at batch 8, each
beside SDPA on fp32 copies of q, k, v (TF32 off), with the bound of the
tree's route: six bf16 piece products for each of S and P V where it runs
split precision (every C since the C = 512 kernel, C <= 256 before), else
fp32 on the CUDA cores (67 TFLOP/s); three bf16 products for B5 on bf16
inputs. Each fp32 forward row also gives its error with a peaked softmax
(q and k scaled by 4) and whether a repeat is bit-equal. B5 on bf16 inputs is also timed on fp32
copies of its inputs (the fp32 route with the inputs widened). Then the
fp32 backward (``_attention_backward_cuda``) at (16, 4096, 256), (16, 256,
512) and (2, 256, 64), beside fp32 SDPA's backward (its forward and
backward less its forward, TF32 off), with the bound of the tree's route:
six bf16 piece products for each of the five products where it runs split
precision (every C since the C = 512 kernel, C <= 256 before), else the
CUDA cores; the profiler splits it by kernel (the split route: the pre-pass
and the one kernel of the dK, dQ and dV roles). The card's name and power
limit come last.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys

FWD_SITES = ((8, 4096, 256), (8, 256, 512), (1, 16384, 256))
BWD_SITES = ((16, 4096, 256), (16, 256, 512), (2, 256, 512), (2, 256, 64), (4, 1024, 64),
             (1, 256, 128), (2, 256, 128), (2, 256, 96), (1, 576, 512), (2, 400, 512),
             (1, 16384, 256))
FP32_SITES = tuple((b, l, c) for b in (8, 16, 32) for l, c in ((4096, 256), (256, 512)))
FLASH_SITES = ((8, 4096, 256), (8, 256, 512))
FP32_BWD_SITES = ((16, 4096, 256), (16, 256, 512), (2, 256, 64))
PEAK_FLOPS, HBM_BYTES_PER_S = 989e12, 3.35e12
FP32_FLOPS = 67e12  # CUDA cores


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


def _rel_err(got, want) -> float:
    want = want.float()
    return ((got.float() - want).abs().max() / want.pow(2).mean().sqrt()).item()


def _kernel_split(fn, calls: int = 3) -> dict:
    """Device ms per launch of each attention kernel that ``fn`` launches
    (the mean over the launches the profiler recorded)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    split = {}
    for e in prof.key_averages():
        name = re.search(r"attn_\w+", e.key)
        if name:
            split[name.group(0)] = e.device_time_total / e.count / 1e3
    return split


def _bound_ms(flops: float, nbytes: float) -> float:
    return max(flops / PEAK_FLOPS, nbytes / HBM_BYTES_PER_S) * 1e3


def _splits(attention, c: int, backward: bool = False) -> bool:
    """Whether the tree runs fp32 attention at width ``c`` split precision:
    at the widths it names (older trees), else at every width."""
    for name in ("SPLIT_BWD_CHANNELS", "SPLIT_CHANNELS")[0 if backward else 1:]:
        if hasattr(attention, name):
            return c in getattr(attention, name)
    return True


def _route_bound_ms(b, l, c, fp32: bool, nbytes: float, products: int = 2,
                    split: bool = True) -> float:
    """``products`` L x L x C products of 2 b l^2 c flops (2 forward, 5
    backward): fp32 on the split-precision route (``split``) six bf16 piece
    products each, else on the CUDA cores; bf16 inputs of B5: three bf16
    products."""
    one = 2 * b * l * l * c
    if not fp32:
        t_ops = 3 * one / PEAK_FLOPS
    elif split:
        t_ops = 6 * products * one / PEAK_FLOPS
    else:
        t_ops = products * one / FP32_FLOPS
    return max(t_ops, nbytes / HBM_BYTES_PER_S) * 1e3


def _sdpa_fp32_ms(q, k, v) -> float:
    import torch.nn.functional as F

    q4, k4, v4 = (t.float()[:, None] for t in (q, k, v))
    return _time_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4))


def _fp32_rows(attention, g) -> dict:
    """The fp32 forward (B1 with its lse) and B5 on fp32 and bf16 inputs."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    out = {"forward_fp32": [], "flash": []}
    for b, l, c in FP32_SITES:
        q, k, v = (torch.randn(b, l, c, device="cuda", generator=g) for _ in range(3))
        o, lse = attention.single_head_attention(q, k, v, return_lse=True)
        again = attention.single_head_attention(q, k, v, return_lse=True)
        fn = lambda: attention.single_head_attention(q, k, v, return_lse=True)  # noqa: E731
        qp, kp = 4 * q, 4 * k
        peaked = attention.single_head_attention(qp, kp, v)
        out["forward_fp32"].append({
            "shape": [b, l, c], "ms": _time_ms(fn), "sdpa_fp32_ms": _sdpa_fp32_ms(q, k, v),
            "bound_ms": _route_bound_ms(b, l, c, True, 4 * q.numel() * 4 + b * l * 4,
                                        split=_splits(attention, c)),
            "max_err_rel_rms": _rel_err(o, attention._attention_reference(q, k, v)[0]),
            "peaked_err_rel_rms": _rel_err(peaked,
                                           attention._attention_reference(qp, kp, v)[0]),
            "repeat_equal": bool(torch.equal(o, again[0]) and torch.equal(lse, again[1])),
            "kernel_ms": _kernel_split(fn),
        })
        del q, k, v, o, lse, again, qp, kp, peaked
        torch.cuda.empty_cache()
    for b, l, c in FLASH_SITES:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (torch.randn(b, l, c, device="cuda", generator=g).to(dtype)
                       for _ in range(3))
            o = attention.flash_attention_forward(q, k, v)
            fn = lambda: attention.flash_attention_forward(q, k, v)  # noqa: E731
            row = {"shape": [b, l, c], "dtype": str(dtype).split(".")[1], "ms": _time_ms(fn),
                   "sdpa_fp32_ms": _sdpa_fp32_ms(q, k, v),
                   "bound_ms": _route_bound_ms(b, l, c, dtype == torch.float32,
                                               4 * q.numel() * q.element_size(),
                                               split=_splits(attention, c)),
                   "max_err_rel_rms": _rel_err(o, attention._flash_reference(q, k, v)),
                   "kernel_ms": _kernel_split(fn)}
            if dtype == torch.bfloat16:
                qf, kf, vf = (t.float() for t in (q, k, v))
                row["widened_to_fp32_ms"] = _time_ms(
                    lambda: attention.flash_attention_forward(qf, kf, vf).bfloat16())
            out["flash"].append(row)
            del q, k, v, o
            torch.cuda.empty_cache()
    return out


def _fp32_bwd_rows(attention, g) -> list:
    """The fp32 backward at FP32_BWD_SITES beside fp32 SDPA's backward."""
    import torch
    import torch.nn.functional as F

    torch.backends.cuda.matmul.allow_tf32 = False
    rows = []
    for b, l, c in FP32_BWD_SITES:
        q, k, v, do = (torch.randn(b, l, c, device="cuda", generator=g) for _ in range(4))
        o, lse = attention.single_head_attention(q, k, v, return_lse=True)
        di = (do * o).sum(-1)
        args = (q, k, v, do, lse, di)
        got = attention._attention_backward_cuda(*args)
        want = attention._attention_backward_reference(*args)
        q4, k4, v4 = (t[:, None].detach().requires_grad_(True) for t in (q, k, v))
        do4 = do[:, None]

        def sdpa():
            return F.scaled_dot_product_attention(q4, k4, v4)

        def sdpa_fwd_bwd():
            torch.autograd.grad(sdpa(), (q4, k4, v4), do4)

        fn = lambda: attention._attention_backward_cuda(*args)  # noqa: E731
        rows.append({
            "shape": [b, l, c], "ms": _time_ms(fn),
            "sdpa_fp32_bwd_ms": _time_ms(sdpa_fwd_bwd) - _time_ms(sdpa),
            "bound_ms": _route_bound_ms(
                b, l, c, True, 7 * q.numel() * 4 + 2 * b * l * 4, 5,
                split=_splits(attention, c, backward=True)),
            "max_err_rel_rms": max(_rel_err(x, y) for x, y in zip(got, want)),
            "kernel_ms": _kernel_split(fn),
        })
        del q, k, v, do, o, got, want, q4, k4, v4, do4
        torch.cuda.empty_cache()
    return rows


def _bwd_inputs(attention, g, b, l, c, peak=1.0):
    import torch

    q, k = (peak * torch.randn(b, l, c, device="cuda", generator=g) for _ in range(2))
    v, do = (torch.randn(b, l, c, device="cuda", generator=g) for _ in range(2))
    q, k, v, do = (t.bfloat16() for t in (q, k, v, do))
    o, lse = attention.single_head_attention(q, k, v, return_lse=True)
    return q, k, v, do, lse, (do.float() * o.float()).sum(-1)


def _bwd_row(attention, g, b, l, c) -> dict:
    """The bf16 backward at (b, l, c): event and device ms, bound, SDPA's
    backward, a bit-equal repeat, the error, and the error with a peaked
    softmax."""
    import torch
    import torch.nn.functional as F

    args = _bwd_inputs(attention, g, b, l, c)
    got = attention._attention_backward_cuda(*args)
    again = attention._attention_backward_cuda(*args)
    fn = lambda: attention._attention_backward_cuda(*args)  # noqa: E731
    ms = _time_ms(fn)
    split = _kernel_split(fn)
    want = attention._attention_backward_reference(*args)
    err = max(_rel_err(x, y) for x, y in zip(got, want))
    repeat = all(torch.equal(x, y) for x, y in zip(got, again))
    del got, again, want
    q4, k4, v4 = (t[:, None].detach().requires_grad_(True) for t in args[:3])
    do4 = args[3][:, None]

    def sdpa():
        return F.scaled_dot_product_attention(q4, k4, v4)

    def sdpa_fwd_bwd():
        torch.autograd.grad(sdpa(), (q4, k4, v4), do4)

    sdpa_ms = _time_ms(sdpa_fwd_bwd) - _time_ms(sdpa)
    del q4, k4, v4, do4, args
    peaked = _bwd_inputs(attention, g, b, l, c, peak=4.0)
    peaked_err = max(_rel_err(x, y) for x, y in zip(
        attention._attention_backward_cuda(*peaked),
        attention._attention_backward_reference(*peaked)))
    flops = 10 * b * l * l * c
    return {
        "shape": [b, l, c], "grid": list(attention.kernel_shape(l, c)), "ms": ms,
        "device_ms": sum(split.values()), "kernel_ms": split, "tflops": flops / ms / 1e9,
        "bound_ms": _bound_ms(flops, 7 * b * l * c * 2 + 2 * b * l * 4),
        "sdpa_bwd_ms": sdpa_ms, "repeat_equal": repeat, "max_err_rel_rms": err,
        "peaked_err_rel_rms": peaked_err,
    }


def run_one(tree: str) -> dict:
    tree = os.path.abspath(tree)
    os.chdir(tree)
    sys.path.insert(0, tree)
    import torch

    from generative_detection_tpu_torch.ops import attention

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device")
    g = torch.Generator(device="cuda").manual_seed(0)
    out = {"tree": tree, "forward": [], "backward": []}
    for b, l, c in FWD_SITES:
        q, k, v = (torch.randn(b, l, c, device="cuda", generator=g).bfloat16() for _ in range(3))
        o, _ = attention.single_head_attention(q, k, v, return_lse=True)
        ms = _time_ms(lambda: attention.single_head_attention(q, k, v, return_lse=True))
        flops = 4 * b * l * l * c
        out["forward"].append({
            "shape": [b, l, c], "ms": ms, "tflops": flops / ms / 1e9,
            "bound_ms": _bound_ms(flops, 4 * q.numel() * 2 + b * l * 4),
            "max_err_rel_rms": _rel_err(o, attention._attention_reference(q, k, v)[0]),
            "kernel_ms": _kernel_split(
                lambda: attention.single_head_attention(q, k, v, return_lse=True)),
        })
        del q, k, v, o
        torch.cuda.empty_cache()
    for b, l, c in BWD_SITES:
        out["backward"].append(_bwd_row(attention, g, b, l, c))
        torch.cuda.empty_cache()
    out.update(_fp32_rows(attention, g))
    out["backward_fp32"] = _fp32_bwd_rows(attention, g)
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
