#!/usr/bin/env python3
"""Compare the GroupNorm(+SiLU) backward kernel (B4c/d) of two checkouts of
the PyTorch port on one card, each tree in its own process, in the order
given.

    python3 tools/ab_group_norm_bwd_kernel.py PARENT_TREE CHANGE_TREE CHANGE_TREE PARENT_TREE

A tree is a directory holding a checkout (e.g. from ``git archive``); its
``generative_detection_tpu_torch`` is imported and builds its own kernels.
At every GroupNorm site of the flagship train step (batch 16, ``SITES``:
(h=w, C, act) and its count a step, as ``chip_smoke.py``'s hooks find them),
in bf16 and fp32, each run times ``group_norm_backward`` (the median of 5
means of 20 calls after a warm-up, CUDA events: the small sites' times
spread by tens of percent between single means; the inputs are the same
each call, so a site whose x and dy fit the 50 MB L2 is timed with them
there), its device time (``torch.profiler``, the backward's kernels summed
over 5 calls: at the small sites the event time is the host's launch cost),
checks dx,
dgamma and dbeta against the plain version (the tolerances of
``chip_smoke.py``), checks that a repeat is bit-equal, and times
``F.group_norm``'s backward on the same inputs (its forward and backward
less its forward; a yardstick the port never calls). The bound moves x and
dy in and dx out once at 3.35 TB/s. Each run prints one JSON line with the
sites and the sums over one step's sites (count x ms); the card's name and
power limit come last.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

# The flagship train step's GroupNorm sites (h=w, C, act): count per step
SITES = {
    (256, 128, "silu"): 11, (128, 128, "silu"): 9, (128, 256, "silu"): 1,
    (64, 128, "silu"): 1, (64, 256, "silu"): 9, (64, 256, None): 5, (32, 256, "silu"): 9,
    (32, 512, "silu"): 1, (16, 256, "silu"): 1, (16, 512, "silu"): 18, (16, 512, None): 2,
}
BATCH = 16
HBM_BYTES_PER_S = 3.35e12
# dx: |err| <= tol * RMS(plain) + rtol * |plain|; dgamma, dbeta: 1e-4 of their largest
GN_BWD_TOL = {"float32": (1e-4, 0.0), "bfloat16": (2e-2, 8e-3)}


def _time_ms(fn, iters: int = 20, repeats: int = 5) -> float:
    import statistics

    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    means = []
    for _ in range(repeats):
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        means.append(start.elapsed_time(end) / iters)
    return statistics.median(means)


def _device_ms(fn, calls: int = 5) -> float:
    """Device ms per call of the GroupNorm-backward kernels ``fn`` launches."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sum(e.device_time_total for e in prof.key_averages() if "gn_bwd" in e.key) / calls / 1e3


def _site(norm, g, hw, c, act, dtype) -> dict:
    import torch
    import torch.nn.functional as F

    name = str(dtype).split(".")[1]
    x = (torch.randn(BATCH, hw, hw, c, device="cuda", generator=g) * 2 + 0.5).to(dtype)
    dy = torch.randn(x.shape, device="cuda", generator=g).to(dtype)
    gamma = 1 + 0.1 * torch.randn(c, device="cuda", generator=g)
    beta = 0.1 * torch.randn(c, device="cuda", generator=g)
    _, partial = norm._gn_cuda(x, gamma, beta, 32, 1e-6, act)
    _, mean, rstd = norm._gn_forward_reference(x, gamma, beta, 32, 1e-6, act)
    args = (x, dy, partial, gamma, beta, 32, 1e-6, act)
    got = norm.group_norm_backward(*args)
    again = norm.group_norm_backward(*args)
    want = norm._gn_backward_reference(x, dy, mean, rstd, gamma, beta, act)
    tol, rtol = GN_BWD_TOL[name]
    w = want[0].float()
    err = (got[0].float() - w).abs()
    ok = bool((err <= tol * w.pow(2).mean().sqrt() + rtol * w.abs()).all())
    for gt, wt in zip(got[1:], want[1:]):
        ok = ok and bool(((gt - wt).abs() <= 1e-4 * wt.abs().max()).all())
    x_lib = x.permute(0, 3, 1, 2).detach().requires_grad_(True)
    g_lib, b_lib = gamma.to(dtype).requires_grad_(True), beta.to(dtype).requires_grad_(True)
    dy_lib = dy.permute(0, 3, 1, 2)

    def lib_fwd():
        y = F.group_norm(x_lib, 32, g_lib, b_lib, 1e-6)
        return F.silu(y) if act == "silu" else y

    def lib_fwd_bwd():
        torch.autograd.grad(lib_fwd(), (x_lib, g_lib, b_lib), dy_lib)

    ms = _time_ms(lambda: norm.group_norm_backward(*args))
    bound = (3 * x.numel() * x.element_size() + 6 * c * 4) / HBM_BYTES_PER_S * 1e3
    row = {"shape": [BATCH, hw, hw, c], "act": act, "dtype": name, "ms": ms,
           "device_ms": _device_ms(lambda: norm.group_norm_backward(*args)),
           "library_ms": _time_ms(lib_fwd_bwd) - _time_ms(lib_fwd), "bound_ms": bound,
           "bound_share": bound / ms, "dx_max_err": err.max().item(), "within_tol": ok,
           "repeat_equal": all(torch.equal(a, b) for a, b in zip(got, again))}
    del x, dy, got, again, want, x_lib, dy_lib, w, err
    torch.cuda.empty_cache()
    return row


def run_one(tree: str) -> dict:
    tree = os.path.abspath(tree)
    os.chdir(tree)
    sys.path.insert(0, tree)
    import torch

    from generative_detection_tpu_torch.ops import norm

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(0)
    out = {"tree": tree, "sites": []}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[1]
        step = {"ms": 0.0, "device_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0}
        for (hw, c, act), n in sorted(SITES.items(), key=lambda s: (s[0][:2], s[0][2] or ""),
                                       reverse=True):
            row = _site(norm, g, hw, c, act, dtype)
            row["count"] = n
            out["sites"].append(row)
            for k in step:
                step[k] += n * row[k]
        out[f"step_{name}"] = step
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
