#!/usr/bin/env python3
"""Compare the GroupNorm(+SiLU) forward (B3) and its stats-only affine of two
checkouts of the PyTorch port on one card, each tree in its own process, in
the order given.

    python3 tools/ab_group_norm_kernel.py PARENT_TREE CHANGE_TREE CHANGE_TREE PARENT_TREE

A tree is a directory holding a checkout (e.g. from ``git archive``); its
``generative_detection_tpu_torch`` is imported and builds its own kernels.
At every GroupNorm site of the flagship detector at batch 8 and 32
(``DETECTOR_SITES``, 28 a request) and of the flagship train step at batch 16
(``STEP_SITES``, 67 a step), in bf16 and fp32, each run times ``group_norm``
and ``group_norm_affine``: the median of 5 means of 20 calls after a warm-up
(CUDA events; the inputs are the same each call, so a site whose x fits the
50 MB L2 is timed with it there) and the device time of their kernels
(``torch.profiler``, summed over 5 calls: at the small sites the event time
is the host's launch cost). It checks each against its plain version (the
tolerances of ``chip_smoke.py``), checks that a repeat is bit-equal, and
times ``F.group_norm`` (+ ``F.silu``) on the same inputs as the forward's
yardstick (the port never calls it). The bound moves x in and y out once at
3.35 TB/s (the affine: x in, a and b out). Each run prints one JSON line with
the sites and the sums over a request's and a step's sites (count x ms);
the card's name and power limit come last.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys

# The flagship encoder's GroupNorm sites (h=w, C, act): count per detector request
DETECTOR_SITES = {
    (256, 128, "silu"): 4, (128, 128, "silu"): 4, (64, 128, "silu"): 1,
    (64, 256, "silu"): 3, (64, 256, None): 2, (32, 256, "silu"): 4,
    (16, 256, "silu"): 1, (16, 512, "silu"): 8, (16, 512, None): 1,
}
# The flagship train step's GroupNorm sites (h=w, C, act): count per step
STEP_SITES = {
    (256, 128, "silu"): 11, (128, 128, "silu"): 9, (128, 256, "silu"): 1,
    (64, 128, "silu"): 1, (64, 256, "silu"): 9, (64, 256, None): 5, (32, 256, "silu"): 9,
    (32, 512, "silu"): 1, (16, 256, "silu"): 1, (16, 512, "silu"): 18, (16, 512, None): 2,
}
RUNS = (("detector", 8, DETECTOR_SITES), ("detector", 32, DETECTOR_SITES),
        ("step", 16, STEP_SITES))
HBM_BYTES_PER_S = 3.35e12
# |err| <= atol + rtol * |plain| (chip_smoke.py's GN_TOL); the affine: 1e-4 of RMS
GN_TOL = {"float32": (1e-4, 0.0), "bfloat16": (2e-2, 8e-3)}


def _time_ms(fn, iters: int = 20, repeats: int = 5) -> float:
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
    """Device ms per call of the GroupNorm forward kernels ``fn`` launches."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sum(e.device_time_total for e in prof.key_averages()
               if "gn_" in e.key and "gn_bwd" not in e.key) / calls / 1e3


def _site(norm, g, b, hw, c, act, dtype) -> dict:
    import torch
    import torch.nn.functional as F

    name = str(dtype).split(".")[1]
    x = (torch.randn(b, hw, hw, c, device="cuda", generator=g) * 2 + 0.5).to(dtype)
    gamma = 1 + 0.1 * torch.randn(c, device="cuda", generator=g)
    beta = 0.1 * torch.randn(c, device="cuda", generator=g)
    y = norm.group_norm(x, gamma, beta, 32, 1e-6, act)
    again = norm.group_norm(x, gamma, beta, 32, 1e-6, act)
    want = norm._gn_reference(x, gamma, beta, 32, 1e-6, act).float()
    atol, rtol = GN_TOL[name]
    err = (y.float() - want).abs()
    ok = bool((err <= atol + rtol * want.abs()).all())
    del want
    a, shift, _ = norm.group_norm_affine(x, gamma, beta)
    a2, shift2, _ = norm.group_norm_affine(x, gamma, beta)
    wa, wb, _, _ = norm._gn_affine_reference(x, gamma, beta, 32, 1e-6)
    aff_err = max(((got - w).abs().max() / w.pow(2).mean().sqrt()).item()
                  for got, w in ((a, wa), (shift, wb)))
    x_nchw = x.permute(0, 3, 1, 2)
    g_lib, b_lib = gamma.to(dtype), beta.to(dtype)

    def library():
        out = F.group_norm(x_nchw, 32, g_lib, b_lib, 1e-6)
        return F.silu(out) if act == "silu" else out

    nbytes = x.numel() * x.element_size()
    fwd = lambda: norm.group_norm(x, gamma, beta, 32, 1e-6, act)  # noqa: E731
    aff = lambda: norm.group_norm_affine(x, gamma, beta)  # noqa: E731
    ms, aff_ms = _time_ms(fwd), _time_ms(aff)
    bound = (2 * nbytes + 2 * c * 4) / HBM_BYTES_PER_S * 1e3
    aff_bound = (nbytes + 2 * b * c * 4 + 2 * c * 4) / HBM_BYTES_PER_S * 1e3
    row = {"shape": [b, hw, hw, c], "act": act, "dtype": name,
           "ms": ms, "device_ms": _device_ms(fwd), "library_ms": _time_ms(library),
           "bound_ms": bound, "bound_share": bound / ms, "max_err": err.max().item(),
           "within_tol": ok, "repeat_equal": torch.equal(y, again),
           "affine_ms": aff_ms, "affine_device_ms": _device_ms(aff),
           "affine_bound_ms": aff_bound, "affine_bound_share": aff_bound / aff_ms,
           "affine_rms_err": aff_err, "affine_within_tol": aff_err <= 1e-4,
           "affine_repeat_equal": torch.equal(a, a2) and torch.equal(shift, shift2)}
    del x, y, again, a, a2, shift, shift2, wa, wb, err
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
    g = torch.Generator(device="cuda").manual_seed(0)
    out = {"tree": tree, "sites": []}
    keys = ("ms", "device_ms", "library_ms", "bound_ms", "affine_ms", "affine_device_ms")
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[1]
        for per, b, sites in RUNS:
            total = dict.fromkeys(keys, 0.0)
            for (hw, c, act), n in sorted(sites.items(), key=lambda s: (s[0][:2], s[0][2] or ""),
                                          reverse=True):
                row = _site(norm, g, b, hw, c, act, dtype)
                row["count"], row["per"] = n, per
                out["sites"].append(row)
                for k in keys:
                    total[k] += n * row[k]
            out[f"{per}_bs{b}_{name}"] = total
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
