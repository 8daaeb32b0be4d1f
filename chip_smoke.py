#!/usr/bin/env python3
"""Drive the PyTorch port of the OD-VAE detector on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root; needs one card

Phases (any failure raises and exits non-zero, before the result line):

1. device: the card's name, the device count, nvidia-smi's name and power limit;
2. build: nvcc builds every kernel under generative_detection_tpu_torch/csrc;
3. kernels at the flagship detector's shapes, batch 8: each kernel against its
   plain PyTorch version on the card, with its time, the plain version's, one
   library call's (a yardstick the port never calls) and the card's bound;
4. detector: the flagship config (configs/autoencoder/pose/
   autoencoder_kl_16x16x16.yaml) at full width with seeded random weights
   serves requests at batch 1, 8 and 32 in bf16; the launch counters must
   show 28 GroupNorm and 3 attention launches per forward. Then the same
   weights and inputs at batch 2 in fp32 on the card and on the CPU (which
   runs the plain versions) must agree;
5. one {"kernels": [...]} line, the nvidia-smi line, and last
   {"ok": true, "device": {...}}.

It imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from generative_detection_tpu_torch.config import instantiate_from_config, merge_configs
from generative_detection_tpu_torch.ops import _build, attention, norm
from generative_detection_tpu_torch.serving import make_detector_fn

REPO = Path(__file__).resolve().parent
FLAGSHIP = REPO / "configs/autoencoder/pose/autoencoder_kl_16x16x16.yaml"
# Published H100 SXM peaks (NVIDIA data sheet, dense, at 700 W)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # fp32: CUDA cores
BATCH = 8
# The encoder's 28 GroupNorm sites of the flagship forward, by (h=w, C, act).
GN_SITES = {
    (256, 128, "silu"): 4, (128, 128, "silu"): 4, (64, 128, "silu"): 1,
    (64, 256, "silu"): 3, (64, 256, None): 2, (32, 256, "silu"): 4,
    (16, 256, "silu"): 1, (16, 512, "silu"): 8, (16, 512, None): 1,
}
# Its 3 attention sites, by (L, C): level 2 twice, the mid block once.
ATTN_SITES = {(4096, 256): 2, (256, 512): 1}
GN_PER_FORWARD, ATTN_PER_FORWARD = sum(GN_SITES.values()), sum(ATTN_SITES.values())

# Tolerances, kernel against plain version on the same inputs.
# GroupNorm, |err| <= atol + rtol * |plain| on outputs of size ~1:
# - fp32: the same fp32 arithmetic in another summation order;
# - bf16: both round an fp32 result to bf16 (one ulp is 2^-8 relative) from
#   values that differ in the last bits.
GN_TOL = {torch.float32: (1e-4, 0.0), torch.bfloat16: (2e-2, 8e-3)}
# Attention, max |err| <= tol * RMS(plain): with N(0, 1) inputs a row's
# softmax spreads over about L/e keys, so the output's RMS is about
# sqrt(e / L) (0.026 at L=4096, 0.10 at L=256) and an absolute limit would
# hide a dropped or mis-weighted K/V tile. bf16 also rounds P to bf16 against
# a running rather than the final row max; fp32 differs in summation order.
ATTN_REL_TOL = {torch.float32: 1e-3, torch.bfloat16: 0.1}
LSE_TOL = 1e-3  # fp32 row statistics from the same logits
# Card against CPU, fp32 detector: fp32 on both sides with TF32 off; the box
# centre amplifies pose differences by up to 1 / (1 - fill factor).
BOX_TOL = dict(rtol=1e-3, atol=1e-3)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def time_ms(fn, iters: int = 20) -> float:
    """Mean device time of ``fn`` over ``iters`` launches after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def check_close(name, got, want, atol, rtol) -> float:
    err = (got.float() - want.float()).abs()
    bad = err > atol + rtol * want.float().abs()
    require(not bool(bad.any()), f"{name}: {int(bad.sum())} elements outside tolerance, "
            f"max err {err.max().item()}")
    return err.max().item()


def phase_device() -> tuple[str, str]:
    require(torch.cuda.is_available(), "no CUDA device")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    emit({"phase": "device", "name": name, "count": torch.cuda.device_count(),
          "nvidia_smi": smi, "torch": torch.__version__, "cuda": torch.version.cuda})
    return name, smi


def phase_build() -> None:
    t0 = time.perf_counter()
    times = _build.build()
    wall = time.perf_counter() - t0
    spills = [ln.strip() for n in _build.SOURCES for ln in _build.build_log(n).splitlines()
              if "spill" in ln and not ln.strip().startswith("0 bytes")]
    emit({"phase": "build", "wall_s": wall, "per_source_s": times, "spill_lines": spills})


def gn_case(g, hw, c, act, dtype):
    x = (torch.randn(BATCH, hw, hw, c, device="cuda", generator=g) * 2 + 0.5).to(dtype)
    gamma = 1 + 0.1 * torch.randn(c, device="cuda", generator=g)
    beta = 0.1 * torch.randn(c, device="cuda", generator=g)
    got = norm.group_norm(x, gamma, beta, 32, 1e-6, act)
    want = norm._gn_reference(x, gamma, beta, 32, 1e-6, act)
    torch.cuda.synchronize()
    err = check_close(f"group_norm {x.shape} {act} {dtype}", got, want, *GN_TOL[dtype])
    x_nchw = x.permute(0, 3, 1, 2)
    g_lib, b_lib = gamma.to(dtype), beta.to(dtype)

    def library():
        y = F.group_norm(x_nchw, 32, g_lib, b_lib, 1e-6)
        return F.silu(y) if act == "silu" else y

    nbytes = 2 * x.numel() * x.element_size() + 2 * c * 4
    return {
        "name": "group_norm", "shape": list(x.shape), "dtype": str(dtype).split(".")[1],
        "act": act, "max_err": err,
        "kernel_ms": time_ms(lambda: norm.group_norm(x, gamma, beta, 32, 1e-6, act)),
        "plain_ms": time_ms(lambda: norm._gn_reference(x, gamma, beta, 32, 1e-6, act), 5),
        "library_ms": time_ms(library),
        "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
    }


def attn_case(g, l, c, dtype):
    q, k, v = (torch.randn(BATCH, l, c, device="cuda", generator=g).to(dtype) for _ in range(3))
    o, lse = attention.single_head_attention(q, k, v, return_lse=True)
    want_o, want_lse = attention._attention_reference(q, k, v)
    torch.cuda.synchronize()
    limit = ATTN_REL_TOL[dtype] * want_o.float().pow(2).mean().sqrt().item()
    err = check_close(f"attention {q.shape} {dtype}", o, want_o, limit, 0.0)
    check_close(f"attention lse {q.shape} {dtype}", lse, want_lse, LSE_TOL, 0.0)
    flops = 4 * BATCH * l * l * c
    nbytes = 4 * q.numel() * q.element_size() + BATCH * l * 4
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / HBM_BYTES_PER_S
    q4, k4, v4 = q[:, None], k[:, None], v[:, None]
    return {
        "name": "attention", "shape": [BATCH, l, c], "dtype": str(dtype).split(".")[1],
        "max_err": err, "tol": limit, "lse_err": (lse - want_lse).abs().max().item(),
        "kernel_ms": time_ms(lambda: attention.single_head_attention(q, k, v, return_lse=True)),
        "plain_ms": time_ms(lambda: attention._attention_reference(q, k, v), 5),
        "library_ms": time_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4)),
        "bound_ms": max(t_ops, t_bytes) * 1e3,
        "bound_by": "operations" if t_ops > t_bytes else "bytes",
    }


def phase_kernels() -> dict:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(0)
    cases = {}
    for dtype in (torch.bfloat16, torch.float32):
        for hw, c in sorted({(hw, c) for hw, c, _ in GN_SITES}, reverse=True):
            for act in ("silu", None):
                r = gn_case(g, hw, c, act, dtype)
                cases[("group_norm", hw, c, act, dtype)] = r
                emit(r)
        for l, c in ATTN_SITES:
            r = attn_case(g, l, c, dtype)
            cases[("attention", l, c, dtype)] = r
            emit(r)
    return cases


def flagship_detector(device: str = "cuda"):
    """The flagship PoseAutoencoder with seeded random weights on ``device``,
    and synthetic hmin/hmax tables (as tests/test_serving.py makes them)."""
    model = instantiate_from_config(merge_configs([str(FLAGSHIP)])["model"])
    net = model.init_net(torch.Generator().manual_seed(0), device=device)
    return model, net, np.full(11, 0.5, np.float32), np.full(11, 4.0, np.float32)


def detector_inputs(b: int, seed: int):
    """The arguments of one detector request of ``b`` patches, seeded numpy."""
    rng = np.random.default_rng(seed)
    return (
        rng.uniform(-1, 1, size=(b, 256, 256, 3)).astype(np.float32),
        np.full((b,), 1266.0, np.float32),
        np.tile(np.float32([800.0, 450.0]), (b, 1)),
        rng.uniform(60, 200, size=(b,)).astype(np.float32),
        np.tile(np.float32([820.0, 460.0]), (b, 1)),
        rng.uniform(1.5, 3.0, size=(b,)).astype(np.float32),
    )


def phase_detector() -> dict:
    model, net, hmin, hmax = flagship_detector()
    detect = make_detector_fn(model, net, hmin, hmax, 256)  # the bf16 default
    requests = {1: 20, 8: 20, 32: 10}
    inputs = {b: [torch.as_tensor(a, device="cuda") for a in detector_inputs(b, b)]
              for b in requests}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    norm.group_norm.launches = 0
    attention.single_head_attention.launches = 0
    calls, results = 0, {}
    for b, n in requests.items():
        lat = []
        for i in range(n + 3):  # the first 3 requests warm up
            t0 = time.perf_counter()
            boxes, cls, score = detect(*inputs[b])
            torch.cuda.synchronize()
            if i >= 3:
                lat.append(time.perf_counter() - t0)
            calls += 1
        require(boxes.shape == (b, 7) and cls.shape == (b,) and score.shape == (b,),
                f"detector output shapes {boxes.shape} {cls.shape} {score.shape}")
        require(bool(torch.isfinite(boxes).all() and torch.isfinite(score).all()),
                "detector output not finite")
        p50 = statistics.median(lat)
        results[b] = {"phase": "detector", "batch": b, "dtype": "bfloat16", "requests": n,
                      "p50_ms": p50 * 1e3, "patches_per_s": b / p50,
                      "min_ms": min(lat) * 1e3, "max_ms": max(lat) * 1e3}
        emit(results[b])
    launches = {"group_norm": norm.group_norm.launches,
                "attention": attention.single_head_attention.launches}
    emit({"phase": "detector", "calls": calls, "launches": launches,
          "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()})
    require(launches["group_norm"] == GN_PER_FORWARD * calls,
            f"group_norm launches {launches['group_norm']} != {GN_PER_FORWARD} x {calls}")
    require(launches["attention"] == ATTN_PER_FORWARD * calls,
            f"attention launches {launches['attention']} != {ATTN_PER_FORWARD} x {calls}")

    # fp32 on the card (kernels) against fp32 on the CPU (plain versions)
    args = detector_inputs(2, 99)
    outs = {}
    for device in ("cuda", "cpu"):
        det = make_detector_fn(model, net, hmin, hmax, 256, dtype="float32", device=device)
        outs[device] = [t.cpu().numpy() for t in det(*args)]
    (boxes, cls, score), (wboxes, wcls, wscore) = outs["cuda"], outs["cpu"]
    np.testing.assert_allclose(boxes, wboxes, **BOX_TOL)
    np.testing.assert_array_equal(cls, wcls)
    np.testing.assert_allclose(score, wscore, rtol=0, atol=1e-5)
    emit({"phase": "detector_fp32_card_vs_cpu", "batch": 2,
          "boxes_max_abs_err": float(np.abs(boxes - wboxes).max()),
          "score_max_abs_err": float(np.abs(score - wscore).max()),
          "classes_equal": True, "boxes": boxes.tolist()})
    return launches


def kernels_line(cases: dict, launches: dict) -> dict:
    """One entry per kernel, with the numbers of its largest bf16 site at
    batch 8. ``launches`` counts wrapper calls that launched the kernel; a
    GroupNorm call is ``kernels_per_call`` = 2 device kernels (stats, apply)."""
    bf16 = torch.bfloat16
    gn = cases[("group_norm", 256, 128, "silu", bf16)]
    at = cases[("attention", 4096, 256, bf16)]
    entries = []
    for r, source, replaces, per_call in (
        (gn, "generative_detection_tpu_torch/csrc/group_norm.cu",
         "generative_detection_tpu/ops/norm.py:109", 2),
        (at, "generative_detection_tpu_torch/csrc/attention.cu",
         "generative_detection_tpu/ops/attention.py:226", 1),
    ):
        entries.append({
            "name": r["name"], "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[r["name"]], "max_abs_err": r["max_err"],
            "ms": r["kernel_ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "shape": r["shape"], "dtype": r["dtype"], "kernels_per_call": per_call,
        })
    return {"kernels": entries}


def main() -> int:
    name, smi = phase_device()
    phase_build()
    cases = phase_kernels()
    launches = phase_detector()
    emit(kernels_line(cases, launches))
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
