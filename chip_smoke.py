#!/usr/bin/env python3
"""Drive the PyTorch port of the OD-VAE detector and its train step on one
NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root; needs one card

Phases (any failure raises and exits non-zero, before the result line):

1. device: the card's name, the device count, nvidia-smi's name and power limit;
2. build: nvcc builds every kernel under generative_detection_tpu_torch/csrc
   (one process per source, all started together);
3. kernels, each against its plain PyTorch version on the card, with its
   time, the plain version's, one library call's (a yardstick the port never
   calls) and the card's bound: the forward kernels at the flagship
   detector's shapes (batch 8), the backward kernels at every shape of the
   flagship train step (batch 16);
4. detector: the flagship config (configs/autoencoder/pose/
   autoencoder_kl_16x16x16.yaml) at full width with seeded random weights
   serves requests at batch 1, 8 and 32 in bf16; the launch counters must
   show 28 GroupNorm and 3 attention launches per forward. Then the same
   weights and inputs at batch 2 in fp32 on the card and on the CPU (which
   runs the plain versions) must agree;
5. train: the flagship train step at full width and depth, batch 16, bf16
   compute with fp32 master weights, past the whole curriculum (pixel,
   LPIPS, KL, pose and GAN terms and d_weight live): 3 warm-up and 10 timed
   steps; the launch counters must show one forward and one backward per
   GroupNorm and attention site per step, every network parameter a finite
   nonzero gradient, LPIPS and logvar unchanged and the discriminator moved;
6. train, card against CPU: one step of tiny_cpu.yaml at ch 128 in fp32 with
   the same weights and draws on both; losses, d_weight and both optimizers'
   Adam first moments must agree;
7. one {"kernels": [...]} line, the nvidia-smi line, and last
   {"ok": true, "device": {...}}.

It imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from generative_detection_tpu_torch.config import instantiate_from_config, merge_configs
from generative_detection_tpu_torch.models.blocks import AttnBlock, GroupNormSiLU
from generative_detection_tpu_torch.ops import _build, attention, norm
from generative_detection_tpu_torch.serving import make_detector_fn
from generative_detection_tpu_torch.train import create_train_state, make_train_step

REPO = Path(__file__).resolve().parent
FLAGSHIP = REPO / "configs/autoencoder/pose/autoencoder_kl_16x16x16.yaml"
TINY = REPO / "configs/autoencoder/pose/tiny_cpu.yaml"
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
# Backward kernels against their plain versions. GroupNorm dx:
# |err| <= tol * RMS(plain) + rtol * |plain| (bf16: two roundings of fp32
# values that differ in the last bits sit up to one bf16 ulp, 2^-7 relative,
# apart); dgamma/dbeta: fp32 sums in another order, 1e-4 of their largest
# magnitude. Attention dq, dk, dv: the forward's RMS rule, per output.
GN_BWD_TOL = {torch.float32: (1e-4, 0.0), torch.bfloat16: (2e-2, 8e-3)}
# The train step, batch 16 (bench.py's default for the JAX step), past the
# flagship curriculum: 30000 pretrain + 45000 pose-conditioned + 45000
# dropout warm-up global steps; optimizer step counting sees 2 * batch.
TRAIN_BATCH = 16
CURRICULUM_END = 30000 + 45000 + 45000
TRAIN_WARMUP, TRAIN_STEPS = 3, 10
# Card against CPU, tiny fp32 train step (TF32 off): losses and d_weight
# relative; Adam first moments (the clipped gradients) within 1e-3 of each
# optimizer's largest, since the composite loss is ~1e6 and summation noise
# scales with the global gradient, not with each parameter's.
TRAIN_LOSS_RTOL, MOMENT_REL = 1e-3, 1e-3


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
    spills = []  # (kernel, ptxas line) for every kernel that spills
    for n in _build.SOURCES:
        kernel = None
        for ln in _build.build_log(n).splitlines():
            if "Function properties for" in ln:
                kernel = ln.split("Function properties for")[-1].strip()
            elif "spill" in ln and not ln.strip().startswith("0 bytes"):
                spills.append([n, kernel, ln.strip()])
    emit({"phase": "build", "wall_s": wall, "per_source_s": times, "spills": spills})


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


def train_sites() -> tuple[Counter, Counter]:
    """The flagship train step's GroupNorm sites by (h=w, C, act) and its
    attention sites by (L, C), one forward pass (encoder and decoder) each,
    read with forward hooks from a batch-1 forward on the card."""
    model = instantiate_from_config(merge_configs([str(FLAGSHIP)])["model"])
    net = model.init_net(torch.Generator().manual_seed(0), device="cuda")
    gn, attn = Counter(), Counter()

    def on_gn(m, inp, _out):
        gn[(inp[0].shape[2], inp[0].shape[1], m.act)] += 1

    def on_attn(_m, inp, _out):
        attn[(inp[0].shape[2] * inp[0].shape[3], inp[0].shape[1])] += 1

    for m in net.modules():
        if isinstance(m, GroupNormSiLU):
            m.register_forward_hook(on_gn)
        elif isinstance(m, AttnBlock):
            m.register_forward_hook(on_attn)
    size = model.input_size
    with torch.no_grad():
        net(torch.zeros(1, size, size, 3, device="cuda"), CURRICULUM_END + 2, phase="full")
    return gn, attn


def rms_close(name, got, want, tol, rtol=0.0) -> float:
    want = want.float()
    err = (got.float() - want).abs()
    bad = err > tol * want.pow(2).mean().sqrt() + rtol * want.abs()
    require(not bool(bad.any()), f"{name}: {int(bad.sum())} elements outside tolerance, "
            f"max err {err.max().item()}")
    return err.max().item()


def gn_bwd_case(g, hw, c, act, dtype):
    x = (torch.randn(TRAIN_BATCH, hw, hw, c, device="cuda", generator=g) * 2 + 0.5).to(dtype)
    dy = torch.randn(x.shape, device="cuda", generator=g).to(dtype)
    gamma = 1 + 0.1 * torch.randn(c, device="cuda", generator=g)
    beta = 0.1 * torch.randn(c, device="cuda", generator=g)
    _, partial = norm._gn_cuda(x, gamma, beta, 32, 1e-6, act)
    _, mean, rstd = norm._gn_forward_reference(x, gamma, beta, 32, 1e-6, act)
    args = (x, dy, (partial,), gamma, beta, 32, 1e-6, act)
    dx, dgamma, dbeta = norm.group_norm_backward(*args)
    want = norm._gn_backward_reference(x, dy, mean, rstd, gamma, beta, act)
    torch.cuda.synchronize()
    name = f"group_norm backward {tuple(x.shape)} {act} {dtype}"
    err = rms_close(f"{name} dx", dx, want[0], *GN_BWD_TOL[dtype])
    for what, got, w in (("dgamma", dgamma, want[1]), ("dbeta", dbeta, want[2])):
        check_close(f"{name} {what}", got, w, 1e-4 * w.abs().max().item(), 0.0)

    x_lib = x.permute(0, 3, 1, 2).detach().requires_grad_(True)
    g_lib = gamma.to(dtype).requires_grad_(True)
    b_lib = beta.to(dtype).requires_grad_(True)
    dy_lib = dy.permute(0, 3, 1, 2)

    def lib_fwd():
        y = F.group_norm(x_lib, 32, g_lib, b_lib, 1e-6)
        return F.silu(y) if act == "silu" else y

    def lib_fwd_bwd():
        torch.autograd.grad(lib_fwd(), (x_lib, g_lib, b_lib), dy_lib)

    # the function moves x and dy in, dx out (and (C,) params and grads)
    nbytes = 3 * x.numel() * x.element_size() + 6 * c * 4
    return {
        "name": "group_norm_bwd", "shape": list(x.shape), "dtype": str(dtype).split(".")[1],
        "act": act, "max_err": err,
        "kernel_ms": time_ms(lambda: norm.group_norm_backward(*args)),
        "plain_ms": time_ms(
            lambda: norm._gn_backward_reference(x, dy, mean, rstd, gamma, beta, act), 3),
        "library_ms": time_ms(lib_fwd_bwd) - time_ms(lib_fwd),
        "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
    }


def attn_bwd_case(g, l, c, dtype):
    b = TRAIN_BATCH
    q, k, v, do = (torch.randn(b, l, c, device="cuda", generator=g).to(dtype) for _ in range(4))
    o, lse = attention.single_head_attention(q, k, v, return_lse=True)
    di = (do.float() * o.float()).sum(-1)
    got = attention.attention_backward(q, k, v, o, lse, do)
    want = attention._attention_backward_reference(q, k, v, do, lse, di)
    torch.cuda.synchronize()
    err = max(rms_close(f"attention backward {q.shape} {dtype} {n}", gt, w, ATTN_REL_TOL[dtype])
              for n, gt, w in zip(("dq", "dk", "dv"), got, want))
    q4, k4, v4 = (t[:, None].detach().requires_grad_(True) for t in (q, k, v))
    do4 = do[:, None]

    def lib_fwd():
        return F.scaled_dot_product_attention(q4, k4, v4)

    def lib_fwd_bwd():
        torch.autograd.grad(lib_fwd(), (q4, k4, v4), do4)

    flops = 10 * b * l * l * c  # five L x L x C products
    nbytes = 7 * q.numel() * q.element_size() + 2 * b * l * 4  # q k v dO in, dq dk dv out
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / HBM_BYTES_PER_S
    return {
        "name": "attention_bwd", "shape": [b, l, c], "dtype": str(dtype).split(".")[1],
        "max_err": err,
        "kernel_ms": time_ms(lambda: attention._attention_backward_cuda(q, k, v, do, lse, di)),
        "plain_ms": time_ms(
            lambda: attention._attention_backward_reference(q, k, v, do, lse, di), 3),
        "library_ms": time_ms(lib_fwd_bwd) - time_ms(lib_fwd),
        "bound_ms": max(t_ops, t_bytes) * 1e3,
        "bound_by": "operations" if t_ops > t_bytes else "bytes",
    }


def phase_kernels(gn_train: Counter, attn_train: Counter) -> dict:
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
        for hw, c in sorted({(hw, c) for hw, c, _ in gn_train}, reverse=True):
            for act in ("silu", None):
                r = gn_bwd_case(g, hw, c, act, dtype)
                cases[("group_norm_bwd", hw, c, act, dtype)] = r
                emit(r)
                torch.cuda.empty_cache()
        for l, c in sorted(attn_train, reverse=True):
            r = attn_bwd_case(g, l, c, dtype)
            cases[("attention_bwd", l, c, dtype)] = r
            emit(r)
            torch.cuda.empty_cache()
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


def train_batch(b: int, size: int, device, seed: int) -> dict:
    """A synthetic prepared batch (the contract of ``prepare_batch``), made on
    ``device`` from ``seed``."""
    g = torch.Generator(device=device).manual_seed(seed)

    def rand(*shape):
        return torch.rand(shape, generator=g, device=device)

    mask = torch.zeros(b, size, size, 1, device=device)
    mask[:, size // 16 : -size // 16, size // 8 : -size // 8] = 1.0
    cls = torch.randint(0, 11, (b,), generator=g, device=device)
    return {
        "rgb_gt": rand(b, size, size, 3) * 2 - 1, "pose_gt": rand(b, 4) * 2 - 1,
        "class_gt": cls, "class_orig_id": cls, "bbox_gt": rand(b, 3) * 3 + 1,
        "fill_factor_gt": rand(b), "mask_2d_bbox": mask,
    }


def flagship_train():
    """The flagship model, a seeded fp32 train state on the card past the
    curriculum, and its bf16 train step (shared discriminator forward,
    optimizer step counting)."""
    model = instantiate_from_config(merge_configs([str(FLAGSHIP)])["model"])
    lr = TRAIN_BATCH * 4.5e-6  # base_learning_rate scaled by batch, as ldm does
    state = create_train_state(model, lr, grad_clip=1.0, seed=0, device="cuda")
    state.step = CURRICULUM_END // 2 + 1
    step = make_train_step(model, phase="full", disc_forward="shared",
                           step_counting="optimizer", compute_dtype=torch.bfloat16)
    return model, state, step


def reset_counts() -> None:
    norm.group_norm.launches = norm.group_norm_backward.launches = 0
    norm.group_norm_backward.grad_copies = 0
    attention.single_head_attention.launches = attention.attention_backward.launches = 0
    attention.attention_backward.grad_copies = 0


def read_counts() -> dict:
    return {"group_norm": norm.group_norm.launches,
            "group_norm_bwd": norm.group_norm_backward.launches,
            "attention": attention.single_head_attention.launches,
            "attention_bwd": attention.attention_backward.launches,
            "grad_copies": norm.group_norm_backward.grad_copies
            + attention.attention_backward.grad_copies}


def phase_train(gn_train: Counter, attn_train: Counter) -> dict:
    model, state, step = flagship_train()
    batch = train_batch(TRAIN_BATCH, model.input_size, "cuda", 1)
    lpips0 = [p.detach().clone() for p in state.loss.perceptual_loss.parameters()]
    disc0 = [p.detach().clone() for p in state.loss.discriminator.parameters()]
    logvar0 = state.loss.logvar.item()
    for _ in range(TRAIN_WARMUP):
        state, metrics = step(state, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    lat = []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t0)
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()

    per_step = {"group_norm": sum(gn_train.values()), "attention": sum(attn_train.values())}
    per_step.update(group_norm_bwd=per_step["group_norm"], attention_bwd=per_step["attention"])
    for name, n in per_step.items():
        require(counts[name] == n * TRAIN_STEPS,
                f"train {name} launches {counts[name]} != {n} x {TRAIN_STEPS}")
    values = {k: float(metrics[k]) for k in ("aeloss", "discloss", "train/d_weight",
                                             "train/disc_factor", "train/rec_loss",
                                             "train/g_loss", "train/kl_loss_obj")}
    require(all(np.isfinite(v) for v in values.values()), f"train losses not finite: {values}")
    require(values["train/d_weight"] > 0.0, f"train/d_weight is {values['train/d_weight']}")
    # the last step's (clipped) gradients: every network parameter has one,
    # finite and nonzero; none is legitimately zero in the 'full' phase
    params = list(state.net.named_parameters())
    zero = [n for n, p in params if p.grad is None or not bool(p.grad.abs().sum() > 0)]
    bad = [n for n, p in params if p.grad is not None and not bool(torch.isfinite(p.grad).all())]
    require(not zero and not bad, f"parameters without a finite nonzero gradient: {zero + bad}")
    require(all(torch.equal(a, b) for a, b in zip(lpips0, state.loss.perceptual_loss.parameters())),
            "LPIPS weights changed")
    require(state.loss.logvar.item() == logvar0, "logvar changed")
    require(any(not torch.equal(a, b) for a, b in zip(disc0, state.loss.discriminator.parameters())),
            "discriminator weights did not change")
    p50 = statistics.median(lat)
    result = {
        "phase": "train", "config": FLAGSHIP.name, "batch": TRAIN_BATCH, "dtype": "bfloat16",
        "master_weights": "float32", "global_step_g": 2 * (state.step - 1), "steps": TRAIN_STEPS,
        "p50_ms": p50 * 1e3, "min_ms": min(lat) * 1e3, "max_ms": max(lat) * 1e3,
        "train_patches_per_s": TRAIN_BATCH / p50, "max_memory_allocated_bytes": peak,
        "launches_per_step": {k: v / TRAIN_STEPS for k, v in counts.items()},
        "sites_per_step": per_step, "params_with_grad": len(params), "losses": values,
    }
    emit(result)
    return {**counts, "result": result}


def phase_train_card_vs_cpu() -> None:
    """One fp32 step of tiny_cpu.yaml at ch 128 (attention at C = 256, a
    kernel width) from the same weights and draws on the card and the CPU."""
    cfg = merge_configs([str(TINY)], ["model.params.ddconfig.ch=128"])
    model = instantiate_from_config(cfg["model"])
    rng = np.random.default_rng(5)
    host = model.example_batch(2)
    host[model.image_rgb_key] = rng.uniform(0, 1, size=(2, 32, 32, 3)).astype(np.float32)
    host[model.pose_key] = rng.normal(size=(2, 4)).astype(np.float32)
    host[model.class_key] = host["original_class_id"] = np.array([0, 3], np.int32)
    host[model.bbox_key] = rng.uniform(1, 4, size=(2, 3)).astype(np.float32)
    host[model.fill_factor_key] = rng.uniform(0.2, 0.8, size=2).astype(np.float32)
    draws = {k: rng.standard_normal(size=s).astype(np.float32) for k, s in
             (("posterior", (2, 16, 16, 16)), ("noise", (2, 16, 16, 16)), ("bbox", (2, 8)))}
    draws["dropout"] = rng.uniform(size=(2, 16, 16, 16)).astype(np.float32)
    step = make_train_step(model, phase="full", compute_dtype=torch.float32)
    out = {}
    for device in ("cuda", "cpu"):
        state = create_train_state(model, 1e-4, grad_clip=1.0, seed=0, device=device)
        state.step = 6  # generator step 12, past this config's 10-step curriculum
        state, metrics = step(state, model.prepare_batch(host, device=device),
                              {k: torch.as_tensor(v, device=device) for k, v in draws.items()})
        moments = [torch.cat([opt.moments(p)[0].flatten().cpu() for p in opt.params])
                   for opt in (state.opt_ae, state.opt_disc)]
        out[device] = ({k: float(metrics[k]) for k in ("aeloss", "discloss", "train/d_weight")},
                       moments)
    (got, got_m), (want, want_m) = out["cuda"], out["cpu"]
    for k, w in want.items():
        require(abs(got[k] - w) <= TRAIN_LOSS_RTOL * abs(w), f"card vs CPU {k}: {got[k]} vs {w}")
    errs = []
    for name, g_m, w_m in zip(("opt_ae", "opt_disc"), got_m, want_m):
        err = (g_m - w_m).abs().max().item()
        require(err <= MOMENT_REL * w_m.abs().max().item(),
                f"card vs CPU {name} Adam mu: max err {err}, scale {w_m.abs().max().item()}")
        errs.append(err)
    emit({"phase": "train_fp32_card_vs_cpu", "config": "tiny_cpu.yaml ch=128", "batch": 2,
          "card": got, "cpu": want, "mu_max_abs_err": dict(zip(("opt_ae", "opt_disc"), errs))})


def kernels_line(cases: dict, launches: dict, train: dict) -> dict:
    """One entry per kernel, with the numbers of its largest bf16 site: batch
    8 for the forward kernels, whose launches are the detector path's; batch
    16 for the backward kernels, whose launches are the train path's.
    ``kernels_per_call`` device kernels run per counted call."""
    bf16 = torch.bfloat16
    gn_bwd_key = max((k for k in cases if k[0] == "group_norm_bwd" and k[-1] == bf16),
                     key=lambda k: (k[1] * k[1] * k[2], k[3] == "silu"))
    at_bwd_key = max((k for k in cases if k[0] == "attention_bwd" and k[-1] == bf16),
                     key=lambda k: k[1] * k[1] * k[2])
    entries = []
    for r, source, replaces, per_call, n in (
        (cases[("group_norm", 256, 128, "silu", bf16)],
         "generative_detection_tpu_torch/csrc/group_norm.cu",
         "generative_detection_tpu/ops/norm.py:109,361,388", 2, launches["group_norm"]),
        (cases[("attention", 4096, 256, bf16)],
         "generative_detection_tpu_torch/csrc/attention.cu",
         "generative_detection_tpu/ops/attention.py:226", 1, launches["attention"]),
        (cases[gn_bwd_key], "generative_detection_tpu_torch/csrc/group_norm_bwd.cu",
         "generative_detection_tpu/ops/norm.py:448,473", 2, train["group_norm_bwd"]),
        (cases[at_bwd_key], "generative_detection_tpu_torch/csrc/attention_bwd.cu",
         "generative_detection_tpu/ops/attention.py:251", 2, train["attention_bwd"]),
    ):
        entries.append({
            "name": r["name"], "route": "cuda", "source": source, "replaces": replaces,
            "launches": n, "max_abs_err": r["max_err"],
            "ms": r["kernel_ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "shape": r["shape"], "dtype": r["dtype"], "kernels_per_call": per_call,
        })
    return {"kernels": entries}


def main() -> int:
    name, smi = phase_device()
    phase_build()
    gn_train, attn_train = train_sites()
    emit({"phase": "train_sites", "group_norm": sum(gn_train.values()),
          "attention": sum(attn_train.values()),
          "group_norm_shapes": sorted([list(k) + [n] for k, n in gn_train.items()], key=str),
          "attention_shapes": sorted([list(k) + [n] for k, n in attn_train.items()])})
    cases = phase_kernels(gn_train, attn_train)
    launches = phase_detector()
    train = phase_train(gn_train, attn_train)
    phase_train_card_vs_cpu()
    emit(kernels_line(cases, launches, train))
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
