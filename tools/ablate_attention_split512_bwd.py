#!/usr/bin/env python3
"""Variants of the fp32 split-precision attention backward at C = 512
(``attn_bwd_split512_wgmma_kernel`` in csrc/attention_bwd.cu), on one card.

    python3 tools/ablate_attention_split512_bwd.py [VARIANT ...]    # default: all

Each variant is the source with a few lines replaced, built from a copy of
the package in a temporary directory (the tree is not touched) and run in a
process of its own:

    as_is        the kernel as it is: X = dP (or dP^T) and S each in one
                 accumulator, both column blocks' small piece products
                 before either leading (0, 0) product (the first block's
                 0-pieces streamed twice);
    x_one_pass   X without that: the first column block's (0, 0) in its own
                 chain, its 0-pieces streamed once (two tiles a step fewer);
    no_stream    the producer copies the piece tiles of the first step only
                 and then lets the ring run on what is in shared memory: the
                 kernel's time without the stream from L2 and the waits on it
                 (its output is wrong; its error is printed, not held);
    s_merge_ab, s_merge_cd, s_merge_both
                 fewer drained S chains: (0,2) with (1,1) (0,1), and (1,0)
                 with (2,0) (0,0), or both.

For each: what ptxas says of the kernel (registers, spills, wgmma
serialization); the backward's time at (16, 256, 512) (mean of 20 calls
after a warm-up, CUDA events) beside fp32 SDPA's backward in the same
process (its forward and backward less its forward, TF32 off); the
profiler's split into the pre-pass and the kernel; whether a repeat gives
the same bits; and max |err| / RMS per output (dq, dk, dv) against the fp32
plain version and against a float64 reference, at (16, 256, 512) and (2,
256, 512), each also with a peaked softmax (q and k scaled by 4). One JSON
line per variant; the card's name and power limit come last.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
PACKAGE = "generative_detection_tpu_torch"
SOURCE = "csrc/attention_bwd.cu"
SHAPE = (16, 256, 512)
ERROR_CASES = (((16, 256, 512), 1.0), ((2, 256, 512), 1.0), ((16, 256, 512), 4.0),
               ((2, 256, 512), 4.0))

_S_AB = ("""      wait(n + 1);
      if (ci) fence_regs(sc);
      wgmma_fence();
      mma_ss<W>(sc, r0, slot(n + 1), ci == 0);  // (0, 2)
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      wait(n);
      wait(n + 2);
      fence_regs(sc);
      wgmma_fence();
""", """      wait(n + 1);
      wait(n);
      wait(n + 2);
      if (ci) fence_regs(sc);
      wgmma_fence();
      mma_ss<W>(sc, r0, slot(n + 1), ci == 0);  // (0, 2)
""")
_S_CD = ("""      wait(n + 3);
      fence_regs(sc);
      wgmma_fence();
      mma_ss<W>(sc, slot(n), slot(n + 3), false);  // (1, 0)
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      __syncwarp();
      if (lane == 0) free_slot(n);  // R1
      wait(n + 4);
      fence_regs(sc);
      wgmma_fence();
""", """      wait(n + 3);
      wait(n + 4);
      fence_regs(sc);
      wgmma_fence();
      mma_ss<W>(sc, slot(n), slot(n + 3), false);  // (1, 0)
""")
_S_CD_FREE = ("""        free_slot(n + 4);  // R2""", """        free_slot(n);  // R1
        free_slot(n + 4);  // R2""")

VARIANTS = {
    "as_is": [],
    "x_one_pass": [
        ("  constexpr int X_ITEMS = ROLE == DV ? 0 : 6 * CB + 2;",
         "  constexpr int X_ITEMS = ROLE == DV ? 0 : 6 * CB;"),
        ("        if (ci == CB - 1) mma_ss<W>(xp, slot(n + 2), slot(n + 3), false);  // (0, 0)",
         "        mma_ss<W>(xp, slot(n + 2), slot(n + 3), false);  // (0, 0)"),
        ("""      // items n, n + 1: XA0' XB0', the first column block's (0, 0)
      wait(n);
      wait(n + 1);
      fence_regs(xp);
      wgmma_fence();
      mma_ss<W>(xp, slot(n), slot(n + 1), false);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(xp);
      __syncwarp();
      if (lane == 0) {
        free_slot(n);
        free_slot(n + 1);
      }
      n += 2;
""", ""),
    ],
    "no_stream": [(
        """          mbar_expect_tx(&full[s], TILE);
          load_tile<W>(ring + s * TILE, tm, &full[s], (op * NP + p) * BL + r, c * W);""",
        """          mbar_expect_tx(&full[s], it < 1 ? TILE : 0);
          if (it < 1) load_tile<W>(ring + s * TILE, tm, &full[s], (op * NP + p) * BL + r, c * W);""")],
    "s_merge_ab": [_S_AB],
    "s_merge_cd": [_S_CD, _S_CD_FREE],
    "s_merge_both": [_S_AB, _S_CD, _S_CD_FREE],
}


def _rel(got, want) -> float:
    want = want.double()
    return ((got.double() - want).abs().max() / want.pow(2).mean().sqrt()).item()


def _reference64(q, k, v, do):
    """(dq, dk, dv) in float64 from float64 copies of the inputs."""
    import torch

    q, k, v, do = (t.double() for t in (q, k, v, do))
    scale = q.shape[-1] ** -0.5
    p = torch.softmax(torch.einsum("blc,bmc->blm", q, k) * scale, -1)
    di = (do * (p @ v)).sum(-1)
    ds = p * (torch.einsum("blc,bmc->blm", do, v) - di[..., None]) * scale
    return (torch.einsum("blm,bmc->blc", ds, k), torch.einsum("blm,blc->bmc", ds, q),
            torch.einsum("blm,blc->bmc", p, do))


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


def measure() -> dict:
    """In the variant's process: build, then time and check the backward."""
    import torch
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile

    from generative_detection_tpu_torch.ops import _build, attention

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build(["attention", "attention_bwd"])
    ptxas, kernel = [], None
    for ln in _build.build_log("attention_bwd").splitlines():
        if "Function properties for" in ln:
            kernel = ln.split("for")[-1].strip()
        if kernel and "split512" in kernel and ("spill" in ln or "Used" in ln):
            ptxas.append(ln.strip())
        if "(C75" in ln and "split512" in ln:
            ptxas.append("wgmma serialized")
    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, do = (torch.randn(SHAPE, device="cuda", generator=g) for _ in range(4))
    o, lse = attention.single_head_attention(q, k, v, return_lse=True)
    args = (q, k, v, do, lse, (do * o).sum(-1))

    def bwd():
        return attention._attention_backward_cuda(*args)

    q4, k4, v4 = (t[:, None].detach().requires_grad_(True) for t in (q, k, v))

    def sdpa():
        return F.scaled_dot_product_attention(q4, k4, v4)

    def sdpa_fwd_bwd():
        torch.autograd.grad(sdpa(), (q4, k4, v4), do[:, None])

    out = {"shape": list(SHAPE), "ms": _time_ms(bwd),
           "sdpa_fp32_bwd_ms": _time_ms(sdpa_fwd_bwd) - _time_ms(sdpa),
           "repeat_equal": all(torch.equal(a, b) for a, b in zip(bwd(), bwd())),
           "ptxas": ptxas}
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            bwd()
        torch.cuda.synchronize()
    out["kernel_ms"] = {re.search(r"attn_\w+", e.key).group(0): e.device_time_total / e.count / 1e3
                        for e in prof.key_averages() if re.search(r"attn_\w+", e.key)}
    out["errors"] = []
    for shape, peak in ERROR_CASES:
        q, k = (peak * torch.randn(shape, device="cuda", generator=g) for _ in range(2))
        v, do = (torch.randn(shape, device="cuda", generator=g) for _ in range(2))
        o, lse = attention.single_head_attention(q, k, v, return_lse=True)
        args = (q, k, v, do, lse, (do * o).sum(-1))
        got = attention._attention_backward_cuda(*args)
        plain = attention._attention_backward_reference(*args)
        exact = _reference64(q, k, v, do)
        out["errors"].append({"shape": list(shape), "qk_scale": peak,
                              "vs_plain": [_rel(a, b) for a, b in zip(got, plain)],
                              "vs_float64": [_rel(a, b) for a, b in zip(got, exact)],
                              "plain_vs_float64": [_rel(a, b) for a, b in zip(plain, exact)]})
    return out


def run_variant(name: str) -> dict:
    src = (REPO / PACKAGE / SOURCE).read_text()
    for old, new in VARIANTS[name]:
        if src.count(old) != 1:
            raise RuntimeError(f"variant {name}: the source no longer holds {old!r}")
        src = src.replace(old, new)
    with tempfile.TemporaryDirectory() as tmp:
        shutil.copytree(REPO / PACKAGE, Path(tmp) / PACKAGE,
                        ignore=shutil.ignore_patterns("__pycache__"))
        (Path(tmp) / PACKAGE / SOURCE).write_text(src)
        out = subprocess.run([sys.executable, __file__, "--measure"], cwd=tmp, check=True,
                             capture_output=True, text=True,
                             env={**os.environ, "PYTHONPATH": tmp}).stdout
    return {"variant": name, **json.loads(out.strip().splitlines()[-1])}


def main(argv) -> int:
    if argv[1:] == ["--measure"]:
        print(json.dumps(measure()), flush=True)
        return 0
    for name in argv[1:] or list(VARIANTS):
        print(json.dumps(run_variant(name)), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
