#!/usr/bin/env python3
"""Ablations of the fp32 split-precision attention backward
(``attn_bwd_split_wgmma_kernel`` in csrc/attention_bwd.cu), on one card.

    python3 tools/ablate_attention_split_bwd.py [VARIANT ...]    # default: all

Each variant is the source with a few lines replaced, built from a copy of
the package in a temporary directory (the tree is not touched) and run in a
process of its own:

    as_is      the kernel as it is; also its error against the plain version
               (fp32, TF32 off) and against a float64 reference, per output,
               at (2, L, 256) for L = 256, 1024, 4096, at (1, 16384, 256) and
               with a peaked softmax (q and k scaled by 4) at (2, 4096, 256);
    no_stream  the producer copies the piece tiles of the first two steps
               only and then lets the ring run on what is in shared memory:
               the kernel's time without the stream from L2 and the waits on
               it (its output is wrong, its error is printed but not held);
    dk_only, dq_only, dv_only
               the launch runs the blocks of one role only: each role's time
               (dK: dP^T, S^T and dK, 11 piece tiles a step; dQ the same
               shape; dV: S^T and dV, 6 piece tiles a step);
    s_two_chains, acc_one_chain, both_merged
               fewer drained wgmma chains: dK and dQ's first two S chains as
               one, each role's three last-product chains as one (their
               tiles then go back together, at its end), or both.

For each: what ptxas says of the C = 256 kernel (registers, spills, wgmma
serialization), the backward's time at (16, 4096, 256) in fp32 (mean of 10
calls after a warm-up, CUDA events), the profiler's split into the pre-pass
and the kernel, and max |err| / RMS of the plain output. One JSON line per
variant; the card's name and power limit come last.
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
SHAPE = (16, 4096, 256)
ERROR_CASES = (((2, 256, 256), 1.0), ((2, 1024, 256), 1.0), ((2, 4096, 256), 1.0),
               ((1, 16384, 256), 1.0), ((2, 4096, 256), 4.0))
_LOAD = ("          mbar_expect_tx(&full[s], TILE);\n"
         "          load_tile<C>(ring + s * TILE, tm, &full[s], (op * NP + p) * BL + r);")
_ROLES = ("return go(attn_bwd_split_wgmma_kernel<C>, 3);", "if (blockIdx.z == DK) {",
          "} else if (blockIdx.z == DQ) {")


def _role_only(role: int) -> list:
    return [(_ROLES[0], "return go(attn_bwd_split_wgmma_kernel<C>, 1);"),
            (_ROLES[1], f"if (blockIdx.z + {role} == DK) {{"),
            (_ROLES[2], f"}} else if (blockIdx.z + {role} == DQ) {{")]


# Fewer drained chains: dK and dQ's first two S chains as one; every role's
# three last-product chains as one (its tiles freed together at its end).
_S_CHAINS = ("""      mbar_wait(&full[n % STAGES], (n / STAGES) & 1);
      wgmma_fence();
      mma_ss<C>(sc, dres, slot(n), true);  // (0, 2)
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
#pragma unroll
      for (int i = 1; i < 3; ++i) mbar_wait(&full[(n + i) % STAGES], ((n + i) / STAGES) & 1);
      fence_regs(sc);
      wgmma_fence();
""", """#pragma unroll
      for (int i = 0; i < 3; ++i) mbar_wait(&full[(n + i) % STAGES], ((n + i) / STAGES) & 1);
      wgmma_fence();
      mma_ss<C>(sc, dres, slot(n), true);  // (0, 2)
""")
_ACC_CHAINS = ("""#pragma unroll
    for (int q = 0; q < NP; ++q) {
      const int item = ROLE == DV ? n + q : t0 + 2 * q, s = item % STAGES;
      if (ROLE == DV) mbar_wait(&full[s], (item / STAGES) & 1);
      fence_regs(acc);
      fence_regs(pa);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BR / 16; ++kk)
#pragma unroll
        for (int i = q; i >= 0; --i)
          wgmma_rs_mn<C>(acc, pa[i][kk], dring_mn + ((s * TILE + kk * 16 * 128) >> 4));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }
""", """#pragma unroll
    for (int q = 0; q < NP; ++q) {
      const int item = ROLE == DV ? n + q : t0 + 2 * q;
      if (ROLE == DV) mbar_wait(&full[item % STAGES], (item / STAGES) & 1);
    }
    fence_regs(acc);
    fence_regs(pa);
    wgmma_fence();
#pragma unroll
    for (int q = 0; q < NP; ++q) {
      const int s = (ROLE == DV ? n + q : t0 + 2 * q) % STAGES;
#pragma unroll
      for (int kk = 0; kk < BR / 16; ++kk)
#pragma unroll
        for (int i = q; i >= 0; --i)
          wgmma_rs_mn<C>(acc, pa[i][kk], dring_mn + ((s * TILE + kk * 16 * 128) >> 4));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    __syncwarp();
    if (lane == 0)
      for (int q = 0; q < NP; ++q) mbar_arrive(&empty[(ROLE == DV ? n + q : t0 + 2 * q) % STAGES]);
""")

VARIANTS = {
    "as_is": [],
    "no_stream": [(_LOAD, "          mbar_expect_tx(&full[s], it < 2 ? TILE : 0);\n"
                          "          if (it < 2)\n"
                          "            load_tile<C>(ring + s * TILE, tm, &full[s], "
                          "(op * NP + p) * BL + r);")],
    "dk_only": _role_only(0),
    "dq_only": _role_only(1),
    "dv_only": _role_only(2),
    "s_two_chains": [_S_CHAINS],
    "acc_one_chain": [_ACC_CHAINS],
    "both_merged": [_S_CHAINS, _ACC_CHAINS],
}


def _rel(got, want) -> float:
    want = want.double()
    return ((got.double() - want).abs().max() / want.pow(2).mean().sqrt()).item()


def _reference64(q, k, v, do):
    """(dq, dk, dv) in float64 from float64 copies of the inputs."""
    import torch

    q, k, v, do = (t.double() for t in (q, k, v, do))
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("blc,bmc->blm", q, k) * scale
    p = torch.softmax(s, -1)
    di = (do * (p @ v)).sum(-1)
    ds = p * (torch.einsum("blc,bmc->blm", do, v) - di[..., None]) * scale
    return (torch.einsum("blm,bmc->blc", ds, k), torch.einsum("blm,blc->bmc", ds, q),
            torch.einsum("blm,blc->bmc", p, do))


def errors(attention, g) -> list:
    """max |err| / RMS per output (dq, dk, dv) against the fp32 plain version
    and against float64, at ERROR_CASES."""
    import torch

    rows = []
    for shape, peak in ERROR_CASES:
        q, k = (peak * torch.randn(shape, device="cuda", generator=g) for _ in range(2))
        v, do = (torch.randn(shape, device="cuda", generator=g) for _ in range(2))
        o, lse = attention.single_head_attention(q, k, v, return_lse=True)
        args = (q, k, v, do, lse, (do * o).sum(-1))
        got = attention._attention_backward_cuda(*args)
        plain = attention._attention_backward_reference(*args)
        exact = _reference64(q, k, v, do)
        rows.append({"shape": list(shape), "qk_scale": peak,
                     "vs_plain": [_rel(a, b) for a, b in zip(got, plain)],
                     "vs_float64": [_rel(a, b) for a, b in zip(got, exact)],
                     "plain_vs_float64": [_rel(a, b) for a, b in zip(plain, exact)]})
        del q, k, v, do, o, got, plain, exact
        torch.cuda.empty_cache()
    return rows


def measure(with_errors: bool) -> dict:
    """In the variant's process: build, then time and check the backward."""
    import torch
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
        if kernel and "split_wgmma_kernelILi256" in kernel and ("spill" in ln or "Used" in ln):
            ptxas.append(ln.strip())
        if "(C7520" in ln and "split_wgmma" in ln:
            ptxas.append("wgmma serialized")
    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, do = (torch.randn(SHAPE, device="cuda", generator=g) for _ in range(4))
    o, lse = attention.single_head_attention(q, k, v, return_lse=True)
    args = (q, k, v, do, lse, (do * o).sum(-1))

    def bwd():
        return attention._attention_backward_cuda(*args)

    got = bwd()
    want = attention._attention_backward_reference(*args)
    err = max(_rel(a, b) for a, b in zip(got, want))
    del got, want
    torch.cuda.empty_cache()
    bwd()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(10):
        bwd()
    end.record()
    end.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            bwd()
        torch.cuda.synchronize()
    split = {}
    for e in prof.key_averages():
        name = re.search(r"attn_\w+", e.key)
        if name:
            split[name.group(0)] = e.device_time_total / e.count / 1e3
    out = {"shape": list(SHAPE), "ms": start.elapsed_time(end) / 10, "kernel_ms": split,
           "max_err_rel_rms": err, "ptxas_c256": ptxas}
    if with_errors:
        del q, k, v, do, o, args
        torch.cuda.empty_cache()
        out["errors"] = errors(attention, g)
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
        flag = "--measure-errors" if name == "as_is" else "--measure"
        out = subprocess.run([sys.executable, __file__, flag], cwd=tmp, check=True,
                             capture_output=True, text=True,
                             env={**os.environ, "PYTHONPATH": tmp}).stdout
    return {"variant": name, **json.loads(out.strip().splitlines()[-1])}


def main(argv) -> int:
    if argv[1:] in (["--measure"], ["--measure-errors"]):
        print(json.dumps(measure(argv[1] == "--measure-errors")), flush=True)
        return 0
    for name in argv[1:] or list(VARIANTS):
        print(json.dumps(run_variant(name)), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
