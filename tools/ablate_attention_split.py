#!/usr/bin/env python3
"""Ablations of the fp32 split-precision attention forward
(``attn_fwd_split_wgmma_kernel`` in csrc/attention.cu), on one card.

    python3 tools/ablate_attention_split.py [VARIANT ...]    # default: all

Each variant is the source with a few lines replaced, built from a copy of
the package in a temporary directory (the tree is not touched) and run in a
process of its own:

    as_is        the kernel as it is;
    no_kv_loads  the producer copies only the first two key tiles' K and V
                 pieces and then lets the ring run on what is in shared
                 memory: the kernel's time without the stream from L2
                 (its output is wrong, its error is printed but not held);
    bk32         32-key tiles and an eight-slot ring (16 KB a slot) instead
                 of 64-key tiles and four slots.

For each: what ptxas says of the C = 256 kernel (registers, spills, wgmma
serialization), the forward's time at (8, 4096, 256) in fp32 (mean of 20
calls after a warm-up, CUDA events; TF32 off), the profiler's split into
the pre-pass and the kernel, and max |err| / RMS of the plain output. One
JSON line per variant; the card's name and power limit come last.
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
SOURCE = "csrc/attention.cu"
SHAPE = (8, 4096, 256)
VARIANTS = {
    "as_is": [],
    "no_kv_loads": [(
        "            mbar_expect_tx(&full[s], TILE_BYTES);\n"
        "            for (int ch = 0; ch < CHUNKS; ++ch)",
        "            mbar_expect_tx(&full[s], it < 2 ? TILE_BYTES : 0);\n"
        "            for (int ch = 0; ch < (it < 2 ? CHUNKS : 0); ++ch)",
    )],
    "bk32": [("BQ = 64, BK = 64, STAGES = 4", "BQ = 64, BK = 32, STAGES = 8")],
}


def measure() -> dict:
    """In the variant's process: build, then time and check the forward."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from generative_detection_tpu_torch.ops import _build, attention

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build(["attention"])
    ptxas, kernel = [], None
    for ln in _build.build_log("attention").splitlines():
        if "Function properties for" in ln:
            kernel = ln.split("for")[-1].strip()
        if kernel and "split_wgmma_kernelILi256" in kernel and ("spill" in ln or "Used" in ln):
            ptxas.append(ln.strip())
        if "(C7520" in ln and "split_wgmma" in ln:
            ptxas.append("wgmma serialized")
    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(SHAPE, device="cuda", generator=g) for _ in range(3))

    def fwd():
        return attention.flash_attention_forward(q, k, v)

    o = fwd()
    want = attention._flash_reference(q, k, v)
    err = ((o - want).abs().max() / want.pow(2).mean().sqrt()).item()
    fwd()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(20):
        fwd()
    end.record()
    end.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            fwd()
        torch.cuda.synchronize()
    split = {}
    for e in prof.key_averages():
        name = re.search(r"attn_\w+", e.key)
        if name:
            split[name.group(0)] = e.device_time_total / e.count / 1e3
    return {"shape": list(SHAPE), "ms": start.elapsed_time(end) / 20, "kernel_ms": split,
            "max_err_rel_rms": err, "ptxas_c256": ptxas}


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
