#!/usr/bin/env python3
"""Compare two checkouts of the PyTorch port on one card: the bf16 detector
(p50 and peak memory at batch 1, 8, 32), default and with
GDT_FUSE_INFERENCE=1, and the flagship bf16 train step (p50 at batch 16),
default and with GDT_WINOGRAD=fused, each tree in its own process, in the
order given. With ``--fp32`` also the flagship's fp32 path as its config
ships it (TF32 off for products and convolutions): the detector at batch 8
and 32 and the train step at batch 16 (5 timed steps after 3 warm-up), and
its two opt-in paths: the detector at batch 32 with GDT_FUSE_INFERENCE=1
and the step with GDT_WINOGRAD=fused, each with p50 and peak memory.

    python3 tools/ab_port_paths.py [--fp32] PARENT_TREE CHANGE_TREE CHANGE_TREE PARENT_TREE

A tree is a directory holding a checkout (e.g. from ``git archive``); its
``generative_detection_tpu_torch`` is imported and builds its own kernels.
Only the public entry points are used, so trees of different slices compare.
Each run prints one JSON line; the card's name and power limit come last.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

FLAGSHIP = "configs/autoencoder/pose/autoencoder_kl_16x16x16.yaml"


def _p50(fn, n: int, warmup: int = 3) -> float:
    import torch

    lat = []
    for i in range(n + warmup):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        if i >= warmup:
            lat.append(time.perf_counter() - t0)
    return statistics.median(lat) * 1e3


def _detector(make_detector_fn, model, net, dtype="bfloat16",
              batches=((1, 50), (8, 50), (32, 10))) -> dict:
    """p50 and peak memory of the detector in ``dtype`` at each (batch,
    requests) of ``batches``."""
    import numpy as np
    import torch

    hmin, hmax = np.full(11, 0.5, np.float32), np.full(11, 4.0, np.float32)
    detect = make_detector_fn(model, net, hmin, hmax, 256, dtype=dtype)
    out = {}
    rng = np.random.default_rng(0)
    for b, n in batches:
        args = [torch.as_tensor(a, device="cuda") for a in (
            rng.uniform(-1, 1, size=(b, 256, 256, 3)).astype(np.float32),
            np.full((b,), 1266.0, np.float32), np.tile(np.float32([800.0, 450.0]), (b, 1)),
            rng.uniform(60, 200, size=(b,)).astype(np.float32),
            np.tile(np.float32([820.0, 460.0]), (b, 1)),
            rng.uniform(1.5, 3.0, size=(b,)).astype(np.float32))]
        detect(*args)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        out[b] = {"p50_ms": _p50(lambda: detect(*args), n),
                  "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()}
    return out


def run_one(tree: str, fp32: bool) -> dict:
    tree = os.path.abspath(tree)
    os.chdir(tree)
    sys.path.insert(0, tree)
    import torch

    from generative_detection_tpu_torch.config import instantiate_from_config, merge_configs
    from generative_detection_tpu_torch.serving import make_detector_fn
    from generative_detection_tpu_torch.train import create_train_state, make_train_step

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device")
    model = instantiate_from_config(merge_configs([FLAGSHIP])["model"])
    net = model.init_net(torch.Generator().manual_seed(0), device="cuda")
    out = {"tree": tree, "detector": _detector(make_detector_fn, model, net)}
    os.environ["GDT_FUSE_INFERENCE"] = "1"  # read when the detector builds its net
    out["detector_fused"] = _detector(make_detector_fn, model, net)
    del os.environ["GDT_FUSE_INFERENCE"]
    del net
    torch.cuda.empty_cache()
    out.update(_train(model, create_train_state, make_train_step, torch.bfloat16, 10,
                      {"train": None, "train_winograd_fused": "fused"}))
    if fp32:  # the config's own dtype, after every bf16 path
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        net = model.init_net(torch.Generator().manual_seed(0), device="cuda")
        out["detector_fp32"] = _detector(make_detector_fn, model, net, "float32",
                                         ((8, 20), (32, 10)))
        os.environ["GDT_FUSE_INFERENCE"] = "1"
        out["detector_fused_fp32"] = _detector(make_detector_fn, model, net, "float32",
                                               ((32, 10),))
        del os.environ["GDT_FUSE_INFERENCE"]
        del net
        torch.cuda.empty_cache()
        out.update(_train(model, create_train_state, make_train_step, None, 5,
                          {"train_fp32": None, "train_winograd_fused_fp32": "fused"}))
    return out


def _train(model, create_train_state, make_train_step, dtype, n: int, runs: dict) -> dict:
    """p50 and peak memory of the flagship train step at batch 16 in
    ``dtype`` (None: the config's), one entry per ``runs`` label, each with
    its GDT_WINOGRAD value (None: unset), one state carried through them."""
    import torch

    b, size = 16, model.input_size
    state = create_train_state(model, b * 4.5e-6, grad_clip=1.0, seed=0, device="cuda")
    state.step = 60001  # past the flagship curriculum (optimizer step counting: 2 * step)
    step = make_train_step(model, phase="full", disc_forward="shared",
                           step_counting="optimizer", compute_dtype=dtype)
    g = torch.Generator(device="cuda").manual_seed(1)
    mask = torch.zeros(b, size, size, 1, device="cuda")
    mask[:, size // 16: -size // 16, size // 8: -size // 8] = 1.0
    cls = torch.randint(0, 11, (b,), generator=g, device="cuda")
    batch = {"rgb_gt": torch.rand(b, size, size, 3, generator=g, device="cuda") * 2 - 1,
             "pose_gt": torch.rand(b, 4, generator=g, device="cuda") * 2 - 1,
             "class_gt": cls, "class_orig_id": cls,
             "bbox_gt": torch.rand(b, 3, generator=g, device="cuda") * 3 + 1,
             "fill_factor_gt": torch.rand(b, generator=g, device="cuda"), "mask_2d_bbox": mask}
    holder = [state]

    def one_step():
        holder[0], _ = step(holder[0], batch)

    out = {}
    for label, winograd in runs.items():
        if winograd is not None:
            os.environ["GDT_WINOGRAD"] = winograd  # read per call by the port's blocks
        torch.cuda.reset_peak_memory_stats()
        out[label] = {"batch": b, "p50_ms": _p50(one_step, n),
                      "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()}
        os.environ.pop("GDT_WINOGRAD", None)
    return out


def main(argv) -> int:
    fp32 = "--fp32" in argv
    argv = [a for a in argv if a != "--fp32"]
    if len(argv) == 3 and argv[1] == "--one":
        print(json.dumps(run_one(argv[2], fp32)), flush=True)
        return 0
    if len(argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    for tree in argv[1:]:
        subprocess.run([sys.executable, os.path.abspath(__file__), "--one", tree]
                       + (["--fp32"] if fp32 else []), check=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
