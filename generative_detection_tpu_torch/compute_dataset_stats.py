"""Offline dataset statistics on the port's datasets (the root
``compute_dataset_stats.py`` of the JAX package, with its flags and
pickles)::

    python -m generative_detection_tpu_torch.compute_dataset_stats \\
        -b configs/autoencoder/pose/autoencoder_kl_16x16x16.yaml \\
        [--out dataset_stats] [--limit N]

Streams the train and validation patch datasets of the config's ``data``
node and accumulates per-class running means and variances of (t1, t2, t3,
v3, l, h, w, yaw, fill_factor). Writes ``<out>/combined/all.pkl``
({label: {key: (mean, logvar)}}, the pickle ``PoseLoss`` reads through
``dataset_stats_path``) and ``<out>/combined/raw_moments.pkl`` ({label:
{key: {mean, std, n}}}), from which ``compute_hmin_hmax`` derives the
``hmin.pkl`` and ``hmax.pkl`` that the nuScenes reader reads.
"""

from __future__ import annotations

import argparse
import logging
import math
import os
import pickle
from typing import Optional, Sequence

import numpy as np

KEYS = ["t1", "t2", "t3", "v3", "l", "h", "w", "yaw", "fill_factor"]


class RunningMoments:
    """Streaming mean and variance (Welford)."""

    def __init__(self):
        self.n = 0
        self.mean = 0.0
        self.m2 = 0.0

    def update(self, x: float):
        self.n += 1
        d = x - self.mean
        self.mean += d / self.n
        self.m2 += d * (x - self.mean)

    @property
    def var(self) -> float:
        return self.m2 / self.n if self.n > 1 else 1.0

    @property
    def logvar(self) -> float:
        return math.log(max(self.var, 1e-12))

    @property
    def std(self) -> float:
        return math.sqrt(max(self.var, 0.0))


def item_values(item) -> dict:
    pose = np.asarray(item["pose_6d"], np.float32).reshape(-1)
    l_h, h, w_h = np.asarray(item["bbox_sizes"], np.float32).reshape(-1)[:3]
    return {
        "t1": float(pose[0]),
        "t2": float(pose[1]),
        "t3": float(pose[2]),
        "v3": float(pose[3]),
        "l": float(l_h),
        "h": float(h),
        "w": float(w_h),
        "yaw": float(item["yaw"]),
        "fill_factor": float(item["fill_factor"]),
    }


def main(argv: Optional[Sequence[str]] = None) -> str:
    """Parse ``argv`` (default ``sys.argv[1:]``), write the pickles, return
    the directory they are in."""
    from .config import instantiate_from_config, merge_configs

    logging.basicConfig(level=logging.INFO)
    p = argparse.ArgumentParser(description="Per-class pose and box statistics of a dataset.")
    p.add_argument("-b", "--base", nargs="*", default=list())
    p.add_argument("--out", type=str, default="dataset_stats")
    p.add_argument("--limit", type=int, default=None, help="max items per split")
    opt, unknown = p.parse_known_args(argv)

    data_cfg = merge_configs(opt.base, unknown)["data"]["params"]
    stats: dict = {}
    for split in ("train", "validation"):
        if split not in data_cfg or data_cfg[split] is None:
            continue
        ds = instantiate_from_config(data_cfg[split])
        n = len(ds) if opt.limit is None else min(len(ds), opt.limit)
        logging.info("streaming %s (%d items)", split, n)
        for i in range(n):
            try:
                item = ds[i]
            except Exception as e:  # noqa: BLE001 - an unreadable item is skipped, as upstream
                logging.debug("skip %d: %s", i, e)
                continue
            label = item["class_name"]
            if label == "background":
                continue
            row = stats.setdefault(label, {k: RunningMoments() for k in KEYS})
            for k, v in item_values(item).items():
                row[k].update(v)
            if i % 1000 == 0 and i:
                logging.info("%s: %d/%d", split, i, n)

    outdir = os.path.join(opt.out, "combined")
    os.makedirs(outdir, exist_ok=True)
    combined = {label: {k: (m.mean, m.logvar) for k, m in row.items()}
                for label, row in stats.items()}
    with open(os.path.join(outdir, "all.pkl"), "wb") as f:
        pickle.dump(combined, f)
    raw = {label: {k: {"mean": m.mean, "std": m.std, "n": m.n} for k, m in row.items()}
           for label, row in stats.items()}
    with open(os.path.join(outdir, "raw_moments.pkl"), "wb") as f:
        pickle.dump(raw, f)
    logging.info("wrote %s (classes: %s)", outdir, sorted(combined))
    return outdir


if __name__ == "__main__":
    main()
