"""Preflight check of a nuScenes data tree (``tools/validate_nuscenes.py``
of the JAX package, on the port's reader)::

    python -m generative_detection_tpu_torch.validate_nuscenes data/nuscenes \
        [--ann-file nuscenes_infos_train.pkl] [--check-images 8] [--items 24] \
        [--h-minmax-dir dataset_stats/combined] [--device-preprocess] [--patch-height 256]

1. load and schema-check the info pkl (``NuScenesBase._validate_infos``);
2. check that the image files of the first N samples exist (every camera);
3. check the h-min/max stats directory (a warning where the reader would use
   its defaults);
4. run M items through the whole per-item pipeline (crop, mask, pose labels),
   timed;
5. print a JSON report; exit 1 on any hard failure, else 0.
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import sys
import time

import numpy as np

DEFAULT_LABEL_NAMES = [
    "car", "truck", "trailer", "bus", "construction_vehicle", "bicycle",
    "motorcycle", "pedestrian", "traffic_cone", "barrier", "background",
]


def validate(
    data_root: str,
    ann_file: str = "nuscenes_infos_train.pkl",
    label_names=None,
    check_images: int = 8,
    items: int = 24,
    h_minmax_dir: str = "dataset_stats/combined",
    device_preprocess: bool = False,
    patch_height: int = 256,
) -> dict:
    """Run every preflight stage; returns a report dict with ``ok`` plus
    per-stage timings and failures. Never raises for data problems — those
    land in ``errors`` so the caller sees ALL of them at once."""
    from .data.nuscenes import CAMERA_NAMES, NuScenesBase

    label_names = list(label_names or DEFAULT_LABEL_NAMES)
    report: dict = {"data_root": data_root, "ann_file": ann_file,
                    "stages": {}, "errors": [], "warnings": []}

    # -- stage 1: pkl load + schema ------------------------------------------
    t0 = time.perf_counter()
    ann_path = os.path.join(data_root, ann_file)
    if not os.path.isfile(ann_path):
        report["errors"].append(f"info pkl not found: {ann_path}")
        report["ok"] = False
        return report
    with open(ann_path, "rb") as f:
        infos = pickle.load(f)
    t_load = time.perf_counter() - t0
    t0 = time.perf_counter()
    try:
        data_list = NuScenesBase._validate_infos(infos, ann_path)
    except (ValueError, KeyError) as e:
        report["errors"].append(f"schema validation failed: {e}")
        report["ok"] = False
        return report
    report["stages"]["pkl"] = {
        "load_s": round(t_load, 3),
        "validate_s": round(time.perf_counter() - t0, 3),
        "samples": len(data_list),
    }

    # -- stage 2: image paths (first N samples, every camera) ----------------
    t0 = time.perf_counter()
    img_root = os.path.join(data_root, "samples")
    n_checked = n_missing = 0
    missing: list = []
    for sample in data_list[: max(check_images, 0)]:
        for cam in CAMERA_NAMES:
            img_path = sample["images"].get(cam, {}).get("img_path")
            if img_path is None:
                continue
            # the reader resolves by basename under samples/<CAM>/ (the
            # info-pkl path prefix varies across mmdet3d converter versions)
            p = os.path.join(img_root, cam, os.path.basename(img_path))
            n_checked += 1
            if not os.path.isfile(p):
                n_missing += 1
                if len(missing) < 10:
                    missing.append(p)
    report["stages"]["images"] = {
        "checked": n_checked,
        "missing": n_missing,
        "first_missing": missing,
        "s": round(time.perf_counter() - t0, 3),
    }
    if n_checked == 0:
        report["errors"].append("no image paths found in the first samples")
    elif n_missing == n_checked:
        report["errors"].append(
            f"ALL {n_checked} checked image files are missing under {img_root} "
            "— wrong data_root, or the image blobs are not extracted"
        )
    elif n_missing:
        report["warnings"].append(f"{n_missing}/{n_checked} image files missing")

    # -- stage 3: h-min/max stats --------------------------------------------
    # resolved as the reader resolves it (relative to the working directory)
    if not (os.path.isfile(os.path.join(h_minmax_dir, "hmin.pkl"))
            and os.path.isfile(os.path.join(h_minmax_dir, "hmax.pkl"))):
        report["warnings"].append(
            f"h-min/max stats not found under '{h_minmax_dir}' — the reader "
            "falls back to defaults; run compute_dataset_stats + "
            "compute_hmin_hmax for faithful z normalization"
        )
    report["stages"]["h_minmax"] = {"dir": h_minmax_dir}

    # -- stage 4: dry-run items through the full per-item pipeline -----------
    t0 = time.perf_counter()
    try:
        ds = NuScenesBase(
            data_root=data_root,
            label_names=label_names,
            patch_height=patch_height,
            ann_file=ann_file,
            h_minmax_dir=h_minmax_dir,
            seed=0,
            device_preprocess=device_preprocess,
        )
    except Exception as e:  # noqa: BLE001 — report, don't crash
        report["errors"].append(f"dataset construction failed: {type(e).__name__}: {e}")
        report["ok"] = False
        return report
    t_construct = time.perf_counter() - t0

    item_times: list = []
    item_errors: list = []
    n_items = min(max(items, 0), len(ds))
    required = {"patch_raw", "bbox_in_crop"} if device_preprocess else {
        "patch", "mask_2d_bbox"}
    required |= {"pose_6d", "bbox_sizes", "fill_factor", "class_id", "yaw"}
    for i in range(n_items):
        t0 = time.perf_counter()
        try:
            item = ds[i]
            missing_keys = required - set(item)
            if missing_keys:
                item_errors.append(f"item {i}: missing keys {sorted(missing_keys)}")
                continue
            for k in ("pose_6d", "bbox_sizes", "fill_factor"):
                if not np.all(np.isfinite(np.asarray(item[k], np.float64))):
                    item_errors.append(f"item {i}: non-finite {k}")
        except Exception as e:  # noqa: BLE001
            item_errors.append(f"item {i}: {type(e).__name__}: {e}")
        finally:
            item_times.append(time.perf_counter() - t0)
    report["stages"]["items"] = {
        "construct_s": round(t_construct, 3),
        "ran": n_items,
        "failed": len(item_errors),
        "first_failures": item_errors[:10],
        "mean_ms": round(1e3 * float(np.mean(item_times)), 2) if item_times else None,
        "p90_ms": round(1e3 * float(np.quantile(item_times, 0.9)), 2)
        if item_times else None,
    }
    if item_errors:
        report["errors"].append(
            f"{len(item_errors)}/{n_items} dry-run items failed (see stages.items)"
        )

    report["ok"] = not report["errors"]
    return report


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("data_root")
    p.add_argument("--ann-file", default="nuscenes_infos_train.pkl")
    p.add_argument("--check-images", type=int, default=8)
    p.add_argument("--items", type=int, default=24)
    p.add_argument("--h-minmax-dir", default="dataset_stats/combined")
    p.add_argument("--device-preprocess", action="store_true")
    p.add_argument("--patch-height", type=int, default=256)
    opt = p.parse_args(argv)
    report = validate(
        opt.data_root,
        ann_file=opt.ann_file,
        check_images=opt.check_images,
        items=opt.items,
        h_minmax_dir=opt.h_minmax_dir,
        device_preprocess=opt.device_preprocess,
        patch_height=opt.patch_height,
    )
    print(json.dumps(report, indent=2))
    sys.exit(0 if report["ok"] else 1)


if __name__ == "__main__":
    main()
