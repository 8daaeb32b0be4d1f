"""Reconstruction and per-patch detection metrics (``eval/metrics.py`` of
the JAX package; numpy).

Detection follows nuScenes conventions: centre-distance thresholds {0.5, 1,
2, 4} m, mean translation, size and orientation errors, and class accuracy.
Matching is 1:1 per patch: each patch has one ground truth and one
prediction, so ``match@Xm`` is the share of patches whose predicted centre
lies within X metres of its own ground truth. The set-based frame-level
evaluation is ``eval/detection.py``.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def psnr(a: np.ndarray, b: np.ndarray, data_range: float = 2.0) -> float:
    """PSNR between image batches in [-1, 1] (data_range 2.0)."""
    mse = float(np.mean((np.asarray(a) - np.asarray(b)) ** 2))
    if mse == 0:
        return float("inf")
    return float(10.0 * np.log10(data_range**2 / mse))


def _yaw_diff(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    d = np.abs(a - b) % (2 * np.pi)
    return np.minimum(d, 2 * np.pi - d)


def detection_metrics(
    pred_boxes: np.ndarray,  # (N, 7) [x,y,z,l,h,w,yaw]
    pred_class: np.ndarray,  # (N,)
    gt_boxes: np.ndarray,  # (N, 7)
    gt_class: np.ndarray,  # (N,)
    foreground: np.ndarray,  # (N,) bool: rows with a real object
) -> Dict[str, float]:
    fg = np.asarray(foreground, bool)
    out: Dict[str, float] = {"num_eval": int(fg.sum())}
    out["class_accuracy"] = float(np.mean(pred_class == gt_class)) if len(gt_class) else 0.0
    if not fg.any():
        return out
    p, g = pred_boxes[fg], gt_boxes[fg]
    center_dist = np.linalg.norm(p[:, :3] - g[:, :3], axis=-1)
    out["mATE"] = float(np.mean(center_dist))  # mean abs translation error
    out["mASE"] = float(np.mean(np.abs(p[:, 3:6] - g[:, 3:6])))  # size error
    out["mAOE"] = float(np.mean(_yaw_diff(p[:, 6], g[:, 6])))  # orientation
    for thr in (0.5, 1.0, 2.0, 4.0):
        out[f"match@{thr}m"] = float(np.mean(center_dist < thr))
    out["class_accuracy_fg"] = float(np.mean(pred_class[fg] == gt_class[fg]))
    return out
