"""Pure-numpy closed forms of the per-item label math of the data pipeline
(``geometry/host.py`` of the JAX package, copied: the port imports nothing of
that package).

The camera/SE(3) label computation is a handful of scalar operations per
item; going through the tensor transform stack would cost milliseconds of
dispatch per item on a loader thread. These closed forms are algebraically
identical to it (``data/synthetic.py`` keeps the transform-stack twin,
``pose_labels_from_box_torch``, as the tests' reference):

- patch-NDC projection of a camera-space point through the dataset's
  negated-focal + xyflip pipeline:
      x_ndc2 = (W/2 - px + f*x/z) / s,   s = min(H, W)/2
      x_patch = (min(patch)/min(image)) * (x_ndc2 - cx_ndc)
- pure-yaw row-form SE(3) log: omega = (0, 0, -yaw), u = V(omega)^-1 T.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np


def patch_ndc_xy(
    x: float,
    y: float,
    z: float,
    focal: float,  # positive camera focal fx (the dataset negates it itself)
    px: float,
    py: float,
    patch_min: float,
    cx: float,
    cy: float,
    img_w: float = 1600.0,
    img_h: float = 900.0,
) -> Tuple[float, float]:
    s = min(img_h, img_w) / 2.0
    i_min = min(img_h, img_w)
    ratio = patch_min / i_min
    x_ndc2 = (img_w / 2.0 - px + focal * x / z) / s
    y_ndc2 = (img_h / 2.0 - py + focal * y / z) / s
    cx_ndc = (cx - img_w / 2.0) / s
    cy_ndc = (cy - img_h / 2.0) / s
    return ratio * (x_ndc2 - cx_ndc), ratio * (y_ndc2 - cy_ndc)


def _V_pure_yaw(theta: float) -> np.ndarray:
    """SE(3) left-Jacobian for omega = (0, 0, theta)."""
    K = np.array([[0.0, -theta, 0.0], [theta, 0.0, 0.0], [0.0, 0.0, 0.0]])
    t2 = theta * theta
    if t2 < 1e-12:
        f1, f2 = 0.5 - t2 / 24.0, 1.0 / 6.0 - t2 / 120.0
    else:
        t = abs(theta)
        f1 = (1.0 - math.cos(t)) / t2
        f2 = (t - math.sin(t)) / (t2 * t)
    return np.eye(3) + f1 * K + f2 * (K @ K)


def se3_log_pure_yaw(tx: float, ty: float, tz: float, yaw: float) -> np.ndarray:
    """Row-form [[Rz(yaw)^T, 0], [t, 1]] -> (u1, u2, u3, v3): the dataset's
    4-d pose (t1, t2, t3, v3) with v3 = -yaw."""
    V = _V_pure_yaw(-yaw)
    u = np.linalg.solve(V, np.array([tx, ty, tz], np.float64))
    return np.array([u[0], u[1], u[2], -yaw], np.float32)


def pose_labels_numpy(
    x: float,
    y: float,
    z: float,
    l: float,
    h: float,
    w: float,
    yaw: float,
    patch_center,
    patch_size_pixels: float,
    patch_resampling_factor: float,
    fill_factor: float,
    hmin: float,
    hmax: float,
    patch_out: int = 256,
    focal: float = 1266.0,
    px: float = 800.0,
    py: float = 450.0,
    img_w: float = 1600.0,
    img_h: float = 900.0,
):
    """The full label math of a nuScenes patch, numpy only."""
    x_patch, y_patch = patch_ndc_xy(
        x, y, z, focal, px, py, patch_size_pixels,
        patch_center[0], patch_center[1], img_w, img_h,
    )
    pad = fill_factor * patch_out
    zmin = hmin * focal / max(patch_out - pad, 1e-6)
    zmax = hmax * focal / max(patch_out - pad, 1e-6)
    z_patch = z / patch_resampling_factor
    z_learned = 2.0 * (z_patch - zmin) / (zmax - zmin) - 1.0
    pose_6d = se3_log_pure_yaw(x_patch, y_patch, z_learned, yaw)
    if not np.all(np.isfinite(pose_6d)):
        return None
    bbox_sizes = np.asarray([l / h, h, w / h], np.float32)
    return pose_6d, bbox_sizes, yaw
