"""Batched inference: encode -> pose decode -> 3D box recovery
(``eval/inference.py`` of the JAX package).

The decoded 19-d pose vector is inverted back to a camera-frame 3D box via
the transforms the data pipeline used to build the labels:

- SE(3): label t = V(omega)^-1 T with omega = (0, 0, -yaw); recovery
  computes T = V(omega) @ u;
- z: learned [-1,1] -> patch -> world via per-class hmin/hmax and the patch
  resampling factor;
- x, y: (x_patch_ndc, y_patch_ndc, 1/z) through the inverse of the
  world -> patch-NDC projection.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..geometry.cameras import z_learned_to_world
from ..geometry.se3 import _se3_V

POSE_6D_DIM = 4
LHW_DIM = 3


def pose_inference(
    net, rgb: torch.Tensor, sample_posterior: bool = False,
    generator: Optional[torch.Generator] = None,
):
    """(B, H, W, 3) patches -> (dec_pose (B, 19), posterior_obj,
    bbox_posterior). Mode path by default (a deterministic detector)."""
    with torch.inference_mode():
        posterior_obj, pose_feat = net.encode(rgb)
        dec_pose, bbox_posterior = net._decode_pose(pose_feat, sample_posterior, generator)
    return dec_pose, posterior_obj, bbox_posterior


def recover_boxes(
    dec_pose: torch.Tensor,
    focal_length: torch.Tensor,  # (B,) positive camera focal fx
    principal_point: torch.Tensor,  # (B, 2)
    patch_size: torch.Tensor,  # (B,) original patch size in pixels (min dim)
    patch_center: torch.Tensor,  # (B, 2) screen pixels
    resampling_factor: torch.Tensor,  # (B,)
    hmin_table: torch.Tensor,  # (num_classes,) per-class box-height min
    hmax_table: torch.Tensor,  # (num_classes,)
    image_size=(900.0, 1600.0),
    patch_out: int = 256,
    train_on_yaw: bool = True,
) -> Dict[str, torch.Tensor]:
    """Decoded pose vectors -> camera-frame 3D boxes [x,y,z,l,h,w,yaw] + class."""
    u = dec_pose[:, :3]
    v3 = dec_pose[:, 3]
    lhw = dec_pose[:, POSE_6D_DIM : POSE_6D_DIM + LHW_DIM]
    fill = dec_pose[:, POSE_6D_DIM + LHW_DIM]
    logits = dec_pose[:, POSE_6D_DIM + LHW_DIM + 1 :]
    cls = torch.argmax(logits, dim=-1)
    score = torch.sigmoid(logits).amax(dim=-1)

    # box sizes: (l/h, h, w/h) -> (l, h, w)
    h = lhw[:, 1]
    l = lhw[:, 0] * h
    w = lhw[:, 2] * h

    # translation from the SE(3) log: T = V(omega) @ u, omega = (0, 0, -yaw)
    yaw = v3 if train_on_yaw else -v3
    zero = torch.zeros_like(yaw)
    t = torch.einsum("bij,bj->bi", _se3_V(torch.stack([zero, zero, -yaw], dim=-1)), u)
    x_patch, y_patch, z_learned = t[:, 0], t[:, 1], t[:, 2]

    # z: learned -> world (per predicted class hmin/hmax)
    denom = torch.clamp(patch_out - fill * patch_out, min=1.0)
    zmin = hmin_table[cls] * focal_length / denom
    zmax = hmax_table[cls] * focal_length / denom
    z_world = torch.clamp(z_learned_to_world(z_learned, zmin, zmax, resampling_factor), min=1e-3)

    # x, y: the closed-form inverse of the label math
    img_h, img_w = float(image_size[0]), float(image_size[1])
    s = min(img_h, img_w) / 2.0
    ratio = torch.clamp(patch_size / min(img_h, img_w), min=1e-9)
    px, py = principal_point[:, 0], principal_point[:, 1]
    cx_ndc = (patch_center[:, 0] - img_w / 2.0) / s
    cy_ndc = (patch_center[:, 1] - img_h / 2.0) / s
    x_world = z_world * (s * (x_patch / ratio + cx_ndc) - img_w / 2.0 + px) / focal_length
    y_world = z_world * (s * (y_patch / ratio + cy_ndc) - img_h / 2.0 + py) / focal_length

    boxes = torch.stack([x_world, y_world, z_world, l, h, w, yaw], dim=-1)
    return {"boxes_3d": boxes, "class_id": cls, "score": score, "logits": logits}
