"""Synthetic nuScenes-patch datasets, no download needed
(``data/synthetic.py`` of the JAX package).

Items have the key and shape contract of the real patch dataset: a rendered
"object" (an oriented colored box on a textured background) or a
pure-background crop, with self-consistent pose, bbox and fill-factor labels
derived through the same camera/patch-NDC/SE(3) math as the real pipeline.
Items are numpy and deterministic per (seed, index): with the same seed they
are bit-equal to the JAX package's. Used by the smoke configs, the tests and
the chip smoke run.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np

from ..geometry.host import pose_labels_numpy

LABEL_NAME2ID = {
    "car": 0,
    "truck": 1,
    "trailer": 2,
    "bus": 3,
    "construction_vehicle": 4,
    "bicycle": 5,
    "motorcycle": 6,
    "pedestrian": 7,
    "traffic_cone": 8,
    "barrier": 9,
    "background": 10,
}
LABEL_ID2NAME = {v: k for k, v in LABEL_NAME2ID.items()}

POSE_DIM = 4
LHW_DIM = 3

_IMG_W, _IMG_H = 1600, 900
_FOCAL = 1266.0
_PP = (800.0, 450.0)


def pose_labels_from_box(
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
    focal: float = _FOCAL,
):
    """3D camera-frame box -> (pose_6d[4], bbox_sizes[3], yaw), the label math
    of a nuScenes patch. The numpy closed form, run on the loader thread
    (microseconds an item); the transform-stack twin below is the tests'
    equivalence reference."""
    out = pose_labels_numpy(
        x, y, z, l, h, w, yaw, patch_center, patch_size_pixels,
        patch_resampling_factor, fill_factor, hmin, hmax, patch_out, focal,
        px=_PP[0], py=_PP[1], img_w=_IMG_W, img_h=_IMG_H,
    )
    if out is None:
        raise ValueError("non-finite pose")
    return out


def pose_labels_from_box_torch(
    x, y, z, l, h, w, yaw, patch_center, patch_size_pixels,
    patch_resampling_factor, fill_factor, hmin, hmax, patch_out=256,
    focal=_FOCAL,
):
    """``pose_labels_from_box`` through the torch transform stack: the
    camera, the patch-NDC projection and the SE(3) log. The tests hold the
    closed form against it."""
    import torch

    from ..geometry import (
        PatchPerspectiveCameras,
        euler_angles_to_matrix,
        se3_log_map,
        z_world_to_learned,
    )

    cam = PatchPerspectiveCameras.create(
        focal_length=-focal,
        principal_point=[list(_PP)],
        image_size=[[_IMG_H, _IMG_W]],
        znear=0.01,
        zfar=55.0,
    )
    p_ndc = cam.transform_points_patch_ndc(
        torch.tensor([[[x, y, z]]], dtype=torch.float32),
        patch_size=[[patch_size_pixels, patch_size_pixels]],
        patch_center=[list(patch_center)],
    ).reshape(-1)
    x_patch, y_patch = float(p_ndc[0]), float(p_ndc[1])

    padding_pixels_resampled = fill_factor * patch_out
    zmin = -(hmin * -focal) / (patch_out - padding_pixels_resampled)
    zmax = -(hmax * -focal) / (patch_out - padding_pixels_resampled)
    z_learned = float(
        z_world_to_learned(z, zmin=zmin, zmax=zmax, patch_resampling_factor=patch_resampling_factor)
    )

    R = euler_angles_to_matrix(torch.tensor([0.0, 0.0, yaw], dtype=torch.float32), "XYZ")
    M = torch.eye(4)
    M[:3, :3] = R
    M[:3, 3] = torch.tensor([x_patch, y_patch, z_learned])
    log = se3_log_map(M.T[None])[0].numpy()
    pose_6d = np.zeros(POSE_DIM, np.float32)
    pose_6d[:3] = log[:3]
    pose_6d[3] = log[5]
    bbox_sizes = np.asarray([l / h, h, w / h], np.float32)
    return pose_6d, bbox_sizes, yaw


def _perturb_yaw(yaw: float, rng: np.random.Generator) -> float:
    """+-[30, 90] degrees, wrapped to [-pi, pi], as the nuScenes dataset perturbs."""
    delta = math.radians(rng.uniform(30.0, 90.0))
    out = yaw + delta if rng.random() > 0.5 else yaw - delta
    if out < -math.pi:
        out += 2 * math.pi
    elif out > math.pi:
        out -= 2 * math.pi
    return out


class SyntheticPatchBase:
    """Deterministic synthetic object/background patches."""

    split_seed = 0

    def __init__(
        self,
        length: int = 256,
        patch_height: int = 256,
        patch_aspect_ratio: float = 1.0,
        negative_sample_prob: float = 0.5,
        label_names=None,
        seed: int = 23,
        device_preprocess: bool = False,
        **_,
    ):
        self.length = length
        self.patch_out = patch_height
        self.patch_w = int(patch_height * patch_aspect_ratio)
        # device_preprocess: emit the raw-uint8-crop contract (patch_raw and
        # the mask rectangle; resize, normalize and mask would run on the
        # device in the model's batch preparation), the nuScenes dataset's
        # keys, so that path has items without real nuScenes data.
        self.device_preprocess = device_preprocess
        if device_preprocess and patch_aspect_ratio != 1.0:
            raise ValueError("device_preprocess needs square patches")
        self.negative_sample_prob = negative_sample_prob
        names = label_names or list(LABEL_NAME2ID)
        self.label_ids = [LABEL_NAME2ID[n] for n in names]
        self.label_id2class_id = {lab: i for i, lab in enumerate(self.label_ids)}
        self.seed = seed + self.split_seed

    def __len__(self):
        return self.length

    def _render_patch(self, rng: np.random.Generator, with_object: bool):
        h, w = self.patch_out, self.patch_w
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        freq = rng.uniform(0.02, 0.1, size=2)
        base = 0.5 + 0.25 * np.sin(freq[0] * xx + rng.uniform(0, 6)) * np.cos(
            freq[1] * yy + rng.uniform(0, 6)
        )
        img = np.stack([base * c for c in rng.uniform(0.4, 1.0, size=3)], axis=-1)
        mask = np.zeros((h, w, 1), np.float32)
        rect = (0.0, 0.0, 0.0, 0.0)  # x1,y1,x2,y2 of the mask in crop pixels
        if with_object:
            cx, cy = w // 2, h // 2
            bw = int(rng.uniform(0.3, 0.9) * w)
            bh = int(rng.uniform(0.3, 0.9) * h)
            x1, y1 = max(cx - bw // 2, 0), max(cy - bh // 2, 0)
            x2, y2 = min(cx + bw // 2, w), min(cy + bh // 2, h)
            color = rng.uniform(0.0, 1.0, size=3)
            img[y1:y2, x1:x2] = 0.3 * img[y1:y2, x1:x2] + 0.7 * color
            mask[y1:y2, x1:x2] = 1.0
            rect = (float(x1), float(y1), float(x2), float(y2))
        return img.astype(np.float32), mask, rect

    def __getitem__(self, idx: int) -> Dict:
        rng = np.random.default_rng((self.seed, idx))
        is_object = rng.random() > self.negative_sample_prob
        patch, mask, rect = self._render_patch(rng, is_object)
        if is_object:
            orig_id = int(rng.choice([i for i in self.label_ids if i != 10] or [0]))
            z = rng.uniform(8.0, 45.0)
            x = rng.uniform(-0.4, 0.4) * z
            y = rng.uniform(-0.1, 0.2) * z
            hsz = rng.uniform(0.8, 3.5)
            l, w3 = hsz * rng.uniform(0.8, 3.0), hsz * rng.uniform(0.5, 1.2)
            yaw = rng.uniform(-math.pi, math.pi)
            patch_size_px = float(rng.choice([50, 100, 200, 400]))
            center = (
                _PP[0] + x / z * _FOCAL + rng.uniform(-5, 5),
                _PP[1] + y / z * _FOCAL + rng.uniform(-5, 5),
            )
            resampling = self.patch_out / patch_size_px
            fill = float(rng.uniform(0.0, 0.3))
            pose_6d, bbox_sizes, yaw = pose_labels_from_box(
                x, y, z, l, hsz, w3, yaw,
                center, patch_size_px, resampling, fill,
                hmin=0.5, hmax=4.0, patch_out=self.patch_out,
            )
            yaw_pert = _perturb_yaw(yaw, rng)
            pose_pert = pose_6d.copy()
            pose_pert[3] = -yaw_pert  # v3 of a pure-yaw row-form SE(3) log
            item = {
                "patch": patch,
                "class_id": self.label_id2class_id.get(orig_id, 0),
                "original_class_id": orig_id,
                "class_name": LABEL_ID2NAME[orig_id],
                "pose_6d": pose_6d,
                "bbox_sizes": bbox_sizes,
                "yaw": np.float32(yaw),
                "yaw_perturbed": np.float32(yaw_pert),
                "pose_6d_perturbed": pose_pert,
                "fill_factor": np.float32(fill),
                "mask_2d_bbox": mask,
                "patch_size": np.asarray([[patch_size_px, patch_size_px]], np.float32),
                "patch_center_2d": np.asarray(center, np.float32),
                "resampling_factor": np.float32(resampling),
                "bbox_3d_gt": np.asarray([x, y, z, l, hsz, w3, yaw], np.float32),
            }
        else:
            bg_id = LABEL_NAME2ID["background"]
            item = {
                "patch": patch,
                "class_id": self.label_id2class_id.get(bg_id, bg_id),
                "original_class_id": bg_id,
                "class_name": "background",
                "pose_6d": np.zeros(POSE_DIM, np.float32),
                "bbox_sizes": np.zeros(LHW_DIM, np.float32),
                "yaw": np.float32(0.0),
                "yaw_perturbed": np.float32(0.0),
                "pose_6d_perturbed": np.zeros(POSE_DIM, np.float32),
                "fill_factor": np.float32(0.0),
                "mask_2d_bbox": np.zeros_like(mask),
                "patch_size": np.asarray(
                    [[self.patch_out, self.patch_w]], np.float32
                ),
                "patch_center_2d": np.asarray(
                    [self.patch_out // 2, self.patch_w // 2], np.float32
                ),
                "resampling_factor": np.float32(1.0),
                "bbox_3d_gt": np.zeros(7, np.float32),
            }
        if self.device_preprocess:
            item.pop("mask_2d_bbox")
            raw = item.pop("patch")
            item["patch_raw"] = np.clip(raw * 255.0 + 0.5, 0, 255).astype(np.uint8)
            item["patch_src_size"] = np.float32(self.patch_out)
            item["bbox_in_crop"] = np.asarray(
                rect if is_object else (0.0, 0.0, 0.0, 0.0), np.float32
            )
            item["patch_out_size"] = np.int32(self.patch_out)
        return item


class SyntheticPatchTrain(SyntheticPatchBase):
    split_seed = 0


class SyntheticPatchValidation(SyntheticPatchBase):
    split_seed = 1


class SyntheticPatchTest(SyntheticPatchBase):
    split_seed = 2


class SyntheticImageBase(SyntheticPatchBase):
    """Plain-image variant for the ldm ``Autoencoder`` family: yields
    ``{'image': (H, W, 3) float32 in [-1, 1]}``, the ldm dataset contract."""

    def __getitem__(self, idx: int) -> Dict:
        rng = np.random.default_rng((self.seed, idx, 7))
        img, _, _ = self._render_patch(rng, with_object=rng.random() > 0.5)
        return {"image": (2.0 * img - 1.0).astype(np.float32)}


class SyntheticImageTrain(SyntheticImageBase):
    split_seed = 0


class SyntheticImageValidation(SyntheticImageBase):
    split_seed = 1
