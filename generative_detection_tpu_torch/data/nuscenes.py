"""nuScenes object-patch datasets read from mmdet3d info pickles
(``data/nuscenes.py`` of the JAX package; items are numpy, bit-equal to that
reader's for one seed).

The mmdet3d >= 1.1 ``nuscenes_infos_*.pkl`` schema is read directly:
``data_list[i]['images'][CAM]{img_path, cam2img}`` and
``data_list[i]['cam_instances'][CAM]``. Frames are read from
``<data_root>/samples/<CAM>/<basename of img_path>``.

Per item (index = sample x camera, 6 cameras):

- with probability 1 - negative_sample_prob, an object patch: a random
  instance of the camera, a square crop around its (optionally perturbed) 2D
  centre, its size snapped to ``PATCH_SIZES`` under ``perturb_scale``,
  resized to ``patch_height``, the 2D box mask, the 4-d patch-NDC + SE(3)-log
  pose, the l/h, h, w/h box sizes, the fill factor and a yaw-perturbed pose;
- else a background crop whose IoU with every instance box is < 0.5;
- an index that yields no item skips forward to the next.

Two image contracts: float patches and masks made on the host (the native
ops of ``data/native.py``), or, with ``device_preprocess``, raw uint8 crops
padded into a ``max(PATCH_SIZES)`` buffer plus the mask rectangle, which
``PoseAutoencoder.prepare_batch`` crops, resizes and masks on the device
(crops larger than the buffer are shrunk to it on the host first).

Frames decode through the native libjpeg region decoder where it built
(``frame_route == "native-jpeg"``), else through one PIL full decode a frame
(``"pil"``; the same pixels). PIL parses each frame's header either way. A
frame that is not RGB is converted to RGB and takes the native ops too (the
JAX package resizes such an object patch with PIL; nuScenes frames are RGB).

Labels come from the numpy closed forms of ``geometry/host.py``;
``_pose_labels_impl`` computes them through the torch transform stack as
the tests' reference. Mask box corners are clamped to the patch (the
reference's negative numpy slices would wrap around).
"""

from __future__ import annotations

import logging
import math
import os
import pickle
from typing import Dict, List, Optional, Tuple

import numpy as np

from . import native
from .synthetic import LABEL_ID2NAME, LABEL_NAME2ID

CAM_NAMESPACE = "CAM"
CAMERAS = ["FRONT", "FRONT_RIGHT", "FRONT_LEFT", "BACK", "BACK_LEFT", "BACK_RIGHT"]
CAMERA_NAMES = [f"{CAM_NAMESPACE}_{c}" for c in CAMERAS]

Z_NEAR, Z_FAR = 0.01, 55.0
NUSC_IMG_WIDTH, NUSC_IMG_HEIGHT = 1600, 900
POSE_DIM, LHW_DIM, BBOX_3D_DIM = 4, 3, 7
PATCH_SIZES = [50, 100, 200, 400]


def _box_iou(box: np.ndarray, boxes: np.ndarray) -> np.ndarray:
    """IoU of one (4,) box against (N, 4) boxes, xyxy."""
    if boxes.size == 0:
        return np.zeros((0,), np.float32)
    x1 = np.maximum(box[0], boxes[:, 0])
    y1 = np.maximum(box[1], boxes[:, 1])
    x2 = np.minimum(box[2], boxes[:, 2])
    y2 = np.minimum(box[3], boxes[:, 3])
    inter = np.clip(x2 - x1, 0, None) * np.clip(y2 - y1, 0, None)
    a = (box[2] - box[0]) * (box[3] - box[1])
    b = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    return inter / np.maximum(a + b - inter, 1e-9)


class _FrameSource:
    """One camera frame, decoded lazily: only the window an item needs
    through the native region decoder (RGB JPEGs, when ``native_jpeg``), else
    one cached PIL decode of the whole frame."""

    def __init__(self, path: str, native_jpeg: bool):
        from PIL import Image

        self._path = path
        self.pil = Image.open(path)  # parses the header only
        self.size = self.pil.size
        self.mode = self.pil.mode
        self._full: Optional[np.ndarray] = None
        self._try_native = native_jpeg and self.pil.format == "JPEG" and self.mode == "RGB"

    def _full_array(self) -> np.ndarray:
        if self._full is None:
            img = self.pil if self.mode == "RGB" else self.pil.convert("RGB")
            self._full = np.asarray(img, np.uint8)
        return self._full

    def region(self, x1: int, y1: int, w: int, h: int) -> np.ndarray:
        """(h, w, 3) uint8 window at [x1, y1); out-of-frame pixels are 0."""
        if self._try_native and self._full is None:
            out = native.jpeg_region_file(self._path, int(x1), int(y1), int(w), int(h))
            if out is not None:
                return out
            self._try_native = False  # a stream the decoder refuses: PIL from here on
        arr = self._full_array()
        out = np.zeros((h, w, 3), np.uint8)
        ix1, iy1 = max(x1, 0), max(y1, 0)
        ix2, iy2 = min(x1 + w, arr.shape[1]), min(y1 + h, arr.shape[0])
        if ix2 > ix1 and iy2 > iy1:
            out[iy1 - y1 : iy2 - y1, ix1 - x1 : ix2 - x1] = arr[iy1:iy2, ix1:ix2]
        return out


class NuScenesBase:
    ann_file: str = "nuscenes_infos_train.pkl"
    split: str = "train"

    def __init__(
        self,
        data_root: str,
        label_names: List[str],
        patch_height: int = 256,
        patch_aspect_ratio: float = 1.0,
        is_sweep: bool = False,
        perturb_center: bool = False,
        perturb_scale: bool = False,
        negative_sample_prob: float = 0.5,
        h_minmax_dir: str = "dataset_stats/combined",
        ann_file: Optional[str] = None,
        seed: Optional[int] = None,
        device_preprocess: bool = False,
        **_ignored,  # mmdet3d keywords (pipeline, modality, box_type_3d, ...)
    ):
        self.data_root = data_root
        self.img_root = os.path.join(data_root, "sweeps" if is_sweep else "samples")
        if ann_file is not None:
            self.ann_file = ann_file
        ann_path = os.path.join(data_root, self.ann_file)
        with open(ann_path, "rb") as f:
            infos = pickle.load(f)
        self.data_list = self._validate_infos(infos, ann_path)

        self.label_names = list(label_names)
        self.label_ids = [LABEL_NAME2ID[n] for n in self.label_names]
        self.label_id2class_id = {lab: i for i, lab in enumerate(self.label_ids)}
        self.patch_size = (patch_height, int(patch_height * patch_aspect_ratio))
        self.perturb_center = perturb_center
        self.perturb_scale = perturb_scale
        self.negative_sample_prob = (
            negative_sample_prob if "background" in self.label_names else 0.0
        )
        self.hmin_dict, self.hmax_dict = self._load_h_minmax(h_minmax_dir)
        self.num_cameras = len(CAMERA_NAMES)
        self._rng = np.random.default_rng(seed)
        self.device_preprocess = device_preprocess
        native.load_lib()  # the crop/resize/mask ops: raise now if they cannot build
        self.frame_route = "native-jpeg" if native.load_jpeg_lib() is not None else "pil"
        logging.info("%s: frames decode through %s", type(self).__name__,
                     "the native libjpeg region decoder" if self.frame_route == "native-jpeg"
                     else "PIL, whole frames (libjpegdec did not build)")

    @staticmethod
    def _validate_infos(infos, ann_path: str):
        """The mmdet3d >= 1.1 layouts, ``{"metainfo", "data_list"}`` or a
        bare list of per-sample dicts, each with ``images[CAM_X]{img_path,
        cam2img}`` and ``cam_instances``; anything else (the pre-1.1
        ``{"infos": ...}`` schema above all) raises with what to do."""
        if isinstance(infos, dict):
            if "infos" in infos and "data_list" not in infos:
                raise ValueError(
                    f"{ann_path}: pre-1.1 mmdet3d info-pkl layout "
                    "('infos' key, per-sample 'cams'). Regenerate with "
                    "mmdet3d >= 1.1 (tools/dataset_converters/update_infos_to_v2.py) "
                    "— this reader consumes the v1.1+ "
                    "{'metainfo', 'data_list'} schema."
                )
            if "data_list" not in infos:
                raise ValueError(
                    f"{ann_path}: unrecognized info-pkl dict layout "
                    f"(keys: {sorted(infos.keys())[:8]}); expected "
                    "{'metainfo', 'data_list'}."
                )
            data_list = infos["data_list"]
        elif isinstance(infos, list):
            data_list = infos
        else:
            raise ValueError(
                f"{ann_path}: expected a dict or list info-pkl, got "
                f"{type(infos).__name__}."
            )
        if data_list:
            first = data_list[0]
            if not isinstance(first, dict) or "images" not in first:
                have = (sorted(first.keys())[:10] if isinstance(first, dict)
                        else type(first).__name__)
                raise ValueError(
                    f"{ann_path}: data_list entries lack the 'images' camera "
                    f"table (got {have}); this reader needs the mmdet3d "
                    "v1.1+ frame-based layout (images[CAM_X] + cam_instances)."
                )
            if "cam_instances" not in first:
                raise ValueError(
                    f"{ann_path}: data_list entries lack 'cam_instances' — "
                    "regenerate the pkl with camera instances "
                    "(mmdet3d create_data with --with-cam-instances / "
                    "frame-based loading, ref configs use "
                    "load_type='frame_based')."
                )
        return data_list

    @staticmethod
    def _load_h_minmax(h_minmax_dir: str) -> Tuple[Dict, Dict]:
        """The per-class box-height ranges of ``compute_hmin_hmax``, or 0.5
        and 4.0 for every class where they are missing."""
        try:
            with open(os.path.join(h_minmax_dir, "hmin.pkl"), "rb") as f:
                hmin = pickle.load(f)
            with open(os.path.join(h_minmax_dir, "hmax.pkl"), "rb") as f:
                hmax = pickle.load(f)
            return hmin, hmax
        except (FileNotFoundError, OSError):
            logging.warning(
                "hmin/hmax stats not found under %s; using defaults (run "
                "generative_detection_tpu_torch.compute_dataset_stats, then "
                ".compute_hmin_hmax)", h_minmax_dir,
            )
            names = [n for n in LABEL_NAME2ID if n != "background"]
            return {n: 0.5 for n in names}, {n: 4.0 for n in names}

    def __len__(self):
        return len(self.data_list) * self.num_cameras

    def _frame(self, sample, cam_name) -> Optional[_FrameSource]:
        img_file = os.path.basename(sample["images"][cam_name]["img_path"])
        try:
            return _FrameSource(os.path.join(self.img_root, cam_name, img_file),
                                self.frame_route == "native-jpeg")
        except (FileNotFoundError, OSError):
            return None

    # -- patch cropping ----------------------------------------------------------

    def _crop_object_patch(self, img, bbox, center_2d):
        """(patch float32 HWC in [0, 1] or the raw-crop fields, patch size in
        pixels, resampling factor, padding pixels resampled, mask or None),
        or None for an unusable instance."""
        W, H = img.size
        if not (0 <= center_2d[0] < W and 0 <= center_2d[1] < H):
            return None
        x1, y1, x2, y2 = (int(v) for v in bbox)
        width, height = x2 - x1, y2 - y1
        center = np.floor(np.asarray(center_2d)).astype(np.int64)
        box_size = max(width, height)
        corner_case = x1 >= W or y1 >= H or x2 <= 0 or y2 <= 0

        if corner_case:
            cx1, cy1 = max(0, x1), max(0, y1)
            cx2, cy2 = min(W, x2), min(H, y2)
            max_dim = max(cx2 - cx1, cy2 - cy1)
            box_size = min(PATCH_SIZES, key=lambda p: abs(max_dim - p))
            nx1 = cx1 + ((cx2 - cx1) - box_size) // 2
            ny1 = cy1 + ((cy2 - cy1) - box_size) // 2
            center = np.asarray([nx1 + box_size // 2, ny1 + box_size // 2])
        elif self.perturb_scale:
            box_size = min(PATCH_SIZES, key=lambda p: abs(box_size - p))
            center[0] = np.clip(center[0], box_size // 2, W - box_size // 2)
            center[1] = np.clip(center[1], box_size // 2, H - box_size // 2)

        px1 = int(center[0]) - box_size // 2
        py1 = int(center[1]) - box_size // 2
        if box_size <= 0:
            return None

        out_w, out_h = self.patch_size[1], self.patch_size[0]
        resampling_factor = out_w / box_size
        bbox_in_crop = (bbox[0] - px1, bbox[1] - py1, bbox[2] - px1, bbox[3] - py1)
        padding_resampled = max(int(width) - int(height), 0) * resampling_factor

        if self.device_preprocess:
            raw = self._materialize_raw(img, px1, py1, box_size, bbox_in_crop)
            return raw, float(box_size), resampling_factor, padding_resampled, None

        crop_u8 = img.region(px1, py1, box_size, box_size)
        patch_np = native.crop_resize_bilinear(crop_u8, 0, 0, box_size, out_h, out_w)
        mask_np = native.bbox_mask(box_size, bbox_in_crop, out_h, out_w)[..., None]
        return patch_np, float(box_size), resampling_factor, padding_resampled, mask_np

    def _materialize_raw(self, img, px1, py1, box_size, bbox_in_crop) -> Dict:
        """The raw-crop fields: the uint8 crop in a ``max(PATCH_SIZES)``
        buffer (zero beyond it and out of frame) and the mask rectangle; a
        crop larger than the buffer is shrunk to it here first."""
        buf_size = max(PATCH_SIZES)
        crop_u8 = img.region(px1, py1, box_size, box_size)
        if box_size > buf_size:
            shrunk = native.crop_resize_bilinear(crop_u8, 0, 0, box_size, buf_size, buf_size)
            raw = np.clip(shrunk * 255.0 + 0.5, 0, 255).astype(np.uint8)
            scale = buf_size / box_size
            bic = np.asarray([v * scale for v in bbox_in_crop], np.float32)
            src_size = float(buf_size)
        else:
            raw = np.zeros((buf_size, buf_size, 3), np.uint8)
            raw[:box_size, :box_size] = crop_u8
            bic = np.asarray(bbox_in_crop, np.float32)
            src_size = float(box_size)
        return {
            "patch_raw": raw,
            "patch_src_size": np.float32(src_size),
            "bbox_in_crop": bic,
            "patch_out_size": np.int32(self.patch_size[0]),
        }

    # -- pose labels ---------------------------------------------------------------

    def _pose_labels(self, cam2img, bbox_3d, patch_center, patch_size_px, resampling_factor,
                     fill_factor, label_name):
        """(pose_6d, bbox_sizes, yaw) by the numpy closed forms, or None."""
        from ..geometry.host import pose_labels_numpy

        K = np.asarray(cam2img, np.float32)
        x, y, z, l, h, w, yaw = (float(v) for v in bbox_3d)
        return pose_labels_numpy(
            x, y, z, l, h, w, yaw,
            patch_center, patch_size_px, resampling_factor, fill_factor,
            hmin=self.hmin_dict[label_name], hmax=self.hmax_dict[label_name],
            patch_out=self.patch_size[0],
            focal=float(K[0, 0]), px=float(K[0, 2]), py=float(K[1, 2]),
            img_w=NUSC_IMG_WIDTH, img_h=NUSC_IMG_HEIGHT,
        )

    def _pose_labels_impl(self, cam, bbox_3d, patch_center, patch_size_px, resampling_factor,
                          fill_factor, label_name):
        """``_pose_labels`` through the torch transform stack (the camera of
        ``_camera_for``, the patch-NDC projection, the SE(3) log): the tests'
        reference for the closed forms."""
        import torch

        from ..geometry import euler_angles_to_matrix, se3_log_map, z_world_to_learned

        x, y, z, l, h, w, yaw = (float(v) for v in bbox_3d)
        p_ndc = cam.transform_points_patch_ndc(
            torch.tensor([[[x, y, z]]], dtype=torch.float32),
            patch_size=[[patch_size_px, patch_size_px]],
            patch_center=[list(patch_center)],
        ).reshape(-1)
        x_patch, y_patch = float(p_ndc[0]), float(p_ndc[1])

        padding_pixels_resampled = fill_factor * self.patch_size[0]
        focal = float(cam.focal_length.reshape(-1)[0])  # negated
        hmin, hmax = self.hmin_dict[label_name], self.hmax_dict[label_name]
        zmin = -(hmin * focal) / (self.patch_size[0] - padding_pixels_resampled)
        zmax = -(hmax * focal) / (self.patch_size[0] - padding_pixels_resampled)
        z_learned = float(
            z_world_to_learned(z, zmin=zmin, zmax=zmax, patch_resampling_factor=resampling_factor)
        )
        M = torch.eye(4)
        M[:3, :3] = euler_angles_to_matrix(torch.tensor([0.0, 0.0, yaw]), "XYZ")
        M[:3, 3] = torch.tensor([x_patch, y_patch, z_learned])
        log = se3_log_map(M.T[None])[0].numpy()
        if not np.all(np.isfinite(log)):
            return None
        pose_6d = np.zeros(POSE_DIM, np.float32)
        pose_6d[:3] = log[:3]
        pose_6d[3] = log[5]
        return pose_6d, np.asarray([l / h, h, w / h], np.float32), yaw

    def _perturbed_v3(self, yaw: float) -> Tuple[float, float]:
        """(v3, yaw) of the yaw perturbed by +-[30, 90] degrees; for a
        pure-yaw row-form SE(3) log, v3 is -yaw."""
        delta = math.radians(self._rng.uniform(30.0, 90.0))
        yp = yaw + delta if self._rng.random() > 0.5 else yaw - delta
        if yp < -math.pi:
            yp += 2 * math.pi
        elif yp > math.pi:
            yp -= 2 * math.pi
        return -yp, yp

    def _perturbed_center(self, center_2d, bbox):
        """A random shift of the centre inside the box."""
        x1, y1, x2, y2 = bbox
        max_p = 0.5 * min(x2 - x1, y2 - y1)
        dx = self._rng.uniform(-max_p, max_p)
        max_dy = math.sqrt(max(max_p**2 - dx**2, 0.0))
        dy = self._rng.uniform(-max_dy, max_dy)
        return [int(center_2d[0] + dx), int(center_2d[1] + dy)]

    def _camera_for(self, cam2img):
        from ..geometry import PatchPerspectiveCameras

        K = np.asarray(cam2img, np.float32)
        return PatchPerspectiveCameras.create(
            focal_length=-K[0, 0],  # negated focal
            principal_point=[[float(K[0, 2]), float(K[1, 2])]],
            image_size=[[NUSC_IMG_HEIGHT, NUSC_IMG_WIDTH]],
            znear=Z_NEAR,
            zfar=Z_FAR,
        )

    # -- item assembly ---------------------------------------------------------------

    def _object_item(self, sample, cam_name, instance) -> Optional[Dict]:
        img = self._frame(sample, cam_name)
        if img is None:
            return None
        img_info = sample["images"][cam_name]
        center_2d = list(instance["center_2d"])
        bbox = list(instance["bbox"])
        if self.perturb_center:
            center_2d = self._perturbed_center(center_2d, bbox)

        crop = self._crop_object_patch(img, bbox, center_2d)
        if crop is None:
            return None
        patch, patch_size_px, resampling, padding_resampled, mask = crop
        fill_factor = padding_resampled / self.patch_size[0]

        label_id = int(instance["bbox_label"])
        label_name = LABEL_ID2NAME[label_id]
        labels = self._pose_labels(img_info["cam2img"], instance["bbox_3d"], center_2d,
                                   patch_size_px, resampling, fill_factor, label_name)
        if labels is None:
            return None
        pose_6d, bbox_sizes, yaw = labels
        v3_pert, yaw_pert = self._perturbed_v3(yaw)
        pose_pert = pose_6d.copy()
        pose_pert[3] = v3_pert

        image_fields = dict(patch) if isinstance(patch, dict) else {
            "patch": patch, "mask_2d_bbox": mask}
        return {
            **image_fields,
            "class_id": self.label_id2class_id[label_id],
            "original_class_id": label_id,
            "class_name": label_name,
            "pose_6d": pose_6d,
            "bbox_sizes": bbox_sizes,
            "yaw": np.float32(yaw),
            "yaw_perturbed": np.float32(yaw_pert),
            "pose_6d_perturbed": pose_pert,
            "fill_factor": np.float32(fill_factor),
            "patch_size": np.asarray([[patch_size_px, patch_size_px]], np.float32),
            "patch_center_2d": np.asarray(center_2d, np.float32),
            "resampling_factor": np.float32(resampling),
            "bbox_3d_gt": np.asarray(instance["bbox_3d"], np.float32),
            "cam2img": np.asarray(img_info["cam2img"], np.float32).reshape(3, 3),
        }

    def _background_item(self, sample, cam_name, instances) -> Optional[Dict]:
        img = self._frame(sample, cam_name)
        if img is None:
            return None
        W, H = img.size
        boxes = np.asarray([inst["bbox"] for inst in instances], np.float32).reshape(-1, 4)
        crop_u8 = None
        ps = 0
        for _ in range(10):
            ps = int(self._rng.choice(PATCH_SIZES))
            cx = int(self._rng.integers(0, max(W - ps, 1)))
            cy = int(self._rng.integers(0, max(H - ps, 1)))
            cand = np.asarray([cx, cy, cx + ps, cy + ps], np.float32)
            if boxes.shape[0] == 0 or np.all(_box_iou(cand, boxes) < 0.5):
                crop_u8 = img.region(cx, cy, ps, ps)
                break
        if crop_u8 is None:
            return None
        out_w, out_h = self.patch_size[1], self.patch_size[0]
        if self.device_preprocess:
            raw = np.zeros((max(PATCH_SIZES),) * 2 + (3,), np.uint8)
            raw[:ps, :ps] = crop_u8
            image_fields = {
                "patch_raw": raw,
                "patch_src_size": np.float32(ps),
                "bbox_in_crop": np.zeros(4, np.float32),  # an empty mask
                "patch_out_size": np.int32(out_h),
            }
        else:
            image_fields = {
                "patch": native.resize_bilinear(crop_u8, out_h, out_w),
                "mask_2d_bbox": np.zeros((out_h, out_w, 1), np.float32),
            }
        bg_id = LABEL_NAME2ID["background"]
        return {
            **image_fields,
            "class_id": self.label_id2class_id[bg_id],
            "original_class_id": bg_id,
            "class_name": "background",
            "pose_6d": np.zeros(POSE_DIM, np.float32),
            "bbox_sizes": np.zeros(LHW_DIM, np.float32),
            "yaw": np.float32(0.0),
            "yaw_perturbed": np.float32(0.0),
            "pose_6d_perturbed": np.zeros(POSE_DIM, np.float32),
            "fill_factor": np.float32(0.0),
            "patch_size": np.asarray([[out_h, out_w]], np.float32),
            "patch_center_2d": np.asarray([out_h // 2, out_w // 2], np.float32),
            "resampling_factor": np.float32(out_w / ps),
            "bbox_3d_gt": np.zeros(BBOX_3D_DIM, np.float32),
            "cam2img": np.asarray(sample["images"][cam_name]["cam2img"],
                                  np.float32).reshape(3, 3),
        }

    def __getitem__(self, idx: int) -> Dict:
        n = len(self)
        for attempt in range(n):  # skip forward past indices that yield no item
            i = (idx + attempt) % n
            sample_idx, cam_idx = divmod(i, self.num_cameras)
            sample = self.data_list[sample_idx]
            cam_name = CAMERA_NAMES[cam_idx]
            instances = [
                inst for inst in sample.get("cam_instances", {}).get(cam_name, [])
                if inst["bbox_label"] in self.label_ids
            ]
            if self._rng.random() <= (1.0 - self.negative_sample_prob):
                if not instances:
                    continue
                inst = instances[int(self._rng.integers(0, len(instances)))]
                item = self._object_item(sample, cam_name, inst)
            else:
                item = self._background_item(sample, cam_name, instances)
            if item is not None:
                item["sample_idx"] = sample_idx
                item["cam_idx"] = cam_idx
                item["cam_name"] = cam_name
                return item
        raise RuntimeError("no valid sample found in the entire dataset")


class NuScenesTrain(NuScenesBase):
    split = "train"
    ann_file = "nuscenes_infos_train.pkl"


class NuScenesValidation(NuScenesBase):
    split = "validation"
    ann_file = "nuscenes_infos_val.pkl"


class NuScenesTest(NuScenesBase):
    split = "test"
    ann_file = "nuscenes_infos_test.pkl"


class NuScenesTrainMini(NuScenesBase):
    split = "train-mini"
    ann_file = "nuscenes_mini_infos_train.pkl"


class NuScenesValidationMini(NuScenesBase):
    split = "val-mini"
    ann_file = "nuscenes_mini_infos_val.pkl"
