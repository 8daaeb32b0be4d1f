"""Port parity on the CPU for the nuScenes slice: the native loader ops, the
device-side resize ops, the nuScenes reader, the raw-crop batch preparation,
the dataset-stats tools, the preflight tool and the config's data node,
against the JAX package; and the slice as a whole (fixture tree -> both
readers -> prepare_batch -> the tiny_cpu.yaml detector -> both evaluators).

Tolerances:
- native ops, reader items, masks, nearest resize, stats pickles and the
  preflight report (timings left out): bit-equal;
- bilinear resize and crop-resize, the raw-crop ``rgb_gt``: 2e-6 absolute
  (float32 on both sides, XLA and PyTorch order the interpolation's
  arithmetic differently; inputs are images in [0, 1]);
- the closed-form labels against the torch transform stack: 1e-4 relative,
  1e-5 absolute on the pose (the bound of ``test_torch_port_data.py``);
- the detector's boxes: ``test_torch_port_detector.py``'s fp32 tolerances;
  the evaluators on the same predictions: 1e-12.
"""

import logging
import os
import pickle
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import compute_dataset_stats as jax_stats_tool
import compute_hmin_hmax as jax_hminmax_tool
from generative_detection_tpu.config import instantiate_from_config as jax_instantiate
from generative_detection_tpu.config import merge_configs as jax_merge
from generative_detection_tpu.data import native as jax_native
from generative_detection_tpu.data import nuscenes as jax_nusc
from generative_detection_tpu.data.datamodule import collate as jax_collate
from generative_detection_tpu.eval import detection_metrics as jax_detection_metrics
from generative_detection_tpu.eval import evaluate_detections as jax_evaluate
from generative_detection_tpu.ops import resize as jax_resize
from generative_detection_tpu.serving import make_detector_fn as jax_make_detector_fn
from generative_detection_tpu_torch import compute_dataset_stats, compute_hmin_hmax
from generative_detection_tpu_torch import eval_cli, validate_nuscenes
from generative_detection_tpu_torch.config import instantiate_from_config, merge_configs
from generative_detection_tpu_torch.data import native, nuscenes
from generative_detection_tpu_torch.data.datamodule import collate
from generative_detection_tpu_torch.eval import (
    detection_metrics, evaluate_detections, frame_ids_from_batch,
)
from generative_detection_tpu_torch.losses.contperceptual import LABEL_NAMES
from generative_detection_tpu_torch.models import autoencoder as port_autoencoder
from generative_detection_tpu_torch.ops import resize
from generative_detection_tpu_torch.serving import make_detector_fn
from generative_detection_tpu_torch.utils.jax_compat import state_dict_from_jax
from tests._torch_cpu import deleted_after, one_torch_thread, tmp_path  # noqa: F401 (fixtures)

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
import validate_nuscenes as jax_validate_tool  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
TINY = str(REPO / "configs/autoencoder/pose/tiny_cpu.yaml")
FLAGSHIP = str(REPO / "configs/autoencoder/pose/autoencoder_kl_16x16x16.yaml")
LABELS = ["car", "truck", "pedestrian", "background"]
CAM2IMG = [[1266.0, 0.0, 800.0], [0.0, 1266.0, 450.0], [0.0, 0.0, 1.0]]
INSTANCES = [
    # a car in the middle of the frame
    {"bbox": [700.0, 380.0, 900.0, 520.0], "bbox_label": 0,
     "bbox_3d": [1.2, 0.8, 20.0, 4.0, 1.6, 1.9, 0.4], "center_2d": [800.0, 450.0]},
    # a pedestrian whose box runs past the left edge (negative mask corners)
    {"bbox": [-40.0, 300.0, 120.0, 420.0], "bbox_label": 7,
     "bbox_3d": [-9.0, 0.5, 12.0, 0.7, 1.8, 0.6, -1.1], "center_2d": [40.0, 360.0]},
    # a close-up truck: a crop above 400 px without perturb_scale
    {"bbox": [300.0, 200.0, 820.0, 720.0], "bbox_label": 1,
     "bbox_3d": [-2.0, 1.0, 7.0, 7.5, 3.2, 2.6, 2.9], "center_2d": [560.0, 460.0]},
    # a box wholly past the right edge with its centre in the frame
    {"bbox": [1650.0, 100.0, 1750.0, 200.0], "bbox_label": 0,
     "bbox_3d": [14.0, -3.0, 25.0, 4.2, 1.5, 1.8, 0.1], "center_2d": [1590.0, 150.0]},
    # a barrier, not among LABELS: filtered out
    {"bbox": [1000.0, 500.0, 1100.0, 560.0], "bbox_label": 9,
     "bbox_3d": [5.0, 1.0, 30.0, 0.5, 1.0, 2.0, 0.0], "center_2d": [1050.0, 530.0]},
]


def _fake_infos(root: Path, n_samples: int = 3) -> Path:
    """A tiny mmdet3d-style nuScenes tree: an info pkl and 1600x900 JPEG
    frames for CAM_FRONT (with instances) and CAM_BACK (none: background
    only); the other cameras' files are missing (such items skip forward)."""
    rng = np.random.default_rng(5)
    yy, xx = np.mgrid[0:900, 0:1600].astype(np.float32)
    data_list = []
    for s in range(n_samples):
        fname = f"img_{s}.jpg"
        for cam in ("CAM_FRONT", "CAM_BACK"):
            os.makedirs(root / "samples" / cam, exist_ok=True)
            img = np.stack([127 + 100 * np.sin(xx / 97.0 + s) * np.cos(yy / 83.0),
                            127 + 100 * np.cos(xx / 61.0) * np.sin(yy / 127.0 + s),
                            (xx + yy) % 256], axis=-1)
            img += rng.uniform(-20, 20, size=(900, 1600, 1))
            Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(
                root / "samples" / cam / fname, quality=90)
        images = {c: {"img_path": f"somewhere/{fname}", "cam2img": CAM2IMG}
                  for c in nuscenes.CAMERA_NAMES}
        front = INSTANCES[: 2 + s]  # sample 1 adds the close-up, sample 2 the edge box
        if s == 2:
            front = front + INSTANCES[4:]
        data_list.append({"sample_idx": s, "images": images,
                          "cam_instances": {c: (front if c == "CAM_FRONT" else [])
                                            for c in images}})
    with open(root / "nuscenes_infos_train.pkl", "wb") as f:
        pickle.dump({"metainfo": {}, "data_list": data_list}, f)
    with open(root / "nuscenes_infos_val.pkl", "wb") as f:
        pickle.dump(data_list, f)  # the bare-list layout
    return root


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    with deleted_after(tmp_path_factory.mktemp("nuscenes")) as root:
        yield _fake_infos(root)


def _assert_items_equal(got: dict, want: dict) -> None:
    assert list(got) == list(want)
    for k, w in want.items():
        g = got[k]
        if isinstance(w, (str, int, float)):
            assert type(g) is type(w) and g == w, k
        else:
            g, w = np.asarray(g), np.asarray(w)
            assert g.dtype == w.dtype and np.array_equal(g, w), k


def _readers(tree, **kw):
    kw = dict(data_root=str(tree), label_names=LABELS, seed=3, h_minmax_dir=str(tree), **kw)
    return nuscenes.NuScenesTrain(**kw), jax_nusc.NuScenesTrain(**kw)


# -- native ops ---------------------------------------------------------------------


def test_native_ops_match_jax_binding():
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, size=(300, 280, 3)).astype(np.uint8)
    for x1, y1, size, out in ((-20, 30, 200, 64), (100, 250, 90, 256), (0, 0, 280, 33)):
        got = native.crop_resize_bilinear(img, x1, y1, size, out, out)
        assert np.array_equal(got, jax_native.crop_resize_bilinear(img, x1, y1, size, out, out))
    for box in ((16, 16, 48, 48), (-5.5, 3.2, 70.9, 20.1), (0, 0, 0, 0)):
        assert np.array_equal(native.bbox_mask(64, box, 32, 40),
                              jax_native.bbox_mask(64, box, 32, 40))
    assert np.array_equal(native.resize_bilinear(img, 47, 61),
                          jax_native.resize_bilinear(img, 47, 61))
    box = np.float32([0, 0, 10, 10])
    boxes = rng.uniform(0, 20, size=(7, 4)).astype(np.float32)
    boxes[:, 2:] += boxes[:, :2]
    assert native.max_iou(box, boxes) == jax_native.max_iou(box, boxes)
    assert native.max_iou(box, np.zeros((0, 4), np.float32)) is None


def test_native_jpeg_region_matches_jax_binding(tree):
    if native.load_jpeg_lib() is None or jax_native.load_jpeg_lib() is None:
        pytest.skip("libjpeg is not on this host: the reader takes PIL's path")
    path = str(tree / "samples" / "CAM_FRONT" / "img_0.jpg")
    data = np.fromfile(path, np.uint8)
    assert native.jpeg_dims(data) == Image.open(path).size
    full = np.asarray(Image.open(path).convert("RGB"))
    for x, y, w, h in ((0, 0, 64, 64), (1530, 850, 100, 100), (-30, 417, 400, 400)):
        got = native.jpeg_region(data, x, y, w, h)
        assert np.array_equal(got, jax_native.jpeg_region(data, x, y, w, h))
        ix1, iy1 = max(x, 0), max(y, 0)
        assert np.array_equal(got[iy1 - y: iy1 - y + 20, ix1 - x: ix1 - x + 20],
                              full[iy1: iy1 + 20, ix1: ix1 + 20])


# -- resize ops -----------------------------------------------------------------------


@pytest.mark.parametrize("op", ["resize_bilinear", "batched_crop_resize", "bbox_mask",
                                "resize_nearest"])
def test_resize_ops_match_jax(op):
    rng = np.random.default_rng(1)
    if op in ("resize_bilinear", "resize_nearest"):
        img = rng.uniform(0, 1, size=(2, 37, 41, 3)).astype(np.float32)
        for oh, ow in ((16, 20), (64, 80), (37, 41)):
            got = getattr(resize, op)(torch.from_numpy(img), oh, ow).numpy()
            want = np.asarray(getattr(jax_resize, op)(jnp.asarray(img), oh, ow))
            assert got.shape == want.shape == (2, oh, ow, 3)
            if op == "resize_nearest":
                assert np.array_equal(got, want)
            else:
                np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)
        return
    b, out = 6, 32
    sizes = np.float32([7, 20, 50, 60, 33, 400])
    if op == "batched_crop_resize":
        frames = rng.integers(0, 256, size=(b, 60, 60, 3)).astype(np.uint8)
        centers = rng.uniform(-10, 70, size=(b, 2)).astype(np.float32)
        got = resize.batched_crop_resize(torch.from_numpy(frames), torch.from_numpy(centers),
                                         torch.from_numpy(sizes), out).numpy()
        want = np.asarray(jax_resize.batched_crop_resize(
            jnp.asarray(frames), jnp.asarray(centers), jnp.asarray(sizes), out_size=out))
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)
        assert got.dtype == want.dtype == np.float32
    else:
        corner = rng.uniform(-20, 0.6 * sizes[:, None], size=(b, 2))
        boxes = np.concatenate([corner, corner + rng.uniform(2, 0.6 * sizes[:, None], size=(b, 2))],
                               axis=1).astype(np.float32)
        got = resize.bbox_mask(torch.from_numpy(boxes), torch.from_numpy(sizes), out).numpy()
        want = np.asarray(jax_resize.bbox_mask(jnp.asarray(boxes), jnp.asarray(sizes), out))
        assert got.shape == (b, out, out, 1) and np.array_equal(got, want)
        assert 0 < got.mean() < 1


# -- the reader -------------------------------------------------------------------------


@pytest.mark.parametrize("device_preprocess", [False, True], ids=["float", "raw_crop"])
@pytest.mark.parametrize("perturb_scale", [True, False], ids=["perturbed", "unsnapped"])
def test_reader_items_match_jax(tree, device_preprocess, perturb_scale):
    """Every field of every item over two passes, object and background
    items, skip-forward past cameras with no frame or no instance."""
    port, jax_ds = _readers(tree, perturb_center=True, perturb_scale=perturb_scale,
                            device_preprocess=device_preprocess, patch_height=64,
                            negative_sample_prob=0.4)
    assert len(port) == len(jax_ds) == 18 and port.frame_route in ("native-jpeg", "pil")
    seen = set()
    for i in list(range(len(port))) * 2:
        got, want = port[i], jax_ds[i]
        _assert_items_equal(got, want)
        seen.add(got["class_name"])
        if got["class_name"] != "background":
            seen.add("object")
        if float(got["patch_size"][0, 0]) > 400:
            seen.add("above 400")
        if device_preprocess and float(np.min(got["bbox_in_crop"])) < 0:
            seen.add("negative mask corner")
    assert {"background", "object"} <= seen
    if not perturb_scale:
        assert "above 400" in seen
    if device_preprocess:
        assert "negative mask corner" in seen


def test_pose_labels_closed_form_matches_transform_stack(tree):
    port, _ = _readers(tree)
    for inst in INSTANCES[:4]:
        for center, size, fill in (([800, 450], 200.0, 0.1), ([560, 460], 520.0, 0.0)):
            label = nuscenes.LABEL_ID2NAME[inst["bbox_label"]]
            args = (inst["bbox_3d"], center, size, 256 / size, fill, label)
            pose, sizes, yaw = port._pose_labels(CAM2IMG, *args)
            pose_t, sizes_t, yaw_t = port._pose_labels_impl(port._camera_for(CAM2IMG), *args)
            np.testing.assert_allclose(pose, pose_t, rtol=1e-4, atol=1e-5)
            assert np.array_equal(sizes, sizes_t) and yaw == yaw_t


INFO_LAYOUTS = {
    "dict": {"metainfo": {}, "data_list": [{"images": {}, "cam_instances": {}}]},
    "list": [{"images": {}, "cam_instances": {}}],
    "empty": {"metainfo": {}, "data_list": []},
    "pre_1_1": {"infos": [{"cams": {}}]},
    "unknown_dict": {"samples": []},
    "not_a_container": 7,
    "no_images": [{"token": "x", "cams": {}}],
    "no_cam_instances": [{"images": {}}],
}


@pytest.mark.parametrize("layout", list(INFO_LAYOUTS))
def test_validate_infos_matches_jax(layout):
    infos = INFO_LAYOUTS[layout]
    try:
        want = jax_nusc.NuScenesBase._validate_infos(infos, "x.pkl")
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            nuscenes.NuScenesBase._validate_infos(infos, "x.pkl")
        assert str(got.value) == str(e)
    else:
        assert nuscenes.NuScenesBase._validate_infos(infos, "x.pkl") == want


def test_h_minmax_defaults_match_jax(tmp_path, caplog):
    with caplog.at_level(logging.WARNING):
        got = nuscenes.NuScenesBase._load_h_minmax(str(tmp_path))
    assert got == jax_nusc.NuScenesBase._load_h_minmax(str(tmp_path))
    assert "hmin/hmax stats not found" in caplog.text


# -- batch preparation --------------------------------------------------------------------


def _models():
    port_cfg, jax_cfg = merge_configs([TINY]), jax_merge([TINY])
    return (instantiate_from_config(port_cfg["model"]), jax_instantiate(jax_cfg["model"]))


def test_raw_prepare_batch_matches_jax(tree):
    port, jax_ds = _readers(tree, device_preprocess=True, patch_height=32, perturb_scale=False,
                            negative_sample_prob=0.3)
    items = [port[i] for i in range(10)]
    assert all(_assert_items_equal(g, jax_ds[i]) is None for i, g in enumerate(items))
    batch = collate(items)
    pm, jm = _models()
    before = port_autoencoder.batch_contracts["raw"]
    got = pm.prepare_batch(batch, device="cpu")
    assert port_autoencoder.batch_contracts["raw"] == before + 1
    want = jm.prepare_batch(jax_collate(items))
    assert set(got) == set(want)
    np.testing.assert_allclose(got["rgb_gt"].numpy(), np.asarray(want["rgb_gt"]), rtol=0,
                               atol=2e-6)
    assert np.array_equal(got["mask_2d_bbox"].numpy(), np.asarray(want["mask_2d_bbox"]))
    assert got["mask_2d_bbox"].sum() > 0
    for k in ("pose_gt", "bbox_gt", "fill_factor_gt", "yaw_perturbed", "class_gt"):
        assert np.array_equal(got[k].numpy(), np.asarray(want[k], got[k].numpy().dtype)), k


# -- the tools --------------------------------------------------------------------------------


def test_stats_tools_match_jax(tree, tmp_path, monkeypatch):
    cfg = tmp_path / "stats.yaml"
    cfg.write_text(f"""
data:
  params:
    train:
      target: generative_detection_tpu.data.nuscenes.NuScenesTrain
      params: {{data_root: {tree}, label_names: {LABELS}, patch_height: 32, seed: 0,
               negative_sample_prob: 0.2, h_minmax_dir: {tree}}}
""")
    outs = {}
    for name, stats_main, hminmax_main in (
            ("port", compute_dataset_stats.main, compute_hmin_hmax.main),
            ("jax", jax_stats_tool.main, jax_hminmax_tool.main)):
        out = tmp_path / name
        argv = ["-b", str(cfg), "--out", str(out), "--limit", "18"]
        if name == "port":
            stats_main(argv)
            hminmax_main(["--stats_dir", str(out / "combined")])
        else:
            monkeypatch.setattr(sys, "argv", ["compute_dataset_stats.py", *argv])
            stats_main()
            monkeypatch.setattr(sys, "argv", ["compute_hmin_hmax.py", "--stats_dir",
                                              str(out / "combined")])
            hminmax_main()
        outs[name] = {f: pickle.loads((out / "combined" / f).read_bytes())
                      for f in ("all.pkl", "raw_moments.pkl", "hmin.pkl", "hmax.pkl")}
    assert outs["port"]["all.pkl"] and outs["port"] == outs["jax"]


@pytest.mark.parametrize("device_preprocess", [False, True], ids=["float", "raw_crop"])
def test_validate_tool_matches_jax(tree, device_preprocess):
    def strip(report):
        # the hint names the port's tools where the JAX package names its scripts
        report["warnings"] = [w.replace("compute_dataset_stats.py + compute_hmin_hmax.py",
                                        "compute_dataset_stats + compute_hmin_hmax")
                              for w in report["warnings"]]
        for stage in report["stages"].values():
            for k in [k for k in stage if k.endswith("_s") or k.endswith("_ms") or k == "s"]:
                del stage[k]
        return report

    kw = dict(check_images=3, items=12, h_minmax_dir=str(tree / "none"),
              device_preprocess=device_preprocess, patch_height=32)
    got = validate_nuscenes.validate(str(tree), **kw)
    assert strip(got) == strip(jax_validate_tool.validate(str(tree), **kw))
    assert got["ok"] and got["warnings"] and got["stages"]["images"]["missing"] == 12
    bad = validate_nuscenes.validate(str(tree), ann_file="missing.pkl")
    assert bad == jax_validate_tool.validate(str(tree), ann_file="missing.pkl")
    assert not bad["ok"]


def test_flagship_data_node_instantiates(tree):
    """The shipped yaml's data node (NuScenesTrain / NuScenesValidation under
    the JAX package's names) on a fixture data_root."""
    cfg = merge_configs([FLAGSHIP], [f"_nuscenes_params.data_root={tree}",
                                     f"data.params.train.params.data_root={tree}",
                                     f"data.params.validation.params.data_root={tree}"])
    data = instantiate_from_config(cfg["data"])
    data.setup()
    try:
        train, val = data.datasets["train"].data, data.datasets["validation"].data
        assert type(train) is nuscenes.NuScenesTrain and type(val) is nuscenes.NuScenesValidation
        assert train.perturb_center and train.perturb_scale and train.patch_size == (256, 256)
        item = val[0]
        assert item["patch"].shape == (256, 256, 3) and len(val) == 18
    finally:
        data.teardown()


# -- the slice as a whole --------------------------------------------------------------------


def _seeded_params(jm, seed=11):
    """Seeded numpy weights in the flax tree of ``jm``'s network (its shapes
    from ``jax.eval_shape``, no init compile): kernels scaled by their fan-in,
    GroupNorm scales near 1, biases small."""
    k = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(jm.net.init, {"params": k, "sample": k, "dropout": k, "noise": k},
                            jnp.zeros((1, 32, 32, 3)), jnp.asarray(0, jnp.int32))["params"]
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        x = rng.normal(size=leaf.shape)
        if len(leaf.shape) >= 2:
            x /= np.sqrt(np.prod(leaf.shape[:-1]))
        elif path[-1].key == "scale":
            x = 1.0 + 0.1 * x
        else:
            x *= 0.1
        return x.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def test_slice_reader_to_evaluator_matches_jax(tree):
    """Fixture tree -> both readers (device_preprocess) -> prepare_batch ->
    the tiny_cpu.yaml detector in both, weights carried across -> boxes ->
    both evaluators on the port's predictions."""
    port, jax_ds = _readers(tree, device_preprocess=True, patch_height=32, perturb_scale=False,
                            negative_sample_prob=0.2)
    items = [port[i] for i in range(8)]
    jitems = [jax_ds[i] for i in range(8)]
    pm, jm = _models()
    prepared = pm.prepare_batch(collate(items), device="cpu")
    jprepared = jm.prepare_batch(jax_collate(jitems))
    params = _seeded_params(jm)
    b = collate(items)
    hmin = np.full((11,), 0.5, np.float32)
    hmax = np.full((11,), 4.0, np.float32)
    cams = (b["cam2img"][:, 0, 0], b["cam2img"][:, :2, 2], b["patch_size"][:, 0, 0],
            b["patch_center_2d"], b["resampling_factor"])
    want = jax_make_detector_fn(jm, params, jnp.asarray(hmin), jnp.asarray(hmax), 32,
                                dtype="float32")(jprepared["rgb_gt"], *map(jnp.asarray, cams))
    want = [np.asarray(a) for a in want]
    det = make_detector_fn(pm, state_dict_from_jax(params), hmin, hmax, 32, dtype="float32",
                           device="cpu")
    boxes, cls, score = [a.numpy() for a in det(prepared["rgb_gt"], *cams)]
    np.testing.assert_allclose(boxes, want[0], rtol=1e-3, atol=1e-4)
    np.testing.assert_array_equal(cls, want[1])
    np.testing.assert_allclose(score, want[2], rtol=1e-5, atol=1e-6)

    gt = b["bbox_3d_gt"]
    gtcls = b["original_class_id"]
    fg = gtcls != 10
    assert detection_metrics(boxes, cls, gt, gtcls, fg) == pytest.approx(
        jax_detection_metrics(boxes, cls, gt, gtcls, fg), rel=0, abs=1e-12)
    frames = frame_ids_from_batch(b, 8)
    assert np.array_equal(frames, b["sample_idx"] * 64 + b["cam_idx"])
    # the ground truths also stand in as confident predictions, so that some match
    preds, gts = eval_cli.set_boxes(
        np.concatenate([boxes, gt]), np.concatenate([cls, gtcls]), np.concatenate([gt, gt]),
        np.concatenate([gtcls, gtcls]), np.concatenate([fg, fg]),
        np.concatenate([score, np.full(8, 0.9, np.float32)]), np.concatenate([frames, frames]),
        LABEL_NAMES)
    names = [n for n in LABEL_NAMES if n != "background"]
    got = evaluate_detections(preds, gts, names)
    want = jax_evaluate(preds, gts, names)
    assert set(got) == set(want) and got["mAP"] > 0
    for k, v in want.items():
        assert got[k] == pytest.approx(v, rel=0, abs=1e-12), k
