"""Port parity on the CPU for the data slice: the synthetic datasets, the
datamodule's loaders and the camera geometry, against the JAX package.

Tolerances:
- items and batches: bit-equal (``np.array_equal`` with equal dtypes; strings
  equal), for the same seed;
- camera transforms and projected points: 1e-5 relative, plus 1e-6 absolute
  for entries that are zero by construction (both sides float32);
- the numpy closed form of the labels against the torch transform stack:
  1e-4 relative and 1e-5 absolute on the pose (the JAX package's own bound
  for its pair), bit-equal sizes and yaw.
"""

import threading
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generative_detection_tpu.config import instantiate_from_config as jax_instantiate
from generative_detection_tpu.config import merge_configs as jax_merge
from generative_detection_tpu.data import synthetic as jax_synthetic
from generative_detection_tpu.geometry import PatchPerspectiveCameras as JaxCameras
from generative_detection_tpu.geometry import (
    get_ndc_to_patch_ndc_transform as jax_ndc_to_patch,
)
from generative_detection_tpu.geometry import (
    get_patch_ndc_to_ndc_transform as jax_patch_to_ndc,
)
from generative_detection_tpu_torch.config import instantiate_from_config, merge_configs
from generative_detection_tpu_torch.data import datamodule as port_dm
from generative_detection_tpu_torch.data import synthetic as port_synthetic
from generative_detection_tpu_torch.geometry import (
    PatchPerspectiveCameras,
    get_ndc_to_patch_ndc_transform,
    get_patch_ndc_to_ndc_transform,
)
from tests._torch_cpu import one_torch_thread  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parents[1]
TINY = str(REPO / "configs/autoencoder/pose/tiny_cpu.yaml")
EPOCHS = 2


def _assert_items_equal(got: dict, want: dict) -> None:
    assert list(got) == list(want)
    for k, w in want.items():
        g = got[k]
        if isinstance(w, (str, int, float)):
            assert type(g) is type(w) and g == w, k
        else:
            assert isinstance(g, np.ndarray) == isinstance(w, np.ndarray), k
            g, w = np.asarray(g), np.asarray(w)
            assert g.dtype == w.dtype and np.array_equal(g, w), k


@pytest.mark.parametrize("device_preprocess", [False, True], ids=["float", "raw_crop"])
@pytest.mark.parametrize("split", ["SyntheticPatchTrain", "SyntheticPatchValidation",
                                   "SyntheticPatchTest"])
def test_synthetic_patch_items_are_bit_equal(split, device_preprocess):
    kw = dict(length=12, patch_height=32, device_preprocess=device_preprocess, seed=5)
    jds = getattr(jax_synthetic, split)(**kw)
    pds = getattr(port_synthetic, split)(**kw)
    assert len(pds) == len(jds)
    names = set()
    for i in range(len(jds)):
        want = jds[i]
        _assert_items_equal(pds[i], want)
        names.add(want["class_name"] == "background")
    assert names == {True, False}, "both object and background items"


@pytest.mark.parametrize("split", ["SyntheticImageTrain", "SyntheticImageValidation"])
def test_synthetic_image_items_are_bit_equal(split):
    jds = getattr(jax_synthetic, split)(length=4, patch_height=32)
    pds = getattr(port_synthetic, split)(length=4, patch_height=32)
    for i in range(4):
        _assert_items_equal(pds[i], jds[i])


@pytest.fixture(scope="module")
def jax_batches():
    """The JAX datamodule's train batches (inline) over two epochs of
    ``tiny_cpu.yaml``, and its validation batches."""
    cfg = jax_merge([TINY])["data"]
    dm = jax_instantiate(cfg)
    dm.setup()
    train = [list(dm.train_dataloader()) for _ in range(EPOCHS)]
    return train, list(dm.val_dataloader())


def _port_dm(**params):
    cfg = merge_configs([TINY])["data"]
    cfg["params"].update(params)
    dm = instantiate_from_config(cfg)
    assert isinstance(dm, port_dm.DataModuleFromConfig)
    dm.setup()
    return dm


@pytest.mark.parametrize(
    "params",
    [dict(num_workers=0), dict(num_workers=2),
     dict(num_workers=1, worker_type="process")],
    ids=["inline", "thread", "process"],
)
def test_datamodule_batches_are_bit_equal(jax_batches, params):
    train, val = jax_batches
    dm = _port_dm(**params)
    try:
        got = [list(dm.train_dataloader()) for _ in range(EPOCHS)]
        got_val = list(dm.val_dataloader())
    finally:
        dm.teardown()
    assert len(got[0]) == len(train[0]) == 2
    # the per-epoch reshuffle: the two epochs differ in order
    assert not np.array_equal(train[0][0]["patch"], train[1][0]["patch"])
    for got_epoch, want_epoch in zip(got + [got_val], train + [val]):
        assert len(got_epoch) == len(want_epoch)
        for g, w in zip(got_epoch, want_epoch):
            _assert_items_equal(g, w)


class _IterableSynthetic:
    """An iterable-style dataset (``__iter__``, no ``__getitem__``)."""

    def __init__(self, module, n=11):
        self.ds = module.SyntheticPatchTrain(length=n, patch_height=16)

    def __iter__(self):
        return (self.ds[i] for i in range(len(self.ds)))


@pytest.mark.parametrize("num_workers", [0, 2], ids=["inline", "producer_thread"])
@pytest.mark.parametrize("drop_last", [True, False])
def test_iterable_dataset_batches_are_bit_equal(num_workers, drop_last):
    from generative_detection_tpu.data.datamodule import _Loader as JaxLoader

    want = list(JaxLoader(_IterableSynthetic(jax_synthetic), 4, shuffle=False,
                          drop_last=drop_last)())
    loader = port_dm._Loader(_IterableSynthetic(port_synthetic), 4, shuffle=False,
                             num_workers=num_workers, drop_last=drop_last)
    got = list(loader())
    assert len(got) == len(want) == (2 if drop_last else 3)
    for g, w in zip(got, want):
        _assert_items_equal(g, w)
    with pytest.raises(TypeError):
        len(loader)


def _loader_threads():
    return [t for t in threading.enumerate() if t.name.startswith(port_dm.THREAD_NAME)]


@pytest.mark.parametrize("iterable", [False, True], ids=["map", "iterable"])
def test_loader_stopped_early_leaves_no_thread(iterable):
    """A consumer that takes one batch and closes the epoch: the producer,
    blocked on its full queue, stops and is joined."""
    ds = (_IterableSynthetic(port_synthetic, 40) if iterable
          else port_synthetic.SyntheticPatchTrain(length=40, patch_height=16))
    loader = port_dm._Loader(ds, 2, shuffle=False, num_workers=2, prefetch=1)
    epoch = loader()
    next(epoch)
    assert _loader_threads()
    epoch.close()
    assert not _loader_threads()


def test_thread_loader_raises_what_an_item_raises():
    class Broken:
        def __len__(self):
            return 4

        def __getitem__(self, i):
            raise ValueError(f"item {i}")

    with pytest.raises(ValueError, match="item"):
        list(port_dm._Loader(Broken(), 2, shuffle=False, num_workers=2)())
    assert not _loader_threads()


# -- geometry --------------------------------------------------------------------

CAM = dict(focal_length=-1266.0, principal_point=[[816.0, 491.0]], image_size=[[900, 1600]],
           znear=0.01, zfar=55.0)
PATCH = dict(patch_size=[[200.0, 200.0]], patch_center=[[900.0, 500.0]])
POINTS = [[[1.0, 0.5, 12.0], [-2.0, 1.5, 30.0], [3.0, -0.4, 7.5]]]


def _close(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-6)


def test_cameras_match_jax():
    jc, pc = JaxCameras.create(**CAM), PatchPerspectiveCameras.create(**CAM)
    for name in ("get_world_to_view_transform", "get_projection_transform",
                 "get_full_projection_transform", "get_ndc_camera_transform"):
        _close(getattr(pc, name)().get_matrix(), getattr(jc, name)().get_matrix())
    _close(pc.get_patch_projection_transform(**PATCH).get_matrix(),
           jc.get_patch_projection_transform(**PATCH).get_matrix())
    pts = jnp.asarray(POINTS)
    for flip in (True, False):
        _close(pc.transform_points_screen(POINTS, with_xyflip=flip),
               jc.transform_points_screen(pts, with_xyflip=flip))
    _close(pc.transform_points_ndc(POINTS), jc.transform_points_ndc(pts))
    _close(pc.transform_points_patch_ndc(POINTS, **PATCH),
           jc.transform_points_patch_ndc(pts, **PATCH))
    # the round trip through the composed projection's inverse
    projected = pc.get_patch_projection_transform(**PATCH).transform_points(POINTS)
    back = pc.transform_points_world_from_patch_ndc(projected, **PATCH)
    _close(back, jc.transform_points_world_from_patch_ndc(jnp.asarray(projected.numpy()), **PATCH))
    np.testing.assert_allclose(back.numpy(), np.asarray(POINTS), rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("with_xyflip", [False, True])
def test_patch_ndc_transforms_match_jax(with_xyflip):
    jc, pc = JaxCameras.create(**CAM), PatchPerspectiveCameras.create(**CAM)
    kw = dict(with_xyflip=with_xyflip, image_size=[[900, 1600]], **PATCH)
    fwd = get_ndc_to_patch_ndc_transform(pc, **kw)
    _close(fwd.get_matrix(), jax_ndc_to_patch(jc, **kw).get_matrix())
    inv = get_patch_ndc_to_ndc_transform(pc, **kw)
    _close(inv.get_matrix(), jax_patch_to_ndc(jc, **kw).get_matrix())
    _close(fwd.compose(inv).get_matrix(), torch.eye(4)[None])
    with pytest.raises(ValueError):
        get_ndc_to_patch_ndc_transform(pc, patch_size=[[1.0, 1.0]])


@pytest.mark.parametrize(
    "box",
    [
        dict(x=2.0, y=0.7, z=21.0, l=4.2, h=1.7, w=2.0, yaw=0.6, patch_center=(860.0, 480.0),
             patch_size_pixels=100.0, patch_resampling_factor=2.56, fill_factor=0.12),
        dict(x=-6.0, y=1.9, z=38.0, l=1.1, h=0.9, w=0.6, yaw=-2.9, patch_center=(601.0, 512.0),
             patch_size_pixels=50.0, patch_resampling_factor=5.12, fill_factor=0.0),
        dict(x=0.5, y=-0.2, z=8.5, l=11.0, h=3.4, w=2.6, yaw=3.1, patch_center=(874.0, 441.0),
             patch_size_pixels=400.0, patch_resampling_factor=0.64, fill_factor=0.29),
    ],
)
def test_closed_form_labels_match_the_transform_stack(box):
    args = dict(box, hmin=0.5, hmax=4.0)
    pose_np, sizes_np, yaw_np = port_synthetic.pose_labels_from_box(**args)
    pose_t, sizes_t, yaw_t = port_synthetic.pose_labels_from_box_torch(**args)
    np.testing.assert_allclose(pose_np, pose_t, rtol=1e-4, atol=1e-5)
    assert np.array_equal(sizes_np, sizes_t) and yaw_np == yaw_t
    want = jax_synthetic.pose_labels_from_box(**args)
    assert all(np.array_equal(a, b) for a, b in zip((pose_np, sizes_np), want[:2]))
