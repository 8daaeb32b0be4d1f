"""Port parity on the CPU for the evaluation half of the nuScenes slice: the
set-based evaluator, the per-patch metrics, PSNR and the frame ids against
the JAX package, and ``eval_cli`` in-process with JAX blocked.

Tolerance: 1e-12 absolute on every metric (both sides are the same numpy
arithmetic on the same inputs).
"""

import json
import sys

import numpy as np
import pytest
import torch

from generative_detection_tpu import eval as jax_eval
from generative_detection_tpu_torch import eval as port_eval
from generative_detection_tpu_torch import eval_cli
from generative_detection_tpu_torch.losses.contperceptual import LABEL_NAMES
from generative_detection_tpu_torch.models import autoencoder as port_autoencoder
from generative_detection_tpu_torch.train.state import flax_like_net
from tests._torch_cpu import one_torch_thread  # noqa: F401 (autouse)
from tests.test_torch_port_nuscenes import TINY, _fake_infos, _models

CLASSES = [n for n in LABEL_NAMES if n != "background"]


def _close(got: dict, want: dict) -> None:
    assert list(got) == list(want)
    for k, v in want.items():
        assert got[k] == pytest.approx(v, rel=0, abs=1e-12), k


def _scene(seed: int, n_frames: int = 6):
    """Seeded ground truths and noisy, partly duplicated, partly missed
    predictions over a few frames and classes (barriers among them)."""
    rng = np.random.default_rng(seed)
    preds, gts = [], []
    for f in range(n_frames):
        for _ in range(rng.integers(1, 5)):
            g = {"frame": f, "class_name": str(rng.choice(["car", "pedestrian", "barrier"])),
                 "center": rng.uniform(-20, 20, size=2).astype(np.float32),
                 "size": rng.uniform(0.5, 4, size=3).astype(np.float32),
                 "yaw": float(rng.uniform(-np.pi, np.pi))}
            gts.append(g)
            for _ in range(rng.integers(0, 3)):
                preds.append({**g, "center": g["center"] + rng.normal(0, 1.5, 2).astype(np.float32),
                              "size": g["size"] * rng.uniform(0.7, 1.3, 3).astype(np.float32),
                              "yaw": g["yaw"] + float(rng.normal(0, 0.5)),
                              "score": float(rng.uniform())})
        preds.append({"frame": f, "class_name": "truck", "score": float(rng.uniform()),
                      "center": rng.uniform(-20, 20, size=2).astype(np.float32),
                      "size": np.ones(3, np.float32), "yaw": 0.0})
    return preds, gts


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_evaluate_detections_matches_jax(seed):
    preds, gts = _scene(seed)
    got = port_eval.evaluate_detections(preds, gts, CLASSES)
    _close(got, jax_eval.evaluate_detections(preds, gts, CLASSES))
    assert 0 < got["mAP"] <= 1 and "AP/barrier" in got
    assert port_eval.evaluate_detections(preds, [], CLASSES) == \
        jax_eval.evaluate_detections(preds, [], CLASSES)


def test_detection_metrics_and_psnr_match_jax():
    rng = np.random.default_rng(3)
    n = 40
    gt = rng.uniform(-10, 30, size=(n, 7)).astype(np.float32)
    pred = gt + rng.normal(0, 1.0, size=(n, 7)).astype(np.float32)
    gtcls = rng.integers(0, 11, size=n)
    cls = np.where(rng.uniform(size=n) < 0.7, gtcls, rng.integers(0, 11, size=n))
    for fg in (gtcls != 10, np.zeros(n, bool)):
        _close(port_eval.detection_metrics(pred, cls, gt, gtcls, fg),
               jax_eval.detection_metrics(pred, cls, gt, gtcls, fg))
    a = rng.uniform(-1, 1, size=(4, 8, 8, 3)).astype(np.float32)
    b = a + rng.normal(0, 0.05, size=a.shape).astype(np.float32)
    assert port_eval.psnr(a, b) == pytest.approx(jax_eval.psnr(a, b), rel=0, abs=1e-12)
    assert port_eval.psnr(a, a) == jax_eval.psnr(a, a) == float("inf")


def test_frame_ids_from_batch_matches_jax():
    batch = {"sample_idx": np.array([0, 3, 3, 7]), "cam_idx": np.array([5, 0, 1, 2])}
    got = port_eval.frame_ids_from_batch(batch, 4)
    assert got.dtype == np.int64
    assert np.array_equal(got, jax_eval.frame_ids_from_batch(batch, 4))
    assert np.array_equal(port_eval.frame_ids_from_batch({}, 3),
                          jax_eval.frame_ids_from_batch({}, 3))


def _block_jax(monkeypatch):
    """``import jax`` (and the JAX package, flax, optax, orbax) raises for
    the rest of the test, cached submodules included."""
    roots = ("jax", "jaxlib", "flax", "optax", "orbax", "generative_detection_tpu")
    for name in list(sys.modules):
        if name.split(".")[0] in roots:
            monkeypatch.setitem(sys.modules, name, None)
    for name in roots:
        monkeypatch.setitem(sys.modules, name, None)


@pytest.fixture(scope="module")
def nusc_tree(tmp_path_factory):
    return _fake_infos(tmp_path_factory.mktemp("nuscenes_eval"))


@pytest.mark.parametrize("data", ["synthetic", "synthetic_raw", "nuscenes_raw"])
def test_eval_cli_without_jax_matches_eval_py_metrics(data, nusc_tree, tmp_path, monkeypatch):
    """``eval_cli -b tiny_cpu.yaml --device cpu --limit 2`` in-process with
    JAX blocked; its JSON holds ``eval.py``'s keys, and its metrics are the
    JAX package's functions on the same predictions."""
    dotlist = []
    if data != "synthetic":
        dotlist.append("data.params.validation.params.device_preprocess=true")
    if data == "nuscenes_raw":
        dotlist += ["data.params.validation.target=src.data.datasets.nuscenes.NuScenesValidation",
                    f"data.params.validation.params.data_root={nusc_tree}",
                    f"data.params.validation.params.h_minmax_dir={nusc_tree}",
                    "data.params.validation.params.label_names=[car,truck,pedestrian,background]",
                    "data.params.validation.params.seed=0",
                    "data.params.batch_size=6"]
    captured = {}

    def spy(name):
        fn = getattr(port_eval, name)

        def wrapped(*args):
            captured[name] = args
            return fn(*args)
        return wrapped

    monkeypatch.setattr(port_eval, "detection_metrics", spy("detection_metrics"))
    monkeypatch.setattr(port_eval, "evaluate_detections", spy("evaluate_detections"))
    out = tmp_path / "metrics.json"
    raw_before = port_autoencoder.batch_contracts["raw"]
    with monkeypatch.context() as m:
        _block_jax(m)
        got = eval_cli.main(["-b", TINY, "--device", "cpu", "--limit", "2", "--out", str(out),
                             *dotlist])
    assert json.loads(out.read_text()) == got
    # tiny_cpu.yaml's validation split is one batch of 8; the fixture's 18 items, 3 of 6
    raw_batches = {"synthetic": 0, "synthetic_raw": 1, "nuscenes_raw": 2}[data]
    assert port_autoencoder.batch_contracts["raw"] - raw_before == raw_batches
    want = {"split": "validation", "psnr": got["psnr"], "kl": got["kl"], "step": 0}
    want.update(jax_eval.detection_metrics(*captured["detection_metrics"]))
    set_metrics = jax_eval.evaluate_detections(*captured["evaluate_detections"])
    want.update({f"set/{k}": v for k, v in set_metrics.items()})
    _close(got, want)
    assert all(np.isfinite(v) for k, v in got.items() if k != "split")
    if data == "nuscenes_raw":  # frames of the fixture, several patches a frame
        frames = [p["frame"] for p in captured["evaluate_detections"][1]]
        assert frames and len(set(frames)) < 12


def test_eval_cli_restores_params(tmp_path, monkeypatch):
    """``-r`` restores the network's parameters (and step) from a run's
    checkpoint layout; the metrics change with the weights."""
    pm, _ = _models()
    net = flax_like_net(pm, torch.Generator().manual_seed(99), "cpu")
    step_dir = tmp_path / "run" / "checkpoints" / "last" / "7"
    step_dir.mkdir(parents=True)
    torch.save(net.state_dict(), step_dir / "net.pt")
    (step_dir / "meta.json").write_text(json.dumps({"step": 7}))
    args = ["-b", TINY, "--device", "cpu", "--limit", "1"]
    with monkeypatch.context() as m:
        _block_jax(m)
        restored = eval_cli.main([*args, "-r", str(tmp_path / "run")])
        fresh = eval_cli.main(args)
    assert restored["step"] == 7 and fresh["step"] == 0
    assert restored["psnr"] != fresh["psnr"]
