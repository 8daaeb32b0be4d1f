"""Port parity on the CPU: the whole detector (encode -> pose decode -> 3D
boxes) on shared weights, box recovery and the geometry it rests on, against
the JAX package."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generative_detection_tpu import geometry as jgeo
from generative_detection_tpu.eval.inference import recover_boxes as jax_recover_boxes
from generative_detection_tpu.serving import make_detector_fn as jax_make_detector_fn
from generative_detection_tpu_torch import geometry as tgeo
from generative_detection_tpu.geometry.se3 import _se3_V as jax_se3_V
from generative_detection_tpu_torch.eval.inference import pose_inference, recover_boxes
from generative_detection_tpu_torch.geometry.se3 import _se3_V
from generative_detection_tpu_torch.models.autoencoder import cast_compute_dtype
from generative_detection_tpu_torch.serving import _resolve_serve_dtype, make_detector_fn
from generative_detection_tpu_torch.utils.jax_compat import state_dict_from_jax
from tests.test_models import small_model
from tests.test_torch_port_model import jax_net_params, port_small_model
from tests._torch_cpu import one_torch_thread  # noqa: F401 (autouse)

HMIN = np.full((11,), 0.5, np.float32)
HMAX = np.full((11,), 4.0, np.float32)


def _camera_args(rng, b):
    return (
        np.full((b,), 1266.0, np.float32),
        np.tile(np.float32([800.0, 450.0]), (b, 1)) + rng.normal(size=(b, 2)).astype(np.float32),
        rng.uniform(60, 200, size=(b,)).astype(np.float32),
        np.tile(np.float32([820.0, 460.0]), (b, 1)) + rng.normal(size=(b, 2)).astype(np.float32),
        rng.uniform(1.5, 3.0, size=(b,)).astype(np.float32),
    )


@pytest.fixture(scope="module")
def shared():
    jm = small_model()
    params = jax_net_params(jm)
    return jm, params, port_small_model(), state_dict_from_jax(params)


def _run_both(shared, dtype, monkeypatch):
    monkeypatch.delenv("GDT_SERVE_DTYPE", raising=False)
    jm, params, tm, sd = shared
    rng = np.random.default_rng(7)
    b = 4
    x = rng.normal(size=(b, 32, 32, 3)).astype(np.float32)
    cams = _camera_args(rng, b)
    jdet = jax_make_detector_fn(
        jm, params, jnp.asarray(HMIN), jnp.asarray(HMAX), 32,
        dtype="auto" if dtype == "auto" else "float32",
    )
    want = [np.asarray(a) for a in jdet(jnp.asarray(x), *map(jnp.asarray, cams))]
    tdet = make_detector_fn(tm, sd, HMIN, HMAX, 32, dtype=dtype, device="cpu")
    got = [a.numpy() for a in tdet(x, *cams)]
    assert got[0].shape == (b, 7) and got[0].dtype == np.float32
    return got, want


def test_detector_matches_jax_fp32(shared, monkeypatch):
    (boxes, cls, score), (wboxes, wcls, wscore) = _run_both(shared, "float32", monkeypatch)
    # the fp32 agreement of tests/test_serving.py (export vs live)
    np.testing.assert_allclose(boxes, wboxes, rtol=1e-3, atol=1e-4)
    np.testing.assert_array_equal(cls, wcls)
    np.testing.assert_allclose(score, wscore, rtol=1e-5, atol=1e-6)


def test_detector_matches_jax_bf16_default(shared, monkeypatch):
    """The bf16 default, at the agreement of tests/test_serving.py:48.

    With random weights the box centre is ill-conditioned in the decoded pose
    (depth scales with 1 / (1 - fill factor)), so bf16 rounding at other
    places in the two frameworks moves centres by percents, as
    tests/test_serving.py notes. The decoded pose, the box sizes, yaw and
    scores are held to the tolerance; centres only to being finite."""
    (boxes, _, score), (wboxes, _, wscore) = _run_both(shared, "auto", monkeypatch)
    tol = dict(rtol=3e-2, atol=5e-2)
    assert np.all(np.isfinite(boxes))
    np.testing.assert_allclose(boxes[:, 3:], wboxes[:, 3:], **tol)
    np.testing.assert_allclose(score, wscore, **tol)

    jm, params, tm, sd = shared
    x = np.random.default_rng(7).normal(size=(4, 32, 32, 3)).astype(np.float32)
    jnet = jm.net.clone(dtype=jnp.bfloat16)
    _, feat = jnet.apply({"params": params}, jnp.asarray(x), method=jnet.encode)
    want, _ = jnet.apply({"params": params}, feat, False, method=jnet._decode_pose,
                         rngs={"sample": jax.random.PRNGKey(0)})
    net = tm.build_net()
    net.load_state_dict(sd, strict=True)
    dec_pose, _, _ = pose_inference(cast_compute_dtype(net, torch.bfloat16), torch.from_numpy(x))
    np.testing.assert_allclose(dec_pose.numpy(), np.asarray(want, np.float32), **tol)


def test_serve_dtype_resolution(monkeypatch):
    monkeypatch.delenv("GDT_SERVE_DTYPE", raising=False)
    assert _resolve_serve_dtype("auto") == torch.bfloat16
    assert _resolve_serve_dtype(None) is None
    assert _resolve_serve_dtype("float32") is None
    assert _resolve_serve_dtype(torch.float16) == torch.float16
    monkeypatch.setenv("GDT_SERVE_DTYPE", "float32")
    assert _resolve_serve_dtype("auto") is None
    with pytest.raises(ValueError):
        _resolve_serve_dtype("float99")


def test_recover_boxes_matches_jax():
    rng = np.random.default_rng(8)
    b = 16
    dec_pose = rng.normal(size=(b, 19)).astype(np.float32)
    dec_pose[:, 7] = rng.uniform(0, 0.5, size=b)  # fill factor
    cams = _camera_args(rng, b)
    hmin = rng.uniform(0.3, 1.0, size=11).astype(np.float32)
    hmax = hmin + rng.uniform(1.0, 3.0, size=11).astype(np.float32)
    want = jax_recover_boxes(jnp.asarray(dec_pose), *map(jnp.asarray, cams),
                             jnp.asarray(hmin), jnp.asarray(hmax), patch_out=256)
    got = recover_boxes(torch.from_numpy(dec_pose), *map(torch.from_numpy, cams),
                        torch.from_numpy(hmin), torch.from_numpy(hmax), patch_out=256)
    np.testing.assert_allclose(got["boxes_3d"].numpy(), np.asarray(want["boxes_3d"]),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(got["class_id"].numpy(), np.asarray(want["class_id"]))
    np.testing.assert_allclose(got["score"].numpy(), np.asarray(want["score"]), rtol=1e-6)


def _both(fn_t, fn_j, *arrays, rtol=1e-5, atol=1e-6):
    got = fn_t(*(torch.from_numpy(np.array(a)) for a in arrays))
    want = fn_j(*map(jnp.asarray, arrays))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol, atol=atol)


@pytest.mark.parametrize("scale", [1e-5, 1.0])  # the Taylor branch and the closed form
def test_so3_se3_match_jax(scale):
    rng = np.random.default_rng(9)
    omega = (rng.normal(size=(32, 3)) * scale).astype(np.float32)
    _both(tgeo.hat, jgeo.hat, omega)
    _both(tgeo.so3_exp_map, jgeo.so3_exp_map, omega)
    _both(_se3_V, jax_se3_V, omega)
    rot = np.asarray(jgeo.so3_exp_map(jnp.asarray(omega)))
    _both(tgeo.so3_log_map, jgeo.so3_log_map, rot, atol=1e-4)
    log6 = np.concatenate([rng.normal(size=(32, 3)).astype(np.float32), omega], axis=1)
    _both(tgeo.se3_exp_map, jgeo.se3_exp_map, log6)
    m = np.asarray(jgeo.se3_exp_map(jnp.asarray(log6)))
    _both(tgeo.se3_log_map, jgeo.se3_log_map, m, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("convention", ["XYZ", "ZYX", "XZX"])
def test_euler_conversions_match_jax(convention):
    angles = np.random.default_rng(10).uniform(-1.2, 1.2, size=(32, 3)).astype(np.float32)
    _both(lambda a: tgeo.euler_angles_to_matrix(a, convention),
          lambda a: jgeo.euler_angles_to_matrix(a, convention), angles)
    rot = np.asarray(jgeo.euler_angles_to_matrix(jnp.asarray(angles), convention))
    _both(lambda r: tgeo.matrix_to_euler_angles(r, convention),
          lambda r: jgeo.matrix_to_euler_angles(r, convention), rot, atol=1e-5)


def test_z_remappings_match_jax():
    rng = np.random.default_rng(11)
    z, zmin, f = (rng.uniform(1, 50, size=16).astype(np.float32) for _ in range(3))
    zmax = zmin + 10.0
    _both(tgeo.z_world_to_learned, jgeo.z_world_to_learned, z, zmin, zmax, f)
    _both(tgeo.z_learned_to_world, jgeo.z_learned_to_world, z, zmin, zmax, f)
    _both(tgeo.z_patch_to_learned, jgeo.z_patch_to_learned, z, zmin, zmax)
    _both(tgeo.z_learned_to_patch, jgeo.z_learned_to_patch, z, zmin, zmax)
    _both(tgeo.z_world_to_patch, jgeo.z_world_to_patch, z, f)
    _both(tgeo.z_patch_to_world, jgeo.z_patch_to_world, z, f)
