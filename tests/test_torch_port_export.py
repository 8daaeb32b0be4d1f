"""Serving export on the CPU: the ``gdt`` operators (``ops/library.py``) pass
``torch.library.opcheck``; ``export_detector`` -> ``load_detector`` serves
from one artifact what the live port detector serves, and what the JAX
package's exported detector serves on the same weights; the traced graph
holds the kernels' operators; every ctypes launch of ``ops/`` sits inside an
operator's CUDA implementation."""

import ast
import io
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generative_detection_tpu.serving import export_detector as jax_export_detector
from generative_detection_tpu.serving import load_detector as jax_load_detector
from generative_detection_tpu_torch.ops import library
from generative_detection_tpu_torch.serving import (
    detector_metadata, export_detector, load_detector, make_detector_fn,
)
from generative_detection_tpu_torch.utils.jax_compat import state_dict_from_jax
from generative_detection_tpu_torch.utils.torch_compat import (
    export_pose_autoencoder, save_torch_checkpoint,
)
from tests.test_models import small_model
from tests.test_torch_port_detector import HMAX, HMIN, _camera_args
from tests.test_torch_port_model import jax_net_params, port_small_model
from tests._torch_cpu import one_torch_thread, tmp_path  # noqa: F401 (fixtures)

REPO = Path(__file__).resolve().parents[1]
SERVED = (1, 3, 5)  # the batches one batch-polymorphic artifact serves here


def _opcheck_args():
    """Small CPU arguments for every operator of the ``gdt`` namespace."""
    g = torch.Generator().manual_seed(0)

    def r(*shape):
        return torch.randn(shape, generator=g)

    x, gamma, beta = r(2, 4, 4, 64), 1 + 0.1 * r(64), 0.1 * r(64)
    _, stats = torch.ops.gdt.group_norm_train(x, gamma, beta, 32, 1e-6, "silu")
    q, k, v, do = r(2, 16, 8), r(2, 16, 8), r(2, 16, 8), r(2, 16, 8)
    lse, di = torch.logsumexp(r(2, 16, 16), -1), r(2, 16)
    xc, w, bias, ga, gb = r(2, 4, 4, 16), r(3, 3, 16, 8), r(8), r(2, 16), r(2, 16)
    return {
        "group_norm": (x, gamma, beta, 32, 1e-6, "silu"),
        "group_norm_train": (x.bfloat16(), gamma, beta, 32, 1e-6, None),
        "group_norm_affine": (x, gamma, beta, 32, 1e-6),
        "group_norm_affine_train": (x, gamma, beta, 32, 1e-6),
        "group_norm_bwd": (x, r(2, 4, 4, 64), stats, gamma, beta, 32, 1e-6, "silu"),
        "attention_fwd": (q, k, v, 12, 8 ** -0.5),  # keys 12..15 masked
        "flash_attention_fwd": (q, k, v, 16, 8 ** -0.5),
        "attention_bwd": (q, k, v, do, lse, di, 16, 8 ** -0.5),
        "fused_conv": (xc, w, bias, ga, gb),
        "fused_conv_z": (xc, w, bias, ga, gb),
        "wino_rows": (xc, r(12, 16, 8), bias, ga, gb, 2),
        "wino_rows_dgrad": (r(2, 4, 4, 8), r(12, 8, 16), 2),
        "wino_wgrad": (xc, r(2, 4, 4, 8), None, None, 2),
    }


@pytest.mark.parametrize("name", sorted(library.OPS))
def test_gdt_op_passes_opcheck(name):
    """Schema, fake implementation (shapes, dtypes, strides against the CPU
    implementation), autograd registration and dynamic-shape dispatch."""
    result = torch.library.opcheck(getattr(torch.ops.gdt, name).default, _opcheck_args()[name])
    assert set(result.values()) == {"SUCCESS"}, result


@pytest.fixture(scope="module")
def shared():
    """The tiny model on shared weights: the JAX package's, and the port's
    state_dict of them."""
    jm = small_model()
    params = jax_net_params(jm)
    return jm, params, port_small_model(), state_dict_from_jax(params)


def _requests(batches, seed=3):
    rng = np.random.default_rng(seed)
    return {b: (rng.normal(size=(b, 32, 32, 3)).astype(np.float32), *_camera_args(rng, b))
            for b in batches}


@pytest.fixture(scope="module")
def artifacts(shared):
    """One batch-polymorphic artifact per dtype, exported and loaded once."""
    _, _, tm, sd = shared
    out = {}
    for dtype in ("float32", "bfloat16"):
        blob = export_detector(tm, sd, HMIN, HMAX, batch=None, dtype=dtype, device="cpu")
        out[dtype] = (blob, load_detector(blob, device="cpu"))
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_one_artifact_serves_every_batch_as_the_live_detector(shared, artifacts, dtype):
    _, _, tm, sd = shared
    blob, detect = artifacts[dtype]
    assert detector_metadata(blob)["dtype"] == dtype and detect.metadata["batch"] is None
    live = make_detector_fn(tm, sd, HMIN, HMAX, 32, dtype=dtype, device="cpu")
    for b, args in _requests(SERVED).items():
        got, want = detect(*args), live(*args)
        assert got[0].shape == (b, 7) and got[0].dtype == torch.float32
        for g, w in zip(got, want):
            assert torch.equal(g, w)  # the same operators on the same inputs
    rgb, *cams = _requests((3,))[3]
    with pytest.raises(ValueError, match="the same for all"):
        detect(rgb[:2], *cams)  # one batch for all six inputs


def test_fixed_batch_artifact(shared, tmp_path):
    """A batch-2 artifact serves batch 2 and refuses other shapes. Its model
    names a ``ckpt_path`` of other weights, which the artifact ignores: it
    holds the weights it was given (a net trained from the file, shipped)."""
    _, _, tm, sd = shared
    path = str(tmp_path / "other.ckpt")
    other = export_pose_autoencoder(tm.build_net())
    assert not torch.equal(other["encoder.conv_in.weight"], sd["encoder.conv_in.weight"])
    save_torch_checkpoint(path, other, global_step=0)
    with_ckpt = port_small_model()
    with_ckpt.ckpt_path = path
    blob = export_detector(with_ckpt, sd, HMIN, HMAX, batch=2, dtype="float32", device="cpu")
    detect = load_detector(blob, device="cpu")
    args = _requests((2, 3))
    live = make_detector_fn(tm, sd, HMIN, HMAX, 32, dtype="float32", device="cpu")
    for g, w in zip(detect(*args[2]), live(*args[2])):
        assert torch.equal(g, w)
    with pytest.raises(ValueError, match="shapes"):
        detect(*args[3])  # the graph's batch is 2
    with pytest.raises(ValueError, match="shapes"):
        detect(args[2][0][:, :16], *args[2][1:])  # and its patches 32 x 32


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_artifact_matches_jax_export(shared, artifacts, dtype):
    """Against the JAX package's exported detector (batch-polymorphic too) on
    the same weights, at the tolerances of ``test_torch_port_detector.py``."""
    jm, params, _, _ = shared
    jdetect = jax_load_detector(jax_export_detector(
        jm, params, HMIN, HMAX, batch=None, dtype="auto" if dtype == "bfloat16" else "float32"))
    args = _requests((3,), seed=7)[3]
    want = [np.asarray(a) for a in jdetect(*map(jnp.asarray, args))]
    boxes, cls, score = (t.numpy() for t in artifacts[dtype][1](*args))
    if dtype == "float32":
        np.testing.assert_allclose(boxes, want[0], rtol=1e-3, atol=1e-4)
        np.testing.assert_array_equal(cls, want[1])
        np.testing.assert_allclose(score, want[2], rtol=1e-5, atol=1e-6)
    else:  # box centres are ill-conditioned under bf16 rounding (see that file)
        tol = dict(rtol=3e-2, atol=5e-2)
        assert np.all(np.isfinite(boxes))
        np.testing.assert_allclose(boxes[:, 3:], want[0][:, 3:], **tol)
        np.testing.assert_allclose(score, want[2], **tol)


def _graph_ops(blob) -> set:
    """The operators the graph calls, those of its nested graphs included
    (the convs' autocast regions trace as submodules)."""
    program = torch.export.load(io.BytesIO(blob))
    return {str(n.target) for m in program.graph_module.modules()
            if isinstance(m, torch.fx.GraphModule)
            for n in m.graph.nodes if n.op == "call_function"}


@pytest.fixture(scope="module")
def wide():
    """tiny_cpu's architecture at ch 128 (sites the fused kernels take),
    and its state_dict (PyTorch's default init: the graph, not the
    weights, is under test), shared by the three graphs."""
    from generative_detection_tpu_torch.models import PoseAutoencoder
    from tests.test_models import SMALL_DD, SMALL_LOSSCONFIG

    model = PoseAutoencoder(ddconfig=dict(SMALL_DD, ch=128), lossconfig=SMALL_LOSSCONFIG,
                            embed_dim=16, input_size=32)
    return model, model.build_net().state_dict()


@pytest.mark.parametrize("switch, want", [
    ({}, {"gdt.group_norm.default", "gdt.attention_fwd.default"}),
    ({"GDT_FUSE_INFERENCE": "1"}, {"gdt.fused_conv.default", "gdt.group_norm_affine.default"}),
    ({"GDT_WINOGRAD": "fused"}, {"gdt.wino_rows.default", "gdt.group_norm_affine.default"}),
])
def test_graph_holds_the_kernels_operators(monkeypatch, wide, switch, want):
    """On ``wide``: the default graph holds B3's and B1's operators, GDT_FUSE_INFERENCE=1
    B6's, GDT_WINOGRAD=fused B7's; no training operator (whose stats
    depend on the batch) is traced; the switches are recorded; the artifact
    serves what the live detector does (a fixed batch: the symbolic one is
    held above, and costs the trace twice the time)."""
    model, net = wide
    for k in ("GDT_FUSE_INFERENCE", "GDT_WINOGRAD", "GDT_SUBPIXEL_UP"):
        monkeypatch.delenv(k, raising=False)
    for k, v in switch.items():
        monkeypatch.setenv(k, v)
    blob = export_detector(model, net, HMIN, HMAX, batch=1, dtype="float32", device="cpu")
    ops = {t for t in _graph_ops(blob) if t.startswith("gdt.")}
    assert want <= ops and not any("_train" in t for t in ops), ops
    assert detector_metadata(blob)["switches"] == {
        k: switch.get(k) for k in ("GDT_FUSE_INFERENCE", "GDT_WINOGRAD", "GDT_SUBPIXEL_UP")}
    args = _requests((1,))[1]
    live = make_detector_fn(model, net, HMIN, HMAX, 32, dtype="float32", device="cpu")
    for g, w in zip(load_detector(blob, device="cpu")(*args), live(*args)):
        assert torch.equal(g, w)


def test_artifact_runs_only_where_it_was_exported(shared, artifacts):
    blob, _ = artifacts["float32"]
    with pytest.raises(ValueError, match="exported for cpu"):
        load_detector(blob, device="cuda")


def _functions(tree):
    return [n for n in ast.walk(tree) if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]


def _launches(fn) -> set:
    """The ctypes kernel entry points ``fn`` calls (``lib.gdt_*(...)``)."""
    return {n.func.attr for n in ast.walk(fn)
            if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
            and n.func.attr.startswith("gdt_") and n.func.attr != "gdt_error_string"}


def _names(node) -> set:
    return {n.id for n in ast.walk(node) if isinstance(n, ast.Name)} | {
        n.attr for n in ast.walk(node) if isinstance(n, ast.Attribute)}


def test_every_ctypes_launch_sits_inside_an_op_implementation():
    """Every function of ``ops/`` that calls a ctypes kernel entry point is
    an operator's registered CUDA implementation, or a helper that only
    those implementations name (anywhere in the package, chip_smoke.py,
    tools/ and tests/); each implementation reaches exactly the entry
    points ``library.ENTRY_POINTS`` gives it; the implementations themselves
    are named only by ``ops/library.py``, and their table ``CUDA_IMPLS``
    only there and here."""
    ops_dir = Path(library.__file__).parent
    impls = {f.__name__: op for op, f in library.CUDA_IMPLS.items()}
    trees = {p: ast.parse(p.read_text()) for p in ops_dir.glob("*.py")}
    launchers = {fn.name: _launches(fn) for tree in trees.values() for fn in _functions(tree)
                 if _launches(fn)}
    helpers = set(launchers) - set(impls)
    assert launchers and helpers <= {"_gn_launch", "_gn_affine_launch", "_launch_wino",
                                     "_launch_wgrad"}, launchers
    files = [REPO / "chip_smoke.py", *(REPO / "generative_detection_tpu_torch").rglob("*.py"),
             *(REPO / "tools").glob("*.py"), *(REPO / "tests").glob("*.py")]
    for path in files:
        text = path.read_text()
        if path.name != "test_torch_port_export.py":
            assert path.name == "library.py" or "CUDA_IMPLS" not in text, path
        if path not in trees and not any(n in text for n in helpers | set(impls)):
            continue
        tree = trees.get(path) or ast.parse(text)
        where = {n: fn.name for fn in _functions(tree) for n in ast.walk(fn)}
        for node in ast.walk(tree):
            name = node.id if isinstance(node, ast.Name) else (
                node.attr if isinstance(node, ast.Attribute) else None)
            if name in helpers:
                assert where.get(node) in impls, f"{path}: {name} named in {where.get(node)}"
            if name in impls:
                assert path.name == "library.py", f"{path}: {name} named outside library.py"
    for fname, op in impls.items():
        fn = next(f for tree in trees.values() for f in _functions(tree) if f.name == fname)
        reached = set().union(_launches(fn), *(launchers[h] for h in helpers & _names(fn)))
        assert reached == set(library.ENTRY_POINTS[op]), (op, reached)
