"""Port parity on the CPU for the backbone's opt-in conv formulations: the
fused GroupNorm+SiLU+conv, the row-Winograd conv (forward, dgrad, weight
gradient, fused GroupNorm), the plain 2-D Winograd and subpixel upsample,
the flash attention variant, their routing in the blocks, and the detector
and one train step with the switches on, against the JAX package.

The JAX side runs its Pallas kernels in interpret mode
(``GDT_PALLAS_INTERPRET=1``), as the JAX package's own tests do; the port
runs its plain versions. Inputs are numpy arrays from a seed. fp32 on both
sides; tolerance: max |port - JAX| <= 1e-4 * max |JAX| (the same fp32
arithmetic in another order) unless a test says otherwise.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generative_detection_tpu.config import instantiate_from_config as jax_instantiate
from generative_detection_tpu.config import merge_configs as jax_merge
from generative_detection_tpu.models import blocks as jax_blocks
from generative_detection_tpu.ops import fused_conv as jax_fused
from generative_detection_tpu.ops import winograd_pallas as jax_wp
from generative_detection_tpu.ops.attention import _attention_pallas
from generative_detection_tpu.ops.upsample import subpixel_upsample_conv as jax_subpixel
from generative_detection_tpu.ops.winograd import winograd_conv3x3 as jax_winograd
from generative_detection_tpu_torch.models import blocks
from generative_detection_tpu_torch.ops import fused_conv, winograd_rows
from generative_detection_tpu_torch.ops.attention import flash_attention_forward
from generative_detection_tpu_torch.ops.upsample import subpixel_upsample_conv
from generative_detection_tpu_torch.ops.winograd import winograd_conv3x3
from generative_detection_tpu_torch.utils.jax_compat import state_dict_from_jax
from tests._torch_cpu import one_torch_thread  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parents[1]
FLAGSHIP = str(REPO / "configs/autoencoder/pose/autoencoder_kl_16x16x16.yaml")
TINY = str(REPO / "configs/autoencoder/pose/tiny_cpu.yaml")
REL = 1e-4


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("GDT_PALLAS_INTERPRET", "1")
    return monkeypatch


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, rel=REL, what=""):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= rel * scale, f"{what}: max err {err} > {rel} * {scale}"


def _inputs(seed, shape, co):
    """x (NHWC), gamma, beta, kernel (HWIO, lecun-scaled), bias, and an
    output cotangent, all fp32 numpy."""
    rng = np.random.default_rng(seed)
    c = shape[-1]
    return (
        (rng.normal(size=shape) * 2 + 0.5).astype(np.float32),
        (1 + 0.1 * rng.normal(size=c)).astype(np.float32),
        (0.1 * rng.normal(size=c)).astype(np.float32),
        (rng.normal(size=(3, 3, c, co)) / np.sqrt(9 * c)).astype(np.float32),
        (0.1 * rng.normal(size=co)).astype(np.float32),
        rng.normal(size=shape[:-1] + (co,)).astype(np.float32),
    )


def _jax_vjp(fn, args, ct):
    out, pull = jax.vjp(fn, *[jnp.asarray(a) for a in args])
    return out, pull(jnp.asarray(ct))


def _port_vjp(fn, args, ct):
    ts = [torch.from_numpy(a).requires_grad_(True) for a in args]
    out = fn(*ts)
    grads = torch.autograd.grad(out, ts, torch.from_numpy(ct))
    return out, grads


@pytest.mark.parametrize("save_activation", [False, True], ids=["remat", "saved_z"])
def test_gn_silu_conv_matches_jax(interpret, save_activation):
    x, gamma, beta, k, b, ct = _inputs(0, (2, 16, 16, 128), 256)
    assert jax_fused.fused_eligible(x.shape, 256, jnp.float32)
    assert fused_conv.fused_eligible(x.shape, 256, torch.float32)
    want, wgrads = _jax_vjp(
        lambda *a: jax_fused.gn_silu_conv(*a, save_activation=save_activation),
        (x, gamma, beta, k, b), ct)
    got, ggrads = _port_vjp(
        lambda *a: fused_conv.gn_silu_conv(*a, save_activation=save_activation),
        (x, gamma, beta, k, b), ct)
    _close(got, want, what="out")
    for name, g, w in zip(("dx", "dgamma", "dbeta", "dk", "dbias"), ggrads, wgrads):
        _close(g, w, what=name)


@pytest.mark.parametrize("m_out", [2, 4])
def test_wino_rows_conv3x3_matches_jax(interpret, m_out):
    # cin != cout: the dgrad runs the kernel with the channels swapped
    x, _, _, k, b, ct = _inputs(1, (1, 8, 16, 32), 64)
    want, wgrads = _jax_vjp(lambda z, kk, bb: jax_wp.wino_rows_conv3x3(z, kk, bb, jnp.float32, m_out),
                            (x, k, b), ct)
    got, ggrads = _port_vjp(lambda z, kk, bb: winograd_rows.wino_rows_conv3x3(
        z, kk, bb, torch.float32, m_out), (x, k, b), ct)
    _close(got, want, what="out")
    for name, g, w in zip(("dz", "dk", "db"), ggrads, wgrads):
        _close(g, w, what=name)


@pytest.mark.parametrize("fuse_gn", [False, True], ids=["plain", "gn"])
@pytest.mark.parametrize("m_out", [2, 4])
def test_wino_wgrad_matches_jax(interpret, m_out, fuse_gn):
    x, gamma, beta, _, _, dy = _inputs(2, (1, 8, 16, 32), 64)
    jab = jax_fused._gn_affine(jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta), 32, 1e-6)
    want = jax_wp.wino_wgrad(jnp.asarray(x), jnp.asarray(dy), jnp.float32, m_out,
                             gn_ab=jab if fuse_gn else None)
    pab = tuple(torch.tensor(np.asarray(t)) for t in jab) if fuse_gn else None
    got = winograd_rows.wino_wgrad(torch.from_numpy(x), torch.from_numpy(dy), torch.float32,
                                   m_out, gn_ab=pab)
    _close(got, want)


@pytest.mark.parametrize("m_out", [2, 4])
def test_gn_silu_wino_conv3x3_matches_jax(interpret, m_out):
    x, gamma, beta, k, b, ct = _inputs(3, (1, 8, 16, 64), 32)
    want, wgrads = _jax_vjp(
        lambda *a: jax_wp.gn_silu_wino_conv3x3(*a, jnp.float32, m_out), (x, gamma, beta, k, b), ct)
    got, ggrads = _port_vjp(
        lambda *a: winograd_rows.gn_silu_wino_conv3x3(*a, torch.float32, m_out),
        (x, gamma, beta, k, b), ct)
    _close(got, want, what="out")
    for name, g, w in zip(("dx", "dgamma", "dbeta", "dk", "dbias"), ggrads, wgrads):
        _close(g, w, what=name)


@pytest.mark.parametrize("which", ["winograd_2d", "subpixel"])
def test_plain_formulations_match_jax(which):
    x, _, _, k, b, _ = _inputs(4, (2, 8, 12, 16), 24)
    jfn, pfn = ((jax_winograd, winograd_conv3x3) if which == "winograd_2d"
                else (jax_subpixel, subpixel_upsample_conv))
    want = jfn(jnp.asarray(x), jnp.asarray(k), jnp.asarray(b))
    got = pfn(torch.from_numpy(x), torch.from_numpy(k), torch.from_numpy(b))
    _close(got, want)


def test_flash_attention_forward_matches_pallas_kernel(interpret):
    rng = np.random.default_rng(5)
    q, k, v = (rng.normal(size=(1, 256, 128)).astype(np.float32) for _ in range(3))
    want = _attention_pallas(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), interpret=True)
    got = flash_attention_forward(*(torch.from_numpy(t) for t in (q, k, v)))
    _close(got, want)


def _flagship_sites():
    """(h, c, co) of every ResnetBlock conv of the flagship encoder and
    decoder (h = w)."""
    cfg = jax_merge([FLAGSHIP])["model"]["params"]["ddconfig"]
    ch, mult, nrb = cfg["ch"], cfg["ch_mult"], cfg["num_res_blocks"]
    sites, h, c = [], 256, ch
    for lvl, m in enumerate(mult):  # encoder
        for _ in range(nrb):
            sites += [(h, c, ch * m), (h, ch * m, ch * m)]
            c = ch * m
        if lvl != len(mult) - 1:
            h //= 2
    sites += [(h, c, c)] * 4  # mid blocks
    for lvl in reversed(range(len(mult))):  # decoder
        for _ in range(nrb + 1):
            sites += [(h, c, ch * mult[lvl]), (h, ch * mult[lvl], ch * mult[lvl])]
            c = ch * mult[lvl]
        if lvl:
            h *= 2
    return sorted(set(sites))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_routing_matches_jax_at_every_flagship_shape(interpret, dtype):
    jdt, pdt = getattr(jnp, dtype), getattr(torch, dtype)
    sites = _flagship_sites()
    assert len(sites) >= 8
    for h, c, co in sites:
        shape = (16, h, h, c)
        assert fused_conv.fused_eligible(shape, co, pdt) == jax_fused.fused_eligible(
            shape, co, jdt), (shape, co)
        assert blocks._wino_band(shape) == jax_blocks._wino_band(shape), shape
        for m in (2, 4):
            assert winograd_rows.wino_rows_eligible(shape, co, pdt, m) == \
                jax_wp.wino_rows_eligible(shape, co, jdt, m), (shape, co, m)
            for sh, cc, oo in ((shape, co, c), (shape, c, co)):  # dgrad, wgrad tiles
                n, hh, ww, _ = sh
                assert winograd_rows._pick_tile(hh, ww, cc, oo, pdt.itemsize, m) == \
                    jax_wp._pick_tile(hh, ww, cc, oo, jnp.dtype(jdt).itemsize, m)
                assert winograd_rows._wgrad_tile(hh, ww, cc, oo, pdt.itemsize, m) == \
                    jax_wp._wgrad_tile(hh, ww, cc, oo, jnp.dtype(jdt).itemsize, m)


class _Spy:
    """Record which formulation each side's blocks call, by op name, the
    spatial shape and the Winograd point count."""

    OPS = ("gn_silu_conv", "gn_silu_wino_conv3x3", "wino_rows_conv3x3", "winograd_conv3x3")

    def __init__(self, monkeypatch, module, nhwc):
        self.calls = []
        for name in self.OPS:
            real = getattr(module, name)

            def spy(x, *a, _real=real, _name=name, **kw):
                m = a[5] if _name == "gn_silu_wino_conv3x3" else (
                    a[3] if _name == "wino_rows_conv3x3" else None)
                self.calls.append((_name, tuple(x.shape[1:3]) if nhwc else None, m))
                return _real(x, *a, **kw)

            monkeypatch.setattr(module, name, spy)


@pytest.mark.parametrize("mode", ["0", "1", "xla", "pallas", "pallas4", "auto", "fused"])
def test_resnet_block_routes_and_matches_jax(interpret, mode):
    interpret.setenv("GDT_WINOGRAD", mode)
    rng = np.random.default_rng(6)
    x = rng.normal(size=(1, 32, 32, 128)).astype(np.float32)
    jmod = jax_blocks.ResnetBlock(128)
    shapes = jax.eval_shape(jmod.init, jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    params = jax.tree_util.tree_map(
        lambda p: jnp.asarray(rng.normal(size=p.shape) * 0.05 + (len(p.shape) == 1), jnp.float32),
        shapes)
    jspy = _Spy(interpret, jax_blocks, True)
    want = jmod.apply({"params": params}, jnp.asarray(x))
    pmod = blocks.ResnetBlock(128, 128)
    sd = state_dict_from_jax({"encoder": {"blk": jax.tree_util.tree_map(np.asarray, params)}})
    pmod.load_state_dict({k.removeprefix("encoder.blk."): v for k, v in sd.items()}, strict=True)
    pspy = _Spy(interpret, blocks, True)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    got = pmod(xt).permute(0, 2, 3, 1)
    assert pspy.calls == jspy.calls
    expect = {"0": 0, "1": 2, "xla": 2, "pallas": 2, "pallas4": 2, "auto": 2, "fused": 2}[mode]
    assert len(pspy.calls) == expect, pspy.calls
    _close(got, want)


# ---- model level: tiny_cpu.yaml at ch 128 (32x32 sites in band, C % 128 == 0)


@pytest.fixture
def interpret_convs(monkeypatch):
    """Only the JAX package's conv kernels in interpret mode; its GroupNorm
    and attention keep their plain XLA versions on the CPU (as in the other
    port tests), which keeps the step's compile short."""
    monkeypatch.setattr(jax_fused, "pallas_enabled", lambda: True)
    monkeypatch.setattr(jax_fused, "_interpret", lambda: True)
    monkeypatch.setattr(jax_wp, "_interpret", lambda: True)
    return monkeypatch


@pytest.fixture(scope="module")
def tiny():
    from generative_detection_tpu.utils.torch_compat import convert_pose_autoencoder
    from generative_detection_tpu_torch.config import instantiate_from_config, merge_configs
    from generative_detection_tpu_torch.train.state import flax_like_net
    from test_torch_port_train import _lpips_tree

    over = ["model.params.ddconfig.ch=128"]
    jm = jax_instantiate(jax_merge([TINY], over)["model"])
    pm = instantiate_from_config(merge_configs([TINY], over)["model"])
    g = torch.Generator().manual_seed(0)
    net_sd = flax_like_net(pm, g, "cpu").state_dict()
    loss_sd = pm.init_loss(g, device="cpu").state_dict()
    sd = {k: v.numpy() for k, v in net_sd.items()}
    sd.update({f"loss.{k}": v.numpy() for k, v in loss_sd.items()})
    net_params, loss_params = convert_pose_autoencoder(sd, jm.ddconfig)
    loss_params = dict(loss_params, perceptual=_lpips_tree(loss_sd))
    return dict(jm=jm, pm=pm, net_sd=net_sd, loss_sd=loss_sd, net_params=net_params,
                loss_params=loss_params)


def test_detector_with_fused_inference_matches_jax(tiny, interpret_convs):
    from generative_detection_tpu.eval.inference import pose_inference as jax_pose_inference
    from generative_detection_tpu_torch.eval.inference import pose_inference

    interpret_convs.setenv("GDT_FUSE_INFERENCE", "1")
    rgb = np.random.default_rng(7).uniform(-1, 1, size=(2, 32, 32, 3)).astype(np.float32)
    jspy = _Spy(interpret_convs, jax_blocks, True)
    want, _, _ = jax_pose_inference(tiny["jm"], tiny["net_params"], jnp.asarray(rgb))
    net = tiny["pm"].inference_net()
    net.load_state_dict(tiny["net_sd"], strict=True)
    pspy = _Spy(interpret_convs, blocks, True)
    got, _, _ = pose_inference(net.to(memory_format=torch.channels_last), torch.from_numpy(rgb))
    # every encoder ResnetBlock conv of this config is eligible: 4 blocks
    assert pspy.calls == jspy.calls and len(pspy.calls) == 8, pspy.calls
    _close(got, want)


def test_train_step_with_fused_winograd_matches_jax(tiny, monkeypatch):
    """One 'full'-phase step past the curriculum with GDT_WINOGRAD=fused,
    with the harness of tests/test_torch_port_train.py: same weights, numpy
    draws handed to both, losses, d_weight and Adam moments compared. The
    JAX step runs as the JAX package runs it on the CPU, where its fused
    Winograd path takes its plain XLA composite (the kernel's parity with its
    interpret mode is tested above); the port's step runs its own fused path
    at every in-band site."""
    from generative_detection_tpu.train import TrainState as JaxTrainState
    from generative_detection_tpu.train import make_optimizers as jax_make_optimizers
    from generative_detection_tpu.train import make_train_step as jax_make_train_step
    from generative_detection_tpu_torch.train import TrainState, make_optimizers, make_train_step
    from test_torch_port_train import (
        _PatchedDraws, _adam_moments, _check_metrics, _check_moments, _disc_sd,
    )

    monkeypatch.setenv("GDT_WINOGRAD", "fused")
    jm, pm, bs, step, lr = tiny["jm"], tiny["pm"], 2, 6, 1e-4
    rng = np.random.default_rng(8)
    host = jm.example_batch(bs)
    host[jm.image_rgb_key] = rng.uniform(0, 1, size=(bs, 32, 32, 3)).astype(np.float32)
    host[jm.pose_key] = rng.normal(size=(bs, 4)).astype(np.float32)
    host[jm.class_key] = host["original_class_id"] = np.array([0, 3], np.int32)
    host[jm.bbox_key] = rng.uniform(1, 4, size=(bs, 3)).astype(np.float32)
    host[jm.fill_factor_key] = rng.uniform(0.2, 0.8, size=bs).astype(np.float32)
    draws = {k: rng.normal(size=s).astype(np.float32) for k, s in
             (("posterior", (bs, 16, 16, 16)), ("noise", (bs, 16, 16, 16)), ("bbox", (bs, 8)))}
    draws["dropout"] = rng.uniform(size=(bs, 16, 16, 16)).astype(np.float32)

    opt_ae, opt_disc = jax_make_optimizers(lr, grad_clip=1.0)
    net_params, loss_params = tiny["net_params"], tiny["loss_params"]
    jstate = JaxTrainState(
        step=jnp.asarray(step, jnp.int32), net_params=net_params, loss_params=loss_params,
        opt_ae_state=opt_ae.init(net_params),
        opt_disc_state=opt_disc.init(loss_params["discriminator"]), rng=jax.random.PRNGKey(0))
    jstep = jax_make_train_step(jm, opt_ae, opt_disc, phase="full", step_counting="optimizer")
    jbatch = jm.prepare_batch(host)
    with monkeypatch.context() as mp:
        patched = _PatchedDraws(mp, draws)
        # LLVM's passes are most of XLA:CPU's compile of this step and the
        # step itself is tiny: compile at backend optimization level 0
        compiled = jax.jit(jstep).lower(jstate, jbatch).compile(
            {"xla_backend_optimization_level": 0})
        assert patched.left == ([], [])
    new_jstate, jmetrics = compiled(jstate, jbatch)

    net = pm.build_net()
    net.load_state_dict(tiny["net_sd"], strict=True)
    loss = pm.build_loss()
    loss.load_state_dict(tiny["loss_sd"], strict=True)
    p_ae, p_disc = make_optimizers(net, loss, lr, grad_clip=1.0)
    state = TrainState(step, net, loss, p_ae, p_disc)
    pspy = _Spy(monkeypatch, blocks, True)
    state, metrics = make_train_step(pm, phase="full", step_counting="optimizer")(
        state, pm.prepare_batch(host, device="cpu"),
        draws={k: torch.from_numpy(v) for k, v in draws.items()})

    # the in-band (32x32) pairs: the encoder's first block, the decoder's last two
    assert sorted(set(pspy.calls)) == [("gn_silu_wino_conv3x3", (32, 32), 4)]
    assert len(pspy.calls) == 6
    assert set(metrics) == set(jmetrics)
    _check_metrics(metrics, jmetrics)
    assert float(metrics["train/d_weight"]) > 0
    mu, nu = _adam_moments(new_jstate.opt_ae_state)
    _check_moments(p_ae, dict(net.named_parameters()), state_dict_from_jax(mu),
                   state_dict_from_jax(nu))
    mu, nu = _adam_moments(new_jstate.opt_disc_state)
    _check_moments(p_disc, dict(loss.discriminator.named_parameters()),
                   _disc_sd(loss_params, mu), _disc_sd(loss_params, nu))


def test_fused_and_winograd_nets_load_jax_params_strictly(monkeypatch):
    """A flax param tree of a fuse=True net traced under GDT_WINOGRAD=fused
    (shapes only: jax.eval_shape) goes through state_dict_from_jax into the
    port's fuse=True net with strict=True."""
    monkeypatch.setenv("GDT_WINOGRAD", "fused")
    jm = jax_instantiate(jax_merge([TINY], ["model.params.ddconfig.ch=128"])["model"])
    jnet = jm.net.clone(fuse=True)
    shapes = jax.eval_shape(
        lambda: jnet.init({"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1),
                           "dropout": jax.random.PRNGKey(2)},
                          jnp.zeros((1, 32, 32, 3)), 0))["params"]
    params = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)
    from generative_detection_tpu_torch.config import instantiate_from_config, merge_configs

    pm = instantiate_from_config(merge_configs([TINY], ["model.params.ddconfig.ch=128"])["model"])
    pm.build_net(fuse=True).load_state_dict(state_dict_from_jax(params), strict=True)
