"""Port parity on the CPU for the plain KL autoencoder family: the port's
``AutoencoderKLNet``, ``LPIPSWithDiscriminator``, ``make_plain_train_step`` /
``make_plain_eval_step``, the ldm ``.ckpt`` export and ``ckpt_path`` against the
JAX package's, at ``plain_kl_tiny.yaml``'s width (ch 32, 32x32 images, batch 2)
with the loss of ``tests/test_plain_autoencoder.py`` (disc_start 2); then the
training CLI on that config while JAX cannot be imported.

The weights are numpy-seeded leaves of the JAX package's own parameter trees
(their shapes from a trace of its init, no compile), carried into the port by
``utils/jax_compat.py`` with ``load_state_dict(strict=True)``. The posterior's
normal draw is a numpy array: the JAX side gets it by replacing
``jax.random.normal`` while it traces, the port through ``draws``. Every JAX
function is compiled once for the module.

Tolerances, fp32 on both sides (those of ``tests/test_torch_port_train.py``):
- network outputs and posterior moments: 1e-4 of the reference's largest
  magnitude (convolutions and sums in another order);
- losses and logged metrics: 1e-4 relative plus 1e-6 absolute; ``d_weight``
  1e-3 relative (a ratio of two norms of sums over B * H * W positions of
  mixed-sign terms, ``tests/test_torch_port_trainer.py``);
- weights after the train steps: 1e-3 of each tree's largest magnitude.
  Not the Adam moments: at ch 32 GroupNorm has one-channel groups, so some
  gradients are zero analytically and the port's fp32 rounding noise in them
  becomes Adam updates of ~lr (ROADMAP.md section C);
- the exported ``.ckpt`` and ``ckpt_path``: equal tensors, then forwards within
  the outputs' limit.

The port's side of the train-step cases runs on two PyTorch intra-op threads:
one thread's CPU backward through the discriminator loses up to 6e-3 of a
layer's largest gradient (``tests/test_torch_port_trainer.py``)."""

import contextlib
import json
import os
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generative_detection_tpu.models.autoencoder import Autoencoder as JaxAutoencoder
from generative_detection_tpu.train import TrainState as JaxTrainState
from generative_detection_tpu.train import make_optimizers as jax_make_optimizers
from generative_detection_tpu.train import make_plain_train_step as jax_make_plain_train_step
from generative_detection_tpu.train.steps import make_plain_eval_step as jax_make_plain_eval_step
from generative_detection_tpu.utils.distributions import (
    DiagonalGaussianDistribution as JaxGaussian,
)
from generative_detection_tpu.utils.torch_compat import (
    export_plain_autoencoder as jax_export_plain_autoencoder,
)
from generative_detection_tpu.utils.torch_compat import (
    save_torch_checkpoint as jax_save_torch_checkpoint,
)
from generative_detection_tpu_torch.config import instantiate_from_config, merge_configs
from generative_detection_tpu_torch.losses import LPIPSWithDiscriminator
from generative_detection_tpu_torch.models import Autoencoder, AutoencoderKLNet
from generative_detection_tpu_torch.train import (
    TrainState,
    make_optimizers,
    make_plain_eval_step,
    make_plain_train_step,
)
from generative_detection_tpu_torch.utils.distributions import DiagonalGaussianDistribution
from generative_detection_tpu_torch.utils.jax_compat import (
    loss_state_dict_from_jax,
    state_dict_from_jax,
)
from generative_detection_tpu_torch.utils.torch_compat import (
    export_plain_autoencoder,
    load_torch_state_dict,
)
from tests._torch_cpu import jax_unimportable, one_torch_thread, tmp_path  # noqa: F401 (fixtures)
from tests.test_torch_port_train import _adam_moments, _disc_sd

REPO = Path(__file__).resolve().parents[1]
PLAIN = str(REPO / "configs/autoencoder/plain_kl_tiny.yaml")
SMALL_DD = {
    "double_z": True, "z_channels": 16, "resolution": 32, "in_channels": 3, "out_ch": 3,
    "ch": 32, "ch_mult": [1, 2], "num_res_blocks": 1, "attn_resolutions": [16], "dropout": 0.0,
}
LOSSCFG = {
    "target": "generative_detection_tpu.losses.contperceptual.LPIPSWithDiscriminator",
    "params": {"disc_start": 2, "kl_weight": 1e-6, "disc_weight": 0.5},
}
LR = 1e-4
BS = 2
OUT_REL, METRIC_RTOL, D_WEIGHT_RTOL, WEIGHT_REL = 1e-4, 1e-4, 1e-3, 1e-3


def _np(x):
    return np.asarray(x.detach().float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32))


def _close(got, want, rel=OUT_REL):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= rel * scale, f"max err {err} > {rel} * {scale}"


def _check_metrics(got: dict, want: dict):
    assert set(got) == set(want)
    for key in want:
        rtol = D_WEIGHT_RTOL if key.endswith("/d_weight") else METRIC_RTOL
        np.testing.assert_allclose(_np(got[key]), _np(want[key]), rtol=rtol, atol=1e-6,
                                   err_msg=key)


@contextlib.contextmanager
def _threads(n=2):
    old = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(old)


def _fill(shapes, rng, path=()):
    """Numpy-seeded leaves for a flax parameter tree of ``ShapeDtypeStruct``s:
    kernels N(0, 1 / fan_in), norm scales N(1, 0.1^2), biases N(0, 0.05^2),
    ``logvar`` 0.1."""
    if isinstance(shapes, dict) or hasattr(shapes, "items"):
        return {k: _fill(v, rng, path + (k,)) for k, v in shapes.items()}
    shape, name = tuple(shapes.shape), path[-1]
    if name == "kernel":
        return (rng.normal(size=shape) / np.sqrt(np.prod(shape[:-1]))).astype(np.float32)
    if name == "scale":
        return (1.0 + 0.1 * rng.normal(size=shape)).astype(np.float32)
    if name == "logvar":
        return np.full(shape, 0.1, np.float32)
    return (0.05 * rng.normal(size=shape)).astype(np.float32)


def _port_model(**params):
    return Autoencoder(ddconfig=SMALL_DD, lossconfig=LOSSCFG, embed_dim=16, **params)


def _port_modules(setup):
    pm = setup["pm"]
    net, loss = pm.build_net(), pm.build_loss()
    net.load_state_dict(setup["net_sd"], strict=True)
    loss.load_state_dict(setup["loss_sd"], strict=True)
    return net, loss


def _patch_normal(monkeypatch, eps):
    """``jax.random.normal`` returns ``eps`` wherever its shape is asked for."""
    original = jax.random.normal

    def normal(key, shape=(), dtype=jnp.float32, *args, **kw):
        if tuple(shape) == eps.shape:
            return jnp.asarray(eps, dtype)
        return original(key, shape, dtype, *args, **kw)

    monkeypatch.setattr(jax.random, "normal", normal)


@pytest.fixture(scope="module")
def setup():
    jm = JaxAutoencoder(ddconfig=SMALL_DD, lossconfig=LOSSCFG, embed_dim=16)
    shapes = jax.eval_shape(lambda k: jm.init_variables(k, BS), jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    net_params, loss_params = _fill(shapes[0], rng), _fill(shapes[1], rng)
    pm = _port_model()
    x = rng.uniform(-1, 1, size=(BS, 32, 32, 3)).astype(np.float32)
    eps = rng.normal(size=(BS, 16, 16, 16)).astype(np.float32)
    with pytest.MonkeyPatch.context() as mp:
        _patch_normal(mp, eps)
        # one compile, reused for every JAX forward of the module
        forward = jax.jit(lambda p, t: jm.net.apply({"params": p}, t,
                                                    rngs={"sample": jax.random.PRNGKey(1)}))
        want = forward(net_params, jnp.asarray(x))
    return dict(jm=jm, pm=pm, net_params=net_params, loss_params=loss_params,
                net_sd=state_dict_from_jax(net_params),
                loss_sd=loss_state_dict_from_jax(loss_params), x=x, eps=eps,
                forward=forward, want=want)


def test_jax_compat_carries_the_plain_trees(setup):
    """Every leaf of the JAX package's plain net and loss lands on a port
    parameter of the same name space (strict loads), ``quant_conv`` included,
    and the loss's names are ``PoseLoss``'s."""
    net, loss = _port_modules(setup)
    assert set(setup["net_sd"]) == set(net.state_dict())
    assert "quant_conv.weight" in setup["net_sd"] and "post_quant_conv.bias" in setup["net_sd"]
    assert set(setup["loss_sd"]) == set(loss.state_dict())
    assert float(loss.logvar) == pytest.approx(0.1) and not loss.logvar.requires_grad
    assert not any(p.requires_grad for p in loss.perceptual_loss.parameters())


def test_net_forward_matches_jax_with_its_draw(setup):
    net, _ = _port_modules(setup)
    with torch.no_grad():
        outs = net(torch.from_numpy(setup["x"]), draws={"posterior": torch.from_numpy(setup["eps"])})
    want = setup["want"]
    assert set(outs) == set(want) == {"dec_obj", "posterior_obj", "pre_out"}
    assert outs["dec_obj"].shape == (BS, 32, 32, 3)
    _close(outs["dec_obj"], want["dec_obj"])
    _close(outs["pre_out"], want["pre_out"])
    _close(outs["posterior_obj"].mean, want["posterior_obj"].mean)
    _close(outs["posterior_obj"].logvar, want["posterior_obj"].logvar)


@pytest.fixture(scope="module")
def jax_losses(setup):
    """Both JAX loss passes under one jit (``global_step`` traced)."""
    loss = setup["jm"].loss

    def losses(params, x, y, moments, step, d_weight):
        post = JaxGaussian.from_parameters(moments, axis=-1)
        gen = loss.apply({"params": params}, x, y, post, 0, step, d_weight=d_weight)
        disc = loss.apply({"params": params}, x, y, post, 1, step)
        return gen, disc

    return jax.jit(losses)


@pytest.mark.parametrize("global_step", [1, 3], ids=["before_disc_start", "after"])
def test_loss_matches_jax_at_both_optimizer_indices(setup, jax_losses, global_step):
    rng = np.random.default_rng(global_step)
    y = (0.5 * rng.normal(size=(BS, 32, 32, 3))).astype(np.float32)
    moments = rng.normal(size=(BS, 16, 16, 32)).astype(np.float32)
    (want, wlog), (want_d, wlog_d) = jax_losses(
        setup["loss_params"], jnp.asarray(setup["x"]), jnp.asarray(y), jnp.asarray(moments),
        jnp.asarray(global_step, jnp.int32), jnp.asarray(0.3))
    _, loss = _port_modules(setup)
    post = DiagonalGaussianDistribution.from_parameters(torch.from_numpy(moments), dim=-1)
    x = torch.from_numpy(setup["x"])
    got, glog = loss(x, torch.from_numpy(y), post, 0, global_step, d_weight=0.3)
    _check_metrics({"total": got, **glog}, {"total": want, **wlog})
    got_d, glog_d = loss(x, torch.from_numpy(y), post, 1, global_step)
    _check_metrics({"d": got_d, **glog_d}, {"d": want_d, **wlog_d})
    assert float(glog["train/disc_factor"]) == (global_step >= 2)
    assert (float(got_d.detach()) > 0) == (global_step >= 2)


@pytest.fixture(scope="module")
def jax_two_steps(setup):
    """Two JAX plain train steps from step 0 under optimizer step counting
    (generator steps 0 and 2 about disc_start 2), one compile."""
    jm = setup["jm"]
    opt_ae, opt_disc = jax_make_optimizers(LR, grad_clip=1.0)
    lp = setup["loss_params"]
    state = JaxTrainState(
        step=jnp.asarray(0, jnp.int32), net_params=setup["net_params"], loss_params=lp,
        opt_ae_state=opt_ae.init(setup["net_params"]),
        opt_disc_state=opt_disc.init(lp["discriminator"]), rng=jax.random.PRNGKey(0))
    with pytest.MonkeyPatch.context() as mp:
        _patch_normal(mp, setup["eps"])
        step = jax.jit(jax_make_plain_train_step(jm, opt_ae, opt_disc, step_counting="optimizer"))
        states, metrics = [], []
        for _ in range(2):
            state, m = step(state, {"image": jnp.asarray(setup["x"])})
            states.append(state)
            metrics.append(m)
    return states, metrics


def _port_trees(state):
    """The port state's network and discriminator parameters, by the names
    ``state_dict_from_jax`` / ``loss_state_dict_from_jax`` give them."""
    return (dict(state.net.named_parameters()),
            {f"discriminator.{k}": v for k, v in state.loss.discriminator.named_parameters()})


def _jax_trees(jstate):
    np_tree = jax.tree_util.tree_map(np.asarray, jstate)
    return (state_dict_from_jax(np_tree.net_params),
            loss_state_dict_from_jax(np_tree.loss_params))


def _carry_jax_state(state, jstate):
    """Put the JAX state's weights and Adam moments (after its first step)
    into the port's state."""
    mu, nu = _adam_moments(jstate.opt_ae_state)
    dmu, dnu = _adam_moments(jstate.opt_disc_state)
    lp = jstate.loss_params
    moments = ((state.opt_ae, state_dict_from_jax(mu), state_dict_from_jax(nu), ""),
               (state.opt_disc, _disc_sd(lp, dmu), _disc_sd(lp, dnu), "discriminator."))
    net_w, disc_w = _jax_trees(jstate)
    with torch.no_grad():
        for params, want in zip(_port_trees(state), (net_w, disc_w)):
            for name, p in params.items():
                p.copy_(want[name])
        for (opt, mu_sd, nu_sd, prefix), params in zip(moments, _port_trees(state)):
            for name, p in params.items():
                st = opt.adam.state[p]
                st["exp_avg"].copy_(mu_sd[name[len(prefix):]])
                st["exp_avg_sq"].copy_(nu_sd[name[len(prefix):]])


def test_two_train_steps_match_jax_across_the_d_weight_gate(setup, jax_two_steps):
    """Each step's metrics, then the net's and the discriminator's weights
    after it. Step 0 sits before disc_start: ldm's d_weight is live there
    (no step gate) while disc_factor keeps the GAN term out; step 1 is past
    it. Step 1 starts from the JAX state after step 0 (weights and Adam
    moments): Adam's first update is lr * g / (|g| + eps), so every gradient
    element smaller than fp32's rounding (4e-8 of the largest here, against
    float64) takes a sign of its own on either side and moves its weight by
    up to 2 lr; the second step's reconstruction then differs by ~1e-5, and
    its g_loss, a mean of logits of both signs, by 5e-4 relative on both
    sides of a float64 run of the port."""
    jstates, want = jax_two_steps
    pm = setup["pm"]
    net, loss = _port_modules(setup)
    opt_ae, opt_disc = make_optimizers(net, loss, LR, grad_clip=1.0)
    state = TrainState(0, net, loss, opt_ae, opt_disc)
    step = make_plain_train_step(pm, step_counting="optimizer")
    lpips0 = [p.clone() for p in loss.perceptual_loss.parameters()]
    draws = {"posterior": torch.from_numpy(setup["eps"])}
    for i in range(2):
        if i:
            _carry_jax_state(state, jstates[0])
        with _threads():
            state, metrics = step(state, {"image": torch.from_numpy(setup["x"])}, draws=draws)
        _check_metrics(metrics, want[i])
        assert float(metrics["train/d_weight"]) > 0.0
        assert float(metrics["train/disc_factor"]) == float(i)
        for got_sd, want_sd in zip(_port_trees(state), _jax_trees(jstates[i])):
            scale = max(float(want_sd[k].abs().max()) for k in got_sd)
            for name, p in got_sd.items():
                np.testing.assert_allclose(p.detach().numpy(), want_sd[name].numpy(), rtol=0,
                                           atol=WEIGHT_REL * scale, err_msg=f"step {i} {name}")
    assert state.step == 2
    assert all(torch.equal(a, b) for a, b in zip(lpips0, loss.perceptual_loss.parameters()))
    assert float(loss.logvar) == pytest.approx(0.1)


def test_eval_step_matches_jax(setup, monkeypatch):
    jm = setup["jm"]
    lp = setup["loss_params"]
    jstate = JaxTrainState(step=jnp.asarray(3, jnp.int32), net_params=setup["net_params"],
                           loss_params=lp, opt_ae_state=None, opt_disc_state=None,
                           rng=jax.random.PRNGKey(0))
    _patch_normal(monkeypatch, setup["eps"])
    want = jax.jit(jax_make_plain_eval_step(jm))(
        jstate, {"image": jnp.asarray(setup["x"])}, jax.random.PRNGKey(2))
    net, loss = _port_modules(setup)
    before = [p.clone() for p in net.parameters()]
    got = make_plain_eval_step(setup["pm"])(
        TrainState(3, net, loss, None, None), {"image": torch.from_numpy(setup["x"])},
        draws={"posterior": torch.from_numpy(setup["eps"])})
    _check_metrics(got, want)
    assert all(k.startswith("val/") for k in got) and float(got["val/d_weight"]) == 0.0
    assert all(torch.equal(a, b) for a, b in zip(before, net.parameters()))


def test_export_plain_autoencoder_matches_jax(setup):
    """Key for key and value for value: the port's export of the modules
    against the JAX package's export of the trees they came from."""
    want = jax_export_plain_autoencoder(setup["net_params"], setup["loss_params"])
    got = export_plain_autoencoder(*_port_modules(setup))
    assert set(got) == set(want)
    assert "quant_conv.weight" in got and "loss.discriminator.main.3.running_var" in got
    assert not any(k.startswith("loss.perceptual_loss") for k in got)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v), err_msg=k)


def test_ckpt_path_loads_into_both_packages(setup, tmp_path):
    """An ldm ``.ckpt`` of other weights (written by the JAX package) through
    ``ckpt_path`` with ``ignore_keys`` ['decoder.conv_out'] into models that
    start from the setup's weights: the port's tensors equal the file's (the
    ignored ones stay the setup's), and both packages' forwards agree."""
    rng = np.random.default_rng(7)
    shapes = jax.eval_shape(lambda: (setup["net_params"], setup["loss_params"]))
    other_net, other_loss = _fill(shapes[0], rng), _fill(shapes[1], rng)
    path = str(tmp_path / "plain.ckpt")
    jax_save_torch_checkpoint(path, jax_export_plain_autoencoder(other_net, other_loss), 9)
    ignore = ["decoder.conv_out"]
    jm = JaxAutoencoder(ddconfig=SMALL_DD, lossconfig=LOSSCFG, embed_dim=16, ckpt_path=path,
                        ignore_keys=ignore)
    jnet, jloss = jm.maybe_init_from_ckpt(setup["net_params"], setup["loss_params"])
    pm = _port_model(ckpt_path=path, ignore_keys=ignore)
    net, loss = _port_modules(setup)
    pm.maybe_init_from_ckpt(net, loss)
    file_sd = load_torch_state_dict(path)
    for k, v in net.state_dict().items():
        want = setup["net_sd"][k] if k.startswith("decoder.conv_out") else file_sd[k]
        assert torch.equal(v, want), k
    assert torch.equal(loss.logvar, file_sd["loss.logvar"])
    assert torch.equal(loss.discriminator.main[0].weight, file_sd["loss.discriminator.main.0.weight"])
    np.testing.assert_array_equal(np.asarray(jloss["logvar"]), file_sd["loss.logvar"].numpy())
    with pytest.MonkeyPatch.context() as mp:
        _patch_normal(mp, setup["eps"])
        want = setup["forward"](jnet, jnp.asarray(setup["x"]))
    with torch.no_grad():
        outs = net(torch.from_numpy(setup["x"]), draws={"posterior": torch.from_numpy(setup["eps"])})
    _close(outs["dec_obj"], want["dec_obj"])
    _close(outs["posterior_obj"].mean, want["posterior_obj"].mean)


def test_plain_targets_and_wrapper_surface():
    cfg = merge_configs([PLAIN])
    model = instantiate_from_config(cfg["model"])
    assert isinstance(model, Autoencoder) and model.step_family == "plain"
    assert model.encoder_pretrain_steps == 0 and model.monitor == "val/rec_loss"
    assert isinstance(model.build_loss(), LPIPSWithDiscriminator)
    assert isinstance(model.build_net(), AutoencoderKLNet)
    nchw = {"image": np.zeros((2, 3, 32, 32), np.float32)}
    assert model.prepare_batch_host(nchw)["image"].shape == (2, 32, 32, 3)
    assert model.prepare_batch(model.example_batch(2), device="cpu")["image"].shape == (2, 32, 32, 3)


def test_cli_fits_resumes_and_exports_plain_without_jax(tmp_path):
    """``train_cli -b plain_kl_tiny.yaml -t data.params.batch_size=2`` (the
    config's 4 steps and accelerator: cpu; batch 2 to keep it short), then
    ``-r <run> -t --max_steps 6``, then ``export_torch_ckpt``, while jax,
    flax, optax, orbax and the JAX package cannot be imported (nor
    TensorBoard, whose import pulls TensorFlow where that is installed)."""
    from generative_detection_tpu_torch import export_torch_ckpt, train_cli

    with jax_unimportable(), pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "torch.utils.tensorboard", None)
        tr = train_cli.main(["-b", PLAIN, "-t", "-l", str(tmp_path), "-n", "plain",
                             "--logging_level", "WARNING", "data.params.batch_size=2"])
        run = Path(tr.logdir)
        tr2 = train_cli.main(["-r", str(run), "-t", "--max_steps", "6",
                              "--logging_level", "WARNING"])
        out = export_torch_ckpt.main(["-b", PLAIN, "-r", str(run),
                                      "--out", str(tmp_path / "plain.ckpt")])
    assert [tr.state.step, tr2.state.step] == [4, 6] and tr.device.type == "cpu"
    rows = [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in rows if "aeloss" in r] == [1, 2, 3, 4, 5, 6]
    assert all(np.isfinite(v) for r in rows for v in r.values())
    assert any("val/rec_loss" in r for r in rows)
    assert sorted(os.listdir(run / "checkpoints" / "last")) == ["6"]
    assert any(n.startswith("reconstructions") for n in os.listdir(run / "images" / "train"))
    sd = load_torch_state_dict(out["out"])
    assert out["step"] == 6 and "quant_conv.weight" in sd and "loss.logvar" in sd
