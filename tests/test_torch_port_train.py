"""Port parity on the CPU for the loss stack and the train step: LPIPS, the
discriminator, ``PoseLoss`` and one pose train step of the port against the
JAX package on shared weights (``tiny_cpu.yaml``, batch 2).

The JAX state is built once per module. Its flax parameters go through
``state_dict_from_jax``/``loss_state_dict_from_jax`` into the port. The
forward's four random draws are made with numpy; the JAX step gets them by
replacing ``jax.random.normal``/``uniform`` during its call (they return the
arrays in call order), the port through ``draws``.

Tolerances, fp32 on both sides on the CPU:
- module outputs and input gradients: 1e-4 of the reference's largest
  magnitude (convolutions and sums in another order);
- losses and logged metrics: 1e-4 relative, plus 1e-6 absolute for values
  that are zero on one side by construction;
- Adam moments after one step: mu = (1 - b1) * clipped g and nu =
  (1 - b2) * g^2, so they compare the gradients themselves. The composite
  loss is ~1e6 and the global-norm clip scales every gradient by the same
  factor, so the limit is 1e-3 of each tree's largest magnitude: summation
  noise is proportional to the global scale, not to each leaf.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generative_detection_tpu.config import instantiate_from_config as jax_instantiate
from generative_detection_tpu.config import merge_configs as jax_merge
from generative_detection_tpu.models.discriminator import NLayerDiscriminator as JaxDisc
from generative_detection_tpu.models.lpips import LPIPS as JaxLPIPS
from generative_detection_tpu.train import TrainState as JaxTrainState
from generative_detection_tpu.train import make_optimizers as jax_make_optimizers
from generative_detection_tpu.train import make_eval_step as jax_make_eval_step
from generative_detection_tpu.train import make_train_step as jax_make_train_step
from generative_detection_tpu.utils.distributions import (
    DiagonalGaussianDistribution as JaxGaussian,
)
from generative_detection_tpu.utils.torch_compat import convert_pose_autoencoder
from generative_detection_tpu_torch.config import instantiate_from_config, merge_configs
from generative_detection_tpu_torch.train import (
    TrainState,
    make_eval_step,
    make_optimizers,
    make_train_step,
)
from generative_detection_tpu_torch.train.state import flax_like_net
from generative_detection_tpu_torch.utils.distributions import DiagonalGaussianDistribution
from generative_detection_tpu_torch.utils.jax_compat import (
    loss_state_dict_from_jax,
    state_dict_from_jax,
)
from tests._torch_cpu import one_torch_thread  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parents[1]
TINY = str(REPO / "configs/autoencoder/pose/tiny_cpu.yaml")
LR = 1e-4
BS = 2


def _np(x):
    return np.asarray(x.detach().float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32))


def _close(got, want, rel=1e-4):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= rel * scale, f"max err {err} > {rel} * {scale}"


def _tree_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _lpips_tree(loss_sd):
    """The port's LPIPS weights as the JAX package's ``perceptual`` tree."""
    convs = [k[: -len(".weight")] for k in loss_sd
             if k.startswith("perceptual_loss.net.") and k.endswith(".weight")]
    convs.sort(key=lambda k: int(k.rsplit(".", 1)[1]))
    tree = {"vgg": {}}
    for i, key in enumerate(convs, 1):
        tree["vgg"][f"conv{i}"] = {
            "kernel": loss_sd[f"{key}.weight"].numpy().transpose(2, 3, 1, 0),
            "bias": loss_sd[f"{key}.bias"].numpy(),
        }
    for i in range(5):
        w = loss_sd[f"perceptual_loss.lin{i}.model.1.weight"].numpy()
        tree[f"lin{i}"] = {"kernel": w.transpose(2, 3, 1, 0)}
    return tree


@pytest.fixture(scope="module")
def setup():
    jm = jax_instantiate(jax_merge([TINY])["model"])
    pm = instantiate_from_config(merge_configs([TINY])["model"])
    # Seeded port weights, handed to the JAX package through its own
    # torch-checkpoint converter (cheaper than JAX's jitted init on the CPU).
    g = torch.Generator().manual_seed(0)
    net_sd = flax_like_net(pm, g, "cpu").state_dict()
    loss_sd = pm.init_loss(g, device="cpu").state_dict()
    sd = {k: v.numpy() for k, v in net_sd.items()}
    sd.update({f"loss.{k}": v.numpy() for k, v in loss_sd.items()})
    net_params, loss_params = convert_pose_autoencoder(sd, jm.ddconfig)
    loss_params = dict(loss_params, perceptual=_lpips_tree(loss_sd))
    opt_ae, opt_disc = jax_make_optimizers(LR, grad_clip=1.0)
    state = JaxTrainState(
        step=jnp.asarray(0, jnp.int32), net_params=net_params, loss_params=loss_params,
        opt_ae_state=opt_ae.init(net_params),
        opt_disc_state=opt_disc.init(loss_params["discriminator"]),
        rng=jax.random.PRNGKey(0),
    )
    rng = np.random.default_rng(0)
    host = jm.example_batch(BS)
    host[jm.image_rgb_key] = rng.uniform(0, 1, size=(BS, 32, 32, 3)).astype(np.float32)
    host[jm.pose_key] = rng.normal(size=(BS, 4)).astype(np.float32)
    host["yaw"] = rng.uniform(-3, 3, size=BS).astype(np.float32)
    host[jm.class_key] = np.array([0, 1], np.int32)  # 1: the background_class_idx quirk
    host["original_class_id"] = np.array([3, 10], np.int32)  # 10: the prior-KL skip
    host[jm.bbox_key] = rng.uniform(1, 4, size=(BS, 3)).astype(np.float32)
    host[jm.fill_factor_key] = rng.uniform(0.2, 0.8, size=BS).astype(np.float32)
    mask = np.zeros((BS, 32, 32, 1), np.float32)
    mask[:, 4:28, 6:26] = 1.0
    host["mask_2d_bbox"] = mask
    draws = {
        "posterior": rng.normal(size=(BS, 16, 16, 16)).astype(np.float32),
        "dropout": rng.uniform(size=(BS, 16, 16, 16)).astype(np.float32),
        "noise": rng.normal(size=(BS, 16, 16, 16)).astype(np.float32),
        "bbox": rng.normal(size=(BS, 8)).astype(np.float32),
    }
    return dict(
        jm=jm, pm=pm, opt_ae=opt_ae, opt_disc=opt_disc, state=state, net_sd=net_sd,
        loss_sd=loss_sd, net_params=net_params, loss_params=loss_params,
        jbatch=jm.prepare_batch(host), pbatch=pm.prepare_batch(host, device="cpu"),
        draws=draws,
    )


def _port_loss(setup):
    loss = setup["pm"].build_loss()
    loss.load_state_dict(setup["loss_sd"], strict=True)
    return loss


def test_loss_state_dict_from_jax_inverts_the_converter(setup):
    sd = loss_state_dict_from_jax(_tree_np(setup["loss_params"]))
    assert set(sd) == set(setup["loss_sd"])
    for k, v in setup["loss_sd"].items():
        assert torch.equal(sd[k], v), k
    net_sd = state_dict_from_jax(_tree_np(setup["net_params"]))
    assert all(torch.equal(net_sd[k], v) for k, v in setup["net_sd"].items())


def _jit_vjp(fn, *args):
    """JAX ``fn(*args)`` and the gradient of its sum, under one jit."""
    def f(*a):
        out, vjp = jax.vjp(fn, *a)
        return out, vjp(jnp.ones_like(out))
    return jax.jit(f)(*args)


def _nhwc(rng, shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def test_lpips_forward_and_input_gradient_match_jax(setup):
    rng = np.random.default_rng(1)
    a, b = _nhwc(rng, (2, 32, 32, 3), 0.5), _nhwc(rng, (2, 32, 32, 3), 0.5)
    params = setup["loss_params"]["perceptual"]
    want, (ga, gb) = _jit_vjp(
        lambda x, y: JaxLPIPS().apply({"params": params}, x, y), jnp.asarray(a), jnp.asarray(b)
    )
    lpips = _port_loss(setup).perceptual_loss
    at, bt = (torch.from_numpy(x).requires_grad_(True) for x in (a, b))
    got = lpips(at, bt)
    got.sum().backward()
    assert got.shape == (2, 1, 1, 1)
    assert not any(p.requires_grad for p in lpips.parameters())
    _close(got, want)
    _close(at.grad, ga)
    _close(bt.grad, gb)


def test_discriminator_forward_and_input_gradient_match_jax(setup):
    x = _nhwc(np.random.default_rng(2), (2, 32, 32, 3))
    params = setup["loss_params"]["discriminator"]
    want, (gx,) = _jit_vjp(
        lambda t: JaxDisc().apply({"params": params}, t, train=True), jnp.asarray(x)
    )
    disc = _port_loss(setup).discriminator
    xt = torch.from_numpy(x).requires_grad_(True)
    got = disc(xt)
    got.sum().backward()
    assert not any(hasattr(m, "running_mean") for m in disc.modules())
    _close(got, want)
    _close(xt.grad, gx)


def _posteriors(rng):
    p = _nhwc(rng, (BS, 16, 16, 32))
    m, lv = _nhwc(rng, (BS, 8)), _nhwc(rng, (BS, 8), 0.5)
    jax_post = (JaxGaussian.from_parameters(jnp.asarray(p), axis=-1),
                JaxGaussian(jnp.asarray(m), jnp.asarray(lv)))
    port_post = (DiagonalGaussianDistribution.from_parameters(torch.from_numpy(p), dim=-1),
                 DiagonalGaussianDistribution(torch.from_numpy(m), torch.from_numpy(lv)))
    return jax_post, port_post


def _check_metrics(got: dict, want: dict, keys=None):
    for key in keys or want:
        np.testing.assert_allclose(
            _np(got[key]), _np(want[key]), rtol=1e-4, atol=1e-6, err_msg=key
        )


@pytest.fixture(scope="module")
def jax_pose_losses(setup):
    """Both JAX losses under one jit; ``global_step`` is traced, so the
    pretrain and full branches share one compile."""
    jm, jb = setup["jm"], setup["jbatch"]

    def losses(params, dec_obj, dec_pose, posterior_obj, bbox_posterior, step):
        gen = jm.loss.apply(
            {"params": params}, jb["rgb_gt"], None, jb["pose_gt"], dec_obj, dec_pose,
            jb["class_gt"], jb["class_orig_id"], jb["bbox_gt"], jb["fill_factor_gt"],
            posterior_obj, bbox_posterior, step, jb["mask_2d_bbox"], d_weight=0.3,
            method=jm.loss.generator_loss,
        )
        disc = jm.loss.apply(
            {"params": params}, jb["rgb_gt"], dec_obj, jb["class_gt"], step,
            jb["mask_2d_bbox"], method=jm.loss.discriminator_loss,
        )
        return gen, disc

    return jax.jit(losses)


@pytest.mark.parametrize("global_step", [1, 20])
def test_pose_loss_matches_jax(setup, jax_pose_losses, global_step):
    rng = np.random.default_rng(3)
    pb = setup["pbatch"]
    dec_obj = _nhwc(rng, (BS, 32, 32, 3), 0.5)
    dec_pose = _nhwc(rng, (BS, 19))
    (jpo, jbp), (ppo, pbp) = _posteriors(rng)
    (want, wlog), (want_d, wlog_d) = jax_pose_losses(
        setup["loss_params"], jnp.asarray(dec_obj), jnp.asarray(dec_pose), jpo, jbp,
        jnp.asarray(global_step, jnp.int32),
    )
    loss = _port_loss(setup)
    got, glog = loss.generator_loss(
        pb["rgb_gt"], None, pb["pose_gt"], torch.from_numpy(dec_obj),
        torch.from_numpy(dec_pose), pb["class_gt"], pb["class_orig_id"], pb["bbox_gt"],
        pb["fill_factor_gt"], ppo, pbp, global_step, pb["mask_2d_bbox"], d_weight=0.3,
    )
    assert set(glog) == set(wlog)
    _check_metrics({"total": got, **glog}, {"total": want, **wlog})
    got_d, glog_d = loss.discriminator_loss(
        pb["rgb_gt"], torch.from_numpy(dec_obj), pb["class_gt"], global_step, pb["mask_2d_bbox"]
    )
    assert set(glog_d) == set(wlog_d)
    _check_metrics({"d": got_d, **glog_d}, {"d": want_d, **wlog_d})


class _PatchedDraws:
    """Replace ``jax.random.normal``/``uniform`` so that they return the
    given arrays in call order (normal: posterior, noise, bbox; uniform:
    dropout) wherever the requested shape is the next array's."""

    def __init__(self, monkeypatch, draws):
        normals = [draws["posterior"], draws["noise"], draws["bbox"]]
        uniforms = [draws["dropout"]]

        def take(queue, original):
            def fn(key, shape=(), dtype=jnp.float32, *args, **kw):
                if not queue or tuple(shape) != queue[0].shape:
                    # flax checks a parameter's shape by tracing its init
                    return original(key, shape, dtype, *args, **kw)
                return jnp.asarray(queue.pop(0), dtype)
            return fn

        monkeypatch.setattr(jax.random, "normal", take(normals, jax.random.normal))
        monkeypatch.setattr(jax.random, "uniform", take(uniforms, jax.random.uniform))
        self.left = (normals, uniforms)


def _adam_moments(opt_state):
    """(mu, nu) of an optax chain(clip, adam) state."""
    for leaf in jax.tree_util.tree_leaves(opt_state, is_leaf=lambda s: hasattr(s, "mu")):
        if hasattr(leaf, "mu"):
            return _tree_np(leaf.mu), _tree_np(leaf.nu)
    raise AssertionError("no Adam state")


def _disc_sd(loss_params, disc_tree):
    sd = loss_state_dict_from_jax(dict(loss_params, discriminator=disc_tree))
    return {k.removeprefix("discriminator."): v for k, v in sd.items()
            if k.startswith("discriminator.")}


def _check_moments(opt, params, mu_sd, nu_sd, rel=1e-3):
    for which, want in (("mu", mu_sd), ("nu", nu_sd)):
        scale = max(float(np.abs(v.numpy()).max()) for v in want.values())
        for name, p in params.items():
            got = opt.moments(p)[which == "nu"]
            np.testing.assert_allclose(got.detach().numpy(), want[name].numpy(), rtol=0,
                                       atol=rel * scale, err_msg=f"{which} {name}")


@pytest.mark.parametrize(
    "phase, step, lean", [("pretrain", 0, True), ("full", 6, False)], ids=["lean_pretrain", "full"]
)
def test_train_step_matches_jax(setup, monkeypatch, phase, step, lean):
    jm, pm = setup["jm"], setup["pm"]
    jstate = setup["state"].replace(step=jnp.asarray(step, jnp.int32))
    jstep = jax_make_train_step(jm, setup["opt_ae"], setup["opt_disc"], phase=phase,
                                step_counting="optimizer", lean_pretrain=lean)
    with monkeypatch.context() as mp:
        patched = _PatchedDraws(mp, setup["draws"])
        new_jstate, jmetrics = jax.jit(jstep)(jstate, setup["jbatch"])
        assert patched.left == ([], [])

    net = pm.build_net()
    net.load_state_dict(setup["net_sd"], strict=True)
    loss = _port_loss(setup)
    opt_ae, opt_disc = make_optimizers(net, loss, LR, grad_clip=1.0)
    state = TrainState(step, net, loss, opt_ae, opt_disc)
    pstep = make_train_step(pm, phase=phase, step_counting="optimizer", lean_pretrain=lean)
    lpips0 = [p.clone() for p in loss.perceptual_loss.parameters()]
    disc0 = [p.clone() for p in loss.discriminator.parameters()]
    draws = {k: torch.from_numpy(v) for k, v in setup["draws"].items()}
    state, metrics = pstep(state, setup["pbatch"], draws=draws)

    assert state.step == step + 1
    assert set(metrics) == set(jmetrics)
    _check_metrics(metrics, jmetrics)
    if not lean:
        assert float(metrics["train/d_weight"]) > 0
        assert float(metrics["train/rec_loss"]) > 0
    assert all(torch.equal(a, b) for a, b in zip(lpips0, loss.perceptual_loss.parameters()))
    assert float(loss.logvar) == float(setup["loss_sd"]["logvar"])
    disc_moved = any(not torch.equal(a, b) for a, b in zip(disc0, loss.discriminator.parameters()))
    assert disc_moved == (not lean)

    mu, nu = _adam_moments(new_jstate.opt_ae_state)
    _check_moments(opt_ae, dict(net.named_parameters()), state_dict_from_jax(mu),
                   state_dict_from_jax(nu))
    if not lean:
        mu, nu = _adam_moments(new_jstate.opt_disc_state)
        lp = setup["loss_params"]
        _check_moments(opt_disc, dict(loss.discriminator.named_parameters()),
                       _disc_sd(lp, mu), _disc_sd(lp, nu))


def test_eval_step_logs_what_jax_logs(setup):
    """The eval step logs JAX's keys (read from a trace of JAX's eval step,
    not a compile), finite, with d_weight 0 and no parameter touched."""
    jm, pm = setup["jm"], setup["pm"]
    want = jax.eval_shape(
        jax_make_eval_step(jm), setup["state"], setup["jbatch"], jax.random.PRNGKey(0)
    )
    net = pm.build_net()
    net.load_state_dict(setup["net_sd"], strict=True)
    state = TrainState(6, net, _port_loss(setup), None, None)
    draws = {k: torch.from_numpy(v) for k, v in setup["draws"].items()}
    before = [p.clone() for p in net.parameters()]
    metrics = make_eval_step(pm)(state, setup["pbatch"], draws=draws)
    assert set(metrics) == set(want)
    assert all(bool(torch.isfinite(torch.as_tensor(v)).all()) for v in metrics.values())
    assert float(metrics["val/d_weight"]) == 0.0 and float(metrics["val/rec_loss"]) > 0.0
    assert all(torch.equal(a, b) for a, b in zip(before, net.parameters()))
