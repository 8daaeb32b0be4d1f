"""Reference checkpoints in and out of the port on the CPU, against the JAX
package's converters: ``ckpt_path`` (with ``ignore_keys``) loads a reference
``.ckpt`` into the port's modules, the port's ``export_pose_autoencoder`` +
``save_torch_checkpoint`` write one the JAX package reads back, the Trainer
consumes ``ckpt_path`` and a resume restores over it, and
``python -m generative_detection_tpu_torch.export_torch_ckpt`` exports a run
(in a process where JAX cannot be imported)."""

import copy
import logging
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generative_detection_tpu.config import instantiate_from_config as jax_instantiate
from generative_detection_tpu.serving import export_detector as jax_export_detector
from generative_detection_tpu.serving import load_detector as jax_load_detector
from generative_detection_tpu.utils.torch_compat import (
    export_pose_autoencoder as jax_export_pose_autoencoder,
)
from generative_detection_tpu.utils.torch_compat import (
    save_torch_checkpoint as jax_save_torch_checkpoint,
)
from generative_detection_tpu_torch.config import instantiate_from_config, merge_configs
from generative_detection_tpu_torch.serving import make_detector_fn
from generative_detection_tpu_torch.train import Trainer, create_train_state
from generative_detection_tpu_torch.utils.jax_compat import state_dict_from_jax
from generative_detection_tpu_torch.utils.torch_compat import (
    export_pose_autoencoder, load_torch_state_dict, save_torch_checkpoint,
)
from tests.test_ckpt_path import _build_state_dict
from tests.test_models import small_model
from tests.test_torch_port_detector import HMAX, HMIN, _camera_args
from tests.test_torch_port_model import jax_net_params, port_small_model
from tests._torch_cpu import deleted_after, one_torch_thread, tmp_path  # noqa: F401 (fixtures)

REPO = Path(__file__).resolve().parents[1]
TINY = str(REPO / "configs/autoencoder/pose/tiny_cpu.yaml")
SEED = 23
# taming's NLayerDiscriminator: flax module name -> ``main`` index
DISC = {"conv_0": 0, "conv_1": 2, "bn_1": 3, "conv_2": 5, "bn_2": 6, "conv_3": 8, "bn_3": 9,
        "conv_out": 11}


def _port_model(**params):
    cfg = merge_configs([TINY])
    cfg["model"]["params"].update(params)
    return instantiate_from_config(cfg["model"])


@pytest.fixture(scope="module")
def ref_ckpt(tmp_path_factory):
    """A reference-layout ``.ckpt`` of tiny_cpu.yaml's architecture, spec-built
    as ``tests/test_ckpt_path.py`` builds it (torch tensors, as a Lightning
    checkpoint holds them)."""
    dd = merge_configs([TINY])["model"]["params"]["ddconfig"]
    sd = {k: torch.as_tensor(np.asarray(v)) for k, v in _build_state_dict(dict(dd)).items()}
    with deleted_after(tmp_path_factory.mktemp("ref")) as root:
        path = str(root / "odvae.ckpt")
        torch.save({"state_dict": sd, "global_step": 5}, path)
        yield sd, path


@pytest.fixture(scope="module")
def jax_small():
    jm = small_model()
    return jm, jax_net_params(jm)


def _normal(rng, shape):
    return rng.normal(size=tuple(shape)).astype(np.float32)


def _numpy_tree(tree):
    return {k: _numpy_tree(v) if isinstance(v, dict) else np.asarray(v) for k, v in tree.items()}


def _flax_discriminator(loss, rng):
    """Random discriminator parameters in the JAX package's flax layout,
    shaped as the port's ``loss.discriminator``."""
    sd = loss.discriminator.state_dict()
    tree = {}
    for name, idx in DISC.items():
        w = sd[f"main.{idx}.weight"]
        # torch (O, I, kh, kw) -> flax (kh, kw, I, O)
        leaf = ({"kernel": _normal(rng, w.permute(2, 3, 1, 0).shape)} if w.dim() == 4
                else {"scale": _normal(rng, w.shape)})
        if f"main.{idx}.bias" in sd:
            leaf["bias"] = _normal(rng, sd[f"main.{idx}.bias"].shape)
        tree[name] = leaf
    return tree


def test_jax_export_loads_through_ckpt_path(jax_small, tmp_path):
    """A ``.ckpt`` from the JAX package's ``save_torch_checkpoint(
    export_pose_autoencoder(params, loss_params))`` gives the port, through
    ``ckpt_path``, ``state_dict_from_jax(params)`` bit for bit, and the
    loss's logvar and discriminator."""
    jm, params = jax_small
    pm = port_small_model()
    rng = np.random.default_rng(4)
    loss_params = {"logvar": np.float32(0.3), "discriminator": _flax_discriminator(
        pm.build_loss(), rng)}
    path = str(tmp_path / "jax.ckpt")
    jax_save_torch_checkpoint(path, jax_export_pose_autoencoder(params, loss_params), 7)
    pm.ckpt_path = path
    net, loss = pm.maybe_init_from_ckpt(pm.build_net(), pm.build_loss())
    want = state_dict_from_jax(params)
    got = net.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    assert loss.logvar.item() == np.float32(0.3)
    lsd = loss.state_dict()
    for name, idx in DISC.items():
        leaf = loss_params["discriminator"][name]
        w = leaf["kernel"].transpose(3, 2, 0, 1) if "kernel" in leaf else leaf["scale"]
        key = f"discriminator.main.{idx}"
        assert torch.equal(lsd[f"{key}.weight"], torch.from_numpy(w.copy()))
        if "bias" in leaf:
            assert torch.equal(lsd[f"{key}.bias"], torch.from_numpy(leaf["bias"]))


def test_port_export_loads_through_jax_ckpt_path(jax_small, tmp_path):
    """The port's ``export_pose_autoencoder`` + ``save_torch_checkpoint``
    write a ``.ckpt`` that the JAX package's ``ckpt_path`` reads back bit
    for bit (network, logvar, discriminator; BatchNorm buffers as fresh
    defaults; no LPIPS)."""
    jm, params0 = jax_small
    pm = port_small_model()
    net = pm.init_net(torch.Generator().manual_seed(1), device="cpu")
    loss = pm.build_loss()
    with torch.no_grad():
        loss.logvar.fill_(-0.7)
    sd = export_pose_autoencoder(net, loss)
    assert not any(k.startswith("loss.perceptual_loss") for k in sd)
    assert torch.equal(sd["loss.discriminator.main.3.running_var"], torch.ones(128))
    path = str(tmp_path / "port.ckpt")
    save_torch_checkpoint(path, sd, global_step=11)
    assert torch.load(path, weights_only=False)["global_step"] == 11
    jm = small_model(ckpt_path=path)
    template = {"logvar": np.float32(0.0),
                "discriminator": _flax_discriminator(loss, np.random.default_rng(6))}
    jnet, jloss = jm.maybe_init_from_ckpt(params0, template)
    got = state_dict_from_jax(_numpy_tree(jnet))
    for k, v in net.state_dict().items():
        assert torch.equal(got[k], v), k
    assert float(jloss["logvar"]) == np.float32(-0.7)
    dsd = loss.discriminator.state_dict()
    for name, idx in DISC.items():
        leaf = jloss["discriminator"][name]
        w = (np.asarray(leaf["kernel"]).transpose(3, 2, 0, 1) if "kernel" in leaf
             else np.asarray(leaf["scale"]))
        assert np.array_equal(w, dsd[f"main.{idx}.weight"].numpy()), name


def test_reference_ckpt_detector_matches_jax(ref_ckpt, jax_small):
    """The reference ``.ckpt`` through the port's ``ckpt_path`` gives the
    detector the JAX package gives after its ``maybe_init_from_ckpt`` of the
    same file (fp32, at ``test_torch_port_detector.py``'s tolerances), and
    its network holds every tensor of the file."""
    sd, path = ref_ckpt
    cfg = merge_configs([TINY])
    cfg["model"]["params"]["ckpt_path"] = path
    jm = jax_instantiate(copy.deepcopy(cfg["model"]))
    # the small model's params as the template: tiny_cpu.yaml's architecture
    jparams, _ = jm.maybe_init_from_ckpt(jax_small[1], None)
    pm = instantiate_from_config(cfg["model"])
    rng = np.random.default_rng(5)
    args = (rng.normal(size=(3, 32, 32, 3)).astype(np.float32), *_camera_args(rng, 3))
    # the JAX package's serving artifact of that detector: a quarter of the
    # CPU time its make_detector_fn takes to trace and compile here
    jdet = jax_load_detector(jax_export_detector(jm, jparams, HMIN, HMAX, batch=3,
                                                 dtype="float32"))
    want = [np.asarray(a) for a in jdet(*map(jnp.asarray, args))]
    net, _ = pm.maybe_init_from_ckpt(pm.build_net())
    det = make_detector_fn(pm, net, HMIN, HMAX, 32, dtype="float32", device="cpu")
    boxes, cls, score = (t.numpy() for t in det(*args))
    np.testing.assert_allclose(boxes, want[0], rtol=1e-3, atol=1e-4)
    np.testing.assert_array_equal(cls, want[1])
    np.testing.assert_allclose(score, want[2], rtol=1e-5, atol=1e-6)
    got = net.state_dict()
    assert set(got) == {k for k in sd if not k.startswith("loss.")}
    for k, v in got.items():
        assert torch.equal(v, sd[k]), k


def test_detector_serves_the_given_weights_not_ckpt_path(ref_ckpt):
    """``make_detector_fn`` of a model with ``ckpt_path`` serves the
    network it is given (a trained net shipped after a fit that started
    from the file), bit for bit what a model without ``ckpt_path`` serves
    of it, and not the file's weights (``export_detector``: in
    ``test_torch_port_export.py``'s fixed-batch case)."""
    sd, path = ref_ckpt
    pm, plain = _port_model(ckpt_path=path), _port_model()
    net = pm.init_net(torch.Generator().manual_seed(2), device="cpu")
    assert not torch.equal(net.encoder.conv_in.weight, sd["encoder.conv_in.weight"])
    rng = np.random.default_rng(8)
    args = (rng.normal(size=(2, 32, 32, 3)).astype(np.float32), *_camera_args(rng, 2))

    def serve(model, weights):
        return make_detector_fn(model, weights, HMIN, HMAX, 32, dtype="float32",
                                device="cpu")(*args)

    want = serve(plain, net)
    for got in (serve(pm, net), serve(pm, net.state_dict())):
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    from_file = serve(plain, pm.maybe_init_from_ckpt(pm.build_net())[0])
    assert not torch.equal(from_file[0], want[0])


def test_ignore_keys_keep_the_ports_init(ref_ckpt):
    """``ignore_keys`` prefixes (ldm's semantics) keep the port's own init;
    the rest land in the network's dtype (bf16 here) from the file."""
    sd, path = ref_ckpt
    pm = _port_model(ckpt_path=path, ignore_keys=["pose_encoder", "encoder.conv_in"],
                     dtype="bfloat16")
    net = pm.init_net(torch.Generator().manual_seed(0), device="cpu")
    init = {k: v.clone() for k, v in net.state_dict().items()}
    pm.maybe_init_from_ckpt(net)
    for k, v in net.state_dict().items():
        if k.startswith(("pose_encoder", "encoder.conv_in")):
            assert torch.equal(v, init[k]), k
        else:
            assert v.dtype == init[k].dtype and torch.equal(v, sd[k].to(v.dtype)), k
    assert net.encoder.conv_in.weight.dtype == torch.bfloat16
    bad = dict(sd, **{"encoder.conv_in.weight": torch.zeros(1, 3, 3, 3)})
    torch.save({"state_dict": bad}, path + ".bad")
    with pytest.raises(RuntimeError, match="size mismatch"):
        _port_model(ckpt_path=path + ".bad").maybe_init_from_ckpt(pm.build_net())


def _fit(pm, logdir, steps, resume=None):
    cfg = merge_configs([TINY])["data"]
    trainer = Trainer(pm, logdir=str(logdir), max_epochs=1, max_steps=steps,
                      limit_val_batches=0, seed=SEED, device="cpu",
                      resume_from_checkpoint=resume)
    trainer.fit(instantiate_from_config(cfg))
    return trainer


@pytest.fixture(scope="module")
def run_a(tmp_path_factory):
    """One step of a Trainer fit of tiny_cpu.yaml without ``ckpt_path`` at
    learning rate 0: its weights stay the seed's."""
    pm = _port_model()
    pm.learning_rate = 0.0
    with deleted_after(tmp_path_factory.mktemp("run_a")) as root:
        yield _fit(pm, root, 1), root


def test_trainer_fit_consumes_ckpt_path_and_resume_restores_over_it(ref_ckpt, run_a,
                                                                     tmp_path, caplog):
    """The Trainer's state (``create_train_state``, which its fit calls
    with the run's seed) loads ``ckpt_path`` over the seeded init and
    ``ignore_keys`` keep the init; a fit with ``ckpt_path`` and ``-r``
    loads the file, then restores the run's checkpoint over it, as the JAX
    package's fit does."""
    sd, path = ref_ckpt
    a, a_root = run_a
    seeded = a.state.net.state_dict()
    pm = _port_model(ckpt_path=path, ignore_keys=["pose_encoder"])
    pm.learning_rate = 0.0
    b = create_train_state(pm, 0.0, seed=SEED, device="cpu")
    for k, v in b.net.state_dict().items():
        assert torch.equal(v, seeded[k] if k.startswith("pose_encoder") else sd[k]), k
    assert b.loss.logvar.item() == 0.125
    with caplog.at_level(logging.INFO):
        c = _fit(pm, tmp_path / "c", 2, resume=str(a_root / "checkpoints"))
    loaded = caplog.text.find("Initializing from torch checkpoint " + path)
    assert 0 <= loaded < caplog.text.find("Resumed from step"), caplog.text
    assert c.state.step == 2
    for k, v in c.state.net.state_dict().items():
        assert torch.equal(v, seeded[k]), k
    assert c.state.loss.logvar.item() == a.state.loss.logvar.item()


def test_export_torch_ckpt_cli_round_trips_a_run(run_a, tmp_path):
    """``python -m generative_detection_tpu_torch.export_torch_ckpt -b
    tiny_cpu.yaml -r <run> --out x.ckpt`` in a process where jax, flax,
    optax, orbax and the JAX package cannot be imported writes a ``.ckpt``
    that the port's ``ckpt_path`` reloads bit for bit."""
    a, a_root = run_a
    code = (
        "import sys, runpy\n"
        "for m in ('jax', 'flax', 'optax', 'orbax', 'generative_detection_tpu'):\n"
        "    sys.modules[m] = None\n"
        "sys.argv = ['export_torch_ckpt'] + sys.argv[1:]\n"
        "runpy.run_module('generative_detection_tpu_torch.export_torch_ckpt',"
        " run_name='__main__')\n"
    )
    out = str(tmp_path / "x.ckpt")
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    run = subprocess.run([sys.executable, "-c", code, "-b", TINY, "-r", str(a_root),
                          "--out", out], cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=300)
    assert run.returncode == 0, run.stderr[-4000:]
    blob = torch.load(out, weights_only=False)
    assert blob["global_step"] == a.state.step == 1
    assert not any(k.startswith("loss.perceptual_loss") for k in load_torch_state_dict(out))
    pm = _port_model(ckpt_path=out)
    net, loss = pm.maybe_init_from_ckpt(pm.build_net(), pm.build_loss())
    for k, v in a.state.net.state_dict().items():
        assert torch.equal(net.state_dict()[k], v), k
    for k, v in a.state.loss.state_dict().items():
        if not k.startswith("perceptual_loss"):
            assert torch.equal(loss.state_dict()[k], v), k
