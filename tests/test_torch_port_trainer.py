"""Port parity on the CPU for the trainer slice: gradient accumulation, the
separate discriminator forward, and the port's ``Trainer.fit`` against the
JAX package's step functions; then the Trainer's own semantics and the
training CLI, on the port alone.

Both sides start from the same seeded weights (the port's, handed to the JAX
package through its torch-checkpoint converter) and take the same forward
draws: numpy arrays, which the JAX step gets by replacing
``jax.random.normal``/``uniform`` while it is traced and the port through
``draws`` (the Trainer's forward gets them through a patched
``PoseAutoencoderNet.forward``). Every step of a test takes the same draws.

Tolerances, fp32 on both sides (``tests/test_torch_port_train.py``'s):
- losses and logged metrics: 1e-4 relative, plus 1e-6 absolute for values
  that are zero on one side by construction; except ``train/d_weight``, at
  1e-3 relative: it is the ratio of two norms of the decoder's ``conv_out``
  weight gradients, each a sum over B * H * W = 8192 positions of
  mixed-sign terms that cancel, so fp32 rounding in the forward is
  amplified there. On the accumulation test's second batch the port's own
  d_weight moves by 2.3e-4 between one and eight CPU threads, while the
  inputs of that gradient agree to 7e-6 and a float64 run of the same step
  sits between the two;
- Adam moments and weights: 1e-3 of each tree's largest magnitude (the
  global-norm clip scales every gradient alike, so summation noise is
  proportional to the global scale, not to each leaf).

The port's side of these comparisons runs on two PyTorch intra-op threads
(``_threads``), the rest of the file on the one thread of ``one_torch_thread``.
On one thread PyTorch's CPU backward through the discriminator loses up to
6e-3 of the largest gradient of a layer on the synthetic batches here
(main.3.bias; 4.7e-2 at main.6.bias), against a float64 run of the same
port code, where two, three or four threads stay within 3e-6: the
single-thread kernels' order of summation, not the port's arithmetic.
"""

import contextlib
import itertools
import json
import os
import signal
import sys
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generative_detection_tpu.config import instantiate_from_config as jax_instantiate
from generative_detection_tpu.config import merge_configs as jax_merge
from generative_detection_tpu.train import TrainState as JaxTrainState
from generative_detection_tpu.train import make_optimizers as jax_make_optimizers
from generative_detection_tpu.train import make_train_step as jax_make_train_step
from generative_detection_tpu.train.loop import Trainer as JaxTrainer
from generative_detection_tpu.utils.torch_compat import convert_pose_autoencoder
from generative_detection_tpu_torch.config import instantiate_from_config, merge_configs
from generative_detection_tpu_torch.data.datamodule import THREAD_NAME
from generative_detection_tpu_torch.models.autoencoder import PoseAutoencoderNet
from generative_detection_tpu_torch.train import (
    CheckpointManager,
    Trainer,
    TrainState,
    make_optimizers,
    make_train_step,
)
from generative_detection_tpu_torch.train.callbacks import (
    Callback,
    CheckpointCallback,
    ImageLogger,
)
from generative_detection_tpu_torch.train.checkpoint import restore_signals, save_on_signal
from generative_detection_tpu_torch.train.metrics import MetricsLogger, WandbLogger, make_logger
from generative_detection_tpu_torch.train.state import flax_like_net
from generative_detection_tpu_torch.utils.jax_compat import state_dict_from_jax
from tests._torch_cpu import (  # noqa: F401 (fixtures)
    deleted_after,
    jax_unimportable,
    one_torch_thread,
    tmp_path,
)
from tests.test_torch_port_train import (
    _adam_moments,
    _check_metrics,
    _check_moments,
    _disc_sd,
    _lpips_tree,
)

REPO = Path(__file__).resolve().parents[1]
TINY = str(REPO / "configs/autoencoder/pose/tiny_cpu.yaml")
LR = 1e-4
SEED = 23
BS = 8  # tiny_cpu.yaml's batch
FIT_STEPS = 3  # tiny_cpu.yaml: batch 0 is 'pretrain', batches 1 and 2 'full'


def _draws(bs=BS, seed=0):
    rng = np.random.default_rng(seed)
    return {
        "posterior": rng.normal(size=(bs, 16, 16, 16)).astype(np.float32),
        "dropout": rng.uniform(size=(bs, 16, 16, 16)).astype(np.float32),
        "noise": rng.normal(size=(bs, 16, 16, 16)).astype(np.float32),
        "bbox": rng.normal(size=(bs, 8)).astype(np.float32),
    }


class _CyclingDraws:
    """Replace ``jax.random.normal``/``uniform`` so that every forward traced
    takes the given arrays, in the forward's call order (normal: posterior,
    noise, bbox; uniform: dropout); a call of another shape (a parameter
    init) goes to the original."""

    def __init__(self, monkeypatch, draws):
        normals = itertools.cycle([draws["posterior"], draws["noise"], draws["bbox"]])
        uniforms = itertools.cycle([draws["dropout"]])

        def take(cycle, original):
            nxt = [next(cycle)]

            def fn(key, shape=(), dtype=jnp.float32, *args, **kw):
                if tuple(shape) != nxt[0].shape:
                    return original(key, shape, dtype, *args, **kw)
                out, nxt[0] = nxt[0], next(cycle)
                return jnp.asarray(out, dtype)
            return fn

        monkeypatch.setattr(jax.random, "normal", take(normals, jax.random.normal))
        monkeypatch.setattr(jax.random, "uniform", take(uniforms, jax.random.uniform))


D_WEIGHT_RTOL = 1e-3


@pytest.fixture(autouse=True, scope="module")
def no_tensorboard():
    """The loggers without TensorBoard: its import pulls TensorFlow where
    that is installed (~15 s)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "torch.utils.tensorboard", None)
        yield


@contextlib.contextmanager
def _threads(n=2):
    old = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(old)


def _check_logged(got: dict, want: dict):
    """``_check_metrics``, with d_weight at its own tolerance."""
    _check_metrics(got, want, keys=[k for k in want if k != "train/d_weight"])
    np.testing.assert_allclose(float(got["train/d_weight"]), float(want["train/d_weight"]),
                               rtol=D_WEIGHT_RTOL, atol=1e-6, err_msg="train/d_weight")


def _torch_draws(draws, separate=False):
    out = {k: torch.from_numpy(v) for k, v in draws.items()}
    if separate:
        out["disc"] = dict(out)
    return out


@pytest.fixture(scope="module")
def models():
    jm = jax_instantiate(jax_merge([TINY])["model"])
    pm = instantiate_from_config(merge_configs([TINY])["model"])
    pm.learning_rate = LR
    # the weights create_train_state(pm, seed=SEED) makes
    g = torch.Generator().manual_seed(SEED)
    net_sd = flax_like_net(pm, g, "cpu").state_dict()
    loss_sd = pm.init_loss(g, device="cpu").state_dict()
    sd = {k: v.numpy() for k, v in net_sd.items()}
    sd.update({f"loss.{k}": v.numpy() for k, v in loss_sd.items()})
    net_params, loss_params = convert_pose_autoencoder(sd, jm.ddconfig)
    loss_params = dict(loss_params, perceptual=_lpips_tree(loss_sd))
    return dict(jm=jm, pm=pm, net_sd=net_sd, loss_sd=loss_sd, net_params=net_params,
                loss_params=loss_params)


def _jax_state(models, opt_ae, opt_disc, step=0):
    net, lp = models["net_params"], models["loss_params"]
    return JaxTrainState(
        step=jnp.asarray(step, jnp.int32), net_params=net, loss_params=lp,
        opt_ae_state=opt_ae.init(net), opt_disc_state=opt_disc.init(lp["discriminator"]),
        rng=jax.random.PRNGKey(0),
    )


def _port_state(models, step=0, accumulate=1):
    pm = models["pm"]
    net, loss = pm.build_net(), pm.build_loss()
    net.load_state_dict(models["net_sd"], strict=True)
    loss.load_state_dict(models["loss_sd"], strict=True)
    opt_ae, opt_disc = make_optimizers(net, loss, LR, grad_clip=1.0,
                                       accumulate_grad_batches=accumulate)
    return TrainState(step, net, loss, opt_ae, opt_disc)


def _host_batches(seed, n):
    """``n`` tiny synthetic batches, as the datamodule collates them."""
    from generative_detection_tpu_torch.data.datamodule import collate
    from generative_detection_tpu_torch.data.synthetic import SyntheticPatchTrain

    ds = SyntheticPatchTrain(length=BS * n, patch_height=32, seed=seed)
    return [collate([ds[i] for i in range(b * BS, (b + 1) * BS)]) for b in range(n)]


def _check_state(state, jstate, moments=True, rel=1e-3):
    """The port's weights (and Adam moments) against the JAX state's."""
    net_sd = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jstate.net_params))
    scale = max(float(np.abs(v.numpy()).max()) for v in net_sd.values())
    for name, p in state.net.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), net_sd[name].numpy(), rtol=0,
                                   atol=rel * scale, err_msg=name)
    if not moments:
        return
    mu, nu = _adam_moments(jstate.opt_ae_state)
    _check_moments(state.opt_ae, dict(state.net.named_parameters()), state_dict_from_jax(mu),
                   state_dict_from_jax(nu), rel)
    mu, nu = _adam_moments(jstate.opt_disc_state)
    lp = jstate.loss_params
    _check_moments(state.opt_disc, dict(state.loss.discriminator.named_parameters()),
                   _disc_sd(lp, mu), _disc_sd(lp, nu), rel)


def test_accumulated_window_matches_jax_multisteps(models, monkeypatch):
    """A window of k = 2 micro-batches (two different batches) at optimizer
    step 2: each micro-step's metrics match JAX's ``MultiSteps`` step, the
    weights do not move inside the window, and after it weights and
    moments match. The curriculum sees the optimizer step: generator step
    4, where dropout_prob is still 1 (micro-batch counting would give 8 and
    10, where it is 0.55 and 0.7)."""
    jm, pm = models["jm"], models["pm"]
    batches = _host_batches(11, 2)
    opt_ae, opt_disc = jax_make_optimizers(LR, grad_clip=1.0, accumulate_grad_batches=2)
    jstate = _jax_state(models, opt_ae, opt_disc, step=4)
    jstep = jax.jit(jax_make_train_step(jm, opt_ae, opt_disc, phase="full",
                                        accumulate_grad_batches=2))
    state = _port_state(models, step=4, accumulate=2)
    pstep = make_train_step(pm, phase="full", accumulate_grad_batches=2)
    draws = _draws()
    before = [p.detach().clone() for p in state.net.parameters()]
    with monkeypatch.context() as mp, _threads():
        _CyclingDraws(mp, draws)
        for i, host in enumerate(batches):
            jstate, jmetrics = jstep(jstate, jm.prepare_batch(host))
            state, metrics = pstep(state, pm.prepare_batch(host, device="cpu"),
                                   draws=_torch_draws(draws))
            _check_logged(metrics, jmetrics)
            assert float(metrics["dropout_prob"]) == 1.0
            assert float(metrics["train/d_weight"]) > 0.0
            moved = any(not torch.equal(a, b) for a, b in zip(before, state.net.parameters()))
            assert moved == (i == 1), f"micro-step {i}: weights moved {moved}"
    assert state.step == 6 and state.opt_ae.mini_step == 0
    _check_state(state, jstate)


def test_accumulated_window_averages_its_gradients(models):
    """Port only, no clip (which would hide a gradient's scale, as Adam's
    update does): a k = 2 window over the same batch twice leaves the same
    Adam moments as one k = 1 step, so the window averages (sum / k) its
    micro-batches' gradients."""
    pm = models["pm"]
    (host,) = _host_batches(13, 1)
    batch = pm.prepare_batch(host, device="cpu")
    draws = _torch_draws(_draws(seed=3))
    moments = []
    for k in (1, 2):
        state = _port_state(models, step=4 * k, accumulate=k)
        for opt in (state.opt_ae, state.opt_disc):
            opt.grad_clip = None
        step = make_train_step(pm, phase="full", accumulate_grad_batches=k)
        with _threads():
            for _ in range(k):
                state, _ = step(state, batch, draws=draws)
        moments.append([torch.cat([opt.moments(p)[i].flatten() for p in opt.params])
                        for opt in (state.opt_ae, state.opt_disc) for i in (0, 1)])
    for got, want in zip(*reversed(moments)):
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * float(want.abs().max()))


def test_separate_disc_forward_matches_jax(models, monkeypatch):
    jm, pm = models["jm"], models["pm"]
    (host,) = _host_batches(12, 1)
    opt_ae, opt_disc = jax_make_optimizers(LR, grad_clip=1.0)
    draws = _draws(seed=1)
    with monkeypatch.context() as mp:
        _CyclingDraws(mp, draws)
        jstep = jax_make_train_step(jm, opt_ae, opt_disc, phase="full", disc_forward="separate")
        jstate, jmetrics = jax.jit(jstep)(_jax_state(models, opt_ae, opt_disc, step=6),
                                          jm.prepare_batch(host))
    state = _port_state(models, step=6)
    pstep = make_train_step(pm, phase="full", disc_forward="separate")
    with _threads():
        state, metrics = pstep(state, pm.prepare_batch(host, device="cpu"),
                               draws=_torch_draws(draws, separate=True))
    assert set(metrics) == set(jmetrics)
    _check_logged(metrics, jmetrics)
    assert float(metrics["train/logits_fake"]) != 0.0
    _check_state(state, jstate)


# -- the slice as a whole: the port's Trainer.fit against JAX's steps --------------


class _Probe(Callback):
    """Records the state's step and first weight at fit start."""

    def on_fit_start(self, trainer):
        self.step = trainer.state.step
        self.weight = next(iter(trainer.state.net.state_dict().values())).clone()


def _patched_forward(monkeypatch, draws):
    """The port's net forward with the tests' draws at the train batch size."""
    forward = PoseAutoencoderNet.forward

    def fwd(self, x, *args, **kw):
        if x.shape[0] == BS and not kw.get("draws"):
            kw["draws"] = _torch_draws(draws)
        return forward(self, x, *args, **kw)

    monkeypatch.setattr(PoseAutoencoderNet, "forward", fwd)


def _port_dm(**params):
    cfg = merge_configs([TINY])["data"]
    cfg["params"].update(params)
    return instantiate_from_config(cfg)


def _rows(logdir):
    with open(os.path.join(logdir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def fit(models, tmp_path_factory):
    """One fit of the port's Trainer over three steps of ``tiny_cpu.yaml``
    (two epochs of two batches; validation of one batch after each epoch,
    thread loaders, the every-step checkpoint stream, image logging)."""
    with deleted_after(tmp_path_factory.mktemp("fit")) as root:
        logdir = str(root)
        draws = _draws(seed=2)
        with pytest.MonkeyPatch.context() as mp, _threads():
            _patched_forward(mp, draws)
            trainer = Trainer(
                models["pm"], logdir=logdir, max_epochs=2, max_steps=FIT_STEPS,
                limit_val_batches=1, log_every_n_steps=1, seed=SEED, device="cpu",
                logger=MetricsLogger(logdir),
                callbacks=[CheckpointCallback(every_n_train_steps=1),
                           ImageLogger(batch_frequency=2, max_images=2)],
            )
            trainer.fit(_port_dm(num_workers=2))
        trainer.logger.close()
        yield dict(trainer=trainer, logdir=logdir, draws=draws,
                   threads=[t.name for t in threading.enumerate()
                            if t.name.startswith(THREAD_NAME)])


def test_trainer_fit_matches_jax_steps(models, fit, monkeypatch, tmp_path):
    """The JAX side: the same weights, the JAX datamodule's batches, the
    phase a JAX ``Trainer``'s ``_phase_for`` picks, and the same draws. The
    logged losses of every step and the final weights are compared. The
    moments are not: at ch 32 some gradients are zero analytically (the
    conv biases before one-channel GroupNorm groups, the attention key
    biases), and Adam turns their fp32 rounding into updates of up to
    ~lr; over three steps that moves the decoder's biases by 1.1e-4 and the
    discriminator's first moment by 1.1e-4 (2e-3 of its largest) from a
    float64 run of the port, while the JAX package's fp32 stays within 1e-7
    of it there."""
    jm = models["jm"]
    jtrainer = JaxTrainer(jm, logdir=str(tmp_path))
    opt_ae, opt_disc = jax_make_optimizers(LR, grad_clip=1.0)
    jstate = _jax_state(models, opt_ae, opt_disc)
    dm = jax_instantiate(jax_merge([TINY])["data"])
    dm.setup()
    steps = {}
    want = []
    with monkeypatch.context() as mp:
        _CyclingDraws(mp, fit["draws"])
        for _ in range(2):
            for host in dm.train_dataloader():
                if len(want) == FIT_STEPS:
                    break
                phase = jtrainer._phase_for(int(jstate.step))
                if phase not in steps:
                    steps[phase] = jax.jit(jax_make_train_step(jm, opt_ae, opt_disc, phase=phase))
                jstate, metrics = steps[phase](jstate, jm.prepare_batch(host))
                want.append(metrics)
    assert set(steps) == {"pretrain", "full"}
    rows = [r for r in _rows(fit["logdir"]) if "aeloss" in r]
    assert [r["step"] for r in rows] == list(range(1, FIT_STEPS + 1))
    for row, metrics in zip(rows, want):
        assert set(metrics) <= set(row)
        _check_logged(row, metrics)
    state = fit["trainer"].state
    assert state.step == FIT_STEPS
    _check_state(state, jstate, moments=False)


# -- the Trainer's own semantics, on the port alone --------------------------------


def test_fit_writes_the_checkpoint_layout_and_stops_its_threads(fit):
    ckpt = Path(fit["logdir"], "checkpoints")
    assert sorted(os.listdir(ckpt / "last")) == [str(FIT_STEPS)]
    assert sorted(int(s) for s in os.listdir(ckpt / "trainstep_checkpoints")) == [1, 2, 3]
    best = sorted(int(s) for s in os.listdir(ckpt / "best"))
    assert best and set(best) <= {2, 3}
    for d in (ckpt / "last" / str(FIT_STEPS), ckpt / "best" / str(best[0])):
        assert {"net.pt", "loss.pt", "optim.pt", "meta.json"} <= set(os.listdir(d))
    assert json.loads((ckpt / "best" / str(best[0]) / "metrics.json").read_text())["val/rec_loss"]
    images = sorted(os.listdir(Path(fit["logdir"], "images", "train")))
    assert images and all(n.endswith(".png") for n in images)
    val_rows = [r for r in _rows(fit["logdir"]) if "val/rec_loss" in r]
    assert [r["step"] for r in val_rows] == [2, 3]
    assert fit["threads"] == [], "loader threads outlived fit"
    t = fit["trainer"].timings
    assert len(t["step_s"]) == FIT_STEPS and t["validation_s"] > 0 and t["checkpoint_s"] > 0


def test_resume_continues_the_step_counter(models, fit, tmp_path, monkeypatch):
    _patched_forward(monkeypatch, fit["draws"])
    probe = _Probe()
    trainer = Trainer(
        models["pm"], logdir=str(tmp_path), max_epochs=2, max_steps=FIT_STEPS + 1,
        limit_val_batches=0, log_every_n_steps=1, seed=SEED, device="cpu",
        logger=MetricsLogger(str(tmp_path)), callbacks=[probe],
        resume_from_checkpoint=os.path.join(fit["logdir"], "checkpoints"),
    )
    trainer.fit(_port_dm())
    trainer.logger.close()
    saved = fit["trainer"].state.net.state_dict()
    assert probe.step == FIT_STEPS
    assert torch.equal(probe.weight, next(iter(saved.values())))
    assert trainer.state.step == FIT_STEPS + 1
    assert [r["step"] for r in _rows(str(tmp_path)) if "aeloss" in r] == [FIT_STEPS + 1]


def test_every_n_stream_counts_optimizer_steps(models, tmp_path, monkeypatch):
    _patched_forward(monkeypatch, _draws())
    trainer = Trainer(
        models["pm"], logdir=str(tmp_path), max_epochs=2, max_steps=4,
        accumulate_grad_batches=2, limit_val_batches=0, log_every_n_steps=1, seed=SEED,
        device="cpu", callbacks=[CheckpointCallback(every_n_train_steps=1)],
    )
    trainer.fit(_port_dm())
    assert trainer.state.step == 4
    stream = Path(tmp_path, "checkpoints", "trainstep_checkpoints")
    assert sorted(int(s) for s in os.listdir(stream)) == [1, 2]
    # the curriculum clock: micro-batches 2 and 3 are optimizer step 1, 'full'
    assert [trainer._phase_for(s) for s in range(4)] == ["pretrain", "pretrain", "full", "full"]


def test_test_and_predict_loops(fit, monkeypatch):
    """``test`` logs ``test/*`` means over ``limit_test_batches`` and leaves
    the best checkpoints alone; ``predict`` returns the posterior-mode
    forward of each batch, the same on a second call."""
    trainer = fit["trainer"]
    split = {"target": "generative_detection_tpu.data.synthetic.SyntheticPatchValidation",
             "params": {"length": 8, "patch_height": 32}}
    dm = _port_dm(test=split, predict=split)
    dm.setup()
    best = os.listdir(Path(fit["logdir"], "checkpoints", "best"))
    monkeypatch.setattr(trainer, "limit_test_batches", 1)
    monkeypatch.setattr(trainer, "logger", None)  # the fixture's is closed
    means = trainer.test(dm)
    assert means and all(k.startswith("test/") for k in means)
    assert all(np.isfinite(v) for v in means.values())
    assert os.listdir(Path(fit["logdir"], "checkpoints", "best")) == best
    out = trainer.predict(dm, limit_batches=1)
    again = trainer.predict(dm, limit_batches=1)
    assert len(out) == 1 and out[0]["dec_obj"].shape == (BS, 32, 32, 3)
    assert out[0]["dec_pose"].shape == (BS, 19)
    assert all(np.array_equal(out[0][k], again[0][k]) for k in out[0])
    dm.teardown()


def test_restore_params_restores_the_net_alone(fit):
    mgr = CheckpointManager(os.path.join(fit["logdir"], "checkpoints"))
    out = mgr.restore_params()
    assert set(out) == {"step", "net"} and out["step"] == FIT_STEPS
    live = fit["trainer"].state.net.state_dict()
    assert out["net"].keys() == live.keys()
    assert all(torch.equal(out["net"][k], v) for k, v in live.items())
    assert set(mgr.restore_params(loss=True)) == {"step", "net", "loss"}


def test_async_save_round_trips_and_a_signal_drains_it(models, fit, tmp_path):
    state = fit["trainer"].state
    mgr = CheckpointManager(str(tmp_path), async_checkpointing=True)
    w = next(state.net.parameters())
    want = w.detach().clone()
    mgr.save_last(5, state)
    with torch.no_grad():
        w.add_(1.0)  # the next step changes the state at once: the save holds a copy
    handlers = save_on_signal(lambda: (mgr.save_last(6, state), mgr.wait_until_finished()))
    try:
        os.kill(os.getpid(), signal.SIGUSR1)
        assert sorted(os.listdir(tmp_path / "last")) == ["6"]
    finally:
        restore_signals(handlers)
        with torch.no_grad():
            w.copy_(want)
    other = _port_state(models)
    other.generator = None
    mgr.restore(other, step=None)
    assert other.step == 6
    assert torch.equal(next(other.net.parameters()), want + 1.0)
    mgr2 = CheckpointManager(str(tmp_path / "b"), async_checkpointing=True)
    mgr2.save_last(5, state)
    mgr2.wait_until_finished()
    mgr2.restore(other)
    assert other.step == 5 and torch.equal(next(other.net.parameters()), want)
    for m in (mgr, mgr2):
        m.close()


def test_make_logger_selects_its_backend(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "wandb", None)  # the fallback, whatever is installed
    default = make_logger(None, str(tmp_path / "a"))
    assert type(default) is MetricsLogger and default.path.endswith("metrics.jsonl")
    tt = make_logger({"logger": {"target": "pytorch_lightning.loggers.TestTubeLogger"}},
                     str(tmp_path / "b"))
    assert type(tt) is MetricsLogger
    wb = make_logger({"logger": {"target": "pytorch_lightning.loggers.WandbLogger",
                                 "params": {"offline": True}}},
                     str(tmp_path / "c"), nowname="run1")
    assert isinstance(wb, WandbLogger)
    wb.log_metrics({"train/aeloss": torch.tensor(2.5)}, 3)
    for lg in (default, tt, wb):
        lg.close()
    hist = tmp_path / "c" / "wandb" / "run-run1" / "files" / "wandb-history.jsonl"
    row = json.loads(hist.read_text())
    assert row["_step"] == 3 and row["train/aeloss"] == 2.5


def test_trainer_refuses_what_it_does_not_run(models, monkeypatch):
    pm = models["pm"]
    for limit in ("limit_val_batches", "limit_test_batches"):
        with pytest.raises(ValueError, match="fractional"):
            Trainer(pm, device="cpu", **{limit: 0.5})
    # two cards need a process group of two ranks; FSDP is not ported
    with pytest.raises(RuntimeError, match="no process group"):
        Trainer(pm, device="cpu", devices=2)
    with pytest.raises(NotImplementedError, match="A9"):
        Trainer(pm, device="cpu", fsdp_parameter_sharding=True)
    # ZeRO-1 in one process shards nothing, and runs
    assert Trainer(pm, device="cpu", devices=1, zero1_optimizer_sharding=True).world.size == 1
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(pm)


def test_cli_trains_without_jax(tmp_path):
    """``train_cli -b tiny_cpu.yaml -t --device cpu --max_steps 2`` while jax,
    flax, optax, orbax and the JAX package cannot be imported (in this
    process, ``jax_unimportable``; TensorBoard is blocked by the module's
    ``no_tensorboard``)."""
    from generative_detection_tpu_torch import train_cli

    args = ["-b", TINY, "-t", "--device", "cpu", "--max_steps", "2", "-l", str(tmp_path),
            "-n", "cli", "--logging_level", "WARNING"]
    with jax_unimportable():
        train_cli.main(args)
    (run,) = list(tmp_path.iterdir())
    assert run.name.endswith("_cli")
    rows = [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in rows if "aeloss" in r] == [1, 2]
    assert all(np.isfinite(r["aeloss"]) for r in rows if "aeloss" in r)
    assert os.listdir(run / "checkpoints" / "last") == ["2"]
    assert len(list((run / "configs").glob("*.yaml"))) == 2
