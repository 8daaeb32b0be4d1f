"""Data parallelism of the port on the CPU: ``torch.distributed`` over gloo in
two processes against the JAX package's global-batch step, against one
process of the port at the global batch, ZeRO-1 against the unsharded
optimizer, a 2-rank ``train_cli`` fit, checkpoints across world sizes, and
``shard_detector``.

Processes. Two spawns of two ranks each, started together by the module's
fixture: the ``train_cli`` fit at ``lightning.trainer.devices: 2`` (which
spawns its ranks itself) and ``tests/torch_parallel_worker.py``, which runs
every other 2-rank case; this process takes the JAX steps meanwhile. Ports
come from the OS's ephemeral range (32768 and up here), so never the JAX
package's multihost tests' fixed 12923 and 12961. Each spawn
has a timeout: a hang kills its ranks and fails the test. The fixture deletes
everything it wrote (checkpoints of the tiny model are ~165 MB each).

The global batch: four ``tiny_cpu.yaml`` synthetic patches with a box; rank 1
holds the last two, relabelled background (``class_id`` 1, the foreground
mask's class; name id 10), so every masked mean of rank 1 has an empty
denominator. A local-denominator ``_masked_mean``, a per-rank batch norm in
the discriminator or a per-rank d_weight each moves the step by far more
than the tolerances below. Both sides rescale the patches per half (the JAX
package's ``rescale_minmax`` over a data axis of two; each rank's own batch in
the port), and take the draws of ``create_train_state``'s generator at the
global batch (the ranks their slices of it; the JAX step receives them as
arguments in place of ``jax.random.normal``/``uniform``).

Tolerances:
- against the JAX package (fp32, the port on two threads a rank): those of
  ``tests/test_torch_port_trainer.py``: metrics 1e-4 relative, d_weight
  1e-3, the weights after the step 1e-3 of each tree's largest magnitude;
- against one process of the port at the global batch: metrics, d_weight and
  the gradients each optimizer steps on (averaged over the ranks, clipped)
  within 1e-6 relative (the gradients: of each optimizer's largest), the
  weights after the step as against the JAX package. Both
  run in float64: in float32 the summation order alone (two samples a rank,
  then a sum of two, against four) moves the pose step's gradients by
  1.4e-6 of the largest. float64 leaves the float32 islands of the step (the
  discriminator's logits, the ``conv_out`` gradients of d_weight, the
  metrics), which keep the two within 2e-7;
- ZeRO-1 against the unsharded optimizer after two steps: the weights bit
  for bit (Adam is elementwise), the consolidated moments' sums within
  1e-12 relative.
"""

import contextlib
import importlib
import json
import os
import shutil
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
from generative_detection_tpu.train import make_plain_train_step as jax_make_plain_train_step
from generative_detection_tpu.train import make_train_step as jax_make_train_step
from generative_detection_tpu.utils.torch_compat import (
    convert_plain_autoencoder,
    convert_pose_autoencoder,
)
from generative_detection_tpu_torch import train_cli
from generative_detection_tpu_torch.config import instantiate_from_config
from generative_detection_tpu_torch.data.datamodule import collate
from generative_detection_tpu_torch.data.synthetic import SyntheticPatchTrain
from generative_detection_tpu_torch.parallel import mesh, multihost
from generative_detection_tpu_torch.serving import export_detector, load_detector, shard_detector
from generative_detection_tpu_torch.train import CheckpointManager, Trainer
from generative_detection_tpu_torch.utils.jax_compat import (
    loss_state_dict_from_jax,
    state_dict_from_jax,
)
from tests import torch_parallel_worker as worker
from tests._torch_cpu import jax_unimportable, one_torch_thread  # noqa: F401 (autouse)
from tests.test_torch_port_detector import HMAX, HMIN, _camera_args
from tests.test_torch_port_train import _check_metrics, _lpips_tree

GLOBAL_BATCH = 4
SPAWN_TIMEOUT = 240.0  # seconds for each 2-rank spawn (~20 s here)
METRIC_RTOL, D_WEIGHT_RTOL, WEIGHT_REL = 1e-4, 1e-3, 1e-3
WORLD_RTOL = 1e-6


def _host_batch() -> dict:
    """The global batch: rank 0's two patches foreground, rank 1's two
    background."""
    ds = SyntheticPatchTrain(length=32, patch_height=32, seed=11)
    items = [it for it in (ds[i] for i in range(len(ds)))
             if np.asarray(it["mask_2d_bbox"]).sum() > 0][:GLOBAL_BATCH]
    host = collate(items)
    host["class_id"] = np.asarray(host["class_id"], np.int32).copy()
    host["original_class_id"] = np.asarray(host["original_class_id"], np.int32).copy()
    host["class_id"][2:] = 1
    host["original_class_id"][2:] = 10
    assert (host["class_id"][:2] != 1).all()
    return host


def _plain_batch() -> dict:
    x = np.random.default_rng(4).uniform(-1, 1, size=(GLOBAL_BATCH, 32, 32, 3))
    return {"image": x.astype(np.float32)}


def _rmtree(path):
    shutil.rmtree(path, ignore_errors=True)


class _Background(threading.Thread):
    """``fn(*args)`` on a thread; ``result()`` joins it and re-raises."""

    def __init__(self, fn, *args):
        super().__init__(daemon=True)
        self.fn, self.args, self.error = fn, args, None
        self.start()

    def run(self):
        try:
            self.fn(*self.args)
        except BaseException as e:  # noqa: BLE001 -- raised in result()
            self.error = e

    def result(self):
        self.join()
        if self.error is not None:
            raise self.error


def _cli_fit(root: Path) -> None:
    """``train_cli -b tiny_cpu.yaml -t`` at ``lightning.trainer.devices: 2``
    (batch 4 a rank, ZeRO-1, 4 steps over two epochs, validation after each,
    so once mid-fit, no monitor: the last checkpoint only), every rank probed
    by ``RankProbe``."""
    (root / "probe").mkdir(parents=True)
    args = ["-b", worker.TINY, "-t", "--device", "cpu", "-l", str(root / "logs"), "-n", "cli",
            "--logging_level", "WARNING", "data.params.batch_size=4",
            "lightning.trainer.devices=2", "lightning.trainer.zero1_optimizer_sharding=true",
            "model.params.monitor=null",
            "lightning.callbacks.probe.target=tests.torch_parallel_worker.RankProbe",
            f"lightning.callbacks.probe.params.out={root / 'probe'}"]
    assert train_cli.main(args) is None  # this process spawned the ranks


@pytest.fixture(scope="module")
def world2(request, tmp_path_factory):
    """The module's two spawns of two ranks, started together: the
    ``train_cli`` fit and the worker. Meanwhile this process builds the
    models and takes the JAX steps, and a thread of it, once the fit has
    ended, restores the fit's ZeRO-1 checkpoint in one process and saves it
    again, which the worker's ranks then resume."""
    root = tmp_path_factory.mktemp("parallel")
    inputs, w1dir = root / "inputs.pt", root / "w1"
    torch.save({"pose": _host_batch(), "plain": _plain_batch(), "resume_from": str(w1dir)},
               inputs)
    env = {"GDT_SPAWN_TIMEOUT": str(SPAWN_TIMEOUT),
           "OMP_NUM_THREADS": str(worker.THREADS)}  # the ranks' intra-op threads
    threads, w1 = [], {}

    def one_process(pose):
        """Once the fit has ended: its checkpoint restored and saved again by
        this process, for the worker's ranks to resume."""
        threads[0].result()
        (run,) = list((root / "cli" / "logs").iterdir())
        restored = worker.state_from(pose["pm"], pose["init"], "pose")
        CheckpointManager(str(run / "checkpoints")).restore(restored)
        CheckpointManager(str(w1dir)).save_last(restored.step, restored)
        (w1dir / "READY").touch()
        w1.update(run=run, step=restored.step, digest=worker.digest(restored.net.parameters()),
                  moments={n: getattr(restored, n).held_moments() for n in ("opt_ae", "opt_disc")})

    try:
        with pytest.MonkeyPatch.context() as mp:  # until the ranks are spawned
            for k, v in env.items():
                mp.setenv(k, v)
            threads.append(_Background(_cli_fit, root / "cli"))
            threads.append(_Background(multihost.spawn_ranks,
                                       [worker.__file__, str(inputs), str(root)], 2,
                                       SPAWN_TIMEOUT))
            threads.append(_Background(one_process, request.getfixturevalue("models")["pose"]))
            request.getfixturevalue("jax_steps")
            for t in threads:
                t.result()
        run = w1.pop("run")
        yield dict(
            run=run, w1=w1,
            cli_probes=[json.loads((root / "cli" / "probe" / f"probe_rank{r}.json").read_text())
                        for r in range(2)],
            res=[torch.load(root / f"rank{r}.pt", weights_only=False) for r in range(2)],
            probes=[json.loads((root / f"probe_rank{r}.json").read_text()) for r in range(2)])
    finally:
        for t in threads:
            t.join()
        _rmtree(root)


@pytest.fixture(scope="module")
def models():
    """Both families' port models, seeded weights and the JAX package's
    models on the same weights."""
    out = {}
    for family, path, convert in (("pose", worker.TINY, convert_pose_autoencoder),
                                  ("plain", worker.PLAIN, convert_plain_autoencoder)):
        pm = worker.model(family)
        net_sd, loss_sd = worker.init_weights(pm)
        sd = {k: v.numpy() for k, v in net_sd.items()}
        sd.update({f"loss.{k}": v.numpy() for k, v in loss_sd.items()})
        jm = jax_instantiate(jax_merge([path])["model"])
        net_params, loss_params = convert(sd, jm.ddconfig)
        loss_params = dict(loss_params, perceptual=_lpips_tree(loss_sd))
        out[family] = dict(pm=pm, init=(net_sd, loss_sd), jm=jm, net_params=net_params,
                           loss_params=loss_params)
    return out


# -- the JAX package's global-batch step -------------------------------------------


def _generator_draws(family):
    """What ``create_train_state``'s generator draws for one forward at the
    global batch, in the forward's order, as the JAX step's normals and
    uniforms."""
    g = torch.Generator().manual_seed(worker.SEED + 1)
    z = (GLOBAL_BATCH, 16, 16, 16)
    if family == "plain":
        return [torch.randn(z, generator=g).numpy()], []
    posterior = torch.randn(z, generator=g)
    dropout = torch.rand(z, generator=g)
    noise = torch.randn(z, generator=g)
    bbox = torch.randn((GLOBAL_BATCH, 8), generator=g)
    return [posterior.numpy(), noise.numpy(), bbox.numpy()], [dropout.numpy()]


@contextlib.contextmanager
def _jax_draws(normals, uniforms):
    """While a JAX step traces: ``jax.random.normal``/``uniform`` return the
    next of ``normals``/``uniforms`` whose shape is asked for."""
    normals, uniforms = list(normals), list(uniforms)

    def take(queue, original):
        def fn(key, shape=(), dtype=jnp.float32, *a, **kw):
            if queue and tuple(shape) == tuple(queue[0].shape):
                return queue.pop(0).astype(dtype)
            return original(key, shape, dtype, *a, **kw)
        return fn

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "normal", take(normals, jax.random.normal))
        mp.setattr(jax.random, "uniform", take(uniforms, jax.random.uniform))
        yield


@pytest.fixture(scope="module")
def jax_steps(models):
    """One JAX train step of each family at the global batch on one device,
    the draws passed in (one compile each)."""
    out = {}
    for family in ("pose", "plain"):
        m = models[family]
        jm = m["jm"]
        opt_ae, opt_disc = jax_make_optimizers(worker.LR, grad_clip=1.0)
        state = JaxTrainState(
            step=jnp.asarray(worker.STEP[family], jnp.int32), net_params=m["net_params"],
            loss_params=m["loss_params"], opt_ae_state=opt_ae.init(m["net_params"]),
            opt_disc_state=opt_disc.init(m["loss_params"]["discriminator"]),
            rng=jax.random.PRNGKey(0))
        step = (jax_make_train_step(jm, opt_ae, opt_disc, phase="full") if family == "pose"
                else jax_make_plain_train_step(jm, opt_ae, opt_disc))

        def run(s, batch, normals, uniforms, _step=step):
            with _jax_draws(normals, uniforms):
                return _step(s, batch)

        host = _host_batch() if family == "pose" else _plain_batch()
        batch = jm.prepare_batch(host, num_shards=2) if family == "pose" else {
            "image": jnp.asarray(host["image"])}
        normals, uniforms = _generator_draws(family)
        state, metrics = jax.jit(run)(state, batch, normals, uniforms)
        np_state = jax.tree_util.tree_map(np.asarray, state)
        want = dict(state_dict_from_jax(np_state.net_params))
        want.update({k: v for k, v in loss_state_dict_from_jax(np_state.loss_params).items()
                     if k.startswith("discriminator.")})
        out[family] = (jax.tree_util.tree_map(np.asarray, metrics), want)
    return out


@pytest.mark.parametrize("family", ["pose", "plain"])
def test_two_ranks_take_the_jax_global_batch_step(world2, jax_steps, family):
    """Metrics (d_weight among them) and the weights after one step of the
    port at world 2, per-rank batch 2, against the JAX package's step at the
    global batch 4 on one device; both ranks bit-equal."""
    res = world2["res"]
    want_metrics, want_weights = jax_steps[family]
    got = res[0][family]
    assert got["metrics"] == res[1][family]["metrics"]
    assert got["digest"] == res[1][family]["digest"]
    assert got["metrics"]["train/d_weight"] > 0.0
    if family == "pose":
        # rank 1's masked means divide by rank 0's count
        assert got["metrics"]["train/nll_loss"] > 0 and got["metrics"]["train/pose_loss"] > 0
    assert set(want_metrics) <= set(got["metrics"])
    _check_metrics(got["metrics"], want_metrics,
                   keys=[k for k in want_metrics if k != "train/d_weight"])
    np.testing.assert_allclose(got["metrics"]["train/d_weight"],
                               float(want_metrics["train/d_weight"]), rtol=D_WEIGHT_RTOL)
    weights = got["weights"]
    assert set(weights) == set(want_weights)
    for prefix in ("discriminator.", ""):
        names = [k for k in weights if k.startswith(prefix) and
                 (prefix or not k.startswith("discriminator."))]
        scale = max(float(want_weights[k].abs().max()) for k in names)
        for k in names:
            np.testing.assert_allclose(weights[k].numpy(), want_weights[k].numpy(), rtol=0,
                                       atol=WEIGHT_REL * scale, err_msg=k)


@pytest.mark.parametrize("family", ["pose", "plain"])
def test_two_ranks_equal_one_process_at_the_global_batch(models, world2, family):
    """float64: the port at world 2 against the port in one process at the
    global batch (the same draws, the batch rescaled per half): metrics,
    d_weight and both optimizers' gradients within 1e-6 relative; the
    weights after Adam within 1e-3 of each tree's largest (Adam's first
    update turns rounding-level gradient elements into +-lr moves)."""
    m = models[family]
    state = worker.state_from(m["pm"], m["init"], family, torch.float64)
    grads = worker.record_grads(state)
    step = worker.step_fn(m["pm"], family)
    with worker_threads():
        _, metrics = step(state, worker.local_batch(m["pm"], family, (
            _host_batch() if family == "pose" else _plain_batch()), torch.float64))
    want = worker.floats(metrics)
    res = world2["res"]
    got = res[0][family + "64"]
    assert got["metrics"] == res[1][family + "64"]["metrics"]
    assert got["digest"] == res[1][family + "64"]["digest"]
    assert set(got["metrics"]) == set(want) and want["train/d_weight"] > 0
    for k, v in want.items():
        assert abs(got["metrics"][k] - v) <= WORLD_RTOL * abs(v), (k, got["metrics"][k], v)
    for name in ("opt_ae", "opt_disc"):
        g, w = got["grads"][name], grads[name]
        err, scale = float((g - w).abs().max()), float(w.abs().max())
        assert scale > 0 and err <= WORLD_RTOL * scale, (name, err, scale)
    # after Adam's first update, as tests/test_torch_port_trainer.py holds weights
    want_w = worker.weights(state)
    for prefix in ("discriminator.", ""):
        names = [k for k in want_w if k.startswith(prefix)
                 and (prefix or not k.startswith("discriminator."))]
        scale = max(float(want_w[k].abs().max()) for k in names)
        for k in names:
            np.testing.assert_allclose(got["weights"][k].numpy(), want_w[k].float().numpy(),
                                       rtol=0, atol=WEIGHT_REL * scale, err_msg=k)


@contextlib.contextmanager
def worker_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(worker.THREADS)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def test_ranks_shard_and_gather_the_global_batch(world2):
    """``shard_batch`` then ``global_batch_from_local`` on both ranks: the
    global batch in rank order."""
    want = _host_batch()["class_id"].tolist()
    assert [r["gathered"] for r in world2["res"]] == [want, want]


def test_zero1_equals_the_unsharded_optimizer(world2):
    """Two steps with ZeRO-1 off and on: the same weights bit for bit on both
    ranks, the consolidated moments of both optimizers equal, and each rank
    holding about half of each optimizer's moment elements."""
    res = world2["res"]
    off, on = res[0]["zero1"][False], res[0]["zero1"][True]
    assert on["digest"] == off["digest"] == res[1]["zero1"][True]["digest"]
    for name in ("opt_ae", "opt_disc"):
        got, want = np.asarray(on["moments"][name]), np.asarray(off["moments"][name])
        assert got.shape == want.shape and len(want) == len(res[0]["zero1"][False]["moments"][name])
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
        assert off["held"][name] == off["total"][name]
        held = [r["zero1"][True]["held"][name] for r in res]
        assert sum(held) == on["total"][name]
        assert all(abs(h - on["total"][name] / 2) <= 0.1 * on["total"][name] for h in held), held


def test_cli_fits_on_two_ranks(world2):
    """The ranks ``train_cli`` spawned: the same world, the same logged
    losses on both, no JAX module in either, one ``metrics.jsonl`` row a
    step (rank 0 alone writes it), a mid-fit validation, and the step-4
    checkpoint."""
    p0, p1 = world2["cli_probes"]
    assert (p0["rank"], p1["rank"], p0["world"], p1["world"]) == (0, 1, 2, 2)
    assert [s for s, _ in p0["aeloss"]] == [1, 2, 3, 4]
    assert p0["aeloss"] == p1["aeloss"] and all(np.isfinite(v) for _, v in p0["aeloss"])
    assert p0["jax_modules"] == p1["jax_modules"] == []
    assert p0["digest"] == p1["digest"]
    run = world2["run"]
    rows = [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]
    losses = [(r["step"], r["aeloss"]) for r in rows if "aeloss" in r]
    assert losses == [(s, pytest.approx(v, rel=1e-6)) for s, v in p0["aeloss"]]
    assert [r["step"] for r in rows if "val/rec_loss" in r] == [2, 4]
    assert os.listdir(run / "checkpoints" / "last") == ["4"]
    assert len(list((run / "configs").glob("*.yaml"))) == 2


def test_zero1_checkpoints_move_between_world_sizes(world2):
    """The fit's world-2 ZeRO-1 checkpoint restores in one process with the
    ranks' step, weights and, shard by shard, the moments each rank held;
    that process's checkpoint then resumes a world-2 ZeRO-1 fit, each rank
    taking its shard back."""
    w1, fit = world2["w1"], world2["cli_probes"]
    assert w1["step"] == 4 and w1["digest"] == fit[0]["digest"]

    def held(probe_owned, name):
        (lo, hi), mu, nu = probe_owned[name]
        want = [float(m[lo:hi].double().sum()) for m in w1["moments"][name]]
        np.testing.assert_allclose([mu, nu], want, rtol=1e-12, atol=0, err_msg=name)
        return hi - lo

    for name in ("opt_ae", "opt_disc"):
        sizes = [held(p["owned"], name) for p in fit]
        assert sum(sizes) == w1["moments"][name][0].numel()
        assert fit[0]["owned"][name][0][1] == fit[1]["owned"][name][0][0]  # adjacent shards
    for p in world2["probes"]:
        assert p["start_step"] == 4 and p["start_digest"] == w1["digest"]
        assert p["step"] == 5 and p["jax_modules"] == []
        for name in ("opt_ae", "opt_disc"):
            held(p["start_owned"], name)
    assert world2["res"][0]["jax_modules"] == world2["res"][1]["jax_modules"] == []


# -- without processes ----------------------------------------------------------


@contextlib.contextmanager
def _fresh_parallel_modules():
    """Inside, ``generative_detection_tpu_torch.parallel`` imports anew (its
    modules out of ``sys.modules``); the imported ones are put back after."""
    import generative_detection_tpu_torch as pkg

    name = "generative_detection_tpu_torch.parallel"
    saved = {n: sys.modules.pop(n) for n in list(sys.modules)
             if n == name or n.startswith(name + ".")}
    try:
        yield
    finally:
        for n in [n for n in sys.modules if n == name or n.startswith(name + ".")]:
            del sys.modules[n]
        sys.modules.update(saved)
        pkg.parallel = saved[name]


def test_should_initialize_behavior_matrix(monkeypatch):
    """The JAX package's matrix (``tests/test_multihost.py``) on torch's
    launch environment, with the parallel modules imported while JAX cannot
    be: a coordinator address joins, a world size counts above one, an
    srun step above one task, an allocation's task count does not, and
    ``GDT_MULTIHOST`` overrides."""
    for var in ("GDT_MULTIHOST", "MASTER_ADDR", "WORLD_SIZE", "SLURM_STEP_NUM_TASKS",
                "SLURM_NTASKS"):
        monkeypatch.delenv(var, raising=False)
    with jax_unimportable(), _fresh_parallel_modules():
        mh = importlib.import_module("generative_detection_tpu_torch.parallel.multihost")
        assert mh.should_initialize() is False
        monkeypatch.setenv("WORLD_SIZE", "1")  # one process is not a world
        assert mh.should_initialize() is False
        monkeypatch.setenv("WORLD_SIZE", "2")
        assert mh.should_initialize() is True
        monkeypatch.setenv("GDT_MULTIHOST", "0")  # opt-out beats markers
        assert mh.should_initialize() is False
        monkeypatch.setenv("GDT_MULTIHOST", "1")
        assert mh.should_initialize() is True
        monkeypatch.delenv("GDT_MULTIHOST")
        monkeypatch.setenv("WORLD_SIZE", "1")
        monkeypatch.setenv("SLURM_STEP_NUM_TASKS", "4")  # an srun step
        assert mh.should_initialize() is True
        monkeypatch.setenv("SLURM_STEP_NUM_TASKS", "1")
        assert mh.should_initialize() is False
        monkeypatch.delenv("SLURM_STEP_NUM_TASKS")
        monkeypatch.setenv("SLURM_NTASKS", "4")  # an allocation: one process here
        assert mh.should_initialize() is False
        monkeypatch.setenv("MASTER_ADDR", "10.0.0.1")
        assert mh.should_initialize() is True
        assert mh.free_port() >= 1024 and not mh.world().active


def test_a_world_that_cannot_be_joined_raises(monkeypatch, models):
    """A world asked for and not named raises (no silent single process), and
    so does a Trainer asked for two cards outside a process group;
    ``fsdp_parameter_sharding`` is not ported and says where it is queued."""
    for var in ("RANK", "SLURM_PROCID", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("GDT_MULTIHOST", "1")
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="does not name it"):
        multihost.maybe_initialize()
    assert not mesh.world().active
    pm = models["pose"]["pm"]
    with pytest.raises(RuntimeError, match="no process group"):
        Trainer(pm, device="cpu", devices=2)
    with pytest.raises(NotImplementedError, match="A9"):
        Trainer(pm, device="cpu", fsdp_parameter_sharding=True)


def test_batch_shards_and_their_inverse():
    batch = {"a": np.arange(12).reshape(6, 2), "b": torch.arange(6)}
    parts = [mesh.shard_batch(batch, rank=r, size=3) for r in range(3)]
    assert [p["a"].shape for p in parts] == [(2, 2)] * 3
    np.testing.assert_array_equal(np.concatenate([p["a"] for p in parts]), batch["a"])
    assert torch.equal(torch.cat([p["b"] for p in parts]), batch["b"])
    assert mesh.local_batch_size(16, 2) == 8
    with pytest.raises(ValueError, match="not divisible"):
        mesh.local_batch_size(15, 2)
    # one process: every collective is the identity
    np.testing.assert_array_equal(multihost.global_batch_from_local({"a": batch["a"]})["a"],
                                  batch["a"])
    t = torch.ones(3)
    assert mesh.all_reduce_mean(t) is t and not mesh.any_rank(False)


class Items:
    """A map-style dataset of ``{"v": i}``."""

    def __init__(self, length):
        self.length = length

    def __len__(self):
        return self.length

    def __getitem__(self, i):
        return {"v": np.asarray(i)}


def _shards(monkeypatch, length, batch_size, world):
    """Each rank's train batches through the port's datamodule, the process
    group's (rank, size) patched in."""
    from generative_detection_tpu_torch.data import datamodule

    out = []
    for rank in range(world):
        monkeypatch.setattr(datamodule, "world", lambda r=rank: mesh.World(r, world, True))
        dm = instantiate_from_config({
            "target": "generative_detection_tpu_torch.data.datamodule.DataModuleFromConfig",
            "params": {"batch_size": batch_size, "num_workers": 0, "seed": 7, "train": {
                "target": "tests.test_torch_port_parallel.Items", "params": {"length": length}}},
        })
        dm.setup()
        out.append([[int(v) for v in b["v"]] for b in dm.train_dataloader()])
        dm.teardown()
    return out


def test_loader_shards_are_disjoint_and_complete(monkeypatch):
    """37 items over 3 ranks at batch 2: equal batch counts (a collective
    step on every rank), overlap only from the padding, full coverage up to
    the dropped tail (``tests/test_multihost.py``'s case)."""
    shards = _shards(monkeypatch, 37, 2, 3)
    assert [len(s) for s in shards] == [6, 6, 6]
    seen = [{v for b in s for v in b} for s in shards]
    overlap = (seen[0] & seen[1]) | (seen[0] & seen[2]) | (seen[1] & seen[2])
    assert len(overlap) <= 2
    assert len(seen[0] | seen[1] | seen[2]) >= 36 - 2


def test_loader_uneven_batch_boundary(monkeypatch):
    """15 items over 2 ranks at batch 4: padded to 2 batches each (unpadded,
    8 against 7 items would give 2 against 1 and hang a collective), every
    item seen."""
    shards = _shards(monkeypatch, 15, 4, 2)
    assert [len(s) for s in shards] == [2, 2]
    assert len({v for s in shards for b in s for v in b}) == 15


def test_shard_detector_serves_two_replicas_as_one(models):
    """One batch-polymorphic artifact as two CPU replicas: every output
    equals ``load_detector``'s on the whole batch, and each replica's slice
    equals ``load_detector``'s on that slice bit for bit."""
    pm = models["pose"]["pm"]
    blob = export_detector(pm, models["pose"]["init"][0], HMIN, HMAX, batch=None,
                           dtype="float32", device="cpu")
    one = load_detector(blob, device="cpu")
    two = shard_detector(blob, ["cpu", "cpu"])
    assert len(two.replicas) == 2 and two.metadata["batch"] is None
    rng = np.random.default_rng(5)
    args = (rng.normal(size=(4, 32, 32, 3)).astype(np.float32), *_camera_args(rng, 4))
    got, whole = two(*args), one(*args)
    halves = [one(*[a[i * 2:(i + 1) * 2] for a in args]) for i in range(2)]
    for k, (g, w) in enumerate(zip(got, whole)):
        assert g.shape == w.shape and g.dtype == w.dtype
        assert torch.equal(g, torch.cat([h[k] for h in halves]))
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="not divisible"):
        two(*[a[:3] for a in args])
