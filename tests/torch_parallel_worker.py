"""A rank of the port's 2-process CPU world (not a pytest module), and the
port-side helpers ``tests/test_torch_port_parallel.py`` shares with it.

Launched by ``generative_detection_tpu_torch.parallel.multihost.spawn_ranks``
(torch's launch environment, gloo on the CPU) as::

    python tests/torch_parallel_worker.py INPUTS.pt OUT_DIR
    python tests/torch_parallel_worker.py --card OUT_DIR   # two ranks on one card
    python tests/torch_parallel_worker.py --card-fsdp OUT_DIR   # the same, FSDP

(``--card``: ``card_steps``, ``--card-fsdp``: ``card_fsdp``, for
``tests/test_torch_port_gpu.py``.)

Each rank runs, on its half of the test's global batch:

- one pose and one plain train step from the seeded weights (float32, for
  the JAX comparison; rank 0 keeps the updated weights; the pose step is the
  first of the ZeRO-1 comparison's unsharded run);
- the same two steps in float64 with the averaged, clipped gradients the
  optimizers step on and (rank 0) the updated weights, for the comparison
  with one process at the global batch;
- two pose steps with ZeRO-1 off and on: the weights' hashes, both
  optimizers' consolidated ``state_dict`` moments and the elements of
  moments the rank holds;
- FSDP (``fsdp_parameter_sharding``): the float32 step of both families
  from the same weights, draws and batch as the unsharded one and what each
  rank then holds at rest; an accumulation window of two pose micro-batches
  with FSDP and without;
- a ``Trainer.fit`` that resumes, with ZeRO-1, a checkpoint written by one
  process, for one more step (``RankProbe`` records what it restored), once
  the test has written it (the ranks start before it exists); then an FSDP
  fit with validation and ``ImageLogger`` that resumes the ZeRO-1 fit's own
  checkpoint for one step, its checkpoint restored into a ZeRO-1 state, and
  a ``train_cli`` fit of the plain family under FSDP, in these ranks.

It writes ``OUT_DIR/rank<r>.pt`` and imports nothing of JAX; it also records
which JAX modules it holds (none). ``RankProbe`` is the callback the test's
``train_cli`` ranks instantiate from the config; importing this module in a
spawned rank keeps ``torch.utils.tensorboard`` out (its import pulls
TensorFlow, ~15 s).
"""

from __future__ import annotations

import hashlib
import json
import os
import sys
import time
from pathlib import Path

import numpy as np
import torch

if os.environ.get("GDT_MULTIHOST") == "1":  # a spawned rank
    sys.modules.setdefault("torch.utils.tensorboard", None)

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from generative_detection_tpu_torch import train_cli  # noqa: E402
from generative_detection_tpu_torch.config import instantiate_from_config, merge_configs  # noqa: E402
from generative_detection_tpu_torch.parallel import fsdp, mesh, multihost  # noqa: E402
from generative_detection_tpu_torch.serving import _serving_net  # noqa: E402
from generative_detection_tpu_torch.train import (  # noqa: E402
    CheckpointManager,
    Trainer,
    TrainState,
    make_optimizers,
    make_plain_train_step,
    make_train_step,
)
from generative_detection_tpu_torch.train.callbacks import Callback, ImageLogger  # noqa: E402
from generative_detection_tpu_torch.train.state import flax_like_net, shard_for_fsdp  # noqa: E402

TINY = str(REPO / "configs/autoencoder/pose/tiny_cpu.yaml")
PLAIN = str(REPO / "configs/autoencoder/plain_kl_tiny.yaml")
LR, SEED = 1e-4, 23
# train steps of the comparisons: pose generator step 8 (past the curriculum:
# pixel, LPIPS, GAN and d_weight live), plain generator step 2 (past disc_start)
STEP = {"pose": 4, "plain": 1}
THREADS = 2  # one thread's CPU backward through the discriminator loses bits
_JAX = ("jax", "jaxlib", "flax", "optax", "orbax", "generative_detection_tpu")


def jax_modules() -> list:
    return sorted(m for m in sys.modules
                  if any(m == j or m.startswith(j + ".") for j in _JAX))


def model(family: str):
    pm = instantiate_from_config(merge_configs([TINY if family == "pose" else PLAIN])["model"])
    pm.learning_rate = LR
    return pm


def init_weights(pm):
    """The weights ``create_train_state(pm, seed=SEED)`` draws (net, loss)."""
    g = torch.Generator().manual_seed(SEED)
    net_sd = flax_like_net(pm, g, "cpu").state_dict()
    return net_sd, pm.init_loss(g, device="cpu").state_dict()


def state_from(pm, weights, family, dtype=torch.float32, zero1=False, fsdp=False,
               accumulate=1) -> TrainState:
    """A train state on the weights at the comparison's step, its forward
    draws from ``create_train_state``'s generator (seed + 1); ``fsdp``
    shards it as ``create_train_state(fsdp=True)`` does."""
    net, loss = pm.build_net(), pm.build_loss()
    net.load_state_dict(weights[0], strict=True)
    loss.load_state_dict(weights[1], strict=True)
    net.to(dtype)
    loss.to(dtype)
    if fsdp:
        shard_for_fsdp(net, loss)
    opt_ae, opt_disc = make_optimizers(net, loss, LR, grad_clip=1.0, zero1=zero1,
                                       accumulate_grad_batches=accumulate)
    return TrainState(STEP[family], net, loss, opt_ae, opt_disc,
                      torch.Generator().manual_seed(SEED + 1))


def step_fn(pm, family, accumulate=1):
    return (make_train_step(pm, phase="full", accumulate_grad_batches=accumulate)
            if family == "pose" else make_plain_train_step(pm, accumulate_grad_batches=accumulate))


def local_batch(pm, family, host, dtype=torch.float32) -> dict:
    """The batch this process trains on: in a world of two its half of the
    global host batch, else the whole of it rescaled per half, as the JAX
    package's data axis of two rescales it (``rescale_minmax``)."""
    w = mesh.world()
    if family == "plain":
        host = {"image": host["image"]}
    if w.size > 1:
        batch = pm.prepare_batch(mesh.shard_batch(host), device="cpu")
    else:
        batch = pm.prepare_batch(host, num_shards=2, device="cpu")
    return {k: v.to(dtype) if v.is_floating_point() else v for k, v in batch.items()}


def floats(metrics) -> dict:
    return {k: float(v) for k, v in metrics.items()}


def record_grads(state) -> dict:
    """Capture, once, the gradients each optimizer's Adam steps on (averaged
    over the ranks and the window, clipped), as one float64 vector each."""
    out = {}
    for name in ("opt_ae", "opt_disc"):
        opt = getattr(state, name)
        adam_step = opt.adam.step

        def step(*a, _opt=opt, _name=name, _step=adam_step, **kw):
            out.setdefault(_name, torch.cat([p.grad.reshape(-1).double() for p in _opt.params]))
            return _step(*a, **kw)

        opt.adam.step = step
    return out


def _params(module) -> dict:
    """A module's parameters by name, in ``parameters()`` order; an FSDP
    module's gathered (every rank calls it)."""
    if not fsdp.is_sharded(module):
        return {k: v.detach().clone() for k, v in module.named_parameters()}
    buffers = {k for k, _ in module.named_buffers()}
    return {k: v for k, v in module.state_dict().items() if k not in buffers}


def weights(state) -> dict:
    """The trained weights by the names of ``state_dict_from_jax`` and
    ``loss_state_dict_from_jax`` (under FSDP gathered: a collective)."""
    out = _params(state.net)
    out.update({f"discriminator.{k}": v for k, v in _params(state.loss.discriminator).items()})
    return out


def at_rest(state) -> dict:
    """What this rank holds of the net, LPIPS and the discriminator between
    steps: per module its parameters' elements ``n``, its units' count, and
    the elements it holds of parameters, gradients and Adam moments; whether
    any unit holds its full parameters, any placeholder of a backward is
    alive, or any weight attribute is a real tensor."""
    out = {}
    opts = {id(state.net): state.opt_ae, id(state.loss.discriminator): state.opt_disc}
    for name, m in (("net", state.net), ("lpips", state.loss.perceptual_loss),
                    ("disc", state.loss.discriminator)):
        units = fsdp.units_of(m)
        opt = opts.get(id(m))
        moments = 0
        if opt is not None:
            moments = sum(st["exp_avg"].numel() + st["exp_avg_sq"].numel()
                          for st in opt.adam.state.values())
        out[name] = dict(
            n=sum(sum(u.numels()) for u in units), units=len(units),
            params=sum(p.numel() for p in m.parameters()),
            grads=sum(p.grad.numel() for p in m.parameters() if p.grad is not None),
            moments=moments,
            held=any(u.held() for u in units), pending=sum(u.pending for u in units),
            real=[rel for u in units for (owner, attr, rel) in u.slots
                  if getattr(owner, attr).device.type != "meta"])
    out["whole"] = [k for k, p in state.loss.named_parameters()
                    if not k.startswith(("perceptual_loss.", "discriminator."))]
    return out


def digest(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def step_grads(state) -> dict:
    """After each optimizer's first step: its global gradient norm before
    clipping, and the averaged gradient it stepped on, before clipping, as
    its consolidated Adam moments give it (mu / (1 - b1) and nu / (1 - b2)
    times the clip's inverse scale, once and squared: ``grad``,
    ``grad_sq``), one flat float64 tensor a key, each parameter in its
    logical order (a collective under ZeRO-1 or FSDP). Undoing the clip
    keeps a wrong scale of the gradient visible; the norm itself sums in
    another order under FSDP."""
    out = {}
    for name in ("opt_ae", "opt_disc"):
        opt = getattr(state, name)
        norm = float(opt.grad_norm)
        scale = max(norm / opt.grad_clip, 1.0)
        b1, b2 = opt.adam.param_groups[0]["betas"]
        sd = opt.state_dict()["adam"]["state"]

        def flat(key):
            return torch.cat([sd[i][key].reshape(-1).double().cpu() for i in sorted(sd)])

        out[name + ".grad_norm"] = norm
        out[name + ".grad"] = flat("exp_avg") * (scale / (1 - b1))
        out[name + ".grad_sq"] = flat("exp_avg_sq") * (scale * scale / (1 - b2))
    return out


def moment_sums(opt_sd: dict) -> list:
    """Per parameter index of an optimizer ``state_dict``: (sum, sum of
    squares) of mu and nu in float64."""
    out = []
    for i in sorted(opt_sd["adam"]["state"]):
        st = opt_sd["adam"]["state"][i]
        out.append([float(t.double().sum()) for m in ("exp_avg", "exp_avg_sq")
                    for t in (st[m], st[m].double().square())])
    return out


class RankProbe(Callback):
    """Writes ``<out>/probe_rank<r>.json`` at each step's end: the rank, the
    world, every step's logged ``aeloss``, the state's step and weights'
    hash at fit start (after a restore) and at the last step, the JAX
    modules this process holds, and the sums of the Adam moments each
    optimizer holds on this rank."""

    def __init__(self, out: str, name: str = "probe", **_):
        self.out, self.name = out, name
        self.rows = {"aeloss": []}

    def on_fit_start(self, trainer):
        w = mesh.world()
        self.rows.update(rank=w.rank, world=w.size, start_step=trainer.state.step,
                         start_digest=digest(_params(trainer.state.net).values()),
                         start_owned=self._owned(trainer.state))
        self._write()

    def on_train_batch_end(self, trainer, metrics, batch):
        self.rows["aeloss"].append([trainer.global_batch(), float(metrics["aeloss"])])
        self.rows.update(step=trainer.state.step,
                         digest=digest(_params(trainer.state.net).values()),
                         owned=self._owned(trainer.state), jax_modules=jax_modules())
        self._write()

    @staticmethod
    def _owned(state) -> dict:
        """Per optimizer: its shard's range of the parameters' flat elements
        and the float64 sums of the Adam moments it holds there."""
        out = {}
        for name in ("opt_ae", "opt_disc"):
            opt = getattr(state, name)
            rng = None if opt.shard_range is None else list(opt.shard_range)
            out[name] = [rng] + [float(m.double().sum()) for m in opt.held_moments()]
        return out

    def _write(self):
        rank = self.rows.get("rank", mesh.world().rank)
        with open(os.path.join(self.out, f"{self.name}_rank{rank}.json"), "w") as f:
            json.dump(self.rows, f)


def wait_for(path: str, timeout: float = 300.0) -> None:
    deadline = time.monotonic() + timeout
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise TimeoutError(f"{path} did not appear within {timeout} s")
        time.sleep(0.1)


def resume_fit(pm, ckptdir: str, logdir: str, probe_dir: str) -> dict:
    """One more step of ``tiny_cpu.yaml`` at batch 4 a rank, with ZeRO-1,
    resumed from ``ckptdir`` once its ``READY`` file exists (no
    validation). Then, with FSDP, two steps resumed from the ZeRO-1 fit's
    own checkpoint (which ``READY`` names), with validation after them and
    ``ImageLogger`` at every step; its last checkpoint restored into a
    ZeRO-1 state. Returns the FSDP fit's consolidated moments' sums and what
    the ZeRO-1 state restored."""
    ready = os.path.join(ckptdir, "READY")
    wait_for(ready)
    cfg = merge_configs([TINY], ["data.params.batch_size=4"])["data"]
    trainer = Trainer(pm, logdir=logdir, max_epochs=4, max_steps=5, limit_val_batches=0,
                      log_every_n_steps=1, seed=SEED, device="cpu", devices=2,
                      zero1_optimizer_sharding=True, resume_from_checkpoint=ckptdir,
                      callbacks=[RankProbe(probe_dir)])
    trainer.fit(instantiate_from_config(cfg))
    with open(ready) as f:
        zero1_ckpt = f.read().strip()
    fsdp_dir = os.path.join(os.path.dirname(logdir), "fsdp_fit")
    trainer = Trainer(pm, logdir=fsdp_dir, max_epochs=4, max_steps=5, limit_val_batches=1,
                      log_every_n_steps=1, seed=SEED, device="cpu", devices=2, save_top_k=0,
                      fsdp_parameter_sharding=True, resume_from_checkpoint=zero1_ckpt,
                      callbacks=[RankProbe(probe_dir, name="fsdp_probe"),
                                 ImageLogger(batch_frequency=5, max_images=2)])
    trainer.fit(instantiate_from_config(cfg))
    out = {"fsdp_moments": {n: moment_sums(getattr(trainer.state, n).state_dict())
                            for n in ("opt_ae", "opt_disc")},
           "at_rest": at_rest(trainer.state)}
    # predict and serving take the gathered weights
    split = {"target": "generative_detection_tpu.data.synthetic.SyntheticPatchValidation",
             "params": {"length": 8, "patch_height": 32}}
    predict_cfg = merge_configs([TINY], ["data.params.batch_size=4"])["data"]
    predict_cfg["params"]["predict"] = split
    dm = instantiate_from_config(predict_cfg)
    dm.setup()
    predicted = trainer.predict(dm, limit_batches=1)
    served, _ = _serving_net(pm, trainer.state.net, "float32", "cpu")
    out["served_digest"] = digest(served.parameters())
    # the FSDP checkpoint into ZeRO-1 ranks
    zero = state_from(pm, init_weights(pm), "pose", zero1=True)
    CheckpointManager(os.path.join(fsdp_dir, "checkpoints")).restore(zero)
    out["zero1_restored"] = {
        "step": zero.step, "digest": digest(weights(zero).values()),
        "moments": {n: moment_sums(getattr(zero, n).state_dict()) for n in ("opt_ae", "opt_disc")}}
    trainer.state = zero
    again = trainer.predict(dm, limit_batches=1)
    out["predict_bit_equal"] = [all(np.array_equal(a[k], b[k]) for k in a)
                                for a, b in zip(predicted, again)]
    out["predict_shapes"] = [list(v.shape) for v in predicted[0].values()]
    dm.teardown()
    return out


def plain_cli_fit(out: str) -> None:
    """``train_cli -b plain_kl_tiny.yaml -t`` under FSDP in these two ranks
    (batch 2 a rank, two steps, validation after them)."""
    train_cli.main(["-b", PLAIN, "-t", "--device", "cpu", "-l", out, "-n", "fsdp",
                    "--logging_level", "WARNING", "--max_steps", "2",
                    "data.params.batch_size=2", "lightning.trainer.devices=2",
                    "lightning.trainer.fsdp_parameter_sharding=true",
                    "model.params.monitor=null"])


def fsdp_steps(pm, init, family, host, res) -> None:
    """The float32 step with FSDP from the unsharded case's weights, draws
    and batch, and what the rank then holds; for the pose family also an
    accumulation window of two micro-batches in float64, with and without
    FSDP."""
    state = state_from(pm, init, family, fsdp=True)
    state, m = step_fn(pm, family)(state, local_batch(pm, family, host))
    trained, grads = weights(state), step_grads(state)
    out = {"metrics": floats(m), "digest": digest(trained.values()), "at_rest": at_rest(state)}
    if mesh.world().rank == 0:
        out.update(weights=trained, grads=grads)
    if family == "pose":
        window = {}
        batch = local_batch(pm, family, host, torch.float64)
        step = step_fn(pm, family, accumulate=2)
        for sharded in (False, True):
            state = state_from(pm, init, family, torch.float64, fsdp=sharded, accumulate=2)
            rows = []
            for _ in range(2):
                state, m = step(state, batch)
                rows.append(floats(m))
            window[sharded] = {"metrics": rows, "weights": weights(state),
                               "moments": {n: getattr(state, n).state_dict()["adam"]["state"]
                                           for n in ("opt_ae", "opt_disc")}}
        if mesh.world().rank == 0:
            out["window"] = window
    res[family + "_fsdp"] = out


def main(inputs: str, out: str) -> None:
    torch.set_num_threads(THREADS)
    w = multihost.maybe_initialize()
    assert w.size == 2, w
    inp = torch.load(inputs, weights_only=False)
    res = {"rank": w.rank}
    # the global batch's rows, sharded and gathered back
    local = mesh.shard_batch({"class_id": inp["pose"]["class_id"]})
    res["gathered"] = multihost.global_batch_from_local(local)["class_id"].tolist()

    def first_step(family, state, m):
        """The float32 step from the seeded weights: the JAX and FSDP comparisons."""
        trained, grads = weights(state), step_grads(state)
        res[family] = {"metrics": floats(m), "digest": digest(trained.values())}
        if w.rank == 0:
            res[family].update(weights=trained, grads=grads)

    for family in ("pose", "plain"):
        pm = model(family)
        init = init_weights(pm)
        step = step_fn(pm, family)
        batch = local_batch(pm, family, inp[family])
        if family == "plain":  # the pose step's is the first of the ZeRO-1 comparison's
            first_step(family, *step(state_from(pm, init, family), batch))
        # float64: against one process at the global batch
        state = state_from(pm, init, family, torch.float64)
        grads = record_grads(state)
        state, m = step(state, local_batch(pm, family, inp[family], torch.float64))
        res[family + "64"] = {"metrics": floats(m), "digest": digest(grads.values())}
        if w.rank == 0:
            res[family + "64"].update(grads=grads, weights={k: v.float() for k, v in
                                                            weights(state).items()})
        if family == "pose":
            zero = {}
            for z in (False, True):
                state = state_from(pm, init, family, zero1=z)
                for i in range(2):
                    state, m = step(state, batch)
                    if i == 0 and not z:
                        first_step(family, state, m)
                sds = {name: getattr(state, name).state_dict() for name in ("opt_ae", "opt_disc")}
                zero[z] = {
                    "digest": digest(weights(state).values()),
                    "moments": {name: moment_sums(sd) for name, sd in sds.items()},
                    "held": {name: sum(st["exp_avg"].numel()
                                       for st in getattr(state, name).adam.state.values())
                             for name in sds},
                    "total": {name: sum(p.numel() for p in getattr(state, name).params)
                              for name in sds},
                }
            res["zero1"] = zero
        fsdp_steps(pm, init, family, inp[family], res)
    res["resumed"] = resume_fit(model("pose"), inp["resume_from"], os.path.join(out, "resumed"),
                                out)
    plain_cli_fit(os.path.join(out, "plain_cli"))
    res["jax_modules"] = jax_modules()
    torch.save(res, os.path.join(out, f"rank{w.rank}.pt"))
    multihost.shutdown()


CARD_BATCH = 8  # the global batch of the card's case


def _card_setup():
    """tiny_cpu.yaml at ch 128, its first CARD_BATCH patches prepared on the
    card (in a world of two this rank's half, else all of them rescaled per
    half) and its fp32 'full' step."""
    cfg = merge_configs([TINY], ["model.params.ddconfig.ch=128"])
    pm = instantiate_from_config(cfg["model"])
    ds = instantiate_from_config(cfg["data"]["params"]["train"])
    from generative_detection_tpu_torch.data.datamodule import collate

    host = collate([ds[i] for i in range(CARD_BATCH)])
    if mesh.world().size > 1:
        batch = pm.prepare_batch(mesh.shard_batch(host), device="cuda")
    else:
        batch = pm.prepare_batch(host, num_shards=2, device="cuda")
    return pm, batch, make_train_step(pm, phase="full", compute_dtype=torch.float32)


def card_steps(out: str = None, fsdp: bool = False) -> list:
    """Two fp32 steps of ``tiny_cpu.yaml`` at ch 128 on the card from the
    seeded weights and the generator's draws (``create_train_state``, with
    ``fsdp`` as given): in a world of two (two ranks sharing the card over
    gloo) each on its half of the global batch, else the whole of it
    rescaled per half. Returns each step's metrics and the weights' digest,
    and writes them to ``<out>/card_rank<r>.json`` when ``out`` is given."""
    from generative_detection_tpu_torch.train import create_train_state

    torch.set_num_threads(THREADS)
    w = mesh.world()
    pm, batch, step = _card_setup()
    state = create_train_state(pm, LR, seed=SEED, device="cuda", fsdp=fsdp)
    state.step = 6  # generator step 12, past this config's curriculum
    rows = []
    for _ in range(2):
        state, m = step(state, batch)
        rows.append(floats(m))
    rows.append({"digest": digest(_params(state.net).values()), "jax_modules": jax_modules()})
    if out is not None:
        with open(os.path.join(out, f"card_rank{w.rank}.json"), "w") as f:
            json.dump(rows, f)
    return rows


def card_fsdp(out: str) -> None:
    """In a world of two on the card: ``card_steps``' first step unsharded
    and with FSDP from the same seed, cuDNN deterministic; writes both
    steps' metrics, the largest difference of the weights after them in
    units of the learning rate, of the gradients before the clip
    (``step_grads``) relative to each one's largest and of the global norms
    relative, what the rank holds at rest under FSDP and the launches of
    each to ``<out>/card_fsdp_rank<r>.json``."""
    from generative_detection_tpu_torch.ops import attention, norm
    from generative_detection_tpu_torch.train import create_train_state

    torch.set_num_threads(THREADS)
    torch.backends.cudnn.deterministic = True
    pm, batch, step = _card_setup()
    counted = (norm.group_norm, norm.group_norm_backward, attention.single_head_attention,
               attention.attention_backward)
    res = {}
    for sharded in (False, True):
        state = create_train_state(pm, LR, seed=SEED, device="cuda", fsdp=sharded)
        state.step = 6
        for fn in counted:
            fn.launches = 0
        state, m = step(state, batch)
        res[sharded] = {"metrics": floats(m), "weights": weights(state),
                        "grads": step_grads(state),
                        "launches": [fn.launches for fn in counted]}
        if sharded:
            res[sharded]["at_rest"] = at_rest(state)
    diff = max(float((res[True]["weights"][k] - v).abs().max())
               for k, v in res[False]["weights"].items())
    got, want = res[True]["grads"], res[False]["grads"]
    grads = {k: (abs(got[k] - v) / v if k.endswith(".grad_norm")
                 else float((got[k] - v).abs().max() / v.abs().max())) for k, v in want.items()}
    with open(os.path.join(out, f"card_fsdp_rank{mesh.world().rank}.json"), "w") as f:
        json.dump({"unsharded": res[False]["metrics"], "fsdp": res[True]["metrics"],
                   "weights_max_abs_diff_over_lr": diff / LR, "grads_rel_diff": grads,
                   "launches": [res[False]["launches"], res[True]["launches"]],
                   "at_rest": res[True]["at_rest"], "jax_modules": jax_modules()}, f)


if __name__ == "__main__":
    if sys.argv[1] in ("--card", "--card-fsdp"):
        multihost.maybe_initialize()
        (card_steps if sys.argv[1] == "--card" else card_fsdp)(sys.argv[2])
        multihost.shutdown()
    else:
        main(*sys.argv[1:3])
