"""A rank of the port's 2-process CPU world (not a pytest module), and the
port-side helpers ``tests/test_torch_port_parallel.py`` shares with it.

Launched by ``generative_detection_tpu_torch.parallel.multihost.spawn_ranks``
(torch's launch environment, gloo on the CPU) as::

    python tests/torch_parallel_worker.py INPUTS.pt OUT_DIR
    python tests/torch_parallel_worker.py --card OUT_DIR   # two ranks on one card

(``--card``: ``card_steps``, for ``tests/test_torch_port_gpu.py``.)

Each rank runs, on its half of the test's global batch:

- one pose and one plain train step from the seeded weights (float32, for
  the JAX comparison; rank 0 keeps the updated weights);
- the same two steps in float64 with the averaged, clipped gradients the
  optimizers step on and (rank 0) the updated weights, for the comparison
  with one process at the global batch;
- two pose steps with ZeRO-1 off and on: the weights' hashes, both
  optimizers' consolidated ``state_dict`` moments and the elements of
  moments the rank holds;
- a ``Trainer.fit`` that resumes, with ZeRO-1, a checkpoint written by one
  process, for one more step (``RankProbe`` records what it restored), once
  the test has written it (the ranks start before it exists).

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

from generative_detection_tpu_torch.config import instantiate_from_config, merge_configs  # noqa: E402
from generative_detection_tpu_torch.parallel import mesh, multihost  # noqa: E402
from generative_detection_tpu_torch.train import (  # noqa: E402
    CheckpointManager,
    Trainer,
    TrainState,
    make_optimizers,
    make_plain_train_step,
    make_train_step,
)
from generative_detection_tpu_torch.train.callbacks import Callback  # noqa: E402
from generative_detection_tpu_torch.train.state import flax_like_net  # noqa: E402

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


def state_from(pm, weights, family, dtype=torch.float32, zero1=False) -> TrainState:
    """A train state on the weights at the comparison's step, its forward
    draws from ``create_train_state``'s generator (seed + 1)."""
    net, loss = pm.build_net(), pm.build_loss()
    net.load_state_dict(weights[0], strict=True)
    loss.load_state_dict(weights[1], strict=True)
    net.to(dtype)
    loss.to(dtype)
    opt_ae, opt_disc = make_optimizers(net, loss, LR, grad_clip=1.0, zero1=zero1)
    return TrainState(STEP[family], net, loss, opt_ae, opt_disc,
                      torch.Generator().manual_seed(SEED + 1))


def step_fn(pm, family):
    return (make_train_step(pm, phase="full") if family == "pose"
            else make_plain_train_step(pm))


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


def weights(state) -> dict:
    """The trained weights by the names of ``state_dict_from_jax`` and
    ``loss_state_dict_from_jax``."""
    out = {k: v.detach().clone() for k, v in state.net.named_parameters()}
    out.update({f"discriminator.{k}": v.detach().clone()
                for k, v in state.loss.discriminator.named_parameters()})
    return out


def digest(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


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

    def __init__(self, out: str, **_):
        self.out = out
        self.rows = {"aeloss": []}

    def on_fit_start(self, trainer):
        w = mesh.world()
        self.rows.update(rank=w.rank, world=w.size, start_step=trainer.state.step,
                         start_digest=digest(trainer.state.net.parameters()),
                         start_owned=self._owned(trainer.state))
        self._write()

    def on_train_batch_end(self, trainer, metrics, batch):
        self.rows["aeloss"].append([trainer.global_batch(), float(metrics["aeloss"])])
        self.rows.update(step=trainer.state.step, digest=digest(trainer.state.net.parameters()),
                         owned=self._owned(trainer.state), jax_modules=jax_modules())
        self._write()

    @staticmethod
    def _owned(state) -> dict:
        """Per optimizer: its shard's range of the parameters' flat elements
        and the float64 sums of the Adam moments it holds there."""
        out = {}
        for name in ("opt_ae", "opt_disc"):
            opt = getattr(state, name)
            out[name] = [list(opt.shard_range)] + [float(m.double().sum())
                                                   for m in opt.held_moments()]
        return out

    def _write(self):
        rank = self.rows.get("rank", mesh.world().rank)
        with open(os.path.join(self.out, f"probe_rank{rank}.json"), "w") as f:
            json.dump(self.rows, f)


def wait_for(path: str, timeout: float = 300.0) -> None:
    deadline = time.monotonic() + timeout
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise TimeoutError(f"{path} did not appear within {timeout} s")
        time.sleep(0.1)


def resume_fit(pm, ckptdir: str, logdir: str, probe_dir: str) -> None:
    """One more step of ``tiny_cpu.yaml`` at batch 4 a rank, with ZeRO-1,
    resumed from ``ckptdir`` once its ``READY`` file exists (no
    validation)."""
    wait_for(os.path.join(ckptdir, "READY"))
    cfg = merge_configs([TINY], ["data.params.batch_size=4"])["data"]
    trainer = Trainer(pm, logdir=logdir, max_epochs=4, max_steps=5, limit_val_batches=0,
                      log_every_n_steps=1, seed=SEED, device="cpu", devices=2,
                      zero1_optimizer_sharding=True, resume_from_checkpoint=ckptdir,
                      callbacks=[RankProbe(probe_dir)])
    trainer.fit(instantiate_from_config(cfg))


def main(inputs: str, out: str) -> None:
    torch.set_num_threads(THREADS)
    w = multihost.maybe_initialize()
    assert w.size == 2, w
    inp = torch.load(inputs, weights_only=False)
    res = {"rank": w.rank}
    # the global batch's rows, sharded and gathered back
    local = mesh.shard_batch({"class_id": inp["pose"]["class_id"]})
    res["gathered"] = multihost.global_batch_from_local(local)["class_id"].tolist()
    for family in ("pose", "plain"):
        pm = model(family)
        init = init_weights(pm)
        step = step_fn(pm, family)
        # float32: the JAX comparison
        state = state_from(pm, init, family)
        state, m = step(state, local_batch(pm, family, inp[family]))
        trained = weights(state)
        res[family] = {"metrics": floats(m), "digest": digest(trained.values())}
        if w.rank == 0:
            res[family]["weights"] = trained
        # float64: against one process at the global batch
        state = state_from(pm, init, family, torch.float64)
        grads = record_grads(state)
        state, m = step(state, local_batch(pm, family, inp[family], torch.float64))
        res[family + "64"] = {"metrics": floats(m), "digest": digest(grads.values())}
        if w.rank == 0:
            res[family + "64"].update(grads=grads, weights={k: v.float() for k, v in
                                                            weights(state).items()})
        if family == "pose":
            batch = local_batch(pm, family, inp[family])
            zero = {}
            for z in (False, True):
                state = state_from(pm, init, family, zero1=z)
                for _ in range(2):
                    state, _ = step(state, batch)
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
    resume_fit(model("pose"), inp["resume_from"], os.path.join(out, "resumed"), out)
    res["jax_modules"] = jax_modules()
    torch.save(res, os.path.join(out, f"rank{w.rank}.pt"))
    multihost.shutdown()


CARD_BATCH = 8  # the global batch of the card's case


def card_steps(out: str = None) -> list:
    """Two fp32 steps of ``tiny_cpu.yaml`` at ch 128 on the card from the
    seeded weights and the generator's draws: in a world of two (two ranks
    sharing the card over gloo) each on its half of the global batch, else
    the whole of it rescaled per half. Returns each step's metrics and
    writes them to ``<out>/card_rank<r>.json`` when ``out`` is given."""
    torch.set_num_threads(THREADS)
    w = mesh.world()
    cfg = merge_configs([TINY], ["model.params.ddconfig.ch=128"])
    pm = instantiate_from_config(cfg["model"])
    ds = instantiate_from_config(cfg["data"]["params"]["train"])
    from generative_detection_tpu_torch.data.datamodule import collate
    from generative_detection_tpu_torch.train import create_train_state

    host = collate([ds[i] for i in range(CARD_BATCH)])
    if w.size > 1:
        batch = pm.prepare_batch(mesh.shard_batch(host), device="cuda")
    else:
        batch = pm.prepare_batch(host, num_shards=2, device="cuda")
    state = create_train_state(pm, LR, seed=SEED, device="cuda")
    state.step = 6  # generator step 12, past this config's curriculum
    step = make_train_step(pm, phase="full", compute_dtype=torch.float32)
    rows = []
    for _ in range(2):
        state, m = step(state, batch)
        rows.append(floats(m))
    rows.append({"digest": digest(state.net.parameters()), "jax_modules": jax_modules()})
    if out is not None:
        with open(os.path.join(out, f"card_rank{w.rank}.json"), "w") as f:
            json.dump(rows, f)
    return rows


if __name__ == "__main__":
    if sys.argv[1] == "--card":
        multihost.maybe_initialize()
        card_steps(sys.argv[2])
        multihost.shutdown()
    else:
        main(*sys.argv[1:3])
