"""The Trainer: fit, validate, test and predict loops (``train/loop.py`` of
the JAX package; PyTorch Lightning's ``Trainer`` in the reference).

- One train step per curriculum phase ('pretrain' before
  ``encoder_pretrain_steps``, then 'full'), chosen by the optimizer-step
  clock, so pretraining never runs the decoder's loss terms;
- prepared batches prefetched onto the card (pinned host memory,
  ``non_blocking`` copies on a side stream, two batches ahead);
- epoch-end validation weighted per sample, monitored top-k and last
  checkpoints, the every-N-steps checkpoint stream, checkpoint-on-signal,
  image logging and callback hooks;
- a ``torch.profiler`` trace of steps [10, 15) when ``profiler_dir`` is set.

It runs on the card (``device="cuda"``) unless the caller asks for the CPU;
without CUDA it raises rather than train on the CPU unasked. A kernel that
fails to build or launch raises: there is no fallback route.

Data parallelism (Lightning's DDP in the reference): one process a card in a
``torch.distributed`` process group (``parallel/``), joined before the
Trainer is built (``train_cli`` joins or spawns it). ``devices`` must then
equal the group's size, and ``devices`` > 1 outside a group raises. Each rank
reads its shard of every split (the datamodule), runs the step on it (a step
of the global batch: ``train/steps.py``), and takes the global means as its
metrics; rank 0 alone logs, writes images and run files; checkpoints are
saved and restored collectively (``train/checkpoint.py``), and a signal's
save waits for the step's end on every rank. ``zero1_optimizer_sharding``
shards the Adam moments over the ranks (``train/state.py``);
``fsdp_parameter_sharding`` (FSDP) shards the parameters of the net, LPIPS
and the discriminator with their gradients and moments (``parallel/fsdp.py``):
the steps and validation gather each unit at its forward, while image
logging and ``predict`` gather the whole network first, on every rank (rank
0 alone writes the images), as the JAX package's loop all-gathers its FSDP
params for them. In one process neither shards anything.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import logging
import os
import time
from typing import Any, Dict, Iterator, List, Optional

import torch

from ..ops.precision import compute_precision
from ..parallel import fsdp
from ..parallel.mesh import any_rank, world
from .callbacks import Callback, CheckpointCallback
from .checkpoint import CheckpointManager, restore_signals, save_on_signal
from .state import TrainState, create_train_state, flax_like_net
from .steps import (
    _autocast, make_eval_step, make_plain_eval_step, make_plain_train_step, make_train_step,
)

PROFILE_STEPS = (10, 15)  # the profiler's window of steps [start, stop)


def _ready(prepared: Dict[str, torch.Tensor], event) -> Dict[str, torch.Tensor]:
    """Make the compute stream wait for a batch copied on the side stream."""
    stream = torch.cuda.current_stream()
    stream.wait_event(event)
    for t in prepared.values():
        t.record_stream(stream)
    return prepared


def _device_prefetch(iterator, model, device: torch.device, depth: int = 2) -> Iterator[dict]:
    """Prepared batches on ``device``, ``depth`` ahead of the step: the host
    half (``prepare_batch_host``) is numpy; on the card its arrays are pinned
    and copied with ``non_blocking`` on a side stream, where the rescale also
    runs, so the copy overlaps the running step."""
    if device.type != "cuda":
        for batch in iterator:
            yield model.prepare_batch_device(model.prepare_batch_host(batch), device=device)
        return
    side = torch.cuda.Stream(device)
    buf = collections.deque()
    for batch in iterator:
        pinned = {k: torch.from_numpy(v).pin_memory()
                  for k, v in model.prepare_batch_host(batch).items()}
        with torch.cuda.stream(side):
            prepared = model.prepare_batch_device(pinned, device=device, non_blocking=True)
            event = torch.cuda.Event()
            event.record(side)
        buf.append((prepared, event))
        if len(buf) >= depth:
            yield _ready(*buf.popleft())
    while buf:
        yield _ready(*buf.popleft())


def _host_metrics(metrics: Dict[str, Any]) -> Dict[str, float]:
    """Every metric as a float; those on the card in one device-to-host copy."""
    tensors = {k: torch.as_tensor(v).detach() for k, v in metrics.items()}
    out = {k: float(v) for k, v in tensors.items() if v.device.type == "cpu"}
    on_card = [k for k in tensors if k not in out]
    if on_card:
        vals = torch.stack([tensors[k].float().reshape(()) for k in on_card]).cpu().tolist()
        out.update(zip(on_card, vals))
    return {k: out[k] for k in metrics}


def _check_devices(devices: Optional[int], w) -> None:
    """``devices`` against the process group this process is in: it must be
    the group's size; more than one outside a group raises."""
    if devices is None:
        return
    devices = int(devices)
    if not w.active and devices > 1:
        raise RuntimeError(
            f"devices={devices} asks for {devices} processes, one a card, but this process is "
            "in no process group: launch it with torchrun or srun, or through train_cli, which "
            "spawns the ranks itself")
    if w.active and devices != w.size:
        raise ValueError(f"devices={devices} but the process group has {w.size} ranks")


class Trainer:
    def __init__(
        self,
        model,
        logdir: str = "logs/run",
        max_epochs: int = 1000,
        max_steps: Optional[int] = None,
        accumulate_grad_batches: int = 1,
        gradient_clip_val: Optional[float] = 1.0,
        log_every_n_steps: int = 50,
        check_val_every_n_epoch: int = 1,
        limit_val_batches: Optional[int] = None,
        limit_test_batches: Optional[int] = None,
        async_checkpointing: bool = False,
        zero1_optimizer_sharding: bool = False,
        fsdp_parameter_sharding: bool = False,
        callbacks: Optional[List[Callback]] = None,
        logger=None,
        seed: int = 23,
        disc_forward: str = "shared",
        step_counting: str = "optimizer",
        monitor: Optional[str] = None,
        save_top_k: int = 3,
        resume_from_checkpoint: Optional[str] = None,
        devices: Optional[int] = None,
        profiler_dir: Optional[str] = None,
        device="cuda",
        **_: Any,
    ):
        self.world = world()
        _check_devices(devices, self.world)
        self.is_main_process = self.world.rank == 0
        self.zero1_optimizer_sharding = zero1_optimizer_sharding
        self.fsdp_parameter_sharding = fsdp_parameter_sharding
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' to train on the CPU")
        if self.device.type == "cuda" and self.device.index is None and self.world.active:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.model = model
        self.logdir = logdir
        self.ckptdir = os.path.join(logdir, "checkpoints")
        self.max_epochs = max_epochs
        self.max_steps = max_steps
        self.accumulate_grad_batches = max(int(accumulate_grad_batches), 1)
        self.gradient_clip_val = gradient_clip_val
        self.log_every_n = log_every_n_steps
        self.check_val_every_n_epoch = check_val_every_n_epoch
        # Lightning's semantics: None -> every batch, 0 -> skip the loop,
        # an int N -> the first N batches. Fractions are not supported.
        for name, v in (("limit_val_batches", limit_val_batches),
                        ("limit_test_batches", limit_test_batches)):
            if v is not None and isinstance(v, float) and 0.0 < v < 1.0:
                raise ValueError(f"fractional {name} is unsupported; pass an int "
                                 "batch count (or 0 to skip the loop)")
        self.limit_val_batches = None if limit_val_batches is None else int(limit_val_batches)
        self.limit_test_batches = None if limit_test_batches is None else int(limit_test_batches)
        self.async_checkpointing = async_checkpointing
        self.callbacks = callbacks or []
        self.logger = logger
        self.seed = seed
        self.disc_forward = disc_forward
        self.step_counting = step_counting
        self.monitor = monitor or getattr(model, "monitor", None)
        self.save_top_k = save_top_k
        self.resume_from_checkpoint = resume_from_checkpoint
        self.profiler_dir = profiler_dir
        # the every-N-steps checkpoint stream, from a configured CheckpointCallback
        self.every_n_train_steps = next(
            (cb.every_n_train_steps for cb in self.callbacks
             if isinstance(cb, CheckpointCallback) and cb.every_n_train_steps),
            None,
        )
        self.epoch = 0
        self.val_batch_idx = 0
        self._last_trainstep_saved = 0  # optimizer step 0 is never checkpointed
        self.state: Optional[TrainState] = None
        self.interrupted = False
        self._train_fns: Dict[str, Any] = {}
        self._eval_fns: Dict[str, Any] = {}
        self._profiler = None
        self._ckpt_mgr: Optional[CheckpointManager] = None
        self._signalled = False  # a signal's save, deferred to the step's end in a group
        # wall seconds by part of the fit, each without the others: each
        # step's loop iteration (the batch's fetch, the step, logging),
        # validation, image logging, checkpoint saves on the caller's thread
        self.timings: Dict[str, Any] = {"step_s": [], "validation_s": 0.0, "image_log_s": 0.0,
                                        "checkpoint_s": 0.0}

    # -- helpers ------------------------------------------------------------------

    def global_batch(self) -> int:
        return int(self.state.step) if self.state is not None else 0

    def _global_step_for_phase(self, batch_idx: int) -> int:
        # Lightning's global_step counts optimizer steps: two a batch (two
        # optimizers), divided by the accumulation factor
        opt_step = batch_idx // self.accumulate_grad_batches
        return 2 * opt_step if self.step_counting == "optimizer" else opt_step

    def _phase_for(self, batch_idx: int) -> str:
        pretrain = self.model.encoder_pretrain_steps
        if pretrain in (-1, 0):
            return "full"
        return "pretrain" if self._global_step_for_phase(batch_idx) < pretrain else "full"

    def _plain(self) -> bool:
        return getattr(self.model, "step_family", "pose") == "plain"

    def _build_fns(self) -> None:
        if self._plain():  # one step for both phases: no curriculum
            plain = make_plain_train_step(
                self.model, step_counting=self.step_counting,
                accumulate_grad_batches=self.accumulate_grad_batches,
            )
            self._train_fns = {"pretrain": plain, "full": plain}
            return
        self._train_fns = {
            phase: make_train_step(
                self.model, phase=phase, disc_forward=self.disc_forward,
                step_counting=self.step_counting,
                accumulate_grad_batches=self.accumulate_grad_batches,
            )
            for phase in ("pretrain", "full")
        }

    def _eval_fn_for(self, split: str):
        """One eval step a split: the split names the logged keys, so a test
        pass never logs (or monitors) ``val/*``."""
        if split not in self._eval_fns:
            kw = dict(step_counting=self.step_counting, split=split,
                      accumulate_grad_batches=self.accumulate_grad_batches)
            self._eval_fns[split] = (make_plain_eval_step(self.model, **kw) if self._plain()
                                     else make_eval_step(self.model, phase="auto", **kw))
        return self._eval_fns[split]

    def _generator(self, offset: int) -> torch.Generator:
        """A generator of its own for a forward-only pass, seeded from the
        trainer's seed as the JAX loop seeds its keys, so it never moves the
        training stream."""
        return torch.Generator(device=self.device).manual_seed(self.seed + offset)

    def _maybe_profile(self, start: bool) -> None:
        """A ``torch.profiler`` trace of steps [10, 15) into ``profiler_dir``."""
        if not self.profiler_dir:
            return
        step = self.global_batch()
        if start and step == PROFILE_STEPS[0] and self._profiler is None:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self._profiler = torch.profiler.profile(activities=acts)
            self._profiler.__enter__()
        elif not start and step >= PROFILE_STEPS[1] and self._profiler is not None:
            self._stop_profiler()

    def _stop_profiler(self) -> None:
        if self._profiler is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._profiler.__exit__(None, None, None)
        os.makedirs(self.profiler_dir, exist_ok=True)
        rank = f"_rank{self.world.rank}" if self.world.size > 1 else ""
        path = os.path.join(self.profiler_dir,
                            f"trace_steps_{PROFILE_STEPS[0]}_{PROFILE_STEPS[1]}{rank}.json")
        self._profiler.export_chrome_trace(path)
        self._profiler = None
        logging.info("profiler trace written to %s", path)

    # -- checkpointing ------------------------------------------------------------

    def save_last_checkpoint(self, drain: bool = True) -> None:
        """``drain`` (the default of the signal, exception and fit-exit
        saves) waits for async writes to land; the epoch-end save passes
        False so an async write overlaps training."""
        if self.state is not None and self._ckpt_mgr is not None:
            t0 = time.perf_counter()
            self._ckpt_mgr.save_last(self.global_batch(), self.state)
            if drain:
                self._ckpt_mgr.wait_until_finished()
            self.timings["checkpoint_s"] += time.perf_counter() - t0

    def save_after_failure(self) -> None:
        """The last checkpoint after an exception or an interrupt: in one
        process only. In a process group the rank that failed may be alone
        and could not meet the others in a collective save, so none is
        attempted (the last epoch's or signal's checkpoint stands)."""
        if self.world.size > 1:
            logging.warning("rank %d failed: no checkpoint (a save is collective)",
                            self.world.rank)
            return
        self.save_last_checkpoint()

    def _on_signal(self) -> None:
        """A signal's checkpoint: at once in one process; in a process group
        at the end of the step, once every rank knows (``any_rank``), so the
        collective save never interleaves with a step's collectives."""
        if self.world.size > 1:
            self._signalled = True
        else:
            self.save_last_checkpoint()

    def _checkpoint_manager(self, ckptdir: str) -> CheckpointManager:
        return CheckpointManager(ckptdir, monitor=self.monitor, save_top_k=self.save_top_k,
                                 async_checkpointing=self.async_checkpointing, save_last=True)

    def _resume_dir(self) -> str:
        r = self.resume_from_checkpoint
        return os.path.dirname(r) if r.endswith("last.ckpt") else r

    # -- image logging ------------------------------------------------------------

    def params_sharded(self) -> bool:
        """True when the live state's parameters are FSDP shards: then a
        whole network is a collective (``_full_net``)."""
        return self.state is not None and fsdp.is_sharded(self.state.net)

    def _full_net(self):
        """The live network; FSDP's gathered into an unsharded copy (every
        rank must call it)."""
        net = self.state.net
        if not fsdp.is_sharded(net):
            return net
        full = self.model.build_net()
        full.load_state_dict(net.state_dict())
        return full.to(self.device, memory_format=torch.channels_last)

    @torch.no_grad()
    def log_images(self, prepared_batch, max_images: int = 4) -> Dict[str, Any]:
        """Inputs, reconstructions, and (pose family) reconstructions decoded
        with the perturbed yaw (``perturbed_pose_forward``), through
        ``model.inference_net`` holding the live weights, as NHWC numpy
        arrays. Under FSDP every rank calls it (the weights are gathered
        first) and ranks other than 0 get nothing."""
        if self.state is None:
            return {}
        net = self._full_net()
        if not self.is_main_process and self.params_sharded():
            return {}
        inet = self.model.inference_net(net)
        gen = self._generator(7)
        dtype = self.model.compute_dtype
        if self._plain():
            x = prepared_batch["image"][:max_images]
            with compute_precision(dtype), _autocast(x.device, dtype):
                dec = inet(x, generator=gen)["dec_obj"]
            return {"inputs": x.float().cpu().numpy(), "reconstructions": dec.float().cpu().numpy()}
        x = prepared_batch["rgb_gt"][:max_images]
        step = self._global_step_for_phase(self.global_batch())
        with compute_precision(dtype), _autocast(x.device, dtype):
            outs = inet(x, step, generator=gen)
            pose_pert = outs["dec_pose"].clone()
            pose_pert[:, 3] = prepared_batch["yaw_perturbed"][: x.shape[0]]
            xrec_pert = inet.perturbed_pose_forward(x, pose_pert, generator=gen)
        return {
            "inputs_rgb": x.float().cpu().numpy(),
            "reconstructions_rgb": outs["dec_obj"].float().cpu().numpy(),
            "perturbed_pose_reconstruction_rgb": xrec_pert.float().cpu().numpy(),
        }

    # -- main loops ---------------------------------------------------------------

    def fit(self, datamodule) -> None:
        m = self.model
        self._build_fns()
        self._ckpt_mgr = self._checkpoint_manager(self.ckptdir)
        datamodule.setup()
        self.state = create_train_state(
            m, m.learning_rate, grad_clip=self.gradient_clip_val, seed=self.seed,
            device=self.device, accumulate_grad_batches=self.accumulate_grad_batches,
            zero1=self.zero1_optimizer_sharding, fsdp=self.fsdp_parameter_sharding,
        )
        if self.resume_from_checkpoint:
            self._checkpoint_manager(self._resume_dir()).restore(self.state)
            logging.info("Resumed from step %d", self.global_batch())
        handlers = save_on_signal(self._on_signal)
        try:
            for cb in self.callbacks:
                cb.on_fit_start(self)
            done = False
            for epoch in range(self.epoch, self.max_epochs):
                self.epoch = epoch
                for cb in self.callbacks:
                    cb.on_epoch_start(self)
                done = self._train_epoch(datamodule)
                if (epoch + 1) % self.check_val_every_n_epoch == 0:
                    self.validate(datamodule)
                for cb in self.callbacks:
                    cb.on_epoch_end(self)
                self.save_last_checkpoint(drain=False)  # an async write overlaps
                if done:
                    break
        except KeyboardInterrupt:
            self.interrupted = True
            logging.info("Interrupted; saving last checkpoint.")
            self.save_after_failure()
        except Exception as e:
            for cb in self.callbacks:
                cb.on_exception(self, e)
            self.save_after_failure()
            raise
        finally:
            self._stop_profiler()
            restore_signals(handlers)
            datamodule.teardown()
        if not self.interrupted:
            self.save_last_checkpoint()

    def _train_epoch(self, datamodule) -> bool:
        """One epoch of train steps; True when ``max_steps`` is reached."""
        loader = datamodule.train_dataloader()
        batches = _device_prefetch(loader, self.model, self.device)
        t = self.timings
        with contextlib.closing(loader), contextlib.closing(batches):
            t0, other0 = time.perf_counter(), t["image_log_s"] + t["checkpoint_s"]
            for prepared in batches:
                phase = self._phase_for(self.global_batch())
                self._maybe_profile(start=True)
                self.state, metrics = self._train_fns[phase](self.state, prepared)
                self._maybe_profile(start=False)
                step = self.global_batch()
                if self.logger and self.is_main_process and step % self.log_every_n == 0:
                    self.logger.log_metrics(_host_metrics(metrics), step)
                if self.world.size > 1 and any_rank(self._signalled):
                    self._signalled = False
                    self.save_last_checkpoint()
                # Lightning's every_n_train_steps counts optimizer steps:
                # with accumulation k it fires once per k micro-batches,
                # labelled with the optimizer step
                opt_step = step // self.accumulate_grad_batches
                if (self.every_n_train_steps and opt_step % self.every_n_train_steps == 0
                        and opt_step != self._last_trainstep_saved):
                    t1 = time.perf_counter()
                    self._ckpt_mgr.save_trainstep(opt_step, self.state)
                    t["checkpoint_s"] += time.perf_counter() - t1
                    self._last_trainstep_saved = opt_step
                for cb in self.callbacks:
                    cb.on_train_batch_end(self, metrics, prepared)
                # the iteration's wall time, image logging and checkpoint
                # saves excluded
                t1, other1 = time.perf_counter(), t["image_log_s"] + t["checkpoint_s"]
                t["step_s"].append(t1 - t0 - (other1 - other0))
                t0, other0 = t1, other1
                if self.max_steps and step >= self.max_steps:
                    return True
        return False

    @torch.no_grad()
    def validate(self, datamodule, split: str = "val") -> Dict[str, float]:
        """Means over the split's samples (each batch's means weighted by
        its size), logged, and for ``val`` the best-checkpoint save. In a
        process group each rank evaluates its shard and the eval step's
        metrics are the ranks' means, so every rank returns the global
        means."""
        limit = self.limit_val_batches if split == "val" else self.limit_test_batches
        if limit == 0:
            return {}
        t0, logged = time.perf_counter(), self.timings["image_log_s"]
        eval_fn = self._eval_fn_for(split)
        loader = datamodule.val_dataloader() if split == "val" else datamodule.test_dataloader()
        gen = self._generator(1)
        agg: Optional[Dict[str, torch.Tensor]] = None
        n_samples = 0
        self.val_batch_idx = 0
        batches = _device_prefetch(itertools.islice(loader, limit), self.model, self.device)
        with contextlib.closing(loader), contextlib.closing(batches):
            for prepared in batches:
                bsz = int(next(iter(prepared.values())).shape[0])
                metrics = eval_fn(self.state, prepared, generator=gen)
                weighted = {k: bsz * torch.as_tensor(v, dtype=torch.float32) for k, v in metrics.items()}
                agg = weighted if agg is None else {k: agg[k] + weighted[k] for k in agg}
                n_samples += bsz
                for cb in self.callbacks:
                    cb.on_validation_batch_end(self, metrics, prepared)
                self.val_batch_idx += 1
        means = ({k: v / n_samples for k, v in _host_metrics(agg).items()} if n_samples else {})
        # image logging excluded, as from the steps' times
        self.timings["validation_s"] += (time.perf_counter() - t0
                                         - (self.timings["image_log_s"] - logged))
        if self.logger and self.is_main_process and means:
            self.logger.log_metrics(means, self.global_batch())
        # best checkpoints read the val monitor only: a test pass never
        # ranks them
        if split == "val" and means and self._ckpt_mgr is not None and self.monitor in means:
            t1 = time.perf_counter()
            self._ckpt_mgr.save_best(self.global_batch(), self.state, means)
            self.timings["checkpoint_s"] += time.perf_counter() - t1
        return means

    def test(self, datamodule) -> Dict[str, float]:
        return self.validate(datamodule, split="test")

    # -- predict ------------------------------------------------------------------

    def _params_for_inference(self):
        """(network, step) for forward-only loops: the live state's (under
        FSDP gathered whole, on every rank), else the network of
        ``resume_from_checkpoint`` (read without the optimizers' moments),
        else a fresh seeded one with ``ckpt_path``'s weights over it when the
        model has one."""
        if self.state is not None:
            return self._full_net(), self.state.step
        m = self.model
        if self.resume_from_checkpoint:
            restored = self._checkpoint_manager(self._resume_dir()).restore_params()
            net = m.build_net()
            net.load_state_dict(restored["net"])
            return net.to(self.device, memory_format=torch.channels_last), restored["step"]
        net = flax_like_net(m, torch.Generator().manual_seed(self.seed), self.device)
        m.maybe_init_from_ckpt(net)
        return net, 0

    @torch.no_grad()
    def predict(self, datamodule, limit_batches: Optional[int] = None) -> List[Dict[str, Any]]:
        """Lightning's default predict loop: one forward a
        ``predict_dataloader`` batch, posterior modes, the 'full' phase, the
        remaining draws from a generator seeded ``seed + 2``, through
        ``model.inference_net``. Returns per batch a dict of numpy
        ``dec_obj`` and ``dec_pose`` (the plain family: ``dec_obj``); in a
        process group, of this rank's shard."""
        m = self.model
        if not getattr(datamodule, "datasets", None):
            datamodule.setup()
        net, step = self._params_for_inference()
        net = m.inference_net(net)
        plain = self._plain()
        gen = self._generator(2)
        dtype = m.compute_dtype
        outputs = []
        loader = datamodule.predict_dataloader()
        batches = _device_prefetch(itertools.islice(loader, limit_batches), m, self.device)
        with contextlib.closing(loader), contextlib.closing(batches):
            for prepared in batches:
                with compute_precision(dtype), _autocast(self.device, dtype):
                    if plain:
                        outs = net(prepared["image"], sample_posterior=False)
                    else:
                        outs = net(prepared["rgb_gt"], self._global_step_for_phase(step),
                                   sample_posterior=False, phase="full", generator=gen)
                keys = ("dec_obj",) if plain else ("dec_obj", "dec_pose")
                outputs.append({k: outs[k].float().cpu().numpy() for k in keys})
        return outputs
