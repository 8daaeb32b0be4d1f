"""OD-VAE training entry point on the port (the root ``train.py`` of the JAX
package, with the same surface)::

    python -m generative_detection_tpu_torch.train_cli \\
        -b configs/autoencoder/pose/synthetic_smoke.yaml -t

``-b`` base YAMLs (merged left to right, then ``a.b=c`` dotlist overrides),
``-t`` train, ``-r LOGDIR`` resume from a run directory (or a checkpoint
directory), ``-n`` name, ``-s`` seed, ``-p`` project, ``-f`` postfix, ``-l``
log root, ``-d`` debug, ``--scale_lr``, ``--devices``, ``--max_steps``,
``--max_epochs``, ``--no-test``. ``--device {cuda,cpu}`` picks where to
train and wins over the config; without it ``lightning.trainer.accelerator:
cpu`` in the config (``plain_kl_tiny.yaml`` has it) selects the
CPU, anything else the card. The YAMLs' targets name the JAX package or the
reference; ``config.TARGET_ALIASES`` maps them onto the port. The
``lightning.trainer`` keys pass through to the ``Trainer`` by name.

Several cards (Lightning's DDP in the reference: one process a card, each at
the config's ``batch_size``, so the global batch is N times it):

- inside a world launched by ``torchrun --nproc_per_node N`` or ``srun``,
  every rank joins the process group first (``parallel.maybe_initialize``);
  ``--devices`` / ``lightning.trainer.devices``, when given, must equal the
  world size;
- ``lightning.trainer.devices: N`` (or ``--devices N``) with N > 1 outside a
  launched world spawns N ranks of this CLI on this host, on a free port,
  and waits for them (``parallel.multihost.spawn_ranks``; a rank that fails
  stops the others; ``GDT_SPAWN_TIMEOUT`` seconds bound the wait). The
  spawning process trains nothing and ``main`` returns None there.

The ranks agree on rank 0's run name; rank 0 alone writes the run's files,
logs and images; checkpoints are collective.
"""

from __future__ import annotations

import argparse
import datetime
import glob
import logging
import os
import signal
import sys
from typing import Optional, Sequence

from .config import instantiate_from_config, merge_configs, to_plain
from .parallel.mesh import broadcast_object, world
from .parallel.multihost import maybe_initialize, shutdown, spawn_ranks
from .utils.misc import log_opts


def get_parser(**kwargs):
    def str2bool(v):
        if isinstance(v, bool):
            return v
        if v.lower() in ("yes", "true", "t", "y", "1"):
            return True
        if v.lower() in ("no", "false", "f", "n", "0"):
            return False
        raise argparse.ArgumentTypeError("Boolean value expected.")

    p = argparse.ArgumentParser(**kwargs)
    p.add_argument("--logging_level", type=str, default="INFO",
                   choices=["DEBUG", "INFO", "WARNING", "ERROR", "CRITICAL"])
    p.add_argument("-n", "--name", type=str, const=True, default="test", nargs="?")
    p.add_argument("-r", "--resume", type=str, const=True, default="", nargs="?")
    p.add_argument("-b", "--base", nargs="*", metavar="base_config.yaml", default=list())
    p.add_argument("-t", "--train", type=str2bool, const=True, default=False, nargs="?")
    p.add_argument("--no-test", type=str2bool, const=True, default=False, nargs="?")
    p.add_argument("-p", "--project", help="name of new or path to existing project")
    p.add_argument("-d", "--debug", type=str2bool, nargs="?", const=True, default=False)
    p.add_argument("-s", "--seed", type=int, default=23)
    p.add_argument("-f", "--postfix", type=str, default="")
    p.add_argument("-l", "--logdir", type=str, default="logs")
    p.add_argument("--scale_lr", type=str2bool, nargs="?", const=True, default=True,
                   help="scale base-lr by ndevices * batch_size * n_accumulate")
    p.add_argument("--devices", type=int, default=None,
                   help="number of cards, one process each (default: the config's "
                        "lightning.trainer.devices, else one)")
    p.add_argument("--max_steps", type=int, default=None)
    p.add_argument("--max_epochs", type=int, default=None)
    p.add_argument("--device", choices=("cuda", "cpu"), default=None,
                   help="train on the card or on the CPU; given, it wins over the "
                        "config's lightning.trainer.accelerator (default: cpu where the "
                        "config says accelerator: cpu, else cuda)")
    return p


def get_nowname(opt, now):
    """The run directory's name, and the resume's checkpoint, configs and
    run directory (``opt.resume_logdir``: a resumed run continues in its own
    directory, as the reference's ldm ``main.py`` does)."""
    if opt.resume:
        if not os.path.exists(opt.resume):
            raise ValueError(f"Cannot find {opt.resume}")
        if os.path.isfile(opt.resume):
            paths = opt.resume.split("/")
            logdir = "/".join(paths[:-2])
            ckpt = opt.resume
        else:
            logdir = opt.resume.rstrip("/")
            ckpt = os.path.join(logdir, "checkpoints")
        opt.resume_from_checkpoint = ckpt
        opt.resume_logdir = logdir
        base_configs = sorted(glob.glob(os.path.join(logdir, "configs/*.yaml")))
        opt.base = base_configs + opt.base
        nowname = logdir.split("/")[-1]
    else:
        opt.resume_from_checkpoint = None
        if opt.name and opt.name is not True:
            name = "_" + opt.name
        elif opt.base:
            name = "_" + os.path.splitext(os.path.split(opt.base[0])[-1])[0]
        else:
            name = ""
        nowname = now + name + opt.postfix
    return opt, nowname


def configure_learning_rate(config, model, trainer_cfg, opt, ndevices):
    """lr = accumulate * ndevices * batch_size * base_lr (ldm's scaling)."""
    bs = config["data"]["params"]["batch_size"]
    base_lr = config["model"].get("base_learning_rate", 4.5e-6)
    accumulate = trainer_cfg.get("accumulate_grad_batches", 1)
    if opt.scale_lr:
        model.learning_rate = accumulate * ndevices * bs * base_lr
        logging.info(
            "Setting learning rate to %.2e = %d (accum) * %d (devices) * %d (bs) * %.2e (base_lr)",
            model.learning_rate, accumulate, ndevices, bs, base_lr,
        )
    else:
        model.learning_rate = base_lr
        logging.info("++++ NOT USING LR SCALING ++++ lr = %.2e", base_lr)
    return model


# Trainer arguments that main() sets itself; every other lightning.trainer
# key passes through by name (the Trainer ignores Lightning keys it does not
# model: gpus, precision, ...)
_EXPLICIT = {
    "max_epochs", "max_steps", "accumulate_grad_batches", "gradient_clip_val",
    "limit_val_batches", "log_every_n_steps", "check_val_every_n_epoch", "profiler_dir",
    "disc_forward", "step_counting", "detect_anomaly", "devices", "accelerator", "device",
    "logdir", "callbacks", "logger", "seed", "monitor", "resume_from_checkpoint",
}


def main(argv: Optional[Sequence[str]] = None, extra_callbacks: Sequence = ()):
    """Parse ``argv`` (default ``sys.argv[1:]``), build the model, data,
    callbacks, logger and Trainer, then fit (``-t``) and test. Returns the
    Trainer (None where it spawned the ranks of a world instead).
    ``extra_callbacks`` are appended to the configured ones. A process
    group that this call joined is left before it returns."""
    now = datetime.datetime.now().strftime("%Y-%m-%dT%H-%M-%S")
    argv = list(sys.argv[1:] if argv is None else argv)
    opt, unknown = get_parser().parse_known_args(argv)
    logging.basicConfig(level=getattr(logging, opt.logging_level))
    if opt.name != "test" and opt.resume:
        raise ValueError("-n/--name and -r/--resume cannot be specified both.")
    in_group = world().active
    w = maybe_initialize()  # a launched world: join it before any file is touched
    try:
        return _main(opt, unknown, argv, broadcast_object(now), w, extra_callbacks)
    finally:
        if w.active and not in_group:
            shutdown()


def _main(opt, unknown, argv, now, w, extra_callbacks):
    import torch

    from .train.callbacks import (
        Callback,
        DeviceStatsCallback,
        ImageLogger,
        LearningRateCallback,
        ProgressCallback,
        SetupCallback,
    )
    from .train.loop import Trainer
    from .train.metrics import make_logger

    opt, nowname = get_nowname(opt, now)
    logdir = opt.resume_logdir if opt.resume else os.path.join(opt.logdir, nowname)
    ckptdir = os.path.join(logdir, "checkpoints")
    cfgdir = os.path.join(logdir, "configs")
    log_opts(opt)

    config = merge_configs(opt.base, unknown)
    lightning_config = config.pop("lightning", {}) or {}
    trainer_cfg = dict(lightning_config.get("trainer", {}) or {})
    devices = opt.devices or trainer_cfg.get("devices")
    devices = None if devices is None else int(devices)
    if devices and devices > 1 and not w.active:
        _spawn(argv, devices)
        return None
    if opt.max_steps is not None:
        trainer_cfg["max_steps"] = opt.max_steps
    if opt.max_epochs is not None:
        trainer_cfg["max_epochs"] = opt.max_epochs
    device = opt.device or ("cpu" if trainer_cfg.get("accelerator") == "cpu" else "cuda")
    if trainer_cfg.get("detect_anomaly"):
        torch.autograd.set_detect_anomaly(True)

    model = instantiate_from_config(config["model"])
    data = instantiate_from_config(config["data"])
    data.prepare_data()
    data.setup()
    logging.info("#### Data ####")
    for k, ds in data.datasets.items():
        logging.info("%s, %s, %d", k, type(ds).__name__, len(ds))
    model = configure_learning_rate(config, model, trainer_cfg, opt, devices or w.size)

    callbacks = [
        SetupCallback(resume=opt.resume, now=now, logdir=logdir, ckptdir=ckptdir, cfgdir=cfgdir,
                      config=to_plain(config), lightning_config=to_plain(lightning_config)),
        LearningRateCallback(),
        DeviceStatsCallback(),
        ProgressCallback(),
    ]
    for name, cfg in (lightning_config.get("callbacks", {}) or {}).items():
        cb = instantiate_from_config(cfg)
        if isinstance(cb, Callback):
            callbacks.append(cb)
    if not any(isinstance(c, ImageLogger) for c in callbacks):
        callbacks.append(ImageLogger(batch_frequency=750, max_images=4))
    callbacks.extend(extra_callbacks)
    logger = make_logger(lightning_config, logdir, nowname=now)

    passthrough = {k: v for k, v in trainer_cfg.items() if k not in _EXPLICIT}
    trainer = Trainer(
        model,
        logdir=logdir,
        max_epochs=trainer_cfg.get("max_epochs", 1000),
        max_steps=trainer_cfg.get("max_steps"),
        accumulate_grad_batches=trainer_cfg.get("accumulate_grad_batches", 1),
        gradient_clip_val=trainer_cfg.get("gradient_clip_val", 1.0),
        limit_val_batches=trainer_cfg.get("limit_val_batches"),
        log_every_n_steps=trainer_cfg.get("log_every_n_steps", 50),
        check_val_every_n_epoch=trainer_cfg.get("check_val_every_n_epoch", 1),
        profiler_dir=trainer_cfg.get("profiler_dir"),
        callbacks=callbacks,
        logger=logger,
        seed=opt.seed,
        monitor=getattr(model, "monitor", None),
        resume_from_checkpoint=opt.resume_from_checkpoint,
        devices=devices,
        disc_forward=trainer_cfg.get("disc_forward", "shared"),
        step_counting=trainer_cfg.get("step_counting", "optimizer"),
        device=device,
        **passthrough,
    )

    def _divein(*_a):  # SIGUSR2: drop into the debugger
        import pdb

        pdb.set_trace()

    previous = signal.signal(signal.SIGUSR2, _divein)
    try:
        if opt.train:
            trainer.fit(data)
        if "test" in data.datasets and not opt.no_test and not trainer.interrupted:
            trainer.test(data)
    except Exception:
        if opt.debug:
            import pdb

            pdb.post_mortem()
        raise
    finally:
        signal.signal(signal.SIGUSR2, previous)
        if logger is not None:
            logger.close()
    return trainer


def _spawn(argv, devices: int) -> None:
    """This CLI as ``devices`` ranks of one world on this host, with the
    package's root on their path."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(filter(None, [root, env.get("PYTHONPATH")]))
    timeout = os.environ.get("GDT_SPAWN_TIMEOUT")
    logging.info("spawning %d ranks", devices)
    spawn_ranks(["-m", __spec__.name if __spec__ else "generative_detection_tpu_torch.train_cli",
                 *argv], devices, timeout=float(timeout) if timeout else None, env=env)


if __name__ == "__main__":
    main()
    sys.exit(0)
