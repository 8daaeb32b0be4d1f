"""Trainer callbacks (``train/callbacks.py`` of the JAX package; the
reference's ``src/util/callbacks.py``).

- ``SetupCallback``: run directories, config snapshots, and a checkpoint when
  the fit raises;
- ``ImageLogger``: input, reconstruction and perturbed-pose reconstruction
  grids at log-spaced steps, as PNG files and to the logger;
- ``DeviceStatsCallback``: each epoch's wall time and the card's memory
  (``torch.cuda`` memory statistics), the reference's ``CUDACallback``;
- ``LearningRateCallback``, ``ProgressCallback``, ``CheckpointCallback``:
  stand-ins for the Lightning callbacks the reference's YAMLs name.

In a process group every rank runs the callbacks (so a hook may take part in
a collective), and those that write files, images or log lines do it on
rank 0 alone. ``SetupCallback.on_exception``'s checkpoint is taken in one
process only (``Trainer.save_after_failure``): saves are collective.
"""

from __future__ import annotations

import logging
import os
import struct
import time
import zlib
from typing import Any, Dict, Optional

import numpy as np
import torch
import yaml


def _main(trainer) -> bool:
    """Rank 0 of the trainer's process group (Lightning's
    ``rank_zero_only``); True for one process."""
    return getattr(trainer, "is_main_process", True)


class Callback:
    def on_fit_start(self, trainer) -> None: ...

    def on_train_batch_end(self, trainer, metrics: Dict[str, Any], batch) -> None: ...

    def on_validation_batch_end(self, trainer, metrics: Dict[str, Any], batch) -> None: ...

    def on_epoch_start(self, trainer) -> None: ...

    def on_epoch_end(self, trainer) -> None: ...

    def on_exception(self, trainer, exc: BaseException) -> None: ...


class SetupCallback(Callback):
    def __init__(self, resume=None, now="", logdir="logs", ckptdir=None, cfgdir=None,
                 config=None, lightning_config=None, **_: Any):
        self.resume = resume
        self.now = now
        self.logdir = logdir
        self.ckptdir = ckptdir or os.path.join(logdir, "checkpoints")
        self.cfgdir = cfgdir or os.path.join(logdir, "configs")
        self.config = config or {}
        self.lightning_config = lightning_config or {}

    def on_fit_start(self, trainer) -> None:
        from ..config import to_plain

        if not _main(trainer):
            return  # rank 0 alone writes the run's files
        for d in (self.logdir, self.ckptdir, self.cfgdir):
            os.makedirs(d, exist_ok=True)
        with open(os.path.join(self.cfgdir, f"{self.now}-project.yaml"), "w") as f:
            yaml.safe_dump(to_plain(self.config), f)
        with open(os.path.join(self.cfgdir, f"{self.now}-lightning.yaml"), "w") as f:
            yaml.safe_dump(to_plain({"lightning": self.lightning_config}), f)

    def on_exception(self, trainer, exc: BaseException) -> None:
        logging.info("Exception during fit; summoning checkpoint.")
        trainer.save_after_failure()


def _to_uint8(img: np.ndarray, clamp: bool = True) -> np.ndarray:
    if clamp:
        img = np.clip(img, -1.0, 1.0)
    return ((img + 1.0) * 127.5).astype(np.uint8)


def make_grid(images: np.ndarray, nrow: int = 4, pad: int = 2) -> np.ndarray:
    """(N, H, W, C) -> one (H', W', C) grid (torchvision ``make_grid``'s
    layout)."""
    n, h, w, c = images.shape
    ncol = min(nrow, n)
    nr = int(np.ceil(n / ncol))
    grid = np.zeros((nr * (h + pad) + pad, ncol * (w + pad) + pad, c), images.dtype)
    for i in range(n):
        r, col = divmod(i, ncol)
        y0 = pad + r * (h + pad)
        x0 = pad + col * (w + pad)
        grid[y0 : y0 + h, x0 : x0 + w] = images[i]
    return grid


def write_png(path: str, img: np.ndarray) -> None:
    """Write an (H, W, 1 or 3) uint8 image as a PNG with zlib alone."""
    h, w, c = img.shape
    color = {1: 0, 3: 2}[c]
    rows = b"".join(b"\x00" + img[y].tobytes() for y in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        body = tag + data
        return struct.pack(">I", len(data)) + body + struct.pack(">I", zlib.crc32(body))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(rows, 6)))
        f.write(chunk(b"IEND", b""))


class ImageLogger(Callback):
    def __init__(self, batch_frequency: int = 1000, max_images: int = 4, clamp: bool = True,
                 increase_log_steps: bool = True, disable_local_logging: bool = False, **_: Any):
        self.batch_freq = max(batch_frequency, 1)
        self.max_images = max_images
        self.clamp = clamp
        self.disable_local = disable_local_logging
        # log-spaced steps up to batch_freq, as the reference's
        if increase_log_steps:
            self.log_steps = [2**n for n in range(int(np.log2(self.batch_freq)) + 1)]
        else:
            self.log_steps = [self.batch_freq]

    def check_frequency(self, step: int) -> bool:
        return step % self.batch_freq == 0 or step in self.log_steps

    def _log(self, trainer, batch, split: str) -> None:
        if not _main(trainer) and not trainer.params_sharded():
            return  # rank 0 alone logs images (its forward is local: no collective)
        t0 = time.perf_counter()
        step = trainer.global_batch()
        # under FSDP every rank gathers the weights, rank 0 alone gets images
        images = trainer.log_images(batch, max_images=self.max_images)
        for name, arr in images.items():
            grid = make_grid(_to_uint8(np.asarray(arr), self.clamp))
            if not self.disable_local:
                root = os.path.join(trainer.logdir, "images", split)
                os.makedirs(root, exist_ok=True)
                write_png(os.path.join(root, f"{name}_gs-{step:06}_e-{trainer.epoch:06}.png"), grid)
            if trainer.logger is not None:
                trainer.logger.log_image_grid(f"{split}/{name}", grid, step)
        trainer.timings["image_log_s"] += time.perf_counter() - t0

    def on_train_batch_end(self, trainer, metrics, batch) -> None:
        if self.check_frequency(trainer.global_batch()):
            self._log(trainer, batch, "train")

    def on_validation_batch_end(self, trainer, metrics, batch) -> None:
        if trainer.val_batch_idx == 0:
            self._log(trainer, batch, "val")


class DeviceStatsCallback(Callback):
    """Each epoch's wall time and the card's memory in use and at its peak
    (the reference's ``CUDACallback``)."""

    def __init__(self, **_: Any):
        self._t0 = None

    def on_epoch_start(self, trainer) -> None:
        self._t0 = time.time()

    def on_epoch_end(self, trainer) -> None:
        if self._t0 is None or not _main(trainer):
            return
        dt = time.time() - self._t0
        stats = {}
        if trainer.device.type == "cuda":
            stats = {
                "device_bytes_in_use": torch.cuda.memory_allocated(trainer.device),
                "device_peak_bytes": torch.cuda.max_memory_allocated(trainer.device),
            }
        logging.info("Epoch %d time %.2fs; device mem %s", trainer.epoch, dt, stats or "n/a")
        if trainer.logger is not None:
            trainer.logger.log_metrics({"epoch_time_s": dt, **stats}, trainer.global_batch())


class LearningRateCallback(Callback):
    def __init__(self, logging_interval: str = "step", **_: Any):
        self.logging_interval = logging_interval

    def on_train_batch_end(self, trainer, metrics, batch) -> None:
        if (trainer.logger is not None and _main(trainer)
                and trainer.global_batch() % trainer.log_every_n == 0):
            trainer.logger.log_metrics({"lr-Adam": trainer.model.learning_rate},
                                       trainer.global_batch())


class ProgressCallback(Callback):
    def __init__(self, refresh_rate: int = 1, process_position: int = 0, **_: Any):
        self.refresh_rate = max(refresh_rate, 1)
        self._t0 = time.time()

    def on_train_batch_end(self, trainer, metrics, batch) -> None:
        step = trainer.global_batch()
        if _main(trainer) and step % (self.refresh_rate * 50) == 0:
            ae = metrics.get("aeloss")
            rate = step / max(time.time() - self._t0, 1e-9)
            logging.info("epoch %d step %d aeloss %.4f (%.2f it/s)", trainer.epoch, step,
                         float(ae) if ae is not None else float("nan"), rate)


class CheckpointCallback(Callback):
    """Lightning ``ModelCheckpoint``'s configuration; the trainer owns the
    checkpoint manager and reads ``every_n_train_steps`` from here."""

    def __init__(self, dirpath: Optional[str] = None, filename: str = "{epoch:06}",
                 verbose: bool = True, save_last: bool = True, save_weights_only: bool = True,
                 monitor: Optional[str] = None, save_top_k: int = 3,
                 every_n_train_steps: Optional[int] = None, **_: Any):
        self.dirpath = dirpath
        self.monitor = monitor
        self.save_top_k = save_top_k
        self.save_last = save_last
        self.every_n_train_steps = every_n_train_steps
