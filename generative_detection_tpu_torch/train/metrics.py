"""Scalar and image logging (``train/metrics.py`` of the JAX package): JSONL
always, TensorBoard when ``torch.utils.tensorboard`` imports, and a wandb
backend that falls back to wandb's run-directory layout when the ``wandb``
package is absent. In a process group the logger lives on rank 0 only
(``make_logger`` returns None elsewhere); the values it receives are the
ranks' means.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Any, Dict

import numpy as np


def _to_float(v: Any) -> float:
    try:
        return float(v)
    except (TypeError, ValueError):
        return float("nan")


class MetricsLogger:
    """JSONL scalar logger (and TensorBoard when ``torch.utils.tensorboard``
    imports). Takes the reference TensorBoardLogger's keywords (``name``,
    ``save_dir``)."""

    def __init__(self, save_dir: str = "logs", name: str = "metrics", **_: Any):
        self.save_dir = save_dir
        os.makedirs(save_dir, exist_ok=True)
        self.path = os.path.join(save_dir, f"{name}.jsonl")
        self._file = open(self.path, "a", buffering=1)
        self._tb = None
        try:
            from torch.utils.tensorboard import SummaryWriter

            self._tb = SummaryWriter(log_dir=os.path.join(save_dir, "tb"))
        except ImportError:
            logging.debug("TensorBoard unavailable; JSONL only")

    def log_metrics(self, metrics: Dict[str, Any], step: int) -> None:
        row = {"step": int(step), "time": time.time()}
        row.update({k: _to_float(v) for k, v in metrics.items()})
        self._file.write(json.dumps(row) + "\n")
        if self._tb is not None:
            for k, v in row.items():
                if k not in ("step", "time") and np.isfinite(v):
                    self._tb.add_scalar(k, v, step)

    def log_image_grid(self, tag: str, grid_hw3: np.ndarray, step: int) -> None:
        if self._tb is not None:
            self._tb.add_image(tag, grid_hw3, step, dataformats="HWC")

    def close(self) -> None:
        self._file.close()
        if self._tb is not None:
            self._tb.close()


class WandbLogger(MetricsLogger):
    """wandb backend behind the reference's logger surface (Lightning's
    ``WandbLogger`` with ``name``/``offline``).

    Uses the ``wandb`` package when it imports (``offline=True`` maps to
    ``mode="offline"``). Without it, writes wandb's run-directory layout,
    ``wandb/run-<name>/files/wandb-history.jsonl`` (one JSON row a call,
    ``_step``/``_timestamp`` keys) and ``config.yaml``, so the run can be
    synced later. The JSONL (and TensorBoard) logging of the base class runs
    in both cases."""

    def __init__(
        self,
        save_dir: str = "logs",
        name: str = "run",
        offline: bool = False,
        project: str = "generative-detection",
        config: Dict[str, Any] | None = None,
        **kw: Any,
    ):
        super().__init__(save_dir=save_dir, name="metrics", **kw)
        self._wandb_run = None
        self._history = None
        try:
            import wandb
        except ImportError:
            wandb = None
        if wandb is not None:
            self._wandb_run = wandb.init(
                project=project, name=name, dir=save_dir,
                mode="offline" if offline else "online", config=config or {},
            )
        else:
            run_dir = os.path.join(save_dir, "wandb", f"run-{name}", "files")
            os.makedirs(run_dir, exist_ok=True)
            self._history = open(os.path.join(run_dir, "wandb-history.jsonl"), "a", buffering=1)
            if config:
                import yaml

                with open(os.path.join(run_dir, "config.yaml"), "w") as f:
                    yaml.safe_dump(config, f)
            logging.info("wandb not installed; writing run files to %s", run_dir)

    def log_metrics(self, metrics: Dict[str, Any], step: int) -> None:
        super().log_metrics(metrics, step)
        row = {k: _to_float(v) for k, v in metrics.items()}
        if self._wandb_run is not None:
            self._wandb_run.log(row, step=int(step))
        else:
            row["_step"] = int(step)
            row["_timestamp"] = time.time()
            self._history.write(json.dumps(row) + "\n")

    def close(self) -> None:
        if self._wandb_run is not None:
            self._wandb_run.finish()
        if self._history is not None:
            self._history.close()
        super().close()


def make_logger(lightning_config, logdir: str, nowname: str = "run"):
    """The config-selected logger: ``MetricsLogger`` by default, with
    ``lightning.logger`` deep-merged over it, so a config naming the
    reference's ``pytorch_lightning.loggers.WandbLogger`` (or the JAX
    package's targets) selects that backend. None off rank 0 of a process
    group."""
    from ..config import instantiate_from_config
    from ..parallel.mesh import world

    if world().rank != 0:
        return None
    from ..config.merge import deep_merge

    default_cfg = {"target": f"{__name__}.MetricsLogger", "params": {}}
    user_cfg = dict((lightning_config or {}).get("logger", {}) or {})
    cfg = deep_merge(default_cfg, user_cfg)
    cfg.setdefault("params", {})
    cfg["params"].setdefault("save_dir", logdir)
    # `name` is the wandb run's name but the JSONL file's name otherwise
    if "WandbLogger" in str(cfg.get("target", "")):
        cfg["params"].setdefault("name", nowname)
    else:
        cfg["params"].setdefault("name", "metrics")
    return instantiate_from_config(cfg)
