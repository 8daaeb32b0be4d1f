"""Config-driven object construction: ``{target: "a.b.C", params: {...}}``.

The port's counterpart of ``generative_detection_tpu/config/instantiate.py``.
The repo's YAMLs name either the reference's ``src.*`` targets or the JAX
package's ``generative_detection_tpu.*`` targets; ``TARGET_ALIASES`` maps both
onto this package's classes, so the pose and plain autoencoder configs build
port objects unchanged.
"""

from __future__ import annotations

import importlib
from typing import Any, Mapping

_PKG = "generative_detection_tpu_torch"

TARGET_ALIASES: dict[str, str] = {}
for _prefix in ("src.models.autoencoder", "generative_detection_tpu.models.autoencoder"):
    for _cls in ("PoseAutoencoder", "Autoencoder"):
        TARGET_ALIASES[f"{_prefix}.{_cls}"] = f"{_PKG}.models.autoencoder.{_cls}"
for _prefix in (
    "src.modules.autoencodermodules.pose_decoder",
    "src.modules.autoencodermodules.pose_encoder",
    "generative_detection_tpu.models.pose_modules",
):
    for _cls in ("PoseDecoderSpatialVAE", "PoseEncoderSpatialVAE"):
        TARGET_ALIASES[f"{_prefix}.{_cls}"] = f"{_PKG}.models.pose_modules.{_cls}"

for _prefix in (
    "src.modules.losses",
    "src.modules.losses.contperceptual",
    "generative_detection_tpu.losses.contperceptual",
):
    for _cls in ("PoseLoss", "LPIPSWithDiscriminator"):
        TARGET_ALIASES[f"{_prefix}.{_cls}"] = f"{_PKG}.losses.contperceptual.{_cls}"

# data: the datamodule and the datasets, under the JAX package's names and
# the reference's (``src.data.datasets.nuscenes.*``)
for _target in ("generative_detection_tpu.data.datamodule.DataModuleFromConfig",
                "src.data.preprocessing.data_modules.DataModuleFromConfig"):
    TARGET_ALIASES[_target] = f"{_PKG}.data.datamodule.DataModuleFromConfig"
_DATASETS = {
    "synthetic": ("SyntheticPatchTrain", "SyntheticPatchValidation", "SyntheticPatchTest",
                  "SyntheticImageTrain", "SyntheticImageValidation"),
    "nuscenes": ("NuScenesTrain", "NuScenesValidation", "NuScenesTest", "NuScenesTrainMini",
                 "NuScenesValidationMini"),
    "shapenet": ("ShapeNetTrain", "ShapeNetValidation", "ShapeNetTest"),
    "waymo": ("WaymoTrain", "WaymoValidation"),
}
for _module, _classes in _DATASETS.items():
    for _cls in _classes:
        TARGET_ALIASES[f"generative_detection_tpu.data.{_module}.{_cls}"] = (
            f"{_PKG}.data.{_module}.{_cls}"
        )
for _cls in _DATASETS["nuscenes"]:
    TARGET_ALIASES[f"src.data.datasets.nuscenes.{_cls}"] = f"{_PKG}.data.nuscenes.{_cls}"

# the trainer's callbacks and loggers, under the JAX package's names, the
# reference's and Lightning's
_CALLBACKS = ("Callback", "SetupCallback", "ImageLogger", "DeviceStatsCallback",
              "LearningRateCallback", "ProgressCallback", "CheckpointCallback")
for _cls in _CALLBACKS:
    TARGET_ALIASES[f"generative_detection_tpu.train.callbacks.{_cls}"] = (
        f"{_PKG}.train.callbacks.{_cls}"
    )
for _target, _cls in (
    ("src.util.callbacks.ImageLogger", "ImageLogger"),
    ("src.util.callbacks.SetupCallback", "SetupCallback"),
    ("src.util.callbacks.CUDACallback", "DeviceStatsCallback"),
    ("src.util.callbacks.DeviceStatsMonitor", "DeviceStatsCallback"),
    ("src.util.callbacks.TQDMProgressBar", "ProgressCallback"),
    ("src.util.callbacks.LearningRateMonitor", "LearningRateCallback"),
    ("pytorch_lightning.callbacks.ModelCheckpoint", "CheckpointCallback"),
):
    TARGET_ALIASES[_target] = f"{_PKG}.train.callbacks.{_cls}"
for _target, _cls in (
    ("generative_detection_tpu.train.metrics.MetricsLogger", "MetricsLogger"),
    ("generative_detection_tpu.train.metrics.WandbLogger", "WandbLogger"),
    ("pytorch_lightning.loggers.TensorBoardLogger", "MetricsLogger"),
    ("pytorch_lightning.loggers.TestTubeLogger", "MetricsLogger"),
    ("pytorch_lightning.loggers.WandbLogger", "WandbLogger"),
):
    TARGET_ALIASES[_target] = f"{_PKG}.train.metrics.{_cls}"
TARGET_ALIASES["generative_detection_tpu.train.loop.Trainer"] = f"{_PKG}.train.loop.Trainer"

def get_obj_from_str(string: str) -> Any:
    """Import ``a.b.C`` and return the attribute ``C`` of module ``a.b``."""
    module, cls = string.rsplit(".", 1)
    return getattr(importlib.import_module(module), cls)


def resolve_target(target: str) -> str:
    return TARGET_ALIASES.get(target, target)


def instantiate_from_config(config: Mapping[str, Any], **extra_kwargs: Any) -> Any:
    """Build an object from a ``{target, params}`` node; ``extra_kwargs`` are
    merged over ``params``."""
    if not isinstance(config, Mapping) or "target" not in config:
        if config in ("__is_first_stage__", "__is_unconditional__"):
            return None
        raise KeyError(f"Expected config dict with a `target` key, got: {config!r}")
    params = dict(config.get("params") or {})
    params.update(extra_kwargs)
    return get_obj_from_str(resolve_target(config["target"]))(**params)
