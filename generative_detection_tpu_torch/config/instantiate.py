"""Config-driven object construction: ``{target: "a.b.C", params: {...}}``.

The port's counterpart of ``generative_detection_tpu/config/instantiate.py``.
The repo's YAMLs name either the reference's ``src.*`` targets or the JAX
package's ``generative_detection_tpu.*`` targets; ``TARGET_ALIASES`` maps both
onto this package's classes, so the pose configs build port objects
unchanged. Targets whose port has not landed yet raise ``NotImplementedError``
naming the slice that brings them.
"""

from __future__ import annotations

import importlib
from typing import Any, Mapping

_PKG = "generative_detection_tpu_torch"

TARGET_ALIASES: dict[str, str] = {}
for _prefix in ("src.models.autoencoder", "generative_detection_tpu.models.autoencoder"):
    TARGET_ALIASES[f"{_prefix}.PoseAutoencoder"] = f"{_PKG}.models.autoencoder.PoseAutoencoder"
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
    TARGET_ALIASES[f"{_prefix}.PoseLoss"] = f"{_PKG}.losses.contperceptual.PoseLoss"

# data: the datamodule and the synthetic datasets
for _target in ("generative_detection_tpu.data.datamodule.DataModuleFromConfig",
                "src.data.preprocessing.data_modules.DataModuleFromConfig"):
    TARGET_ALIASES[_target] = f"{_PKG}.data.datamodule.DataModuleFromConfig"
for _cls in ("SyntheticPatchTrain", "SyntheticPatchValidation", "SyntheticPatchTest",
             "SyntheticImageTrain", "SyntheticImageValidation"):
    TARGET_ALIASES[f"generative_detection_tpu.data.synthetic.{_cls}"] = (
        f"{_PKG}.data.synthetic.{_cls}"
    )

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

# Target prefixes of the JAX package and the reference that later slices
# port, with the slice that brings them.
NOT_PORTED: dict[str, str] = {
    "src.models.autoencoder.Autoencoder": "the plain-autoencoder slice",
    "generative_detection_tpu.models.autoencoder.Autoencoder": "the plain-autoencoder slice",
    "src.modules.losses": "the plain-autoencoder slice",
    "generative_detection_tpu.losses": "the plain-autoencoder slice",
    "src.data": "the nuScenes slice",
    "generative_detection_tpu.data.nuscenes": "the nuScenes slice",
    "generative_detection_tpu.data.shapenet": "the nuScenes slice",
    "generative_detection_tpu.data.waymo": "the nuScenes slice",
}


def get_obj_from_str(string: str) -> Any:
    """Import ``a.b.C`` and return the attribute ``C`` of module ``a.b``."""
    module, cls = string.rsplit(".", 1)
    return getattr(importlib.import_module(module), cls)


def resolve_target(target: str) -> str:
    if target in TARGET_ALIASES:
        return TARGET_ALIASES[target]
    for prefix, later in NOT_PORTED.items():
        if target == prefix or target.startswith(prefix + "."):
            raise NotImplementedError(
                f"{target} is not ported to {_PKG} yet; it comes with {later}"
            )
    return target


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
