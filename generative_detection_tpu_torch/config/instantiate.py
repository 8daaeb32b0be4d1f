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

# Target prefixes of the JAX package and the reference that later slices
# port, with the slice that brings them.
NOT_PORTED: dict[str, str] = {
    "src.models.autoencoder.Autoencoder": "the plain-autoencoder slice",
    "generative_detection_tpu.models.autoencoder.Autoencoder": "the plain-autoencoder slice",
    "src.modules.losses": "the plain-autoencoder slice",
    "generative_detection_tpu.losses": "the plain-autoencoder slice",
    "src.data": "the data slice",
    "generative_detection_tpu.data": "the data slice",
    "src.util.callbacks": "the trainer slice",
    "generative_detection_tpu.train": "the trainer slice",
    "pytorch_lightning": "the trainer slice",
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
