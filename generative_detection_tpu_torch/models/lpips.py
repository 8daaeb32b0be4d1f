"""LPIPS perceptual distance: VGG16 taps + learned linear heads
(``models/lpips.py`` of the JAX package; taming-transformers' LPIPS).

- ``ScalingLayer``: ImageNet-stat shift/scale of [-1, 1] inputs;
- VGG16 conv features with taps after relu1_2/relu2_2/relu3_3/relu4_3/relu5_3;
- per tap: channel-L2 normalisation, squared difference, 1x1 no-bias head,
  spatial mean; summed over taps.

Parameter names follow taming's layout (``net.slice{1..5}.{i}`` with
torchvision's ``features`` indices, ``lin{i}.model.1.weight``,
``scaling_layer.shift/scale``), so a reference checkpoint's
``loss.perceptual_loss.*`` keys land where they belong. The module is frozen:
no parameter requires a gradient and no optimizer sees it. Without
pretrained weights it keeps the JAX package's default, a seeded random
initialisation; ``load_lpips_weights`` overlays an ``.npz`` the caller gives.
"""

from __future__ import annotations

import hashlib
import os
from collections import OrderedDict
from typing import List, Optional

import numpy as np
import torch
from torch import nn

# VGG16 conv plan: channels per conv, 'M' = 2x2 maxpool (torchvision
# ``vgg16().features`` order), cut into taming's five slices at the taps.
_VGG16_PLAN = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M", 512, 512, 512)
_SLICE_ENDS = (4, 9, 16, 23, 30)  # slice{i} = features[prev_end:end]
_TAP_CHANNELS = (64, 128, 256, 512, 512)

_SHIFT = np.array([-0.030, -0.088, -0.188], dtype=np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], dtype=np.float32)

# The key set of a converted weight file (the JAX package's layout): 13 VGG16
# convs (kernel + bias) and 5 linear heads (kernel only).
EXPECTED_NPZ_KEYS = frozenset(
    [f"vgg/conv{i}/{p}" for i in range(1, 14) for p in ("kernel", "bias")]
    + [f"lin{i}/kernel" for i in range(5)]
)


def _features() -> List[nn.Module]:
    layers: List[nn.Module] = []
    c_in = 3
    for item in _VGG16_PLAN:
        if item == "M":
            layers.append(nn.MaxPool2d(2, 2))
        else:
            layers += [nn.Conv2d(c_in, item, 3, padding=1), nn.ReLU()]
            c_in = item
    return layers


def _conv_indices() -> List[int]:
    """torchvision ``features`` index of each of the 13 convs (conv1..conv13)."""
    return [i for i, m in enumerate(_features()) if isinstance(m, nn.Conv2d)]


class VGG16Slices(nn.Module):
    def __init__(self):
        super().__init__()
        feats = _features()
        start = 0
        for s, end in enumerate(_SLICE_ENDS, 1):
            setattr(
                self, f"slice{s}",
                nn.Sequential(OrderedDict((str(i), feats[i]) for i in range(start, end))),
            )
            start = end

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        taps = []
        for s in range(1, len(_SLICE_ENDS) + 1):
            x = getattr(self, f"slice{s}")(x)
            taps.append(x)
        return taps


class ScalingLayer(nn.Module):
    def __init__(self):
        super().__init__()
        self.register_buffer("shift", torch.from_numpy(_SHIFT).reshape(1, 3, 1, 1))
        self.register_buffer("scale", torch.from_numpy(_SCALE).reshape(1, 3, 1, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return (x - self.shift) / self.scale


class NetLinLayer(nn.Module):
    """taming's 1x1 no-bias head. Index 0 holds taming's dropout slot; the
    JAX package applies no dropout there, so it is an identity."""

    def __init__(self, channels: int):
        super().__init__()
        self.model = nn.Sequential(nn.Identity(), nn.Conv2d(channels, 1, 1, bias=False))


def _tap_distance(a: torch.Tensor, b: torch.Tensor, w: torch.Tensor,
                  eps: float = 1e-10) -> torch.Tensor:
    """mean_HW sum_c w_c (a/na - b/nb)_c^2 over NCHW taps, expanded as
    (sum w a^2)/na^2 + (sum w b^2)/nb^2 - 2 (sum w a b)/(na nb) so no
    normalised tensor is materialised (``lpips.py:47-98`` of the JAX
    package). Kept from there: the safe-sqrt ``where`` cuts the gradient
    where a tap is all zero (sqrt'(0) would be inf), and the 3e-9 norm floor
    caps the expanded backward's 1/na^4 terms below float32's range."""
    a32, b32 = a.float(), b.float()
    w = w.reshape(1, -1, 1, 1).float()
    a2 = a32.square().sum(1)
    b2 = b32.square().sum(1)
    a2w = (a32.square() * w).sum(1)
    b2w = (b32.square() * w).sum(1)
    abw = (a32 * b32 * w).sum(1)

    def safe_norm(x2):
        nz = x2 > 0.0
        raw = torch.where(nz, torch.sqrt(torch.where(nz, x2, torch.ones_like(x2))), 0.0) + eps
        return torch.clamp(raw, min=3e-9)

    na, nb = safe_norm(a2), safe_norm(b2)
    val = a2w / na.square() + b2w / nb.square() - 2.0 * abw / (na * nb)
    return val.mean(dim=(1, 2)).reshape(-1, 1, 1, 1)


class LPIPS(nn.Module):
    """``forward(inputs, recons)`` on NHWC images in [-1, 1] -> per-sample
    distance (B, 1, 1, 1) float32. Both images go through the VGG as one
    batch."""

    def __init__(self):
        super().__init__()
        self.scaling_layer = ScalingLayer()
        self.net = VGG16Slices()
        for i, c in enumerate(_TAP_CHANNELS):
            setattr(self, f"lin{i}", NetLinLayer(c))
        self.requires_grad_(False)

    def forward(self, inputs: torch.Tensor, recons: torch.Tensor) -> torch.Tensor:
        b = inputs.shape[0]
        x = torch.cat([inputs, recons]).permute(0, 3, 1, 2)
        x = self.scaling_layer(x).contiguous(memory_format=torch.channels_last)
        total = 0.0
        for i, tap in enumerate(self.net(x)):
            w = getattr(self, f"lin{i}").model[1].weight
            total = total + _tap_distance(tap[:b], tap[b:], w)
        return total.float()


def lpips_state_dict_from_npz(flat) -> dict:
    """A converted weight file's arrays (JAX layout, ``vgg/conv{i}/kernel``
    (kH, kW, I, O)) -> this module's state_dict entries."""
    convs = _conv_indices()
    sd = {}
    for i, idx in enumerate(convs, 1):
        s = next(n for n, end in enumerate(_SLICE_ENDS, 1) if idx < end)
        k = np.asarray(flat[f"vgg/conv{i}/kernel"])
        sd[f"net.slice{s}.{idx}.weight"] = np.transpose(k, (3, 2, 0, 1))
        sd[f"net.slice{s}.{idx}.bias"] = np.asarray(flat[f"vgg/conv{i}/bias"])
    for i in range(len(_TAP_CHANNELS)):
        sd[f"lin{i}.model.1.weight"] = np.transpose(np.asarray(flat[f"lin{i}/kernel"]), (3, 2, 0, 1))
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in sd.items()}


def load_lpips_weights(module: LPIPS, weights_path: str,
                       expected_sha256: Optional[str] = None) -> LPIPS:
    """Overlay converted pretrained weights (an ``.npz`` in the JAX package's
    layout) onto ``module``, with the checks of ``lpips.py:171-237`` of the
    JAX package: an optional checksum (argument or ``<path>.sha256``
    sidecar), the exact key set, and every shape."""
    if expected_sha256 is None and os.path.exists(weights_path + ".sha256"):
        with open(weights_path + ".sha256") as f:
            expected_sha256 = f.read().split()[0].strip()
    if expected_sha256:
        h = hashlib.sha256()
        with open(weights_path, "rb") as f:
            for chunk in iter(lambda: f.read(1 << 20), b""):
                h.update(chunk)
        if h.hexdigest() != expected_sha256.lower():
            raise ValueError(
                f"LPIPS weights checksum mismatch for {weights_path}: "
                f"expected {expected_sha256}, got {h.hexdigest()}"
            )
    flat = dict(np.load(weights_path))
    keys = frozenset(flat)
    if keys != EXPECTED_NPZ_KEYS:
        missing, extra = sorted(EXPECTED_NPZ_KEYS - keys), sorted(keys - EXPECTED_NPZ_KEYS)
        raise ValueError(
            f"LPIPS npz {weights_path} does not match the converter layout: "
            f"missing={missing[:5]} extra={extra[:5]}"
        )
    sd = lpips_state_dict_from_npz(flat)
    own = module.state_dict()
    for k, v in sd.items():
        if tuple(v.shape) != tuple(own[k].shape):
            raise ValueError(f"LPIPS npz entry for {k} has shape {tuple(v.shape)}, "
                             f"the module {tuple(own[k].shape)}")
    module.load_state_dict(sd, strict=False)
    return module
