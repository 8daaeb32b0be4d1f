"""JAX package parameters -> this package's ``state_dict``.

The port's own copy of ``export_pose_autoencoder``
(``utils/torch_compat.py:258-369`` of the JAX package): flax parameter trees,
handed over as nested dicts of numpy arrays, become a state_dict in the ldm
key layout that ``PoseAutoencoderNet`` uses:

- flax conv kernel (kH, kW, I, O) -> torch (O, I, kH, kW);
- flax Dense kernel (in, out) -> torch Linear (out, in);
- GroupNorm ``scale`` -> ``weight``;
- ``down_0_block_1`` -> ``down.0.block.1``, ``mid_attn_1`` -> ``mid.attn_1``;
- the pose MLPs' ``fc_*`` layers -> ``nn.Sequential`` indices.

The plain ``AutoencoderKLNet``'s ``quant_conv`` goes the same way.
``loss_state_dict_from_jax`` does the same for either loss: ``logvar``, the
discriminator's convs and norms at taming's ``main.{idx}`` (flax norm
``scale`` -> ``weight``), and the LPIPS VGG and heads at taming's names.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch

from ..models.lpips import _SCALE, _SHIFT, lpips_state_dict_from_npz

_BACKBONE_RE = [
    (r"^(down|up)_(\d+)_(block|attn)_(\d+)$", r"\1.\2.\3.\4"),
    (r"^(down|up)_(\d+)_(downsample|upsample)$", r"\1.\2.\3"),
    (r"^mid_(block|attn)_(\d+)$", r"mid.\1_\2"),
]


def _torch_name(flax_name: str) -> str:
    for pat, rep in _BACKBONE_RE:
        new, n = re.subn(pat, rep, flax_name)
        if n:
            return new
    return flax_name


def _export_leaf(tree: Mapping, key: str, sd: Dict) -> bool:
    """Write one leaf module (conv/dense via ``kernel``, norm via ``scale``)."""
    if "kernel" in tree:
        k = np.asarray(tree["kernel"])
        sd[f"{key}.weight"] = np.transpose(k, (3, 2, 0, 1)) if k.ndim == 4 else k.T
        if "bias" in tree:
            sd[f"{key}.bias"] = np.asarray(tree["bias"])
        return True
    if "scale" in tree:
        sd[f"{key}.weight"] = np.asarray(tree["scale"])
        sd[f"{key}.bias"] = np.asarray(tree["bias"])
        return True
    return False


def _export_tree(tree: Mapping, prefix: str, sd: Dict) -> None:
    for name, sub in tree.items():
        key = f"{prefix}.{_torch_name(name)}"
        if not _export_leaf(sub, key, sd):
            _export_tree(sub, key, sd)


def _export_pose_mlp(tree: Mapping, prefix: str, sd: Dict) -> None:
    """pose_decoder (has fc_in): fc_in -> layers.0, fc_i -> layers.{2i},
    fc_out -> layers.{2(n_hidden+1)}; pose_encoder: fc_i -> layers.{2i-1},
    fc_out -> layers.{2 n_hidden + 1}; coord/latent linears keep their names."""
    fcs = [n for n in tree if n.startswith("fc_") and n[3:].isdigit()]
    has_fc_in = "fc_in" in tree
    for name, sub in tree.items():
        if name == "fc_in":
            key = f"{prefix}.layers.0"
        elif name == "fc_out":
            last = 2 * (len(fcs) + 1) if has_fc_in else 2 * len(fcs) + 1
            key = f"{prefix}.layers.{last}"
        elif name in fcs:
            i = int(name[3:])
            key = f"{prefix}.layers.{2 * i if has_fc_in else 2 * i - 1}"
        else:
            key = f"{prefix}.{name}"
        _export_leaf(sub, key, sd)


def state_dict_from_jax(net_params: Mapping) -> Dict[str, torch.Tensor]:
    """``PoseAutoencoderNet`` or ``AutoencoderKLNet`` flax params (nested
    numpy dicts) -> state_dict."""
    sd: Dict = {}
    for top in ("encoder", "decoder"):
        if top in net_params:
            _export_tree(net_params[top], top, sd)
    for top in ("quant_conv_obj", "quant_conv_pose", "quant_conv", "post_quant_conv"):
        if top in net_params:
            _export_leaf(net_params[top], top, sd)
    for top in ("pose_decoder", "pose_encoder"):
        if top in net_params:
            _export_pose_mlp(net_params[top], top, sd)
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in sd.items()}


# taming's ``NLayerDiscriminator.main`` indices (n_layers = 3)
_DISC_IDX = {"conv_0": 0, "conv_1": 2, "bn_1": 3, "conv_2": 5, "bn_2": 6, "conv_3": 8,
             "bn_3": 9, "conv_out": 11}


def loss_state_dict_from_jax(loss_params: Mapping) -> Dict[str, torch.Tensor]:
    """``PoseLoss`` or ``LPIPSWithDiscriminator`` flax params (nested numpy
    dicts: ``logvar``, ``discriminator``, ``perceptual``; the two losses name
    them alike) -> the port's loss state_dict."""
    sd: Dict = {"logvar": np.asarray(loss_params["logvar"]).reshape(())}
    for name, sub in loss_params["discriminator"].items():
        _export_leaf(sub, f"discriminator.main.{_DISC_IDX[name]}", sd)
    out = {k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in sd.items()}
    perceptual = loss_params["perceptual"]
    flat = {f"vgg/{n}/{p}": v for n, leaf in perceptual["vgg"].items() for p, v in leaf.items()}
    flat.update({f"{n}/kernel": leaf["kernel"] for n, leaf in perceptual.items() if n != "vgg"})
    for k, v in lpips_state_dict_from_npz(flat).items():
        out[f"perceptual_loss.{k}"] = v
    out["perceptual_loss.scaling_layer.shift"] = torch.from_numpy(_SHIFT).reshape(1, 3, 1, 1)
    out["perceptual_loss.scaling_layer.scale"] = torch.from_numpy(_SCALE).reshape(1, 3, 1, 1)
    return out
