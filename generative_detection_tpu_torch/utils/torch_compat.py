"""Reference checkpoints in and out: the reference's ``.ckpt`` layout and the
port's modules.

The port's modules use the reference's ldm key layout (``encoder.down.0.
block.1.conv1.weight``, ``pose_decoder.layers.0.weight``, ...), so a
reference ``PoseAutoencoder`` checkpoint is a native ``load_state_dict``
here: what the JAX package converts into flax trees
(``utils/torch_compat.py:221-256`` there) is only read and filtered. The
other direction writes the reference layout back, as the JAX package's
``export_pose_autoencoder`` and ``save_torch_checkpoint`` (``:351-392``
there): the network, ``loss.logvar`` and the discriminator at taming's
``loss.discriminator.main.{idx}``, LPIPS left out, and the discriminator's
BatchNorm buffers written as fresh defaults (the port's ``BatchStatsNorm``
normalizes by batch statistics and keeps no running ones).
"""

from __future__ import annotations

import logging
from typing import Dict, Iterable, Mapping, Optional

import numpy as np
import torch
from torch import nn

LOSS_PREFIX = "loss."
# taming's NLayerDiscriminator (n_layers = 3): the BatchNorm indices of ``main``
_DISC_BN_IDX = (3, 6, 9)


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """The state_dict of a ``.ckpt``/``.pth`` file on the CPU: the
    ``state_dict`` entry of a Lightning checkpoint, else the file's dict
    itself (``blob.get("state_dict", blob)``). Values become tensors. The
    file is unpickled in full (a Lightning checkpoint holds more than
    tensors): read only checkpoints you trust."""
    blob = torch.load(path, map_location="cpu", weights_only=False)
    sd = blob.get("state_dict", blob) if isinstance(blob, dict) else blob
    return {k: torch.as_tensor(v) for k, v in sd.items()}


def filter_ignore_keys(sd: Mapping[str, torch.Tensor],
                       ignore_keys: Iterable[str]) -> Dict[str, torch.Tensor]:
    """``sd`` without the keys that start with any of ``ignore_keys`` (ldm's
    ``init_from_ckpt`` semantics), each dropped key logged."""
    ignore = tuple(ignore_keys)
    out = {}
    for k, v in sd.items():
        if any(k.startswith(ik) for ik in ignore):
            logging.info("Deleting key %s from state_dict.", k)
            continue
        out[k] = v
    return out


def split_loss(sd: Mapping[str, torch.Tensor]):
    """(the network's entries, the loss's entries without ``loss.``)."""
    net = {k: v for k, v in sd.items() if not k.startswith(LOSS_PREFIX)}
    loss = {k[len(LOSS_PREFIX):]: v for k, v in sd.items() if k.startswith(LOSS_PREFIX)}
    return net, loss


def load_overlay(module: nn.Module, sd: Mapping[str, torch.Tensor], what: str) -> None:
    """``module.load_state_dict(sd, strict=False)`` (ldm's overlay): the
    entries land in the module's dtype and on its device; a shape that
    differs raises; missing and unexpected keys are logged."""
    missing, unexpected = module.load_state_dict(dict(sd), strict=False)
    logging.info("Restored %s from checkpoint: %d keys, %d missing, %d unexpected",
                 what, len(sd), len(missing), len(unexpected))
    if missing:
        logging.info("Missing keys of %s: %s", what, missing)
    if unexpected:
        logging.info("Unexpected keys of %s: %s", what, unexpected)


def _host(t: torch.Tensor) -> torch.Tensor:
    """A CPU copy, float32 where floating."""
    dtype = torch.float32 if t.is_floating_point() else t.dtype
    return t.detach().to(device="cpu", dtype=dtype, copy=True)


def export_pose_autoencoder(net: nn.Module, loss: Optional[nn.Module] = None
                            ) -> Dict[str, torch.Tensor]:
    """A ``PoseAutoencoderNet`` (and its ``PoseLoss``) as a reference
    ``PoseAutoencoder`` state_dict: float32 CPU tensors, the network's keys
    as they are, ``loss.logvar``, the discriminator's, its BatchNorm buffers
    as fresh defaults; LPIPS (``loss.perceptual_loss.*``) is left out, as
    the JAX package's export leaves it (the reference loads with
    strict=False)."""
    sd = {k: _host(v) for k, v in net.state_dict().items()}
    if loss is not None:
        lsd = loss.state_dict()
        if "logvar" in lsd:
            sd[LOSS_PREFIX + "logvar"] = _host(lsd["logvar"]).reshape(())
        for k, v in lsd.items():
            if k.startswith("discriminator."):
                sd[LOSS_PREFIX + k] = _host(v)
        for idx in _DISC_BN_IDX:
            key = f"{LOSS_PREFIX}discriminator.main.{idx}"
            if f"{key}.weight" in sd:
                c = sd[f"{key}.weight"].shape[0]
                sd[f"{key}.running_mean"] = torch.zeros(c)
                sd[f"{key}.running_var"] = torch.ones(c)
                sd[f"{key}.num_batches_tracked"] = torch.tensor(0, dtype=torch.int64)
    return sd


def save_torch_checkpoint(path: str, sd: Mapping, global_step: int = 0) -> None:
    """Write a Lightning-style ``.ckpt`` that the reference's
    ``init_from_ckpt`` (and ``torch.load``) reads: ``{'state_dict',
    'global_step'}``. Values may be tensors or numpy arrays."""
    torch.save(
        {
            "state_dict": {k: torch.as_tensor(np.array(v, copy=True)
                                              if isinstance(v, np.ndarray) else v)
                           for k, v in sd.items()},
            "global_step": int(global_step),
        },
        path,
    )
