"""Serving: the per-patch 3D detector, patches -> encode -> pose decode (mode)
-> 3D boxes (``serving.py`` of the JAX package).

``make_detector_fn`` closes a network into a function of the patches and the
camera arguments. It runs on the card by default, in bfloat16 unless asked
otherwise. ``export_detector``/``load_detector`` wait for a later slice: the
ctypes kernels cannot be traced by ``torch.export`` until they are registered
through ``torch.library``.
"""

from __future__ import annotations

import os
from typing import Mapping, Union

import torch
from torch import nn

from .eval.inference import pose_inference, recover_boxes
from .models.autoencoder import cast_compute_dtype


def _resolve_serve_dtype(dtype):
    """Serving compute dtype: ``"auto"`` reads ``GDT_SERVE_DTYPE`` and
    defaults to bfloat16 (the JAX package's serving default);
    ``None``/``"float32"`` keep the network's own dtype; a string or a torch
    dtype selects that dtype."""
    if dtype == "auto":
        dtype = os.environ.get("GDT_SERVE_DTYPE", "bfloat16")
    if dtype is None or dtype == "float32":
        return None
    if isinstance(dtype, str):
        dtype = getattr(torch, dtype, None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"unknown serving dtype {dtype!r}")
    return dtype


def make_detector_fn(
    model,
    state_dict_or_net: Union[Mapping[str, torch.Tensor], nn.Module],
    hmin_table,
    hmax_table,
    patch_out: int = 256,
    dtype="auto",
    device="cuda",
):
    """Return ``detect(rgb, focal, principal_point, patch_size, patch_center,
    resampling) -> (boxes_3d (B, 7), class_id (B,), score (B,))``.

    ``model`` is a ``PoseAutoencoder``; the weights come from a state_dict or
    from a network, which is copied and left as it is. In a reduced dtype,
    conv and dense weights are cast and GroupNorm affine stays float32.
    Inputs may be numpy arrays or tensors; patches are (B, H, W, 3)."""
    sd = (
        state_dict_or_net.state_dict()
        if isinstance(state_dict_or_net, nn.Module)
        else state_dict_or_net
    )
    net = model.build_net()
    cast_compute_dtype(net, model.compute_dtype)
    net.load_state_dict(sd, strict=True)
    dtype = _resolve_serve_dtype(dtype)
    if dtype is not None:
        cast_compute_dtype(net, dtype)
    net = net.to(device=device, memory_format=torch.channels_last).eval()
    hmin = torch.as_tensor(hmin_table, dtype=torch.float32, device=device)
    hmax = torch.as_tensor(hmax_table, dtype=torch.float32, device=device)

    def detect(rgb, focal, principal_point, patch_size, patch_center, resampling):
        args = [
            torch.as_tensor(a, dtype=torch.float32, device=device)
            for a in (rgb, focal, principal_point, patch_size, patch_center, resampling)
        ]
        with torch.inference_mode():
            dec_pose, _, _ = pose_inference(net, args[0])
            rec = recover_boxes(
                dec_pose, *args[1:], hmin_table=hmin, hmax_table=hmax, patch_out=patch_out
            )
        return rec["boxes_3d"], rec["class_id"], rec["score"]

    return detect
