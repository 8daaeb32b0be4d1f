"""Sigmoid focal loss with mmcv/mmdet semantics (``ops/focal.py`` of the JAX
package): integer targets are one-hot encoded with ``num_classes + 1``
columns and the last column dropped, so a label equal to ``num_classes`` is a
pure-negative row; the elementwise focal BCE is mean-reduced over all N*C
entries by default. A handful of elementwise ops: plain torch, no kernel."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def sigmoid_focal_loss(
    logits: torch.Tensor,
    targets: torch.Tensor,
    gamma: float = 2.0,
    alpha: float = 0.25,
    weight: Optional[torch.Tensor] = None,
    reduction: str = "mean",
    avg_factor: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Focal loss on raw logits (N, C) with integer targets (N,)."""
    c = logits.shape[1]
    onehot = F.one_hot(targets.long(), c + 1)[:, :c].to(logits.dtype)
    p = torch.sigmoid(logits)
    pt = (1.0 - p) * onehot + p * (1.0 - onehot)
    focal_weight = (alpha * onehot + (1.0 - alpha) * (1.0 - onehot)) * pt.pow(gamma)
    # BCE-with-logits, numerically stable form
    bce = torch.clamp(logits, min=0.0) - logits * onehot + torch.log1p(torch.exp(-logits.abs()))
    loss = bce * focal_weight
    if weight is not None:
        loss = loss * weight.reshape(-1, 1)
    if reduction == "none":
        return loss
    if reduction == "sum":
        return loss.sum()
    if avg_factor is None:
        return loss.mean()
    return loss.sum() / avg_factor
