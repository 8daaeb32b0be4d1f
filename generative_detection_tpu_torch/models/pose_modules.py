"""Spatial-VAE pose MLPs (``models/pose_modules.py`` of the JAX package).

- ``PoseDecoderSpatialVAE``: flattened 16x16x16 feature map (4096) ->
  hidden (500, tanh) x num_layers -> (4+3+1)*2 Gaussian moments +
  num_classes logits. Parameters ``layers.0/2/4``.
- ``PoseEncoderSpatialVAE``: a fixed [-1,1]^2 grid of 16x16 coordinates is
  lifted to (256, 4) features, the 19-d pose vector is lifted (no bias) to 4
  features broadcast over all coordinates, summed, then an MLP (SiLU,
  1024 -> 500 -> 4096) emits the flattened pose feature map. Parameters
  ``coord_linear``, ``latent_linear`` and ``layers.1/3``.

Both compute in the dtype of their weights and return float32.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

POSE_DIM = 4
LHW_DIM = 3
FILL_FACTOR_DIM = 1

_ACTIVATIONS = {
    "swish": nn.SiLU,
    "silu": nn.SiLU,
    "tanh": nn.Tanh,
    "relu": nn.ReLU,
    "softplus": nn.Softplus,
}


def _activation(name) -> nn.Module:
    return _ACTIVATIONS.get(name if isinstance(name, str) else "relu", nn.ReLU)()


class PoseDecoderSpatialVAE(nn.Module):
    def __init__(self, num_classes=11, num_channels=16, n=16, m=16, hidden_dim=500,
                 num_layers=2, activation="tanh", resid=False):
        super().__init__()
        inf_dim = (POSE_DIM + LHW_DIM + FILL_FACTOR_DIM) * 2 + num_classes
        layers = [nn.Linear(num_channels * n * m, hidden_dim), _activation(activation)]
        for _ in range(1, num_layers):
            layers += [nn.Linear(hidden_dim, hidden_dim), _activation(activation)]
        layers.append(nn.Linear(hidden_dim, inf_dim))
        self.layers = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.layers(x.to(self.layers[0].weight.dtype)).float()


class PoseEncoderSpatialVAE(nn.Module):
    def __init__(self, num_classes=11, num_channels=16, n=16, m=16, hidden_dim=500,
                 num_layers=2, activation="swish", feat_size=4):
        super().__init__()
        self.num_coords = n * m
        # fixed grid: x in [-1,1] left->right, y in [1,-1] top->down
        x0, x1 = np.meshgrid(np.linspace(-1, 1, m), np.linspace(1, -1, n))
        coords = np.stack([x0.ravel(), x1.ravel()], axis=1).astype(np.float32)
        self.register_buffer(
            "coords", torch.from_numpy(coords.reshape(1, -1)), persistent=False
        )
        self.coord_linear = nn.Linear(self.num_coords * 2, self.num_coords * feat_size)
        pose_dim = POSE_DIM + LHW_DIM + FILL_FACTOR_DIM + num_classes
        self.latent_linear = nn.Linear(pose_dim, feat_size, bias=False)
        layers, d = [_activation(activation)], self.num_coords * feat_size
        for _ in range(1, num_layers):
            layers += [nn.Linear(d, hidden_dim), _activation(activation)]
            d = hidden_dim
        layers.append(nn.Linear(d, num_channels * self.num_coords))
        self.layers = nn.Sequential(*layers)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        dt = self.coord_linear.weight.dtype
        h_x = self.coord_linear(self.coords.to(dt).expand(z.shape[0], -1))
        h_z = self.latent_linear(z.to(dt)).repeat(1, self.num_coords)
        return self.layers(h_x + h_z).float()
